"""Minimal dependency-free tree checkpointing (npz + a JSON manifest).

Checkpoints cover model parameters AND the asynchronous algorithm's
state (per-worker momenta, the running sum v0, the step counter), so an
interrupted run restarts with its staleness-mitigation state intact: the
per-worker momenta are NOT reconstructible from the weights.

The file format is the JAX package's, exactly: an ``.npz`` whose
``__manifest__`` is the JSON list of every leaf's path in
``jax.tree_util.keystr`` form (``"['theta']['unit'][0]['mlp']['w1']"``:
a dict key as ``[<repr of the key>]``, a list or tuple index as
``[<i>]``), in the JAX flatten order (sorted dict keys, ``None`` an empty
subtree), and the leaves as ``leaf_0``, ``leaf_1``, ...  A checkpoint
written by either package loads in the other.  bfloat16 tensors, which
numpy cannot hold, are stored as their 16-bit patterns (numpy ``V2``,
what numpy reads back from a JAX bfloat16 leaf) and load bit for bit
into a bfloat16 leaf of ``like``.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.types import tree_flatten, tree_unflatten


def _paths(tree, prefix: str, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _paths(tree[k], f"{prefix}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, c in enumerate(tree):
            _paths(c, f"{prefix}[{i}]", out)
    elif tree is not None:
        out.append(prefix)


def keystr_paths(tree) -> list[str]:
    """Every leaf's path in ``jax.tree_util.keystr`` form, in the
    order of ``tree_flatten``."""
    out: list[str] = []
    _paths(tree, "", out)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(a: np.ndarray, like) -> torch.Tensor:
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    if a.dtype == np.dtype("V2"):
        if not (isinstance(like, torch.Tensor)
                and like.dtype == torch.bfloat16):
            raise TypeError("a 16-bit pattern (bfloat16) leaf loads only "
                            "into a bfloat16 leaf")
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def save_pytree(path: str, tree) -> None:
    """Atomically save a tree of tensors (or arrays) to ``path`` (.npz).

    The archive is ``np.savez``'s (stored, not compressed, one ``.npy``
    entry a leaf, written by ``np.lib.format.write_array``), written one
    leaf at a time while a second thread copies the next leaf to the
    host, so the host holds two leaves' copies at a time, not the whole
    tree's."""
    keys = keystr_paths(tree)
    leaves = tree_flatten(tree)[0]
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    os.close(fd)
    try:
        with zipfile.ZipFile(tmp, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf, \
                ThreadPoolExecutor(1) as pool:
            _write(zf, "__manifest__", np.asarray(json.dumps(keys)))
            ahead = [pool.submit(_to_numpy, l) for l in leaves[:1]]
            for i in range(len(leaves)):
                arr = ahead.pop().result()
                if i + 1 < len(leaves):
                    ahead.append(pool.submit(_to_numpy, leaves[i + 1]))
                _write(zf, f"leaf_{i}", arr)
                del arr
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write(zf: zipfile.ZipFile, name: str, arr: np.ndarray) -> None:
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        np.lib.format.write_array(f, arr, allow_pickle=False)


def load_pytree(path: str, like):
    """Load a checkpoint into the structure of ``like`` (structure and
    shapes checked); each leaf keeps its saved type and lands on the
    device of ``like``'s leaf (the CPU where that leaf is no tensor).
    Leaves are read one at a time by ``np.load``, which checks each
    entry's CRC."""
    like_keys = keystr_paths(like)
    like_leaves, treedef = tree_flatten(like)
    out = []
    with np.load(path, allow_pickle=False) as data:
        keys = json.loads(str(data["__manifest__"]))
        if keys != like_keys:
            raise ValueError(
                f"checkpoint structure mismatch:\n saved={keys[:5]}...\n "
                f"expected={like_keys[:5]}...")
        for i, (k, expect) in enumerate(zip(keys, like_leaves)):
            saved = data[f"leaf_{i}"]
            if saved.shape != np.shape(expect):
                raise ValueError(f"shape mismatch at {k}: {saved.shape} vs "
                                 f"{tuple(np.shape(expect))}")
            out.append(_to_tensor(saved, expect))
            del saved
    return tree_unflatten(treedef, out)
