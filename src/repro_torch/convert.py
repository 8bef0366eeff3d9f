"""Carry weights and master state across from the JAX package.

Inputs are numpy only (the caller does ``np.asarray`` on the JAX side),
so this module imports no JAX:

* ``params_from_numpy(tree)``: a tree of arrays (e.g. the MLP's
  ``[{"w", "b"}, ...]``, a JAX MoE layer's ``router``, ``w_gate``,
  ``w_up``, ``w_down`` and ``shared``, or a JAX decode cache,
  ``prefill``'s or ``init_cache``'s: ``k``, ``v`` bfloat16 or int8 with
  float32 ``k_scale``, ``v_scale``, ``pos`` and ``t`` int32, ``conv``,
  ``h``, ``ssm``; an enc-dec cache's ``{"self", "cross"}`` blocks and
  its ``enc_out``) -> the same tree of tensors, leaf by leaf in its own
  type, so both packages can decode from one cache;
* ``flat_state_from_numpy(flat)``: the JAX ``FlatAlgorithm`` state dict
  of any flat-eligible member (``theta``, ``v``, ``v0``, ``u2``,
  ``sent``, ``wscal``, ``rate``, ``t``, ``lr_prev``, ``vscale``,
  ``tau``, ``avg_step``, each as ``np.asarray``) -> the port's flat
  state, so both packages can step the same state.  Row buffers and
  ga-asgd's ``avg_step`` become tensors on ``device``; the scalar lanes
  (``wscal``, ``rate``: device arrays in the JAX package) stay host
  float32 arrays of the same (N, 128) layout; the step ``t`` becomes a
  Python int and the other scalars host ``np.float32``, as the port
  keeps them;
* ``lm_params_from_numpy(tree)``: the JAX ``init_lm`` parameter tree
  (every leaf through ``np.asarray``) -> the port's tree of the same
  structure, unit leaves still stacked ``(unit_repeats, ...)``; with
  ``dtype`` every floating leaf is cast to it (the serve path's cast of
  every float32 leaf to bfloat16).  Every block kind ported so far
  carries over leaf by leaf: mamba's, the RG-LRU's (``in_x``,
  ``in_gate``, ``conv_w``, ``w_a``, ``w_i``, ``lam``, ...), attention's
  (``wq``, ``wk``, ``wv``, ``wo``, the qkv biases), the MLP's and the
  MoE layer's (``router`` (d, E), the experts stacked (E, d, ff) and (E,
  ff, d) under the unit's repeat axis, the optional ``shared`` MLP), and
  the enc-dec family's (the ``encoder`` subtree, ``lnx`` and ``xattn``).

numpy arrays of JAX's bfloat16 (``ml_dtypes``) become torch bfloat16
tensors exactly (through float32, which holds every bfloat16 value).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import tree_map

ROW_KEYS = ("theta", "v", "v0", "u2", "sent")   # buffers laid out by row
LANE_KEYS = ("wscal", "rate")                    # host scalar lanes
DEVICE_SCALARS = ("avg_step",)                   # 0-d tensors


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    return tree_map(lambda a: _tensor(a, device), tree)


def flat_state_from_numpy(flat: dict, device="cuda") -> dict:
    out = {}
    for key, val in flat.items():
        a = np.asarray(val)
        if key == "t":
            out[key] = int(a)
        elif key in LANE_KEYS:
            out[key] = np.array(a, np.float32)
        elif key in ROW_KEYS or key in DEVICE_SCALARS or a.ndim > 0:
            out[key] = _tensor(a, device)
        else:
            out[key] = np.float32(a)
    return out


def lm_params_from_numpy(tree, device="cuda", dtype=None):
    def leaf(a):
        t = _tensor(a, device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t
    return tree_map(leaf, tree)
