"""Carry weights and master state across from the JAX package.

Inputs are numpy only (the caller does ``np.asarray`` on the JAX side),
so this module imports no JAX:

* ``params_from_numpy(tree)``: a tree of arrays (e.g. the MLP's
  ``[{"w", "b"}, ...]``) -> the same tree of float tensors;
* ``flat_state_from_numpy(flat)``: the JAX ``FlatAlgorithm`` state dict
  (``theta``, ``v``, ``v0``, ``t``, ``lr_prev``, ``vscale``, ... each as
  ``np.asarray``) -> the port's flat state, so both packages can step
  the same state.  Row buffers become tensors, the step ``t`` a Python
  int and the other scalars host ``np.float32``, as the port keeps them.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import tree_map

ROW_KEYS = ("theta", "v", "v0", "u2", "sent")   # buffers laid out by row


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    return tree_map(lambda a: _tensor(a, device), tree)


def flat_state_from_numpy(flat: dict, device="cuda") -> dict:
    out = {}
    for key, val in flat.items():
        a = np.asarray(val)
        if key == "t":
            out[key] = int(a)
        elif key in ROW_KEYS or a.ndim > 0:
            out[key] = _tensor(a, device)
        else:
            out[key] = np.float32(a)
    return out
