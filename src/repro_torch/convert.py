"""Carry weights and master state across from the JAX package.

Inputs are numpy only (the caller does ``np.asarray`` on the JAX side),
so this module imports no JAX:

* ``params_from_numpy(tree)``: a tree of arrays (e.g. the MLP's
  ``[{"w", "b"}, ...]``) -> the same tree of float tensors;
* ``flat_state_from_numpy(flat)``: the JAX ``FlatAlgorithm`` state dict
  of any flat-eligible member (``theta``, ``v``, ``v0``, ``u2``,
  ``sent``, ``wscal``, ``rate``, ``t``, ``lr_prev``, ``vscale``,
  ``tau``, ``avg_step``, each as ``np.asarray``) -> the port's flat
  state, so both packages can step the same state.  Row buffers and
  ga-asgd's ``avg_step`` become tensors on ``device``; the scalar lanes
  (``wscal``, ``rate``: device arrays in the JAX package) stay host
  float32 arrays of the same (N, 128) layout; the step ``t`` becomes a
  Python int and the other scalars host ``np.float32``, as the port
  keeps them.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.types import tree_map

ROW_KEYS = ("theta", "v", "v0", "u2", "sent")   # buffers laid out by row
LANE_KEYS = ("wscal", "rate")                    # host scalar lanes
DEVICE_SCALARS = ("avg_step",)                   # 0-d tensors


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
        elif key in LANE_KEYS:
            out[key] = np.array(a, np.float32)
        elif key in ROW_KEYS or key in DEVICE_SCALARS or a.ndim > 0:
            out[key] = _tensor(a, device)
        else:
            out[key] = np.float32(a)
    return out
