"""Serve steps: prefill and decode for an input shape.

The JAX package's step functions also bind the mesh's logical-axis
rules and, on a TPU, switch its Pallas kernels on; the port has no mesh
(ROADMAP A8) and its scan wrapper picks the kernel by device, so a step
is the model's function with the shape's cache geometry.  The DANA pod-round
train step waits for the training slice (ROADMAP A7).
"""
from __future__ import annotations

from ..configs.base import InputShape
from ..models.api import Model, cache_spec_for


def build_prefill_step(model: Model, shape: InputShape):
    spec = cache_spec_for(model.cfg, shape)

    def step(params, batch):
        return model.prefill(params, batch, spec)

    return step


def build_decode_step(model: Model, shape: InputShape):
    spec = cache_spec_for(model.cfg, shape)

    def step(params, token, cache):
        return model.decode_step(params, token, cache, spec)

    return step
