"""Gradients through the port's forward-only CUDA kernels.

The JAX package has no backward kernel for its scans or its attention
(nothing in its ``kernels/`` uses ``custom_vjp``); it trains through
their ``jnp`` versions.  Here a kernel's wrapper stays the forward, and
``KernelFunction`` is its backward: it recomputes the same function with
the module's plain version on detached inputs under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of that
recomputation.  The forward still launches the kernel (and counts it);
the backward launches nothing of its own.

``apply`` routes a call through the Function only when a gradient is
needed (grad mode on and some input requiring grad).  Otherwise it calls
the kernel directly and records no graph: serving, whose parameters do
not require grad, runs exactly as before.

The forward is an argument, so a CPU test can drive the same Function
with the plain version as its forward.
"""
from __future__ import annotations

import torch


class KernelFunction(torch.autograd.Function):
    """``kernel(*tensors, *static)`` forward; the gradient of
    ``plain(*tensors, *static)`` backward.  ``static`` (a window, say)
    is not differentiable."""

    @staticmethod
    def forward(ctx, kernel, plain, static, *tensors):
        ctx.plain, ctx.static = plain, static
        ctx.save_for_backward(*tensors)
        return kernel(*tensors, *static)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*xs, *ctx.static)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wrt = [x for x, n in zip(xs, need) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wrt, [g for _, g in pairs],
                                       allow_unused=True))
        return (None, None, None, *(next(got) if n else None for n in need))


def apply(kernel, plain, tensors, static=()):
    """``kernel(*tensors, *static)``, differentiable through ``plain``
    when a gradient is needed, a direct call otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return KernelFunction.apply(kernel, plain, tuple(static), *tensors)
    return kernel(*tensors, *static)
