"""Discrete-event asynchronous training engine (paper Sec. 5 methodology).

Simulates a parameter-server cluster: N workers with gamma-distributed batch
execution times (Ali et al. 2000) pull parameter views from the master,
compute gradients, and push updates.  The master applies whichever
``Algorithm`` is configured.  This is the paper's own evaluation harness
(Sec. 5: "we simulate multiple distributed workers").

The event order depends only on ``GammaModel``'s numpy stream, so the
port and the JAX package replay the same events (time, worker, lag,
step) for the same seed.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable

import torch

from .algorithms import Algorithm
from .gamma import GammaModel
from .metrics import History
from .types import Pytree, tree_gap, tree_l2, tree_map


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    num_workers: int = 8
    total_grads: int = 1000        # total gradient computations (all workers)
    eval_every: int = 100          # master updates between eval points
    exec_model: GammaModel = GammaModel()
    record_telemetry: bool = True
    # Run the master hot path on flat (R, 128) state through the batched
    # update kernel and the send-view kernel (kernels/flat_update; the
    # plain versions for CPU tensors).  Raises for algorithms without a
    # flat path.
    use_kernel: bool = False
    device: str = "cuda"


def run_simulation(
    algo: Algorithm,
    grad_fn: Callable[[Pytree, Any], Pytree],
    params0: Pytree,
    next_batch: Callable[[int, int], Any],
    cfg: SimulationConfig,
    eval_fn: Callable[[Pytree], Any] | None = None,
) -> History:
    """Run one asynchronous training simulation on ``cfg.device``.

    grad_fn(params, batch) -> grad tree
    next_batch(worker_id, counter) -> batch          (host-side, deterministic)
    eval_fn(params) -> loss or (loss, metric)

    ``params0`` (a tree of tensors or numpy arrays) is copied to
    ``cfg.device``; batches must already live there.
    """
    if algo.name == "ssgd":
        raise NotImplementedError("ssgd (the synchronous barrier engine) "
                                  "is not ported yet: ROADMAP.md")
    n = cfg.num_workers
    history = History()
    draw = cfg.exec_model.sampler(n)

    def _eval(params, time, step):
        if eval_fn is None:
            return
        out = eval_fn(params)
        loss, metric = (out if isinstance(out, tuple) else (out, float("nan")))
        history.record_eval(time=time, step=step, loss=loss, metric=metric)

    params = tree_map(lambda l: torch.as_tensor(l).to(cfg.device), params0)
    # flat execution: same loop, state packed once into (R, 128) buffers
    # and receive->send applied by the batched kernel
    algo_exec = algo
    master_view = algo.master_params
    if cfg.use_kernel:
        from ..kernels.flat_update import FlatAlgorithm
        algo_exec = FlatAlgorithm(algo)
        master_view = algo_exec.master_view
    state = algo_exec.init(params, n)

    views: list[Pytree] = []
    pull_step = [0] * n
    heap: list[tuple[float, int]] = []
    for i in range(n):
        view, state = algo_exec.send(state, i)
        views.append(view)
        heapq.heappush(heap, (draw(i), i))

    counters = [0] * n
    done = 0
    while done < cfg.total_grads:
        t_now, i = heapq.heappop(heap)
        batch = next_batch(i, counters[i])
        counters[i] += 1
        lag = state["t"] - pull_step[i]
        grad = grad_fn(views[i], batch)
        # the gap reads theta BEFORE this message updates it in place, so
        # a view of it will do; eval and final_params get copies
        gap = tree_gap(master_view(state), views[i])
        gnorm = tree_l2(grad)
        state, new_view = algo_exec.receive_send(state, i, grad, t_now)
        if cfg.record_telemetry:
            history.record(time=t_now, step=state["t"], worker=i,
                           lag=lag, gap=gap, grad_norm=gnorm)
        views[i] = new_view
        pull_step[i] = state["t"]
        done += 1
        if done % cfg.eval_every == 0 or done == cfg.total_grads:
            _eval(algo_exec.master_params(state), t_now, state["t"])
        heapq.heappush(heap, (t_now + draw(i), i))
    history.final_params = algo_exec.master_params(state)
    return history
