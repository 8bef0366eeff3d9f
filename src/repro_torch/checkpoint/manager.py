"""Checkpoint manager: step-numbered checkpoints with retention, latest
resolution and a metrics sidecar (JSONL), as the JAX package's.

Layout:  <dir>/step_0000100.npz
         <dir>/metrics.jsonl       (one JSON object per logged step)
"""
from __future__ import annotations

import json
import os
import re

from .io import load_pytree, save_pytree

_STEP_RE = re.compile(r"step_(\d+)\.npz$")


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    # -- checkpoints ------------------------------------------------------
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:07d}.npz")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.search(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, tree) -> str:
        path = self._path(step)
        save_pytree(path, tree)
        self._retain()
        return path

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like, step: int | None = None):
        """Returns (tree, step) or (None, None) when nothing is saved."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return load_pytree(self._path(step), like), step

    def _retain(self):
        steps = self.steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    # -- metrics ------------------------------------------------------------
    def log_metrics(self, step: int, **metrics):
        row = {"step": int(step)}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(os.path.join(self.dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    def read_metrics(self) -> list[dict]:
        path = os.path.join(self.dir, "metrics.jsonl")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
