"""Flat-state layout: pack a tree once into contiguous (R, 128) rows.

The master hot loop views every algorithm's state as a handful of dense
f32 streams (theta, per-worker momentum, running sums).  ``FlatSpec``
computes the layout ONCE at ``init``; packing and unpacking are then
copies into / views out of one contiguous buffer, so a whole coalesced
batch runs as one kernel over it.

Layout (identical to the JAX package's, byte for byte): all leaves
raveled in treedef order (``core/types.tree_flatten``: sorted dict keys),
concatenated, zero-padded to a whole number of 128-lane rows rounded up
to ``row_align`` rows, viewed as (R, 128).  Per-worker stacked state
(leaves shaped (N, ...)) packs to (N, R, 128) with the SAME per-row
layout, so row r of worker i's slab and row r of theta describe the same
parameters.

Zero padding is load-bearing: every update rule in the family maps
(0, 0, ..., 0) -> 0 in the padding region, so packed buffers never leak
padding into real rows and norms over flat buffers equal tree norms.

``unpack`` returns VIEWS into the buffer it is given (no copy).  A caller
that keeps an unpacked tree past the next in-place update of that buffer
must copy it first (``FlatAlgorithm.master_params`` does).

Every family update rule is elementwise per row, so a contiguous row
range [r0, r1) is a self-contained shard of the state: ``row_ranges``
splits the rows into S ranges (the JAX package's boundaries exactly) and
``FlatSubSpec`` views one range of a buffer; the row-sharded master
(``cluster/sharded.py``) builds on them, and ``concat_rows`` reassembles
the shards in range order.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .types import flatten_up_to, tree_flatten, tree_unflatten

LANES = 128


class FlatSpec:
    """Layout of one tree flattened to (rows, 128) f32."""

    def __init__(self, treedef, shapes, dtypes, *, row_align: int = 8):
        self.treedef = treedef
        self.shapes = tuple(tuple(s) for s in shapes)
        self.dtypes = tuple(dtypes)
        self.sizes = tuple(int(math.prod(s)) for s in self.shapes)
        self.n_elems = int(sum(self.sizes))
        self.row_align = int(row_align)
        rows = -(-self.n_elems // LANES)
        self.rows = -(-rows // row_align) * row_align
        self.padded = self.rows * LANES
        offs, o = [], 0
        for s in self.sizes:
            offs.append(o)
            o += s
        self.offsets = tuple(offs)

    @classmethod
    def from_tree(cls, tree, *, row_align: int = 8) -> "FlatSpec":
        leaves, treedef = tree_flatten(tree)
        return cls(treedef, [tuple(l.shape) for l in leaves],
                   [l.dtype for l in leaves], row_align=row_align)

    # -- pack -----------------------------------------------------------
    def pack(self, tree) -> torch.Tensor:
        """Tree -> (rows, 128) f32, zero-padded.  Each leaf is written
        into its ``offsets`` span of one zeroed buffer (one allocation;
        the zero init is the padding tail)."""
        leaves = flatten_up_to(self.treedef, tree)
        buf = torch.zeros((self.padded,), dtype=torch.float32,
                          device=leaves[0].device)
        for leaf, o, s in zip(leaves, self.offsets, self.sizes):
            buf[o:o + s] = leaf.reshape(-1)
        return buf.view(self.rows, LANES)

    def pack_stacked(self, tree) -> torch.Tensor:
        """Tree of (N, ...) leaves -> (N, rows, 128) f32."""
        leaves = flatten_up_to(self.treedef, tree)
        n = leaves[0].shape[0]
        buf = torch.zeros((n, self.padded), dtype=torch.float32,
                          device=leaves[0].device)
        for leaf, o, s in zip(leaves, self.offsets, self.sizes):
            buf[:, o:o + s] = leaf.reshape(n, -1)
        return buf.view(n, self.rows, LANES)

    # -- unpack ---------------------------------------------------------
    def unpack(self, buf: torch.Tensor):
        """(rows, 128) -> tree of views (original shapes/dtypes, padding
        dropped)."""
        flat = buf.reshape(-1)
        leaves = [
            flat[o:o + s].view(shape).to(dt)
            for o, s, shape, dt in zip(self.offsets, self.sizes,
                                       self.shapes, self.dtypes)
        ]
        return tree_unflatten(self.treedef, leaves)

    def unpack_stacked(self, buf: torch.Tensor):
        """(N, rows, 128) -> tree of (N, ...) leaves."""
        n = buf.shape[0]
        flat = buf.reshape(n, -1)
        leaves = [
            flat[:, o:o + s].reshape((n,) + shape).to(dt)
            for o, s, shape, dt in zip(self.offsets, self.sizes,
                                       self.shapes, self.dtypes)
        ]
        return tree_unflatten(self.treedef, leaves)


    # -- row sharding ----------------------------------------------------
    def row_ranges(self, shards: int) -> tuple[tuple[int, int], ...]:
        """Split [0, rows) into ``shards`` contiguous non-empty ranges.

        Boundaries are ``round(s * rows / shards)`` (Python's rounding,
        half to even) snapped down to ``row_align`` multiples when that
        keeps every range non-empty; tiny states keep the plain split,
        so any S <= rows works.  The ranges cover [0, rows) in order."""
        if not 1 <= shards <= self.rows:
            raise ValueError(
                f"need 1 <= shards <= rows={self.rows}, got {shards}")
        bounds = [round(s * self.rows / shards) for s in range(shards + 1)]
        for s in range(1, shards):
            snapped = (bounds[s] // self.row_align) * self.row_align
            if bounds[s - 1] < snapped:
                bounds[s] = snapped
        return tuple((bounds[s], bounds[s + 1]) for s in range(shards))

    def subspec(self, r0: int, r1: int) -> "FlatSubSpec":
        return FlatSubSpec(self, r0, r1)

    def concat_rows(self, pieces) -> torch.Tensor:
        """Range-ordered shard slices ((r, 128) or (N, r, 128) each) ->
        one full buffer, one ``torch.cat`` along the row axis."""
        return torch.cat(list(pieces), dim=-2)


class FlatSubSpec:
    """One contiguous row range [r0, r1) of a ``FlatSpec`` layout;
    ``take`` views those rows of a full buffer (the sharded worker's
    split of its packed gradient)."""

    def __init__(self, spec: FlatSpec, r0: int, r1: int):
        if not 0 <= r0 < r1 <= spec.rows:
            raise ValueError(f"bad row range [{r0}, {r1}) for "
                             f"rows={spec.rows}")
        self.spec = spec
        self.r0, self.r1 = int(r0), int(r1)
        self.rows = self.r1 - self.r0

    def take(self, buf: torch.Tensor) -> torch.Tensor:
        """(.., rows, 128) -> a view of (.., r1-r0, 128)."""
        return buf[..., self.r0:self.r1, :]


class ScalarLane:
    """Named per-worker scalars packed as one (N, 128) f32 row per worker.

    Slot j of worker i's lane row holds the scalar named ``names[j]``;
    lanes beyond ``len(names)`` are zero.  The lane is not part of the
    row space.  The layout is the JAX package's, but the port keeps its
    lanes on the HOST as float32 numpy arrays: every lane value is read
    or advanced per message (staleness stamps, message timestamps), and
    a host array lets the master compute those scalars without waiting
    on the device.  Every method returns a new array; none writes the
    lane it is given.
    """

    def __init__(self, names):
        names = tuple(names)
        if not 0 < len(names) <= LANES:
            raise ValueError(f"need 1..{LANES} scalar names, "
                             f"got {len(names)}")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate scalar names in {names}")
        self.names = names
        self.index = {n: j for j, n in enumerate(names)}

    def init(self, num_workers: int, **values) -> np.ndarray:
        """Zeroed (N, 128) lane; ``values`` seeds named columns with a
        scalar or an (N,) vector."""
        lane = np.zeros((num_workers, LANES), np.float32)
        for name, v in values.items():
            lane[:, self.index[name]] = np.asarray(v, np.float32)
        return lane

    def pack(self, cols: dict) -> np.ndarray:
        """{name: (N,) array} -> (N, 128) f32 lane (zero-padded)."""
        first = next(iter(cols.values()))
        return self.init(len(first), **cols)

    def unpack(self, lane: np.ndarray) -> dict:
        """(N, 128) lane -> {name: (N,) f32 column}."""
        return {n: self.get(lane, n) for n in self.names}

    def get(self, lane: np.ndarray, name: str) -> np.ndarray:
        return np.array(lane[:, self.index[name]], np.float32)

    def set_at(self, lane: np.ndarray, name: str, i,
               value) -> np.ndarray:
        """Lane with worker i's ``name`` slot <- value (a new array)."""
        out = np.array(lane, np.float32)
        out[i, self.index[name]] = value
        return out


# rate-telemetry slots (dana-hetero): EMA of worker i's inter-push
# interval, and the timestamp of its last push.
RATE_INTERVAL = "interval"
RATE_LAST_T = "last_t"
RATE_LANE = ScalarLane((RATE_INTERVAL, RATE_LAST_T))

# staleness slot: the master step worker i's view (and ``sent``
# snapshot) was sent at, so t - lane[i] is its age in master updates
SENT_STEP = "sent_step"
SENT_LANE = ScalarLane((SENT_STEP,))
