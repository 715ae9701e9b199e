"""Batched LT symbol combine on torch tensors (counterpart of nanorq_tpu.ops.lt).

Encoding symbol ISI x is the XOR of its tuple-expanded neighbour rows of the
intermediate matrix C.  The host expands the neighbours of a whole batch of
ISIs (rfc.tuples.lt_indices) into one of two gather layouts -- the same
numpy planning the JAX package does -- and the device runs them as K1
gathers:

- flat: row-aligned passes plus overflow classes (a GatherPlan, as the
  replay's sel-row stage uses), for small batches;
- sorted: symbols sorted by degree into power-of-two width classes, then
  placed in ISI order by one width-1 gather, for large batches.

The plans keep those arrays as the JAX package builds them; the device runs
each overflow class and each sorted class composed with its placement
(`ops/replay.placed`): one K1 launch that XORs straight into the class's
output rows.  Index L, the sentinel, reads as K1's implicit zero row, so C
is gathered from as it is, with no zero row appended.
"""

from dataclasses import dataclass

import numpy as np
import torch

from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops.kernels import gather_xor
from nanorq_tpu_torch.ops.replay import _idx, apply_plan, placed
from nanorq_tpu_torch.precode.device_schedule import _gather_plan_flat
from nanorq_tpu_torch.rfc.params import Params
from nanorq_tpu_torch.rfc.tuples import lt_indices
from nanorq_tpu_torch.utils import stats
from nanorq_tpu_torch.utils.lru import ByteLRU


def _pad_rows(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


@dataclass
class LTPlan:
    """Neighbour-gather plan for a fixed batch of ISIs, on one device.

    Exactly one layout is set: `passes`/`overflow` (flat) or `classes`/`sel`
    (sorted), the JAX package's arrays.  `placed` holds what the device
    runs: each overflow class or sorted class composed with its placement,
    (idx [m, w], output rows [m]).  Index tensors are int32; `sel` is
    [n_pad, 1]."""

    n: int  # number of symbols
    n_pad: int  # padded output rows
    L: int  # C rows; index L = zero sentinel
    placed: list  # (idx [m, w], rows [m]) per class
    passes: list | None = None  # [n_pad, w] per pass
    overflow: list | None = None  # (idx [nb, w], sel [n_pad, 1]) per class
    classes: list | None = None  # idx [m_i, w_i] per width class
    sel: torch.Tensor | None = None  # [n_pad, 1] into concat(classes) + zero row


_PLAN_BUDGET = 128 << 20  # plans hold device index tensors: byte-budgeted
_plan_cache = ByteLRU(_PLAN_BUDGET, "torch_lt_plan_cache")


def _sorted_layout(idx: np.ndarray, valid: np.ndarray, n: int, n_pad: int, L: int):
    """Degree-sorted power-of-two classes + placement (numpy): ([ix], sel)."""
    deg = valid.sum(1).astype(np.int64)
    order = np.argsort(-deg, kind="stable")
    sdeg = deg[order]
    wq = np.zeros(n, np.int64)
    nz = sdeg > 0
    wq[nz] = 1 << np.ceil(np.log2(np.maximum(sdeg[nz], 1))).astype(np.int64)
    classes = []
    sel = np.full(n_pad, -1, np.int64)
    pos = start = 0
    while start < n and wq[start] > 0:
        w = int(wq[start])
        end = int(np.searchsorted(-wq, -w, side="right"))
        rows = order[start:end]
        vm = valid[rows]
        er, ec = np.nonzero(vm)
        cp = np.cumsum(vm, axis=1) - 1
        ix = np.full((rows.size, w), L, np.int32)
        ix[er, cp[er, ec]] = idx[rows][er, ec]
        classes.append(ix)
        sel[rows] = pos + np.arange(rows.size)
        pos += rows.size
        start = end
    sel[sel < 0] = pos  # degree-0 and padding rows -> the zero row
    return classes, sel.astype(np.int32)


_W_SMALL = 8  # width of the flat layout's row-aligned pass (the JAX default)


def lt_plan(isis: np.ndarray, P: Params, device, mode: str = "auto") -> LTPlan:
    """Build (or fetch) the gather plan for a batch of ISIs on `device`.

    mode "auto" takes the sorted layout for the systematic full window and
    for batches of 2048 or more, else flat -- the choice of the JAX package
    (nanorq_tpu.ops.lt.lt_plan), so both build the same index arrays."""
    dev = resolve(device)
    isis = np.asarray(isis, dtype=np.uint32)
    if mode == "auto":
        full_window = isis.size == P.Kp and np.array_equal(isis, np.arange(P.Kp, dtype=np.uint32))
        mode = "sorted" if (full_window or isis.size >= 2048) else "flat"
    key = b"%d|%s|%s|" % (P.Kp, mode.encode(), str(dev).encode()) + isis.tobytes()
    hit, cached = _plan_cache.get(key)
    if hit:
        stats.count("torch_lt_plan_cache_hit")
        return cached
    n = isis.shape[0]
    n_pad = _pad_rows(n)
    idx, valid = lt_indices(isis, P)
    if mode == "sorted":
        plan = _sorted_plan(n, n_pad, P.L, *_sorted_layout(idx, valid, n, n_pad, P.L), dev)
    else:
        erows, ecols = np.nonzero(valid)
        gp = _gather_plan_flat(n_pad, erows.astype(np.int64), idx[erows, ecols].astype(np.int64),
                               sentinel=P.L, w_small=_W_SMALL)
        plan = _flat_plan(n, n_pad, P.L, gp.passes, gp.overflow, dev)
    _plan_cache.put(key, plan)
    return plan


def _flat_plan(n, n_pad, L, passes, overflow, dev) -> LTPlan:
    return LTPlan(n=n, n_pad=n_pad, L=L, passes=[_idx(p, dev) for p in passes],
                  overflow=[(_idx(ix, dev), _idx(np.asarray(s).reshape(-1, 1), dev))
                            for ix, s in overflow],
                  placed=[placed(ix, s, dev) for ix, s in overflow])


def _sorted_plan(n, n_pad, L, classes, sel, dev) -> LTPlan:
    """Class i holds the rows [lo_i, lo_i + m_i) of concat(classes) that sel
    places."""
    los = np.cumsum([0] + [c.shape[0] for c in classes])
    return LTPlan(n=n, n_pad=n_pad, L=L, classes=[_idx(c, dev) for c in classes],
                  sel=_idx(np.asarray(sel).reshape(-1, 1), dev),
                  placed=[placed(c, sel, dev, int(lo)) for c, lo in zip(classes, los)])


def lt_plan_from_jax(plan_np, device) -> LTPlan:
    """The port's plan from a JAX `nanorq_tpu.ops.lt.LTPlan` whose arrays were
    turned into numpy (no JAX is imported here): `classes`/`sel` for a
    sorted plan, `plan` = (passes, overflow) for a flat one."""
    dev = resolve(device)
    if plan_np.classes is not None:
        return _sorted_plan(plan_np.n, plan_np.n_pad, plan_np.L, [np.asarray(c) for c in plan_np.classes],
                            np.asarray(plan_np.sel), dev)
    passes, overflow = plan_np.plan
    return _flat_plan(plan_np.n, plan_np.n_pad, plan_np.L, passes, overflow, dev)


def lt_combine(C: torch.Tensor, plan: LTPlan) -> torch.Tensor:
    """C [L, t] -> symbols [n_pad, t] for the plan's ISIs (row order = isis)."""
    L = plan.L
    if plan.passes:  # the first pass covers every row: it stores, the rest XOR in
        out = gather_xor(C, plan.passes[0], zero_index=L)
        passes = plan.passes[1:]
    else:  # rows no class places (degree 0, padding) stay zero
        out, passes = C.new_zeros(plan.n_pad, C.shape[1]), []
    return apply_plan(C, passes, plan.placed, out, zero_index=L)
