"""Encoder / Decoder of the port: `nanorq_tpu.codec.api` on torch tensors.

The host logic (OTI, partitioning, symbol ingestion, gap tracking, the
patched system and its solve) is inherited from the JAX package unchanged.
These subclasses override every method that reached JAX, and run the device
work on the explicit `device` they were built with:

- encode: the structured replay (ops/replay.py) and LT combine (ops/lt.py);
- decode (`backend="device"`): the dense-W matmul (ops/wpath.py) for
  WSchedule plans, or the replay plus a gap LT combine for structured plans;
- decode (`backend="host"`): the inherited native CPU arm, which has no
  device half.

Not ported yet, and raising NotImplementedError: the residual arm and the
`auto` routing (ROADMAP Queue 1 item 8) and `mesh=` (item 10).
"""

import numpy as np
import torch

from nanorq_tpu.codec import api as _api
from nanorq_tpu.codec import cache as _jcache
from nanorq_tpu.io.ioctx import IOContext
from nanorq_tpu.utils import stats
from nanorq_tpu_torch.codec import cache as _cache
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops import wpath
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays, replay

_NO_MESH = "mesh= is not ported yet (ROADMAP Queue 1 item 10, multi-GPU)"
_NO_RES = "the residual arm and auto routing are not ported yet (ROADMAP Queue 1 item 8)"


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


class _HostResult:
    """Lazy host copy of one device result: the first np.asarray() of any
    of its views waits for the device and fetches the whole tensor once."""

    __slots__ = ("dev", "_np")

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self._np = None

    def numpy(self) -> np.ndarray:
        if self._np is None:
            self._np = self.dev.cpu().numpy()
        return self._np


class _HostView:
    """Row block `j` of a stacked _HostResult (or all of it when j is None),
    resolved by np.asarray -- the form Decoder._repair_finish consumes."""

    __slots__ = ("res", "j")

    def __init__(self, res: _HostResult, j: int | None = None):
        self.res = res
        self.j = j

    def __array__(self, dtype=None, copy=None):
        a = self.res.numpy() if self.j is None else self.res.numpy()[self.j]
        return a if dtype is None else a.astype(dtype)


class Encoder(_api.Encoder):
    """Systematic RaptorQ encoder whose payload math runs on `device`."""

    def __init__(self, transfer_length: int, symbol_size: int, Al: int = 4, K: int = 0,
                 Z: int = 0, N: int = 1, *, device):
        super().__init__(transfer_length, symbol_size, Al=Al, K=K, Z=Z, N=N)
        self.device = resolve(device)

    def generate_symbols(self, sbn: int, io: IOContext, mesh=None) -> bool:
        """Compute the block's intermediate symbols C [L, T] on the device."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        b = self._load(io, sbn)
        if b.C is None:
            ds = _jcache.encoder_schedule(self.P.Kp)
            b.C = replay(device_arrays(ds, self.device), _upload(b.D, self.device))
        return True

    def encode_batch(self, sbn: int, esis: np.ndarray, io: IOContext, mesh=None) -> np.ndarray:
        """Encode many symbols of one block -> [n, T] uint8 (numpy).  Source
        ESIs come from the loaded rows, repair ESIs from the LT combine."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        esis = np.asarray(esis, dtype=np.int64)
        b = self._load(io, sbn)
        T = self.scheme.T
        out = np.zeros((len(esis), T), np.uint8)
        src_mask = esis < b.K
        if src_mask.any():
            out[src_mask] = b.D[esis[src_mask]]
        rep = np.nonzero(~src_mask)[0]
        if rep.size:
            self.generate_symbols(sbn, io)
            isis = (esis[rep] + (self.P.Kp - b.K)).astype(np.uint32)
            sym = lt_combine(b.C, lt_plan(isis, self.P, self.device))
            out[rep] = sym[: rep.size, :T].cpu().numpy()
        return out


class Decoder(_api.Decoder):
    """RaptorQ decoder whose device arm runs on `device`."""

    def __init__(self, oti_common: int, oti_scheme: int, *, device):
        super().__init__(oti_common, oti_scheme)
        self.device = resolve(device)

    def repair_block(self, io: IOContext, sbn: int) -> bool:
        """Recover the block's missing source symbols on the device."""
        prep = self._repair_prepare(sbn)
        if isinstance(prep, bool):
            return prep
        gaps, isis, overhead = prep
        ds = _cache.decoder_plan(self.P, isis, overhead)
        if ds is None:
            stats.count("repair_block_failed")
            return False  # rank deficient: feed more symbols, retry
        return self._repair_finish(io, sbn, gaps, self._repair_launch(sbn, gaps, overhead, ds))

    def _repair_pipeline(self, max_workers: int | None = None, mesh=None, backend: str | None = None,
                         io: IOContext | None = None):
        """backend "device" (the default) or "host"; see the module docstring."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        backend = backend or "device"
        if backend not in ("device", "host"):
            raise NotImplementedError(f"backend {backend!r}: {_NO_RES}")
        return super()._repair_pipeline(max_workers, backend=backend, io=io)

    def _repair_residual_batch(self, work):
        raise NotImplementedError(_NO_RES)

    def _repair_residual_host_batch(self, work, io: IOContext | None = None):
        raise NotImplementedError(_NO_RES)

    def _repair_pipeline_device(self, work, max_workers: int | None = None, mesh=None):
        """Device arm: per-pattern plans solved in one worker thread while
        this thread launches each block as its solve lands; WSchedule
        blocks of one (kind, M_pad) are stacked into batches."""
        from concurrent.futures import ThreadPoolExecutor

        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        ok, launched, pend = True, [], {}

        def flush(key):
            items = pend.pop(key, [])
            if len(items) == 1:
                s, g, ov, ds, _ = items[0]
                launched.append((s, g, self._repair_launch(s, g, ov, ds)))
            elif items:
                launched.extend(self._repair_launch_batch(items))

        with ThreadPoolExecutor(max_workers=max_workers or 1) as ex:
            futs = [(s, g, ov, ex.submit(_cache.decoder_plan, self.P, isis, ov))
                    for s, g, isis, ov in work]
            for sbn, gaps, ov, fut in futs:
                ds = fut.result()
                if ds is None:
                    stats.count("repair_block_failed")
                    ok = False
                elif isinstance(ds, _jcache.WSchedule):
                    key = (ds.Wbits is not None, ds.M_pad)
                    pend.setdefault(key, []).append((sbn, gaps, ov, ds, None))
                    if len(pend[key]) >= self._BATCH_FLUSH:
                        flush(key)
                else:
                    launched.append((sbn, gaps, self._repair_launch(sbn, gaps, ov, ds)))
            for key in list(pend):
                flush(key)
        return ok, launched

    def _repair_launch(self, sbn: int, gaps: np.ndarray, overhead: int, ds, D_dev=None):
        """Launch one block's recovery; returns a host view of its gap rows.

        A WSchedule runs one dense-W matmul; a DeviceSchedule the structured
        replay plus an LT combine of the gap ISIs.  D_dev: optionally the
        payload matrix [ds.M_pad, T] already on the device."""
        if D_dev is None:
            D_dev = _upload(self._repair_D(sbn, gaps, overhead, ds.M_pad), self.device)
        if isinstance(ds, _jcache.WSchedule):
            sym = _cache.apply(ds, D_dev)
        else:
            C = replay(device_arrays(ds, self.device), D_dev)
            sym = lt_combine(C, lt_plan(gaps.astype(np.uint32), self.P, self.device))
        return _HostView(_HostResult(sym[: gaps.size]))

    def _repair_launch_batch(self, items, mesh=None):
        """Stacked launch for same-(kind, M_pad) WSchedule blocks.

        items: [(sbn, gaps, overhead, plan, D_host|None)] -> [(sbn, gaps,
        view)]; the views share one device result, fetched once."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        stats.count("repair_batch_launch")
        stats.count("repair_batch_blocks", len(items))
        plans = [p for _, _, _, p, _ in items]
        M_pad = plans[0].M_pad
        D = np.zeros((len(items), M_pad, self.scheme.T), np.uint8)
        for j, (sbn, gaps, ov, _p, Dh) in enumerate(items):
            D[j] = Dh if Dh is not None else self._repair_D(sbn, gaps, ov, M_pad)
        dev = self.device
        if plans[0].Wbits is not None:
            bits, rows = wpath.w_stack_gf2(plans)
            out = wpath.w_apply_gf2_batch(_upload(bits, dev), _upload(rows[..., None], dev),
                                          _upload(D, dev))
        else:
            out = wpath.w_apply_gf256_batch(_upload(wpath.w_stack_gf256(plans), dev), _upload(D, dev))
        res = _HostResult(out)
        return [(it[0], it[1], _HostView(res, j)) for j, it in enumerate(items)]
