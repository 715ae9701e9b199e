"""Encoder / Decoder of the port: `nanorq_tpu.codec.api` on torch tensors.

The host logic (OTI, partitioning, symbol ingestion, gap tracking, the
patched system and its solve) is inherited from the JAX package unchanged.
These subclasses override every method that reached JAX, and run the device
work on the explicit `device` they were built with:

- encode: the structured replay (ops/replay.py) and LT combine (ops/lt.py);
- decode, per `backend` of `repair_all` (default: env NANORQ_DECODE_BACKEND,
  else "auto", as in the JAX package):
  - "device": the dense-W matmul (ops/wpath.py) for WSchedule plans, or the
    replay plus a gap LT combine for structured plans;
  - "res": the residual arm, no per-pattern solve: canonical w-rows, a
    native G-inverse per block and one batched K3 product per chunk
    (ops/wpath.res_apply_batch).  Raises when the native factorization is
    missing, where the JAX package quietly reroutes to the host;
  - "res_host" and "host": the native CPU arms, with no device half;
  - "auto": warm patterns (a device plan already cached) on the device,
    cold ones on "res_host" up to K' = NANORQ_RES_HOST_MAX (256), else on
    "host" -- the JAX package's rule, unchanged.

Not ported yet, and raising NotImplementedError: `mesh=` (ROADMAP Queue 1
item 10).
"""

import os

import numpy as np
import torch

from nanorq_tpu.codec import api as _api
from nanorq_tpu.codec import cache as _jcache
from nanorq_tpu.codec.partition import symbol_ranges
from nanorq_tpu.io.ioctx import IOContext
from nanorq_tpu.native import host_residual_flat, native_available, res_rinv
from nanorq_tpu.utils import stats
from nanorq_tpu_torch.codec import cache as _cache
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops import wpath
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays, replay

_NO_MESH = "mesh= is not ported yet (ROADMAP Queue 1 item 10, multi-GPU)"
_NO_FACTOR = ('backend "res" needs the native solver\'s canonical factorization, '
              "which is unavailable here; no other arm is taken in its place")
BACKENDS = ("auto", "device", "host", "res", "res_host")


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
        """Route every gap block to an arm and launch it; (ok, launched) as in
        nanorq_tpu (see the module docstring for the backends)."""
        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        backend = backend or os.environ.get("NANORQ_DECODE_BACKEND", "auto")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        work, ok = [], True
        for sbn in range(self.num_blocks):
            prep = self._repair_prepare(sbn)
            if isinstance(prep, bool):
                ok = ok and prep
            else:
                work.append((sbn, *prep))
        if not work:
            return ok, []
        if backend == "res":
            rok, launched = self._repair_residual_batch(work)
            return ok and rok, launched
        if backend == "device" or not native_available():
            dok, launched = self._repair_pipeline_device(work, max_workers)
            return ok and dok, launched

        rhost_work, host_work, dev_work = [], [], []
        if backend == "host":
            host_work = work
        elif backend == "res_host":
            rhost_work = work
        else:  # auto: warm plans on the device; cold patterns on the host
            small = self.P.Kp <= _api._RES_HOST_MAX
            for item in work:
                hit, plan = _cache.decoder_plan_cached(self.P, item[2], item[3])
                if hit and plan is not None:
                    dev_work.append(item)
                elif small:
                    rhost_work.append(item)
                else:
                    host_work.append(item)
        launched = []
        if rhost_work:
            rres = self._repair_residual_host_batch(rhost_work, io)
            if rres is None:  # no native factorization: the patched host solve
                host_work = host_work + rhost_work
            else:
                rok, results = rres
                ok = ok and rok
                launched.extend(results)
        if host_work:
            res = self._repair_host_batch(host_work, io)
            if res is None:  # native vanished mid-flight: everything on the device
                dev_work, launched = work, []
            else:
                hok, results = res
                ok = ok and hok
                launched.extend(results)
        if dev_work:
            dok, dlaunched = self._repair_pipeline_device(dev_work, max_workers)
            ok = ok and dok
            launched.extend(dlaunched)
        return ok, launched

    def _repair_residual_batch(self, work):
        """Residual arm (nanorq_tpu's _repair_residual_batch): repair without a
        per-pattern solve.  A received repair symbol is y = w . D over the
        canonical system, so y = W D0 + G X with G = W[:, gaps]; the host
        finds G's left inverse R (native res_rinv) and the device computes
        X = R (y ^ W D0) for a chunk of up to _BATCH_FLUSH blocks at once
        (wpath.res_apply_batch).  Rows and columns are padded to the chunk's
        largest block, not to a power of two: eager CUDA compiles nothing per
        shape, and zero rows are exact no-ops.

        work: [(sbn, gaps, isis, overhead)] -> (ok, [(sbn, gaps, view)]); a
        rank-deficient G fails its block.  Raises RuntimeError when the
        native factorization is unavailable."""
        P, T = self.P, self.scheme.T
        kc = _jcache.res_kcols(P)
        metas, Ws, Gs = [], [], []
        with stats.timer("res_prep"):
            for sbn, gaps, isis, ov in work:
                W = _cache.res_wrows(P, np.concatenate([isis[gaps], isis[P.Kp : P.Kp + ov]]))
                if W is None:
                    raise RuntimeError(_NO_FACTOR)
                metas.append((sbn, gaps))
                Ws.append(W)
                Gs.append(np.ascontiguousarray(W[:, gaps]))
        with stats.timer("res_rinv"):
            rr = res_rinv(Gs)
        if rr is None:
            raise RuntimeError(_NO_FACTOR)
        ok, items = True, []
        for meta, W, R, status in zip(metas, Ws, *rr):
            if status == 0:
                items.append((meta, W, R))
            else:
                stats.count("decode_rank_deficient")
                stats.count("repair_block_failed")
                ok = False
        stats.count("repair_res_blocks", len(items))
        dev, launched = self.device, []
        for c0 in range(0, len(items), self._BATCH_FLUSH):
            chunk = items[c0 : c0 + self._BATCH_FLUSH]
            nb = len(chunk)
            nr = max(W.shape[0] for _, W, _ in chunk)
            g = max(m[1].size for m, _, _ in chunk)
            Wst = np.zeros((nb, nr, kc), np.uint8)
            Rst = np.zeros((nb, g, nr), np.uint8)
            D0 = np.zeros((nb, kc, T), np.uint8)
            yst = np.zeros((nb, nr, T), np.uint8)
            for j, ((sbn, gaps), W, R) in enumerate(chunk):
                Wst[j, : W.shape[0]] = W
                Rst[j, : gaps.size, : W.shape[0]] = R
                b = self._block(sbn)
                if b.D is not None:
                    n = min(b.D.shape[0], kc)
                    D0[j, :n] = b.D[:n]
                yst[j, : W.shape[0]] = b.rep_rows[: W.shape[0]]
            res = _HostResult(wpath.res_apply_batch(_upload(Wst, dev), _upload(D0, dev),
                                                    _upload(Rst, dev), _upload(yst, dev)))
            launched.extend((m[0], m[1], _HostView(res, j)) for j, (m, _, _) in enumerate(chunk))
        return ok, launched

    def _repair_residual_host_batch(self, work, io: IOContext | None = None):
        """Solve-free CPU repair (nanorq_tpu's _repair_residual_host_batch,
        line for line, with the port's res_wrows_flat): X = R (y ^ W D0) run by
        the native host_residual_flat, reading payloads in place and writing
        recovered rows straight into a writable buffer `io`.

        work: [(sbn, gaps, isis, overhead)] -> (ok, [(sbn, gaps, rows | None)]),
        or None when the native factorization is unavailable (the caller
        reroutes to the host arm)."""
        P, T = self.P, self.scheme.T
        scheme = self.scheme
        kc = _jcache.res_kcols(P)
        Kp = P.Kp
        nb = len(work)
        with stats.timer("res_prep"):
            buf_base = None
            if io is not None and scheme.N == 1:
                buf = getattr(io, "buffer", None)
                if (buf is not None and io.writable and buf.flags["C_CONTIGUOUS"]
                        and buf.size >= scheme.F):
                    buf_base = np.uint64(buf.ctypes.data)
            isi_list, gaps_list = [], []
            for sbn, gaps, isis, ov in work:
                ng = gaps.size
                rep_isis = np.empty(ng + ov, np.uint32)
                rep_isis[:ng] = isis[gaps]
                rep_isis[ng:] = isis[Kp : Kp + ov]
                isi_list.append(rep_isis)
                gaps_list.append(gaps)
            flat = _cache.res_wrows_flat(P, isi_list)
            if flat is None:
                return None
            W_all, _, nrs = flat
            ngaps = np.fromiter((g.size for g in gaps_list), np.int64, nb)
            gaps_all = np.concatenate(gaps_list).astype(np.int32) if nb else np.zeros(0, np.int32)
            gaps_off = np.zeros(nb, np.int64)
            if nb > 1:
                np.cumsum(ngaps[:-1], out=gaps_off[1:])
            d0p_all = np.zeros(nb * kc, np.uint64)
            yp_all = np.empty(int(nrs.sum()), np.uint64)
            orow_all = np.empty(int(ngaps.sum()), np.uint64)
            temps: list = [None] * nb
            yo = oo = 0
            for j, (sbn, gaps, isis, ov) in enumerate(work):
                ng, nr = gaps.size, int(nrs[j])
                b = self._block(sbn)
                if b.D is not None:
                    have = np.nonzero(b.got)[0]
                    d0p_all[j * kc + have] = np.uint64(b.D.ctypes.data) + have.astype(
                        np.uint64) * np.uint64(b.D.strides[0])
                yp_all[yo : yo + nr] = np.uint64(b.rep_rows.ctypes.data) + np.arange(
                    nr, dtype=np.uint64) * np.uint64(b.rep_rows.strides[0])
                yo += nr
                op = None
                if buf_base is not None:
                    base = symbol_ranges(scheme, sbn, 0, b.K)[0][0]
                    offs = base + gaps.astype(np.uint64) * np.uint64(T)
                    if not (ng and int(offs[-1]) + T > scheme.F):  # short tail
                        op = buf_base + offs
                if op is None:
                    temps[j] = np.empty((ng, T), np.uint8)
                    op = np.uint64(temps[j].ctypes.data) + np.arange(ng, dtype=np.uint64) * np.uint64(T)
                orow_all[oo : oo + ng] = op
                oo += ng
        with stats.timer("host_residual"):
            statuses = host_residual_flat(kc, T, nrs, ngaps, gaps_all, gaps_off, W_all, d0p_all,
                                          yp_all, orow_all)
        if statuses is None:
            return None
        stats.count("repair_res_host_blocks", nb)
        ok, results = True, []
        for j, (sbn, gaps, _, _) in enumerate(work):
            if statuses[j] == 0:
                results.append((sbn, gaps, temps[j]))
            else:
                stats.count("decode_rank_deficient")
                stats.count("repair_block_failed")
                ok = False
        return ok, results

    def _repair_pipeline_device(self, work, max_workers: int | None = None, mesh=None):
        """Device arm: per-pattern plans solved in one worker thread while
        this thread launches each block as its solve lands; WSchedule
        blocks of one (kind, M_pad) are stacked into batches."""
        from concurrent.futures import ThreadPoolExecutor

        if mesh is not None:
            raise NotImplementedError(_NO_MESH)
        stats.count("repair_device_blocks", len(work))
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
