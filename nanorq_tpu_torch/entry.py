"""The flagship codec step on torch: counterpart of `__graft_entry__.entry()`.

One encode step at K=1000, T=1280: the structured replay of the per-K'
encoder schedule over `blocks` blocks laid side by side, then the LT combine
of all K' ISIs (the systematic window, whose first K rows reproduce the
source).
"""

import numpy as np
import torch

from nanorq_tpu_torch.codec.cache import encoder_schedule
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays, replay
from nanorq_tpu_torch.rfc.params import params_init


def flagship(device, K: int = 1000, T: int = 1280, blocks: int = 2, seed: int = 0):
    """(schedule tensors, LT plan, D [M_pad, blocks*T]) on `device`; the
    source rows of D are random bytes from `seed`."""
    dev = resolve(device)
    P = params_init(K)
    ds = encoder_schedule(P.Kp)
    D = np.zeros((ds.M_pad, blocks * T), np.uint8)
    D[:K] = np.random.default_rng(seed).integers(0, 256, (K, blocks * T), dtype=np.uint8)
    plan = lt_plan(np.arange(P.Kp, dtype=np.uint32), P, dev)
    return device_arrays(ds, dev), plan, torch.from_numpy(D).to(dev)


def step(arr: dict, plan, D: torch.Tensor) -> torch.Tensor:
    """Replay then LT combine: D [M_pad, t] -> symbols [n_pad, t]."""
    return lt_combine(replay(arr, D), plan)


def entry(device):
    """(fn, example_args) of the flagship step on `device`."""
    return step, flagship(device)
