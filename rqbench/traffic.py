"""The one traffic generator: what a mix file (`rqbench/traffic/<mix>.json`)
asks for, made from the seed.

A mix names the role (`send`: encode only; `receive`: decode only) over
the configuration's bulk object, the repair symbols the sender emits a block
(`repair_share` x K, rounded down), the loss model, the decoder's overhead
(`overhead` x K, rounded up), the burst of packets handed to one
`add_symbols` call, the pool of objects that the window cycles through, and
the objects of the warm-up.

Loss models (`loss.model`):
- `none`: every source symbol arrives;
- `fixed`: round(rate x K) source ESIs drawn once from the seed, lost in every
  block of every object (a storage node's stripe positions).

Packets go out in transmission order: block by block, the kept source ESIs
ascending, then the first (lost + overhead) repair ESIs.  A receiver takes
each block's packets in bursts, then repairs the block.  Tags are the FEC
payload ID of RFC 6330 s3.2: SBN in the top 8 bits, ESI in the low 24.
"""

import json
import math

import numpy as np


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def tag(sbn, esi):
    return (np.asarray(sbn, np.int64) << 24) | np.asarray(esi, np.int64)


def fixed_gaps(rng: np.random.Generator, K: int, rate: float) -> np.ndarray:
    return np.sort(rng.choice(K, int(round(rate * K)), replace=False))


def lost_esis(mix: dict, K: int, rng: np.random.Generator) -> np.ndarray:
    """The source ESIs lost in every block, as the mix's loss model draws them."""
    loss = mix.get("loss", {"model": "none"})
    if loss["model"] == "none":
        return np.zeros(0, np.int64)
    if loss["model"] == "fixed":
        return fixed_gaps(rng, K, loss["rate"])
    raise ValueError(f"unknown loss model {loss['model']!r}")


def n_repair(mix: dict, K: int) -> int:
    """Repair symbols a sender emits a block."""
    return max(1, int(mix["repair_share"] * K))


def overhead(mix: dict, K: int) -> int:
    return math.ceil(mix["overhead"] * K) if "overhead" in mix else 0


class Stream:
    """The packets of one object in transmission order: `rows` indexes the
    rows of [source rows of every block (Z*K), then repair rows (Z*n)], `tags`
    the FEC payload IDs, `starts[b]` the first packet of block b; `lost` the
    lost ESIs of each block."""

    def __init__(self, Z: int, K: int, n: int, gaps: list, ov: int):
        rows, tags = [], []
        for b, g in enumerate(gaps):
            keep = np.ones(K, bool)
            keep[g] = False
            src = np.nonzero(keep)[0]
            m = g.size + ov
            if m > n:
                raise ValueError(f"block {b} lost {g.size} symbols: {m} repair symbols needed, {n} sent")
            rows += [b * K + src, Z * K + b * n + np.arange(m)]
            tags += [tag(b, src), tag(b, K + np.arange(m))]
        self.rows = np.concatenate(rows)
        self.tags = np.concatenate(tags)
        self.starts = np.searchsorted(self.tags >> 24, np.arange(Z + 1))
        self.lost = gaps

    def __len__(self) -> int:
        return self.rows.size

    def payloads(self, rows: np.ndarray) -> np.ndarray:
        """The packets' payloads [len, T], gathered from `rows`: the source
        rows of every block (Z*K), then the repair rows (Z*n)."""
        return np.take(rows, self.rows, axis=0)

    def blocks(self, payloads: np.ndarray, size: int):
        """(sbn, [(payloads, tags)] of its packets in bursts of `size`) for each block in order."""
        for b in range(len(self.starts) - 1):
            lo, hi = self.starts[b], self.starts[b + 1]
            yield b, [(payloads[s : min(s + size, hi)], self.tags[s : min(s + size, hi)]) for s in range(lo, hi, size)]
