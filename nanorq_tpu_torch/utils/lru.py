"""Byte-budgeted LRU cache.

The decode-plan and LT-plan caches hold multi-MB artifacts (dense W bit
matrices, structured-replay index tensors, device-resident gather plans)
whose size scales with K'^2 or K' — an entry-count bound lets 128 cached
K'=50511 patterns pin multiple GB of host RAM.  This LRU accounts cost in
BYTES (caller-estimated via deep_nbytes) and evicts oldest-first until the
budget holds, counting evictions in utils.stats so soaks can watch them.
"""

from collections import OrderedDict
from threading import Lock

import numpy as np


def deep_nbytes(obj, _depth: int = 0) -> int:
    """Approximate host-side byte cost of a plan object: the summed nbytes of
    every NumPy / JAX array reachable through tuples, lists, dicts, and
    object attributes (dataclasses, __slots__ classes).  Scalars and small
    Python structure are ignored — arrays dominate every cached plan."""
    if _depth > 8 or obj is None:
        return 0
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    nb = getattr(obj, "nbytes", None)  # jax.Array and friends
    if isinstance(nb, int) and not isinstance(obj, (bool, int)):
        return nb
    if isinstance(obj, (list, tuple)):
        return sum(deep_nbytes(v, _depth + 1) for v in obj)
    if isinstance(obj, dict):
        return sum(deep_nbytes(v, _depth + 1) for v in obj.values())
    if isinstance(obj, (str, bytes, int, float, bool)):
        return 0
    slots = getattr(type(obj), "__slots__", None)
    if slots:
        return sum(deep_nbytes(getattr(obj, s, None), _depth + 1) for s in slots)
    d = getattr(obj, "__dict__", None)
    if d:
        return sum(deep_nbytes(v, _depth + 1) for v in d.values())
    return 0


class ByteLRU:
    """Thread-safe LRU with a byte budget.

    Entries are (value, cost) pairs; None values are legal (the decoder
    caches rank-deficient outcomes) and cost a nominal constant.  At least
    one entry is always retained so a single over-budget plan still caches.
    """

    _MISS = object()

    def __init__(self, budget_bytes: int, name: str):
        self._d: OrderedDict = OrderedDict()
        self._lock = Lock()
        self.budget = int(budget_bytes)
        self.name = name
        self.bytes = 0

    def get(self, key):
        """(hit, value); hit distinguishes a cached None from a miss."""
        with self._lock:
            v = self._d.get(key, self._MISS)
            if v is self._MISS:
                return False, None
            self._d.move_to_end(key)
            return True, v[0]

    def peek(self, key):
        """key's value, or None on a miss, leaving the order as it is."""
        with self._lock:
            v = self._d.get(key)
            return None if v is None else v[0]

    def put(self, key, value, nbytes: int | None = None) -> None:
        from nanorq_tpu_torch.utils import stats

        cost = 64 if value is None else (deep_nbytes(value) if nbytes is None else int(nbytes))
        cost += len(key) if isinstance(key, (bytes, str)) else 0
        with self._lock:
            old = self._d.pop(key, self._MISS)
            if old is not self._MISS:
                self.bytes -= old[1]
            self._d[key] = (value, cost)
            self.bytes += cost
            while self.bytes > self.budget and len(self._d) > 1:
                _, (_, c) = self._d.popitem(last=False)
                self.bytes -= c
                stats.count(f"{self.name}_evict")

    def evict(self, keep=None) -> int:
        """Evict every entry but `keep`'s, counted as the budget's evictions
        are; returns the bytes they cost."""
        from nanorq_tpu_torch.utils import stats

        with self._lock:
            evicted = [(k, c) for k, (_, c) in self._d.items() if k != keep]
            for k, c in evicted:
                del self._d[k]
                self.bytes -= c
                stats.count(f"{self.name}_evict")
        return sum(c for _, c in evicted)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self.bytes = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)
