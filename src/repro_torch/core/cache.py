"""Bounded LRU caches for the re-plan fast path.

DISTAL-style systems separate the expensive format/partition *assembly*
step from steady-state execution; our analog is a set of content-keyed
caches (shard materialization in :mod:`.partition`, plan memoization and
runners in :mod:`.lower`) all built on this one LRU. Keys are
content fingerprints (CRC over storage regions), so a re-plan over
unchanged operands is near-free while any value or structure change —
including in-place mutation — misses and re-packs.

Every cache is bounded (the unbounded-growth latent in the original
one-off add-stream cache) and keeps ``hits`` / ``misses`` / ``evictions``
counters that :class:`repro_torch.core.lower.LoweredKernel` snapshots per lower
call (``kernel.cache``), alongside ``CommStats``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Sequence, Tuple


def avals_key(arrays: Sequence) -> Tuple:
    """Shapes/dtypes key component of the runner cache (core.lower._runner).
    Works on numpy arrays and torch tensors alike."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in arrays)


#: Default batch-size buckets for the serving fast path. Every incoming
#: batch pads up to the smallest bucket >= its size, so the compiled-runner
#: caches (keyed on avals, hence on the padded batch width) see at most
#: ``len(BATCH_BUCKETS)`` distinct SpMM widths no matter how request counts
#: fluctuate — bounded recompilation under mixed traffic.
BATCH_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


def batch_bucket(n: int, buckets: Sequence[int] = BATCH_BUCKETS) -> int:
    """Smallest bucket >= ``n`` (next power of two beyond the table, so an
    oversized burst still lands on one of O(log n) shapes)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    b = 1 << (int(n) - 1).bit_length()
    return int(b)


# Private miss sentinel: ``None`` is a legitimate cached value (e.g. the
# tuned-plan cache recording "no feasible candidate"), so misses must be
# distinguishable from stored Nones.
_MISSING = object()


class LRUCache:
    """A bounded mapping with least-recently-used eviction + counters."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.stats: Dict[str, int] = {"hits": 0, "misses": 0, "evictions": 0}

    def get(self, key: Hashable, default: Optional[Any] = None) -> Any:
        """Return the cached value (refreshing recency) or ``default``;
        counts a hit or a miss either way — pair every ``get`` with a
        ``put`` on a miss so the counters read as cache effectiveness.
        Pass a private sentinel as ``default`` when stored values may
        themselves be None."""
        try:
            value = self._d[key]
        except KeyError:
            self.stats["misses"] += 1
            return default
        self._d.move_to_end(key)
        self.stats["hits"] += 1
        return value

    def put(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.stats["evictions"] += 1

    def get_or_build(self, key: Hashable, factory: Callable[[], Any]) -> Any:
        """Return the cached value, or build + insert it (one hit or miss
        is counted either way). A factory that returns None caches None —
        subsequent calls hit instead of rebuilding."""
        value = self.get(key, _MISSING)
        if value is _MISSING:
            value = factory()
            self.put(key, value)
        return value

    def set_capacity(self, capacity: int) -> None:
        """Re-bound the cache (evicting oldest entries if shrinking)."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.stats["evictions"] += 1

    def clear(self) -> None:
        """Drop all entries (counters are kept; reset via reset_stats)."""
        self._d.clear()

    def reset_stats(self) -> None:
        self.stats.update(hits=0, misses=0, evictions=0)

    def items(self):
        """Snapshot of (key, value) pairs, oldest → newest. No recency or
        counter effects — the observability/checkpoint-export view (the
        tuned-plan cache rides checkpoints so an elastic restart skips
        re-search; see runtime/checkpoint.py)."""
        return list(self._d.items())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:  # no recency update
        return key in self._d
