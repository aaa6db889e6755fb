"""Device-resident scan cache: device memory is the buffer pool.

The port of arrow_ballista_tpu/utils/table_cache.py.  A scan's expensive
step is not the disk read but the host conversion and the host->device
copy, so the converted device batches stay resident across queries.

Granularity: one entry per (scan partition, projection, capacity, torch
device) — the exact list of ColumnBatches a ``ScanExec`` produces BEFORE
filter masks are applied (filters derive new masks on top).  Keys embed
file mtime and size, so a rewritten file can never serve stale rows;
stale entries age out by LRU.  The device is part of the key, so a CPU
context and a card context in one process never share an entry.

Cached batches are shared by every later query: nothing downstream may
write into their tensors (the port updates only tensors it has just
allocated; ``tests/test_torch_parquet.py`` fingerprints every cached
tensor around q1, q3, q4 and q18).

Budget: bytes of device tensors (columns + mask, ``tensor.nbytes``),
LRU-evicted.  Host-side string dictionaries ride along uncounted.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

DEFAULT_BUDGET = 6 << 30
# the CPU: "device" tensors ARE host memory, so the pool stays small there
DEFAULT_BUDGET_CPU = 1 << 30


def _batch_bytes(b) -> int:
    n = int(b.mask.nbytes)
    for v in b.columns.values():
        n += int(v.nbytes)
    return n


class DeviceTableCache:
    def __init__(self, budget_bytes: int = DEFAULT_BUDGET):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, Tuple[list, int]]" = OrderedDict()
        self._bytes = 0
        self._budget = budget_bytes
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def set_budget(self, budget_bytes: int) -> None:
        with self._lock:
            if budget_bytes == self._budget:
                return
            self._budget = budget_bytes
            self._evict_locked()

    def get(self, key: Tuple) -> Optional[List]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return list(entry[0])

    def put(self, key: Tuple, batches: List) -> None:
        size = sum(_batch_bytes(b) for b in batches)
        with self._lock:
            if size > self._budget:
                return  # larger than the whole pool: never cache
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (list(batches), size)
            self._bytes += size
            self._evict_locked()

    def _evict_locked(self) -> None:
        while self._bytes > self._budget and self._entries:
            _, (_, size) = self._entries.popitem(last=False)
            self._bytes -= size
            self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def entries(self) -> List[Tuple[Tuple, list]]:
        """(key, batches) of every resident entry, least recent first."""
        with self._lock:
            return [(k, list(v[0])) for k, v in self._entries.items()]

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "budget": self._budget,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }


# process-wide: every context of the process shares one pool (the key holds
# the device)
CACHE = DeviceTableCache()


def resolve_budget(value, device=None) -> int:
    """Config value -> bytes.  '0'/0 disables the cache.  'auto' is keyed
    on the torch device the scan runs on (None: the card): the card gets
    the large default, the CPU the small one."""
    import torch

    from ..client.context import resolve_device

    if isinstance(value, str):
        if value.strip().lower() == "auto":
            dev = resolve_device() if device is None else torch.device(device)
            return DEFAULT_BUDGET if dev.type == "cuda" else DEFAULT_BUDGET_CPU
        value = int(value)
    return int(value)
