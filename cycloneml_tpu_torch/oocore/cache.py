"""Content-hash shard-set reuse: spill once, attach many.

The port's counterpart of ``cycloneml_tpu/oocore/cache.py``. A re-fit over
the same in-core dataset (a warm start, the second fit of a degraded
configuration, CV folds) would write the same spill again, an O(n d) disk
write a fit. The cache keys a spilled :class:`~.shards.StreamingDataset`
by content: a sha256 of the SOURCE dataset (read back from the device in
bounded row slices, O(shard) host memory, memoized on the dataset), the
stream tier, the shard rows and the geometry; an equal request ATTACHES to
the existing shard files and writes 0 bytes.

- **bounded**: the cached shard bytes stay under
  ``cyclone.oocore.cacheBytes``, LRU-evicted (0 disables reuse);
- **pinned**: attached handles refcount their entry; eviction takes only
  entries with no handle, so files are never removed under a live stream;
- **checked**: every shard file's sha256 is taken at insert and checked
  again at every attach; a mismatch evicts the entry and rebuilds it from
  the source.
"""

from __future__ import annotations

import atexit
import hashlib
import logging
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from cycloneml_tpu_torch.oocore.shards import (StreamingDataset,
                                               _pad_geometry, _stream_intent)

logger = logging.getLogger(__name__)

#: rows a fingerprint slice reads back at a time
_FP_SLICE_ROWS = 65536


class _Entry:
    __slots__ = ("key", "sds", "nbytes", "shard_hashes", "refs")

    def __init__(self, key: str, sds: StreamingDataset, nbytes: int,
                 shard_hashes: List[str]):
        self.key = key
        self.sds = sds
        self.nbytes = nbytes
        self.shard_hashes = shard_hashes
        self.refs = 0


class _SharedShardSet(StreamingDataset):
    """A non-owning view of a cached shard set: the whole
    :class:`StreamingDataset` surface over SHARED files, under the
    attaching dataset's context, whose ``close()`` releases the cache's
    refcount instead of removing them, so every consumer keeps its
    ``finally: sds.close()``."""

    def __init__(self, cache: "ShardSetCache", key: str,
                 base: StreamingDataset, ctx):
        super().__init__(ctx, base._shards, base.n_features,
                         base.pad_rows, base._moments, base._dir, False,
                         x_dtype=base.x_dtype, y_dtype=base.y_dtype,
                         x_scale=base.x_scale)
        self._cache = cache
        self._cache_key = key

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._cache.release(self._cache_key)


#: threads hashing shard files or fingerprint slices side by side
# (hashlib releases the GIL over large buffers)
_HASH_THREADS = max(1, min(8, os.cpu_count() or 1))


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def _files_sha256(paths) -> List[str]:
    """Every file's sha256, the files hashed side by side."""
    with ThreadPoolExecutor(_HASH_THREADS,
                            thread_name_prefix="cyclone-oocore-hash") as p:
        return list(p.map(_file_sha256, paths))


def _slice_digest(block: torch.Tensor) -> bytes:
    return hashlib.sha256(block.view(torch.uint8).numpy()).digest()


def _dataset_fingerprint(ds) -> str:
    """sha256 of the source dataset's content: the sha256s of X's bounded
    row slices (read back one at a time, hashed side by side, a few
    slices in flight, so O(slice) host memory), y, w, and what else
    changes the spilled bytes (shape, storage dtype, the fp8 scale, the
    mask of real rows). Memoized on the dataset: CV folds re-fitting one
    dataset hash it once."""
    fp = getattr(ds, "_oocore_fingerprint", None)
    if fp is not None:
        return fp
    h = hashlib.sha256()
    h.update(f"{ds.shape}|{ds.n_rows}|{ds.x.dtype}".encode())
    n_pad = int(ds.x.shape[0])
    with ThreadPoolExecutor(_HASH_THREADS,
                            thread_name_prefix="cyclone-oocore-hash") as p:
        pending = []
        for lo in range(0, n_pad, _FP_SLICE_ROWS):
            block = ds.x[lo:lo + _FP_SLICE_ROWS].contiguous().cpu()
            pending.append(p.submit(_slice_digest, block))
            if len(pending) >= _HASH_THREADS:
                h.update(pending.pop(0).result())
        for f in pending:
            h.update(f.result())
    h.update(np.ascontiguousarray(
        np.asarray(ds.y_host(), dtype=np.float64)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(ds.w_host(), dtype=np.float64)).tobytes())
    if ds.x_scale is not None:
        h.update(np.ascontiguousarray(ds.x_scale, np.float64).tobytes())
    mask = getattr(ds, "_valid_mask", None)
    if mask is not None:
        h.update(np.ascontiguousarray(np.asarray(mask)).tobytes())
    fp = h.hexdigest()
    ds._oocore_fingerprint = fp
    return fp


class ShardSetCache:
    """Process-wide, byte-bounded, refcounted LRU of spilled shard sets."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions_lru = 0
        self.evictions_corrupt = 0
        self.spill_write_bytes = 0

    def attach(self, ds, shard_rows: Optional[int] = None,
               spill_dir: Optional[str] = None) -> StreamingDataset:
        """A shard set for ``ds``, attached to a cached spill when the
        content key matches (:func:`engine.shard_dataset`'s body). A
        caller's ``spill_dir`` and ``cacheBytes=0`` bypass the cache: the
        handle then owns its files."""
        from cycloneml_tpu_torch.conf import OOCORE_CACHE_BYTES
        conf = getattr(ds.ctx, "conf", None)
        bound = int(conf.get(OOCORE_CACHE_BYTES)) if conf is not None \
            else (1 << 30)
        if spill_dir is not None or bound <= 0:
            return StreamingDataset.from_dataset(ds, shard_rows=shard_rows,
                                                 spill_dir=spill_dir)
        key = self._key(ds, shard_rows)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.refs += 1
                self._entries.move_to_end(key)
        if entry is not None:
            if self._verify(entry):
                with self._lock:
                    self.hits += 1
                logger.info("oocore: shard-set cache hit (%d shards, 0 "
                            "spill-write bytes)", entry.sds.n_shards)
                return _SharedShardSet(self, key, entry.sds, ds.ctx)
            # corrupt: drop our reference, evict, rebuild from the source
            with self._lock:
                entry.refs -= 1
                if self._entries.get(key) is entry:
                    del self._entries[key]
                self.evictions_corrupt += 1
            logger.warning("oocore: a cached shard set failed its sha256 "
                           "check — evicting it and rebuilding from the "
                           "source")
            if entry.refs <= 0:
                entry.sds.close()
        return self._build(ds, key, shard_rows, bound)

    def release(self, key: str) -> None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.refs = max(entry.refs - 1, 0)

    def _key(self, ds, shard_rows: Optional[int]) -> str:
        from cycloneml_tpu_torch.conf import OOCORE_SHARD_ROWS
        from cycloneml_tpu_torch.dataset.instance import (compute_dtype,
                                                          data_dtype)
        conf = getattr(ds.ctx, "conf", None)
        if shard_rows is None:
            shard_rows = int(conf.get(OOCORE_SHARD_ROWS)) \
                if conf is not None else 65536
        ident = "|".join([
            _dataset_fingerprint(ds), _stream_intent(conf),
            str(data_dtype(conf, fp8_capable=True)),
            str(compute_dtype(conf)),
            str(max(int(shard_rows), 1)), str(_pad_geometry(ds.ctx, 1)),
            str(ds.n_features)])
        return hashlib.sha256(ident.encode()).hexdigest()

    def _verify(self, entry: _Entry) -> bool:
        try:
            return _files_sha256([s.path for s in entry.sds._shards]) \
                == entry.shard_hashes
        except OSError:
            return False

    def _build(self, ds, key: str, shard_rows: Optional[int],
               bound: int) -> StreamingDataset:
        with self._lock:
            self.misses += 1
        sds = StreamingDataset.from_dataset(ds, shard_rows=shard_rows)
        hashes = _files_sha256([s.path for s in sds._shards])
        nbytes = sum(sds.shard_nbytes(i) for i in range(sds.n_shards))
        entry = _Entry(key, sds, nbytes, hashes)
        entry.refs = 1
        evicted: List[_Entry] = []
        with self._lock:
            self.spill_write_bytes += nbytes
            self._entries[key] = entry
            total = sum(e.nbytes for e in self._entries.values())
            while total > bound:
                victim_key = next((k for k, e in self._entries.items()
                                   if e.refs <= 0 and k != key), None)
                if victim_key is None:
                    break  # everything left is pinned: the bound yields
                victim = self._entries.pop(victim_key)
                evicted.append(victim)
                total -= victim.nbytes
            self.evictions_lru += len(evicted)
        for victim in evicted:
            victim.sds.close()
        return _SharedShardSet(self, key, sds, ds.ctx)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictionsLru": self.evictions_lru,
                    "evictionsCorrupt": self.evictions_corrupt,
                    "spillWriteBytes": self.spill_write_bytes,
                    "entries": len(self._entries),
                    "bytes": sum(e.nbytes for e in self._entries.values())}

    def clear(self) -> None:
        """Drop every entry and remove its files (entries with live
        handles leave the index; their files go with the base set)."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.sds.close()


_cache = ShardSetCache()
# cached spills outlive their fits, not the process
atexit.register(_cache.clear)


def shard_set_cache() -> ShardSetCache:
    """The process's shard-set cache."""
    return _cache
