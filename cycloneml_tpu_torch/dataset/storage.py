"""Storage tiers with eviction: the BlockManager memory store's analog.

The port's counterpart of ``cycloneml_tpu/dataset/storage.py`` (ref:
core/.../storage/BlockManager.scala and memory/StorageMemoryPool: the
reference caches RDD blocks in a bounded memory store and evicts the least
recently used ones to disk under pressure). The cached unit is a whole
``InstanceDataset``, and the tiers are:

- DEVICE: its tensors on the card (the default placement);
- HOST: ``persist_host()``, CPU tensors in driver memory, the card's
  released;
- DISK: ``persist_disk()``, an npz spill file, placed back on the card at
  the next access.

:class:`StorageManager` tracks registered datasets with a byte budget for
the DEVICE and the HOST tier and demotes the least recently used dataset
one tier down when a budget is exceeded (MEMORY_AND_DISK: data is never
dropped; a demotion always lands in a durable tier). A dataset's bytes are
its padded tensors' own sizes, taken when it was made, so accounting never
touches (and so never restores) its tensors. Datasets that share tensors
(``derive`` lineage, or the same storage among the managed datasets) are
never eviction candidates: freeing one side's tensors would not free the
memory, and the other side still reads them.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
import weakref
from typing import Dict, Optional

from cycloneml_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)


class StorageLevel:
    DEVICE = "DEVICE"
    HOST = "HOST"
    DISK = "DISK"


_ORDER = [StorageLevel.DEVICE, StorageLevel.HOST, StorageLevel.DISK]


def _spill_file(path: str) -> str:
    """The name ``persist_disk`` writes for a spill ``path``."""
    return path if path.endswith(".npz") else path + ".npz"


def _unlink_spill(path: Optional[str]) -> None:
    if path:
        try:
            os.unlink(_spill_file(path))
        except OSError:
            pass


def _cleanup_entry(mgr_ref, key: int) -> None:
    """``weakref.finalize`` hook: a collected managed dataset drops its
    entry and its spill file (module-level, so the finalizer pins neither
    the manager nor the dataset)."""
    mgr = mgr_ref()
    if mgr is None:
        return
    with mgr._lock:
        e = mgr._entries.pop(key, None)
    _unlink_spill(e["path"] if e else None)


def _storages(ds) -> set:
    """The data pointers of the storages behind the tensors ``ds`` holds
    on any tier (empty tensors aside)."""
    out = set()
    for t in (ds._x, ds._y, ds._w):
        if t is not None:
            ptr = t.untyped_storage().data_ptr()
            if ptr:
                out.add((t.device.type, t.device.index, ptr))
    return out


class StorageManager:
    """Bounded multi-tier dataset cache with least-recently-used demotion.

    ``device_budget``/``host_budget`` are byte budgets of the DEVICE and
    HOST tiers (None: unbounded); DISK is unbounded. Spill files go to
    ``spill_dir``, or to a temporary directory the manager makes at its
    first spill and removes in :meth:`close`."""

    def __init__(self, device_budget: Optional[int] = None,
                 host_budget: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        self.device_budget = device_budget
        self.host_budget = host_budget
        self._spill_dir = spill_dir
        self._own_dir = False
        self._lock = threading.RLock()
        # id(ds) -> {ds (weakref), level, bytes, last_used, path}: entries
        # hold their dataset weakly; the manager accounts for blocks and
        # does not extend their lifetime (the reference's ContextCleaner)
        self._entries: Dict[int, dict] = {}

    # -- public surface ------------------------------------------------------
    def persist(self, ds, level: str = StorageLevel.DEVICE):
        """Register ``ds`` at ``level``; may demote older datasets to keep
        the budgets. The dataset's own restores (a read of ``ds.x`` on a
        lower tier) notify the manager, so accounting follows the normal
        read path."""
        if level not in _ORDER:
            raise ValueError(f"unknown storage level {level!r}")
        with self._lock:
            key = id(ds)
            entry = {"ds": weakref.ref(ds), "level": level,
                     "bytes": ds.padded_bytes(),
                     "last_used": time.monotonic(), "path": None}
            old = self._entries.get(key)
            if old is not None:
                entry["path"] = old["path"]
            self._entries[key] = entry
            ref = weakref.ref(self)
            ds._storage_cb = lambda d: (ref() and ref()._on_restore(d))
            if old is None:
                weakref.finalize(ds, _cleanup_entry, ref, key)
            self._apply_level(entry, level)
            self._enforce()
        return ds

    def _on_restore(self, ds) -> None:
        """A managed dataset placed itself back on the device: relabel,
        drop the now redundant host copy, enforce the budgets again."""
        with self._lock:
            e = self._entries.get(id(ds))
            if e is None:
                return
            e["level"] = StorageLevel.DEVICE
            e["last_used"] = time.monotonic()
            ds._host = None  # the device copy is the dataset again
            self._enforce()

    def touch(self, ds) -> None:
        """Record an access without moving data."""
        with self._lock:
            e = self._entries.get(id(ds))
            if e is None:
                return
            e["last_used"] = time.monotonic()
            if ds._x is not None:
                e["level"] = StorageLevel.DEVICE
            self._enforce()

    def migrate_device_to_host(self):
        """Move every live DEVICE-tier dataset to the host tier (the
        decommission hop, ref BlockManagerDecommissioner.scala:40).
        Returns ``(datasets, bytes)``. The first failure raises and leaves
        the rest where they are: a DEVICE-only dataset has no other
        copy."""
        migrated = []
        moved_bytes = 0
        with self._lock:
            for e in self._entries.values():
                ds = e["ds"]()
                if ds is None or e["level"] != StorageLevel.DEVICE:
                    continue
                try:
                    ds.persist_host()
                except Exception as exc:
                    raise RuntimeError(
                        f"decommission aborted: dataset {id(ds):#x} could "
                        f"not be migrated off the device tier ({exc!r}); "
                        "the mesh is untouched — free host memory or "
                        "checkpoint the dataset and retry") from exc
                e["level"] = StorageLevel.HOST
                migrated.append(ds)
                moved_bytes += e["bytes"]
        return migrated, moved_bytes

    def unpersist(self, ds) -> None:
        """Stop managing ``ds``. Data is never dropped: a DISK-tier dataset
        is read back to the host tier before its spill file goes."""
        with self._lock:
            e = self._entries.pop(id(ds), None)
            ds._storage_cb = None
            if e is None:
                return
            if e["level"] == StorageLevel.DISK and e["path"]:
                ds._host = ds._read_disk(_spill_file(e["path"]))
                ds._disk_path = None
            _unlink_spill(e["path"])

    def level_of(self, ds) -> Optional[str]:
        with self._lock:
            e = self._entries.get(id(ds))
            return e["level"] if e else None

    def usage(self) -> Dict[str, int]:
        """Bytes held in each tier by the live managed datasets."""
        with self._lock:
            self._prune()
            out = {lvl: 0 for lvl in _ORDER}
            for e in self._entries.values():
                out[e["level"]] += e["bytes"]
            return out

    def close(self) -> None:
        """Remove every spill file, and the spill directory if the manager
        made it (context shutdown). Managed datasets stay where they are:
        a DISK-tier dataset keeps its data only if it was unpersisted
        first, which reads it back."""
        with self._lock:
            for e in self._entries.values():
                _unlink_spill(e["path"])
            self._entries = {}
            if self._own_dir and self._spill_dir:
                shutil.rmtree(self._spill_dir, ignore_errors=True)
                self._spill_dir = None
                self._own_dir = False

    # -- mechanics -----------------------------------------------------------
    def _prune(self) -> None:
        dead = [k for k, e in self._entries.items() if e["ds"]() is None]
        for k in dead:
            _unlink_spill(self._entries.pop(k)["path"])

    def _spill_path(self, ds) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="cyclone-store-")
            self._own_dir = True
        os.makedirs(self._spill_dir, exist_ok=True)
        return os.path.join(self._spill_dir, f"block-{id(ds)}")

    def _apply_level(self, e: dict, level: str) -> None:
        ds = e["ds"]()
        if ds is None:
            return
        if level == StorageLevel.DEVICE:
            ds.x  # the property access places a released dataset back
        elif level == StorageLevel.HOST:
            if ds._x is not None:
                ds.persist_host()
        elif level == StorageLevel.DISK:
            if e["path"] is None:
                e["path"] = self._spill_path(ds)
            # persist_disk writes from the host copy when there is one: a
            # HOST -> DISK demotion never goes through the device
            ds.persist_disk(e["path"])
        e["level"] = level

    def _shares_arrays(self, ds) -> bool:
        """True when ``ds`` shares tensors with a live dataset: a
        ``derive`` relative (the reference's ``_shares_arrays`` rule), or
        another managed dataset over the same storage. Demoting it would
        free no memory and would take the tensors from under the other."""
        p = getattr(ds, "_array_parent", None)
        if p is not None and p() is not None:
            return True
        kids = getattr(ds, "_derived_children", None)
        if kids is not None and len(kids) > 0:
            return True
        mine = _storages(ds)
        if not mine:
            return False
        for e in self._entries.values():
            other = e["ds"]()
            if other is not None and other is not ds and \
                    mine & _storages(other):
                return True
        return False

    def _enforce(self) -> None:
        self._prune()
        for level, budget in ((StorageLevel.DEVICE, self.device_budget),
                              (StorageLevel.HOST, self.host_budget)):
            if budget is None:
                continue
            while True:
                entries = [e for e in self._entries.values()
                           if e["level"] == level]
                used = sum(e["bytes"] for e in entries)
                # the most recently used entry is never demoted: it may be
                # the dataset a read just placed back (an over-budget
                # single block stays put, as the reference keeps a block
                # larger than the store)
                candidates = [e for e in sorted(
                    entries, key=lambda e: e["last_used"])[:-1]
                    if e["ds"]() is not None
                    and not self._shares_arrays(e["ds"]())]
                if used <= budget or not candidates:
                    if used > budget:
                        logger.warning(
                            "storage: %s over budget (%d > %d) with no "
                            "evictable entry", level, used, budget)
                    break
                victim = candidates[0]
                nxt = _ORDER[_ORDER.index(level) + 1]
                logger.info("storage: evicting %d bytes %s -> %s",
                            victim["bytes"], level, nxt)
                self._apply_level(victim, nxt)
