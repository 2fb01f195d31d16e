"""Host staging for the streamed readers: a ring of pinned buffers and a
copy stream.

The reference places each parsed chunk with a synchronous ``device_put``
(``cycloneml_tpu/dataset/sparse.py:324-328``). On the card the port stages a
chunk in one slot of a ring of two pinned host buffers (double buffering)
and copies it with ``non_blocking=True`` on a side stream, so that the host
parses the next chunk into the other slot while the copy runs (the scanner
releases the GIL). A slot is written again only after the event recorded
behind its last copy has completed, and :meth:`StagingRing.finish` makes
the caller's stream wait on the copy stream, without blocking the host:
every later use of the copied tensors on the caller's stream is ordered
after the copies.

On the CPU (``cyclone.master=cpu``) the same ring holds plain buffers and
a copy is a clone, so that every reader runs one code path.

The out-of-core stream (``oocore/stream.py``) uses the ring with a DEVICE
TWIN per slot: device buffers allocated once (:meth:`StagingRing.twin`)
that every shard staged through the slot is copied into
(:meth:`StagingRing.put_into`), so that the stream's device memory is the
slots' and not the dataset's. A slot is then rewritten only after two
things: its earlier copy finished, waited for on the host
(:meth:`StagingRing.wait_copied`) before the host buffer is written; and
the kernel that read its device twin finished, which the copy stream
waits for on the device, on an event the caller records on its own stream
after the shard's launch (:meth:`StagingRing.consumed`).
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

_SLOTS = 2   # double buffering: one slot parses while the other copies


class StagingRing:
    """Two slots of named host buffers, and the copies out of them onto
    ``device``. ``stats`` gathers the time the host waited for a slot
    (``wait_s``), the host time of the device allocations (``alloc_s``),
    the bytes copied, the largest copy's bytes (``max_copy_bytes``: one
    chunk) and the copies' time (``copy_s``; on the card read from CUDA
    events by :meth:`copy_seconds`)."""

    def __init__(self, device: torch.device, slots: int = _SLOTS):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.n_slots = int(slots)
        self._slots: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(self.n_slots)]
        self._twins: List[Dict[str, torch.Tensor]] = [
            {} for _ in range(self.n_slots)]
        self._done: List = [None] * self.n_slots
        self._consumed: List = [None] * self.n_slots
        self._timing: List = []   # (start, end) events of every copy
        self._next = 0
        self.stats = {"wait_s": 0.0, "alloc_s": 0.0, "copy_s": 0.0,
                      "bytes": 0, "copies": 0, "max_copy_bytes": 0}

    def acquire(self) -> int:
        """The next slot, once the copies out of it have completed."""
        slot = self._next
        self._next = (slot + 1) % self.n_slots
        self.wait_copied(slot)
        return slot

    def wait_copied(self, slot: int) -> None:
        """Wait on the host until the last copy out of slot ``slot``'s
        host buffers has completed (time counted in ``wait_s``)."""
        done = self._done[slot]
        if done is not None:
            t0 = time.perf_counter()
            done.synchronize()
            self.stats["wait_s"] += time.perf_counter() - t0
            self._done[slot] = None

    def twin(self, slot: int, name: str, shape, dtype: torch.dtype
             ) -> torch.Tensor:
        """Slot ``slot``'s device buffer ``name``, allocated at the first
        call on the caller's stream (the copy stream then waits on the
        caller's stream once: memory the allocator hands back may still
        be read there) and reused by every later call."""
        buf = self._twins[slot].get(name)
        if buf is None or tuple(buf.shape) != tuple(shape) \
                or buf.dtype != dtype:
            t0 = time.perf_counter()
            buf = torch.empty(shape, dtype=dtype, device=self.device)
            self.stats["alloc_s"] += time.perf_counter() - t0
            if self.cuda:
                self.stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            self._twins[slot][name] = buf
        return buf

    def put_into(self, slot: int, views: List[torch.Tensor],
                 twins: List[torch.Tensor]):
        """Copy host views into slot ``slot``'s device twins on the copy
        stream, after the kernel that last read them (:meth:`consumed`).
        Returns the event that ends the copies (None on the CPU, where the
        copies are done on return): the caller's stream waits on it
        before reading the twins (:meth:`ready`)."""
        size = sum(v.numel() * v.element_size() for v in views)
        self.stats["bytes"] += size
        self.stats["copies"] += 1
        self.stats["max_copy_bytes"] = max(self.stats["max_copy_bytes"],
                                           size)
        if not self.cuda:
            t0 = time.perf_counter()
            for dst, src in zip(twins, views):
                dst.copy_(src)
            self.stats["copy_s"] += time.perf_counter() - t0
            return None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            if self._consumed[slot] is not None:
                self.stream.wait_event(self._consumed[slot])
            start.record()
            for dst, src in zip(twins, views):
                dst.copy_(src, non_blocking=True)
            end.record()
        self._timing.append((start, end))
        self._done[slot] = end
        return end

    def ready(self, event) -> None:
        """Make the caller's stream wait on a copy's end event."""
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)

    def consumed(self, slot: int):
        """Record, on the caller's stream, that everything reading slot
        ``slot``'s twins has been launched: the next copy into them waits
        for this point on the device. Returns the (timing) event, None on
        the CPU."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        self._consumed[slot] = ev
        return ev

    def buffer(self, slot: int, name: str, numel: int,
               dtype: torch.dtype) -> torch.Tensor:
        """Slot ``slot``'s host buffer ``name`` with room for ``numel``
        elements of ``dtype`` (pinned on the card's side; reallocated
        only when it must grow)."""
        buf = self._slots[slot].get(name)
        if buf is None or buf.numel() < numel or buf.dtype != dtype:
            buf = torch.empty(max(numel, 1), dtype=dtype,
                              pin_memory=self.cuda)
            self._slots[slot][name] = buf
        return buf

    def put(self, slot: int, views: List[torch.Tensor]) -> List[torch.Tensor]:
        """Copies on the device of host views into slot ``slot``'s buffers,
        issued on the copy stream (asynchronous on the card). The device
        tensors are allocated on the caller's stream, which the copy
        stream waits for first (memory the allocator hands back may still
        be read there)."""
        size = sum(v.numel() * v.element_size() for v in views)
        self.stats["bytes"] += size
        self.stats["copies"] += 1
        self.stats["max_copy_bytes"] = max(self.stats["max_copy_bytes"],
                                           size)
        if not self.cuda:
            t0 = time.perf_counter()
            out = [v.clone() for v in views]
            self.stats["copy_s"] += time.perf_counter() - t0
            return out
        t0 = time.perf_counter()
        out = [torch.empty(v.shape, dtype=v.dtype, device=self.device)
               for v in views]
        self.stats["alloc_s"] += time.perf_counter() - t0
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record()
            for dst, src in zip(out, views):
                dst.copy_(src, non_blocking=True)
            end.record()
        self._timing.append((start, end))
        self._done[slot] = end
        return out

    def finish(self) -> dict:
        """Make the caller's stream wait for every copy (the host does not
        wait); returns ``stats``."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        return self.stats

    def copy_seconds(self) -> float:
        """The copies' time. On the card the device time between the
        events around each copy, read once the last copy has ended: the
        host waits for it here, so read it for statistics only. On the
        CPU the clones' host time."""
        if self._timing:
            self._timing[-1][1].synchronize()
            self.stats["copy_s"] += sum(s.elapsed_time(e)
                                        for s, e in self._timing) / 1000.0
            self._timing = []
        return self.stats["copy_s"]


def settle(stats: dict, rings: List[StagingRing]) -> dict:
    """An ingest's ``stats`` with its rings' copy time (``copy_s``, read
    from the copies' events at the first call) and the share of it the
    host did not wait for (``copy_hidden_share``: 1 - ``wait_s`` /
    ``copy_s``)."""
    if rings:
        copy_s = sum(r.copy_seconds() for r in rings)
        stats["copy_s"] = copy_s
        stats["copy_hidden_share"] = (
            max(0.0, 1.0 - stats["wait_s"] / copy_s) if copy_s else None)
        rings.clear()
    return stats
