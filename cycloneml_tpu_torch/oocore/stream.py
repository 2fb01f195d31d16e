"""The shard pipeline from disk onto the device.

The port's counterpart of ``cycloneml_tpu/oocore/stream.py``. A
background thread walks the shard files in the epoch's ``order``; for each
shard it takes a free slot of the pinned :class:`~cycloneml_tpu_torch.
dataset.staging.StagingRing`, waits on the host for the slot's earlier
copy, reads the shard's bytes into the slot's pinned buffers (``os.preadv``
in pieces on a few reader threads, the rows past the shard's own zeroed),
and copies them onto the slot's device twins on the ring's copy stream,
after the kernel that last read those twins (an event the consumer
recorded on its stream). It stages at most ``prefetchDepth`` shards ahead
of the consumer, so at most ``prefetchDepth + 1`` slots' device memory is
in use. Each item carries the TRUE shard index, so per-shard keys do not
depend on the order.

The consumer (:meth:`ShardStream.__iter__`) makes its stream wait on the
shard's copy event (no host wait), runs its kernel over the twins, and
hands the slot back with :meth:`ShardStream.release`.

Faults: a staging failure reaches the consumer as the exception itself;
the thread then stops and the queue is drained: no hang and no leaked
thread (the reference's contract, :91-126, without its transient retries,
which are ROADMAP Queue 1 item 9 with the ``oocore.stage`` chaos point).

Counters (``ShardStream.stats``, added into a caller's dict when given):
``read_s`` (host time of the reads), ``slot_wait_s`` (host time the thread
waited for a free slot or its earlier copy), ``consumer_wait_s`` (host
time the consumer waited for a staged shard), ``bytes``, ``shards``;
``bytes_staged`` as the reference's.
"""

from __future__ import annotations

import concurrent.futures
import os
import queue
import threading
import time
from typing import Optional

import torch

from cycloneml_tpu_torch.dataset.staging import StagingRing

_DONE = object()

#: reader threads a shard's X is read by (os.preadv releases the GIL)
READ_THREADS = max(1, min(8, os.cpu_count() or 1))


def stream_depth(ctx, depth: Optional[int] = None) -> int:
    """``depth``, else ``cyclone.oocore.prefetchDepth``."""
    if depth is None:
        from cycloneml_tpu_torch.conf import OOCORE_PREFETCH_DEPTH
        conf = getattr(ctx, "conf", None)
        depth = int(conf.get(OOCORE_PREFETCH_DEPTH)) if conf is not None \
            else 2
    return max(int(depth), 1)


def shard_ring(sds, depth: Optional[int] = None) -> StagingRing:
    """A ring of ``depth + 1`` slots for ``sds``'s shards on its context's
    device; keep it across epochs, so the slots are allocated once."""
    return StagingRing(sds.ctx.mesh_runtime.device,
                       slots=stream_depth(sds.ctx, depth) + 1)


class ShardStream:
    """Iterate ``(i, x, y, w, slot)`` staged shards with prefetch: x, y and
    w are the slot's device twins at the ``(pad_rows, ...)`` geometry. One
    pass over the shard set is one epoch. The consumer hands each slot
    back with :meth:`release` once its kernel is launched."""

    def __init__(self, sds, depth: Optional[int] = None, order=None,
                 ring: Optional[StagingRing] = None,
                 stats: Optional[dict] = None):
        self._sds = sds
        depth = stream_depth(sds.ctx, depth)
        if order is None:
            self._order = list(range(sds.n_shards))
        else:
            self._order = [int(i) for i in order]
            if sorted(self._order) != list(range(sds.n_shards)):
                raise ValueError(
                    f"order must be a permutation of range({sds.n_shards})")
        self._ring = ring if ring is not None else shard_ring(sds, depth)
        if self._ring.n_slots < depth + 1:
            raise ValueError(f"a ring of {self._ring.n_slots} slots cannot "
                             f"stage {depth} shards ahead")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._free: "queue.Queue" = queue.Queue()
        # the slots' buffers are made here, on the caller's thread and
        # stream, before the staging thread starts
        self._bufs = [self._slot_buffers(j) for j in range(depth + 1)]
        for j in range(depth + 1):
            self._free.put(j)
        self._stop = threading.Event()
        self.bytes_staged = 0
        self.stats = {"read_s": 0.0, "slot_wait_s": 0.0,
                      "consumer_wait_s": 0.0, "bytes": 0, "shards": 0}
        self._outer = stats
        self.marks = []   # CUDA events a shard: reached, ready, released
        self._closed = False
        self._thread = threading.Thread(
            target=self._produce, name="cyclone-oocore-stage", daemon=True)
        self._thread.start()

    # -- the staging thread ------------------------------------------------
    def _produce(self) -> None:
        try:
            with concurrent.futures.ThreadPoolExecutor(
                    READ_THREADS, thread_name_prefix="cyclone-oocore-read"
            ) as pool:
                for i in self._order:
                    if self._stop.is_set():
                        return
                    item = self._stage(i, pool)
                    if item is None or not self._put(item):
                        return
            self._put((_DONE, None))
        except BaseException as exc:  # the thread never dies silent
            self._put((None, exc))

    def _slot_buffers(self, slot: int):
        """Slot ``slot``'s pinned buffers and device twins at the shard
        set's geometry (a stacked view's labels are ``(pad_rows, K)``)."""
        sds, ring = self._sds, self._ring
        p, d = sds.pad_rows, sds.n_features
        k = getattr(sds, "n_models", 0)
        y_shape = (p, k) if k else (p,)
        ydt = getattr(sds, "stack_dtype", sds.y_dtype)
        host = (ring.buffer(slot, "x", p * d, sds.x_dtype)[:p * d]
                .view(p, d),
                ring.buffer(slot, "y", p * max(k, 1), ydt)[:p * max(k, 1)]
                .view(y_shape),
                ring.buffer(slot, "w", p, sds.y_dtype)[:p])
        dev = (ring.twin(slot, "x", (p, d), sds.x_dtype),
               ring.twin(slot, "y", y_shape, ydt),
               ring.twin(slot, "w", (p,), sds.y_dtype))
        return host, dev

    def _stage(self, i: int, pool):
        t0 = time.perf_counter()
        slot = None
        while slot is None:
            if self._stop.is_set():
                return None
            try:
                slot = self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        self._ring.wait_copied(slot)
        self.stats["slot_wait_s"] += time.perf_counter() - t0
        host, dev = self._bufs[slot]
        t0 = time.perf_counter()
        self._sds.read_into(i, *host, pool=pool)
        self.stats["read_s"] += time.perf_counter() - t0
        event = self._ring.put_into(slot, list(host), list(dev))
        n_bytes = sum(t.numel() * t.element_size() for t in host)
        self.bytes_staged += n_bytes
        self.stats["bytes"] += n_bytes
        self.stats["shards"] += 1
        return (i, slot, event, dev)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # -- the consumer ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        self.stats["consumer_wait_s"] += time.perf_counter() - t0
        if item[0] is _DONE:
            self.close()
            raise StopIteration
        if item[0] is None:
            self.close()
            raise item[1]
        i, slot, event, (x, y, w) = item
        if self._ring.cuda:
            # the caller's stream: reaching the shard, then its copy done
            reach = torch.cuda.Event(enable_timing=True)
            reach.record()
            self._ring.ready(event)
            ready = torch.cuda.Event(enable_timing=True)
            ready.record()
            self.marks.append([reach, ready, None])
        return i, x, y, w, slot

    def release(self, slot: int) -> None:
        """Hand slot ``slot`` back once everything reading its twins has
        been launched on the caller's stream."""
        done = self._ring.consumed(slot)
        if done is not None and self.marks:
            self.marks[-1][2] = done
        self._free.put(slot)

    def device_seconds(self):
        """``(copy_stall_s, compute_s)`` of the shards consumed: the device
        time the caller's stream waited for their copies, and from each
        copy's readiness to the release of its slot. Reads CUDA events:
        call once the caller's stream has been synchronized. (0, 0) on
        the CPU."""
        stall = compute = 0.0
        for reach, ready, done in self.marks:
            stall += reach.elapsed_time(ready) / 1000.0
            if done is not None:
                compute += ready.elapsed_time(done) / 1000.0
        return stall, compute

    def close(self) -> None:
        """Stop staging, drain the queue, join the thread, and order the
        caller's stream after every copy issued. Idempotent; safe mid-epoch
        (the abort path). Drains again after the join: a put in flight
        when stop was set can land after the first drain."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._drain()
        self._thread.join(timeout=30.0)
        self._drain()
        self._ring.finish()
        if self._outer is not None:
            for k, v in self.stats.items():
                self._outer[k] = self._outer.get(k, 0) + v

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self) -> "ShardStream":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
