"""The two dataset tiers.

``PartitionedDataset`` — the host tier with the RDD's functional surface
(map/filter/mapPartitions/reduce/treeAggregate/collect, lazy lineage,
caching, ``checkpoint`` to ``ctx.checkpoint_dir``) over Python objects in
host threads: the port's counterpart of ``cycloneml_tpu/dataset/
dataset.py:PartitionedDataset``. Its shuffle's spill comes with the native
codecs it writes through (ROADMAP Queue 1 item 12); its cross-process
exchange needs several devices (item 9).

``InstanceDataset`` — the numeric tier every estimator trains on, the
port's counterpart of the reference's ``InstanceDataset``: ``x`` is
``(n_pad, d)`` in the data tier, ``y``/``w`` are
``(n_pad,)`` in the accumulator tier, all on the mesh's device; padding
rows carry w=0. Host twins of the padded (y, w) are kept when they are
known, so estimators read label histograms without a device readback.
``persist``/``cache``/``unpersist`` register it with the context's
storage tiers (``dataset/storage.StorageManager``: DEVICE, HOST, DISK
under the ``cyclone.storage.*`` budgets); ``persist_disk``, ``checkpoint``
and ``restore`` write and read the reference's npz layout, so that either
package reads the other's files bit for bit.

On the fp8 rung ``x`` holds e4m3 CODES and ``x_scale`` the per-column
float64 scales: the value is ``x * x_scale``. Only fp8-capable fits read the
codes (folding the scale into their (d,) vectors); everything else gets a
bfloat16 dequantization through :func:`fp8_fallback`, which always logs.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import functools
import logging
import os
import pickle
import time
import warnings
import weakref
import zlib
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.instance import (blockify_arrays,
                                                  compute_dtype, data_dtype,
                                                  fp8_probe_ok, is_fp8_dtype,
                                                  quantize_fp8, rows_to_dense)
from cycloneml_tpu_torch.parallel import collectives

logger = logging.getLogger(__name__)

_DEQUANT_ROWS = 1 << 16  # rows of fp8 codes widened at a time


_POOL: Optional[cf.ThreadPoolExecutor] = None


def _pool() -> cf.ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = cf.ThreadPoolExecutor(max_workers=os.cpu_count() or 8,
                                      thread_name_prefix="cyclone-task")
    return _POOL


def stable_hash(key: Any) -> int:
    """The partitioner's hash, the same in every process and run (the
    reference's ``dataset/spill.stable_hash``): numbers by Python's own
    salt-free numeric hash (so 1 == 1.0 == True co-partition), str and
    bytes by a crc32 digest of the bytes and of the bytes reversed, tuples
    and frozensets from their elements, other types by ``__hash__``."""
    if isinstance(key, str):
        b = key.encode("utf-8")
    elif isinstance(key, (bytes, bytearray)):
        b = bytes(key)
    elif isinstance(key, tuple):
        h = 1099511628211
        for k in key:
            h = (h * 31 + stable_hash(k)) & 0x7FFFFFFFFFFFFFFF
        return h
    elif isinstance(key, frozenset):
        return (sum(stable_hash(k) for k in key) + len(key)) \
            & 0x7FFFFFFFFFFFFFFF
    else:
        return hash(key) & 0x7FFFFFFFFFFFFFFF
    return (zlib.crc32(b) | (zlib.crc32(b[::-1]) << 32)) & 0x7FFFFFFFFFFFFFFF


class PartitionedDataset:
    """Host-tier RDD analog: lazy, lineage-based, partitioned lists of
    Python objects; actions run a task a partition on a thread pool."""

    def __init__(self, ctx, partitions_fn: Callable[[], List[List[Any]]],
                 num_partitions: int, name: str = ""):
        self.ctx = ctx
        self._compute = partitions_fn
        self.num_partitions = num_partitions
        self.name = name or "dataset"
        self._cached: Optional[List[List[Any]]] = None
        self._checkpoint_path: Optional[str] = None

    @classmethod
    def from_sequence(cls, ctx, data: List[Any],
                      num_partitions: int) -> "PartitionedDataset":
        """``data`` cut into ``num_partitions`` runs of ceil(n / parts)."""
        data = list(data)
        n = max(1, num_partitions)

        def compute():
            size = (len(data) + n - 1) // n if data else 0
            return [data[i * size:(i + 1) * size] for i in range(n)]

        return cls(ctx, compute, n, "parallelize")

    # -- materialization ------------------------------------------------------
    def _partitions(self) -> List[List[Any]]:
        if self._cached is not None:
            return self._cached
        if self._checkpoint_path is not None:
            with open(self._checkpoint_path, "rb") as fh:
                return pickle.load(fh)
        return self._compute()

    def cache(self) -> "PartitionedDataset":
        return self.persist()

    def persist(self) -> "PartitionedDataset":
        """Keep the partitions in host memory from the next action on."""
        if self._cached is None:
            self._cached = self._partitions()
        return self

    def unpersist(self) -> "PartitionedDataset":
        self._cached = None
        return self

    def checkpoint(self) -> "PartitionedDataset":
        """Truncate the lineage: the partitions are written to
        ``<ctx.checkpoint_dir>/<name>-<id>.pkl`` and read from there from
        now on (ref RDD.scala:1631, ReliableCheckpointRDD.scala:147).
        Raises when no checkpoint directory is set."""
        d = self.ctx.checkpoint_dir
        if not d:
            raise RuntimeError(
                "checkpoint dir not set; call set_checkpoint_dir")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{self.name}-{id(self)}.pkl")
        parts = self._partitions()
        with open(path, "wb") as fh:
            pickle.dump(parts, fh)
        self._checkpoint_path = path
        self._compute = lambda: None  # the lineage is gone
        return self

    # -- transformations (lazy) -----------------------------------------------
    def _derive(self, fn: Callable[[List[List[Any]]], List[List[Any]]],
                name: str, num_partitions: Optional[int] = None
                ) -> "PartitionedDataset":
        parent = self
        return PartitionedDataset(
            self.ctx, lambda: fn(parent._partitions()),
            self.num_partitions if num_partitions is None else num_partitions,
            name)

    def map(self, f: Callable) -> "PartitionedDataset":
        return self._derive(lambda ps: [[f(x) for x in p] for p in ps], "map")

    def filter(self, f: Callable) -> "PartitionedDataset":
        return self._derive(lambda ps: [[x for x in p if f(x)] for p in ps],
                            "filter")

    def flat_map(self, f: Callable) -> "PartitionedDataset":
        return self._derive(
            lambda ps: [[y for x in p for y in f(x)] for p in ps], "flatMap")

    def map_partitions(self, f: Callable[[Iterable], Iterable]
                       ) -> "PartitionedDataset":
        return self._derive(lambda ps: [list(f(iter(p))) for p in ps],
                            "mapPartitions")

    def map_partitions_with_index(self, f: Callable[[int, Iterable], Iterable]
                                  ) -> "PartitionedDataset":
        return self._derive(
            lambda ps: [list(f(i, iter(p))) for i, p in enumerate(ps)],
            "mapPartitionsWithIndex")

    def zip_with_index(self) -> "PartitionedDataset":
        def fn(ps):
            out, i = [], 0
            for p in ps:
                out.append([(x, i + j) for j, x in enumerate(p)])
                i += len(p)
            return out
        return self._derive(fn, "zipWithIndex")

    def repartition(self, n: int) -> "PartitionedDataset":
        def fn(ps):
            flat = [x for p in ps for x in p]
            size = (len(flat) + n - 1) // n if flat else 0
            return [flat[i * size:(i + 1) * size] for i in range(n)]
        return self._derive(fn, "repartition", n)

    coalesce = repartition

    def group_by_key(self) -> "PartitionedDataset":
        """Key/value pairs grouped into ``(key, [values])``, each key in
        partition ``stable_hash(key) % num_partitions``, keys in the order
        they first occur and values in row order (the reference's path
        within its spill budget; the spill past it writes through the
        native codecs, ROADMAP Queue 1 item 12)."""
        n = self.num_partitions

        def fn(ps):
            buckets = [{} for _ in range(n)]
            for p in ps:
                for k, v in p:
                    buckets[stable_hash(k) % n].setdefault(k, []).append(v)
            return [list(b.items()) for b in buckets]
        return self._derive(fn, "groupByKey", n)

    def reduce_by_key(self, f: Callable) -> "PartitionedDataset":
        return self.group_by_key().map(
            lambda kv: (kv[0], functools.reduce(f, kv[1])))

    def union(self, other: "PartitionedDataset") -> "PartitionedDataset":
        parent = self
        return PartitionedDataset(
            self.ctx, lambda: parent._partitions() + other._partitions(),
            self.num_partitions + other.num_partitions, "union")

    # -- actions (eager, a task a partition) ----------------------------------
    def _run_per_partition(self, f: Callable[[List[Any]], Any]) -> List[Any]:
        return list(_pool().map(f, self._partitions()))

    def collect(self) -> List[Any]:
        return [x for p in self._partitions() for x in p]

    def count(self) -> int:
        return sum(self._run_per_partition(len))

    def take(self, n: int) -> List[Any]:
        out: List[Any] = []
        for p in self._partitions():
            out.extend(p[: n - len(out)])
            if len(out) >= n:
                break
        return out

    def first(self) -> Any:
        got = self.take(1)
        if not got:
            raise ValueError("empty dataset")
        return got[0]

    def reduce(self, f: Callable) -> Any:
        partials = [functools.reduce(f, p)
                    for p in self._run_per_partition(list) if p]
        if not partials:
            raise ValueError("empty dataset")
        return functools.reduce(f, partials)

    def aggregate(self, zero: Any, seq_op: Callable, comb_op: Callable) -> Any:
        partials = self._run_per_partition(
            lambda p: functools.reduce(seq_op, p, copy.deepcopy(zero)))
        return functools.reduce(comb_op, partials, copy.deepcopy(zero))

    def tree_aggregate(self, zero: Any, seq_op: Callable, comb_op: Callable,
                       depth: int = 2) -> Any:
        """A partial a partition, then combined in ``depth`` rounds of
        groups (ref RDD.scala:1223): the host tier's reduction; the
        numeric tier sums on the device."""
        partials = self._run_per_partition(
            lambda p: functools.reduce(seq_op, p, copy.deepcopy(zero)))
        while len(partials) > 2 and depth > 1:
            scale = max(2, int(np.ceil(len(partials) ** (1.0 / depth))))
            groups = [partials[i::scale] for i in range(scale)]
            partials = [functools.reduce(comb_op, g) for g in groups if g]
            depth -= 1
        return functools.reduce(comb_op, partials, copy.deepcopy(zero))

    def foreach(self, f: Callable) -> None:
        self._run_per_partition(lambda p: [f(x) for x in p])

    def is_empty(self) -> bool:
        return not self.take(1)

    # -- bridge to the numeric tier -------------------------------------------
    def to_instance_dataset(self, n_features: Optional[int] = None,
                            label_fn=None, weight_fn=None,
                            features_fn=None) -> "InstanceDataset":
        """The rows (``Instance``-like: ``features``, ``label``,
        ``weight``, or the given accessors) as a device dataset."""
        rows = self.collect()
        features_fn = features_fn or (lambda r: r.features)
        label_fn = label_fn or (lambda r: getattr(r, "label", 0.0))
        weight_fn = weight_fn or (lambda r: getattr(r, "weight", 1.0))
        x = rows_to_dense([features_fn(r) for r in rows], n_features)
        y = np.array([label_fn(r) for r in rows], dtype=np.float64)
        w = np.array([weight_fn(r) for r in rows], dtype=np.float64)
        return InstanceDataset.from_numpy(self.ctx, x, y, w)


#: torch dtypes npz cannot hold, by the reference's tag (the numpy name of
#: its ml_dtypes type); they travel as an unsigned bit view
_NPZ_TAGS = {torch.bfloat16: "bfloat16",
             torch.float8_e4m3fn: "float8_e4m3fn"}
_NPZ_DTYPES = {tag: dt for dt, tag in _NPZ_TAGS.items()}


def _npz_pack(t: torch.Tensor):
    """``(array, tag)`` of a CPU tensor for an npz file: the reference's
    ``_npz_pack`` layout, an unsigned bit view (uint16 for bfloat16, uint8
    for float8) and the dtype's name for the narrow floats, the array
    itself and ``""`` for every other dtype."""
    tag = _NPZ_TAGS.get(t.dtype)
    if tag is None:
        return t.numpy(), ""
    if t.element_size() == 1:
        return t.view(torch.uint8).numpy(), tag
    return t.view(torch.int16).numpy().view(np.uint16), tag


def _npz_unpack(arr: np.ndarray, tag) -> torch.Tensor:
    """The CPU tensor of a packed npz array and its tag. A tag that names
    no narrow float, or whose width is not the payload's, raises: torn
    bytes are never read as values."""
    tag = str(tag)
    if not tag:
        return torch.from_numpy(np.ascontiguousarray(arr))
    dt = _NPZ_DTYPES.get(tag)
    if dt is None:
        raise ValueError(f"corrupt npz dtype tag {tag!r}: not a known dtype")
    width = torch.empty((), dtype=dt).element_size()
    if width != arr.dtype.itemsize:
        raise ValueError(
            f"corrupt npz dtype tag {tag!r}: itemsize {width} does not "
            f"match the packed {arr.dtype} payload")
    bits = np.ascontiguousarray(arr).view(np.uint8 if width == 1
                                          else np.int16)
    return torch.from_numpy(bits).view(dt)


def fp8_fallback(ds: "InstanceDataset", estimator: str,
                 reason: str) -> "InstanceDataset":
    """Leave the fp8 storage rung for this fit: log the reference's
    warning, record the decision in ``ctx.precision_fallbacks`` (the
    reference's ``PrecisionFallback`` event; the listener bus is ROADMAP
    slice 10) and return the bfloat16 dequantization. The fit goes on
    training; only the storage rung changes."""
    from_dt = str(ds.x.dtype).replace("torch.", "")
    logger.warning("%s: falling back from %s to bfloat16 storage — %s",
                   estimator, from_dt, reason)
    record = getattr(ds.ctx, "precision_fallbacks", None)
    if record is not None:
        record.append({"estimator": estimator, "from_dtype": from_dt,
                       "to_dtype": "bfloat16", "reason": reason})
    return ds.dequantized()


def resolve_fp8_fit(ds: "InstanceDataset", stats,
                    estimator: str) -> "InstanceDataset":
    """The per-fit fp8 safety rail: the envelope probe
    (:func:`instance.fp8_probe_ok`) on statistics already at hand, and a
    fallback to bfloat16 storage when e4m3 would break the documented
    accuracy envelope. ``ds`` itself when it is not quantized or passes."""
    if ds.x_scale is None:
        return ds
    w_host = ds.w_host()
    w_max = float(np.max(w_host)) if len(w_host) else None
    reason = fp8_probe_ok(stats, w_max, probe_ratio=ds._fp8_probe_ratio)
    if reason is None:
        return ds
    return fp8_fallback(ds, estimator, reason)


def _dense_chunk(ci: int, item, n_features: int, yw_dtype):
    """Chunk ``ci`` of a dense stream as (x, y, w) arrays, y and w in the
    accumulator tier (zeros and ones when None); a chunk of another width,
    or whose y or w is not one a row, raises."""
    cx, cy, cw = item
    cx = np.asarray(cx)
    if cx.ndim != 2 or cx.shape[1] != n_features:
        raise ValueError(f"chunk {ci} has shape {cx.shape}, expected "
                         f"(rows, {n_features})")
    m = cx.shape[0]
    cy = np.zeros(m, yw_dtype) if cy is None else np.asarray(cy, yw_dtype)
    cw = np.ones(m, yw_dtype) if cw is None else np.asarray(cw, yw_dtype)
    if len(cy) != m or len(cw) != m:
        # a silent mismatch would shift every later label
        raise ValueError(f"chunk {ci}: y/w lengths ({len(cy)}/{len(cw)}) "
                         f"!= x rows ({m})")
    return cx, cy, cw


class InstanceDataset:
    def __init__(self, ctx, x: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor, n_rows: int, n_features: int,
                 x_scale: Optional[np.ndarray] = None):
        self.ctx = ctx
        self._x = x
        self._y = y
        self._w = w
        if (x_scale is not None) != is_fp8_dtype(x.dtype):
            raise ValueError("an fp8 X needs its per-column x_scale, and "
                             f"only an fp8 X takes one (X is {x.dtype})")
        # fp8 rung: per-column dequantization scales, float64 on the host
        self._x_scale: Optional[np.ndarray] = (
            np.asarray(x_scale, dtype=np.float64)
            if x_scale is not None else None)
        # the RAW data's per-column absmax/std, taken when quantizing: the
        # envelope probe's input (the codes cannot show a collapsed column)
        self._fp8_probe_ratio: Optional[np.ndarray] = None
        self._yw_host: Optional[Tuple[np.ndarray, np.ndarray]] = None
        # host copies of (x, y, w) after persist_host; None on the device
        self._host: Optional[Tuple[torch.Tensor, ...]] = None
        self._summary_cache = None  # Summarizer moments (immutable data)
        # the real rows of the padded arrays (set by the streamed ingest;
        # None: the first n_rows)
        self._valid_mask: Optional[np.ndarray] = None
        self._disk_path: Optional[str] = None  # the DISK tier's npz file
        self._storage_cb = None  # the StorageManager's restore hook
        # derive() lineage: the dataset whose tensors this one shares and
        # those that share its own; the StorageManager demotes neither
        self._array_parent = None
        self._derived_children = None
        # the padded tensors' bytes, taken now so that storage accounting
        # never touches (and so never restores) them
        self._nbytes = sum(t.numel() * t.element_size() for t in (x, y, w))
        self.n_rows = n_rows
        self.n_features = n_features

    #: (stats, staging rings) of the ingest that made the dataset
    _ingest: Optional[tuple] = None

    @property
    def ingest_stats(self) -> Optional[dict]:
        """The split of the time of the streamed ingest that made the
        dataset (None for any other). The copies' device time is read at
        the first access, which waits on the host for the last copy."""
        from cycloneml_tpu_torch.dataset.staging import settle
        return None if self._ingest is None else settle(*self._ingest)

    @classmethod
    def from_numpy(cls, ctx, x: np.ndarray, y: Optional[np.ndarray] = None,
                   w: Optional[np.ndarray] = None,
                   dtype: Optional[torch.dtype] = None) -> "InstanceDataset":
        """Pad host arrays with zero-weight rows and place them on the
        mesh: X in the data tier (``dtype``, default
        :func:`data_dtype`), y/w in the accumulator tier. An fp8 ``dtype``
        quantizes X first (:func:`instance.quantize_fp8`, statistics over
        the real rows only), keeping its scales and probe ratio."""
        conf = getattr(ctx, "conf", None)
        if dtype is None:
            dtype = data_dtype(conf)
        x = np.asarray(x)
        x_scale = probe_ratio = None
        if is_fp8_dtype(dtype):
            x, x_scale, probe_ratio = quantize_fp8(x)
        ds = cls._place(ctx, x, y, w, dtype, x_scale)
        ds._fp8_probe_ratio = probe_ratio
        return ds

    @classmethod
    def from_fp8_codes(cls, ctx, codes: np.ndarray, x_scale,
                       y: Optional[np.ndarray] = None,
                       w: Optional[np.ndarray] = None,
                       probe_ratio=None) -> "InstanceDataset":
        """A dataset over e4m3 codes quantized elsewhere (the reference's
        fp8 dataset, carried across by ``interop``): ``codes`` is any
        1-byte numpy array holding float8_e4m3fn bits, placed bit for bit
        with its ``x_scale`` and probe ratio."""
        codes = np.ascontiguousarray(codes)
        if codes.dtype.itemsize != 1 or codes.ndim != 2:
            raise ValueError("from_fp8_codes: codes must be a 2-D array of "
                             f"1-byte elements; got {codes.shape} "
                             f"{codes.dtype}")
        x8 = torch.from_numpy(codes.view(np.uint8)).view(torch.float8_e4m3fn)
        ds = cls._place(ctx, x8, y, w, torch.float8_e4m3fn, x_scale)
        ds._fp8_probe_ratio = (None if probe_ratio is None else
                               np.asarray(probe_ratio, dtype=np.float64))
        return ds

    @classmethod
    def from_dense_chunks(cls, ctx, chunks: Iterable, n_features: int,
                          dtype: Optional[torch.dtype] = None
                          ) -> "InstanceDataset":
        """Streamed dense ingest (the reference's ``from_dense_chunks``,
        ref HadoopRDD.scala:87 partition streaming): a dataset from an
        iterator of ``(x_chunk, y_chunk_or_None, w_chunk_or_None)`` host
        chunks, without the whole matrix ever on the host.

        Each chunk is cast to the data tier (``dtype``, default
        :func:`data_dtype`; torch's round to nearest even) into a slot of
        a pinned staging ring and copied onto the device on a side stream
        while the next chunk is read (:class:`staging.StagingRing`); x is
        staged before the next chunk is asked for, so a stream may reuse
        its x buffer (y and w are kept). At the end the chunks are copied
        into one padded X and released; peak
        device memory is at most twice X. On the port's one shard the rows
        keep input order, padded at the end to a multiple of 8 rows with
        w = 0; y and w (accumulator tier) are assembled on the host and
        kept as host twins, with the mask of real rows. The host does not
        wait for the device: the assembly and every later use are ordered
        after the copies on the caller's stream. ``ingest_stats`` holds
        the split of the time (reading, staging, copies, assembly).
        An fp8 ``dtype`` raises: quantize after ingest with
        :meth:`quantized`, whose scales need every row."""
        from cycloneml_tpu_torch.dataset.staging import StagingRing
        conf = getattr(ctx, "conf", None)
        if dtype is None:
            dtype = data_dtype(conf)
        if is_fp8_dtype(dtype):
            raise ValueError("from_dense_chunks stages X in a wider tier; "
                             "quantize the dataset with quantized()")
        yw_dt = compute_dtype(conf)
        np_yw = np.float64 if yw_dt == torch.float64 else np.float32
        rt = ctx.mesh_runtime
        if rt.data_parallelism != 1:
            raise NotImplementedError(
                "a dataset over several shards is ROADMAP slice 8")
        t_all = time.perf_counter()
        ring = StagingRing(rt.device)
        parts: List[torch.Tensor] = []
        ys: List[np.ndarray] = []
        ws: List[np.ndarray] = []
        read_s = stage_s = 0.0
        it = iter(chunks)
        ci = 0
        try:
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                read_s += time.perf_counter() - t0
                if item is None:
                    break
                cx, cy, cw = _dense_chunk(ci, item, n_features, np_yw)
                m = cx.shape[0]
                ci += 1
                if m == 0:
                    continue
                t0 = time.perf_counter()
                slot = ring.acquire()
                buf = ring.buffer(slot, "x", m * n_features, dtype)
                view = buf[:m * n_features].view(m, n_features)
                with warnings.catch_warnings():
                    # a read-only chunk (np.frombuffer) is only read here
                    warnings.simplefilter("ignore", UserWarning)
                    view.copy_(torch.from_numpy(np.ascontiguousarray(cx)))
                stage_s += time.perf_counter() - t0
                parts.extend(ring.put(slot, [view]))
                ys.append(cy)
                ws.append(cw)
        finally:
            # memory an error releases is reused only after the copies
            stats = ring.finish()
        t0 = time.perf_counter()
        n = sum(len(c) for c in ys)
        n_pad = max((n + 7) // 8 * 8, 8)
        x = torch.empty((n_pad, n_features), dtype=dtype, device=rt.device)
        lo = 0
        while parts:
            part = parts.pop(0)   # each chunk released once copied
            x[lo:lo + part.shape[0]] = part
            lo += part.shape[0]
            del part
        x[lo:] = 0
        y_pad = np.zeros(n_pad, dtype=np_yw)
        w_pad = np.zeros(n_pad, dtype=np_yw)
        valid = np.zeros(n_pad, dtype=bool)
        if n:
            y_pad[:n] = np.concatenate(ys)
            w_pad[:n] = np.concatenate(ws)
        valid[:n] = True
        ds = cls(ctx, x, rt.device_put_sharded_rows(y_pad),
                 rt.device_put_sharded_rows(w_pad), n, n_features)
        ds._valid_mask = valid
        stats.update(read_s=read_s, stage_s=stage_s, chunks=ci, rows=n,
                     dataset_bytes=ds.padded_bytes(),
                     assembly_s=time.perf_counter() - t0,
                     wall_s=time.perf_counter() - t_all)
        ds._ingest = (stats, [ring])
        return ds.attach_host_labels(y_pad, w_pad)

    @classmethod
    def _place(cls, ctx, x, y, w, dtype, x_scale) -> "InstanceDataset":
        conf = getattr(ctx, "conf", None)
        rt = ctx.mesh_runtime
        x_p, y_p, w_p, n = blockify_arrays(x, y, w, rt.data_parallelism,
                                           dtype=dtype,
                                           yw_dtype=compute_dtype(conf))
        ds = cls(ctx, rt.device_put_sharded_rows(x_p),
                 rt.device_put_sharded_rows(y_p),
                 rt.device_put_sharded_rows(w_p), n, x.shape[1],
                 x_scale=x_scale)
        ds._yw_host = (y_p.numpy(), w_p.numpy())
        return ds

    def quantized(self) -> "InstanceDataset":
        """This dataset on the fp8 rung: its real rows quantized on their
        device (:func:`instance.quantize_fp8`, statistics over the real
        rows only) into a new X whose padding rows are zero codes; y, w and
        the host twins are shared. ``self`` when already quantized."""
        if self._x_scale is not None:
            return self
        x8 = torch.zeros(self.x.shape, dtype=torch.uint8,
                         device=self.x.device).view(torch.float8_e4m3fn)
        _, scale, ratio = quantize_fp8(self.x[:self.n_rows], out=x8)
        ds = InstanceDataset(self.ctx, x8, self.y, self.w, self.n_rows,
                             self.n_features, x_scale=scale)
        ds._fp8_probe_ratio = ratio
        ds._yw_host = self._yw_host
        self._link_child(ds)   # y and w are shared
        return ds

    def attach_host_labels(self, y: np.ndarray,
                           w: np.ndarray) -> "InstanceDataset":
        """Attach padded host twins of (y, w), so ``y_host``/``w_host``
        never read the device back."""
        self._yw_host = (y, w)
        return self

    def derive(self, x=None, y=None, w=None,
               n_features: Optional[int] = None) -> "InstanceDataset":
        """A dataset with some arrays replaced and this dataset's row
        metadata kept: the row count, and the host twins of (y, w) when
        neither changes. Row-aligned transformations (normalization, X.B
        products) build their result through this."""
        ds = InstanceDataset(self.ctx, self.x if x is None else x,
                             self.y if y is None else y,
                             self.w if w is None else w, self.n_rows,
                             self.n_features if n_features is None
                             else n_features,
                             # the scales describe X: they follow an
                             # unchanged X and go with a replaced one
                             x_scale=self._x_scale if x is None else None)
        if x is None:
            ds._fp8_probe_ratio = self._fp8_probe_ratio
        if y is None and w is None:
            ds._yw_host = self._yw_host
        ds._valid_mask = self._valid_mask
        self._link_child(ds)
        return ds

    def _link_child(self, ds: "InstanceDataset") -> None:
        """Record that ``ds`` shares tensors with this dataset: both, and
        the root of this dataset's derive chain (tensors pass down it, and
        a dead middle link must not end the protection), count as sharing
        for the StorageManager while the other lives."""
        root = self
        while root._array_parent is not None:
            p = root._array_parent()
            if p is None:
                break
            root = p
        ds._array_parent = weakref.ref(root)
        for owner in {id(root): root, id(self): self}.values():
            if owner._derived_children is None:
                owner._derived_children = weakref.WeakSet()
            owner._derived_children.add(ds)

    def valid_indices(self) -> np.ndarray:
        """Padded-array positions of the real (non-padding) rows: the
        first ``n_rows`` (the port pads at the end only, so the streamed
        ingest's mask names the same rows)."""
        if self._valid_mask is not None:
            return np.flatnonzero(self._valid_mask)
        return np.arange(self.n_rows)

    def gather_rows(self, idx) -> np.ndarray:
        """Host copy of the given padded row positions at the accumulator
        width (w's dtype): O(len(idx) d) moved, X itself is indexed in
        place on its device and never copied whole."""
        idx = np.asarray(idx, dtype=np.int64).ravel()
        if len(idx) == 0:
            return np.zeros((0, self.n_features))
        rows = self.x[torch.as_tensor(idx, device=self.x.device)]
        out = rows.to(self.w.dtype).cpu().numpy()
        if self._x_scale is not None:
            # codes -> values at the host boundary
            out = out.astype(np.float64) * self._x_scale[None, :]
        return out

    def to_instance_dataset(self, *args, fp8_capable: bool = False,
                            **kwargs) -> "InstanceDataset":
        """Already an InstanceDataset: estimators accept one as a frame
        (column names and dtype are ignored). A quantized dataset handed to
        a caller that is not fp8-capable is dequantized to bfloat16 first:
        raw e4m3 codes are never read as values."""
        if self._x_scale is not None and not fp8_capable:
            return fp8_fallback(
                self, "to_instance_dataset",
                "estimator is not fp8-capable; dequantizing its view")
        return self

    @property
    def x_scale(self) -> Optional[np.ndarray]:
        """Per-column fp8 dequantization scales (float64 host ``(d,)``), or
        None on every wider tier; the value is ``x * x_scale``."""
        return self._x_scale

    def dequantized(self, dtype=torch.bfloat16) -> "InstanceDataset":
        """This dataset with X dequantized out of the fp8 rung into
        ``dtype`` (bfloat16, the next rung down): ``codes.float() * scale``
        a chunk of rows at a time on X's device, y/w and metadata carried
        by :meth:`derive`. ``self`` when not quantized."""
        if self._x_scale is None:
            return self
        s = torch.as_tensor(self._x_scale, dtype=torch.float32,
                            device=self.x.device)
        x = torch.empty(self.x.shape, dtype=dtype, device=self.x.device)
        for lo in range(0, x.shape[0], _DEQUANT_ROWS):
            hi = lo + _DEQUANT_ROWS
            x[lo:hi] = (self.x[lo:hi].to(torch.float32) * s).to(dtype)
        return self.derive(x=x)

    @property
    def x(self) -> torch.Tensor:
        self._restore_device()
        return self._x

    @property
    def y(self) -> torch.Tensor:
        self._restore_device()
        return self._y

    @property
    def w(self) -> torch.Tensor:
        self._restore_device()
        return self._w

    # -- placement ------------------------------------------------------------
    def _restore_device(self) -> None:
        """Put a released dataset back on its device: from its host copy,
        else from its DISK-tier file. A restore tells the storage manager,
        so its accounting follows the normal read path."""
        if self._x is not None:
            return
        if self._host is not None:
            tensors = self._host
        elif self._disk_path:
            tensors = self._read_disk(self._disk_path)
        else:
            return
        rt = self.ctx.mesh_runtime
        self._x, self._y, self._w = (rt.device_put_sharded_rows(t)
                                     for t in tensors)
        if self._storage_cb is not None:
            self._storage_cb(self)

    @staticmethod
    def _read_disk(path: str) -> Tuple[torch.Tensor, ...]:
        """(x, y, w) as CPU tensors from an npz file of :meth:`persist_disk`
        or :meth:`checkpoint` (either package's)."""
        with np.load(path) as z:
            return tuple(_npz_unpack(z[k], z.get(f"{k}_dtype", ""))
                         for k in ("x", "y", "w"))

    def persist(self, level: str = "DEVICE") -> "InstanceDataset":
        """Register with the context's storage manager at ``level``
        (``"DEVICE"``, ``"HOST"`` or ``"DISK"``; the reference's default
        storage path, ``rdd.persist()`` into the BlockManager): the
        ``cyclone.storage.*`` budgets then bound what cold datasets hold,
        demoting the least recently used ones down the tiers."""
        mgr = getattr(self.ctx, "storage", None)
        if mgr is not None:
            mgr.persist(self, level)
        return self

    def cache(self) -> "InstanceDataset":
        return self.persist()

    def unpersist(self) -> "InstanceDataset":
        """Leave the storage manager; a DISK-tier dataset is read back to
        host memory first (data is never dropped)."""
        mgr = getattr(self.ctx, "storage", None)
        if mgr is not None:
            mgr.unpersist(self)
        return self

    def persist_host(self) -> "InstanceDataset":
        """Copy the padded arrays to host memory and release the device's;
        the next access places them back (``x``/``y``/``w``, ``persist``)."""
        self._host = tuple(t.cpu() for t in (self.x, self.y, self.w))
        self._x = self._y = self._w = None
        return self

    def release_device(self) -> None:
        """Free the device arrays; a durable copy must exist (the host
        copy of :meth:`persist_host` or the file of :meth:`persist_disk`),
        since it is the only one then. The memory returns to the caching
        allocator once no other dataset shares the arrays."""
        if self._host is None and not self._disk_path:
            raise RuntimeError("release_device would drop the only copy")
        self._x = self._y = self._w = None

    def _npz_fields(self, x, y, w) -> dict:
        """The reference's npz fields of (x, y, w): packed arrays, their
        tags, the row and column counts, the real-row mask and the fp8
        scales when present."""
        out = {}
        for k, t in (("x", x), ("y", y), ("w", w)):
            out[k], out[f"{k}_dtype"] = _npz_pack(t.cpu())
        out.update(n_rows=self.n_rows, n_features=self.n_features)
        if self._valid_mask is not None:
            out["valid_mask"] = self._valid_mask
        if self._x_scale is not None:
            # the codes are meaningless without their scales
            out["x_scale"] = self._x_scale
            if self._fp8_probe_ratio is not None:
                out["x_probe_ratio"] = self._fp8_probe_ratio
        return out

    def persist_disk(self, path: str) -> "InstanceDataset":
        """Spill to an npz file (``path``, ``.npz`` added when missing) and
        release both the device and the host copy: the DISK tier. Written
        from the host copy when there is one, never through the device.
        The next access reads the file back onto the device."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        x, y, w = self._host if self._host is not None else \
            (self.x, self.y, self.w)
        np.savez(path, **self._npz_fields(x, y, w))
        self._disk_path = path if path.endswith(".npz") else path + ".npz"
        self._host = None
        if self._x is not None:
            self.release_device()
        return self

    def checkpoint(self, path: str) -> str:
        """Write the padded arrays to the npz file ``path`` (the
        reference's layout: bfloat16 and float8 as bit views with their
        tags, the fp8 scales beside the codes) and return it; the dataset
        stays as it is."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **self._npz_fields(self.x, self.y, self.w))
        return path

    @classmethod
    def restore(cls, ctx, path: str) -> "InstanceDataset":
        """A dataset on ``ctx``'s device from an npz file of
        :meth:`checkpoint` or :meth:`persist_disk` (either package's): X,
        y and w bit for bit, with the real-row mask and the fp8 scales."""
        path = path if path.endswith(".npz") else path + ".npz"
        rt = ctx.mesh_runtime
        with np.load(path) as z:
            x, y, w = (_npz_unpack(z[k], z.get(f"{k}_dtype", ""))
                       for k in ("x", "y", "w"))
            n_rows, n_features = int(z["n_rows"]), int(z["n_features"])
            scale = (np.asarray(z["x_scale"], dtype=np.float64)
                     if "x_scale" in z else None)
            ratio = (np.asarray(z["x_probe_ratio"], dtype=np.float64)
                     if "x_probe_ratio" in z else None)
            mask = z["valid_mask"] if "valid_mask" in z else None
        ds = cls(ctx, rt.device_put_sharded_rows(x),
                 rt.device_put_sharded_rows(y),
                 rt.device_put_sharded_rows(w), n_rows, n_features,
                 x_scale=scale)
        ds._fp8_probe_ratio = ratio
        ds._valid_mask = mask
        return ds

    def map_batches(self, fn: Callable):
        """``fn(x, y, w)`` over the padded device arrays (the reference
        jits it; here it runs eagerly on the device)."""
        return fn(self.x, self.y, self.w)

    def unpad(self, arr: np.ndarray) -> np.ndarray:
        """The real rows of a host array aligned with the padded rows."""
        if self._valid_mask is not None:
            return arr[self._valid_mask]
        return arr[:self.n_rows]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_features)

    def y_host(self) -> np.ndarray:
        """Padded label vector as numpy."""
        if self._yw_host is not None:
            return self._yw_host[0]
        return self.y.cpu().numpy()

    def w_host(self) -> np.ndarray:
        """Padded weight vector as numpy."""
        if self._yw_host is not None:
            return self._yw_host[1]
        return self.w.cpu().numpy()

    def padded_bytes(self) -> int:
        """Storage footprint of the padded block: its tensors' bytes when
        it was made (never touches, so never restores, them)."""
        return self._nbytes

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Unpadded host copies; a bf16 X comes back as float32, fp8 codes
        dequantized to float64 values (host readbacks always see values)."""
        n = self.n_rows
        x = self.x[:n]
        if x.dtype == torch.bfloat16:
            x = x.float()
        if self._x_scale is not None:
            x = x.double().cpu().numpy() * self._x_scale[None, :]
        else:
            x = x.cpu().numpy()
        return (x, self.y[:n].cpu().numpy(), self.w[:n].cpu().numpy())

    def tree_aggregate_fn(self, fn: Callable, auto_psum: bool = True):
        """``fn(x_shard, y_shard, w_shard, *extras) -> pytree`` summed over
        the mesh; returns a callable taking the extras. ``.compiled`` is the
        aggregation over explicit ``(x, y, w, *extras)`` and ``.arrays()``
        the dataset's arrays, so a caller can run the aggregation inside
        its own loop."""
        compiled = collectives.tree_aggregate(
            fn, self.ctx.mesh_runtime, self.x, self.y, self.w,
            auto_psum=auto_psum)
        ds = self

        def call(*extras):
            return compiled(ds.x, ds.y, ds.w, *extras)

        call.compiled = compiled
        call.arrays = lambda: (ds.x, ds.y, ds.w)
        return call
