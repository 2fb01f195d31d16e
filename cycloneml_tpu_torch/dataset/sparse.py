"""Sparse instance datasets — the Criteo-class tier.

The port's counterpart of ``cycloneml_tpu/dataset/sparse.py``: rows in the
ELL layout, every row exactly ``k_max`` (column, value) slots, short rows
padded with (0, 0.0); optionally HYBRID (ELL + COO), where rows wider than
the ELL width keep their first k slots in ELL and spill the rest into a COO
tail (row id, column, value), padded with (0, 0, 0.0). Indices are int32,
values, labels and weights float32 (as the reference stores them); padding
rows carry w = 0.

On the card the aggregators run the hand-written passes of
``csrc/ell_sweep.cu`` (``ops/kernels.ell_rows`` and ``ell_cols``). The
column pass reads a copy of the nonzeros in (row block, column, row) order
(:meth:`SparseInstanceDataset.columns`), and the row pass a table of the
hot columns (:meth:`SparseInstanceDataset.hot_columns`); both are built at
first use on the card by deterministic integer steps and cached, shared
with every standardized view of the same rows.

Standardization (:func:`standardize_sparse_dataset`) scales by 1/std
without centering, as the reference does, but keeps no scaled copy: the
view carries the float32 ``scale`` (d,) and every pass reads ``value *
scale[index]``, the same float32 product the reference stores.

The streamed libsvm ingest (:meth:`SparseInstanceDataset.from_libsvm_stream`,
:func:`read_libsvm_sparse`) reads the file with the port's native scanner
(``native/host.py``) into a pinned staging ring, copies each CSR chunk onto
the device on a side stream while the next one parses, and builds the ELL
on the device once its width is known, in file order.
"""

from __future__ import annotations

import copy
import os
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.ops import kernels


def _rows_to_pairs(rows, n_features: Optional[int] = None):
    """Normalize [(indices, values)] rows or SparseVectors to array pairs,
    inferring the feature dimension — the one row parser of the pure-ELL
    and hybrid constructors."""
    pairs = []
    d = n_features or 0
    for r in rows:
        if hasattr(r, "indices"):  # SparseVector
            idx, val = np.asarray(r.indices), np.asarray(r.values)
            d = max(d, getattr(r, "size", 0))
        else:
            idx, val = np.asarray(r[0]), np.asarray(r[1])
        if idx.size:
            d = max(d, int(idx.max()) + 1)
        pairs.append((idx, val))
    return pairs, d


def rows_to_ell(rows, n_features: Optional[int] = None,
                k_max: Optional[int] = None
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """[(indices, values)] rows (or SparseVectors) as ELL arrays: (indices
    (n, k) int32, values (n, k) float32, n_features). A row longer than
    ``k_max`` raises (truncating it would corrupt gradients; use
    ``SparseInstanceDataset.from_rows_hybrid`` for any row length)."""
    pairs, d = _rows_to_pairs(rows, n_features)
    k = max((p[0].size for p in pairs), default=1)
    if k_max is not None:
        if k > k_max:
            raise ValueError(f"row has {k} nonzeros > k_max={k_max}")
        k = k_max
    k = max(k, 1)
    n = len(pairs)
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=np.float32)
    for i, (idx, val) in enumerate(pairs):
        indices[i, : idx.size] = idx
        values[i, : idx.size] = val
    return indices, values, d


def _csr_to_ell(row_nnz: np.ndarray, flat_idx: np.ndarray,
                flat_val: np.ndarray, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """A CSR chunk as ELL (n, k) arrays, rows padded with (0, 0.0)."""
    n = len(row_nnz)
    indices = np.zeros((n, k), dtype=np.int32)
    values = np.zeros((n, k), dtype=np.float32)
    if n == 0 or len(flat_idx) == 0:
        return indices, values
    offsets = np.concatenate([[0], np.cumsum(row_nnz[:-1], dtype=np.int64)])
    cols = np.arange(k)[None, :]
    mask = cols < row_nnz[:, None]
    pos = offsets[:, None] + cols
    indices[mask] = flat_idx[pos[mask]]
    values[mask] = flat_val[pos[mask]]
    return indices, values


HASH_MULTIPLIER = 2654435761


def hash_features(indices: np.ndarray, values: np.ndarray,
                  num_features: int) -> Tuple[np.ndarray, np.ndarray]:
    """The hashing trick: column ids remapped into [0, num_features) by
    the reference's multiplicative hash (collisions sum; the padding slots
    (0, 0.0) survive it, their value being 0)."""
    hashed = (indices.astype(np.int64) * HASH_MULTIPLIER % 2**31) \
        % num_features
    return hashed.astype(np.int32), values


def hash_features_torch(indices: torch.Tensor,
                        num_features: int) -> torch.Tensor:
    """:func:`hash_features` on a tensor of column ids (any device): the
    same int64 arithmetic, int32 result."""
    return ((indices.long() * HASH_MULTIPLIER) % 2**31
            % num_features).int()


def _check_ids(ids: torch.Tensor, bound: int, what: str) -> None:
    """Raise unless every id lies in [0, bound): one min/max reduction on
    the ids' device and one readback. The kernels gather by these ids
    unchecked, so a stray id is stopped here, at ingest."""
    if ids.numel() == 0:
        return
    lo, hi = torch.stack(torch.aminmax(ids)).tolist()
    if lo < 0 or hi >= bound:
        raise ValueError(f"{what} ids must lie in [0, {bound}); found "
                         f"{lo} to {hi}")


def _pad_rows(n: int) -> int:
    """Rows after padding: a multiple of 8 (the dense tier's rule on the
    port's one-shard mesh), at least 8."""
    return max((n + 7) // 8 * 8, 8)


class SparseInstanceDataset:
    """ELL rows on the mesh's device: ``indices``/``values`` (n_pad, k),
    ``y``/``w`` (n_pad,) float32, padding rows with w = 0; optionally the
    COO tail ``coo_row``/``coo_idx``/``coo_val`` (row ids local to the
    one shard); optionally a float32 ``scale`` (d,) that every pass
    multiplies into the values (a standardized view). Column ids outside
    [0, n_features) and tail row ids outside the rows raise ValueError."""

    def __init__(self, ctx, indices: torch.Tensor, values: torch.Tensor,
                 y: torch.Tensor, w: torch.Tensor, n_rows: int,
                 n_features: int, coo_row=None, coo_idx=None, coo_val=None,
                 scale: Optional[torch.Tensor] = None):
        if ctx.mesh_runtime.data_parallelism != 1:
            raise NotImplementedError(
                "a sparse dataset over several shards is ROADMAP slice 8")
        _check_ids(indices, n_features, "column")
        if coo_row is not None:
            _check_ids(coo_idx, n_features, "COO column")
            _check_ids(coo_row, indices.shape[0], "COO row")
        self.ctx = ctx
        self.indices = indices
        self.values = values
        self.y = y
        self.w = w
        self.n_rows = n_rows
        self.n_features = n_features
        # the hybrid tail: all three set, or none
        self.coo_row = coo_row
        self.coo_idx = coo_idx
        self.coo_val = coo_val
        self.scale = scale
        # built at first use and shared with standardized views: the
        # row-grouped tail, the blocked column copy, the hot columns
        self._layout: dict = {}
        self._yw_host: Optional[Tuple[np.ndarray, np.ndarray]] = None

    #: (stats, staging rings) of the ingest that made the dataset
    _ingest: Optional[tuple] = None

    @property
    def ingest_stats(self) -> Optional[dict]:
        """The split of the time of the streamed ingest that made the
        dataset (None for any other). The copies' device time is read at
        the first access, which waits on the host for the last copy."""
        from cycloneml_tpu_torch.dataset.staging import settle
        return None if self._ingest is None else settle(*self._ingest)

    @property
    def is_hybrid(self) -> bool:
        return self.coo_row is not None

    @property
    def device(self) -> torch.device:
        return self.values.device

    @classmethod
    def _place(cls, ctx, indices: np.ndarray, values: np.ndarray, y, w,
               n_rows: int, d: int, coo=None) -> "SparseInstanceDataset":
        rt = ctx.mesh_runtime
        n_pad = indices.shape[0]
        y_p = np.zeros(n_pad, dtype=np.float32)
        w_p = np.zeros(n_pad, dtype=np.float32)
        if y is not None:
            y_p[:n_rows] = np.asarray(y, dtype=np.float64)
        w_p[:n_rows] = 1.0 if w is None else np.asarray(w, dtype=np.float64)
        put = rt.device_put_sharded_rows
        coo = coo or (None, None, None)
        ds = cls(ctx, put(indices), put(values), put(y_p), put(w_p), n_rows,
                 d, *[None if a is None else put(a) for a in coo])
        ds._yw_host = (y_p, w_p)
        return ds

    @classmethod
    def from_ell(cls, ctx, indices: np.ndarray, values: np.ndarray,
                 y: Optional[np.ndarray] = None,
                 w: Optional[np.ndarray] = None,
                 n_features: Optional[int] = None) -> "SparseInstanceDataset":
        """ELL arrays (n, k) as a dataset, padded with (0, 0.0) rows of
        weight 0."""
        n, k = indices.shape
        d = n_features or (int(indices.max()) + 1 if indices.size else 1)
        n_pad = _pad_rows(n)
        idx_p = np.zeros((n_pad, k), dtype=np.int32)
        val_p = np.zeros((n_pad, k), dtype=np.float32)
        idx_p[:n] = indices
        val_p[:n] = values
        return cls._place(ctx, idx_p, val_p, y, w, n, d)

    @classmethod
    def from_rows(cls, ctx, rows, y=None, w=None,
                  n_features: Optional[int] = None,
                  hash_dim: Optional[int] = None) -> "SparseInstanceDataset":
        indices, values, d = rows_to_ell(rows, n_features)
        if hash_dim is not None:
            indices, values = hash_features(indices, values, hash_dim)
            d = hash_dim
        return cls.from_ell(ctx, indices, values, y, w, n_features=d)

    @classmethod
    def from_libsvm_stream(cls, ctx, path: str,
                           n_features: Optional[int] = None,
                           hash_dim: Optional[int] = None,
                           k_max: Optional[int] = None,
                           chunk_rows: int = 65536,
                           n_threads: int = 0,
                           n_readers: int = 1,
                           collect_labels: Optional[list] = None
                           ) -> "SparseInstanceDataset":
        """Bounded-memory ingest of a libsvm file onto the device (the
        reference's ``from_libsvm_stream``; ref HadoopRDD.scala:87
        partition streaming feeding MLUtils.loadLibSVMFile,
        MLUtils.scala:77): the host never holds more than the staging
        ring's chunks.

        The native scanner writes each CSR chunk (labels, row nnz, ids,
        values) into a slot of a ring of pinned buffers
        (:class:`~cycloneml_tpu_torch.dataset.staging.StagingRing`), which
        is copied onto the device on a side stream while the next chunk
        parses. ``n_readers > 1`` splits the file into byte ranges read by
        concurrent threads (ctypes releases the GIL), each with its own
        ring. Once every chunk is on the device the ELL is built there
        with the widest row's width (or ``k_max``, which rejects a wider
        row), the chunks released as they are placed: peak device memory
        is the CSR chunks plus the ELL, at most twice the dataset and a
        fraction of one chunk.

        Rows keep FILE ORDER whatever ``n_readers`` (reader by reader, each
        reader's chunks in order), so every reader count gives the same
        dataset bit for bit; the reference places chunks round-robin over
        its devices in arrival order. Ids are 1-based on disk: a file with
        a ``0:`` index raises (the reference stores -1), as does an id at
        or past ``n_features`` (unless ``hash_dim`` folds the ids into
        ``hash_dim`` columns with :func:`hash_features`).

        ``collect_labels``: pass an empty list to receive the float64
        labels as chunks in the dataset's row order (one list: the port's
        one shard). The host waits for no copy at the end: the assembly
        and every later use are ordered after the copies on the caller's
        stream. ``ingest_stats`` holds the split of the time.
        """
        from cycloneml_tpu_torch.native.host import native_available
        rt = ctx.mesh_runtime
        if rt.data_parallelism != 1:
            raise NotImplementedError(
                "a sparse dataset over several shards is ROADMAP slice 8")
        if n_readers > 1 and not native_available():
            raise NotImplementedError(
                "n_readers > 1 needs the native scanner (not built here)")
        t_all = time.perf_counter()
        if n_readers <= 1:
            ranges, threads_each = [None], n_threads
        else:
            size = os.path.getsize(path)
            ranges = [(i * size // n_readers, (i + 1) * size // n_readers)
                      for i in range(n_readers)]
            threads_each = max(
                1, (n_threads or (os.cpu_count() or 1)) // n_readers)
        bound = None if hash_dim is not None else n_features
        stop = threading.Event()   # set by a reader that fails
        readers = [_LibsvmReader(path, rng, chunk_rows, threads_each,
                                 rt.device, bound, k_max, stop)
                   for rng in ranges]
        if len(readers) == 1:
            readers[0].run()
        else:
            workers = [threading.Thread(target=r.run, daemon=True)
                       for r in readers]
            for t in workers:
                t.start()
            for t in workers:
                t.join()
        stats = {"parse_s": 0.0, "host_s": 0.0, "wait_s": 0.0,
                 "alloc_s": 0.0, "bytes": 0, "chunks": 0,
                 "max_copy_bytes": 0}
        chunks: List[_CsrChunk] = []
        for r in readers:
            ring = r.ring.finish()   # the caller's stream waits on the copies
            for key in ("wait_s", "alloc_s", "bytes"):
                stats[key] += ring[key]
            stats["max_copy_bytes"] = max(stats["max_copy_bytes"],
                                          ring["max_copy_bytes"])
            stats["parse_s"] += r.parse_s
            stats["host_s"] += r.host_s
            stats["chunks"] += len(r.chunks)
            chunks.extend(r.chunks)   # reader by reader: file order
            r.chunks = []             # placed chunks are released
        for r in readers:             # raised once the copies are ordered
            if r.error is not None:
                raise r.error
        t0 = time.perf_counter()
        max_feature = max((c.max_feature for c in chunks), default=0)
        k = max([k_max or 1] + [c.k for c in chunks])
        n = sum(c.rows for c in chunks)
        nonzeros = sum(c.used for c in chunks)
        if collect_labels is not None:
            collect_labels.append([c.labels for c in chunks])
        y_host = np.zeros(_pad_rows(n), dtype=np.float32)
        if n:
            y_host[:n] = np.concatenate([c.labels for c in chunks])
        w_host = np.zeros(len(y_host), dtype=np.float32)
        w_host[:n] = 1.0
        indices, values, y, lowest = _assemble_ell(chunks, len(y_host), k,
                                                   hash_dim, rt.device)
        if lowest is not None and lowest < 0:
            raise ValueError(
                f"{path!r} holds a feature index 0 (found {lowest + 1}): "
                "libsvm ids are 1-based")
        w = rt.device_put_sharded_rows(w_host)
        d = hash_dim or n_features or max(max_feature, 1)
        ds = cls(ctx, indices, values, y, w, n, d)
        ds._yw_host = (y_host, w_host)
        stats.update(rows=n, nonzeros=nonzeros,
                     dataset_bytes=sum(t.numel() * t.element_size()
                                       for t in (indices, values, y, w)),
                     k=k, assembly_s=time.perf_counter() - t0,
                     wall_s=time.perf_counter() - t_all)
        ds._ingest = (stats, [r.ring for r in readers])
        return ds

    @classmethod
    def from_rows_hybrid(cls, ctx, rows, y=None, w=None,
                         n_features: Optional[int] = None,
                         k_ell: int = 16) -> "SparseInstanceDataset":
        """The ELL + COO hybrid: each row's first ``k_ell`` nonzeros go to
        ELL, the rest to the COO tail (in row order), padded to at least
        one entry with (row 0, col 0, 0.0), which is exactly neutral."""
        pairs, d = _rows_to_pairs(rows, n_features)
        n = len(pairs)
        k = max(1, min(k_ell, max((p[0].size for p in pairs), default=1)))
        n_pad = _pad_rows(n)
        indices = np.zeros((n_pad, k), dtype=np.int32)
        values = np.zeros((n_pad, k), dtype=np.float32)
        tail = []
        for i, (idx, val) in enumerate(pairs):
            m = min(idx.size, k)
            indices[i, :m] = idx[:m]
            values[i, :m] = val[:m]
            for j in range(k, idx.size):
                tail.append((i, int(idx[j]), float(val[j])))
        size = max(len(tail), 1)
        coo_row = np.zeros(size, dtype=np.int32)
        coo_idx = np.zeros(size, dtype=np.int32)
        coo_val = np.zeros(size, dtype=np.float32)
        for j, (r, c, v) in enumerate(tail):
            coo_row[j], coo_idx[j], coo_val[j] = r, c, v
        return cls._place(ctx, indices, values, y, w, n, d,
                          coo=(coo_row, coo_idx, coo_val))

    @classmethod
    def from_scipy(cls, ctx, csr, y=None, w=None,
                   hash_dim: Optional[int] = None) -> "SparseInstanceDataset":
        """From a scipy.sparse matrix (read as CSR)."""
        csr = csr.tocsr()
        rows = [(csr.indices[csr.indptr[i]:csr.indptr[i + 1]],
                 csr.data[csr.indptr[i]:csr.indptr[i + 1]])
                for i in range(csr.shape[0])]
        return cls.from_rows(ctx, rows, y, w, n_features=csr.shape[1],
                             hash_dim=hash_dim)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_features)

    @property
    def k_max(self) -> int:
        return self.indices.shape[1]

    def y_host(self) -> np.ndarray:
        """Padded float32 labels as numpy (kept from ingest, or read back
        once)."""
        if self._yw_host is None:
            self._yw_host = (self.y.cpu().numpy(), self.w.cpu().numpy())
        return self._yw_host[0]

    def w_host(self) -> np.ndarray:
        """Padded float32 weights as numpy."""
        self.y_host()
        return self._yw_host[1]

    def tail(self) -> Optional[kernels.EllTail]:
        """The COO tail grouped by row (:func:`kernels.ell_tail`), built at
        first use and cached; None without a tail."""
        if not self.is_hybrid:
            return None
        if "tail" not in self._layout:
            self._layout["tail"] = kernels.ell_tail(
                self.coo_row, self.coo_idx, self.coo_val,
                self.indices.shape[0])
        return self._layout["tail"]

    def columns(self) -> kernels.EllColumns:
        """The copy of the nonzeros in (row block, column, row) order that
        the column pass reads (:func:`kernels.ell_columns`), built at first
        use and cached."""
        if "columns" not in self._layout:
            self._layout["columns"] = kernels.ell_columns(
                self.indices, self.values, self.n_features, self.tail())
        return self._layout["columns"]

    def hot_columns(self) -> torch.Tensor:
        """The row pass's table of hot columns
        (:func:`kernels.ell_hot_columns`), built at first use and
        cached."""
        if "hot" not in self._layout:
            self._layout["hot"] = kernels.ell_hot_columns(
                self.indices, self.values, self.n_features, self.tail())
        return self._layout["hot"]

    def scaled(self, scale: torch.Tensor) -> "SparseInstanceDataset":
        """A view of these rows whose values read ``value * scale[index]``
        (float32); arrays, host labels and the built layouts are shared."""
        if self.scale is not None:
            raise ValueError("the dataset is already scaled")
        ds = copy.copy(self)  # shares the arrays and the layouts' dict
        ds.scale = scale.to(device=self.device, dtype=torch.float32)
        return ds

    def tree_aggregate_fn(self, fn: Callable, auto_psum: bool = True):
        """``fn(block, *extras) -> pytree`` summed over the mesh's shards;
        ``block`` is the shard's rows (this dataset on the port's one-shard
        mesh: indices, values, y, w, the tail, the scale and the layouts).
        Returns a callable taking the extras, with ``.compiled`` (the same,
        over an explicit block) and ``.arrays()`` (the block) as the dense
        tier's has."""
        ds = self

        def compiled(block, *extras):
            return fn(block, *extras)

        def call(*extras):
            return compiled(ds, *extras)

        call.compiled = compiled
        call.arrays = lambda: (ds,)
        return call

    def to_dense(self) -> np.ndarray:
        """The present rows (w > 0) as a dense float64 array, scale
        applied — tests and debugging only."""
        mask = self.w_host() > 0
        idx = self.indices.cpu().numpy()
        val = self.values.cpu().numpy()
        scale = None if self.scale is None else self.scale.cpu().numpy()
        if scale is not None:
            val = val * scale[idx]
        full = np.zeros((idx.shape[0], self.n_features))
        for i in range(idx.shape[0]):
            np.add.at(full[i], idx[i], val[i])
        if self.is_hybrid:
            crow = self.coo_row.cpu().numpy()
            cidx = self.coo_idx.cpu().numpy()
            cval = self.coo_val.cpu().numpy()
            if scale is not None:
                cval = cval * scale[cidx]
            np.add.at(full, (crow, cidx), cval)
        return full[mask]


_SUB_ROWS = 1 << 12  # rows of a chunk placed into the ELL at a time


class _CsrChunk(NamedTuple):
    """One chunk of the streamed ingest on the device (float32 labels, row
    nnz, ids, values), with what the host knows of it: its rows,
    nonzeros, widest row, the CSR offsets at every ``_SUB_ROWS`` rows, its
    float64 labels and the running max feature."""

    rows: int
    used: int
    k: int
    offsets: np.ndarray
    labels: np.ndarray
    max_feature: int
    y: torch.Tensor
    nnz: torch.Tensor
    idx: torch.Tensor
    val: torch.Tensor


class _LibsvmReader:
    """Reads one byte range of a libsvm file (None: the whole file) into
    its own staging ring and onto the device, chunk by chunk, keeping the
    chunks in order. ``n_features`` (None when hashing) and ``k_max`` are
    checked on the host as each chunk arrives; a reader that fails sets
    ``stop``, and every reader stops at its next chunk."""

    def __init__(self, path, byte_range, chunk_rows, n_threads, device,
                 n_features, k_max, stop):
        from cycloneml_tpu_torch.dataset.staging import StagingRing
        self.path, self.byte_range = path, byte_range
        self.chunk_rows, self.n_threads = chunk_rows, n_threads
        self.cap_nnz = chunk_rows * 64
        self.n_features, self.k_max, self.stop = n_features, k_max, stop
        self.ring = StagingRing(device)
        self.chunks: List[_CsrChunk] = []
        self.parse_s = self.host_s = 0.0
        self.error: Optional[BaseException] = None

    def _slot(self, slot):
        b = self.ring.buffer
        return (b(slot, "y", self.chunk_rows, torch.float64),
                b(slot, "y32", self.chunk_rows, torch.float32),
                b(slot, "nnz", self.chunk_rows, torch.int32),
                b(slot, "idx", self.cap_nnz, torch.int32),
                b(slot, "val", self.cap_nnz, torch.float32))

    def _native_fills(self):
        """Fill functions over the native stream: each writes the next
        chunk into a slot's buffers and returns (rows, max_feature)."""
        from cycloneml_tpu_torch.native.host import LibsvmStream
        stream = LibsvmStream(self.path, n_threads=self.n_threads,
                              byte_range=self.byte_range)

        def fill(bufs):
            y, _, nnz, idx, val = bufs
            return stream.next_into(y.data_ptr(), nnz.data_ptr(),
                                    idx.data_ptr(), val.data_ptr(),
                                    self.chunk_rows, self.cap_nnz)
        return fill, stream.close

    def _python_fills(self):
        """The same over the pure-Python twin (no native library)."""
        from cycloneml_tpu_torch.native.host import stream_libsvm_views
        gen = stream_libsvm_views(self.path, chunk_rows=self.chunk_rows,
                                  cap_nnz=self.cap_nnz)

        def fill(bufs):
            got = next(gen, None)
            if got is None:
                return 0, 0
            cy, cnnz, cfi, cfv, mf = got
            y, _, nnz, idx, val = bufs
            for dst, src in ((y, cy), (nnz, cnnz), (idx, cfi), (val, cfv)):
                dst[:len(src)].copy_(torch.from_numpy(src))
            return len(cy), mf
        return fill, gen.close

    def run(self) -> None:
        from cycloneml_tpu_torch.native.host import native_available
        try:
            fill, close = (self._native_fills() if native_available()
                           else self._python_fills())
            try:
                self._read(fill)
            finally:
                close()
        except BaseException as e:  # raised again by the caller's thread
            self.error = e
            self.stop.set()

    def _read(self, fill) -> None:
        n_features, k_max = self.n_features, self.k_max
        while not self.stop.is_set():
            slot = self.ring.acquire()
            bufs = self._slot(slot)
            t0 = time.perf_counter()
            m, mf = fill(bufs)
            t1 = time.perf_counter()
            self.parse_s += t1 - t0
            if m == 0:
                return
            if n_features is not None and mf > n_features:
                raise ValueError(
                    f"observed feature index {mf - 1} >= declared "
                    f"n_features={n_features}; pass n_features>={mf} or "
                    "hash_dim to fold indices")
            y, y32, nnz, idx, val = bufs
            nnz_host = nnz[:m].numpy()
            ends = np.cumsum(nnz_host, dtype=np.int64)
            used, k = int(ends[-1]), max(int(nnz_host.max()), 1)
            if k_max is not None and k > k_max:
                raise ValueError(f"row has {k} nonzeros > k_max={k_max}")
            starts = np.arange(0, m, _SUB_ROWS)
            offsets = np.append(np.where(starts > 0, ends[starts - 1], 0),
                                used)
            labels = y[:m].numpy().copy()
            y32[:m] = y[:m]                      # round to nearest, as numpy
            on_device = self.ring.put(slot, [y32[:m], nnz[:m], idx[:used],
                                             val[:used]])
            self.chunks.append(_CsrChunk(m, used, k, offsets, labels, mf,
                                         *on_device))
            self.host_s += time.perf_counter() - t1


def _assemble_ell(chunks: List[_CsrChunk], n_pad: int, k: int,
                  hash_dim: Optional[int], device):
    """The ELL (indices, values, y) of the chunks in order, built on the
    device ``_SUB_ROWS`` rows at a time (each row's CSR entries scattered
    into its first slots, in order; ids hashed first when ``hash_dim``);
    each chunk is released once placed. Also returns the smallest raw id
    (None without nonzeros), read back once."""
    indices = torch.zeros((n_pad, k), dtype=torch.int32, device=device)
    values = torch.zeros((n_pad, k), dtype=torch.float32, device=device)
    y = torch.zeros(n_pad, dtype=torch.float32, device=device)
    slots = torch.arange(k, device=device, dtype=torch.int32)
    lowest = None
    r0 = 0
    while chunks:
        c = chunks.pop(0)
        y[r0:r0 + c.rows] = c.y
        for b, lo in enumerate(range(0, c.rows, _SUB_ROWS)):
            hi = min(lo + _SUB_ROWS, c.rows)
            e0, e1 = int(c.offsets[b]), int(c.offsets[b + 1])
            if e1 == e0:
                continue
            ids = c.idx[e0:e1]
            low = ids.min()
            lowest = low if lowest is None else torch.minimum(lowest, low)
            if hash_dim is not None:
                ids = hash_features_torch(ids, hash_dim)
            mask = slots[None, :] < c.nnz[lo:hi, None]
            indices[r0 + lo:r0 + hi].masked_scatter_(mask, ids)
            values[r0 + lo:r0 + hi].masked_scatter_(mask, c.val[e0:e1])
            del ids, mask
        r0 += c.rows
        del c
    return indices, values, y, (None if lowest is None else
                                int(lowest.item()))


def read_libsvm_sparse(ctx, path: str, n_features: Optional[int] = None,
                       hash_dim: Optional[int] = None,
                       chunk_rows: int = 65536, n_readers: int = 1
                       ) -> Tuple[SparseInstanceDataset, np.ndarray]:
    """libsvm to ELL without densifying (the dense reader is
    ``dataset.io.read_libsvm``): :meth:`SparseInstanceDataset.
    from_libsvm_stream` with ``n_readers`` readers, and the float64 labels
    in the dataset's row order (file order), the one O(n) host array."""
    labels: list = []
    ds = SparseInstanceDataset.from_libsvm_stream(
        ctx, path, n_features=n_features, hash_dim=hash_dim,
        chunk_rows=chunk_rows, n_readers=n_readers, collect_labels=labels)
    parts = [c for shard in labels for c in shard]
    y = np.concatenate(parts) if parts else np.zeros(0)
    return ds, y


def sparse_feature_std(ds: SparseInstanceDataset) -> np.ndarray:
    """Per-feature std over a sparse dataset, implicit zeros included: the
    unbiased weighted formula of the dense Summarizer, from one pass of
    per-feature weighted sums and squares (:func:`sparse_summary`)."""
    from cycloneml_tpu_torch.ml.optim.sparse_aggregators import (
        sparse_summary, sparse_summary_hybrid)
    summ = sparse_summary_hybrid if ds.is_hybrid else sparse_summary
    out = ds.tree_aggregate_fn(summ(ds.n_features))(None)
    w = float(out["weight_sum"])
    s1 = out["sum"].cpu().double().numpy()
    s2 = out["sum_sq"].cpu().double().numpy()
    denom = w - float(out["weight_sq_sum"]) / max(w, 1e-300)
    mean = s1 / max(w, 1e-300)
    if denom <= 0:
        return np.zeros_like(mean)
    var = np.maximum((s2 - w * mean * mean) / denom, 0.0)
    return np.sqrt(var)


def standardize_sparse_dataset(ds: SparseInstanceDataset,
                               features_std: np.ndarray
                               ) -> Tuple[SparseInstanceDataset, np.ndarray]:
    """Scale the values by 1/std WITHOUT centering (centering would
    densify; the reference's note at LogisticRegression.scala:968);
    zero-variance features scale to 0. Returns (the view, inv_std float64).
    The view keeps no scaled copy: its passes read ``value * inv_std32[
    index]`` in float32, the product the reference stores."""
    std = np.asarray(features_std, dtype=np.float64)
    inv_std = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 0.0)
    return ds.scaled(torch.as_tensor(inv_std, dtype=torch.float32)), inv_std
