"""Data ingest: libsvm, ``.npy`` and CSV readers.

The port's counterpart of ``cycloneml_tpu/dataset/io.py``: whole-file
readers that parse on the host and place the result with
``InstanceDataset.from_numpy``, and streamed readers that yield ``(x, y,
w)`` host chunks into ``InstanceDataset.from_dense_chunks``, which stages
them through pinned buffers onto the card. The chunk iterators
(:func:`iter_libsvm_chunks`, :func:`iter_npy_chunks`,
:func:`iter_csv_chunks`) are also the sources of the out-of-core tier:
``oocore.StreamingDataset.from_chunks(ctx, iter_npy_chunks(path, ...),
d)`` writes a file's rows to shards without an in-core dataset ever
existing. LibSVM ids are 1-based on disk (``MLUtils.loadLibSVMFile``).

The libsvm and CSV parses run on the port's native scanner
(``native/host.py``) when it is built; the pure-Python parsers here are its
twins, used only when it is not (``native`` warns once then). A read that
fails raises: nothing falls back on an error.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset

logger = logging.getLogger(__name__)


def parse_libsvm(path: str, n_features: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a libsvm file to dense (X float64, y float64). Indices are
    1-based on disk. The multithreaded native parser (float32 values)
    when it is built; this Python loop (float64 values) when it is not."""
    from cycloneml_tpu_torch.native.host import (count_read,
                                                 parse_libsvm_native)
    got = parse_libsvm_native(path, n_features)
    if got is not None:
        return np.asarray(got[0], dtype=np.float64), got[1]
    count_read("python")
    labels = []
    rows = []
    max_idx = 0
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            labels.append(float(parts[0]))
            idx = []
            vals = []
            for tok in parts[1:]:
                i, v = tok.split(":")
                idx.append(int(i) - 1)
                vals.append(float(v))
            if idx:
                max_idx = max(max_idx, max(idx))
            rows.append((np.array(idx, dtype=np.int32), np.array(vals)))
    d = n_features if n_features is not None else max_idx + 1
    x = np.zeros((len(rows), d), dtype=np.float64)
    for r, (idx, vals) in enumerate(rows):
        x[r, idx] = vals
    return x, np.array(labels, dtype=np.float64)


#: files above this size stream through the chunked readers instead of a
#: whole-file parse (override per call with ``streamed=``)
DENSE_STREAM_THRESHOLD = 256 << 20


def read_libsvm(ctx, path: str, n_features: Optional[int] = None,
                streamed: Optional[bool] = None) -> InstanceDataset:
    """Dense libsvm ingest. Large files (``streamed=None`` and a size over
    :data:`DENSE_STREAM_THRESHOLD`, or ``streamed=True``) stream CSR
    chunks from the scanner, densify them a chunk at a time and stage them
    onto the device (``InstanceDataset.from_dense_chunks``): the host never
    holds the dense matrix. Streaming needs ``n_features`` (the chunk width
    is fixed up front); without it a large file is parsed whole, with a
    warning (``SparseInstanceDataset.from_libsvm_stream`` infers the
    width)."""
    if streamed is None:
        big = os.path.getsize(path) > DENSE_STREAM_THRESHOLD
        streamed = n_features is not None and big
        if big and not streamed:
            logger.warning(
                "read_libsvm: %s exceeds the streaming threshold but "
                "n_features was not given — falling back to WHOLE-FILE "
                "host materialization; pass n_features to stream, or use "
                "SparseInstanceDataset.from_libsvm_stream (infers it)", path)
    if streamed:
        if n_features is None:
            raise ValueError("streamed dense libsvm ingest requires "
                             "n_features (chunk width is fixed up-front)")
        return InstanceDataset.from_dense_chunks(
            ctx, _libsvm_dense_chunks(path, n_features), n_features)
    x, y = parse_libsvm(path, n_features)
    return InstanceDataset.from_numpy(ctx, x, y)


def iter_libsvm_chunks(path: str, n_features: int, chunk_rows: int = 65536):
    """The dense libsvm chunk stream, each block arrays of its own: the
    ``(x, y, w)`` chunk contract of ``InstanceDataset.from_dense_chunks``
    and of ``oocore.StreamingDataset.from_chunks`` (a streamed fit's
    shards)."""
    for x, y, w in _libsvm_dense_chunks(path, n_features, chunk_rows):
        yield x.copy(), y, w


def _libsvm_dense_chunks(path: str, n_features: int,
                         chunk_rows: int = 65536):
    """Yield (x float32, y float64, None) dense blocks from the
    bounded-memory CSR stream. The scanner writes into buffers reused from
    chunk to chunk (:func:`stream_libsvm_views`) and x is densified into
    one float32 block, reused too: each x is overwritten by the next, so
    the consumer copies it first, as ``from_dense_chunks`` does (y is a
    copy). A row with a repeated index keeps its last value (numpy's
    assignment order), as the whole-file parse does."""
    from cycloneml_tpu_torch.native.host import stream_libsvm_views
    block = np.empty((0, n_features), dtype=np.float32)
    for cy, cnnz, cfi, cfv, mf in stream_libsvm_views(
            path, chunk_rows=chunk_rows):
        if mf > n_features:
            raise ValueError(
                f"observed feature index {mf - 1} >= declared "
                f"n_features={n_features}")
        m = len(cy)
        if block.shape[0] < m:
            block = np.empty((m, n_features), dtype=np.float32)
        x = block[:m]
        x.fill(0.0)
        x[np.repeat(np.arange(m), cnnz), cfi] = cfv
        yield x, cy.copy(), None


def _read_npy_header(fh):
    import numpy.lib.format as npf
    version = npf.read_magic(fh)
    if version == (1, 0):
        return npf.read_array_header_1_0(fh)
    if version == (2, 0):
        return npf.read_array_header_2_0(fh)
    return npf._read_array_header(fh, version)


def npy_header(path: str):
    """``(n_rows, n_cols, dtype)`` of a C-order 2-D .npy file: the shape
    probe the chunked readers size themselves from."""
    with open(path, "rb") as fh:
        shape, fortran, dt = _read_npy_header(fh)
    if fortran or len(shape) != 2:
        raise ValueError("chunked .npy ingest requires a C-order 2-D array")
    return shape[0], shape[1], dt


def iter_npy_chunks(path: str, label_col: Optional[int] = None,
                    chunk_rows: int = 65536):
    """Yield ``(x, y_or_None, None)`` blocks of a 2-D .npy file with plain
    ``file.read`` (no mmap: mapped pages would count toward the host's
    memory and defeat the bounded-memory contract); ``label_col`` splits
    one column off as a float64 label. A source of
    ``InstanceDataset.from_dense_chunks`` and of
    ``oocore.StreamingDataset.from_chunks``."""
    n, d_file, dt = npy_header(path)
    row_bytes = d_file * dt.itemsize
    with open(path, "rb") as fh:
        _read_npy_header(fh)
        done = 0
        while done < n:
            m = min(chunk_rows, n - done)
            buf = fh.read(m * row_bytes)
            if len(buf) != m * row_bytes:
                raise IOError(f"truncated .npy payload in {path!r}")
            block = np.frombuffer(buf, dtype=dt).reshape(m, d_file)
            if label_col is None:
                yield block, None, None
            else:
                y = block[:, label_col].astype(np.float64)
                yield np.delete(block, label_col, axis=1), y, None
            done += m


def read_npy_chunked(ctx, path: str, label_col: Optional[int] = None,
                     chunk_rows: int = 65536) -> InstanceDataset:
    """Streamed ingest of a 2-D .npy array: chunks read by
    :func:`iter_npy_chunks` are staged onto the device as they arrive."""
    _, d_file, _ = npy_header(path)
    d = d_file - (1 if label_col is not None else 0)
    return InstanceDataset.from_dense_chunks(
        ctx, iter_npy_chunks(path, label_col, chunk_rows), d)


def _first_data_line(fh, skip_header: bool):
    if skip_header:
        fh.readline()
    for line in fh:  # blank lines anywhere (incl. leading) are skipped
        if line.strip():
            return line
    return None


def iter_csv_chunks(path: str, label_col: int = 0, delimiter: str = ",",
                    skip_header: bool = False, chunk_rows: int = 65536):
    """Yield ``(x, y, None)`` blocks of a CSV file, one batch of lines at
    a time (``np.loadtxt`` per batch): a source of
    ``InstanceDataset.from_dense_chunks`` and of
    ``oocore.StreamingDataset.from_chunks``."""
    with open(path) as fh:
        first = _first_data_line(fh, skip_header)
        if first is None:
            return
        d_file = len(first.split(delimiter))
        batch = [first]
        for line in fh:
            if not line.strip():
                continue
            batch.append(line)
            if len(batch) >= chunk_rows:
                yield _csv_block(batch, delimiter, d_file, label_col)
                batch = []
        if batch:
            yield _csv_block(batch, delimiter, d_file, label_col)


def read_csv_chunked(ctx, path: str, label_col: int = 0, delimiter: str = ",",
                     skip_header: bool = False,
                     chunk_rows: int = 65536) -> InstanceDataset:
    """Streamed CSV ingest: line batches parsed and staged onto the device
    as they are read; the host holds one batch."""
    with open(path) as fh:
        head = _first_data_line(fh, skip_header)
    if head is None:
        raise ValueError(f"{path!r} has no data rows")
    d = len(head.split(delimiter)) - 1
    return InstanceDataset.from_dense_chunks(
        ctx, iter_csv_chunks(path, label_col, delimiter, skip_header,
                             chunk_rows), d)


def _csv_block(lines, delimiter, d_file, label_col):
    data = np.loadtxt(lines, delimiter=delimiter, ndmin=2)
    if data.shape[1] != d_file:
        raise ValueError(f"ragged CSV: expected {d_file} columns, "
                         f"got {data.shape[1]}")
    y = data[:, label_col]
    x = np.delete(data, label_col, axis=1)
    return x, y, None


def read_csv(ctx, path: str, label_col: int = 0, delimiter: str = ",",
             skip_header: bool = False) -> InstanceDataset:
    """A whole numeric CSV file as a dataset: the native parser when it is
    built, ``np.loadtxt`` when it is not."""
    from cycloneml_tpu_torch.native.host import count_read, parse_csv_native
    data = parse_csv_native(path, delimiter, skip_header)
    if data is None:
        count_read("python")
        data = np.loadtxt(path, delimiter=delimiter,
                          skiprows=1 if skip_header else 0)
    y = data[:, label_col]
    x = np.delete(data, label_col, axis=1)
    return InstanceDataset.from_numpy(ctx, x, y)
