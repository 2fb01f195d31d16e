"""ctypes surface over the port's native scanner, with pure-Python twins.

The port's copy of the scanner half of ``cycloneml_tpu/native/host.py``:
:func:`parse_libsvm_native` and :func:`parse_csv_native` (multithreaded
C++ parsers feeding dense arrays) and :func:`stream_libsvm_chunks` (a
libsvm file in bounded-memory CSR chunks, optionally one byte range of
it), whose pure-Python twin :func:`_stream_libsvm_py` keeps the same chunk
contract. The codecs and the KV store stay with ROADMAP Queue 1 item 12.

:class:`LibsvmStream` is the stream's lower level: the scanner writes each
chunk into buffers the caller owns (the pinned staging ring of
``dataset/staging.py``) instead of fresh arrays.

``READS`` counts the reads each side served (``native``, ``python``), so a
caller can hold that the native scanner served every read it made.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from cycloneml_tpu_torch.native import load


def _fn(lib, name, restype, argtypes):
    f = getattr(lib, name)
    f.restype = restype
    f.argtypes = argtypes
    return f


_c_i64 = ctypes.c_int64
_c_vp = ctypes.c_void_p

#: reads served by the native scanner and by the pure-Python twins
READS: collections.Counter = collections.Counter()
_reads_lock = threading.Lock()


def count_read(side: str) -> None:
    """One more read served by ``side`` (``native`` or ``python``); the
    readers of one ingest count from several threads at once."""
    with _reads_lock:
        READS[side] += 1


def reset_read_counts() -> None:
    with _reads_lock:
        READS.clear()


class _Lib:
    """Typed function table, built once."""

    _instance = None

    def __init__(self, lib):
        self.svm_open = _fn(lib, "svm_open", _c_vp,
                            [ctypes.c_char_p, ctypes.c_int,
                             ctypes.POINTER(_c_i64), ctypes.POINTER(_c_i64)])
        self.svm_fill = _fn(lib, "svm_fill", ctypes.c_int,
                            [_c_vp, _c_vp, _c_vp, _c_i64, _c_i64])
        self.svm_free = _fn(lib, "svm_free", None, [_c_vp])
        self.svm_stream_open = _fn(lib, "svm_stream_open", _c_vp,
                                   [ctypes.c_char_p, _c_i64, ctypes.c_int])
        self.svm_stream_open_range = _fn(
            lib, "svm_stream_open_range", _c_vp,
            [ctypes.c_char_p, _c_i64, ctypes.c_int, _c_i64, _c_i64])
        self.svm_stream_next = _fn(lib, "svm_stream_next", _c_i64,
                                   [_c_vp, _c_vp, _c_vp, _c_vp, _c_vp,
                                    _c_i64, _c_i64, ctypes.POINTER(_c_i64)])
        self.svm_stream_free = _fn(lib, "svm_stream_free", None, [_c_vp])
        self.csv_open = _fn(lib, "csv_open", _c_vp,
                            [ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
                             ctypes.c_int, ctypes.POINTER(_c_i64),
                             ctypes.POINTER(_c_i64)])
        self.csv_fill = _fn(lib, "csv_fill", ctypes.c_int,
                            [_c_vp, _c_vp, _c_i64, _c_i64])
        self.csv_free = _fn(lib, "csv_free", None, [_c_vp])


def _lib() -> Optional[_Lib]:
    if _Lib._instance is None:
        raw = load()
        if raw is None:
            return None
        _Lib._instance = _Lib(raw)
    return _Lib._instance


def native_available() -> bool:
    return _lib() is not None


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

def parse_libsvm_native(path: str, n_features: Optional[int] = None,
                        n_threads: int = 0
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Dense (X float32, y float64) via the C++ parser; None when the
    library is not built. A file that cannot be read raises (the
    reference returns None there and falls back)."""
    lib = _lib()
    if lib is None:
        return None
    nr, nf = _c_i64(), _c_i64()
    h = lib.svm_open(path.encode(), n_threads, ctypes.byref(nr),
                     ctypes.byref(nf))
    if not h:
        raise IOError(f"cannot read {path!r}")
    try:
        rows = nr.value
        d = n_features if n_features is not None else nf.value
        x = np.zeros((rows, max(d, 1)), dtype=np.float32)
        y = np.zeros(rows, dtype=np.float32)
        rc = lib.svm_fill(h, x.ctypes.data_as(_c_vp),
                          y.ctypes.data_as(_c_vp), rows, x.shape[1])
        if rc != 0:
            raise IOError(f"svm_fill failed on {path!r} ({rc})")
        count_read("native")
        return x[:, :d] if d else x, y.astype(np.float64)
    finally:
        lib.svm_free(h)


class LibsvmStream:
    """One native libsvm stream (the whole file, or the byte range
    ``(start, end)``: the partial first line skipped when ``start > 0``,
    every line starting at offset <= ``end`` kept). :meth:`next_into`
    writes the next chunk into the caller's buffers."""

    def __init__(self, path: str, buf_bytes: int = 8 << 20,
                 n_threads: int = 0,
                 byte_range: Optional[Tuple[int, int]] = None):
        lib = _lib()
        if lib is None:
            raise RuntimeError("the native scanner is not built")
        self._lib, self.path = lib, path
        if byte_range is not None:
            h = lib.svm_stream_open_range(path.encode(), buf_bytes,
                                          n_threads, byte_range[0],
                                          byte_range[1])
        else:
            h = lib.svm_stream_open(path.encode(), buf_bytes, n_threads)
        if not h:
            raise IOError(f"cannot open {path!r}")
        self._h = h
        count_read("native")

    def next_into(self, y: int, nnz: int, idx: int, val: int,
                  max_rows: int, cap_nnz: int) -> Tuple[int, int]:
        """Fill the buffers at addresses ``y`` (float64, ``max_rows``),
        ``nnz`` (int32, ``max_rows``), ``idx`` (int32, ``cap_nnz``) and
        ``val`` (float32, ``cap_nnz``) with up to ``max_rows`` whole rows;
        returns (rows, max_feature so far). 0 rows at the end of the
        stream; a failed read of the file raises. The GIL is released
        while the scanner runs."""
        mf = _c_i64()
        n = self._lib.svm_stream_next(self._h, y, nnz, idx, val, max_rows,
                                      cap_nnz, ctypes.byref(mf))
        if n == -2:
            raise ValueError(
                f"a row of {self.path!r} has more than cap_nnz={cap_nnz} "
                "nonzeros; raise cap_nnz")
        if n < 0:
            raise IOError(f"reading {self.path!r} failed (code {n})")
        return int(n), int(mf.value)

    def close(self) -> None:
        if self._h:
            self._lib.svm_stream_free(self._h)
            self._h = None

    def __enter__(self) -> "LibsvmStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stream_libsvm_chunks(path: str, chunk_rows: int = 65536,
                         cap_nnz: Optional[int] = None,
                         buf_bytes: int = 8 << 20, n_threads: int = 0,
                         byte_range: Optional[Tuple[int, int]] = None):
    """Yield ``(y, row_nnz, flat_idx, flat_val, max_feature)`` CSR chunks
    of a libsvm file with bounded memory (ref MLUtils.scala:77 over
    HadoopRDD.scala:87): y float64, row_nnz and flat_idx int32 (0-based),
    flat_val float32; ``max_feature`` is the running 1 + max feature index
    over everything parsed so far, final only after the last chunk.

    The native scanner when it is built, else :func:`_stream_libsvm_py`,
    the line-streaming twin with the same chunks. ``byte_range=(start,
    end)`` reads one split; the splits of a partition of the file
    concatenate to the single reader's rows. It needs the native scanner.
    Each chunk is arrays of its own (:func:`stream_libsvm_views` gives the
    same chunks in reused buffers).
    """
    for y, nnz, fidx, fval, mf in stream_libsvm_views(
            path, chunk_rows, cap_nnz, buf_bytes, n_threads, byte_range):
        yield y.copy(), nnz.copy(), fidx.copy(), fval.copy(), mf


def stream_libsvm_views(path: str, chunk_rows: int = 65536,
                        cap_nnz: Optional[int] = None,
                        buf_bytes: int = 8 << 20, n_threads: int = 0,
                        byte_range: Optional[Tuple[int, int]] = None):
    """The chunks of :func:`stream_libsvm_chunks`, which the native
    scanner writes into one set of buffers allocated once: each chunk's
    arrays are views that the next chunk overwrites, for a consumer that
    is done with a chunk before it asks for the next."""
    if cap_nnz is None:
        cap_nnz = chunk_rows * 64
    if _lib() is None:
        if byte_range is not None:
            raise NotImplementedError(
                "byte_range needs the native scanner (not built here)")
        yield from _stream_libsvm_py(path, chunk_rows, cap_nnz)
        return
    y = np.empty(chunk_rows, dtype=np.float64)
    nnz = np.empty(chunk_rows, dtype=np.int32)
    fidx = np.empty(cap_nnz, dtype=np.int32)
    fval = np.empty(cap_nnz, dtype=np.float32)
    with LibsvmStream(path, buf_bytes, n_threads, byte_range) as s:
        while True:
            n, mf = s.next_into(y.ctypes.data, nnz.ctypes.data,
                                fidx.ctypes.data, fval.ctypes.data,
                                chunk_rows, cap_nnz)
            if n == 0:
                break
            used = int(nnz[:n].sum())
            yield (y[:n], nnz[:n], fidx[:used], fval[:used], mf)


def _stream_libsvm_py(path: str, chunk_rows: int, cap_nnz: int):
    """Line-streaming twin of the native stream, with the same chunk
    contract (the reference's fallback, copied)."""
    count_read("python")
    y, nnz, fidx, fval = [], [], [], []
    used = 0
    max_feature = 0

    def flush():
        return (np.asarray(y, dtype=np.float64),
                np.asarray(nnz, dtype=np.int32),
                np.asarray(fidx, dtype=np.int32),
                np.asarray(fval, dtype=np.float32), max_feature)

    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            row_idx = [int(p.split(":")[0]) - 1 for p in parts[1:]]
            row_val = [float(p.split(":")[1]) for p in parts[1:]]
            if len(row_idx) > cap_nnz:
                raise ValueError(
                    f"a row of {path!r} has more than cap_nnz={cap_nnz} "
                    "nonzeros; raise cap_nnz")
            if len(y) >= chunk_rows or used + len(row_idx) > cap_nnz:
                yield flush()
                y, nnz, fidx, fval = [], [], [], []
                used = 0
            y.append(float(parts[0]))
            nnz.append(len(row_idx))
            fidx.extend(row_idx)
            fval.extend(row_val)
            used += len(row_idx)
            if row_idx:
                max_feature = max(max_feature, max(row_idx) + 1)
    if y:
        yield flush()


def parse_csv_native(path: str, delimiter: str = ",",
                     skip_header: bool = False,
                     n_threads: int = 0) -> Optional[np.ndarray]:
    """Dense float64 rows of a numeric CSV file via the C++ parser (a
    non-numeric cell reads NaN, short rows pad with 0); None when the
    library is not built. A file that cannot be read raises."""
    lib = _lib()
    if lib is None:
        return None
    nr, nc = _c_i64(), _c_i64()
    h = lib.csv_open(path.encode(), delimiter.encode()[0], int(skip_header),
                     n_threads, ctypes.byref(nr), ctypes.byref(nc))
    if not h:
        raise IOError(f"cannot read {path!r}")
    try:
        x = np.zeros((nr.value, max(nc.value, 1)), dtype=np.float64)
        if lib.csv_fill(h, x.ctypes.data_as(_c_vp), nr.value,
                        x.shape[1]) != 0:
            raise IOError(f"csv_fill failed on {path!r}")
        count_read("native")
        return x
    finally:
        lib.csv_free(h)
