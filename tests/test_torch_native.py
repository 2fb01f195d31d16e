"""The port's native scanner (``cycloneml_tpu_torch/native``) against the
reference's (``cycloneml_tpu/native``), on libsvm and CSV files written by
the tests from seeded numpy rows.

The streamed chunks must be equal bit for bit, chunk by chunk: labels, row
nnz, ids, values and the running max feature. The files cover comments
(whole-line and trailing), blank lines, CRLF line ends, a read window of
only comments, integer values (the scanner's fast path), exponents and
negative values; chunks of 1, 50 and 65,536 rows; byte-range splits.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cycloneml_tpu.native import host as ref_host
from cycloneml_tpu_torch import native
from cycloneml_tpu_torch.native import host

ROOT = Path(__file__).resolve().parent.parent


def _value_text(rng, v):
    """A value in one of the spellings libsvm files use."""
    form = rng.randint(5)
    if form == 0:
        return str(int(round(v * 10)))           # a plain integer
    if form == 1:
        return f"{v:.6g}"
    if form == 2:
        return f"{v:e}"                           # an exponent
    if form == 3:
        return repr(float(np.float32(v)))
    return f"{v:+.3f}"                            # a leading sign


def _write_mixed(path, n=300, d=40, seed=0):
    """Rows with every spelling above, comments, blank lines, CRLF ends,
    tabs, rows with no features and labels of every sign."""
    rng = np.random.RandomState(seed)
    with open(path, "w", newline="") as fh:
        fh.write("# a header comment\n\n")
        for i in range(n):
            k = rng.randint(0, 9)
            ids = np.sort(rng.choice(d, k, replace=False)) + 1
            vals = rng.randn(k) * 10 ** rng.randint(-3, 4)
            label = ["1", "0", "-1", f"{rng.randn():.5f}"][rng.randint(4)]
            toks = [f"{j}:{_value_text(rng, v)}" for j, v in zip(ids, vals)]
            sep = "\t" if rng.rand() < 0.1 else " "
            line = sep.join([label] + toks)
            if rng.rand() < 0.1:
                line += "  # trailing comment 3:4"
            end = "\r\n" if rng.rand() < 0.2 else "\n"
            fh.write(line + end)
            if rng.rand() < 0.05:
                fh.write("\n" if rng.rand() < 0.5 else "# between rows\n")


def _write_integers(path, n=400, d=30, seed=1):
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for _ in range(n):
            ids = np.sort(rng.choice(d, 6, replace=False)) + 1
            vals = rng.randint(-500, 500, size=6)
            fh.write(f"{rng.randint(2)} " + " ".join(
                f"{j}:{v}" for j, v in zip(ids, vals)) + "\n")


def _write_comment_window(path):
    """More than a read window of comment lines between two runs of rows
    (the reference's test_stream_survives_all_comment_window)."""
    with open(path, "w") as fh:
        for i in range(10):
            fh.write(f"1 {i + 1}:1.0\n")
        for _ in range(200):
            fh.write("# padding comment line, no data here\n")
        for i in range(10):
            fh.write(f"0 {i + 1}:2.5e-1\n")


WRITERS = {"mixed": _write_mixed, "integers": _write_integers,
           "comment_window": _write_comment_window}


@pytest.fixture(params=sorted(WRITERS))
def svm_file(request, tmp_path):
    path = tmp_path / f"{request.param}.svm"
    WRITERS[request.param](path)
    return str(path)


def _assert_same_chunks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 5
        for a, b in zip(g[:4], w[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            assert a.tobytes() == b.tobytes()
        assert g[4] == w[4]


def test_native_scanner_builds_here():
    assert host.native_available()
    assert native.failure() is None
    assert ref_host.native_available()


@pytest.mark.parametrize("chunk_rows", [1, 50, 65536])
@pytest.mark.parametrize("buf_bytes", [512, 8 << 20])
def test_stream_matches_reference_chunk_by_chunk(svm_file, chunk_rows,
                                                 buf_bytes):
    got = list(host.stream_libsvm_chunks(svm_file, chunk_rows=chunk_rows,
                                         buf_bytes=buf_bytes))
    want = list(ref_host.stream_libsvm_chunks(svm_file,
                                              chunk_rows=chunk_rows,
                                              buf_bytes=buf_bytes))
    _assert_same_chunks(got, want)


def test_stream_chunk_caps_match_reference(tmp_path):
    """A chunk also ends where the nonzeros would pass ``cap_nnz``."""
    path = str(tmp_path / "m.svm")
    _write_mixed(path, n=500, seed=4)
    kw = dict(chunk_rows=64, cap_nnz=40)
    _assert_same_chunks(list(host.stream_libsvm_chunks(path, **kw)),
                        list(ref_host.stream_libsvm_chunks(path, **kw)))


@pytest.mark.parametrize("n_splits", [2, 3, 7])
def test_byte_range_splits_concatenate_to_the_single_reader(svm_file,
                                                            n_splits):
    size = os.path.getsize(svm_file)
    bounds = [(i * size // n_splits, (i + 1) * size // n_splits)
              for i in range(n_splits)]
    whole = list(host.stream_libsvm_chunks(svm_file, chunk_rows=65536))
    parts = []
    for b in bounds:
        got = list(host.stream_libsvm_chunks(svm_file, chunk_rows=65536,
                                             buf_bytes=256, byte_range=b))
        want = list(ref_host.stream_libsvm_chunks(
            svm_file, chunk_rows=65536, buf_bytes=256, byte_range=b))
        _assert_same_chunks(got, want)
        parts.extend(got)
    for j in range(4):
        joined = np.concatenate([p[j] for p in parts])
        np.testing.assert_array_equal(joined, whole[0][j])
    assert max(p[4] for p in parts) == whole[0][4]


def test_row_over_cap_nnz_raises(tmp_path):
    path = str(tmp_path / "wide.svm")
    with open(path, "w") as fh:
        fh.write("1 1:1 2:1\n0 " + " ".join(f"{j}:1" for j in
                                             range(1, 30)) + "\n")
    with pytest.raises(ValueError, match="cap_nnz=10"):
        list(host.stream_libsvm_chunks(path, chunk_rows=4, cap_nnz=10))
    with pytest.raises(ValueError, match="cap_nnz=10"):
        list(host._stream_libsvm_py(path, 4, 10))
    with pytest.raises(ValueError, match="cap_nnz"):
        list(ref_host.stream_libsvm_chunks(path, chunk_rows=4, cap_nnz=10))


@pytest.mark.parametrize("chunk_rows", [1, 50, 65536])
def test_python_twin_matches_the_reference_twin(svm_file, chunk_rows):
    got = list(host._stream_libsvm_py(svm_file, chunk_rows, chunk_rows * 64))
    want = list(ref_host._stream_libsvm_py(svm_file, chunk_rows,
                                           chunk_rows * 64))
    _assert_same_chunks(got, want)


def test_python_twin_agrees_with_the_scanner_on_float32_values(tmp_path):
    """Where the text is a float32's shortest spelling, both sides parse
    the same float32 (the twins differ only in how they round)."""
    path = str(tmp_path / "f32.svm")
    rng = np.random.RandomState(9)
    vals = rng.randn(200, 5).astype(np.float32)
    with open(path, "w") as fh:
        for i in range(200):
            fh.write(f"{i % 2} " + " ".join(
                f"{j + 1}:{np.format_float_positional(v, unique=True)}"
                for j, v in enumerate(vals[i])) + "\n")
    _assert_same_chunks(list(host._stream_libsvm_py(path, 64, 64 * 64)),
                        list(host.stream_libsvm_chunks(path, chunk_rows=64)))


@pytest.mark.parametrize("n_features", [None, 45, 60])
def test_parse_libsvm_native_matches_reference(svm_file, n_features):
    got = host.parse_libsvm_native(svm_file, n_features)
    want = ref_host.parse_libsvm_native(svm_file, n_features)
    assert got is not None and want is not None
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_parse_libsvm_native_raises_on_a_missing_file(tmp_path):
    with pytest.raises(IOError):
        host.parse_libsvm_native(str(tmp_path / "none.svm"))


@pytest.mark.parametrize("read", [
    lambda p: list(host.stream_libsvm_chunks(p)),
    lambda p: list(host.stream_libsvm_chunks(p, byte_range=(0, 10))),
    lambda p: host.parse_libsvm_native(p),
    lambda p: host.parse_csv_native(p),
], ids=["stream", "byte_range", "parse_libsvm", "parse_csv"])
def test_a_failed_read_raises(tmp_path, read):
    """A directory opens but fails every read: the scanner reports the
    failure and the reader raises, where a short read taken for the end of
    the file would give an empty or truncated dataset."""
    with pytest.raises(IOError):
        read(str(tmp_path))


def _address(a):
    return a.__array_interface__["data"][0]


def test_views_are_the_chunks_in_one_reused_set_of_buffers(svm_file):
    chunks = list(host.stream_libsvm_chunks(svm_file, chunk_rows=4))
    views = []
    for got, want in zip(host.stream_libsvm_views(svm_file, chunk_rows=4),
                         chunks):
        _assert_same_chunks([tuple(a.copy() for a in got[:4]) + got[4:]],
                            [want])
        views.append(got)
    assert len(views) == len(chunks) > 2
    for j in range(4):
        assert len({_address(v[j]) for v in views}) == 1
        assert len({_address(c[j]) for c in chunks}) == len(chunks)


def _write_csv(path, n=300, d=7, seed=2, header=False, delimiter=","):
    rng = np.random.RandomState(seed)
    data = rng.randn(n, d) * 10.0 ** rng.randint(-3, 4, size=d)
    with open(path, "w") as fh:
        if header:
            fh.write(delimiter.join(f"c{j}" for j in range(d)) + "\n")
        for i, row in enumerate(data):
            cells = [repr(v) for v in row]
            if i == 5:
                cells[2] = "n/a"                 # a non-numeric cell
            if i == 9:
                cells = cells[:-2]               # a short row
            fh.write(delimiter.join(cells) + ("\r\n" if i % 7 == 0
                                              else "\n"))
            if i % 50 == 0:
                fh.write("\n")


@pytest.mark.parametrize("header,delimiter", [(False, ","), (True, ","),
                                              (False, ";")])
def test_parse_csv_native_matches_reference(tmp_path, header, delimiter):
    path = str(tmp_path / "a.csv")
    _write_csv(path, header=header, delimiter=delimiter)
    got = host.parse_csv_native(path, delimiter, header)
    want = ref_host.parse_csv_native(path, delimiter, header)
    assert got.shape == want.shape == (300, 7)
    assert got.tobytes() == want.tobytes()
    assert np.isnan(got[5, 2]) and got[9, -1] == 0.0


def test_reads_are_counted_by_the_side_that_served_them(svm_file):
    host.reset_read_counts()
    list(host.stream_libsvm_chunks(svm_file))
    host.parse_libsvm_native(svm_file)
    list(host._stream_libsvm_py(svm_file, 50, 50 * 64))
    assert host.READS == {"native": 2, "python": 1}


def test_reads_counted_from_many_threads_at_once_are_all_counted():
    """The readers of one ingest count from their own threads: no count is
    lost, from the first (the key's insertion) on."""
    import threading
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        host.reset_read_counts()
        start = threading.Barrier(8)

        def count():
            start.wait()
            for _ in range(2000):
                host.count_read("native")
        threads = [threading.Thread(target=count) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert host.READS == {"native": 16000}


_BUILD = (
    "import sys\n"
    "from pathlib import Path\n"
    "from cycloneml_tpu_torch import native\n"
    "native.BUILD_DIR = Path(sys.argv[1])\n"
    "print(native.build())\n")


def test_two_processes_building_at_once_leave_one_good_library(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    libs = sorted(f.name for f in tmp_path.iterdir() if f.suffix == ".so")
    assert libs == [Path(paths.pop()).name]
    assert not [f for f in tmp_path.iterdir() if f.name.startswith(".")]
    import ctypes
    lib = ctypes.CDLL(str(tmp_path / libs[0]))
    assert lib.svm_stream_open and lib.csv_open


_NO_GXX = (
    "import sys, warnings\n"
    "from pathlib import Path\n"
    "from cycloneml_tpu_torch import native\n"
    "native.BUILD_DIR = Path(sys.argv[1])\n"
    "from cycloneml_tpu_torch.native import host\n"
    "with warnings.catch_warnings(record=True) as w:\n"
    "    warnings.simplefilter('always')\n"
    "    assert not host.native_available()\n"
    "    assert not host.native_available()\n"
    "assert len(w) == 1 and 'cannot build' in str(w[0].message), w\n"
    "chunks = list(host.stream_libsvm_chunks(sys.argv[2]))\n"
    "assert host.READS['python'] == 1 and host.READS['native'] == 0\n"
    "assert len(chunks[0][0]) == 20\n"
    "try:\n"
    "    list(host.stream_libsvm_chunks(sys.argv[2], byte_range=(0, 9)))\n"
    "except NotImplementedError:\n"
    "    pass\n"
    "else:\n"
    "    raise SystemExit('byte_range did not raise')\n"
    "from cycloneml_tpu_torch import CycloneConf, CycloneContext\n"
    "from cycloneml_tpu_torch.dataset.sparse import read_libsvm_sparse\n"
    "ctx = CycloneContext(CycloneConf().set('cyclone.master', 'cpu'))\n"
    "ds, y = read_libsvm_sparse(ctx, sys.argv[2])\n"
    "assert ds.n_rows == 20\n"
    "try:\n"
    "    read_libsvm_sparse(ctx, sys.argv[2], n_readers=2)\n"
    "except NotImplementedError:\n"
    "    pass\n"
    "else:\n"
    "    raise SystemExit('n_readers=2 did not raise')\n")


def test_without_a_compiler_it_warns_once_and_serves_the_python_twins(
        tmp_path):
    """No g++ on the PATH: one warning naming why, the pure-Python twins
    serve the reads, and byte ranges and several readers raise."""
    svm = tmp_path / "c.svm"
    _write_comment_window(svm)
    empty = tmp_path / "bin"
    empty.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT), PATH=str(empty))
    r = subprocess.run([sys.executable, "-c", _NO_GXX,
                        str(tmp_path / "build"), str(svm)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr + r.stdout
