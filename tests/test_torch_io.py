"""The port's readers (``dataset/io.py``, ``SparseInstanceDataset.
from_libsvm_stream``) against the JAX package's, on libsvm, .npy and CSV
files written by the tests from seeded numpy rows, on the float64 tier.

The reference spreads each streamed chunk over its test session's 8 CPU
devices, so its rows come back in a permutation of file order once a file
spans several chunks; the port keeps file order on its one device. With
one chunk the two are compared row for row; with several, the port's rows
are held to the whole-file parse row for row and the reference's to the
port's as sorted multisets of rows (labels included). Nothing is compared
with a tolerance: every reader is exact.

The ``gpu`` tests hold the pinned-ring ingest on the card to the CPU ingest
of the same file, bit for bit, and read each dataset right after ingest,
also with every copy landing late and the host barred from waiting for
the device.
The card's machine has no jax, so the reference is imported inside the
tests that use it: ``python -m pytest --noconftest -m gpu
tests/test_torch_io.py``.
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.dataset import io as tio
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.sparse import (SparseInstanceDataset,
                                                read_libsvm_sparse)
from cycloneml_tpu_torch.dataset.staging import StagingRing
from cycloneml_tpu_torch.native import host


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _ref():
    from cycloneml_tpu.dataset import io as rio
    from cycloneml_tpu.dataset import sparse as rsparse
    from cycloneml_tpu.dataset.dataset import InstanceDataset as RDataset
    return rio, rsparse, RDataset


def _write_svm(path, n=300, d=25, seed=0, max_k=9, dense=False):
    """libsvm rows from seeded numpy: ids ascending, values the float32's
    shortest text; returns the float32 values as a dense (n, d) array and
    the labels."""
    rng = np.random.RandomState(seed)
    x = np.zeros((n, d), dtype=np.float32)
    y = rng.randint(0, 2, n).astype(np.float64)
    with open(path, "w") as fh:
        for i in range(n):
            k = d if dense else rng.randint(0, max_k + 1)
            ids = np.sort(rng.choice(d, k, replace=False))
            vals = (rng.randn(k) * 3).astype(np.float32)
            x[i, ids] = vals
            fh.write(f"{y[i]:g} " + " ".join(
                f"{j + 1}:{np.format_float_positional(v, unique=True)}"
                for j, v in zip(ids, vals)) + "\n")
    return x, y


def _rows(x, y):
    """Rows with their labels, sorted by content (a multiset)."""
    full = np.column_stack([y, x])
    return full[np.lexsort(full.T[::-1])]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                        a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


# -- libsvm, dense ------------------------------------------------------------

@pytest.mark.parametrize("n_features", [None, 25, 40])
def test_parse_libsvm_matches_reference(tmp_path, n_features):
    rio, _, _ = _ref()
    p = str(tmp_path / "a.svm")
    _write_svm(p)
    for got, want in zip(tio.parse_libsvm(p, n_features),
                         rio.parse_libsvm(p, n_features)):
        _bits_equal(got, want)


def test_read_libsvm_whole_file_matches_reference(ctx, pctx, tmp_path):
    rio, _, _ = _ref()
    p = str(tmp_path / "a.svm")
    x, y = _write_svm(p)
    got = tio.read_libsvm(pctx, p, n_features=25, streamed=False)
    want = rio.read_libsvm(ctx, p, n_features=25, streamed=False)
    gx, gy, gw = got.to_numpy()
    wx, wy, ww = want.to_numpy()
    _bits_equal(gx, wx)
    _bits_equal(gy, wy)
    _bits_equal(gw, ww)
    np.testing.assert_array_equal(gx, x)
    np.testing.assert_array_equal(gy, y)
    assert got.x.dtype == torch.float64


def test_read_libsvm_streamed_one_chunk_row_for_row(ctx, pctx, tmp_path):
    """One chunk: the reference's shards hold consecutive slices of it,
    so its real rows are in file order too."""
    rio, _, _ = _ref()
    p = str(tmp_path / "a.svm")
    x, y = _write_svm(p, n=203)
    got = tio.read_libsvm(pctx, p, n_features=25, streamed=True)
    want = rio.read_libsvm(ctx, p, n_features=25, streamed=True)
    for g, w in zip(got.to_numpy(), want.to_numpy()):
        _bits_equal(g, w)
    np.testing.assert_array_equal(got.to_numpy()[0], x)
    assert got.n_rows == want.n_rows == 203
    assert got.x.shape == (208, 25)


def test_iter_libsvm_chunks_match_reference_chunk_by_chunk(tmp_path):
    rio, _, _ = _ref()
    p = str(tmp_path / "a.svm")
    _write_svm(p, n=250)
    got = list(tio.iter_libsvm_chunks(p, 25, chunk_rows=37))
    want = list(rio.iter_libsvm_chunks(p, 25, chunk_rows=37))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        _bits_equal(g[0], w[0])
        _bits_equal(g[1], w[1])
        assert g[2] is None and w[2] is None


def test_streamed_dense_several_chunks(ctx, pctx, tmp_path):
    """Several chunks: the port's rows in file order (equal to the whole
    file's parse), the reference's the same multiset, its valid mask and
    host labels naming exactly the real rows."""
    rio, _, rds = _ref()
    p = str(tmp_path / "a.svm")
    x, y = _write_svm(p, n=250)
    got = InstanceDataset.from_dense_chunks(
        pctx, tio.iter_libsvm_chunks(p, 25, chunk_rows=37), 25)
    want = rds.from_dense_chunks(
        ctx, rio.iter_libsvm_chunks(p, 25, chunk_rows=37), 25)
    gx, gy, gw = got.to_numpy()
    np.testing.assert_array_equal(gx, x)
    np.testing.assert_array_equal(gy, y)
    wx, wy, ww = want.to_numpy()
    _bits_equal(_rows(gx, gy), _rows(wx, wy))
    assert np.all(gw == 1) and np.all(ww == 1)
    np.testing.assert_array_equal(want.unpad(want.y_host()), wy)
    np.testing.assert_array_equal(got.valid_indices(), np.arange(250))
    np.testing.assert_array_equal(got.y_host()[:250], y)
    assert got.w_host()[250:].sum() == 0


def test_dense_reader_reuses_its_buffers(pctx, tmp_path):
    """The dense reader densifies every chunk into one reused block (the
    scanner's CSR buffers are reused too) and still gives the whole file;
    the public stream's blocks are each arrays of their own."""
    p = str(tmp_path / "a.svm")
    x, y = _write_svm(p, n=250)
    blocks = [c[0] for c in tio._libsvm_dense_chunks(p, 25, chunk_rows=37)]
    assert len(blocks) == 7
    assert all(np.shares_memory(blocks[0], b) for b in blocks[1:])
    own = [c[0] for c in tio.iter_libsvm_chunks(p, 25, chunk_rows=37)]
    assert not any(np.shares_memory(a, b) for a, b in zip(own, own[1:]))
    ds = InstanceDataset.from_dense_chunks(
        pctx, tio._libsvm_dense_chunks(p, 25, chunk_rows=37), 25)
    np.testing.assert_array_equal(ds.to_numpy()[0], x)
    np.testing.assert_array_equal(ds.to_numpy()[1], y)
    assert ds.ingest_stats["chunks"] == 7


def test_libsvm_duplicate_index_keeps_the_last_value(ctx, pctx, tmp_path):
    """numpy's assignment order decides a repeated index: the last value
    of the row stays, in every reader of both packages."""
    rio, _, _ = _ref()
    p = str(tmp_path / "dup.svm")
    with open(p, "w") as fh:
        fh.write("1 3:1.5 2:4 3:-2.25\n0 1:7 1:8 4:1\n")
    want = np.array([[0, 4, -2.25, 0], [8, 0, 0, 1]])
    for streamed in (True, False):
        got = tio.read_libsvm(pctx, p, n_features=4, streamed=streamed)
        ref = rio.read_libsvm(ctx, p, n_features=4, streamed=streamed)
        np.testing.assert_array_equal(got.to_numpy()[0], want)
        np.testing.assert_array_equal(ref.to_numpy()[0], want)


def test_streamed_read_needs_n_features(pctx, tmp_path):
    p = str(tmp_path / "a.svm")
    _write_svm(p, n=10)
    with pytest.raises(ValueError, match="n_features"):
        tio.read_libsvm(pctx, p, streamed=True)
    with pytest.raises(ValueError, match="declared n_features=5"):
        tio.read_libsvm(pctx, p, n_features=5, streamed=True)


def test_large_file_without_n_features_warns_and_parses_whole(
        pctx, tmp_path, monkeypatch, caplog):
    p = str(tmp_path / "a.svm")
    x, _ = _write_svm(p, n=40)
    monkeypatch.setattr(tio, "DENSE_STREAM_THRESHOLD", 100)
    ds = tio.read_libsvm(pctx, p)
    assert "exceeds the streaming threshold" in caplog.text
    np.testing.assert_array_equal(ds.to_numpy()[0], x)
    streamed = tio.read_libsvm(pctx, p, n_features=25)   # now streams
    assert streamed.ingest_stats["chunks"] == 1


def test_context_read_libsvm(pctx, tmp_path):
    p = str(tmp_path / "a.svm")
    x, y = _write_svm(p, n=30)
    ds = pctx.read_libsvm(p, n_features=25)
    np.testing.assert_array_equal(ds.to_numpy()[0], x)
    np.testing.assert_array_equal(ds.to_numpy()[1], y)


def test_reads_are_served_by_the_native_scanner(pctx, tmp_path):
    p = str(tmp_path / "a.svm")
    _write_svm(p, n=30)
    host.reset_read_counts()
    tio.read_libsvm(pctx, p, n_features=25, streamed=True)
    tio.read_libsvm(pctx, p, n_features=25, streamed=False)
    read_libsvm_sparse(pctx, p, n_readers=3)
    assert host.READS == {"native": 5}


# -- .npy ---------------------------------------------------------------------

def _write_npy(path, n=230, d=6, seed=3, dtype=np.float32):
    rng = np.random.RandomState(seed)
    arr = rng.randn(n, d).astype(dtype)
    np.save(path, arr)
    return arr


def test_npy_header_and_chunks_match_reference(tmp_path):
    rio, _, _ = _ref()
    p = str(tmp_path / "a.npy")
    _write_npy(p)
    assert tio.npy_header(p) == rio.npy_header(p)
    for label_col in (None, 2, 5):
        got = list(tio.iter_npy_chunks(p, label_col, chunk_rows=50))
        want = list(rio.iter_npy_chunks(p, label_col, chunk_rows=50))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _bits_equal(g[0], w[0])
            if label_col is None:
                assert g[1] is None and w[1] is None
            else:
                _bits_equal(g[1], w[1])


def test_npy_rejects_fortran_and_truncated_files(tmp_path):
    p = str(tmp_path / "f.npy")
    np.save(p, np.asfortranarray(np.ones((4, 3))))
    with pytest.raises(ValueError, match="C-order"):
        tio.npy_header(p)
    q = tmp_path / "t.npy"
    np.save(q, np.ones((10, 3)))
    q.write_bytes(q.read_bytes()[:-8])
    with pytest.raises(IOError, match="truncated"):
        list(tio.iter_npy_chunks(str(q)))


@pytest.mark.parametrize("chunk_rows", [100_000, 50])
def test_read_npy_chunked_matches_reference(ctx, pctx, tmp_path, chunk_rows):
    rio, _, _ = _ref()
    p = str(tmp_path / "a.npy")
    arr = _write_npy(p)
    got = tio.read_npy_chunked(pctx, p, label_col=5, chunk_rows=chunk_rows)
    want = rio.read_npy_chunked(ctx, p, label_col=5, chunk_rows=chunk_rows)
    gx, gy, _ = got.to_numpy()
    wx, wy, _ = want.to_numpy()
    np.testing.assert_array_equal(gx, arr[:, :5].astype(np.float64))
    np.testing.assert_array_equal(gy, arr[:, 5].astype(np.float64))
    if chunk_rows > len(arr):
        _bits_equal(gx, wx)
        _bits_equal(gy, wy)
    else:
        _bits_equal(_rows(gx, gy), _rows(wx, wy))


def test_npy_ingest_is_from_numpy_of_the_same_rows_in_bf16(tmp_path):
    """On the bfloat16 tier the streamed ingest rounds as from_numpy does:
    the same bits."""
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    try:
        p = str(tmp_path / "a.npy")
        arr = _write_npy(p, n=301, d=9)
        got = tio.read_npy_chunked(c, p, label_col=8, chunk_rows=64)
        want = InstanceDataset.from_numpy(c, arr[:, :8], arr[:, 8])
        assert got.x.dtype == torch.bfloat16
        assert torch.equal(got.x, want.x) and torch.equal(got.y, want.y)
        assert torch.equal(got.w, want.w)
    finally:
        c.stop()


# -- CSV ----------------------------------------------------------------------

def _write_csv(path, n=220, d=5, seed=4, header=False):
    rng = np.random.RandomState(seed)
    data = np.round(rng.randn(n, d), 6)
    with open(path, "w") as fh:
        if header:
            fh.write(",".join(f"c{j}" for j in range(d)) + "\n")
        for i, row in enumerate(data):
            fh.write(",".join(repr(float(v)) for v in row) + "\n")
            if i % 60 == 0:
                fh.write("\n")
    return data


@pytest.mark.parametrize("header", [False, True])
def test_csv_readers_match_reference(ctx, pctx, tmp_path, header):
    rio, _, rds = _ref()
    p = str(tmp_path / "a.csv")
    data = _write_csv(p, header=header)
    kw = dict(label_col=1, skip_header=header)
    got = list(tio.iter_csv_chunks(p, chunk_rows=40, **kw))
    want = list(rio.iter_csv_chunks(p, chunk_rows=40, **kw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _bits_equal(g[0], w[0])
        _bits_equal(g[1], w[1])
    whole = tio.read_csv(pctx, p, **kw)
    ref_whole = rio.read_csv(ctx, p, **kw)
    for g, w in zip(whole.to_numpy(), ref_whole.to_numpy()):
        _bits_equal(g, w)
    one = tio.read_csv_chunked(pctx, p, **kw)
    ref_one = rio.read_csv_chunked(ctx, p, **kw)
    for g, w in zip(one.to_numpy(), ref_one.to_numpy()):
        _bits_equal(g, w)
    several = tio.read_csv_chunked(pctx, p, chunk_rows=40, **kw)
    for g, w in zip(several.to_numpy(), whole.to_numpy()):
        _bits_equal(g, w)
    np.testing.assert_array_equal(whole.to_numpy()[1], data[:, 1])


def test_ragged_and_empty_csv_raise(pctx, tmp_path):
    p = tmp_path / "r.csv"
    p.write_text("1,2,3\n4,5\n")
    with pytest.raises(ValueError):
        tio.read_csv_chunked(pctx, str(p))
    q = tmp_path / "e.csv"
    q.write_text("\n\n")
    with pytest.raises(ValueError, match="no data rows"):
        tio.read_csv_chunked(pctx, str(q))


# -- from_dense_chunks --------------------------------------------------------

def test_from_dense_chunks_checks_its_chunks(pctx):
    bad = [(np.ones((3, 4)), None, None)]
    with pytest.raises(ValueError, match="expected \\(rows, 5\\)"):
        InstanceDataset.from_dense_chunks(pctx, bad, 5)
    short = [(np.ones((3, 4)), np.ones(2), None)]
    with pytest.raises(ValueError, match="y/w lengths"):
        InstanceDataset.from_dense_chunks(pctx, short, 4)
    with pytest.raises(ValueError, match="quantized"):
        InstanceDataset.from_dense_chunks(pctx, [], 4,
                                          dtype=torch.float8_e4m3fn)


def test_from_dense_chunks_pads_with_zero_weight_rows(pctx):
    rng = np.random.RandomState(5)
    chunks = [(rng.randn(m, 3), rng.rand(m), rng.rand(m) + 1)
              for m in (5, 0, 9)]
    ds = InstanceDataset.from_dense_chunks(pctx, iter(chunks), 3)
    assert ds.n_rows == 14 and ds.x.shape == (16, 3)
    np.testing.assert_array_equal(ds.to_numpy()[0],
                                  np.concatenate([c[0] for c in chunks]))
    np.testing.assert_array_equal(ds.w_host()[:14],
                                  np.concatenate([c[2] for c in chunks]))
    assert not ds.x[14:].any() and not ds.w[14:].any()
    assert ds._valid_mask.tolist() == [True] * 14 + [False] * 2


# -- libsvm, sparse -----------------------------------------------------------

def _sparse_rows(ds):
    """(labels float32, indices, values) of the real rows, as numpy."""
    host = [a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
            for a in (ds.w, ds.y, ds.indices, ds.values)]
    m = host[0] > 0
    return tuple(a[m] for a in host[1:])


def test_read_libsvm_sparse_one_chunk_row_for_row(ctx, pctx, tmp_path):
    _, rsparse, _ = _ref()
    p = str(tmp_path / "a.svm")
    x, y = _write_svm(p, n=300, d=40)
    got, gy = read_libsvm_sparse(pctx, p, n_features=40)
    want, wy = rsparse.read_libsvm_sparse(ctx, p, n_features=40)
    _bits_equal(gy, wy)
    np.testing.assert_array_equal(gy, y)
    for g, w in zip(_sparse_rows(got), _sparse_rows(want)):
        _bits_equal(g, w)
    np.testing.assert_array_equal(got.to_dense(), x)
    assert got.n_features == want.n_features == 40
    assert got.k_max == want.k_max == 9


def test_read_libsvm_sparse_several_chunks(ctx, pctx, tmp_path):
    """The port in file order (the labels and the dense rows equal the
    file's); the reference's rows the same multiset, its collected labels
    its rows' labels."""
    _, rsparse, _ = _ref()
    p = str(tmp_path / "a.svm")
    x, y = _write_svm(p, n=500, d=40)
    got, gy = read_libsvm_sparse(pctx, p, chunk_rows=33)
    want, wy = rsparse.read_libsvm_sparse(ctx, p, chunk_rows=33)
    np.testing.assert_array_equal(gy, y)
    np.testing.assert_array_equal(got.to_dense(), x)
    gl, gi, gv = _sparse_rows(got)
    wl, wi, wv = _sparse_rows(want)
    _bits_equal(_rows(np.column_stack([gi, gv]), gl),
                _rows(np.column_stack([wi, wv]), wl))
    np.testing.assert_array_equal(np.sort(wy), np.sort(gy))
    np.testing.assert_array_equal(wl, wy.astype(np.float32))
    assert got.ingest_stats["chunks"] == 16


@pytest.mark.parametrize("chunk_rows", [7, 65536])
def test_one_and_four_readers_give_the_same_dataset(pctx, tmp_path,
                                                    chunk_rows):
    p = str(tmp_path / "a.svm")
    _write_svm(p, n=400, d=30)
    one, y1 = read_libsvm_sparse(pctx, p, chunk_rows=chunk_rows)
    four, y4 = read_libsvm_sparse(pctx, p, chunk_rows=chunk_rows,
                                  n_readers=4)
    _bits_equal(y1, y4)
    for a in ("indices", "values", "y", "w"):
        assert torch.equal(getattr(one, a), getattr(four, a))
    assert one.n_rows == four.n_rows == 400
    assert one.n_features == four.n_features


def test_hash_dim_and_k_max_match_reference(ctx, pctx, tmp_path):
    _, rsparse, rds = _ref()
    p = str(tmp_path / "a.svm")
    _write_svm(p, n=120, d=40)
    kw = dict(hash_dim=13, k_max=12)
    got = SparseInstanceDataset.from_libsvm_stream(pctx, p, **kw)
    want = rsparse.SparseInstanceDataset.from_libsvm_stream(ctx, p, **kw)
    for g, w in zip(_sparse_rows(got), _sparse_rows(want)):
        _bits_equal(g, w)
    assert got.n_features == want.n_features == 13
    assert got.k_max == 12


def test_too_narrow_limits_raise_as_in_the_reference(ctx, pctx, tmp_path):
    _, rsparse, _ = _ref()
    p = str(tmp_path / "a.svm")
    _write_svm(p, n=120, d=40)
    for pkg_ctx, cls in ((pctx, SparseInstanceDataset),
                         (ctx, rsparse.SparseInstanceDataset)):
        with pytest.raises(ValueError, match="k_max=3"):
            cls.from_libsvm_stream(pkg_ctx, p, k_max=3)
        with pytest.raises(ValueError, match="n_features=20"):
            cls.from_libsvm_stream(pkg_ctx, p, n_features=20)


def test_zero_based_index_raises_in_the_port(ctx, pctx, tmp_path):
    """A ``0:`` index: the reference stores column -1, the port rejects
    the file at ingest (ROADMAP Queue 3, decided), also under hashing,
    which would otherwise fold -1 into a real column."""
    _, rsparse, _ = _ref()
    p = str(tmp_path / "zero.svm")
    with open(p, "w") as fh:
        fh.write("1 1:1.0 2:3\n0 0:2.0 3:1\n")
    want = rsparse.SparseInstanceDataset.from_libsvm_stream(ctx, p)
    assert int(np.asarray(want.indices).min()) == -1
    for kw in ({}, {"hash_dim": 8}, {"n_readers": 2}):
        with pytest.raises(ValueError, match="1-based"):
            SparseInstanceDataset.from_libsvm_stream(pctx, p, **kw)


def test_labels_keep_float64(pctx, tmp_path):
    p = str(tmp_path / "r.svm")
    with open(p, "w") as fh:
        fh.write("0.1234567890123 1:1\n-3.25 2:2\n")
    ds, y = read_libsvm_sparse(pctx, p)
    assert y.dtype == np.float64 and y[0] == 0.1234567890123
    assert ds.y.dtype == torch.float32
    assert ds.y[0].item() == np.float32(0.1234567890123)


# -- a fit from a file --------------------------------------------------------

def test_logistic_fit_from_a_libsvm_file_matches_reference(ctx, pctx,
                                                           tmp_path):
    from cycloneml_tpu.ml.classification import LogisticRegression as RLR
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    rio, _, _ = _ref()
    p = str(tmp_path / "fit.svm")
    _write_svm(p, n=400, d=12, seed=7, dense=True)
    kw = dict(maxIter=30, regParam=0.01, tol=1e-9)
    got = LogisticRegression(**kw).fit(
        tio.read_libsvm(pctx, p, n_features=12, streamed=True))
    ref = RLR(**kw).fit(rio.read_libsvm(ctx, p, n_features=12,
                                        streamed=False))
    assert got.summary.total_iterations == ref.summary.total_iterations
    assert got.summary.total_evals == ref.summary.total_evals
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients), rtol=1e-8)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=1e-8)


# -- the card -----------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cpu_twin(fn):
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    try:
        return fn(c)
    finally:
        c.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("n_readers", [1, 4])
def test_cuda_sparse_ingest_equals_the_cpu_ingest(tmp_path, n_readers):
    """The pinned ring, the copy stream and the device ELL give the CPU's
    dataset bit for bit; read right after ingest, it is whole."""
    _need_cuda()
    p = str(tmp_path / "a.svm")
    _write_svm(p, n=60_003, d=5000, max_k=40, seed=11)
    want = _cpu_twin(lambda c: read_libsvm_sparse(c, p, chunk_rows=1024))
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        ds, y = read_libsvm_sparse(ctx, p, chunk_rows=1024,
                                   n_readers=n_readers)
        # read at once on the default stream: no synchronize in between
        got = (ds.indices.sum(), ds.values.sum(), ds.y.sum())
        assert torch.equal(ds.indices.cpu(), want[0].indices)
        assert torch.equal(ds.values.cpu(), want[0].values)
        assert torch.equal(ds.y.cpu(), want[0].y)
        assert torch.equal(ds.w.cpu(), want[0].w)
        _bits_equal(y, want[1])
        assert got[0].item() == want[0].indices.sum().item()
        assert got[2].item() == want[0].y.sum().item()
        stats = ds.ingest_stats
        assert stats["chunks"] >= 49 and stats["bytes"] > 0
    finally:
        ctx.stop()


@pytest.mark.gpu
def test_cuda_dense_ingest_equals_the_cpu_ingest(tmp_path):
    _need_cuda()
    p = str(tmp_path / "a.npy")
    _write_npy(p, n=100_001, d=301)
    want = _cpu_twin(lambda c: tio.read_npy_chunked(c, p, label_col=300,
                                                    chunk_rows=4096))
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        ds = tio.read_npy_chunked(ctx, p, label_col=300, chunk_rows=4096)
        total = ds.x.float().sum()   # right after ingest, same stream
        assert torch.equal(ds.x.cpu(), want.x)
        assert torch.equal(ds.y.cpu(), want.y)
        assert torch.equal(ds.w.cpu(), want.w)
        # the same reduction on the card over the CPU's copy: the same bits
        assert total.item() == want.x.to(ds.x.device).float().sum().item()
    finally:
        ctx.stop()


_SPIN = 100_000_000   # clock cycles of torch.cuda._sleep ahead of each copy


def _late_copies_and_no_host_wait(m):
    """Every copy of a staging ring lands late: a spin is queued ahead of
    it on the copy stream, and its destination is poisoned on the caller's
    stream meanwhile. The host may not wait for the device
    (``torch.cuda.synchronize`` and ``Stream.synchronize`` raise), so only
    the caller's stream waiting on the copy stream orders a read after the
    copies. The spin and the poison's kernels are launched once first: a
    kernel's first launch may load its module, and wait for the device."""
    torch.cuda._sleep(1)
    for dt in (torch.bfloat16, torch.float32, torch.int32):
        torch.empty(1, dtype=dt, device="cuda").fill_(-7)
    torch.cuda.synchronize()
    put = StagingRing.put

    def late_put(self, slot, views):
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(_SPIN)
        out = put(self, slot, views)
        for t in out:
            t.fill_(-7)
        return out

    def no_wait(*args, **kwargs):
        raise AssertionError("the host waited for the device in an ingest")
    m.setattr(StagingRing, "put", late_put)
    m.setattr(torch.cuda, "synchronize", no_wait)
    m.setattr(torch.cuda.Stream, "synchronize", no_wait)


@pytest.mark.gpu
@pytest.mark.parametrize("reader", ["sparse-1", "sparse-4", "dense"])
def test_cuda_reads_after_ingest_wait_for_late_copies(tmp_path, monkeypatch,
                                                      reader):
    """The ingest is over once the caller's stream has waited on the copy
    stream: a read queued right after it sees every copy, however late the
    copies land, with no host wait in between."""
    _need_cuda()
    if reader == "dense":
        p = str(tmp_path / "a.npy")
        _write_npy(p, n=30_001, d=301)

        def read(c):
            return tio.read_npy_chunked(c, p, label_col=300,
                                        chunk_rows=4096)
        names = ("x", "y", "w")
    else:
        p = str(tmp_path / "a.svm")
        _write_svm(p, n=20_001, d=5000, max_k=40, seed=12)
        n_readers = int(reader.split("-")[1])

        def read(c):
            return read_libsvm_sparse(c, p, chunk_rows=4096,
                                      n_readers=n_readers)[0]
        names = ("indices", "values", "y", "w")
    want = _cpu_twin(read)
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        read(ctx)   # every kernel of the ingest launched once (see above)
        with monkeypatch.context() as m:
            _late_copies_and_no_host_wait(m)
            ds = read(ctx)
            got = [getattr(ds, a).clone() for a in names]   # same stream
        for g, a in zip(got, names):
            assert torch.equal(g.cpu(), getattr(want, a)), a
        assert ds.ingest_stats["copy_s"] >= 0.0
    finally:
        ctx.stop()
