"""The port's local linear algebra, BLAS dispatch boundary and 2-D
distributed matrices against the JAX package's, on the same numpy inputs.

Every case of the reference's tests/test_linalg.py and the BlockMatrix,
CoordinateMatrix and IndexedRowMatrix cases of
tests/test_distributed_matrices.py run through both packages: results are
equal, or within 1e-12 where a product is formed (float64 on both sides:
the port's context is ``cyclone.master=cpu``, ``cyclone.compute.dtype=
float64``). The boundary's routing: products below
``DEVICE_FLOPS_THRESHOLD`` stay on the host, larger ones run on the mesh's
device, each counted; on a CUDA master with no card a device product
raises (the reference falls back to numpy in silence).

The ``gpu`` test runs a product above the threshold on the card; the
card's machine has no jax, so the reference is imported inside the tests
that use it:

    python -m pytest --noconftest -m gpu tests/test_torch_linalg.py
"""

import types

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext, mesh
from cycloneml_tpu_torch.linalg import (
    BLAS, DenseMatrix, DenseVector, Matrices, SparseMatrix, SparseVector,
    Vectors, blas,
)
from cycloneml_tpu_torch.linalg.block import (BlockMatrix, CoordinateMatrix,
                                              IndexedRowMatrix)

PORT = types.SimpleNamespace(
    BLAS=BLAS, DenseMatrix=DenseMatrix, DenseVector=DenseVector,
    Matrices=Matrices, SparseMatrix=SparseMatrix, SparseVector=SparseVector,
    Vectors=Vectors, BlockMatrix=BlockMatrix,
    CoordinateMatrix=CoordinateMatrix, IndexedRowMatrix=IndexedRowMatrix)


def _reference():
    import cycloneml_tpu.linalg as r
    from cycloneml_tpu.linalg import block as rb
    return types.SimpleNamespace(
        BLAS=r.BLAS, DenseMatrix=r.DenseMatrix, DenseVector=r.DenseVector,
        Matrices=r.Matrices, SparseMatrix=r.SparseMatrix,
        SparseVector=r.SparseVector, Vectors=r.Vectors,
        BlockMatrix=rb.BlockMatrix, CoordinateMatrix=rb.CoordinateMatrix,
        IndexedRowMatrix=rb.IndexedRowMatrix)


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _same(got, ref, rtol=0.0):
    """Equal results (a tuple/list elementwise), or within ``rtol`` where a
    product is formed."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r, rtol)
        return
    if isinstance(got, (bool, str, type(None))):
        assert got == ref
        return
    g, r = np.asarray(got), np.asarray(ref)
    assert g.shape == r.shape
    if rtol:
        np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol)
    else:
        np.testing.assert_array_equal(g, r)


def _both(case, rtol=0.0):
    """``case(pkg)`` through the port and the reference: the same
    results. Returns the port's."""
    got = case(PORT)
    _same(got, case(_reference()), rtol)
    return got


# -- vectors -----------------------------------------------------------------

def test_dense_sparse_roundtrip():
    def case(p):
        dv = p.Vectors.dense(0.0, 1.5, 0.0, 3.0)
        sv = dv.to_sparse()
        assert sv.to_dense() == dv
        assert dv == sv  # cross-type equality like the reference
        return sv.indices, sv.values, sv.to_dense().to_array()

    idx, vals, _ = _both(case)
    assert idx.tolist() == [1, 3] and vals.tolist() == [1.5, 3.0]


def test_sparse_factory_pairs():
    def case(p):
        sv = p.Vectors.sparse(5, [(3, 3.0), (1, 1.0)])
        return sv.indices, sv[3], sv[0], sv.size, sv.num_actives()

    got = _both(case)
    assert got[0].tolist() == [1, 3] and got[1] == 3.0 and got[2] == 0.0


def test_norm_and_sqdist():
    def case(p):
        v = p.Vectors.dense(3.0, -4.0)
        u = p.Vectors.sparse(2, [0], [1.0])
        return (p.Vectors.norm(v, 1), p.Vectors.norm(v, 2),
                p.Vectors.norm(v, np.inf), p.Vectors.norm(v, 3),
                p.Vectors.sqdist(v, u), v.norm(), v.sq_dist(u))

    got = _both(case)
    assert got[:3] == (7.0, 5.0, 4.0) and got[4] == pytest.approx(20.0)


def test_argmax_matches_reference_semantics():
    def case(p):
        return (p.Vectors.dense(1.0, 5.0, 2.0).argmax(),
                p.SparseVector(3, [0, 1], [-2.0, -1.0]).argmax(),
                p.SparseVector(3, [1], [7.0]).argmax(),
                p.SparseVector(4, [], []).argmax(),
                p.SparseVector(2, [0, 1], [-1.0, -2.0]).argmax())

    assert _both(case) == (1, 2, 1, 0, 0)


def test_compressed_picks_smaller():
    def case(p):
        mostly_zero = p.Vectors.dense([0.0] * 100 + [1.0])
        dense = p.Vectors.dense(list(range(1, 11)))
        return (type(mostly_zero.compressed()).__name__,
                type(dense.compressed()).__name__,
                mostly_zero.compressed().to_array())

    assert _both(case)[:2] == ("SparseVector", "DenseVector")


def test_vector_dot_copy_zeros_and_hash():
    def case(p):
        d = p.Vectors.dense(1.0, 0.0, 2.0)
        s = p.Vectors.sparse(3, [0, 2], [1.0, 2.0])
        c = d.copy()
        c.values[0] = 9.0
        return (d.dot(s), s.dot(d), hash(d) == hash(s), d.to_array(),
                p.Vectors.zeros(3).to_array(), s.num_nonzeros(), len(s),
                s.copy().to_array())

    _both(case)


def test_dense_vector_keeps_its_port_behaviour():
    """Every fitted model's ``coefficients``: a float64 array that numpy
    reads through ``__array__``, indexed as floats."""
    v = DenseVector([1, 2, 3])
    assert v.values.dtype == np.float64
    np.testing.assert_array_equal(np.asarray(v), [1.0, 2.0, 3.0])
    assert np.asarray(v, dtype=np.float32).dtype == np.float32
    assert v[1] == 2.0 and len(v) == 3 and v.size == 3


def test_sparse_vector_sorts_and_checks_indices():
    def case(p):
        sv = p.SparseVector(6, [4, 1, 3], [4.0, 1.0, 3.0])
        return sv.indices, sv.values

    _both(case)
    with pytest.raises(ValueError, match="out of range"):
        SparseVector(3, [5], [1.0])
    with pytest.raises(ValueError, match="same length"):
        SparseVector(3, [0, 1], [1.0])


# -- matrices ----------------------------------------------------------------

def test_dense_matrix_column_major_ctor():
    def case(p):
        m = p.Matrices.dense(2, 2, [1, 2, 3, 4])
        t = p.DenseMatrix(2, 3, [1, 2, 3, 4, 5, 6], is_transposed=True)
        return (m[0, 0], m[1, 0], m[0, 1], m[1, 1], m.values, m.to_array(),
                t.to_array(), t.values)

    got = _both(case)
    assert got[:4] == (1, 2, 3, 4) and got[4].tolist() == [1, 2, 3, 4]


def test_sparse_matrix_csc_ctor():
    def case(p):
        m = p.Matrices.sparse(2, 2, [0, 1, 2], [1, 0], [5.0, 7.0])
        t = m.transpose()
        return (m[1, 0], m[0, 1], m.num_actives(), t[0, 1], t[1, 0],
                m.to_array(), m.to_dense().to_array(),
                m.to_scipy().toarray(),
                p.SparseMatrix.from_scipy(m.to_scipy()).to_array())

    got = _both(case)
    assert got[:5] == (5.0, 7.0, 2, 5.0, 7.0)


def test_matrix_methods():
    def case(p):
        a = p.Matrices.from_array(np.arange(6.0).reshape(2, 3))
        c = a.copy()
        c.to_array()[0, 0] = 9.0
        return (a.to_array(), a.transpose().to_array(), a.T.to_array(),
                a.apply(1, 2), a.num_nonzeros(), a.num_actives(),
                a.colwise(), [r.to_array() for r in a.row_iter()],
                [col.to_array() for col in a.col_iter()],
                a.to_sparse().to_array(), a.to_sparse().num_actives(),
                a == p.Matrices.from_array(np.arange(6.0).reshape(2, 3)),
                p.Matrices.zeros(2, 2).to_array(),
                p.Matrices.ones(1, 2).to_array(), p.Matrices.eye(2).to_array(),
                p.Matrices.diag(p.Vectors.dense(1.0, 2.0)).to_array(),
                p.Matrices.horzcat([a, a]).to_array(),
                p.Matrices.vertcat([a, a]).to_array())

    _both(case)


def test_matrix_multiply():
    def case(p):
        a = p.Matrices.from_array(np.arange(6.0).reshape(2, 3))
        b = p.Matrices.from_array(np.arange(12.0).reshape(3, 4))
        v = p.Vectors.dense(1.0, 2.0, 3.0)
        return a.multiply(b).to_array(), a.multiply(v).to_array()

    ab, av = _both(case, rtol=1e-12)
    a = np.arange(6.0).reshape(2, 3)
    np.testing.assert_allclose(ab, a @ np.arange(12.0).reshape(3, 4))
    np.testing.assert_allclose(av, a @ [1.0, 2.0, 3.0])


# -- BLAS --------------------------------------------------------------------

def test_axpy_dense_and_sparse():
    def case(p):
        y = p.DenseVector(np.ones(4))
        p.BLAS.axpy(2.0, p.Vectors.dense(1, 2, 3, 4), y)
        y2 = p.DenseVector(np.zeros(4))
        p.BLAS.axpy(3.0, p.Vectors.sparse(4, [1, 3], [1.0, 2.0]), y2)
        return y.to_array(), y2.to_array()

    y, y2 = _both(case)
    np.testing.assert_allclose(y, [3, 5, 7, 9])
    np.testing.assert_allclose(y2, [0, 3, 0, 6])
    with pytest.raises(ValueError, match="size mismatch"):
        BLAS.axpy(1.0, Vectors.dense(1.0), DenseVector(np.zeros(2)))


def test_dot_all_combinations():
    def case(p):
        d1, d2 = p.Vectors.dense(1, 2, 3), p.Vectors.dense(4, 5, 6)
        s1 = p.Vectors.sparse(3, [0, 2], [1.0, 3.0])
        s2 = p.Vectors.sparse(3, [1, 2], [5.0, 6.0])
        return (p.BLAS.dot(d1, d2), p.BLAS.dot(s1, d2), p.BLAS.dot(d2, s1),
                p.BLAS.dot(s1, s2))

    assert _both(case) == (32.0, 22.0, 22.0, 18.0)


def test_scal_and_copy():
    def case(p):
        v = p.Vectors.dense(1.0, 2.0)
        p.BLAS.scal(3.0, v)
        y = p.Vectors.zeros(2)
        p.BLAS.copy(v, y)
        s = p.Vectors.sparse(3, [1], [2.0])
        p.BLAS.scal(0.5, s)
        return v.to_array(), y.to_array(), s.to_array()

    v, y, _ = _both(case)
    np.testing.assert_allclose(v, [3, 6])
    np.testing.assert_allclose(y, [3, 6])


def test_gemv_variants():
    a_np = np.arange(6.0).reshape(2, 3)

    def case(p):
        a = p.Matrices.from_array(a_np)
        x = p.Vectors.dense(1.0, 1.0, 1.0)
        y = p.DenseVector(np.ones(2))
        p.BLAS.gemv(2.0, a, x, 0.5, y)
        y2 = p.DenseVector(np.zeros(2))
        p.BLAS.gemv(1.0, a, p.Vectors.sparse(3, [2], [2.0]), 0.0, y2)
        y3 = p.DenseVector(np.zeros(2))
        p.BLAS.gemv(1.0, p.SparseMatrix.from_array(a_np), x, 0.0, y3)
        return y.to_array(), y2.to_array(), y3.to_array()

    y, y2, y3 = _both(case, rtol=1e-12)
    np.testing.assert_allclose(y, 2.0 * (a_np @ np.ones(3)) + 0.5)
    np.testing.assert_allclose(y2, a_np[:, 2] * 2.0)
    np.testing.assert_allclose(y3, a_np.sum(axis=1))


def test_gemm_variants():
    a_np = np.random.RandomState(0).randn(4, 3)
    b_np = np.random.RandomState(1).randn(3, 5)

    def case(p):
        c = p.Matrices.zeros(4, 5)
        p.BLAS.gemm(1.5, p.Matrices.from_array(a_np),
                    p.Matrices.from_array(b_np), 0.0, c)
        c2 = p.Matrices.ones(4, 5)
        p.BLAS.gemm(1.0, p.SparseMatrix.from_array(a_np),
                    p.Matrices.from_array(b_np), 2.0, c2)
        c3 = p.Matrices.ones(4, 5)
        p.BLAS.gemm(1.0, p.Matrices.from_array(a_np),
                    p.SparseMatrix.from_array(b_np), -1.0, c3)
        return c.to_array(), c2.to_array(), c3.to_array()

    c, c2, c3 = _both(case, rtol=1e-12)
    np.testing.assert_allclose(c, 1.5 * a_np @ b_np, rtol=1e-12)
    np.testing.assert_allclose(c2, a_np @ b_np + 2.0, rtol=1e-12)
    np.testing.assert_allclose(c3, a_np @ b_np - 1.0, rtol=1e-12)
    with pytest.raises(ValueError, match="dimension mismatch"):
        BLAS.gemm(1.0, Matrices.from_array(a_np), Matrices.from_array(a_np),
                  0.0, Matrices.zeros(4, 3))


def test_spr_matches_packed_outer():
    v = np.random.RandomState(2).randn(5)

    def case(p):
        u = np.zeros(15)
        p.BLAS.spr(1.0, p.Vectors.dense(v), u)
        u2 = np.zeros(15)
        p.BLAS.spr(2.0, p.Vectors.dense(v).to_sparse(), u2)
        return u, u2, p.BLAS.unpack_upper(u, 5)

    u, u2, full = _both(case, rtol=1e-12)
    np.testing.assert_allclose(full, np.outer(v, v), rtol=1e-12)
    np.testing.assert_allclose(u2, 2.0 * u, rtol=1e-12)


def test_pack_unpack_roundtrip():
    m = np.random.RandomState(3).randn(6, 6)
    sym = m + m.T

    def case(p):
        packed = p.BLAS.pack_upper(sym)
        return packed, p.BLAS.unpack_upper(packed, 6)

    _, back = _both(case)
    np.testing.assert_allclose(back, sym)


def test_syr():
    rng = np.random.RandomState(4)
    a0 = rng.randn(4, 4)
    x_np = rng.randn(4)

    def case(p):
        a = p.Matrices.from_array(a0.copy())
        p.BLAS.syr(0.7, p.Vectors.dense(x_np), a)
        a2 = p.Matrices.zeros(4, 4)
        p.BLAS.syr(1.0, p.Vectors.sparse(4, [1, 3], [2.0, 3.0]), a2)
        return a.to_array(), a2.to_array()

    a, a2 = _both(case, rtol=1e-12)
    np.testing.assert_allclose(a, a0 + 0.7 * np.outer(x_np, x_np),
                               rtol=1e-12)
    expected = np.zeros((4, 4))
    expected[np.ix_([1, 3], [1, 3])] = np.outer([2.0, 3.0], [2.0, 3.0])
    np.testing.assert_allclose(a2, expected)


def test_device_gemm_large_routes_to_the_device(pctx):
    """Above the threshold on ``cyclone.master=cpu``: one torch.matmul on
    the mesh's CPU device in float64, counted as a device route; below it
    numpy, counted as a host route; the reference's result to 1e-12."""
    rng = np.random.RandomState(5)
    a, b = rng.randn(300, 300), rng.randn(300, 300)
    x = rng.randn(300)
    blas.reset_route_counts()
    got = BLAS.device_gemm(a, b)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, _reference().BLAS.device_gemm(a, b),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, a @ b, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(BLAS.device_gemm(a[:4, :4], b[:4, :4]),
                                  a[:4, :4] @ b[:4, :4])
    np.testing.assert_allclose(BLAS.device_gemv(a, x), a @ x, rtol=1e-12)
    np.testing.assert_array_equal(BLAS.device_gemv(a[:4], x), a[:4] @ x)
    assert BLAS.device_gemm.routes == {"device": 1, "host": 1}
    assert BLAS.device_gemv.routes == {"device": 0, "host": 2}


def test_device_gemv_routes_by_the_threshold(pctx, monkeypatch):
    monkeypatch.setattr(blas, "DEVICE_FLOPS_THRESHOLD", 16)
    blas.reset_route_counts()
    a = np.arange(20.0).reshape(4, 5)
    y = DenseVector(np.zeros(4))
    BLAS.gemv(1.0, Matrices.from_array(a), Vectors.dense(np.ones(5)), 0.0, y)
    np.testing.assert_allclose(y.to_array(), a.sum(1), rtol=1e-12)
    assert BLAS.device_gemv.routes == {"device": 1, "host": 0}


def test_device_gemm_on_cuda_without_a_card_raises(monkeypatch):
    """No silent fallback: on the default CUDA master with no card a
    product above the threshold raises, and nothing is counted."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert mesh.active() is None
    blas.reset_route_counts()
    a = np.ones((300, 300))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BLAS.device_gemm(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BLAS.gemm(1.0, Matrices.from_array(a), Matrices.from_array(a), 0.0,
                  Matrices.zeros(300, 300))
    assert BLAS.device_gemm.routes == {"device": 0, "host": 0}
    assert mesh.active() is None
    # below the threshold the host serves, whatever the master
    np.testing.assert_array_equal(BLAS.device_gemm(a[:2, :2], a[:2, :2]),
                                  a[:2, :2] @ a[:2, :2])


# -- distributed matrices ------------------------------------------------------

@pytest.fixture
def ab():
    rng = np.random.RandomState(0)
    return rng.randn(30, 17), rng.randn(17, 11)


def _block_pair(ctx, pctx, *arrays):
    r = _reference()
    return ([r.BlockMatrix.from_numpy(ctx, a) for a in arrays],
            [BlockMatrix.from_numpy(pctx, a) for a in arrays])


def test_block_matrix_roundtrip(ctx, pctx, ab):
    a, _ = ab
    (rm,), (bm,) = _block_pair(ctx, pctx, a)
    assert bm.num_rows() == 30 and bm.num_cols() == 17
    bm.validate()
    assert tuple(bm._arr.shape) == (32, 24) and bm._arr.dtype == torch.float64
    assert bm.rows_per_block == 32 and bm.cols_per_block == 24
    np.testing.assert_array_equal(bm.to_numpy(), a)
    np.testing.assert_array_equal(bm.to_numpy(), rm.to_numpy())
    np.testing.assert_array_equal(bm.to_local_matrix().to_array(),
                                  rm.to_local_matrix().to_array())


def test_block_matrix_multiply(ctx, pctx, ab):
    a, b = ab
    (ra, rb), (pa, pb) = _block_pair(ctx, pctx, a, b)
    c = pa.multiply(pb)
    assert c.num_rows() == 30 and c.num_cols() == 11
    np.testing.assert_allclose(c.to_numpy(), ra.multiply(rb).to_numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(c.to_numpy(), a @ b, atol=1e-12)
    with pytest.raises(ValueError, match="A.cols"):
        pa.multiply(pa)


def test_block_matrix_add_scale_transpose(ctx, pctx, ab):
    a, _ = ab
    (ra,), (pa,) = _block_pair(ctx, pctx, a)
    s = pa.add(pa).subtract(pa.scale(0.5))
    np.testing.assert_array_equal(
        s.to_numpy(), ra.add(ra).subtract(ra.scale(0.5)).to_numpy())
    np.testing.assert_allclose(s.to_numpy(), 1.5 * a)
    t = pa.transpose()
    assert t.num_rows() == 17
    np.testing.assert_array_equal(t.to_numpy(), a.T)
    g = t.multiply(pa)
    np.testing.assert_allclose(g.to_numpy(),
                               ra.transpose().multiply(ra).to_numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.to_numpy(), a.T @ a, atol=1e-12)
    with pytest.raises(ValueError, match="dimension mismatch"):
        pa.add(t)


def test_block_matrix_mixed_padding_paths(ctx, pctx, ab):
    a, _ = ab
    (ra, rat), (pa, pat) = _block_pair(ctx, pctx, a, a.T)
    s = pa.transpose().add(pat)
    np.testing.assert_array_equal(s.to_numpy(),
                                  ra.transpose().add(rat).to_numpy())
    np.testing.assert_allclose(s.to_numpy(), 2.0 * a.T)


def test_block_matrix_conversions(ctx, pctx, ab):
    a, _ = ab
    (ra,), (pa,) = _block_pair(ctx, pctx, a)
    irm = pa.to_indexed_row_matrix()
    np.testing.assert_array_equal(irm.to_numpy(),
                                  ra.to_indexed_row_matrix().to_numpy())
    cm, rcm = pa.to_coordinate_matrix(), ra.to_coordinate_matrix()
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(cm, f), getattr(rcm, f))
    np.testing.assert_array_equal(cm.to_numpy(), a)


def test_coordinate_matrix(ctx, pctx):
    entries = [(0, 0, 1.0), (1, 2, 3.0), (4, 1, -2.0), (1, 2, 0.5)]
    rcm = _reference().CoordinateMatrix.from_entries(ctx, entries)
    cm = CoordinateMatrix.from_entries(pctx, entries)
    assert (cm.num_rows(), cm.num_cols()) == (rcm.num_rows(),
                                              rcm.num_cols()) == (5, 3)
    np.testing.assert_array_equal(cm.to_numpy(), rcm.to_numpy())
    assert cm.to_numpy()[1, 2] == 3.5  # duplicates add, as the reference
    t = cm.transpose()
    assert t.num_rows() == 3
    np.testing.assert_array_equal(t.to_numpy(), cm.to_numpy().T)
    np.testing.assert_array_equal(cm.to_block_matrix().to_numpy(),
                                  cm.to_numpy())
    np.testing.assert_array_equal(cm.to_indexed_row_matrix().to_numpy(),
                                  rcm.to_indexed_row_matrix().to_numpy())
    np.testing.assert_array_equal(cm.to_row_matrix().to_numpy(),
                                  rcm.to_row_matrix().to_numpy())
    assert cm.entries() == rcm.entries()
    assert (cm.entries()[1].i, cm.entries()[1].j,
            cm.entries()[1].value) == (1, 2, 3.0)


def test_indexed_row_matrix(ctx, pctx):
    rng = np.random.RandomState(1)
    x = rng.randn(20, 6)
    idx = np.arange(20, dtype=np.int64)[::-1].copy()
    rirm = _reference().IndexedRowMatrix.from_numpy(ctx, idx, x)
    irm = IndexedRowMatrix.from_numpy(pctx, idx, x)
    assert irm.num_rows() == 20 and irm.num_cols() == 6
    np.testing.assert_allclose(irm.compute_gramian_matrix().to_array(),
                               rirm.compute_gramian_matrix().to_array(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(irm.compute_gramian_matrix().to_array(),
                               x.T @ x, atol=1e-12)
    np.testing.assert_array_equal(irm.to_numpy(), rirm.to_numpy())
    np.testing.assert_array_equal(irm.to_numpy()[idx], x)
    svd, rsvd = irm.compute_svd(3), rirm.compute_svd(3)
    np.testing.assert_allclose(svd.s.to_array(), rsvd.s.to_array(),
                               rtol=1e-12)
    np.testing.assert_allclose(svd.s.to_array(),
                               np.linalg.svd(x, compute_uv=False)[:3],
                               atol=1e-10)
    b = rng.randn(6, 2)
    prod = irm.multiply(Matrices.from_array(b))
    rprod = rirm.multiply(_reference().Matrices.from_array(b))
    np.testing.assert_allclose(prod.to_numpy(), rprod.to_numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(prod.indices, idx)
    np.testing.assert_allclose(irm.column_similarities().to_array(),
                               rirm.column_similarities().to_array(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(irm.to_block_matrix().to_numpy(),
                                  rirm.to_block_matrix().to_numpy())
    cm, rcm = irm.to_coordinate_matrix(), rirm.to_coordinate_matrix()
    np.testing.assert_array_equal(cm.to_numpy(), rcm.to_numpy())
    assert irm.to_row_matrix() is irm.row_matrix


# -- on the card --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_device_gemm_above_the_threshold_runs_on_the_card():
    """On ``cyclone.master=cuda``: a product past the threshold is one
    matmul on the card (float32, TF32 off), counted as a device route,
    within float32's rounding of the float64 product; below it numpy."""
    _cuda()
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        assert ctx.device.type == "cuda"
        rng = np.random.RandomState(7)
        a, b = rng.randn(512, 512), rng.randn(512, 512)
        blas.reset_route_counts()
        got = BLAS.device_gemm(a, b)
        assert got.dtype == np.float64
        assert BLAS.device_gemm.routes == {"device": 1, "host": 0}
        bound = 1e-5 * np.linalg.norm(a) * np.linalg.norm(b)
        assert np.abs(got - a @ b).max() <= bound
        c = Matrices.zeros(512, 512)
        BLAS.gemm(1.0, Matrices.from_array(a), Matrices.from_array(b), 0.0, c)
        np.testing.assert_array_equal(c.to_array(), got)
        BLAS.device_gemm(a[:8, :8], b[:8, :8])
        assert BLAS.device_gemm.routes == {"device": 2, "host": 1}
        bm = BlockMatrix.from_numpy(ctx, a)
        assert bm._arr.device.type == "cuda"
        assert np.abs(bm.multiply(BlockMatrix.from_numpy(ctx, b)).to_numpy()
                      - a @ b).max() <= bound
    finally:
        ctx.stop()
