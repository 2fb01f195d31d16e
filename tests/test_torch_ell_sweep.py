"""S1 and S2, the sparse tier's row and column passes (``csrc/ell_sweep.cu``).

On the CPU the wrappers run their plain versions (``index_select`` plus
``index_add_``); here they are held against a float64 numpy truth built
from dense rows, and the column-ordered copy of the nonzeros
(``ell_columns``) is checked for order and content. The ``gpu``-marked
tests hold the CUDA kernels against their plain versions in float64 on the
card, at ragged shapes (n not a multiple of a warp's rows, k = 1, wide
rows, a column that holds every row, empty columns, a COO tail, a
standardizing scale), and check that two launches are bitwise equal. The
card's machine has no jax, and nothing here imports it:

    python -m pytest --noconftest -m gpu tests/test_torch_ell_sweep.py
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch.ops import kernels as tk

LINKS = [tk.LOGISTIC, tk.SQUARED, tk.HINGE, tk.GRAM]


def _ell(n, k, d, seed, hot=False, empty=(), tail_rows=0, device="cpu"):
    """Random ELL rows (n, k) over d columns (distinct in a row), ragged
    (short rows padded with (0, 0.0)), and optionally: column 0 in every
    row (``hot``), columns ``empty`` never used, a COO tail on every
    ``tail_rows``-th row. Returns (indices, values, tail or None, dense
    float64 rows)."""
    rng = np.random.RandomState(seed)
    free = np.setdiff1d(np.arange(1 if hot else 0, d), np.asarray(empty))
    idx = np.zeros((n, k), np.int32)
    val = np.zeros((n, k), np.float32)
    dense = np.zeros((n, d))
    for i in range(n):
        m = k if hot or i % 3 else rng.randint(0, k + 1)
        cols = rng.choice(free, size=m - int(hot), replace=False)
        if hot:
            cols = np.concatenate([[0], cols])
        v = rng.randn(m).astype(np.float32)
        idx[i, :m], val[i, :m] = cols, v
        dense[i, cols] += v
    tail = None
    if tail_rows:
        rows = np.arange(0, n, tail_rows)
        t_rows = np.repeat(rows, 3).astype(np.int32)
        t_cols = rng.choice(np.setdiff1d(np.arange(d), np.asarray(empty)),
                            size=t_rows.size).astype(np.int32)
        t_vals = rng.randn(t_rows.size).astype(np.float32)
        np.add.at(dense, (t_rows, t_cols), t_vals.astype(np.float64))
        # a padding entry (0, 0, 0.0), as a hybrid dataset pads its tail
        t = [torch.from_numpy(np.append(a, 0).astype(a.dtype))
             for a in (t_rows, t_cols, t_vals)]
        tail = tk.ell_tail(*[a.to(device) for a in t], n)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(val).to(device),
            tail, dense)


def _labels(n, seed, device="cpu"):
    rng = np.random.RandomState(seed + 1)
    y = (rng.rand(n) > 0.6).astype(np.float32)
    w = (rng.rand(n) + 0.5).astype(np.float32)
    w[::7] = 0.0  # rows masked by w = 0
    return torch.from_numpy(y).to(device), torch.from_numpy(w).to(device)


def _truth(dense, y, w, beta, b0, link):
    """Float64 (mult, loss) of the dense rows."""
    y, w = y.double().cpu().numpy(), w.double().cpu().numpy()
    m = dense @ beta + b0
    if link == tk.LOGISTIC:
        loss = np.sum(w * (np.logaddexp(0.0, m) - y * m))
        mult = w * (1.0 / (1.0 + np.exp(-m)) - y)
    elif link == tk.SQUARED:
        loss, mult = 0.5 * np.sum(w * (m - y) ** 2), w * (m - y)
    elif link == tk.HINGE:
        s = 2 * y - 1
        loss = np.sum(w * np.maximum(0.0, 1 - s * m))
        mult = np.where(1 - s * m > 0, -s * w, 0.0)
    else:
        loss, mult = 0.0, m * (w > 0)
    return mult, loss


@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("hybrid", [False, True])
def test_plain_passes_match_float64(link, hybrid):
    """The plain S1 and S2 in float64 against dense float64 rows, with a
    COO tail and with a standardizing scale."""
    n, k, d = 203, 6, 40
    idx, val, tail, dense = _ell(n, k, d, seed=3, tail_rows=5 if hybrid
                                 else 0)
    y, w = _labels(n, 3)
    rng = np.random.RandomState(4)
    beta = rng.randn(d) * 0.5
    scale = (rng.rand(d) + 0.5).astype(np.float32)
    sdense = _scaled_dense(idx, val, tail, scale, d)
    mult, loss, msum, wsum = tk.ell_rows(idx, val, y, w,
                                         torch.from_numpy(beta), 0.3, link,
                                         torch.from_numpy(scale), tail)
    t_mult, t_loss = _truth(sdense, y, w, beta, 0.3, link)
    np.testing.assert_allclose(mult.numpy(), t_mult, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(loss), t_loss, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(msum), t_mult.sum(), rtol=1e-10,
                               atol=1e-10)
    assert float(wsum) == pytest.approx(float(w.double().sum()), rel=1e-15)
    g = tk.ell_cols(idx, val, mult, d, scale=torch.from_numpy(scale),
                    tail=tail)
    np.testing.assert_allclose(g.numpy(), sdense.T @ t_mult, rtol=1e-10,
                               atol=1e-10)
    assert tk.ell_rows.launches == 0 and tk.ell_cols.launches == 0


def _scaled_dense(idx, val, tail, scale, d):
    """Dense float64 rows of the float32 products value * scale[index]."""
    i, v = idx.cpu().numpy(), val.cpu().numpy()
    out = np.zeros((i.shape[0], d))
    sv = (v * scale[i]).astype(np.float64)
    for r in range(i.shape[0]):
        np.add.at(out[r], i[r], sv[r])
    if tail is not None:
        rows = tk.tail_row_ids(tail).cpu().numpy()
        c, tv = tail.cols.cpu().numpy(), tail.vals.cpu().numpy()
        np.add.at(out, (rows, c), (tv * scale[c]).astype(np.float64))
    return out


def test_plain_moments_match_float64():
    """The moments are sums over the stored entries (a column that a row
    holds twice, in its ELL slots and its tail, adds two squares), as the
    reference's summary sums them."""
    n, k, d = 150, 5, 30
    idx, val, tail, _ = _ell(n, k, d, seed=5, tail_rows=4)
    _, w = _labels(n, 5)
    mom = tk.ell_cols(idx, val, w, d, moments=True, tail=tail)
    assert mom.shape == (3, d)
    rows = np.concatenate([np.repeat(np.arange(n), k),
                           tk.tail_row_ids(tail).numpy()])
    cols = np.concatenate([idx.numpy().ravel(), tail.cols.numpy()])
    v = np.concatenate([val.numpy().ravel(), tail.vals.numpy()]
                       ).astype(np.float64)
    wr = w.double().numpy()[rows]
    for q, term in enumerate((wr * v, wr * v * v, wr * (v != 0))):
        truth = np.zeros(d)
        np.add.at(truth, cols, term)
        np.testing.assert_allclose(mom[q].double().numpy(), truth,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hybrid", [False, True])
def test_column_copy_holds_every_nonzero_in_row_order(hybrid):
    """ell_columns: each nonzero once, columns in order, rows ascending
    inside a column (the ELL entries; the tail comes after them), pieces
    that cover each column, and two builds equal."""
    n, k, d = 300, 7, 50
    idx, val, tail, dense = _ell(n, k, d, seed=6, hot=True, empty=(7, 8),
                                 tail_rows=9 if hybrid else 0)
    cols = tk.ell_columns(idx, val, d, tail, piece=16, chunk_rows=64)
    again = tk.ell_columns(idx, val, d, tail, piece=16, chunk_rows=97)
    assert all(torch.equal(a, b) for a, b in zip(cols[:5], again[:5]))
    ptr = cols.col_ptr.numpy()
    n_tail = 0 if tail is None else int(torch.count_nonzero(tail.vals))
    assert ptr[-1] == int(torch.count_nonzero(val)) + n_tail
    assert ptr[1] - ptr[0] >= n  # column 0 holds every row
    assert ptr[7] == ptr[8] == ptr[9]  # columns 7 and 8 are empty
    rebuilt = np.zeros((n, d))
    rows, vals = cols.rows.numpy(), cols.vals.numpy()
    for c in range(d):
        r = rows[ptr[c]:ptr[c + 1]]
        if tail is None:
            assert np.all(np.diff(r) >= 0)
        np.add.at(rebuilt, (r, np.full(r.size, c)), vals[ptr[c]:ptr[c + 1]])
        pieces = cols.piece_start[c + 1] - cols.piece_start[c]
        assert int(pieces) == -(-(ptr[c + 1] - ptr[c]) // 16)
        assert torch.all(cols.piece_col[cols.piece_start[c]:
                                        cols.piece_start[c + 1]] == c)
    np.testing.assert_allclose(rebuilt, dense, rtol=1e-6, atol=1e-6)


def test_cuda_launch_without_column_copy_raises_on_cpu_tensors_never():
    """On CPU tensors the wrappers never ask for the column copy: the
    plain version runs and nothing is launched."""
    idx, val, tail, _ = _ell(40, 3, 10, seed=1)
    r = torch.ones(40)
    g = tk.ell_cols(idx, val, r, 10, columns=None)
    assert g.shape == (10,) and tk.ell_cols.launches == 0


# -- the kernels on the card --------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (n, k, d): k = 1; n not a multiple of 32 rows; wide rows past one 32-slot
# chunk; more columns than rows
_SHAPES = [(1, 1, 3), (1000, 1, 50), (1037, 39, 300), (4099, 72, 2000),
           (333, 232, 5000)]


# S1 forms each slot's product v s beta in float32 (the float64 truth forms
# it from the same float32 factors) and sums in double, so a row's margin is
# off by at most 2^-24 sum |v s beta| and its mult by the link's slope times
# that, plus float32's rounding of mult. S2 forms r v s in float32 as its
# plain version does and sums in double: a column is off by float32's
# rounding of its sum and double roundings of sum |r v s|. Every row and
# every column is held to its own bound, at twice the unit roundoff.
ROW_RTOL, COL_RTOL, COL_ATOL = 1.2e-7, 1e-7, 1e-9


def _abs_tail(tail):
    return None if tail is None else tail._replace(vals=tail.vals.abs())


def _row_scale(idx, val, beta, scale, tail):
    """sum |v s beta| of each row (float64): the scale of its margin."""
    ones = torch.ones(idx.shape[0], device=idx.device)
    return tk.ell_rows_plain(idx, val.abs(), ones, ones, beta.double().abs(),
                             0.0, tk.GRAM, scale, _abs_tail(tail))[0]


def _assert_columns(got, truth, abs_sum):
    """Every column within COL_RTOL |truth| + COL_ATOL sum |terms|."""
    err = (got.double() - truth).abs()
    assert torch.all(err <= COL_RTOL * truth.abs() + COL_ATOL * abs_sum)


def _run_both(dev, n, k, d, link, hybrid, scaled, seed):
    idx, val, tail, _ = _ell(n, k, d, seed, hot=True, empty=(1, 2),
                             tail_rows=3 if hybrid else 0, device=dev)
    y, w = _labels(n, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    beta = torch.randn(d, generator=g, device=dev) / k ** 0.5
    scale = (torch.rand(d, generator=g, device=dev) + 0.5) if scaled \
        else None
    b0 = torch.tensor(0.25, device=dev)
    out = tk.ell_rows(idx, val, y, w, beta, b0, link, scale, tail)
    again = tk.ell_rows(idx, val, y, w, beta, b0, link, scale, tail)
    truth = tk.ell_rows_plain(idx, val, y, w, beta.double(), b0.double(),
                              link, scale, tail)
    ones = torch.ones_like(w)
    margin = tk.ell_rows_plain(idx, val, y, ones, beta.double(), b0.double(),
                               tk.GRAM, scale, tail)[0]
    m_scale = _row_scale(idx, val, beta, scale, tail)
    cols = tk.ell_columns(idx, val, d, tail)
    grad = tk.ell_cols(idx, val, out[0], d, scale=scale, tail=tail,
                       columns=cols)
    grad2 = tk.ell_cols(idx, val, out[0], d, scale=scale, tail=tail,
                        columns=cols)
    # S2's truth on S1's own mult, and the columns' sums of |r v s|
    t_grad = tk.ell_cols_plain(idx, val, out[0], d, scale=scale, tail=tail,
                               acc_dtype=torch.float64)
    a_grad = tk.ell_cols_plain(idx, val.abs(), out[0].abs(), d, scale=scale,
                               tail=_abs_tail(tail), acc_dtype=torch.float64)
    torch.cuda.synchronize()
    return (out, again, truth, grad, grad2, t_grad, a_grad, y, w, margin,
            m_scale)


@pytest.mark.gpu
@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("n,k,d", _SHAPES)
@pytest.mark.parametrize("hybrid,scaled", [(False, False), (True, True)])
def test_cuda_passes_match_plain(n, k, d, link, hybrid, scaled):
    """S1 then S2 against float64 on the card, each row and each column
    to its own scale: every row's mult within its slope times 1.2e-7 sum
    |v s beta| plus 1.2e-7 |mult| (a hinge row exact unless its margin
    lies that close to the kink); the loss within the bound those margins
    allow; sum(mult) the double sum of mult; S2 on S1's mult within 1e-7
    of each column plus 1e-9 of its sum |r v s|; sum(w) exact; two
    launches of each bitwise equal."""
    dev = _cuda()
    before = (tk.ell_rows.launches, tk.ell_cols.launches)
    ((mult, loss, msum, wsum), again, truth, grad, grad2, t_grad, a_grad,
     y, w, margin, m_scale) = _run_both(dev, n, k, d, link, hybrid, scaled,
                                        seed=n + k)
    t_mult, t_loss = truth[0], truth[1]
    w64 = w.double()
    dmult = (mult.double() - t_mult).abs()
    if link == tk.HINGE:
        near = (1.0 - (2.0 * y.double() - 1.0) * margin).abs() \
            <= ROW_RTOL * m_scale
        assert torch.all(dmult[~near] == 0)
        deriv = w64
    else:
        slope = {tk.LOGISTIC: w64 / 4, tk.SQUARED: w64,
                 tk.GRAM: (w64 > 0).double()}[link]
        assert torch.all(dmult <= ROW_RTOL * (slope * m_scale
                                              + t_mult.abs()))
        deriv = t_mult.abs() if link != tk.GRAM else torch.zeros_like(w64)
    loss_tol = ROW_RTOL * float(torch.sum(deriv * m_scale)) \
        + 1e-12 * abs(float(t_loss))
    assert abs(float(loss) - float(t_loss)) <= loss_tol
    assert abs(float(msum) - float(mult.double().sum())) <= \
        1e-12 * float(mult.double().abs().sum())
    assert float(wsum) == float(w64.sum())  # exact in double
    _assert_columns(grad, t_grad, a_grad)
    assert torch.equal(mult, again[0]) and torch.equal(grad, grad2)
    assert all(torch.equal(a, b) for a, b in zip((loss, msum, wsum),
                                                 again[1:]))
    assert tk.ell_rows.launches == before[0] + 2
    assert tk.ell_cols.launches == before[1] + 2


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d", _SHAPES[1:])
def test_cuda_moments_match_plain(n, k, d):
    """S2's moments mode (the sparse summary) against float64 sums, with
    a tail, each column to its own scale (sum |w v| for sum w v; the other
    two have no negative term); two launches bitwise equal."""
    dev = _cuda()
    idx, val, tail, _ = _ell(n, k, d, n, hot=True, empty=(3,), tail_rows=4,
                             device=dev)
    _, w = _labels(n, n, dev)
    cols = tk.ell_columns(idx, val, d, tail)
    mom = tk.ell_cols(idx, val, w, d, moments=True, tail=tail, columns=cols)
    mom2 = tk.ell_cols(idx, val, w, d, moments=True, tail=tail, columns=cols)
    truth = tk.ell_cols_plain(idx, val, w, d, moments=True, tail=tail,
                              acc_dtype=torch.float64)
    a0 = tk.ell_cols_plain(idx, val.abs(), w, d, moments=True,
                           tail=_abs_tail(tail), acc_dtype=torch.float64)[0]
    torch.cuda.synchronize()
    assert torch.equal(mom, mom2)
    for q in range(3):
        _assert_columns(mom[q], truth[q], a0 if q == 0 else truth[q].abs())
    assert float(mom[0, 3]) == 0.0  # the empty column


@pytest.mark.gpu
def test_cuda_column_holding_every_row_spans_many_pieces():
    """One column in all 300,000 rows (293 pieces) and the rest sparse:
    the pieces' fixed-order combine against float64, each column to its
    own scale."""
    dev = _cuda()
    n, d = 300_000, 64
    g = torch.Generator(device=dev).manual_seed(9)
    idx = torch.randint(1, d, (n, 4), generator=g, device=dev,
                        dtype=torch.int32)
    idx[:, 0] = 0
    val = torch.randn(n, 4, generator=g, device=dev)
    r = torch.randn(n, generator=g, device=dev)
    cols = tk.ell_columns(idx, val, d)
    assert int(cols.piece_start[1]) == -(-n // tk.ELL_PIECE)
    got = tk.ell_cols(idx, val, r, d, columns=cols)
    truth = tk.ell_cols_plain(idx, val, r, d, acc_dtype=torch.float64)
    abs_sum = tk.ell_cols_plain(idx, val.abs(), r.abs(), d,
                                acc_dtype=torch.float64)
    torch.cuda.synchronize()
    _assert_columns(got, truth, abs_sum)


@pytest.mark.gpu
def test_cuda_launch_needs_the_column_copy():
    dev = _cuda()
    idx, val, _, _ = _ell(64, 3, 10, seed=2, device=dev)
    with pytest.raises(ValueError, match="column-ordered copy"):
        tk.ell_cols(idx, val, torch.ones(64, device=dev), 10)
    with pytest.raises(ValueError, match="int32"):
        tk.ell_rows(idx.long(), val, torch.ones(64, device=dev),
                    torch.ones(64, device=dev), torch.ones(10, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("hybrid", [False, True])
def test_cuda_sparse_fit_launches_once_per_evaluation_and_repeats(hybrid):
    """A sparse LogisticRegression on the card: S1 once per evaluation,
    S2 once more for the summary, no other kernel; two fits bitwise equal;
    the plain aggregator's fit within rtol 5e-3 / atol 5e-4."""
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    from cycloneml_tpu_torch.dataset.sparse import SparseInstanceDataset
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    _cuda()
    rng = np.random.RandomState(4)
    n, d = 20_000, 500
    rows = []
    for i in range(n):
        m = 40 if hybrid and i % 50 == 0 else rng.randint(1, 9)
        rows.append((rng.choice(d, m, replace=False), rng.randn(m)))
    beta = rng.randn(d)
    y = np.array([float(r[1] @ beta[r[0]] + rng.randn() > 0) for r in rows])
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        ds = SparseInstanceDataset.from_rows_hybrid(ctx, rows, y, n_features=d,
                                                    k_ell=8) if hybrid \
            else SparseInstanceDataset.from_rows(ctx, rows, y, n_features=d)
        lr = LogisticRegression(maxIter=30, regParam=0.01)
        tk.reset_launch_counts()
        a = lr.fit(ds)
        assert tk.ell_rows.launches == a.summary.total_evals
        assert tk.ell_cols.launches == a.summary.total_evals + 1
        assert tk.ell_cols.launches_by_mode[tk.MOMENTS] == 1
        assert tk.glm_sweep.launches == tk.gramian.launches == 0
        b = lr.fit(ds)
        np.testing.assert_array_equal(a.coefficients.values,
                                      b.coefficients.values)
        assert a.intercept == b.intercept
        ctx.conf.set("cyclone.ml.usePallasKernels", "false")
        p = lr.fit(ds)
        np.testing.assert_allclose(a.coefficients.values,
                                   p.coefficients.values, rtol=5e-3,
                                   atol=5e-4)
    finally:
        ctx.stop()
