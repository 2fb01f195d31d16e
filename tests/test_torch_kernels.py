"""Kernels K1-K4 of the PyTorch port against the JAX package.

On the CPU each wrapper runs its kernel's plain version (float32 sums); it
is held against the reference's Pallas kernel run with ``interpret=True``,
with the tolerances of tests/test_pallas_ops.py (K1: loss rtol 1e-5 and grad
1e-4 for f32 X, 1e-3 and 5e-3 for bf16 X; K2: 1e-3 and 5e-3; K3: equal
argmin, distances 1e-4; K4: rtol 1e-4, atol 1e-3, exact symmetry). The CUDA
kernels themselves are held against their plain versions in float64 by the
``gpu``-marked tests, on the card (float32, bfloat16 and e4m3 codes, with
and without the fp8 rung's ``x_scale``); the machine with the card has no
jax, so the reference is imported inside the tests that use it and the
card's command skips tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

K3's tensor-core arithmetic (bf16 X, or e4m3 codes, times the float32
centers split exactly in three bf16 parts, summed in float32) is emulated
on the CPU and held against the reference; the `gpu` tests hold the
tensor-core instances of K3 and K4 at the edges of their tiling.
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch.ops import kernels as tk

TOL = {"float32": dict(loss=1e-5, grad=1e-4), "bfloat16": dict(loss=1e-3, grad=5e-3)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(42)
    n, d = 300, 37  # deliberately unaligned with tiles and lanes
    x = rng.randn(n, d)
    y = (rng.rand(n) > 0.4).astype(np.float64)
    w = rng.rand(n) + 0.5
    return x, y, w


def _both(x, dtype):
    """The same X values for both packages: numpy for JAX, torch for the
    port (bf16 rounding done once, by ml_dtypes)."""
    if dtype == "bfloat16":
        import ml_dtypes
        xj = np.asarray(x, dtype=ml_dtypes.bfloat16)
        return xj, torch.from_numpy(xj.astype(np.float32)).to(torch.bfloat16)
    return x, torch.from_numpy(np.asarray(x, np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_plain_k1_matches_pallas(data, dtype, fit_intercept, ctx):
    from cycloneml_tpu.ops import fused_binary_logistic
    x, y, w = data
    d = x.shape[1]
    coef = np.random.RandomState(0).randn(d + (1 if fit_intercept else 0))
    xj, xt = _both(x, dtype)
    ref = fused_binary_logistic(xj, y, w, coef, d, fit_intercept,
                                interpret=True, row_tile=128)
    got = tk.fused_binary_logistic(xt, _t(y), _t(w), _t(coef), d,
                                   fit_intercept)
    tol = TOL[dtype]
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=tol["loss"])
    np.testing.assert_allclose(got["grad"].numpy(), np.asarray(ref["grad"]),
                               rtol=tol["grad"], atol=tol["grad"])
    np.testing.assert_allclose(float(got["count"]), float(ref["count"]),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k1_scaled_matches_pallas(data, dtype, ctx):
    from cycloneml_tpu.ops import fused_binary_logistic_scaled
    x, y, w = data
    d = x.shape[1]
    rng = np.random.RandomState(2)
    coef = rng.randn(d + 1)
    inv_std = rng.rand(d) + 0.5
    mu = rng.randn(d)
    xj, xt = _both(x, dtype)
    ref = fused_binary_logistic_scaled(xj, y, w, inv_std, mu, coef, d, True,
                                       interpret=True, row_tile=128)
    got = tk.fused_binary_logistic_scaled(xt, _t(y), _t(w), _t(inv_std),
                                          _t(mu), _t(coef), d, True)
    tol = TOL[dtype]
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=tol["loss"])
    np.testing.assert_allclose(got["grad"].numpy(), np.asarray(ref["grad"]),
                               rtol=tol["grad"], atol=tol["grad"])


def test_plain_k1_padding_rows_inert(ctx):
    """Rows with w=0 (the padding invariant) change no output, in the port
    as in the reference."""
    from cycloneml_tpu.ops import fused_binary_logistic
    rng = np.random.RandomState(1)
    d = 17
    coef = rng.randn(d + 1)
    x, y, w = rng.randn(100, d), (rng.rand(100) > 0.5).astype(float), np.ones(100)
    x2 = np.vstack([x, rng.randn(60, d) * 100])
    y2 = np.concatenate([y, np.ones(60)])
    w2 = np.concatenate([w, np.zeros(60)])
    small = tk.fused_binary_logistic(_both(x, "float32")[1], _t(y), _t(w),
                                     _t(coef), d)
    big = tk.fused_binary_logistic(_both(x2, "float32")[1], _t(y2), _t(w2),
                                   _t(coef), d)
    ref = fused_binary_logistic(x2, y2, w2, coef, d, True, interpret=True,
                                row_tile=128)
    np.testing.assert_allclose(float(big["loss"]), float(small["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(big["grad"].numpy(), small["grad"].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(big["loss"]), float(ref["loss"]),
                               rtol=1e-5)
    assert float(big["count"]) == 100.0


def test_plain_k1_f64_accumulation_is_the_truth(data):
    """glm_sweep_plain in float64 matches a direct numpy evaluation to
    rounding — it is what the kernel is held against on the card."""
    x, y, w = data
    d = x.shape[1]
    rng = np.random.RandomState(5)
    beta, off = rng.randn(d) / np.sqrt(d), 0.3
    loss, g, msum, wsum = tk.glm_sweep_plain(
        _t(x), _t(y), _t(w), _t(beta), off, acc_dtype=torch.float64,
        chunk_rows=64)
    m = x @ beta + off
    mult = w * (1 / (1 + np.exp(-m)) - y)
    np.testing.assert_allclose(float(loss), np.sum(
        w * (np.logaddexp(m, 0) - y * m)), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), x.T @ mult, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(msum), mult.sum(), rtol=1e-10, atol=1e-12)
    assert float(wsum) == pytest.approx(w.sum(), rel=1e-14)


# rows past every whole round of blocks (132 SMs x 8 warps x R = 4 rows x
# 3, plus 5), and fewer rows than one warp's ring
_RAGGED_ROWS = 132 * 8 * 4 * 3 + 5
_SWEEP_SHAPES = [(1, 1), (1003, 37), (4096, 256), (2049, 1000), (777, 2048),
                 (777, 2000), (_RAGGED_ROWS, 1280), (_RAGGED_ROWS, 2000),
                 (5, 1280), (3, 2000)]


def _sweep_holds(x, y, w, beta, off, link=tk.LOGISTIC, ys=0.0,
                 x_scale=None):
    """The CUDA sweep against its plain version in float64 on the same
    card: loss to 1e-5 relative, grad to 1e-4 of its largest entry,
    sum(mult) to 1e-4 of sum(w), sum(w) exact, two launches bitwise equal
    and counted under the link and X's dtype and no other."""
    n = x.shape[0]
    before = dict(tk.glm_sweep.launches_by_link)
    before_dt = dict(tk.glm_sweep.launches_by_dtype)
    out = tk.glm_sweep(x, y, w, beta, off, link=link, ys=ys, x_scale=x_scale)
    again = tk.glm_sweep(x, y, w, beta, off, link=link, ys=ys,
                         x_scale=x_scale)
    torch.cuda.synchronize()
    assert tk.glm_sweep.launches_by_link == {
        k: v + (2 if k == link else 0) for k, v in before.items()}
    assert tk.glm_sweep.launches_by_dtype == {
        k: v + (2 if k == x.dtype else 0) for k, v in before_dt.items()}
    tl, tg, tm, tw = tk.glm_sweep_plain(x, y, w, beta, off,
                                        acc_dtype=torch.float64, link=link,
                                        ys=ys, x_scale=x_scale)
    loss, grad, msum, wsum = out
    assert abs(float(loss) - float(tl)) <= 1e-5 * abs(float(tl))
    assert float((grad.double() - tg).abs().max()) <= \
        1e-4 * float(tg.abs().max()) + 1e-6
    assert abs(float(msum) - float(tm)) <= 1e-4 * float(tw)
    assert float(wsum) == n
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", _SWEEP_SHAPES)
def test_cuda_k1_matches_plain(n, d, dtype):
    """The CUDA kernel against its plain version in float64 on the same
    card (:func:`_sweep_holds`), at ragged and aligned shapes, the fits'
    widths (1,280 and 2,000) and the widest (2,048), with rows past the
    last whole round of blocks and fewer rows than one ring."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n * 7 + d)
    x = torch.randn(n, d, generator=g, device=dev).to(dtype)
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    y = (torch.rand(n, generator=g, device=dev) > 0.5).float()
    w = torch.ones(n, device=dev)
    _sweep_holds(x, y, w, beta, torch.tensor(0.25, device=dev))


# -- K2: the squared link ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k2_matches_pallas(data, dtype, ctx):
    """fused_least_squares_scaled: the port's plain K2 against the
    interpreted Pallas kernel (test_pallas_ops.py:157's tolerances: both
    sum in float32 in different orders)."""
    from cycloneml_tpu.ops import fused_least_squares_scaled
    x, y, w = data
    d = x.shape[1]
    rng = np.random.RandomState(6)
    coef = rng.randn(d)
    inv_std = rng.rand(d) + 0.5
    mu = rng.randn(d)
    y_pars = np.array([1.7, 0.3])
    xj, xt = _both(x, dtype)
    ref = fused_least_squares_scaled(xj, y, w, inv_std, mu, y_pars, coef, d,
                                     interpret=True, row_tile=128)
    got = tk.fused_least_squares_scaled(xt, _t(y), _t(w), _t(inv_std),
                                        _t(mu), _t(y_pars), _t(coef), d)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(got["grad"].numpy(), np.asarray(ref["grad"]),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(float(got["count"]), float(ref["count"]),
                               rtol=1e-6)


def test_plain_k2_f64_matches_reference_aggregator(data, ctx):
    """In float64 the plain squared sweep with the fold around it, and the
    port's least_squares_scaled aggregator, equal the reference's
    least_squares_scaled aggregator to rounding (1e-12)."""
    from cycloneml_tpu.ml.optim import aggregators as jagg
    from cycloneml_tpu_torch.ml.optim import aggregators as tagg
    x, y, w = data
    d = x.shape[1]
    rng = np.random.RandomState(6)
    coef, inv_std, mu = rng.randn(d), rng.rand(d) + 0.5, rng.randn(d)
    y_pars = np.array([1.7, 0.3])
    ref = jagg.least_squares_scaled(d)(x, y, w, inv_std, mu, y_pars, coef)
    loss, g, msum, wsum = tk.glm_sweep_plain(
        _t(x), _t(y), _t(w), _t(inv_std * coef), y_pars[1] - mu @ coef,
        acc_dtype=torch.float64, chunk_rows=64, link=tk.SQUARED,
        ys=y_pars[0])
    grad = inv_std * g.numpy() - mu * float(msum)
    agg = tagg.least_squares_scaled(d)(_t(x), _t(y), _t(w), _t(inv_std),
                                       _t(mu), _t(y_pars), _t(coef))
    for lv, gv in ((float(loss), grad),
                   (float(agg["loss"]), agg["grad"].numpy())):
        np.testing.assert_allclose(lv, float(ref["loss"]), rtol=1e-12)
        np.testing.assert_allclose(gv, np.asarray(ref["grad"]), rtol=1e-12,
                                   atol=1e-12)
    assert float(wsum) == pytest.approx(w.sum(), rel=1e-14)


def test_plain_k2_padding_rows_inert(ctx):
    """Rows with w=0 change no output of the squared sweep."""
    rng = np.random.RandomState(11)
    d = 13
    coef, inv_std, mu = rng.randn(d), rng.rand(d) + 0.5, rng.randn(d)
    y_pars = _t([0.8, -0.2])
    x, y = rng.randn(90, d), rng.randn(90)
    x2 = np.vstack([x, rng.randn(40, d) * 100])
    y2 = np.concatenate([y, rng.randn(40) * 100])
    w2 = np.concatenate([np.ones(90), np.zeros(40)])
    args = (_t(inv_std), _t(mu), y_pars, _t(coef), d)
    small = tk.fused_least_squares_scaled(_both(x, "float32")[1], _t(y),
                                          _t(np.ones(90)), *args)
    big = tk.fused_least_squares_scaled(_both(x2, "float32")[1], _t(y2),
                                        _t(w2), *args)
    np.testing.assert_allclose(float(big["loss"]), float(small["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(big["grad"].numpy(), small["grad"].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert float(big["count"]) == 90.0


# -- K1/K2's summation order, emulated -----------------------------------------

def _block_sums(v, block, kahan=True):
    """The sums of one float32 term array ``v`` (rows, warps, ...) the way
    the CUDA sweep's lanes take them: row i of warp w is ``v[i, w]``; each
    block of ``block`` rows is summed in plain float32, one rounding a row
    (an FMA: the product is exact, the sum rounds), and each block sum goes
    into the lane's running sum by one Kahan step (or by a plain float32
    add). Returns the lanes' sums ``s - c`` in float64."""
    s = torch.zeros(v.shape[1:], dtype=torch.float32)
    c = torch.zeros_like(s)
    for lo in range(0, v.shape[0], block):
        b = torch.zeros_like(s)
        for t in v[lo:lo + block].double():
            b = (b.double() + t).float()
        if kahan:
            y = b - c
            t = s + y
            c = (t - s) - y
            s = t
        else:
            s = s + b
    return s.double() - c.double()


def _emulated_squared_sweep(x, y, w, beta, off, ys, block, warps,
                            products=None, kahan=True):
    """K2 in the CUDA sweep's float32 arithmetic and order on the CPU:
    margins and the link per row in float32, rows dealt to ``warps``
    warps (grid-stride), each lane's sums by :func:`_block_sums`, then the
    warps folded in double in warp order (the CTA fold and the second
    pass add the same terms in double). ``products`` (rows, d), when
    given, are the float64 terms mult * x the gradient sums, so two orders
    can be held to the same terms. Returns float64 ``(loss, grad,
    sum(mult), sum(w))``."""
    n, d = x.shape
    m = x @ beta + off
    err = m - ys * y
    mult = w * err
    loss = 0.5 * w * err * err
    pad = -n % warps
    rows = (n + pad) // warps

    def lanes(v):
        v = torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
        return v.reshape((rows, warps) + v.shape[1:])

    terms = (mult[:, None] * x if products is None else products).float()
    folded = [_block_sums(lanes(v), block, kahan).sum(0)
              for v in (loss, terms, mult, w)]
    return tuple(folded)


@pytest.mark.parametrize("block", [2, 4])
def test_emulated_glm_sweep_block_order(block, capsys):
    """The CUDA sweep sums the gradient as the reference's _run_glm does:
    a block of rows in plain float32, Kahan across blocks (block = 2 for
    bf16 X, 4 for e4m3 codes; float32 X keeps one row a block). Emulated
    in float32 on the CPU at a point where the gradient cancels to <= 1e-3
    of sum|mult x| (the least-squares fit, nudged): within the kernel's
    check bounds of float64 (loss 1e-5 relative, grad 1e-4 of its largest
    entry), and its summation error within 4x that of the per-row Kahan
    order on the same float32 terms. The error of an uncompensated order
    is printed beside them: it is why Kahan across blocks stays."""
    rng = np.random.RandomState(block)
    n, d, warps = 32_768, 64, 32   # 1,024 rows a lane, as at the fit shapes
    x = rng.randn(n, d).astype(np.float32).astype(np.float64)
    y = x @ rng.randn(d) + 0.5 * rng.randn(n)
    coef = np.linalg.lstsq(x, y, rcond=None)[0] + 5e-5 * rng.randn(d)
    x32, y32 = torch.from_numpy(x).float(), torch.from_numpy(y).float()
    beta32, w32 = torch.from_numpy(coef).float(), torch.ones(n)
    off, ys = 0.0, 1.0
    t_loss, t_grad, t_m, t_w = tk.glm_sweep_plain(
        x32, y32, w32, beta32, off, acc_dtype=torch.float64, link=tk.SQUARED,
        ys=ys)
    scale = float((t_grad.abs().max()))
    mult32 = (x32 @ beta32 + off) - ys * y32
    products = mult32.double()[:, None] * x32.double()
    assert scale <= 1e-3 * float(products.abs().sum(0).max())

    loss, grad, msum, wsum = _emulated_squared_sweep(
        x32, y32, w32, beta32, off, ys, block, warps)
    assert abs(float(loss) - float(t_loss)) <= 1e-5 * abs(float(t_loss))
    assert float((grad - t_grad).abs().max()) <= 1e-4 * scale
    assert abs(float(msum) - float(t_m)) <= 1e-4 * float(t_w)
    assert float(wsum) == n

    # summation error alone: every order on the same float32 terms
    exact = products.sum(0)
    errs = {}
    for name, blk, kahan in (("block", block, True), ("row", 1, True),
                             ("uncompensated", block, False)):
        g = _emulated_squared_sweep(x32, y32, w32, beta32, off, ys, blk,
                                    warps, products=products,
                                    kahan=kahan)[1]
        errs[name] = float((g - exact).abs().max()) / scale
    with capsys.disabled():
        print(f"\nblock={block}: grad error / max|grad|: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()))
    assert errs["block"] <= 4 * errs["row"]
    assert errs["block"] <= 1e-4


# -- K3: nearest-center assignment ---------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k", [(500, 23, 11), (300, 17, 5)])
def test_plain_k3_matches_pallas(n, d, k, dtype, ctx):
    """kmeans_assign (k not a multiple of 8) against the interpreted
    fused_kmeans_assign: the argmin equal, distances to 1e-4 (both float32,
    test_pallas_ops.py:69 and :181)."""
    from cycloneml_tpu.ops import fused_kmeans_assign
    rng = np.random.RandomState(n + k)
    x = rng.randn(n, d)
    centers = rng.randn(k, d)
    xj, xt = _both(x, dtype)
    rb, rd = fused_kmeans_assign(xj, centers, interpret=True, row_tile=128)
    best, dist = tk.kmeans_assign(xt, _t(centers))
    np.testing.assert_array_equal(best.numpy(), np.asarray(rb))
    np.testing.assert_allclose(dist.numpy(), np.asarray(rd), rtol=1e-4,
                               atol=1e-4)
    # and against float64 distances over the same (rounded) values
    xf = xt.double().numpy()
    d2 = ((xf[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(best.numpy(), d2.argmin(1))


def test_plain_k3_huge_distances_pick_real_centers(ctx):
    """At distances near 1e6 the reference's padded centers (norm +inf)
    never win; the port has no padded centers, and every index is < k."""
    from cycloneml_tpu.ops import fused_kmeans_assign
    rng = np.random.RandomState(8)
    x = rng.randn(50, 5) * 1000
    centers = rng.randn(3, 5) * 1000
    rb, _ = fused_kmeans_assign(x, centers, interpret=True, row_tile=128)
    best, dist = tk.kmeans_assign(_both(x, "float32")[1], _t(centers))
    assert int(best.max()) < 3
    np.testing.assert_array_equal(best.numpy(), np.asarray(rb))
    assert float(dist.min()) >= 0.0


def test_plain_k3_ties_go_to_the_lowest_index():
    x = torch.zeros(4, 3)
    centers = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0]])
    best, dist = tk.kmeans_assign(x, centers)
    assert best.tolist() == [0, 0, 0, 0]
    assert dist.tolist() == [1.0] * 4


# -- K4: the Gramian -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_k4_matches_pallas(dtype, masked, ctx):
    """gramian against the interpreted fused_gramian, with and without
    the w mask (test_pallas_ops.py:88, :97, :197: rtol 1e-4, atol 1e-3),
    and exactly symmetric."""
    from cycloneml_tpu.ops import fused_gramian
    rng = np.random.RandomState(3)
    x = rng.randn(400, 19)
    w = np.ones(400)
    if masked:
        w[250:] = 0.0  # masked rows contribute nothing
    xj, xt = _both(x, dtype)
    ref = fused_gramian(xj, w=w, interpret=True, row_tile=128)
    got = tk.gramian(xt, _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got, got.T)
    xf = xt.double().numpy()[:250 if masked else 400]
    np.testing.assert_allclose(got, xf.T @ xf, rtol=1e-4, atol=1e-3)


def test_plain_k4_without_weights_takes_every_row():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(120, 11))
    np.testing.assert_allclose(tk.gramian_plain(x, None, torch.float64),
                               (x.T @ x).numpy(), rtol=1e-13)


# -- the CUDA kernels on the card ----------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", _SWEEP_SHAPES)
def test_cuda_k2_matches_plain(n, d, dtype):
    """The squared link against its plain version in float64
    (:func:`_sweep_holds`), at K1's shapes."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n * 5 + d)
    x = torch.randn(n, d, generator=g, device=dev).to(dtype)
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    y = torch.randn(n, generator=g, device=dev)
    w = torch.ones(n, device=dev)
    off, ys = torch.tensor(0.25, device=dev), torch.tensor(0.7, device=dev)
    _sweep_holds(x, y, w, beta, off, link=tk.SQUARED, ys=ys)


@pytest.mark.gpu
@pytest.mark.parametrize("link", [tk.LOGISTIC, tk.SQUARED])
@pytest.mark.parametrize("d", [1280, 2000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
def test_cuda_glm_sweep_misaligned_base(dtype, d, link):
    """X a contiguous (n, d) view one element into a flat buffer, so its
    base is not slot-aligned although its rows' width is: the sweep takes
    its element-wise copies and still holds (:func:`_sweep_holds`)."""
    dev = _cuda()
    n = _RAGGED_ROWS
    g = torch.Generator(device=dev).manual_seed(d + 3)
    flat = torch.randn(n * d + 1, generator=g, device=dev)
    if dtype == torch.float8_e4m3fn:
        flat = flat.clamp(-448, 448)
    x = flat.to(dtype)[1:].view(n, d)
    assert x.is_contiguous() and x.data_ptr() % 8 != 0
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    y = ((torch.rand(n, generator=g, device=dev) > 0.5).float()
         if link == tk.LOGISTIC else torch.randn(n, generator=g, device=dev))
    w = torch.ones(n, device=dev)
    off, ys = torch.tensor(0.25, device=dev), torch.tensor(0.7, device=dev)
    _sweep_holds(x, y, w, beta, off, link=link, ys=ys)


@pytest.mark.gpu
def test_cuda_glm_sweep_instances_do_not_spill():
    """Every glm_sweep_kernel instance (3 dtypes x 2 links x 8 widths, the
    E = 64 ones of d = 2,000 included) and every kernel of the wide
    instance (3 dtypes x 2 links of the margin pass, 3 dtypes of the
    gradient pass) reports 0 spill bytes in ptxas's lines of the build."""
    _cuda()
    from cycloneml_tpu_torch.ops import build
    tk._library("glm_sweep")
    spills, func = {}, None
    for ln in build.ptxas_report("glm_sweep").read_text().splitlines():
        if "Compiling entry function" in ln:
            func = ln.split("'")[1]
        elif func and "spill stores" in ln:
            spills[func] = ln.split(":")[-1].strip()
    sweeps = {f: s for f, s in spills.items() if "glm_sweep_kernel" in f}
    assert len(sweeps) == 48
    wide = {f: s for f, s in spills.items() if "glm_wide_" in f}
    assert len(wide) == 9
    bad = {f: s for f, s in {**sweeps, **wide}.items()
           if "0 bytes spill stores, 0 bytes spill loads" not in s}
    assert not bad, bad


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", [(1, 1, 1), (1003, 37, 11), (777, 100, 37),
                                   (4099, 128, 1000), (300, 2000, 129)])
def test_cuda_k3_matches_plain(n, d, k, dtype):
    """K3 against its plain version in float64 on the same values: where
    the argmins differ, the kernel's pick is within the float32 resolution
    of the expansion (1e-5 max(d2, |x|^2)) of the best; distances to 1e-4
    of the same scale; two launches bitwise equal; int32 indices < k."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n + d + k)
    x = torch.randn(n, d, generator=g, device=dev).to(dtype)
    c = torch.randn(k, d, generator=g, device=dev)
    best, dist = tk.kmeans_assign(x, c)
    best2, dist2 = tk.kmeans_assign(x, c)
    torch.cuda.synchronize()
    assert best.dtype == torch.int32 and int(best.max()) < k
    assert torch.equal(best, best2) and torch.equal(dist, dist2)
    b64, d64 = tk.kmeans_assign_plain(x, c, acc_dtype=torch.float64)
    x64, c64 = x.double(), c.double()
    scale = torch.maximum(d64, (x64 * x64).sum(1))
    picked = ((x64 - c64[best.long()]) ** 2).sum(1)
    assert bool((picked - d64 <= 1e-5 * scale).all())
    assert bool(((dist.double() - d64).abs() <= 1e-4 * scale + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 1), (1003, 37), (4096, 256),
                                 (2049, 300), (500, 2000)])
def test_cuda_k4_matches_plain(n, d, dtype):
    """K4 against its plain version in float64, with a third of the rows
    masked by w = 0: |dG_ij| <= 1e-4 sqrt(G_ii G_jj), exactly symmetric,
    two launches bitwise equal."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n * 3 + d)
    x = torch.randn(n, d, generator=g, device=dev).to(dtype)
    w = (torch.arange(n, device=dev) % 3 != 2).float()
    got = tk.gramian(x, w)
    again = tk.gramian(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, got.T)
    ref = tk.gramian_plain(x, w, acc_dtype=torch.float64)
    diag = torch.sqrt(torch.outer(ref.diagonal(), ref.diagonal()))
    assert bool(((got.double() - ref).abs() <= 1e-4 * diag + 1e-6).all())
    assert torch.equal(tk.gramian(x), tk.gramian(x, torch.ones(n,
                                                                device=dev)))


# -- the e4m3 instances (the fp8 rung) on the card -----------------------------

_FP8_SHAPES = [(1, 1), (1003, 15), (2049, 17), (777, 777)]


def _fp8_codes(n, d, seed, dev):
    """e4m3 codes of N(0, 1) columns of unequal spread, quantized on the
    card, and their per-column scale as a float32 tensor."""
    from cycloneml_tpu_torch.dataset.instance import quantize_fp8
    g = torch.Generator(device=dev).manual_seed(seed)
    spread = torch.rand(d, generator=g, device=dev) * 4 + 0.1
    x = torch.randn(n, d, generator=g, device=dev) * spread
    codes, scale, _ = quantize_fp8(x)
    return codes, torch.as_tensor(scale, dtype=torch.float32, device=dev), g


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("link", [tk.LOGISTIC, tk.SQUARED])
@pytest.mark.parametrize("n,d", _FP8_SHAPES + [
    (2049, 1000), (_RAGGED_ROWS, 1280), (_RAGGED_ROWS, 2000), (5, 2000),
    (777, 2048)])
def test_cuda_fp8_glm_sweep_matches_plain(n, d, link, scaled):
    """K1/K2 on e4m3 codes, with and without x_scale, against the plain
    version in float64 on the same (dequantized) values
    (:func:`_sweep_holds`: launches counted under float8_e4m3fn), at the
    fits' widths too."""
    dev = _cuda()
    x8, scale, g = _fp8_codes(n, d, n + d, dev)
    s = scale if scaled else None
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    if not scaled:
        beta = beta / 448.0  # raw codes reach 448: keep the margins O(1)
    y = ((torch.rand(n, generator=g, device=dev) > 0.5).float()
         if link == tk.LOGISTIC else torch.randn(n, generator=g, device=dev))
    w = torch.ones(n, device=dev)
    off, ys = torch.tensor(0.25, device=dev), torch.tensor(0.7, device=dev)
    _sweep_holds(x8, y, w, beta, off, link=link, ys=ys, x_scale=s)


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("n,d", _FP8_SHAPES)
def test_cuda_fp8_k3_matches_plain(n, d, scaled):
    """K3 on e4m3 codes against its plain version in float64 on the
    dequantized values (x_scale applied before |x|^2 and the product):
    the near-tie rule and distances as for the wider dtypes, bitwise-equal
    launches."""
    dev = _cuda()
    x8, scale, g = _fp8_codes(n, d, 3 * n + d, dev)
    s = scale if scaled else None
    xv = x8.double() * (scale.double() if scaled else 1.0)
    k = 37
    pick = torch.randint(0, n, (k,), generator=g, device=dev)
    spread = 0.1 * float(xv.abs().max().clamp(min=1.0))
    c = (xv[pick] + torch.randn(k, d, generator=g, device=dev,
                                dtype=torch.float64) * spread).float()
    before = tk.kmeans_assign.launches
    best, dist = tk.kmeans_assign(x8, c, x_scale=s)
    best2, dist2 = tk.kmeans_assign(x8, c, x_scale=s)
    torch.cuda.synchronize()
    assert tk.kmeans_assign.launches == before + 2
    assert best.dtype == torch.int32 and int(best.max()) < k
    assert torch.equal(best, best2) and torch.equal(dist, dist2)
    b64, d64 = tk.kmeans_assign_plain(x8, c, acc_dtype=torch.float64,
                                      x_scale=s)
    c64 = c.double()
    scale_r = torch.maximum(d64, (xv * xv).sum(1))
    picked = ((xv - c64[best.long()]) ** 2).sum(1)
    assert bool((picked - d64 <= 1e-5 * scale_r).all())
    assert bool(((dist.double() - d64).abs() <= 1e-4 * scale_r + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("n,d", _FP8_SHAPES)
def test_cuda_fp8_k4_matches_plain(n, d, scaled):
    """K4 on e4m3 codes, a third of the rows masked: |dG_ij| <= 1e-4
    sqrt(G_ii G_jj) against float64 on the dequantized values, exactly
    symmetric, two launches bitwise equal."""
    dev = _cuda()
    x8, scale, _ = _fp8_codes(n, d, 5 * n + d, dev)
    s = scale if scaled else None
    w = (torch.arange(n, device=dev) % 3 != 2).float()
    got = tk.gramian(x8, w, x_scale=s)
    again = tk.gramian(x8, w, x_scale=s)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, got.T)
    ref = tk.gramian_plain(x8, w, acc_dtype=torch.float64, x_scale=s)
    diag = torch.sqrt(torch.outer(ref.diagonal(), ref.diagonal()))
    assert bool(((got.double() - ref).abs() <= 1e-4 * diag + 1e-6).all())


@pytest.mark.gpu
def test_cuda_fp8_never_takes_the_plain_version():
    """A CUDA e4m3 tensor launches the e4m3 instance of every kernel (the
    counts move), and a wrong-length x_scale raises before any launch."""
    dev = _cuda()
    x8, scale, _ = _fp8_codes(64, 16, 1, dev)
    counts = (tk.glm_sweep.launches, tk.kmeans_assign.launches,
              tk.gramian.launches)
    tk.fused_binary_logistic(x8, torch.zeros(64, device=dev),
                             torch.ones(64, device=dev),
                             torch.zeros(17, device=dev), 16, x_scale=scale)
    tk.kmeans_assign(x8, torch.zeros(2, 16, device=dev), x_scale=scale)
    tk.gramian(x8, x_scale=scale)
    torch.cuda.synchronize()
    assert (tk.glm_sweep.launches, tk.kmeans_assign.launches,
            tk.gramian.launches) == tuple(c + 1 for c in counts)
    with pytest.raises(ValueError, match="x_scale"):
        tk.gramian(x8, x_scale=scale[:3])


# -- K3's three-part centers: the numerics of the tensor-core instance ---------
#
# K3's tensor-core instance multiplies bf16 X (or e4m3 codes, exact in bf16)
# by the float32 centers split in three bf16 parts and sums the three exact
# products, smallest first, in float32. These tests hold that arithmetic on
# the CPU, emulated with float32 products of the same bf16 operands.

def _f32_values(rng, shape, lo=-100, hi=100):
    """float32 values of every sign over binades 2^lo .. 2^hi."""
    m = rng.uniform(1.0, 2.0, size=shape)
    e = rng.randint(lo, hi + 1, size=shape)
    sign = rng.choice([-1.0, 1.0], size=shape)
    return (sign * m * np.exp2(e)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_centers_is_exact(seed):
    """hi + mid + lo == c in float64, each part a bf16 value, over a wide
    range of exponents and signs, and for +-0 and +-1."""
    c = _f32_values(np.random.RandomState(seed), (257, 129))
    c[0, :4] = [0.0, -0.0, 1.0, -1.0]
    parts = tk.split_bf16x3(torch.from_numpy(c))
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, 257, 129)
    np.testing.assert_array_equal(parts.double().sum(0).numpy(),
                                  c.astype(np.float64))
    # the signed zeros split into zeros
    assert float(parts[:, 0, :2].double().abs().sum()) == 0.0


def _emulated_k3(x32, centers, parts=3, x_scale=None):
    """K3's tensor-core arithmetic on the CPU: X (bf16 values or e4m3
    codes, in float32) times the first ``parts`` parts of the split
    centers c~ = s o c (lo first: the three-part sum is x.lo + x.mid +
    x.hi; one part is c~ rounded once to bf16), summed in float32;
    d2 = (|x~|^2 - 2 x.c~) + |c|^2 with |c|^2 in value space; the first
    least index."""
    c = torch.as_tensor(centers, dtype=torch.float32)
    s = None if x_scale is None else torch.as_tensor(x_scale,
                                                     dtype=torch.float32)
    split = tk.split_bf16x3(c if s is None else c * s).float()
    use = [split[0]] if parts == 1 else [split[2], split[1], split[0]]
    acc = torch.zeros(x32.shape[0], c.shape[0], dtype=torch.float32)
    for p in use:
        acc = acc + x32 @ p.T
    xs = x32 if s is None else x32 * s
    d2 = ((xs * xs).sum(1)[:, None] - 2.0 * acc) + (c * c).sum(1)[None, :]
    mn, idx = torch.min(d2, dim=1)
    return idx.numpy(), torch.clamp(mn, min=0.0).numpy()


def _pick_rule(best, dist, xv, centers):
    """The worst pick excess and distance error over max(d2, |x|^2) against
    float64 distances of the same values (chip_smoke.py's K3 rule)."""
    d2 = ((xv[:, None, :] - centers[None, :, :].astype(np.float64)) ** 2
          ).sum(-1)
    truth = d2.min(1)
    scale = np.maximum(truth, (xv * xv).sum(1))
    picked = d2[np.arange(len(best)), best]
    return (float(((picked - truth) / scale).max()),
            float((np.abs(dist - truth) / scale).max()))


@pytest.mark.parametrize("case", ["bf16", "fp8"])
def test_emulated_k3_matches_pallas(case, ctx):
    """The emulated three-part arithmetic against the interpreted
    fused_kmeans_assign on the recipes of tests/test_pallas_ops.py:181
    (bf16 points) and :307 (e4m3 codes; the scale folded into the centers,
    c~ = s o c, so that x~ . c = code . c~): argmins agree or lie within
    1e-5 of max(d2, |x|^2), distances within 1e-4 of it."""
    import ml_dtypes
    from cycloneml_tpu.dataset.instance import quantize_fp8
    from cycloneml_tpu.ops import fused_kmeans_assign
    if case == "bf16":
        rng = np.random.RandomState(9)
        xj = np.asarray(rng.randn(300, 17), dtype=ml_dtypes.bfloat16)
        centers = rng.randn(5, 17)
        rb, _ = fused_kmeans_assign(xj, centers, interpret=True,
                                    row_tile=128)
        codes = torch.from_numpy(np.asarray(xj, np.float32))
        xv = np.asarray(xj, np.float64)
        scale = None
    else:
        rng = np.random.RandomState(11)
        centers = rng.randn(5, 8) * 2.0
        x = centers[rng.randint(0, 5, 200)] + 0.05 * rng.randn(200, 8)
        x8, scale = quantize_fp8(x)[:2]
        rb, _ = fused_kmeans_assign(x8, centers, interpret=True,
                                    row_tile=64, x_scale=scale)
        codes = torch.from_numpy(np.asarray(x8, np.float32))
        xv = np.asarray(x8, np.float64) * scale[None, :]
    best, dist = _emulated_k3(codes, centers, x_scale=scale)
    excess, dist_err = _pick_rule(best, dist, xv, centers)
    same = best == np.asarray(rb)
    assert same.all() or excess <= 1e-5
    assert excess <= 1e-5 and dist_err <= 1e-4


def _near_tie_set(seed, pairs=40, d=16, rows_per_pair=3):
    """A set on which one bf16 pass picks wrong by construction, for every
    seed: center B_i is a bf16 vector with entries in [1, 1.25) (bf16
    spacing u = 2^-7 there) and the rows sit on it (distance 0); its twin
    A_i = B_i + 1.9 u, at index 2i, before B_i, rounds to B_i + 2u. One pass
    sees x . bf16(A_i) = x . A_i + 0.1 u sum(x), which overstates the
    product by more than the true gap (3.61 u^2 d): it picks A_i, 3.61 u^2
    / 1.5625 >= 1.4e-4 of |x|^2 too far. The three exact parts see the
    true gap, which float32 resolves at ~1e-7 of |x|^2."""
    import ml_dtypes
    rng = np.random.RandomState(seed)
    u = 2.0 ** -7
    b = np.asarray(rng.uniform(1.0, 1.25, size=(pairs, d)),
                   dtype=ml_dtypes.bfloat16).astype(np.float64)
    a = (b + 1.9 * u).astype(np.float32)
    centers = np.empty((2 * pairs, d), np.float32)
    centers[0::2], centers[1::2] = a, b.astype(np.float32)
    x = np.repeat(b, rows_per_pair, axis=0)
    return x, centers


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_one_bf16_pass_is_not_enough(seed):
    """On the near-tie set the single-pass emulation's worst pick excess
    is above the 1e-5 rule, and the three-part one is within it."""
    x, centers = _near_tie_set(seed)
    x32 = torch.from_numpy(x.astype(np.float32))
    one, one_d = _emulated_k3(x32, centers, parts=1)
    three, three_d = _emulated_k3(x32, centers, parts=3)
    one_excess, _ = _pick_rule(one, one_d, x, centers)
    three_excess, three_err = _pick_rule(three, three_d, x, centers)
    assert one_excess > 1e-5
    assert three_excess <= 1e-5 and three_err <= 1e-4
    # and the three parts find the rows' own centers
    np.testing.assert_array_equal(three,
                                  np.repeat(np.arange(1, len(centers), 2), 3))


# -- the tensor-core instances of K3 and K4 on the card: the tiling's edges ----

def _k3_holds(x, c, x_scale=None):
    """K3 at chip_smoke.py's tolerances against float64 on the same
    values: where the argmins differ the pick is within 1e-5 of max(d2,
    |x|^2) of the best, distances within 1e-4 of it; two launches bitwise
    equal; int32 indices < k. Returns the count of differing rows."""
    k = c.shape[0]
    best, dist = tk.kmeans_assign(x, c, x_scale=x_scale)
    best2, dist2 = tk.kmeans_assign(x, c, x_scale=x_scale)
    torch.cuda.synchronize()
    assert best.dtype == torch.int32 and 0 <= int(best.min())
    assert int(best.max()) < k
    assert torch.equal(best, best2) and torch.equal(dist, dist2)
    b64, d64 = tk.kmeans_assign_plain(x, c, acc_dtype=torch.float64,
                                      x_scale=x_scale)
    xv = x.double() * (1.0 if x_scale is None else x_scale.double())
    scale = torch.maximum(d64, (xv * xv).sum(1))
    picked = ((xv - c.double()[best.long()]) ** 2).sum(1)
    assert bool((picked - d64 <= 1e-5 * scale).all())
    assert bool(((dist.double() - d64).abs() <= 1e-4 * scale + 1e-6).all())
    return int((best.long() != b64).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", [1, 8, 100, 128, 129])
@pytest.mark.parametrize("k", [1, 37, 64, 65, 1000, 1025])
def test_cuda_k3_tensor_cores_edges(k, d, dtype):
    """The tensor-core instance across the center tile's k edge, the
    64-feature block's d edge and a row count that is not a multiple of
    the CTA's 256 rows; e4m3 with its x_scale. The launch is counted
    under the tensor-core instance."""
    dev = _cuda()
    n = 777
    g = torch.Generator(device=dev).manual_seed(k * 131 + d)
    c = torch.randn(k, d, generator=g, device=dev)
    if dtype == torch.bfloat16:
        x, s = torch.randn(n, d, generator=g, device=dev).to(dtype), None
    else:
        x, s, _ = _fp8_codes(n, d, k + d, dev)
        c = c * float((x.float() * s).abs().max().clamp(min=1.0)) * 0.3
    before = dict(tk.kmeans_assign.launches_by_instance)
    _k3_holds(x, c, s)
    after = tk.kmeans_assign.launches_by_instance
    assert after[tk.TENSOR_CORE] == before[tk.TENSOR_CORE] + 2
    assert after[tk.FMA] == before[tk.FMA]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", [16, 100, 300])
def test_cuda_k3_tensor_cores_near_ties(d, dtype):
    """Centers in pairs c and c + delta, delta ~ 1e-6: float32 rounding
    decides which of a pair wins, and every pick stays within the 1e-5
    rule (the rows with another argmin than float64's are counted, not
    forbidden). d = 300 stages X per feature block."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(d)
    base = torch.randn(50, d, generator=g, device=dev)
    c = torch.stack([base, base + 1e-6 * torch.randn(
        50, d, generator=g, device=dev)], 1).reshape(100, d)
    pick = torch.randint(0, 100, (3001,), generator=g, device=dev)
    xv = c[pick] + 0.3 * torch.randn(3001, d, generator=g, device=dev)
    if dtype == torch.bfloat16:
        x, s = xv.to(dtype), None
    else:
        from cycloneml_tpu_torch.dataset.instance import quantize_fp8
        x, s, _ = quantize_fp8(xv)
        s = torch.as_tensor(s, dtype=torch.float32, device=dev)
    _k3_holds(x, c, s)


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("d", [16, 128, 300])
def test_cuda_k3_tensor_cores_pick_what_the_fma_instance_picks(d, scaled):
    """Every row's pick and every re-decided distance of the tensor-core
    instance is the FMA instance's on the same values (float32 X; with
    x_scale, e4m3 codes against their float32 copy and the same scale):
    rows whose two least distances lie within the products' rounding
    bound are re-decided in the FMA instance's arithmetic, and on the
    others the two agree by that bound. Centers in near-tie pairs."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(7 * d + scaled)
    base = torch.randn(60, d, generator=g, device=dev)
    c = torch.stack([base, base + 1e-6 * torch.randn(
        60, d, generator=g, device=dev)], 1).reshape(120, d)
    pick = torch.randint(0, 120, (20_011,), generator=g, device=dev)
    xv = c[pick] + 0.5 * torch.randn(20_011, d, generator=g, device=dev)
    if scaled:
        from cycloneml_tpu_torch.dataset.instance import quantize_fp8
        x, s, _ = quantize_fp8(xv)
        s = torch.as_tensor(s, dtype=torch.float32, device=dev)
    else:
        x, s = xv.to(torch.bfloat16), None
    best, dist = tk.kmeans_assign(x, c, x_scale=s)
    fbest, fdist = tk.kmeans_assign(x.float(), c, x_scale=s)
    torch.cuda.synchronize()
    assert torch.equal(best, fbest)
    assert bool((dist >= 0).all())
    _k3_holds(x, c, s)


@pytest.mark.gpu
def test_cuda_k3_f32_takes_the_fma_instance():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(500, 100, generator=g, device=dev)
    c = torch.randn(37, 100, generator=g, device=dev)
    before = dict(tk.kmeans_assign.launches_by_instance)
    _k3_holds(x, c)
    after = tk.kmeans_assign.launches_by_instance
    assert after[tk.FMA] == before[tk.FMA] + 2
    assert after[tk.TENSOR_CORE] == before[tk.TENSOR_CORE]


def _k4_holds(x, w, x_scale=None):
    """K4 at chip_smoke.py's tolerances: |dG_ij| <= 1e-4 sqrt(G_ii G_jj)
    against float64 on the same values, G == G^T bitwise, two launches
    bitwise equal."""
    got = tk.gramian(x, w, x_scale=x_scale)
    again = tk.gramian(x, w, x_scale=x_scale)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got, got.T)
    ref = tk.gramian_plain(x, w, acc_dtype=torch.float64, x_scale=x_scale)
    diag = torch.sqrt(torch.outer(ref.diagonal(), ref.diagonal()))
    assert bool(((got.double() - ref).abs() <= 1e-4 * diag + 1e-6).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", [1, 127, 128, 129, 777, 2000])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_k4_tensor_cores_edges(masked, d, dtype):
    """The tensor-core instance across the 128-column tile's edge, ragged
    rows (d = 127, 129, 777: strides that are not 16-byte aligned, for
    bf16 and e4m3) and a row count that is not a multiple of the 64-row
    stage, with and without a third of the rows masked by w = 0; e4m3 with
    its x_scale. The launch is counted under the tensor-core instance."""
    dev = _cuda()
    n = 2_000 if d == 2000 else 5_003
    if dtype == torch.bfloat16:
        g = torch.Generator(device=dev).manual_seed(n + d)
        x, s = torch.randn(n, d, generator=g, device=dev).to(dtype), None
    else:
        x, s, _ = _fp8_codes(n, d, n + 7 * d, dev)
    w = ((torch.arange(n, device=dev) % 3 != 2).float() if masked
         else None)
    before = dict(tk.gramian.launches_by_instance)
    _k4_holds(x, w, s)
    after = tk.gramian.launches_by_instance
    assert after[tk.TENSOR_CORE] == before[tk.TENSOR_CORE] + 2
    assert after[tk.FMA] == before[tk.FMA]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_cuda_tensor_cores_misaligned_base(dtype):
    """X whose base address is not 16-byte aligned (a view 1 element into
    its buffer) at d = 128, where the rows' stride would allow vector
    loads: K3 and K4 take the element-wise path and still hold."""
    dev = _cuda()
    n, d = 1_001, 128
    g = torch.Generator(device=dev).manual_seed(17)
    flat = torch.randn(n * d + 1, generator=g, device=dev).to(dtype)
    x = flat[1:].view(n, d)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    _k4_holds(x, None)
    _k3_holds(x, torch.randn(65, d, generator=g, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", [7_168, 10_000, 20_000])
def test_cuda_k3_tensor_cores_wide_rows(d, dtype):
    """Rows wider than the re-decision's shared-memory tile (7,168
    features a row): near-tie pairs mark rows for the re-decision, which
    stages them in feature tiles; every pick is the FMA instance's, and
    the launch holds at chip_smoke.py's tolerances."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(d)
    base = torch.randn(19, d, generator=g, device=dev)
    c = torch.stack([base, base + 1e-6 * torch.randn(
        19, d, generator=g, device=dev)], 1).reshape(38, d)
    pick = torch.randint(0, 38, (2_001,), generator=g, device=dev)
    xv = c[pick] + 0.05 * torch.randn(2_001, d, generator=g, device=dev)
    if dtype == torch.bfloat16:
        x, s = xv.to(dtype), None
    else:
        from cycloneml_tpu_torch.dataset.instance import quantize_fp8
        x, s, _ = quantize_fp8(xv)
        s = torch.as_tensor(s, dtype=torch.float32, device=dev)
    best, _ = tk.kmeans_assign(x, c, x_scale=s)
    fbest, _ = tk.kmeans_assign(x.float(), c, x_scale=s)
    torch.cuda.synchronize()
    assert torch.equal(best, fbest)
    _k3_holds(x, c, s)


def _gramian_plan(d, n):
    import ctypes
    tiles, splits = ctypes.c_int(0), ctypes.c_int(0)
    assert tk._library("gramian").gramian_plan(
        d, n, ctypes.byref(tiles), ctypes.byref(splits)) == 0
    return tiles.value, splits.value


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 129, 777, 2000])
def test_cuda_k4_scratch_does_not_grow_with_n(d):
    """The plan's CTAs, one (128, 128) double partial each, stay within 16
    waves of one CTA per SM for any row count, and each split holds at
    least a fold of 1024 rows where there are that many."""
    dev = _cuda()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (0, 1_000, 5_003, 400_000, 10_000_000, 10**9, 10**12):
        tiles, splits = _gramian_plan(d, n)
        assert splits >= 1 and tiles * splits <= max(16 * sms, tiles)
        assert splits <= max(1, n // 1024)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
@pytest.mark.parametrize("d", [129, 256])
def test_cuda_k4_splits_of_many_windows(d, dtype):
    """Splits of more than one 32,768-row window: each CTA adds several
    windows' float32 sums into its double partial. Ragged (d = 129) and
    aligned rows, a third of them masked, at chip_smoke.py's
    tolerances."""
    dev = _cuda()
    n = 2_000_003
    tiles, splits = _gramian_plan(d, n)
    assert n / splits > 32_768  # every split walks more than one window
    if dtype == torch.bfloat16:
        g = torch.Generator(device=dev).manual_seed(d)
        x, s = torch.randn(n, d, generator=g, device=dev).to(dtype), None
    else:
        x, s, _ = _fp8_codes(n, d, d, dev)
    w = (torch.arange(n, device=dev) % 3 != 2).float()
    _k4_holds(x, w, s)
