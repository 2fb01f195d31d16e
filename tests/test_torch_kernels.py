"""Kernels K1-K4 of the PyTorch port against the JAX package.

On the CPU each wrapper runs its kernel's plain version (float32 sums); it
is held against the reference's Pallas kernel run with ``interpret=True``,
with the tolerances of tests/test_pallas_ops.py (K1: loss rtol 1e-5 and grad
1e-4 for f32 X, 1e-3 and 5e-3 for bf16 X; K2: 1e-3 and 5e-3; K3: equal
argmin, distances 1e-4; K4: rtol 1e-4, atol 1e-3, exact symmetry). The CUDA
kernels themselves are held against their plain versions in float64 by the
``gpu``-marked tests, on the card; the machine with the card has no jax, so
the reference is imported inside the tests that use it and the card's
command skips tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 1), (1003, 37), (4096, 256),
                                 (2049, 1000), (777, 2048)])
def test_cuda_k1_matches_plain(n, d, dtype):
    """The CUDA kernel against its plain version in float64 on the same
    card, at ragged and aligned shapes: loss to 1e-5 relative, grad to
    1e-4 of its largest entry, sum(w) exact, launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n * 7 + d)
    x = torch.randn(n, d, generator=g, device=dev).to(dtype)
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    y = (torch.rand(n, generator=g, device=dev) > 0.5).float()
    w = torch.ones(n, device=dev)
    off = torch.tensor(0.25, device=dev)
    before = tk.glm_sweep.launches
    loss, grad, msum, wsum = tk.glm_sweep(x, y, w, beta, off)
    again = tk.glm_sweep(x, y, w, beta, off)
    torch.cuda.synchronize()
    assert tk.glm_sweep.launches == before + 2
    tl, tg, tm, tw = tk.glm_sweep_plain(x, y, w, beta, off,
                                        acc_dtype=torch.float64)
    assert abs(float(loss) - float(tl)) <= 1e-5 * abs(float(tl))
    assert float((grad.double() - tg).abs().max()) <= \
        1e-4 * float(tg.abs().max()) + 1e-6
    assert abs(float(msum) - float(tm)) <= 1e-4 * float(tw)
    assert float(wsum) == n
    assert all(torch.equal(a, b) for a, b in zip((loss, grad, msum, wsum),
                                                 again))


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
@pytest.mark.parametrize("n,d", [(1, 1), (1003, 37), (2049, 1000),
                                 (777, 2000)])
def test_cuda_k2_matches_plain(n, d, dtype):
    """The squared link against its plain version in float64: loss to
    1e-5 relative, grad to 1e-4 of its largest entry, sum(w) exact,
    launches bitwise equal and counted by link."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n * 5 + d)
    x = torch.randn(n, d, generator=g, device=dev).to(dtype)
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    y = torch.randn(n, generator=g, device=dev)
    w = torch.ones(n, device=dev)
    off, ys = torch.tensor(0.25, device=dev), torch.tensor(0.7, device=dev)
    before = dict(tk.glm_sweep.launches_by_link)
    out = tk.glm_sweep(x, y, w, beta, off, link=tk.SQUARED, ys=ys)
    again = tk.glm_sweep(x, y, w, beta, off, link=tk.SQUARED, ys=ys)
    torch.cuda.synchronize()
    assert tk.glm_sweep.launches_by_link[tk.SQUARED] == \
        before[tk.SQUARED] + 2
    assert tk.glm_sweep.launches_by_link[tk.LOGISTIC] == before[tk.LOGISTIC]
    tl, tg, tm, tw = tk.glm_sweep_plain(x, y, w, beta, off,
                                        acc_dtype=torch.float64,
                                        link=tk.SQUARED, ys=ys)
    loss, grad, msum, wsum = out
    assert abs(float(loss) - float(tl)) <= 1e-5 * abs(float(tl))
    assert float((grad.double() - tg).abs().max()) <= \
        1e-4 * float(tg.abs().max()) + 1e-6
    assert abs(float(msum) - float(tm)) <= 1e-4 * float(tw)
    assert float(wsum) == n
    assert all(torch.equal(a, b) for a, b in zip(out, again))


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
