"""Kernel K1 (the GLM sweep) of the PyTorch port against the JAX package.

On the CPU the wrapper runs the kernel's plain version (float32 sums); it is
held against the reference's Pallas kernel run with ``interpret=True``, with
the tolerances of tests/test_pallas_ops.py (loss rtol 1e-5 and grad 1e-4 for
f32 X; 1e-3 and 5e-3 for bf16 X). The CUDA kernel itself is held against
the plain version in float64 by the ``gpu``-marked test, on the card; the
machine with the card has no jax, so the reference is imported inside the
tests that use it and the card's command skips tests/conftest.py:

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
