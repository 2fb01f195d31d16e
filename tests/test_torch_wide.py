"""K1, K2 and K1s past d = 2,048 (their wide instances), and the fits that
reach them, against the JAX package.

The reference's ``_run_glm`` takes any d; the port's narrow instances end
at 2,048 columns, its wide instances (``csrc/glm_sweep.cu``: a row's slots
over a CTA's 512 threads, up to 12,288; ``csrc/glm_stacked.cu``: the
columns over a cluster of CTAs, up to 8,192) read X once, and the
two-pass instances take the rest (and K1s's float32 X past 2,048). On the CPU each wrapper
runs its plain version, held here against the reference's Pallas kernel
in interpret mode (K1/K2) and its ``jax.vmap`` (K1s) at d = 2,304 and
3,000, with the tolerances of tests/test_torch_kernels.py and
tests/test_torch_stacked.py; the wide instance's summation order is
emulated in float32 and held to float64 and to the reference; the fits that reach the wide instances on the card
(binomial LogisticRegression, LinearRegression with l-bfgs or with ``auto``
past 4,096 columns, OneVsRest) match the reference's iteration and
evaluation counts in float64 at those widths. Under ``cyclone.oocore.
mode=force`` an explicit normal solver raises before any spill, as the
reference's does (the streamed fits themselves are held in
tests/test_torch_oocore.py). The ``gpu`` tests hold
the wide instances on the card against their plain versions in float64
(the machine with the card has no jax):

    python -m pytest --noconftest -m gpu tests/test_torch_wide.py
"""

import functools
import re

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import (LogisticRegression,
                                                   OneVsRest)
from cycloneml_tpu_torch.ml.regression import LinearRegression
from cycloneml_tpu_torch.ops import kernels as tk

TOL = {"float32": dict(loss=1e-5, grad=1e-4),
       "bfloat16": dict(loss=1e-3, grad=5e-3)}
F8 = torch.float8_e4m3fn
WIDE_DS = (2304, 3000)


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


def _both(x, dtype):
    """The same X values for both packages (bf16 rounding done once, by
    ml_dtypes)."""
    if dtype == "bfloat16":
        import ml_dtypes
        xj = np.asarray(x, dtype=ml_dtypes.bfloat16)
        return xj, torch.from_numpy(xj.astype(np.float32)).to(torch.bfloat16)
    return x, torch.from_numpy(np.asarray(x, np.float32))


def _wide_data(d, n=384, seed=0, k=None):
    """X (n, d), labels (n,) or (n, k), w with every fifth row at 0, and
    standardization vectors; coefficients at 1/sqrt(d) keep the margins
    O(1)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = (rng.rand(n) > 0.4) if k is None else (rng.rand(n, k) > 0.4)
    w = rng.rand(n) + 0.5
    w[::5] = 0.0
    inv_std = rng.rand(d) + 0.5
    mu = rng.randn(d) * 0.3
    return x, y.astype(np.float64), w, inv_std, mu, rng


# -- the routing -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, F8])
def test_instance_by_width(dtype):
    """K1 and K2: d <= 2,048 takes the narrow instance, d <= 12,288 the
    wide one (one read of X), past it the two-pass one, in every dtype the
    kernels read; other dtypes and empty rows raise."""
    for d in (1, 37, 1280, 2000, 2048):
        assert tk.glm_sweep_instance(dtype, d) == tk.NARROW
    for d in (2049, 3072, 4096, 4097, 5000, 8192, 8193, 10_000, 12_288):
        assert tk.glm_sweep_instance(dtype, d) == tk.WIDE
    for d in (12_289, 16_384, 100_000):
        assert tk.glm_sweep_instance(dtype, d) == tk.TWO_PASS
    assert (tk.NARROW_MAX_D, tk.WIDE_MAX_D, tk.STACKED_WIDE_MAX_D) == (
        2048, 12_288, 8192)
    with pytest.raises(ValueError, match="at least one column"):
        tk.glm_sweep_instance(dtype, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, F8])
def test_stacked_instance_by_width(dtype):
    """K1s: narrow up to 2,048 columns; past it the wide tensor-core
    instance (a cluster of CTAs) up to 8,192 for bf16 X and e4m3 codes,
    the two-pass instance past 8,192 and for float32 X at every wide d."""
    for d in (1, 1280, 2048):
        assert tk.glm_sweep_instance(dtype, d, stacked=True) == tk.NARROW
    wide = tk.WIDE if tk.INSTANCE[dtype] == tk.TENSOR_CORE else tk.TWO_PASS
    for d in (2049, 3072, 4096, 4097, 8192):
        assert tk.glm_sweep_instance(dtype, d, stacked=True) == wide
    for d in (8193, 12_288, 16_384):
        assert tk.glm_sweep_instance(dtype, d, stacked=True) == tk.TWO_PASS


def test_instance_refuses_other_dtypes():
    with pytest.raises(ValueError, match="no kernel reads"):
        tk.glm_sweep_instance(torch.float64, 4096)


def test_cpu_tensors_launch_nothing_at_any_width():
    """A wide CPU X runs the plain versions: no count moves."""
    tk.reset_launch_counts()
    x, y, w, _, _, rng = _wide_data(2049, n=40)
    xt = torch.from_numpy(x.astype(np.float32))
    tk.glm_sweep(xt, _t(y).float(), _t(w).float(),
                 torch.from_numpy(rng.randn(2049).astype(np.float32)), 0.1)
    tk.glm_sweep_stacked(xt, torch.zeros(40, 3), _t(w).float(),
                         torch.zeros(3, 2049), torch.zeros(3))
    assert tk.glm_sweep.launches == tk.glm_sweep_stacked.launches == 0
    assert tk.glm_sweep.launches_by_width == {tk.NARROW: 0, tk.WIDE: 0,
                                              tk.TWO_PASS: 0}


# -- the plain versions against the reference past 2,048 columns ---------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDE_DS)
def test_plain_k1_wide_matches_pallas(ctx, d, dtype):
    from cycloneml_tpu.ops import fused_binary_logistic_scaled
    x, y, w, inv_std, mu, rng = _wide_data(d)
    coef = rng.randn(d + 1) / np.sqrt(d)
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
    np.testing.assert_allclose(float(got["count"]), float(ref["count"]),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", WIDE_DS)
def test_plain_k2_wide_matches_pallas(ctx, d, dtype):
    from cycloneml_tpu.ops import fused_least_squares_scaled
    x, _, w, inv_std, mu, rng = _wide_data(d, seed=1)
    y = x[:, :8] @ rng.randn(8) + rng.randn(len(x))
    coef = rng.randn(d) / np.sqrt(d)
    y_pars = np.array([1.3, 0.2])
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


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k1s_wide_matches_vmapped_pallas(ctx, dtype, fit_intercept):
    import jax

    from cycloneml_tpu.ops import fused_binary_logistic_scaled
    d, k = 2304, 3
    x, y, w, inv_std, mu, rng = _wide_data(d, n=256, seed=2, k=k)
    coef = rng.randn(k, d + (1 if fit_intercept else 0)) / np.sqrt(d)
    xj, xt = _both(x, dtype)
    ref = jax.vmap(functools.partial(
        fused_binary_logistic_scaled, d=d, fit_intercept=fit_intercept,
        interpret=True, row_tile=128),
        in_axes=(None, 1, None, None, None, 0))(xj, y, w, inv_std, mu, coef)
    got = tk.fused_binary_logistic_stacked_scaled(
        xt, _t(y), _t(w), _t(inv_std), _t(mu), _t(coef), d, fit_intercept)
    tol = TOL[dtype]
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(ref["loss"]),
                               rtol=tol["loss"])
    np.testing.assert_allclose(got["grad"].numpy(), np.asarray(ref["grad"]),
                               rtol=tol["grad"], atol=tol["grad"])
    np.testing.assert_allclose(got["count"].numpy(), np.asarray(ref["count"]),
                               rtol=1e-6)


# -- the wide instance's summation order, emulated ----------------------------

def _kahan_blocks(v, block):
    """Float32 sums of ``v`` (rows, lanes...) the way a wide thread or warp
    takes them: each block of ``block`` rows in plain float32 (one rounding
    a row: an FMA's product is exact), each block sum into the running sum
    by one Kahan step. Returns ``s - c`` in float64."""
    s = torch.zeros(v.shape[1:], dtype=torch.float32)
    c = torch.zeros_like(s)
    for lo in range(0, v.shape[0], block):
        b = torch.zeros_like(s)
        for t in v[lo:lo + block].double():
            b = (b.double() + t).float()
        y = b - c
        t = s + y
        c = (t - s) - y
        s = t
    return s.double() - c.double()


def _emulated_wide_sweep(x, y, w, beta, off, ys, block, ctas, group,
                         products=None):
    """K2's wide instance (one read of X) in float32 on the CPU: margins
    and the link per row in float32; tiles of ``group`` consecutive rows go
    to CTA q % ``ctas``, each CTA taking its rows in order; a CTA sums the
    gradient, the loss, sum(mult) and sum(w) in blocks of ``block`` rows
    (:func:`_kahan_blocks`; a tile holds whole blocks), and the CTAs' sums
    add in double in CTA order. ``products`` (rows, d), when given, are the
    float64 terms mult * x the gradient sums. Returns float64 ``(loss,
    grad, sum(mult), sum(w))``."""
    n, d = x.shape
    err = (x @ beta + off) - ys * y
    mult = w * err
    loss = 0.5 * w * err * err
    terms = (mult[:, None] * x if products is None else products).float()
    owner = (torch.arange(n) // group) % ctas
    grad = torch.zeros(d, dtype=torch.float64)
    scalars = [0.0, 0.0, 0.0]
    for c in range(ctas):
        rows = torch.nonzero(owner == c).flatten()
        if len(rows):
            grad += _kahan_blocks(terms[rows], block)
            for i, v in enumerate((loss, mult, w)):
                scalars[i] += float(_kahan_blocks(v[rows], block))
    return scalars[0], grad, scalars[1], scalars[2]


# the wide instance's tile rows at d = 2,304 (OnePlan in csrc/glm_sweep.cu):
# 2 for float32 X (block 1), 4 for bf16 (block 2) and e4m3 codes (block 4)
_GROUP_OF_BLOCK = {1: 2, 2: 4, 4: 4}


@pytest.mark.parametrize("block", [1, 2, 4])
def test_emulated_wide_sweep_holds(ctx, block, capsys):
    """The wide instance's order (block = 1 for float32 X, 2 for bf16, 4
    for e4m3 codes) at a least-squares point where the gradient cancels to
    <= 2e-3 of sum|mult x|. Its sums alone, on the same float32 terms
    mult * x: within 1e-5 of the largest gradient entry and within 4x the
    error of a per-row Kahan order. The whole sweep in float32: loss to
    1e-5 and sum(mult) to 1e-4 of sum(w) of float64, sum(w) exact, and the
    loss and gradient within the K2 tolerance of the reference's Pallas
    kernel on the same rows. (At this cancellation the float32 margins,
    not the order, set the gradient's error: printed.)"""
    from cycloneml_tpu.ops import fused_least_squares_scaled
    rng = np.random.RandomState(10 + block)
    n, d = 4096, 2304
    x = rng.randn(n, d).astype(np.float32).astype(np.float64)
    y = x[:, :32] @ rng.randn(32) + 0.5 * rng.randn(n)
    coef = np.linalg.lstsq(x, y, rcond=None)[0] + 5e-5 * rng.randn(d)
    x32, y32 = torch.from_numpy(x).float(), torch.from_numpy(y).float()
    beta32, w32 = torch.from_numpy(coef).float(), torch.ones(n)
    mult32 = (x32 @ beta32) - y32
    products = mult32.double()[:, None] * x32.double()
    exact = products.sum(0)
    scale = float(exact.abs().max())
    assert scale <= 2e-3 * float(products.abs().sum(0).max())

    order = {}
    group = _GROUP_OF_BLOCK[block]
    for name, blk in (("wide", block), ("row", 1)):
        g = _emulated_wide_sweep(x32, y32, w32, beta32, 0.0, 1.0, blk,
                                 ctas=132, group=group, products=products)[1]
        order[name] = float((g - exact).abs().max()) / scale
    assert order["wide"] <= 1e-5
    assert order["wide"] <= 4 * order["row"]

    t_loss, t_grad, t_m, t_w = tk.glm_sweep_plain(
        x32, y32, w32, beta32, 0.0, acc_dtype=torch.float64,
        link=tk.SQUARED, ys=1.0)
    loss, grad, msum, wsum = _emulated_wide_sweep(
        x32, y32, w32, beta32, 0.0, 1.0, block, ctas=132, group=group)
    assert abs(loss - float(t_loss)) <= 1e-5 * abs(float(t_loss))
    assert abs(msum - float(t_m)) <= 1e-4 * float(t_w)
    assert wsum == n
    ref = fused_least_squares_scaled(
        x, y, np.ones(n), np.ones(d), np.zeros(d), np.array([1.0, 0.0]),
        coef, d, interpret=True, row_tile=128)
    np.testing.assert_allclose(loss, float(ref["loss"]), rtol=1e-3)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref["grad"]),
                               rtol=5e-3, atol=5e-3 * scale)
    with capsys.disabled():
        print(f"\nblock={block}: grad error / max|grad|: order alone "
              f"{order['wide']:.3g} (per-row Kahan {order['row']:.3g}), "
              f"with float32 margins "
              f"{float((grad - t_grad).abs().max()) / scale:.3g}")


# -- fits past 2,048 columns: the reference's path in float64 ----------------

def _lr_data(n, d, seed, k=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * (rng.rand(d) * 2 + 0.2) + rng.randn(d) * 0.5
    m = min(16, d)
    if k is None:
        y = ((x[:, :m] - x[:, :m].mean(0)) @ rng.randn(m)
             + rng.randn(n) > 0).astype(np.float64)
    else:
        y = np.argmax(x[:, :m] @ rng.randn(m, k) + rng.randn(n, k),
                      axis=1).astype(np.float64)
    return x, y


def _same_counts_and_model(ref, got, rtol=1e-8):
    assert got.summary.total_iterations == ref.summary.total_iterations
    assert got.summary.total_evals == ref.summary.total_evals
    np.testing.assert_allclose(got.summary.objective_history,
                               ref.summary.objective_history, rtol=rtol)
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients), rtol=rtol,
                               atol=1e-10)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=rtol,
                               atol=1e-10)


def test_f64_wide_lr_matches_reference(ctx, pctx):
    from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
    from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
    x, y = _lr_data(256, 2304, 30)
    kw = dict(maxIter=15, regParam=0.05, tol=1e-9)
    ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    _same_counts_and_model(ref, got)
    assert got.summary.total_dispatches == ref.summary.total_dispatches


@pytest.mark.parametrize("d,kw", [
    (2304, dict(solver="l-bfgs", regParam=0.05)),
    (4100, dict(regParam=0.05))])   # auto past 4,096 columns: l-bfgs
def test_f64_wide_linreg_matches_reference(ctx, pctx, monkeypatch, d, kw):
    """The reference's summary carries no evaluation count: its loss
    function's own count is read through a recording subclass."""
    from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
    from cycloneml_tpu.ml.regression import LinearRegression as JaxLinReg
    from cycloneml_tpu.ml.regression import linear_regression as jlr
    made = []

    class Recording(jlr.DistributedLossFunction):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(jlr, "DistributedLossFunction", Recording)
    rng = np.random.RandomState(31)
    x = rng.randn(192, d) * (rng.rand(d) + 0.3)
    y = x[:, :12] @ rng.randn(12) + 0.3 * rng.randn(192) + 1.0
    kw = dict(kw, maxIter=12, tol=1e-10)
    ref = JaxLinReg(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LinearRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    assert len(made) == 1  # the quasi-Newton path, not the normal solver
    ref.summary.total_evals = made[0].n_evals
    _same_counts_and_model(ref, got)


def test_f64_wide_ovr_matches_reference(ctx, pctx):
    """Three classes at d = 2,304, stacked (parallelism=3): each model's
    iterations and evaluations as the reference's, coefficients to 1e-8,
    the same predictions."""
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
    from cycloneml_tpu.ml.classification import OneVsRest as JaxOvR
    x, y = _lr_data(240, 2304, 32, k=3)
    kw = dict(maxIter=10, tol=0.0, regParam=0.05)
    cols = {"features": x, "label": y}
    jf, pf = JaxFrame(ctx, dict(cols)), MLFrame(pctx, dict(cols))
    ref = JaxOvR(classifier=JaxLR(**kw), parallelism=3).fit(jf)
    got = OneVsRest(classifier=LogisticRegression(**kw),
                    parallelism=3).fit(pf)
    assert got.num_classes == ref.num_classes == 3
    for mg, mr in zip(got.models, ref.models):
        assert mg.summary.total_iterations == mr.summary.total_iterations
        assert mg.summary.total_evals == mr.summary.total_evals
        np.testing.assert_allclose(mg._coef, mr._coef, rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(mg._icpt, mr._icpt, rtol=1e-8,
                                   atol=1e-10)
    np.testing.assert_array_equal(got.transform(pf)["prediction"], np.asarray(
        ref.transform(jf)["prediction"]))


# -- cyclone.oocore.mode=force (the streamed fits are test_torch_oocore.py's) --

def test_force_mode_refuses_the_normal_solver_first(ctx, pctx):
    """An explicit solver='normal' under force raises the reference's
    ValueError before anything else, as the reference's own check does
    (before any spill)."""
    from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
    from cycloneml_tpu.ml.regression import LinearRegression as JaxLinReg
    x, y = _lr_data(60, 5, 35)
    pctx.conf.set("cyclone.oocore.mode", "force")
    ctx.conf.set("cyclone.oocore.mode", "force")
    try:
        with pytest.raises(ValueError, match="in-core dataset") as ref:
            JaxLinReg(solver="normal").fit(JaxDataset.from_numpy(ctx, x, y))
    finally:
        ctx.conf.set("cyclone.oocore.mode", "auto")
    with pytest.raises(ValueError, match="in-core dataset") as got:
        LinearRegression(solver="normal").fit(
            interop.dataset_from_numpy(x, y))
    assert str(got.value) == str(ref.value)


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# rows past whole rounds of tiles at the most CTAs (the two-pass margin
# pass's 132 SMs x 4 CTAs x 8 warps x 4 rows, 32 rounds of the wide
# instance's 132 CTAs x 4 rows, plus 5), few rows, and a middle count; the
# widths of the wide instance's three thread shapes (E = 8, 16, 24) and of
# the two-pass instance past 12,288
_RAGGED_ROWS = 132 * 4 * 8 * 4 + 5
_WIDE_SHAPES = [(n, d) for d in (2049, 3072, 4096, 5000, 8192, 8193, 10_000,
                                  12_288, 12_289)
                for n in (3, 1003, _RAGGED_ROWS)]


def _wide_holds(x, y, w, beta, off, link=tk.LOGISTIC, ys=0.0, x_scale=None):
    """The CUDA sweep against its plain version in float64 on the same
    card (the narrow instance's bounds: loss 1e-5 relative, grad 1e-4 of
    its largest entry, sum(mult) 1e-4 of sum(w), sum(w) exact), two
    launches bitwise equal, counted under the link, X's dtype and the
    instance of its width (wide to 12,288, two-pass past it)."""
    n, d = x.shape
    inst = tk.glm_sweep_instance(x.dtype, d)
    assert inst == (tk.WIDE if d <= 12_288 else tk.TWO_PASS)
    before = dict(tk.glm_sweep.launches_by_width)
    out = tk.glm_sweep(x, y, w, beta, off, link=link, ys=ys, x_scale=x_scale)
    again = tk.glm_sweep(x, y, w, beta, off, link=link, ys=ys,
                         x_scale=x_scale)
    torch.cuda.synchronize()
    assert tk.glm_sweep.launches_by_width == {
        **before, inst: before[inst] + 2}
    tl, tg, tm, tw = tk.glm_sweep_plain(x, y, w, beta, off,
                                        acc_dtype=torch.float64, link=link,
                                        ys=ys, x_scale=x_scale)
    loss, grad, msum, wsum = out
    assert abs(float(loss) - float(tl)) <= 1e-5 * abs(float(tl))
    assert float((grad.double() - tg).abs().max()) <= \
        1e-4 * float(tg.abs().max()) + 1e-6
    assert abs(float(msum) - float(tm)) <= 1e-4 * float(tw)
    assert float(wsum) == float(tw) == n
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.gpu
@pytest.mark.parametrize("link", [tk.LOGISTIC, tk.SQUARED])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", _WIDE_SHAPES)
def test_cuda_wide_sweep_matches_plain(n, d, dtype, link):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n * 13 + d)
    x = torch.randn(n, d, generator=g, device=dev).to(dtype)
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    y = ((torch.rand(n, generator=g, device=dev) > 0.5).float()
         if link == tk.LOGISTIC else torch.randn(n, generator=g, device=dev))
    w = torch.ones(n, device=dev)
    _wide_holds(x, y, w, beta, torch.tensor(0.25, device=dev), link=link,
                ys=torch.tensor(0.7, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("link", [tk.LOGISTIC, tk.SQUARED])
@pytest.mark.parametrize("n,d", _WIDE_SHAPES)
def test_cuda_wide_fp8_sweep_matches_plain(n, d, link, scaled):
    from cycloneml_tpu_torch.dataset.instance import quantize_fp8
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(n + 7 * d)
    spread = torch.rand(d, generator=g, device=dev) * 4 + 0.1
    x8, scale, _ = quantize_fp8(torch.randn(n, d, generator=g, device=dev)
                                * spread)
    s = torch.as_tensor(scale, dtype=torch.float32, device=dev) \
        if scaled else None
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5
    if not scaled:
        beta = beta / 448.0
    y = ((torch.rand(n, generator=g, device=dev) > 0.5).float()
         if link == tk.LOGISTIC else torch.randn(n, generator=g, device=dev))
    _wide_holds(x8, y, torch.ones(n, device=dev), beta,
                torch.tensor(0.25, device=dev), link=link,
                ys=torch.tensor(0.7, device=dev), x_scale=s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, F8])
@pytest.mark.parametrize("d", [2049, 4096, 5000, 8192, 8193, 12_288, 12_289])
def test_cuda_wide_sweep_misaligned_base_and_dead_rows(d, dtype):
    """X a contiguous view one element into a flat buffer (element-wise
    loads) with a third of the rows at w = 0."""
    dev = _cuda()
    n = _RAGGED_ROWS
    g = torch.Generator(device=dev).manual_seed(d)
    flat = torch.randn(n * d + 1, generator=g, device=dev).clamp(-400, 400)
    x = flat.to(dtype)[1:].view(n, d)
    beta = torch.randn(d, generator=g, device=dev) / d ** 0.5 / (
        448.0 if dtype == F8 else 1.0)
    y = (torch.rand(n, generator=g, device=dev) > 0.5).float()
    w = (torch.arange(n, device=dev) % 3 != 2).float()
    out = tk.glm_sweep(x, y, w, beta, 0.1)
    torch.cuda.synchronize()
    tl, tg, tm, tw = tk.glm_sweep_plain(x, y, w, beta, 0.1,
                                        acc_dtype=torch.float64)
    assert abs(float(out[0]) - float(tl)) <= 1e-5 * abs(float(tl))
    assert float((out[1].double() - tg).abs().max()) <= \
        1e-4 * float(tg.abs().max()) + 1e-6
    assert float(out[3]) == float(tw)


def _k1s_inputs(n, d, k, seed, dev, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=dev)
    y = (torch.rand(n, k, generator=g, device=dev) > 0.5).float()
    w = (torch.arange(n, device=dev) % 3 != 2).float()  # a third at w=0
    b = torch.randn(k, d, generator=g, device=dev) / d ** 0.5
    off = torch.randn(k, generator=g, device=dev) * 0.3
    return x.to(dtype), y, w, b, off


def _assert_k1s(got, truth, n_w):
    loss, grad, msum, wsum = got
    tl, tg, tm, _ = truth
    for kk in range(loss.shape[0]):
        assert abs(float(loss[kk]) - float(tl[kk])) <= \
            1e-5 * abs(float(tl[kk]))
        assert float((grad[kk].double() - tg[kk]).abs().max()) <= \
            1e-4 * float(tg[kk].abs().max()) + 1e-6
        assert abs(float(msum[kk]) - float(tm[kk])) <= 1e-4 * n_w
    assert float(wsum) == n_w


# every branch of the wide tensor-core K1s: clusters of 4 CTAs (d <= 4,096)
# and 8, slices of three and four k-blocks a warp (2049, 3072, 5000: three;
# 4096, 8192: four), and the two-pass instance past 8,192
_K1S_SHAPES = [(5, 2049), (1003, 3072), (2049, 4096), (777, 5000),
               (517, 8192), (300, 8193)]
_K1S_MODELS = [1, 2, 3, 8, 10, 16, 17]


@pytest.mark.gpu
@pytest.mark.parametrize("k", _K1S_MODELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", _K1S_SHAPES)
def test_cuda_wide_k1s_matches_plain(n, d, dtype, k):
    """The wide K1s against its plain version in float64, one launch per
    group (16 models a launch, 8 on the two-pass tensor-core instance past
    8,192), counted under its instance, two launches bitwise equal."""
    dev = _cuda()
    x, y, w, b, off = _k1s_inputs(n, d, k, n * 3 + d + k, dev, dtype)
    group = tk.glm_sweep_stacked_group(dtype, d)
    inst = tk.glm_sweep_instance(dtype, d, stacked=True)
    assert group == (8 if d > 8192 and dtype != torch.float32 else 16)
    before = dict(tk.glm_sweep_stacked.launches_by_width)
    got = tk.glm_sweep_stacked(x, y, w, b, off)
    again = tk.glm_sweep_stacked(x, y, w, b, off)
    torch.cuda.synchronize()
    assert tk.glm_sweep_stacked.launches_by_width == {
        **before, inst: before[inst] + 2 * -(-k // group)}
    truth = tk.glm_sweep_stacked_plain(x, y, w, b, off,
                                       acc_dtype=torch.float64)
    _assert_k1s(got, truth, float(w.sum()))
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("k", _K1S_MODELS)
@pytest.mark.parametrize("n,d", [(1003, 2049), (2049, 3072), (517, 4096),
                                 (777, 5000), (777, 8192), (300, 8193)])
def test_cuda_wide_k1s_e4m3_codes_with_scale(n, d, k):
    """e4m3 codes with x_scale and bf16 labels on the wide tensor-core
    instance (and the two-pass one past 8,192), against float64 on the
    dequantized values."""
    from cycloneml_tpu_torch.dataset.instance import quantize_fp8
    dev = _cuda()
    x, y, w, b, off = _k1s_inputs(n, d, k, n + d + k, dev, torch.float32)
    x8, scale, _ = quantize_fp8(x)
    s32 = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    s64 = torch.as_tensor(scale, dtype=torch.float64, device=dev)
    yb = y.to(torch.bfloat16)
    got = tk.glm_sweep_stacked(x8, yb, w, b, off, x_scale=s32)
    again = tk.glm_sweep_stacked(x8, yb, w, b, off, x_scale=s32)
    torch.cuda.synchronize()
    truth = tk.glm_sweep_stacked_plain(x8, yb, w, b, off,
                                       acc_dtype=torch.float64, x_scale=s64)
    _assert_k1s(got, truth, float(w.sum()))
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [3001, 6001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wide_k1s_misaligned_base_and_label_stride(dtype, d):
    dev = _cuda()
    n, k = 3001, 5
    x, y, w, b, off = _k1s_inputs(n, d, 2 * k, 23, dev, dtype)
    flat = torch.empty(n * d + 1, dtype=dtype, device=dev)
    xo = flat[1:].view(n, d)
    xo.copy_(x)
    ys = y[:, 3:3 + k]
    got = tk.glm_sweep_stacked(xo, ys, w, b[:k], off[:k])
    torch.cuda.synchronize()
    truth = tk.glm_sweep_stacked_plain(x, ys, w, b[:k], off[:k],
                                       acc_dtype=torch.float64)
    _assert_k1s(got, truth, float(w.sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [3072, 8192])
def test_cuda_two_pass_at_one_read_widths_holds_and_counts(d):
    """The two-pass instances launched where the one-read ones route
    (``_sweep``/``_stacked`` with TWO_PASS, as the scripts time them
    beside each other) agree with the plain versions in float64 and count
    every launch as two-pass where it is made: one K1 sweep, and K1s's 10
    models in groups of 8 and 2."""
    dev = _cuda()
    n = 1003
    x, y, w, b, off = _k1s_inputs(n, d, 10, 5 * n + d, dev, torch.bfloat16)
    before = dict(tk.glm_sweep.launches_by_width)
    got = tk._sweep(x, y[:, 0].contiguous(), w, b[0], off[0], tk.LOGISTIC,
                    0.0, None, tk.TWO_PASS)
    torch.cuda.synchronize()
    assert tk.glm_sweep.launches_by_width == {
        **before, tk.TWO_PASS: before[tk.TWO_PASS] + 1}
    tl, tg, tm, tw = tk.glm_sweep_plain(x, y[:, 0], w, b[0].double(),
                                        off[0], acc_dtype=torch.float64)
    assert abs(float(got[0]) - float(tl)) <= 1e-5 * abs(float(tl))
    assert float((got[1].double() - tg).abs().max()) <= \
        1e-4 * float(tg.abs().max()) + 1e-6
    assert abs(float(got[2]) - float(tm)) <= 1e-4 * float(tw)
    assert float(got[3]) == float(tw)
    before = dict(tk.glm_sweep_stacked.launches_by_width)
    got = tk._stacked(x, y, w, b, off, None, tk.TWO_PASS, 8)
    torch.cuda.synchronize()
    assert tk.glm_sweep_stacked.launches_by_width == {
        **before, tk.TWO_PASS: before[tk.TWO_PASS] + 2}
    truth = tk.glm_sweep_stacked_plain(x, y, w, b, off,
                                       acc_dtype=torch.float64)
    _assert_k1s(got, truth, float(w.sum()))


@pytest.mark.gpu
def test_cuda_narrow_plans_and_groups_are_unchanged():
    """Up to d = 2,048 the plans and groups are the narrow instances' (the
    parent's values); past it the wide instance's plan (one read: a CTA of
    512 threads, tiles of whole blocks; up to 12,288 columns) and K1s's
    group of 16 (up to 8,192), and the two-pass instance's plan and groups
    past them."""
    _cuda()
    # the pure-Python routing's bounds are the kernels' own
    sweep, stacked = tk._library("glm_sweep"), tk._library("glm_stacked")
    assert sweep.glm_sweep_max_d() == tk.NARROW_MAX_D
    assert stacked.glm_stacked_max_d() == tk.NARROW_MAX_D
    assert tk._entry(sweep, "glm_sweep_wide_max_d", [])() == tk.WIDE_MAX_D
    assert tk._entry(stacked, "glm_stacked_wide_max_d", [])() == \
        tk.STACKED_WIDE_MAX_D
    for dt in (torch.bfloat16, F8):
        assert tk.glm_sweep_stacked_group(dt, 1280) == 16
        assert tk.glm_sweep_stacked_group(dt, 2048) == 8
        for d in (2049, 3072, 4096, 4097, 8192):
            assert tk.glm_sweep_stacked_group(dt, d) == 16
        assert tk.glm_sweep_stacked_group(dt, 8193) == 8
    for d in (2048, 4096, 8192, 8193):
        assert tk.glm_sweep_stacked_group(torch.float32, d) == 16
    narrow = tk.glm_sweep_plan(torch.bfloat16, tk.LOGISTIC, 1280)
    assert set(narrow) == {"stages", "block_rows", "smem_bytes",
                           "ctas_per_sm"}
    for dt, d, block, group in ((torch.float32, 4096, 1, 2),
                                (torch.float32, 8192, 1, 1),
                                (torch.bfloat16, 4096, 2, 4),
                                (torch.float32, 12_288, 1, 1),
                                (torch.bfloat16, 8192, 2, 2),
                                (torch.bfloat16, 12_288, 2, 2),
                                (F8, 4096, 4, 4), (F8, 8192, 4, 4),
                                (F8, 12_288, 4, 4)):
        wide = tk.glm_sweep_plan(dt, tk.LOGISTIC, d)
        assert wide["instance"] == tk.WIDE and wide["threads"] == 512
        assert (wide["block_rows"], wide["group_rows"]) == (block, group)
        assert wide["stages"] >= 4 and wide["ctas_per_sm"] == 1
    two = tk.glm_sweep_plan(torch.bfloat16, tk.SQUARED, 12_289)
    assert two["instance"] == tk.TWO_PASS and two["block_rows"] == 2
    assert two["margin_ctas_per_sm"] >= 1 and \
        two["gradient_ctas_per_sm"] >= 1


def _spills(name):
    """ptxas's spill line of every kernel of the build of ``name``."""
    from cycloneml_tpu_torch.ops import build
    tk._library(name)
    spills, func = {}, None
    for ln in build.ptxas_report(name).read_text().splitlines():
        if "Compiling entry function" in ln:
            func = ln.split("'")[1]
        elif func and "spill stores" in ln:
            spills[func] = ln.split(":")[-1].strip()
    return spills


@pytest.mark.gpu
def test_cuda_wide_k1s_kernels_do_not_spill():
    """The two-pass K1s kernels (tensor-core margin and gradient passes for
    bf16 and e4m3, FMA passes at KG = 8 and 16) report 0 spill bytes."""
    _cuda()
    wide = {f: s for f, s in _spills("glm_stacked").items()
            if "glm_wide_" in f and "reduce" not in f}
    assert len(wide) == 8
    bad = {f: s for f, s in wide.items()
           if "0 bytes spill stores, 0 bytes spill loads" not in s}
    assert not bad, bad


@pytest.mark.gpu
def test_cuda_one_read_wide_kernels_do_not_spill():
    """The one-read wide instances report 0 spill bytes: K1/K2's 18
    (3 dtypes x 2 links x E = 8, 16, 24) and K1s's 16 cluster instances
    (bf16 and e4m3 x KG = 8, 16 x three or four k-blocks a warp x clusters
    of 4 and 8)."""
    _cuda()
    sweep = {f: s for f, s in _spills("glm_sweep").items()
             if "glm_sweep_wide_kernel" in f}
    # a cluster instance's last template argument (its CTAs) is 4 or 8
    cluster = {f: s for f, s in _spills("glm_stacked").items()
               if "glm_stacked_tc_kernel" in f
               and re.search(r"Li[48]EEEv", f)}
    assert (len(sweep), len(cluster)) == (18, 16)
    bad = {f: s for f, s in {**sweep, **cluster}.items()
           if "0 bytes spill stores, 0 bytes spill loads" not in s}
    assert not bad, bad
