"""The port's stacked (model-axis) binomial fits against the JAX package's,
and kernel K1s against its plain version.

- K1s's plain version (``ops/kernels.glm_sweep_stacked_plain``, through
  ``fused_binary_logistic_stacked_scaled`` on CPU tensors) against the
  reference's ``jax.vmap`` of ``fused_binary_logistic_scaled`` (interpret
  mode, row_tile 128) with ``in_axes=(None, 1, None, None, None, 0)``, with
  tests/test_pallas_ops.py's K1 tolerances (loss rtol 1e-5 and grad 1e-4
  for f32 X, 1e-3 and 5e-3 for bf16 X); and against K plain K1 sweeps in
  float64 to 1e-12.
- ``LogisticRegression.fit_stacked`` in float64
  (``cyclone.compute.dtype=float64``) against the reference's on the same
  numpy data: equal per-model iteration and evaluation counts, objective
  histories within rtol 1e-10, coefficients within rtol 1e-8 / atol 1e-10
  (tests/test_torch_logistic.py's bounds); on e4m3 codes through the plain
  path, within the kernel-vs-plain bound (rtol 5e-3, atol 5e-4) of the
  reference's kernel route.
- The stacked optimizer's convergence masks (tests/test_stacked.py:213-316).
- KMeans' center sums against float64 segment sums.

The ``gpu`` tests hold K1s (every K, ragged shapes, padding rows, e4m3
codes with x_scale, K=1 against K1) and the center-sum kernel on the card;
the card's machine has no jax, so the reference is imported inside the
tests that use it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py \\
        tests/test_torch_stacked.py
"""

import functools

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import LogisticRegression
from cycloneml_tpu_torch.ml.optim import aggregators
from cycloneml_tpu_torch.ml.optim.device_lbfgs import StackedDeviceLBFGS
from cycloneml_tpu_torch.ml.optim.loss import (
    StackedDistributedLossFunction, inv_std_vector, stacked_l2_scale)
from cycloneml_tpu_torch.ml.stat import Summarizer
from cycloneml_tpu_torch.ops import kernels as tk

TOL = {"float32": dict(loss=1e-5, grad=1e-4),
       "bfloat16": dict(loss=1e-3, grad=5e-3)}
F8 = torch.float8_e4m3fn
KERNEL_BOUND = dict(rtol=5e-3, atol=5e-4)  # tests/test_pallas_ops.py


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


def _sweep_data(k, seed=42, n=300, d=37):
    """X, K label columns, w with a third of the rows at 0 (padding rows
    must stay inert), coefficients and standardization vectors."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = (rng.rand(n, k) > 0.4).astype(np.float64)
    w = rng.rand(n) + 0.5
    w[::3] = 0.0
    coef = rng.randn(k, d + 1) / np.sqrt(d)
    inv_std = rng.rand(d) + 0.5
    mu = rng.randn(d)
    return x, y, w, coef, inv_std, mu


# -- K1s: the plain version against the reference's vmapped kernel ------------

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_k1s_matches_vmapped_pallas(ctx, dtype, fit_intercept, k):
    import jax

    from cycloneml_tpu.ops import fused_binary_logistic_scaled
    x, y, w, coef, inv_std, mu = _sweep_data(k)
    d = x.shape[1]
    if not fit_intercept:
        coef = coef[:, :d]
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
    assert tk.glm_sweep_stacked.launches == 0  # CPU tensors launch nothing


def test_plain_k1s_equals_k_plain_k1_sweeps():
    """In float64 the stacked sweep is K single sweeps to 1e-12."""
    x, y, w, coef, inv_std, _ = _sweep_data(4, seed=3)
    d = x.shape[1]
    b = _t(coef[:, :d] * inv_std)
    off = _t(coef[:, d])
    loss, grad, msum, wsum = tk.glm_sweep_stacked_plain(
        _t(x), _t(y), _t(w), b, off, acc_dtype=torch.float64, chunk_rows=64)
    for kk in range(4):
        l1, g1, m1, w1 = tk.glm_sweep_plain(
            _t(x), _t(y[:, kk]), _t(w), b[kk], off[kk],
            acc_dtype=torch.float64, chunk_rows=64)
        np.testing.assert_allclose(float(loss[kk]), float(l1), rtol=1e-12)
        np.testing.assert_allclose(grad[kk].numpy(), g1.numpy(), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(float(msum[kk]), float(m1), rtol=1e-12,
                                   atol=1e-12)
        assert float(wsum) == float(w1)


def test_plain_k1s_takes_x_scale():
    """The fp8 rung's x_scale: the sweep of codes o scale, as K1's."""
    x, y, w, coef, inv_std, _ = _sweep_data(3, seed=4)
    d = x.shape[1]
    s = np.random.RandomState(5).rand(d) + 0.1
    b, off = _t(coef[:, :d]), _t(coef[:, d])
    got = tk.glm_sweep_stacked_plain(_t(x), _t(y), _t(w), b, off,
                                     torch.float64, x_scale=s)
    want = tk.glm_sweep_stacked_plain(_t(x * s), _t(y), _t(w), b, off,
                                      torch.float64)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_kernel_twin_is_one_stacked_sweep(monkeypatch):
    """The model-axis twin of the kernel aggregator makes ONE K1s call per
    evaluation and never calls K1."""
    calls = {"k1s": 0, "k1": 0}
    orig_k1s, orig_k1 = tk.glm_sweep_stacked, tk.glm_sweep

    def k1s(*a, **kw):
        calls["k1s"] += 1
        return orig_k1s(*a, **kw)

    def k1(*a, **kw):
        calls["k1"] += 1
        return orig_k1(*a, **kw)

    monkeypatch.setattr(tk, "glm_sweep_stacked", k1s)
    monkeypatch.setattr(tk, "glm_sweep", k1)
    x, y, w, coef, inv_std, mu = _sweep_data(5, seed=6)
    d = x.shape[1]
    agg = aggregators.stack_scaled_aggregator(
        aggregators.binary_logistic_pallas_scaled(d, True))
    out = agg(_both(x, "float32")[1], _t(y), _t(w), _t(inv_std), _t(mu),
              _t(coef))
    assert calls == {"k1s": 1, "k1": 0}
    assert out["loss"].shape == (5,) and out["grad"].shape == (5, d + 1)


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_plain_twin_matches_plain_aggregator_per_model(fit_intercept):
    """The batched plain twins equal the single-model aggregators."""
    x, y, w, coef, inv_std, mu = _sweep_data(3, seed=7)
    d = x.shape[1]
    if not fit_intercept:
        coef = coef[:, :d]
    for base, extra in ((aggregators.binary_logistic(d, fit_intercept), ()),
                        (aggregators.binary_logistic_scaled(
                            d, fit_intercept), (_t(inv_std), _t(mu)))):
        stacked = aggregators.stack_aggregator(base)
        out = stacked(_t(x), _t(y), _t(w), *extra, _t(coef))
        for kk in range(3):
            one = base(_t(x), _t(y[:, kk]), _t(w), *extra, _t(coef[kk]))
            for key in ("loss", "grad", "count"):
                np.testing.assert_allclose(out[key][kk].numpy(),
                                           one[key].numpy(), rtol=1e-12,
                                           atol=1e-12)
    with pytest.raises(ValueError, match="model-axis twin"):
        aggregators.stack_aggregator(aggregators.least_squares(d))


# -- fit_stacked against the reference ----------------------------------------

def _lr_data(n=400, d=6, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * (rng.rand(d) * 3) + rng.randn(d)
    y = (x @ rng.randn(d) + rng.randn(n) > 0).astype(np.float64)
    return x, y


def _assert_same_models(refs, gots):
    assert len(refs) == len(gots)
    for r, g in zip(refs, gots):
        rs, gs = r.summary, g.summary
        assert gs.n_models == rs.n_models == len(refs)
        assert gs.total_iterations == rs.total_iterations
        assert gs.total_evals == rs.total_evals
        assert gs.total_dispatches == rs.total_dispatches
        np.testing.assert_allclose(gs.objective_history,
                                   rs.objective_history, rtol=1e-10)
        np.testing.assert_allclose(g.coefficients.values,
                                   np.asarray(r.coefficients),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(g.intercept, r.intercept, rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("fit_intercept,standardization",
                         [(True, True), (False, True), (True, False)])
def test_fit_stacked_with_y_stack_matches_reference(ctx, pctx, fit_intercept,
                                                    standardization):
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
    x, y = _lr_data()
    rng = np.random.RandomState(1)
    y_stack = np.stack([y, 1 - y, (rng.rand(len(y)) > 0.5).astype(float)])
    kw = dict(maxIter=30, regParam=0.01, tol=1e-9,
              fitIntercept=fit_intercept, standardization=standardization)
    ref = JaxLR(**kw).fit_stacked(
        JaxFrame(ctx, {"features": x, "label": y}), y_stack=y_stack)
    got = LogisticRegression(**kw).fit_stacked(
        MLFrame(pctx, {"features": x, "label": y}), y_stack=y_stack)
    _assert_same_models(ref, got)


def test_fit_stacked_with_reg_params_matches_reference(ctx, pctx):
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
    x, y = _lr_data(seed=2)
    kw = dict(maxIter=30, tol=1e-9)
    regs = [0.0, 0.1, 1.0]
    ref = JaxLR(**kw).fit_stacked(
        JaxFrame(ctx, {"features": x, "label": y}), reg_params=regs)
    got = LogisticRegression(**kw).fit_stacked(
        MLFrame(pctx, {"features": x, "label": y}), reg_params=regs)
    _assert_same_models(ref, got)
    # the models differ: each has its own regParam
    assert len({round(float(m.intercept), 6) for m in got}) == 3


def test_fit_stacked_on_the_kernel_route_matches_the_plain_route(pctx):
    """usePallasKernels=true on the CPU runs K1s's plain version (float32
    sums): within the kernel-vs-plain bound of the float64 plain fit."""
    x, y = _lr_data(seed=3)
    frame = MLFrame(pctx, {"features": x, "label": y})
    kw = dict(maxIter=40, tol=1e-10)
    plain = LogisticRegression(**kw).fit_stacked(frame,
                                                 reg_params=[0.01, 0.1])
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    kern = LogisticRegression(**kw).fit_stacked(frame,
                                                reg_params=[0.01, 0.1])
    assert tk.glm_sweep_stacked.launches == 0
    for p, k in zip(plain, kern):
        np.testing.assert_allclose(k.coefficients.values,
                                   p.coefficients.values, **KERNEL_BOUND)


def test_fit_stacked_on_fp8_codes_matches_reference(ctx, pctx):
    """One stacked fit on e4m3 codes through the port's plain path against
    the reference's fp8 fit_stacked on its kernel route (the route the
    port follows, ROADMAP Queue 3): within the kernel-vs-plain bound."""
    from cycloneml_tpu.conf import USE_PALLAS_KERNELS as JAX_USE_KERNELS
    from cycloneml_tpu.dataset import instance as jinst
    from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
    from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
    rng = np.random.RandomState(25)
    x = rng.randn(600, 12) * (1.0 + np.arange(12) / 4.0) + 0.3
    y = (x @ rng.randn(12) + rng.randn(600) > 0).astype(np.float64)
    y_stack = np.stack([y, 1 - y])
    kw = dict(maxIter=50, regParam=0.01, tol=1e-10)
    ctx.conf.set("cyclone.data.dtype", "float8")
    ctx.conf.set(JAX_USE_KERNELS, "true")
    try:
        ref = JaxLR(**kw).fit_stacked(JaxDataset.from_numpy(
            ctx, x, y, dtype=jinst.data_dtype(ctx.conf, fp8_capable=True)),
            y_stack=y_stack)
    finally:
        ctx.conf.set("cyclone.data.dtype", "auto")
        ctx.conf.set(JAX_USE_KERNELS, "false")
    ds = InstanceDataset.from_numpy(pctx, x, y, dtype=F8)
    got = LogisticRegression(**kw).fit_stacked(ds, y_stack=y_stack)
    assert not pctx.precision_fallbacks
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.coefficients.values,
                                   np.asarray(r.coefficients), **KERNEL_BOUND)
        np.testing.assert_allclose(g.intercept, r.intercept, **KERNEL_BOUND)


def test_fit_stacked_rejects_what_it_cannot_fit(pctx):
    x, y = _lr_data(n=100)
    frame = MLFrame(pctx, {"features": x, "label": y})
    with pytest.raises(ValueError, match="y_stack or reg_params"):
        LogisticRegression().fit_stacked(frame)
    with pytest.raises(ValueError, match=r"labels in \{0, 1\}"):
        LogisticRegression().fit_stacked(frame, y_stack=np.stack([2 * y]))
    with pytest.raises(ValueError, match="can_fit_stacked"):
        LogisticRegression(elasticNetParam=0.5).fit_stacked(
            frame, reg_params=[0.1, 0.2])
    pctx.conf.set("cyclone.oocore.mode", "force")
    with pytest.raises(NotImplementedError, match="ROADMAP slice 6"):
        LogisticRegression().fit_stacked(frame, reg_params=[0.1, 0.2])


# -- convergence masks (tests/test_stacked.py:213-316) ------------------------

def _stacked_loss(pctx, regs):
    rng = np.random.RandomState(40)
    x = rng.randn(400, 4)
    y = (x @ rng.randn(4) + 0.5 * rng.randn(400) > 0).astype(np.float64)
    ds = MLFrame(pctx, {"features": x, "label": y}).to_instance_dataset(
        "features", "label", None)
    stats = Summarizer.summarize(ds)
    inv_std = inv_std_vector(stats.std)
    scaled_mean = stats.mean * inv_std
    d, k = ds.n_features, len(regs)
    y_pad = torch.zeros((ds.x.shape[0], k), dtype=ds.x.dtype)
    y_pad[:ds.n_rows] = torch.from_numpy(np.tile(y[:, None], (1, k)))
    agg = aggregators.stack_scaled_aggregator(
        aggregators.binary_logistic_scaled(d, True))
    loss = StackedDistributedLossFunction(
        ds.derive(y=y_pad), agg, k, reg=np.asarray(regs),
        l2_scale=stacked_l2_scale(d, d + 1), weight_sum=stats.weight_sum,
        extra_args=(_t(inv_std), _t(scaled_mean)))
    return loss, d


def test_models_freeze_at_their_own_iteration(pctx):
    regs = np.array([0.0, 0.1, 5.0])
    loss, d = _stacked_loss(pctx, regs)
    res = StackedDeviceLBFGS(max_iter=100, tol=1e-6, chunk=8).minimize(
        loss, np.zeros((3, d + 1)))
    iters = np.asarray(res.iterations)
    assert (iters > 0).all()
    assert len(set(iters.tolist())) > 1, iters
    assert all(r in ("function value converged", "gradient converged")
               for r in res.converged_reasons)
    for kk in range(3):
        assert len(res.loss_histories[kk]) == iters[kk] + 1
    evals = np.asarray(res.evals)
    assert (evals >= iters + 1).all()
    assert loss.n_evals >= int(evals.max())


def test_freeze_is_chunk_size_invariant(pctx):
    regs = np.array([0.0, 5.0])
    loss, d = _stacked_loss(pctx, regs)
    x0 = np.zeros((2, d + 1))
    a = StackedDeviceLBFGS(max_iter=100, tol=1e-6, chunk=8).minimize(loss, x0)
    b = StackedDeviceLBFGS(max_iter=100, tol=1e-6, chunk=1).minimize(loss, x0)
    np.testing.assert_array_equal(a.iterations, b.iterations)
    np.testing.assert_array_equal(a.x, b.x)
    for ha, hb in zip(a.loss_histories, b.loss_histories):
        np.testing.assert_allclose(ha, hb, rtol=0)


def test_frozen_models_stay_frozen(pctx):
    regs = np.array([0.0, 5.0])
    loss, d = _stacked_loss(pctx, regs)
    x0 = np.zeros((2, d + 1))
    full = StackedDeviceLBFGS(max_iter=100, tol=1e-6, chunk=8).minimize(
        loss, x0)
    early, late = int(np.argmin(full.iterations)), \
        int(np.argmax(full.iterations))
    assert full.iterations[early] < full.iterations[late]
    cut = StackedDeviceLBFGS(max_iter=int(full.iterations[early]), tol=1e-6,
                             chunk=8).minimize(loss, x0)
    assert int(cut.iterations[early]) == int(full.iterations[early])
    np.testing.assert_array_equal(full.x[early], cut.x[early])
    np.testing.assert_allclose(full.loss_histories[early],
                               cut.loss_histories[early], rtol=0)


def test_masks_match_the_reference_optimizer(ctx, pctx):
    """The same stacked problem through the reference's StackedDeviceLBFGS
    (on its own dataset): the same per-model iterations, evaluations and
    reasons, solutions to rtol 1e-8."""
    import jax.numpy as jnp

    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    from cycloneml_tpu.ml.optim import aggregators as jagg
    from cycloneml_tpu.ml.optim import loss as jloss
    from cycloneml_tpu.ml.optim.device_lbfgs import \
        StackedDeviceLBFGS as JaxStacked
    from cycloneml_tpu.ml.stat import Summarizer as JaxSummarizer
    regs = np.array([0.0, 0.1, 5.0])
    loss, d = _stacked_loss(pctx, regs)
    rng = np.random.RandomState(40)
    x = rng.randn(400, 4)
    y = (x @ rng.randn(4) + 0.5 * rng.randn(400) > 0).astype(np.float64)
    ds = JaxFrame(ctx, {"features": x, "label": y}).to_instance_dataset(
        "features", "label", None)
    stats = JaxSummarizer.summarize(ds)
    inv_std = jloss.inv_std_vector(stats.std)
    y_pad = np.zeros((len(ds.y_host()), 3))
    y_pad[ds.valid_indices()] = np.tile(y[:, None], (1, 3))
    jl = jloss.StackedDistributedLossFunction(
        ds.derive(y=ctx.mesh_runtime.device_put_sharded_rows(y_pad)),
        jagg.stack_scaled_aggregator(jagg.binary_logistic_scaled(d, True)),
        3, reg=regs, l2_scale=jloss.stacked_l2_scale(d, d + 1),
        weight_sum=stats.weight_sum,
        extra_args=(jnp.asarray(inv_std), jnp.asarray(stats.mean * inv_std)))
    x0 = np.zeros((3, d + 1))
    ref = JaxStacked(max_iter=100, tol=1e-6, chunk=8).minimize(jl, x0)
    got = StackedDeviceLBFGS(max_iter=100, tol=1e-6, chunk=8).minimize(
        loss, x0)
    np.testing.assert_array_equal(got.iterations, ref.iterations)
    np.testing.assert_array_equal(got.evals, ref.evals)
    assert got.converged_reasons == ref.converged_reasons
    assert loss.n_evals == jl.n_evals and loss.n_dispatches == jl.n_dispatches
    np.testing.assert_allclose(got.x, ref.x, rtol=1e-8, atol=1e-10)


# -- KMeans' center sums ------------------------------------------------------

@pytest.mark.parametrize("with_sums", [True, False])
def test_center_sums_equal_float64_segment_sums(with_sums):
    from cycloneml_tpu_torch.ml.clustering import kmeans
    rng = np.random.RandomState(8)
    n, d, k = 1000, 7, 13
    x = rng.randn(n, d)
    w = rng.rand(n)
    w[::5] = 0.0
    best = rng.randint(0, k - 1, n)  # cluster k-1 stays empty
    want_sums = np.zeros((k, d))
    want_counts = np.zeros(k)
    np.add.at(want_sums, best, x * w[:, None])
    np.add.at(want_counts, best, w)
    if with_sums:
        sums, counts = kmeans._center_sums(_t(x), _t(w),
                                           torch.from_numpy(best), k)
        np.testing.assert_allclose(sums.numpy(), want_sums, rtol=1e-12,
                                   atol=1e-12)
    else:
        sums, counts = tk.center_sums(_t(x), _t(w), torch.from_numpy(best),
                                      k, with_sums=False)
        assert sums is None
    np.testing.assert_allclose(counts.numpy(), want_counts, rtol=1e-12)
    assert counts[k - 1] == 0
    assert tk.center_sums.launches == 0


# -- on the card --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 8, 16, 17, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(1, 1), (1003, 37), (2049, 1000),
                                 (777, 2048)])
def test_cuda_k1s_matches_plain(n, d, dtype, k):
    """K1s against its plain version in float64 at ragged shapes with a
    third of the rows at w=0, every K (above K_MAX in groups): loss to
    1e-5 relative, grad to 1e-4 of its largest entry, sum(w) exact, two
    launches bitwise equal, one launch per group counted under X's
    dtype."""
    dev = _cuda()
    x, y, w, b, off = _k1s_inputs(n, d, k, n * 11 + d + k, dev, dtype)
    before = tk.glm_sweep_stacked.launches_by_dtype[dtype]
    got = tk.glm_sweep_stacked(x, y, w, b, off)
    again = tk.glm_sweep_stacked(x, y, w, b, off)
    torch.cuda.synchronize()
    groups = -(-k // tk.K_MAX)
    assert tk.glm_sweep_stacked.launches_by_dtype[dtype] == \
        before + 2 * groups
    truth = tk.glm_sweep_stacked_plain(x, y, w, b, off,
                                       acc_dtype=torch.float64)
    _assert_k1s(got, truth, float(w.sum()))
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 16, 20])
@pytest.mark.parametrize("n,d", [(1003, 37), (2049, 1000), (4096, 1280)])
def test_cuda_k1s_e4m3_codes_with_scale(n, d, k):
    """e4m3 codes with x_scale and bf16 labels (the fp8 tier's stack),
    against float64 on the dequantized values."""
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
def test_cuda_k1s_at_one_model_agrees_with_k1(dtype):
    """K=1: K1s and K1 on the same inputs, each within K1's bounds of the
    float64 truth, and within them of each other."""
    dev = _cuda()
    n, d = 50_003, 999
    x, y, w, b, off = _k1s_inputs(n, d, 1, 17, dev, torch.float32)
    x = x.to(dtype)
    stacked = tk.glm_sweep_stacked(x, y, w, b, off)
    single = tk.glm_sweep(x, y[:, 0], w, b[0], off[0])
    torch.cuda.synchronize()
    truth = tk.glm_sweep_stacked_plain(x, y, w, b, off,
                                       acc_dtype=torch.float64)
    _assert_k1s(stacked, truth, float(w.sum()))
    as_stack = tuple(t.reshape(1, -1) if t.dim() == 1 else t.reshape(1)
                     for t in single[:3])
    _assert_k1s(as_stack + (single[3],), truth, float(w.sum()))
    assert abs(float(stacked[0][0]) - float(single[0])) <= \
        2e-5 * abs(float(truth[0][0]))


@pytest.mark.gpu
def test_cuda_k1s_misaligned_base_and_label_stride():
    """X at a base 2 bytes off its alignment (the element-by-element copy)
    and labels as a column slice of a wider stack (row stride > K)."""
    dev = _cuda()
    n, d, k = 3001, 256, 5
    x, y, w, b, off = _k1s_inputs(n, d, 2 * k, 23, dev, torch.bfloat16)
    flat = torch.empty(n * d + 1, dtype=torch.bfloat16, device=dev)
    xo = flat[1:].view(n, d)
    xo.copy_(x)
    ys = y[:, 3:3 + k]
    got = tk.glm_sweep_stacked(xo, ys, w, b[:k], off[:k])
    aligned = tk.glm_sweep_stacked(x, ys.contiguous(), w, b[:k], off[:k])
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, aligned))
    truth = tk.glm_sweep_stacked_plain(x, ys, w, b[:k], off[:k],
                                       acc_dtype=torch.float64)
    _assert_k1s(got, truth, float(w.sum()))


@pytest.mark.gpu
def test_cuda_k1s_never_takes_the_plain_version():
    """A CUDA X the kernel cannot take raises; it does not fall back."""
    dev = _cuda()
    x, y, w, b, off = _k1s_inputs(10, 2049, 2, 1, dev, torch.float32)
    with pytest.raises(ValueError, match="limit"):
        tk.glm_sweep_stacked(x, y, w, b, off)
    with pytest.raises(ValueError, match="float64"):
        tk.glm_sweep_stacked(x[:, :8].double(), y, w, b[:, :8], off)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_center_sums_match_plain_and_repeat_bitwise(dtype):
    """The center-sum kernel against float64 index_add_ sums, one very
    large cluster (several pieces) and empty ones, bitwise equal across
    calls; counts exact for unit weights."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(31)
    n, d, k = 300_007, 130, 50
    x = torch.randn(n, d, generator=g, device=dev).to(dtype)
    w = torch.ones(n, device=dev)
    w[::7] = 0.0
    best = torch.randint(0, k - 3, (n,), generator=g, device=dev)
    best[: n // 2] = 0  # one cluster of ~150k rows
    before = tk.center_sums.launches
    sums, counts = tk.center_sums(x, w, best, k)
    sums2, counts2 = tk.center_sums(x, w, best, k)
    torch.cuda.synchronize()
    assert tk.center_sums.launches == before + 2
    assert torch.equal(sums, sums2) and torch.equal(counts, counts2)
    t_sums, t_counts = tk.center_sums_plain(x, w, best, k, torch.float64)
    assert torch.equal(counts.double(), t_counts)
    scale = float(t_sums.abs().max())
    assert float((sums.double() - t_sums).abs().max()) <= 1e-6 * scale
    assert float(counts[k - 1]) == 0.0 and float(sums[k - 1].abs().max()) == 0
    _, only = tk.center_sums(x, w, best, k, with_sums=False)
    assert torch.equal(only, counts)


@pytest.mark.gpu
def test_cuda_kmeans_fits_are_bitwise_equal():
    """Two KMeans fits of configuration 3's shape (d=128, k=1000, bf16
    tier; fewer rows) end with bitwise-equal centers and costs."""
    dev = _cuda()
    from cycloneml_tpu_torch.ml.clustering import KMeans
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        g = torch.Generator(device=dev).manual_seed(12)
        n, d = 400_000, 128
        x = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
        ds = InstanceDataset(ctx, x, torch.zeros(n, device=dev),
                             torch.ones(n, device=dev), n, d)
        a = KMeans(k=1000, maxIter=5, tol=1e-5, seed=3).fit(ds)
        b = KMeans(k=1000, maxIter=5, tol=1e-5, seed=3).fit(ds)
        assert np.array_equal(a.cluster_centers_matrix().to_array(),
                              b.cluster_centers_matrix().to_array())
        assert a.training_cost == b.training_cost
    finally:
        ctx.stop()
