"""The port's L-BFGS-B and bounded binomial LogisticRegression against the
JAX package's, on the same numpy data.

- ``LBFGSB`` on the reference's quadratic problems (tests/test_optim.py:
  binding box, inactive bounds, crossed bounds, resume, pinned and corner
  starts): the same iterates, states within rtol 1e-10;
- bounded LogisticRegression in float64: equal iteration and evaluation
  counts, objective histories within rtol 1e-10, coefficients within rtol
  1e-8 / atol 1e-10; coefficient bounds keep fitWithMean centering,
  intercept bounds turn it off, as in the reference;
- the kernel route (``usePallasKernels=true``): on the CPU the port's
  plain K1, which launches nothing, against the reference's interpreted
  Pallas kernel, within the reference's kernel-vs-plain bound (rtol 5e-3,
  atol 5e-4);
- on the card (``gpu``): a small bounded fit through K1, one launch per
  L-BFGS-B evaluation, against the plain aggregator.

The card's machine has no jax, so the reference is imported inside the
tests that use it.
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import LogisticRegression
from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS, LBFGSB
from cycloneml_tpu_torch.ops import kernels


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _quad_problem(d=6, seed=0):
    """The reference's convex quadratic 1/2 (x - c)^T Q (x - c)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(d, d)
    q = a @ a.T + d * np.eye(d)
    c = rng.randn(d) * 2.0

    def f(x):
        diff = x - c
        return 0.5 * float(diff @ q @ diff), q @ diff
    return f, q, c


def _same_state(got, ref):
    assert got.iteration == ref.iteration
    assert got.converged_reason == ref.converged_reason
    np.testing.assert_allclose(got.loss_history, ref.loss_history,
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(got.x, ref.x, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", ["binding", "inactive", "pinned", "corner",
                                  "partial-pin"])
def test_lbfgsb_matches_reference(case):
    from cycloneml_tpu.ml.optim.lbfgs import LBFGSB as JaxLBFGSB
    if case in ("binding", "inactive"):
        f, _, c = _quad_problem(seed=0 if case == "binding" else 3)
        wide = case == "inactive"
        lo = np.full(6, -1e6 if wide else -0.5)
        hi = np.full(6, 1e6 if wide else 0.75)
        kw, x0 = dict(max_iter=200, tol=1e-12), np.zeros(6)
    else:
        def f(x):
            return 0.5 * float(x @ x), x.copy()
        lo, hi = {"pinned": (np.ones(3), np.ones(3)),
                  "corner": (np.full(3, 1.0), np.full(3, 2.0)),
                  "partial-pin": (np.array([-5.0, 2.0, -5.0]),
                                  np.array([5.0, 2.0, 5.0]))}[case]
        kw, x0 = dict(max_iter=100, tol=1e-12), np.zeros(3)
    ref = JaxLBFGSB(lo, hi, **kw).minimize(f, x0)
    got = LBFGSB(lo, hi, **kw).minimize(f, x0)
    _same_state(got, ref)
    assert got.converged
    assert np.all(got.x >= lo) and np.all(got.x <= hi)
    if case == "inactive":
        free = LBFGS(**kw).minimize(f, x0)
        np.testing.assert_allclose(got.x, free.x, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(got.x, c, rtol=1e-6, atol=1e-8)


def test_lbfgsb_rejects_crossed_bounds():
    with pytest.raises(ValueError, match="lower bound"):
        LBFGSB(np.ones(3), np.zeros(3))


def test_lbfgsb_resumes_a_reference_state_exactly():
    """Three reference iterations, carried across as a pytree, resume in
    the port and end where an uninterrupted reference run ends."""
    from cycloneml_tpu.ml.optim.lbfgs import LBFGSB as JaxLBFGSB
    f, _, _ = _quad_problem(seed=5)
    lo, hi = np.full(6, -0.4), np.full(6, 0.6)
    ref_opt = JaxLBFGSB(lo, hi, max_iter=40, tol=1e-13)
    full = ref_opt.minimize(f, np.zeros(6))
    head = None
    for head in ref_opt.iterations(f, np.zeros(6)):
        if head.iteration == 3:
            break
    resumed = LBFGSB(lo, hi, max_iter=40, tol=1e-13).minimize(
        f, np.zeros(6),
        resume=interop.optim_state_from_pytree(head.to_pytree()))
    _same_state(resumed, full)


def _binary(n=400, d=5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * (rng.rand(d) * 2 + 0.3) + rng.randn(d)
    beta = rng.randn(d)
    y = ((x - x.mean(0)) @ beta + 0.7 * rng.randn(n) > 0).astype(np.float64)
    return x, y


def _assert_same_path(ref, got):
    rs, gs = ref.summary, got.summary
    assert gs.total_iterations == rs.total_iterations
    assert gs.total_evals == rs.total_evals
    np.testing.assert_allclose(gs.objective_history, rs.objective_history,
                               rtol=1e-10)
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.intercept, ref.intercept,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("bounds", [
    dict(lowerBoundsOnCoefficients=np.zeros((1, 5))),
    dict(upperBoundsOnCoefficients=np.full((1, 5), 0.3),
         lowerBoundsOnCoefficients=np.full((1, 5), -0.3)),
    dict(lowerBoundsOnCoefficients=np.full((1, 5), -1e6),
         upperBoundsOnCoefficients=np.full((1, 5), 1e6)),
    dict(upperBoundsOnIntercepts=np.array([-0.5])),
    dict(lowerBoundsOnIntercepts=np.array([0.2]),
         lowerBoundsOnCoefficients=np.zeros(5)),
], ids=["nonnegative", "box", "wide-open", "intercept-above",
        "intercept-below-and-vector"])
@pytest.mark.parametrize("reg", [0.0, 0.02])
def test_f64_bounded_fit_matches_reference(ctx, pctx, bounds, reg):
    from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
    from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
    x, y = _binary()
    kw = dict(maxIter=80, tol=1e-9, regParam=reg, **bounds)
    ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    _assert_same_path(ref, got)
    cb = np.asarray(bounds.get("lowerBoundsOnCoefficients", -np.inf))
    assert np.all(got.coefficients.values >= cb.ravel())
    ib = bounds.get("upperBoundsOnIntercepts")
    if ib is not None:
        assert got.intercept <= ib[0]


def test_f64_bounded_unstandardized_weighted_fit_matches_reference(ctx,
                                                                   pctx):
    from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
    from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
    x, y = _binary(n=300, d=4, seed=3)
    w = np.random.RandomState(4).rand(len(y)) + 0.3
    kw = dict(maxIter=60, tol=1e-9, regParam=0.05, standardization=False,
              fitIntercept=False,
              upperBoundsOnCoefficients=np.full((1, 4), 0.2))
    ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y, w))
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y, w))
    _assert_same_path(ref, got)


@pytest.mark.parametrize("kw,match", [
    (dict(lowerBoundsOnCoefficients=np.zeros((1, 5)), elasticNetParam=0.5,
          regParam=0.1), "elasticNetParam"),
    (dict(lowerBoundsOnCoefficients=np.zeros((1, 5)), elasticNetParam=1.0),
     "elasticNetParam"),
    (dict(lowerBoundsOnCoefficients=np.zeros((2, 5))), r"shape \(1, 5\)"),
    (dict(lowerBoundsOnIntercepts=np.zeros(2)), "1 entries"),
    (dict(lowerBoundsOnIntercepts=np.zeros(1), fitIntercept=False),
     "fitIntercept"),
    (dict(lowerBoundsOnCoefficients=np.ones((1, 5)),
          upperBoundsOnCoefficients=np.zeros((1, 5))), "lower bound"),
])
def test_bad_bounds_are_refused(pctx, kw, match):
    x, y = _binary(n=80)
    with pytest.raises(ValueError, match=match):
        LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y))


def test_kernel_route_bounded_fit_matches_reference_kernel_fit(ctx, pctx):
    """usePallasKernels=true in both packages: the bounded fit's loss is
    K1 (the port's plain version on the CPU, no launch; the reference's
    Pallas kernel interpreted)."""
    from cycloneml_tpu.conf import USE_PALLAS_KERNELS as JAX_USE_KERNELS
    from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
    from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
    x, y = _binary(n=512, d=8, seed=7)
    kw = dict(maxIter=30, regParam=0.01, tol=1e-8,
              lowerBoundsOnCoefficients=np.zeros((1, 8)))
    ctx.conf.set(JAX_USE_KERNELS, "true")
    try:
        ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    finally:
        ctx.conf.set(JAX_USE_KERNELS, "false")
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    launches = kernels.glm_sweep.launches
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(got.intercept, ref.intercept,
                               rtol=5e-3, atol=5e-4)
    assert np.all(got.coefficients.values >= 0.0)
    assert kernels.glm_sweep.launches == launches


def test_bounded_frame_fit_matches_reference(ctx, pctx):
    """Through MLFrame, as a CrossValidator hands it over."""
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
    x, y = _binary(n=200, d=3, seed=9)
    kw = dict(maxIter=40, tol=1e-9, regParam=0.01,
              upperBoundsOnCoefficients=np.full((1, 3), 0.1))
    ref = JaxLR(**kw).fit(JaxFrame(ctx, {"features": x, "label": y}))
    got = LogisticRegression(**kw).fit(
        MLFrame(pctx, {"features": x, "label": y}))
    _assert_same_path(ref, got)


@pytest.mark.gpu
def test_cuda_bounded_fit_launches_k1_once_per_evaluation():
    """A bounded fit on the card: K1 launched exactly once per L-BFGS-B
    evaluation and nothing else; every coefficient inside the box; the
    model within rtol 5e-3 / atol 5e-4 of the plain aggregator's fit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        x, y = _binary(n=20_000, d=64, seed=11)
        ds = interop.dataset_from_numpy(x, y, ctx=c)
        kw = dict(maxIter=25, regParam=0.01, tol=0.0,
                  lowerBoundsOnCoefficients=np.zeros((1, 64)))
        kernels.reset_launch_counts()
        c.conf.set("cyclone.ml.usePallasKernels", "auto")
        got = LogisticRegression(**kw).fit(ds)
        assert kernels.glm_sweep.launches_by_link[kernels.LOGISTIC] == \
            got.summary.total_evals
        assert kernels.glm_sweep.launches == got.summary.total_evals
        assert kernels.glm_sweep_stacked.launches == 0
        assert np.all(got.coefficients.values >= 0.0)
        c.conf.set("cyclone.ml.usePallasKernels", "false")
        plain = LogisticRegression(**kw).fit(ds)
        np.testing.assert_allclose(got.coefficients.values,
                                   plain.coefficients.values,
                                   rtol=5e-3, atol=5e-4)
    finally:
        c.stop()
