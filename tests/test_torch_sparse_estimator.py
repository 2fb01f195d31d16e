"""Sparse-tier LogisticRegression (``_fit_sparse``) against the JAX package's,
on the same numpy rows, in float64 (``cyclone.compute.dtype=float64``).

With the feature std handed over from the reference (the one input the two
packages compute through different float32 reduction orders), both run the
same host optimizer on the same objective: equal iteration and evaluation
counts, coefficients within 1e-8. With the port's own std, the objective
agrees to 1e-7 relative and the coefficients to rtol 1e-3 / atol 1e-5,
the bound the reference's own tests allow between two float32 reduction
orders of the std (tests/test_sparse_estimator.py:35-38).
"""

import numpy as np
import pytest

from cycloneml_tpu.dataset import sparse as jsparse
from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset import sparse as psparse
from cycloneml_tpu_torch.ml.classification import LogisticRegression
from cycloneml_tpu_torch.ops import kernels
from tests.test_sparse import _random_sparse, _random_varlen_sparse


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _both(ctx, pctx, seed, d, hybrid, n=300):
    if hybrid:
        rows, _, y, w = _random_varlen_sparse(n=n, d=d, seed=seed)
        ref = jsparse.SparseInstanceDataset.from_rows_hybrid(
            ctx, rows, y=y, w=w, n_features=d, k_ell=8)
        got = interop.sparse_dataset_from_reference(
            rows=rows, y=y, w=w, n_features=d, k_ell=8, ctx=pctx)
    else:
        rows, _, y, w = _random_sparse(n=n, d=d, k=5, seed=seed)
        ref = jsparse.SparseInstanceDataset.from_rows(ctx, rows, y=y, w=w,
                                                      n_features=d)
        got = psparse.SparseInstanceDataset.from_rows(pctx, rows, y=y, w=w,
                                                      n_features=d)
    return ref, got


_CONFIGS = {
    "l2": dict(maxIter=60, regParam=0.05, tol=1e-10),
    "elastic_net": dict(maxIter=80, regParam=0.1, elasticNetParam=0.6,
                        tol=1e-9),
    "bounds": dict(maxIter=80, regParam=0.05,
                   lowerBoundsOnCoefficients=np.zeros((1, 24))),
    "no_standardization": dict(maxIter=60, regParam=0.05, tol=1e-10,
                               standardization=False),
    "l1_no_standardization": dict(maxIter=60, regParam=0.05, tol=1e-9,
                                  elasticNetParam=1.0,
                                  standardization=False),
    "no_intercept": dict(maxIter=60, regParam=0.02, tol=1e-10,
                         fitIntercept=False),
}


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("config", sorted(_CONFIGS))
def test_fit_matches_reference_with_its_std(ctx, pctx, monkeypatch, config,
                                            hybrid):
    ref_ds, got_ds = _both(ctx, pctx, seed=7, d=24, hybrid=hybrid)
    ref_std = jsparse.sparse_feature_std(ref_ds)
    monkeypatch.setattr(psparse, "sparse_feature_std", lambda ds: ref_std)
    kw = _CONFIGS[config]
    ref = JaxLR(**kw).fit(ref_ds)
    got = LogisticRegression(**kw).fit(got_ds)
    rs, gs = ref.summary, got.summary
    assert gs.total_iterations == rs.total_iterations
    assert gs.total_evals == rs.total_evals
    np.testing.assert_allclose(got.coefficients.values,
                               ref.coefficients.to_array(), rtol=1e-8,
                               atol=1e-8)
    assert got.intercept == pytest.approx(ref.intercept, rel=1e-8, abs=1e-8)
    np.testing.assert_allclose(gs.objective_history, rs.objective_history,
                               rtol=1e-10)
    if "elasticNetParam" in kw:  # OWL-QN: the same exact zeros
        np.testing.assert_array_equal(got.coefficients.values == 0.0,
                                      ref.coefficients.to_array() == 0.0)
        assert np.any(got.coefficients.values == 0.0)
    if config == "bounds":
        assert np.all(got.coefficients.values >= 0.0)


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("config", ["l2", "elastic_net", "bounds"])
def test_fit_matches_reference_with_its_own_std(ctx, pctx, config, hybrid):
    ref_ds, got_ds = _both(ctx, pctx, seed=3, d=24, hybrid=hybrid)
    kw = _CONFIGS[config]
    ref = JaxLR(**kw).fit(ref_ds)
    got = LogisticRegression(**kw).fit(got_ds)
    r_obj = ref.summary.objective_history[-1]
    assert abs(got.summary.objective_history[-1] - r_obj) <= 1e-7 * abs(r_obj)
    np.testing.assert_allclose(got.coefficients.values,
                               ref.coefficients.to_array(), rtol=1e-3,
                               atol=1e-5)
    assert got.intercept == pytest.approx(ref.intercept, rel=1e-3, abs=1e-5)


def test_predictions_of_the_sparse_model(ctx, pctx):
    """The fitted model carries across and classifies like the
    reference's (a binomial model of d coefficients)."""
    ref_ds, got_ds = _both(ctx, pctx, seed=5, d=24, hybrid=False)
    got = LogisticRegression(maxIter=40, regParam=0.05).fit(got_ds)
    assert got.num_classes == 2 and got.num_features == 24
    x = got_ds.to_dense()
    raw = got._raw_prediction(x)
    np.testing.assert_allclose(raw[:, 1], x @ got.coefficients.values
                               + got.intercept, rtol=1e-12)


def test_multinomial_and_multiclass_are_rejected_as_the_reference(ctx,
                                                                   pctx):
    rows, _, _, _ = _random_sparse(n=60, d=10, k=3, seed=1)
    y3 = (np.arange(60) % 3).astype(float)
    ref = jsparse.SparseInstanceDataset.from_rows(ctx, rows, y=y3,
                                                  n_features=10)
    got = psparse.SparseInstanceDataset.from_rows(pctx, rows, y=y3,
                                                  n_features=10)
    for family, err in (("auto", NotImplementedError),
                        ("multinomial", NotImplementedError),
                        ("binomial", ValueError)):
        with pytest.raises(err) as want:
            JaxLR(maxIter=5, family=family).fit(ref)
        with pytest.raises(err) as have:
            LogisticRegression(maxIter=5, family=family).fit(got)
        assert str(have.value) == str(want.value)
    y2 = (np.arange(60) % 2).astype(float)
    two = psparse.SparseInstanceDataset.from_rows(pctx, rows, y=y2,
                                                  n_features=10)
    with pytest.raises(NotImplementedError, match="binomial"):
        LogisticRegression(maxIter=5, family="multinomial").fit(two)


def test_checkpointing_raises_with_its_slice(pctx, tmp_path):
    """The sparse fit checkpoints under its own fingerprint: a directory
    written by a fit of other rows raises instead of resuming."""
    rows, _, y, w = _random_sparse(n=40, d=8, k=3, seed=2)
    ds = psparse.SparseInstanceDataset.from_rows(pctx, rows, y=y, w=w,
                                                 n_features=8)
    ck = str(tmp_path / "ck")
    LogisticRegression(maxIter=5, checkpointDir=ck).fit(ds)
    other = psparse.SparseInstanceDataset.from_rows(pctx, rows, y=1.0 - y,
                                                    w=w, n_features=8)
    with pytest.raises(ValueError, match="DIFFERENT training run"):
        LogisticRegression(maxIter=5, checkpointDir=ck).fit(other)


def test_kernel_route_on_the_cpu_fits_the_same_model(pctx):
    """usePallasKernels=true on CPU tensors: the wrappers' plain versions,
    the same model bit for bit, nothing launched."""
    rows, _, y, w = _random_varlen_sparse(n=200, d=30, seed=9)
    ds = psparse.SparseInstanceDataset.from_rows_hybrid(
        pctx, rows, y=y, w=w, n_features=30, k_ell=6)
    lr = LogisticRegression(maxIter=30, regParam=0.02)
    plain = lr.fit(ds)
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    fused = lr.fit(ds)
    np.testing.assert_array_equal(fused.coefficients.values,
                                  plain.coefficients.values)
    assert fused.summary.total_evals == plain.summary.total_evals
    assert kernels.ell_rows.launches == 0 and kernels.ell_cols.launches == 0


def _criteo_fits_by_tier(monkeypatch, seed):
    """A Criteo-class fit (``generate_criteo_like``, 20,000 rows, 2^14
    hashed columns, maxIter=25 as chip_smoke.py's) through the plain
    passes with their sums in float32 (the float32 tier), in float64 (the
    float64 tier), and in the kernels' arithmetic (float32 inputs, S1's
    sums in double, as ``csrc/ell_sweep.cu`` takes them), on the CPU draw
    of ``seed``."""
    from cycloneml_tpu_torch.dataset.random import generate_criteo_like
    from cycloneml_tpu_torch.ml.optim import sparse_aggregators

    plain_rows = kernels.ell_rows_plain

    def rows_in_double(indices, values, y, w, beta, *args):
        mult, loss, msum, wsum = plain_rows(indices, values, y, w,
                                            beta.double(), *args)
        return mult.float(), loss, msum, wsum

    models = {}
    for name, dtype in (("float32", "float32"), ("float64", "float64"),
                        ("kernel arithmetic", "float32")):
        ctx = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                             .set("cyclone.compute.dtype", dtype))
        try:
            ds = generate_criteo_like(ctx, 20_000, seed=seed,
                                      hash_dim=1 << 14)
            with monkeypatch.context() as m:
                if name == "kernel arithmetic":
                    m.setattr(sparse_aggregators.kernels, "ell_rows_plain",
                              rows_in_double)
                models[name] = LogisticRegression(maxIter=25,
                                                  regParam=0.01).fit(ds)
        finally:
            ctx.stop()
    return models


def test_float32_sums_do_not_part_a_small_criteo_fit(monkeypatch):
    """The float32 tier's sparse intercept (ROADMAP Queue 3), on seed 0's
    draw (:func:`_criteo_fits_by_tier`): the three tiers take the same
    iterations, their objectives agree to 1e-6 at every iteration and
    their intercepts to 1e-5. On this draw the sums' precision does not
    move the fit; on others it does (the next test), so this holds for a
    draw, not for the size."""
    models = _criteo_fits_by_tier(monkeypatch, 0)
    ref = models["float64"]
    for name in ("float32", "kernel arithmetic"):
        got = models[name]
        assert got.summary.total_iterations == ref.summary.total_iterations
        np.testing.assert_allclose(got.summary.objective_history,
                                   ref.summary.objective_history, rtol=1e-6)
        assert abs(got.intercept - ref.intercept) <= 1e-5


def test_float32_sums_part_a_small_criteo_fit_on_seed_3(monkeypatch):
    """The draw that disproves the claim above at this size (ROADMAP
    Queue 3, open): on seed 3's draw the float32 tier's objectives part
    from the float64 tier's by more than 1e-6 (1.6e-6 at the worst
    iteration on the CPU; the kernels' arithmetic 5.5e-6) and its
    intercept by 2.8e-4. The narrower claim it does meet: the same
    iterations, objectives within 1e-5 at every iteration, intercepts
    within 1e-3."""
    models = _criteo_fits_by_tier(monkeypatch, 3)
    ref = models["float64"]
    for name in ("float32", "kernel arithmetic"):
        got = models[name]
        assert got.summary.total_iterations == ref.summary.total_iterations
        np.testing.assert_allclose(got.summary.objective_history,
                                   ref.summary.objective_history, rtol=1e-5)
        assert abs(got.intercept - ref.intercept) <= 1e-3


def _tier_parting(models):
    """How far a float32-tier fit parts from the float64-tier fit of the
    same rows: the largest relative objective difference over the
    iterations both ran, and the intercepts' distance."""
    a, b = models["float32"], models["float64"]
    ha = np.asarray(a.summary.objective_history)
    hb = np.asarray(b.summary.objective_history)
    m = min(len(ha), len(hb))
    assert a.summary.total_iterations == b.summary.total_iterations
    return (float(np.max(np.abs(ha[:m] - hb[:m]) / np.abs(hb[:m]))),
            abs(a.intercept - b.intercept))


def test_reference_float32_fit_parts_as_the_port_does_on_seed_3(ctx):
    """ROADMAP Queue 3, the item the test above opened: seed 3's draw of
    ``generate_criteo_like`` (20,000 rows, 2^14 columns), handed as the
    same numpy ELL rows to both packages' sparse LogisticRegression
    (maxIter=25, regParam=0.01) at each accumulator tier: the port's
    ``cyclone.compute.dtype`` float32 and float64, the reference's jax
    x64 off and on (its ``compute_dtype``). The reference's float32 fit
    parts from its float64 fit too (objective 3.8e-6 at the worst
    iteration, intercept 2.8e-4 on the CPU), and the port's parts no
    further (1.6e-6, 2.8e-4): the parting is the unconverged float32
    line search's, in both packages, not a port fault."""
    import jax
    from cycloneml_tpu_torch.dataset.random import generate_criteo_like

    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    try:
        ds = generate_criteo_like(c, 20_000, seed=3, hash_dim=1 << 14)
        n, d = ds.n_rows, ds.n_features
        idx = ds.indices.cpu().numpy()[:n]
        val = ds.values.cpu().numpy()[:n]
        y, w = ds.y_host()[:n], ds.w_host()[:n]
    finally:
        c.stop()
    assert ds.tail() is None  # the rows are the ELL arrays alone

    port, ref = {}, {}
    for tier in ("float32", "float64"):
        pc = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                            .set("cyclone.compute.dtype", tier))
        try:
            got = interop.sparse_dataset_from_reference(idx, val, y, w,
                                                        n_features=d, ctx=pc)
            port[tier] = LogisticRegression(maxIter=25,
                                            regParam=0.01).fit(got)
        finally:
            pc.stop()
        with jax.enable_x64(tier == "float64"):
            rds = jsparse.SparseInstanceDataset.from_ell(ctx, idx, val, y, w,
                                                         n_features=d)
            ref[tier] = JaxLR(maxIter=25, regParam=0.01).fit(rds)
    ref_obj, ref_icpt = _tier_parting(ref)
    port_obj, port_icpt = _tier_parting(port)
    # the reference parts by as much as the test above finds the port does
    assert ref_obj > 1e-6 and ref_icpt > 1e-4
    # and the port parts no further than the reference
    assert port_obj <= 1.5 * ref_obj
    assert port_icpt <= 1.5 * ref_icpt
    # the two float64 fits agree
    np.testing.assert_allclose(port["float64"].summary.objective_history,
                               ref["float64"].summary.objective_history,
                               rtol=1e-5)
