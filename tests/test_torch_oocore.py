"""The port's out-of-core streaming engine (``cycloneml_tpu_torch/oocore``)
against the JAX package's, on the same seeded numpy arrays.

On the CPU in float64 (``cyclone.master=cpu``, ``cyclone.compute.dtype=
float64``) the port's streamed fits (LogisticRegression, LinearRegression,
the stacked fit, the streamed SGD at miniBatchFraction 1.0) take the
reference's streamed fits' path: equal iteration and evaluation counts,
coefficients within rtol 1e-9 / atol 1e-12, the reference's own
streamed-versus-in-core envelope (tests/test_oocore.py:304-434). The
write-pass statistics, the budget guard's degradation, force mode, the
shuffle order, the close race, the fp8 probe's refusal, the stacked fits
against serial ones and the shard-set cache are held as the reference's
tests hold them. The mini-batch mask at fraction < 1 is the port's own
bits (ROADMAP Queue 3), held to determinism.

The ``gpu`` tests stream on the card with every copy or every kernel held
back by a spin, so that only the two waits of a slot (the host's on its
earlier copy, the copy stream's on the kernel that read its device twin)
keep each shard's data right, and stage a short shard into a slot a
longer shard of large values filled. The card's machine has no jax, so the reference is
imported inside the tests that use it:

    python -m pytest --noconftest -m gpu tests/test_torch_oocore.py
"""

import os
import subprocess
import sys
import textwrap
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.ml.classification import LogisticRegression
from cycloneml_tpu_torch.ml.optim import aggregators
from cycloneml_tpu_torch.ml.optim.gradient_descent import (
    GradientDescent, SquaredL2Updater, mask_seed, sample_weights)
from cycloneml_tpu_torch.ml.regression import LinearRegression
from cycloneml_tpu_torch.oocore import (ShardStream, StreamingDataset,
                                        StreamingGradientDescent,
                                        StreamingLossFunction, shard_dataset,
                                        shard_set_cache)

TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


@pytest.fixture(autouse=True)
def _empty_cache():
    """Every test starts and ends with the shard-set cache empty (its
    spills removed)."""
    shard_set_cache().clear()
    yield
    shard_set_cache().clear()


def _ref():
    """The reference's pieces (imported here: the card's machine has no
    jax)."""
    from cycloneml_tpu.dataset.dataset import InstanceDataset as RDataset
    from cycloneml_tpu.ml.classification import \
        LogisticRegression as RLR
    from cycloneml_tpu.ml.optim import aggregators as ragg
    from cycloneml_tpu.ml.regression import LinearRegression as RLinReg
    from cycloneml_tpu import oocore as roo
    return RDataset, RLR, RLinReg, ragg, roo


def _binary_problem(n=3000, d=10, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = (x @ rng.randn(d) + 0.3 * rng.randn(n) > 0).astype(float)
    return x, y


def _chunks(x, y, size=450):
    for lo in range(0, len(x), size):  # chunk != shard boundaries
        yield x[lo:lo + size], y[lo:lo + size], None


def _streaming_ds(ctx, x, y, shard_rows=700, **kw):
    return StreamingDataset.from_chunks(ctx, _chunks(x, y), x.shape[1],
                                        shard_rows=shard_rows, **kw)


def _ref_streaming_ds(ctx, x, y, shard_rows=700, **kw):
    roo = _ref()[4]
    return roo.StreamingDataset.from_chunks(ctx, _chunks(x, y), x.shape[1],
                                            shard_rows=shard_rows, **kw)


def _same_fit(got, ref, tol=TOL):
    assert got.summary.total_iterations == ref.summary.total_iterations
    assert got.summary.total_evals == ref.summary.total_evals
    np.testing.assert_allclose(np.asarray(got._coef),
                               np.asarray(ref._coef), **tol)
    np.testing.assert_allclose(np.asarray(got._icpt),
                               np.asarray(ref._icpt), **tol)


# -- the shard set ----------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_streaming_dataset_stats_match_summarizer(ctx, pctx, weighted):
    """The write pass harvests the Summarizer's moments and the label
    histogram (tests/test_oocore.py:280), equal to the in-core pass and to
    the reference's shard set; with weights, zero-weight rows are left out
    of every statistic but the fp8 absmax."""
    from cycloneml_tpu_torch.ml.stat import Summarizer
    roo = _ref()[4]
    x, y = _binary_problem()
    w = None
    if weighted:
        w = np.random.RandomState(3).rand(len(y)) * 2
        w[::7] = 0.0

    def chunks():
        for lo in range(0, len(x), 450):
            yield (x[lo:lo + 450], y[lo:lo + 450],
                   None if w is None else w[lo:lo + 450])

    sds = StreamingDataset.from_chunks(pctx, chunks(), x.shape[1],
                                       shard_rows=700)
    rsds = roo.StreamingDataset.from_chunks(ctx, chunks(), x.shape[1],
                                            shard_rows=700)
    try:
        ref = Summarizer.summarize(InstanceDataset.from_numpy(pctx, x, y, w))
        got = sds.summary()
        np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-12)
        np.testing.assert_allclose(got.std, ref.std, rtol=1e-12)
        # unit weights sum exactly; others to the summation order
        np.testing.assert_allclose(got.weight_sum, ref.weight_sum,
                                   rtol=1e-13 if weighted else 0)
        assert got.count == ref.count
        np.testing.assert_allclose(got.max, ref.max)
        np.testing.assert_allclose(got.min, ref.min)
        hist = sds.label_histogram()
        np.testing.assert_allclose(
            hist, np.bincount(y.astype(int), weights=w, minlength=2))
        assert sds.num_classes == 2
        rs = rsds.summary()
        np.testing.assert_allclose(got.mean, rs.mean, rtol=1e-12)
        np.testing.assert_allclose(got.variance, rs.variance, rtol=1e-12)
        np.testing.assert_allclose(hist, rsds.label_histogram())
        np.testing.assert_allclose(sds.y_moments(), rsds.y_moments(),
                                   rtol=1e-12)
        assert sds.n_shards == rsds.n_shards == 5
        assert sds.n_rows == 3000
    finally:
        sds.close()
        rsds.close()


def test_shards_round_trip_and_stage_a_zero_tail(pctx):
    """A shard's file gives its rows back bit for bit, and staging a
    short shard into a slot a longer one filled leaves no stale rows."""
    x, y = _binary_problem(n=1000, d=6)
    sds = _streaming_ds(pctx, x, y, shard_rows=400)
    try:
        assert [s.rows for s in sds._shards] == [400, 400, 200]
        assert sds.pad_rows == 400
        xs, ys, ws = sds.load_shard(2)
        np.testing.assert_array_equal(xs.numpy(), x[800:])
        np.testing.assert_array_equal(ys, y[800:])
        np.testing.assert_array_equal(ws, np.ones(200))
        xb = torch.full((400, 6), 7.0, dtype=torch.float64)
        yb = torch.full((400,), 7.0, dtype=torch.float64)
        wb = torch.full((400,), 7.0, dtype=torch.float64)
        assert sds.read_into(2, xb, yb, wb) == 200
        np.testing.assert_array_equal(xb[:200].numpy(), x[800:])
        assert not xb[200:].any() and not yb[200:].any() \
            and not wb[200:].any()
    finally:
        sds.close()


@pytest.mark.parametrize("tier, itemsize", [("bfloat16", 2),
                                            ("float8", 1), ("auto", 8)])
def test_stream_tiers_store_their_bits(pctx, tier, itemsize):
    """bf16 shards store 2 bytes an element, fp8 shards the 1-byte e4m3
    codes with one set-level scale, the same codes and scale as the
    in-core quantizer of the same rows."""
    from cycloneml_tpu_torch.dataset.instance import quantize_fp8
    x, y = _binary_problem(n=1500, d=8, seed=31)
    sds = _streaming_ds(pctx, x, y, stream_dtype=tier)
    try:
        x0, _, _ = sds.load_shard(0)
        assert x0.element_size() == itemsize
        assert sds.shard_nbytes(0) == 700 * (8 * itemsize + 16)
        if tier == "float8":
            codes, scale, _ = quantize_fp8(x)
            np.testing.assert_array_equal(sds.x_scale, scale)
            assert torch.equal(x0.view(torch.uint8),
                               codes[:700].view(torch.uint8))
        elif tier == "auto":
            # the parity tier's data dtype, float64: the rows as they are
            assert sds.x_scale is None
            np.testing.assert_array_equal(x0.numpy(), x[:700])
        else:
            assert sds.x_scale is None
            assert torch.equal(x0, torch.from_numpy(x[:700]).to(
                torch.bfloat16))
    finally:
        sds.close()


@pytest.mark.parametrize("shard_rows", [256, 1003, 5000])
def test_from_dataset_drops_padding_rows(pctx, shard_rows):
    x, y = _binary_problem(n=1003, d=5)
    ds = InstanceDataset.from_numpy(pctx, x, y)
    sds = StreamingDataset.from_dataset(ds, shard_rows=shard_rows)
    try:
        assert sds.n_rows == 1003
        assert sds.n_shards == -(-1003 // shard_rows)
        got = np.concatenate([sds.load_shard(i)[0].numpy()
                              for i in range(sds.n_shards)])
        np.testing.assert_array_equal(got, x)
    finally:
        sds.close()


# -- the streamed fits against the reference's --------------------------------

@pytest.mark.parametrize("shard_rows", [350, 700, 3000])
@pytest.mark.parametrize("standardization", [True, False])
def test_streamed_logreg_matches_reference(ctx, pctx, shard_rows,
                                           standardization):
    """(tests/test_oocore.py:304) A streamed LR lands on the reference's
    streamed coefficients with its iteration and evaluation counts, and
    within 1e-9 of the in-core fit, for shards of a few rows to one shard;
    one shard launch an evaluation a shard."""
    RDataset, RLR = _ref()[:2]
    x, y = _binary_problem()
    sds = _streaming_ds(pctx, x, y, shard_rows=shard_rows)
    rsds = _ref_streaming_ds(ctx, x, y, shard_rows=shard_rows)
    kw = dict(maxIter=25, regParam=0.05, standardization=standardization)
    try:
        m = LogisticRegression(**kw).fit(sds)
        r = RLR(**kw).fit(rsds)
        assert m.summary.streamed and r.summary.streamed
        _same_fit(m, r)
        incore = LogisticRegression(**kw).fit(
            InstanceDataset.from_numpy(pctx, x, y))
        assert not incore.summary.streamed
        np.testing.assert_allclose(m._coef, incore._coef, **TOL)
        assert m.summary.total_dispatches == \
            m.summary.total_evals * sds.n_shards
    finally:
        sds.close()
        rsds.close()


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_streamed_linreg_matches_reference(ctx, pctx, fit_intercept, alpha):
    """(tests/test_oocore.py:335) The streamed l-bfgs (and, with an L1
    part, OWL-QN) fit against the reference's; ``solver="normal"`` raises
    before anything, ``auto`` streams through l-bfgs."""
    RLinReg = _ref()[2]
    rng = np.random.RandomState(12)
    n, d = 2500, 8
    x = rng.randn(n, d)
    y = x @ rng.randn(d) + 0.1 * rng.randn(n) + 0.5
    sds = _streaming_ds(pctx, x, y)
    rsds = _ref_streaming_ds(ctx, x, y)
    try:
        kw = dict(maxIter=25, regParam=0.1, solver="l-bfgs",
                  fitIntercept=fit_intercept, elasticNetParam=alpha)
        m = LinearRegression(**kw).fit(sds)
        r = RLinReg(**kw).fit(rsds)
        assert m.summary.streamed and r.summary.streamed
        assert m.summary.total_iterations == r.summary.total_iterations
        np.testing.assert_allclose(m._coef, np.asarray(r._coef), **TOL)
        np.testing.assert_allclose(m._icpt, float(r._icpt), **TOL)
        assert m.summary.total_dispatches == \
            m.summary.total_evals * sds.n_shards
        with pytest.raises(ValueError, match="in-core"):
            LinearRegression(solver="normal").fit(sds)
        auto = LinearRegression(maxIter=25, solver="auto").fit(sds)
        assert auto.summary.streamed
    finally:
        sds.close()
        rsds.close()


@pytest.mark.parametrize("updater", ["Simple", "SquaredL2", "L1"])
def test_streamed_gradient_descent_matches_reference(ctx, pctx, updater):
    """(tests/test_oocore.py:362) The streamed SGD at miniBatchFraction
    1.0 folds every shard's partial into one step: the reference's
    streamed trajectory, and the in-core GradientDescent's, under each
    Updater."""
    from cycloneml_tpu.ml.optim import gradient_descent as rgd
    from cycloneml_tpu_torch.ml.optim import gradient_descent as pgd
    ragg, roo = _ref()[3:5]
    x, y = _binary_problem(n=1500, d=6, seed=13)
    sds = _streaming_ds(pctx, x, y, shard_rows=400)
    rsds = _ref_streaming_ds(ctx, x, y, shard_rows=400)
    name = f"{updater}Updater"
    try:
        kw = dict(step_size=1.0, num_iterations=25, reg_param=0.01, seed=3)
        agg = aggregators.binary_logistic(6, fit_intercept=False)
        w_s, h_s = StreamingGradientDescent(
            updater=getattr(pgd, name)(), **kw).optimize(sds, agg,
                                                        np.zeros(6))
        w_r, h_r = roo.StreamingGradientDescent(
            updater=getattr(rgd, name)(), **kw).optimize(
                rsds, ragg.binary_logistic(6, fit_intercept=False),
                np.zeros(6))
        assert len(h_s) == len(h_r)
        np.testing.assert_allclose(w_s, w_r, **TOL)
        np.testing.assert_allclose(h_s, h_r, rtol=1e-9)
        w_i, h_i = GradientDescent(updater=getattr(pgd, name)(), **kw) \
            .optimize(InstanceDataset.from_numpy(pctx, x, y), agg,
                      np.zeros(6))
        np.testing.assert_allclose(w_s, w_i, **TOL)
        np.testing.assert_allclose(h_s, h_i, rtol=1e-9)
    finally:
        sds.close()
        rsds.close()


def test_over_budget_fit_degrades_to_streaming(ctx, pctx):
    """(tests/test_oocore.py:387) An in-core fit over the budget
    DEGRADES to the streaming engine and completes, even under
    budgetAction=raise, on the unbudgeted coefficients and the
    reference's degraded ones; the warnings are recorded; mode=off
    restores the raise."""
    from cycloneml_tpu_torch.observe.costs import MemoryBudgetError
    RDataset, RLR = _ref()[:2]
    x, y = _binary_problem(n=1200, d=6, seed=14)
    ds = InstanceDataset.from_numpy(pctx, x, y)

    def est(cls):
        return cls(maxIter=12, regParam=0.1)

    unbudgeted = est(LogisticRegression).fit(ds)
    assert not unbudgeted.summary.streamed
    for c in (ctx, pctx):
        c.conf.set("cyclone.memory.budgetFraction", "1e-12")
        c.conf.set("cyclone.memory.budgetAction", "raise")
    try:
        m = est(LogisticRegression).fit(ds)
        assert m.summary.streamed
        np.testing.assert_allclose(m._coef, unbudgeted._coef, **TOL)
        r = est(RLR).fit(RDataset.from_numpy(ctx, x, y))
        assert r.summary.streamed
        _same_fit(m, r)
        warns = pctx.memory_warnings
        assert warns and warns[-1]["event"] == "MemoryBudgetExceeded"
        assert warns[-1]["predicted_bytes"] > warns[-1]["budget_bytes"]
        pctx.conf.set("cyclone.oocore.mode", "off")
        with pytest.raises(MemoryBudgetError):
            est(LogisticRegression).fit(ds)
    finally:
        for c in (ctx, pctx):
            c.conf.remove("cyclone.memory.budgetFraction")
            c.conf.remove("cyclone.memory.budgetAction")
            c.conf.remove("cyclone.oocore.mode")


def test_guard_warns_and_proceeds_by_default(pctx):
    """Under budgetAction=warn with streaming off, an over-budget fit
    records the warning, drops to chunk 1 and fits in core, the same
    model; an unarmed guard records nothing."""
    x, y = _binary_problem(n=600, d=4, seed=15)
    ds = InstanceDataset.from_numpy(pctx, x, y)
    ref = LogisticRegression(maxIter=8, regParam=0.1).fit(ds)
    assert not pctx.memory_warnings
    pctx.conf.set("cyclone.memory.budgetFraction", "1e-12")
    pctx.conf.set("cyclone.oocore.mode", "off")
    m = LogisticRegression(maxIter=8, regParam=0.1).fit(ds)
    assert not m.summary.streamed and len(pctx.memory_warnings) == 1
    np.testing.assert_allclose(m._coef, ref._coef, **TOL)
    assert m.summary.total_dispatches > ref.summary.total_dispatches


def test_device_memory_limit_and_prediction(pctx):
    from cycloneml_tpu_torch.observe import costs
    assert costs.device_memory_limit(pctx.conf) > 0
    pctx.conf.set("cyclone.memory.deviceBytes", "12345")
    assert costs.device_memory_limit(pctx.conf) == 12345
    x = torch.zeros((100, 10))
    assert costs.predict_fit_peak([x, torch.zeros(100), "not a tensor"],
                                  n_coef=11, d=10, m=10, acc_bytes=8) == \
        100 * 10 * 4 + 100 * 4 + 2 * 10 * 11 * 8 + 4 * 11 * 8
    assert not costs.guard_armed(CycloneConf(load_defaults=False))


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("family", ["binomial", "multinomial"])
def test_force_mode_lr_streams_as_the_reference(ctx, pctx, family,
                                                fit_intercept):
    """(tests/test_oocore.py:420) Under ``cyclone.oocore.mode=force`` dense
    LR (both families) spills and streams, on the reference's forced
    fit's path."""
    RDataset, RLR = _ref()[:2]
    rng = np.random.RandomState(33)
    x = rng.randn(600, 5)
    y = (np.argmax(x[:, :3] @ rng.randn(3, 3), axis=1) if family ==
         "multinomial" else (x @ rng.randn(5) > 0)).astype(np.float64)
    for c in (ctx, pctx):
        c.conf.set("cyclone.oocore.mode", "force")
    try:
        kw = dict(family=family, maxIter=10, regParam=0.1,
                  fitIntercept=fit_intercept)
        m = LogisticRegression(**kw).fit(
            InstanceDataset.from_numpy(pctx, x, y))
        r = RLR(**kw).fit(RDataset.from_numpy(ctx, x, y))
        assert m.summary.streamed and r.summary.streamed
        _same_fit(m, r)
    finally:
        for c in (ctx, pctx):
            c.conf.remove("cyclone.oocore.mode")
    incore = LogisticRegression(**kw).fit(
        InstanceDataset.from_numpy(pctx, x, y))
    assert not incore.summary.streamed
    np.testing.assert_allclose(m._coef, incore._coef, **TOL)


@pytest.mark.parametrize("kw", [dict(), dict(solver="l-bfgs"),
                                dict(regParam=0.1, elasticNetParam=0.5)])
def test_force_mode_linreg_streams_as_the_reference(ctx, pctx, kw):
    """``auto`` (l-bfgs under force), l-bfgs and OWL-QN spill and stream,
    on the reference's forced fit's path."""
    RDataset, RLinReg = _ref()[0], _ref()[2]
    rng = np.random.RandomState(34)
    x = rng.randn(600, 5)
    y = x @ rng.randn(5) + 0.2 * rng.randn(600)
    for c in (ctx, pctx):
        c.conf.set("cyclone.oocore.mode", "force")
    try:
        m = LinearRegression(**kw).fit(
            InstanceDataset.from_numpy(pctx, x, y))
        r = RLinReg(**kw).fit(RDataset.from_numpy(ctx, x, y))
    finally:
        for c in (ctx, pctx):
            c.conf.remove("cyclone.oocore.mode")
    assert m.summary.streamed and r.summary.streamed
    assert m.summary.total_iterations == r.summary.total_iterations
    np.testing.assert_allclose(m._coef, np.asarray(r._coef), **TOL)
    np.testing.assert_allclose(m._icpt, float(r._icpt), **TOL)


def test_force_mode_fit_stacked_streams_as_the_reference(ctx, pctx):
    """fit_stacked under force spills and streams (one epoch a round for
    every model), on the reference's forced stacked fit."""
    RDataset, RLR = _ref()[:2]
    x, y = _binary_problem(n=800, d=5, seed=35)
    regs = [0.01, 0.1, 1.0]
    for c in (ctx, pctx):
        c.conf.set("cyclone.oocore.mode", "force")
    try:
        got = LogisticRegression(maxIter=20).fit_stacked(
            InstanceDataset.from_numpy(pctx, x, y), reg_params=regs)
        ref = RLR(maxIter=20).fit_stacked(RDataset.from_numpy(ctx, x, y),
                                          reg_params=regs)
    finally:
        for c in (ctx, pctx):
            c.conf.remove("cyclone.oocore.mode")
    for g, r in zip(got, ref):
        assert g.summary.streamed and g.summary.n_models == 3
        _same_fit(g, r)


# -- shuffle, validation, the stream's faults ---------------------------------

def test_shuffled_sgd_matches_fixed_order(ctx, pctx):
    """(tests/test_oocore.py:582) The streamed SGD walks the reference's
    seeded permutation of the shard order; at fraction 0.6 (the port's
    mask, keyed on the TRUE shard index) a shuffled run agrees with the
    fixed order up to summation order and re-runs bitwise; at fraction 1.0
    a shuffled run is the reference's shuffled run."""
    roo = _ref()[4]
    ragg = _ref()[3]
    from cycloneml_tpu.ml.optim.gradient_descent import \
        SquaredL2Updater as RL2
    x, y = _binary_problem(n=1600, d=6, seed=21)
    sds = _streaming_ds(pctx, x, y, shard_rows=300)
    rsds = _ref_streaming_ds(ctx, x, y, shard_rows=300)
    try:
        agg = aggregators.binary_logistic(6, fit_intercept=False)
        kw = dict(step_size=1.0, num_iterations=12, reg_param=0.01, seed=5)
        part = dict(kw, mini_batch_fraction=0.6)
        w_fix, h_fix = StreamingGradientDescent(
            shuffle=False, updater=SquaredL2Updater(), **part).optimize(
                sds, agg, np.zeros(6))
        w_shuf, h_shuf = StreamingGradientDescent(
            shuffle=True, updater=SquaredL2Updater(), **part).optimize(
                sds, agg, np.zeros(6))
        w_shuf2, _ = StreamingGradientDescent(
            shuffle=True, updater=SquaredL2Updater(), **part).optimize(
                sds, agg, np.zeros(6))
        np.testing.assert_allclose(w_shuf, w_fix, **TOL)
        np.testing.assert_allclose(h_shuf, h_fix, rtol=1e-9)
        np.testing.assert_array_equal(w_shuf, w_shuf2)
        w_p, h_p = StreamingGradientDescent(
            shuffle=True, updater=SquaredL2Updater(), **kw).optimize(
                sds, agg, np.zeros(6))
        w_r, h_r = roo.StreamingGradientDescent(
            shuffle=True, updater=RL2(), **kw).optimize(
                rsds, ragg.binary_logistic(6, fit_intercept=False),
                np.zeros(6))
        np.testing.assert_allclose(w_p, w_r, **TOL)
        np.testing.assert_allclose(h_p, h_r, rtol=1e-9)
    finally:
        sds.close()
        rsds.close()


@pytest.mark.parametrize("seed", [0, 9, 2 ** 31 + 5])
def test_shuffle_order_is_the_references_permutation(pctx, monkeypatch,
                                                     seed):
    """Every epoch stages its shards in numpy's RandomState((seed *
    1000003 + step) % 2**32) permutation, the reference's, bit for
    bit."""
    x, y = _binary_problem(n=1600, d=4, seed=23)
    sds = _streaming_ds(pctx, x, y, shard_rows=200)
    orders = []
    sweep = StreamingLossFunction.sweep

    def spy(self, *a, order=None, **k):
        orders.append(None if order is None else list(order))
        return sweep(self, *a, order=order, **k)

    monkeypatch.setattr(StreamingLossFunction, "sweep", spy)
    try:
        StreamingGradientDescent(num_iterations=3, seed=seed, shuffle=True,
                                 convergence_tol=0.0).optimize(
            sds, aggregators.binary_logistic(4, False), np.zeros(4))
        want = [list(np.random.RandomState((seed * 1000003 + t) % 2 ** 32)
                     .permutation(8)) for t in (1, 2, 3)]
        assert orders == want
    finally:
        sds.close()


def test_shuffle_conf_key_and_order_validation(pctx):
    """(tests/test_oocore.py:615) ``cyclone.oocore.shuffle`` is the
    engine's default; an order that is not a permutation is refused."""
    from cycloneml_tpu_torch.conf import OOCORE_SHUFFLE
    assert pctx.conf.get(OOCORE_SHUFFLE) is False
    pctx.conf.set("cyclone.oocore.shuffle", "true")
    assert pctx.conf.get(OOCORE_SHUFFLE) is True
    assert StreamingGradientDescent().shuffle is None  # conf-resolved
    pctx.conf.set("cyclone.oocore.shuffle", "false")
    x, y = _binary_problem(n=600, d=4, seed=22)
    sds = _streaming_ds(pctx, x, y, shard_rows=300)
    try:
        with pytest.raises(ValueError, match="permutation"):
            ShardStream(sds, order=[0, 0, 1]).close()
    finally:
        sds.close()


@pytest.mark.parametrize("frac", [0.1, 0.3, 0.7])
def test_minibatch_mask_is_deterministic(pctx, frac):
    """The port's mask at fraction < 1: one (seed, step, shard) draws the
    same rows every time, another key other rows, at about the fraction;
    two streamed SGD runs at one seed are bitwise equal."""
    w = torch.ones(20000, dtype=torch.float64)
    a = sample_weights(w, frac, seed=4, step=2, shard=1)
    assert torch.equal(a, sample_weights(w, frac, seed=4, step=2, shard=1))
    for other in (dict(seed=5, step=2, shard=1), dict(seed=4, step=3,
                                                      shard=1),
                  dict(seed=4, step=2, shard=2)):
        assert not torch.equal(a, sample_weights(w, frac, **other))
    assert abs(float(a.mean()) - frac) < 0.02
    assert mask_seed(0, 0, 0) != mask_seed(0, 0, 1)
    assert 0 <= mask_seed(2 ** 40, 7, 3) < 2 ** 32
    x, y = _binary_problem(n=900, d=4, seed=24)
    sds = _streaming_ds(pctx, x, y, shard_rows=300)
    try:
        runs = [StreamingGradientDescent(
            num_iterations=6, seed=8, mini_batch_fraction=frac).optimize(
                sds, aggregators.binary_logistic(4, False), np.zeros(4))
            for _ in range(2)]
        np.testing.assert_array_equal(runs[0][0], runs[1][0])
        assert runs[0][1] == runs[1][1]
    finally:
        sds.close()


@pytest.mark.parametrize("bad", [0, 3, 5])
@pytest.mark.parametrize("depth", [1, 2])
def test_staging_failure_reaches_the_consumer(pctx, monkeypatch, bad, depth):
    """A shard that fails to stage (the first, one inside, the last)
    raises in the consumer after the shards before it, the thread stops
    and the queue drains: no hang, no leaked thread."""
    x, y = _binary_problem(n=1200, d=4, seed=25)
    sds = _streaming_ds(pctx, x, y, shard_rows=200)
    read = StreamingDataset.read_into

    def flaky(self, i, *a, **k):
        if i == bad:
            raise IOError(f"shard {bad} is gone")
        return read(self, i, *a, **k)

    monkeypatch.setattr(StreamingDataset, "read_into", flaky)
    try:
        stream = ShardStream(sds, depth=depth)
        seen = []
        with pytest.raises(IOError, match=f"shard {bad}"):
            for i, _, _, _, slot in stream:
                seen.append(i)
                stream.release(slot)
        assert seen == list(range(bad))
        stream._thread.join(timeout=10)
        assert not stream._thread.is_alive()
        assert not any(t.name.startswith("cyclone-oocore")
                       for t in threading.enumerate())
    finally:
        sds.close()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_device_slots_are_bounded_by_depth(pctx, depth):
    """An epoch uses prefetchDepth + 1 slots whatever the shard count,
    and the fit's streamed epochs allocate them once."""
    pctx.conf.set("cyclone.oocore.prefetchDepth", str(depth))
    x, y = _binary_problem(n=3000, d=4, seed=26)
    sds = _streaming_ds(pctx, x, y, shard_rows=100)
    try:
        f = StreamingLossFunction(
            sds, aggregators.binary_logistic(4, False))
        f.sweep(torch.zeros(4, dtype=torch.float64))
        twins = [dict(t) for t in f._ring._twins]
        assert f._ring.n_slots == depth + 1 and all(twins)
        f.sweep(torch.zeros(4, dtype=torch.float64))
        assert all(f._ring._twins[j][k] is twins[j][k]
                   for j in range(depth + 1) for k in twins[j])
        assert f.n_dispatches == 2 * sds.n_shards == 60 and f.epochs == 2
        assert f.stats["shards"] == 60
    finally:
        sds.close()


def test_streaming_dataset_close_race_single_unlink(pctx, monkeypatch):
    """(tests/test_oocore.py:637) Concurrent closers unlink each shard
    file exactly once."""
    x, y = _binary_problem(n=600, d=4)
    sds = _streaming_ds(pctx, x, y, shard_rows=200)
    paths = [s.path for s in sds._shards]
    assert paths and all(os.path.exists(p) for p in paths)
    counts: Counter = Counter()
    count_lock = threading.Lock()
    real_unlink = os.unlink

    def counted(p, *a, **k):
        with count_lock:
            counts[p] += 1
        return real_unlink(p, *a, **k)

    monkeypatch.setattr(os, "unlink", counted)
    barrier = threading.Barrier(4)

    def closer():
        barrier.wait()
        sds.close()

    threads = [threading.Thread(target=closer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert {counts[p] for p in paths} == {1}
    assert not any(os.path.exists(p) for p in paths)
    sds.close()
    assert {counts[p] for p in paths} == {1}


# -- the fp8 stream -------------------------------------------------------------

@pytest.mark.parametrize("reg", [0.01, 0.1])
def test_fp8_stream_matches_incore_fp8(pctx, reg):
    """The fp8 shard set holds the in-core quantizer's codes and scale,
    and its streamed fit lands on the in-core fp8 fit up to summation
    order (the reference's own pin of this, tests/test_oocore.py:711,
    fails in the reference: ROADMAP "Reference caveats")."""
    x, y = _binary_problem(n=1500, d=8, seed=31)
    pctx.conf.set("cyclone.oocore.streamDtype", "float8")
    pctx.conf.set("cyclone.data.dtype", "float8")
    sds = _streaming_ds(pctx, x, y)
    try:
        assert sds.x_dtype == torch.float8_e4m3fn
        ds8 = InstanceDataset.from_numpy(pctx, x, y,
                                         dtype=torch.float8_e4m3fn)
        np.testing.assert_array_equal(sds.x_scale, ds8.x_scale)

        def est():
            return LogisticRegression(maxIter=30, regParam=reg, tol=1e-10)

        m_st = est().fit(sds)
        m_in = est().fit(ds8)
        assert m_st.summary.streamed and not pctx.precision_fallbacks
        np.testing.assert_allclose(m_st._coef, m_in._coef, **TOL)
        np.testing.assert_allclose(m_st._icpt, m_in._icpt, **TOL)
    finally:
        sds.close()


def test_fp8_stream_probe_refusal_stays_wide_and_visible(pctx):
    """(tests/test_oocore.py:728) An ill-conditioned column makes the
    probe refuse the fp8 rung for the SET: the spill stays at the write
    rung, the refusal is recorded, the fit completes."""
    x, y = _binary_problem(n=900, d=6, seed=32)
    x[:, 2] = 1000.0 + 0.01 * np.random.RandomState(1).randn(900)
    pctx.conf.set("cyclone.oocore.streamDtype", "float8")
    sds = _streaming_ds(pctx, x, y)
    try:
        assert sds.x_scale is None
        assert sds.x_dtype.itemsize > 1
        falls = pctx.precision_fallbacks
        assert len(falls) == 1
        assert falls[0]["from_dtype"] == "float8_e4m3fn"
        assert "absmax/std" in falls[0]["reason"]
        m = LogisticRegression(maxIter=8, regParam=0.1).fit(sds)
        assert m.summary.streamed
        assert np.all(np.isfinite(m._coef))
    finally:
        sds.close()


def test_fp8_set_to_a_consumer_that_is_not_fp8_capable(pctx):
    x, y = _binary_problem(n=800, d=5, seed=36)
    sds = _streaming_ds(pctx, x, y, stream_dtype="float8")
    try:
        wide = sds.to_instance_dataset(fp8_capable=False)
        try:
            assert wide.x_dtype == torch.bfloat16 and wide.x_scale is None
            assert pctx.precision_fallbacks[-1]["to_dtype"] == "bfloat16"
        finally:
            wide.close()
        assert sds.to_instance_dataset(fp8_capable=True) is sds
    finally:
        sds.close()


# -- stacked streamed fits ----------------------------------------------------

def test_streamed_stacked_fit_matches_serial_streamed(ctx, pctx):
    """(tests/test_oocore.py:761) fit_stacked over a shard set drives K
    models through ONE epoch a round: each model is its serial streamed
    fit (and the reference's stacked streamed model), and the epochs are
    the most any serial fit needs, not their sum."""
    RLR = _ref()[1]
    x, y = _binary_problem(n=2000, d=8, seed=33)
    sds = _streaming_ds(pctx, x, y)
    rsds = _ref_streaming_ds(ctx, x, y)
    regs = [0.0, 0.01, 0.1, 1.0]
    try:
        models = LogisticRegression(maxIter=40, tol=1e-9).fit_stacked(
            sds, reg_params=regs)
        ref = RLR(maxIter=40, tol=1e-9).fit_stacked(rsds, reg_params=regs)
        serial_evals = []
        for kk, r in enumerate(regs):
            m_ser = LogisticRegression(maxIter=40, tol=1e-9,
                                       regParam=r).fit(sds)
            np.testing.assert_allclose(models[kk]._coef, m_ser._coef, **TOL)
            np.testing.assert_allclose(models[kk]._icpt, m_ser._icpt,
                                       **TOL)
            _same_fit(models[kk], ref[kk])
            serial_evals.append(m_ser.summary.total_evals)
        s = models[0].summary
        assert s.streamed and s.n_models == len(regs)
        assert s.stacked_evals <= max(serial_evals)
        assert s.stacked_evals < sum(serial_evals)
        assert s.total_dispatches == s.stacked_evals * sds.n_shards
    finally:
        sds.close()
        rsds.close()


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_streamed_stacked_fit_with_a_label_stack(ctx, pctx, fit_intercept):
    """OneVsRest's form: a (K, n) label stack over a shard set, each model
    against the reference's."""
    RLR = _ref()[1]
    x, y = _binary_problem(n=1000, d=5, seed=37)
    y_stack = np.stack([y, 1.0 - y, (x[:, 0] > 0).astype(float)])
    sds = _streaming_ds(pctx, x, y)
    rsds = _ref_streaming_ds(ctx, x, y)
    try:
        kw = dict(maxIter=20, regParam=0.05, fitIntercept=fit_intercept)
        got = LogisticRegression(**kw).fit_stacked(sds, y_stack=y_stack)
        ref = RLR(**kw).fit_stacked(rsds, y_stack=y_stack)
        for g, r in zip(got, ref):
            _same_fit(g, r)
    finally:
        sds.close()
        rsds.close()


def test_streamed_stacked_sgd_matches_serial(pctx):
    """(tests/test_oocore.py:796) optimize_stacked: per-model labels by
    ``y_stack``, the mask shared across models by the TRUE shard index,
    each model its serial streamed run."""
    x, y = _binary_problem(n=1200, d=6, seed=34)
    sds = _streaming_ds(pctx, x, y, shard_rows=400)
    sds_flip = _streaming_ds(pctx, x, 1.0 - y, shard_rows=400)
    try:
        agg = aggregators.binary_logistic(6, fit_intercept=False)
        kw = dict(step_size=1.0, num_iterations=15, reg_param=0.01,
                  updater=SquaredL2Updater(), seed=7,
                  mini_batch_fraction=0.6)
        W, hists = StreamingGradientDescent(**kw).optimize_stacked(
            sds, agg, np.zeros((2, 6)), y_stack=np.stack([y, 1.0 - y]))
        w0, h0 = StreamingGradientDescent(**kw).optimize(sds, agg,
                                                         np.zeros(6))
        w1, h1 = StreamingGradientDescent(**kw).optimize(sds_flip, agg,
                                                         np.zeros(6))
        np.testing.assert_allclose(W[0], w0, **TOL)
        np.testing.assert_allclose(W[1], w1, **TOL)
        np.testing.assert_allclose(hists[0], h0, rtol=1e-9)
        np.testing.assert_allclose(hists[1], h1, rtol=1e-9)
    finally:
        sds.close()
        sds_flip.close()


def test_incore_stacked_gradient_descent_matches_reference(ctx, pctx):
    """The in-core StackedGradientDescent at fraction 1.0: each model the
    reference's stacked trajectory, and the serial GradientDescent's."""
    RDataset, ragg = _ref()[0], _ref()[3]
    from cycloneml_tpu.ml.optim.gradient_descent import (
        SquaredL2Updater as RL2, StackedGradientDescent as RSGD)
    from cycloneml_tpu_torch.ml.optim.gradient_descent import \
        StackedGradientDescent
    x, y = _binary_problem(n=900, d=5, seed=38)
    y_stack = np.stack([y, 1.0 - y])
    kw = dict(step_size=1.0, num_iterations=12, reg_param=0.01, seed=2)
    ds = InstanceDataset.from_numpy(pctx, x, y)
    yk = torch.zeros((ds.x.shape[0], 2), dtype=torch.float64)
    yk[:len(y)] = torch.from_numpy(y_stack.T)
    W, hists = StackedGradientDescent(updater=SquaredL2Updater(), **kw) \
        .optimize_stacked(ds.derive(y=yk),
                          aggregators.binary_logistic(5, False),
                          np.zeros((2, 5)))
    rds = RDataset.from_numpy(ctx, x, y)
    rpad = np.zeros((len(rds.y_host()), 2))
    rpad[rds.valid_indices()] = y_stack.T
    rt = ctx.mesh_runtime
    Wr, hr = RSGD(updater=RL2(), **kw).optimize_stacked(
        rds.derive(y=rt.device_put_sharded_rows(rpad)),
        ragg.binary_logistic(5, False), np.zeros((2, 5)))
    np.testing.assert_allclose(W, np.asarray(Wr), **TOL)
    for got, ref in zip(hists, hr):
        np.testing.assert_allclose(got, ref, rtol=1e-9)
    w0, h0 = GradientDescent(updater=SquaredL2Updater(), **kw).optimize(
        ds, aggregators.binary_logistic(5, False), np.zeros(5))
    np.testing.assert_allclose(W[0], w0, **TOL)


# -- the shard-set cache ------------------------------------------------------

def test_shard_set_cache_attach_hit_zero_respill(pctx):
    """(tests/test_oocore.py:829) A second attach is a HIT: a shared view
    of the same files, 0 spill-write bytes; closing one handle keeps the
    files for the other."""
    cache = shard_set_cache()
    cache.clear()
    x, y = _binary_problem(n=900, d=5, seed=35)
    ds = InstanceDataset.from_numpy(pctx, x, y)
    st0 = cache.stats()
    s1 = shard_dataset(ds, shard_rows=300)
    st1 = cache.stats()
    assert st1["misses"] == st0["misses"] + 1
    assert st1["spillWriteBytes"] > st0["spillWriteBytes"]
    try:
        s2 = shard_dataset(ds, shard_rows=300)
        st2 = cache.stats()
        assert st2["hits"] == st1["hits"] + 1
        assert st2["spillWriteBytes"] == st1["spillWriteBytes"]
        assert [a.path for a in s2._shards] == [a.path for a in s1._shards]
        m = LogisticRegression(maxIter=6, regParam=0.1).fit(s2)
        assert m.summary.streamed
        s2.close()
        assert all(os.path.exists(a.path) for a in s1._shards)
        m2 = LogisticRegression(maxIter=6, regParam=0.1).fit(s1)
        np.testing.assert_array_equal(m2._coef, m._coef)
    finally:
        s1.close()
        cache.clear()


def test_shard_set_cache_hit_takes_the_attaching_context(pctx):
    """A hit from another context's dataset of equal content serves that
    context (its device and conf), not the one the spill was made under;
    another accumulator tier misses."""
    cache = shard_set_cache()
    st0 = cache.stats()
    x, y = _binary_problem(n=600, d=4, seed=41)
    a = shard_dataset(InstanceDataset.from_numpy(pctx, x, y), shard_rows=200)
    pctx.stop()
    other = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                           .set("cyclone.compute.dtype", "float64"))
    try:
        b = shard_dataset(InstanceDataset.from_numpy(other, x, y),
                          shard_rows=200)
        assert cache.stats()["hits"] == st0["hits"] + 1 and b.ctx is other
        m = LogisticRegression(maxIter=4, regParam=0.1).fit(b)
        assert m.summary.streamed
        b.close()
    finally:
        other.stop()
    f32 = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    try:
        c = shard_dataset(InstanceDataset.from_numpy(
            f32, x, y, dtype=torch.float64), shard_rows=200)
        assert cache.stats()["misses"] == st0["misses"] + 2 \
            and c.y_dtype == torch.float32
        c.close()
    finally:
        f32.stop()
    a.close()


def test_shard_set_cache_keying_negatives(pctx):
    """(tests/test_oocore.py:859) Other data, another geometry and another
    stream tier each MISS."""
    cache = shard_set_cache()
    cache.clear()
    x, y = _binary_problem(n=800, d=5, seed=36)
    x2 = x.copy()
    x2[0, 0] += 1.0
    ds = InstanceDataset.from_numpy(pctx, x, y)
    ds2 = InstanceDataset.from_numpy(pctx, x2, y)
    st0 = cache.stats()
    handles = [shard_dataset(ds, shard_rows=300)]
    try:
        handles.append(shard_dataset(ds, shard_rows=128))
        handles.append(shard_dataset(ds2, shard_rows=300))
        pctx.conf.set("cyclone.oocore.streamDtype", "float8")
        handles.append(shard_dataset(ds, shard_rows=300))
        pctx.conf.remove("cyclone.oocore.streamDtype")
        st = cache.stats()
        assert st["hits"] == st0["hits"]
        assert st["misses"] == st0["misses"] + 4
    finally:
        for h in handles:
            h.close()
        cache.clear()


def test_shard_set_cache_eviction_pins_live_streams(pctx):
    """(tests/test_oocore.py:886) LRU eviction never takes an entry with a
    live handle: under a bound of one entry, the released entry goes and
    the pinned one still serves a fit."""
    cache = shard_set_cache()
    cache.clear()
    probs = [_binary_problem(n=900, d=6, seed=s) for s in (37, 38, 39)]
    dss = [InstanceDataset.from_numpy(pctx, x, y) for x, y in probs]
    st0 = cache.stats()
    live = shard_dataset(dss[0], shard_rows=300)
    nb = cache.stats()["bytes"]
    assert nb > 0
    pctx.conf.set("cyclone.oocore.cacheBytes", str(nb))
    try:
        other = shard_dataset(dss[1], shard_rows=300)
        other_paths = [s.path for s in other._shards]
        other.close()
        third = shard_dataset(dss[2], shard_rows=300)
        third.close()
        st = cache.stats()
        assert st["evictionsLru"] >= st0["evictionsLru"] + 1
        assert not any(os.path.exists(p) for p in other_paths)
        assert all(os.path.exists(s.path) for s in live._shards)
        m = LogisticRegression(maxIter=5, regParam=0.1).fit(live)
        assert m.summary.streamed
    finally:
        live.close()
        cache.clear()


def test_shard_set_cache_bypass_modes(pctx, tmp_path):
    """(tests/test_oocore.py:914) cacheBytes=0 and an explicit spill_dir
    build a set that OWNS its files; a corrupted cached shard is caught at
    attach and rebuilt."""
    cache = shard_set_cache()
    cache.clear()
    x, y = _binary_problem(n=600, d=4, seed=40)
    ds = InstanceDataset.from_numpy(pctx, x, y)
    pctx.conf.set("cyclone.oocore.cacheBytes", "0")
    st0 = cache.stats()
    sds = shard_dataset(ds, shard_rows=200)
    assert cache.stats() == st0
    paths = [s.path for s in sds._shards]
    sds.close()
    assert not any(os.path.exists(p) for p in paths)
    pctx.conf.remove("cyclone.oocore.cacheBytes")
    own = shard_dataset(ds, shard_rows=200, spill_dir=str(tmp_path / "s"))
    assert cache.stats() == st0 and own._shards[0].path.startswith(
        str(tmp_path))
    own.close()
    try:
        a = shard_dataset(ds, shard_rows=200)
        with open(a._shards[1].path, "r+b") as fh:
            fh.write(b"\x01\x02")
        a.close()
        b = shard_dataset(ds, shard_rows=200)
        assert cache.stats()["evictionsCorrupt"] == 1
        np.testing.assert_array_equal(b.load_shard(1)[0].numpy(),
                                      x[200:400])
        b.close()
    finally:
        cache.clear()


# -- host memory ----------------------------------------------------------------

_STREAM_RSS_SCRIPT = textwrap.dedent("""
    import resource, sys
    import numpy as np
    from cycloneml_tpu_torch import CycloneConf, CycloneContext
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.oocore import StreamingDataset

    n, d, shard_rows = (int(a) for a in sys.argv[1:4])
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    rng = np.random.RandomState(4)
    beta = rng.randn(d)

    def chunks():
        done = 0
        while done < n:
            m = min(32768, n - done)
            xc = rng.randn(m, d).astype(np.float32)
            yield xc, (xc @ beta > 0).astype(np.float64), None
            done += m

    sds = StreamingDataset.from_chunks(ctx, chunks(), d,
                                       shard_rows=shard_rows)
    model = LogisticRegression(maxIter=3, regParam=0.1).fit(sds)
    assert model.summary.streamed and sds.n_rows == n
    sds.close()
    print("PEAK_RSS_KB", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
""")


def test_streamed_fit_rss_is_shard_bounded():
    """(tests/test_oocore.py:525) generate, shard and fit in a fresh
    process without the matrix ever whole: peak RSS over a tiny run stays
    well under the dataset's float32 bytes (on the CPU the device slots
    are host memory too, so this bounds them as well)."""
    n, d, shard_rows = 640_000, 64, 32768
    ds_bytes = n * d * 4
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)

    def run(n_):
        out = subprocess.run(
            [sys.executable, "-c", _STREAM_RSS_SCRIPT, str(n_), str(d),
             str(shard_rows)], capture_output=True, text=True, env=env,
            timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        return int(out.stdout.split("PEAK_RSS_KB")[1])

    base_kb = run(4096)
    peak_kb = run(n)
    extra = (peak_kb - base_kb) * 1024
    assert extra < 0.5 * ds_bytes, (base_kb, peak_kb, ds_bytes)


# -- the card -------------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


_SPIN = 50_000_000   # clock cycles of torch.cuda._sleep


def _card_shards(ctx, n=24 * 2048, d=256, shard_rows=2048, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = (rng.rand(n) > 0.5).astype(np.float64)
    sds = StreamingDataset.from_chunks(
        ctx, _chunks(x, y, 5000), d, shard_rows=shard_rows,
        stream_dtype="bfloat16")
    return sds


@pytest.mark.gpu
@pytest.mark.parametrize("hold", ["copies", "kernels"])
def test_cuda_slot_reuse_waits_for_copies_and_kernels(monkeypatch, hold):
    """Each shard's sum on the card equals its file's, with every copy
    (``hold="copies"``: a spin ahead of it on the copy stream, so only
    the host's wait on a slot's earlier copy keeps its pinned buffer from
    being rewritten under it) or every kernel (``hold="kernels"``: a spin
    ahead of the read on the caller's stream, so only the copy stream's
    wait on the consumed event keeps the next copy out of the device twin)
    landing late. Two slots (depth 1) over 24 shards: every slot is
    reused 11 times."""
    _need_cuda()
    from cycloneml_tpu_torch.dataset.staging import StagingRing
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    try:
        sds = _card_shards(ctx)
        want = [sds.load_shard(i)[0].double().sum().item()
                for i in range(sds.n_shards)]
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        if hold == "copies":
            put = StagingRing.put_into

            def late_put(self, slot, views, twins):
                with torch.cuda.stream(self.stream):
                    torch.cuda._sleep(_SPIN)
                return put(self, slot, views, twins)
            monkeypatch.setattr(StagingRing, "put_into", late_put)
        stream = ShardStream(sds, depth=1)
        got = {}
        for i, x, _, _, slot in stream:
            if hold == "kernels":
                torch.cuda._sleep(_SPIN)
            got[i] = x.double().sum()
            stream.release(slot)
        torch.cuda.synchronize()
        assert sorted(got) == list(range(sds.n_shards))
        assert [got[i].item() for i in range(sds.n_shards)] == want
        sds.close()
    finally:
        ctx.stop()


@pytest.mark.gpu
def test_cuda_short_shard_lands_on_a_zero_tail():
    """Two slots over shards of 512, 512 and 100 rows: the short shard
    lands in the slot the first filled with large values, and the rows of
    its device twins past its own are zero (so K1 adds exactly 0 for them,
    never 0 * a stale overflow); the streamed K1 sweep matches the CPU's
    plain one within K1's tolerance."""
    _need_cuda()
    rng = np.random.RandomState(5)
    d = 64
    x = rng.randn(2 * 512 + 100, d).astype(np.float32)
    x[:512] *= 1e3
    y = (rng.rand(len(x)) > 0.5).astype(np.float64)
    coef = np.full(d + 1, 1.0 / d)

    def sweep_on(master):
        ctx = CycloneContext(CycloneConf().set("cyclone.master", master)
                             .set("cyclone.oocore.prefetchDepth", "1"))
        try:
            sds = StreamingDataset.from_chunks(
                ctx, _chunks(x, y, 300), d, shard_rows=512,
                stream_dtype="bfloat16")
            assert [s.rows for s in sds._shards] == [512, 512, 100]
            stream = ShardStream(sds)
            tails = {}
            for i, xs, ys, ws, slot in stream:
                rows = sds._shards[i].rows
                tails[(i, slot)] = float(xs[rows:].float().abs().sum()
                                         + ys[rows:].abs().sum()
                                         + ws[rows:].abs().sum())
                stream.release(slot)
            assert tails == {(0, 0): 0.0, (1, 1): 0.0, (2, 0): 0.0}
            dev = ctx.mesh_runtime.device
            f = StreamingLossFunction(
                sds, aggregators.binary_logistic_pallas_scaled(d, True),
                extra_args=(torch.ones(d, device=dev),
                            torch.zeros(d, device=dev)))
            out = f.sweep(*f._extras, torch.as_tensor(coef, device=dev))
            sds.close()
            return out
        finally:
            ctx.stop()

    got, want = sweep_on("cuda"), sweep_on("cpu")
    assert got["count"] == want["count"] == len(x)
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    np.testing.assert_allclose(got["grad"], want["grad"], rtol=0,
                               atol=1e-4 * np.abs(want["grad"]).max())
