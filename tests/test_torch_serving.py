"""The port's model server (``cycloneml_tpu_torch/serving``) against the
JAX package's, on the same numpy models and rows.

The cases of the reference's tests/test_serving.py and the serving cases
of tests/test_chaos.py, run through the port on the CPU
(``cyclone.master=cpu``, where each bucket's program is the margins
kernel's plain twin): the compile ledger (one entry a bucket at
registration, none a request), coalescing, admission control, gangs,
bucket-padding parity, observability, the quantized tier and the chaos
paths. The SQL scoring endpoint, the Kafka source and the status store
are ROADMAP Queue 1 item 12.

Parity with the reference: its jitted ``linear_margins`` family against
the port's plain path within 1e-12 (float64) and 1e-6 (float32) of the
margin scale, equal labels from both servers, and the quantized codes bit
for bit.

The ``gpu`` tests hold the kernel (``csrc/serving_margins.cu``) against its
plain twin bit for bit, and the CUDA graphs a lane captures; the card's
machine has no jax, so the reference is imported inside the tests that use
it:

    python -m pytest --noconftest -m gpu tests/test_torch_serving.py
"""

import threading
import time

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.ml.classification.linear_svc import LinearSVCModel
from cycloneml_tpu_torch.ml.classification.logistic_regression import (
    LogisticRegressionModel,
)
from cycloneml_tpu_torch.ml.regression.linear_regression import (
    LinearRegressionModel,
)
from cycloneml_tpu_torch.observe import tracing
from cycloneml_tpu_torch.ops import kernels
from cycloneml_tpu_torch.parallel.faults import (FaultInjector, FaultSchedule,
                                                 TransientCollectiveError)
from cycloneml_tpu_torch.serving import (
    ModelServer, ServingError, ServingOverloaded, as_servable, bucket_for,
    bucket_sizes, pad_rows,
)

rng = np.random.default_rng(7)


def _cpu(**settings):
    conf = CycloneConf().set("cyclone.master", "cpu")
    for k, v in settings.items():
        conf.set(k, v)
    return conf


def _server(**kw):
    """A server on the CPU with no context (the reference's ctx=None)."""
    return ModelServer(ctx=None, conf=kw.pop("conf", None) or _cpu(), **kw)


def _binary_lr(d, seed=0):
    r = np.random.default_rng(seed)
    return LogisticRegressionModel(r.normal(size=(1, d)),
                                   r.normal(size=(1,)), 2, False)


def _bucketed_margins(lane, x, bucket, dtype):
    return lane.bucket_margins(pad_rows(np.asarray(x, dtype=dtype), bucket),
                               bucket)


# -- buckets --------------------------------------------------------------------

def test_bucket_helpers():
    assert bucket_sizes(64) == (1, 2, 4, 8, 16, 32, 64)
    assert bucket_sizes(100) == (1, 2, 4, 8, 16, 32, 64, 128)
    assert bucket_for(1, 64) == 1
    assert bucket_for(33, 64) == 64
    assert bucket_for(100, 100) == 128
    with pytest.raises(ValueError):
        bucket_for(65, 64)
    with pytest.raises(ValueError):
        bucket_for(0, 64)
    x = np.ones((3, 2))
    p = pad_rows(x, 8)
    assert p.shape == (8, 2) and np.all(p[3:] == 0) and np.all(p[:3] == 1)
    assert pad_rows(x, 3) is x  # exact fit: no copy


# -- the compile ledger -----------------------------------------------------------

def test_one_compile_per_bucket_never_per_request():
    """Concurrent mixed-row-count requests leave the ledger where
    registration put it: one entry a bucket, by the lane's table, the
    compile counts and the compile spans."""
    d = 23
    tracer = tracing.enable()
    try:
        srv = _server(max_batch=16, window_ms=2)
        srv.register("m", _binary_lr(d))
        lane = srv._lane("m")
        n_buckets = len(lane.buckets)
        assert lane.buckets == (1, 2, 4, 8, 16)
        compile_spans = [s for s in tracer.snapshot()
                         if s.kind == "compile" and s.name == "serving/m"]
        assert len(compile_spans) == n_buckets
        assert all(s.attrs.get("compiled") for s in compile_spans)
        assert srv.compile_counts()["m"] == n_buckets
        assert lane._cache_size() == n_buckets
        errors = []

        def fire(n_rows):
            try:
                srv.predict("m", rng.normal(size=(n_rows, d)))
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=fire, args=(n,))
                   for n in (1, 2, 3, 5, 7, 8, 11, 16, 1, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        assert srv.compile_counts()["m"] == n_buckets
        assert lane._cache_size() == n_buckets
        assert len([s for s in tracer.snapshot()
                    if s.kind == "compile"
                    and s.name == "serving/m"]) == n_buckets
        assert srv.stats()["models"]["m"]["requests"] == 10
        srv.stop()
    finally:
        tracing.disable()


def test_concurrent_traffic_keeps_every_tally():
    """More client threads than cores on three lanes, the interpreter
    switching threads every microsecond: every answer is its own request's
    and no tally loses an update (the lanes' counts under their locks,
    the registry's counters)."""
    import os
    import sys
    d = 9
    models = {f"m{i}": _binary_lr(d, seed=70 + i) for i in range(3)}
    srv = _server(max_batch=16, window_ms=1)
    for name, m in models.items():
        srv.register(name, m)
    n_threads = 2 * (os.cpu_count() or 2) + 2
    per_thread = 12
    rows, bad, errors = [], [], []
    lock = threading.Lock()

    def client(i):
        r = np.random.default_rng(100 + i)
        for j in range(per_thread):
            name = f"m{(i + j) % 3}"
            x = r.normal(size=(int(r.integers(1, 9)), d))
            try:
                got = srv.predict(name, x, timeout=60)
            except Exception as e:
                errors.append(e)
                continue
            with lock:
                rows.append(x.shape[0])
                if not np.array_equal(got, models[name]._predict_batch(x)):
                    bad.append((name, x.shape[0]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not bad
    total = srv.stats()["totals"]
    assert total["requests"] == n_threads * per_thread == len(rows)
    assert total["rows"] == sum(rows)
    values = srv.registry.values()
    assert values["serving.requests"] == total["requests"]
    assert values["serving.rows"] == total["rows"]
    assert values["serving.batches"] == total["batches"]
    assert values["serving.latency.count"] == total["requests"]
    srv.stop()


def test_same_signature_lanes_each_prepare_their_buckets():
    """A lane's programs bind its own parameters (on the card a graph
    holds their addresses), so a second model of the same signature pays
    its own bucket set, where the reference's shares one executable."""
    d = 21
    srv = _server(max_batch=8, window_ms=0)
    srv.register("a", _binary_lr(d, seed=1))
    srv.register("b", _binary_lr(d, seed=2))
    assert srv.compile_counts() == {"a": 4, "b": 4}
    x = rng.normal(size=(3, d))
    assert not np.array_equal(srv._lane("a").bucket_margins(x, 4),
                              srv._lane("b").bucket_margins(x, 4))
    srv.stop()


# -- coalescing ------------------------------------------------------------------

def test_batcher_coalesces_concurrent_requests():
    d = 24
    srv = _server(max_batch=64, window_ms=150)
    srv.register("m", _binary_lr(d))
    model = srv._lane("m").servable.model
    x = rng.normal(size=(2, d))
    ref = model._predict_batch(x)
    results, errors = [], []
    barrier = threading.Barrier(4)

    def fire():
        try:
            barrier.wait(timeout=10)
            results.append(srv.predict("m", x))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=fire) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(results) == 4
    for r in results:  # everyone gets their own answer back
        assert np.array_equal(r, ref)
    st = srv.stats()["models"]["m"]
    assert st["requests"] == 4
    assert st["batches"] < 4
    assert st["coalesced"] >= 2
    srv.stop()


# -- admission control -----------------------------------------------------------

def test_admission_queues_then_sheds_under_tiny_budget():
    """An impossible memory budget sheds with a 503 after queued patience:
    never a MemoryBudgetError (even under budgetAction=raise), never a
    hang, and the over-budget program never runs."""
    d = 25
    conf = _cpu(**{"cyclone.memory.budgetFraction": 0.5,
                   "cyclone.memory.deviceBytes": 1,
                   "cyclone.memory.budgetAction": "raise"})
    srv = _server(conf=conf, max_batch=8, window_ms=5, shed_after_ms=80)
    srv.register("m", _binary_lr(d))
    lane = srv._lane("m")
    assert lane.peaks, "an armed guard predicts every bucket's peak"
    t0 = time.perf_counter()
    with pytest.raises(ServingOverloaded) as ei:
        srv.predict("m", rng.normal(size=(3, d)), timeout=30)
    assert ei.value.status == 503
    assert time.perf_counter() - t0 < 20  # shed, not hung
    st = srv.stats()["models"]["m"]
    assert st["shed"] >= 1
    assert st["requeues"] >= 1  # it queued (backpressure) before shedding
    assert st["batches"] == 0
    srv.stop()


def test_admission_verdict_cached_and_harvest_shared(monkeypatch):
    """The requeue loop does not re-check the budget every window:
    check_budget runs once a bucket, and a second same-signature model's
    registration checks nothing (the port predicts peaks from shapes, so
    there is no analysis to share)."""
    from cycloneml_tpu_torch.observe import costs
    d = 19
    calls = []
    real = costs.check_budget

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(costs, "check_budget", counting)
    conf = _cpu(**{"cyclone.memory.budgetFraction": 0.5,
                   "cyclone.memory.deviceBytes": 1})
    srv = _server(conf=conf, max_batch=8, window_ms=2, shed_after_ms=60)
    srv.register("a", _binary_lr(d, seed=1))
    srv.register("b", _binary_lr(d, seed=2))
    assert not calls
    assert srv._lane("a").peaks == srv._lane("b").peaks
    with pytest.raises(ServingOverloaded):
        srv.predict("a", rng.normal(size=(2, d)), timeout=30)
    assert srv.stats()["models"]["a"]["requeues"] >= 1
    assert len(calls) == 1  # one verdict for the one touched bucket
    srv.stop()


def test_try_cancel_fails_queued_sibling():
    from cycloneml_tpu_torch.serving.batcher import ModelLane, _Request
    d = 20
    srv = _server(max_batch=8, window_ms=0)
    srv.register("m", _binary_lr(d))
    # a lane whose worker never starts: submissions stay queued, the state
    # predict()'s unwind path sees
    lane = ModelLane("probe", srv._lane("m").servable, srv)
    fut = lane.submit(np.zeros((2, d)))
    assert lane.try_cancel(fut)
    with pytest.raises(ServingOverloaded, match="shed as a unit"):
        fut.result(timeout=1)
    assert not lane.try_cancel(fut)  # already gone
    # a requeue racing stop() fails the futures instead of stranding them
    req = _Request(np.zeros((1, d)))
    lane._stop = True
    lane._requeue_front([req])
    with pytest.raises(ServingOverloaded, match="stopped"):
        req.future.result(timeout=1)
    srv.stop()


def test_queue_full_backpressure_sheds_fast():
    d = 26
    sched = FaultSchedule(seed=0)
    # slow every dispatch so the queue can fill
    sched.window("serving.dispatch", 1, 1000, delay_s=0.05)
    srv = _server(max_batch=1, window_ms=0, max_queue=2)
    srv.register("m", _binary_lr(d))
    outcomes = []

    def fire():
        try:
            srv.predict("m", rng.normal(size=(1, d)))
            outcomes.append("ok")
        except ServingOverloaded:
            outcomes.append("shed")

    with FaultInjector(sched):
        threads = [threading.Thread(target=fire) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert len(outcomes) == 12
    assert "shed" in outcomes   # the bounded queue pushed back
    assert "ok" in outcomes     # while admitted requests kept serving
    srv.stop()


# -- gangs ------------------------------------------------------------------------

def test_gang_serving_matches_serial_predict():
    d, k = 27, 3
    models = [_binary_lr(d, seed=s) for s in range(k)]
    srv = _server(max_batch=16, window_ms=2)
    info = srv.register_gang("gang", models)
    assert info["gang"] == k
    x = rng.normal(size=(9, d))
    preds = srv.predict("gang", x)
    assert isinstance(preds, list) and len(preds) == k
    for kk in range(k):
        assert np.array_equal(preds[kk], models[kk]._predict_batch(x))
    # one program a bucket for K models
    assert srv.compile_counts()["gang"] == len(bucket_sizes(16))
    srv.stop()


def test_gang_requires_homogeneous_models():
    from cycloneml_tpu_torch.serving import GangServable
    with pytest.raises(ValueError, match="homogeneous"):
        GangServable([as_servable(_binary_lr(5)), as_servable(_binary_lr(6))])
    with pytest.raises(TypeError, match="no servable adapter"):
        as_servable(object())


def test_duplicate_and_oversize_guards():
    d = 18
    srv = _server(max_batch=8, window_ms=0)
    srv.register("m", _binary_lr(d))
    with pytest.raises(ValueError, match="already registered"):
        srv.register("m", _binary_lr(d))
    with pytest.raises(ValueError, match="exceeds maxBatch"):
        srv._lane("m").submit(np.zeros((9, d)))
    x = rng.normal(size=(3, d))
    assert srv.predict("m", x).shape == (3,)
    srv.stop()


def test_large_request_splits_under_one_deadline():
    """A request above maxBatch rows splits into maxBatch-row
    sub-requests and comes back whole, in order."""
    d = 22
    model = _binary_lr(d, seed=4)
    srv = _server(max_batch=8, window_ms=0)
    srv.register("m", model)
    x = rng.normal(size=(30, d))
    assert np.array_equal(srv.predict("m", x), model._predict_batch(x))
    assert srv.stats()["models"]["m"]["requests"] == 4
    srv.stop()


# -- bucket-padding parity -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bucket_padding_parity_serial(dtype):
    """A row's margins are bitwise identical whatever bucket carries it,
    and the served predictions match the model's own predict: the labels
    exactly, the margins within 1e-6 (float32) or 1e-12 (float64) of the
    float64 host margins."""
    d = 28 if dtype == "float32" else 29
    model = _binary_lr(d, seed=3)
    srv = _server(max_batch=8, window_ms=0, dtype=dtype)
    srv.register("m", model)
    lane = srv._lane("m")
    B = 8
    x = rng.normal(size=(B + 1, d))
    m1 = _bucketed_margins(lane, x[:1], 1, dtype)
    mB = _bucketed_margins(lane, x[:B], B, dtype)
    m_pad = _bucketed_margins(lane, x[:3], B, dtype)[:3]
    assert mB.dtype == np.dtype(dtype)
    assert np.array_equal(m1[0], mB[0])
    assert np.array_equal(mB[:3], m_pad)
    preds = srv.predict("m", x)
    assert np.array_equal(preds, model._predict_batch(x))
    host_margins = lane.servable.host_margins(x.astype(dtype))
    tol = 1e-6 if dtype == "float32" else 1e-12
    mfull = np.concatenate([mB, _bucketed_margins(lane, x[B:], 1, dtype)])
    assert np.max(np.abs(mfull - host_margins)) <= tol * max(
        1.0, np.max(np.abs(host_margins)))
    srv.stop()


def test_bucket_padding_parity_bf16_tier_fit():
    """A model fitted under the bf16 data tier serves through the f32
    kernel within 1e-6 of its own host predict."""
    d = 30
    r = np.random.default_rng(5)
    coef = torch.as_tensor(r.normal(size=(1, d))).to(torch.bfloat16) \
        .double().numpy()
    model = LogisticRegressionModel(coef, r.normal(size=(1,)), 2, False)
    srv = _server(max_batch=8, window_ms=0, dtype="float32")
    srv.register("m", model)
    lane = srv._lane("m")
    x = r.normal(size=(9, d))
    got = np.concatenate([
        _bucketed_margins(lane, x[:8], 8, "float32")[:8],
        _bucketed_margins(lane, x[8:], 1, "float32")])
    host = lane.servable.host_margins(x)
    assert np.max(np.abs(got - host)) <= 1e-6 * max(
        1.0, np.max(np.abs(host)))
    assert np.array_equal(srv.predict("m", x), model._predict_batch(x))
    srv.stop()


def test_bucket_padding_parity_stacked():
    """Gang margins: bitwise bucket-invariant a row and bitwise equal to
    each serial lane's margins."""
    d, k = 31, 3
    models = [_binary_lr(d, seed=10 + s) for s in range(k)]
    srv = _server(max_batch=8, window_ms=0, dtype="float32")
    srv.register_gang("g", models)
    for m_i, m in enumerate(models):
        srv.register(f"s{m_i}", m)
    glane = srv._lane("g")
    x = rng.normal(size=(9, d)).astype("float32")
    g1 = _bucketed_margins(glane, x[:1], 1, "float32")      # (k, 1, 1)
    g8 = _bucketed_margins(glane, x[:8], 8, "float32")      # (k, 8, 1)
    gpad = _bucketed_margins(glane, x[:3], 8, "float32")[:, :3, :]
    assert np.array_equal(g1[:, 0], g8[:, 0])
    assert np.array_equal(g8[:, :3], gpad)
    for m_i in range(k):
        serial = _bucketed_margins(srv._lane(f"s{m_i}"), x[:8], 8, "float32")
        assert np.array_equal(g8[m_i], serial)
    gp = srv.predict("g", x)
    for m_i in range(k):
        assert np.array_equal(gp[m_i], srv.predict(f"s{m_i}", x))
    srv.stop()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("quantized", [False, True])
def test_plain_twin_bits_do_not_depend_on_bucket_or_models(dtype, quantized):
    """The plain twin's order depends on neither B nor K: every bucket and
    every gang width gives a row's margins the same bits, at widths that
    are and are not multiples of a warp."""
    from cycloneml_tpu_torch.serving.servable import _quantize_rows
    r = np.random.default_rng(13)
    for d in (7, 32, 77):
        coef = r.normal(size=(5, 2, d))
        icpt = r.normal(size=(5, 2))
        x = torch.as_tensor(r.normal(size=(16, d))).to(dtype)
        if quantized:
            c, s, i = _quantize_rows(coef, icpt, dtype)
        else:
            c, s = torch.as_tensor(coef).to(dtype), None
            i = torch.as_tensor(icpt).to(dtype)
        full = kernels.serving_margins(x, c, i, s)
        for b in (1, 3, 8):
            xp = torch.zeros((16, d), dtype=dtype)
            xp[:b] = x[:b]
            got = kernels.serving_margins(xp, c, i, s)[:, :b]
            assert torch.equal(got, full[:, :b])
            one = kernels.serving_margins(x[:b], c[1:2], i[1:2],
                                          None if s is None else s[1:2])
            assert torch.equal(one[0], full[1, :b])


# -- servable coverage -------------------------------------------------------------

def test_multinomial_and_regression_servables():
    d, k = 13, 4
    r = np.random.default_rng(11)
    mn = LogisticRegressionModel(r.normal(size=(k, d)), r.normal(size=(k,)),
                                 k, True)
    reg = LinearRegressionModel(r.normal(size=(d,)), 0.25)
    svc = LinearSVCModel(r.normal(size=(d,)), -0.5)
    srv = _server(max_batch=8, window_ms=0)
    srv.register("mn", mn)
    srv.register("reg", reg)
    srv.register("svc", svc)
    x = r.normal(size=(6, d))
    assert np.array_equal(srv.predict("mn", x), mn._predict_batch(x))
    assert np.array_equal(srv.predict("svc", x), svc._predict_batch(x))
    assert np.allclose(srv.predict("reg", x), reg._predict_batch(x),
                       rtol=0, atol=1e-5)
    assert srv.predict("reg", x[0]).shape == (1,)
    assert srv.predict("reg", np.zeros((0, d))).shape == (0,)
    with pytest.raises(ValueError, match="expects"):
        srv.predict("reg", np.zeros((2, d + 1)))
    with pytest.raises(KeyError, match="no model"):
        srv.predict("nope", x)
    srv.stop()


# -- observability ----------------------------------------------------------------

def test_request_spans_and_latency_metrics():
    from cycloneml_tpu_torch.util.metrics import MetricsRegistry
    d = 32
    tracer = tracing.enable()
    try:
        srv = _server(max_batch=8, window_ms=2, registry=MetricsRegistry())
        srv.register("m", _binary_lr(d))
        srv.predict("m", rng.normal(size=(3, d)))
        spans = tracer.snapshot()
        batch_spans = [s for s in spans
                       if s.kind == "serving" and s.name == "m"]
        req_spans = [s for s in spans
                     if s.kind == "serving" and s.name == "request"]
        assert batch_spans and req_spans
        rs = req_spans[0]
        assert rs.parent_id == batch_spans[0].span_id
        assert rs.attrs["model"] == "m" and rs.attrs["rows"] == 3
        assert rs.attrs["queue_s"] >= 0 and rs.attrs["dispatch_s"] > 0
        assert rs.duration_s >= rs.attrs["dispatch_s"]
        lat = srv.registry.timer("serving.latency").snapshot()
        assert lat["count"] == 1 and lat["p99"] >= lat["p50"] > 0
        srv.stop()
    finally:
        tracing.disable()


def test_histogram_p99_and_prometheus_summary():
    from cycloneml_tpu_torch.util.metrics import (
        MetricsRegistry, prometheus_text,
    )
    reg = MetricsRegistry()
    t = reg.timer("serving.latency")
    for i in range(100):
        t.update(i / 1000.0)
    snap = t.snapshot()
    assert snap["p50"] <= snap["p95"] <= snap["p99"] <= snap["max"]
    assert snap["p99"] == 0.098  # 99th of 0..99 ms
    text = prometheus_text(reg.values(), types=reg.types())
    assert 'cyclone_serving_latency{quantile="0.5"}' in text
    assert 'cyclone_serving_latency{quantile="0.99"} 0.098' in text
    assert "cyclone_serving_latency_p99" not in text
    reg.counter('req.total{model="a",tenant="t"}').inc(3)
    reg.gauge("mem", lambda: 1 / 0)  # a gauge that raises is skipped
    text = prometheus_text(reg.values(), types=reg.types())
    assert 'cyclone_req_total{model="a",tenant="t"} 3' in text
    assert "cyclone_mem" not in text


def test_serving_stats_reach_the_context_registry():
    """A server on a context feeds the context's registry (the reference
    also posts its rollup to the status store, ROADMAP item 12)."""
    d = 14
    ctx = CycloneContext(_cpu())
    try:
        srv = ModelServer(ctx, max_batch=8, window_ms=2)
        assert srv.registry is ctx.metrics_registry
        assert srv.device.type == "cpu"
        srv.register("store-m", _binary_lr(d))
        srv.predict("store-m", rng.normal(size=(2, d)))
        srv.stop()
        values = ctx.metrics_registry.values()
        assert values["serving.requests"] >= 1
        assert values["serving.compiles"] == len(bucket_sizes(8))
        m = srv.stats()["models"]["store-m"]
        assert m["latencyMs"]["p99"] >= m["latencyMs"]["p50"] > 0
    finally:
        ctx.stop()


# -- ingestion surfaces -----------------------------------------------------------

def test_streaming_featurize_predict_sink():
    """A micro-batch's feature column scores through the batcher into the
    inner sink (y = 2x + 1); a replayed batch id is dropped there."""
    from cycloneml_tpu_torch.serving.streaming import ScoringSink
    from cycloneml_tpu_torch.streaming.sinks import MemorySink
    model = LinearRegressionModel(np.array([2.0]), 1.0)
    srv = _server(max_batch=8, window_ms=0, dtype="float64")
    srv.register("m", model)
    inner = MemorySink()
    sink = ScoringSink(srv, "m", ["f"], inner)
    sink.add_batch(0, {"f": np.array([1.5, -2.0])}, "append")
    sink.add_batch(0, {"f": np.array([9.0])}, "append")  # replayed id
    batch = inner.to_batch()
    assert sorted(batch) == ["f", "prediction"]
    got = dict(zip(batch["f"], batch["prediction"]))
    assert got == {1.5: 4.0, -2.0: -3.0}
    assert inner.rows() == [(1.5, 4.0), (-2.0, -3.0)]
    srv.stop()


def test_streaming_scoring_sink_gang_and_empty():
    from cycloneml_tpu_torch.serving.streaming import ScoringSink
    from cycloneml_tpu_torch.streaming.sinks import MemorySink
    d, k = 17, 2
    models = [_binary_lr(d, seed=30 + s) for s in range(k)]
    srv = _server(max_batch=8, window_ms=0)
    srv.register_gang("g", models)
    inner = MemorySink()
    sink = ScoringSink(srv, "g", [f"f{i}" for i in range(d)], inner)
    x = rng.normal(size=(3, d))
    sink.add_batch(0, {f"f{i}": x[:, i] for i in range(d)}, "append")
    sink.add_batch(1, {f"f{i}": np.array([]) for i in range(d)}, "append")
    out = inner.to_batch()
    for kk in range(k):
        assert np.array_equal(out[f"prediction.{kk}"],
                              models[kk]._predict_batch(x))
    srv.stop()


# -- the quantized tier (cyclone.serving.quantize) ---------------------------------

def test_quantized_predictions_within_envelope():
    from cycloneml_tpu_torch.serving.servable import Servable
    d = 41
    r = np.random.default_rng(3)
    coef, icpt = r.normal(size=(1, d)), r.normal(size=(1,))
    x = r.normal(size=(13, d))
    srv_p = _server(max_batch=16, window_ms=0)
    srv_p.register("m", Servable(None, coef, icpt, "scalar"))
    plain = srv_p.predict("m", x)
    srv_p.stop()
    srv_q = _server(max_batch=16, window_ms=0, quantize=True)
    srv_q.register("m", Servable(None, coef, icpt, "scalar"))
    quant = srv_q.predict("m", x)
    assert srv_q.stats()["quantize"] is True
    assert srv_q.stats()["models"]["m"]["quantized"] is True
    srv_q.stop()
    scale = max(float(np.abs(plain).max()), 1e-9)
    assert float(np.abs(quant - plain).max()) / scale < 0.06


def test_quantized_bucket_padding_is_bitwise_stable():
    d = 43
    srv = _server(max_batch=16, window_ms=0, quantize=True)
    srv.register("m", _binary_lr(d, seed=5))
    x = rng.normal(size=(5, d))
    whole = srv.predict("m", x)
    singles = np.concatenate([srv.predict("m", x[i:i + 1])
                              for i in range(len(x))])
    assert np.array_equal(whole, singles)
    lane = srv._lane("m")
    assert np.array_equal(lane.bucket_margins(x[:1], 1)[0],
                          lane.bucket_margins(x, 16)[0])
    srv.stop()


def test_quantized_gang_admits_more_models_per_budget():
    """The quantized gang's predicted bucket peak is smaller, so a fixed
    budget admits more gang models, by the same accounting the admission
    path consults (bucket_peak_bytes)."""
    from cycloneml_tpu_torch.serving import GangServable, Servable
    from cycloneml_tpu_torch.serving.batcher import bucket_peak_bytes
    r = np.random.default_rng(11)
    d, bucket = 128, 1

    def peak(k, quant):
        gang = GangServable([Servable(None, r.normal(size=(1, d)),
                                      r.normal(size=(1,)), "scalar")
                             for _ in range(k)])
        return bucket_peak_bytes(gang, bucket, np.float64, quant)

    p_plain, p_quant = peak(16, False), peak(16, True)
    assert p_quant < p_plain
    budget = 4 * p_plain

    def admitted(quant):
        base, p17 = peak(1, quant), peak(17, quant)
        marginal = max((p17 - base) / 16.0, 1.0)
        return 1 + int((budget - base) // marginal)

    assert admitted(True) > admitted(False)


def test_quantized_gang_matches_plain_gang():
    d, k = 37, 4
    models = [_binary_lr(d, seed=20 + s) for s in range(k)]
    x = rng.normal(size=(6, d))
    srv_q = _server(max_batch=8, window_ms=0, quantize=True)
    srv_q.register_gang("gq", models)
    before = srv_q.compile_counts()["gq"]
    assert before == len(bucket_sizes(8))
    preds = srv_q.predict("gq", x)
    assert srv_q.compile_counts()["gq"] == before
    srv_q.stop()
    for kk in range(k):
        m = models[kk]
        margins = x @ m._coef[0] + m._icpt[0]
        away = np.abs(margins) > 0.25  # away from the decision boundary
        ref = (margins > 0).astype(np.float64)
        assert np.array_equal(preds[kk][away], ref[away])


def test_retry_backoff_jitter_is_seeded_per_lane():
    import random

    from cycloneml_tpu_torch.parallel.resilience import backoff_delay
    from cycloneml_tpu_torch.serving.batcher import ModelLane
    d = 6
    srv = _server(max_batch=8, window_ms=0)
    srv.register("m", _binary_lr(d))
    try:
        a = ModelLane("probe", srv._lane("m").servable, srv)
        b = ModelLane("probe", srv._lane("m").servable, srv)
        other = ModelLane("probe2", srv._lane("m").servable, srv)
        seq = [backoff_delay(i, base_s=0.01, max_s=0.2, rng=a._rng)
               for i in range(6)]
        assert seq == [backoff_delay(i, base_s=0.01, max_s=0.2, rng=b._rng)
                       for i in range(6)]
        ref = random.Random(sum(b"probe"))
        assert seq == [backoff_delay(i, base_s=0.01, max_s=0.2, rng=ref)
                       for i in range(6)]
        assert seq != [backoff_delay(i, base_s=0.01, max_s=0.2,
                                     rng=other._rng) for i in range(6)]
    finally:
        srv.stop()


# -- serving dispatch faults (test_chaos.py's serving cases) -----------------------

def _serving_fixture(d, **kw):
    r = np.random.default_rng(0)
    model = LogisticRegressionModel(r.normal(size=(1, d)),
                                    r.normal(size=(1,)), 2, False)
    srv = _server(max_batch=8, window_ms=0, **kw)
    srv.register("m", model)
    return srv, model


def test_serving_transient_dispatch_fault_is_retried():
    d = 41
    srv, model = _serving_fixture(d)
    sched = FaultSchedule(seed=0)
    sched.at("serving.dispatch", 1,
             TransientCollectiveError("injected serving flake"))
    x = np.random.default_rng(1).normal(size=(3, d))
    with FaultInjector(sched) as inj:
        preds = srv.predict("m", x, timeout=30)
    assert np.array_equal(preds, model._predict_batch(x))
    assert inj.log == [("serving.dispatch", 1, "TransientCollectiveError")]
    st = srv.stats()["models"]["m"]
    assert st["retries"] >= 1 and st["requests"] == 1
    srv.stop()


def test_serving_permanent_dispatch_fault_sheds_5xx_never_hangs():
    d = 42
    srv, model = _serving_fixture(d)
    sched = FaultSchedule(seed=0)
    sched.at("serving.dispatch", 1, TypeError("injected broken dispatch"))
    x = np.random.default_rng(2).normal(size=(2, d))
    t0 = time.perf_counter()
    with FaultInjector(sched) as inj:
        with pytest.raises(ServingError) as ei:
            srv.predict("m", x, timeout=30)
        assert 500 <= ei.value.status < 600
        assert isinstance(ei.value.cause, TypeError)
        assert time.perf_counter() - t0 < 10
        assert len(inj.log) == 1
        assert srv.stats()["models"]["m"]["retries"] == 0
        preds = srv.predict("m", x, timeout=30)  # the worker serves on
    assert np.array_equal(preds, model._predict_batch(x))
    srv.stop()


def test_serving_transient_faults_exhaust_to_5xx():
    d = 43
    srv, model = _serving_fixture(d, max_retries=2)
    sched = FaultSchedule(seed=0)
    sched.at("serving.dispatch", [1, 2, 3, 4],
             TransientCollectiveError("persistent flake"))
    x = np.random.default_rng(3).normal(size=(1, d))
    with FaultInjector(sched) as inj:
        with pytest.raises(ServingError) as ei:
            srv.predict("m", x, timeout=30)
    assert 500 <= ei.value.status < 600
    assert len(inj.log) == 3  # the first attempt and maxRetries, then shed
    srv.stop()


def test_fault_window_replays_under_a_seed():
    """A probabilistic window fires the same invocations under one seed,
    and an injector installs exclusively."""
    from cycloneml_tpu_torch.parallel import faults

    def run():
        sched = FaultSchedule(seed=5)
        sched.window("p", 1, 40, TransientCollectiveError("x"), p=0.3)
        with FaultInjector(sched) as inj:
            for _ in range(40):
                try:
                    faults.inject("p")
                except TransientCollectiveError:
                    pass
        return inj.log

    first = run()
    assert first and first == run() and len(first) < 40
    with FaultInjector(FaultSchedule()):
        with pytest.raises(RuntimeError, match="already installed"):
            FaultInjector(FaultSchedule()).__enter__()


# -- the port's decisions (ROADMAP Queue 3) -----------------------------------------

def test_sticky_cuda_errors_are_permanent():
    """A CUDA error that poisons the context (an illegal address, a launch
    failure) cannot succeed on retry: permanent, never transient. A
    refused launch (out of resources, 701) stays transient."""
    from cycloneml_tpu_torch.parallel.faults import DeviceLostError
    from cycloneml_tpu_torch.parallel.resilience import classify_failure
    assert classify_failure(kernels.CudaError("launch", 700)) == "permanent"
    assert classify_failure(kernels.CudaError("launch", 719)) == "permanent"
    assert classify_failure(kernels.CudaError("launch", 701)) == "transient"
    assert classify_failure(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == \
        "permanent"
    assert classify_failure(RuntimeError(
        "CUDA error: unspecified launch failure")) == "permanent"
    assert classify_failure(TypeError("x")) == "permanent"
    assert classify_failure(TransientCollectiveError("x")) == "transient"
    assert classify_failure(DeviceLostError()) == "device_loss"
    assert classify_failure(RuntimeError("SLICE_LOST")) == "device_loss"


def test_float64_serving_is_honoured():
    """cyclone.serving.dtype=float64 serves in float64 (the reference
    narrows to float32 without jax x64): margins within 1e-12 of the
    float64 host margins; 'auto' follows cyclone.compute.dtype."""
    from cycloneml_tpu_torch.serving import serving_dtype
    assert serving_dtype(_cpu()) == np.float32
    assert serving_dtype(_cpu(**{"cyclone.compute.dtype": "float64"})) == \
        np.float64
    d = 33
    conf = _cpu(**{"cyclone.serving.dtype": "float64"})
    srv = _server(conf=conf, max_batch=4, window_ms=0)
    assert srv.dtype == np.float64 and srv.stats()["dtype"] == "float64"
    srv.register("m", _binary_lr(d, seed=8))
    lane = srv._lane("m")
    assert lane.instance == "f64"
    x = rng.normal(size=(4, d))
    got = lane.bucket_margins(x, 4)
    assert got.dtype == np.float64
    host = lane.servable.host_margins(x)
    assert np.max(np.abs(got - host)) <= 1e-12 * max(1.0, np.abs(host).max())
    srv.stop()


def test_model_server_on_cuda_without_a_card_raises():
    """No hidden fallback: cyclone.master=cuda with no card raises at the
    server, which never serves on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelServer(ctx=None, conf=CycloneConf().set("cyclone.master",
                                                     "cuda"))


def test_serving_conf_keys():
    from cycloneml_tpu_torch import conf as C
    c = CycloneConf(load_defaults=False)
    assert (c.get(C.SERVING_MAX_BATCH), c.get(C.SERVING_WINDOW_MS),
            c.get(C.SERVING_DTYPE), c.get(C.SERVING_MAX_QUEUE),
            c.get(C.SERVING_SHED_AFTER_MS), c.get(C.SERVING_MAX_RETRIES),
            c.get(C.SERVING_QUANTIZE)) == (64, 5.0, "auto", 1024, 1000.0, 3,
                                           False)
    for key, bad in (("cyclone.serving.maxBatch", 0),
                     ("cyclone.serving.windowMs", -1),
                     ("cyclone.serving.dtype", "bfloat16"),
                     ("cyclone.serving.maxQueue", 0),
                     ("cyclone.serving.shedAfterMs", -1),
                     ("cyclone.serving.maxRetries", -1)):
        with pytest.raises(ValueError, match="Invalid value"):
            CycloneConf(load_defaults=False).set(key, bad).get(key)


# -- parity with the JAX package ----------------------------------------------------

def _reference_servable():
    import cycloneml_tpu.serving.servable as ref
    return ref


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("quantized", [False, True])
def test_margins_match_the_references_kernels(dtype, quantized):
    """The reference's jitted linear_margins family against the port's
    plain path on the same numpy parameters and rows, serial and stacked:
    within 1e-12 (float64) or 1e-6 (float32) of the margin scale."""
    import jax
    ref = _reference_servable()
    r = np.random.default_rng(17)
    d, k, km, b = 45, 3, 4, 6
    coefs, icpts = r.normal(size=(k, km, d)), r.normal(size=(k, km))
    x = r.normal(size=(b, d)).astype(dtype)
    tol = 1e-12 if dtype == "float64" else 1e-6
    from cycloneml_tpu_torch.serving.servable import _quantize_rows
    if quantized:
        rq = ref._quantize_rows(coefs, icpts, np.dtype(dtype))
        want = np.asarray(jax.jit(ref.stacked_quantized_linear_margins)(
            *rq, x))
        want1 = np.asarray(jax.jit(ref.quantized_linear_margins)(
            rq[0][0], rq[1][0], rq[2][0], x))
        c, s, i = _quantize_rows(coefs, icpts, np.dtype(dtype))
    else:
        want = np.asarray(jax.jit(ref.stacked_linear_margins)(
            coefs.astype(dtype), icpts.astype(dtype), x))
        want1 = np.asarray(jax.jit(ref.linear_margins)(
            coefs[0].astype(dtype), icpts[0].astype(dtype), x))
        c, s = torch.as_tensor(coefs.astype(dtype)), None
        i = torch.as_tensor(icpts.astype(dtype))
    got = kernels.serving_margins(torch.from_numpy(x), c, i, s).numpy()
    assert got.dtype == want.dtype == np.dtype(dtype)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale
    assert np.abs(got[0] - want1).max() <= tol * scale


def test_quantized_codes_are_the_references_bitwise():
    from cycloneml_tpu_torch.serving.servable import _quantize_rows
    ref = _reference_servable()
    r = np.random.default_rng(23)
    coefs = r.normal(size=(4, 3, 200)) * np.logspace(-3, 3, 200)
    coefs[1, 2] = 0.0  # an all-zero row takes scale 1.0
    icpts = r.normal(size=(4, 3))
    for dtype in (np.float32, np.float64):
        rc, rs, ri = ref._quantize_rows(coefs, icpts, np.dtype(dtype))
        c, s, i = _quantize_rows(coefs, icpts, np.dtype(dtype))
        assert np.array_equal(c.view(torch.uint8).numpy(),
                              rc.view(np.uint8))
        assert np.array_equal(s.numpy(), rs) and s.numpy().dtype == dtype
        assert np.array_equal(i.numpy(), ri)


def test_e4m3_codes_from_float64_match_ml_dtypes_at_midpoints():
    """torch's float64 -> float8_e4m3fn conversion rounds once, as
    ml_dtypes does: every grid value, the midpoints between neighbours
    and the midpoints moved by +-1e-12 (where a double rounding through
    float32 would show), 262,168 values."""
    import ml_dtypes
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn) \
        .astype(np.float64)
    grid = np.unique(grid[np.isfinite(grid)])
    mids = (grid[1:] + grid[:-1]) / 2
    base = np.concatenate([grid, mids, mids + 1e-12, mids - 1e-12,
                           mids * (1 + 1e-9), mids * (1 - 1e-9)])
    r = np.random.default_rng(29)
    vals = np.concatenate([base, r.uniform(-448, 448, 262_168 - base.size)])
    assert vals.size == 262_168
    want = vals.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = torch.from_numpy(vals).to(torch.float8_e4m3fn).view(torch.uint8)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_both_servers_give_equal_labels(dtype):
    """The reference's ModelServer and the port's on the same models and
    rows: equal labels, serial (binomial, multinomial), gang and
    quantized gang; regression within the dtype's tolerance."""
    from cycloneml_tpu.ml.classification.logistic_regression import (
        LogisticRegressionModel as RefLR,
    )
    from cycloneml_tpu.ml.regression.linear_regression import (
        LinearRegressionModel as RefLinReg,
    )
    from cycloneml_tpu.serving import ModelServer as RefServer
    r = np.random.default_rng(31 if dtype == "float32" else 37)
    d, k = 47 if dtype == "float32" else 49, 3
    bin_p = [(r.normal(size=(1, d)), r.normal(size=(1,))) for _ in range(k)]
    mn_p = (r.normal(size=(4, d)), r.normal(size=(4,)))
    lin_p = (r.normal(size=(d,)), 0.75)
    x = r.normal(size=(20, d))
    out = {}
    for side, lr, linreg, srv_of in (
            ("ref", RefLR, RefLinReg,
             lambda **kw: RefServer(ctx=None, max_batch=8, window_ms=0,
                                    dtype=dtype, **kw)),
            ("port", LogisticRegressionModel, LinearRegressionModel,
             lambda **kw: _server(max_batch=8, window_ms=0, dtype=dtype,
                                  **kw))):
        srv, srv_q = srv_of(), srv_of(quantize=True)
        try:
            srv.register("bin", lr(*bin_p[0], 2, False))
            srv.register("mn", lr(*mn_p, 4, True))
            srv.register("lin", linreg(*lin_p))
            gang = [lr(c, i, 2, False) for c, i in bin_p]
            srv.register_gang("gang", gang)
            srv_q.register_gang("gang", gang)
            out[side] = {n: srv.predict(n, x) for n in ("bin", "mn", "lin",
                                                         "gang")}
            out[side]["qgang"] = srv_q.predict("gang", x)
        finally:
            srv.stop()
            srv_q.stop()
    ref, port = out["ref"], out["port"]
    for n in ("bin", "mn"):
        assert np.array_equal(port[n], ref[n])
    for n in ("gang", "qgang"):
        for a, b in zip(port[n], ref[n]):
            assert np.array_equal(a, b)
    tol = 1e-6 if dtype == "float32" else 1e-12
    assert np.abs(port["lin"] - ref["lin"]).max() <= tol * max(
        1.0, np.abs(ref["lin"]).max())


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_server(**kw):
    return ModelServer(ctx=None, conf=CycloneConf().set("cyclone.master",
                                                        "cuda"), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_kernel_equals_plain_twin_bitwise(dtype, quantized):
    """The kernel against its plain twin on the same card tensors: equal
    bits at every bucket, K = 1 and 5, widths off and on a warp; each
    launch counted under its instance."""
    from cycloneml_tpu_torch.serving.servable import _quantize_rows
    dev = _cuda()
    r = np.random.default_rng(41)
    kernels.reset_launch_counts()
    launches = 0
    for d, k in ((77, 1), (1280, 5), (3072, 1)):
        coef, icpt = r.normal(size=(k, 2, d)), r.normal(size=(k, 2))
        if quantized:
            c, s, i = (t.to(dev) for t in _quantize_rows(coef, icpt, dtype))
        else:
            c = torch.as_tensor(coef).to(dev, dtype)
            i, s = torch.as_tensor(icpt).to(dev, dtype), None
        for b in bucket_sizes(64):
            x = torch.as_tensor(r.normal(size=(b, d))).to(dev, dtype)
            got = kernels.serving_margins(x, c, i, s)
            launches += 1
            assert torch.equal(got, kernels.serving_margins_plain(x, c, i, s))
    inst = kernels.serving_instance(dtype, quantized)
    assert kernels.serving_margins.launches_by_instance[inst] == launches


@pytest.mark.gpu
def test_cuda_register_captures_one_graph_per_bucket_and_serves():
    """Registration on the card captures one graph a bucket; traffic adds
    none, allocates no device memory, counts one launch a replay and
    serves the model's own labels; gang margins equal the serial lanes'
    bits, a row's bits equal in buckets 1, 8 and padded 3-of-8."""
    _cuda()
    d, k = 300, 3
    models = [_binary_lr(d, seed=60 + s) for s in range(k)]
    srv = _cuda_server(max_batch=8, window_ms=1)
    try:
        for i, m in enumerate(models):
            srv.register(f"s{i}", m)
        srv.register_gang("g", models)
        counts = srv.compile_counts()
        assert set(counts.values()) == {len(bucket_sizes(8))}
        x = rng.normal(size=(29, d)).astype(np.float32)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        preds = srv.predict("g", x)
        serial = [srv.predict(f"s{i}", x) for i in range(k)]
        assert torch.cuda.memory_allocated() == before
        assert srv.compile_counts() == counts
        assert kernels.serving_margins.launches_by_instance["f32"] == \
            sum(lane["batches"] for lane in srv.stats()["models"].values())
        for i, m in enumerate(models):
            host = x.astype(np.float64) @ m._coef[0] + m._icpt[0]
            sure = np.abs(host) > 1e-5 * max(1.0, np.abs(host).max())
            assert np.array_equal(preds[i][sure], m._predict_batch(x)[sure])
            assert np.array_equal(serial[i], preds[i])
        g = srv._lane("g")
        g8 = g.bucket_margins(x[:8], 8)
        assert np.array_equal(g.bucket_margins(x[:1], 1)[:, 0], g8[:, 0])
        assert np.array_equal(g.bucket_margins(x[:3], 8)[:, :3], g8[:, :3])
        for i in range(k):
            assert np.array_equal(srv._lane(f"s{i}").bucket_margins(x[:8], 8),
                                  g8[i])
    finally:
        srv.stop()


@pytest.mark.gpu
def test_cuda_register_raises_when_capture_fails(monkeypatch):
    """No fallback: a launch that fails inside the capture makes register
    raise, the capture is ended, and the server registers the next model
    through graphs."""
    from cycloneml_tpu_torch.serving.batcher import ModelLane
    _cuda()
    real = ModelLane.launch

    def broken(self, *a, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launch refused during capture")
        return real(self, *a, **kw)

    srv = _cuda_server(max_batch=4, window_ms=0)
    try:
        monkeypatch.setattr(ModelLane, "launch", broken)
        with pytest.raises(RuntimeError, match="refused during capture"):
            srv.register("m", _binary_lr(64))
        assert "m" not in srv.models
        monkeypatch.setattr(ModelLane, "launch", real)
        srv.register("m", _binary_lr(64))
        assert srv.compile_counts() == {"m": len(bucket_sizes(4))}
        x = rng.normal(size=(3, 64))
        assert np.array_equal(srv.predict("m", x),
                              _binary_lr(64)._predict_batch(x))
    finally:
        srv.stop()
