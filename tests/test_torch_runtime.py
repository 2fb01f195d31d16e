"""The port's Spark-style runtime core against the JAX package's: the
host-tier ``PartitionedDataset`` behind ``CycloneContext.parallelize``,
broadcasts, accumulators, ``run_job``, the ``InstanceDataset`` placement
methods, ``Instance`` and ``rows_to_dense``, and the rest of ``MLFrame``.

The reference's own cases of tests/test_dataset.py (:11-98; its
checkpoint case and the storage tiers are in tests/test_torch_storage.py)
run through both packages on the same inputs: the port's context is
``cyclone.master=cpu`` at float64, the reference's the suite's
local-mesh[8] fixture. Results are equal.
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.dataset.dataset import (InstanceDataset,
                                                 PartitionedDataset,
                                                 stable_hash)
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.dataset.instance import (Instance, blockify_arrays,
                                                  rows_to_dense)
from cycloneml_tpu_torch.linalg.vectors import Vectors
from cycloneml_tpu_torch.observe import tracing


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


@pytest.fixture(params=["port", "reference"])
def both(request, pctx):
    """The port's context, or the reference's (the suite's shared
    local-mesh[8] context)."""
    if request.param == "port":
        return pctx
    return request.getfixturevalue("ctx")


# -- tests/test_dataset.py:11-98, through both packages -------------------------

def test_parallelize_collect(both):
    ds = both.parallelize(range(100), 8)
    assert ds.num_partitions == 8
    assert ds.collect() == list(range(100))
    assert ds.count() == 100


def test_map_filter_chain(both):
    ds = both.parallelize(range(20), 4).map(lambda x: x * 2).filter(
        lambda x: x % 4 == 0)
    assert ds.collect() == [x * 2 for x in range(20) if (x * 2) % 4 == 0]


def test_flat_map_and_map_partitions(both):
    ds = both.parallelize([1, 2, 3], 2).flat_map(lambda x: [x, x])
    assert sorted(ds.collect()) == [1, 1, 2, 2, 3, 3]
    sums = both.parallelize(range(10), 5).map_partitions(lambda it: [sum(it)])
    assert sum(sums.collect()) == 45


def test_reduce_aggregate_tree_aggregate(both):
    ds = both.parallelize(range(1, 101), 8)
    assert ds.reduce(lambda a, b: a + b) == 5050
    assert ds.aggregate(0, lambda acc, x: acc + x, lambda a, b: a + b) == 5050
    assert ds.tree_aggregate(0, lambda acc, x: acc + x, lambda a, b: a + b,
                             depth=3) == 5050


def test_group_reduce_by_key(both):
    pairs = both.parallelize([("a", 1), ("b", 2), ("a", 3)], 3)
    assert dict(pairs.reduce_by_key(lambda a, b: a + b).collect()) == \
        {"a": 4, "b": 2}


def test_zip_with_index_and_take(both):
    ds = both.parallelize("abcdef", 3).zip_with_index()
    assert ds.collect() == [(c, i) for i, c in enumerate("abcdef")]
    assert ds.take(2) == [("a", 0), ("b", 1)]


def test_broadcast_and_accumulator(both):
    b = both.broadcast({"w": np.arange(3.0)})
    np.testing.assert_allclose(b.value["w"], [0, 1, 2])
    acc = both.accumulator(0.0, "hits")
    both.parallelize(range(10), 4).foreach(lambda x: acc.add(1))
    assert acc.value == 10


@pytest.mark.parametrize("package", ["port", "reference"])
def test_blockify_padding_invariants(package):
    if package == "reference":
        from cycloneml_tpu.dataset.instance import blockify_arrays as blockify
    else:
        blockify = blockify_arrays
    x = np.arange(20.0).reshape(10, 2)
    xp, yp, wp, n = blockify(x, None, None, n_shards=8)
    xp, wp = np.asarray(xp), np.asarray(wp)
    assert n == 10
    assert xp.shape[0] % 8 == 0
    assert wp[:10].sum() == 10 and wp[10:].sum() == 0
    np.testing.assert_allclose(xp[:10], x)


# -- the same actions, element for element ------------------------------------

def test_every_action_equals_the_references(pctx, ctx):
    """Every transformation and action of the host tier gives the
    reference's result on the same data and partitioning: partitions,
    group_by_key's buckets (the reference's stable hash), union,
    repartition, first, is_empty, map_partitions_with_index."""
    data = [("k%d" % (i % 7), i) for i in range(50)] + [(3, 1.5), (3.0, 2)]

    def run(c):
        ds = c.parallelize(data, 5)
        return {
            "parts": ds.map_partitions_with_index(
                lambda i, it: [(i, len(list(it)))]).collect(),
            "groups": ds.group_by_key().map_partitions_with_index(
                lambda i, it: [(i, k, v) for k, v in it]).collect(),
            "union": ds.union(c.parallelize([1, 2], 2)).count(),
            "repart": ds.repartition(3).map_partitions(
                lambda it: [len(list(it))]).collect(),
            "first": ds.first(),
            "empty": (ds.is_empty(), c.parallelize([], 2).is_empty()),
            "take": ds.filter(lambda kv: kv[1] % 3 == 0).take(4),
        }
    assert run(pctx) == run(ctx)
    from cycloneml_tpu.dataset.spill import stable_hash as ref_hash
    for key in ("a", b"bytes", ("t", 1, 2.0), frozenset({1, "x"}), 7, 7.0,
                True, -3):
        assert stable_hash(key) == ref_hash(key)


def test_persist_keeps_results_and_checkpoint_cites_its_item(pctx):
    calls = []
    ds = pctx.parallelize(range(10), 2).map(lambda x: calls.append(1) or x)
    ds.persist()
    ds.collect()
    n1 = len(calls)
    ds.collect()
    assert len(calls) == n1
    ds.unpersist().collect()
    assert len(calls) == 2 * n1
    # a checkpoint needs the context's directory (the reference's message)
    with pytest.raises(RuntimeError, match="set_checkpoint_dir"):
        pctx.parallelize(range(5), 2).checkpoint()


def test_to_instance_dataset_from_instances(pctx, ctx):
    """Instance rows (dense and sparse features) to the numeric tier, as
    the reference's bridge builds it; rows_to_dense equal."""
    from cycloneml_tpu.dataset.instance import Instance as RefInstance
    from cycloneml_tpu.dataset.instance import rows_to_dense as ref_dense
    from cycloneml_tpu.linalg.vectors import Vectors as RefVectors
    rows = [(1.0, 2.0, [0.5, 0.0, 1.5]), (0.0, 1.0, {1: 3.0}),
            (1.0, 0.5, [2.0, 1.0, 0.0])]

    def vec(v, vs):
        return vs.dense(v) if isinstance(v, list) else vs.sparse(3, list(v.items()))

    port = [Instance(y, w, vec(f, Vectors)) for y, w, f in rows]
    ref = [RefInstance(y, w, vec(f, RefVectors)) for y, w, f in rows]
    np.testing.assert_array_equal(rows_to_dense([r.features for r in port]),
                                  ref_dense([r.features for r in ref]))
    got = pctx.parallelize(port, 2).to_instance_dataset().to_numpy()
    want = ctx.parallelize(ref, 2).to_instance_dataset().to_numpy()
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g, r)


def test_default_parallelism_and_its_conf(pctx):
    assert pctx.default_parallelism == 1
    assert pctx.parallelize(range(9)).num_partitions == 1
    pctx.conf.set("cyclone.default.parallelism", 4)
    assert pctx.parallelize(range(9)).num_partitions == 4


def test_broadcast_device_value_lives_once_on_the_device(pctx):
    b = pctx.broadcast({"w": np.arange(4.0), "k": [torch.ones(2)], "n": 3})
    dv = b.device_value
    assert isinstance(dv["w"], torch.Tensor) and dv["w"].device == pctx.device
    assert torch.equal(dv["w"], torch.arange(4.0, dtype=torch.float64))
    assert dv["n"] == 3 and torch.equal(dv["k"][0], torch.ones(2))
    assert b.device_value is dv          # placed once
    b.unpersist()
    assert b.device_value is not dv      # placed again after unpersist
    b.destroy()
    assert b.value is None


def test_run_job_counts_times_and_spans(pctx):
    reg = pctx.metrics_registry
    tracer = tracing.enable()
    try:
        acc = pctx.accumulator(0.0, "seen")

        def job():
            ds = pctx.parallelize(range(1, 11), 3)
            ds.foreach(lambda x: acc.add(x))
            return ds.tree_aggregate(0, lambda a, x: a + x,
                                     lambda a, b: a + b)
        assert pctx.run_job("sum", job) == 55
        assert acc.value == 55
        with pytest.raises(ZeroDivisionError):
            pctx.run_job("fails", lambda: 1 / 0)
    finally:
        tracing.disable()
    assert reg.counter("jobs.started").count == 2
    assert reg.counter("jobs.succeeded").count == 1
    assert reg.counter("jobs.failed").count == 1
    assert reg.timer("job.duration").snapshot()["count"] == 2
    jobs = [s for s in tracer.snapshot() if s.kind == "job"]
    assert [s.name for s in jobs] == ["sum", "fails"]


# -- InstanceDataset placement ---------------------------------------------------

def test_persist_host_release_and_persist_bring_rows_back(pctx):
    x = np.random.default_rng(3).normal(size=(21, 4))
    y = (x[:, 0] > 0).astype(float)
    ds = InstanceDataset.from_numpy(pctx, x, y)
    before = [t.clone() for t in (ds.x, ds.y, ds.w)]
    ds.persist_host()
    assert ds._x is None
    assert ds.persist() is ds and torch.equal(ds.x, before[0])
    # back on the device, the managed dataset dropped its host copy (the
    # reference's storage rule): a release needs a host copy again
    assert ds._host is None
    ds.persist_host()
    ds.release_device()
    assert ds._x is None and ds.cache() is ds
    for t, b in zip((ds.x, ds.y, ds.w), before):
        assert torch.equal(t, b)
    with pytest.raises(RuntimeError, match="only copy"):
        InstanceDataset.from_numpy(pctx, x).release_device()
    # the other levels go through the context's storage tiers
    assert ds.persist("HOST") is ds and ds._x is None
    assert pctx.storage.level_of(ds) == "HOST"
    assert ds.unpersist() is ds and pctx.storage.level_of(ds) is None
    for t, b in zip((ds.x, ds.y, ds.w), before):
        assert torch.equal(t, b)


def test_map_batches_and_unpad_equal_the_references(pctx, ctx):
    x = np.random.default_rng(4).normal(size=(13, 3))
    ds = InstanceDataset.from_numpy(pctx, x)
    from cycloneml_tpu.dataset.dataset import InstanceDataset as RefDS
    ref = RefDS.from_numpy(ctx, x, dtype=np.float64)
    got = ds.map_batches(lambda xs, ys, ws: (xs * ws[:, None]).sum(0))
    want = ref.map_batches(lambda xs, ys, ws: (xs * ws[:, None]).sum(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    pad = np.arange(ds.x.shape[0], dtype=float)
    np.testing.assert_array_equal(ds.unpad(pad), np.arange(13.0))
    np.testing.assert_array_equal(
        ds.unpad(np.arange(ds.x.shape[0], dtype=float)),
        ref.unpad(np.arange(ref.x.shape[0], dtype=float)))


# -- MLFrame ------------------------------------------------------------------------

def _frames(pctx, ctx):
    from cycloneml_tpu.dataset.frame import MLFrame as RefFrame
    r = np.random.default_rng(9)
    cols = {"features": r.normal(size=(40, 3)), "label": r.integers(0, 2, 40)
            .astype(float), "id": np.arange(40)}
    return MLFrame(pctx, cols), RefFrame(ctx, cols)


def _same_frame(a, b):
    assert a.columns == b.columns and a.n_rows == b.n_rows
    for c in a.columns:
        np.testing.assert_array_equal(a[c], b[c])


def test_frame_column_ops_equal_the_references(pctx, ctx):
    f, g = _frames(pctx, ctx)
    assert ("label" in f) and ("nope" not in f)
    np.testing.assert_array_equal(f.col("id"), g.col("id"))
    _same_frame(f.select("id", "label"), g.select("id", "label"))
    _same_frame(f.drop("features"), g.drop("features"))
    _same_frame(f.with_column_renamed("label", "y"),
                g.with_column_renamed("label", "y"))
    _same_frame(f.limit(7), g.limit(7))
    assert f.count() == g.count() == 40
    got, want = f.drop("features").head(3), g.drop("features").head(3)
    assert [tuple(map(float, t)) for t in got] == \
        [tuple(map(float, t)) for t in want]
    assert len(f.collect()) == 40


@pytest.mark.parametrize("seed", [0, 5])
def test_frame_sample_and_split_draw_the_references_rows(pctx, ctx, seed):
    """One seed picks the same rows in both packages (both draw from
    numpy's RandomState), and replays in the port."""
    f, g = _frames(pctx, ctx)
    _same_frame(f.sample(0.3, seed=seed), g.sample(0.3, seed=seed))
    _same_frame(f.sample(0.3, seed=seed), f.sample(0.3, seed=seed))
    parts = f.random_split([0.5, 0.3, 0.2], seed=seed)
    for a, b in zip(parts, g.random_split([0.5, 0.3, 0.2], seed=seed)):
        _same_frame(a, b)
    assert sum(p.n_rows for p in parts) == 40
    ids = np.concatenate([p["id"] for p in parts])
    assert sorted(ids.tolist()) == list(range(40))


def test_frame_from_rows_and_from_instance_dataset(pctx, ctx):
    from cycloneml_tpu.dataset.dataset import InstanceDataset as RefDS
    from cycloneml_tpu.dataset.frame import MLFrame as RefFrame
    from cycloneml_tpu.linalg.vectors import Vectors as RefVectors
    rows = [(Vectors.dense([1.0, 2.0]), 1.0), (Vectors.sparse(2, [(1, 4.0)]),
                                               0.0)]
    ref_rows = [(RefVectors.dense([1.0, 2.0]), 1.0),
                (RefVectors.sparse(2, [(1, 4.0)]), 0.0)]
    _same_frame(MLFrame.from_rows(pctx, rows, ["features", "label"]),
                RefFrame.from_rows(ctx, ref_rows, ["features", "label"]))
    x = np.random.default_rng(2).normal(size=(11, 2))
    y = np.arange(11.0) % 2
    w = np.linspace(0.5, 1.5, 11)
    got = MLFrame.from_instance_dataset(
        InstanceDataset.from_numpy(pctx, x, y, w), weight_col="w")
    want = RefFrame.from_instance_dataset(
        RefDS.from_numpy(ctx, x, y, w, dtype=np.float64), weight_col="w")
    _same_frame(got, want)
