"""The port's storage tiers and dataset checkpoints against the JAX
package's.

The reference's own cases run through both packages (the port's context
is ``cyclone.master=cpu`` at float64, the reference's the suite's
local-mesh[8] under x64): ``PartitionedDataset.checkpoint`` and the
``InstanceDataset`` npz round trip (tests/test_dataset.py:51, :99), the
``StorageManager``'s DEVICE -> HOST -> DISK demotion, its lazy restores
and ``unpersist`` (:119, :159), a fit under a tight device budget that
demotes the cold cached dataset and the shared-array rule
(tests/test_storage_default.py:24, :69). The port's own cases: sharing by
storage among managed datasets, the budgets from the conf, the spill
directory's lifetime, the DISK tier's bit-exact round trip of bfloat16 X
and of e4m3 codes with their scales, and a corrupt dtype tag.

Across the packages, an npz written by either package's
``InstanceDataset.checkpoint`` (float32, bfloat16, e4m3 codes with
``x_scale``) restores in the other bit for bit.

The ``gpu`` tests demote and restore on the card, with
``torch.cuda.memory_allocated`` falling by the demoted bytes (the card's
machine has no jax, so the reference is imported inside the tests that
use it):

    python -m pytest --noconftest -m gpu tests/test_torch_storage.py
"""

import gc
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext

PACKAGES = ["port", "reference"]


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _pkg(name):
    if name == "port":
        from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
        from cycloneml_tpu_torch.dataset.frame import MLFrame
        from cycloneml_tpu_torch.dataset.storage import (StorageLevel,
                                                         StorageManager)
        from cycloneml_tpu_torch.ml.classification import LogisticRegression
    else:
        from cycloneml_tpu.dataset.dataset import InstanceDataset
        from cycloneml_tpu.dataset.frame import MLFrame
        from cycloneml_tpu.dataset.storage import StorageLevel, StorageManager
        from cycloneml_tpu.ml.classification import LogisticRegression
    return SimpleNamespace(InstanceDataset=InstanceDataset, MLFrame=MLFrame,
                           StorageLevel=StorageLevel,
                           StorageManager=StorageManager,
                           LogisticRegression=LogisticRegression)


@pytest.fixture(params=PACKAGES)
def both(request):
    """(the package's names, its context)."""
    ctx = request.getfixturevalue("pctx" if request.param == "port"
                                  else "ctx")
    return _pkg(request.param), ctx


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- tests/test_dataset.py:51, :99 ---------------------------------------------

def test_cache_and_checkpoint(both, tmp_path):
    _, ctx = both
    calls = []
    ds = ctx.parallelize(range(10), 2).map(lambda x: calls.append(1) or x)
    ds.persist()
    ds.collect()
    n1 = len(calls)
    ds.collect()
    assert len(calls) == n1
    ctx.set_checkpoint_dir(str(tmp_path))
    ds2 = ctx.parallelize(range(5), 2).map(lambda x: x + 1)
    ds2.checkpoint()
    assert ds2.collect() == [1, 2, 3, 4, 5]
    # the lineage is gone: the partitions come from the file
    assert ds2._checkpoint_path.startswith(str(tmp_path))
    assert ds2._compute() is None


def test_instance_dataset_checkpoint_roundtrip(both, tmp_path):
    p, ctx = both
    x = np.random.RandomState(1).randn(32, 3)
    ds = p.InstanceDataset.from_numpy(ctx, x)  # float64 in both
    path = ds.checkpoint(str(tmp_path / "ck.npz"))
    back = p.InstanceDataset.restore(ctx, path)
    x2, _, _ = back.to_numpy()
    np.testing.assert_allclose(x2, x)


# -- the StorageManager (tests/test_dataset.py:119, :159) ----------------------

def _mk(p, ctx, rng):
    return p.InstanceDataset.from_numpy(ctx, rng.randn(256, 16),
                                        rng.rand(256))


DS_BYTES = 256 * 18 * 8  # padded rows x (d + y + w) x float64


def test_storage_manager_tiers_and_eviction(both, tmp_path):
    p, ctx = both
    L = p.StorageLevel
    rng = np.random.RandomState(0)
    sm = p.StorageManager(device_budget=int(DS_BYTES * 1.5),
                          host_budget=int(DS_BYTES * 1.5),
                          spill_dir=str(tmp_path))
    a, b, c = _mk(p, ctx, rng), _mk(p, ctx, rng), _mk(p, ctx, rng)
    assert a.padded_bytes() == DS_BYTES
    ref = {k: d.to_numpy() for k, d in (("a", a), ("b", b), ("c", c))}
    sm.persist(a)
    sm.persist(b)            # a -> HOST
    assert sm.level_of(a) == L.HOST and a._x is None
    assert sm.level_of(b) == L.DEVICE
    sm.persist(c)            # b -> HOST, which sends a -> DISK
    assert sm.level_of(a) == L.DISK
    assert sm.level_of(b) == L.HOST
    assert sm.level_of(c) == L.DEVICE
    assert sm.usage()[L.DEVICE] <= DS_BYTES * 1.5
    xa, ya, wa = a.to_numpy()
    np.testing.assert_allclose(xa, ref["a"][0])
    np.testing.assert_allclose(ya, ref["a"][1])
    sm.touch(a)
    assert sm.level_of(a) == L.DEVICE
    agg = a.tree_aggregate_fn(lambda x, y, w: (x * w[:, None]).sum(0))()
    assert np.isfinite(_np(agg)).all()
    for d in (a, b, c):
        sm.unpersist(d)


def test_storage_manager_lazy_restore_and_unpersist(both, tmp_path):
    p, ctx = both
    L = p.StorageLevel
    rng = np.random.RandomState(1)
    sm = p.StorageManager(device_budget=int(DS_BYTES * 1.5),
                          host_budget=int(DS_BYTES * 1.5),
                          spill_dir=str(tmp_path))
    a, b = _mk(p, ctx, rng), _mk(p, ctx, rng)
    ref_a = a.to_numpy()
    sm.persist(a)
    sm.persist(b)  # a -> HOST
    assert sm.level_of(a) == L.HOST
    d = a.derive()  # restores instead of deriving an empty dataset
    assert d.x is not None and d.to_numpy()[0].shape == (256, 16)
    assert sm.level_of(a) == L.DEVICE
    assert sm.usage()[L.DEVICE] <= DS_BYTES * 1.5
    sm.persist(b)
    sm.touch(b)
    c = _mk(p, ctx, rng)
    sm.persist(c)
    if sm.level_of(a) != L.DISK:
        sm._apply_level(sm._entries[id(a)], L.DISK)
    sm.unpersist(a)
    np.testing.assert_allclose(a.to_numpy()[0], ref_a[0])
    big = _mk(p, ctx, rng)
    sm2 = p.StorageManager(device_budget=10, spill_dir=str(tmp_path / "s2"))
    sm2.persist(big)
    assert sm2.level_of(big) == L.DEVICE and big.x is not None


def test_migrate_device_to_host_moves_every_device_dataset(both, tmp_path):
    """The decommission hop: every DEVICE-tier dataset to HOST, its bytes
    counted, the data unchanged."""
    p, ctx = both
    L = p.StorageLevel
    rng = np.random.RandomState(2)
    sm = p.StorageManager(spill_dir=str(tmp_path))
    a, b = _mk(p, ctx, rng), _mk(p, ctx, rng)
    ref = a.to_numpy()[0]
    sm.persist(a)
    sm.persist(b, L.HOST)
    moved, n_bytes = sm.migrate_device_to_host()
    assert moved == [a] and n_bytes == DS_BYTES
    assert sm.level_of(a) == L.HOST and a._x is None
    assert sm.usage() == {L.DEVICE: 0, L.HOST: 2 * DS_BYTES, L.DISK: 0}
    np.testing.assert_array_equal(a.to_numpy()[0], ref)
    sm.unpersist(a)
    sm.unpersist(b)


# -- tests/test_storage_default.py:24, :69 -------------------------------------

def _frame(p, ctx, seed, n=1500, d=48):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = (x @ rng.randn(d) + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return p.MLFrame(ctx, {"features": x, "label": y})


def test_fit_under_tight_budget_demotes_cold_dataset(both):
    p, ctx = both
    L = p.StorageLevel
    mgr = ctx.storage
    cold = _frame(p, ctx, 31)
    cold_ds = cold.to_instance_dataset("features", "label", None)
    assert mgr.level_of(cold_ds) == L.DEVICE
    hot = _frame(p, ctx, 32)
    oracle = p.LogisticRegression(maxIter=60, regParam=0.05,
                                  tol=1e-10).fit(_frame(p, ctx, 32))
    old_budget = mgr.device_budget
    probe = _frame(p, ctx, 32).to_instance_dataset("features", "label", None)
    hot_bytes = probe.padded_bytes()
    mgr.unpersist(probe)
    mgr.device_budget = hot_bytes + cold_ds.padded_bytes() // 2
    hot_ds = None
    try:
        model = p.LogisticRegression(maxIter=60, regParam=0.05,
                                     tol=1e-10).fit(hot)
        hot_ds = hot.to_instance_dataset("features", "label", None)
        assert mgr.level_of(cold_ds) in (L.HOST, L.DISK)
        np.testing.assert_allclose(model.coefficients.to_array(),
                                   oracle.coefficients.to_array(),
                                   rtol=1e-8, atol=1e-10)
        assert cold_ds.x is not None
        assert mgr.level_of(cold_ds) == L.DEVICE
    finally:
        mgr.device_budget = old_budget
        mgr.unpersist(cold_ds)
        if hot_ds is not None:
            mgr.unpersist(hot_ds)


def test_shared_array_datasets_are_not_eviction_candidates(both):
    p, ctx = both
    mgr = ctx.storage
    parent = _frame(p, ctx, 33).to_instance_dataset("features", "label",
                                                    None)
    child = parent.derive(x=parent.x)
    assert mgr._shares_arrays(parent) and mgr._shares_arrays(child)
    del child
    gc.collect()
    assert not mgr._shares_arrays(parent)
    mgr.unpersist(parent)


def test_managed_datasets_over_one_storage_are_not_candidates(pctx):
    """The port's rule beyond the derive lineage: two managed datasets
    over the same tensors' storage (here a dataset built by hand over
    another's y and w, and the e4m3 view ``quantized`` makes) are not
    demoted, since freeing one side frees no memory."""
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    from cycloneml_tpu_torch.dataset.storage import StorageManager
    rng = np.random.RandomState(4)
    a = InstanceDataset.from_numpy(pctx, rng.randn(64, 4), rng.rand(64))
    b = InstanceDataset(pctx, a.x.clone(), a.y, a.w, a.n_rows, 4)
    sm = StorageManager(device_budget=1)
    sm.persist(a)
    sm.persist(b)
    assert sm._shares_arrays(a) and sm._shares_arrays(b)
    assert sm.level_of(a) == sm.level_of(b) == "DEVICE"
    q = InstanceDataset.from_numpy(pctx, rng.randn(64, 4)).quantized()
    assert q._array_parent is not None


def test_frame_registers_its_cached_dataset(both):
    """A frame's cached dataset registers at DEVICE (the reference's
    frame.py:184-186), once per column selection."""
    p, ctx = both
    f = _frame(p, ctx, 35, n=50, d=3)
    ds = f.to_instance_dataset("features", "label", None)
    assert ctx.storage.level_of(ds) == p.StorageLevel.DEVICE
    assert f.to_instance_dataset("features", "label", None) is ds
    ctx.storage.unpersist(ds)
    assert ctx.storage.level_of(ds) is None


# -- the port's own cases -------------------------------------------------------

@pytest.mark.parametrize("key", ["cyclone.checkpoint.dir",
                                 "cyclone.storage.deviceBudget",
                                 "cyclone.storage.hostBudget"])
def test_new_conf_keys_match_the_references_entries(key):
    from cycloneml_tpu.conf import CycloneConf as RefConf
    from cycloneml_tpu.conf import registered_entries as ref_entries
    from cycloneml_tpu_torch.conf import registered_entries
    mine, ref = registered_entries()[key], ref_entries()[key]
    assert (mine.default, mine.value_type, mine.version) == \
        (ref.default, ref.value_type, ref.version)
    assert mine.doc
    probes = ["/tmp/ck", ""] if key == "cyclone.checkpoint.dir" \
        else ["0", "1024", "-1"]
    for raw in probes:
        outcome = []
        for conf in (CycloneConf(load_defaults=False),
                     RefConf(load_defaults=False)):
            conf.set(key, raw)
            try:
                outcome.append(conf.get(key))
            except ValueError:
                outcome.append("rejected")
        assert outcome[0] == outcome[1], (key, raw, outcome)


def test_budgets_and_checkpoint_dir_come_from_the_conf(tmp_path):
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                         .set("cyclone.storage.deviceBudget", "4096")
                         .set("cyclone.storage.hostBudget", "0"))
    try:
        assert ctx.storage.device_budget == 4096
        assert ctx.storage.host_budget is None
        assert ctx.checkpoint_dir == ""
        ctx.set_checkpoint_dir(str(tmp_path / "ck"))
        assert ctx.checkpoint_dir == str(tmp_path / "ck")
        assert os.path.isdir(tmp_path / "ck")
    finally:
        ctx.stop()


def test_stop_removes_the_managers_own_spill_directory(tmp_path):
    """A spill directory the manager made goes with the context; one the
    caller gave keeps everything but the spill files."""
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    from cycloneml_tpu_torch.dataset.storage import StorageManager
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    try:
        ds = InstanceDataset.from_numpy(ctx, np.ones((16, 2)))
        ds.persist("DISK")
        spill = ctx.storage._spill_dir
        assert os.path.isdir(spill) and os.listdir(spill)
    finally:
        ctx.stop()
    assert not os.path.exists(spill)
    keep = tmp_path / "given"
    keep.mkdir()
    (keep / "other").write_text("x")
    sm = StorageManager(spill_dir=str(keep))
    ctx = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    try:
        ds = InstanceDataset.from_numpy(ctx, np.ones((16, 2)))
        sm.persist(ds, "DISK")
        sm.close()
    finally:
        ctx.stop()
    assert os.listdir(keep) == ["other"]


def _dataset_of(ctx, dtype, n=203, d=7, seed=9):
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * np.linspace(0.5, 40.0, d)
    return InstanceDataset.from_numpy(ctx, x, (rng.rand(n) > 0.5) * 1.0,
                                      rng.rand(n) + 0.5, dtype=dtype)


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.element_size() == 1:
        return t.view(torch.uint8).numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn],
                         ids=["f32", "bf16", "e4m3"])
def test_disk_tier_round_trip_is_bitwise(pctx, tmp_path, dtype):
    """``persist("DISK")`` releases the tensors; the first access reads
    them back bit for bit (codes with their scale and probe ratio), the
    storage callback relabels the dataset DEVICE, and a checkpoint file
    restores into a new dataset with the same bits."""
    ds = _dataset_of(pctx, dtype)
    keep = [t.clone() for t in (ds.x, ds.y, ds.w)]
    scale, ratio = ds.x_scale, ds._fp8_probe_ratio
    ds.persist("DISK")
    assert ds._x is None and ds._host is None
    assert pctx.storage.level_of(ds) == "DISK"
    assert all(_bits(t).tobytes() == _bits(k).tobytes()
               for t, k in zip((ds.x, ds.y, ds.w), keep))
    assert pctx.storage.level_of(ds) == "DEVICE"
    back = type(ds).restore(pctx, ds.checkpoint(str(tmp_path / "c.npz")))
    assert back.x.dtype == dtype and back.n_rows == ds.n_rows
    assert _bits(back.x).tobytes() == _bits(keep[0]).tobytes()
    if dtype == torch.float8_e4m3fn:
        assert np.array_equal(back.x_scale, scale)
        assert np.array_equal(back._fp8_probe_ratio, ratio)
    else:
        assert back.x_scale is None and scale is None
    pctx.storage.unpersist(ds)


def test_a_corrupt_dtype_tag_raises(pctx, tmp_path):
    ds = _dataset_of(pctx, torch.bfloat16)
    path = ds.checkpoint(str(tmp_path / "c.npz"))
    with np.load(path) as z:
        fields = dict(z)
    for tag, match in (("bfloat17", "not a known dtype"),
                       ("float8_e4m3fn", "itemsize")):
        fields["x_dtype"] = np.array(tag)
        np.savez(str(tmp_path / "bad.npz"), **fields)
        with pytest.raises(ValueError, match=match):
            type(ds).restore(pctx, str(tmp_path / "bad.npz"))


def test_unpersist_reads_a_disk_tier_dataset_back(pctx):
    """Data is never dropped: unpersisting a DISK-tier dataset reads it
    back to the host tier and removes its spill file."""
    ds = _dataset_of(pctx, torch.bfloat16)
    keep = ds.x.clone()
    ds.persist("DISK")
    spill = ds._disk_path
    ds.unpersist()
    assert not os.path.exists(spill) and ds._host is not None
    assert torch.equal(ds.x.view(torch.int16), keep.view(torch.int16))


@pytest.mark.parametrize("writer", PACKAGES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_npz_of_either_package_restores_in_the_other(writer, dtype, pctx,
                                                     ctx, tmp_path):
    """``InstanceDataset.checkpoint`` of one package restores in the
    other's ``restore``: X's bits (bfloat16 and e4m3 as bit views with
    the reference's tags), y, w, the row counts and the e4m3 scales."""
    import ml_dtypes

    from cycloneml_tpu.dataset.dataset import InstanceDataset as RefDS
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    np_dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
             "float8_e4m3fn": ml_dtypes.float8_e4m3fn}[dtype]
    t_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float8_e4m3fn": torch.float8_e4m3fn}[dtype]
    rng = np.random.RandomState(13)
    x = rng.randn(203, 7) * np.linspace(0.5, 40.0, 7)
    y, w = (rng.rand(203) > 0.5) * 1.0, rng.rand(203) + 0.5
    path = str(tmp_path / "ds.npz")
    if writer == "reference":
        src = RefDS.from_numpy(ctx, x, y, w, dtype=np_dt)
        src.checkpoint(path)
        got = InstanceDataset.restore(pctx, path)
        want_x = np.asarray(src.x)
        got_x = got.x.numpy() if dtype == "float32" else _bits(got.x)
        want_y, want_w = np.asarray(src.y), np.asarray(src.w)
        got_y, got_w = got.y.numpy(), got.w.numpy()
        want_scale, got_scale = src.x_scale, got.x_scale
        n_want, n_got = src.n_rows, got.n_rows
    else:
        src = InstanceDataset.from_numpy(pctx, x, y, w, dtype=t_dt)
        src.checkpoint(path)
        got = RefDS.restore(ctx, path)
        want_x = src.x.numpy() if dtype == "float32" else _bits(src.x)
        got_x = np.asarray(got.x)
        want_y, want_w = src.y.numpy(), src.w.numpy()
        got_y, got_w = np.asarray(got.y), np.asarray(got.w)
        want_scale, got_scale = src.x_scale, got.x_scale
        n_want, n_got = src.n_rows, got.n_rows
    assert np.asarray(want_x).tobytes() == np.asarray(got_x).tobytes()
    assert np.array_equal(want_y, got_y) and np.array_equal(want_w, got_w)
    assert n_want == n_got == 203
    if dtype == "float8_e4m3fn":
        assert np.array_equal(want_scale, got_scale)
    else:
        assert want_scale is None and got_scale is None


# -- on the card ---------------------------------------------------------------

def _cuda_ctx(**conf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = CycloneConf().set("cyclone.master", "cuda")
    for k, v in conf.items():
        c.set(k, str(v))
    return CycloneContext(c)


@pytest.mark.gpu
def test_cuda_demotion_frees_the_card_and_restores_bitwise():
    """Two bf16 datasets under a device budget of 1.5 of one: the second's
    registration demotes the first to HOST and memory_allocated falls by
    its padded bytes (and the allocator's slack); touching it brings it back bit for bit (and demotes
    the second)."""
    from cycloneml_tpu_torch.dataset.random import generate_classification
    n, d = 400_000, 256
    ctx = _cuda_ctx(**{"cyclone.storage.deviceBudget":
                       int(1.5 * n * (2 * d + 8))})
    try:
        a = generate_classification(ctx, n, d, seed=1)
        b = generate_classification(ctx, n, d, seed=2)
        assert a.padded_bytes() == n * (2 * d + 8)
        keep = a.x.clone()
        a.persist()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        b.persist()
        torch.cuda.synchronize()
        assert ctx.storage.level_of(a) == "HOST" and a._x is None
        # the caching allocator keeps a block whole when less than 1 MiB
        # of its segment would remain: each of X, y and w frees at most
        # that much more than its own bytes
        drop = before - torch.cuda.memory_allocated()
        assert 0 <= drop - a.padded_bytes() < 3 * (1 << 20)
        assert torch.equal(a.x, keep)
        assert ctx.storage.level_of(a) == "DEVICE"
        assert ctx.storage.level_of(b) == "HOST"
    finally:
        ctx.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "e4m3"])
def test_cuda_disk_round_trip_is_bitwise(dtype):
    from cycloneml_tpu_torch.dataset.random import generate_classification
    ctx = _cuda_ctx()
    try:
        ds = generate_classification(ctx, 50_000, 300, seed=3)
        if dtype == torch.float8_e4m3fn:
            ds = ds.quantized()
        keep = [t.clone() for t in (ds.x, ds.y, ds.w)]
        ds.persist("DISK")
        assert ds._x is None
        back = [ds.x, ds.y, ds.w]
        assert back[0].device.type == "cuda"
        assert all(torch.equal(t.view(torch.uint8) if t.element_size() == 1
                               else t, k.view(torch.uint8)
                               if k.element_size() == 1 else k)
                   for t, k in zip(back, keep))
    finally:
        ctx.stop()
