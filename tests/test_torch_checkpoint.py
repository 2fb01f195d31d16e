"""Checkpointed training in the port against the JAX package's.

The reference's own cases run through both packages (``package`` is
"port" or "reference"): the checkpointer of tests/test_resilience.py:36-121
(retention, uncommitted leftovers, checksums, legacy steps), ``retry_step``
(:167-204), the exact resume of L-BFGS, OWL-QN and L-BFGS-B (:248, :265),
``train_with_checkpoints`` (:282-351: a crash and its resume, no replay of
``on_step``, the transient retry budget), the checkpoint chaos of
tests/test_chaos.py (:206 mid-save crash, :234 a damaged newest step, :263
every step damaged, :1145 and :1163 the save and restore entry points), the
LogisticRegression resume and fingerprint guard (test_resilience.py:370,
:397) and ALS's (test_als.py:118, :136). The port's context is
``cyclone.master=cpu`` at float64, the reference's the suite's
local-mesh[8] under x64.

Across the packages: a checkpoint directory the reference's
``train_with_checkpoints`` wrote before a crash resumes in the port's (and
the other way round) onto the uninterrupted run within 1e-12, and an ALS
directory the reference wrote at iteration 4 resumes in the port within
1e-10 of the reference's uninterrupted float64 fit.

The ``gpu`` tests fit on the card and hold the resumed fits bitwise to the
uninterrupted ones (the card's machine has no jax, so the reference is
imported inside the tests that use it):

    python -m pytest --noconftest -m gpu tests/test_torch_checkpoint.py
"""

import json
import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext

PACKAGES = ["port", "reference"]


def _pkg(name):
    """The optimizer, checkpoint and fault names of one package."""
    if name == "port":
        from cycloneml_tpu_torch.ml.optim import lbfgs
        from cycloneml_tpu_torch.parallel import faults, resilience
        from cycloneml_tpu_torch.util import checkpoint
    else:
        from cycloneml_tpu.ml.optim import lbfgs
        from cycloneml_tpu.parallel import faults, resilience
        from cycloneml_tpu.util import checkpoint
    return SimpleNamespace(
        LBFGS=lbfgs.LBFGS, OWLQN=lbfgs.OWLQN, LBFGSB=lbfgs.LBFGSB,
        OptimState=lbfgs.OptimState,
        Checkpointer=checkpoint.TrainingCheckpointer,
        Corrupt=checkpoint.CheckpointCorrupt,
        train=resilience.train_with_checkpoints,
        retry_step=resilience.retry_step,
        FaultSchedule=faults.FaultSchedule,
        FaultInjector=faults.FaultInjector,
        MidSaveCrash=faults.MidSaveCrash,
        Transient=faults.TransientCollectiveError)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return _pkg(request.param)


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


@pytest.fixture(params=PACKAGES)
def both(request):
    """(package name, its context): the port's float64 CPU context, or the
    reference's local-mesh[8]."""
    if request.param == "port":
        yield "port", request.getfixturevalue("pctx")
    else:
        yield "reference", request.getfixturevalue("ctx")


def _estimators(name):
    if name == "port":
        from cycloneml_tpu_torch.dataset.frame import MLFrame
        from cycloneml_tpu_torch.ml.classification import LogisticRegression
        from cycloneml_tpu_torch.ml.recommendation import ALS
    else:
        from cycloneml_tpu.dataset.frame import MLFrame
        from cycloneml_tpu.ml.classification import LogisticRegression
        from cycloneml_tpu.ml.recommendation import ALS
    return MLFrame, LogisticRegression, ALS


def _quadratic(d=6, seed=3):
    rng = np.random.RandomState(seed)
    a = rng.randn(d, d)
    h = a @ a.T + d * np.eye(d)
    b = rng.randn(d)

    def f(x):
        return 0.5 * x @ h @ x - b @ x, h @ x - b

    return f, np.zeros(d)


def _ratings(seed=3, n_users=40, n_items=30, rank=3, frac=0.5):
    """tests/test_als.py's ratings."""
    rng = np.random.RandomState(seed)
    full = rng.randn(n_users, rank) @ rng.randn(n_items, rank).T
    users, items = np.nonzero(rng.rand(n_users, n_items) < frac)
    return users, items, full[users, items]


# -- the checkpointer (tests/test_resilience.py:36-121) ------------------------

def test_checkpointer_save_restore_retention(pkg, tmp_path):
    ck = pkg.Checkpointer(str(tmp_path), keep_last=2)
    assert ck.latest_step() is None
    for s in (5, 10, 15):
        ck.save(s, {"x": np.arange(3) * s, "nested": {"v": float(s)}},
                metadata={"loss": 1.0 / s})
    assert ck.steps() == [10, 15]  # retention dropped step 5
    got = ck.restore()
    np.testing.assert_array_equal(got["x"], np.arange(3) * 15)
    assert got["nested"]["v"] == 15.0
    assert ck.metadata(15)["loss"] == pytest.approx(1.0 / 15)
    # a re-save of a step that exists keeps it as it is
    ck.save(15, {"x": np.zeros(1), "nested": {"v": 0.0}})
    np.testing.assert_array_equal(ck.restore(15)["x"], np.arange(3) * 15)
    with pytest.raises(FileNotFoundError):
        pkg.Checkpointer(str(tmp_path / "empty")).restore()


def test_checkpointer_ignores_uncommitted(pkg, tmp_path):
    ck = pkg.Checkpointer(str(tmp_path))
    os.makedirs(tmp_path / "step_000000000007.tmp123")
    (tmp_path / "step_000000000007.tmp123" / "METADATA.json").write_text("{}")
    assert ck.latest_step() is None
    ck.save(8, {"x": 1})
    assert ck.steps() == [8]


def test_truncated_legacy_checkpoint_surfaces_checkpoint_corrupt(pkg,
                                                                 tmp_path):
    ck = pkg.Checkpointer(str(tmp_path))
    ck.save(2, {"x": np.arange(4.0)})
    legacy = tmp_path / "step_000000000005"   # no checksums, torn payload
    os.makedirs(legacy)
    blob = pickle.dumps({"x": np.arange(8.0)})
    (legacy / "state.pkl").write_bytes(blob[: len(blob) // 2])
    (legacy / "METADATA.json").write_text(json.dumps({"step": 5}))
    assert ck.latest_step() == 5
    with pytest.raises(pkg.Corrupt, match="does not unpickle"):
        ck.restore(5)
    assert ck.latest_verifiable_step() == 2
    np.testing.assert_array_equal(ck.restore()["x"], np.arange(4.0))


def test_checkpoint_metadata_records_checksums(pkg, tmp_path):
    ck = pkg.Checkpointer(str(tmp_path))
    ck.save(1, {"w": np.arange(3.0)})
    files = ck.metadata(1)["files"]
    assert set(files) == {"state.pkl"}
    assert len(files["state.pkl"]["sha256"]) == 64
    assert files["state.pkl"]["bytes"] == os.path.getsize(
        tmp_path / "step_000000000001" / "state.pkl")
    assert ck.verify(1)


def test_checkpointer_saves_tensors_as_numpy_and_never_widens(tmp_path):
    """The port's form of the reference's device-array case (:113): a
    tensor comes back a numpy array with its bits; a dtype numpy lacks
    raises (TypeError: a retry cannot help) and leaves no step behind."""
    from cycloneml_tpu_torch.util.checkpoint import TrainingCheckpointer
    ck = TrainingCheckpointer(str(tmp_path))
    ck.save(1, {"w": torch.arange(4.0, dtype=torch.float64),
                "f": [torch.tensor([1.5], dtype=torch.float32)]})
    got = ck.restore(1)
    assert isinstance(got["w"], np.ndarray) and got["w"].dtype == np.float64
    np.testing.assert_array_equal(got["w"], np.arange(4.0))
    assert got["f"][0].dtype == np.float32
    for dt in (torch.bfloat16, torch.float8_e4m3fn):
        with pytest.raises(TypeError, match="never widened"):
            ck.save(2, {"x": torch.zeros(3).to(dt)})
    assert ck.steps() == [1]
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


@pytest.mark.parametrize("writer", PACKAGES)
def test_each_package_reads_the_others_checkpoints(writer, tmp_path):
    """The on-disk contract is shared: steps, METADATA.json (checksum and
    bytes) and the pickled pytree written by one package verify and load
    in the other."""
    reader = "reference" if writer == "port" else "port"
    w, r = _pkg(writer), _pkg(reader)
    state = {"x": np.random.RandomState(0).randn(7), "iteration": 4,
             "hist_s": [np.ones(7)], "loss_history": [3.0, 2.0]}
    w.Checkpointer(str(tmp_path)).save(4, state,
                                       metadata={"fingerprint": "abc"})
    ck = r.Checkpointer(str(tmp_path))
    assert ck.steps() == [4] and ck.verify(4)
    assert ck.metadata(4)["fingerprint"] == "abc"
    got = ck.restore()
    np.testing.assert_array_equal(got["x"], state["x"])
    assert got["loss_history"] == state["loss_history"]


# -- retry_step (tests/test_resilience.py:167-204) -----------------------------

def test_retry_step_recovers_transient(pkg):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("DATA_LOSS: simulated device failure")
        return 42

    failures = []
    assert pkg.retry_step(flaky, max_failures=4,
                          on_failure=lambda i, e: failures.append(i)) == 42
    assert failures == [0, 1]


def test_retry_step_gives_up(pkg):
    def always():
        raise RuntimeError("broken")

    with pytest.raises(RuntimeError, match="failed 3 times"):
        pkg.retry_step(always, max_failures=3, backoff_base_s=0.0)


def test_retry_step_fails_fast_on_permanent(pkg):
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise TypeError("got a bad argument")

    with pytest.raises(TypeError, match="bad argument"):
        pkg.retry_step(broken, max_failures=5)
    assert calls["n"] == 1


def test_retry_step_fails_fast_on_a_sticky_cuda_error():
    """The port's permanent class includes the CUDA errors that poison the
    context: no retry can succeed after one."""
    from cycloneml_tpu_torch.parallel.resilience import retry_step
    calls = {"n": 0}

    def poisoned():
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        retry_step(poisoned, max_failures=5)
    assert calls["n"] == 1


# -- exact optimizer resume (tests/test_resilience.py:248, :265) ---------------

def _resume_at(opt, f, x0, at):
    states = []
    for s in opt.iterations(f, x0):
        states.append(s)
        if s.iteration == at:
            break
    return states[-1]


@pytest.mark.parametrize("kind", ["lbfgs", "owlqn", "lbfgsb"])
def test_optimizer_exact_resume(pkg, kind):
    """Stop after a few iterations, round-trip the state through its
    pytree, resume in a new optimizer: the uninterrupted run's solution,
    objective history and iteration count (L-BFGS-B: bounds that bind)."""
    f, x0 = _quadratic(d=8, seed=11)
    make = {"lbfgs": lambda: pkg.LBFGS(max_iter=40, tol=1e-12),
            "owlqn": lambda: pkg.OWLQN(max_iter=60, tol=1e-12, l1_reg=0.05),
            "lbfgsb": lambda: pkg.LBFGSB(np.full(8, -0.05), np.full(8, 0.05),
                                         max_iter=40, tol=1e-12)}[kind]
    full = make().minimize(f, x0)
    mid = pkg.OptimState.from_pytree(
        _resume_at(make(), f, x0, 3).to_pytree())
    resumed = make().minimize(f, None, resume=mid)
    np.testing.assert_allclose(resumed.x, full.x, rtol=1e-12, atol=1e-12)
    assert resumed.loss_history == pytest.approx(full.loss_history,
                                                 rel=1e-12)
    assert resumed.iteration == full.iteration


@pytest.mark.parametrize("kind", ["lbfgs", "owlqn", "lbfgsb"])
def test_port_resumes_the_references_optimizer_state(kind):
    """A state the reference's optimizer yielded resumes in the port's on
    the reference's uninterrupted trajectory (the pytrees are the same)."""
    ref, port = _pkg("reference"), _pkg("port")
    f, x0 = _quadratic(d=8, seed=11)
    args = {"lbfgs": ("LBFGS", (), dict(max_iter=40, tol=1e-12)),
            "owlqn": ("OWLQN", (), dict(max_iter=60, tol=1e-12,
                                        l1_reg=0.05)),
            "lbfgsb": ("LBFGSB", (np.full(8, -0.05), np.full(8, 0.05)),
                       dict(max_iter=40, tol=1e-12))}[kind]
    name, pos, kw = args
    full = getattr(ref, name)(*pos, **kw).minimize(f, x0)
    mid = _resume_at(getattr(ref, name)(*pos, **kw), f, x0, 3).to_pytree()
    resumed = getattr(port, name)(*pos, **kw).minimize(
        f, None, resume=port.OptimState.from_pytree(mid))
    np.testing.assert_allclose(resumed.x, full.x, rtol=1e-12, atol=1e-12)
    assert resumed.iteration == full.iteration


# -- train_with_checkpoints (tests/test_resilience.py:61, :282-351) ------------

def test_replay_of_finished_job_is_noop(pkg, tmp_path):
    f, x0 = _quadratic()
    ck = pkg.Checkpointer(str(tmp_path))
    final = pkg.train(pkg.LBFGS(max_iter=40, tol=1e-12), f, x0, ck,
                      interval=3)
    assert final.converged
    evals = {"n": 0}

    def counting_f(x):
        evals["n"] += 1
        return f(x)

    again = pkg.train(pkg.LBFGS(max_iter=40, tol=1e-12), counting_f, x0, ck,
                      interval=3)
    assert evals["n"] == 0
    assert again.iteration == final.iteration and again.converged


def test_train_with_checkpoints_crash_and_resume(pkg, tmp_path):
    f, x0 = _quadratic(d=10, seed=5)
    baseline = pkg.LBFGS(max_iter=50, tol=1e-12).minimize(f, x0)
    evals = {"n": 0}

    def failing_f(x):
        evals["n"] += 1
        if evals["n"] >= 8:
            raise RuntimeError("SLICE_LOST")
        return f(x)

    ck = pkg.Checkpointer(str(tmp_path), keep_last=3)
    with pytest.raises(RuntimeError):
        pkg.train(pkg.LBFGS(max_iter=50, tol=1e-12), failing_f, x0, ck,
                  interval=2, max_step_failures=1)
    crashed_at = ck.latest_step()
    assert crashed_at is not None and crashed_at >= 2
    final = pkg.train(pkg.LBFGS(max_iter=50, tol=1e-12), f, x0, ck,
                      interval=2)
    np.testing.assert_allclose(final.x, baseline.x, rtol=1e-12, atol=1e-12)
    assert final.loss_history == pytest.approx(baseline.loss_history)
    assert ck.latest_step() == final.iteration


def test_permanent_failure_after_progress_aborts(pkg, tmp_path):
    f, x0 = _quadratic(d=6, seed=2)
    evals = {"n": 0}

    def dies_later(x):
        evals["n"] += 1
        if evals["n"] > 5:
            raise RuntimeError("permanent")
        return f(x)

    ck = pkg.Checkpointer(str(tmp_path))
    with pytest.raises(RuntimeError, match="failed 4 times"):
        pkg.train(pkg.LBFGS(max_iter=50, tol=1e-12), dies_later, x0, ck,
                  interval=2, max_step_failures=4, backoff_base_s=0.0)
    assert evals["n"] == 9   # 5 good evaluations, 4 failed attempts


def test_resume_does_not_replay_on_step(pkg, tmp_path):
    f, x0 = _quadratic(d=6, seed=4)
    ck = pkg.Checkpointer(str(tmp_path))
    for s in pkg.LBFGS(max_iter=50, tol=1e-12).iterations(f, x0):
        if s.iteration == 4:
            ck.save(4, s.to_pytree())
            break
    second_run = []
    pkg.train(pkg.LBFGS(max_iter=50, tol=1e-12), f, x0, ck, interval=3,
              on_step=lambda s: second_run.append(s.iteration))
    assert second_run[0] == 5
    assert second_run == sorted(set(second_run))   # each announced once


def test_train_with_checkpoints_transient_retry(pkg, tmp_path):
    f, x0 = _quadratic(d=5, seed=9)
    evals = {"n": 0}

    def flaky_f(x):
        evals["n"] += 1
        if evals["n"] in (3, 11):
            raise RuntimeError("transient")
        return f(x)

    ck = pkg.Checkpointer(str(tmp_path))
    final = pkg.train(pkg.LBFGS(max_iter=50, tol=1e-12), flaky_f, x0, ck,
                      interval=5, max_step_failures=3)
    baseline = pkg.LBFGS(max_iter=50, tol=1e-12).minimize(f, x0)
    np.testing.assert_allclose(final.x, baseline.x, rtol=1e-10)


def test_train_with_checkpoints_takes_no_supervisor(tmp_path):
    """The mesh supervisor needs several devices: anything but None
    raises, citing its ROADMAP item."""
    from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS
    from cycloneml_tpu_torch.parallel.resilience import train_with_checkpoints
    from cycloneml_tpu_torch.util.checkpoint import TrainingCheckpointer
    f, x0 = _quadratic()
    with pytest.raises(NotImplementedError, match="item 9"):
        train_with_checkpoints(LBFGS(), f, x0,
                               TrainingCheckpointer(str(tmp_path)),
                               supervisor=object())
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("writer", PACKAGES)
def test_crashed_directory_resumes_in_the_other_package(writer, tmp_path):
    """A directory one package's ``train_with_checkpoints`` left at a
    mid-save crash (a fingerprint bound) resumes in the other's onto the
    writer's uninterrupted run within 1e-12; the iterations agree."""
    reader = "reference" if writer == "port" else "port"
    w, r = _pkg(writer), _pkg(reader)
    f, x0 = _quadratic(d=10, seed=5)
    baseline = w.LBFGS(max_iter=50, tol=1e-12).minimize(f, x0)
    ck = str(tmp_path / "ck")
    sched = w.FaultSchedule().at("checkpoint.commit", 3,
                                 w.MidSaveCrash("power cut"))
    with w.FaultInjector(sched):
        with pytest.raises(w.MidSaveCrash):
            w.train(w.LBFGS(max_iter=50, tol=1e-12), f, x0,
                    w.Checkpointer(ck), interval=2, fingerprint="fp1")
    assert r.Checkpointer(ck).steps() == [2, 4]
    final = r.train(r.LBFGS(max_iter=50, tol=1e-12), f, x0,
                    r.Checkpointer(ck), interval=2, fingerprint="fp1")
    np.testing.assert_allclose(final.x, baseline.x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(final.loss_history, baseline.loss_history,
                               rtol=1e-12)
    assert final.iteration == baseline.iteration
    with pytest.raises(ValueError, match="DIFFERENT training run"):
        r.train(r.LBFGS(max_iter=50, tol=1e-12), f, x0, r.Checkpointer(ck),
                interval=2, fingerprint="another")


# -- the chaos cases (tests/test_chaos.py:206, :234, :263, :1145, :1163) -------

def test_mid_save_crash_never_leaves_corrupt_checkpoint(pkg, tmp_path):
    f, x0 = _quadratic(d=8, seed=11)
    baseline = pkg.LBFGS(max_iter=40, tol=1e-12).minimize(f, x0)
    ck = pkg.Checkpointer(str(tmp_path), keep_last=5)
    sched = pkg.FaultSchedule().at("checkpoint.commit", 2,
                                   pkg.MidSaveCrash("power cut mid-save"))
    with pkg.FaultInjector(sched) as inj:
        with pytest.raises(pkg.MidSaveCrash):
            pkg.train(pkg.LBFGS(max_iter=40, tol=1e-12), f, x0, ck,
                      interval=2)
    assert inj.log == [("checkpoint.commit", 2, "MidSaveCrash")]
    assert ck.steps() == [2]
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
    assert ck.verify(2)
    final = pkg.train(pkg.LBFGS(max_iter=40, tol=1e-12), f, x0, ck,
                      interval=2)
    np.testing.assert_allclose(final.x, baseline.x, rtol=1e-12, atol=1e-12)
    assert final.loss_history == pytest.approx(baseline.loss_history)


def test_corrupt_latest_checkpoint_falls_back_to_verifiable(pkg, tmp_path):
    f, x0 = _quadratic(d=10, seed=5)
    baseline = pkg.LBFGS(max_iter=50, tol=1e-12).minimize(f, x0)
    ck = pkg.Checkpointer(str(tmp_path), keep_last=5)
    final = pkg.train(pkg.LBFGS(max_iter=50, tol=1e-12), f, x0, ck,
                      interval=2)
    latest = ck.latest_step()
    assert latest == final.iteration and len(ck.steps()) >= 2
    pkl = os.path.join(tmp_path, f"step_{latest:012d}", "state.pkl")
    with open(pkl, "r+b") as fh:
        fh.truncate(os.path.getsize(pkl) // 2)
    assert not ck.verify(latest)
    with pytest.raises(pkg.Corrupt, match="checksum mismatch"):
        ck.restore(latest)
    fallback = ck.latest_verifiable_step()
    assert fallback is not None and fallback < latest
    ck.restore()
    resumed = pkg.train(pkg.LBFGS(max_iter=50, tol=1e-12), f, x0, ck,
                        interval=2)
    np.testing.assert_allclose(resumed.x, baseline.x, rtol=1e-12, atol=1e-12)
    assert resumed.iteration == baseline.iteration


def test_all_checkpoints_corrupt_aborts_loudly(pkg, tmp_path):
    f, x0 = _quadratic()
    ck = pkg.Checkpointer(str(tmp_path), keep_last=3)
    pkg.train(pkg.LBFGS(max_iter=40, tol=1e-12), f, x0, ck, interval=2)
    for step in ck.steps():
        pkl = os.path.join(tmp_path, f"step_{step:012d}", "state.pkl")
        with open(pkl, "wb") as fh:
            fh.write(b"garbage")
    with pytest.raises(pkg.Corrupt, match="failed verification"):
        pkg.train(pkg.LBFGS(max_iter=40, tol=1e-12), f, x0, ck, interval=2)


def test_save_entry_fault_leaves_prior_checkpoint_intact(pkg, tmp_path):
    ck = pkg.Checkpointer(str(tmp_path), keep_last=3)
    ck.save(1, {"x": 1})
    sched = pkg.FaultSchedule().at("checkpoint.save", 1,
                                   pkg.MidSaveCrash("died before writing"))
    with pkg.FaultInjector(sched) as inj:
        with pytest.raises(pkg.MidSaveCrash):
            ck.save(2, {"x": 2})
    assert inj.log == [("checkpoint.save", 1, "MidSaveCrash")]
    assert ck.steps() == [1] and ck.verify(1)
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_restore_entry_fault_surfaces_not_swallowed(pkg, tmp_path):
    ck = pkg.Checkpointer(str(tmp_path), keep_last=3)
    ck.save(1, {"x": 1})
    sched = pkg.FaultSchedule().at("checkpoint.restore", 1,
                                   pkg.Transient("torn read"))
    with pkg.FaultInjector(sched) as inj:
        with pytest.raises(pkg.Transient):
            ck.restore(1)
    assert inj.log == [("checkpoint.restore", 1, "TransientCollectiveError")]


def test_restore_point_fires_only_where_a_load_begins(tmp_path):
    """``restore_newest_verifiable`` fires ``checkpoint.restore`` once a
    load begins and never on an empty directory (the reference's count)."""
    port = _pkg("port")
    sched = port.FaultSchedule()
    with port.FaultInjector(sched) as inj:
        ck = port.Checkpointer(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            ck.restore_newest_verifiable()
        assert inj.counts.get("checkpoint.restore", 0) == 0
        ck.save(3, {"x": 3})
        assert ck.restore_newest_verifiable()[0] == 3
        assert inj.counts == {"checkpoint.save": 1, "checkpoint.commit": 1,
                              "checkpoint.restore": 1}


def test_checkpoint_spans_go_to_the_tracer(tmp_path):
    """``checkpoint``/``save`` with ``commit`` nested in it, and
    ``restore``, on the port's tracer."""
    from cycloneml_tpu_torch.observe import tracing
    port = _pkg("port")
    tracer = tracing.enable()
    try:
        ck = port.Checkpointer(str(tmp_path))
        ck.save(1, {"x": np.ones(3)})
        ck.restore()
    finally:
        tracing.disable()
    spans = {sp.name: sp for sp in tracer.snapshot()
             if sp.kind == "checkpoint"}
    assert set(spans) == {"save", "commit", "restore"}
    assert spans["commit"].parent_id == spans["save"].span_id


def test_every_fault_point_of_the_table_fires_here():
    """The port's points table (parallel/faults.py) lists the checkpoint
    points and each is scheduled by a case of this file or of the serving
    tests: the table cannot fall behind the harness."""
    import re

    from cycloneml_tpu_torch.parallel import faults
    table = set(re.findall(r"^``([a-z_]+\.[a-z_]+)``", faults.__doc__, re.M))
    assert {"checkpoint.save", "checkpoint.commit", "checkpoint.restore",
            "serving.dispatch"} == table
    here = open(__file__).read()
    serving = open(os.path.join(os.path.dirname(__file__),
                                "test_torch_serving.py")).read()
    for point in table:
        assert f'"{point}"' in here + serving, point


# -- LogisticRegression (tests/test_resilience.py:370, :397) -------------------

def _lr_frame(MLFrame, ctx, seed=3, n=200, d=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = (x @ rng.randn(d) > 0).astype(float)
    return MLFrame(ctx, {"features": x, "label": y})


def test_logistic_regression_checkpoint_resume(both, tmp_path):
    """A fit killed after 3 iterations resumes with ``checkpointDir`` and
    lands on the uninterrupted fit (the port's uninterrupted fit is its
    chunked device optimizer; the checkpointed ones the host L-BFGS)."""
    name, ctx = both
    MLFrame, LogisticRegression, _ = _estimators(name)
    frame = _lr_frame(MLFrame, ctx)
    ck = str(tmp_path / "lr-ck")
    full = LogisticRegression(maxIter=40, tol=1e-9).fit(frame)
    LogisticRegression(maxIter=3, tol=1e-9, checkpointDir=ck,
                       checkpointInterval=2).fit(frame)
    assert os.listdir(ck)
    resumed = LogisticRegression(maxIter=40, tol=1e-9, checkpointDir=ck,
                                 checkpointInterval=2).fit(frame)
    np.testing.assert_allclose(np.asarray(resumed.coefficients.to_array()),
                               np.asarray(full.coefficients.to_array()),
                               rtol=1e-8)
    assert resumed.summary.total_iterations == full.summary.total_iterations


def test_checkpoint_fingerprint_guards_reuse(both, tmp_path):
    name, ctx = both
    MLFrame, LogisticRegression, _ = _estimators(name)
    rng = np.random.RandomState(0)
    x = rng.randn(100, 4)
    ck = str(tmp_path / "ck")
    frame_a = MLFrame(ctx, {"features": x,
                            "label": (x[:, 0] > 0).astype(float)})
    frame_b = MLFrame(ctx, {"features": x,
                            "label": (x[:, 1] > 0).astype(float)})
    LogisticRegression(maxIter=5, checkpointDir=ck).fit(frame_a)
    with pytest.raises(ValueError, match="DIFFERENT training run"):
        LogisticRegression(maxIter=5, checkpointDir=ck).fit(frame_b)
    with pytest.raises(ValueError, match="DIFFERENT training run"):
        LogisticRegression(maxIter=5, regParam=0.5,
                           checkpointDir=ck).fit(frame_a)


def test_checkpointed_fit_takes_the_host_optimizer(pctx, tmp_path):
    """With ``checkpointDir`` the port runs the host L-BFGS (a state an
    iteration to save), without it the chunked device optimizer: both
    fits agree in float64, and the checkpointed one saved every second
    iteration and its last."""
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.util.checkpoint import TrainingCheckpointer
    frame = _lr_frame(MLFrame, pctx, seed=8)
    plain = LogisticRegression(maxIter=30, tol=1e-10).fit(frame)
    ck = str(tmp_path / "ck")
    model = LogisticRegression(maxIter=30, tol=1e-10, checkpointDir=ck,
                               checkpointInterval=2).fit(frame)
    it = model.summary.total_iterations
    # the chunked optimizer runs many iterations a dispatch; the host
    # L-BFGS one line search (on the device) an iteration
    assert plain.summary.total_dispatches < it
    assert model.summary.total_dispatches == it + 1
    steps = TrainingCheckpointer(ck).steps()
    assert steps[-1] == it and all(s % 2 == 0 for s in steps[:-1])
    np.testing.assert_allclose(model.coefficients.to_array(),
                               plain.coefficients.to_array(), rtol=1e-7)


def test_streamed_fit_checkpoints_and_resumes(pctx, tmp_path):
    """The streamed (out-of-core) fit goes through the same optimize tail:
    a fit stopped at 3 iterations resumes onto the uninterrupted streamed
    fit."""
    from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.oocore import shard_dataset
    rng = np.random.RandomState(5)
    x = rng.randn(300, 5)
    y = (x @ rng.randn(5) > 0).astype(float)
    pctx.conf.set("cyclone.oocore.shardRows", "64")
    sds = shard_dataset(InstanceDataset.from_numpy(pctx, x, y))
    try:
        full = LogisticRegression(maxIter=20, tol=1e-9).fit(sds)
        ck = str(tmp_path / "ck")
        LogisticRegression(maxIter=3, tol=1e-9, checkpointDir=ck).fit(sds)
        resumed = LogisticRegression(maxIter=20, tol=1e-9,
                                     checkpointDir=ck).fit(sds)
    finally:
        sds.close()
    assert resumed.summary.streamed
    np.testing.assert_allclose(resumed.coefficients.to_array(),
                               full.coefficients.to_array(), rtol=1e-10)
    assert resumed.summary.objective_history == pytest.approx(
        full.summary.objective_history, rel=1e-12)


# -- ALS (tests/test_als.py:118, :136) -----------------------------------------

def test_als_checkpoint_resume_matches_uninterrupted(both, tmp_path):
    name, ctx = both
    MLFrame, _, ALS = _estimators(name)
    users, items, r = _ratings(seed=3)
    frame = MLFrame(ctx, {"user": users, "item": items, "rating": r})
    full = ALS(rank=3, maxIter=6, seed=9).fit(frame)
    ck = str(tmp_path / "als-ck")
    ALS(rank=3, maxIter=2, seed=9, checkpointDir=ck,
        checkpointInterval=1).fit(frame)
    resumed = ALS(rank=3, maxIter=6, seed=9, checkpointDir=ck,
                  checkpointInterval=1).fit(frame)
    np.testing.assert_allclose(resumed.user_factors, full.user_factors,
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(resumed.item_factors, full.item_factors,
                               rtol=1e-6, atol=1e-8)


def test_als_checkpoint_fingerprint_guards_foreign_resume(both, tmp_path):
    name, ctx = both
    MLFrame, _, ALS = _estimators(name)
    users, items, r = _ratings(seed=3)
    frame = MLFrame(ctx, {"user": users, "item": items, "rating": r})
    ck = str(tmp_path / "ck")
    ALS(rank=3, maxIter=3, seed=9, checkpointDir=ck,
        checkpointInterval=1).fit(frame)
    with pytest.raises(ValueError, match="DIFFERENT ALS run"):
        ALS(rank=4, maxIter=3, seed=9, checkpointDir=ck,
            checkpointInterval=1).fit(frame)
    frame2 = MLFrame(ctx, {"user": users, "item": items, "rating": r + 1.0})
    with pytest.raises(ValueError, match="DIFFERENT ALS run"):
        ALS(rank=3, maxIter=3, seed=9, checkpointDir=ck,
            checkpointInterval=1).fit(frame2)


def test_als_checkpoint_past_max_iter_raises(pctx, tmp_path):
    """A checkpoint past ``maxIter`` raises (an over-trained model); one
    at ``maxIter`` is the requested model. No save after the last
    iteration."""
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.ml.recommendation import ALS
    from cycloneml_tpu_torch.util.checkpoint import TrainingCheckpointer
    users, items, r = _ratings(seed=4)
    frame = MLFrame(pctx, {"user": users, "item": items, "rating": r})
    ck = str(tmp_path / "ck")
    ALS(rank=3, maxIter=5, seed=1, checkpointDir=ck,
        checkpointInterval=2).fit(frame)
    assert TrainingCheckpointer(ck).steps() == [2, 4]
    with pytest.raises(ValueError, match="maxIter=3"):
        ALS(rank=3, maxIter=3, seed=1, checkpointDir=ck).fit(frame)
    at_four = ALS(rank=3, maxIter=4, seed=1, checkpointDir=ck).fit(frame)
    plain = ALS(rank=3, maxIter=4, seed=1).fit(frame)
    np.testing.assert_array_equal(at_four.user_factors, plain.user_factors)


def test_als_directory_of_the_reference_resumes_in_the_port(ctx, pctx,
                                                            tmp_path):
    """The reference saves its factors at iteration 4 (of 5); the port
    resumes that directory to 12 iterations and lands within 1e-10 of the
    reference's uninterrupted float64 fit."""
    RefFrame, _, RefALS = _estimators("reference")
    MLFrame, _, ALS = _estimators("port")
    users, items, r = _ratings(seed=3)
    cols = {"user": users, "item": items, "rating": r}
    kw = dict(rank=3, seed=9, regParam=0.1)
    full = RefALS(maxIter=12, **kw).fit(RefFrame(ctx, cols))
    ck = str(tmp_path / "ck")
    RefALS(maxIter=5, checkpointDir=ck, checkpointInterval=4,
           **kw).fit(RefFrame(ctx, cols))
    from cycloneml_tpu_torch.util.checkpoint import TrainingCheckpointer
    assert TrainingCheckpointer(ck).steps() == [4]
    resumed = ALS(maxIter=12, checkpointDir=ck, checkpointInterval=4,
                  **kw).fit(MLFrame(pctx, cols))
    np.testing.assert_allclose(resumed.user_factors, full.user_factors,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(resumed.item_factors, full.item_factors,
                               rtol=1e-10, atol=1e-10)


# -- on the card ---------------------------------------------------------------

def _cuda_ctx():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return CycloneContext(CycloneConf().set("cyclone.master", "cuda"))


@pytest.mark.gpu
def test_cuda_lr_resume_is_bitwise(tmp_path):
    """On the card (K1 on bf16 X, host L-BFGS): a fit crashed at its
    second commit resumes from step 2 to the uninterrupted checkpointed
    fit's coefficients, iterations and objective history bit for bit."""
    from cycloneml_tpu_torch.dataset.random import generate_classification
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    from cycloneml_tpu_torch.ops import kernels
    from cycloneml_tpu_torch.parallel.faults import (FaultInjector,
                                                     FaultSchedule,
                                                     MidSaveCrash)
    from cycloneml_tpu_torch.util.checkpoint import TrainingCheckpointer
    ctx = _cuda_ctx()
    try:
        ds = generate_classification(ctx, 20_000, 300, seed=4)

        def fit(d):
            return LogisticRegression(maxIter=12, regParam=0.01, tol=0.0,
                                      checkpointDir=d,
                                      checkpointInterval=2).fit(ds)
        kernels.reset_launch_counts()
        full = fit(str(tmp_path / "full"))
        assert kernels.glm_sweep.launches_by_link["logistic"] == \
            full.summary.total_evals
        crash = str(tmp_path / "crash")
        sched = FaultSchedule().at("checkpoint.commit", 2,
                                   MidSaveCrash("power cut"))
        with FaultInjector(sched), pytest.raises(MidSaveCrash):
            fit(crash)
        assert TrainingCheckpointer(crash).steps() == [2]
        resumed = fit(crash)
    finally:
        ctx.stop()
    assert np.array_equal(resumed.coefficients.to_array(),
                          full.coefficients.to_array())
    assert resumed.intercept == full.intercept
    assert resumed.summary.total_iterations == full.summary.total_iterations
    assert resumed.summary.objective_history == \
        full.summary.objective_history


@pytest.mark.gpu
def test_cuda_als_resume_is_bitwise(tmp_path):
    """On the card (``als_normal``): a fit crashed at its second commit
    resumes from iteration 2 to the uncheckpointed fit's factors bit for
    bit, with 2 x (6 - 2) kernel launches."""
    from cycloneml_tpu_torch.dataset.frame import MLFrame
    from cycloneml_tpu_torch.ml.recommendation import ALS
    from cycloneml_tpu_torch.ops import kernels
    from cycloneml_tpu_torch.parallel.faults import (FaultInjector,
                                                     FaultSchedule,
                                                     MidSaveCrash)
    ctx = _cuda_ctx()
    try:
        users, items, r = _ratings(seed=5, n_users=400, n_items=300, rank=8)
        frame = MLFrame(ctx, {"user": users, "item": items, "rating": r})
        kw = dict(rank=8, maxIter=6, seed=2, regParam=0.05)
        plain = ALS(**kw).fit(frame)
        ck = str(tmp_path / "ck")
        sched = FaultSchedule().at("checkpoint.commit", 2,
                                   MidSaveCrash("power cut"))
        with FaultInjector(sched), pytest.raises(MidSaveCrash):
            ALS(checkpointDir=ck, checkpointInterval=2, **kw).fit(frame)
        kernels.reset_launch_counts()
        resumed = ALS(checkpointDir=ck, checkpointInterval=2, **kw).fit(frame)
        launches = kernels.als_normal.launches
    finally:
        ctx.stop()
    assert launches == 2 * (6 - 2)
    assert np.array_equal(resumed.user_factors, plain.user_factors)
    assert np.array_equal(resumed.item_factors, plain.item_factors)
