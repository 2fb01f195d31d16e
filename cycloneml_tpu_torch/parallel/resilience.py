"""Failure classification, retries and checkpointed training.

The port's counterpart of ``cycloneml_tpu/parallel/resilience.py``'s
classification (:50-107), ``retry_step`` (:483-519) and
``train_with_checkpoints`` (:915-1109): **transient** failures (a flaky
link, an I/O hiccup) are retried with exponential backoff and jitter;
**permanent** failures abort at once, since a retry runs the same bug;
**device loss** means the mesh is gone and recovery is a rebuild.

The port's permanent types are the reference's Python ones (``TypeError``,
``SyntaxError``, ``NameError``) and the CUDA errors that poison the
context: an illegal address, a launch failure, a device-side assert and
the rest of the sticky errors (:data:`STICKY_CUDA_ERRORS`). After one of
them every later call on the context fails, so a retry cannot succeed.

:func:`train_with_checkpoints` drives an optimizer's iterations with
periodic checkpoints (``util/checkpoint.TrainingCheckpointer``) and resumes
from the newest verifiable one, on one device: heartbeats, the mesh
supervisor (device-loss recovery, the preemption drain, elastic capacity)
need several devices and are ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional

from cycloneml_tpu_torch.observe import tracing
from cycloneml_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

# specific runtime tokens only: broad phrases would match ordinary error
# text and misroute a failure into a mesh rebuild
_DEVICE_LOSS_MARKERS = ("DATA_LOSS", "SLICE_LOST", "DEVICE_SHUTTING_DOWN")

#: cudaError_t codes after which the CUDA context is unusable: illegal
#: address (700), launch timeout (702), context destroyed (709), assert
#: (710), hardware stack error (713), illegal instruction (714),
#: misaligned address (715), invalid address space (716), invalid program
#: counter (717), launch failure (719)
STICKY_CUDA_ERRORS = frozenset((700, 702, 709, 710, 713, 714, 715, 716,
                                717, 719))

# the same errors as torch's CUDA runtime reports them in its messages
_STICKY_CUDA_MARKERS = (
    "an illegal memory access was encountered",
    "unspecified launch failure", "the launch timed out",
    "device-side assert triggered", "misaligned address",
    "an illegal instruction was encountered", "hardware stack error",
    "invalid program counter", "operation not supported on global/shared "
    "address space")


def _poisons_the_context(exc: BaseException) -> bool:
    from cycloneml_tpu_torch.ops.kernels import CudaError
    if isinstance(exc, CudaError):
        return exc.code in STICKY_CUDA_ERRORS
    msg = str(exc)
    return "CUDA" in msg and any(m in msg for m in _STICKY_CUDA_MARKERS)


def is_device_loss(exc: BaseException) -> bool:
    """True when the failure means the mesh (or part of it) is gone: the
    recovery is a rebuild, not a retry."""
    from cycloneml_tpu_torch.parallel.faults import DeviceLostError
    if isinstance(exc, DeviceLostError):
        return True
    msg = str(exc)
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


def classify_failure(exc: BaseException) -> str:
    """``'device_loss'`` | ``'permanent'`` | ``'transient'``.

    Device loss is checked first. Permanent: the step itself is broken
    (``TypeError``, ``SyntaxError``, ``NameError``), or a CUDA error
    poisoned the context. Everything else is presumed transient and worth
    a backoff retry."""
    if is_device_loss(exc):
        return "device_loss"
    if isinstance(exc, (TypeError, SyntaxError, NameError)) or \
            _poisons_the_context(exc):
        return "permanent"
    return "transient"


def backoff_delay(attempt: int, base_s: float = 0.05, max_s: float = 2.0,
                  rng: Optional[random.Random] = None) -> float:
    """Exponential backoff with jitter: ``min(max, base 2^attempt)``
    scaled by a uniform draw in [0.5, 1], deterministic under a seeded
    ``rng``."""
    if base_s <= 0:
        return 0.0
    r = rng.random() if rng is not None else random.random()
    return min(max_s, base_s * (2.0 ** attempt)) * (0.5 + 0.5 * r)


def retry_step(fn: Callable[[], Any], max_failures: int = 4,
               on_failure: Optional[Callable[[int, Exception], None]] = None,
               retryable=(Exception,), backoff_base_s: float = 0.02,
               backoff_max_s: float = 2.0,
               rng: Optional[random.Random] = None) -> Any:
    """Run one step with whole-step retry (barrier-stage semantics).

    Transient failures are retried with exponential backoff and jitter;
    permanent ones (:func:`classify_failure`) propagate at once. ``rng``
    seeds the jitter (a fixed default, so a chaos run replays)."""
    if rng is None:
        rng = random.Random(0xC1C10)
    last: Optional[Exception] = None
    for attempt in range(max_failures):
        try:
            return fn()
        except retryable as e:  # noqa: PERF203 (the retry loop)
            if classify_failure(e) == "permanent":
                logger.error("step failed permanently (%s: %s); not retrying",
                             type(e).__name__, e)
                raise
            last = e
            logger.warning("step failed (attempt %d/%d): %s",
                           attempt + 1, max_failures, e)
            tracing.instant("retry", attempt=attempt + 1,
                            error=type(e).__name__)
            if on_failure is not None:
                on_failure(attempt, e)
            if attempt + 1 < max_failures:
                time.sleep(backoff_delay(attempt, backoff_base_s,
                                         backoff_max_s, rng))
    raise RuntimeError(
        f"step failed {max_failures} times; aborting job "
        f"(≈ TaskSetManager 'Task failed {max_failures} times')") from last


def _restore_latest_verified(checkpointer, fingerprint: Optional[str]):
    """``(step, pytree)`` of the newest verifiable checkpoint, or None when
    the directory holds none. Raises ``CheckpointCorrupt`` when steps exist
    but none verifies, and ``ValueError`` when the state is another run's
    (its fingerprint differs, or it has none)."""
    try:
        step, tree = checkpointer.restore_newest_verifiable()
    except FileNotFoundError:
        return None  # an empty directory: a fresh run
    if fingerprint is not None:
        saved = checkpointer.metadata(step).get("fingerprint")
        if saved != fingerprint:
            raise ValueError(
                f"checkpoint dir {checkpointer.directory!r} holds state "
                f"for a DIFFERENT training run (fingerprint {saved} != "
                f"{fingerprint}); resuming it would silently return the "
                "wrong model — clear the directory or use a new one")
    return step, tree


def train_with_checkpoints(optimizer, loss_grad, x0, checkpointer,
                           interval: int = 5, max_step_failures: int = 4,
                           on_step: Optional[Callable] = None,
                           fingerprint: Optional[str] = None,
                           supervisor=None, backoff_base_s: float = 0.02,
                           backoff_max_s: float = 2.0, seed: int = 0):
    """Drive ``optimizer.iterations`` with a checkpoint every ``interval``
    iterations and a final one, resuming from the newest verifiable
    checkpoint of ``checkpointer`` (the whole curvature memory is saved,
    so the resumed run takes the uninterrupted run's steps). Returns the
    last ``OptimState``.

    A failed step is classified (:func:`classify_failure`): a permanent
    failure is raised at once; any other rebuilds the iteration stream
    from the last good state after a backoff whose jitter ``seed`` fixes,
    and ``max_step_failures`` failures of one step abort. The rebuilt
    stream's re-yield of its resume point is skipped, and ``on_step`` is
    never called twice for an iteration. ``supervisor`` (device-loss
    recovery, the preemption drain, elastic capacity) needs several
    devices: only None is accepted."""
    if supervisor is not None:
        raise NotImplementedError(
            "train_with_checkpoints(supervisor=...): the mesh supervisor "
            "needs several devices, ROADMAP Queue 1 item 9")
    from cycloneml_tpu_torch.ml.optim.lbfgs import OptimState

    rng = random.Random(seed)
    resume = None
    restored = _restore_latest_verified(checkpointer, fingerprint)
    if restored is not None:
        step, tree = restored
        resume = OptimState.from_pytree(tree)
        logger.info("resuming training from checkpoint step %d", step)

    it = optimizer.iterations(loss_grad, x0, resume=resume)
    # the resume state was delivered (saved, announced) by the run that
    # wrote it: its re-yield is skipped, not announced again
    state = resume
    last_announced = resume.iteration if resume is not None else -1
    fail_count = 0
    while True:
        try:
            s = next(it, None)
        except Exception as e:
            # the budget counts failures of the same step across stream
            # rebuilds: the re-yield of the resume point must not reset it
            if classify_failure(e) == "permanent":
                logger.error("step failed permanently (%s: %s); aborting",
                             type(e).__name__, e)
                raise
            fail_count += 1
            logger.warning("step failed (attempt %d/%d): %s",
                           fail_count, max_step_failures, e)
            tracing.instant("retry", attempt=fail_count,
                            error=type(e).__name__)
            if fail_count >= max_step_failures:
                raise RuntimeError(
                    f"step failed {max_step_failures} times; aborting job "
                    f"(≈ TaskSetManager 'Task failed {max_step_failures} "
                    f"times')") from e
            time.sleep(backoff_delay(fail_count - 1, backoff_base_s,
                                     backoff_max_s, rng))
            it = optimizer.iterations(loss_grad, x0, resume=state)
            continue
        if s is None:
            break
        if state is not None and s.iteration <= state.iteration:
            continue  # the re-yield of the resume point after a rebuild
        state = s
        fail_count = 0  # progress resets the per-step budget
        if on_step is not None and state.iteration > last_announced:
            on_step(state)
        last_announced = max(last_announced, state.iteration)
        if state.iteration > 0 and state.iteration % interval == 0:
            checkpointer.save(state.iteration, state.to_pytree(),
                              metadata={"loss": state.value,
                                        "fingerprint": fingerprint})
        if state.converged:
            break
    if state is not None and checkpointer.latest_step() != state.iteration:
        checkpointer.save(state.iteration, state.to_pytree(),
                          metadata={"loss": state.value, "final": True,
                                    "fingerprint": fingerprint})
    return state
