"""Failure classification and retry backoff.

The port's counterpart of the classification part of
``cycloneml_tpu/parallel/resilience.py`` (:50-107): **transient** failures
(a flaky link, an I/O hiccup) are retried with exponential backoff and
jitter; **permanent** failures abort at once, since a retry runs the same
bug; **device loss** means the mesh is gone and recovery is a rebuild.

The port's permanent types are the reference's Python ones (``TypeError``,
``SyntaxError``, ``NameError``) and the CUDA errors that poison the
context: an illegal address, a launch failure, a device-side assert and
the rest of the sticky errors (:data:`STICKY_CUDA_ERRORS`). After one of
them every later call on the context fails, so a retry cannot succeed.
Heartbeats, the mesh supervisor, ``retry_step`` and
``train_with_checkpoints`` come with ROADMAP Queue 1 items 9 and 10.
"""

from __future__ import annotations

import random
from typing import Optional

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
