"""Step-level training checkpoints.

The port's counterpart of ``cycloneml_tpu/util/checkpoint.py``, with the
same on-disk contract, so that either package resumes the other's
directories: ``<dir>/step_<012d>/{state.pkl, METADATA.json}``, the state a
pickle of host numpy pytrees, the metadata JSON with the step, the
caller's fields and a sha256 and byte count per payload file.

Durability:

- every payload file is fsync'd before the commit rename, and the parent
  directory is fsync'd after it: a crash at any point leaves either a
  readable checkpoint or an invisible ``.tmp`` leftover, never a visible
  half-written one;
- ``METADATA.json`` records the sha256 (taken while writing) and the byte
  count of ``state.pkl``, so a step damaged after its commit is detected;
- ``restore()`` with no step falls back to the newest verifiable step and
  raises :class:`CheckpointCorrupt` only when every step fails.

Tensors, CUDA tensors included, are saved as numpy arrays. A tensor whose
dtype numpy lacks (bfloat16, float8) raises: it is never widened. Spans
``checkpoint``/``save``, ``commit`` and ``restore`` go to the active
tracer, and the fault points ``checkpoint.save``, ``checkpoint.commit`` and
``checkpoint.restore`` fire where the reference's do.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from cycloneml_tpu_torch.observe import tracing
from cycloneml_tpu_torch.parallel import faults
from cycloneml_tpu_torch.util.logging import get_logger

logger = get_logger(__name__)

# torch dtypes with no numpy counterpart: a checkpoint holds numpy arrays
_NO_NUMPY = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


class CheckpointCorrupt(Exception):
    """A committed checkpoint failed verification (checksum mismatch,
    truncated or unpicklable payload)."""


def _to_host(tree: Any) -> Any:
    """Tensors (on any device) and other array-likes to numpy, through
    dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_to_host(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, torch.Tensor):
        if tree.dtype in _NO_NUMPY:
            raise TypeError(
                f"a {tree.dtype} tensor has no numpy dtype; checkpoint it "
                "at a dtype numpy has (it is never widened here)")
        return tree.detach().cpu().numpy()
    if hasattr(tree, "__array__") and not isinstance(tree, np.ndarray):
        return np.asarray(tree)
    return tree


class _HashingWriter:
    """File-object wrapper feeding every written chunk into a digest, so
    the checksum costs no second pass over the state file."""

    def __init__(self, fh, digest):
        self._fh = fh
        self._digest = digest

    def write(self, b):
        self._digest.update(b)
        return self._fh.write(b)

    def flush(self):
        self._fh.flush()


def _fsync_write(path: str, write_fn) -> str:
    """Write a file through ``write_fn(fh)``, fsync it, return its sha256
    (computed while writing)."""
    digest = hashlib.sha256()
    with open(path, "wb") as fh:
        write_fn(_HashingWriter(fh, digest))
        fh.flush()
        os.fsync(fh.fileno())
    return digest.hexdigest()


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # no directory descriptors here: the rename is still atomic
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class TrainingCheckpointer:
    """Atomic step-directory checkpoints with retention and verification.

    A step directory is renamed into place only after its files are
    written and fsync'd (the reference's CheckpointFileManager commit,
    sql/.../streaming/CheckpointFileManager.scala); the ``keep_last``
    newest steps are kept."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = max(1, keep_last)
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def steps(self) -> List[int]:
        """The committed steps, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            stem = name[5:]
            # non-digit stems are uncommitted leftovers (step_N.tmpXX)
            if name.startswith("step_") and stem.isdigit() and \
                    os.path.exists(os.path.join(self.directory, name,
                                                "METADATA.json")):
                out.append(int(stem))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, state: Any,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        """Commit ``state`` (a pytree; tensors become numpy) as ``step``
        with ``metadata``; a step that exists is kept as it is. Returns the
        step's directory."""
        with tracing.span("checkpoint", "save", step=step):
            faults.inject("checkpoint.save", step=step)
            target = self._step_dir(step)
            if os.path.exists(target):
                return target  # idempotent re-save after a replayed step
            tmp = tempfile.mkdtemp(dir=self.directory,
                                   prefix=f"step_{step:012d}.tmp")
            try:
                state_path = os.path.join(tmp, "state.pkl")
                host = _to_host(state)
                sha = _fsync_write(state_path, lambda fh: pickle.dump(
                    host, fh, protocol=pickle.HIGHEST_PROTOCOL))
                meta = {"step": step, **(metadata or {}),
                        "files": {"state.pkl": {
                            "sha256": sha,
                            "bytes": os.path.getsize(state_path)}}}
                _fsync_write(os.path.join(tmp, "METADATA.json"),
                             lambda fh: fh.write(json.dumps(meta).encode()))
                # a crash between here and the rename orphans the tmp
                # directory, which steps() never lists: the contract
                with tracing.span("checkpoint", "commit", step=step):
                    faults.inject("checkpoint.commit", step=step)
                    os.replace(tmp, target)
                    _fsync_dir(self.directory)
            finally:
                if os.path.isdir(tmp):
                    shutil.rmtree(tmp, ignore_errors=True)
            self._retain()
            return target

    def verify(self, step: int) -> bool:
        """True when ``step`` passes its recorded checksum (a step written
        without checksums passes when its payload unpickles)."""
        try:
            self._verified_load(step)
            return True
        except (CheckpointCorrupt, OSError):
            return False

    def _verified_load(self, step: int) -> Any:
        sdir = self._step_dir(step)
        state_path = os.path.join(sdir, "state.pkl")
        try:
            meta = self.metadata(step)
        except (FileNotFoundError, json.JSONDecodeError) as e:
            raise CheckpointCorrupt(
                f"checkpoint step {step}: unreadable METADATA.json ({e})") \
                from e
        recorded = meta.get("files", {}).get("state.pkl")
        if recorded is not None:
            digest = hashlib.sha256()
            try:
                with open(state_path, "rb") as fh:
                    for chunk in iter(lambda: fh.read(1 << 20), b""):
                        digest.update(chunk)
            except FileNotFoundError as e:
                raise CheckpointCorrupt(
                    f"checkpoint step {step}: state.pkl missing") from e
            if digest.hexdigest() != recorded["sha256"]:
                raise CheckpointCorrupt(
                    f"checkpoint step {step}: state.pkl checksum mismatch "
                    f"(truncated or damaged after commit)")
        try:
            with open(state_path, "rb") as fh:
                return pickle.load(fh)
        except FileNotFoundError:
            raise
        except (EOFError, pickle.UnpicklingError, ValueError,
                AttributeError, ImportError) as e:
            # steps without checksums land here when truncated
            raise CheckpointCorrupt(
                f"checkpoint step {step}: state.pkl does not unpickle "
                f"({type(e).__name__}: {e})") from e

    def latest_verifiable_step(self) -> Optional[int]:
        """The newest step that passes verification, or None."""
        for step in reversed(self.steps()):
            if self.verify(step):
                return step
        return None

    def restore_newest_verifiable(self) -> tuple:
        """``(step, state)`` of the newest step that passes verification,
        one read, hash and unpickle a candidate. Damaged steps are logged
        and skipped; raises :class:`CheckpointCorrupt` when steps exist but
        none verifies, ``FileNotFoundError`` when there is none."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        with tracing.span("checkpoint", "restore", step=-1):
            # fired only where a load begins: an empty directory raised
            # above without firing
            faults.inject("checkpoint.restore", step=None)
            last_err: Optional[Exception] = None
            for s in reversed(steps):
                try:
                    return s, self._verified_load(s)
                except (CheckpointCorrupt, OSError) as e:
                    last_err = e
                    logger.warning(
                        "checkpoint step %d failed verification (%s); "
                        "falling back to the previous step", s, e)
        raise CheckpointCorrupt(
            f"all {len(steps)} checkpoints under {self.directory} failed "
            f"verification; newest error: {last_err}") from last_err

    def restore(self, step: Optional[int] = None) -> Any:
        """The state of ``step`` (verified; :class:`CheckpointCorrupt` on
        damage), or with no step the newest verifiable state
        (:meth:`restore_newest_verifiable`, which owns that path's span and
        fault point: one firing a restore)."""
        if step is None:
            return self.restore_newest_verifiable()[1]
        with tracing.span("checkpoint", "restore", step=step):
            faults.inject("checkpoint.restore", step=step)
            return self._verified_load(step)

    def metadata(self, step: int) -> Dict[str, Any]:
        with open(os.path.join(self._step_dir(step), "METADATA.json")) as fh:
            return json.load(fh)

    def _retain(self) -> None:
        for s in self.steps()[: -self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
