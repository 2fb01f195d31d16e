"""The port's native host library: built at first use, loaded with ctypes.

``src/cyclone_host.cpp`` (the libsvm and CSV scanners) is compiled by
``g++ -O3 -std=c++17 -shared -fPIC`` into ``cycloneml_tpu_torch/_build/``,
under a name keyed by a hash of the source, the flags, the compiler and the
host's CPU (``-march=native`` code built on one machine must not load on
another). A build that fails with ``-march=native`` is retried without it.

Several processes may build at once (a test session's workers): each takes
an exclusive file lock, builds to a temporary name and ``os.replace``\\ s it
into place, so a reader only ever sees a whole library. When the library
cannot be built, :func:`load` warns once with the compiler's message and
returns None; the callers (``native/host.py``) then serve reads with their
pure-Python twins where the reference has one, and raise where it has none.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "src" / "cyclone_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_handle = None
_failure: Optional[str] = None


def _host_identity() -> str:
    """The compiler's version and the CPU's model and flags: a library
    built for one host is not loaded on another."""
    try:
        cc = subprocess.run(["g++", "--version"], capture_output=True,
                            text=True, timeout=60).stdout
    except OSError as e:
        cc = f"no g++: {e}"
    cpu = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as fh:
            for line in fh:
                if line.startswith(("model name", "flags")):
                    cpu += line
                if line.startswith("flags"):
                    break
    except OSError:
        cpu = platform.processor()
    return cc + platform.machine() + cpu


def library_path(flags=FLAGS) -> Path:
    """Where the library built from the current source with ``flags``
    lives."""
    h = hashlib.sha256()
    h.update(SRC.read_bytes())
    h.update(" ".join(flags + LIBS).encode())
    h.update(_host_identity().encode())
    return BUILD_DIR / f"libcyclone_host-{h.hexdigest()[:16]}.so"


def _compile(flags, out: Path) -> None:
    """Build to a temporary name beside ``out`` and move it into place;
    raises CalledProcessError (with g++'s output) on failure."""
    tmp = out.with_name(f".{out.name}.{os.getpid()}.{threading.get_ident()}")
    try:
        subprocess.run(["g++", *flags, str(SRC), "-o", str(tmp), *LIBS],
                       check=True, capture_output=True, text=True,
                       timeout=600)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def build() -> Path:
    """The path of a built library for this source and host, building it
    if needed (with ``-march=native``, else without); raises if neither
    build succeeds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    plain = [f for f in FLAGS if f != "-march=native"]
    candidates = [(FLAGS, library_path(FLAGS)), (plain, library_path(plain))]
    for _, path in candidates:
        if path.exists():
            return path
    with open(BUILD_DIR / "libcyclone_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            errors = []
            for flags, path in candidates:
                if path.exists():  # another process built it meanwhile
                    return path
                try:
                    _compile(flags, path)
                    return path
                except (subprocess.SubprocessError, OSError) as e:
                    errors.append(f"g++ {' '.join(flags)}: "
                                  f"{getattr(e, 'stderr', None) or e}")
            raise RuntimeError("cannot build the native host library: "
                               + " | ".join(errors))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load():
    """The ctypes handle of the library, or None when it cannot be built
    (warned once, with the reason)."""
    global _handle, _failure
    with _lock:
        if _handle is not None or _failure is not None:
            return _handle
        try:
            _handle = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _failure = str(e)
            warnings.warn(f"cycloneml_tpu_torch.native: {_failure}; the "
                          "libsvm and CSV readers fall back to their "
                          "pure-Python twins, and byte ranges and several "
                          "readers are unavailable", RuntimeWarning,
                          stacklevel=2)
        return _handle


def failure() -> Optional[str]:
    """Why the library could not be built, or None."""
    return _failure
