"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, at first use, into
``cycloneml_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. A library is keyed by a hash of its source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header
rebuilds and a stale library is never loaded. Independent sources compile
in parallel (:func:`build_all`).

Nothing here runs at import: the CPU test tier imports every module and has
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under ``$CUDA_HOME`` or the
    toolkit's default prefix. Raises when none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # the shared headers
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def ptxas_report(name: str) -> Path:
    """Where the ``-Xptxas -v`` output of the last build of ``name`` is
    kept (registers, shared memory and spills of every kernel)."""
    return BUILD_DIR / f"{name}.ptxas.txt"


def _start(name: str):
    """Start compiling ``name`` unless its library is built; returns the
    running process (or None) and the target path."""
    target = _target(name)
    if target.exists():
        return None, target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), target


def _finish(name: str, started, target: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    out, _ = proc.communicate()
    ptxas_report(name).write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or none


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all nvcc
    processes at once, and return the library paths."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        for n, (proc, target) in started.items():
            _finish(n, proc, target)
    return {n: target for n, (_, target) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def edited_sources(src: str, variants: Dict[str, List[Tuple[str, str]]]
                   ) -> Dict[str, str]:
    """``{"full": src}`` and, for each variant, ``src`` with its (old,
    new) text replacements made; every old text must occur exactly once,
    so a variant fails loudly when the kernel's text changes."""
    out = {"full": src}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel text {old!r} is not "
                                   "found exactly once; update the variants")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants(name: str, sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Versions of ``csrc/<name>.cu`` (variant name -> source text), all
    nvcc processes started together, into ``_build/<name>_variants/``
    (the shared headers come from ``csrc/``); returns the loaded
    libraries. For measuring what a phase of a kernel costs."""
    out_dir = BUILD_DIR / f"{name}_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, text in sources.items():
        cu = out_dir / f"{name}_{variant}.cu"
        cu.write_text(text)
        so = out_dir / f"lib{name}_{variant}.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(so),
               str(cu)]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), so)
    libs = {}
    for variant, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {variant} build of "
                               f"csrc/{name}.cu:\n{log}")
        libs[variant] = ctypes.CDLL(str(so))
    return libs
