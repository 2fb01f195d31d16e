"""Guards on the PyTorch port's boundary: it never imports jax or the JAX
package, its kernel modules import without CUDA, and a CUDA master with no
card raises instead of dropping to the CPU."""

import ast
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cycloneml_tpu_torch"


def _port_modules():
    import cycloneml_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        cycloneml_tpu_torch.__path__, "cycloneml_tpu_torch."))


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _run(code: str, **env):
    full_env = dict(os.environ, PYTHONPATH=str(ROOT), **env)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           env=full_env, capture_output=True, text=True,
                           timeout=120)


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert "cycloneml_tpu_torch.ops.kernels" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'cycloneml_tpu' or "
        "k.startswith('cycloneml_tpu.'))\n"
        "assert not bad, bad\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_name_nothing_of_the_jax_package(path):
    text = path.read_text()
    assert not re.search(r"\bcycloneml_tpu\.", text), \
        f"{path} names the JAX package"
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "cycloneml_tpu"), \
                f"{path}:{node.lineno} imports {name}"


def test_kernels_import_without_cuda():
    r = _run("import torch\n"
             "assert not torch.cuda.is_available()\n"
             "from cycloneml_tpu_torch.ops import build, kernels\n"
             "x = torch.randn(20, 3); y = (x[:, 0] > 0).float()\n"
             "out = kernels.glm_sweep(x, y, torch.ones(20), torch.ones(3), 0.)\n"
             "assert kernels.glm_sweep.launches == 0\n"
             "assert torch.isfinite(out[0])\n",
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr


def test_cuda_master_without_a_card_raises():
    r = _run("from cycloneml_tpu_torch import CycloneConf, CycloneContext\n"
             "try:\n"
             "    CycloneContext(CycloneConf().set('cyclone.master', 'cuda'))\n"
             "except RuntimeError as e:\n"
             "    assert 'no CUDA device' in str(e), e\n"
             "else:\n"
             "    raise SystemExit('no error raised')\n",
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr + r.stdout


def test_default_master_is_the_card():
    from cycloneml_tpu_torch.conf import MASTER, CycloneConf
    assert CycloneConf(load_defaults=False).get(MASTER) == "cuda"
