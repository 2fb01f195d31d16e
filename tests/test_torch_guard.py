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
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "k1s_phases.py",
                                        ROOT / "glm_phases.py",
                                        ROOT / "ell_phases.py",
                                        ROOT / "center_phases.py",
                                        ROOT / "als_phases.py"]


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
    """Every kernel wrapper imports and runs its plain version on CPU
    tensors with no card and no nvcc, launching nothing."""
    r = _run("import torch\n"
             "assert not torch.cuda.is_available()\n"
             "from cycloneml_tpu_torch.ops import build, kernels\n"
             "x = torch.randn(20, 3); y = (x[:, 0] > 0).float()\n"
             "out = kernels.glm_sweep(x, y, torch.ones(20), torch.ones(3), 0.)\n"
             "sq = kernels.glm_sweep(x, y, torch.ones(20), torch.ones(3), 0.,\n"
             "                       link='squared', ys=1.0)\n"
             "best, dist = kernels.kmeans_assign(x, x[:4])\n"
             "g = kernels.gramian(x, torch.ones(20))\n"
             "assert kernels.glm_sweep.launches == 0\n"
             "assert kernels.kmeans_assign.launches == 0\n"
             "assert kernels.gramian.launches == 0\n"
             "assert torch.isfinite(out[0]) and torch.isfinite(sq[0])\n"
             "assert best.tolist()[:4] == [0, 1, 2, 3]\n"
             "assert torch.equal(g, g.T)\n",
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("name", ["glm_sweep", "kmeans_assign", "gramian",
                                  "glm_stacked", "center_sums", "ell_sweep",
                                  "als_normal", "serving_margins",
                                  "tree_hist"])
def test_every_kernel_source_has_a_binding(name):
    """Each CUDA source the wrappers load exists, declares its C entry
    points with ``extern "C"``, and has its argument types declared."""
    from cycloneml_tpu_torch.ops import build, kernels
    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    assert 'extern "C"' in src
    for fn in kernels._SIGNATURES[name]:
        assert re.search(rf"\bint {fn}\(", src), f"{name}.cu lacks {fn}"


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


def test_port_never_imports_ml_dtypes():
    """The card's machine has no ml_dtypes: e4m3 is torch.float8_e4m3fn
    throughout, and importing every module of the port loads no
    ml_dtypes."""
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] != "ml_dtypes" for n in names), \
                f"{path}:{node.lineno} imports ml_dtypes"
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
        "assert 'ml_dtypes' not in sys.modules\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_fp8_wrappers_import_and_run_without_cuda():
    """The fp8 rung's pieces (quantize_fp8, the x_scale operand of every
    wrapper) run their plain versions on CPU tensors with no card and no
    nvcc, launching nothing."""
    r = _run("import torch\n"
             "assert not torch.cuda.is_available()\n"
             "from cycloneml_tpu_torch.dataset.instance import quantize_fp8\n"
             "from cycloneml_tpu_torch.ops import kernels\n"
             "x8, s, _ = quantize_fp8(torch.randn(20, 3))\n"
             "assert x8.dtype == torch.float8_e4m3fn\n"
             "y = torch.ones(20)\n"
             "out = kernels.glm_sweep(x8, y, y, torch.ones(3), 0., x_scale=s)\n"
             "best, _ = kernels.kmeans_assign(x8, torch.zeros(2, 3),\n"
             "                                x_scale=s)\n"
             "g = kernels.gramian(x8, y, x_scale=s)\n"
             "assert kernels.glm_sweep.launches == 0\n"
             "assert sum(kernels.glm_sweep.launches_by_dtype.values()) == 0\n"
             "assert kernels.kmeans_assign.launches == 0\n"
             "assert kernels.gramian.launches == 0\n"
             "assert torch.isfinite(out[0]) and torch.equal(g, g.T)\n",
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr


def test_stacked_slice_modules_are_guarded():
    """The stacked slice's modules (OneVsRest, tuning, the evaluators) are
    among the modules whose imports are checked above."""
    mods = _port_modules()
    for name in ("cycloneml_tpu_torch.ml.classification.one_vs_rest",
                 "cycloneml_tpu_torch.ml.tuning.tuning",
                 "cycloneml_tpu_torch.ml.evaluation.evaluators"):
        assert name in mods
        assert PKG.joinpath(*name.split(".")[1:]).with_suffix(".py") in \
            _port_sources()


def test_stacked_wrappers_import_and_run_without_cuda():
    """K1s and the center sums run their plain versions on CPU tensors
    with no card and no nvcc, launching nothing."""
    r = _run("import torch\n"
             "assert not torch.cuda.is_available()\n"
             "from cycloneml_tpu_torch.ops import kernels\n"
             "x = torch.randn(20, 3); y = (torch.rand(20, 4) > 0.5).float()\n"
             "out = kernels.glm_sweep_stacked(x, y, torch.ones(20),\n"
             "                                torch.ones(4, 3), torch.zeros(4))\n"
             "s, c = kernels.center_sums(x, torch.ones(20),\n"
             "                           torch.arange(20) % 3, 3)\n"
             "assert kernels.glm_sweep_stacked.launches == 0\n"
             "assert kernels.center_sums.launches == 0\n"
             "assert out[1].shape == (4, 3) and c.tolist() == [7., 7., 6.]\n",
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr


def test_sparse_tier_modules_are_guarded():
    """The sparse tier's modules are among the modules whose imports are
    checked above."""
    mods = _port_modules()
    for name in ("cycloneml_tpu_torch.dataset.sparse",
                 "cycloneml_tpu_torch.ml.optim.sparse_aggregators",
                 "cycloneml_tpu_torch.linalg.distributed",
                 "cycloneml_tpu_torch.linalg.matrices",
                 "cycloneml_tpu_torch.interop"):
        assert name in mods
        assert PKG.joinpath(*name.split(".")[1:]).with_suffix(".py") in \
            _port_sources()


def test_sparse_wrappers_import_and_run_without_cuda():
    """S1 and S2 run their plain versions on CPU tensors with no card and
    no nvcc, launching nothing; the column copy builds on the CPU."""
    r = _run("import torch\n"
             "assert not torch.cuda.is_available()\n"
             "from cycloneml_tpu_torch.ops import kernels\n"
             "idx = torch.randint(0, 6, (20, 3), dtype=torch.int32)\n"
             "val = torch.rand(20, 3)\n"
             "y = (torch.rand(20) > 0.5).float(); w = torch.ones(20)\n"
             "for link in ('logistic', 'squared', 'hinge', 'gram'):\n"
             "    mult, loss, _, ws = kernels.ell_rows(idx, val, y, w,\n"
             "                                         torch.ones(6), 0.1,\n"
             "                                         link)\n"
             "    g = kernels.ell_cols(idx, val, mult, 6)\n"
             "    assert g.shape == (6,) and float(ws) == 20.0\n"
             "cols = kernels.ell_columns(idx, val, 6)\n"
             "assert int(cols.block_ptr[-1]) == int((val != 0).sum())\n"
             "hot = kernels.ell_hot_columns(idx, val, 6, slots=32)\n"
             "assert hot.shape == (32,)\n"
             "assert kernels.ell_rows.launches == 0\n"
             "assert kernels.ell_cols.launches == 0\n",
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr


def test_recommendation_modules_are_guarded():
    """ALS's modules are among the modules whose imports are checked
    above."""
    mods = _port_modules()
    for name in ("cycloneml_tpu_torch.ml.recommendation",
                 "cycloneml_tpu_torch.ml.recommendation.als"):
        assert name in mods
    assert PKG / "ml" / "recommendation" / "als.py" in _port_sources()


def test_als_wrapper_imports_and_runs_without_cuda():
    """The ALS normal equations run their plain twin on CPU tensors with
    no card and no nvcc, launching nothing."""
    r = _run("import torch\n"
             "assert not torch.cuda.is_available()\n"
             "from cycloneml_tpu_torch.ops import kernels\n"
             "dst = torch.tensor([0, 1, 0, 2]); src = torch.tensor([1, 0, 2, 1])\n"
             "o = kernels.als_order(dst, src, torch.ones(4), 3, 3)\n"
             "a, b, n = kernels.als_normal(torch.ones(3, 2), o, reg=0.5)\n"
             "assert kernels.als_normal.launches == 0\n"
             "assert n.tolist() == [2., 1., 1.] and torch.equal(a, a.transpose(1, 2))\n"
             "assert a[0].tolist() == [[3., 2.], [2., 3.]]\n",
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode == 0, r.stderr


def _code_strings(tree):
    """The string constants of a module that are not docstrings (f-string
    parts included)."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant):
                docs.add(id(first.value))
    return [n for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


_REF_PATH = re.compile(r"(?<![\w])cycloneml_tpu/([\w./:\-]*)")
_CITATION = re.compile(r"[\w/]+\.py(:[\d\-]*)?")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_load_nothing_from_the_jax_package_by_path(path):
    """A ctypes load or a build by path would escape the import guard: no
    string in the port's code names a file under ``cycloneml_tpu/`` other
    than a citation of a Python source (``kernels.py:270``), nor the
    package directory as a path component, nor the reference's native
    library (``_lib/libcyclone_host.so``)."""
    text = path.read_text()
    assert "libcyclone_host.so" not in text and "/_lib" not in text, \
        f"{path} names the reference's native library"
    for node in _code_strings(ast.parse(text)):
        s = node.value
        assert s.strip("/") != "cycloneml_tpu", \
            f"{path}:{node.lineno} joins the JAX package's directory"
        for m in _REF_PATH.finditer(s):
            assert _CITATION.fullmatch(m.group(1)), \
                f"{path}:{node.lineno} names {m.group(0)!r}"


def test_native_sources_include_nothing_of_the_jax_package():
    srcs = sorted((PKG / "native" / "src").glob("*")) + \
        sorted((PKG / "csrc").glob("*"))
    assert PKG / "native" / "src" / "cyclone_host.cpp" in srcs
    for src in srcs:
        for line in src.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert "cycloneml_tpu/" not in line, f"{src}: {line}"


def test_the_native_library_is_the_ports_own():
    """Reading a libsvm file maps the port's library, built from its own
    source into its own build directory, and nothing under the JAX
    package."""
    r = _run("import os, tempfile\n"
             "from cycloneml_tpu_torch import native\n"
             "from cycloneml_tpu_torch.native import host\n"
             "p = os.path.join(tempfile.mkdtemp(), 'a.svm')\n"
             "open(p, 'w').write('1 1:2\\n0 2:3\\n')\n"
             "assert len(list(host.stream_libsvm_chunks(p))) == 1\n"
             "maps = open('/proc/self/maps').read()\n"
             "assert 'cycloneml_tpu/' not in maps, 'the JAX package mapped'\n"
             "lib = str(native.build())\n"
             "assert lib in maps and '/cycloneml_tpu_torch/_build/' in lib\n"
             "assert native.SRC.parent.parent.name == 'native'\n"
             "assert native.SRC.parent.parent.parent.name == "
             "'cycloneml_tpu_torch'\n")
    assert r.returncode == 0, r.stderr
