"""The port's fp8 (e4m3) data tier against the JAX package's, on the same
numpy data.

- Tier resolution, ``quantize_fp8`` (codes and scales bit for bit; the
  probe ratio, a float64 std taken in another summation order, to rtol
  1e-12), the envelope probe's reasons and the Summarizer's moments on the
  same codes (rtol 1e-12, float64) mirror tests/test_mixed_precision.py.
- The plain K1-K4 on e4m3 codes with ``x_scale`` against the reference's
  Pallas kernels in interpret mode, with tests/test_pallas_ops.py's fp8
  tolerances (K1/K2: loss rtol 1e-3, grad rtol and atol 5e-3; K3: equal
  argmin, distances rtol and atol 1e-4; K4: rtol 1e-4, atol 1e-3).
- fp8 fits with ``usePallasKernels=true`` in both packages (the port's
  plain K1/K2, the reference's interpreted kernels) agree within the
  kernel-vs-plain bound (rtol 5e-3, atol 5e-4).
- The decided divergence (ROADMAP Queue 3): the reference's jnp route
  rounds the vector operand to e4m3 and lands outside that bound; the port
  follows the reference's kernel route, and both stay inside the
  reference's 20% fp8 envelope (``FP8_COEF_NORMREL``) of the jnp fit.
"""

import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cycloneml_tpu.conf import USE_PALLAS_KERNELS as JAX_USE_KERNELS
from cycloneml_tpu.dataset import instance as jinst
from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
from cycloneml_tpu.ml.regression import LinearRegression as JaxLinReg
from cycloneml_tpu.ml.stat import Summarizer as JaxSummarizer
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset import instance as tinst
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import LogisticRegression
from cycloneml_tpu_torch.ml.regression import LinearRegression
from cycloneml_tpu_torch.ml.stat import Summarizer
from cycloneml_tpu_torch.ops import kernels as tk

F8 = torch.float8_e4m3fn
FP8_COEF_NORMREL = 0.20  # tests/test_mixed_precision.py:318
KERNEL_BOUND = dict(rtol=5e-3, atol=5e-4)  # tests/test_pallas_ops.py


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64")
                       .set("cyclone.data.dtype", "float8"))
    yield c
    c.stop()


@pytest.fixture
def ref_tier(ctx):
    """Set the reference context's cyclone.data.dtype (and kernel route)
    for one test, always restoring 'auto' and 'false'."""
    def set_tier(name, kernels="false"):
        ctx.conf.set("cyclone.data.dtype", name)
        ctx.conf.set(JAX_USE_KERNELS, kernels)
    yield set_tier
    ctx.conf.set("cyclone.data.dtype", "auto")
    ctx.conf.set(JAX_USE_KERNELS, "false")


def _norm_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))


def _codes(a):
    """1-byte codes of a reference (ml_dtypes) or port (torch) array."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _ref_fp8(ctx, x, y=None, w=None):
    return JaxDataset.from_numpy(
        ctx, x, y, w, dtype=jinst.data_dtype(ctx.conf, fp8_capable=True))


def _lr_data(n, d, seed):
    """tests/test_mixed_precision.py:431's recipe."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * (1.0 + np.arange(d) / 4.0) + 0.3
    beta = rng.randn(d)
    y = (x @ beta + rng.randn(n) > 0).astype(np.float64)
    return x, y


# -- tier resolution -----------------------------------------------------------

@pytest.mark.parametrize("compute", ["float64", "float32"])
def test_tier_resolution_mirrors_reference(compute):
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", compute))
    try:
        c.conf.set("cyclone.data.dtype", "float8")
        # forced: e4m3 for capable callers even under float64 parity;
        # every other caller lands on the bf16 rung
        assert tinst.data_dtype(c.conf, fp8_capable=True) == F8
        assert tinst.data_dtype(c.conf) == torch.bfloat16
        assert tinst.is_fp8_dtype(F8)
        assert not tinst.is_fp8_dtype(torch.bfloat16)
        assert tinst.is_narrow_dtype(F8)
        c.conf.set("cyclone.data.dtype", "auto8")
        if compute == "float64":
            # auto8 keeps the parity tier full width, like auto
            assert tinst.data_dtype(c.conf, fp8_capable=True) == torch.float64
            assert tinst.data_dtype(c.conf) == torch.float64
        else:
            assert tinst.data_dtype(c.conf, fp8_capable=True) == F8
            assert tinst.data_dtype(c.conf) == torch.bfloat16
        assert tinst.FP8_MAX == jinst.FP8_MAX
        assert tinst.FP8_PROBE_RATIO == jinst.FP8_PROBE_RATIO
    finally:
        c.stop()


def test_tier_resolution_matches_reference_under_parity(ctx, ref_tier):
    for name in ("float8", "auto8"):
        ref_tier(name)
        c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                           .set("cyclone.compute.dtype", "float64")
                           .set("cyclone.data.dtype", name))
        try:
            for capable in (True, False):
                ref = str(np.dtype(jinst.data_dtype(ctx.conf,
                                                    fp8_capable=capable)))
                got = str(tinst.data_dtype(c.conf, fp8_capable=capable))
                assert got == f"torch.{ref}", (name, capable)
        finally:
            c.stop()


def test_unknown_tier_is_refused():
    from cycloneml_tpu_torch.conf import DATA_DTYPE
    for name in ("auto8", "float8"):
        assert CycloneConf().set(DATA_DTYPE, name).get(DATA_DTYPE) == name
    with pytest.raises(ValueError, match="auto8"):
        CycloneConf().set(DATA_DTYPE, "float16").get(DATA_DTYPE)


# -- quantize_fp8 --------------------------------------------------------------

def _quant_inputs():
    rng = np.random.RandomState(40)
    x = rng.randn(300, 7) * np.array([1.0, 1e3, 1e-3, 5.0, 0.0, 1.0, 2.0])
    x[:, 5] = 0.0
    x[0, 5] = 0.0            # an all-zero column: scale 1.0, codes 0
    x[:, 6] = np.linspace(-448.0, 448.0, 300)  # codes at the edge of e4m3
    x[3, 0] = 1e6            # one wild value: a 1e6 dynamic range
    return x


def test_quantize_fp8_codes_bitwise_equal_reference():
    x = _quant_inputs()
    r8, rscale, rratio = jinst.quantize_fp8(x)
    g8, gscale, gratio = tinst.quantize_fp8(x)
    assert g8.dtype == F8 and g8.shape == x.shape
    np.testing.assert_array_equal(_codes(g8), _codes(r8))
    np.testing.assert_array_equal(gscale, rscale)  # bit for bit
    assert gscale[5] == 1.0 and not _codes(g8)[:, 5].any()
    assert np.isfinite(g8.float().numpy()).all()
    np.testing.assert_allclose(gratio, rratio, rtol=1e-12)
    assert gratio[5] == 0.0


def test_quantize_fp8_of_a_tensor_in_chunks_into_out():
    """A tensor input, quantized a few rows at a time into a larger
    ``out``: the same codes, scale and ratio as the whole numpy array."""
    x = _quant_inputs()
    r8, rscale, rratio = jinst.quantize_fp8(x)
    out = torch.zeros((x.shape[0] + 5, x.shape[1]),
                      dtype=torch.uint8).view(F8)
    g8, gscale, gratio = tinst.quantize_fp8(torch.from_numpy(x), out=out,
                                            chunk_rows=7)
    np.testing.assert_array_equal(_codes(out[:300]), _codes(r8))
    assert not _codes(out[300:]).any()
    assert g8.data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(gscale, rscale)
    np.testing.assert_allclose(gratio, rratio, rtol=1e-12)
    # a fixed, external scale
    fixed = rscale * 2.0
    r8f = jinst.quantize_fp8(x, scale=fixed)[0]
    g8f = tinst.quantize_fp8(x, scale=fixed)[0]
    np.testing.assert_array_equal(_codes(g8f), _codes(r8f))


# -- the envelope probe --------------------------------------------------------

_PROBE_CASES = {
    "good": (SimpleNamespace(std=np.ones(3), max=np.full(3, 3.0),
                             min=np.full(3, -3.0)), None),
    "constant column exempt": (SimpleNamespace(
        std=np.array([1.0, 0.0]), max=np.array([3.0, 500.0]),
        min=np.array([-3.0, 500.0])), None),
    "scale spread": (SimpleNamespace(
        std=np.array([1.0, 0.01]), max=np.array([3.0, 100.0]),
        min=np.array([-3.0, 99.0])), None),
    "weight overflow": (SimpleNamespace(std=np.ones(3), max=np.full(3, 3.0),
                                        min=np.full(3, -3.0)), 1000.0),
}


@pytest.mark.parametrize("case", sorted(_PROBE_CASES))
def test_probe_reasons_match_reference(case):
    """tests/test_mixed_precision.py:555's cases: the same verdict, word
    for word."""
    stats, w_max = _PROBE_CASES[case]
    ref = jinst.fp8_probe_ok(stats, w_max)
    assert tinst.fp8_probe_ok(stats, w_max) == ref
    if case == "scale spread":
        assert "absmax/std" in ref
    if case == "weight overflow":
        assert "max instance weight" in ref


def test_probe_prefers_the_raw_ratio():
    ratio = np.array([2.0, 0.0, 40.0])
    assert tinst.fp8_probe_ok(None, None, probe_ratio=ratio) == \
        jinst.fp8_probe_ok(None, None, probe_ratio=ratio)
    assert "column 2" in tinst.fp8_probe_ok(None, None, probe_ratio=ratio)


# -- the fp8 dataset -----------------------------------------------------------

def test_fp8_dataset_quantizes_with_scales(ctx, ref_tier, pctx):
    """from_numpy under the fp8 tier: the reference's codes and scales,
    1-byte storage, y/w at accumulator width, values at the host
    boundary."""
    ref_tier("float8")
    rng = np.random.RandomState(21)
    x = rng.randn(203, 6) * np.array([1.0, 10.0, 0.1, 5.0, 2.0, 1.0])
    y = (rng.rand(203) > 0.5).astype(np.float64)
    ref = _ref_fp8(ctx, x, y)
    ds = InstanceDataset.from_numpy(
        pctx, x, y, dtype=tinst.data_dtype(pctx.conf, fp8_capable=True))
    assert ds.x.dtype == F8 and ds.y.dtype == torch.float64
    np.testing.assert_array_equal(_codes(ds.x[:203]),
                                  _codes(np.asarray(ref.x)[:203]))
    assert not _codes(ds.x[203:]).any()  # padding rows are zero codes
    np.testing.assert_array_equal(ds.x_scale, ref.x_scale)
    np.testing.assert_allclose(ds._fp8_probe_ratio, ref._fp8_probe_ratio,
                               rtol=1e-12)
    n_pad = ds.x.shape[0]
    assert ds.padded_bytes() == n_pad * (6 * 1 + 2 * 8)
    xv, yv, _ = ds.to_numpy()
    np.testing.assert_array_equal(xv, ref.to_numpy()[0])
    np.testing.assert_allclose(xv, x, rtol=2 ** -4, atol=1e-12)
    np.testing.assert_array_equal(ds.gather_rows([0, 5]), xv[[0, 5]])
    # derive keeps the scales with an unchanged X, drops them with a new one
    assert ds.derive(w=ds.w).x_scale is ds.x_scale
    deq = ds.dequantized()
    assert deq.x.dtype == torch.bfloat16 and deq.x_scale is None
    np.testing.assert_allclose(deq.x[:203].double().numpy(), xv,
                               rtol=2 ** -8)


def test_quantized_dataset_on_its_device_matches_from_numpy(pctx):
    """InstanceDataset.quantized(): statistics over the real rows only,
    padding rows zero codes, the same codes as quantizing the numpy rows
    (from a float64 X: no rounding before the quantization)."""
    rng = np.random.RandomState(22)
    x = rng.randn(101, 5) * 3.0 + 1.0
    y = rng.randn(101)
    wide = InstanceDataset.from_numpy(pctx, x, y, dtype=torch.float64)
    wide.x[101:] = 1e9  # padding rows hold anything; w = 0 there
    q = wide.quantized()
    ref = InstanceDataset.from_numpy(pctx, x, y, dtype=F8)
    assert q.x.shape == wide.x.shape
    np.testing.assert_array_equal(_codes(q.x), _codes(ref.x))
    np.testing.assert_array_equal(q.x_scale, ref.x_scale)
    np.testing.assert_array_equal(q._fp8_probe_ratio, ref._fp8_probe_ratio)
    assert q.y is wide.y and q.quantized() is q


def test_an_fp8_x_needs_its_scale(pctx):
    x8 = torch.zeros((8, 2), dtype=torch.uint8).view(F8)
    w = torch.ones(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="x_scale"):
        InstanceDataset(pctx, x8, w, w, 8, 2)
    with pytest.raises(ValueError, match="x_scale"):
        InstanceDataset(pctx, x8.float(), w, w, 8, 2, x_scale=np.ones(2))


def test_summarizer_on_codes_matches_reference(ctx, ref_tier, pctx):
    """Moments of the quantized values: the codes summed in float64 and
    rescaled on the host, as the reference does; rtol 1e-12."""
    ref_tier("float8")
    rng = np.random.RandomState(23)
    x = rng.randn(1500, 5) * np.array([1.0, 20.0, 0.05, 3.0, 1.0]) + 2.0
    x[rng.rand(1500, 5) < 0.1] = 0.0
    w = rng.rand(1500) + 0.2
    ref = JaxSummarizer.summarize(_ref_fp8(ctx, x, None, w))
    got = Summarizer.summarize(InstanceDataset.from_numpy(pctx, x, None, w,
                                                          dtype=F8))
    for name in ("mean", "variance", "num_nonzeros", "max", "min", "norm_l1",
                 "norm_l2", "sum"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-12, atol=1e-13, err_msg=name)
    assert got.count == ref.count == 1500


# -- K1-K4's plain versions on codes against the interpreted kernels --------

@pytest.fixture(scope="module")
def kdata():
    rng = np.random.RandomState(42)
    n, d = 300, 37
    x = rng.randn(n, d) * (rng.rand(d) * 4 + 0.1)
    y = (rng.rand(n) > 0.4).astype(np.float64)
    w = rng.rand(n) + 0.5
    x8, scale, _ = jinst.quantize_fp8(x)
    x8t = torch.from_numpy(np.asarray(x8).view(np.uint8)).view(F8)
    return x8, x8t, scale, y, w


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float64))


@pytest.mark.parametrize("scaled", [True, False])
def test_plain_k1_on_codes_matches_pallas(kdata, scaled, ctx):
    from cycloneml_tpu.ops import fused_binary_logistic_scaled
    x8, x8t, scale, y, w = kdata
    d = x8.shape[1]
    rng = np.random.RandomState(8)
    coef = rng.randn(d + 1) * 0.05
    inv_std, mu = rng.rand(d) + 0.5, rng.randn(d) * 0.1
    s = scale if scaled else None
    ref = fused_binary_logistic_scaled(x8, y, w, inv_std, mu, coef, d, True,
                                       interpret=True, row_tile=128,
                                       x_scale=s)
    got = tk.fused_binary_logistic_scaled(x8t, _t(y), _t(w), _t(inv_std),
                                          _t(mu), _t(coef), d, True,
                                          x_scale=s)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(got["grad"].numpy(), np.asarray(ref["grad"]),
                               rtol=5e-3, atol=5e-3)
    # the unscaled twin takes the scale the same way
    ref1 = tk.fused_binary_logistic(x8t, _t(y), _t(w), _t(coef), d, True,
                                    x_scale=s)
    deq = x8t.double() * (_t(scale) if scaled else 1.0)
    got1 = tk.fused_binary_logistic(deq, _t(y), _t(w), _t(coef), d, True)
    np.testing.assert_allclose(ref1["grad"].numpy(), got1["grad"].numpy(),
                               rtol=1e-5, atol=1e-5)


def test_plain_k2_on_codes_matches_pallas(kdata, ctx):
    from cycloneml_tpu.ops import fused_least_squares_scaled
    x8, x8t, scale, y, w = kdata
    d = x8.shape[1]
    rng = np.random.RandomState(9)
    coef, inv_std, mu = rng.randn(d) * 0.1, rng.rand(d) + 0.5, rng.randn(d)
    y_pars = np.array([1.7, 0.3])
    ref = fused_least_squares_scaled(x8, y, w, inv_std, mu, y_pars, coef, d,
                                     interpret=True, row_tile=128,
                                     x_scale=scale)
    got = tk.fused_least_squares_scaled(x8t, _t(y), _t(w), _t(inv_std),
                                        _t(mu), _t(y_pars), _t(coef), d,
                                        x_scale=scale)
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(got["grad"].numpy(), np.asarray(ref["grad"]),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("scaled", [True, False])
def test_plain_k3_on_codes_matches_pallas(scaled, ctx):
    """tests/test_pallas_ops.py:307's data: the same argmin as the
    interpreted kernel and as float64 on the dequantized points."""
    from cycloneml_tpu.ops import fused_kmeans_assign
    rng = np.random.RandomState(11)
    centers = rng.randn(5, 8) * 2.0
    x = centers[rng.randint(0, 5, 200)] + 0.05 * rng.randn(200, 8)
    x8, scale, _ = jinst.quantize_fp8(x)
    x8t = torch.from_numpy(np.asarray(x8).view(np.uint8)).view(F8)
    s = scale if scaled else None
    c = centers if scaled else centers / scale  # centers in value space
    rb, rd = fused_kmeans_assign(x8, c, interpret=True, row_tile=64,
                                 x_scale=s)
    best, dist = tk.kmeans_assign(x8t, _t(c), x_scale=s)
    np.testing.assert_array_equal(best.numpy(), np.asarray(rb))
    deq = x8t.double().numpy() * (scale if scaled else 1.0)
    d2 = ((deq[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(best.numpy(), d2.argmin(1))
    if scaled:
        np.testing.assert_allclose(dist.numpy(), np.asarray(rd), rtol=1e-4,
                                   atol=1e-4)
    else:
        # raw codes reach |x|^2 ~ 1e6: both sum the expansion |x|^2 - 2 x.c
        # + |c|^2 in float32, in different orders, so they agree to 1e-4
        # of max(d2, |x|^2), the rule the kernel is held to on the card
        bound = 1e-4 * np.maximum(d2.min(1), (deq * deq).sum(1))
        assert np.all(np.abs(dist.numpy() - np.asarray(rd)) <= bound)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_k4_on_codes_matches_pallas(masked, ctx):
    """tests/test_pallas_ops.py:296's data: rtol 1e-4, atol 1e-3, exactly
    symmetric; with the w > 0 mask as well."""
    from cycloneml_tpu.ops import fused_gramian
    rng = np.random.RandomState(10)
    x = rng.randn(96, 9) * np.array([1.0, 4.0, 0.5, 2.0, 1.0, 3.0, 1.0,
                                     0.25, 1.0])
    x8, scale, _ = jinst.quantize_fp8(x)
    x8t = torch.from_numpy(np.asarray(x8).view(np.uint8)).view(F8)
    w = np.ones(96)
    if masked:
        w[60:] = 0.0
    ref = fused_gramian(x8, w=w, interpret=True, row_tile=32, x_scale=scale)
    got = tk.gramian(x8t, _t(w), x_scale=scale).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got, got.T)
    deq = (x8t.double().numpy() * scale)[:60 if masked else 96]
    np.testing.assert_allclose(got, deq.T @ deq, rtol=1e-4, atol=1e-3)


def test_x_scale_must_have_d_entries(kdata):
    _, x8t, scale, y, w = kdata
    with pytest.raises(ValueError, match="x_scale has 3 entries"):
        tk.gramian(x8t, None, x_scale=scale[:3])


# -- fits --------------------------------------------------------------------

def _port_fit(pctx, est, ds):
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    before = tk.glm_sweep.launches
    model = est.fit(ds)
    # on the CPU the kernel route is the plain version: nothing launched
    assert tk.glm_sweep.launches == before
    return model


def _assert_kernel_bound(got, ref):
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients), **KERNEL_BOUND)
    np.testing.assert_allclose(got.intercept, ref.intercept, **KERNEL_BOUND)


def test_lr_fp8_kernel_route_matches_reference(ctx, ref_tier, pctx):
    """LogisticRegression on the same e4m3 codes, usePallasKernels=true in
    both packages: within the kernel-vs-plain bound."""
    ref_tier("float8", kernels="true")
    x, y = _lr_data(600, 12, 25)
    kw = dict(maxIter=50, regParam=0.01, tol=1e-10)
    ref = JaxLR(**kw).fit(_ref_fp8(ctx, x, y))
    ds = InstanceDataset.from_numpy(pctx, x, y, dtype=F8)
    got = _port_fit(pctx, LogisticRegression(**kw), ds)
    _assert_kernel_bound(got, ref)
    assert not pctx.precision_fallbacks


def test_linreg_fp8_kernel_route_matches_reference(ctx, ref_tier, pctx):
    """LinearRegression (l-bfgs) on the same e4m3 codes,
    usePallasKernels=true in both packages: within the kernel-vs-plain
    bound (tests/test_mixed_precision.py:454's recipe at 800 x 12)."""
    ref_tier("float8", kernels="true")
    rng = np.random.RandomState(26)
    x = rng.randn(800, 12) * 2.0 + 1.0
    y = x @ rng.randn(12) + 0.05 * rng.randn(800)
    kw = dict(maxIter=80, solver="l-bfgs", regParam=0.001, tol=1e-10)
    ref = JaxLinReg(**kw).fit(_ref_fp8(ctx, x, y))
    got = _port_fit(pctx, LinearRegression(**kw),
                    InstanceDataset.from_numpy(pctx, x, y, dtype=F8))
    _assert_kernel_bound(got, ref)


def test_queue3_port_follows_the_kernel_route(ctx, ref_tier, pctx):
    """ROADMAP Queue 3, decided: on one fp8 dataset the port's PLAIN fit
    (full-width vectors over upcast codes) agrees with the reference's
    kernel route within the kernel-vs-plain bound, while the reference's
    jnp route (vectors rounded to e4m3) does not; both routes stay inside
    the reference's 20% envelope of each other."""
    x, y = _lr_data(600, 12, 25)
    kw = dict(maxIter=50, regParam=0.01, tol=1e-10)
    ref_tier("float8", kernels="true")
    ref_kernel = JaxLR(**kw).fit(_ref_fp8(ctx, x, y))
    ref_tier("float8", kernels="false")
    ref_jnp = JaxLR(**kw).fit(_ref_fp8(ctx, x, y))
    ref_tier("float32")
    ref_f32 = JaxLR(**kw).fit(JaxDataset.from_numpy(
        ctx, x, y, dtype=np.float32))
    pctx.conf.set("cyclone.ml.usePallasKernels", "false")
    got = LogisticRegression(**kw).fit(
        InstanceDataset.from_numpy(pctx, x, y, dtype=F8))
    _assert_kernel_bound(got, ref_kernel)
    gc = got.coefficients.values
    kc, jc = np.asarray(ref_kernel.coefficients), np.asarray(
        ref_jnp.coefficients)
    fc = np.asarray(ref_f32.coefficients)
    # the jnp route's gap: outside the kernel-vs-plain bound ...
    assert not np.allclose(gc, jc, **KERNEL_BOUND)
    assert _norm_rel(jc, kc) > 10 * _norm_rel(gc, kc)
    # ... and inside the reference's fp8 envelope, as is the port
    assert _norm_rel(gc, jc) < FP8_COEF_NORMREL
    assert _norm_rel(gc, fc) < FP8_COEF_NORMREL
    assert _norm_rel(jc, fc) < FP8_COEF_NORMREL


def test_frame_fit_under_float8_reads_codes(pctx):
    """fit(frame) under cyclone.data.dtype=float8: LogisticRegression and
    LinearRegression ask for the e4m3 rung and land within the reference's
    envelope of the float32 tier (tests/test_mixed_precision.py:431)."""
    x, y = _lr_data(2000, 16, 25)
    frame = MLFrame(pctx, {"features": x, "label": y})
    m8 = LogisticRegression(maxIter=80, regParam=0.01, tol=1e-10).fit(frame)
    assert frame.to_instance_dataset(fp8_capable=True).x.dtype == F8
    pctx.conf.set("cyclone.data.dtype", "float32")
    m32 = LogisticRegression(maxIter=80, regParam=0.01, tol=1e-10).fit(
        MLFrame(pctx, {"features": x, "label": y}))
    assert _norm_rel(m8.coefficients.values,
                     m32.coefficients.values) < FP8_COEF_NORMREL
    assert not pctx.precision_fallbacks


def test_envelope_probe_falls_back_to_bf16(pctx, caplog):
    """tests/test_mixed_precision.py:505: a column at 1000 + 0.01 eps
    (absmax/std ~ 1e5) makes the probe decline e4m3; the fit logs, records
    the reason and trains on bf16. A well-scaled fit does not fall back."""
    rng = np.random.RandomState(28)
    n, d = 800, 8
    x = rng.randn(n, d)
    x[:, 2] = 1000.0 + 0.01 * rng.randn(n)
    y = (x[:, 0] > 0).astype(np.float64)
    with caplog.at_level(logging.WARNING):
        model = LogisticRegression(maxIter=25, regParam=0.01).fit(
            MLFrame(pctx, {"features": x, "label": y}))
    assert np.all(np.isfinite(model.coefficients.values))
    assert len(pctx.precision_fallbacks) == 1
    fb = pctx.precision_fallbacks[0]
    assert fb["estimator"] == "LogisticRegression"
    assert (fb["from_dtype"], fb["to_dtype"]) == ("float8_e4m3fn",
                                                  "bfloat16")
    assert "absmax/std" in fb["reason"]
    assert any("falling back from float8_e4m3fn to bfloat16" in r.message
               for r in caplog.records)
    x2 = rng.randn(n, d)
    LogisticRegression(maxIter=25, regParam=0.01).fit(
        MLFrame(pctx, {"features": x2, "label": (x2[:, 0] > 0) * 1.0}))
    LinearRegression(maxIter=25, solver="l-bfgs").fit(
        MLFrame(pctx, {"features": x2, "label": x2[:, 1]}))
    assert len(pctx.precision_fallbacks) == 1


def test_non_capable_estimators_get_bf16(pctx):
    """Under float8, KMeans and PCA frames materialize at the bf16 rung,
    and a quantized dataset handed to them is dequantized (with a logged,
    recorded fallback): raw codes are never read as values."""
    from cycloneml_tpu_torch.ml.clustering import KMeans
    from cycloneml_tpu_torch.ml.feature import PCA
    rng = np.random.RandomState(29)
    x = rng.randn(96, 4)
    frame = MLFrame(pctx, {"features": x})
    assert frame.to_instance_dataset(label_col=None).x.dtype == torch.bfloat16
    assert InstanceDataset.from_numpy(pctx, x).x.dtype == torch.bfloat16
    KMeans(k=2, maxIter=3, seed=1).fit(frame)
    PCA(k=2, inputCol="features").fit(frame)
    assert not pctx.precision_fallbacks
    ds8 = InstanceDataset.from_numpy(pctx, x, dtype=F8)
    view = ds8.to_instance_dataset()
    assert view.x.dtype == torch.bfloat16 and view.x_scale is None
    assert ds8.to_instance_dataset(fp8_capable=True) is ds8
    model = KMeans(k=2, maxIter=3, seed=1).fit(ds8)
    assert np.all(np.isfinite(model.cluster_centers_matrix().to_array()))
    assert [f["estimator"] for f in pctx.precision_fallbacks] == \
        ["to_instance_dataset"] * 2
    # the frame cache is keyed on the dtype's name: no fp8 placement is
    # served to the bf16 caller, nor the other way round
    assert frame.to_instance_dataset(label_col=None,
                                     fp8_capable=True).x.dtype == F8
    assert frame.to_instance_dataset(label_col=None).x.dtype == torch.bfloat16


def test_rowmatrix_over_codes_reads_values(pctx):
    """RowMatrix is not fp8-capable: over a quantized dataset it works on
    the bf16 dequantization (a logged, recorded fallback), so its Gramian
    is that of the values, never of the raw codes."""
    from cycloneml_tpu_torch.linalg.distributed import RowMatrix
    rng = np.random.RandomState(33)
    x = rng.randn(200, 6) * np.array([1.0, 30.0, 0.2, 4.0, 1.0, 9.0])
    ds8 = InstanceDataset.from_numpy(pctx, x, dtype=F8)
    got = RowMatrix(ds8).compute_gramian().to_array()
    want = RowMatrix(ds8.dequantized()).compute_gramian().to_array()
    np.testing.assert_array_equal(got, want)
    # the values' Gramian at e4m3 resolution (codes would be off by
    # 1/scale^2, a factor of hundreds)
    g = x.T @ x
    assert np.all(np.abs(got - g)
                  <= 0.1 * np.sqrt(np.outer(np.diag(g), np.diag(g))))
    assert [f["estimator"] for f in pctx.precision_fallbacks] == \
        ["to_instance_dataset"]


def test_interop_carries_reference_codes(ctx, ref_tier, pctx):
    """A reference fp8 dataset's codes, scales and probe ratio carried
    across by interop: the same bytes, and the same model as quantizing
    the numpy rows in the port (the plain route, float64)."""
    ref_tier("float8")
    x, y = _lr_data(400, 9, 31)
    ref = _ref_fp8(ctx, x, y)
    codes = np.asarray(ref.x)[:400]
    ds = interop.dataset_from_numpy(codes, y, x_scale=ref.x_scale,
                                    probe_ratio=ref._fp8_probe_ratio)
    assert ds.x.dtype == F8
    np.testing.assert_array_equal(_codes(ds.x[:400]), codes.view(np.uint8))
    np.testing.assert_array_equal(ds.x_scale, ref.x_scale)
    kw = dict(maxIter=40, regParam=0.02, tol=1e-10)
    a = LogisticRegression(**kw).fit(ds)
    b = LogisticRegression(**kw).fit(
        InstanceDataset.from_numpy(pctx, x, y, dtype=F8))
    np.testing.assert_array_equal(a.coefficients.values,
                                  b.coefficients.values)
    assert a.intercept == b.intercept
    with pytest.raises(ValueError, match="1-byte"):
        interop.dataset_from_numpy(x, y, x_scale=ref.x_scale)
