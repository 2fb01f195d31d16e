"""The port's Summarizer moments against the JAX package's, in float64 on
the same numpy data (weights, zero-weight rows and exact zeros included)."""

import numpy as np
import pytest

from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
from cycloneml_tpu.ml.stat import Summarizer as JaxSummarizer
from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.ml.stat import Summarizer


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


@pytest.mark.parametrize("weighted", [False, True])
def test_moments_match_reference(ctx, pctx, weighted):
    rng = np.random.RandomState(11)
    n, d = 203, 9
    x = rng.randn(n, d) * rng.rand(d) * 4 + rng.randn(d)
    x[rng.rand(n, d) < 0.2] = 0.0
    x[:, 3] = 2.5  # a constant column: zero variance
    w = rng.rand(n) + 0.1 if weighted else None
    if weighted:
        w[::17] = 0.0  # rows present in X but weightless
    ref = JaxSummarizer.summarize(JaxDataset.from_numpy(ctx, x, None, w))
    got = Summarizer.summarize(InstanceDataset.from_numpy(pctx, x, None, w))
    for name in ("mean", "variance", "num_nonzeros", "max", "min", "norm_l1",
                 "norm_l2", "sum"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-12, atol=1e-13, err_msg=name)
    assert got.count == ref.count
    assert got.weight_sum == pytest.approx(ref.weight_sum, rel=1e-14)
    np.testing.assert_allclose(got.std, ref.std, rtol=1e-12, atol=1e-13)


def test_moments_of_bf16_data_accumulate_wide(pctx):
    """A bf16 X is summed at w's (accumulator) width, chunk by chunk: the
    moments equal the float64 moments of the bf16-rounded values."""
    import torch
    pctx.conf.set("cyclone.compute.dtype", "float32")
    rng = np.random.RandomState(3)
    x = rng.randn(1000, 5) + 3.0
    ds = InstanceDataset.from_numpy(pctx, x, dtype=torch.bfloat16)
    got = Summarizer.summarize(ds)
    xr = ds.x[:1000].double().numpy()
    np.testing.assert_allclose(got.mean, xr.mean(0), rtol=1e-6)
    np.testing.assert_allclose(got.variance, xr.var(0, ddof=1), rtol=1e-4)
    assert got.count == 1000 and got.weight_sum == 1000.0
