"""The serving margins' summation order, and the tiled kernel against it.

The CPU tests hold ``kernels.serving_margins_plain`` to an emulation of
the order written out in numpy (one float32 or float64 operation at a
time, each rounded on its own): partial l adds the products of columns
l, l + 32, ... in order, then the xor tree over offsets 16, 8, 4, 2, 1,
then the intercept. That is the order the one-warp-a-margin kernel
(``csrc/serving_margins.cu`` before its tiled design) and its twin gave,
so the twin keeps those bits on the buckets and gangs of
``tests/test_torch_serving.py``.

The ``gpu`` test holds the tiled kernel to the twin bit for bit at every
bucket 1 to 1,024, float32 and float64, plain and e4m3 coefficients,
ragged widths and a misaligned base. Run it on the card with

    python -m pytest --noconftest -m gpu tests/test_torch_serving_tiles.py
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch.ops import kernels
from cycloneml_tpu_torch.serving import bucket_sizes
from cycloneml_tpu_torch.serving.servable import _quantize_rows


def _order_in_numpy(x, coef, icpt):
    """(K, B, Km) margins in the kernel's order, one rounded numpy
    operation at a time; x (B, d), coef (K, Km, d), icpt (K, Km), all of
    one float dtype."""
    k, km, d = coef.shape
    b = x.shape[0]
    dt = x.dtype.type
    part = np.zeros((k, b, km, 32), dtype=x.dtype)
    for j0 in range(0, d, 32):
        n = min(32, d - j0)
        prod = x[None, :, None, j0:j0 + n] * coef[:, None, :, j0:j0 + n]
        part[..., :n] = part[..., :n] + prod
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., np.arange(32) ^ off]
    return part[..., 0] + icpt[:, None, :].astype(dt)


def _case(r, k, km, d, dtype, quantized):
    coef, icpt = r.normal(size=(k, km, d)), r.normal(size=(k, km))
    if quantized:
        c, s, i = _quantize_rows(coef, icpt, dtype)
        dense = (c.to(dtype) * s[..., None]).numpy()
    else:
        c = torch.as_tensor(coef).to(dtype)
        i, s = torch.as_tensor(icpt).to(dtype), None
        dense = c.numpy()
    return c, i, s, dense


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("quantized", [False, True])
def test_plain_twin_keeps_the_one_warp_order_bitwise(dtype, quantized):
    """The twin gives the order's bits (as the one-warp kernel and its
    twin did) on the buckets and gangs of test_torch_serving.py: K = 1
    and 5 models of 2 margins, widths 77, 1,280 and 3,072, buckets 1 to
    64."""
    r = np.random.default_rng(41)
    for d, k in ((77, 1), (1280, 5), (3072, 1)):
        c, i, s, dense = _case(r, k, 2, d, dtype, quantized)
        for b in bucket_sizes(64):
            x = torch.as_tensor(r.normal(size=(b, d))).to(dtype)
            got = kernels.serving_margins_plain(x, c, i, s)
            want = _order_in_numpy(x.numpy(), dense, i.numpy())
            assert np.array_equal(got.numpy(), want), (d, k, b)


def test_plain_twin_gang_rows_equal_serial_and_bucket_bits():
    """A CIFAR-10-sized gang (10 x 3,072) at buckets 1, 64 and 256: each
    model's margins are its serial lane's bits, and a row's bits are the
    same in every bucket."""
    r = np.random.default_rng(7)
    c, i, s, _ = _case(r, 10, 1, 3072, torch.float32, False)
    x = torch.as_tensor(r.normal(size=(256, 3072))).to(torch.float32)
    full = kernels.serving_margins_plain(x, c, i, s)
    for b in (1, 64):
        assert torch.equal(kernels.serving_margins_plain(x[:b], c, i, s),
                           full[:, :b])
    for m in range(10):
        assert torch.equal(kernels.serving_margins_plain(
            x, c[m:m + 1], i[m:m + 1], s), full[m:m + 1])


# -- on the card ---------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_tiled_kernel_equals_plain_twin_bitwise(dtype, quantized):
    """The kernel (staged tiles or the direct layout, as its plan picks
    them) against its twin on the same card tensors, bit for bit: every
    bucket 1 to 1,024; gangs of 1, 8 and 10 models, a
    multinomial lane of 3 margins, a gang of 2 models of 3 margins (the
    2 x 2 tile) and a gang of 23 margin rows (several margin tiles, the
    last one short); widths 1,279 and 2,000 (rows not
    16-byte aligned) and 3,072; a base one element off its allocation's
    alignment; each launch counted under its instance."""
    dev = _cuda()
    r = np.random.default_rng(1021)
    kernels.reset_launch_counts()
    launches = 0
    for d, k, km in ((1279, 10, 1), (2000, 8, 1), (3072, 10, 1),
                     (1279, 1, 1), (2000, 1, 3), (3072, 2, 3),
                     (1279, 23, 1)):
        c, i, s, _ = _case(r, k, km, d, dtype, quantized)
        c, i = c.to(dev), i.to(dev)
        s = None if s is None else s.to(dev)
        rows = torch.as_tensor(r.normal(size=(1024 * d + 1,))).to(dev, dtype)
        for b in bucket_sizes(1024):
            for base in (0, 1):
                x = rows[base:base + b * d].view(b, d)
                got = kernels.serving_margins(x, c, i, s)
                launches += 1
                want = kernels.serving_margins_plain(x, c, i, s)
                assert torch.equal(got, want), (d, k, km, b, base)
    torch.cuda.synchronize()
    inst = kernels.serving_instance(dtype, quantized)
    assert kernels.serving_margins.launches_by_instance[inst] == launches
