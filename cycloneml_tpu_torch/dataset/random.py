"""Random dataset generators, drawn on the device.

The port's counterpart of ``cycloneml_tpu/dataset/random.py``
(``generate_classification``, ``generate_regression`` and
``RandomDatasets.normal``). Each mesh shard draws its rows from its own
seeded ``torch.Generator`` (seed, shard), and a shared ground-truth weight
vector comes from the generator (seed, 2**31 - 1) — the reference's
per-shard ``fold_in`` scheme. The bits differ from ``jax.random``'s, so "the
same seed" is not the same data as the reference's: parity tests never use
these generators; they make their inputs with numpy and hand them to both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import compute_dtype, data_dtype

_GEN_ROWS = 1 << 16  # rows drawn at a time (bounds the f32 temporary)
_BETA_STREAM = 2 ** 31 - 1


def _generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 32) + int(stream))
    return g


def _generate_labeled(ctx, n_rows: int, n_cols: int, seed: int,
                      noise: float, label) -> InstanceDataset:
    """Rows x ~ N(0, I) and labels ``label(x.beta + noise*eps)`` with a
    shared ``beta ~ N(0, I)``, generated on the device. X lands in the data
    tier (drawn in float32, then narrowed on the device), y/w in the
    accumulator tier; padding rows carry w=0. Only the (n,) labels are read
    back, once, so estimators get their host label moments."""
    conf = getattr(ctx, "conf", None)
    rt = ctx.mesh_runtime
    dev = rt.device
    nd = rt.data_parallelism
    per = max(((n_rows + nd - 1) // nd + 7) // 8 * 8, 8)
    total = per * nd
    # not fp8-capable: under the fp8 tiers the generators store bfloat16,
    # as the reference's do; quantize with InstanceDataset.quantized()
    cdt, xdt = compute_dtype(conf), data_dtype(conf)
    f32 = torch.float32
    beta = torch.randn(n_cols, generator=_generator(dev, seed, _BETA_STREAM),
                       device=dev, dtype=f32)
    x = torch.empty((total, n_cols), dtype=xdt, device=dev)
    y = torch.empty(total, dtype=cdt, device=dev)
    for shard in range(nd):
        g = _generator(dev, seed, shard)
        for lo in range(0, per, _GEN_ROWS):
            rows = min(_GEN_ROWS, per - lo)
            xc = torch.randn((rows, n_cols), generator=g, device=dev, dtype=f32)
            eps = torch.randn(rows, generator=g, device=dev, dtype=f32)
            at = shard * per + lo
            x[at:at + rows] = xc.to(xdt)
            y[at:at + rows] = label(xc @ beta + noise * eps).to(cdt)
    w_host = np.zeros(total, dtype=np.float64)
    w_host[:n_rows] = 1.0
    w = rt.device_put_sharded_rows(w_host).to(cdt)
    ds = InstanceDataset(ctx, x, y, w, n_rows, n_cols)
    return ds.attach_host_labels(y.cpu().double().numpy(), w_host)


def generate_classification(ctx, n_rows: int, n_cols: int, seed: int = 0,
                            noise: float = 1.0) -> InstanceDataset:
    """Labeled synthetic binary-classification data, generated on the
    device: ``y = 1[x.beta + noise*eps > 0]`` (see
    :func:`_generate_labeled`)."""
    return _generate_labeled(ctx, n_rows, n_cols, seed, noise,
                             lambda m: m > 0)


def generate_regression(ctx, n_rows: int, n_cols: int, seed: int = 0,
                        noise: float = 0.1) -> InstanceDataset:
    """Labeled synthetic linear-regression data, generated on the device
    (the epsilon-shape LinearRegression configuration's feeder):
    ``y = x.beta + noise*eps`` (see :func:`_generate_labeled`)."""
    return _generate_labeled(ctx, n_rows, n_cols, seed, noise,
                             lambda m: m)


class RandomDatasets:
    """Static factory surface mirroring RandomRDDs (the vector variants
    this slice uses)."""

    classification = staticmethod(generate_classification)
    regression = staticmethod(generate_regression)

    @staticmethod
    def normal(ctx, n_rows: int, n_cols: int = 1, seed: int = 0,
               mean: float = 0.0, std: float = 1.0) -> InstanceDataset:
        """Unlabeled rows x ~ N(mean, std^2 I) on the device, in the data
        tier (drawn in float32, narrowed on the device); y = 0, padding
        rows carry w=0."""
        conf = getattr(ctx, "conf", None)
        rt = ctx.mesh_runtime
        dev = rt.device
        nd = rt.data_parallelism
        per = max(((n_rows + nd - 1) // nd + 7) // 8 * 8, 8)
        total = per * nd
        cdt, xdt = compute_dtype(conf), data_dtype(conf)
        x = torch.empty((total, n_cols), dtype=xdt, device=dev)
        for shard in range(nd):
            g = _generator(dev, seed, shard)
            for lo in range(0, per, _GEN_ROWS):
                rows = min(_GEN_ROWS, per - lo)
                at = shard * per + lo
                x[at:at + rows] = (torch.randn(
                    (rows, n_cols), generator=g, device=dev,
                    dtype=torch.float32) * std + mean).to(xdt)
        w_host = np.zeros(total, dtype=np.float64)
        w_host[:n_rows] = 1.0
        w = rt.device_put_sharded_rows(w_host).to(cdt)
        ds = InstanceDataset(ctx, x, torch.zeros(total, dtype=cdt,
                                                 device=dev), w, n_rows,
                             n_cols)
        return ds.attach_host_labels(np.zeros(total), w_host)
