"""Random dataset generators, drawn on the device.

The port's counterpart of ``cycloneml_tpu/dataset/random.py``. Each mesh
shard draws its rows from its own seeded ``torch.Generator`` (seed, shard),
and a shared ground-truth weight vector comes from the generator (seed,
2**31 - 1) — the reference's per-shard ``fold_in`` scheme. The bits differ
from ``jax.random``'s, so parity tests never use these generators: they
make their inputs with numpy and hand them to both packages.
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


def generate_classification(ctx, n_rows: int, n_cols: int, seed: int = 0,
                            noise: float = 1.0) -> InstanceDataset:
    """Labeled synthetic binary-classification data, generated on the
    device: rows x ~ N(0, I) and labels ``y = 1[x.beta + noise*eps > 0]``
    with a shared ``beta ~ N(0, I)``. X lands in the data tier (drawn in
    float32, then narrowed on the device), y/w in the accumulator tier;
    padding rows carry w=0. Only the (n,) labels are read back, once, so
    estimators get their host label histogram."""
    conf = getattr(ctx, "conf", None)
    rt = ctx.mesh_runtime
    dev = rt.device
    nd = rt.data_parallelism
    per = max(((n_rows + nd - 1) // nd + 7) // 8 * 8, 8)
    total = per * nd
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
            y[at:at + rows] = (xc @ beta + noise * eps > 0).to(cdt)
    w_host = np.zeros(total, dtype=np.float64)
    w_host[:n_rows] = 1.0
    w = rt.device_put_sharded_rows(w_host).to(cdt)
    ds = InstanceDataset(ctx, x, y, w, n_rows, n_cols)
    return ds.attach_host_labels(y.cpu().double().numpy(), w_host)
