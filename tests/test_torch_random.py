"""The port's seeded generators (``cycloneml_tpu_torch/dataset/random.py``).

A ``torch.Generator`` on the CPU keeps only the low 32 bits of its seed, so
the card's seed value ``(seed << 32) + stream`` would draw the same rows
for every seed there; on the CPU the seed is mixed into the low 32 bits
(:func:`seed_value`), and on CUDA the value stays ``(seed << 32) +
stream``, so every configuration drawn on the card keeps its data. These
tests need no card: the CUDA branch is held through ``seed_value``.
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.dataset import random as prandom


@pytest.fixture
def ctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    yield c
    c.stop()


@pytest.mark.parametrize("seed", [0, 1, 2, 11, 2 ** 31 - 1, 2 ** 40 + 3])
@pytest.mark.parametrize("stream", [0, 1, 7, prandom._BETA_STREAM])
def test_cuda_seed_value_is_unchanged(seed, stream):
    """On CUDA the seed value is ``(seed << 32) + stream``, as before the
    CPU repair; on the CPU it is a 32-bit value, the stream itself at seed
    0 (whose CPU draws the repair keeps)."""
    assert prandom.seed_value("cuda", seed, stream) == (seed << 32) + stream
    cpu = prandom.seed_value("cpu", seed, stream)
    assert 0 <= cpu < 2 ** 32
    if seed == 0:
        assert cpu == stream


def test_cpu_seed_values_differ_by_seed_and_stream():
    """Distinct (seed, stream) pairs give distinct CPU seed values."""
    values = {prandom.seed_value("cpu", s, t)
              for s in range(64) for t in (0, 1, 2, prandom._BETA_STREAM)}
    assert len(values) == 64 * 4


def test_cpu_generators_draw_by_seed():
    """On the CPU two seeds draw different numbers and one seed the same
    numbers twice."""
    def draw(seed, stream=0):
        return torch.rand(8, generator=prandom._generator(
            torch.device("cpu"), seed, stream))

    assert not torch.equal(draw(0), draw(1))
    assert not torch.equal(draw(1), draw(2))
    assert not torch.equal(draw(1, 0), draw(1, 1))
    assert torch.equal(draw(3), draw(3))


@pytest.mark.parametrize("make", [
    lambda ctx, seed: prandom.generate_criteo_like(ctx, 500, seed=seed,
                                                   hash_dim=1 << 10),
    lambda ctx, seed: prandom.generate_classification(ctx, 200, 6,
                                                      seed=seed),
], ids=["criteo_like", "classification"])
def test_cpu_datasets_draw_different_rows_by_seed(ctx, make):
    """Two seeds draw different rows on the CPU, and one seed the same
    rows twice."""
    def rows(seed):
        ds = make(ctx, seed)
        x = ds.values if hasattr(ds, "indices") else ds.x
        extra = ds.indices if hasattr(ds, "indices") else ds.y
        return (x.cpu().float().numpy().copy(),
                extra.cpu().float().numpy().copy())

    a, b, again = rows(0), rows(1), rows(0)
    assert not np.array_equal(a[0], b[0])
    assert not np.array_equal(a[1], b[1])
    assert all(np.array_equal(u, v) for u, v in zip(a, again))
