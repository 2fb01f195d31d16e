"""Low-latency model serving on prepared bucket programs.

The port's ``cycloneml_tpu/serving`` package (built the way Clipper
structured serving, Crankshaw et al., NSDI 2017):

- :mod:`~cycloneml_tpu_torch.serving.servable`: the model-abstraction
  layer: fitted estimators, and K-model gangs, behind one margins kernel
  and a host postprocess.
- :mod:`~cycloneml_tpu_torch.serving.buckets`: power-of-two padded shape
  buckets; registration prepares every one, requests never do.
- :mod:`~cycloneml_tpu_torch.serving.batcher`: latency-bounded
  micro-batching, each bucket one CUDA graph on the card, admission
  control against the memory budget guard, chaos-instrumented dispatch
  (``serving.dispatch``).
- :mod:`~cycloneml_tpu_torch.serving.server`: the ModelServer facade.
- :mod:`~cycloneml_tpu_torch.serving.streaming`: featurize -> predict ->
  sink through the same batcher.
"""

from cycloneml_tpu_torch.serving.batcher import ServingError, ServingOverloaded
from cycloneml_tpu_torch.serving.buckets import bucket_for, bucket_sizes, pad_rows
from cycloneml_tpu_torch.serving.servable import (
    GangServable, Servable, as_servable, serving_dtype,
)
from cycloneml_tpu_torch.serving.server import ModelServer
from cycloneml_tpu_torch.serving.streaming import ScoringSink

__all__ = [
    "ModelServer", "ServingError", "ServingOverloaded", "Servable",
    "GangServable", "as_servable", "serving_dtype", "bucket_for",
    "bucket_sizes", "pad_rows", "ScoringSink",
]
