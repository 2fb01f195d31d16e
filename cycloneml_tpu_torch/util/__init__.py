"""Host-side utilities of the port: the metrics registry
(:mod:`~cycloneml_tpu_torch.util.metrics`)."""
