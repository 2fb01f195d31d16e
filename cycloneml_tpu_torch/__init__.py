"""cycloneml_tpu_torch — the PyTorch/CUDA port of ``cycloneml_tpu``.

A second package beside the JAX one, with the same module paths and names.
It imports ``torch`` and never ``jax`` or ``cycloneml_tpu``; its entry points
run on the card (``cyclone.master`` defaults to ``"cuda"``) unless the caller
asks for the CPU. Every Pallas kernel on a ported path is a hand-written
CUDA kernel for Hopper (``csrc/``), with a plain PyTorch version beside it.
"""

__version__ = "0.1.0"

from cycloneml_tpu_torch.conf import CycloneConf
from cycloneml_tpu_torch.context import CycloneContext

__all__ = ["CycloneConf", "CycloneContext", "__version__"]
