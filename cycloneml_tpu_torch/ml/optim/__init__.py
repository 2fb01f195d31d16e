"""Aggregators, loss functions and quasi-Newton optimizers."""
from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS, OptimState

__all__ = ["LBFGS", "OptimState"]
