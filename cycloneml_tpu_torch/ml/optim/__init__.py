"""Aggregators, loss functions and quasi-Newton optimizers."""
from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS, LBFGSB, OWLQN, OptimState

__all__ = ["LBFGS", "LBFGSB", "OWLQN", "OptimState"]
