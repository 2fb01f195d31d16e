"""Summary statistics, hypothesis tests and correlation."""
from cycloneml_tpu_torch.ml.stat.summarizer import Summarizer, SummaryStats
from cycloneml_tpu_torch.ml.stat.tests import (
    ANOVATest, ChiSquareTest, Correlation, FValueTest, KolmogorovSmirnovTest,
)

__all__ = ["Summarizer", "SummaryStats", "ChiSquareTest", "Correlation",
           "KolmogorovSmirnovTest", "ANOVATest", "FValueTest"]
