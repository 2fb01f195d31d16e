"""Summary statistics."""
from cycloneml_tpu_torch.ml.stat.summarizer import Summarizer, SummaryStats

__all__ = ["Summarizer", "SummaryStats"]
