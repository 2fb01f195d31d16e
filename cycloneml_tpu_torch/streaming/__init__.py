"""Structured streaming's sink contract, the part the model server's
:class:`~cycloneml_tpu_torch.serving.streaming.ScoringSink` needs:
:class:`~cycloneml_tpu_torch.streaming.sinks.Sink` and
:class:`~cycloneml_tpu_torch.streaming.sinks.MemorySink`. The engine, its
sources, state stores, logs and the other sinks are ROADMAP Queue 1 item
12."""

from cycloneml_tpu_torch.streaming.sinks import MemorySink, Sink

__all__ = ["Sink", "MemorySink"]
