"""Logging (analog of the reference's internal/Logging trait).

The port's copy of ``cycloneml_tpu/util/logging.py``: one stderr handler on
the ``cycloneml_tpu_torch`` root logger, its level from
``CYCLONE_LOG_LEVEL`` (default WARNING), installed at the first call."""

import logging
import os
import sys

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("CYCLONE_LOG_LEVEL", "WARNING").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        root = logging.getLogger("cycloneml_tpu_torch")
        root.addHandler(handler)
        root.setLevel(level)
        _CONFIGURED = True
    return logging.getLogger(
        name if name.startswith("cycloneml_tpu_torch")
        else f"cycloneml_tpu_torch.{name}")
