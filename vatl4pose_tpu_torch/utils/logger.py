"""Logging and scalar tracking (counterpart of vatl4pose_tpu/utils/
logger.py).

Parity: alphapose/opt.py:65-86 (a file and stream logger with epochInfo)
and alphapose/utils/logger.py:10-29 (TensorBoard scalar writing; here the
scalars go to a JSONL file that the analysis scripts read).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

__all__ = ["make_logger", "ScalarWriter"]


def make_logger(name: str, work_dir: Optional[str] = None,
                filename: str = "train.log") -> logging.Logger:
    """An INFO logger to stderr and, with `work_dir`, to work_dir/filename;
    `logger.epochInfo(epoch, loss, acc)` logs one epoch's line."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if work_dir:
        os.makedirs(work_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(work_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)

    def epoch_info(epoch, loss, acc):
        logger.info(f"Epoch {epoch} | loss:{loss:.8f} | acc:{acc:.4f}")

    logger.epochInfo = epoch_info  # type: ignore[attr-defined]
    return logger


class ScalarWriter:
    """Appends one {step, tag, value, wall} JSON line a scalar."""

    def __init__(self, work_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, filename)
        self._f = open(self.path, "a")

    def write(self, tag: str, value: float, step: int):
        self._f.write(json.dumps({"step": step, "tag": tag,
                                  "value": float(value),
                                  "wall": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
