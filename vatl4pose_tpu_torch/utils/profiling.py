"""Profiling: a torch.profiler trace and per-AL-cycle wall-clock tracking
(counterpart of vatl4pose_tpu/utils/profiling.py).

CycleTimer records every phase of every AL round to
work_dir/cycle_times.jsonl in the JAX package's schema
({"round", "phases": {name: s}, "total_s"} a line), which the analysis
tools read.  `trace()` wraps a region in a torch.profiler trace of the host
and, where there is a card, of its kernels, exported as a Chrome trace
(the JAX package's `jax.profiler` trace for --verbose).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

__all__ = ["trace", "CycleTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed region into log_dir/trace.json (Chrome trace
    format; chrome://tracing or Perfetto opens it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class CycleTimer:
    """Phase-level wall-clock per AL cycle → work_dir/cycle_times.jsonl."""

    def __init__(self, work_dir: Optional[str] = None):
        self.work_dir = work_dir
        self.cycles: List[Dict] = []
        self._current: Dict = {}
        self._t0 = None

    def start_cycle(self, round_cnt: int):
        self._current = {"round": round_cnt, "phases": {}}
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ph = self._current.setdefault("phases", {})
            ph[name] = ph.get(name, 0.0) + time.perf_counter() - t0

    def end_cycle(self):
        if self._t0 is None:
            return
        self._current["total_s"] = time.perf_counter() - self._t0
        self.cycles.append(self._current)
        if self.work_dir:
            os.makedirs(self.work_dir, exist_ok=True)
            with open(os.path.join(self.work_dir, "cycle_times.jsonl"),
                      "a") as f:
                f.write(json.dumps(self._current) + "\n")
        self._current = {}
        self._t0 = None

    def summary(self) -> Dict[str, float]:
        if not self.cycles:
            return {}
        totals = [c["total_s"] for c in self.cycles]
        out = {"cycles": len(totals),
               "mean_cycle_s": sum(totals) / len(totals),
               "total_s": sum(totals)}
        keys = {k for c in self.cycles for k in c.get("phases", {})}
        for k in sorted(keys):
            vals = [c["phases"].get(k, 0.0) for c in self.cycles]
            out[f"mean_{k}_s"] = sum(vals) / len(vals)
        return out
