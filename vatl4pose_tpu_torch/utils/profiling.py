"""Profiling: the port's spans, a torch.profiler trace and per-AL-cycle
wall-clock tracking (counterpart of vatl4pose_tpu/utils/profiling.py).

`span(name)` marks one layer boundary of the program (a scoring pass and
its stages, a retraining call and its geometry, upload, steps and fetch,
the AE fine-tune, mAP, OSPA).  It costs one flag test and one profiler
test while nothing listens.  Under torch.profiler it is a
`record_function` range, so it shares the event stream and clock of the
card's kernels and labels the device's idle gaps that fall inside it.
Between `CycleTimer.start_cycle` and `end_cycle` it is kept in memory
(name, parent, start, end on the host's perf_counter) and summed into the
cycle's line.

CycleTimer records every AL round to work_dir/cycle_times.jsonl in the
JAX package's schema ({"round", "phases": {name: s}, "total_s"} a line),
which the analysis tools read, plus "spans": {name: {"n", "s", "self_s"}}
for every span the round ran, self time being a span's duration less the
part its child spans cover.  `trace()` wraps a region in a torch.profiler
trace of the host and, where there is a card, of its kernels, exported as
a Chrome trace (the JAX package's `jax.profiler` trace for --verbose).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "trace", "CycleTimer"]

# the recorder of the open CycleTimer cycle, else None: spans are opened
# deep inside the engine and the trainers, which hold no timer
_recorder = None
PHASE = "al."


class _Spans:
    """The spans of one cycle, in the order they were opened.  Spans are
    opened from one thread, so the innermost open span is the parent."""

    def __init__(self):
        self.records = []       # [name, parent index or -1, start, end] ns
        self.open = []          # indices of the open spans, innermost last

    def enter(self, name):
        self.records.append([name, self.open[-1] if self.open else -1,
                             time.perf_counter_ns(), None])
        self.open.append(len(self.records) - 1)

    def exit(self):
        self.records[self.open.pop()][3] = time.perf_counter_ns()

    def totals(self):
        """{name: {"n", "s", "self_s"}} over the spans that closed."""
        closed = [(i, r) for i, r in enumerate(self.records)
                  if r[3] is not None]
        child = [0] * len(self.records)
        for _, (_, parent, t0, t1) in closed:
            if parent >= 0:
                child[parent] += t1 - t0
        ns = {}
        for i, (name, _, t0, t1) in closed:
            n, total, own = ns.get(name, (0, 0, 0))
            ns[name] = (n + 1, total + t1 - t0, own + t1 - t0 - child[i])
        return {k: {"n": n, "s": total / 1e9, "self_s": own / 1e9}
                for k, (n, total, own) in ns.items()}


@contextlib.contextmanager
def span(name: str):
    """A layer boundary named `name`: a torch.profiler range while the
    profiler records, an entry of the open CycleTimer cycle, or nothing."""
    rec = _recorder
    prof = _autograd_profiler._is_profiler_enabled
    if rec is None and not prof:
        yield
        return
    if rec is not None:
        rec.enter(name)
    try:
        if prof:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        if rec is not None:
            rec.exit()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed region into log_dir/trace.json (Chrome trace
    format; chrome://tracing or Perfetto opens it)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class CycleTimer:
    """Phase-level wall-clock and the spans of each AL cycle →
    work_dir/cycle_times.jsonl.  A phase is the span PHASE + name."""

    def __init__(self, work_dir: Optional[str] = None):
        self.work_dir = work_dir
        self._round = None
        self._spans = None
        self._t0 = None

    def start_cycle(self, round_cnt: int):
        global _recorder
        self._round = round_cnt
        self._spans = _recorder = _Spans()
        self._t0 = time.perf_counter()

    def phase(self, name: str):
        return span(PHASE + name)

    def end_cycle(self):
        global _recorder
        if self._t0 is None:
            return
        total_s = time.perf_counter() - self._t0
        if _recorder is self._spans:
            _recorder = None
        spans = self._spans.totals()
        line = {"round": self._round,
                "phases": {k[len(PHASE):]: v["s"] for k, v in spans.items()
                           if k.startswith(PHASE)},
                "total_s": total_s, "spans": spans}
        if self.work_dir:
            os.makedirs(self.work_dir, exist_ok=True)
            with open(os.path.join(self.work_dir, "cycle_times.jsonl"),
                      "a") as f:
                f.write(json.dumps(line) + "\n")
        self._spans = self._t0 = None
