"""The traced segment: a bounded number of the window's units of work run
under torch.profiler (CPU and CUDA activity), reduced in memory to what
the per-layer metrics read.  Nothing is written to disk.

busy_s is the length of the union of every device activity's interval
(kernels, copies, sets) inside the segment's span, so that activities
that overlap count once; window_s is the span's length; idle = 1 -
busy/window.  `breakdown` gives the device operations that took most time
(summed by name) and the idle gaps, each labelled by the innermost host
operation that was running at the gap's middle, summed by label.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

__all__ = ["union_ns", "gaps", "summarize", "traced"]

WINDOW = "bench.window"
UNIT = "bench.unit"


def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _device_event(e):
    """A device activity: a kernel, copy or set on the card.  The
    profiler also mirrors each record_function range onto the device's
    timeline as a user annotation; that is no activity."""
    return e.device_type() == torch.autograd.DeviceType.CUDA \
        and not e.is_user_annotation()


def _is_kernel(name):
    return not name.startswith(("Memcpy", "Memset"))


def summarize(events, top=10, labelled_gaps=200):
    """events: (name, is_device, start_ns, end_ns) of one traced segment,
    holding exactly one host event named WINDOW.  The harness's own
    ranges mirrored onto the device's timeline are no device activity."""
    win = [(s, e) for n, dev, s, e in events if n == WINDOW and not dev]
    lo, hi = win[0]
    dev = [(n, max(s, lo), min(e, hi)) for n, d, s, e in events
           if d and e > lo and s < hi and n not in (WINDOW, UNIT)]
    busy = [(s, e) for _, s, e in dev]
    by_name = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host = [(n, s, e) for n, d, s, e in events if not d and n != WINDOW]
    hs = np.array([s for _, s, _ in host], np.int64)
    he = np.array([e for _, _, e in host], np.int64)
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])
    label_sum = {}
    for i, (s, e) in enumerate(idle):
        label = "shorter gaps"
        if i < labelled_gaps and len(hs):
            mid = (s + e) // 2
            inside = np.flatnonzero((hs <= mid) & (he >= mid))
            label = host[inside[np.argmax(hs[inside])]][0] if len(inside) \
                else "no host operation"
            if label == UNIT:
                label = "host Python, no torch operation"
        label_sum[label] = label_sum.get(label, 0) + (e - s)
    idle_top = sorted(label_sum.items(), key=lambda kv: -kv[1])[:top]
    return types.SimpleNamespace(
        window_s=(hi - lo) / 1e9, busy_s=union_ns(busy) / 1e9,
        kernels=[(n, s, e) for n, s, e in dev if _is_kernel(n)],
        breakdown={"device_ops": [[n[:160], t / 1e9] for n, t in ops],
                   "idle_gaps": [[n[:160], t / 1e9] for n, t in idle_top]})


def traced(unit, n_units, device):
    """Run `unit()` n_units times under the profiler; returns (summary,
    samples, seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    samples = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            for _ in range(n_units):
                with record_function(UNIT):
                    samples += unit()
            if device.type == "cuda":
                torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    events = [(e.name(), _device_event(e), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return summarize(events), samples, seconds
