"""One run of one cell: set-up, the measured window, the traced segment,
the per-layer readers and the comparison that decides `correct`.

Everything a cell is made of is found by name: the cell's entry in
BENCHMARK.json names its configuration file and its traffic file; the
traffic file names its driver (benchmark/drivers/<driver>.py), the
end-to-end metric it reports and its parameters; each per-layer metric is
benchmark/metrics/<name>.py; each cell's limits are
benchmark/limits/<workload>.json.  A new configuration, mix, metric or
cell is new files and entries only.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import torch

from benchmark import port, trace
from benchmark.video import make_video

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vatl4pose_tpu")


def forbidden_modules(modules=None):
    """Top-level names in sys.modules (or `modules`) that a run may not
    load, compared whole: the port's name begins with the JAX package's."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def load_spec(workload: str):
    """(benchmark spec, cell entry, configuration, traffic, limits)."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    return spec, cell, cfg, traffic, limits


def end_to_end_metrics(spec, workload):
    """The cell's end-to-end metrics: those that list it, or list no
    cells."""
    return [m for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer_metrics(spec, workload):
    """The cell's per-layer metrics: those whose `workloads` list it.
    Every per-layer entry lists its cells, so that a metric is never
    asked of a cell where its reader finds nothing to read."""
    for m in spec["per_layer"]:
        if "workloads" not in m:
            raise SystemExit(f"per-layer metric {m['name']!r} lists no "
                             "workloads")
    return [m for m in spec["per_layer"] if workload in m["workloads"]]


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(workload, seed, seconds, trace_on, t_start, precision="f32",
             device=None, spec_parts=None, fault=None, log=print):
    """One run.  Returns the result object (the contract's keys, `checks`
    last).  `device`, `spec_parts` (as load_spec returns them) and `fault`
    (called with the driver's cell after set-up, to break the timed path
    underneath) serve the benchmark's own tests."""
    device = torch.device(device or "cuda")
    spec, cell_entry, cfg, traffic, limits = spec_parts or load_spec(workload)
    phases = {"start": time.perf_counter() - t_start}

    def phase(name):
        _sync(device)
        phases[name] = time.perf_counter() - t_start

    port.setup_precision(precision)
    phase("port imported")
    if device.type == "cuda":
        port.build_kernels()
    phase("kernels")
    video = make_video(traffic["video"], seed, device)
    phase("video")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    cell = driver.Cell(cfg, traffic, video, seed, device, precision)
    phase("built")
    if fault is not None:
        fault(cell)
    cell.warm()
    phase("warm")
    setup_s = phases["warm"]
    log(f"set-up {setup_s:.3f} s; by phase (s from process start): "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    counts0 = port.launch_counts()
    units = samples = 0
    t0 = time.perf_counter()
    while True:
        samples += cell.unit()
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    rate = samples / elapsed
    counts = {k: v - counts0[k] for k, v in port.launch_counts().items()}
    log(f"window {elapsed:.3f} s: {units} units, {samples} samples, "
        f"{rate:.4f} samples/s; kernel launches {counts}")

    e2e = end_to_end_metrics(spec, workload)
    units_of = {m["name"]: m["unit"] for m in spec["end_to_end"]}
    result = {"correct": False, "attempted": units, "failed": 0}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(0)
                if device.type == "cuda" else device.type,
                "count": int(cell_entry["chips"])}
    if not trace_on:
        values = {traffic["metric"]: rate, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": units_of[m["name"]]}
                             for m in e2e}
    else:
        summary, t_samples, t_seconds = trace.traced(
            cell.unit, traffic["trace_units"], device)
        # what a reader of benchmark/metrics/ may read
        ctx = types.SimpleNamespace(
            cfg=cfg, trace=summary, rate=rate,
            traced_units=traffic["trace_units"], traced_samples=t_samples,
            chunks=getattr(cell, "chunks", None))
        result["metrics"] = {}
        for m in per_layer_metrics(spec, workload):
            v = reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown
        log(f"traced {traffic['trace_units']} units: {t_seconds:.3f} s, "
            f"device busy {summary.busy_s:.6f} of {summary.window_s:.6f} s")
    if device.type == "cuda":
        _sync(device)
        dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    else:
        dev_info["memory_peak_bytes"] = 0
    result["device"] = dev_info

    cell.release()
    t_ref = time.perf_counter()
    readings = cell.judge(log)
    log(f"reference and comparison {time.perf_counter() - t_ref:.3f} s")
    if set(readings) != set(limits):
        raise SystemExit(f"limits {sorted(limits)} do not name the "
                         f"numbers compared {sorted(readings)}")
    result["correct"] = all(readings[k] <= limits[k] for k in readings)
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                        for k in sorted(readings)}
    return result
