"""The readings that the limits of benchmark/limits/ are set from, for one
cell at its own size, in one process (set-up, imports and the kernels'
build are paid once):

  program   the port as the configuration states it (f32, TF32 off), a
            window of one unit, judged as a run judges it, on `--seeds`
            seeds: the lower readings;
  control   the reference in emulated TF32 in the program's place, on the
            first `--controls` seeds: the upper readings;
  bf16      the port's own bf16 path (the AL CLI's --speedup) on those
            seeds;
  <fault>   each fault of benchmark/faults.py for the cell's traffic,
            planted in the program, on those seeds.

    python3 benchmark/calibrate.py --workload <cell> --first-seed <n>
        [--seeds 14] [--controls 3] [--device cuda]

Prints one JSON line a reading ({"kind", "seed", numbers...}) and a
summary: each number's largest program reading and smallest control,
bf16 and fault readings.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=14)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import importlib
    import torch
    from benchmark import core, port
    from benchmark.faults import FAULTS
    from benchmark.video import make_video

    parts = core.load_spec(args.workload)
    cfg, traffic = parts[2], parts[3]
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dev = torch.device(args.device)
    rows = []

    def note(kind, seed, readings):
        row = {"kind": kind, "seed": seed, **readings}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def quiet(*a):
        print(*a, file=sys.stderr, flush=True)

    for i in range(args.seeds):
        seed = args.first_seed + i
        # seconds=0: the window ends after its first unit
        for kind, kw in [("program", {})] + (
                [("bf16", {"precision": "bf16"})]
                + [(f.__name__, {"fault": f})
                   for f in FAULTS[traffic["driver"]]]
                if i < args.controls else []):
            t0 = time.perf_counter()
            said = []

            def keep(*a):
                said.append(" ".join(map(str, a)))
                quiet(*a)

            res = core.run_cell(args.workload, seed, 0, False, t0,
                                device=dev, spec_parts=parts, log=keep,
                                **kw)
            extra = {line.split(" ", 1)[0]: line.split(" ", 1)[1]
                     for line in said if line.startswith("loss_err_by")}
            note(kind, seed, {**{k: c["value"] for k, c in
                                 res["checks"].items()}, **extra})
        if i < args.controls:
            port.setup_precision("f32")
            video = make_video(traffic["video"], seed, dev)
            note("control", seed,
                 driver.control(cfg, traffic, video, seed, dev))
            del video
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    names = [k for k in rows[0] if k not in ("kind", "seed")
             and isinstance(rows[0][k], float)]
    summary = {}
    for kind in dict.fromkeys(r["kind"] for r in rows):
        got = [r for r in rows if r["kind"] == kind]
        pick = max if kind == "program" else min
        summary[kind] = {n: pick(r[n] for r in got) for n in names}
        summary[kind]["seeds"] = len(got)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
