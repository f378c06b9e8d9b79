"""The benchmark of vatl4pose_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--precision f32|bf16]

Runs one cell of BENCHMARK.json from the root of a checkout: makes the
video and the weights from the seed on the card, builds the port's
entries, warms the cell's shapes, measures for `--seconds`, checks what
the window produced against the plain reference, and prints one JSON
object as the last line of standard output (with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics and the trace's
breakdown).  The numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.  `--precision bf16`
runs the port's own bf16 path (the AL CLI's --speedup), a control whose
result must come out not correct.

Exits 2 without a result where CUDA is absent or has fewer cards than the
cell asks for, and 3 where the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache a run may fill sits in the checkout, at a fixed path
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--precision", choices=("f32", "bf16"), default="f32")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from benchmark import chip, core

    parts = core.load_spec(args.workload)
    chips = int(parts[1]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    result = core.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START,
                           precision=args.precision, spec_parts=parts,
                           log=log)
    # read after the window, so that the query stays out of set-up
    log(f"card: {chip.power_limit()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; precision {args.precision}")
    bad = core.forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures the port alone")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
