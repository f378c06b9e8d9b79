#!/usr/bin/env python3
"""Phase 7 of chip_smoke.py (the streaming AL loop) alone, several times,
each run in a fresh process, on one GPU: how often its streamed-vs-resident
check on retrained weights passes (ROADMAP C6).

    python3 scripts/c6_repeat.py [--root DIR] [--runs 3] [--log FILE]

--root is the checkout whose chip_smoke.py and vatl4pose_tpu_torch run
(default: the one holding this script), so an unpacked `git archive` of
another commit can be measured with the same script.  Each run prints one
JSON line: the shares within the bounds that streamed_vs_resident returns
on the seeded and on the retrained weights (kpts, samples decoded alike,
OKS, ...), the pretraining's final loss and accuracy, the phase's wall and
whether it passed.  The last line gathers the runs.  --log keeps each run's
whole output.  Exits 1 when any run failed its checks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _floats(obj):
    """Numbers, and dicts and lists of them; anything else (a model) is
    left out as None."""
    if isinstance(obj, dict):
        return {k: _floats(v) for k, v in obj.items()
                if _floats(v) is not None}
    if isinstance(obj, (list, tuple)):
        return [_floats(v) for v in obj]
    try:
        return float(obj)
    except (TypeError, ValueError):
        return None


def one_run(root):
    """Phase 7 in this process; prints the run's JSON line."""
    sys.path.insert(0, root)
    os.chdir(root)
    # as chip_smoke.main does: deterministic cuBLAS needs its workspace
    # fixed before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import chip_smoke as cs
    from vatl4pose_tpu_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("c6_repeat: CUDA is not available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    rec = {"card": card, "shares": {}, "pretrain": None}
    compare = cs.streamed_vs_resident

    def recorded(label, *a, **kw):
        cmp, failed = compare(label, *a, **kw)
        rec["shares"]["retrained" if "retrained" in label else "seeded"] = \
            dict(cmp, failed=len(failed))
        return cmp, failed
    cs.streamed_vs_resident = recorded
    # the pretraining of the phase (its last return value is kept)
    for name in ("pretrain", "stream_pretrain"):
        fn = getattr(cs, name, None)
        if fn is None:
            continue

        def kept(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            rec["pretrain"] = _floats(out)
            return out
        setattr(cs, name, kept)
    t0 = time.perf_counter()
    try:
        cs.phase_streaming_loop(card, 0)
        rec["passed"] = True
    except AssertionError as e:
        rec["passed"] = False
        rec["error"] = str(e)[:2000]
    rec["wall_s"] = time.perf_counter() - t0
    print("C6_RUN " + json.dumps(rec), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--log", default="")
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    root = os.path.abspath(a.root)
    if a.one:
        one_run(root)
        return 0
    runs = []
    for i in range(a.runs):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--root", root, "--one"],
                              capture_output=True, text=True)
        if a.log:
            with open(a.log, "a") as f:
                f.write(f"===== run {i} (rc {proc.returncode})\n"
                        + proc.stdout + proc.stderr)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("C6_RUN ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-3000:] + proc.stderr[-3000:])
            raise SystemExit(f"c6_repeat: run {i} exited {proc.returncode}")
        rec = json.loads(line[-1][len("C6_RUN "):])
        print(json.dumps(dict(rec, run=i)), flush=True)
        runs.append(rec)
    summary = {"root": root, "runs": len(runs),
               "passed": sum(r["passed"] for r in runs),
               "retrained_kpts": [r["shares"].get("retrained", {}).get("kpts")
                                  for r in runs],
               "retrained_alike": [r["shares"].get("retrained", {}).get(
                   "samples_decoded_alike") for r in runs],
               "retrained_oks": [r["shares"].get("retrained", {}).get("oks")
                                 for r in runs],
               "pretrain": [r["pretrain"] for r in runs]}
    print(json.dumps(summary))
    return 0 if summary["passed"] == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
