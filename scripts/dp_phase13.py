#!/usr/bin/env python3
"""Phase 13 of chip_smoke.py (data parallel: two gloo ranks sharing one
GPU) alone, with the phases it needs before it: the kernels' build and
phase 3's video (phase 1), and phase 5's DUW loop, whose round 0 step 1
and the DP loop are held against.

    python3 scripts/dp_phase13.py

Prints each phase's lines as chip_smoke.py does, each step's wall time,
and as its last line one JSON object with the phase's numbers (the DP
step's and all-reduce's ms, the DP pass's samples/s, the DP loop's wall
and split).  Exits 1 when a step failed its checks; the next steps run
all the same, but the loop, which needs step 1's round 0.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("dp_phase13: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.phase_card_and_build()
    video = cs.make_video(0)
    cs.phase_al_loop(video, card, 0)
    out, failed, box = {}, [], {}

    def noop():
        summary, box["round0"] = cs.phase_dp_noop(video, 0, card)
        return summary
    for name, fn in (("noop", noop),
                     ("steps", lambda: cs.phase_dp_steps(video, card, 0)),
                     ("loop", lambda: cs.phase_dp_loop(video, 0, card,
                                                       box["round0"]))):
        if name == "loop" and "round0" not in box:
            failed.append("loop (no round 0 from step 1)")
            continue
        t0 = time.perf_counter()
        try:
            out[name] = fn()
        except AssertionError as e:
            failed.append(name)
            print(f"{name} FAILED: {e}", flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(dict(out, failed=failed), default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
