#!/usr/bin/env python3
"""How far the port's bf16 train step sits from the JAX package's, in
units of the JAX package's own bf16-vs-f32 gap, on the inputs of
tests/test_torch_train.py::test_bf16_step_follows_jax_casting (one AdamW
step of a He-scaled R18 at 64x64, batch 8), on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/bf16_step_gap.py

Runs the steps twice, each in a process of its own: with XLA's defaults,
and with XLA_FLAGS=--xla_allow_excess_precision=false, under which XLA
rounds to bf16 wherever the JAX program casts (by default it may keep f32
values between ops).  For each, one JSON line: the loss, the parameters
(weights and BN affine) and the BN running statistics of the port's bf16
step, of the port's f32 step (the control) and of the JAX f32 step, each
as its distance from the JAX bf16 step over the JAX bf16-vs-f32 gap, and
the port's bf16 step from the port's f32 step over the same gap.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def measure():
    sys.path.insert(0, str(ROOT))
    from tests.test_torch_train import (Cfg, bf16_steps, build_dataset,
                                        make_synthetic_video)
    with tempfile.TemporaryDirectory() as tmp:
        root, ann = make_synthetic_video(tmp, num_frames=4, num_persons=2,
                                         width=160, height=128)
        ds = build_dataset(Cfg({"TYPE": "Posetrack21", "ROOT": root,
                                "ANN": ann, "IMG_PREFIX": ""}))
        loss, state = bf16_steps((ds, ds.load_frames()))

    def dist(a, b, stats):
        return sum(float(((a[k].double() - b[k].double()) ** 2).sum())
                   for k in a if "num_batches" not in k
                   and ("running" in k) == stats) ** 0.5

    ref, ref32 = ("jax", True), ("jax", False)
    out = {"XLA_FLAGS": os.environ.get("XLA_FLAGS", "")}
    out["loss"] = {str(k): abs(loss[k] - loss[ref])
                   / abs(loss[ref32] - loss[ref])
                   for k in (("port", True), ("port", False), ref32)}
    for what, stats in (("params", False), ("bn_stats", True)):
        gap = dist(state[ref], state[ref32], stats)
        row = {str(k): dist(state[k], state[ref], stats) / gap
               for k in (("port", True), ("port", False), ref32)}
        row["port bf16 from port f32"] = dist(
            state["port", True], state["port", False], stats) / gap
        out[what] = row
    return out


def main():
    if "--child" in sys.argv:
        print(json.dumps(measure()))
        return 0
    rc = 0
    for flags in ("", "--xla_allow_excess_precision=false"):
        env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, __file__, "--child"], env=env,
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        print(lines[-1] if lines else proc.stderr[-2000:])
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
