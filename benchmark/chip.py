"""The card: its published peaks and what it says of itself.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the full
700 W power limit): 989 TFLOP/s in bf16, 495 in TF32 on the tensor cores,
67 in float32 on the CUDA cores, 3.35 TB/s of HBM3."""

from __future__ import annotations

import subprocess

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the card, or "" where it
    cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
