"""A cell of the benchmark cut to a size that the CPU tests can hold: the
configuration's widths and depth as published, a 96x64 input (HRNet and
ResNet need sides that are multiples of 32), batch 8, a 6-frame video of
5 tracks at 160x120 and 26 labeled rows."""

from __future__ import annotations

import copy

from benchmark import core


def tiny_parts(workload):
    spec, cell, cfg, traffic, limits = core.load_spec(workload)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["DATA_PRESET"]["IMAGE_SIZE"] = [96, 64]
    cfg["DATA_PRESET"]["HEATMAP_SIZE"] = [24, 16]
    cfg["RETRAIN"]["BATCH_SIZE"] = 8
    traffic["video"].update(frames=6, persons=5, width=160, height=120)
    if "labeled" in traffic:
        traffic["labeled"] = 26
    return spec, cell, cfg, traffic, limits
