"""The `fastpose_dcn_r50.score` cell at a size that the CPU holds
(benchmark/tests/tiny.py): a sound run is correct, the control and an
altered answer are not; the configuration's FLOPs and K4's bound against
hand counts."""

import importlib
import time

import pytest
import torch

from benchmark import bounds, chip, core, dcn_bounds, faults
from benchmark.flops import forward_flops
from benchmark.tests.tiny import tiny_parts
from benchmark.video import make_video

CELL = "fastpose_dcn_r50.score"
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(parts, **kw):
    return core.run_cell(CELL, SEED, 0, False, time.perf_counter(),
                         device="cpu", spec_parts=parts, log=lambda *a: None,
                         **kw)


def test_sound_run_is_correct():
    res = run(tiny_parts(CELL))
    assert res["correct"], res["checks"]


def test_control_is_not_correct():
    parts = tiny_parts(CELL)
    cfg, traffic, limits = parts[2], parts[3], parts[4]
    driver = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}")
    video = make_video(traffic["video"], SEED, torch.device("cpu"))
    got = driver.control(cfg, traffic, video, SEED, torch.device("cpu"))
    assert any(got[k] > limits[k] for k in limits), got


def test_altered_answer_is_not_correct():
    res = run(tiny_parts(CELL), fault=faults.answer_altered)
    assert not res["correct"], res["checks"]


def test_forward_flops_equal_the_hand_count():
    """12.00 GFLOP a sample at 256x192: the SE-ResNet-50 backbone 8.00
    (its 13 deformable 3x3s 2.94), the DUC head 3.74, the offset
    convolutions 0.25 (2 a multiply-add)."""
    cfg = core.load_spec(CELL)[2]
    macs_dcn = sum(h * w * 9 * c * c for c, h, w, n in
                   ((128, 32, 24, 4), (256, 16, 12, 6), (512, 8, 6, 3))
                   for _ in range(n))
    macs_off = sum(h * w * 9 * c * 18 for c, h, w, n in
                   ((128, 32, 24, 4), (256, 16, 12, 6), (512, 8, 6, 3))
                   for _ in range(n))
    assert 2 * macs_dcn / 1e9 == pytest.approx(2.94, abs=5e-3)
    assert 2 * macs_off / 1e9 == pytest.approx(0.25, abs=5e-3)
    assert forward_flops(cfg) / 1e9 == pytest.approx(12.00, rel=0.01)


def test_k4_bound_of_one_convolution_by_hand():
    """Stage 2's strided block at 256x192 and a chunk of 512: columns
    128 x 9 x 32 x 24 f32 a sample written once (3.54 MB), its 128 x 64 x
    48 input and 18 x 32 x 24 offsets read once."""
    convs = dcn_bounds.dcn_convs(core.load_spec(CELL)[2])
    assert len(convs) == 13
    assert convs[0] == (128, 64, 48, 32, 24, 2, 1, False)
    assert convs[1] == (128, 32, 24, 32, 24, 1, 1, False)
    assert convs[-1] == (512, 8, 6, 8, 6, 1, 1, False)
    per_sample = 4 * (128 * 9 * 32 * 24 + 128 * 64 * 48 + 18 * 32 * 24)
    assert per_sample == 3_538_944 + 1_572_864 + 55_296
    assert dcn_bounds.k4_bytes(512, convs[0]) == 512 * per_sample
    assert dcn_bounds.k4_bound_s(512, convs[:1]) == pytest.approx(
        512 * per_sample / chip.HBM_BYTES_PER_S)
    # the 13 at a chunk: 27.4 MB of columns a sample, ~5.0 ms
    cols = sum(4 * c * 9 * ho * wo for c, _, _, ho, wo, _, _, _ in convs)
    assert cols / 1e6 == pytest.approx(27.4, abs=0.05)
    assert dcn_bounds.k4_bound_s(512, convs) * 1e3 == pytest.approx(
        5.0, abs=0.1)


def test_k1_runs_on_stage_one_tail_only():
    """The configuration's stages 2-4 are deformable: of the four tails
    `bounds.resnet_tails` counts, K1 runs the first alone, so
    k1_roofline.score does not list this cell."""
    spec, _, cfg, _, _ = core.load_spec(CELL)
    assert cfg["MODEL"]["STAGE_WITH_DCN"] == [False, True, True, True]
    assert len(bounds.resnet_tails(50, (256, 192))) == 4
    k1 = {m["name"]: m for m in spec["per_layer"]}["k1_roofline.score"]
    assert CELL not in k1["workloads"]
