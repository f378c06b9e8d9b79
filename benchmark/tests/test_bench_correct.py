"""The comparison that decides `correct`, driven through whole runs at a
size that the CPU holds (benchmark/tests/tiny.py), with the cells'
limits: a sound run passes; the control, the port's bf16 path and each
planted fault fail.  The control at each cell's own size runs on the
card only (marker `cuda`)."""

import importlib
import time

import pytest
import torch

from benchmark import core, faults
from benchmark.tests.tiny import tiny_parts
from benchmark.video import make_video

CELLS = ["simplepose_r50.score", "hrnet_w32.score",
         "simplepose_r50.retrain", "hrnet_w32.retrain"]
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload, parts, seed=SEED, **kw):
    return core.run_cell(workload, seed, 0, False, time.perf_counter(),
                         device="cpu", spec_parts=parts, log=lambda *a: None,
                         **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = run(workload, tiny_parts(workload))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    parts = tiny_parts(workload)
    cfg, traffic, limits = parts[2], parts[3], parts[4]
    driver = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}")
    video = make_video(traffic["video"], SEED, torch.device("cpu"))
    got = driver.control(cfg, traffic, video, SEED, torch.device("cpu"))
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.parametrize("workload", ["simplepose_r50.score",
                                      "hrnet_w32.retrain"])
def test_port_bf16_is_not_correct(workload):
    res = run(workload, tiny_parts(workload), precision="bf16")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload,fault", [
    ("simplepose_r50.score", faults.answer_altered),
    ("simplepose_r50.retrain", faults.half_batch),
    # at this size SimplePose's padded batch (2 real rows of 8) moves
    # the loss by about 1% on this seed, under its cell's limit; on
    # HRNet it is caught, as on both cells at their own size
    ("hrnet_w32.retrain", faults.all_valid),
    ("simplepose_r50.retrain", faults.state_unchanged)])
def test_fault_underneath_is_not_correct(workload, fault):
    res = run(workload, tiny_parts(workload), fault=fault)
    assert not res["correct"], res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_at_cell_size(card, workload):
    """python -m pytest benchmark/tests -m cuda, on the card."""
    parts = core.load_spec(workload)
    cfg, traffic, limits = parts[2], parts[3], parts[4]
    driver = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}")
    for seed in (SEED, SEED + 1, SEED + 2):
        video = make_video(traffic["video"], seed, card)
        got = driver.control(cfg, traffic, video, seed, card)
        assert any(got[k] > limits[k] for k in limits), (seed, got)
