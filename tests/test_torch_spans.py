"""The port's spans (vatl4pose_tpu_torch/utils/profiling.py): free while
nothing listens, torch.profiler ranges around the work they name, kept
and summed by the AL loop's CycleTimer, and placed at the scoring engine's
and the Retrainer's layer boundaries, in order."""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
from vatl4pose_tpu_torch.cli import run_active_learning as cli
from vatl4pose_tpu_torch.models import SimplePose, WholeBodyAE
from vatl4pose_tpu_torch.train import Retrainer
from vatl4pose_tpu_torch.utils import profiling
from vatl4pose_tpu_torch.utils.profiling import CycleTimer, span

torch.set_num_threads(1)
N, F, H, W = 8, 3, 96, 128
INPUT, HM = (64, 64), (16, 16)


@pytest.fixture
def counted(monkeypatch):
    """Counts of the clock reads and record_function ranges that spans
    make."""
    n = {"clock": 0, "range": 0}
    clock, rf = profiling.time.perf_counter_ns, torch.profiler.record_function

    def perf_counter_ns():
        n["clock"] += 1
        return clock()

    def record_function(name):
        n["range"] += 1
        return rf(name)

    monkeypatch.setattr(profiling.time, "perf_counter_ns", perf_counter_ns)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return n


def test_span_off_reads_no_clock_and_opens_no_range(counted):
    assert profiling._recorder is None
    with span("off.outer"), span("off.inner"):
        torch.ones(3).sum()
    assert counted == {"clock": 0, "range": 0}
    # the counters see what a listening span does
    timer = CycleTimer()
    timer.start_cycle(0)
    with span("on.cycle"):
        pass
    timer.end_cycle()
    assert counted == {"clock": 2, "range": 0}
    with profile(activities=[ProfilerActivity.CPU]):
        with span("on.profiler"):
            pass
    assert counted == {"clock": 2, "range": 1}
    assert profiling._recorder is None


def _events(fn, prefix):
    """fn() under torch.profiler (CPU): every host event, and those whose
    name starts with `prefix`, as (name, start ns, end ns) by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ev = sorted(((e.name(), e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()),
                key=lambda e: e[1])
    return ev, [e for e in ev if e[0].startswith(prefix)]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_encloses_the_operations_run_inside_it():
    def work():
        x = torch.arange(64.0).reshape(8, 8)
        with span("test.block"):
            (x @ x).relu().sum()
        x.amax()

    ev, (block,) = _events(work, "test.")
    ops = {}
    for e in ev:
        ops.setdefault(e[0], []).append(e)
    inside = ops["aten::mm"] + ops["aten::relu"] + ops["aten::sum"]
    assert all(_inside(e, block) for e in inside)
    assert all(e[1] >= block[2] for e in ops["aten::amax"])


def test_cycle_spans_sum_self_time_by_name(monkeypatch):
    """Self time is a span's duration less what its children cover."""
    ticks = iter([0, 10, 40, 50, 60, 100, 200, 230])
    monkeypatch.setattr(profiling.time, "perf_counter_ns",
                        lambda: next(ticks))
    timer = CycleTimer()
    timer.start_cycle(3)
    rec = profiling._recorder
    with timer.phase("score"):              # 0 .. 100
        with span("x.child"):               # 10 .. 40
            pass
        with span("x.child"):               # 50 .. 60
            pass
    with span("x.other"):                   # 200 .. 230
        pass
    assert rec.totals() == {
        "al.score": {"n": 1, "s": 100e-9, "self_s": 60e-9},
        "x.child": {"n": 2, "s": 40e-9, "self_s": 40e-9},
        "x.other": {"n": 1, "s": 30e-9, "self_s": 30e-9}}


def _frames():
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.integers(0, 255, (F, H, W, 3), np.uint8))


def _boxes(rng):
    x0 = rng.uniform(0, W / 2, N)
    y0 = rng.uniform(0, H / 2, N)
    return np.stack([x0, y0, x0 + rng.uniform(20, W / 2, N),
                     y0 + rng.uniform(30, H / 2, N)], 1).astype(np.float32)


def _model():
    torch.manual_seed(0)
    return SimplePose(num_joints=17, num_layers=18, deconv_dim=(16, 16, 16),
                      device="cpu")


def test_retrain_call_spans_in_order():
    rng = np.random.default_rng(1)
    boxes = _boxes(rng)
    joints = boxes[:, None, :2] + rng.uniform(0, 20, (N, 17, 2))
    data = types.SimpleNamespace(
        bboxes=boxes, joints_xy=joints.astype(np.float32),
        joints_vis=np.ones((N, 17), np.float32),
        frame_idx=np.arange(N) % F)
    tr = Retrainer(_model(), {"OPTIMIZER": "AdamW", "LR": 1e-4,
                              "BATCH_SIZE": 3, "WEIGHT_DECAY": 0.0},
                   "SimplePose", input_size=INPUT, hm_size=HM, seed=5,
                   device="cpu")
    frames = _frames()
    _, spans = _events(lambda: tr.retrain(data, frames, np.arange(7), 2,
                                          (W, H)), "retrain.")
    steps = 2 * 3                           # 2 epochs of ceil(7 / 3)
    assert [n for n, _, _ in spans] == \
        ["retrain.call", "retrain.geometry", "retrain.upload"] \
        + ["retrain.step"] * steps + ["retrain.stats"]
    call, rest = spans[0], spans[1:]
    assert all(_inside(s, call) for s in rest)
    assert all(a[2] <= b[1] for a, b in zip(rest, rest[1:]))


def test_scoring_pass_spans_nest():
    rng = np.random.default_rng(2)
    boxes = _boxes(rng)
    ae = WholeBodyAE(device="cpu")
    engine = ScoringEngine(_model(), ScoringConfig(uncertainty="THC+WPU",
                                                   input_size=INPUT),
                           ae_model=ae, chunk=N // 2, device="cpu")
    xywh = np.concatenate([boxes[:, :2], boxes[:, 2:] - boxes[:, :2]], 1)
    gt = np.concatenate([boxes[:, None, :2] + rng.uniform(0, 20, (N, 17, 2)),
                         np.ones((N, 17, 1))], -1).reshape(N, -1)
    prev = np.arange(N) % 2 == 1
    args = (_frames(), np.arange(N) % F, boxes, gt.astype(np.float32), xywh,
            prev, np.roll(prev, -1))
    _, spans = _events(lambda: engine.score(*args, keep_heatmaps=False),
                       "score.")
    names = [n for n, _, _ in spans]
    assert names == ["score.pass", "score.stage1", "score.chunk",
                     "score.chunk", "score.stage2", "score.fetch"]
    pass_, stage1, c1, c2, stage2, fetch = spans
    assert all(_inside(s, pass_) for s in spans[1:])
    assert _inside(c1, stage1) and _inside(c2, stage1)
    assert stage1[2] <= stage2[1] and stage2[2] <= fetch[1]


def test_cycle_times_line_keeps_phases_and_gains_spans(tmp_path,
                                                       monkeypatch):
    """The DUW loop (THC+WPU, so the AE is fine-tuned every round): every
    line keeps its phases, each the time of its al.* span, and lists the
    round's spans, self time never above the total."""
    from tests.test_torch_al import cfg_dict
    import yaml
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg_dict("", "", "", "")))
    monkeypatch.chdir(tmp_path)
    cli.main(["--cfg", str(path), "--video_id", "000001", "--uncertainty",
              "THC+WPU", "--representativeness", "Influence", "--filter",
              "Coreset", "--continual", "--seedfix", "--synthetic",
              "--from_scratch", "--device", "cpu", "--synth_frames", "3",
              "--synth_persons", "2", "--synth_size", "96", "80"])
    (log,) = tmp_path.glob("exp/**/cycle_times.jsonl")
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert {k for c in lines for k in c["phases"]} == {
        "score", "map_ospa", "select", "retrain"}
    for c in lines:
        assert list(c) == ["round", "phases", "total_s", "spans"]
        sp = c["spans"]
        assert c["phases"] == {k[3:]: v["s"] for k, v in sp.items()
                               if k.startswith("al.")}
        for v in sp.values():
            assert v["n"] >= 1 and 0 <= v["self_s"] <= v["s"]
        if "score" in c["phases"]:
            assert {"score.pass", "score.stage1", "score.chunk",
                    "score.stage2", "score.fetch", "eval.map",
                    "eval.ospa"} <= set(sp)
            assert sp["eval.map"]["n"] == sp["eval.ospa"]["n"] == 2
    retrains = [c["spans"] for c in lines if "retrain" in c["phases"]]
    assert retrains and all("ae.finetune" in sp for sp in retrains)
    assert any("retrain.call" in sp for sp in retrains)
    for sp in retrains:
        if "retrain.call" in sp:
            assert {"retrain.geometry", "retrain.upload", "retrain.step",
                    "retrain.stats"} <= set(sp)
