"""The port's AL loop (vatl4pose_tpu_torch/al/active_learning.py and
cli/run_active_learning.py) against the JAX package's on the CPU.

Both run the DUW strategy (THC+WPU, Influence, Coreset, continual) on the
tiny config of tests/test_e2e.py (R18 at 64x64, a 10-sample synthetic
video, QUERY_RATIO [0.2, 0.5, 1.0]) from the same numpy Flax `.pkl`
weights, for the estimator and the AE.  RETRAIN.ALPHA is 3 (tests/
test_e2e.py has 1, which with random weights rounds every round's retrain
to 0 epochs), so each round retrains 2 epochs.  The query sets of every
round and the percentages must be equal.  AP and OSPA agree within 1e-6
in round 0, where only the folded-BN chain that the port serves (the JAX
package serves the unfused graph in parity mode) tells the two apart.
After a retrain they agree within 0.02: the retrained weights differ by
AdamW's sign-like first steps on tiny gradients (tests/test_torch_train.py
bounds them), and the argmax of these random weights' near-flat heatmaps
moves by whole heatmap pixels under such differences.
"""

import copy
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_models import random_flax_variables
from vatl4pose_tpu.al import selection as jsel
from vatl4pose_tpu.al.active_learning import ActiveLearning as JaxAL
from vatl4pose_tpu.cli import run_active_learning as jax_cli
from vatl4pose_tpu.config import Cfg as JaxCfg
from vatl4pose_tpu.data.synthetic import make_synthetic_video
from vatl4pose_tpu.models import build_sppe as jax_build_sppe
from vatl4pose_tpu.models import build_wholebody_ae as jax_build_ae
from vatl4pose_tpu_torch.al import ActiveLearning
from vatl4pose_tpu_torch.cli import run_active_learning as cli
from vatl4pose_tpu_torch.config import Cfg

torch.set_num_threads(1)
STRATEGY = "THC+WPU+Influence_Coresetfilter"
TOL_ROUND0, TOL = 1e-6, 0.02


def cfg_dict(root, ann, pretrained, ae_root):
    return {
        "DATASET": {
            "TRAIN": {"TYPE": "Posetrack21", "ROOT": root, "ANN": ann,
                      "IMG_PREFIX": "",
                      "AUG": {"FLIP": False, "ROT_FACTOR": 40,
                              "SCALE_FACTOR": 0.3,
                              "NUM_JOINTS_HALF_BODY": 8,
                              "PROB_HALF_BODY": -1}},
            "EVAL": {"TYPE": "Posetrack21", "ROOT": root, "ANN": ann,
                     "IMG_PREFIX": ""},
        },
        "DATA_PRESET": {"TYPE": "simple", "SIGMA": 2, "NUM_JOINTS": 17,
                        "IMAGE_SIZE": [64, 64], "HEATMAP_SIZE": [16, 16]},
        "MODEL": {"TYPE": "SimplePose", "PRETRAINED": pretrained,
                  "TRY_LOAD": "", "NUM_DECONV_FILTERS": [64, 64, 64],
                  "NUM_LAYERS": 18},
        "LOSS": {"TYPE": "MSELoss"},
        "AE": {"Z_DIM": 4, "PRETRAINED_ROOT": ae_root, "EPOCH": 1,
               "LR": 8e-5},
        "AUXNET": {"PRETRAINED_ROOT": "", "EPOCH": 1, "LR": 8e-5},
        "RETRAIN": {"BATCH_SIZE": 8, "BASE": 1, "OPTIMIZER": "AdamW",
                    "LR": 2.5e-4, "ALPHA": 3, "WEIGHT_DECAY": 0.7,
                    "LR_GAMMA": 0.99},
        "VAL": {"FINISH_ACC": 1, "BATCH_SIZE": 16, "W_UNC": 0.01,
                "UNC_LAMBDA": 0.01, "QUERY_RATIO": [0.2, 0.5, 1.0],
                "VIS": False},
    }


class Opt:
    def __init__(self, work_dir, **kw):
        self.uncertainty = "THC+WPU"
        self.representativeness = "Influence"
        self.filter = "Coreset"
        self.strategy = STRATEGY
        self.video_id = "000001"
        self.cfg = "tiny"
        self.work_dir = work_dir
        self.seed = 166
        self.retrain_thresh = 1.0
        self.continual = True
        self.onebyone = False
        self.from_scratch = False
        self.THCvsWPU = "const"
        self.fixed_lambda = False
        self.optimize = False
        self.device = "cpu"
        self.__dict__.update(kw)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The video and the shared weights: a SimplePose-R18 and a WholeBodyAE
    drawn with numpy (He-scaled, random BN statistics), pickled as Flax
    variable trees."""
    tmp = tmp_path_factory.mktemp("al")
    root, ann = make_synthetic_video(str(tmp / "video"), num_frames=5,
                                     num_persons=2, width=160, height=128)
    rng = np.random.default_rng(2024)
    base = cfg_dict(root, ann, "", "")
    model = jax_build_sppe(JaxCfg(base["MODEL"]), JaxCfg(base["DATA_PRESET"]),
                           train=True)
    pretrained = str(tmp / "simplepose_r18.pkl")
    with open(pretrained, "wb") as f:
        pickle.dump(random_flax_variables(model, jnp.zeros((1, 64, 64, 3)),
                                          rng), f)
    ae_root = str(tmp / "ae")
    os.makedirs(os.path.join(ae_root, "Hybrid"))
    with open(os.path.join(ae_root, "Hybrid", "WholeBodyAE_zdim4.pkl"),
              "wb") as f:
        pickle.dump(random_flax_variables(jax_build_ae({"Z_DIM": 4}),
                                          jnp.zeros((1, 38)), rng), f)
    return tmp, cfg_dict(root, ann, pretrained, ae_root)


def run(al):
    while True:
        al.eval_and_query()
        result = al.outcome()
        if result is not None:
            return result


@pytest.fixture(scope="module")
def port_run(setup):
    tmp, cfg = setup
    opt = Opt(str(tmp / "port"))
    return opt, run(ActiveLearning(Cfg(copy.deepcopy(cfg)), opt))


def test_duw_loop_matches_jax(setup, port_run):
    tmp, cfg = setup
    opt, got = port_run
    jopt = Opt(str(tmp / "jax"))
    want = run(JaxAL(JaxCfg(copy.deepcopy(cfg)), jopt))

    # every round's query set, and every sample queried exactly once
    assert list(got[3]) == list(want[3]) == ["Round0", "Round1", "Round2"]
    for rc in want[3]:
        assert set(got[3][rc]) == set(want[3][rc]), rc
    assert sorted(q for qs in got[3].values() for q in qs) == list(range(10))
    assert got[0] == want[0] == [0.0, 20.0, 50.0, 100.0]      # percentages
    for i in (1, 2):                                           # AP dicts
        for r, (a, b) in enumerate(zip(got[i], want[i])):
            assert list(a) == list(b)
            np.testing.assert_allclose(list(a.values()), list(b.values()),
                                       rtol=0, atol=TOL if r else TOL_ROUND0)
    for i in (17, 18):                                         # OSPA
        np.testing.assert_allclose(got[i][0], want[i][0], rtol=0,
                                   atol=TOL_ROUND0)
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=TOL)
    assert got[2][-1]["AP"] == 1.0 and got[18][-1] < 1e-6     # all GT at 100%
    assert got[14:17] == want[14:17]                          # stopping
    # the same result.json fields
    paths = []
    for mod, o, res in ((cli, opt, got), (jax_cli, jopt, want)):
        paths.append(mod.save_result(Cfg(cfg), o, res))
    keys = [list(json.load(open(p))) for p in paths]
    assert keys[0] == keys[1] and len(keys[0]) == 24
    # one cycle_times.jsonl line per cycle: a score+select and a retrain
    # line per round, the final evaluation's
    lines = [json.loads(x) for x in
             open(os.path.join(opt.work_dir, "cycle_times.jsonl"))]
    assert len(lines) == 7
    assert {k for c in lines for k in c["phases"]} == {
        "score", "map_ospa", "select", "retrain"}


def test_resume_matches_uninterrupted(setup, port_run):
    """Round 0, save_state, a new orchestrator, load_state, the rest: the
    same query lists and curves as the uninterrupted run."""
    tmp, cfg = setup
    _, want = port_run
    opt = Opt(str(tmp / "resume"))
    al = ActiveLearning(Cfg(copy.deepcopy(cfg)), opt)
    al.eval_and_query()
    assert al.outcome() is None
    state = al.save_state()
    del al
    got = run(ActiveLearning(Cfg(copy.deepcopy(cfg)), opt).load_state(state))
    assert got[3] == want[3]
    assert got[0] == want[0]
    assert got[1] == want[1] and got[17] == want[17]


def test_cli_main_synthetic_writes_result(tmp_path, monkeypatch):
    """main() through the YAML config path, --synthetic, --from_scratch,
    on the CPU; a comma-separated video list runs each video."""
    tiny = cfg_dict("", "", "", "")
    tiny["AE"]["EPOCH"] = 1
    import yaml
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(tiny))
    monkeypatch.chdir(tmp_path)
    cli.main(["--cfg", str(path), "--video_id", "000001,000002",
              "--uncertainty", "THC+WPU", "--representativeness",
              "Influence", "--filter", "Coreset", "--continual",
              "--seedfix", "--synthetic", "--from_scratch", "--device",
              "cpu", "--synth_frames", "3", "--synth_persons", "2",
              "--synth_size", "96", "80", "--checkpoint_state"])
    base = tmp_path / "exp" / "AL_test" / "SimplePose" / STRATEGY
    results = sorted(base.glob("000001,000002/*/*/result.json"))
    assert [p.parent.name for p in results] == ["000001", "000002"]
    for p in results:
        rj = json.load(open(p))
        assert rj["percentages"][-1] == 100.0 and len(rj) == 24
        assert sorted(q for qs in rj["query_list"].values() for q in qs) \
            == list(range(6))
        assert (p.parent / "al_state.pkl").exists()


def test_data_parallel_on_one_rank_is_a_noop(setup, monkeypatch):
    """--data_parallel without torchrun (WORLD_SIZE unset) does nothing,
    as the JAX package's does on one device: no mesh, and round 0's
    scores and query list those of a run without the flag, bit for
    bit."""
    tmp, cfg = setup
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    rounds = []
    for dp in (True, False):
        al = ActiveLearning(Cfg(copy.deepcopy(cfg)),
                            Opt(str(tmp / f"dp_{dp}"), data_parallel=dp))
        assert al.mesh is None and al.primary
        al.eval_and_query()
        rounds.append((al.uncertainty_dict["Round0"],
                       al.query_list_list["Round0"]))
    assert rounds[0] == rounds[1]


@pytest.mark.parametrize("flt", ["K-Means", "weighted"])
def test_kmeans_filter_options_match_jax(setup, flt):
    """The loop's K-Means and weighted filters (_apply_filter) against the
    JAX package's selection as its loop calls it (ActiveLearning.py
    :541-552 of the JAX package: the weighted filter's weights
    1 + W_UNC * combine_weight * total score, dedupe, and the query-size
    clamps), on the same seeded embeddings: the same picks."""
    tmp, cfg = setup
    al = ActiveLearning(Cfg(copy.deepcopy(cfg)),
                        Opt(str(tmp / f"f_{flt}"), filter=flt))
    rng = np.random.default_rng(31)
    emb = np.maximum(rng.normal(0, 1, (10, 512)), 0).astype(np.float32)
    emb[7] = emb[2]                                  # a repeated embedding
    unlabeled = [0, 2, 3, 5, 6, 7, 8, 9]
    total = rng.uniform(0, 1, len(unlabeled))
    for query_size, want_size in ((3, 3), (9, 8)):
        al.query_size = query_size
        got = al._apply_filter(sorted(unlabeled), total, emb, 0.4, unlabeled)
        kw = dict(weight=1 + cfg["VAL"]["W_UNC"] * 0.4 * total,
                  dedupe=True) if flt == "weighted" else {}
        assert al.query_size == want_size
        assert got == jsel.kmeans_filter(emb, sorted(unlabeled), want_size,
                                         **kw)
        assert set(got) <= set(unlabeled) and len(set(got)) == len(got)


def test_speedup_loop_runs_to_the_end(setup):
    """--speedup on the CPU: bf16 serving through the folded chain and the
    bf16 retrainer, through the whole DUW loop; the served model's master
    weights stay f32 between rounds, every sample is queried once, the
    percentages rise to 100 and the scores are finite."""
    tmp, cfg = setup
    al = ActiveLearning(Cfg(copy.deepcopy(cfg)),
                        Opt(str(tmp / "speedup"), speedup=True))
    assert al.speedup and al.engine.cfg.bf16 and al.retrainer.bf16
    got = run(al)
    assert {p.dtype for p in al.model.parameters()} == {torch.float32}
    assert sorted(q for qs in got[3].values() for q in qs) == list(range(10))
    assert got[0] == [0.0, 20.0, 50.0, 100.0]
    assert np.isfinite([r["AP"] for r in got[1]]).all()
    assert all(np.isfinite(list(u.values())).all()
               for u in got[4].values())


def test_optimize_matches_jax(setup, monkeypatch):
    """--optimize's study (run_study; the JAX package's optimize_alc, its
    Study.optimize held to the same 2 trials): the grid's first two
    UNC_LAMBDA values, each an HP + Coreset loop over the video with
    QUERY_RATIO [0.05, 0.1, 0.2, 0.3, 0.4, 1].  The same trial params and
    the same best params; the ALCs (AP .95 with annotations, x100) within
    1e-4.  RETRAIN.ALPHA 0 keeps the estimator as it is (the study's
    objective is the loop, whatever it retrains), so that the test stays
    short; so the APs are round 0's, which the DUW test holds to 1e-6."""
    from vatl4pose_tpu.al import optuna_lite as jax_optuna
    tmp, cfg = setup
    cfg = copy.deepcopy(cfg)
    cfg["RETRAIN"]["ALPHA"] = 0
    base = dict(uncertainty="HP", representativeness="None",
                filter="Coreset", strategy="HP_Coresetfilter",
                optimize=True, synthetic=True, search="grid")
    orig = jax_optuna.Study.optimize
    monkeypatch.setattr(jax_optuna.Study, "optimize",
                        lambda self, f, n_trials: orig(self, f, 2))
    jopt = Opt(str(tmp / "opt_jax"), **base)
    want = jax_cli.optimize_alc(JaxCfg(copy.deepcopy(cfg)), jopt, ["000001"])
    opt = Opt(str(tmp / "opt_port"), **base)
    got = cli.run_study(Cfg(copy.deepcopy(cfg)), opt, ["000001"], n_trials=2)
    assert [p for _, p, _ in got.history()] \
        == [p for _, p, _ in want.history()] \
        == [{"unc_lambda": 0.001}, {"unc_lambda": 0.01}]
    assert got.best_params == want.best_params
    np.testing.assert_allclose([v for _, _, v in got.history()],
                               [v for _, _, v in want.history()], rtol=0,
                               atol=1e-4)


def test_weights_and_device_are_never_guessed(setup, monkeypatch):
    """A missing or empty MODEL.PRETRAINED or AE root raises (no random
    fallback); frames over the budget stay in host RAM (streaming), never
    on the device; no device means CUDA."""
    tmp, base = setup
    cases = [(("MODEL", "PRETRAINED"), str(tmp / "none.pth"),
              FileNotFoundError),
             (("MODEL", "PRETRAINED"), "", ValueError),
             (("AE", "PRETRAINED_ROOT"), str(tmp / "none"),
              FileNotFoundError)]
    for (sec, key), value, exc in cases:
        cfg = copy.deepcopy(base)
        cfg[sec][key] = value
        with pytest.raises(exc):
            ActiveLearning(Cfg(cfg), Opt(str(tmp / "y")))
    cfg = copy.deepcopy(base)
    cfg["VAL"]["HBM_FRAME_BUDGET_GB"] = 1e-6
    al = ActiveLearning(Cfg(cfg), Opt(str(tmp / "y")))
    assert al.streaming and al.frames_dev is None
    assert al.frame_store.total_bytes > 1e-6 * 2 ** 30
    assert not ActiveLearning(Cfg(copy.deepcopy(base)),
                              Opt(str(tmp / "y2"))).streaming
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ActiveLearning(Cfg(copy.deepcopy(base)),
                       Opt(str(tmp / "z"), device=None))
