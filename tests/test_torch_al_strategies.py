"""The port's AL loop on the paper's other strategies against the JAX
package's, on the CPU: MPE with the K-Means filter and VL4Pose with the
weighted filter, on configs/synthetic/al_simple_synthetic.yaml (R18 at
128x96, 32x24 maps: room for several peaks 6 px apart inside the 5-px
border) over a 10-sample synthetic video, from the same numpy Flax `.pkl`
weights, with two cuts that keep every round's retrain (RETRAIN.ALPHA 2,
one epoch a round): deconv 256 -> 64 and RETRAIN.BATCH_SIZE 16 -> 4.  The
JAX package's retrain runs a 16-step scan whatever the real step count,
and at batch 16 it takes 80-120 s a round on the CPU; at batch 4 it takes
11-17 s.  The JAX loop inits its AuxNet from PRNGKey(318); the port's own
init draws other bits, so the JAX init is carried into the port's AuxNet
(state_dict_from_flax) before the loop starts.

Every round's query list must be equal, in order.  Round 0's scores
agree within 1e-5 (rtol: f32 sums in another order).  A retrain moves the
two loops' weights apart by AdamW's sign-like first steps on tiny
gradients (tests/test_torch_train.py bounds them), and a peak that moves
by a heatmap pixel moves a sample's score by up to a third (ROADMAP C5).
So after the first retrain at least 8 of the 10 scores agree within 1e-4
(measured: MPE 10 within 4.4e-6, VL4Pose 8 within 4.4e-5, its other two
1.2e-2 and 0.35 apart); after the second only the query lists are held
(MPE up to 0.10 apart, VL4Pose up to 0.32)."""

import copy
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from tests.test_torch_al import Opt, run
from tests.test_torch_models import random_flax_variables
from vatl4pose_tpu.al.active_learning import ActiveLearning as JaxAL
from vatl4pose_tpu.config import Cfg as JaxCfg
from vatl4pose_tpu.data.synthetic import make_synthetic_video
from vatl4pose_tpu.models import build_sppe as jax_build_sppe
from vatl4pose_tpu_torch.al import ActiveLearning
from vatl4pose_tpu_torch.config import Cfg
from vatl4pose_tpu_torch.models import state_dict_from_flax

torch.set_num_threads(1)
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "synthetic", "al_simple_synthetic.yaml")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The config with the video's paths and a He-scaled R18 (random BN
    statistics) pickled as a Flax variable tree."""
    tmp = tmp_path_factory.mktemp("al_strategies")
    root, ann = make_synthetic_video(str(tmp / "video"), num_frames=5,
                                     num_persons=2, width=160, height=128)
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    for split in ("TRAIN", "EVAL"):
        cfg["DATASET"][split].update(ROOT=root, ANN=ann)
    cfg["MODEL"]["NUM_DECONV_FILTERS"] = [64, 64, 64]
    cfg["RETRAIN"]["BATCH_SIZE"] = 4
    model = jax_build_sppe(JaxCfg(cfg["MODEL"]), JaxCfg(cfg["DATA_PRESET"]),
                           train=True)
    cfg["MODEL"]["PRETRAINED"] = str(tmp / "simplepose_r18.pkl")
    with open(cfg["MODEL"]["PRETRAINED"], "wb") as f:
        pickle.dump(random_flax_variables(model, jnp.zeros((1, 128, 96, 3)),
                                          np.random.default_rng(77)), f)
    return tmp, cfg


@pytest.mark.parametrize("unc,flt", [("MPE", "K-Means"),
                                     ("VL4Pose", "weighted")])
def test_strategy_loop_matches_jax(synth, unc, flt):
    tmp, cfg = synth
    kw = dict(uncertainty=unc, representativeness="None", filter=flt,
              strategy=f"{unc}_{flt}filter")
    jal = JaxAL(JaxCfg(copy.deepcopy(cfg)), Opt(str(tmp / f"jax_{unc}"),
                                                **kw))
    al = ActiveLearning(Cfg(copy.deepcopy(cfg)),
                        Opt(str(tmp / f"port_{unc}"), **kw))
    if unc == "VL4Pose":
        al.aux.load_state_dict(state_dict_from_flax(
            jax.tree.map(np.asarray, jal.aux_vars), "auxnet"))
    want = run(jal)
    got = run(al)
    assert list(got[3]) == list(want[3]) == ["Round0", "Round1", "Round2"]
    for rc in want[3]:
        assert got[3][rc] == want[3][rc], rc
    assert sorted(q for qs in got[3].values() for q in qs) == list(range(10))
    assert got[0] == want[0] == [0.0, 30.0, 60.0, 100.0]
    assert al.retrain_epoch == jal.retrain_epoch == 1      # each round
    np.testing.assert_allclose(                     # the per-sample scores
        list(got[4]["Round0"].values()), list(want[4]["Round0"].values()),
        rtol=1e-5, atol=1e-5)
    g, w = (np.array(list(r[4]["Round1"].values())) for r in (got, want))
    assert np.sum(np.abs(g - w) <= 1e-4 * np.abs(w)) >= 8, g / w - 1
