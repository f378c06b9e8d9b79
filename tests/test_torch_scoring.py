"""The whole slice: the port's ScoringEngine.score against the JAX
package's on the synthetic video, with the same weights, on the CPU
(where the port's kernel wrappers take their plain versions)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_models import NARROW, random_flax_variables
from vatl4pose_tpu.al.scoring import ScoringConfig as JaxScoringConfig
from vatl4pose_tpu.al.scoring import ScoringEngine as JaxScoringEngine
from vatl4pose_tpu.config import Cfg
from vatl4pose_tpu.data.dataset import build_dataset
from vatl4pose_tpu.data.synthetic import make_synthetic_video
from vatl4pose_tpu.models import SimplePose as FlaxSimplePose
from vatl4pose_tpu.models import WholeBodyAE as FlaxWholeBodyAE
from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
from vatl4pose_tpu_torch.models import (SimplePose, WholeBodyAE,
                                        state_dict_from_flax)

torch.set_num_threads(1)
RNG = np.random.default_rng(6007)
INPUT = (64, 48)
MARGIN = 1e-4


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    root, ann = make_synthetic_video(
        str(tmp_path_factory.mktemp("slice")), num_frames=4, num_persons=2,
        width=160, height=128)
    ds = build_dataset(Cfg({"TYPE": "Posetrack21", "ROOT": root,
                            "ANN": ann}))
    d = ds.data
    frames = ds.load_frames()
    bbox_ann = np.stack([d.bboxes[:, 0], d.bboxes[:, 1],
                         d.bboxes[:, 2] - d.bboxes[:, 0],
                         d.bboxes[:, 3] - d.bboxes[:, 1]], 1)
    args = (d.frame_idx, d.bboxes, d.gt_keypoints, bbox_ann, d.is_prev,
            d.is_next)
    variables = random_flax_variables(FlaxSimplePose(**NARROW),
                                      jnp.zeros((1,) + INPUT + (3,)), RNG)
    ae_vars = random_flax_variables(FlaxWholeBodyAE(), jnp.zeros((1, 38)),
                                    RNG)
    jax_engine = JaxScoringEngine(
        FlaxSimplePose(**NARROW, fused_eval=True),
        JaxScoringConfig(uncertainty="THC+WPU", input_size=INPUT),
        ae_model=FlaxWholeBodyAE(), chunk=8)
    ref = jax_engine.score(jax.tree.map(jnp.asarray, variables),
                           jnp.asarray(frames), *args,
                           ae_variables=jax.tree.map(jnp.asarray, ae_vars))

    model = SimplePose(**NARROW, fused_eval=True, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, "SimplePose"))
    ae = WholeBodyAE(device="cpu")
    ae.load_state_dict(state_dict_from_flax(ae_vars, "WholeBodyAE"))
    return dict(frames=frames, args=args, ref=ref, model=model, ae=ae,
                jax_engine=jax_engine, ae_vars=ae_vars)


def port_engine(s, uncertainty="THC+WPU", **kw):
    return ScoringEngine(s["model"], ScoringConfig(
        uncertainty=uncertainty, input_size=INPUT, **kw),
        ae_model=s["ae"], chunk=3, device="cpu")


def top2_margin(hms):
    flat = np.sort(np.asarray(hms, np.float64).reshape(
        hms.shape[0], hms.shape[1], -1), axis=-1)
    return flat[..., -1] - flat[..., -2]


def test_score_matches_jax_engine(slice_setup):
    s = slice_setup
    ref = s["ref"]
    res = port_engine(s).score(s["frames"], *s["args"])
    n = len(s["args"][0])
    assert set(res) == set(ref)
    for k in ref:
        assert tuple(res[k].shape) == tuple(ref[k].shape), k
    ref_hm = np.asarray(ref["heatmaps"])
    assert rel_err(res["heatmaps"], ref_hm) <= 1e-4
    assert rel_err(res["embeddings"], ref["embeddings"]) <= 1e-4
    np.testing.assert_allclose(res["bbox_crop"], ref["bbox_crop"], rtol=1e-6)
    for k in ("gc", "unc", "scores", "det_score"):
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    # an argmax may flip where JAX's top-2 values are closer than MARGIN;
    # such joints (and the OKS/WPU of their samples) are left out
    clear = top2_margin(ref_hm) > MARGIN                  # (n, K)
    print(f"joints excluded from the coords check: {(~clear).sum()} of "
          f"{clear.size}")
    assert clear.sum() >= 0.9 * clear.size, f"{(~clear).sum()} excluded"
    np.testing.assert_allclose(res["coords"][clear], ref["coords"][clear],
                               rtol=1e-4, atol=1e-3)
    kp_clear = np.repeat(clear, 3, axis=1)
    np.testing.assert_allclose(res["kpts"][kp_clear], ref["kpts"][kp_clear],
                               rtol=1e-4, atol=1e-3)
    whole = clear.all(axis=1)
    for k in ("oks", "unc2"):
        np.testing.assert_allclose(res[k][whole], ref[k][whole], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert np.isfinite(res["unc2"]).all() and res["unc2"].any()
    assert n == 8


@pytest.mark.parametrize("unc", ["HP", "THC_L1", "THC_L2", "WPU", "None"])
def test_stage2_branches_match_jax(slice_setup, unc):
    """Stage 2 of every ported branch on the same heatmaps."""
    s = slice_setup
    frame_idx, bboxes, gt, bb_ann, is_prev, is_next = s["args"]
    hms = s["ref"]["heatmaps"]
    bbox_crop = s["ref"]["bbox_crop"]
    jax_engine = JaxScoringEngine(
        FlaxSimplePose(**NARROW), JaxScoringConfig(uncertainty=unc,
                                                   input_size=INPUT),
        ae_model=FlaxWholeBodyAE())
    ref = jax_engine._score_video(
        jnp.asarray(hms), jnp.asarray(bbox_crop), jnp.asarray(gt),
        jnp.asarray(bb_ann, jnp.float32), jnp.asarray(is_prev),
        jnp.asarray(is_next), jax.tree.map(jnp.asarray, s["ae_vars"]),
        jnp.zeros((len(gt), 1, 2)))
    got = port_engine(s, unc)._score_video(
        *(torch.tensor(np.asarray(a)) for a in (
            hms, bbox_crop, gt, bb_ann.astype(np.float32), is_prev,
            is_next)))
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_bf16_serving_runs_and_tracks_f32(slice_setup):
    s = slice_setup
    res = port_engine(s, bf16=True).score(s["frames"], *s["args"])
    assert res["heatmaps"].dtype == torch.bfloat16
    for k in ("coords", "kpts", "oks", "unc", "unc2", "gc", "embeddings"):
        assert np.isfinite(res[k]).all(), k
    ref = np.asarray(s["ref"]["heatmaps"])
    assert rel_err(res["heatmaps"].float(), ref) <= 0.1
    assert s["model"].preact.conv1.weight.dtype == torch.float32


@pytest.mark.parametrize("unc", ["TPC", "MPE", "Margin", "Entropy",
                                 "VL4Pose"])
def test_unported_branches_raise(slice_setup, unc):
    with pytest.raises(NotImplementedError, match="A11"):
        port_engine(slice_setup, unc)
