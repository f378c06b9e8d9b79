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
from vatl4pose_tpu.models.auxnet import AuxNet as FlaxAuxNet
from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
from vatl4pose_tpu_torch.data import build_dataset as port_build_dataset
from vatl4pose_tpu_torch.models import (AuxNet, SimplePose, WholeBodyAE,
                                        state_dict_from_flax)

torch.set_num_threads(1)
RNG = np.random.default_rng(6007)
INPUT = (64, 48)
# the TPC, peak and VL4Pose branches' crops: 32x24 maps leave room for
# several peaks 6 px apart inside the 5-px border (16x12 maps hold one)
INPUT_PEAKS = (128, 96)
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
    port_ds = port_build_dataset({"TYPE": "Posetrack21", "ROOT": root,
                                  "ANN": ann})
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
    aux_vars = random_flax_variables(FlaxAuxNet(),
                                     jnp.zeros((1, 2, 2, 2048)), RNG)
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
    aux = AuxNet(device="cpu")
    aux.load_state_dict(state_dict_from_flax(aux_vars, "auxnet"))
    return dict(frames=frames, args=args, ref=ref, model=model, ae=ae,
                aux=aux, jax_engine=jax_engine, ae_vars=ae_vars,
                aux_vars=aux_vars, variables=variables, ds=ds,
                port_ds=port_ds)


def port_engine(s, uncertainty="THC+WPU", input_size=INPUT, **kw):
    return ScoringEngine(s["model"], ScoringConfig(
        uncertainty=uncertainty, input_size=input_size, **kw),
        ae_model=s["ae"], aux_model=s["aux"], chunk=3, device="cpu")


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
def test_branch_matches_jax(slice_setup, unc):
    """ScoringEngine.score and score_streaming of each branch against
    the JAX engine's, VL4Pose with the same AuxNet weights.  The streamed
    pairs share the host warp's uint8 crops; the port streams in chunks
    of 3, so halo rows carry TPC's neighbours.  Tolerances: the heatmaps
    differ by f32 summation order (about 1e-6 of their scale), so the
    peak values behind MPE, Margin and VL4Pose's softmax and the flat
    entropy agree to 1e-4 (rtol) and 1e-5 (atol); TPC's counts are
    integers and must be equal on every sample whose joints, and whose
    neighbours' joints, decode clear of an argmax near-tie (top-2 gap
    over MARGIN)."""
    s = slice_setup
    frame_idx, bboxes, gt, bb_ann, is_prev, is_next = s["args"]
    jax_engine = JaxScoringEngine(
        FlaxSimplePose(**NARROW, fused_eval=True),
        JaxScoringConfig(uncertainty=unc, input_size=INPUT_PEAKS),
        aux_model=FlaxAuxNet(), chunk=8)
    variables = jax.tree.map(jnp.asarray, s["variables"])
    aux_vars = jax.tree.map(jnp.asarray, s["aux_vars"])
    ref = jax_engine.score(variables, jnp.asarray(s["frames"]), *s["args"],
                           aux_variables=aux_vars)
    ref_stream = jax_engine.score_streaming(
        variables, s["ds"].frame_store(), *s["args"],
        aux_variables=aux_vars, keep_heatmaps=True)
    engine = port_engine(s, unc, INPUT_PEAKS)
    got = engine.score(s["frames"], *s["args"])
    got_stream = engine.score_streaming(s["port_ds"].frame_store(),
                                        *s["args"])
    for r, g in ((ref, got), (ref_stream, got_stream)):
        # entropy is -inf where a map holds negative values, as in JAX
        assert (np.isfinite(g["unc"]) | (unc == "Entropy")).all()
        assert g["unc"].any()
        if unc != "TPC":
            np.testing.assert_allclose(g["unc"], r["unc"], rtol=1e-4,
                                       atol=1e-5)
            continue
        clear = (top2_margin(np.asarray(r["heatmaps"])) > MARGIN).all(1)
        ok = clear & np.roll(clear, 1) & np.roll(clear, -1)
        assert ok.sum() >= len(ok) // 2, ok
        np.testing.assert_array_equal(g["unc"][ok], r["unc"][ok])


def test_vl4pose_pass_splits_one_backbone(slice_setup):
    """VL4Pose's stage 1 runs the backbone once: the head's heatmaps and
    the embedding equal the unsplit forward's, and the link parameters
    are the AuxNet's on that feature."""
    s = slice_setup
    engine = port_engine(s, "VL4Pose", INPUT_PEAKS)
    hms, embs, _, aux = engine.forward_video(s["frames"], *s["args"][:2])
    ref_hms, ref_embs, _, ref_aux = port_engine(
        s, "None", INPUT_PEAKS).forward_video(s["frames"], *s["args"][:2])
    torch.testing.assert_close(hms, ref_hms, rtol=0, atol=0)
    torch.testing.assert_close(embs, ref_embs, rtol=0, atol=0)
    assert tuple(aux.shape) == (len(s["args"][0]), 16, 2)
    assert ref_aux is None and torch.isfinite(aux).all()
