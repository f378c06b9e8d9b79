"""The port's other pose models (FastPose, HRNet, ShuffleResnet), its
layers, registry and builder, against the Flax models with the same
weights, carried across by `state_dict_from_flax`.  Weights come from
numpy (`random_flax_variables`: He-scaled kernels, random BN statistics),
not from HRNet's normal(0.001) init, which would compare near-zeros.
Heatmaps and embeddings agree within 1e-4 of the reference's max
magnitude in f32 (ROADMAP A12's bound)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_models as tm
from tests.test_torch_models import random_flax_variables, rel_err
from vatl4pose_tpu.models import FastPose as FlaxFastPose
from vatl4pose_tpu.models import PoseHighResolutionNet as FlaxHRNet
from vatl4pose_tpu.models import build_sppe as jax_build_sppe
from vatl4pose_tpu.models.convert_torch import (convert_state_dict,
                                                export_state_dict)
from vatl4pose_tpu.models.layers import DUC as FlaxDUC
from vatl4pose_tpu.models.layers import SELayer as FlaxSELayer
from vatl4pose_tpu.models.layers import pixel_shuffle, pixel_unshuffle
from vatl4pose_tpu.models.shuffle_resnet import \
    ShuffleResnet as FlaxShuffleResnet
from vatl4pose_tpu.train import optim as jopt
from vatl4pose_tpu_torch.data import build_dataset
from vatl4pose_tpu_torch.models import (FastPose, PoseHighResolutionNet,
                                        ShuffleResnet, SimplePose,
                                        build_sppe, state_dict_from_flax)
from vatl4pose_tpu_torch.models.layers import DUC, SELayer
from vatl4pose_tpu_torch.registry import (DATASET, SPPE, Registry,
                                          build_from_cfg)
from vatl4pose_tpu_torch.train import build_optimizer

torch.set_num_threads(1)
RNG = np.random.default_rng(8121)
PRESET = {"NUM_JOINTS": 17}
# HRNet cut to size: one module a stage, one block a branch, 8..64
# channels; the stem and layer1 keep their fixed widths
NARROW_STAGES = {
    "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "NUM_BLOCKS": [1, 1],
               "NUM_CHANNELS": [8, 16], "BLOCK": "BASIC"},
    "STAGE3": {"NUM_MODULES": 1, "NUM_BRANCHES": 3, "NUM_BLOCKS": [1, 1, 1],
               "NUM_CHANNELS": [8, 16, 32], "BLOCK": "BASIC"},
    "STAGE4": {"NUM_MODULES": 1, "NUM_BRANCHES": 4,
               "NUM_BLOCKS": [1, 1, 1, 1], "NUM_CHANNELS": [8, 16, 32, 64],
               "BLOCK": "BASIC"},
}
# two modules in the last stage, so that a multi-scale module feeds the
# single-output one, and bottleneck branches in stage 3
DEEP_STAGES = {k: dict(v) for k, v in NARROW_STAGES.items()}
DEEP_STAGES["STAGE3"] = dict(NARROW_STAGES["STAGE3"], BLOCK="BOTTLENECK",
                             NUM_CHANNELS=[2, 4, 8])
DEEP_STAGES["STAGE4"] = dict(NARROW_STAGES["STAGE4"], NUM_MODULES=2)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def port_from(variables, model, arch):
    model.load_state_dict(state_dict_from_flax(variables, arch), strict=True)
    return model.eval()


def compare(flax_model, port_model, arch, x, embedding=True):
    """Flax and port forward (eval) on the same numpy weights and input;
    returns (heatmap rel err, embedding rel err)."""
    variables = random_flax_variables(flax_model, jnp.asarray(x), RNG)
    port = port_from(variables, port_model, arch)
    with torch.no_grad():
        if embedding:
            hm, emb = port(nchw(x), return_embedding=True)
        else:
            hm = port(nchw(x))
    if embedding:
        ref_hm, ref_emb = flax_model.apply(variables, jnp.asarray(x),
                                           return_embedding=True)
    else:
        ref_hm = flax_model.apply(variables, jnp.asarray(x))
    ref_hm = np.asarray(ref_hm).transpose(0, 3, 1, 2)
    assert tuple(hm.shape) == ref_hm.shape
    return (rel_err(hm, ref_hm),
            rel_err(emb, ref_emb) if embedding else None, hm, ref_hm)


@pytest.mark.parametrize("fused_eval", [False, True])
def test_fastpose_matches_flax(fused_eval):
    """SE-ResNet-50 + DUC head at 64x48; fused: the four stage tails
    through K1's plain version against the JAX package's fused chain."""
    x = RNG.normal(0, 1, (2, 64, 48, 3)).astype(np.float32)
    e_hm, e_emb, hm, _ = compare(
        FlaxFastPose(num_joints=17, num_layers=50, fused_eval=fused_eval),
        FastPose(num_joints=17, num_layers=50, fused_eval=fused_eval,
                 device="cpu"), "FastPose", x)
    assert hm.shape == (2, 17, 16, 16)
    assert e_hm <= 1e-4 and e_emb <= 1e-4


@pytest.mark.parametrize("final_conv_kernel,stages",
                         [(1, NARROW_STAGES), (3, NARROW_STAGES),
                          (1, DEEP_STAGES)], ids=["k1", "k3", "deep"])
def test_hrnet_matches_flax(final_conv_kernel, stages):
    x = RNG.normal(0, 1, (2, 128, 96, 3)).astype(np.float32)
    e_hm, e_emb, hm, _ = compare(
        FlaxHRNet(num_joints=17, final_conv_kernel=final_conv_kernel,
                  stages=stages),
        PoseHighResolutionNet(num_joints=17,
                              final_conv_kernel=final_conv_kernel,
                              stages=stages, device="cpu"),
        "PoseHighResolutionNet", x)
    assert hm.shape == (2, 17, 32, 24)
    assert e_hm <= 1e-4 and e_emb <= 1e-4


def test_shuffle_resnet_matches_flax():
    x = RNG.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    e, _, feat, _ = compare(FlaxShuffleResnet(depth=50),
                            ShuffleResnet(depth=50, device="cpu"),
                            "ShuffleResnet", x, embedding=False)
    assert feat.shape == (2, 2048, 2, 2) and e <= 1e-4


@pytest.mark.parametrize("dcn", [
    {"MODULATED": False, "DEFORM_GROUP": 1},
    {"MODULATED": True, "DEFORM_GROUP": 2}], ids=["v1", "v2"])
def test_dcn_stage_matches_flax(dcn):
    """FastPose with DCN on stage 2 (the builder's DCN keys), exact
    graph: every block of the stage samples at its conv2_offset's
    offsets (He-scaled random weights, so the offsets are O(1) pixels and
    taps fall off the 8x6 maps' edges)."""
    cfg = {"TYPE": "FastPose", "NUM_LAYERS": 50, "DCN": dcn,
           "STAGE_WITH_DCN": [False, True, False, False]}
    x = RNG.normal(0, 1, (2, 64, 48, 3)).astype(np.float32)
    port = build_sppe(cfg, PRESET, device="cpu")
    assert type(port.preact.layer2[1].conv2).__name__ == "DeformConv2d"
    assert not hasattr(port.preact.layer3[1], "conv2_offset")
    e_hm, e_emb, _, _ = compare(jax_build_sppe(cfg, PRESET), port,
                                "FastPose", x)
    assert e_hm <= 1e-4 and e_emb <= 1e-4


def _variables(arch):
    if arch == "FastPose":
        return random_flax_variables(FlaxFastPose(num_layers=50),
                                     jnp.zeros((1, 64, 48, 3)), RNG), \
            FastPose(device="cpu")
    if arch == "PoseHighResolutionNet":
        return random_flax_variables(FlaxHRNet(stages=NARROW_STAGES),
                                     jnp.zeros((1, 128, 96, 3)), RNG), \
            PoseHighResolutionNet(stages=NARROW_STAGES, device="cpu")
    return random_flax_variables(FlaxShuffleResnet(depth=50),
                                 jnp.zeros((1, 64, 64, 3)), RNG), \
        ShuffleResnet(device="cpu")


@pytest.mark.parametrize("arch", ["FastPose", "PoseHighResolutionNet",
                                  "ShuffleResnet"])
def test_state_dict_round_trip(arch):
    """Flax tree -> port state_dict: a strict load, every Flax leaf once;
    back through the JAX package's own converter (FastPose, HRNet) to the
    same tree, and for FastPose equal to the JAX package's export."""
    variables, model = _variables(arch)
    sd = state_dict_from_flax(variables, arch)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    leaves = jax.tree_util.tree_leaves(variables)
    assert len(leaves) == len([k for k in sd
                               if not k.endswith("num_batches_tracked")])
    if arch == "ShuffleResnet":        # the JAX package has no converter
        return
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()}, arch)
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(node), leaf,
                                      err_msg=jax.tree_util.keystr(path))
    if arch == "FastPose":
        for k, v in export_state_dict(variables, arch).items():
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("arch", ["FastPose", "PoseHighResolutionNet"])
def test_reference_state_dict_loads_as_is(arch):
    """The reference-layout torch oracles' state_dicts load strictly."""
    if arch == "FastPose":
        ref, model = tm.FastPose(depth=50), FastPose(device="cpu")
    else:
        ref = tm.HRNet(NARROW_STAGES)
        model = PoseHighResolutionNet(stages=NARROW_STAGES, device="cpu")
    model.load_state_dict(ref.state_dict(), strict=True)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffles_match_jax_channel_order(r):
    """nn.PixelShuffle/PixelUnshuffle on NCHW equal the JAX package's
    NHWC pixel_shuffle/pixel_unshuffle, exactly."""
    x = RNG.normal(0, 1, (2, 3, 4, 5 * r * r)).astype(np.float32)
    got = torch.nn.PixelShuffle(r)(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(pixel_shuffle(
        jnp.asarray(x), r)))
    y = RNG.normal(0, 1, (2, 3 * r, 4 * r, 5)).astype(np.float32)
    got = torch.nn.PixelUnshuffle(r)(nchw(y)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(pixel_unshuffle(
        jnp.asarray(y), r)))


def test_se_layer_and_duc_match_flax():
    """Each block on its own, its weights named by the converter as
    FastPose's duc1 and as an SE-ResNet block's se."""
    x = RNG.normal(0, 1, (2, 6, 5, 32)).astype(np.float32)
    for flax_mod, mod, prefix in (
            (FlaxSELayer(32), SELayer(32), ("preact", "layer1_0", "se")),
            (FlaxDUC(16, 2), DUC(32, 16), ("duc1",))):
        variables = random_flax_variables(flax_mod, jnp.asarray(x), RNG)
        wrapped = {}
        for col, tree in variables.items():
            for name in reversed(prefix):
                tree = {name: tree}
            wrapped[col] = tree
        head = state_dict_from_flax(wrapped, "FastPose")
        strip = len(".".join(prefix).replace("layer1_0", "layer1.0")) + 1
        mod.load_state_dict({k[strip:]: v for k, v in head.items()},
                            strict=True)
        with torch.no_grad():
            got = mod.eval()(nchw(x)).permute(0, 2, 3, 1).numpy()
        ref = np.asarray(flax_mod.apply(variables, jnp.asarray(x)))
        assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("model_type,cls", [
    ("SimplePose", SimplePose), ("FastPose", FastPose),
    ("PoseHighResolutionNet", PoseHighResolutionNet)])
def test_build_sppe_dispatches_through_the_registry(model_type, cls):
    cfg = {"TYPE": model_type, "NUM_LAYERS": 50, "CONV_DIM": 256,
           "FINAL_CONV_KERNEL": 3, "STAGE2": NARROW_STAGES["STAGE2"],
           "STAGE3": NARROW_STAGES["STAGE3"],
           "STAGE4": NARROW_STAGES["STAGE4"]}
    assert SPPE.get(model_type) is cls
    model = build_sppe(cfg, PRESET, fused_eval=True, device="cpu")
    assert type(model) is cls
    if cls is FastPose:
        assert model.conv_out.in_channels == 256
        assert model.preact.fused_eval
    if cls is PoseHighResolutionNet:
        assert model.final_layer.kernel_size == (3, 3)
        assert model.final_layer.in_channels == 8


@pytest.mark.parametrize("model_type", ["ShuffleResnet", "NoSuchPose"])
def test_unknown_model_type_raises_the_registry_key_error(model_type):
    """As in the JAX package: ShuffleResnet is a backbone, no SPPE."""
    with pytest.raises(KeyError, match="not registered in sppe"):
        build_sppe({"TYPE": model_type}, PRESET, device="cpu")
    with pytest.raises(KeyError):
        jax_build_sppe({"TYPE": model_type}, PRESET)


def test_registry_and_dataset_dispatch():
    reg = Registry("toy")

    @reg.register_module
    class Toy:
        def __init__(self, a, b=0):
            self.a, self.b = a, b
    with pytest.raises(KeyError, match="already registered"):
        reg.register_module(Toy)
    toy = build_from_cfg({"TYPE": "Toy", "a": 1}, reg, b=2)
    assert (toy.a, toy.b) == (1, 2) and reg.module_dict == {"Toy": Toy}
    # the video sets and the extra datasets (data/extra_datasets.py), as
    # the JAX package registers them
    assert sorted(DATASET.module_dict) == [
        "ConcatDataset", "JRDB2022", "Mpii", "Mscoco", "Mscoco_det",
        "Posetrack21"]
    with pytest.raises(KeyError, match="not registered in dataset"):
        build_dataset({"TYPE": "COCO", "ROOT": "", "ANN": ""})


@pytest.mark.parametrize("model_type", ["FastPose", "PoseHighResolutionNet"])
def test_lr_groups_match_jax(model_type):
    """One AdamW group per top-level child gives every parameter the
    multiplier the JAX package's per-leaf tree gives its Flax leaf
    (FastPose: conv_out x10, preact x1, the DUCs x5; HRNet x1)."""
    variables, model = _variables(model_type)
    mults = jopt.lr_multiplier_tree(
        variables["params"],
        jopt.LR_GROUPS.get(model_type, lambda k: 1.0))
    want = {}
    for k, v in state_dict_from_flax({"params": mults}, model_type).items():
        want[k] = float(np.asarray(v).flat[0])
    opt = build_optimizer(model, {"OPTIMIZER": "AdamW", "LR": 1.0,
                                  "WEIGHT_DECAY": 0.7}, model_type)
    got = {}
    names = {id(p): n for n, p in model.named_parameters()}
    for g in opt.param_groups:
        for p in g["params"]:
            got[names[id(p)]] = g["lr_mult"]
    assert got == want
    assert len(got) == len(list(model.parameters()))
