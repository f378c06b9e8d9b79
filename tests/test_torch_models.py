"""The port's models (vatl4pose_tpu_torch/models) against the Flax ones
with the same weights, carried across by `state_dict_from_flax`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_models as tm
from vatl4pose_tpu.models import SimplePose as FlaxSimplePose
from vatl4pose_tpu.models import WholeBodyAE as FlaxWholeBodyAE
from vatl4pose_tpu.models.convert_torch import export_state_dict
from vatl4pose_tpu_torch.al import ScoringConfig, ScoringEngine
from vatl4pose_tpu_torch.models import (FastPose, PoseHighResolutionNet,
                                        ShuffleResnet, SimplePose,
                                        WholeBodyAE, build_sppe,
                                        state_dict_from_flax)

torch.set_num_threads(1)
RNG = np.random.default_rng(5021)
NARROW = dict(num_joints=17, num_layers=50, deconv_dim=(32, 32, 32))


def _redraw(path, leaf, rng):
    """He-scaled kernels, small residual-branch gains and random BN stats,
    so activations stay O(1) and the BN fold matters."""
    names = [getattr(k, "key", str(k)) for k in path]
    name, shape = names[-1], leaf.shape
    if name == "kernel":
        fan_in = shape[2] * 4 if names[-2].startswith("deconv") \
            else int(np.prod(shape[:-1]))
        v = rng.normal(0, (2.0 / fan_in) ** 0.5, shape)
    elif name == "scale":
        lo, hi = (0.1, 0.3) if names[-2] == "bn3" else (0.5, 1.0)
        v = rng.uniform(lo, hi, shape)
    elif name == "var":
        v = rng.uniform(0.5, 1.5, shape)
    else:                                   # bias, mean
        v = rng.normal(0, 0.02, shape)
    return np.asarray(v, np.float32)


def random_flax_variables(module, x, rng):
    """The Flax init's tree, every leaf drawn with numpy from `rng`; numpy
    tree.  Only the leaves' shapes are needed, so the init is only traced
    (eval_shape), never run."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: _redraw(p, a, rng), shapes)


def port_simplepose(variables, fused_eval):
    model = SimplePose(**NARROW, fused_eval=fused_eval, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, "SimplePose"))
    return model.eval()


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def r50():
    x = RNG.normal(0, 1, (2, 64, 48, 3)).astype(np.float32)
    variables = random_flax_variables(FlaxSimplePose(**NARROW),
                                      jnp.asarray(x), RNG)
    return x, variables


@pytest.mark.parametrize("fused_eval", [False, True])
def test_simplepose_r50_matches_flax(r50, fused_eval):
    x, variables = r50
    flax_model = FlaxSimplePose(**NARROW, fused_eval=fused_eval)
    ref_hm, ref_emb = flax_model.apply(variables, jnp.asarray(x),
                                       return_embedding=True)
    model = port_simplepose(variables, fused_eval)
    with torch.no_grad():
        hm, emb = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                        return_embedding=True)
    ref_hm = np.asarray(ref_hm).transpose(0, 3, 1, 2)
    assert hm.shape == ref_hm.shape == (2, 17, 16, 16)
    assert rel_err(hm, ref_hm) <= 1e-4
    assert rel_err(emb, ref_emb) <= 1e-4


def test_fused_eval_sees_weight_updates(r50):
    """BN is folded on every forward call, not once at construction."""
    x, variables = r50
    model = port_simplepose(variables, fused_eval=True)
    exact = port_simplepose(variables, fused_eval=False)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        before = model(xt)
        for m in (model, exact):
            m.preact.layer3[2].bn2.running_var.mul_(3.0)
        after, want = model(xt), exact(xt)
    assert rel_err(after, before) > 1e-3
    assert rel_err(after, want) <= 1e-4


def test_wholebody_ae_matches_flax():
    x = RNG.uniform(-1, 1, (6, 38)).astype(np.float32)
    variables = random_flax_variables(FlaxWholeBodyAE(z_dim=4, input_dim=38),
                                      jnp.asarray(x), RNG)
    ref = FlaxWholeBodyAE(z_dim=4, input_dim=38).apply(variables,
                                                       jnp.asarray(x))
    ae = WholeBodyAE(z_dim=4, input_dim=38, device="cpu")
    ae.load_state_dict(state_dict_from_flax(variables, "WholeBodyAE"))
    with torch.no_grad():
        got = ae(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["SimplePose", "WholeBodyAE"])
def test_state_dict_round_trip(r50, arch):
    """Flax tree -> port state_dict: strict load with no missing or
    unexpected keys, and every tensor equal to the JAX package's own
    torch-layout export."""
    if arch == "SimplePose":
        variables = r50[1]
        model = SimplePose(**NARROW, device="cpu")
    else:
        variables = random_flax_variables(FlaxWholeBodyAE(),
                                          jnp.zeros((1, 38)), RNG)
        model = WholeBodyAE(device="cpu")
    sd = state_dict_from_flax(variables, arch)
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    exported = export_state_dict(variables, arch)
    assert set(exported) == {k for k in sd
                             if not k.endswith("num_batches_tracked")}
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v)


def test_reference_state_dict_loads_as_is():
    """A reference-layout SimplePose-R50 state_dict (the torch oracle's)
    loads into the port strictly."""
    ref = tm.SimplePose(depth=50)
    model = SimplePose(num_joints=17, num_layers=50, device="cpu")
    model.load_state_dict(ref.state_dict(), strict=True)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SimplePose(**NARROW)
    for model in (FastPose, PoseHighResolutionNet, ShuffleResnet):
        with pytest.raises(RuntimeError, match="CUDA"):
            model()
    for t in ("SimplePose", "FastPose", "PoseHighResolutionNet"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_sppe({"TYPE": t}, {"NUM_JOINTS": 17})
    with pytest.raises(RuntimeError, match="CUDA"):
        WholeBodyAE()
    ae = WholeBodyAE(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ScoringEngine(None, ScoringConfig(), ae_model=ae)
    ScoringEngine(None, ScoringConfig(), ae_model=ae, device="cpu")
