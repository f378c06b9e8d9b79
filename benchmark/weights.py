"""Seeded random weights for a model, made on the device in two large
draws (one normal, one uniform) and cut into the leaves, in the layout
of the plain reference model, whose parameter names the port shares.

He-scaled convolutions and linear layers; BN gains in [0.5, 1], or
[0.1, 0.3] where a BN's output is summed with another branch (a
bottleneck's bn3 and shortcut, an HRNet branch block's bn2 and its fusion
layers), so that activations stay O(1) through the depth; BN running
statistics near (0, 1), so that folding them matters; LayerNorm gains in
[0.5, 1] and biases as a BN's.  The same seed
gives the same weights on the same device."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.models import build_ae, build_estimator

__all__ = ["make_weights", "generator", "estimator_weights", "ae_weights"]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch Generator on `device` for draw stream `stream` of `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % 2 ** 63)
    return g


def _summed(name: str) -> bool:
    return name.endswith(("bn3", "downsample.1")) or (
        ".branches." in name and name.endswith("bn2")) \
        or ".fuse_layers." in name


def _plan(model: nn.Module):
    """(state name, shape, kind, a, b): leaf = normal*a + b ("n"), uniform
    in [b, a + b) ("u") or zeros ("z")."""
    plan = []
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
        elif isinstance(m, nn.ConvTranspose2d):
            # each output pixel of a stride-s deconvolution sees
            # in * (k / s)^2 taps
            fan_in = m.weight.shape[0] * (m.kernel_size[0] // m.stride[0]) \
                * (m.kernel_size[1] // m.stride[1])
        elif isinstance(m, nn.BatchNorm2d):
            lo, hi = (0.1, 0.3) if _summed(mname) else (0.5, 1.0)
            c = (m.num_features,)
            plan += [(pre + "weight", c, "u", hi - lo, lo),
                     (pre + "bias", c, "n", 0.1, 0.0),
                     (pre + "running_mean", c, "n", 0.1, 0.0),
                     (pre + "running_var", c, "u", 1.0, 0.5),
                     (pre + "num_batches_tracked", (), "z", 0, 0)]
            continue
        elif isinstance(m, nn.LayerNorm):
            c = tuple(m.normalized_shape)
            plan += [(pre + "weight", c, "u", 0.5, 0.5),
                     (pre + "bias", c, "n", 0.1, 0.0)]
            continue
        else:
            continue
        plan.append((pre + "weight", tuple(m.weight.shape), "n",
                     (2.0 / fan_in) ** 0.5, 0.0))
        if m.bias is not None:
            plan.append((pre + "bias", tuple(m.bias.shape), "n", 0.05, 0.0))
    return plan


@torch.no_grad()
def make_weights(model: nn.Module, seed: int, stream: int, device):
    """A state dict for `model`'s layout (its parameters may live on the
    meta device), drawn from (seed, stream) on `device`."""
    plan = _plan(model)
    numel = {k: 0 for k in "nu"}
    for _, shape, kind, _, _ in plan:
        if kind in numel:
            numel[kind] += int(torch.Size(shape).numel())
    g = generator(seed, stream, device)
    pools = {"n": torch.randn(numel["n"], generator=g, device=device),
             "u": torch.rand(numel["u"], generator=g, device=device)}
    used = {k: 0 for k in "nu"}
    out = {}
    for name, shape, kind, a, b in plan:
        if kind == "z":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        n = int(torch.Size(shape).numel())
        out[name] = (pools[kind][used[kind]:used[kind] + n] * a + b) \
            .view(shape)
        used[kind] += n
    missing = set(model.state_dict()) - set(out)
    if missing:
        raise ValueError(f"no weights planned for {sorted(missing)[:5]}")
    return out


def estimator_weights(cfg, seed, device):
    """The estimator's weights for `cfg` (draw stream 1 of `seed`)."""
    with torch.device("meta"):
        meta = build_estimator(cfg["MODEL"], cfg["DATA_PRESET"])
    return make_weights(meta, seed, 1, device)


def ae_weights(cfg, seed, device):
    """The WPU autoencoder's weights (draw stream 2 of `seed`)."""
    with torch.device("meta"):
        meta = build_ae(cfg["AE"])
    return make_weights(meta, seed, 2, device)
