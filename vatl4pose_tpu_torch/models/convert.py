"""Weights carried across: the JAX package's Flax variable tree →
this port's state_dict, and the checkpoint readers the entry points share
(`read_weights`: a reference .pth or a .pkl of Flax variables;
`load_weights`: strict but for BN step counters).

`state_dict_from_flax(variables, arch)` (arch "SimplePose", "FastPose",
"PoseHighResolutionNet", "ShuffleResnet", "WholeBodyAE" or "auxnet")
takes {"params", "batch_stats"}
as nested mappings of numpy arrays (a Flax tree passed through
np.asarray) and returns {name: tensor} in the reference torch layout,
which `load_state_dict(strict=True)` takes as it is.  Layout rules (the
port's own copy of the inverse in vatl4pose_tpu/models/convert_torch.py):

  conv kernel    HWIO -> OIHW (a DCN conv2 and its conv2_offset too)
  deconv kernel  HWIO -> IOHW (the Flax module flips it at call time)
  dense kernel   (in, out) -> (out, in) (SE fc1/fc2 -> se.fc.0/se.fc.2)
  batchnorm      scale/bias -> weight/bias, mean/var -> running_mean/var,
                 plus num_batches_tracked = 0
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, List

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "read_weights", "load_weights"]

_DECONV_MODULES = {"deconv1", "deconv2", "deconv3"}
_DECONV_INDEX = {"deconv1": "0", "bn_d1": "1", "deconv2": "3", "bn_d2": "4",
                 "deconv3": "6", "bn_d3": "7"}
_CONV_BN = {"conv": "0", "bn": "1"}       # Sequential(conv, bn[, relu])


def _block_names(names: List[str]) -> List[str]:
    """Inside a residual block: the shortcut, the SE layer's
    Sequential(Linear, ReLU, Linear, Sigmoid), the rest as they are
    (conv1..3, bn1..3, a DCN stage's conv2_offset and conv2)."""
    if names[0] == "downsample_conv":
        return ["downsample", "0"]
    if names[0] == "downsample_bn":
        return ["downsample", "1"]
    if names[0] == "se":
        return ["se", "fc", {"fc1": "0", "fc2": "2"}[names[1]]]
    return names


def _resnet_names(names: List[str]) -> List[str]:
    m = re.fullmatch(r"layer(\d+)_(\d+)", names[0])
    if m is None:
        return names                                  # stem conv1 / bn1
    return [f"layer{m.group(1)}", m.group(2)] + _block_names(names[1:])


def _simplepose_name(names: List[str]) -> str:
    if names[0] == "preact":
        return ".".join(["preact"] + _resnet_names(names[1:]))
    if names[0] in _DECONV_INDEX:
        return f"deconv_layers.{_DECONV_INDEX[names[0]]}"
    return ".".join(names)                            # final_layer


def _fastpose_name(names: List[str]) -> str:
    if names[0] == "preact":
        return ".".join(["preact"] + _resnet_names(names[1:]))
    return ".".join(names)                  # duc1.conv, duc2.bn, conv_out


def _shuffle_resnet_name(names: List[str]) -> str:
    return ".".join(_resnet_names(names))


def _hrnet_name(names: List[str]) -> str:
    head = names[0]
    stem = re.fullmatch(r"stem(\d)", head)
    if stem:                                   # stem1/conv -> conv1 ...
        return f"{names[1]}{stem.group(1)}"
    m = re.fullmatch(r"layer1_(\d+)", head)
    if m:
        return ".".join(["layer1", m.group(1)] + _block_names(names[1:]))
    m = re.fullmatch(r"transition(\d)_(\d+)(?:_(\d+))?", head)
    if m:                                      # .i.{0,1} or .i.j.{0,1}
        idx = [g for g in m.groups()[1:] if g is not None]
        return ".".join([f"transition{m.group(1)}", *idx,
                         _CONV_BN[names[1]]])
    m = re.fullmatch(r"stage(\d)_(\d+)", head)
    if m:
        mod = [f"stage{m.group(1)}", m.group(2)]
        b = re.fullmatch(r"branch(\d+)_(\d+)", names[1])
        if b:
            return ".".join(mod + ["branches", b.group(1), b.group(2)]
                            + _block_names(names[2:]))
        f = re.fullmatch(r"fuse(\d+)_(\d+)(?:_(\d+))?", names[1])
        idx = [g for g in f.groups() if g is not None]
        return ".".join(mod + ["fuse_layers", *idx, _CONV_BN[names[2]]])
    return ".".join(names)                            # final_layer


def _wholebody_ae_name(names: List[str]) -> str:
    side = "encoder" if names[0].startswith("enc") else "decoder"
    return f"{side}.{int(names[0][3:]) * 2}"


def _auxnet_name(names: List[str]) -> str:
    return ".".join(names)                            # proj, down0, fc0...


_NAMES = {"SimplePose": _simplepose_name, "FastPose": _fastpose_name,
          "PoseHighResolutionNet": _hrnet_name,
          "ShuffleResnet": _shuffle_resnet_name,
          "WholeBodyAE": _wholebody_ae_name, "auxnet": _auxnet_name}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def state_dict_from_flax(variables, arch: str) -> Dict[str, torch.Tensor]:
    name_of = _NAMES[arch]
    out: Dict[str, np.ndarray] = {}
    for path, arr in _leaves(variables["params"]):
        mod = name_of(list(path[:-1]))
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim == 4:
                perm = (2, 3, 0, 1) if path[-2] in _DECONV_MODULES \
                    else (3, 2, 0, 1)
                out[mod + ".weight"] = arr.transpose(perm)
            elif arr.ndim == 2:
                out[mod + ".weight"] = arr.T
            else:
                out[mod + ".weight"] = arr
        elif leaf == "scale":
            out[mod + ".weight"] = arr
        elif leaf == "bias":
            out[mod + ".bias"] = arr
        else:
            raise ValueError(f"unhandled Flax leaf: {'/'.join(path)}")
    # np.array copies: a tree of jax arrays passed through np.asarray is
    # read-only, and the tensors here become the model's own weights
    sd = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _leaves(variables.get("batch_stats", {})):
        mod = name_of(list(path[:-1]))
        sd[f"{mod}.{stats[path[-1]]}"] = torch.from_numpy(np.array(arr))
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def read_weights(path: str, arch: str) -> Dict[str, torch.Tensor]:
    """A state_dict from a reference .pth (a state_dict or a pickled
    module) or from a .pkl of numpy Flax variables (the JAX package's
    checkpoints) of the architecture `arch`."""
    if path.endswith(".pth"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        return state.state_dict() if hasattr(state, "state_dict") else state
    import pickle
    with open(path, "rb") as f:
        return state_dict_from_flax(pickle.load(f), arch)


def load_weights(module, state_dict, what: str):
    """load_state_dict that tolerates only missing BN step counters (a
    reference .pth may carry none); anything else missing or unexpected
    raises a KeyError naming `what`."""
    missing, unexpected = module.load_state_dict(state_dict, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"{what}: missing {missing[:5]}, unexpected "
                       f"{unexpected[:5]}")
