"""Weights carried across: the JAX package's Flax variable tree →
this port's state_dict.

`state_dict_from_flax(variables, arch)` takes {"params", "batch_stats"}
as nested mappings of numpy arrays (a Flax tree passed through
np.asarray) and returns {name: tensor} in the reference torch layout,
which `load_state_dict(strict=True)` takes as it is.  Layout rules (the
port's own copy of the inverse in vatl4pose_tpu/models/convert_torch.py):

  conv kernel    HWIO -> OIHW
  deconv kernel  HWIO -> IOHW (the Flax module flips it at call time)
  dense kernel   (in, out) -> (out, in)
  batchnorm      scale/bias -> weight/bias, mean/var -> running_mean/var,
                 plus num_batches_tracked = 0
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, List

import numpy as np
import torch

__all__ = ["state_dict_from_flax"]

_DECONV_MODULES = {"deconv1", "deconv2", "deconv3"}
_DECONV_INDEX = {"deconv1": "0", "bn_d1": "1", "deconv2": "3", "bn_d2": "4",
                 "deconv3": "6", "bn_d3": "7"}


def _simplepose_name(names: List[str]) -> str:
    if names[0] == "preact":
        out = ["preact"]
        m = re.fullmatch(r"layer(\d+)_(\d+)", names[1])
        if m is None:
            return ".".join(out + names[1:])          # stem conv1 / bn1
        out += [f"layer{m.group(1)}", m.group(2)]
        for r in names[2:]:
            out += {"downsample_conv": ["downsample", "0"],
                    "downsample_bn": ["downsample", "1"]}.get(r, [r])
        return ".".join(out)
    if names[0] in _DECONV_INDEX:
        return f"deconv_layers.{_DECONV_INDEX[names[0]]}"
    return ".".join(names)                            # final_layer


def _wholebody_ae_name(names: List[str]) -> str:
    side = "encoder" if names[0].startswith("enc") else "decoder"
    return f"{side}.{int(names[0][3:]) * 2}"


_NAMES = {"SimplePose": _simplepose_name, "WholeBodyAE": _wholebody_ae_name}


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
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in out.items()}
    stats = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _leaves(variables.get("batch_stats", {})):
        mod = name_of(list(path[:-1]))
        sd[f"{mod}.{stats[path[-1]]}"] = torch.from_numpy(
            np.ascontiguousarray(arr))
        sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
