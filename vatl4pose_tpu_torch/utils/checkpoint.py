"""Checkpoints of variable and optimizer trees (counterpart of
vatl4pose_tpu/utils/checkpoint.py).

Parity: the reference's torch.save/load cycle (posetrack_train.py:188-196,
ActiveLearning.py:207-219) and TRY_LOAD's shape-filtered partial load
(posetrack_train.py:221-229).  The files are pickles of numpy arrays in
plain containers, so the two packages read each other's: a `.pkl` written
here loads through the JAX package's `load_checkpoint`, and one written
there loads here.  The port has no orbax: it never writes an orbax
directory and refuses to read one.

A JAX checkpoint of Flax variables pickles no Flax class: Flax's `init`
returns plain dicts, and `save_checkpoint` maps every leaf to a numpy
array, so the pickle names only numpy.  A JAX optimizer tree pickles the
JAX package's `train.optim.OptState`: `load_checkpoint` reads it as this
module's `OptState` without importing that package (`_Unpickler`), and
refuses any other class of jax, flax or the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "try_load", "OptState"]


@dataclasses.dataclass
class OptState:
    """The JAX package's optimizer state (train/optim.py `OptState`: the
    first and second moment trees and the step count) as unpickled here."""
    m: Any = None
    v: Any = None
    count: Any = None


_REFUSED = ("jax", "jaxlib", "flax", "vatl4pose_tpu")


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("vatl4pose_tpu.train.optim", "OptState"):
            return OptState
        if module.split(".")[0] in _REFUSED:
            raise pickle.UnpicklingError(
                f"{module}.{name} in a checkpoint: the port reads numpy "
                f"arrays in plain containers")
        return super().find_class(module, name)


def _to_numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def save_checkpoint(path: str, tree: Any) -> str:
    """Pickle `tree` (a nested dict, list or tuple of tensors or arrays,
    a state_dict among them) with every tensor as a numpy array, to `path`
    if it ends in .pkl and to `path + ".pkl"` otherwise: where the JAX
    package has no orbax it does the same.  Returns the path written."""
    if not path.endswith(".pkl"):
        path += ".pkl"
    with open(path, "wb") as f:
        pickle.dump(_to_numpy(tree), f)
    return path


def load_checkpoint(path: str, arch: Optional[str] = None):
    """A reference .pth as a state_dict (needs the architecture `arch`:
    models/convert.read_weights), or any other file as the tree it
    pickles.  A directory is an orbax checkpoint, which the port cannot
    read: it raises."""
    if path.endswith(".pth"):
        from ..models.convert import read_weights
        if not arch:
            raise ValueError(".pth load needs the architecture name")
        return read_weights(path, arch)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory, an orbax checkpoint: the "
                         f"port reads no orbax checkpoints; save it from "
                         f"the JAX package to a .pkl path")
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def try_load(state, ckpt):
    """TRY_LOAD: every entry of `state` (a state_dict or a nested dict of
    tensors or arrays) whose key path and shape match an entry of `ckpt`
    takes the checkpoint's values; the rest keep their own.  A tensor
    entry stays a tensor, on its device and in its dtype.  Returns
    (merged, n_loaded); n_loaded leaves out BatchNorm's
    `num_batches_tracked`, which has no Flax leaf, so that on the same
    weights it equals the JAX package's count."""
    flat_ck = dict(_flatten(ckpt))
    n_loaded = 0

    def merge(tree, prefix):
        nonlocal n_loaded
        if isinstance(tree, dict):
            return type(tree)((k, merge(v, prefix + (k,)))
                              for k, v in tree.items())
        c = flat_ck.get(prefix)
        if c is None or _shape(c) != _shape(tree):
            return tree
        if not str(prefix[-1]).endswith("num_batches_tracked"):
            n_loaded += 1
        if torch.is_tensor(tree):
            return torch.as_tensor(c).to(tree.device, tree.dtype)
        return c

    return merge(state, ()), n_loaded
