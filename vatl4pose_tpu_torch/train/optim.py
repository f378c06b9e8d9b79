"""Optimizers with per-layer LR groups and epoch schedules (counterpart of
vatl4pose_tpu/train/optim.py).

Parity: ActiveLearning.py:220-231 (AdamW with per-module LR multipliers,
weight decay 0.7, ExponentialLR(gamma=0.99) stepped per epoch) and
posetrack_train.py:155-161 (Adam, MultiStepLR).  The JAX package wrote
its own AdamW/Adam/SGD to equal torch.optim's; here they are torch.optim
itself, with one parameter group per top-level module of the model.  Each
group keeps its multiplier under "lr_mult"; `set_lr` gives every group
lr * lr_mult before an epoch, which is the JAX package's per-leaf
multiplier tree.  The default (foreach) implementation is used.
"""

from __future__ import annotations

import torch

__all__ = ["LR_GROUPS", "build_optimizer", "set_lr", "exponential_lr",
           "multistep_lr", "with_warmup"]

LR_GROUPS = {
    "SimplePose": lambda k: 10.0 if k == "final_layer" else
    (1.0 if k == "preact" else 5.0),
    "FastPose": lambda k: 10.0 if k == "conv_out" else
    (1.0 if k == "preact" else 5.0),
}


def _groups(model, group_of, lr):
    groups = []
    for name, child in model.named_children():
        params = [p for p in child.parameters() if p.requires_grad]
        if params:
            mult = float(group_of(name))
            groups.append({"params": params, "lr": lr * mult,
                           "lr_mult": mult, "name": name})
    return groups


def build_optimizer(model, retrain_cfg, model_type: str):
    """The optimizer of a RETRAIN config section (ActiveLearning.py:
    220-231) over `model`'s parameters, grouped by top-level module."""
    name = retrain_cfg["OPTIMIZER"]
    lr = float(retrain_cfg["LR"])
    if name == "AdamW":
        group_of = LR_GROUPS.get(model_type, lambda k: 1.0)
        return torch.optim.AdamW(
            _groups(model, group_of, lr), lr=lr,
            weight_decay=float(retrain_cfg.get("WEIGHT_DECAY", 0.0)))
    if name == "Adam":
        return torch.optim.Adam(_groups(model, lambda k: 1.0, lr), lr=lr)
    if name == "SGD":
        return torch.optim.SGD(_groups(model, lambda k: 1.0, lr), lr=lr,
                               momentum=0.9, weight_decay=0.0005)
    raise ValueError(f"Optimizer {name} not supported")


def set_lr(optimizer, lr: float):
    """Every group's learning rate to lr times its multiplier."""
    for g in optimizer.param_groups:
        g["lr"] = lr * g.get("lr_mult", 1.0)


def exponential_lr(base_lr: float, gamma: float):
    """ExponentialLR: lr(epoch) = base * gamma**epoch."""
    return lambda epoch: base_lr * (gamma ** epoch)


def multistep_lr(base_lr: float, milestones, factor: float):
    """MultiStepLR: decay by `factor` at each milestone epoch."""
    ms = sorted(milestones)

    def lr(epoch):
        k = sum(1 for m in ms if epoch >= m)
        return base_lr * (factor ** k)

    return lr


def with_warmup(lr_fn, warmup_epochs: int):
    """Linear epoch-level warmup: lr_fn scaled by (epoch+1)/warmup for the
    first `warmup_epochs` epochs (TRAIN.WARMUP_EPOCHS; for training from
    scratch, where full-LR first steps collapse the head)."""
    if warmup_epochs <= 0:
        return lr_fn
    return lambda epoch: lr_fn(epoch) * min(1.0, (epoch + 1) / warmup_epochs)
