"""Sharded train and eval steps (counterpart of vatl4pose_tpu/parallel/
steps.py).

DP semantics of the JAX package's jit steps: the batch is sharded over the
mesh's 'data' axis and the parameters are replicated.  The state lives in
the module and the optimizer, as everywhere in the port; each rank passes
its own block of the batch.

  * The loss is `masked_heatmap_loss` over the *global* batch: each rank's
    term is its masked squared-error sum over the global denominator
    (the valid rows of all ranks, times K*h*w), so the ranks' terms add
    up to the one-process loss.  A padded batch puts its invalid rows on
    the last ranks (the retrainer cycle-pads with the valid rows first),
    so the ranks' valid counts differ: dividing by a local count, as
    DDP's gradient mean implies, would weigh the ranks wrongly.
  * The gradients are summed over the ranks (one coalesced all-reduce a
    dtype), which is the exact gradient of that global loss.  An explicit
    all-reduce after backward() keeps the module's parameter names (a DDP
    wrapper would rename them `module.*`, which the bf16 retrainer's
    torch.func.functional_call addresses by name).
  * BatchNorm's batch statistics are global (SyncBatchNorm semantics, with
    the Flax running-variance update): the forward runs inside `with
    mesh:` (models/layers.BatchNorm2d).
  * The reported loss and the PCK accuracy are the global batch's: the
    loss terms and each joint's counted and hit labels are summed over
    the ranks before the ratio.
"""

from __future__ import annotations

import torch

from ..models.criterion import masked_heatmap_loss
from ..utils.metrics import acc_counts, acc_from_counts
from .mesh import Mesh, all_gather, all_reduce_, all_reduce_grads

__all__ = ["build_sharded_train_step", "build_sharded_eval_step"]


def build_sharded_train_step(model, optimizer, mesh: Mesh, forward=None):
    """Returns step(x, target, mask, valid) -> (2,) tensor (loss, acc),
    both of the global batch.

    x (n, 3, H, W), target (n, K, h, w), mask (n, K, 1, 1) and valid (n,)
    bool are this rank's block; `forward(x)` (default `model`) gives the
    heatmaps in train mode.  One optimizer step of `optimizer` over
    `model`'s parameters, the same on every rank."""
    forward = forward or model
    group = mesh.group("data")

    def step(x, target, mask, valid):
        with mesh:
            out = forward(x).to(torch.float32)
        n_valid = all_reduce_(valid.sum().to(torch.float32), group)
        loss = masked_heatmap_loss(out, target, mask, valid=valid,
                                   n_valid=n_valid)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(model.parameters(), group)
        optimizer.step()
        num, hit = acc_counts(out.detach(), target * mask)
        counts = all_reduce_(torch.stack([num, hit]).to(torch.float32),
                             group)
        return torch.stack([all_reduce_(loss.detach().float(), group),
                            acc_from_counts(*counts)])

    return step


def build_sharded_eval_step(model, mesh: Mesh):
    """Returns step(x) -> (heatmaps (N, K, h, w), embeddings (N, E)) of
    the whole batch: each rank forwards its block x (n, 3, H, W) in eval
    mode and the blocks are gathered in rank order."""
    group = mesh.group("data")

    @torch.no_grad()
    def step(x):
        hm, emb = model(x, return_embedding=True)
        return all_gather(hm, group), all_gather(emb, group)

    return step
