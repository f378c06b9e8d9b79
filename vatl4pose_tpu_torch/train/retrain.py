"""Fine-tuning loops: the pose estimator and the WPU autoencoder
(counterpart of vatl4pose_tpu/train/retrain.py: `Retrainer`, `AETrainer`).

Parity: ActiveLearning.py:651-686 (retrain_model: AdamW with per-layer LR
groups, 0.5x masked MSE, ExponentialLR stepped per epoch, shuffled
batches) and :905-925 (retrain_AE).  The host draws every batch's sample
geometry from the trainer's numpy Generator in the JAX package's order;
the card does the rest of the step: the crop (kernels/rot_warp.py), the
Gaussian targets, the forward and backward, the optimizer and the PCK
accuracy.

The JAX package fuses steps into `lax.scan` chunks (STEP_CHUNK, a
`prewarm` compile, no-op padded steps) to cut dispatch through the TPU's
host link.  Eager PyTorch dispatches each step's kernels directly, so the
port runs one optimizer step per batch and none of that is ported; the
loss and accuracy still stay on the card until one fetch at the end.

bf16 (`bf16=True`, RETRAIN.BF16 or --speedup) is the JAX package's mixed
precision: bf16 copies of the parameters and bf16 activations go through
the forward and backward, while the f32 master weights, the optimizer's
state, the BatchNorm running statistics and the loss stay f32.  The
module's own parameters stay f32 between steps, so the scoring engine
folds BN from f32 weights.  `retrain_streaming` trains on the host warp's
crops (data/stream.CropStreamer) for frames that stay in host RAM.

Data parallel (`mesh=`, parallel/mesh.py; one process a rank): `retrain`
draws every step's geometry on every rank in the same rng order, and each
rank crops and trains its contiguous block of the batch through
parallel/steps.build_sharded_train_step (the JAX package's P(None,
"data") over its scan steps; a BATCH_SIZE that the 'data' axis does not
divide raises, as there).  `retrain_streaming` stays unsharded, as the JAX
package's `_step_crops` is: every rank runs the whole streamed step, then
rank 0's parameters, buffers and optimizer state are broadcast.
`AETrainer` is unsharded (ActiveLearning broadcasts rank 0's AE).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.pipeline import AugCfg, pad_to, train_sample_geometry
from ..device import resolve_device
from ..kernels.rot_warp import rot_warp_crop
from ..models.criterion import masked_heatmap_loss
from ..ops.heatmap import gaussian_target
from ..ops.warp import normalize_crops
from ..parallel import Sharding, broadcast_module, build_sharded_train_step
from ..utils.metrics import acc_tensor
from ..utils.profiling import span
from .optim import build_optimizer, exponential_lr, set_lr

__all__ = ["Retrainer", "AETrainer"]


def _weighted_stats(stats, counts):
    """Per-step (loss, acc) device rows -> sample-weighted averages, with one
    device-to-host fetch (DataLogger semantics, metrics.py:14-32)."""
    if not stats:
        return 0.0, 0.0
    arr = torch.stack(stats).cpu().numpy().astype(np.float64)
    w = np.asarray(counts, np.float64)
    loss_avg, acc_avg = (arr * w[:, None]).sum(0) / w.sum()
    return float(loss_avg), float(acc_avg)


def _check_model_device(model, device):
    p = next(model.parameters(), None)
    if p is not None and p.device.type != device.type:
        raise ValueError(f"the model is on {p.device}, the trainer on "
                         f"{device}")


class Retrainer:
    """Fine-tunes the pose estimator `model` (an nn.Module, trained in
    place) over a subset of one video's samples.  The optimizer state and
    `epoch_counter` live on the trainer and survive across calls, as the AL
    loop's continual mode needs; `reset_schedule` and `reset_optimizer`
    start them anew.  device=None means CUDA.  `mesh` (parallel.Mesh):
    data parallel over its 'data' axis; a mesh whose 'data' axis holds one
    rank trains as without one."""

    def __init__(self, model, retrain_cfg, model_type: str,
                 input_size=(256, 192), hm_size=(64, 48), sigma=2.0,
                 aug: Optional[AugCfg] = None, joint_pairs=None,
                 seed: int = 166, bf16: bool = False, mesh=None,
                 device=None):
        self.device = resolve_device(device)
        _check_model_device(model, self.device)
        self.model = model
        self.cfg = retrain_cfg
        self.model_type = model_type
        self.bf16 = bool(bf16 or retrain_cfg.get("BF16", False))
        self.input_size = tuple(input_size)
        self.hm_size = tuple(hm_size)
        self.sigma = float(sigma)
        self.aug = aug or AugCfg()
        self.joint_pairs = joint_pairs or []
        self.lr_of = exponential_lr(retrain_cfg["LR"],
                                    retrain_cfg.get("LR_GAMMA", 1.0))
        self.batch_size = retrain_cfg["BATCH_SIZE"]
        self.epoch_counter = 0
        self.rng = np.random.default_rng(seed)
        self.mesh = mesh if mesh is not None \
            and mesh.shape.get("data", 1) > 1 else None
        self.reset_optimizer()

    def reset_schedule(self):
        self.epoch_counter = 0

    def reset_optimizer(self):
        self.optimizer = build_optimizer(self.model, self.cfg,
                                         self.model_type)
        self._sharded_step = None if self.mesh is None \
            else build_sharded_train_step(self.model, self.optimizer,
                                          self.mesh, self._forward)

    def _upload(self, a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def train_step(self, frames, frame_idx, inv_mats, joints, vis, valid):
        """One optimizer step on one batch, at the groups' current learning
        rates, with the model in train mode.

        frames: (F, H, W, 3) uint8 on the trainer's device; frame_idx (N,),
        inv_mats (N, 2, 3) dst->src, joints (N, K, 2) in input space, vis
        (N, K), valid (N,) bool, as tensors on the device or numpy arrays.
        Returns the (2,) device tensor (loss, acc); the gradients stay in
        the parameters' `.grad`.  Under a mesh the operands are this
        rank's block of the batch, and loss, acc and the gradients the
        whole batch's."""
        # K3 writes the bf16 crops as the f32 crop rounded once, as the
        # JAX package casts its f32 crops
        crops = rot_warp_crop(frames, self._upload(frame_idx, torch.int64),
                              self._upload(inv_mats, torch.float32),
                              self.input_size, dtype=self._crop_dtype())
        return self._fit(crops, joints, vis, valid, self._sharded_step)

    def train_step_crops(self, crops_u8, joints, vis, valid):
        """One optimizer step on host-warped uint8 crops (N, oh, ow, 3),
        normalized on the device; otherwise as `train_step`, but never
        sharded."""
        return self._fit(normalize_crops(crops_u8, self.device,
                                         self._crop_dtype()),
                         joints, vis, valid)

    def _crop_dtype(self):
        return torch.bfloat16 if self.bf16 else torch.float32

    def _fit(self, crops, joints, vis, valid, sharded_step=None):
        f32 = torch.float32
        # (N, oh, ow, 3) is the channels-last layout of (N, 3, oh, ow); a
        # float64 model (a reference step) takes the crops in its dtype
        x = crops.permute(0, 3, 1, 2)
        if not self.bf16:
            x = x.to(next(self.model.parameters()).dtype)
        target, tw = gaussian_target(self._upload(joints, f32),
                                     self._upload(vis, f32), self.hm_size,
                                     self.sigma)
        mask = tw[:, :, None, None]
        if sharded_step is not None:
            return sharded_step(x, target, mask,
                                self._upload(valid, torch.bool))
        out = self._forward(x).to(f32)
        loss = masked_heatmap_loss(out, target, mask,
                                   valid=self._upload(valid, torch.bool))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        acc = acc_tensor(out.detach().float(), target * mask)
        return torch.stack([loss.detach().float(), acc])

    def _forward(self, x):
        """The model in train mode; under bf16 through bf16 copies of its
        f32 parameters (the casts are differentiated, so the f32 masters
        get f32 gradients; the BN buffers stay f32 and are updated in
        place, from f32 batch statistics: models/layers.BatchNorm2d)."""
        if not self.bf16:
            return self.model(x)
        params = {k: p.to(torch.bfloat16) if p.dtype == torch.float32
                  else p for k, p in self.model.named_parameters()}
        return torch.func.functional_call(self.model, params, (x,))

    @span("retrain.call")
    def retrain(self, data, frames, indices, num_epochs: int, img_wh,
                log=None):
        """`num_epochs` epochs over the samples `indices` of `data`
        (VideoPoseData); frames (F, H, W, 3) uint8, best kept on the device
        across calls.  Trains the model in place and returns the
        sample-weighted (loss, acc) averages."""
        frames = torch.as_tensor(frames, device=self.device)
        indices = np.asarray(indices, np.int64)
        bs = self.batch_size
        # every step's geometry first, in the rng order of a per-step loop
        lrs, ns, fi, mats, joints, vis, valid = ([] for _ in range(7))
        with span("retrain.geometry"):
            for _ in range(num_epochs):
                lr = self.lr_of(self.epoch_counter)
                order = self.rng.permutation(len(indices))
                for s in range(0, len(order), bs):
                    sel = indices[order[s:s + bs]]
                    # cycle-pad, not zero-pad: BatchNorm reduces over the whole
                    # batch, and equal replication keeps the batch statistics;
                    # `valid` keeps the replicas out of the loss
                    sel_p = np.resize(sel, bs)
                    m, _, j, v, _ = train_sample_geometry(
                        data.bboxes[sel_p], data.joints_xy[sel_p],
                        data.joints_vis[sel_p], img_wh, self.input_size,
                        self.aug, self.joint_pairs, self.rng)
                    ok = np.zeros(bs, bool)
                    ok[:len(sel)] = True
                    for lst, a in ((lrs, lr), (ns, len(sel)),
                                   (fi, data.frame_idx[sel_p]), (mats, m),
                                   (joints, j), (vis, v), (valid, ok)):
                        lst.append(a)
                self.epoch_counter += 1
        if not ns:
            return 0.0, 0.0
        with span("retrain.upload"):
            fi = np.stack(fi).astype(np.int64)
            if fi.min() < 0 or fi.max() >= frames.shape[0]:
                raise IndexError(f"frame index outside [0, {frames.shape[0]})")
            f32 = torch.float32
            steps = [fi, np.stack(mats), np.stack(joints), np.stack(vis),
                     np.stack(valid)]
            if self.mesh is not None:
                # this rank's block of every step's batch
                steps = [Sharding(self.mesh, (None, "data")).local(a)
                         for a in steps]
            fi, mats, joints, vis, valid = (
                self._upload(a, t) for a, t in zip(
                    steps, (torch.int64, f32, f32, f32, torch.bool)))
        stats = []
        was_training = self.model.training
        self.model.train()
        try:
            for k, lr in enumerate(lrs):
                set_lr(self.optimizer, lr)
                with span("retrain.step"):
                    stats.append(self.train_step(frames, fi[k], mats[k],
                                                 joints[k], vis[k],
                                                 valid[k]))
        finally:
            self.model.train(was_training)
        # accuracy over the cycled batch counts replicas of real rows too
        with span("retrain.stats"):
            loss_avg, acc_avg = _weighted_stats(stats, ns)
        if log:
            log(f"loss: {loss_avg:.7f} | acc: {acc_avg:.4f}")
        return loss_avg, acc_avg

    @span("retrain.call")
    def retrain_streaming(self, streamer, indices, num_epochs: int,
                          log=None):
        """`num_epochs` epochs over `indices` on the crops of `streamer`
        (data/stream.CropStreamer: its own seeded geometry, host-warped
        uint8 crops made ahead by a thread), for frames that stay in host
        RAM.  The last batch of an epoch is cycle-padded to the batch
        size, as in `retrain`.  Trains the model in place and returns the
        sample-weighted (loss, acc) averages."""
        bs = self.batch_size
        stats, counts = [], []
        was_training = self.model.training
        self.model.train()
        try:
            for _ in range(num_epochs):
                set_lr(self.optimizer, self.lr_of(self.epoch_counter))
                for crops, joints, vis, n in streamer.epoch(indices):
                    valid = np.zeros(bs, bool)
                    valid[:n] = True
                    crops, joints, vis = (np.resize(a, (bs,) + a.shape[1:])
                                          for a in (crops, joints, vis))
                    with span("retrain.step"):
                        stats.append(self.train_step_crops(crops, joints,
                                                           vis, valid))
                    counts.append(n)
                self.epoch_counter += 1
        finally:
            self.model.train(was_training)
        if self.mesh is not None:
            broadcast_module(self.model, self.mesh.group("data"),
                             self.optimizer)
        with span("retrain.stats"):
            loss_avg, acc_avg = _weighted_stats(stats, counts)
        if log:
            log(f"loss: {loss_avg:.7f} | acc: {acc_avg:.4f}")
        return loss_avg, acc_avg


class AETrainer:
    """WPU autoencoder fine-tuning (ActiveLearning.py:905-925): Adam, a
    masked MSE, a fixed number of epochs, batch 10, the last batch of an
    epoch zero-padded.  device=None means CUDA."""

    def __init__(self, lr: float, epochs: int, batch_size: int = 10,
                 seed: int = 318, device=None):
        self.device = resolve_device(device)
        self.lr = lr
        self.epochs = epochs
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    @span("ae.finetune")
    def train(self, ae, features: np.ndarray):
        """Fine-tune `ae` in place on (n, D) features with a fresh Adam;
        returns `ae`."""
        _check_model_device(ae, self.device)
        features = np.asarray(features, np.float32)
        n, bs = len(features), self.batch_size
        batches, valids = [], []
        for _ in range(self.epochs):
            order = self.rng.permutation(n)
            for s in range(0, n, bs):
                sel = order[s:s + bs]
                batches.append(pad_to(features[sel], bs))
                v = np.zeros(bs, np.float32)
                v[:len(sel)] = 1.0
                valids.append(v)
        if not batches:
            return ae
        feats = torch.as_tensor(np.stack(batches), device=self.device)
        valid = torch.as_tensor(np.stack(valids), device=self.device)
        opt = torch.optim.Adam(ae.parameters(), lr=self.lr)
        was_training = ae.training
        ae.train()
        try:
            for f, v in zip(feats, valid):
                sq = (ae(f) - f).square().mean(dim=-1)
                loss = (sq * v).sum() / v.sum().clamp(min=1)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
        finally:
            ae.train(was_training)
        return ae
