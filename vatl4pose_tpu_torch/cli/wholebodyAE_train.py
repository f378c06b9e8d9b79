"""WholeBodyAE pre-training (counterpart of vatl4pose_tpu/cli/
wholebodyAE_train.py; scripts/wholebodyAE_train.py).

    python -m vatl4pose_tpu_torch.cli.wholebodyAE_train \\
        --ann_train <train json> --ann_val <val json> --zdim 4

The WPU autoencoder on the hybrid features of every annotated body
(data/wholebody.Wholebody): AdamW at 1e-3 (torch's default weight decay
0.01), set by hand to 2e-4 at epoch 12 and to 5e-5 at epoch 40, batches
of 10000 in an order drawn from np.random.default_rng(seed), MSE loss,
early stopping after --patience epochs without a better validation loss,
the best model's state_dict saved as WholeBodyAE_zdim{Z}.pth (the file the
AL loop reads from AE.PRETRAINED_ROOT/Hybrid/) and log.json with each
epoch's losses (wholebodyAE_train.py:90-184).  The model starts from
torch's init under --seed.  --device cpu runs on the CPU; otherwise CUDA
is required.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

__all__ = ["parse_args", "build_ae", "ae_lr", "train_ae", "main"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WholeBodyAE training (H100)")
    p.add_argument("--ann_train", type=str, required=True,
                   help="COCO-format annotation json for training features")
    p.add_argument("--ann_val", type=str, required=True)
    p.add_argument("--dataset_type", default="Posetrack21")
    p.add_argument("--zdim", type=int, default=4)
    p.add_argument("--epochs", type=int, default=80)
    p.add_argument("--batch", type=int, default=10000)
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--kp_direct", action="store_true")
    p.add_argument("--work_dir", default="./exp/wholebodyAE")
    p.add_argument("--seed", type=int, default=318)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; CUDA when not given")
    return p.parse_args(argv)


def build_ae(z_dim: int, input_dim: int, seed: int, device):
    """The autoencoder with torch's init under `seed`, on `device`."""
    import torch
    from ..models.wholebody_ae import WholeBodyAE
    torch.manual_seed(seed)
    return WholeBodyAE(z_dim=z_dim, input_dim=input_dim, device=device)


def ae_lr(epoch: int) -> float:
    """The reference's hand-set rate: 1e-3, 2e-4 from epoch 12, 5e-5 from
    epoch 40."""
    return 1e-3 if epoch < 12 else (2e-4 if epoch < 40 else 5e-5)


def train_ae(opt, feats_train, feats_val, device=None):
    """Trains a new autoencoder (build_ae) on (n, D) `feats_train`,
    validating on `feats_val` after each epoch; writes the best
    WholeBodyAE_zdim{Z}.pth and log.json under opt.work_dir.  Returns
    (the model with the best epoch's weights, the log, the best epoch)."""
    import torch
    from ..device import resolve_device

    device = resolve_device(device if device is not None
                            else getattr(opt, "device", None))
    feats_train = np.asarray(feats_train, np.float32)
    model = build_ae(opt.zdim, feats_train.shape[1], opt.seed, device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3,
                                  weight_decay=0.01)
    train_dev = torch.from_numpy(feats_train).to(device)
    val_dev = torch.as_tensor(np.asarray(feats_val, np.float32),
                              device=device)
    os.makedirs(opt.work_dir, exist_ok=True)
    path = os.path.join(opt.work_dir, f"WholeBodyAE_zdim{opt.zdim}.pth")
    rng = np.random.default_rng(opt.seed)
    best, best_epoch, log = np.inf, -1, []
    for epoch in range(opt.epochs):
        for g in optimizer.param_groups:
            g["lr"] = ae_lr(epoch)
        order = torch.from_numpy(rng.permutation(len(feats_train))).to(
            device)
        model.train()
        losses = []
        for s in range(0, len(order), opt.batch):
            batch = train_dev[order[s:s + opt.batch]]
            loss = (model(batch) - batch).square().mean()
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        tl = float(torch.stack(losses).double().sum())
        model.eval()
        with torch.no_grad():
            vl = float((model(val_dev) - val_dev).square().mean())
        log.append({"epoch": epoch, "train_loss": tl, "val_loss": vl})
        print(f"epoch {epoch}: train {tl:.6f} val {vl:.6f}", flush=True)
        if vl < best:
            best, best_epoch = vl, epoch
            best_state = {k: v.detach().cpu().clone()
                          for k, v in model.state_dict().items()}
            torch.save(best_state, path)
        elif epoch - best_epoch >= opt.patience:
            print(f"early stop at {epoch} (best {best:.6f} @ {best_epoch})")
            break
    with open(os.path.join(opt.work_dir, "log.json"), "w") as f:
        json.dump(log, f)
    if best_epoch >= 0:
        model.load_state_dict(best_state)
    return model, log, best_epoch


def main(argv=None):
    from ..data.wholebody import Wholebody
    from ..device import resolve_device
    opt = parse_args(argv)
    device = resolve_device(opt.device)
    np.random.seed(opt.seed)
    train_ds = Wholebody(opt.ann_train, opt.dataset_type,
                         kp_direct=opt.kp_direct)
    val_ds = Wholebody(opt.ann_val, opt.dataset_type,
                       kp_direct=opt.kp_direct)
    train_ae(opt, train_ds.features, val_ds.features, device)


if __name__ == "__main__":
    main()
