"""JRDB-Pose estimator pre-training (counterpart of vatl4pose_tpu/cli/
jrdbpose_train.py; scripts/jrdbpose_train.py).

    python -m vatl4pose_tpu_torch.cli.jrdbpose_train --cfg <jrdb cfg>

The reference's jrdbpose_train.py repeats posetrack_train.py (the same
loss, optimizer and DPG machinery); what is JRDB's lives in the data
layer: the JRDB2022 dataset type with its 3-digit track-id suffix, JRDB's
joint pairs for flipping and stitched-scene frame sizes.  This entry point
shares posetrack_train's trainer and requires a JRDB2022 training set;
its --synthetic fixture writes JRDB-style 3-digit annotation ids.
"""

from __future__ import annotations

from .posetrack_train import parse_args, synthetic_train_set, train

__all__ = ["check_jrdb", "main"]


def check_jrdb(cfg):
    """The guard: DATASET.TRAIN must be a JRDB2022 set."""
    assert cfg.DATASET.TRAIN.TYPE == "JRDB2022", (
        "jrdbpose_train expects a JRDB2022 training dataset "
        f"(got {cfg.DATASET.TRAIN.TYPE}); use posetrack_train otherwise")


def main(argv=None):
    import numpy as np

    from ..config import update_config
    from ..device import resolve_device
    opt = parse_args(argv)
    resolve_device(opt.device)
    cfg = update_config(opt.cfg)
    np.random.seed(opt.seed)
    if opt.synthetic:
        # JRDB2022's composite-id sort takes the last THREE ann-id digits
        cfg = synthetic_train_set(cfg, opt, prefix="vatl_jrdb_pretrain_",
                                  track_digits=3)
        cfg.DATASET.TRAIN.TYPE = "JRDB2022"
    check_jrdb(cfg)
    return train(cfg, opt)


if __name__ == "__main__":
    main()
