"""Training: optimizers with per-layer LR groups, the estimator retrainer
and the autoencoder fine-tuner."""

from .optim import (LR_GROUPS, build_optimizer, exponential_lr, multistep_lr,
                    set_lr, with_warmup)
from .retrain import AETrainer, Retrainer
