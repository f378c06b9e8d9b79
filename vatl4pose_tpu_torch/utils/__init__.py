"""Training metrics."""

from .metrics import acc_tensor, calc_accuracy
