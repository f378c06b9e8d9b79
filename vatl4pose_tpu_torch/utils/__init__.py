"""Training metrics and profiling."""

from .metrics import acc_tensor, calc_accuracy
from .profiling import CycleTimer, span, trace
