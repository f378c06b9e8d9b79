"""Active-learning engine: scoring, selection and the AL loop."""

from .active_learning import ActiveLearning
from .al_metric import (compute_alc, compute_corr, compute_spearmanr,
                        plot_learning_curves)
from .scoring import ScoringConfig, ScoringEngine
