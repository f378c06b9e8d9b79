"""Active-learning engine: scoring, selection and the AL loop."""

from .active_learning import ActiveLearning
from .scoring import ScoringConfig, ScoringEngine
