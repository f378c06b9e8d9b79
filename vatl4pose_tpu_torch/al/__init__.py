"""Active-learning engine (the scoring pass so far)."""

from .scoring import ScoringConfig, ScoringEngine
