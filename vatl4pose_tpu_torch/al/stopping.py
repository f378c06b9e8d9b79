"""Stopping criteria utilities (the port's own copy of
vatl4pose_tpu/al/stopping.py).

alipy.experiment.StoppingCriteria (vendored ALiPy,
stopping_criteria.py:23-80): instantiated by the reference
(ActiveLearning.py:109) though never consulted; provided for API
completeness.  The three criteria the AL loop tracks per round (actual
finish, min-error, "our SC") live in ActiveLearning._is_finished.
"""

from __future__ import annotations

import time
from typing import Optional


class StoppingCriteria:
    """ALiPy-compatible: criteria in {None, 'num_of_queries', 'cost_limit',
    'percent_of_unlabel', 'time_limit'}; None = stop when the pool drains."""

    def __init__(self, stopping_criteria: Optional[str] = None, value=None):
        allowed = (None, "num_of_queries", "cost_limit",
                   "percent_of_unlabel", "time_limit")
        if stopping_criteria not in allowed:
            raise ValueError(f"invalid criterion {stopping_criteria}")
        self._criteria = stopping_criteria
        if stopping_criteria == "time_limit":
            self._start_time = time.perf_counter()
        self.value = value
        self._current_iter = 0
        self._accum_cost = 0
        self._current_unlabel = 100
        self._percent = 0

    def update_information(self, saver):
        """saver: StateIO-like with cost/percent bookkeeping."""
        if self._criteria == "num_of_queries":
            self._current_iter = len(saver)
        elif self._criteria == "cost_limit":
            self._accum_cost = getattr(saver, "cost_inall", 0)
        elif self._criteria == "percent_of_unlabel":
            _, _, ul, _ = saver.get_workspace()
            self._current_unlabel = len(ul)
        return self

    def is_stop(self) -> bool:
        if self._criteria is None:
            return self._current_unlabel == 0
        if self._criteria == "num_of_queries":
            return self._current_iter >= self.value
        if self._criteria == "cost_limit":
            return self._accum_cost >= self.value
        if self._criteria == "percent_of_unlabel":
            return self._percent >= self.value
        if self._criteria == "time_limit":
            return time.perf_counter() - self._start_time >= self.value
        return False

    def reset(self):
        self.__init__(self._criteria, self.value)
