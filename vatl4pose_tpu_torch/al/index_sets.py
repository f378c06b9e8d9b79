"""Labeled/unlabeled index bookkeeping (the port's own copy of
vatl4pose_tpu/al/index_sets.py).

alipy.index.IndexCollection as the reference uses it
(ActiveLearning.py:119-120,629-637): ordered, duplicate-free integer
collections with update / difference_update.
"""

from __future__ import annotations

from typing import Iterable, List


class IndexCollection:
    def __init__(self, data: Iterable[int] = ()):  # keeps insertion order
        self._index: List[int] = []
        self._seen = set()
        self.update(data)

    @property
    def index(self) -> List[int]:
        return list(self._index)

    def update(self, items: Iterable[int]):
        for it in items:
            it = int(it)
            if it not in self._seen:
                self._seen.add(it)
                self._index.append(it)
        return self

    def difference_update(self, items: Iterable[int]):
        rm = {int(i) for i in items}
        self._index = [i for i in self._index if i not in rm]
        self._seen -= rm
        return self

    def __contains__(self, item):
        return int(item) in self._seen

    def __len__(self):
        return len(self._index)

    def __iter__(self):
        return iter(self._index)
