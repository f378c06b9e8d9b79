"""Streaming data path (counterpart of vatl4pose_tpu/data/stream.py):
host-RAM frames and prefetched host-warped crops.

For a video whose decoded frames exceed the card's frame budget
(VAL.HBM_FRAME_BUDGET_GB; a JRDB-Pose stitched frame is 3760x480x3 =
5.41 MB) and for sets of mixed frame sizes.  Frames stay in host RAM,
decoded lazily into a byte-capped LRU; crops are made on the host by the
native warp (data/native_warp.py), grouped by frame shape; a prefetch
thread keeps batches in flight while the card trains on the previous one.
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np

from .dataset import decode_frame
from .pipeline import AugCfg, train_sample_geometry

__all__ = ["FrameStore", "CropStreamer", "warp_crops_host"]


class FrameStore:
    """Lazily decoded host-RAM frames with a byte-capped LRU cache."""

    def __init__(self, frame_paths: Sequence[str], frame_sizes: np.ndarray,
                 cache_bytes: int = 2 << 30):
        self.paths = list(frame_paths)
        self.sizes = np.asarray(frame_sizes, np.int64).reshape(-1, 2)
        self.cache_bytes = int(cache_bytes)
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._cached_bytes = 0
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.paths)

    @property
    def total_bytes(self) -> int:
        """Decoded size of every frame (the frame-budget estimate)."""
        return int((self.sizes[:, 0] * self.sizes[:, 1] * 3).sum())

    def get(self, idx: int) -> np.ndarray:
        with self._lock:
            if idx in self._cache:
                self._cache.move_to_end(idx)
                return self._cache[idx]
        img = np.ascontiguousarray(decode_frame(self.paths[idx]))
        with self._lock:
            self._cache[idx] = img
            self._cached_bytes += img.nbytes
            while self._cached_bytes > self.cache_bytes \
                    and len(self._cache) > 1:
                _, old = self._cache.popitem(last=False)
                self._cached_bytes -= old.nbytes
        return img


def warp_crops_host(store: FrameStore, frame_idx: np.ndarray,
                    fwd_mats: np.ndarray, out_hw,
                    mode: int = 1) -> np.ndarray:
    """(N, out_h, out_w, 3) uint8 crops by the native warp, grouped by
    frame shape (the warp takes one (F, H, W, C) stack a call)."""
    from . import native_warp

    frame_idx = np.asarray(frame_idx, np.int64)
    out = np.zeros((len(frame_idx), int(out_hw[0]), int(out_hw[1]), 3),
                   np.uint8)
    shapes = store.sizes[frame_idx]          # (N, 2) w, h
    for wh in np.unique(shapes, axis=0):
        sel = np.where((shapes == wh).all(axis=1))[0]
        uniq, local = np.unique(frame_idx[sel], return_inverse=True)
        stack = np.stack([store.get(int(f)) for f in uniq])
        out[sel] = native_warp.warp_affine_batch(
            stack, local.astype(np.int32), fwd_mats[sel], out_hw, mode=mode)
    return out


class CropStreamer:
    """Prefetched augmented training crops for the streaming train loop:
    the host draws the geometry and warps, the card's step takes ready
    uint8 crops."""

    def __init__(self, data, store: FrameStore, input_size, aug: AugCfg,
                 joint_pairs, batch_size: int, seed: int = 166,
                 warp_mode: int = 1, prefetch: int = 2):
        self.data = data
        self.store = store
        self.input_size = tuple(input_size)
        self.aug = aug
        self.joint_pairs = joint_pairs
        self.batch_size = int(batch_size)
        self.rng = np.random.default_rng(seed)
        self.warp_mode = warp_mode
        self.prefetch = prefetch
        self.item_wh = data.item_img_wh()

    def _make_batch(self, sel: np.ndarray):
        d = self.data
        _, _, joints, vis, fwd = train_sample_geometry(
            d.bboxes[sel], d.joints_xy[sel], d.joints_vis[sel],
            self.item_wh[sel], self.input_size, self.aug, self.joint_pairs,
            self.rng)
        crops = warp_crops_host(self.store, d.frame_idx[sel], fwd,
                                self.input_size, mode=self.warp_mode)
        return crops, joints, vis, len(sel)

    def epoch(self, indices: Sequence[int], shuffle: bool = True
              ) -> Iterable[tuple]:
        """Yield (crops_u8, joints, vis, n_valid) a batch, made ahead by a
        producer thread.  The geometry's random draws happen in submission
        order on that thread, so one seed gives one stream.  An exception
        in the producer is raised here, after the batches made before it;
        a consumer that stops early stops the producer."""
        indices = np.asarray(indices, np.int64)
        order = self.rng.permutation(len(indices)) if shuffle \
            else np.arange(len(indices))
        batches = [indices[order[s:s + self.batch_size]]
                   for s in range(0, len(order), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        err: list = []
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                for sel in batches:
                    if not put(self._make_batch(sel)):
                        return
            except BaseException as e:   # raised on the consumer's side
                err.append(e)
            put(None)

        t = threading.Thread(target=produce, daemon=True,
                             name="crop-streamer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
            t.join()
        if err:
            raise err[0]
