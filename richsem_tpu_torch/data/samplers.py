"""Long-tail training samplers (a copy of ``richsem_tpu/data/samplers.py``).

Capability parity with datasets/samplers.py:
  * ``RepeatFactorTrainingSampler`` (:9-147): per-class frequency
    ``f = image_count / N`` → category repeat ``max(1, sqrt(t/f))``; each
    image repeats by the max over its categories; stochastic rounding of
    the fractional part with a per-epoch seed; per-epoch shuffle; sharded
    by (shard_id, num_shards) stride.
  * ``ClassAwareSampler`` (:150-191): sample a class ∝ 1/frequency, then a
    uniform image containing it; fixed epoch length.

Pure-numpy/host code — these drive the input pipeline, not the device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class RepeatFactorSampler:
    def __init__(
        self,
        img_category_ids: Sequence[Sequence[int]],  # contiguous cat ids per image
        num_classes: int,
        repeat_thresh: float = 0.001,
        shard_id: int = 0,
        num_shards: int = 1,
        seed: int = 0,
    ):
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        n = len(img_category_ids)
        counts = np.zeros((num_classes,), np.float64)
        for cats in img_category_ids:
            for c in set(cats):
                counts[c] += 1
        freq = counts / max(n, 1)
        cat_repeat = np.maximum(
            1.0, np.sqrt(repeat_thresh / np.maximum(freq, 1e-12))
        )
        cat_repeat[counts == 0] = 1.0
        rf = np.ones((n,), np.float64)
        for i, cats in enumerate(img_category_ids):
            if len(cats):
                rf[i] = max(cat_repeat[c] for c in set(cats))
        self._int_part = np.floor(rf)
        self._frac_part = rf - self._int_part

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        rounded = self._int_part + (
            rng.random(len(self._frac_part)) < self._frac_part
        )
        indices = np.repeat(np.arange(len(rounded)), rounded.astype(np.int64))
        rng.shuffle(indices)
        return indices[self.shard_id :: self.num_shards]


class ClassAwareSampler:
    def __init__(
        self,
        img_category_ids: Sequence[Sequence[int]],
        num_classes: int,
        epoch_length: int = 120000,
        shard_id: int = 0,
        num_shards: int = 1,
        seed: int = 0,
    ):
        self.epoch_length = epoch_length
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.class_to_imgs: Dict[int, List[int]] = {}
        counts = np.zeros((num_classes,), np.float64)
        for i, cats in enumerate(img_category_ids):
            for c in set(cats):
                self.class_to_imgs.setdefault(c, []).append(i)
                counts[c] += 1
        present = sorted(self.class_to_imgs)
        w = 1.0 / np.maximum(counts[present], 1)
        self.present = np.asarray(present)
        self.class_probs = w / w.sum()

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        cls = rng.choice(self.present, size=self.epoch_length, p=self.class_probs)
        out = np.empty((self.epoch_length,), np.int64)
        for i, c in enumerate(cls):
            imgs = self.class_to_imgs[int(c)]
            out[i] = imgs[rng.integers(len(imgs))]
        return out[self.shard_id :: self.num_shards]


class ShuffleSampler:
    """Plain per-epoch shuffled sharded sampler (DistributedSampler parity).

    ``pad_to_equal`` wraps indices around so every shard gets the same
    count (torch DistributedSampler's padding) — required for multihost
    eval where every process must run the same number of batches (the
    per-batch cross-host allgather deadlocks otherwise). Duplicated eval
    images are deduplicated downstream by image_id.
    """

    def __init__(self, n: int, shard_id: int = 0, num_shards: int = 1, seed: int = 0,
                 shuffle: bool = True, pad_to_equal: bool = False):
        self.n = n
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.shuffle = shuffle
        self.pad_to_equal = pad_to_equal

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        if self.pad_to_equal and self.n % self.num_shards:
            pad = self.num_shards - self.n % self.num_shards
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.shard_id :: self.num_shards]
