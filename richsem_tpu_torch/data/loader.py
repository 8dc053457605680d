"""Batching, bucketing, prefetching — the host input pipeline (a copy of
``richsem_tpu/data/loader.py``).

Replaces the reference's torch DataLoader worker processes + NestedTensor
collate (util/misc.py:286-428, main.py:250-266) with a TPU-first design:

  * **static canvas buckets**: every batch is padded onto one of a small,
    fixed set of (H, W) canvases (configs/richsem/base_data_aug.py) so XLA
    compiles one program per bucket instead of one per image shape — the
    reference pads each batch to its own max-size/32 shape, which on TPU
    would recompile constantly;
  * **padded targets**: GT arrays are fixed-width ``[B, max_gt]`` with a
    validity mask (replacing ragged per-image dicts);
  * **threaded prefetch**: decode+augment runs in a thread pool (zlib/numpy
    release the GIL) with a bounded queue, replacing worker processes;
  * ``MultiDatasetLoader`` (main.py:34-71): deterministic main:sub
    interleave at ``main_weight:sub_weight``; the sub loader restarts on
    exhaustion; an epoch ends with the main loader.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from richsem_tpu_torch.data import image_io
from richsem_tpu_torch.data.transforms import Record


def pick_bucket(
    shapes: Sequence[Tuple[int, int]], buckets: Sequence[Tuple[int, int]]
) -> Tuple[int, int]:
    """Smallest-area bucket that fits every (h, w); error if none fits."""
    best = None
    for bh, bw in buckets:
        if all(h <= bh and w <= bw for h, w in shapes):
            if best is None or bh * bw < best[0] * best[1]:
                best = (bh, bw)
    if best is None:
        raise ValueError(f"no bucket in {buckets} fits shapes {shapes}")
    return best


def collate(
    records: List[Record],
    buckets: Sequence[Tuple[int, int]],
    max_gt: int,
    canvas: Optional[Tuple[int, int]] = None,
) -> Dict[str, np.ndarray]:
    bh, bw = canvas or pick_bucket([r["size"] for r in records], buckets)
    b = len(records)
    images = np.zeros((b, bh, bw, 3), np.float32)
    pad_mask = np.ones((b, bh, bw), bool)
    labels = np.zeros((b, max_gt), np.int32)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    valid = np.zeros((b, max_gt), bool)
    sizes = np.zeros((b, 2), np.int32)
    orig = np.zeros((b, 2), np.int32)
    image_ids = np.zeros((b,), np.int64)
    is_extra = np.zeros((b,), bool)
    with_masks = any("masks" in r for r in records)
    if with_masks:
        gt_masks = np.zeros((b, max_gt, bh // 8, bw // 8), bool)
    for i, r in enumerate(records):
        h, w = r["size"]
        images[i, :h, :w] = r["image"]
        pad_mask[i, :h, :w] = False
        n = min(len(r["labels"]), max_gt)
        labels[i, :n] = r["labels"][:n]
        boxes[i, :n] = r["boxes"][:n]
        valid[i, :n] = True
        sizes[i] = (h, w)
        orig[i] = r["orig_size"]
        image_ids[i] = r["image_id"]
        is_extra[i] = r.get("is_extra", False)
        if with_masks and len(r.get("masks", ())):
            for j in range(n):
                mj = r["masks"][j].astype(np.uint8)
                small = image_io.resize(mj, (max(w // 8, 1), max(h // 8, 1)),
                                        image_io.INTER_NEAREST)
                gt_masks[i, j, : small.shape[0], : small.shape[1]] = small > 0
    out = {
        "images": images,
        "pad_mask": pad_mask,
        "labels": labels,
        "boxes": boxes,
        "valid": valid,
        "size": sizes,
        "orig_size": orig,
        "image_id": image_ids,
        "is_extra": is_extra,
    }
    if with_masks:
        out["masks"] = gt_masks
    return out


class DataLoader:
    """Threaded prefetching loader over a sampler + dataset."""

    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        buckets: Sequence[Tuple[int, int]],
        max_gt: int = 300,
        num_threads: int = 8,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        pad_last: bool = False,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.buckets = list(buckets)
        self.max_gt = max_gt
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        # pad_last: repeat trailing indices so the final batch has the full
        # batch_size (one compiled shape; eval dedups by image_id)
        self.pad_last = pad_last

    def __len__(self) -> int:
        n = len(self.sampler.epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _record_bucket(self, r: Record) -> Tuple[int, int]:
        return pick_bucket([r["size"]], self.buckets)

    def num_batches_hint(self, epoch: int = 0) -> Optional[int]:
        """Exact batch count when the dataset can predict post-transform
        sizes from metadata (deterministic eval transform) — used by
        multihost eval to equalize per-process batch counts without running
        the pipeline. None when sizes are augmentation-dependent."""
        size_hint = getattr(self.dataset, "size_hint", None)
        if size_hint is None:
            return None
        per_bucket: Dict[Tuple[int, int], int] = {}
        for i in self.sampler.epoch_indices(epoch):
            hw = size_hint(int(i))
            if hw is None:
                return None
            b = pick_bucket([hw], self.buckets)
            per_bucket[b] = per_bucket.get(b, 0) + 1
        nb = 0
        for n in per_bucket.values():
            nb += n // self.batch_size
            if n % self.batch_size and (self.pad_last or not self.drop_last):
                nb += 1
        return nb

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Stream records through the thread pool, grouping completed
        records by canvas bucket; a batch is emitted whenever a bucket
        group fills. (Batching per-bucket is what makes mixed portrait/
        landscape data feasible on static canvases: no single canvas fits
        both orientations of a shortest-side-800 resize.) Leftover partial
        groups at epoch end are padded (``pad_last``), emitted ragged
        (``drop_last=False``) or dropped."""
        indices = self.sampler.epoch_indices(epoch)
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()

        def build(pos: int):
            rng = random.Random(hash((self.seed, epoch, pos)))
            return self.dataset.get(int(indices[pos]), rng)

        def producer():
            try:
                from concurrent.futures import ThreadPoolExecutor

                groups: Dict[Tuple[int, int], List[Record]] = {}
                with ThreadPoolExecutor(self.num_threads) as pool:
                    futures = [
                        pool.submit(build, i) for i in range(len(indices))
                    ]
                    for f in futures:
                        if stop.is_set():
                            for g in futures:
                                g.cancel()
                            return
                        r = f.result()
                        key = self._record_bucket(r)
                        grp = groups.setdefault(key, [])
                        grp.append(r)
                        if len(grp) == self.batch_size:
                            q.put(("ok", collate(grp, self.buckets,
                                                 self.max_gt, canvas=key)))
                            groups[key] = []
                # flush leftovers
                for key, grp in groups.items():
                    if not grp or stop.is_set():
                        continue
                    if self.pad_last:
                        base = list(grp)
                        while len(grp) < self.batch_size:
                            grp.append(base[(len(grp) - len(base)) % len(base)])
                        q.put(("ok", collate(grp, self.buckets,
                                             self.max_gt, canvas=key)))
                    elif not self.drop_last:
                        q.put(("ok", collate(grp, self.buckets,
                                             self.max_gt, canvas=key)))
                q.put(("done", None))
            except Exception as e:  # surface worker errors to the consumer
                q.put(("err", e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise item
                yield item
        finally:
            stop.set()


class MultiDatasetLoader:
    """Deterministic main/sub interleave (main.py:34-71)."""

    def __init__(self, main_loader, sub_loader, main_weight: int = 1, sub_weight: int = 1):
        self.main_loader = main_loader
        self.sub_loader = sub_loader
        self.main_weight = main_weight
        self.sub_weight = sub_weight

    def __len__(self) -> int:
        n = len(self.main_loader)
        return n + n * self.sub_weight // self.main_weight

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        main_it = self.main_loader.epoch(epoch)
        sub_epoch = epoch
        sub_it = self.sub_loader.epoch(sub_epoch)
        pattern = [True] * self.main_weight + [False] * self.sub_weight
        i = 0
        while True:
            use_main = pattern[i % len(pattern)]
            i += 1
            if use_main:
                try:
                    yield next(main_it)
                except StopIteration:
                    return
            else:
                try:
                    yield next(sub_it)
                except StopIteration:
                    sub_epoch += 1  # sub loader restarts (main.py:64-69)
                    sub_it = self.sub_loader.epoch(sub_epoch)
                    yield next(sub_it)
