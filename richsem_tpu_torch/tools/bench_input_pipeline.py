"""Host input-pipeline throughput at production settings (counterpart of
``tools/bench_input_pipeline.py``).

    python -m richsem_tpu_torch.tools.bench_input_pipeline [--images N] [--threads T]
        [--batch B] [--chip-rate R]

Writes a synthetic corpus at LVIS-like sizes (LVIS rides COCO's images, at
most 640 px a side) with LVIS's annotation density (11 boxes an image), then
drives the port's production train pipeline: ``CocoIndex`` ->
``DetectionDataset`` -> ``make_train_transform`` (multi-scale resize, crop,
flip, normalise; ``configs/richsem/base_data_aug.py``) -> the threaded
``DataLoader`` with the shipped canvas buckets, ``max_gt_per_image``, 8
threads and a prefetch of 4, and reports the images/s it sustains on the
host. No device is involved.

The corpus is the JAX tool's: the same sizes, the same smooth noise and boxes
from ``numpy.random.default_rng(0)``, written as JPEG at quality 90 by the
port's codec (``data/image_io.py:encode_jpeg``, which writes the bytes
``cv2.imwrite`` writes; the noise is upsampled with the port's ``resize``,
within one level of ``cv2.resize``), and read back by the port's decoder
(``decode_jpeg``, ``csrc/jpeg_host.c``). The metric says "JPEG corpus".

Prints ONE JSON line with the JAX tool's keys: the host's img/s, per core,
the cores, threads and images, the corpus' generation seconds and the ratio
to a chip's train rate (``--chip-rate``, by default 5.0 img/s); and beside
them ``decode_ms``, the codec's decode time an image on one host thread over
the corpus (every file once, after one warm-up decode).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict

import numpy as np

from richsem_tpu_torch.bench import CONFIG

# LVIS rides COCO images: max side 640, common aspect ratios
CORPUS_SIZES = [
    (480, 640), (640, 480), (427, 640), (640, 427), (612, 612),
    (426, 640), (640, 426), (375, 500), (500, 375), (480, 640),
]
ANNS_PER_IMAGE = 11  # LVIS v1 train mean 11.2
NUM_CLASSES = 1203
N_WARM = 5  # warm-up batches (first touches), fewer on a small corpus
JPEG_QUALITY = 90  # the JAX tool's IMWRITE_JPEG_QUALITY


def decode_ms(img_dir: str) -> float:
    """The codec's decode ms an image on this thread: every file of
    ``img_dir`` once, after one warm-up decode (the codec's build and load)."""
    from richsem_tpu_torch.data.image_io import decode_jpeg

    blobs = []
    for name in sorted(os.listdir(img_dir)):
        with open(os.path.join(img_dir, name), "rb") as f:
            blobs.append(f.read())
    decode_jpeg(blobs[0])
    t0 = time.perf_counter()
    for b in blobs:
        decode_jpeg(b)
    return (time.perf_counter() - t0) * 1e3 / len(blobs)


def make_corpus(root: str, n_images: int, seed: int = 0) -> str:
    """Write ``n_images`` JPEGs (quality 90) and a COCO-format annotation file
    under ``root``. -> the annotation file's path."""
    from richsem_tpu_torch.data.image_io import INTER_LINEAR, encode_jpeg, resize

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        h, w = CORPUS_SIZES[i % len(CORPUS_SIZES)]
        # smooth noise: decode cost between flat and white noise, like natural images
        base = rng.integers(0, 255, (h // 8, w // 8, 3), np.uint8)
        img = resize(base, (w, h), interpolation=INTER_LINEAR)
        fname = f"{i:08d}.jpg"
        with open(os.path.join(img_dir, fname), "wb") as f:
            # cv2.imwrite takes the array as BGR: the file's RGB is it reversed
            f.write(encode_jpeg(np.ascontiguousarray(img[..., ::-1]), JPEG_QUALITY))
        images.append({"id": i + 1, "file_name": fname, "height": h, "width": w})
        for _ in range(ANNS_PER_IMAGE):
            x = float(rng.uniform(0, w * 0.7))
            y = float(rng.uniform(0, h * 0.7))
            bw = float(rng.uniform(8, w - x))
            bh = float(rng.uniform(8, h - y))
            annotations.append({
                "id": ann_id, "image_id": i + 1,
                "category_id": int(rng.integers(0, NUM_CLASSES)),
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
            })
            ann_id += 1
    ann = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c, "name": f"c{c}"} for c in range(NUM_CLASSES)],
    }
    ann_path = os.path.join(root, "ann.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return ann_path


class _SeqSampler:
    def __init__(self, n):
        self.n = n

    def epoch_indices(self, epoch):
        return np.arange(self.n)


def bench_line(n_images: int = 400, threads: int = 8, batch: int = 2,
               chip_rate: float = 5.0) -> Dict[str, Any]:
    """Write the corpus into a temporary directory, run one epoch through the
    pipeline, time it after the warm-up batches. -> the JSON line."""
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.data.coco_api import CocoIndex
    from richsem_tpu_torch.data.datasets import DetectionDataset
    from richsem_tpu_torch.data.loader import DataLoader
    from richsem_tpu_torch.data.transforms import make_train_transform

    cfg = Config.fromfile(CONFIG)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.time()
        ann_path = make_corpus(root, n_images)
        gen_s = time.time() - t0
        dec_ms = decode_ms(os.path.join(root, "imgs"))
        tf = make_train_transform(
            cfg.data_aug_scales, cfg.data_aug_max_size,
            cfg.data_aug_scales2_resize, tuple(cfg.data_aug_scales2_crop),
        )
        ds = DetectionDataset(os.path.join(root, "imgs"), CocoIndex(ann_path), tf,
                              is_train=True)
        loader = DataLoader(
            ds, _SeqSampler(len(ds)), batch_size=batch,
            buckets=cfg.train_canvas_buckets, max_gt=cfg.max_gt_per_image,
            num_threads=threads, prefetch=4,
        )
        it = loader.epoch(0)
        # bucket grouping drops at most one partial group a bucket, so a
        # quarter of the corpus' batches leaves batches to time
        for _ in range(min(N_WARM, n_images // (4 * batch))):
            next(it)
        t0 = time.time()
        n_imgs = 0
        for b in it:
            n_imgs += b["images"].shape[0]
        dt = time.time() - t0
    if n_imgs == 0:
        raise RuntimeError(f"no batch left to time after the warm-up ({n_images} images)")
    rate = n_imgs / dt
    cores = len(os.sched_getaffinity(0))
    return {
        "metric": "host input pipeline images/sec (decode+aug+collate, production train "
                  "transform + canvas buckets; JPEG corpus)",
        "value": rate,
        "unit": "images/sec",
        "cores": cores,
        "per_core": rate / cores,
        "threads": threads,
        "images": n_imgs,
        "corpus_gen_s": gen_s,
        "chip_rate": chip_rate,
        "ratio_to_chip": rate / chip_rate,
        "decode_ms": dec_ms,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=400)
    ap.add_argument("--threads", type=int,
                    default=int(os.environ.get("BENCH_PIPE_THREADS", "8")))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--chip-rate", type=float, default=5.0,
                    help="train img/s a chip to compare against")
    args = ap.parse_args(argv)
    print(json.dumps(bench_line(args.images, args.threads, args.batch, args.chip_rate)),
          flush=True)


if __name__ == "__main__":
    main()
