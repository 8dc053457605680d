"""The one traffic generator: a mix file of parameters -> a pool of batches.

A mix (``benchmark/traffic/<name>.json``) gives the batch size, the canvas
bucket, the pool size, the original image sizes, the resize rule and, for
training, the ground truth per image. The set of per-image shapes (original
size, valid extent, GT count) is drawn from the mix's own ``set_seed``, so
every run seed serves the same work; the run seed orders that set and draws
the pixels, boxes and labels. Pixels are drawn on the device.

Image sizes: LVIS v1 images are COCO 2017 images, mostly 640 pixels on the
long side with 4:3, 3:2, 16:9, 5:4 and 1:1 shapes (the mix lists the shares
it assumes). The valid extent is the image resized as the pipeline resizes it
(the short side to one of ``short`` sides, the long side at most
``max_long``), and must fit the canvas. Ground truth (training): a GT count
per image from a log-normal with the mix's mean, at least 1 and at most the
slots; labels from the frequency groups of the classes at the mix's shares;
boxes with centres uniform in the image and sides log-uniform.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch


def image_set(mix: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The mix's ``n`` per-image shapes, from its ``set_seed``: ``orig`` (h, w),
    ``valid`` (h, w) in the canvas and, for training, ``gt`` (a count)."""
    rng = np.random.default_rng(mix["set_seed"])
    ch, cw = mix["canvas"]
    sizes = mix["image_sizes"]
    aspects = np.asarray([a for a, _ in sizes["aspects"]], float)
    shares = np.asarray([s for _, s in sizes["aspects"]], float)
    out = []
    for _ in range(n):
        long = int(sizes["long"]) if rng.random() < sizes["long_share"] else int(
            rng.integers(sizes["long_min"], sizes["long"]))
        aspect = float(aspects[rng.choice(len(aspects), p=shares / shares.sum())])
        oh, ow = int(round(long / aspect)), long  # landscape: the canvas is wider
        short = int(rng.choice(mix["resize"]["short"]))
        s = min(short / min(oh, ow), mix["resize"]["max_long"] / max(oh, ow))
        vh, vw = int(round(oh * s)), int(round(ow * s))
        if vh > ch or vw > cw:
            raise ValueError(f"an image of {oh}x{ow} resizes to {vh}x{vw}, past the "
                             f"{ch}x{cw} canvas")
        img = {"orig": (oh, ow), "valid": (vh, vw)}
        if "gt" in mix:
            g = mix["gt"]
            sigma = g["sigma"]
            mu = math.log(g["mean"]) - sigma * sigma / 2
            img["gt"] = int(min(max(round(rng.lognormal(mu, sigma)), 1), g["slots"]))
        out.append(img)
    return out


def _labels(rng: np.random.Generator, groups, n: int) -> np.ndarray:
    """``n`` class ids: a frequency group by its share, then a class of it uniformly."""
    shares = np.asarray([g["share"] for g in groups], float)
    pick = rng.choice(len(groups), size=n, p=shares / shares.sum())
    lo = np.asarray([g["classes"][0] for g in groups])[pick]
    hi = np.asarray([g["classes"][1] for g in groups])[pick]
    return lo + (rng.random(n) * (hi - lo)).astype(np.int64)


def pool(mix: Dict[str, Any], seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The run's pool of ``mix["pool"]`` batches of ``mix["batch"]`` images,
    on ``device``, in the layout the port's steps take."""
    b, n_batches = mix["batch"], mix["pool"]
    ch, cw = mix["canvas"]
    rng = np.random.default_rng([seed, 1])
    shapes = image_set(mix, b * n_batches)
    order = rng.permutation(len(shapes))
    g = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    batches = []
    for i in range(n_batches):
        imgs = [shapes[j] for j in order[i * b:(i + 1) * b]]
        images = torch.zeros(b, ch, cw, 3, device=device)
        pad = torch.ones(b, ch, cw, dtype=torch.bool, device=device)
        for k, im in enumerate(imgs):
            vh, vw = im["valid"]
            images[k, :vh, :vw] = torch.randn(vh, vw, 3, generator=g, device=device)
            pad[k, :vh, :vw] = False
        batch = {"images": images, "pad_mask": pad,
                 "orig_size": torch.tensor([im["orig"] for im in imgs], dtype=torch.int32,
                                           device=device),
                 "size": torch.tensor([im["valid"] for im in imgs], dtype=torch.int32,
                                      device=device)}
        if "gt" in mix:
            batch.update(ground_truth(mix["gt"], imgs, rng, device))
        batches.append(batch)
    return batches


def ground_truth(g: Dict[str, Any], imgs, rng: np.random.Generator, device
                 ) -> Dict[str, torch.Tensor]:
    """``labels [B, slots]``, ``boxes [B, slots, 4]`` (normalised cxcywh) and
    ``valid [B, slots]`` for the images' GT counts, and ``is_extra`` (none)."""
    b, slots = len(imgs), g["slots"]
    labels = np.zeros((b, slots), np.int64)
    boxes = np.tile(np.asarray([0.5, 0.5, 0.1, 0.1], np.float32), (b, slots, 1))
    valid = np.zeros((b, slots), bool)
    lo, hi = np.log(g["side"][0]), np.log(g["side"][1])
    for k, im in enumerate(imgs):
        n = im["gt"]
        labels[k, :n] = _labels(rng, g["groups"], n)
        wh = np.exp(rng.uniform(lo, hi, (n, 2)))
        c = rng.uniform(wh / 2, 1 - wh / 2)
        boxes[k, :n] = np.concatenate([c, wh], 1)
        valid[k, :n] = True
    return {"labels": torch.from_numpy(labels).to(device),
            "boxes": torch.from_numpy(boxes).to(device),
            "valid": torch.from_numpy(valid).to(device),
            "is_extra": torch.zeros(b, dtype=torch.bool, device=device)}
