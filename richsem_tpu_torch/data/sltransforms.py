"""Photometric ("SLT") augmentation ops (counterpart of
``richsem_tpu/data/sltransforms.py``): brightness, contrast, the channel
permutation of ``LightingNoise`` and their random composition, in numpy over
the port's records (``data/transforms.py``). Boxes are untouched."""

from __future__ import annotations

import random

import numpy as np

from richsem_tpu_torch.data.transforms import Record

_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def adjust_brightness(r: Record, factor: float) -> Record:
    r = dict(r)
    img = r["image"].astype(np.float32) * factor
    r["image"] = np.clip(img, 0, 255).astype(r["image"].dtype)
    return r


def adjust_contrast(r: Record, factor: float) -> Record:
    r = dict(r)
    img = r["image"].astype(np.float32)
    mean = img.mean(axis=(0, 1), keepdims=True)
    r["image"] = np.clip(mean + (img - mean) * factor, 0, 255).astype(r["image"].dtype)
    return r


def lighting_noise(r: Record, rng: random.Random) -> Record:
    """A random permutation of the RGB channels."""
    r = dict(r)
    perm = _PERMS[rng.randrange(len(_PERMS))]
    r["image"] = np.ascontiguousarray(r["image"][:, :, perm])
    return r


def random_photometric(r: Record, rng: random.Random, brightness_range=(0.7, 1.3),
                       contrast_range=(0.7, 1.3), prob: float = 0.5) -> Record:
    """Each op applied independently with ``prob``, in the JAX function's order
    of draws."""
    if rng.random() < prob:
        r = adjust_brightness(r, rng.uniform(*brightness_range))
    if rng.random() < prob:
        r = adjust_contrast(r, rng.uniform(*contrast_range))
    if rng.random() < prob:
        r = lighting_noise(r, rng)
    return r
