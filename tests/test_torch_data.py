"""The port's host input pipeline (``richsem_tpu_torch/data``) held against the
JAX package's (``richsem_tpu/data``), which decodes and resizes with OpenCV.

* Samplers: ``epoch_indices`` equal for RFS, CAS and shuffle, one shard and
  two.
* Transforms under the same ``random.Random``: the same draws in the same
  order (the generators end in the same state), equal labels and sizes, boxes
  to 1e-6, pixels within one uint8 level a resize on the way (the resize is
  within one level of OpenCV's, and a second resize can carry a difference on;
  one level is 1/255/0.224 = 0.0175 after normalization), and at most 2% of
  the values differing.
* ``DataLoader.epoch`` batches for two epochs on a synthetic LVIS directory,
  and a ``MultiDatasetLoader`` interleaving it with an image-folder dataset
  under Mosaic (three resizes on the way): every key equal, images as above.
"""

import json
import os
import random

import numpy as np
import pytest

from richsem_tpu.config import Config as JaxConfig
from richsem_tpu.data import datasets as jdatasets
from richsem_tpu.data import loader as jloader
from richsem_tpu.data import samplers as jsamplers
from richsem_tpu.data import transforms as jT
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.data import datasets, loader, samplers
from richsem_tpu_torch.data import transforms as T
from richsem_tpu_torch.data.synthetic import write_lvis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = 1.0 / 255.0 / 0.224 + 1e-6  # one uint8 level after normalization


def _img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 80 * np.sin(xx / 6.0) * np.cos(yy / 9.0)
    return np.clip(base[..., None] + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)


def _record(h, w, seed=0, n=5):
    rng = np.random.default_rng(seed + 100)
    x0, y0 = rng.uniform(0, w * 0.6, n), rng.uniform(0, h * 0.6, n)
    bw, bh = rng.uniform(4, w * 0.4, n), rng.uniform(4, h * 0.4, n)
    boxes = np.stack([x0, y0, np.minimum(x0 + bw, w), np.minimum(y0 + bh, h)], 1)
    return {"image": _img(h, w, seed), "boxes": boxes.astype(np.float32),
            "labels": rng.integers(1, 12, n).astype(np.int64),
            "area": ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).astype(np.float32),
            "iscrowd": np.zeros(n, np.int64), "image_id": seed, "orig_size": (h, w)}


def _close_images(a, b, levels):
    """Within ``levels`` uint8 levels (normalized or not), at most 2% differing."""
    assert a.shape == b.shape and a.dtype == b.dtype
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    assert diff.max() <= levels * (LEVEL if a.dtype == np.float32 else 1)
    assert (diff > 0).mean() <= 0.02


def _same_record(a, b, levels=1):
    assert set(a) == set(b)
    for k in a:
        if k == "image":
            _close_images(a[k], b[k], levels)
        elif k == "boxes":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", ["rfs", "cas", "shuffle"])
@pytest.mark.parametrize("num_shards", [1, 2])
def test_samplers_equal(name, num_shards):
    rng = np.random.default_rng(0)
    cats = [sorted(set(rng.integers(0, 30, rng.integers(0, 4)).tolist())) for _ in range(57)]
    for shard in range(num_shards):
        if name == "rfs":
            args = (cats, 30)
            kw = dict(repeat_thresh=0.05, shard_id=shard, num_shards=num_shards, seed=3)
            a, b = jsamplers.RepeatFactorSampler(*args, **kw), samplers.RepeatFactorSampler(*args, **kw)
        elif name == "cas":
            kw = dict(epoch_length=200, shard_id=shard, num_shards=num_shards, seed=3)
            a, b = jsamplers.ClassAwareSampler(cats, 30, **kw), samplers.ClassAwareSampler(cats, 30, **kw)
        else:
            a = jsamplers.ShuffleSampler(57, shard, num_shards, seed=3, pad_to_equal=True)
            b = samplers.ShuffleSampler(57, shard, num_shards, seed=3, pad_to_equal=True)
        for epoch in range(3):
            np.testing.assert_array_equal(a.epoch_indices(epoch), b.epoch_indices(epoch))


SCALES = ([96, 112, 128, 160], 200, [80, 100], (64, 96))


@pytest.mark.parametrize("hw", [(90, 130), (150, 110), (301, 211)])
def test_train_transform_equal(hw):
    tj, tp = jT.make_train_transform(*SCALES), T.make_train_transform(*SCALES)
    for seed in range(8):
        rec = _record(*hw, seed=seed)
        ra, rb = random.Random(seed), random.Random(seed)
        _same_record(tj(rec, ra), tp(rec, rb), levels=2)
        assert ra.random() == rb.random()  # the same draws were taken


def test_eval_transform_and_primitives_equal():
    tj, tp = jT.make_eval_transform([96, 128], 200), T.make_eval_transform([96, 128], 200)
    for hw in [(90, 130), (301, 211), (128, 64)]:
        rec = _record(*hw, seed=hw[0])
        _same_record(tj(rec), tp(rec))
        assert tj.size_hint(*hw) == tp.size_hint(*hw)
        _same_record(jT.hflip(rec), T.hflip(rec))
        _same_record(jT.crop(rec, 5, 7, 40, 50), T.crop(rec, 5, 7, 40, 50))
        _same_record(jT.resize(rec, 150, 170), T.resize(rec, 150, 170))


def test_mosaic_equal():
    recs = [_record(60 + 13 * i, 80 + 7 * i, seed=i) for i in range(4)]
    ra, rb = random.Random(5), random.Random(5)
    _same_record(jT.mosaic_compose(recs, ra, (96, 128)), T.mosaic_compose(recs, rb, (96, 128)))
    assert ra.random() == rb.random()


TINY_CFG = """_base_ = ["{base}"]
dataset_file = "lvis"
data_root = "{root}"
data_aug_scales = [64, 80, 96]
data_aug_max_size = 160
data_aug_scales2_resize = [56, 72]
data_aug_scales2_crop = [48, 64]
train_canvas_buckets = [(128, 192), (192, 128), (160, 160)]
eval_canvas = (128, 192)
max_gt_per_image = 8
num_classes = 13
imagenet_path = "{root}/imagenet-lvis"
imagenet_lvis_mapping = "{root}/imagenet-lvis/mapping.json"
imagenet_use_mosaic = True
seed = 42
"""


@pytest.fixture(scope="module")
def lvis_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lvis"))
    write_lvis(root, n_train=10, n_val=4, hw=((60, 80), (90, 120)), n_cats=12,
               max_boxes=6, seed=1, filters=(0, 1, 2, 3, 4))
    inet = os.path.join(root, "imagenet-lvis")
    from richsem_tpu_torch.data.image_io import encode_png

    for k, folder in enumerate(("n001", "n002", "n003")):
        os.makedirs(os.path.join(inet, folder))
        for j in range(2):
            with open(os.path.join(inet, folder, f"{j}.png"), "wb") as f:
                f.write(encode_png(_img(50 + 10 * j, 70 + 5 * k, seed=10 * k + j), 4))
    with open(os.path.join(inet, "mapping.json"), "w") as f:
        json.dump({"n001": 3, "n002": 5}, f)
    cfg_path = os.path.join(root, "tiny.py")
    with open(cfg_path, "w") as f:
        f.write(TINY_CFG.format(base=os.path.join(ROOT, "configs/richsem/dino_4scale_lvis.py"),
                                root=root))
    return cfg_path


def _same_batches(ja, pa, levels):
    ja, pa = list(ja), list(pa)
    assert len(ja) == len(pa) > 0
    for a, b in zip(ja, pa):
        assert set(a) == set(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k == "images":
                _close_images(a[k], b[k], levels)
            elif k == "boxes":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _loader(mod_ds, mod_loader, mod_samplers, cfg, split, **kw):
    ds = mod_ds.build_dataset(split, cfg)
    buckets = [tuple(b) for b in cfg.train_canvas_buckets]
    sampler = mod_samplers.RepeatFactorSampler(ds.category_ids_per_image(), cfg.num_classes,
                                               repeat_thresh=0.3, seed=cfg.seed)
    return mod_loader.DataLoader(ds, sampler, 2, buckets, cfg.max_gt_per_image, seed=cfg.seed,
                                 num_threads=3, **kw)


def test_loader_epochs_equal(lvis_root):
    jcfg, pcfg = JaxConfig.fromfile(lvis_root), Config.fromfile(lvis_root)
    ja = _loader(jdatasets, jloader, jsamplers, jcfg, "train")
    pa = _loader(datasets, loader, samplers, pcfg, "train")
    assert len(ja) == len(pa)
    for epoch in range(2):
        _same_batches(ja.epoch(epoch), pa.epoch(epoch), levels=2)
    jv = _loader(jdatasets, jloader, jsamplers, jcfg, "val", drop_last=False, pad_last=True)
    pv = _loader(datasets, loader, samplers, pcfg, "val", drop_last=False, pad_last=True)
    _same_batches(jv.epoch(0), pv.epoch(0), levels=1)


def test_multi_dataset_loader_with_mosaic_equal(lvis_root):
    out = []
    for ds_mod, ld_mod, sm_mod, cfg in ((jdatasets, jloader, jsamplers, JaxConfig.fromfile(lvis_root)),
                                        (datasets, loader, samplers, Config.fromfile(lvis_root))):
        main = _loader(ds_mod, ld_mod, sm_mod, cfg, "train")
        extra = ds_mod.build_dataset("train", cfg, imagenet_lvis=True)
        assert type(extra).__name__ == "MosaicDataset"
        buckets = [tuple(b) for b in cfg.train_canvas_buckets] + [(1280, 1280)]
        sub = ld_mod.DataLoader(extra, sm_mod.ShuffleSampler(len(extra), 0, 1, cfg.seed), 2,
                                buckets, cfg.max_gt_per_image, seed=cfg.seed + 1, num_threads=3)
        out.append(ld_mod.MultiDatasetLoader(main, sub, 1, 1))
    for epoch in range(2):
        _same_batches(out[0].epoch(epoch), out[1].epoch(epoch), levels=3)
