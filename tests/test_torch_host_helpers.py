"""The port's host helpers held against the JAX package's:
``richsem_tpu_torch/data/misc_utils.py`` (the TSV dataset, the SSD random
crop, local staging), ``data/sltransforms.py`` (the photometric ops) and
``utils/box_losses.py`` (DIoU and CIoU).

* TSV: a file of base64 JPEG (one with an Exif orientation, which PIL's
  ``.convert("RGB")`` leaves alone) and PNG rows, the ``.lineidx`` sidecar
  byte for byte, every record exactly (the JAX helper decodes with PIL), a
  label map with an unmapped class.
* ``ssd_random_crop``: the same outputs from the same seed, exactly, over
  many seeds, with an empty box set too.
* Staging: files, a tree and a zip, the returned paths and the staged tree
  equal to JAX's; with two gloo ranks only rank 0 copies and both return
  after the barrier.
* The photometric ops and their composition under one ``random.Random``
  seed, exactly.
* DIoU and CIoU and their gradients against ``jax.grad``, f32 to 1e-6 and
  1e-5.
"""

import base64
import os
import random
import struct
import zipfile

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.data import misc_utils as jax_misc
from richsem_tpu.data import sltransforms as jax_slt
from richsem_tpu.utils import box_losses as jax_losses
from richsem_tpu_torch.data import image_io, misc_utils, sltransforms
from richsem_tpu_torch.parallel import dist as pdist
from richsem_tpu_torch.utils import box_losses

torch.set_num_threads(2)


def _img(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 80 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    return np.clip(base[..., None] + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)


def _exif6(data: bytes) -> bytes:
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, 6, 0) + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.fixture()
def tsv(tmp_path):
    rows = []
    for i in range(6):
        img = _img(20 + 3 * i, 30 + 5 * i, i)
        if i % 3 == 2:
            data = image_io.encode_png(img)
        else:
            ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85 + i])
            data = _exif6(buf.tobytes()) if i == 1 else buf.tobytes()
        rows.append(f"img{i}\t{i % 4}\t{base64.b64encode(data).decode()}")
    path = tmp_path / "data.tsv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _same_record(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("label_map", [None, {0: 7, 1: 3, 3: 0}], ids=["ids", "mapped"])
def test_tsv_records_equal_jax(tsv, label_map):
    port = list(misc_utils.tsv_records(tsv, label_map))
    with open(os.path.splitext(tsv)[0] + ".lineidx") as f:
        port_idx = f.read()
    os.remove(os.path.splitext(tsv)[0] + ".lineidx")
    ref = list(jax_misc.tsv_records(tsv, label_map))
    with open(os.path.splitext(tsv)[0] + ".lineidx") as f:
        assert f.read() == port_idx
    assert len(port) == len(ref) == 6
    for a, b in zip(port, ref):
        _same_record(a, b)
    if label_map is not None:  # class 2 is unmapped: an unlabeled image
        assert port[2]["labels"].shape == (0,) and port[2]["boxes"].shape == (0, 4)
    assert port[1]["image"].shape == (23, 35, 3)  # the Exif tag is left alone, as PIL


def test_tsv_file_random_access(tsv):
    a, b = misc_utils.TsvFile(tsv), jax_misc.TsvFile(tsv)
    assert len(a) == len(b) == 6
    for i in (5, 0, 3, 3, 1):
        assert a.seek(i) == b.seek(i)
    a.close()
    b.close()


@pytest.mark.parametrize("seed", range(12))
def test_ssd_random_crop_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    h, w = 60 + seed, 90 - seed
    image = rng.integers(0, 255, (h, w, 3), np.uint8)
    xy = rng.uniform(0, [w * 0.6, h * 0.6], (5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (5, 2))], 1).astype(np.float32)
    labels = np.arange(5)
    ref = jax_misc.ssd_random_crop(image, boxes, labels, np.random.default_rng(seed))
    out = misc_utils.ssd_random_crop(image, boxes, labels, np.random.default_rng(seed))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_ssd_random_crop_without_boxes_keeps_the_image():
    image = np.zeros((30, 40, 3), np.uint8)
    empty = np.zeros((0, 4), np.float32)
    for seed in range(4):
        ref = jax_misc.ssd_random_crop(image, empty, np.zeros(0), np.random.default_rng(seed))
        out = misc_utils.ssd_random_crop(image, empty, np.zeros(0), np.random.default_rng(seed))
        assert out[0] is image and ref[0] is image


def _sources(root):
    src = os.path.join(root, "src")
    os.makedirs(os.path.join(src, "tree", "sub"))
    with open(os.path.join(src, "a.json"), "w") as f:
        f.write('{"a": 1}')
    with open(os.path.join(src, "tree", "sub", "b.txt"), "w") as f:
        f.write("b")
    with zipfile.ZipFile(os.path.join(src, "imgs.zip"), "w") as zf:
        zf.writestr("imgs/x.bin", b"xyz")
    return ({"ann": os.path.join(src, "a.json"), "tree": os.path.join(src, "tree"),
             "imgs": os.path.join(src, "imgs.zip")})


def _targets(root):
    dst = os.path.join(root, "dst")
    return {"ann": os.path.join(dst, "ann", "a.json"), "tree": os.path.join(dst, "tree"),
            "imgs": os.path.join(dst, "imgs")}


def _listing(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_prepare_local_dataset_equals_jax(tmp_path):
    static = _sources(str(tmp_path))
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    out = misc_utils.prepare_local_dataset(_targets(port_root), static)
    ref = jax_misc.prepare_local_dataset(_targets(jax_root), static)
    assert [os.path.relpath(p, port_root) for p in out] == \
        [os.path.relpath(p, jax_root) for p in ref]
    assert _listing(port_root) == _listing(jax_root)
    assert open(os.path.join(port_root, "dst", "imgs", "x.bin"), "rb").read() == b"xyz"
    # a second call copies nothing new (the zip is extracted again, as in JAX)
    again = misc_utils.prepare_local_dataset(_targets(port_root), static)
    ref_again = jax_misc.prepare_local_dataset(_targets(jax_root), static)
    assert [os.path.relpath(p, port_root) for p in again] == \
        [os.path.relpath(p, jax_root) for p in ref_again] == [os.path.join("dst", "imgs")]


def _stage_rank(static, targets):
    d = pdist.init_distributed("cpu")
    out = misc_utils.prepare_local_dataset(targets, static, dist=d)
    # past the barrier rank 0's copies exist on every rank
    return d.rank, out, os.path.isfile(targets["ann"])


def test_prepare_local_dataset_copies_on_rank_0_only(tmp_path):
    static = _sources(str(tmp_path))
    r0, r1 = pdist.spawn(_stage_rank, 2, (static, _targets(str(tmp_path / "ranks"))),
                         timeout=120)
    assert r0[0] == 0 and r0[1] is not None and len(r0[1]) == 4 and r0[2]
    assert r1[0] == 1 and r1[1] is None and r1[2]


def _record(seed=0):
    return {"image": _img(24, 32, seed), "boxes": np.asarray([[1.0, 2.0, 9.0, 12.0]]),
            "labels": np.asarray([3])}


@pytest.mark.parametrize("factor", [0.0, 0.7, 1.0, 1.3, 2.5])
def test_brightness_and_contrast_equal_jax(factor):
    r = _record()
    _same_record(sltransforms.adjust_brightness(r, factor), jax_slt.adjust_brightness(r, factor))
    _same_record(sltransforms.adjust_contrast(r, factor), jax_slt.adjust_contrast(r, factor))


@pytest.mark.parametrize("seed", range(8))
def test_random_photometric_equals_jax(seed):
    r = _record(seed)
    out = sltransforms.random_photometric(r, random.Random(seed))
    ref = jax_slt.random_photometric(r, random.Random(seed))
    _same_record(out, ref)
    _same_record(sltransforms.lighting_noise(r, random.Random(seed)),
                 jax_slt.lighting_noise(r, random.Random(seed)))


def _box_pairs():
    rng = np.random.default_rng(3)
    xy1 = rng.uniform(0, 0.6, (64, 2))
    xy2 = np.where(rng.uniform(size=(64, 1)) < 0.5, xy1 + rng.normal(0, 0.03, (64, 2)),
                   rng.uniform(0, 0.6, (64, 2)))  # half overlap well (IoU >= 0.5)
    b1 = np.concatenate([xy1, xy1 + rng.uniform(0.05, 0.4, (64, 2))], 1)
    b2 = np.concatenate([xy2, xy2 + rng.uniform(0.05, 0.4, (64, 2))], 1)
    return b1.astype(np.float32).reshape(4, 16, 4), b2.astype(np.float32).reshape(4, 16, 4)


@pytest.mark.parametrize("name", ["diou_loss", "ciou_loss"])
def test_box_losses_and_grads_equal_jax(name):
    b1, b2 = _box_pairs()
    jfn = getattr(jax_losses, name)
    ref, ref_grads = jax.value_and_grad(lambda a, b: jfn(a, b).sum(), argnums=(0, 1))(
        jnp.asarray(b1), jnp.asarray(b2))
    ref_vals = np.asarray(jfn(jnp.asarray(b1), jnp.asarray(b2)))
    t1 = torch.from_numpy(b1).requires_grad_(True)
    t2 = torch.from_numpy(b2).requires_grad_(True)
    out = getattr(box_losses, name)(t1, t2)
    out.sum().backward()
    assert out.shape == (4, 16)
    np.testing.assert_allclose(out.detach().numpy(), ref_vals, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(out.detach().sum()), float(ref), rtol=1e-6)
    for g, r in zip((t1.grad, t2.grad), ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    if name == "ciou_loss":  # the aspect term is on for some pairs
        assert (out.detach().numpy() != np.asarray(jax_losses.diou_loss(
            jnp.asarray(b1), jnp.asarray(b2)))).any()
