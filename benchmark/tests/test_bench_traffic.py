"""The traffic generator: a seed repeats exactly, every seed serves the same
set of shapes, and every image fits its canvas."""

import json

import torch

from benchmark.harness import core, traffic
from benchmark.tests import tiny


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


def test_seed_repeats_exactly():
    mix = tiny.mix("train-bs2")
    one, two = traffic.pool(mix, 12345, "cpu"), traffic.pool(mix, 12345, "cpu")
    assert all(_same(a, b) for a, b in zip(one, two))
    other = traffic.pool(mix, 2 ** 31 + 77, "cpu")
    assert not all(_same(a, b) for a, b in zip(one, other))


def test_every_seed_serves_the_same_shapes():
    mix = tiny.mix("train-bs2")

    def shapes(seed):
        pool = traffic.pool(mix, seed, "cpu")
        valid = sorted(tuple(int(v) for v in s) for b in pool for s in b["size"])
        gt = sorted(int(n) for b in pool for n in b["valid"].sum(1))
        return valid, gt

    assert shapes(3) == shapes(2 ** 31 + 5)


def test_mixes_fit_their_canvas_and_gt_mean():
    for name in ("eval-bs8", "eval-bs2", "train-bs2"):
        mix = core.load_json(f"benchmark/traffic/{name}.json")
        ch, cw = mix["canvas"]
        imgs = traffic.image_set(mix, 2000)
        assert all(vh <= ch and vw <= cw for vh, vw in (i["valid"] for i in imgs))
        if "gt" in mix:
            mean = sum(i["gt"] for i in imgs) / len(imgs)
            assert abs(mean - mix["gt"]["mean"]) < 1.0
            assert max(i["gt"] for i in imgs) <= mix["gt"]["slots"]


def test_labels_follow_the_frequency_groups():
    mix = json.loads(json.dumps(tiny.mix("train-bs2")))
    mix["gt"]["groups"] = [{"name": "rare", "classes": [866, 1203], "share": 1.0}]
    for batch in traffic.pool(mix, 9, "cpu"):
        lab = batch["labels"][batch["valid"]]
        assert ((lab >= 866) & (lab < 1203)).all()
