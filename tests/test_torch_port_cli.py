"""multiposenet_tpu_torch.cli against the JAX package's CLI, and end to end
on the CPU (``MPN_PLATFORM=cpu``): ``build_config`` field by field for
each subnet and flag, the loaders of both packages over one tree, then
``train`` (resnet50, 64 px, batch 2, 1 epoch), ``val``, ``coco-eval`` with
a metrics file, two ``--eval-shard``s and ``merge-results`` equal to the
unsharded stats and result rows, and ``test`` on a PNG directory; and the
raise when no GPU is present and the CPU was not asked for."""

import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from multiposenet_tpu import cli as jcli

import chip_smoke
from multiposenet_tpu_torch import cli


def _args(**kw):
    base = dict(backbone="resnet101", coco_root="/data/COCO/", ckpt=None,
                exp_name=None, inp_size=None, batch_size=None, lr=None,
                max_epoch=None, num_workers=8, save_dir="./extra/models",
                bf16=False)
    base.update(kw)
    return argparse.Namespace(**base)


FLAGS = {
    "defaults": {},
    "overrides": dict(backbone="resnet50", coco_root="/tmp/coco", ckpt="/tmp/c",
                      exp_name="e", inp_size=96, batch_size=3, lr=2e-3,
                      max_epoch=7, num_workers=2, save_dir="/tmp/s"),
    "bf16": dict(bf16=True),
}


def _same(port, ref, where):
    """Every field of the port's dataclass equals the JAX one's (dtypes by
    name)."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _same(a, b, f"{where}.{f.name}")
        elif f.name == "compute_dtype":
            assert str(a).split(".")[-1] == np.dtype(b).name, where
        else:
            assert a == b, (f"{where}.{f.name}", a, b)


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("subnet", ["keypoint", "detection", "prn", None])
def test_build_config_matches_jax(subnet, flags):
    args = _args(**FLAGS[flags])
    _same(cli.build_config(args, subnet), jcli.build_config(args, subnet), "cfg")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    info = chip_smoke.write_synthetic_coco(root, 4, 3, sizes=((96, 128), (128, 96)),
                                           tall=(40.0, 80.0))
    return root, info


@pytest.mark.parametrize("subnet", ["keypoint", "detection", "prn"])
def test_make_loaders_match_jax(tree, subnet):
    root, _ = tree
    args = _args(coco_root=root, inp_size=64, batch_size=2, num_workers=2)
    for training in (True, False):
        got = cli.make_loaders(cli.build_config(args, subnet), subnet, training)
        want = jcli.make_loaders(jcli.build_config(args, subnet), subnet, training)
        assert (len(got), len(got.dataset), got.batch_size, got.shuffle,
                got.num_workers) == (len(want), len(want.dataset), want.batch_size,
                                     want.shuffle, want.num_workers)


def test_cli_end_to_end_on_cpu(tree, tmp_path, monkeypatch):
    monkeypatch.setenv("MPN_PLATFORM", "cpu")
    root, info = tree
    save = str(tmp_path / "models")
    common = ["--coco-root", root, "--backbone", "resnet50", "--save-dir", save,
              "--num-workers", "2", "--inp-size", "64", "--exp-name", "kp"]
    cli.main(["train", "--subnet", "keypoint", *common, "--batch-size", "2",
              "--max-epoch", "1"])
    ckpt = os.path.join(save, "kp", "ckpt_1")
    assert os.path.isfile(os.path.join(ckpt, "state.pt"))
    loss = cli.main(["val", "--subnet", "keypoint", *common, "--batch-size", "2",
                     "--max-batches", "2", "--ckpt", ckpt])
    assert np.isfinite(loss)

    # the briefly trained heads find nothing: raise their output biases
    eval_ckpt = chip_smoke.raise_output_biases(ckpt, str(tmp_path / "eval"))
    ev = ["--coco-root", root, "--backbone", "resnet50", "--ckpt", eval_ckpt,
          "--inp-size", "64", "--max-peaks", "8", "--max-people", "8",
          "--no-escalate"]
    metrics_file = str(tmp_path / "metrics.json")
    metrics = cli.main(["coco-eval", *ev, "--metrics-file", metrics_file,
                        "--result-file", str(tmp_path / "all.json")])
    with open(metrics_file) as f:
        assert json.load(f) == metrics
    assert len(metrics) == 10
    shards = [str(tmp_path / f"shard{i}.json") for i in range(2)]
    for i, path in enumerate(shards):
        assert cli.main(["coco-eval", *ev, "--eval-shard", f"{i}:2",
                         "--result-file", path]) == {}
    merged = str(tmp_path / "merged.json")
    assert cli.main(["merge-results", *shards, "--coco-root", root,
                     "--out", merged]) == metrics
    rows = []
    for path in (merged, tmp_path / "all.json"):
        with open(path) as f:
            rows.append(sorted(json.load(f), key=lambda r: (
                r["image_id"], -r["score"], r["keypoints"])))
    assert rows[0] == rows[1] and len(rows[0]) > 0

    out = tmp_path / "test_out"
    people = cli.main(["test", *ev[:8], "--testdata",
                       os.path.join(root, "images", "val2017"),
                       "--testresult", str(out)])
    with open(out / "multipose_results.json") as f:
        assert len(json.load(f)) == len(people) > 0


def test_cli_raises_without_gpu_or_cpu_request(tree, monkeypatch):
    root, _ = tree
    monkeypatch.delenv("MPN_PLATFORM", raising=False)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["val", "--subnet", "prn", "--coco-root", root,
                  "--backbone", "resnet50", "--batch-size", "2"])
    monkeypatch.setenv("MPN_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="MPN_PLATFORM"):
        cli.main(["val", "--subnet", "prn", "--coco-root", root])
    monkeypatch.setenv("MPN_PLATFORM", "cpu")
    with pytest.raises(SystemExit):
        cli.main(["coco-eval", "--coco-root", "/definitely/missing"])
    with pytest.raises(SystemExit):
        cli.main(["coco-eval", "--coco-root", root, "--eval-shard", "0:2"])
