"""multiposenet_tpu_torch with several processes, on the CPU: process
groups of 2 over gloo (``parallel.distributed.spawn_ranks``, a ``file://``
rendezvous in a temporary directory; every wait has a timeout, so a hang
fails one test instead of the suite).

- ``Loader`` shards against the JAX ``Loader``'s, and bad shard ids;
- the single-process defaults and ``gather_objects`` with 1 and 2 processes;
- auto-sharded ``coco_eval`` against one process (forward stubbed by
  ``GTForward``), and a failing shard, which the primary must refuse;
- the mesh-sharded pipelines and ``BatchPredictor(mesh=...)``;
- ``cli train`` in 2 processes, checkpoints written by process 0 only.

The training steps in several processes are in tests/test_torch_port_dryrun.py.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from multiposenet_tpu.data.loader import Loader as JLoader

import chip_smoke
import torch_port_dist_workers as workers
from multiposenet_tpu_torch.config import Config, ModelConfig
from multiposenet_tpu_torch.data.loader import Loader
from multiposenet_tpu_torch.engine.inference import (
    make_e2e_pose_pipeline,
    make_full_pipeline,
    make_sharded_e2e_pipeline,
    make_sharded_pipeline,
)
from multiposenet_tpu_torch.engine.predictor import BatchPredictor
from multiposenet_tpu_torch.parallel import distributed as pdist
from multiposenet_tpu_torch.parallel import make_mesh
from multiposenet_tpu_torch.parallel.distributed import RankFailure, spawn_ranks
from torch_port_helpers import (
    HEAD_STD,
    GTForward,
    model_files,  # noqa: F401 (a fixture)
    perturbed_init,
    port_config,
    port_model,
    synthetic_coco,
)

TIMEOUT = 300.0    # seconds a process group may take before it is ended


def ranks(fn, n=2, *args):
    return spawn_ranks(fn, n, args=args, device="cpu", timeout=TIMEOUT, threads=2)


# ---------------------------------------------------------------- Loader


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return {"i": np.asarray([i], np.int64)}


def _epoch(loader):
    return [b["i"][:, 0].tolist() for b in loader]


@pytest.mark.parametrize("n_items,num_shards,batch", [(16, 2, 4), (17, 2, 4),
                                                       (23, 3, 2)])
def test_loader_shards_match_jax_and_cover_the_dataset(n_items, num_shards, batch):
    """Every shard equals the JAX Loader's (same permutation, same
    stride), the shards are disjoint, have one floor-divided length, and
    cover the dataset but for fewer than ``num_shards`` trailing samples;
    a second epoch reshuffles alike."""
    shards = []
    for sid in range(num_shards):
        got = Loader(_Items(n_items), batch, num_workers=2, seed=5,
                     shard_id=sid, num_shards=num_shards)
        want = JLoader(_Items(n_items), batch, num_workers=2, seed=5,
                       shard_id=sid, num_shards=num_shards)
        assert len(got) == len(want) == (n_items // num_shards) // batch
        for _ in range(2):
            g = _epoch(got)
            assert g == _epoch(want)
        shards.append(sum(g, []))
    flat = sum(shards, [])
    assert len(flat) == len(set(flat))
    assert len({len(s) for s in shards}) == 1
    no_drop = [sum(_epoch(Loader(_Items(n_items), n_items // num_shards,
                                 num_workers=1, seed=5, shard_id=s,
                                 num_shards=num_shards)), [])
               for s in range(num_shards)]
    covered = set(sum(no_drop, []))
    assert len(covered) == n_items - n_items % num_shards


@pytest.mark.parametrize("shard_id,num_shards", [(2, 2), (-1, 2), (0, 0)])
def test_loader_rejects_bad_shard_ids(shard_id, num_shards):
    for cls in (Loader, JLoader):
        with pytest.raises(ValueError):
            cls(_Items(8), 2, shard_id=shard_id, num_shards=num_shards)


# ---------------------------------------------------------------- topology


def test_single_process_defaults(monkeypatch):
    monkeypatch.delenv("MPN_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("MPN_DISTRIBUTED", raising=False)
    assert pdist.initialize(device="cpu") is False
    assert not pdist.is_active()
    assert (pdist.process_count(), pdist.process_index(), pdist.is_primary(),
            pdist.process_device()) == (1, 0, True, None)
    assert pdist.per_host_batch(6) == 6
    assert pdist.gather_objects({"a": [1]}) == [{"a": [1]}]
    assert pdist.gather_objects({"a": [1]}, decode=False) is None


def test_two_process_topology():
    got = ranks(workers.topology)
    msg = "global batch_size 7 must be divisible by the process count 2"
    assert got == [{"count": 2, "index": r, "primary": r == 0, "device": "cpu",
                    "per_host": 4, "remainder": msg} for r in range(2)]


@pytest.mark.parametrize("n", [1, 2])
def test_gather_objects(n):
    """Every process gets every payload in process order (ragged lengths,
    non-ASCII text); with ``decode=False`` a process still joins and gets
    None."""
    want = [{"rank": r, "rows": list(range(r * 3 + 1)), "name": "é" * r}
            for r in range(n)]
    for r, (every, primary_only) in enumerate(ranks(workers.gather, n)):
        assert every == want
        assert primary_only == (None if r else want)


def test_a_failing_process_is_reported_and_the_others_ended():
    """``spawn_ranks`` raises with the failed process's traceback; the other
    one, which waits for it in a collective, fails too (gloo sees its peer
    gone) or is ended after the grace time; either way it is reported."""
    t0 = time.monotonic()
    with pytest.raises(RankFailure) as info:
        spawn_ranks(workers.fail_then_wait, 2, device="cpu", timeout=TIMEOUT,
                    grace=5.0)
    assert time.monotonic() - t0 < 60
    assert "ValueError: process 1 fails" in info.value.errors[1]
    assert set(info.value.errors) == {0, 1}


# ---------------------------------------------------------------- training


# ---------------------------------------------------------------- coco_eval

SCALES = (0.5, 1.0, 1.5)
PEOPLE = [[(45, 60), (150, 70)], [(60, 100)], [(170, 110)], [(90, 80)],
          [(50, 50), (160, 120)]]


def _eval_setup(tmp_path):
    ann_file, gt = synthetic_coco(str(tmp_path), PEOPLE)
    cfg = Config(model=ModelConfig(backbone="resnet50"))
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, inp_size=128, scale_search=SCALES, flip=True))
    return cfg, GTForward(gt, 128, SCALES), ann_file


def _by_image(rows):
    return sorted(rows, key=lambda r: (r["image_id"], -r["score"],
                                       r["keypoints"]))


def test_auto_sharded_coco_eval_equals_one_process(tmp_path):
    """5 images over 2 processes (3 and 2): process 0 scores the gathered
    rows; its stats and rows equal one process's, the other returns {}."""
    cfg, stub, ann_file = _eval_setup(tmp_path)
    want, want_rows = workers.coco_eval(cfg, stub, ann_file, str(tmp_path))
    assert len(want) == 10 and want["AP"] > 0.8 and len(want_rows) == 7
    (m0, rows0), (m1, rows1) = ranks(workers.coco_eval, 2, cfg, stub, ann_file,
                                     str(tmp_path))
    assert m0 == want
    assert _by_image(rows0) == _by_image(want_rows)
    assert (m1, rows1) == ({}, None)


def test_a_failing_shard_makes_the_primary_raise(tmp_path):
    """Process 1's reader fails on its second image: it still joins the
    gather, then raises; process 0 refuses to score the partial set.  Both
    end well inside the timeout."""
    cfg, stub, ann_file = _eval_setup(tmp_path)
    t0 = time.monotonic()
    with pytest.raises(RankFailure) as info:
        ranks(workers.coco_eval, 2, cfg, stub, ann_file, str(tmp_path), (1, 2))
    assert time.monotonic() - t0 < TIMEOUT / 2
    errors = info.value.errors
    assert "refusing to score partial results" in errors[0]
    assert "injected read failure" in errors[1]


# ---------------------------------------------------------------- serving

SIZE = 64


@pytest.fixture(scope="module")
def serving():
    _, v = perturbed_init("resnet50", SIZE, head_std=HEAD_STD)
    cfg = port_config(SIZE)
    return cfg, port_model(v, cfg)


def _equal(a, b):
    if a is None or isinstance(a, torch.Tensor):
        assert (a is None and b is None) or torch.equal(a, b)
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        _equal(x, y)


def _cat(parts):
    """Outputs of several batches concatenated on dim 0, field by field."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    fields = [_cat(list(f)) for f in zip(*parts)]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def test_sharded_pipelines_equal_the_unsharded_ones(serving):
    """A batch of 4 over a mesh of two CPU entries: every output field
    equals the unsharded pipeline's on each half (the per-device batch),
    concatenated."""
    cfg, model = serving
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 and mesh.devices == (torch.device("cpu"),) * 2
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randint(0, 256, (4, SIZE, SIZE, 3)).astype(np.uint8))
    scales = torch.tensor([1.0, 1.5, 2.0, 0.5])
    e2e = make_e2e_pose_pipeline(model, cfg, (SIZE, SIZE), device="cpu")
    want = _cat([e2e(images[i:i + 2], scales[i:i + 2]) for i in (0, 2)])
    got = make_sharded_e2e_pipeline(model, cfg, (SIZE, SIZE), mesh)(images, scales)
    _equal(got, want)
    assert int(got[1].box_valid.sum()) > 0 and int(got[1].peak_valid.sum()) > 0

    full = make_full_pipeline(model, cfg, (SIZE, SIZE), device="cpu")
    want = _cat([full(images[i:i + 2]) for i in (0, 2)])
    _equal(make_sharded_pipeline(model, cfg, (SIZE, SIZE), mesh)(images), want)
    with pytest.raises(ValueError, match="does not split"):
        make_sharded_pipeline(model, cfg, (SIZE, SIZE), mesh)(images[:3])


def test_batch_predictor_on_a_mesh_equals_unsharded(serving):
    """BatchPredictor(mesh=...) at batch 4 over two entries answers 7 images
    of mixed sizes (a ragged tail) with the rows of an unsharded predictor
    at the per-device batch 2; a batch that does not divide is refused."""
    cfg, model = serving
    mesh = make_mesh(devices=["cpu", "cpu"])
    rng = np.random.RandomState(2)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in [(64, 64), (48, 80), (90, 60), (64, 64), (30, 40),
                           (70, 70), (64, 100)]]
    got = BatchPredictor(cfg, model=model, batch_size=4, mesh=mesh).predict(images)
    want = BatchPredictor(cfg, model=model, batch_size=2, device="cpu").predict(images)
    assert got == want and sum(map(len, got)) > 0
    with pytest.raises(ValueError, match="divisible by the mesh"):
        BatchPredictor(cfg, model=model, batch_size=3, mesh=mesh)


# ---------------------------------------------------------------- CLI


def test_cli_train_in_two_processes(model_files):
    """``cli train`` with the cluster flags in 2 processes (global batch 2,
    one sample each), each with its own --save-dir, as hosts without a
    shared filesystem: process 0 writes the checkpoint and the metrics,
    process 1 writes nothing."""
    root = str(model_files / "coco")
    os.makedirs(root)
    chip_smoke.write_synthetic_coco(root, 4, 3, sizes=((96, 128), (128, 96)),
                                    tall=(40.0, 80.0))
    env = dict(os.environ, MPN_PLATFORM="cpu", OMP_NUM_THREADS="2")
    env.pop("MPN_COORDINATOR_ADDRESS", None)
    env.pop("MPN_DISTRIBUTED", None)
    init = "file://" + str(model_files / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "multiposenet_tpu_torch.cli", "train",
         "--subnet", "keypoint", "--coco-root", root, "--backbone", "resnet50",
         "--inp-size", "64", "--batch-size", "2", "--max-epoch", "1",
         "--num-workers", "2", "--save-dir", str(model_files / f"save{r}"),
         "--coordinator", init, "--num-processes", "2", "--process-id", str(r)],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "process 1/2 on cpu, backend gloo" in outs[1]
    exp = model_files / "save0" / "multipose101"
    assert (exp / "ckpt_1" / "state.pt").is_file()
    assert (exp / "metrics.jsonl").is_file()
    other = model_files / "save1" / "multipose101"
    assert not other.exists() or not any(other.iterdir())
