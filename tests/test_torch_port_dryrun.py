"""multiposenet_tpu_torch's train steps in several processes, on the CPU
(2 processes over gloo, ``parallel.distributed.spawn_ranks``):

- ``dryrun_multichip(2)``, the counterpart of the JAX dry run: each stage's
  2-process SGD step equals the 1-process step on the same global batch
  within JAX's bound, BatchNorm statistics equal in both processes, the
  mesh-sharded e2e batch;
- the 2-process keypoint step (BatchNorm on the global batch, DDP) against
  JAX's step on a 2-device mesh of virtual CPU devices.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import Config as JConfig
from multiposenet_tpu.config import DataConfig as JDataConfig
from multiposenet_tpu.config import ModelConfig as JModelConfig
from multiposenet_tpu.config import TrainConfig as JTrainConfig
from multiposenet_tpu.engine import train_steps as jts
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet
from multiposenet_tpu.parallel import make_mesh as jmake_mesh
from multiposenet_tpu.parallel import replicated as jreplicated
from multiposenet_tpu.parallel import shard_batch as jshard_batch

import torch_port_dist_workers as workers
from multiposenet_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from multiposenet_tpu_torch.engine.train_steps import is_trainable
from multiposenet_tpu_torch.parallel.distributed import spawn_ranks
from multiposenet_tpu_torch.parallel.dryrun import dryrun_multichip
from multiposenet_tpu_torch.weights import state_dict_from_flax, torch_key

TIMEOUT = 300.0    # seconds a process group may take before it is ended


@pytest.fixture
def files(tmp_path):
    """``tmp_path``, removed after the test: state dicts are large."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def ranks(fn, n=2, *args):
    return spawn_ranks(fn, n, args=args, device="cpu", timeout=TIMEOUT, threads=2)


def test_dryrun_multichip_two_processes():
    """Each stage's 2-process SGD step equals the 1-process step on the
    same global batch within max(1e-5, 5e-6 sqrt(2)) (measured on the CPU:
    loss 6.7e-8, parameters 3.1e-6 in the keypoint stage, ~1e-17 in the
    others); the BatchNorm running statistics are bit-equal in both
    processes; the sharded e2e batch has its shapes."""
    r = dryrun_multichip(2, device="cpu", threads=2, timeout=TIMEOUT)
    assert r["tol"] == 1e-5
    for stage in ("keypoint", "detection", "prn"):
        assert np.isfinite(r[stage]["loss"])
        assert r[stage]["dloss"] < r["tol"] and r[stage]["dparams"] < r["tol"]
    assert r["bn_max_diff"] == 0.0
    assert r["inference"] == {"heatmaps": (4, 16, 16, 18), "chosen": (4, 8, 17)}
    assert len(r["checks"]) == 8


SIZE = 64
B = 4
SMALL_PRN = dict(backbone="resnet50", prn_coeff=1, prn_node_count=64)


def _jax_state_dict(params, batch_stats):
    """A JAX state in the port's state_dict keys and layouts, dtype kept."""
    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(v)
    out = {}
    for path, a in flat(params):
        leaf = path[-1]
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[torch_key(path[:-1], "bias" if leaf == "bias" else "weight")] = a
    for path, a in flat(batch_stats):
        out[torch_key(path[:-1], {"mean": "running_mean",
                                  "var": "running_var"}[path[-1]])] = a
    return out


def _jax_preprocess_f64(img):
    """tests/torch_port_dist_workers.preprocess_f64 in JAX."""
    from multiposenet_tpu.engine.inference import IMAGENET_MEAN, IMAGENET_STD

    return ((img.astype(jnp.float64) / 255.0 - IMAGENET_MEAN.astype(np.float64))
            / IMAGENET_STD.astype(np.float64))


def test_two_process_keypoint_step_equals_jax_mesh_step(files, monkeypatch):
    """The keypoint step in 2 processes (BatchNorm on the global batch's
    statistics through the differentiable all-reduce, DDP's averaged
    gradients) against JAX's step on a 2-device mesh of virtual CPU devices,
    from one init tree and one seeded global batch of 4, in float64 with
    SGD at lr 1e3 (the first SGD update is the gradient itself), as
    tests/test_torch_port_train_steps does for one device, with the images
    normalised in float64 on both sides, so that no program's float32
    rounding of them enters (at 64 px an input ulp moves the loss by
    1e-6).  Bounds: the losses (the mean over the processes; the largest
    and smallest heatmap value over them) 1e-6 relative, each updated
    tensor within 1e-6 of its largest JAX update, running statistics within
    1e-9 of each tensor's largest value and bit-equal in both processes."""
    monkeypatch.setattr(jts, "preprocess_on_device", _jax_preprocess_f64)
    lr = 1e3
    jm = JPoseNet(JModelConfig(**SMALL_PRN))
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                jnp.zeros((1, 28, 18, 17)), method=JPoseNet.init_all)
    v = jax.tree_util.tree_map(np.array, jax.device_get(v))
    rng = np.random.RandomState(0)
    joints = np.full((B, 3, 18, 3), 2.0, np.float32)
    joints[:, 0, :, :2] = rng.uniform(0, SIZE, (B, 18, 2))
    joints[:, 0, :, 2] = rng.randint(0, 2, (B, 18))
    batch = {"image": rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
             "joints": joints,
             "mask": rng.rand(B, SIZE // 4, SIZE // 4).astype(np.float32)}

    jcfg = JConfig(model=JModelConfig(compute_dtype=jnp.float64, **SMALL_PRN),
                   data=JDataConfig(inp_size=SIZE),
                   train=JTrainConfig(optimizer="sgd"))
    with jax.enable_x64(True):
        cast = lambda a: jnp.asarray(np.asarray(a, np.float64))  # noqa: E731
        params = jax.tree.map(cast, v["params"])
        stats = jax.tree.map(cast, v["batch_stats"])
        tx, mask = jts.make_optimizer(jcfg, params, "keypoint")
        state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=tx.init(params))
        mesh = jmake_mesh((2,), ("data",), devices=jax.devices()[:2])
        step, _ = jts.make_keypoint_steps(JPoseNet(jcfg.model), jcfg, tx, mask,
                                          mesh=mesh)
        new, jlogs = step(jax.device_put(state, jreplicated(mesh)),
                          jshard_batch(mesh, {k: jnp.asarray(a)
                                              for k, a in batch.items()}),
                          jnp.asarray(lr))
        new, jlogs = jax.device_get((new, jlogs))
    want = _jax_state_dict(new.params, new.batch_stats)

    cfg = Config(model=ModelConfig(compute_dtype=torch.float64, **SMALL_PRN),
                 data=DataConfig(inp_size=SIZE), train=TrainConfig(optimizer="sgd"))
    start = state_dict_from_flax(v)
    torch.save(start, files / "start.pt")
    out = files / "after.pt"
    (logs0, stats0), (logs1, stats1) = ranks(
        workers.keypoint_step, 2, str(files / "start.pt"), cfg, batch, lr,
        str(out))
    after = torch.load(out)

    np.testing.assert_array_equal(stats0, stats1)
    assert logs0.keys() == jlogs.keys()
    for k in jlogs:
        got = {"max_ht": max, "min_ht": min}.get(
            k, lambda a, b: (a + b) / 2)(logs0[k], logs1[k])
        np.testing.assert_allclose(got, float(jlogs[k]), rtol=1e-6, err_msg=k)
    n_trained = 0
    for k, t in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        got, s0 = t.numpy(), start[k].numpy().astype(np.float64)
        if k.endswith(("running_mean", "running_var")):
            assert np.abs(got - want[k]).max() <= 1e-9 * np.abs(want[k]).max(), k
        elif not is_trainable(k, "keypoint"):
            assert np.array_equal(got, s0), k
        else:
            n_trained += 1
            upd = want[k] - s0
            assert np.abs((got - s0) - upd).max() <= 1e-6 * np.abs(upd).max(), k
    assert n_trained > 100
