"""multiposenet_tpu_torch train steps against the JAX package's, on the CPU.

One JAX ``init_all`` tree (resnet50, 64 px) crosses into the port through
the weights bridge; each test runs one train step of a stage in both
packages on the same seeded numpy batch and learning rate, then compares
the loss and logs, the updated trainable parameters (as updates, in units
of the learning rate: one Adam step moves an element by at most about lr),
the frozen parameters (bit-equal to their start in both packages) and, for
the keypoint stage, the BatchNorm running statistics.

The keypoint stage trains BatchNorm on batch statistics, and at 64 px
``layer4`` normalises 8 values per channel: its gradient is ill-conditioned
(both packages' float32 gradients are up to 24% off a float64 evaluation in
the worst tensor, and an ulp of input difference moves them by as much).
So its update is held to the JAX step in float64, with both steps fed the
same normalised image; the float32 step, the training default, is held on
its loss, logs and running statistics.
"""

import dataclasses

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
from multiposenet_tpu.engine.inference import IMAGENET_MEAN, IMAGENET_STD
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from multiposenet_tpu_torch.engine import train_steps as tts
from multiposenet_tpu_torch.models.posenet import build_trainable_posenet
from multiposenet_tpu_torch.weights import state_dict_from_flax, torch_key

from torch_port_helpers import perturbed_init

SIZE = 64
B = 2
LR = 1e-4
STAGES = ("keypoint", "detection", "prn")


@pytest.fixture(scope="module")
def init_tree():
    _, v = perturbed_init("resnet50", SIZE)
    return v


def configs(prn_dropout=0.0, x64=False, **train):
    """Matching configurations of both packages: resnet50 at SIZE, PRN
    dropout off (the packages draw different masks)."""
    jm = dict(backbone="resnet50", prn_dropout=prn_dropout)
    tm = dict(backbone="resnet50", prn_dropout=prn_dropout)
    if x64:
        jm["compute_dtype"] = jnp.float64
        tm["compute_dtype"] = torch.float64
    return (JConfig(model=JModelConfig(**jm), data=JDataConfig(inp_size=SIZE),
                    train=JTrainConfig(**train)),
            Config(model=ModelConfig(**tm), data=DataConfig(inp_size=SIZE),
                   train=TrainConfig(**train)))


def make_batch(stage: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    if stage == "keypoint":
        joints = np.full((B, 3, 18, 3), 2.0, np.float32)     # 3 slots, 2 padded
        joints[:, 0, :, :2] = rng.uniform(0, SIZE, (B, 18, 2))
        joints[:, 0, :, 2] = rng.randint(0, 2, (B, 18))
        return {"image": rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
                "joints": joints,
                "mask": rng.rand(B, SIZE // 4, SIZE // 4).astype(np.float32)}
    if stage == "detection":
        boxes = np.full((B, 4, 5), -1.0, np.float32)        # image 1: no GT
        boxes[0, 0] = [5, 5, 40, 50, 0]
        boxes[0, 1] = [20, 10, 60, 60, 0]
        return {"image": rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8),
                "boxes": boxes}
    return {"weights_marks": (rng.rand(B, 56, 36, 17) > 0.99).astype(np.float32),
            "label_marks": (rng.rand(B, 56, 36, 17) > 0.995).astype(np.float32)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def jax_state_dict(params, batch_stats):
    """The JAX state as the port's state_dict keys and layouts, keeping the
    dtype (``weights.state_dict_from_flax`` casts to float32)."""
    out = {}
    for path, a in _flat(params):
        leaf = path[-1]
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[torch_key(path[:-1], "bias" if leaf == "bias" else "weight")] = a
    for path, a in _flat(batch_stats):
        out[torch_key(path[:-1], {"mean": "running_mean",
                                  "var": "running_var"}[path[-1]])] = a
    return out


def jax_step(v, stage, batch, jcfg, x64=False, lr=LR):
    """One JAX train step; returns (logs, state_dict after the step)."""
    with jax.enable_x64(x64):
        dt = np.float64 if x64 else np.float32
        cast = lambda a: jnp.asarray(np.asarray(a, dt))  # noqa: E731
        params = jax.tree.map(cast, v["params"])
        stats = jax.tree.map(cast, v["batch_stats"])
        model = JPoseNet(jcfg.model)
        tx, mask = jts.make_optimizer(jcfg, params, stage)
        state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               batch_stats=stats, opt_state=tx.init(params))
        jb = {k: jnp.asarray(a) for k, a in batch.items()}
        if stage == "keypoint":
            step, _ = jts.make_keypoint_steps(model, jcfg, tx, mask)
            new, logs = step(state, jb, jnp.asarray(lr))
        elif stage == "detection":
            step, _ = jts.make_detection_steps(model, jcfg, tx, mask,
                                               image_hw=(SIZE, SIZE))
            new, logs = step(state, jb, jnp.asarray(lr))
        else:
            step, _ = jts.make_prn_steps(model, jcfg, tx, mask)
            new, logs = step(state, jb, jnp.asarray(lr), jax.random.PRNGKey(0))
        new, logs = jax.device_get((new, logs))
    return ({k: float(x) for k, x in logs.items()},
            jax_state_dict(new.params, new.batch_stats))


def port_step(v, stage, batch, cfg, x64=False, lr=LR):
    """One port train step on the CPU; returns (logs, state_dict before,
    state_dict after, state)."""
    model = build_trainable_posenet(cfg.model, torch.device("cpu"),
                                    state_dict_from_flax(v))
    if x64:
        model = model.double()
    state = tts.create_train_state(cfg, stage, model=model)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    train_step, _ = tts.STEP_FACTORIES[stage](cfg, device="cpu")
    args = (lr, torch.Generator().manual_seed(0)) if stage == "prn" else (lr,)
    state, logs = train_step(state, batch, *args)
    return ({k: float(x) for k, x in logs.items()}, before,
            model.state_dict(), state)


def compare_step(stage, jlogs, jsd, tlogs, before, after, *, log_rtol,
                 update_tol=None, update_rel=False, update_floor=0.0,
                 stats_rtol=None):
    """Logs within ``log_rtol``; updated trainable parameters within
    ``update_tol * LR`` of the JAX update, or with ``update_rel`` within
    ``update_tol`` of the tensor's largest JAX update, or of
    ``update_floor`` times its largest starting value where that is larger
    (a float32 update below it is the parameters' rounding); None: not
    compared.  Frozen
    parameters bit-equal to their start in both packages; running
    statistics within ``stats_rtol`` of each tensor's largest value (None:
    bit-unchanged in both)."""
    assert set(jlogs) == set(tlogs)
    for k in jlogs:
        np.testing.assert_allclose(tlogs[k], jlogs[k], rtol=log_rtol, err_msg=k)
    n_trained = 0
    for k, t in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        got, start, want = t.numpy(), before[k].numpy(), jsd[k]
        if k.endswith(("running_mean", "running_var")):
            if stats_rtol is None:
                assert np.array_equal(got, start) and np.array_equal(want, start), k
            else:
                scale = np.abs(want).max()
                assert np.abs(got - want).max() <= stats_rtol * scale, k
            continue
        if not tts.is_trainable(k, stage):
            assert np.array_equal(got, start), k
            assert np.array_equal(want, start), k
            continue
        n_trained += 1
        assert not np.array_equal(got, start), f"{k} did not move"
        if update_tol is not None:
            err = np.abs((got - start) - (want - start)).max()
            scale = (max(np.abs(want - start).max(),
                         update_floor * np.abs(start).max())
                     if update_rel else LR)
            assert err <= update_tol * scale, (k, err / scale)
    assert n_trained > 0


# ---------------------------------------------------------------- groups

def test_param_groups_match_jax(init_tree):
    """Every torch parameter lands in the freeze group of its Flax
    counterpart (mapped through weights.torch_key), and all six groups
    occur."""
    groups = {}
    for path, _ in _flat(init_tree["params"]):
        leaf = path[-1]
        key = torch_key(path[:-1], "bias" if leaf == "bias" else "weight")
        groups[key] = jts.param_group(path)
    model = build_trainable_posenet(ModelConfig(backbone="resnet50"),
                                    torch.device("cpu"), seed=0)
    keys = [k for k, _ in model.named_parameters()]
    assert set(keys) == set(groups)
    for k in keys:
        assert tts.param_group(k) == groups[k], k
    assert set(groups.values()) == {"fpn_resnet", "fpn_retina", "fpn_keypoint",
                                    "keypoint", "retinanet", "prn"}
    assert tts.TRAINABLE_GROUPS == jts.TRAINABLE_GROUPS


@pytest.mark.parametrize("stage", STAGES)
def test_train_state_holds_only_the_trainable_subset(stage):
    _, cfg = configs()
    model = build_trainable_posenet(cfg.model, torch.device("cpu"), seed=0)
    state = tts.create_train_state(cfg, stage, model=model)
    held = {id(p) for p in state.trainable_parameters()}
    for k, p in model.named_parameters():
        trainable = tts.param_group(k) in jts.TRAINABLE_GROUPS[stage]
        assert p.requires_grad == trainable, k
        assert (id(p) in held) == trainable, k


# ---------------------------------------------------------------- keypoint

def xla_preprocess(img: torch.Tensor) -> torch.Tensor:
    """The JAX step's image normalisation as XLA compiles it on the CPU:
    ``fma(x, f32(1/255), -mean) * f32(1/std)`` (the product and the sum
    rounded once, through float64)."""
    c = float(np.float32(1) / np.float32(255))
    x = img.double() * c - torch.from_numpy(IMAGENET_MEAN).double()
    return x.float() * torch.from_numpy(np.float32(1) / IMAGENET_STD)


def test_xla_preprocess_equals_the_jax_step_normalisation():
    from multiposenet_tpu.engine.inference import preprocess_on_device
    img = np.random.RandomState(5).randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    want = np.asarray(jax.jit(preprocess_on_device)(jnp.asarray(img)))
    np.testing.assert_array_equal(xla_preprocess(torch.from_numpy(img)).numpy(), want)


def test_keypoint_step_equals_jax_float64(init_tree, monkeypatch):
    """BN on batch statistics with Flax's running update, the 5-term masked
    MSE on device-built targets, Adam.  In float64 the two packages' losses
    agree to 1.4e-8 (the targets are float32 in both, and exp differs by an
    ulp) and updates to 3.7e-3 lr (measured); bounds 1e-6 and 2e-2 lr.
    The running statistics depend on the forward alone: 1e-9."""
    monkeypatch.setattr(tts, "preprocess_on_device", xla_preprocess)
    jcfg, cfg = configs(x64=True)
    batch = make_batch("keypoint")
    jlogs, jsd = jax_step(init_tree, "keypoint", batch, jcfg, x64=True)
    tlogs, before, after, _ = port_step(init_tree, "keypoint", batch, cfg, x64=True)
    compare_step("keypoint", jlogs, jsd, tlogs, before, after, log_rtol=1e-6,
                 update_tol=2e-2, stats_rtol=1e-9)
    # the running statistics moved, with the biased variance
    k = "fpn.layer4.2.bn3.running_var"
    assert not np.array_equal(after[k].numpy(), before[k].numpy())


def test_keypoint_sgd_step_equals_jax_float64(init_tree, monkeypatch):
    """The keypoint step with SGD at lr 1e3, whose first update is the
    gradient itself: unlike Adam's first step (about lr * sign(g)), it holds
    the size of every gradient through the BatchNorm train-mode backward.
    Each tensor's update is within 3.1e-8 of its largest JAX update
    (measured, float64); bound 1e-6."""
    monkeypatch.setattr(tts, "preprocess_on_device", xla_preprocess)
    jcfg, cfg = configs(x64=True, optimizer="sgd")
    batch = make_batch("keypoint")
    jlogs, jsd = jax_step(init_tree, "keypoint", batch, jcfg, x64=True, lr=1e3)
    tlogs, before, after, _ = port_step(init_tree, "keypoint", batch, cfg,
                                        x64=True, lr=1e3)
    compare_step("keypoint", jlogs, jsd, tlogs, before, after, log_rtol=1e-6,
                 update_tol=1e-6, update_rel=True, stats_rtol=1e-9)


def test_keypoint_step_float32(init_tree):
    """The default float32 step, with the port's own normalisation: loss
    2e-6, logs 1.2e-4 (max_ht), running statistics 1.9e-4 of each tensor's
    largest value off the JAX step (measured); bounds 1e-4, 1e-3, 2e-3.
    Frozen parameters are bit-equal to their start."""
    jcfg, cfg = configs()
    batch = make_batch("keypoint", seed=1)
    jlogs, jsd = jax_step(init_tree, "keypoint", batch, jcfg)
    tlogs, before, after, _ = port_step(init_tree, "keypoint", batch, cfg)
    np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-4)
    compare_step("keypoint", jlogs, jsd, tlogs, before, after, log_rtol=1e-3,
                 stats_rtol=2e-3)


# ---------------------------------------------------------------- detection

@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_detection_step_equals_jax(init_tree, weight_decay):
    """Focal + smooth-L1 loss on padded GT (the second image has none),
    BN on running statistics (bit-unchanged), gradients into fpn_retina and
    the heads only; Adam, and with weight decay AdamW's rule.  Loss within
    1.1e-7, updates within 1.7e-3 lr of JAX (measured); bounds 1e-5, 1e-2."""
    jcfg, cfg = configs(weight_decay=weight_decay)
    batch = make_batch("detection")
    jlogs, jsd = jax_step(init_tree, "detection", batch, jcfg)
    tlogs, before, after, state = port_step(init_tree, "detection", batch, cfg)
    compare_step("detection", jlogs, jsd, tlogs, before, after, log_rtol=1e-5,
                 update_tol=1e-2)
    # frozen parameters got no gradient and carry no optimizer state
    held = {id(p) for p in state.trainable_parameters()}
    for p in state.model.parameters():
        if id(p) not in held:
            assert p.grad is None
    assert len(state.optimizer.state) == len(held)


def test_detection_sgd_step_equals_jax(init_tree):
    """The detection step with SGD, whose first update is the gradient
    itself, so it holds the size of every gradient through the retina FPN
    and the heads.  The weights' gradients are 1e-8 to 1e-7 at 64 px, so
    the step runs at lr 1e5 for their updates to stand above float32
    rounding.  Each tensor's update is within 5.7e-6 of its largest JAX
    update (measured), or of 1e-3 of its largest weight where that is
    larger (conv6, conv7, toplayer0 and toplayer1 get gradients of 1e-17
    to 1e-13 here); bound 1e-4."""
    jcfg, cfg = configs(optimizer="sgd")
    batch = make_batch("detection")
    jlogs, jsd = jax_step(init_tree, "detection", batch, jcfg, lr=1e5)
    tlogs, before, after, _ = port_step(init_tree, "detection", batch, cfg,
                                        lr=1e5)
    compare_step("detection", jlogs, jsd, tlogs, before, after, log_rtol=1e-5,
                 update_tol=1e-4, update_rel=True, update_floor=1e-3)


# ---------------------------------------------------------------- PRN

@pytest.mark.parametrize("optimizer,max_grad_norm", [
    ("adam", None),
    ("sgd", 1e-6),     # the inf-norm clip binds: max |g| is 2.6e-6
])
def test_prn_step_equals_jax(init_tree, optimizer, max_grad_norm):
    """Gaussian grids built on the device, the PRN MLP,
    BCE; Adam, or SGD with momentum behind a binding inf-norm clip (at lr
    1e3, so that its update stands far above the parameters' rounding).  Adam's
    updates are within 1.3e-4 lr of JAX (measured), bound 1e-2 lr; SGD's
    within 1e-3 of each tensor's largest update.  The
    loss differs by 5.1e-5: XLA's float32 BCE over the 34,272-way softmax
    is that far off a float64 evaluation of the same outputs, the port's
    within 1e-8 (measured); bound 1e-4."""
    jcfg, cfg = configs(optimizer=optimizer, max_grad_norm=max_grad_norm)
    batch = make_batch("prn")
    lr = 1e3 if optimizer == "sgd" else LR
    jlogs, jsd = jax_step(init_tree, "prn", batch, jcfg, lr=lr)
    tlogs, before, after, state = port_step(init_tree, "prn", batch, cfg, lr=lr)
    compare_step("prn", jlogs, jsd, tlogs, before, after, log_rtol=1e-4,
                 update_tol=1e-2 if optimizer == "adam" else 1e-3,
                 update_rel=optimizer == "sgd")
    if max_grad_norm:
        # clipped by max_norm / (max |g| + 1e-6) = 0.28
        top = max(float(p.grad.abs().max()) for p in state.trainable_parameters())
        assert 0.5 * max_grad_norm < top < max_grad_norm


def test_prn_dropout_mask_and_val_identity():
    """Training dropout: the mask comes from the generator (same seed, same
    mask), about half the units drop at rate 0.5 and kept values double;
    the val step and train=False apply none."""
    from multiposenet_tpu_torch.models.subnets import dropout

    x = torch.rand(4, 4096) + 0.5
    a = dropout(x, 0.5, torch.Generator().manual_seed(3))
    b = dropout(x, 0.5, torch.Generator().manual_seed(3))
    c = dropout(x, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert 0.45 < float(kept.float().mean()) < 0.55
    assert torch.equal(a[kept], x[kept] * 2)

    _, cfg = configs(prn_dropout=0.5)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, prn_node_count=64))
    model = build_trainable_posenet(cfg.model, torch.device("cpu"), seed=0)
    grid = torch.rand(2, 56, 36, 17)
    with torch.no_grad():
        plain = model.prn_forward(grid)
        train = model.prn_forward(grid, True, torch.Generator().manual_seed(0))
    assert not torch.equal(plain, train)
    state = tts.create_train_state(cfg, "prn", model=model)
    _, val_step = tts.make_prn_steps(cfg, device="cpu")
    batch = make_batch("prn")
    assert val_step(state, batch)["loss"] == val_step(state, batch)["loss"]
    with pytest.raises(ValueError, match="generator"):
        model.prn_forward(grid, True)
