"""multiposenet_tpu_torch training engine on the CPU: the plateau scheduler
and the loader against the JAX package's, checkpoints (names, order,
pruning, partial restore, best copies, background saves), the device
prefetch, and the Trainer (auto-resume, SIGTERM checkpoint-and-exit, the
reference's three-stage chain with freezing, no CPU unless asked), and a
bfloat16 step per stage."""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from multiposenet_tpu.data.loader import Loader as JLoader
from multiposenet_tpu.engine.checkpoint import list_checkpoints as j_list_checkpoints
from multiposenet_tpu.engine.trainer import ReduceLROnPlateau as JReduceLROnPlateau

from multiposenet_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from multiposenet_tpu_torch.data.loader import Loader, device_prefetch
from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
from multiposenet_tpu_torch.engine.train_steps import TrainState, param_group
from multiposenet_tpu_torch.engine.trainer import ReduceLROnPlateau, Trainer

SIZE = 64


# ---------------------------------------------------------------- scheduler

def test_plateau_scheduler_semantics():
    s = ReduceLROnPlateau(1.0, factor=0.5, patience=2)
    lrs = [s.step(v) for v in [3.0, 2.0, 2.5, 2.4, 2.3, 2.2]]
    # bad epochs: 2.5, 2.4, 2.3 -> reduce on the 3rd (patience 2 exceeded)
    assert lrs == [1.0, 1.0, 1.0, 1.0, 0.5, 0.5]
    vals = np.random.RandomState(0).rand(60).tolist()
    a = ReduceLROnPlateau(1e-3, 0.3, 1, min_lr=1e-6)
    b = JReduceLROnPlateau(1e-3, 0.3, 1, min_lr=1e-6)
    assert [a.step(v) for v in vals] == [b.step(v) for v in vals]


# ---------------------------------------------------------------- loader

class ArrayDataset:
    def __len__(self):
        return 23

    def __getitem__(self, i, rng=None):
        return {"x": np.full((2,), i, np.float32),
                "r": np.asarray([rng.random()], np.float64)}


def test_loader_equals_jax():
    """Same shuffle order and per-worker sample randomness."""
    for kw in (dict(batch_size=4), dict(batch_size=5, drop_last=False),
               dict(batch_size=3, shuffle=False)):
        got = list(Loader(ArrayDataset(), num_workers=1, seed=3, **kw))
        want = list(JLoader(ArrayDataset(), num_workers=1, seed=3, **kw))
        assert len(got) == len(want) == len(Loader(ArrayDataset(), **kw))
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


class RaisingDataset(ArrayDataset):
    def __len__(self):
        return 4

    def __getitem__(self, i, rng=None):
        if i == 1:
            raise RuntimeError("sample 1 is unreadable")
        return super().__getitem__(i, rng)


def test_loader_raises_a_worker_exception():
    """A sample that raises reaches the iterating thread instead of leaving
    it blocked on a batch that never comes."""
    outcome = []

    def consume():
        try:
            list(Loader(RaisingDataset(), batch_size=2, num_workers=1,
                        shuffle=False))
            outcome.append(None)
        except RuntimeError as e:
            outcome.append(e)

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive(), "Loader still blocked after 10 s"
    assert len(outcome) == 1 and isinstance(outcome[0], RuntimeError)
    assert "sample 1 is unreadable" in str(outcome[0])


# ---------------------------------------------------------------- prefetch

def test_device_prefetch_order_errors_and_early_stop():
    batches = [{"a": np.full((2, 3), i, np.uint8), "b": torch.ones(4) * i}
               for i in range(5)]
    got = list(device_prefetch(iter(batches), "cpu"))
    assert [int(b["a"][0, 0]) for b in got] == list(range(5))
    assert all(isinstance(b["a"], torch.Tensor) for b in got)

    def failing():
        yield batches[0]
        raise KeyError("boom")
    it = device_prefetch(failing(), "cpu")
    next(it)
    with pytest.raises(KeyError, match="boom"):
        next(it)

    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield {"a": np.zeros(1) + i}
            i += 1
    it = device_prefetch(endless(), "cpu", depth=2)
    next(it)
    it.close()                    # the consumer stops: the pump thread stops
    n = len(pulled)
    time.sleep(1.2)
    assert len(pulled) <= n + 1


def test_entry_points_raise_without_a_gpu(monkeypatch, tmp_path):
    """No CPU fallback: without device='cpu', no GPU is an error."""
    from multiposenet_tpu_torch.engine.train_steps import make_keypoint_steps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = stage_cfg(tmp_path, "keypoint", "x")
    for fn in (lambda: Trainer(cfg), lambda: make_keypoint_steps(cfg),
               lambda: next(device_prefetch(iter([{"a": np.zeros(1)}])))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()


# ---------------------------------------------------------------- checkpoints

def tiny_state(seed=0):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4))
    model[1].running_mean.uniform_()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.0)
    model(torch.rand(2, 3, 5, 5)).sum().backward()
    opt.step()
    return TrainState(model=model, optimizer=opt, subnet="keypoint", step=3)


def test_checkpoint_names_order_and_pruning(tmp_path):
    state = tiny_state()
    d = str(tmp_path)
    for epoch, step in [(1, 5), (1, None), (2, 7), (2, 12), (0, 1)]:
        path = ckpt_lib.save_checkpoint(d, state, epoch, step=step)
        assert os.path.basename(path) == (f"ckpt_{epoch}" if step is None
                                          else f"ckpt_{epoch}_s{step}")
    os.makedirs(os.path.join(d, "ckpt_9.best"))          # not a checkpoint
    want = [(0, 1), (1, 5), (1, -1), (2, 7), (2, 12)]
    assert ckpt_lib.list_checkpoints(d) == want == j_list_checkpoints(d)
    assert ckpt_lib.latest_checkpoint(d) == os.path.join(d, "ckpt_2_s12")
    ckpt_lib.save_checkpoint(d, state, 3, max_n_ckpts=2)
    assert ckpt_lib.list_checkpoints(d) == [(2, 12), (3, -1)]
    assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_checkpoint_restore_round_trip_and_copy_best(tmp_path):
    a, b = tiny_state(0), tiny_state(1)
    path = ckpt_lib.save_checkpoint(str(tmp_path), a, 4)
    ckpt_lib.restore_checkpoint(path, b)
    assert b.step == 3
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    best = ckpt_lib.copy_best(path, 0.123456)
    assert best == path + "_0.12346.best"
    assert ckpt_lib.load_checkpoint(best)["epoch"] == 4
    assert ckpt_lib.list_checkpoints(str(tmp_path)) == [(4, -1)]


def test_restore_model_state_partial_skips_shapes_and_keeps_missing(tmp_path):
    src = tiny_state(0)
    path = ckpt_lib.save_checkpoint(str(tmp_path), src, 1)
    torch.manual_seed(5)
    # conv with 5 outputs: its weight and bias shapes differ; BN of 4 loads
    # (weight, bias, mean, var); an extra Linear is missing from the ckpt
    dst = nn.Sequential(nn.Conv2d(3, 5, 3), nn.BatchNorm2d(4), nn.Linear(2, 2))
    template = {k: v.clone() for k, v in dst.state_dict().items()}
    sd, stats = ckpt_lib.restore_model_state_partial(path, dst.state_dict())
    assert stats == {"loaded": 4, "shape_skipped": 2, "missing": 2, "bn_loaded": 2}
    dst.load_state_dict(sd)
    ref = src.model.state_dict()
    for k in ("1.weight", "1.bias", "1.running_mean", "1.running_var"):
        assert torch.equal(dst.state_dict()[k], ref[k]), k
    for k in ("0.weight", "0.bias", "2.weight", "2.bias"):
        assert torch.equal(dst.state_dict()[k], template[k]), k


def test_async_saver_snapshots_orders_and_reraises(tmp_path):
    state = tiny_state()
    saver = ckpt_lib.AsyncSaver()
    before = state.model[0].weight.detach().clone()
    f1 = saver.save(str(tmp_path), state, 1, step=1)
    with torch.no_grad():
        state.model[0].weight.add_(1.0)       # a later step, in place
    f2 = saver.save(str(tmp_path), state, 1, step=2)
    assert saver.wait() == f2.result()
    assert torch.equal(ckpt_lib.load_checkpoint(f1.result())["model"]["0.weight"], before)
    assert torch.equal(ckpt_lib.load_checkpoint(f2.result())["model"]["0.weight"],
                       before + 1.0)
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver.save(str(blocker), state, 2)        # fails in the background
    with pytest.raises(OSError):
        saver.wait()
    assert saver.wait() is None               # nothing pending any more


# ---------------------------------------------------------------- trainer

def keypoint_batches(n, seed=0, b=2):
    out = []
    for i in range(n):
        r = np.random.RandomState(seed + i)
        joints = np.full((b, 2, 18, 3), 2.0, np.float32)
        joints[:, 0, :, :2] = r.uniform(6, SIZE - 6, (b, 18, 2))
        joints[:, 0, :, 2] = 1.0
        out.append({"image": r.randint(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8),
                    "joints": joints,
                    "mask": np.ones((b, SIZE // 4, SIZE // 4), np.float32)})
    return out


def detection_batches(n, seed=100, b=2):
    out = []
    for i in range(n):
        r = np.random.RandomState(seed + i)
        boxes = np.full((b, 4, 5), -1.0, np.float32)
        boxes[:, 0] = [8, 8, 44, 52, 0]
        out.append({"image": r.randint(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8),
                    "boxes": boxes})
    return out


def prn_batches(n, seed=200, b=2):
    out = []
    for i in range(n):
        r = np.random.RandomState(seed + i)
        m = (r.rand(b, 56, 36, 17) > 0.99).astype(np.float32)
        out.append({"weights_marks": m, "label_marks": m})
    return out


def stage_cfg(tmp, subnet, exp, **train):
    kw = dict(subnet=subnet, batch_size=2, max_epoch=1, init_lr=1e-3,
              save_dir=str(tmp), exp_name=exp, print_freq=100, val_freq=0,
              save_freq_step=10 ** 9, val_nbatch_end_epoch=0)
    kw.update(train)
    # a narrow PRN keeps the checkpoints small
    return Config(model=ModelConfig(backbone="resnet50", prn_node_count=64),
                  data=DataConfig(inp_size=SIZE), train=TrainConfig(**kw))


def test_auto_resume_roundtrip(tmp_path):
    """Train an epoch (end-of-epoch validation, best copy); a fresh Trainer
    picks up the newest checkpoint: epoch, step, weights, BN statistics and
    optimizer state."""
    cfg = stage_cfg(tmp_path, "keypoint", "t", val_nbatch_end_epoch=1)
    t = Trainer(cfg, train_data=keypoint_batches(2), val_data=keypoint_batches(1, 9),
                device="cpu")
    t.train()
    assert t.last_epoch == 1 and t.state.step == 2
    save_dir = os.path.join(str(tmp_path), "t")
    assert any(n.endswith(".best") for n in os.listdir(save_dir))
    assert os.path.exists(os.path.join(save_dir, "metrics.jsonl"))
    t2 = Trainer(cfg, train_data=keypoint_batches(2), device="cpu")
    assert t2.last_epoch == 1
    assert t2.state.step == t.state.step == t2.global_step
    for (k, x), y in zip(t.model.state_dict().items(), t2.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert len(t2.state.optimizer.state) == len(t.state.optimizer.state) > 0
    t2.train()                                 # max_epoch reached: no step
    assert t2.state.step == 2


def test_sigterm_checkpoints_and_exits(tmp_path):
    """SIGTERM during the epoch: the current step finishes, a step
    checkpoint is written, and the trainer exits with SystemExit(0)."""
    cfg = stage_cfg(tmp_path, "prn", "p")
    t = Trainer(cfg, train_data=None, device="cpu")
    t.install_signal_handlers()

    def data():
        for i, b in enumerate(prn_batches(6)):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b
    t.train_data = data()
    try:
        with pytest.raises(SystemExit) as exc:
            t.train()
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGINT, signal.default_int_handler)
    assert exc.value.code == 0
    save_dir = os.path.join(str(tmp_path), "p")
    ckpts = ckpt_lib.list_checkpoints(save_dir)
    assert len(ckpts) == 1 and ckpts[0][1] == t.global_step < 6
    # a resumed run re-runs the unfinished epoch from that step
    t2 = Trainer(cfg, train_data=prn_batches(6), device="cpu")
    assert (t2.last_epoch, t2.global_step) == (0, t.global_step)


def test_three_stage_chain_partial_init_and_freeze(tmp_path):
    """The reference's staged recipe: each stage starts from the previous
    stage's checkpoint by partial init (weights and BN statistics), trains
    only its own groups, and carries everything else bit-unchanged."""
    def snapshot(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def changed_groups(a, b):
        return {param_group(k) for k in a
                if not k.endswith(("running_mean", "running_var",
                                   "num_batches_tracked"))
                and not torch.equal(a[k], b[k])}

    t1 = Trainer(stage_cfg(tmp_path, "keypoint", "s1"),
                 train_data=keypoint_batches(2), device="cpu")
    s0 = snapshot(t1.model)
    t1.train()
    s1 = snapshot(t1.model)
    assert changed_groups(s0, s1) == {"fpn_resnet", "fpn_keypoint", "keypoint"}
    bn = [k for k in s1 if k.endswith("running_mean")]
    assert any(not torch.equal(s0[k], s1[k]) for k in bn)   # BN trained
    ck1 = ckpt_lib.latest_checkpoint(os.path.join(str(tmp_path), "s1"))

    t2 = Trainer(stage_cfg(tmp_path, "detection", "s2"),
                 train_data=detection_batches(2), init_ckpt_params=ck1, device="cpu")
    for k, v in snapshot(t2.model).items():    # weights AND BN statistics
        assert torch.equal(v, s1[k]), k
    t2.train()
    s2 = snapshot(t2.model)
    assert changed_groups(s1, s2) == {"fpn_retina", "retinanet"}
    for k in bn:                               # BN frozen in this stage
        assert torch.equal(s2[k], s1[k]), k

    ck2 = ckpt_lib.latest_checkpoint(os.path.join(str(tmp_path), "s2"))
    t3 = Trainer(stage_cfg(tmp_path, "prn", "s3"),
                 train_data=prn_batches(2), init_ckpt_params=ck2, device="cpu")
    t3.train()
    s3 = snapshot(t3.model)
    assert changed_groups(s2, s3) == {"prn"}
    for k in bn:
        assert torch.equal(s3[k], s2[k]), k


@pytest.mark.parametrize("stage", ["keypoint", "detection", "prn"])
def test_bfloat16_step_runs_under_autocast(stage):
    """With ``compute_dtype=bfloat16`` the step runs under autocast, the
    losses are taken in float32, and the loss stays within 2% of the
    float32 step's (measured 0.9%, 0.01%, 1e-6)."""
    from multiposenet_tpu_torch.engine import train_steps as ts
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet

    batch = {"keypoint": keypoint_batches, "detection": detection_batches,
             "prn": prn_batches}[stage](1)[0]
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        cfg = Config(model=ModelConfig(backbone="resnet50", prn_node_count=64,
                                       compute_dtype=dtype),
                     data=DataConfig(inp_size=SIZE))
        model = build_trainable_posenet(cfg.model, torch.device("cpu"), seed=0,
                                        head_output_std=0.01)
        state = ts.create_train_state(cfg, stage, model=model)
        step, _ = ts.STEP_FACTORIES[stage](cfg, device="cpu")
        extra = (torch.Generator().manual_seed(0),) if stage == "prn" else ()
        _, logs = step(state, batch, 1e-4, *extra)
        assert logs["loss"].dtype == torch.float32
        losses[dtype] = float(logs["loss"])
    assert np.isfinite(losses[torch.bfloat16])
    assert losses[torch.bfloat16] == pytest.approx(losses[torch.float32], rel=2e-2)
