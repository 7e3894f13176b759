"""The port's tracer (``multiposenet_tpu_torch/utils/trace.py``) on the CPU:
rows, parents and ids of nested spans, no row with the timeline off, a span
entered after it was built, totals with the timeline off, one stack per
thread; the spans of a train step of each stage, the feed's ``data.wait``
and the Trainer's log line that reads them."""

import re
import threading
import time

import numpy as np
import pytest
import torch

from multiposenet_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from multiposenet_tpu_torch.data.loader import device_prefetch
from multiposenet_tpu_torch.engine import trainer as trainer_mod
from multiposenet_tpu_torch.engine.train_steps import STEP_FACTORIES, create_train_state
from multiposenet_tpu_torch.utils import trace

SIZE = 64


@pytest.fixture
def timeline():
    """The timeline on, with no row left from before; off afterwards."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def test_nested_spans_keep_parents_and_ids(timeline):
    with trace.span("outer", 7):
        with trace.span("a"):
            with trace.span("a.inner"):
                pass
        with trace.span("b", 9):
            pass
    with trace.span("top"):
        pass
    rows = trace.drain()
    assert [r.name for r in rows] == ["outer", "a", "a.inner", "b", "top"]
    assert [r.parent for r in rows] == [None, 0, 1, 0, None]
    # a child without an id of its own takes its parent's
    assert [r.id for r in rows] == [7, 7, 7, 9, None]
    assert {r.thread for r in rows} == {threading.get_ident()}
    for r in rows:
        assert r.start <= r.end
        if r.parent is not None:
            p = rows[r.parent]
            assert p.start <= r.start and r.end <= p.end
    assert rows[1].end <= rows[3].start
    assert trace.drain() == []


def test_timeline_off_records_no_row():
    trace.disable()
    trace.drain()
    with trace.span("x") as outer:
        with trace.span("y", 3) as inner:
            pass
    assert (outer.name, outer.id, inner.name, inner.id) == ("x", None, "y", 3)
    assert trace.drain() == []


def test_a_span_entered_later_keeps_its_own_name(timeline):
    """A span built now and entered after another one was built and run is
    still the span it was built as."""
    later = trace.span("later", 4)
    with trace.span("first"):
        pass
    with later:
        with trace.span("child"):
            pass
    rows = trace.drain()
    assert [(r.name, r.id, r.parent) for r in rows] == [
        ("first", None, None), ("later", 4, None), ("child", 4, 1)]


def test_totals_are_kept_with_the_timeline_off():
    trace.disable()
    before = trace.totals().get("totals.test", (0, 0.0))
    for _ in range(2):
        with trace.span("totals.test"):
            time.sleep(0.01)
    calls, seconds = trace.totals()["totals.test"]
    assert calls - before[0] == 2
    assert 0.02 <= seconds - before[1] < 1.0
    assert trace.drain() == []


def test_threads_keep_their_own_stacks(timeline):
    """Two threads open their spans in turns; each child's parent is the
    span open on its own thread."""
    turn = threading.Barrier(2, timeout=10)

    def work(tag):
        with trace.span(f"outer.{tag}"):
            turn.wait()
            with trace.span(f"inner.{tag}"):
                turn.wait()
            turn.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    rows = trace.drain()
    assert sorted(r.name for r in rows) == ["inner.a", "inner.b", "outer.a", "outer.b"]
    for r in rows:
        if r.name.startswith("inner."):
            parent = rows[r.parent]
            assert parent.name == "outer." + r.name[len("inner."):]
            assert parent.thread == r.thread
    assert len({r.thread for r in rows}) == 2


def stage_cfg(subnet, tmp="unused", **train):
    kw = dict(subnet=subnet, batch_size=2, max_epoch=1, init_lr=1e-3,
              save_dir=str(tmp), exp_name=subnet, print_freq=1, val_freq=0,
              save_freq_step=10 ** 9, val_nbatch_end_epoch=0)
    kw.update(train)
    return Config(model=ModelConfig(backbone="resnet50", prn_node_count=64),
                  data=DataConfig(inp_size=SIZE), train=TrainConfig(**kw))


def make_batch(stage, seed=0, b=2):
    r = np.random.RandomState(seed)
    if stage == "keypoint":
        joints = np.full((b, 2, 18, 3), 2.0, np.float32)
        joints[:, 0, :, :2] = r.uniform(6, SIZE - 6, (b, 18, 2))
        joints[:, 0, :, 2] = 1.0
        return {"image": r.randint(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8),
                "joints": joints, "mask": np.ones((b, SIZE // 4, SIZE // 4), np.float32)}
    if stage == "detection":
        boxes = np.full((b, 4, 5), -1.0, np.float32)
        boxes[:, 0] = [8, 8, 44, 52, 0]
        return {"image": r.randint(0, 256, (b, SIZE, SIZE, 3)).astype(np.uint8),
                "boxes": boxes}
    marks = (r.rand(b, 56, 36, 17) > 0.99).astype(np.float32)
    return {"weights_marks": marks, "label_marks": marks}


PHASES = {
    "keypoint": ["train.upload", "train.targets", "train.forward", "train.loss",
                 "train.backward", "train.optimizer"],
    "detection": ["train.upload", "train.forward", "train.loss", "train.backward",
                  "train.optimizer"],
    "prn": ["train.upload", "train.targets", "train.forward", "train.loss",
            "train.backward", "train.optimizer"],
}


@pytest.mark.parametrize("stage", ["keypoint", "detection", "prn"])
def test_train_step_spans_its_phases(stage, timeline):
    cfg = stage_cfg(stage)
    state = create_train_state(cfg, stage, device="cpu")
    train_step, val_step = STEP_FACTORIES[stage](cfg, "cpu")
    args = (1e-3, torch.Generator().manual_seed(1)) if stage == "prn" else (1e-3,)
    state.step = 5
    trace.drain()
    train_step(state, make_batch(stage), *args)
    rows = trace.drain()
    steps = [i for i, r in enumerate(rows) if r.name == "train.step"]
    assert len(steps) == 1
    top = rows[steps[0]]
    assert top.id == 5 and top.parent is None
    children = [r for r in rows if r.parent == steps[0]]
    assert [r.name for r in children] == PHASES[stage]
    assert len(rows) == len(children) + 1
    assert all(r.id == 5 for r in children)
    assert top.start <= children[0].start and children[-1].end <= top.end
    for a, b in zip(children, children[1:]):
        assert a.end <= b.start
    # a val step opens no span
    val_step(state, make_batch(stage, 1))
    assert trace.drain() == []


def test_device_prefetch_records_one_data_wait_per_batch(timeline):
    batches = [{"x": np.full((2,), i, np.float32)} for i in range(5)]
    it = device_prefetch(iter(batches), "cpu", depth=2)
    got = [next(it) for _ in range(4)]
    it.close()
    assert [float(b["x"][0]) for b in got] == [0.0, 1.0, 2.0, 3.0]
    rows = trace.drain()
    assert [r.name for r in rows] == ["data.wait"] * 4
    assert {r.thread for r in rows} == {threading.get_ident()}


class SlowBatches:
    """Detection batches that take ``delay`` seconds each to make."""

    def __init__(self, n, delay):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            time.sleep(self.delay)
            yield make_batch("detection", i)


def test_trainer_log_line_carries_the_data_wait_and_phase_times(tmp_path, monkeypatch):
    lines = []
    monkeypatch.setattr(trainer_mod.logger, "info",
                        lambda msg, *a: lines.append(msg % a if a else msg))
    cfg = stage_cfg("detection", tmp_path)
    t = trainer_mod.Trainer(cfg, train_data=SlowBatches(3, 0.3), device="cpu")
    t.train()
    logs = [m for m in lines if "fps:" in m]
    assert len(logs) == 3
    for i, m in enumerate(logs):
        wait, step = map(float, re.search(r"\(([\d.]+)/([\d.]+)s, fps:", m).groups())
        assert wait <= step
        if i == 0:
            # the first batch takes 0.3 s to make, and the first step waits
            assert wait >= 0.2
        phases = re.search(r"host ms/step: (.*)", m).group(1)
        got = dict(p.rsplit(" ", 1) for p in phases.split(", "))
        assert {"upload", "forward", "loss", "backward", "optimizer",
                "step"} <= set(got)
        assert float(got["step"]) >= float(got["forward"]) > 0
