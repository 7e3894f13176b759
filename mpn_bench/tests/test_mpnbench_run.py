"""Whole runs of tiny cells on the CPU: a sound run comes out correct and
loads nothing of JAX; with the timed path broken underneath, or with the
control in the program's place, ``correct`` comes out false; without a
CUDA device the benchmark's command prints no result and fails."""

import json
import time
import subprocess
import sys

import pytest
import torch

from mpn_bench import checks, harness, traffic, weights
from mpn_bench.drivers import frame_stream
from mpn_bench.tests import tiny


def _subprocess(*args, timeout=600):
    return subprocess.run([sys.executable, *args], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("kind,trace", [("serve", "0"), ("serve", "1"), ("train", "0"),
                                        ("train", "1")])
def test_sound_tiny_run_is_correct_and_loads_no_jax(kind, trace):
    out = _subprocess("-m", "mpn_bench.tests.tiny", kind, "2147483659", "0.3", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["forbidden"] == []
    r = line["result"]
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"] or trace == "1"
    if trace == "1":
        assert r["device"]["busy_s"] > 0
        assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
    if kind == "serve":
        assert r["info"]["people_checked"] > 0


def test_command_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _subprocess("mpn_bench/run.py", "--workload", "r50-train-det", "--seed", "1",
                      "--seconds", "1", "--trace", "0", timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _serve_run(monkeypatch=None):
    return tiny.run("serve", 31, 0.3)


def test_serving_answer_altered_where_produced(monkeypatch):
    from multiposenet_tpu_torch.eval import grouping

    real = grouping.format_assignment

    def altered(*a, **k):
        rows = real(*a, **k)
        if rows:
            rows[0]["keypoints"][0] += 3.0
        return rows

    monkeypatch.setattr(grouping, "format_assignment", altered)
    import multiposenet_tpu_torch.engine.inference as inf

    monkeypatch.setattr(inf, "format_assignment", altered)
    r = _serve_run()
    assert r["correct"] is False
    assert r["checks"]["person_diff"]["value"] > 0


def test_serving_keep_mask_altered_where_produced(monkeypatch):
    from multiposenet_tpu_torch.ops import nms

    real = nms.nms_suppress

    def flipped(boxes, valid, thresh):
        keep = real(boxes, valid, thresh).clone()
        keep[:, 0] = ~keep[:, 0]
        return keep

    monkeypatch.setattr(nms, "nms_suppress", flipped)
    r = _serve_run()
    assert r["correct"] is False
    assert r["checks"]["det_diff"]["value"] > 0


def test_serving_forward_altered_where_produced(monkeypatch):
    from multiposenet_tpu_torch.models.posenet import PoseNet

    real = PoseNet.full_forward

    def skewed(self, img):
        heat, cls, reg = real(self, img)
        return heat * 1.05, cls, reg

    monkeypatch.setattr(PoseNet, "full_forward", skewed)
    r = _serve_run()
    assert r["correct"] is False
    assert r["checks"]["heat_err"]["value"] > r["checks"]["heat_err"]["limit"]


def test_training_state_left_unchanged(monkeypatch):
    from multiposenet_tpu_torch.engine import train_steps

    def no_update(state, loss, lr, max_grad_norm):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()

    monkeypatch.setattr(train_steps, "_apply_updates", no_update)
    r = tiny.run("train", 37, 0.3)
    assert r["correct"] is False
    assert r["checks"]["delta_gap"]["value"] > r["checks"]["delta_gap"]["limit"]


def test_training_half_batch_left_out(monkeypatch):
    from multiposenet_tpu_torch.engine import train_steps

    real = train_steps.detection_loss

    def half(cls, reg, anchors, ann, **kw):
        h = cls.shape[0] // 2
        return real(cls[:h], reg[:h], anchors, ann[:h], **kw)

    monkeypatch.setattr(train_steps, "detection_loss", half)
    r = tiny.run("train", 37, 0.3)
    assert r["correct"] is False


def test_training_window_loss_altered_where_produced(monkeypatch):
    """A loss that goes bad after the checked steps, inside the window."""
    from multiposenet_tpu_torch.engine import train_steps

    factory = train_steps.STEP_FACTORIES["detection"]

    def broken(cfg, device):
        step, rest = factory(cfg, device)
        calls = [0]

        def bad_after_three(state, batch, lr):
            calls[0] += 1
            state, logs = step(state, batch, lr)
            if calls[0] > 3:
                logs = dict(logs, loss=logs["loss"] * float("nan"))
            return state, logs
        return bad_after_three, rest

    monkeypatch.setitem(train_steps.STEP_FACTORIES, "detection", broken)
    r = tiny.run("train", 37, 0.3)
    assert r["correct"] is False
    assert r["checks"]["window_nonfinite"]["value"] > 0


def test_training_feed_skips_a_batch_after_the_checked_steps(monkeypatch):
    """The feed drops one batch after the checked steps: the step after the
    window trains on another batch than the pool's next."""
    from multiposenet_tpu_torch.data import loader

    real = loader.device_prefetch

    def skipping(batches, device, depth=2):
        it = real(batches, device, depth=depth)
        try:
            for k, b in enumerate(it):
                if k != 3:
                    yield b
        finally:
            it.close()

    monkeypatch.setattr(loader, "device_prefetch", skipping)
    r = tiny.run("train", 37, 0.3)
    assert r["correct"] is False
    assert r["checks"]["late_loss_gap"]["value"] > r["checks"]["late_loss_gap"]["limit"]


def test_training_trace_covers_the_window_start():
    """A trace shorter than the window stops inside it; the per-layer
    numbers read the traced part."""
    from mpn_bench import run as run_mod

    c, cfg, spec = tiny.cell("train")
    spec["trace_seconds"] = 0.2
    r = run_mod.run_cell(tiny.bench(), None, 39, 0.8, True, torch.device("cpu"),
                         time.time(), files=(c, cfg, spec))
    assert r["correct"] is True, r["checks"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"] < 0.8
    assert "device_idle.train" in r["metrics"]


def test_serving_control_fails():
    """The reference in float8 in the program's place (bf16 configured)."""
    _, cfg, spec = tiny.cell("serve")
    dev = torch.device("cpu")
    spans = harness.Spans()
    spans.on = False
    srv = frame_stream.Serving(cfg, spec, 41, dev, spans)
    rec = srv.serve(0.3)
    got, _ = checks.serve_numbers(cfg, srv.captured, rec["served"], srv.frames,
                                  srv.state_dict, srv.batch, dev,
                                  control=checks.fp8_quant)
    assert harness.checks_failed(got)
    assert got["heat_err"]["value"] > got["heat_err"]["limit"]


@pytest.mark.parametrize("fault", [{"autocast_dtype": torch.bfloat16},
                                   {"half_batch": True}])
def test_training_control_and_fault_fail(fault):
    """bf16 in the float32 step, and half of each batch left out."""
    _, cfg, spec = tiny.cell("train")
    t = cfg["train_detection"]
    sd = weights.make_state_dict(cfg, 43, "cpu", "train_detection")
    batches = traffic.detection_pool(spec, 43, t["inp_size"], "cpu")[:3]
    got, _ = checks.train_numbers(cfg, None, sd, batches, torch.device("cpu"),
                                  t["init_lr"], ref_run=fault)
    assert harness.checks_failed(got)


@pytest.mark.chip
def test_tiny_serving_on_the_card():
    """K1 and the pipeline on a CUDA device, checked as a run checks them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mpn_bench import run as run_mod

    r = run_mod.run_cell(tiny.bench(), None, 5, 0.5, True, torch.device("cuda", 0),
                         0.0, files=tiny.cell("serve"))
    assert r["correct"] is True, r["checks"]
