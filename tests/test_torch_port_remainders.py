"""multiposenet_tpu_torch's last small counterparts of the JAX package, on
the CPU: the port's PRN MLP against JAX's fused ``_prn_mlp_eval``; ``MetricsWriter``'s JSONL
log and TensorBoard mirror; ``StepProfiler``'s trace window; ``cli
export-torch`` and ``import-torch`` (the reference's h5 layout) against
JAX ``tools/export_torch_ckpt.py``."""

import copy
import importlib.util
import json
import os
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import ModelConfig as JModelConfig
from multiposenet_tpu.engine.inference import _prn_mlp_eval
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch import cli
from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
from multiposenet_tpu_torch.models.posenet import build_posenet
from multiposenet_tpu_torch.utils.metrics import MetricsWriter, StepProfiler
from multiposenet_tpu_torch.weights import (
    read_reference_h5,
    state_dict_from_flax,
    write_reference_h5,
)
from torch_port_helpers import HEAD_STD, perturbed_init, port_config
from torch_port_helpers import model_files  # noqa: F401 (a fixture)

SIZE = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tree():
    _, v = perturbed_init("resnet50", SIZE, head_std=HEAD_STD)
    return v


@pytest.fixture(scope="module")
def model(tree):
    return build_posenet(port_config(SIZE).model, torch.device("cpu"),
                         state_dict_from_flax(tree))


# ---------------------------------------------------------------- PRN MLP


def test_prn_module_matches_jax_fused_mlp(tree, model):
    """The port's one PRN MLP (the module: reshape -> Linear -> reshape; a
    flatten of a contiguous tensor is a view, so the JAX package's fused
    variant has nothing to fold here) against JAX ``_prn_mlp_eval``, the
    flatten folded into dens1/dens2, on grids of 6 boxes (sparse marks in
    [0, 1]), errors in units of each output's largest value.  The
    whole-vector softmax of near-equal logits magnifies float32 rounding:
    against a float64 evaluation of the module the float32 module is
    1.4e-5 off (bound 5e-5) and JAX ``_prn_mlp_eval`` 3.6e-5; the two
    float32 results are 5.0e-5 apart (bound 2e-4).  Measured on the CPU."""
    rng = np.random.RandomState(0)
    grids = (rng.rand(6, 56, 36, 17) > 0.995).astype(np.float32)
    grids = grids * rng.rand(6, 56, 36, 17).astype(np.float32)
    t = torch.from_numpy(grids)
    got = model.prn_forward(t).numpy()
    jax_out = np.asarray(_prn_mlp_eval(tree["params"]["prn"], jnp.asarray(grids),
                                       jnp.float32))
    exact = copy.deepcopy(model.prn).double()(t.double(), torch.float64).numpy()
    assert got.shape == jax_out.shape == exact.shape == (6, 56, 36, 17)
    scale = np.abs(exact).max(axis=(1, 2, 3), keepdims=True)
    assert (np.abs(got - exact) / scale).max() <= 5e-5
    assert (np.abs(jax_out - exact) / scale).max() <= 5e-5
    assert (np.abs(got - jax_out) / scale).max() <= 2e-4
    # a float32 sum of 34,272 probabilities
    np.testing.assert_allclose(got.sum(axis=(1, 2, 3)), 1.0, rtol=1e-4)


# ---------------------------------------------------------------- metrics


def _tb_scalars(tb_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(tb_dir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_metrics_writer_jsonl_and_tensorboard(tmp_path):
    w = MetricsWriter(str(tmp_path))
    w.write(5, {"loss": torch.tensor(0.5), "lr": 1e-4, "name": "skipped"},
            prefix="train/")
    w.write(9, {"loss": 0.25}, prefix="val/")
    w.close()
    lines = [json.loads(s) for s in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["step"], {k: v for k, v in r.items() if k not in ("step", "time")})
            for r in lines] == [(5, {"train/loss": 0.5, "train/lr": 1e-4}),
                                (9, {"val/loss": 0.25})]
    scalars = _tb_scalars(str(tmp_path / "tb"))
    assert scalars["train/loss"] == [(5, 0.5)]
    assert scalars["val/loss"] == [(9, 0.25)]
    # TensorBoard keeps scalars in float32
    assert scalars["train/lr"] == [(5, float(np.float32(1e-4)))]


def test_metrics_writer_without_tensorboard(tmp_path, monkeypatch):
    """Where ``torch.utils.tensorboard`` does not import, the JSONL log is
    written alone."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = MetricsWriter(str(tmp_path))
    w.write(1, {"loss": 1.0})
    w.close()
    assert sorted(os.listdir(tmp_path)) == ["metrics.jsonl"]
    off = MetricsWriter(str(tmp_path / "off"), use_tensorboard=False)
    off.close()
    assert sorted(os.listdir(tmp_path / "off")) == ["metrics.jsonl"]


def test_step_profiler_traces_its_window(tmp_path):
    prof = StepProfiler(str(tmp_path), start_step=2, num_steps=3)
    x = torch.ones(64, 64)
    for step in range(8):
        prof.step(step)
        if step == 4:
            assert prof.trace_path is None      # still inside the window
        (x @ x).sum()
    assert prof.trace_path == str(tmp_path / "trace_steps_2_5.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert os.listdir(tmp_path) == ["trace_steps_2_5.json"]


# ---------------------------------------------------------------- export-torch


@pytest.fixture(scope="module")
def small_tree():
    """A JAX ``init_all`` tree with a narrow PRN (28 x 18 grid, 64 nodes):
    the files these tests write stay near 140 MB."""
    jm = JPoseNet(JModelConfig(backbone="resnet50", prn_coeff=1, prn_node_count=64))
    v = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)),
                jnp.zeros((1, 28, 18, 17)), method=JPoseNet.init_all)
    return jax.tree_util.tree_map(np.array, jax.device_get(v))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_ckpt", os.path.join(REPO, "tools", "export_torch_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(d[()]) for k, d in f.items()}, int(f.attrs["epoch"])


def test_export_torch_round_trips_and_matches_jax(small_tree, model_files):
    """A checkpoint of the port, written by ``cli export-torch``: the h5
    reads back through ``read_reference_h5`` (and ``cli import-torch`` into
    a checkpoint) bit for bit, and agrees key by key, in value, dtype and
    shape, with the JAX tool's ``export_state_dict`` of the same weights
    and with the file its ``write_reference_h5`` writes."""
    sd = state_dict_from_flax(small_tree)
    ckpt = ckpt_lib.save_model_checkpoint(str(model_files / "ckpts"), sd, epoch=3)
    out = str(model_files / "port.h5")
    cli.main(["export-torch", ckpt, out, "--backbone", "resnet50", "--epoch", "7"])

    back, epoch = read_reference_h5(out)
    assert epoch == 7 and back.keys() == sd.keys()
    for k, t in sd.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k

    tool = _jax_tool()
    want = tool.export_state_dict(small_tree["params"], small_tree["batch_stats"])
    got, _ = _h5(out)
    assert got.keys() == want.keys()
    for k, a in want.items():
        a = np.asarray(a)
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert np.array_equal(got[k], a), k
    ref = str(model_files / "jax.h5")
    tool.write_reference_h5(want, ref, epoch=7)
    ref_sets, ref_epoch = _h5(ref)
    assert ref_epoch == 7 and ref_sets.keys() == got.keys()
    assert all(np.array_equal(ref_sets[k], got[k]) and ref_sets[k].dtype == got[k].dtype
               for k in got)

    path = cli.main(["import-torch", out, str(model_files / "imported"),
                     "--backbone", "resnet50"])
    assert os.path.basename(path) == "ckpt_7"
    loaded, stats = ckpt_lib.restore_model_state_partial(path, sd)
    assert stats["missing"] == stats["shape_skipped"] == 0
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def test_reference_h5_reader_strips_data_parallel_prefixes(model_files):
    path = str(model_files / "dp.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("module.fpn.conv1.weight", data=np.ones((2, 3), np.float32))
        f.create_dataset("prn.dens1.bias", data=np.zeros(4, np.float32))
    sd, epoch = read_reference_h5(path)
    assert sorted(sd) == ["fpn.conv1.weight", "prn.dens1.bias"] and epoch == -1
    write_reference_h5({"x": torch.ones(2, dtype=torch.float64)}, path)
    assert _h5(path)[0]["x"].dtype == np.float32


def test_export_torch_refuses_the_wrong_backbone(small_tree, model_files):
    ckpt = ckpt_lib.save_model_checkpoint(str(model_files), state_dict_from_flax(small_tree))
    with pytest.raises(SystemExit, match="6 fpn.layer3 blocks"):
        cli.main(["export-torch", ckpt, str(model_files / "x.h5")])
