"""multiposenet_tpu_torch deployment path on the CPU (``MPN_PLATFORM=cpu``):
kernel K1 as the registered operator ``mpn::nms_suppress``, the exported
serving program (engine/export_model.py) array-exact against the live
pipeline, ``BatchPredictor.from_exported`` against a live predictor, the
CLI's ``export-program``, ``--fold-bn`` on ``test`` and ``coco-eval``, and
the port's bench at a tiny size.  resnet50 at 64 px, float32."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from multiposenet_tpu.ops.nms import batched_topk_nms as j_batched_topk_nms

import chip_smoke
from multiposenet_tpu_torch import bench, cli
from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
from multiposenet_tpu_torch.engine import inference
from multiposenet_tpu_torch.engine.export_model import load_pose_pipeline
from multiposenet_tpu_torch.engine.inference import make_e2e_pose_pipeline
from multiposenet_tpu_torch.engine.predictor import BatchPredictor
from multiposenet_tpu_torch.models.fold_bn import fold_bn_state_dict
from multiposenet_tpu_torch.models.posenet import PoseNet
from multiposenet_tpu_torch.ops import nms, peaks
from test_torch_port_cli import _args as cli_args
from test_torch_port_ops import _nms_case, _suppress_case

SIZE = 64
BATCH = 2


# ---------------------------------------------------------------- the operator

def test_registered_op_on_the_cpu_is_the_plain_twin():
    assert nms.nms_suppress._opoverload is torch.ops.mpn.nms_suppress.default
    for kind in ("fuzz", "chain_across_words"):
        boxes, valid = _suppress_case(kind, np.random.RandomState(7), 100)
        b, v = torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None]
        want = nms.nms_suppress_plain(b, v, 0.5)
        assert torch.equal(torch.ops.mpn.nms_suppress(b, v, 0.5), want)
        assert torch.equal(nms.nms_suppress(b, v, 0.5), want)


def test_registered_op_shape_function():
    boxes, valid = _suppress_case("fuzz", np.random.RandomState(8), 40)
    b = torch.from_numpy(np.stack([boxes] * 3))
    v = torch.from_numpy(np.stack([valid] * 3))
    torch.library.opcheck(torch.ops.mpn.nms_suppress.default, (b, v, 0.5))
    keep = nms.nms_suppress(torch.empty(5, 33, 4, device="meta"),
                            torch.empty(5, 33, dtype=torch.bool, device="meta"),
                            0.5)
    assert keep.shape == (5, 33) and keep.dtype == torch.bool
    assert keep.device.type == "meta"


class _TopkNMS(torch.nn.Module):
    def forward(self, boxes, scores):
        return tuple(nms.batched_topk_nms(boxes, scores, 0.5, 32, 0.05))


def test_exported_batched_topk_nms_equals_jax():
    rng = np.random.RandomState(11)
    cases = [_nms_case("fuzz", rng) for _ in range(3)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    args = (torch.from_numpy(boxes), torch.from_numpy(scores))
    program = torch.export.export(_TopkNMS(), args, strict=False)
    ops = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.mpn.nms_suppress.default) == 1
    got = program.module()(*args)
    want = j_batched_topk_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                              32, 0.05)
    for name, g in zip(("boxes", "scores", "indices", "keep"), got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


# ---------------------------------------------------------------- export

def _args(**kw):
    return cli_args(backbone="resnet50", inp_size=SIZE, num_workers=2, **kw)


def _checkpoint(path: str) -> str:
    """A resnet50 model state with random BatchNorm statistics and affines
    and raised output biases, so that the fold moves every trunk conv and
    the default thresholds leave boxes and peaks."""
    model = PoseNet(cli.build_config(_args(), "keypoint").model)
    model.reset_parameters(torch.Generator().manual_seed(3), head_output_std=0.05)
    sd = model.state_dict()
    rng = np.random.RandomState(3)
    for k, t in sd.items():
        lo, hi = {"running_mean": (-0.5, 0.5), "running_var": (0.5, 2.0),
                  "weight": (0.5, 1.5)}.get(k.rsplit(".", 1)[-1], (None, None))
        if lo is not None and (".bn" in k or "downsample.1" in k):
            sd[k] = torch.from_numpy(rng.uniform(lo, hi, t.shape).astype(np.float32))
    sd["classificationModel.output.bias"] = torch.full_like(
        sd["classificationModel.output.bias"], 3.0)
    sd["convfin.bias"] = sd["convfin.bias"] + 0.3
    os.makedirs(path, exist_ok=True)
    torch.save({"model": sd}, os.path.join(path, ckpt_lib.STATE_FILE))
    return path


def _images(seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The folded model of a checkpoint exported through the CLI, after the
    live pipeline ran once with its device-tensor caches cleared again."""
    root = tmp_path_factory.mktemp("export")
    ckpt = _checkpoint(str(root / "ckpt"))
    out = str(root / "pose.pt2")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPN_PLATFORM", "cpu")
        cfg, ev = cli._load_eval(_args(ckpt=ckpt, fold_bn=True))
        live = make_e2e_pose_pipeline(ev.model, cfg, (SIZE, SIZE), device="cpu")
        images, scales = _images(1), torch.tensor([1.0, 1.5])
        before = live(images, scales)[1]
        inference._cached_imagenet_stats.cache_clear()
        peaks._cached_upsample.cache_clear()
        cli.main(["export-program", out, "--ckpt", ckpt, "--fold-bn",
                  "--backbone", "resnet50", "--inp-size", str(SIZE),
                  "--batch-size", str(BATCH)])
    return cfg, ev, live, (images, scales), before, out


def test_export_program_folds_and_recovers_its_signature(exported):
    cfg, ev, _, _, _, out = exported
    assert cfg.model.fold_bn and not any(".bn" in k for k in ev.model.state_dict()
                                         if k.startswith("fpn."))
    sd, _ = ckpt_lib.restore_model_state_partial(
        os.path.dirname(out) + "/ckpt", PoseNet(dataclasses.replace(
            cfg.model, fold_bn=False)).state_dict())
    for k, t in fold_bn_state_dict(sd).items():
        assert torch.equal(ev.model.state_dict()[k], t), k
    sp = load_pose_pipeline(out, device="cpu")
    assert (sp.batch, sp.inp_size, sp.device) == (BATCH, SIZE, torch.device("cpu"))
    ops = [n.target for g in sp.program.graph_module.modules()
           if isinstance(g, torch.fx.GraphModule) for n in g.graph.nodes]
    assert ops.count(torch.ops.mpn.nms_suppress.default) == 1


def test_loaded_program_equals_live_pipeline(exported):
    _, _, live, (images, scales), before, out = exported
    sp = load_pose_pipeline(out, device="cpu")
    got = sp(images, scales)
    assert int(got.box_valid.sum()) > 0 and int(got.peak_valid.sum()) > 0
    for name, g, w in zip(got._fields, got, before):
        assert torch.equal(g, w), name


def test_live_pipeline_unchanged_after_an_export(exported):
    """The export ran with the caches empty: the live pipeline still gets
    real tensors from them, and the same outputs as before."""
    _, _, live, (images, scales), before, _ = exported
    after = live(images, scales)[1]
    for name, a, b in zip(after._fields, after, before):
        assert type(a) is torch.Tensor, name
        assert torch.equal(a, b), name
    for t in inference._imagenet_stats(torch.device("cpu")):
        assert type(t) is torch.Tensor


def test_from_exported_predictor_equals_live(exported):
    cfg, ev, _, _, _, out = exported
    aot = BatchPredictor.from_exported(out, device="cpu")
    assert (aot.batch_size, aot.inp, aot.cfg, aot.model) == (BATCH, SIZE, None, None)
    live = BatchPredictor(cfg, model=ev.model, batch_size=BATCH, device="cpu")
    rng = np.random.RandomState(5)
    imgs = [rng.randint(0, 256, (48 + 8 * i, 80 - 8 * i, 3), dtype=np.uint8)
            for i in range(3)]
    want, got = live.predict(imgs), aot.predict(imgs)
    assert len(got) == 3 and sum(map(len, want)) > 0
    assert got == want


def test_export_program_needs_a_checkpoint(monkeypatch, tmp_path):
    monkeypatch.setenv("MPN_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="requires --ckpt"):
        cli.main(["export-program", str(tmp_path / "x.pt2"),
                  "--backbone", "resnet50"])
    assert not (tmp_path / "x.pt2").exists()


def test_test_and_coco_eval_with_fold_bn(exported, tmp_path, monkeypatch):
    monkeypatch.setenv("MPN_PLATFORM", "cpu")
    ckpt = os.path.dirname(exported[-1]) + "/ckpt"
    root = str(tmp_path / "coco")
    chip_smoke.write_synthetic_coco(root, 0, 2, sizes=((96, 128),),
                                    tall=(40.0, 80.0))
    common = ["--coco-root", root, "--backbone", "resnet50", "--ckpt", ckpt,
              "--inp-size", str(SIZE), "--fold-bn"]
    out = tmp_path / "test_out"
    people = cli.main(["test", *common, "--testdata",
                       os.path.join(root, "images", "val2017"),
                       "--testresult", str(out)])
    with open(out / "multipose_results.json") as f:
        assert len(json.load(f)) == len(people) > 0
    metrics = cli.main(["coco-eval", *common, "--max-peaks", "8",
                        "--max-people", "8", "--no-escalate"])
    assert len(metrics) == 10


# ---------------------------------------------------------------- bench

def test_bench_prints_every_key(monkeypatch, capsys):
    monkeypatch.setenv("MPN_PLATFORM", "cpu")
    out = bench.main(backbone="resnet50", size=SIZE, batch=BATCH, iters=2)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    keys = {"metric", "value", "unit", "vs_baseline", "detect_peaks_ips",
            "gflops_per_image", "mfu", "dtype", "e2e_runs_s",
            "device_busy_ms_per_exec"}
    assert keys <= set(out)
    assert out["mfu"] is None and out["device_busy_ms_per_exec"] is None
    assert out["vs_baseline"] is None and out["dtype"] == "bfloat16"
    assert out["value"] > 0 and out["detect_peaks_ips"] > 0
    assert len(out["e2e_runs_s"]) == 3 and out["device"] == "cpu"
    # a 64 px resnet50 forward is ~1 GFLOP per image
    assert 0.1 < out["gflops_per_image"] < 10


def test_deployment_modules_import_nothing_of_jax():
    code = ("import sys\n"
            "import multiposenet_tpu_torch.models.fold_bn\n"
            "import multiposenet_tpu_torch.engine.export_model\n"
            "import multiposenet_tpu_torch.bench, multiposenet_tpu_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'multiposenet_tpu' or "
            "m.startswith('multiposenet_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
