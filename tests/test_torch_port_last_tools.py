"""The port's last tools against the JAX package's, on the CPU: ``make_demo``
(its scenes, batches and one step of each stage), the ResNet-101 synthetic
recipe's table (``train_synth_e2e``), the parity runbook and its verdict
tool, the orbax-to-port converter (tools/orbax_to_torch.py), and the open
``eval/render.thick_line`` that the demo draws with.

The JAX tools are loaded from the root ``tools/`` through ``importlib`` and
run unchanged; where a JAX tool's ``main`` builds its batches inline, the
test records them by replacing the JAX train-step factories and evaluator
with recorders for the call.
"""

import dataclasses
import importlib.util
import json
import os
import re
import shlex
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import Config as JConfig
from multiposenet_tpu.config import ModelConfig as JModelConfig
from multiposenet_tpu.engine import train_steps as jts
from multiposenet_tpu.engine.checkpoint import save_checkpoint as j_save_checkpoint
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch.config import ModelConfig
from multiposenet_tpu_torch.data.image_io import read_image
from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
from multiposenet_tpu_torch.eval import render
from multiposenet_tpu_torch.models.posenet import PoseNet
from multiposenet_tpu_torch.weights import torch_key
from multiposenet_tpu_torch.tools import (
    diff_parity_metrics,
    make_demo,
    real_parity_runbook,
    synth_e2e_gate,
    train_synth_e2e,
)
from test_torch_port_train_steps import compare_step, configs, jax_step, port_step
from torch_port_helpers import model_files  # noqa: F401 (a fixture)
from torch_port_helpers import perturbed_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64          # the train-step parity tests' size


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jdemo():
    return _load_tool("make_demo")


# ---------------------------------------------------------------- thick_line

LINES = {
    "horizontal": ((5, 10), (50, 10)),
    "vertical": ((20, 3), (20, 60)),
    "diagonal": ((3, 3), (60, 55)),
    "degenerate": ((30, 30), (30, 30)),
    "partly_off": ((-40, -20), (80, 50)),
    "off_the_image": ((-30, -10), (-2, -25)),
}


@pytest.mark.parametrize("case", list(LINES) + ["fuzz"])
def test_thick_line_equals_cv2_line(case):
    """``render.thick_line`` against ``cv2.line`` (LINE_8) at thickness 2-5
    on two canvases, bit for bit: the polygon, both round caps and the
    clipping of the ends to the image grown by the thickness."""
    rng = np.random.RandomState(sorted(LINES).index(case) if case in LINES else 99)
    segs = ([LINES[case]] if case in LINES else
            [tuple(tuple(int(v) for v in rng.randint(-30, 100, 2)) for _ in range(2))
             for _ in range(300)])
    for p1, p2 in segs:
        for thickness in (2, 3, 4, 5):
            for hw in ((64, 64), (40, 70)):
                want = (rng.rand(*hw, 3) * 40 + 200).astype(np.uint8)
                got = want.copy()
                color = tuple(int(c) for c in rng.randint(0, 256, 3))
                cv2.line(want, p1, p2, color, thickness)
                render.thick_line(got, p1, p2, color, thickness)
                assert np.array_equal(got, want), (p1, p2, thickness, hw)
    with pytest.raises(ValueError, match="thickness"):
        render.thick_line(want, (0, 0), (5, 5), (0, 0, 0), 1)


# ---------------------------------------------------------------- scenes

@pytest.mark.parametrize("size", [64, 128])
def test_scenes_equal_the_jax_tool(jdemo, size):
    """``draw_scene`` and ``scene_batch`` from the same ``RandomState``:
    images, joints and boxes bit-equal, and the generator left in the same
    state; also a scene whose people reach past the image's edges."""
    a, b = np.random.RandomState(7), np.random.RandomState(7)
    got, want = make_demo.scene_batch(size, 4, a), jdemo.scene_batch(size, 4, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert a.randint(1 << 30) == b.randint(1 << 30)
    edge = [(size * 0.02, -size * 0.1, size * 0.9), (size * 0.98, size * 0.5, size * 0.8)]
    for k in range(3):
        got = make_demo.draw_scene(size, edge, np.random.RandomState(k))
        want = jdemo.draw_scene(size, edge, np.random.RandomState(k))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def _jax_demo_batches(jdemo, monkeypatch, out):
    """Run the JAX tool's ``main`` at ``--size 64 --steps 1`` with its
    train-state factory, step factories and evaluator replaced by
    recorders: the batches and learning rates each stage got, and what the
    evaluator was given."""
    import multiposenet_tpu.engine.evaluator as jev

    seen = {}

    class State:
        params = batch_stats = None

        def replace(self, **_):
            return self

    def factory(stage):
        def make(*_, **__):
            def step(state, batch, lr, *rest):
                seen[stage] = ({k: np.asarray(v) for k, v in batch.items()},
                               float(lr))
                return state, {"loss": jnp.zeros(()), "max_ht": jnp.zeros(())}
            return step, None
        return make

    class Evaluator:
        def __init__(self, cfg, model, variables):
            seen["eval_cfg"] = cfg

        def test(self, test_dir, out_dir):
            seen["test"] = (test_dir, out_dir)
            return []

    monkeypatch.setattr(jts, "create_train_state", lambda *a, **k: (State(), None, None))
    monkeypatch.setattr(jts, "STEP_FACTORIES",
                        {s: factory(s) for s in ("keypoint", "detection", "prn")})
    monkeypatch.setattr(jev, "Evaluator", Evaluator)
    monkeypatch.setattr(sys, "argv", ["make_demo.py", "--size", str(SIZE),
                                      "--steps", "1", "--out", out])
    jdemo.main()
    return seen


def test_demo_batches_equal_the_jax_tool(jdemo, monkeypatch, tmp_path):
    """The keypoint, detection and PRN batches that JAX's ``main`` builds
    inline, bit-equal to the port's functions of the same scenes; the
    learning rates equal the port's defaults; the held-out scenes that JAX
    writes through cv2 decode to the same pixels as the port's PNGs; the
    evaluator's configuration writes the same outputs at the same size."""
    seen = _jax_demo_batches(jdemo, monkeypatch, str(tmp_path / "jax"))
    imgs, joints = make_demo.scene_batch(SIZE, make_demo.N_TRAIN,
                                         np.random.RandomState(7))
    cfg = make_demo.demo_config(SIZE)
    args = make_demo.parse_args([])
    ours = {
        "keypoint": (make_demo.keypoint_batch(imgs, joints), args.lr),
        "detection": (make_demo.detection_batch(imgs, joints), args.det_lr),
        "prn": (make_demo.prn_batch(joints, cfg.model.prn_height,
                                    cfg.model.prn_width, cfg.prn.in_thres),
                make_demo.PRN_LR),
    }
    for stage, (batch, lr) in ours.items():
        want, want_lr = seen[stage]
        assert set(batch) == set(want), stage
        for k in batch:
            assert batch[k].dtype == want[k].dtype, (stage, k)
            assert np.array_equal(batch[k], want[k]), (stage, k)
        assert np.float32(lr) == np.float32(want_lr), stage
    assert ours["prn"][0]["label_marks"].sum() > 0
    assert (ours["prn"][0]["weights_marks"] >= ours["prn"][0]["label_marks"]).all()

    jcfg = seen["eval_cfg"]
    assert (jcfg.eval.inp_size, jcfg.eval.write_image, jcfg.eval.write_json) == (
        cfg.eval.inp_size, cfg.eval.write_image, cfg.eval.write_json)
    assert (jcfg.model.backbone, jcfg.data.inp_size) == (cfg.model.backbone,
                                                         cfg.data.inp_size)
    test_dir = seen["test"][0]
    for k, im in enumerate(make_demo.held_out_scenes(SIZE)):
        jax_png = cv2.imread(os.path.join(test_dir, f"scene{k + 1}.png"))
        assert np.array_equal(jax_png, im)
    assert sorted(os.listdir(test_dir)) == ["scene1.png", "scene2.png"]


@pytest.fixture(scope="module")
def init_tree():
    return perturbed_init("resnet50", SIZE)[1]


def narrow_prn(tree, nodes=64, cells=56 * 36 * 17):
    """``tree`` with its PRN cut to ``nodes`` hidden units and a grid of
    ``cells`` values (the first ones of each)."""
    prn = tree["params"]["prn"]
    cut = {"dens1": {"kernel": prn["dens1"]["kernel"][:cells, :nodes],
                     "bias": prn["dens1"]["bias"][:nodes]},
           "bneck": {"kernel": prn["bneck"]["kernel"][:nodes, :nodes],
                     "bias": prn["bneck"]["bias"][:nodes]},
           "dens2": {"kernel": prn["dens2"]["kernel"][:nodes, :cells],
                     "bias": prn["dens2"]["bias"][:cells]}}
    return {"params": {**tree["params"], "prn": cut},
            "batch_stats": tree["batch_stats"]}


@pytest.mark.parametrize("stage", ["keypoint", "detection", "prn"])
def test_demo_batch_step_equals_jax(init_tree, stage):
    """One train step of each stage on the demo's own batch, from the same
    weights in both packages, within tests/test_torch_port_train_steps.py's
    tolerances: the keypoint stage's float32 loss to 1e-4, logs to 1e-3 and
    running statistics to 2e-3 of each tensor's largest (its update is held
    in float64 there); detection logs to 1e-5 and updates to 1e-2 lr; PRN
    logs to 1e-4 and updates to 1e-2 lr, in float64 with a 64-unit PRN
    (XLA's float32 BCE over the 34,272-way softmax is 1e-6 off a float64
    evaluation, 2e-4 of this batch's small loss); frozen parameters
    bit-unchanged in both."""
    imgs, joints = make_demo.scene_batch(SIZE, make_demo.N_TRAIN,
                                         np.random.RandomState(7))
    x64 = stage == "prn"
    jcfg, cfg = configs(x64=x64)
    tree = init_tree
    if x64:
        tree = narrow_prn(init_tree)
        jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
            jcfg.model, prn_node_count=64))
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, prn_node_count=64))
    batch = {"keypoint": lambda: make_demo.keypoint_batch(imgs, joints),
             "detection": lambda: make_demo.detection_batch(imgs, joints),
             "prn": lambda: make_demo.prn_batch(joints, cfg.model.prn_height,
                                                cfg.model.prn_width,
                                                cfg.prn.in_thres)}[stage]()
    jlogs, jsd = jax_step(tree, stage, batch, jcfg, x64=x64)
    tlogs, before, after, _ = port_step(tree, stage, batch, cfg, x64=x64)
    if stage == "keypoint":
        np.testing.assert_allclose(tlogs["loss"], jlogs["loss"], rtol=1e-4)
        compare_step(stage, jlogs, jsd, tlogs, before, after, log_rtol=1e-3,
                     stats_rtol=2e-3)
    else:
        compare_step(stage, jlogs, jsd, tlogs, before, after,
                     log_rtol=1e-5 if stage == "detection" else 1e-4,
                     update_tol=1e-2)


def test_demo_runs_on_the_cpu_and_writes_its_files(model_files, capsys):
    """The port's demo at 64 px, one step a stage: the two held-out scenes
    as PNG, a heatmap and a canvas per scene and the results JSON; the last
    line of output is its JSON object.  On two threads: beside the other
    test workers, more only oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = make_demo.main(["--size", "64", "--steps", "1", "--device", "cpu",
                              "--out", str(model_files), "--diag"])
    finally:
        torch.set_num_threads(threads)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["written"] == ["multipose_results.json", "scene1_1heatmap.png",
                              "scene1_2canvas.png", "scene2_1heatmap.png",
                              "scene2_2canvas.png"]
    assert set(out["persons_per_scene"]) == {"scene1.png", "scene2.png"}
    assert out["device"] == "cpu" and out["nms_suppress_launches"] == 0
    assert set(out["wall_s"]) == {"keypoint", "detection", "prn", "test"}
    assert all(np.isfinite(v) for v in out["final_loss"].values())
    for k, im in enumerate(make_demo.held_out_scenes(64)):
        assert np.array_equal(read_image(os.path.join(
            out["test_dir"], f"scene{k + 1}.png")), im)
    canvas = read_image(os.path.join(out["out_dir"], "scene1_2canvas.png"))
    assert canvas.shape == (64, 64, 3)
    with open(os.path.join(out["out_dir"], "multipose_results.json")) as f:
        assert len(json.load(f)) == out["persons"]


# ---------------------------------------------------------------- the recipe

def _sh_commands(path):
    """The shell script's commands, continuation lines joined."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    return [shlex.split(line, comments=True) for line in text.splitlines()
            if line.strip() and not line.lstrip().startswith("#")]


def _flags(words):
    out, i = {}, 0
    while i < len(words):
        if words[i].startswith("--"):
            if i + 1 < len(words) and not words[i + 1].startswith("--"):
                out[words[i]] = words[i + 1]
                i += 2
                continue
            out[words[i]] = True
        i += 1
    return out


def test_recipe_table_equals_the_jax_script():
    """``train_synth_e2e.RECIPE`` against the flags of
    tools/train_synth_e2e.sh: the dataset generator's (the JAX tool's
    defaults for what the script does not pass), each stage's flags and
    bf16, the backbone, and a coco-eval at the default capacities."""
    cmds = _sh_commands(os.path.join(REPO, "tools", "train_synth_e2e.sh"))
    stages, evals, data = {}, [], None
    for words in cmds:
        if "make_synth_pose_dataset.py" in " ".join(words):
            data = _flags(words)
        if "multiposenet_tpu.cli" in words and "train" in words:
            f = _flags(words)
            stages[f.pop("--subnet")] = f
        if "multiposenet_tpu.cli" in words and "coco-eval" in words:
            evals.append(_flags(words))
    # the JAX generator's defaults for what the script leaves out
    with open(os.path.join(REPO, "tools", "make_synth_pose_dataset.py")) as f:
        src = f.read()
    default = {m.group(1): m.group(2) for m in re.finditer(
        r'add_argument\("(--[\w-]+)",[^)]*?default=([\w.]+)', src)}
    r = train_synth_e2e.RECIPE
    assert (r.n_train, r.n_val) == (int(data["--n-train"]), int(data["--n-val"]))
    assert (r.width, r.height, r.crowd_frac) == (
        int(default["--width"]), int(default["--height"]),
        float(default["--crowd-frac"]))
    assert [s for s, _, _ in r.stages] == list(stages) == ["keypoint", "detection", "prn"]
    for stage, flags, bf16 in r.stages:
        want = dict(stages[stage])
        assert want.pop("--backbone") == r.backbone == "resnet101"
        assert want.pop("--bf16", False) is bf16, stage
        for k in ("--coco-root", "--save-dir", "--exp-name", "--init-params"):
            want.pop(k, None)
        assert {k: str(v) for k, v in flags.items()} == {
            k: str(float(v)) if k == "--lr" else v for k, v in want.items()}, stage
        assert synth_e2e_gate.EXP[stage] == stages[stage]["--exp-name"]
    (ev,) = evals
    assert set(ev) == {"--coco-root", "--backbone", "--ckpt", "--result-file"}
    assert r.eval_flags == () and ev["--backbone"] == r.backbone


def test_recipe_never_trains_on_the_gates_tree(tmp_path, capsys):
    """A tree whose marker names the gate's generator flags is made again
    with the recipe's before any stage runs; a failing stage (an unknown
    backbone) then ends the recipe with exit 1 and nothing after it; and
    without a GPU and without --device cpu the recipe refuses."""
    root, save = tmp_path / "coco", tmp_path / "models"
    gate_args = synth_e2e_gate.parse_args(["--root", str(root), "--save-dir",
                                           str(save / "gate"), "--n-train", "2",
                                           "--n-val", "1", "--width", "64",
                                           "--height", "48"])
    env = dict(os.environ, MPN_PLATFORM="cpu")
    synth_e2e_gate.ensure_dataset(gate_args, synth_e2e_gate.GATE, env)
    marker = root / synth_e2e_gate.MARKER
    gate_flags = marker.read_text()
    assert "--crowd-frac 0.3" in gate_flags
    assert synth_e2e_gate.ensure_dataset(gate_args, synth_e2e_gate.GATE, env) == 0.0
    rc = train_synth_e2e.main(["--root", str(root), "--save-dir", str(save),
                               "--device", "cpu", "--n-train", "2", "--n-val", "1",
                               "--width", "64", "--height", "48",
                               "--backbone", "resnet18"])
    out = capsys.readouterr().out
    assert rc == 1 and "synth_e2e: dataset done" in out
    assert "synth_e2e: FAIL: keypoint failed" in out
    assert marker.read_text() != gate_flags and "--crowd-frac 0.25" in marker.read_text()
    assert not (save / "det").exists()
    if not torch.cuda.is_available():
        with pytest.raises(synth_e2e_gate.GateError, match="no CUDA device"):
            synth_e2e_gate.run_recipe(train_synth_e2e.recipe_parser(
                train_synth_e2e.RECIPE).parse_args(["--root", str(root)]),
                train_synth_e2e.RECIPE)


# ---------------------------------------------------------------- the runbook

METRIC_PAIRS = {
    "agree_above_baseline": ({"AP": 0.591, "AP50": 0.791}, {"AP": 0.590, "AP50": 0.791}, []),
    "modes_disagree": ({"AP": 0.591, "AP50": 0.791}, {"AP": 0.560, "AP50": 0.791}, []),
    "under_the_baseline": ({"AP": 0.500}, {"AP": 0.500}, []),
    "under_the_baseline_dry": ({"AP": 0.500}, {"AP": 0.500}, ["--no-baseline"]),
    "one_mode_empty": ({}, {"AP": 0.6, "AR": 0.7}, []),
    "other_mode_empty": ({"AP": 0.6}, {}, ["--no-baseline"]),
    "both_empty": ({}, {}, []),
    "both_empty_dry": ({}, {}, ["--no-baseline"]),
    "bf16_within_its_tol": ({"AP": 0.600, "AR": 0.7}, {"AP": 0.592, "AR": 0.7},
                            ["--mode-tol", "0.01", "--no-baseline"]),
    "bf16_beyond_its_tol": ({"AP": 0.600}, {"AP": 0.585},
                            ["--mode-tol", "0.01", "--no-baseline"]),
    "baseline_options": ({"AP": 0.61}, {"AP": 0.61},
                         ["--baseline-ap", "0.65", "--baseline-tol", "0.05"]),
}


@pytest.mark.parametrize("case", list(METRIC_PAIRS))
def test_verdict_tool_equals_the_jax_tool(case, tmp_path, capsys):
    """The port's verdict tool prints the JAX tool's table and exits with
    its code on the same pair of metric files and options."""
    fast, ref, extra = METRIC_PAIRS[case]
    a, b = tmp_path / "fast.json", tmp_path / "ref.json"
    a.write_text(json.dumps(fast))
    b.write_text(json.dumps(ref))
    want = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                        "diff_parity_metrics.py"),
                           str(a), str(b), *extra], capture_output=True, text=True)
    rc = diff_parity_metrics.main([str(a), str(b), *extra])
    assert (rc, capsys.readouterr().out) == (want.returncode, want.stdout)


def test_runbook_dry_run_on_the_cpu(model_files, monkeypatch):
    """The runbook's dry run: stand-in tree and h5, ``import-torch``, the
    three coco-eval modes at the dry run's low capacities (the escalated
    re-dispatch fires on the fast and bf16 paths; the reference-exact host
    chain has no escalation), both verdicts 0.  Its CLI processes run on
    two threads each, beside the other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rc = real_parity_runbook.main(["--dry-run", "--device", "cpu", "--out",
                                   str(model_files)])
    with open(model_files / "coco_eval_fast.log") as f:
        assert "re-dispatching at the escalated tier" in f.read()
    assert rc == 0
    for mode in ("fast", "ref", "bf16"):
        assert (model_files / f"results_{mode}.json").exists(), mode
        assert (model_files / f"metrics_{mode}.json").exists(), mode
    args = real_parity_runbook.parse_args(["--dry-run"])
    assert (args.backbone, args.max_images, args.extra_eval_flags) == (
        "resnet50", 2, "--inp-size 96 --max-peaks 2 --max-people 2")
    with pytest.raises(SystemExit):
        real_parity_runbook.parse_args(["coco_only"])
    if not torch.cuda.is_available():
        with pytest.raises(real_parity_runbook.RunbookError, match="no CUDA device"):
            real_parity_runbook.run(real_parity_runbook.parse_args(
                ["--dry-run", "--out", str(model_files / "x")]))


def test_runbook_reports_each_mode(model_files, capsys, monkeypatch):
    """The runbook's JSON line, with the CLI steps stood in for: every mode
    with its escalations and launches from its coco-eval log line, the two
    verdicts, and a mode disagreement stopping it before the bf16
    verdict with exit 1."""
    calls = []

    def fake_step(name, cmd, env, log_path, prefix):
        calls.append(name)
        out = os.path.dirname(log_path)
        if name == "import_torch":
            os.makedirs(os.path.join(cmd[cmd.index("import-torch") + 2], "ckpt_0"))
            return 0.5
        mode = name.split("_")[-1]
        with open(os.path.join(out, f"{name}.log"), "w") as f:
            f.write("coco-eval: 1 image(s) re-dispatched at the escalated peak "
                    f"tier; nms_suppress kernel launches {3 if mode != 'ref' else 10}\n")
        ap = {"fast": 0.600, "ref": 0.600, "bf16": 0.605}[mode]
        with open(cmd[cmd.index("--metrics-file") + 1], "w") as f:
            json.dump({"AP": ap}, f)
        return 1.0

    monkeypatch.setattr(real_parity_runbook, "run_stage", fake_step)
    rc = real_parity_runbook.main(["coco", "ref.h5", "--out", str(model_files),
                                   "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["passed"] and calls == [
        "import_torch", "coco_eval_fast", "coco_eval_ref", "coco_eval_bf16"]
    assert res["verdicts"] == {"fast_vs_ref": 0, "bf16_vs_fast": 0}
    assert {m: (v["escalated_images"], v["nms_suppress_launches"])
            for m, v in res["modes"].items()} == {
        "fast": (1, 3), "ref": (1, 10), "bf16": (1, 3)}
    # the published baseline binds without --dry-run: 0.600 >= 0.580
    monkeypatch.setattr(real_parity_runbook, "BASELINE_AP", 0.650)
    rc = real_parity_runbook.main(["coco", "ref.h5", "--out", str(model_files),
                                   "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and res["verdicts"] == {"fast_vs_ref": 1}


# ---------------------------------------------------------------- orbax

PRN = dict(prn_coeff=1, prn_node_count=64)


def test_orbax_checkpoint_converts_into_the_port(init_tree, model_files):
    """A JAX train state (ResNet-50, 64 px, a narrow PRN) saved by the JAX
    package's ``save_checkpoint`` and converted by tools/orbax_to_torch.py,
    in a process that imports nothing of ``multiposenet_tpu``: its BN
    statistics bit-equal to JAX's, and the port's forwards (heatmaps,
    detection scores and boxes, PRN) within tests/test_torch_port_model.py's
    2e-5 of each tensor's largest value of JAX's; read back through the
    ``--ckpt`` path (``model_state_for``) too."""
    jm = JPoseNet(JModelConfig(backbone="resnet50", **PRN))
    v = narrow_prn(init_tree, cells=28 * 18 * 17)
    rng = np.random.RandomState(3)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) + 0.5).astype(np.float32), v["batch_stats"])
    jcfg = JConfig(model=JModelConfig(backbone="resnet50", **PRN))
    tx, _ = jts.make_optimizer(jcfg, v["params"], "keypoint")
    state = jts.TrainState(step=jnp.asarray(7, jnp.int32), params=v["params"],
                           batch_stats=stats, opt_state=tx.init(v["params"]))
    src = j_save_checkpoint(str(model_files / "jax"), state, 3)

    code = ("import runpy, sys; sys.argv = ['orbax_to_torch.py'] + sys.argv[1:]; "
            "runpy.run_path(%r, run_name='__main__'); "
            "bad = [m for m in sys.modules if m == 'multiposenet_tpu' "
            "or m.startswith('multiposenet_tpu.')]; "
            "assert not bad, bad; print('isolated')"
            % os.path.join(REPO, "tools", "orbax_to_torch.py"))
    r = subprocess.run([sys.executable, "-c", code, src, str(model_files / "port")],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-3000:]
    path = str(model_files / "port" / "ckpt_3")
    assert f"wrote {path}" in r.stdout and "isolated" in r.stdout

    mcfg = ModelConfig(backbone="resnet50", **PRN)
    sd = ckpt_lib.load_checkpoint(path)["model"]
    assert sd.keys() == ckpt_lib.model_state_for(path, mcfg).keys()
    model = PoseNet(mcfg)
    model.load_state_dict(sd, strict=True)
    model.requires_grad_(False)
    n = 0
    for mod, leaves in _flat_stats(stats):
        for leaf, name in (("mean", "running_mean"), ("var", "running_var")):
            assert np.array_equal(sd[torch_key(mod, name)].numpy(), leaves[leaf])
            n += 1
    assert n == sum(k.endswith("running_mean") or k.endswith("running_var") for k in sd)

    img = np.random.RandomState(4).randn(2, SIZE, SIZE, 3).astype(np.float32)
    want = jm.apply({"params": v["params"], "batch_stats": stats},
                    jnp.asarray(img), method=JPoseNet.full_forward)
    got = model.full_forward(torch.from_numpy(img))
    grid = np.random.RandomState(5).rand(2, 28, 18, 17).astype(np.float32)
    want += (jm.apply({"params": v["params"], "batch_stats": stats},
                      jnp.asarray(grid), method=JPoseNet.prn_forward),)
    got += (model.prn_forward(torch.from_numpy(grid)),)
    for name, g, w in zip(("heatmaps", "cls", "reg", "prn"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.abs(g.numpy() - w).max() <= 2e-5 * np.abs(w).max(), name


def _flat_stats(tree, prefix=()):
    """(module path, {"mean", "var"}) of a Flax batch_stats tree."""
    if "mean" in tree:
        yield prefix, tree
        return
    for k, sub in tree.items():
        yield from _flat_stats(sub, prefix + (k,))


# ---------------------------------------------------------------- HDF5

def _h5_arrays(n):
    rng = np.random.RandomState(n)
    out = {f"fpn.layer{i % 4}.{i}.conv{i % 3}.weight": rng.randn(
        *rng.randint(1, 5, rng.randint(1, 5))).astype(np.float32) for i in range(n)}
    out.update({"fpn.bn1.num_batches_tracked": np.array(3, np.int64),
                "module.prn.dens1.bias": rng.randn(7).astype(np.float32),
                "f64": rng.randn(2, 3), "u8": np.arange(5, dtype=np.uint8),
                "i32": np.arange(-3, 3, dtype=np.int32).reshape(2, 3),
                "scalar": np.array(1.5, np.float32),
                "transposed": np.arange(6, dtype=np.float32).reshape(2, 3).T})
    return out


@pytest.mark.parametrize("n", [3, 900])
def test_h5file_reads_what_h5py_writes_and_back(tmp_path, n):
    """``utils/h5file`` (the port's reference-h5 IO, numpy alone) against
    h5py: a file h5py writes at its defaults (900 datasets make its group
    B-tree two levels deep over many symbol nodes), big-endian data and the
    epoch attribute among them, reads back equal in value, dtype and shape;
    the file ``write_h5`` writes reads back equal through h5py."""
    import h5py

    from multiposenet_tpu_torch.utils.h5file import read_h5, write_h5

    arrays = _h5_arrays(n)
    src = str(tmp_path / "h5py.h5")
    with h5py.File(src, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
        f.create_dataset("big_endian", data=np.arange(6, dtype=">f4").reshape(3, 2))
        f.attrs["epoch"] = 41
    got, attrs = read_h5(src)
    assert int(attrs["epoch"]) == 41 and len(attrs) == 1
    assert np.array_equal(got.pop("big_endian"), np.arange(6, dtype="f4").reshape(3, 2))
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert (got[k].dtype, got[k].shape) == (v.dtype, v.shape), k
        assert np.array_equal(got[k], v), k

    ours = str(tmp_path / "ours.h5")
    write_h5(ours, arrays, {"epoch": -1})
    with h5py.File(ours, "r") as f:
        assert set(f) == set(arrays) and int(f.attrs["epoch"]) == -1
        for k, v in arrays.items():
            a = f[k][()]
            assert (a.dtype, a.shape) == (v.dtype, v.shape) and np.array_equal(a, v), k
    assert read_h5(ours)[0].keys() == arrays.keys()


def test_h5file_refuses_what_it_does_not_read(tmp_path):
    """Compressed or chunked data, a group below the root and the newer
    file format raise ``H5Error`` naming the cause."""
    import h5py

    from multiposenet_tpu_torch.utils.h5file import H5Error, read_h5

    cases = {
        "compressed": lambda f: f.create_dataset("x", data=np.ones(64, np.float32),
                                                 compression="gzip"),
        "chunked": lambda f: f.create_dataset("x", data=np.ones(64, np.float32),
                                              chunks=(16,)),
        "groups below the root": lambda f: f.create_group("g").create_dataset(
            "x", data=np.ones(2)),
    }
    for what, make in cases.items():
        path = str(tmp_path / f"{what}.h5")
        with h5py.File(path, "w") as f:
            make(f)
        with pytest.raises(H5Error, match=what.split()[0]):
            read_h5(path)
    path = str(tmp_path / "latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones(2))
    with pytest.raises(H5Error, match="superblock version"):
        read_h5(path)


# ---------------------------------------------------------------- isolation

PORT_MODULES = ("multiposenet_tpu_torch.tools.make_demo",
                "multiposenet_tpu_torch.tools.train_synth_e2e",
                "multiposenet_tpu_torch.tools.real_parity_runbook",
                "multiposenet_tpu_torch.tools.diff_parity_metrics",
                "multiposenet_tpu_torch.eval.render",
                "multiposenet_tpu_torch.utils.h5file")


@pytest.mark.parametrize("module", PORT_MODULES)
def test_new_module_imports_nothing_of_jax(module):
    """Each new module, imported with what its entry point imports when it
    runs (the CLI, the evaluator, the train steps, the h5 IO), in a fresh
    process: no ``jax``, no ``h5py`` (the port reads and writes the
    reference's h5 files without it), and no name that is
    ``multiposenet_tpu`` or starts with ``multiposenet_tpu.``."""
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "import multiposenet_tpu_torch.cli, "
            "multiposenet_tpu_torch.engine.evaluator, "
            "multiposenet_tpu_torch.engine.train_steps, "
            "multiposenet_tpu_torch.weights; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'h5py') "
            "or m == 'multiposenet_tpu' or m.startswith('multiposenet_tpu.')]; "
            "print(bad)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "[]"


def test_new_entry_points_refuse_without_a_gpu(tmp_path):
    """Without a GPU and without ``--device cpu`` the demo raises before it
    builds anything; the recipe and the runbook exit 1 (their refusals are
    held in their own tests above)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tools run on it")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        make_demo.main(["--out", str(tmp_path / "demo")])
    assert not (tmp_path / "demo").exists()
    assert train_synth_e2e.main(["--root", str(tmp_path / "c"),
                                 "--save-dir", str(tmp_path / "m")]) == 1
    assert not (tmp_path / "c").exists()
    assert real_parity_runbook.main(["--dry-run", "--out", str(tmp_path / "p")]) == 1
    assert not (tmp_path / "p").exists()
