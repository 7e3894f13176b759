"""The port's measurement tools (multiposenet_tpu_torch/tools: bench_serving,
bench_e2e_stages, bench_reference_shaped, profile_trace, bench_loader,
bench_trainer_loop, bench_train_mfu, bench_fold_bn, measure_bf16_drift)
against the JAX package's tools on the CPU: their outputs on the same
weights and network outputs, their inputs bit for bit, and the soundness of
what they measure.  resnet50 at 64 px; the JAX weights cross into the port
through ``weights.state_dict_from_flax``.

Where a tool's outputs are compared with JAX's, the two pipelines are fed
the JAX model's (heatmaps, cls, reg) (``ForwardStub``), as in
tests/test_torch_port_e2e.py, so that the comparison holds the tool's
path and not the two packages' convolution rounding.
"""

import ast
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiposenet_tpu.config import DataConfig as JDataConfig
from multiposenet_tpu.data import datasets as jds
from multiposenet_tpu.engine.evaluator import Evaluator as JEvaluator
from multiposenet_tpu.engine.evaluator import drop_neck as j_drop_neck
from multiposenet_tpu.engine.inference import (
    format_pose_batch as j_format_pose_batch,
    make_e2e_pose_pipeline as j_make_e2e,
    make_full_pipeline as j_make_full,
    preprocess_on_device as j_preprocess,
)
from multiposenet_tpu.eval.multiscale import (
    joint_list_from_heatmaps as j_joint_list_from_heatmaps,
)
from multiposenet_tpu.models.fold_bn import fold_bn_variables
from multiposenet_tpu.models.posenet import PoseNet as JPoseNet

from multiposenet_tpu_torch.config import DataConfig
from multiposenet_tpu_torch.data import datasets
from multiposenet_tpu_torch.tools import (
    bench_e2e_stages,
    bench_fold_bn,
    bench_loader,
    bench_reference_shaped,
    bench_serving,
    bench_train_mfu,
    bench_trainer_loop,
    measure_bf16_drift,
    probe_pyramid_conv,
    profile_trace,
)
from multiposenet_tpu_torch.tools.benchlib import pctl, with_model
from test_torch_port_data import _compare_items
from torch_port_helpers import (
    HEAD_STD,
    ForwardStub,
    jax_config,
    perturbed_init,
    port_config,
    port_model,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
CPU = torch.device("cpu")
TOOLS = ("bench_serving", "bench_e2e_stages", "bench_reference_shaped",
         "profile_trace", "bench_loader", "bench_trainer_loop",
         "bench_train_mfu", "bench_fold_bn", "measure_bf16_drift")
JAX_TOOL = {"profile_trace": "profile_xplane"}


def jax_tool_source(name: str) -> ast.Module:
    path = os.path.join(REPO, "tools", JAX_TOOL.get(name, name) + ".py")
    with open(path) as f:
        return ast.parse(f.read())


def load_jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def nested_function(tree: ast.Module, outer: str, inner: str) -> ast.FunctionDef:
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == outer)
    return next(n for n in ast.walk(fn) if isinstance(n, ast.FunctionDef)
                and n.name == inner)


@pytest.fixture(scope="module")
def slice_run():
    """One JAX model (detection heads drawn wide, lowered thresholds) and
    its bridged port twin, 3 images, and the JAX network outputs."""
    jm, v = perturbed_init("resnet50", SIZE, seed=1, head_std=HEAD_STD)
    imgs = (np.random.RandomState(7).rand(3, SIZE, SIZE, 3) * 255).astype(np.uint8)
    fwd = jax.jit(lambda v, x: jm.apply(v, j_preprocess(x),
                                        method=JPoseNet.full_forward))
    heads = [np.array(h) for h in jax.device_get(fwd(v, jnp.asarray(imgs)))]
    return jm, v, imgs, heads


def stub_forward(pipe, heads):
    """The port pipeline's forward returns ``heads`` (the JAX model's)."""
    pipe.forward = lambda images: tuple(torch.from_numpy(h) for h in heads)


# ---------------------------------------------------------------- isolation

@pytest.mark.parametrize("name", TOOLS + ("benchlib", "probe_pyramid_conv"))
def test_tool_stays_apart_from_jax(name):
    """No module of the tools imports jax or the JAX package (a name that
    is ``multiposenet_tpu`` or starts with ``multiposenet_tpu.``); each
    tool has a ``main(argv=None, ...)`` and runs under ``python -m``."""
    path = os.path.join(REPO, "multiposenet_tpu_torch", "tools", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    for mod in imported:
        top = mod.split(".")[0]
        assert top != "jax" and top != "jaxlib", (name, mod)
        assert mod != "multiposenet_tpu" and not mod.startswith("multiposenet_tpu."), \
            (name, mod)
    if name == "benchlib":
        return
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    assert main.args.args[0].arg == "argv" and main.args.defaults[0].value is None
    assert any(isinstance(n, ast.If) and "__main__" in ast.unparse(n.test)
               for n in tree.body)
    if name in TOOLS:
        assert jax_tool_source(name) is not None


@pytest.mark.parametrize("name", TOOLS + ("probe_pyramid_conv",))
def test_tool_refuses_without_a_gpu(name, monkeypatch):
    """Without a GPU and without ``MPN_PLATFORM=cpu`` every tool raises
    before it builds anything; with it, it would run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tools run on it")
    monkeypatch.delenv("MPN_PLATFORM", raising=False)
    mod = globals()[name]
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        mod.main([])
    monkeypatch.setenv("MPN_PLATFORM", "cpu")
    from multiposenet_tpu_torch.tools.benchlib import tool_device
    assert tool_device() == CPU


def test_pyramid_conv_probe_counts_on_the_cpu():
    """probe_pyramid_conv's float32 arm on the CPU: every weight gradient
    finite and its off-centre taps exactly 0 (they see only padding); the
    bfloat16 arm reports its counts (oneDNN's garbage there varies from run
    to run, so only their range is held)."""
    r = probe_pyramid_conv.probe_conv(3, CPU)
    assert r["float32"] == {"trials": 3, "not_finite": 0, "max_off_centre": 0.0}
    assert 0 <= r["bfloat16"]["not_finite"] <= 3
    assert r["bfloat16"]["max_off_centre"] >= 0.0


# ---------------------------------------------------------------- inputs

def test_serving_inputs_and_percentile_equal_jax():
    """The request images are the JAX tool's, bit for bit (its list
    comprehension in ``_run_bench``, evaluated here), and ``pctl`` is its
    percentile."""
    fn = next(n for n in jax_tool_source("bench_serving").body
              if isinstance(n, ast.FunctionDef) and n.name == "_run_bench")
    assign = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "imgs")
    want = eval(compile(ast.Expression(assign.value), "jax_tool", "eval"),
                {"np": np, "rng": np.random.RandomState(0)})
    got = bench_serving.serving_images()
    assert len(got) == len(want) == 64
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jtool = load_jax_tool("bench_serving")
    xs = np.random.RandomState(3).rand(37) * 100
    for q in (50, 95, 99):
        assert pctl(xs, q) == jtool.pctl(xs, q)


@pytest.mark.parametrize("subnet", ["keypoint", "detection", "prn"])
def test_train_mfu_batches_equal_jax(subnet):
    """``bench_train_mfu.make_batch`` equals the JAX tool's for the same
    RandomState, bit for bit, and so does ``bench_trainer_loop``'s batch
    list against the JAX tool's nested ``make_batch`` called in turn."""
    from multiposenet_tpu.config import Config as JConfig

    from multiposenet_tpu_torch.config import Config
    jtool = load_jax_tool("bench_train_mfu")
    want = jtool.make_batch(subnet, JConfig(), 3, SIZE, np.random.RandomState(0))
    got = bench_train_mfu.make_batch(subnet, Config(), 3, SIZE,
                                     np.random.RandomState(0))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])

    if subnet != "keypoint":
        return
    fn = nested_function(jax_tool_source("bench_trainer_loop"), "main", "make_batch")
    ns = {"np": np, "rng": np.random.RandomState(0),
          "args": type("A", (), {"batch": 3})(), "size": SIZE}
    exec(compile(ast.Module([fn], []), "jax_tool", "exec"), ns)
    want = [ns["make_batch"]() for _ in range(4)]
    got = bench_trainer_loop.make_batches(4, 3, SIZE, np.random.RandomState(0))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_loader_tree_gives_jax_the_same_items(tmp_path):
    """The loader bench's PNG tree: its records are the JAX tool's
    ``make_synthetic_dataset``'s (but the image suffix), and the port's and
    JAX's ``KeypointDataset`` read the same items from it within the bounds
    of ROADMAP §3.4 (joints equal, pixels within one level on <= 1%)."""
    jtool = load_jax_tool("bench_loader")
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jtool.make_synthetic_dataset(jroot, 3)
    records = bench_loader.make_synthetic_dataset(root, 3)
    for g, w in zip(records, want):
        assert g["img_paths"] == w["img_paths"][:-4] + ".png"
        assert {**g, "img_paths": None} == {**w, "img_paths": None}
    jcfg, cfg = JDataConfig(inp_size=SIZE), DataConfig(inp_size=SIZE)
    idx = list(range(len(records)))
    jset = jds.KeypointDataset(records, idx, root, root, jcfg, augment=True)
    tset = bench_loader.keypoint_dataset(root, records, SIZE)
    assert isinstance(tset, datasets.KeypointDataset) and tset.cfg == cfg
    for i in idx:
        _compare_items(jset.__getitem__(i, np.random.default_rng(i)),
                       tset.__getitem__(i, np.random.default_rng(i)),
                       f"loader tree item {i}")


# ---------------------------------------------------------------- outputs

def test_e2e_stages_equal_jax(slice_run):
    """Stages A-D of ``bench_e2e_stages.measure_stages`` against JAX
    ``make_full_pipeline``, ``make_e2e_pose_pipeline`` and
    ``format_pose_batch`` on the same network outputs: scores within 1e-6
    (tests/test_torch_port_e2e.py's box bound), ``chosen`` and every
    integer and boolean field exactly, the coordinates within 1e-5, the
    ``PoseAssignments`` bytes equal to JAX's; each rate positive."""
    jm, v, imgs, heads = slice_run
    jcfg, cfg = jax_config(SIZE), port_config(SIZE)
    params = {"v": v, "heads": heads}
    scales = np.ones(len(imgs), np.float32)
    jdet = jax.device_get(j_make_full(ForwardStub(jm), jcfg, (SIZE, SIZE))(
        params, jnp.asarray(imgs)))
    _, jassign = jax.device_get(j_make_e2e(ForwardStub(jm), jcfg, (SIZE, SIZE))(
        params, jnp.asarray(imgs), jnp.asarray(scales)))
    jrows = j_format_pose_batch(jassign)

    from multiposenet_tpu_torch.engine.inference import (
        make_e2e_pose_pipeline, make_full_pipeline)
    model = port_model(v, cfg)
    detect = make_full_pipeline(model, cfg, (SIZE, SIZE), device="cpu")
    e2e = make_e2e_pose_pipeline(model, cfg, (SIZE, SIZE), device="cpu")
    stub_forward(detect, heads)
    stub_forward(e2e, heads)
    m = bench_e2e_stages.measure_stages(detect, e2e, torch.from_numpy(imgs),
                                        torch.from_numpy(scales), 1, CPU)
    out = m["outputs"]
    np.testing.assert_allclose(out["A"].numpy(), np.asarray(jdet.detections.scores),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out["B"].numpy(), np.asarray(jassign.chosen))
    for field, got in zip(out["C"]._fields, out["C"]):
        want = np.asarray(getattr(jassign, field))
        assert got.shape == want.shape, field
        if got.dtype in (torch.int32, torch.bool) or field in ("peak_xy",):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=field)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5,
                                       err_msg=field)
    assert m["pose_assignments_bytes"] == sum(np.asarray(x).nbytes for x in jassign)
    assert len(out["D"]) == len(jrows) == len(imgs)
    assert sum(len(r) for r in jrows) > 0
    for g_img, w_img in zip(out["D"], jrows):
        assert len(g_img) == len(w_img)
        for g, w in zip(g_img, w_img):
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=1e-6, atol=1e-5)
            assert g["score"] == w["score"]
            np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=1e-5)
    for k in "ABCD":
        assert m[f"{k}_images_per_sec"] > 0


def test_reference_shaped_rows_equal_jax(slice_run):
    """``ReferenceShaped.one_image`` on 2 images against the JAX tool's
    ``one_image`` (its steps, on the JAX package: the pipeline without
    peaks, the whole heatmap to the host, host peaks, the neck dropped, the
    test threshold, ``Evaluator.prn_process``) on the same network
    outputs: the same people, boxes within 1e-5, scores equal, keypoints
    within 1e-4 (the host refine of two float heatmaps)."""
    jm, v, imgs, heads = slice_run
    jcfg, cfg = jax_config(SIZE), port_config(SIZE)
    jpipe = j_make_full(ForwardStub(jm), jcfg, (SIZE, SIZE), with_peaks=False)
    jev = JEvaluator(jcfg, jm, v)
    ref = bench_reference_shaped.ReferenceShaped(port_model(v, cfg), cfg, SIZE, CPU)
    n_people = 0
    for i in range(2):
        one = [h[i:i + 1] for h in heads]
        out = jpipe({"v": v, "heads": one}, jnp.asarray(imgs[i:i + 1]))
        heat = np.asarray(out.heatmaps[0], np.float32)
        keep = np.asarray(out.detections.keep[0])
        boxes = np.asarray(out.detections.boxes[0])[keep]
        scores = np.asarray(out.detections.scores[0])[keep]
        jl = j_drop_neck(j_joint_list_from_heatmaps(heat, SIZE, 1.0,
                                                    thre1=jcfg.peaks.thre1))
        sel = scores > jcfg.detection.test_score_thresh
        want = jev.prn_process(jl, [[b[0], b[1], b[2], b[3]] for b in boxes[sel]],
                               "bench", 0)
        stub_forward(ref.pipeline, one)
        got = ref.one_image(imgs[i:i + 1])
        assert len(got) == len(want)
        n_people += len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=1e-6, atol=1e-5)
            assert g["score"] == w["score"]
            np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=1e-4)
    assert n_people > 0


def test_fold_bn_arms_agree_and_equal_jax(slice_run):
    """``bench_fold_bn.ab`` in float32: the folded and unfolded arms'
    heatmaps within 2e-4 and their candidate scores within 2e-4 (JAX's own
    bounds between its folded and unfolded forwards, tests/test_fold_bn.py),
    and the folded arm's heatmaps within 2e-4 of JAX's folded pipeline;
    the reported difference is the largest over every output."""
    jm, v, imgs, _ = slice_run
    cfg = port_config(SIZE)
    model = port_model(v, cfg)
    r = bench_fold_bn.ab(model, cfg, torch.from_numpy(imgs),
                         torch.ones(len(imgs)), 1, False, CPU)
    a, b = r["outputs"]
    np.testing.assert_allclose(b.heatmaps.numpy(), a.heatmaps.numpy(), rtol=0, atol=2e-4)
    assert r["max_abs_diff"] == bench_fold_bn.max_abs_diff(a, b)
    assert r["unfolded_images_per_sec"] > 0 and r["fold_bn_images_per_sec"] > 0

    jcfg = jax_config(SIZE)
    jfold = JPoseNet(dataclasses.replace(jcfg.model, fold_bn=True))
    jout = jax.device_get(j_make_full(jfold, dataclasses.replace(
        jcfg, model=dataclasses.replace(jcfg.model, fold_bn=True)),
        (SIZE, SIZE))(fold_bn_variables(v), jnp.asarray(imgs)))
    np.testing.assert_allclose(b.heatmaps.numpy(), np.asarray(jout.heatmaps),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(b.detections.scores.numpy().max(axis=1),
                               np.asarray(jout.detections.scores).max(axis=1),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(a.detections.scores.numpy().max(axis=1),
                               b.detections.scores.numpy().max(axis=1),
                               rtol=0, atol=2e-4)


# ---------------------------------------------------------------- soundness

def test_profile_trace_accounting_counts_an_overlap_once():
    """Busy time is the union of the kernel intervals, idle the gaps, and
    busy + idle the span; overlapping kernels (two streams) count once in
    busy and twice in the kernel total; a span per execution off the
    reference time, a span longer than the host's wall window, or an empty
    trace, fails loudly."""
    events = [("sm90_xmma_fprop_implicit_gemm_bf16", 0.0, 4.0),
              ("void at::native::vectorized_elementwise_kernel", 3.0, 5.0),
              ("nms_suppress_kernel", 6.0, 6.5),
              ("Memcpy DtoH (Device -> Pinned)", 6.5, 7.0),
              ("sm90_gemm_tn", 8.0, 9.0),
              ("ampere_sgemm_128x64_nn", 8.5, 10.0)]
    acc = profile_trace.account(events, n_exec=2, ref_ms_per_exec=5.0, top=3)
    assert acc["busy_ms"] == 5.0 + 1.0 + 2.0
    assert acc["idle_ms"] == 1.0 + 1.0
    assert acc["span_ms"] == 10.0 == acc["busy_ms"] + acc["idle_ms"]
    assert acc["kernel_total_ms"] == 4.0 + 2.0 + 0.5 + 0.5 + 1.0 + 1.5
    assert acc["device_busy_ms_per_exec"] == 4.0
    assert acc["idle_share"] == 0.2
    b = acc["buckets"]
    assert (b["convolution"]["ms"], b["elementwise/reduction"]["ms"],
            b["NMS K1"]["ms"], b["copy/memcpy"]["ms"], b["GEMM"]["ms"],
            b["other"]["n"]) == (4.0, 2.0, 0.5, 0.5, 2.5, 0)
    assert [t["name"] for t in acc["top"]] == [
        "sm90_xmma_fprop_implicit_gemm_bf16",
        "void at::native::vectorized_elementwise_kernel",
        "ampere_sgemm_128x64_nn"]
    assert profile_trace.bucket("cudnn::bn_fw_inf_1C11_kernel_NCHW") == \
        "elementwise/reduction"
    assert profile_trace.bucket("some_custom_kernel") == "other"
    with pytest.raises(profile_trace.ReconcileError, match="CUDA-event time"):
        profile_trace.account(events, n_exec=2, ref_ms_per_exec=4.0, max_off=0.15)
    with pytest.raises(profile_trace.ReconcileError, match="no device event"):
        profile_trace.account([], n_exec=1, ref_ms_per_exec=1.0)
    assert profile_trace.account(events, n_exec=2, ref_ms_per_exec=5.0,
                                 wall_ms=10.0 / 1.005)["reconciled"]
    with pytest.raises(profile_trace.ReconcileError, match="wall window"):
        profile_trace.account(events, n_exec=2, ref_ms_per_exec=5.0, wall_ms=9.8)


def test_serving_idle_share_holds_the_trace_to_its_wall_window():
    """bench_serving's idle share is 1 - busy / wall with busy the union
    of the device intervals (an overlap counted once), exact on synthetic
    intervals; intervals whose span exceeds the wall window by more than
    1% (events from outside it, or another clock) raise instead of
    reading as a plausible share."""
    iv = [(0.0, 4.0), (3.0, 5.0), (8.0, 9.0)]
    assert bench_serving.idle_of_window(iv, 10.0) == 1.0 - 6.0 / 10.0
    assert bench_serving.idle_of_window(iv, 9.0 / 1.005) == 1.0 - 6.0 / (9.0 / 1.005)
    with pytest.raises(profile_trace.ReconcileError, match="wall window"):
        bench_serving.idle_of_window(iv, 8.9)
    with pytest.raises(profile_trace.ReconcileError, match="wall window"):
        bench_serving.idle_of_window([(0.0, 12.0)], 10.0)


def test_train_mfu_counts_the_step_as_it_runs():
    """The keypoint step's FLOPs are 2.8-3.0 times its forward's (the
    backward is twice the forward, less the stem's input gradient); the
    detection step's are below that, since its frozen trunk has no
    backward."""
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet

    ratios = {}
    model = None
    for subnet in ("keypoint", "detection"):
        # a narrow PRN: its seeded init dominates the build, and neither
        # stage runs it
        cfg = with_model(bench_train_mfu.mfu_config(subnet, SIZE, "resnet50", f32=True),
                         prn_node_count=64)
        model = model or build_trainable_posenet(cfg.model, CPU, seed=0)
        m = bench_train_mfu.measure_step(cfg, subnet, 1, 1, CPU, model=model)
        ratios[subnet] = m["step_flops"] / m["forward_flops"]
        assert m["ms_per_step"] > 0 and np.isfinite(m["loss"])
    assert 2.8 <= ratios["keypoint"] <= 3.0
    assert ratios["detection"] < 2.8
    peak, flags = bench_train_mfu.peak_flops("bfloat16", "keypoint")
    assert peak == 989.4e12 and set(flags) == {"cudnn_allow_tf32", "matmul_allow_tf32"}


def test_bf16_drift_is_zero_between_two_float32_arms():
    """``measure_bf16_drift.drift`` with float32 in both arms (two models
    of the same weights) reports no drift in any quantity, and finds
    peaks to compare."""
    from multiposenet_tpu_torch.config import Config, ModelConfig
    from multiposenet_tpu_torch.models.posenet import build_posenet

    cfg = Config(model=ModelConfig(backbone="resnet50", prn_node_count=64))
    a = build_posenet(cfg.model, CPU, seed=0)
    imgs = torch.from_numpy((np.random.RandomState(0).rand(
        1, SIZE, SIZE, 3) * 255).astype(np.uint8))
    measure_bf16_drift.rescale_heatmap_head(a, cfg, imgs)
    b = build_posenet(cfg.model, CPU, a.state_dict())
    d = measure_bf16_drift.drift(a, cfg, b, with_model(cfg), imgs)
    assert d["peaks_all"] > 0 and d["top5_peaks"] > 0
    for k in ("heatmap_max_abs_diff", "heatmap_rms_diff", "peaks_all_without_twin",
              "top5_moved", "top5_max_px", "score_max_drift", "score_rms_drift",
              "box_max_drift_px", "box_rms_drift_px"):
        assert d[k] == 0.0, k
