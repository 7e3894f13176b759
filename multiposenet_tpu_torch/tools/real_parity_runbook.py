"""One-command real-data AP parity run against the reference's published
table (BASELINE.md AP 0.590) — the port's counterpart of
tools/real_parity_runbook.sh.  Once COCO val2017 and the reference's
``ckpt_baseline_resnet101.h5`` are at hand, one command gives the verdict:

  python -m multiposenet_tpu_torch.tools.real_parity_runbook \\
      COCO_ROOT REF_CKPT.h5 [--out DIR]

The steps, in the JAX script's order, each a CLI subprocess whose output
goes to ``<out>/<step>.log``:
  1. ``cli import-torch H5 <out>/ckpt``: the reference h5 as a port
     checkpoint (tools/convert_torch_ckpt.py's counterpart; the JAX
     script's precompile step has none: PyTorch compiles nothing ahead);
  2. ``cli coco-eval`` three ways: ``fast``, the device defaults; ``ref``,
     the reference-exact host chain (``REF_FLAGS``: host resize, peaks,
     image resize and grouping); ``bf16``, the serving dtype;
  3. the verdicts (tools/diff_parity_metrics): fast against ref, strict,
     with the published baseline as the floor of ref's AP; then bf16
     against fast at ``--mode-tol 0.01`` without the baseline.
The first failing step ends the run with a non-zero exit.

The JAX script's environment overrides are options: ``--backbone``,
``--max-images``, ``--extra-eval-flags`` (appended to every coco-eval),
``--dry-run`` (no baseline comparison) and ``--device``.  ``--dry-run``
without COCO_ROOT and H5 writes synthetic stand-ins under
``<out>/stand_in`` (as tests/test_parity_runbook.py does for the JAX
script): a 160x128 crowd tree of 1 + 2 images from seed 5, and a random
reference-layout h5 whose final keypoint conv is rescaled so that the
heatmaps reach ~0.62 and the crowds overfill ``--max-peaks 2``; it then
runs ResNet-50 at ``--inp-size 96 --max-peaks 2 --max-people 2`` on 2
images unless told otherwise, so that the escalated re-dispatch fires.

The default ``--out`` lies outside the repository, in the temporary
directory.  The last line of standard output is one JSON object: per mode
its wall seconds, escalated images, kernel K1's launches and stats; the
two verdicts' exit codes; whether the run passed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from multiposenet_tpu_torch.tools import diff_parity_metrics
from multiposenet_tpu_torch.tools.synth_e2e_gate import GateError as RunbookError
from multiposenet_tpu_torch.tools.synth_e2e_gate import LAUNCH_RE, run_stage

BASELINE_AP = 0.590
REF_FLAGS = ("--host-resize", "--host-peaks", "--host-image-resize",
             "--host-grouping")
MODES = {"fast": (), "ref": REF_FLAGS, "bf16": ("--bf16",)}
BF16_TOL = 0.01        # bf16 against fast: a numerics-only switch
# the stand-in data's run
DRY_BACKBONE = "resnet50"
DRY_MAX_IMAGES = 2
DRY_EVAL_FLAGS = "--inp-size 96 --max-peaks 2 --max-people 2"
HEAT_PEAK = 0.62       # the stand-in's heatmap maximum on its probe image


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("coco_root", nargs="?", default=None)
    ap.add_argument("h5", nargs="?", default=None,
                    help="the reference checkpoint (ckpt_baseline_resnet101.h5)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "mpn_parity_torch"))
    ap.add_argument("--backbone", default=None,
                    help=f"default resnet101 ({DRY_BACKBONE} for stand-ins)")
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--extra-eval-flags", default=None,
                    help="appended to every coco-eval, e.g. '--inp-size 96'")
    ap.add_argument("--dry-run", action="store_true",
                    help="skip the baseline comparison; without COCO_ROOT "
                         "and H5, run on synthetic stand-ins")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if (args.coco_root is None) != (args.h5 is None):
        ap.error("give both COCO_ROOT and H5, or neither (with --dry-run)")
    if args.coco_root is None and not args.dry_run:
        ap.error("COCO_ROOT and H5 are required unless --dry-run")
    stand_in = args.coco_root is None
    if args.backbone is None:
        args.backbone = DRY_BACKBONE if stand_in else "resnet101"
    if args.max_images is None and stand_in:
        args.max_images = DRY_MAX_IMAGES
    if args.extra_eval_flags is None:
        args.extra_eval_flags = DRY_EVAL_FLAGS if stand_in else ""
    return args


def make_stand_in(root: str, backbone: str) -> tuple:
    """A crowd tree and a random reference-layout h5 under ``root``, made on
    the host: (coco root, h5 path)."""
    import numpy as np
    import torch

    from multiposenet_tpu_torch.config import ModelConfig
    from multiposenet_tpu_torch.models.posenet import build_posenet
    from multiposenet_tpu_torch.tools import make_synth_pose_dataset
    from multiposenet_tpu_torch.weights import write_reference_h5

    coco = os.path.join(root, "coco")
    make_synth_pose_dataset.main([
        "--root", coco, "--n-train", "1", "--n-val", "2", "--width", "160",
        "--height", "128", "--seed", "5", "--crowd-frac", "1.0",
        "--workers", "1"])
    model = build_posenet(ModelConfig(backbone=backbone), torch.device("cpu"),
                          seed=0)
    # a random net's heatmaps are ~1e-2 and no peak would clear thre1:
    # scale the final keypoint conv so that they reach HEAT_PEAK on a probe
    probe = torch.from_numpy(
        np.random.RandomState(7).rand(1, 96, 96, 3).astype(np.float32))
    heat = model.keypoint_forward(probe)[0]
    k = HEAT_PEAK / float(heat.abs().max())
    state = model.state_dict()
    for name in ("convfin.weight", "convfin.bias"):
        state[name] = state[name] * k
    h5 = os.path.join(root, "ref_ckpt.h5")
    write_reference_h5(state, h5)
    return coco, h5


def run(args) -> dict:
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RunbookError("no CUDA device: the runbook runs on the GPU "
                               "unless --device cpu is given")
    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"
    if args.device == "cpu":
        env["MPN_PLATFORM"] = "cpu"
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    coco, h5 = args.coco_root, args.h5
    if coco is None:
        coco, h5 = make_stand_in(os.path.join(out, "stand_in"), args.backbone)

    cli = [sys.executable, "-m", "multiposenet_tpu_torch.cli"]
    ckpt_dir = os.path.join(out, "ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    wall = {"import_torch": run_stage(
        "import_torch", cli + ["import-torch", h5, ckpt_dir, "--backbone",
                               args.backbone], env,
        os.path.join(out, "import_torch.log"), "runbook")}
    (ckpt,) = [os.path.join(ckpt_dir, n) for n in os.listdir(ckpt_dir)]

    extra = args.extra_eval_flags.split()
    if args.max_images is not None:
        extra += ["--max-images", str(args.max_images)]
    modes = {}
    for mode, flags in MODES.items():
        metrics_file = os.path.join(out, f"metrics_{mode}.json")
        name = f"coco_eval_{mode}"
        wall[name] = run_stage(name, cli + [
            "coco-eval", "--coco-root", coco, "--backbone", args.backbone,
            "--ckpt", ckpt, *extra, *flags,
            "--result-file", os.path.join(out, f"results_{mode}.json"),
            "--metrics-file", metrics_file], env,
            os.path.join(out, f"{name}.log"), "runbook")
        with open(os.path.join(out, f"{name}.log"), errors="replace") as f:
            found = LAUNCH_RE.findall(f.read())
        if not found:
            raise RunbookError(f"coco-eval {mode} logged no launch line")
        with open(metrics_file) as f:
            stats = json.load(f)
        escalated, launches = (int(v) for v in found[-1])
        modes[mode] = {"wall_s": wall[name], "escalated_images": escalated,
                       "nms_suppress_launches": launches, "stats": stats}

    result = {"modes": modes, "wall_s": wall, "dry_run": args.dry_run,
              "coco_root": coco, "backbone": args.backbone,
              "verdicts": {}, "passed": False}
    diff = [os.path.join(out, "metrics_fast.json"),
            os.path.join(out, "metrics_ref.json"),
            "--baseline-ap", str(BASELINE_AP)]
    rc = diff_parity_metrics.main(diff + (["--no-baseline"] if args.dry_run else []))
    result["verdicts"]["fast_vs_ref"] = rc
    if rc == 0:
        # bf16 against the float32 device default: no baseline re-check
        print("== bf16 vs fast ==", flush=True)
        rc = diff_parity_metrics.main([
            os.path.join(out, "metrics_bf16.json"),
            os.path.join(out, "metrics_fast.json"),
            "--mode-tol", str(BF16_TOL), "--no-baseline"])
        result["verdicts"]["bf16_vs_fast"] = rc
        result["passed"] = rc == 0
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result = run(args)
    except RunbookError as e:
        print(f"runbook: FAIL: {e}", flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0 if result["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
