"""The synthetic end-to-end gate: generate a learnable crowd dataset, train
the three stages through the CLI, each from the previous stage's best
checkpoint, run the 5-scale + flip ``coco-eval`` at low base capacities (so
that escalation fires), assert an AP floor and zero capacity truncation,
then run the AP ablation — the port's counterpart of
tools/synth_e2e_gate.sh.

The recipe, as the JAX gate runs it: dataset v2 (128 train and 16 val
images of 320x240, 30% crowds), ResNet-50 throughout; keypoint at 240 px,
batch 16, 30 epochs, 4 workers; detection at 320 px, batch 8, lr 1e-4, 16
epochs, from the keypoint stage's best; PRN at batch 8, lr 1e-3, 12
epochs, from the detection stage's best; ``coco-eval --max-peaks 8
--max-people 8``; floor 0.60; the ablation at ``--assert-tol 0.02``.
``--precision f32`` drops ``--bf16`` from the first two stages.

Each stage is a ``python -m multiposenet_tpu_torch.cli`` subprocess with
``--deterministic`` (deterministic cuDNN and cuBLAS; each batch's
augmentation from its own seed, so that a run's AP repeats) and
``--worker-processes`` (the recipe's 4 loader workers as processes), on
the GPU unless ``--device cpu``; its
output goes to ``<save-dir>/<stage>.log``.  A finished stage keeps only
its best checkpoint.  The eval runs alone, so that its wall time is its
own; the ablation's runs then go at once.  The first stage that fails
ends the gate with a non-zero exit.  The last line of standard output is
one JSON object: AP, AP50, AP75, AR, the wall seconds of each stage and of
the eval, the number of images re-dispatched at the escalated tier,
kernel K1's launches in the eval, the ops that had no deterministic
implementation, and the ablation's rows.

The dataset, the stages and the eval are one runner (``run_recipe``) over
a ``Recipe`` table, shared with the ResNet-101 recipe of
tools/train_synth_e2e.py.  A tree is made again unless its ``MARKER`` file
holds the generator flags of the recipe at hand, so one recipe never
trains on another's tree.

Usage:
  python -m multiposenet_tpu_torch.tools.synth_e2e_gate \\
      [--root DIR] [--save-dir DIR] [--floor 0.60] [--precision bf16|f32] \\
      [--no-ablation] [--only bf16,host_grouping] [--device cpu]
The size options (--n-train, --inp-size, --max-epoch, ...) shrink the
recipe for a quick run on the CPU; the gate's verdict is only meaningful
at the defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Tuple

from multiposenet_tpu_torch.tools import ap_ablation, check_ap_floor

# holds the generator flags that made the tree
MARKER = ".synth_tree"
ABLATION_TOL = 0.02     # |dAP| of a bounded ablation switch
EXP = {"keypoint": "kp", "detection": "det", "prn": "prn"}
BEST_RE = re.compile(r"ckpt_(\d+)_[-+.\deE]+\.best$")
NONDET_RE = re.compile(r"(\S+) does not have a deterministic implementation")
LAUNCH_RE = re.compile(r"coco-eval: (\d+) image\(s\) re-dispatched at the "
                       r"escalated peak tier; nms_suppress kernel launches (\d+)")


@dataclasses.dataclass(frozen=True)
class Recipe:
    """A staged recipe on the synthetic dataset: the tree it trains on (seed
    0), the backbone, each stage's CLI flags and the eval's."""
    name: str                  # prefix of its log lines and result files
    root: str
    save_dir: str
    n_train: int
    n_val: int
    width: int
    height: int
    crowd_frac: float
    backbone: str
    # (stage, CLI flags of the recipe, bf16 under --precision bf16)
    stages: Tuple[Tuple[str, dict, bool], ...]
    eval_flags: Tuple[str, ...] = ()


STAGES = (
    ("keypoint", {"--inp-size": 240, "--batch-size": 16, "--max-epoch": 30,
                  "--num-workers": 4}, True),
    ("detection", {"--inp-size": 320, "--batch-size": 8, "--lr": 1e-4,
                   "--max-epoch": 16, "--num-workers": 4}, True),
    ("prn", {"--batch-size": 8, "--lr": 1e-3, "--max-epoch": 12,
             "--num-workers": 4}, False),
)
GATE = Recipe("gate", "./extra/mpn_gate_coco", "./extra/mpn_gate_models",
              n_train=128, n_val=16, width=320, height=240, crowd_frac=0.3,
              backbone="resnet50", stages=STAGES,
              eval_flags=("--max-peaks", "8", "--max-people", "8"))


class GateError(RuntimeError):
    pass


def best_checkpoint(save_dir: str, exp: str) -> str:
    """The newest best copy (``ckpt_{epoch}_{val loss}.best``,
    engine/checkpoint.copy_best) of one stage: its val loss is the lowest."""
    d = os.path.join(save_dir, exp)
    best = [(int(m.group(1)), n) for n in os.listdir(d)
            if (m := BEST_RE.match(n))] if os.path.isdir(d) else []
    if not best:
        raise GateError(f"no best checkpoint under {d}")
    return os.path.join(d, max(best)[1])


def prune_stage(save_dir: str, exp: str, keep: str) -> None:
    """A finished stage's rolling checkpoints go (each 0.5-1 GB); its best
    copy, which the next stage starts from, stays."""
    d = os.path.join(save_dir, exp)
    for name in os.listdir(d):
        path = os.path.join(d, name)
        if name.startswith("ckpt_") and os.path.isdir(path) \
                and os.path.abspath(path) != os.path.abspath(keep):
            shutil.rmtree(path)


def run_stage(name: str, cmd, env, log_path: str, prefix: str = "gate") -> float:
    """Run one CLI subprocess, its output to ``log_path``; its wall s."""
    print(f"{prefix}: {name}: {' '.join(cmd[2:])}", flush=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        r = subprocess.run(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)
    wall = time.perf_counter() - t0
    if r.returncode:
        with open(log_path, errors="replace") as f:
            tail = f.readlines()[-30:]
        sys.stdout.write("".join(tail))
        raise GateError(f"{name} failed (rc {r.returncode}) after {wall:.1f} s; "
                        f"log {log_path}")
    print(f"{prefix}: {name} done in {wall:.1f} s", flush=True)
    return wall


def recipe_parser(recipe: Recipe) -> argparse.ArgumentParser:
    """The options every recipe takes, with ``recipe``'s defaults."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=recipe.root,
                    help="the synthetic COCO tree (made again unless its "
                         f"{MARKER} file names this recipe's generator flags)")
    ap.add_argument("--save-dir", default=recipe.save_dir)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backbone", default=recipe.backbone)
    # the recipe's sizes, to shrink it for a quick run
    ap.add_argument("--n-train", type=int, default=recipe.n_train)
    ap.add_argument("--n-val", type=int, default=recipe.n_val)
    ap.add_argument("--width", type=int, default=recipe.width)
    ap.add_argument("--height", type=int, default=recipe.height)
    ap.add_argument("--kp-inp-size", type=int, default=None)
    ap.add_argument("--det-inp-size", type=int, default=None)
    ap.add_argument("--eval-inp-size", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None,
                    help="every stage's batch")
    ap.add_argument("--max-epoch", type=int, default=None,
                    help="every stage's epochs")
    ap.add_argument("--num-workers", type=int, default=None)
    return ap


def parse_args(argv=None):
    ap = recipe_parser(GATE)
    ap.add_argument("--floor", type=float, default=0.60)
    ap.add_argument("--no-ablation", action="store_true",
                    help="skip the AP ablation (the JAX gate's ABLATIONS=0)")
    ap.add_argument("--only", default=None,
                    help="ablation switches to run (ap_ablation --only)")
    return ap.parse_args(argv)


def stage_flags(args, stage: str, base) -> list:
    flags = dict(base)
    over = {"--batch-size": args.batch_size, "--max-epoch": args.max_epoch,
            "--num-workers": args.num_workers,
            "--inp-size": {"keypoint": args.kp_inp_size,
                           "detection": args.det_inp_size}.get(stage)}
    for k, v in over.items():
        if v is not None and (k != "--inp-size" or k in flags):
            flags[k] = v
    return [str(x) for kv in flags.items() for x in kv]


def ensure_dataset(args, recipe: Recipe, env) -> float:
    """The recipe's tree under ``args.root``, made unless its marker names
    the same generator flags; the wall s it took (0 when reused).  Makes
    ``args.save_dir``, where the logs go."""
    os.makedirs(args.save_dir, exist_ok=True)
    flags = ["--seed", "0", "--n-train", str(args.n_train), "--n-val",
             str(args.n_val), "--width", str(args.width), "--height",
             str(args.height), "--crowd-frac", str(recipe.crowd_frac)]
    marker = os.path.join(args.root, MARKER)
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == " ".join(flags):
                return 0.0
        os.remove(marker)
    os.makedirs(args.root, exist_ok=True)
    cmd = [sys.executable, "-m",
           "multiposenet_tpu_torch.tools.make_synth_pose_dataset",
           "--root", args.root] + flags
    wall = run_stage("dataset", cmd, env,
                     os.path.join(args.save_dir, "dataset.log"), recipe.name)
    with open(marker, "w") as f:
        f.write(" ".join(flags))
    return wall


def run_recipe(args, recipe: Recipe) -> dict:
    """The tree, the three stages, each from the previous stage's best
    checkpoint, and the eval; raises ``GateError`` at the first failing
    step.  Returns the eval's AP, AP50, AP75, AR, the wall s of each step,
    the escalated images, K1's launches and the best checkpoint."""
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise GateError(f"no CUDA device: the {recipe.name} runs on the "
                            "GPU unless --device cpu is given")
    env = dict(os.environ)
    env["PYTHONUNBUFFERED"] = "1"
    if args.device == "cpu":
        env["MPN_PLATFORM"] = "cpu"
    wall = {"dataset": ensure_dataset(args, recipe, env)}

    cli = [sys.executable, "-m", "multiposenet_tpu_torch.cli"]
    common = ["--coco-root", args.root, "--backbone", args.backbone,
              "--save-dir", args.save_dir, "--deterministic",
              "--worker-processes"]
    init = None
    nondet = set()
    for stage, base, bf16 in recipe.stages:
        cmd = (cli + ["train", "--subnet", stage] + common
               + ["--exp-name", EXP[stage]] + stage_flags(args, stage, base)
               + (["--bf16"] if bf16 and args.precision == "bf16" else [])
               + (["--init-params", init] if init else []))
        log = os.path.join(args.save_dir, f"{stage}.log")
        wall[stage] = run_stage(stage, cmd, env, log, recipe.name)
        with open(log, errors="replace") as f:
            nondet |= set(NONDET_RE.findall(f.read()))
        init = best_checkpoint(args.save_dir, EXP[stage])
        prune_stage(args.save_dir, EXP[stage], init)
        print(f"{recipe.name}: {stage} best checkpoint {init}", flush=True)

    metrics_file = os.path.join(args.save_dir, f"{recipe.name}_metrics.json")
    eval_log = os.path.join(args.save_dir, "coco_eval.log")
    cmd = (cli + ["coco-eval", "--coco-root", args.root, "--backbone",
                  args.backbone, "--ckpt", init, "--deterministic",
                  *recipe.eval_flags,
                  "--result-file", os.path.join(args.save_dir,
                                                f"{recipe.name}_results.json"),
                  "--metrics-file", metrics_file]
           + (["--inp-size", str(args.eval_inp_size)] if args.eval_inp_size else []))
    wall["coco_eval"] = run_stage("coco-eval", cmd, env, eval_log, recipe.name)
    with open(eval_log, errors="replace") as f:
        text = f.read()
    found = LAUNCH_RE.findall(text)
    if not found:
        raise GateError(f"coco-eval logged no launch line; see {eval_log}")
    escalated, launches = (int(v) for v in found[-1])
    with open(metrics_file) as f:
        metrics = json.load(f)
    with open(os.path.join(args.root, "annotations",
                           "person_keypoints_val2017.json")) as f:
        eval_images = len(json.load(f)["images"])
    out = {k: metrics.get(k) for k in ("AP", "AP50", "AP75", "AR")}
    out.update(precision=args.precision, wall_s=wall,
               escalated_images=escalated,
               crowd_overflows=text.count("crowd overflow"),
               nms_suppress_launches=launches, eval_images=eval_images,
               nondeterministic_ops=sorted(nondet), best_checkpoint=init)
    return out


def run_gate(args) -> dict:
    out = run_recipe(args, GATE)
    metrics_file = os.path.join(args.save_dir, f"{GATE.name}_metrics.json")
    ap_ok = check_ap_floor.check(metrics_file, args.floor)
    trunc_ok = check_ap_floor.check_no_truncation(
        os.path.join(args.save_dir, "coco_eval.log"))
    out.update(floor=args.floor, ablation=None)
    if not (ap_ok and trunc_ok):
        out["passed"] = False
        return out

    if not args.no_ablation:
        t0 = time.perf_counter()
        abl_dir = os.path.join(args.save_dir, "ablation")
        init = out["best_checkpoint"]
        abl = ["--coco-root", args.root, "--ckpt", init, "--backbone",
               args.backbone, "--out-dir", abl_dir, "--assert-tol",
               str(ABLATION_TOL), "--device", args.device]
        if args.only:
            abl += ["--only", args.only]
        # every switch at once: the runs are independent processes
        abl += ["--jobs", str(len(args.only.split(",")) + 1 if args.only
                              else len(ap_ablation.TOGGLES))]
        if args.eval_inp_size:
            abl += ["--inp-size", str(args.eval_inp_size)]
        rc = ap_ablation.main(abl)
        out["wall_s"]["ablation"] = time.perf_counter() - t0
        with open(os.path.join(abl_dir, "ablation.json")) as f:
            out["ablation"] = {k: {s: v.get(s) for s in ("AP", "AP50")}
                               for k, v in json.load(f).items()}
        if rc:
            out["passed"] = False
            return out
    out["passed"] = True
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        out = run_gate(args)
    except GateError as e:
        print(f"gate: FAIL: {e}", flush=True)
        return 1
    print(json.dumps(out), flush=True)
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
