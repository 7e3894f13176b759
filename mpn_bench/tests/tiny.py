"""Tiny cells of the benchmark for the CPU tests: the configurations' own
files at 64 px with small batches and pools, run by ``run.run_cell`` on the
CPU (the plain twins of the port's kernels), with limits of their own.

    python -m mpn_bench.tests.tiny serve|train SEED [SECONDS] [TRACE]

prints the result line, as a run prints it, and exits non-zero when the
process loaded a module of JAX or of the JAX package."""

from __future__ import annotations

import copy
import json
import sys
import time

from mpn_bench import harness

# limits of the tiny cells (64 px, ResNet-50, the CPU), from their own
# readings over 4 seeds, the program's largest against the control's least:
# serving bf16 against fp8: heat 0.0047 / 0.041, cls 0.025 / 0.22, reg
# 0.012 / 0.12, prn 6.9e-5 / 4.7e-4; training float32 (no TF32 on the CPU)
# against bf16: loss 2.2e-7 / 2.3e-4, grad 1.1e-7 / 0.018, delta 7.2e-6 /
# 3.0e-3, grad_err 6.2e-7 / 0.042; the chain from frames to people 0 /
# 0.14 (2 control seeds), the step after the window 1.1e-7 / 2.1e-5
SERVE_LIMITS = {"pack_diff": 0, "heat_err": 0.014, "cls_err": 0.07, "reg_err": 0.04,
                "det_diff": 0, "peak_diff": 0, "prn_err": 1.8e-4, "cell_diff": 0,
                "person_diff": 0, "chain_miss": 0.07}
TINY_SCALES = {r"^convfin\.weight$": 0.03}
TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-5, "delta_gap": 1e-4, "grad_err": 1e-5,
                "window_nonfinite": 0, "late_loss_gap": 1e-5}


def bench() -> dict:
    return harness.load_bench(pending=True)


def cell(kind: str):
    b = bench()
    name = "r101-serve-b64" if kind == "serve" else "r50-train-det"
    c, cfg, spec = harness.cell_files(b, name)
    cfg, spec = copy.deepcopy(cfg), copy.deepcopy(spec)
    cfg["backbone"] = "resnet50"
    cfg["serve"]["inp_size"] = 64
    cfg["train_detection"]["inp_size"] = 64
    cfg["checks"] = {"serve": SERVE_LIMITS, "train_detection": TRAIN_LIMITS}
    # a ResNet-50 at 64 px has smaller activations: a larger heatmap conv
    # gives it peaks
    for rule in cfg["init"]:
        if rule["match"] in TINY_SCALES:
            rule["scale"] = TINY_SCALES[rule["match"]]
    cfg["serve"]["calibrate"]["frames"] = 4
    if kind == "serve":
        spec.update(batch=2, pool_frames=8, warmup_batches=1,
                    sizes_hw=[[48, 64], [64, 48], [64, 64], [36, 64]])
    else:
        spec.update(batch=2, pool_batches=4, side_min=24, side_max=60, pad_boxes=8, boxes_max=6,
                    log_every=2)
    return c, cfg, spec


def run(kind: str, seed: int, seconds: float = 0.5, trace: bool = False) -> dict:
    import torch

    from mpn_bench import run as run_mod

    return run_mod.run_cell(bench(), None, seed, seconds, trace,
                            torch.device("cpu"), time.time(), files=cell(kind))


if __name__ == "__main__":
    kind, seed = sys.argv[1], int(sys.argv[2])
    seconds = float(sys.argv[3]) if len(sys.argv) > 3 else 0.5
    trace = len(sys.argv) > 4 and sys.argv[4] == "1"
    result = run(kind, seed, seconds, trace)
    found = harness.forbidden_modules()
    print(json.dumps({"result": result, "forbidden": found}, default=str))
    sys.exit(1 if found else 0)
