"""FLOPs-grounded MFU of one training step — the port's counterpart of
tools/bench_train_mfu.py.

    python -m multiposenet_tpu_torch.tools.bench_train_mfu
        [--subnet keypoint|detection|prn] [--batch 16] [--size 480]
        [--backbone resnet101] [--f32] [--iters 20]

Counts the FLOPs of the stage's train step as it runs, forward and
backward (``torch.utils.flop_counter.FlopCounterMode`` around one step;
the optimizer's update counts 0), so the detection stage's frozen trunk,
which has no backward, is not counted 3 times.  The forward alone is
counted too.  Then times ``--iters`` steps in a row on one batch already on
the device between CUDA events, and prints GFLOPs per image, TFLOP/s and
MFU.  The peak is the NVIDIA H100 SXM's dense rate for what the step runs:
989.4 TFLOP/s in bf16; in float32 494.7 for TF32 on the tensor cores (the
convolutions when ``torch.backends.cudnn.allow_tf32`` is on, its default;
the PRN's matmuls when ``torch.backends.cuda.matmul.allow_tf32`` is on,
whose default is off), else 67 outside them.  The tool prints the flags it
found.  The detection stage runs at 608 px unless ``--size`` says
otherwise, the others at 480.

The batches are the JAX tool's ``make_batch``.  Its ``--prn-grids`` A/B
has no counterpart: the port's PRN step builds its grids one way.  On the CPU
(``MPN_PLATFORM=cpu``) the FLOPs and times are printed, the rate and MFU
are null.  The last line of standard output is one JSON object; ``main``
returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from multiposenet_tpu_torch.tools.benchlib import (device_name, synchronize,
                                                   tool_device)

BF16_PEAK = 989.4e12
TF32_PEAK = 494.7e12
F32_PEAK = 67e12


def make_batch(subnet: str, cfg, batch: int, size: int,
               rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """The JAX tool's batches, drawn in its order (bench_train_mfu.py:34-63)."""
    if subnet == "keypoint":
        joints = np.full((batch, 4, 18, 3), 2.0, np.float32)
        for p in range(2):
            joints[:, p, :, 0] = rng.uniform(5, size - 5, (batch, 18))
            joints[:, p, :, 1] = rng.uniform(5, size - 5, (batch, 18))
        joints[:, 2:, :, 2] = 0.0
        return {
            "image": (rng.rand(batch, size, size, 3) * 255).astype(np.uint8),
            "joints": joints,
            "mask": np.ones((batch, size // 4, size // 4), np.float32),
        }
    if subnet == "detection":
        boxes = np.full((batch, cfg.data.max_gt_boxes, 5), -1.0, np.float32)
        boxes[:, 0] = [40.0, 40.0, 200.0, 260.0, 0.0]
        boxes[:, 1] = [250.0, 100.0, 380.0, 300.0, 0.0]
        return {
            "image": (rng.rand(batch, size, size, 3) * 255).astype(np.uint8),
            "boxes": boxes,
        }
    gh, gw = cfg.model.prn_height, cfg.model.prn_width
    inp = np.zeros((batch, gh, gw, 17), np.float32)
    lab = np.zeros((batch, gh, gw, 17), np.float32)
    ys = rng.randint(2, gh - 2, (batch, 17))
    xs = rng.randint(2, gw - 2, (batch, 17))
    for b in range(batch):
        inp[b, ys[b], xs[b], np.arange(17)] = 1.0
        lab[b, ys[b], xs[b], np.arange(17)] = 1.0
    return {"weights_marks": inp, "label_marks": lab}


def peak_flops(dtype_name: str, subnet: str):
    """(peak FLOP/s, TF32 flags found) for what the step runs."""
    flags = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    if dtype_name == "bfloat16":
        return BF16_PEAK, flags
    tf32 = flags["matmul_allow_tf32" if subnet == "prn" else "cudnn_allow_tf32"]
    return (TF32_PEAK if tf32 else F32_PEAK), flags


def mfu_config(subnet: str, size: int, backbone: str, f32: bool):
    from multiposenet_tpu_torch.config import Config, DataConfig, ModelConfig

    return Config(model=ModelConfig(
        backbone=backbone, compute_dtype=torch.float32 if f32 else torch.bfloat16),
        data=DataConfig(inp_size=size))


def forward_flops(model, subnet: str, batch: Dict[str, torch.Tensor]) -> int:
    """FLOPs of the stage's forward alone on ``batch``."""
    from torch.utils.flop_counter import FlopCounterMode

    from multiposenet_tpu_torch.engine.inference import preprocess_on_device
    from multiposenet_tpu_torch.ops.gaussian import gaussian_blur

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        if subnet == "prn":
            grids = gaussian_blur(batch["weights_marks"], sigma=1.0, mode="nearest")
            model.prn_forward(grids)
        else:
            imgs = preprocess_on_device(batch["image"])
            if subnet == "keypoint":
                model.keypoint_forward(imgs, train=True)
            else:
                model.detection_forward(imgs)
    return counter.get_total_flops()


def train_step_runner(cfg, subnet: str, batch: int, dev: torch.device,
                      model=None):
    """The stage's train state and its batch on the device, and a function
    that takes one train step on that batch and returns its logs (the
    chained protocol).  ``model`` (on ``dev``) replaces the seed-0 model."""
    from multiposenet_tpu_torch.engine import train_steps as ts
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet

    if model is None:
        model = build_trainable_posenet(cfg.model, dev, seed=0)
    state = ts.create_train_state(cfg, subnet, model=model)
    train_step, _ = ts.STEP_FACTORIES[subnet](cfg, device=dev)
    host = make_batch(subnet, cfg, batch, cfg.data.inp_size,
                      np.random.RandomState(0))
    dev_batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    extra = (torch.Generator(dev).manual_seed(1),) if subnet == "prn" else ()
    return state, dev_batch, lambda: train_step(state, dev_batch, 1e-4, *extra)[1]


def measure_step(cfg, subnet: str, batch: int, iters: int, dev: torch.device,
                 model=None) -> Dict:
    """FLOPs of one train step and of its forward, and ms per step over
    ``iters`` steps on one batch on the device.  ``model`` (on ``dev``)
    replaces the seed-0 model."""
    from torch.utils.flop_counter import FlopCounterMode

    state, dev_batch, step = train_step_runner(cfg, subnet, batch, dev, model)
    step()                                                      # warm-up
    with FlopCounterMode(display=False) as counter:
        step()
    step_flops = counter.get_total_flops()
    fwd_flops = forward_flops(state.model, subnet, dev_batch)

    synchronize(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            logs = step()
        end.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            logs = step()
        ms = (time.perf_counter() - t0) / iters * 1e3
    if not torch.isfinite(logs["loss"]):
        raise FloatingPointError(f"{subnet} step loss {float(logs['loss'])}")
    return {"step_flops": step_flops, "forward_flops": fwd_flops,
            "ms_per_step": ms, "loss": float(logs["loss"])}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="bench_train_mfu")
    ap.add_argument("--subnet", default="keypoint",
                    choices=["keypoint", "detection", "prn"])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=None,
                    help="input size (default 608 for detection, else 480)")
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    return ap.parse_args(argv)


def main(argv=None, device=None, model=None) -> Dict:
    args = parse_args(argv)
    dev = tool_device(device)
    size = args.size or (608 if args.subnet == "detection" else 480)
    cfg = mfu_config(args.subnet, size, args.backbone, args.f32)
    dtype_name = "float32" if args.f32 else "bfloat16"
    m = measure_step(cfg, args.subnet, args.batch, args.iters, dev, model=model)
    peak, flags = peak_flops(dtype_name, args.subnet)
    print(f"# TF32 flags: {flags}; peak {peak / 1e12:.1f} TFLOP/s")
    gflops = m["step_flops"] / args.batch / 1e9
    ips = args.batch / m["ms_per_step"] * 1e3
    out = {"subnet": args.subnet, "dtype": dtype_name, "batch": args.batch,
           "size": size, "ms_per_step": m["ms_per_step"],
           "images_per_sec": ips, "gflops_per_image": gflops,
           "forward_gflops_per_image": m["forward_flops"] / args.batch / 1e9,
           "step_over_forward": m["step_flops"] / m["forward_flops"],
           "tflops_per_sec": None, "mfu": None, "peak_tflops": peak / 1e12,
           **flags, "device": device_name(dev)}
    if dev.type == "cuda":
        out["tflops_per_sec"] = ips * gflops / 1e3
        out["mfu"] = out["tflops_per_sec"] * 1e12 / peak
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
