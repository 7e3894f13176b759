"""End-to-end pose benchmark of the port — the counterpart of the repo's
root ``bench.py`` for the JAX package, at its configuration.

    python -m multiposenet_tpu_torch.bench       # or: python -m multiposenet_tpu_torch.cli bench

Times the whole serving pipeline (uint8 images -> preprocess -> ResNet-101
FPN -> heatmaps + RetinaNet heads -> decode -> NMS kernel K1 -> peaks -> PRN
-> grouping -> host formatting) on one GPU at 480x480, batch 64, bf16
autocast, ``max_people`` 20, with random weights from seed 0 on
``RandomState(0)`` images.  ``MPN_BENCH_F32=1`` runs float32 instead;
``MPN_PLATFORM=cpu`` runs on the CPU (the plain twins; no device metrics).

Prints one JSON line with bench.py's keys:
- ``value``: images per second of the e2e pipeline, 20 batches enqueued and
  then drained through ``.cpu()`` and ``format_pose_batch`` inside the
  window, best of 3 runs (all in ``e2e_runs_s``);
- ``detect_peaks_ips``: images per second of ``make_full_pipeline`` alone
  (forward, NMS, peaks), best of 2 runs of 10 batches;
- ``gflops_per_image``: ``torch.utils.flop_counter.FlopCounterMode`` over
  one e2e batch (convolutions and matmuls; NMS counts 0);
- ``mfu``: the measured FLOP rate over the H100 SXM's dense peak for what
  the forward runs: 989.4 TFLOP/s in bf16 on the tensor cores, and 67
  TFLOP/s in float32, because the pipeline turns TF32 off around its
  forward (engine/inference.full_fp32_matmul), so float32 convolutions run
  outside the tensor cores; null on the CPU;
- ``device_busy_ms_per_exec``: kernel time per e2e batch under
  ``torch.profiler`` (5 batches); null on the CPU;
- ``vs_baseline``: null.  bench.py divides by 5.93 images/s, a TPU v5e
  figure, which is no baseline for this port.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

# NVIDIA H100 SXM dense peaks (data sheet) for the forward's compute dtype
PEAK_FLOPS = {"bfloat16": 989.4e12, "float32": 67e12}


def best_of(n_runs: int, run_once):
    times = [run_once() for _ in range(n_runs)]
    return min(times), times


def device_busy_ms(fn, n: int = 5) -> float:
    """Kernel ms per call of ``fn`` under torch.profiler over ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / n


def main(backbone: str = "resnet101", size: int = 480, batch: int = 64,
         iters: int = 20, device=None) -> dict:
    """Run the benchmark, print its JSON line and return it as a dict.
    ``device`` defaults to the CLI's choice (``cuda`` unless
    ``MPN_PLATFORM=cpu``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from multiposenet_tpu_torch.cli import resolve_cli_device
    from multiposenet_tpu_torch.config import Config, EvalConfig, ModelConfig
    from multiposenet_tpu_torch.engine.inference import (
        format_pose_batch, make_e2e_pose_pipeline, make_full_pipeline)
    from multiposenet_tpu_torch.models.posenet import build_posenet

    dev = resolve_cli_device() if device is None else torch.device(device)
    use_f32 = os.environ.get("MPN_BENCH_F32") == "1"
    dtype_name = "float32" if use_f32 else "bfloat16"
    cfg = Config(model=ModelConfig(backbone=backbone,
                                   compute_dtype=getattr(torch, dtype_name)),
                 eval=EvalConfig(inp_size=size))
    # 20 people per image, the COCO keypoint protocol's own cap (bench.py)
    cfg = dataclasses.replace(cfg, prn=dataclasses.replace(cfg.prn, max_people=20))
    model = build_posenet(cfg.model, dev, seed=0)
    e2e = make_e2e_pose_pipeline(model, cfg, (size, size), device=dev)
    detect = make_full_pipeline(model, cfg, (size, size), device=dev)
    imgs = torch.from_numpy((np.random.RandomState(0).rand(
        batch, size, size, 3) * 255).astype(np.uint8)).to(dev)
    scales = torch.ones(batch, device=dev)
    on_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)

    # warm-up (cuDNN plans, the kernel build), then the FLOPs of one batch
    format_pose_batch(e2e(imgs, scales)[1].cpu())
    detect(imgs).detections.scores.cpu()
    with FlopCounterMode(display=False) as counter:
        e2e(imgs, scales)
    gflops_per_image = counter.get_total_flops() / batch / 1e9

    def e2e_once():
        sync()
        t0 = time.perf_counter()
        outs = [e2e(imgs, scales)[1] for _ in range(iters)]
        for a in outs:
            format_pose_batch(a.cpu())
        return time.perf_counter() - t0

    dt, e2e_runs = best_of(3, e2e_once)
    ips = batch * iters / dt

    iters2 = max(1, iters // 2)

    def detect_once():
        sync()
        t0 = time.perf_counter()
        outs = [detect(imgs) for _ in range(iters2)]
        fetched = [o.detections.scores.cpu() for o in outs]
        if len(fetched) != iters2 or fetched[0].shape[0] != batch:
            raise AssertionError("detect pipeline returned the wrong batch")
        return time.perf_counter() - t0

    dt2, _ = best_of(2, detect_once)

    mfu = busy = None
    if on_cuda:
        mfu = ips * gflops_per_image * 1e9 / PEAK_FLOPS[dtype_name]
        busy = device_busy_ms(lambda: e2e(imgs, scales)[1].chosen)
    out = {
        "metric": "images_per_sec_per_chip_e2e_pose",
        "value": ips,
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "detect_peaks_ips": batch * iters2 / dt2,
        "gflops_per_image": gflops_per_image,
        "mfu": mfu,
        "dtype": dtype_name,
        "e2e_runs_s": e2e_runs,
        "device_busy_ms_per_exec": busy,
        "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
