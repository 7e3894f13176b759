"""Per-kernel profile of the benched inference graph, with accounting that
checks itself — the port's counterpart of tools/profile_xplane.py.

    python -m multiposenet_tpu_torch.tools.profile_trace [--f32] [--batch 64]
        [--iters 10] [--e2e | --train keypoint|detection|prn] [--size S]
        [--backbone resnet101] [--top 25] [--keep-trace DIR]

1. time N executions of the graph between CUDA events (the time per
   execution that the throughput numbers imply);
2. run N more under ``torch.profiler`` and take every device event
   (kernels, copies, memsets) with its start and end;
3. bucket them by name (convolution, GEMM, elementwise/reduction,
   copy/memcpy, NMS K1, other) and print per-kernel and per-bucket totals;
4. account for the device's time: busy is the union of the event
   intervals (overlapping kernels on several streams count once, which a
   sum of ``self_device_time_total`` does not), idle the gaps between
   them, the span from the first start to the last end (so busy + idle is
   the span by construction).  The accounting reconciles when the events'
   total is at least busy, the span fits in the host's wall window around
   the profiled executions (within 1%), and span / N agrees with the
   CUDA-event time per execution within 15% of it; when it does not, the
   tool says so and fails instead of reporting.

The JAX tool parses the XLA trace's protobuf by hand; PyTorch hands the
events over, so only the accounting is ported.  The graph is bench.py's
(ResNet-101, 480², batch 64, bf16 unless ``--f32``, ``max_people`` 20,
seed-0 weights, ``RandomState(0)`` images): detect + peaks, or with
``--e2e`` the whole pipeline to ``PoseAssignments``; with ``--train`` one
execution is one train step of that stage on one batch already on the
device (bench_train_mfu's batch and set-up).  On the CPU
(``MPN_PLATFORM=cpu``) the "device events" are the profiler's top-level
CPU ops, and the reference time is the host clock's.

The last line of standard output is one JSON object; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from multiposenet_tpu_torch.tools.benchlib import (bench_config, device_name,
                                                   random_images, synchronize,
                                                   tool_device)

# the largest share by which span / N may differ from the CUDA-event time
# per execution: the profiler's own host cost moves the span by a few
# percent on a device-bound graph
MAX_OFF = 0.15
# the share by which a device span may exceed the host's wall window around
# it: the two clocks' rates agree far closer; events from outside the window
# or a wrong time unit exceed it
WALL_TOL = 0.01
BUCKETS = ("convolution", "GEMM", "elementwise/reduction", "copy/memcpy",
           "NMS K1", "other")
_RULES = (
    ("NMS K1", re.compile(r"nms_suppress")),
    ("copy/memcpy", re.compile(r"memcpy|memset|copy", re.I)),
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|winograd|implicit_gemm"
                               r"|nchwtonhwc|nhwctonchw", re.I)),
    ("GEMM", re.compile(r"gemm|cublas|cutlass|matmul|\bmm\b|addmm|bmm", re.I)),
    ("elementwise/reduction", re.compile(
        r"elementwise|reduce|vectorized|unrolled|pointwise|norm|bn_|softmax|index"
        r"|scatter|gather|sort|cat|upsample|where|fill|arange|pool|radix"
        r"|scan|cumsum|topk|add|mul|sub|div|relu|sigmoid|exp|clamp", re.I)),
)


class ReconcileError(RuntimeError):
    """The trace's device time does not fit the host's wall window, or its
    span per execution disagrees with the CUDA-event time."""


def bucket(name: str) -> str:
    for b, rule in _RULES:
        if rule.search(name):
            return b
    return "other"


def union_busy(intervals: Sequence[Tuple[float, float]]
               ) -> Tuple[float, float, float]:
    """(busy, idle, span) of a set of [start, end) intervals: busy is the
    length of their union, idle the total of the gaps inside the span."""
    if not intervals:
        return 0.0, 0.0, 0.0
    iv = sorted(intervals)
    busy = idle = 0.0
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            idle += s - cur_e
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, idle, max(e for _, e in iv) - iv[0][0]


def check_in_window(span_ms: float, wall_ms: float, what: str,
                    tol: float = WALL_TOL) -> None:
    """Raises ReconcileError when device time ``span_ms`` exceeds the host's
    wall window ``wall_ms`` around it by more than ``tol`` of it."""
    if span_ms > wall_ms * (1.0 + tol):
        raise ReconcileError(f"{what} {span_ms:.6f} ms exceeds the host's wall "
                             f"window {wall_ms:.6f} ms by more than {tol:.0%}")


def account(events: Sequence[Tuple[str, float, float]], n_exec: int,
            ref_ms_per_exec: float, max_off: float = MAX_OFF,
            top: int = 25, wall_ms: float = None) -> Dict:
    """Accounting of device events ``(name, start_ms, end_ms)`` from
    ``n_exec`` executions against ``ref_ms_per_exec`` (CUDA events).
    Raises ReconcileError when the events' total is below their busy time,
    when their span exceeds ``wall_ms`` (the host's window around the
    profiled executions, when given; ``check_in_window``), or when
    span / n_exec differs from ``ref_ms_per_exec`` by more than
    ``max_off`` of it."""
    if not events:
        raise ReconcileError("the trace holds no device event")
    busy, idle, span = union_busy([(s, e) for _, s, e in events])
    total = sum(e - s for _, s, e in events)
    if total + 1e-9 < busy:
        raise ReconcileError(f"kernel total {total:.6f} ms < busy {busy:.6f} ms")
    if wall_ms is not None:
        check_in_window(span, wall_ms, "device span")
    span_per_exec = span / n_exec
    off = abs(span_per_exec - ref_ms_per_exec) / ref_ms_per_exec
    if off > max_off:
        raise ReconcileError(
            f"span per execution {span_per_exec:.4f} ms is {off:.1%} off the "
            f"CUDA-event time {ref_ms_per_exec:.4f} ms (limit {max_off:.0%})")
    by_bucket = {b: [0.0, 0] for b in BUCKETS}
    by_name: Dict[str, List] = collections.defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        b = by_bucket[bucket(name)]
        b[0] += e - s
        b[1] += 1
        k = by_name[name]
        k[0] += e - s
        k[1] += 1
    top_rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "busy_ms": busy, "idle_ms": idle, "span_ms": span,
        "kernel_total_ms": total,
        "device_busy_ms_per_exec": busy / n_exec,
        "idle_share": idle / span if span else 0.0,
        "span_ms_per_exec": span_per_exec,
        "reference_ms_per_exec": ref_ms_per_exec,
        "span_off_reference": off,
        "reconciled": True,
        "buckets": {b: {"ms": v[0], "share": v[0] / total if total else 0.0,
                        "n": v[1]} for b, v in by_bucket.items()},
        "top": [{"name": nm, "ms": v[0], "n": v[1]} for nm, v in top_rows],
    }


def device_events(prof, dev: torch.device) -> List[Tuple[str, float, float]]:
    """``(name, start_ms, end_ms)`` of every device event of a finished
    profile; on the CPU, of every top-level CPU op."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if dev.type == "cuda":
            if e.device_type != DeviceType.CUDA:
                continue
        elif e.device_type != DeviceType.CPU or e.cpu_parent is not None:
            continue
        out.append((e.name, e.time_range.start / 1e3, e.time_range.end / 1e3))
    return out


def reference_ms(run: Callable, n: int, dev: torch.device) -> float:
    """ms per call of ``run`` over ``n`` calls: CUDA events on the GPU, the
    host clock around a synchronise on the CPU."""
    synchronize(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            run()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    return (time.perf_counter() - t0) * 1e3 / n


def profile(run: Callable, n: int, dev: torch.device, max_off: float = MAX_OFF,
            top: int = 25, keep_trace: str = None) -> Dict:
    """Warm ``run``, time ``n`` calls, profile ``n`` more and account for
    them (``account``).  ``run`` enqueues one execution."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    run()
    synchronize(dev)
    ref = reference_ms(run, n, dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    synchronize(dev)
    t0 = time.perf_counter()
    with torch_profile(activities=acts) as prof:
        for _ in range(n):
            run()
        synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3
    if keep_trace:
        os.makedirs(keep_trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(keep_trace, "trace.json"))
    out = account(device_events(prof, dev), n, ref, max_off, top, wall_ms=wall)
    out["profiled_wall_ms"] = wall
    return out


def print_report(acc: Dict, n: int) -> None:
    print(f"busy {acc['busy_ms']:.3f} ms + idle {acc['idle_ms']:.3f} ms = span "
          f"{acc['span_ms']:.3f} ms over {n} execs; "
          f"{acc['device_busy_ms_per_exec']:.3f} ms busy per exec, idle share "
          f"{acc['idle_share']:.4f}; span per exec {acc['span_ms_per_exec']:.3f} "
          f"ms against {acc['reference_ms_per_exec']:.3f} ms of CUDA events")
    print("   per bucket:")
    for b, v in sorted(acc["buckets"].items(), key=lambda kv: -kv[1]["ms"]):
        print(f"     {b:<22} {v['ms']:9.3f} ms  ({100 * v['share']:5.1f}%)  "
              f"n={v['n']}")
    print(f"   top {len(acc['top'])} kernels:")
    for r in acc["top"]:
        print(f"     {r['ms']:9.3f} ms  n={r['n']:<6} {r['name'][:90]}")


def benched_graph(model, cfg, dev: torch.device, batch: int, e2e: bool
                  ) -> Callable:
    """One execution of bench.py's graph on its images: detect + peaks, or
    with ``e2e`` the whole pipeline."""
    from multiposenet_tpu_torch.engine.inference import (
        make_e2e_pose_pipeline, make_full_pipeline)

    size = cfg.eval.inp_size
    imgs = random_images(batch, size, dev)
    if e2e:
        pipe = make_e2e_pose_pipeline(model, cfg, (size, size), device=dev)
        scales = torch.ones(batch, device=dev)
        return lambda: pipe(imgs, scales)[1].chosen
    pipe = make_full_pipeline(model, cfg, (size, size), device=dev)
    return lambda: pipe(imgs).detections.scores


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="profile_trace")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--e2e", action="store_true",
                    help="profile the full e2e pose graph instead of "
                         "detect+peaks")
    ap.add_argument("--train", default=None,
                    choices=["keypoint", "detection", "prn"],
                    help="profile a train step instead of inference (the "
                         "chained protocol and set-up of bench_train_mfu)")
    ap.add_argument("--size", type=int, default=None,
                    help="input size (default 480; 608 for --train detection)")
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--keep-trace", default=None,
                    help="write the Chrome trace (trace.json) here")
    return ap.parse_args(argv)


def main(argv=None, device=None, model=None, cfg=None) -> Dict:
    """Profile the graph and print the report and its JSON line.  ``model``
    and ``cfg`` (built, on ``device``) replace the seed-0 model of
    bench.py's configuration."""
    from multiposenet_tpu_torch.models.posenet import build_posenet

    args = parse_args(argv)
    dev = tool_device(device)
    if args.train:
        from multiposenet_tpu_torch.tools import bench_train_mfu

        size = args.size or (608 if args.train == "detection" else 480)
        cfg = bench_train_mfu.mfu_config(args.train, size, args.backbone, args.f32)
        _, _, step = bench_train_mfu.train_step_runner(cfg, args.train,
                                                       args.batch, dev, model)
        run = lambda: step()["loss"]  # noqa: E731
        graph = f"train:{args.train}"
    else:
        if cfg is None:
            cfg = bench_config(args.f32, args.backbone, args.size or 480)
        if model is None:
            model = build_posenet(cfg.model, dev, seed=0)
        run = benched_graph(model, cfg, dev, args.batch, args.e2e)
        graph = "e2e" if args.e2e else "detect+peaks"
    acc = profile(run, args.iters, dev, MAX_OFF, args.top, args.keep_trace)
    dtype = "f32" if cfg.model.compute_dtype == torch.float32 else "bf16"
    print(f"graph={graph} batch={args.batch} iters={args.iters} dtype={dtype}")
    print_report(acc, args.iters)
    out = {"graph": graph, "batch": args.batch, "iters": args.iters,
           "dtype": dtype,
           "images_per_sec": args.batch / acc["reference_ms_per_exec"] * 1e3,
           **acc, "device": device_name(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    try:
        main()
    except ReconcileError as e:
        sys.exit(f"profile_trace: the trace does not reconcile: {e}")
