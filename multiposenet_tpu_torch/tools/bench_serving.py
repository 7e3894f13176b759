"""Serving latency: per-request wall latency through BatchPredictor — the
port's counterpart of tools/bench_serving.py.

    python -m multiposenet_tpu_torch.tools.bench_serving [--ckpt DIR] [--bf16]
        [--backbone resnet101] [--fold-bn] [--requests 30]
        [--batch-sizes 1,4,8,16] [--exported PROGRAM]

The throughput headline (``multiposenet_tpu_torch.bench``) measures a full
pipelined queue; a serving deployment cares about the other end: one
request arrives, how long until its person list is back on the host?
This drives ``engine/predictor.BatchPredictor.predict`` (host letterbox and
pack, pinned upload, the whole pose pipeline with NMS kernel K1, the fetch,
the host formatting) and reports, per request batch size, the wall latency
of one ``predict`` call from the request to the person lists on the host
(p50, p95; the host clock after a synchronise, so no earlier request's
work is in the window) and images per second.  Then a few more requests of
each size run under ``torch.profiler``: the device's idle share over their
wall window (1 - the union of its kernel intervals / the window).

Inputs are the JAX tool's: 64 ``RandomState(0)`` noise images of about
640x480 in three heights.  ``--ckpt`` takes a port checkpoint (its weights
and BN statistics), else the weights are drawn from seed 0 and the
detector keeps almost no boxes, so the PRN and grouping tail measures its
fixed cost only.  ``--exported`` serves a program of ``cli
export-program`` through ``BatchPredictor.from_exported`` at its own batch
size; the flags that shape the model are then ignored.

Each ``predict`` call below a batch's size runs one batch, so K1 launches
once per call: ``predict_calls`` in the result counts them.  The last line
of standard output is one JSON object; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from multiposenet_tpu_torch.tools.benchlib import (device_name, load_model,
                                                   pctl, synchronize,
                                                   tool_device, with_model)

PROFILED_REQUESTS = 4


def serving_images(n: int = 64) -> List[np.ndarray]:
    """The JAX tool's request images: COCO-like landscape noise whose
    heights vary a little, so that the host pack does real work."""
    rng = np.random.RandomState(0)
    return [(rng.rand(480 + 2 * (i % 3), 640, 3) * 255).astype(np.uint8)
            for i in range(n)]


def idle_share(pred, chunks: Sequence[Sequence[np.ndarray]],
               dev: torch.device) -> float:
    """The device's idle share over the wall window of ``chunks`` served
    one ``predict`` call each, under torch.profiler; None on the CPU
    (``idle_of_window``)."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    from multiposenet_tpu_torch.tools.profile_trace import device_events
    synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in chunks:
            pred.predict(c)
        synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return idle_of_window([(s, e) for _, s, e in device_events(prof, dev)],
                          wall_ms)


def idle_of_window(intervals: Sequence[Tuple[float, float]],
                   wall_ms: float) -> float:
    """1 - busy / ``wall_ms``, busy the union of the device ``intervals``
    (ms).  Raises ``profile_trace.ReconcileError`` when their span exceeds
    the wall window by more than ``profile_trace.WALL_TOL`` of it: the
    events and the window do not belong together."""
    from multiposenet_tpu_torch.tools.profile_trace import (check_in_window,
                                                            union_busy)
    busy, _, span = union_busy(intervals)
    check_in_window(span, wall_ms, "device span of the served requests")
    return 1.0 - busy / wall_ms


def bench_batch_sizes(make_pred: Callable[[int], object],
                      batch_sizes: Sequence[int], requests: int,
                      imgs: Sequence[np.ndarray], dev: torch.device) -> Dict:
    """Per batch size: two warm-up calls, then timed ``predict`` calls (at
    batch 1 ``requests`` of them, else ``max(4, requests // bs)``), then
    on the GPU PROFILED_REQUESTS under the profiler.  Returns the rows and the number
    of ``predict`` calls made."""
    rows, calls = [], 0
    for bs in batch_sizes:
        pred = make_pred(bs)
        pred.predict(imgs[:bs])
        pred.predict(imgs[bs:2 * bs])
        calls += 2
        n_req = requests if bs == 1 else max(4, requests // bs)
        lat = []
        for r in range(n_req):
            chunk = [imgs[(r * bs + j) % len(imgs)] for j in range(bs)]
            synchronize(dev)
            t0 = time.perf_counter()
            res = pred.predict(chunk)
            synchronize(dev)
            lat.append((time.perf_counter() - t0) * 1e3)
            if len(res) != bs:
                raise AssertionError(f"predict answered {len(res)} of {bs} images")
        calls += n_req
        prof_chunks = [[imgs[(r * bs + j) % len(imgs)] for j in range(bs)]
                       for r in range(PROFILED_REQUESTS)]
        idle = idle_share(pred, prof_chunks, dev)
        calls += PROFILED_REQUESTS if idle is not None else 0
        rows.append({"batch": bs, "p50_ms": pctl(lat, 50), "p95_ms": pctl(lat, 95),
                     "images_per_sec": bs * 1e3 / float(np.mean(lat)),
                     "requests": n_req, "idle_share": idle})
    return {"rows": rows, "predict_calls": calls}


def report(rows, label: str, size: int, dev: torch.device) -> Dict:
    print(f"# serving latency, {label}, ~640x480 inputs -> {size}x{size}")
    print("# batch  p50_ms  p95_ms  img/s  idle_share")
    for r in rows:
        idle = "-" if r["idle_share"] is None else f"{r['idle_share']:.3f}"
        print(f"  {r['batch']:5d}  {r['p50_ms']:6.1f}  {r['p95_ms']:6.1f}  "
              f"{r['images_per_sec']:6.1f}  {idle}")
    one = next((r for r in rows if r["batch"] == 1), rows[0])
    return {"metric": f"serving_p50_latency_batch{one['batch']}",
            "value": one["p50_ms"], "unit": "ms", "rows": rows,
            "device": device_name(dev)}


def serving_config(args):
    from multiposenet_tpu_torch.config import Config

    cfg = Config()
    if args.bf16:
        cfg = with_model(cfg, compute_dtype=torch.bfloat16)
    if args.backbone:
        cfg = with_model(cfg, backbone=args.backbone)
    return cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="bench_serving")
    ap.add_argument("--ckpt", default=None,
                    help="a port checkpoint directory for real weights")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--backbone", default=None,
                    choices=["resnet50", "resnet101"],
                    help="override cfg.model.backbone (match the ckpt)")
    ap.add_argument("--fold-bn", action="store_true",
                    help="fold the trunk BNs into the convs "
                         "(models/fold_bn.py) before serving")
    ap.add_argument("--requests", type=int, default=30,
                    help="timed single-image requests")
    ap.add_argument("--batch-sizes", default="1,4,8,16")
    ap.add_argument("--exported", default=None,
                    help="a program of cli export-program, served through "
                         "BatchPredictor.from_exported at its own batch size")
    return ap.parse_args(argv)


def main(argv=None, device=None, model=None, cfg=None) -> Dict:
    """Run the benchmark and print its table and JSON line.  ``model`` and
    ``cfg`` (built, on ``device``) replace the model the flags describe."""
    from multiposenet_tpu_torch.engine.predictor import BatchPredictor
    from multiposenet_tpu_torch.models.fold_bn import fold_bn_state_dict
    from multiposenet_tpu_torch.models.posenet import build_posenet

    args = parse_args(argv)
    dev = tool_device(device)
    imgs = serving_images()
    if args.exported:
        pred = BatchPredictor.from_exported(args.exported, device=dev)
        out = bench_batch_sizes(lambda bs: pred, [pred.batch_size],
                                args.requests, imgs, dev)
        result = report(out["rows"], f"exported program {args.exported}",
                        pred.inp, dev)
    else:
        if cfg is None:
            cfg = serving_config(args)
        if model is None:
            model = load_model(cfg, dev, args.ckpt)
        if args.fold_bn:
            cfg = with_model(cfg, fold_bn=True)
            model = build_posenet(cfg.model, dev,
                                  fold_bn_state_dict(model.state_dict()))
        label = (f"{'bf16' if cfg.model.compute_dtype == torch.bfloat16 else 'f32'}, "
                 f"{'trained' if args.ckpt else 'random'} weights")
        out = bench_batch_sizes(
            lambda bs: BatchPredictor(cfg, model=model, batch_size=bs, device=dev),
            [int(b) for b in args.batch_sizes.split(",")], args.requests, imgs, dev)
        result = report(out["rows"], label, cfg.eval.inp_size, dev)
    result["predict_calls"] = out["predict_calls"]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
