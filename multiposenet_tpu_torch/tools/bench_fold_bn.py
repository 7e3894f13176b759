"""A/B of the BN-folded inference graph — the port's counterpart of
tools/bench_fold_bn.py.

    python -m multiposenet_tpu_torch.tools.bench_fold_bn [--batch 64]
        [--iters 10] [--f32] [--e2e]

The detect + peaks graph (or with ``--e2e`` the whole pipeline) with and
without ``ModelConfig.fold_bn``, on the same weights: the folded arm's are
``models/fold_bn.fold_bn_state_dict`` of the unfolded arm's.  Each arm runs
once (the outputs compared), then ``--iters`` times enqueued back to back
and synchronised, on the host clock; it prints ms per execution, images
per second, the speed-up and the largest absolute difference between the
two arms over every output tensor of that first run.  The configuration is
bench.py's (ResNet-101, 480², batch 64, bf16 unless ``--f32``,
``max_people`` 20, seed-0 weights, ``RandomState(0)`` images).

K1 runs once per execution of either arm: 2 x (1 + ``--iters``).  The last
line of standard output is one JSON object; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import torch

from multiposenet_tpu_torch.tools.benchlib import (bench_config, device_name,
                                                   random_images, synchronize,
                                                   tool_device, with_model)


def leaves(out) -> List[torch.Tensor]:
    """The tensors of a pipeline output (NamedTuples, tuples, None)."""
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for x in out for t in leaves(x)]


def max_abs_diff(a, b) -> float:
    return max((float((x.float() - y.float()).abs().max()) if x.numel() else 0.0)
               for x, y in zip(leaves(a), leaves(b)))


def build_arm(model, cfg, imgs, scales, e2e: bool, dev: torch.device):
    from multiposenet_tpu_torch.engine.inference import (
        make_e2e_pose_pipeline, make_full_pipeline)

    hw = tuple(imgs.shape[1:3])
    if e2e:
        pipe = make_e2e_pose_pipeline(model, cfg, hw, device=dev)
        return lambda: pipe(imgs, scales)
    pipe = make_full_pipeline(model, cfg, hw, device=dev)
    return lambda: pipe(imgs)


def bench(run, iters: int, dev: torch.device):
    """(first output, ms per execution) of ``run``."""
    out = run()
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    synchronize(dev)
    return out, (time.perf_counter() - t0) / iters * 1e3


def ab(model, cfg, imgs, scales, iters: int, e2e: bool,
       dev: torch.device) -> Dict:
    """Both arms on the same weights: times, speed-up, largest output
    difference, and the two arms' first outputs (``outputs``)."""
    from multiposenet_tpu_torch.models.fold_bn import fold_bn_state_dict
    from multiposenet_tpu_torch.models.posenet import build_posenet

    folded_cfg = with_model(cfg, fold_bn=True)
    folded = build_posenet(folded_cfg.model, dev,
                           fold_bn_state_dict(model.state_dict()))
    out_a, ms_a = bench(build_arm(model, cfg, imgs, scales, e2e, dev), iters, dev)
    out_b, ms_b = bench(build_arm(folded, folded_cfg, imgs, scales, e2e, dev),
                        iters, dev)
    batch = imgs.shape[0]
    return {"unfolded_ms": ms_a, "fold_bn_ms": ms_b,
            "unfolded_images_per_sec": batch / ms_a * 1e3,
            "fold_bn_images_per_sec": batch / ms_b * 1e3,
            "speedup": ms_a / ms_b, "max_abs_diff": max_abs_diff(out_a, out_b),
            "outputs": (out_a, out_b)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="bench_fold_bn")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--size", type=int, default=480)
    ap.add_argument("--backbone", default="resnet101")
    return ap.parse_args(argv)


def main(argv=None, device=None, model=None, cfg=None) -> Dict:
    """Run the A/B and print its lines and JSON line.  ``model`` and
    ``cfg`` (built, unfolded, on ``device``) replace the seed-0 model."""
    from multiposenet_tpu_torch.models.posenet import build_posenet

    args = parse_args(argv)
    dev = tool_device(device)
    if cfg is None:
        cfg = bench_config(args.f32, args.backbone, args.size)
    if model is None:
        model = build_posenet(cfg.model, dev, seed=0)
    imgs = random_images(args.batch, args.size, dev)
    scales = torch.ones(args.batch, device=dev)
    r = ab(model, cfg, imgs, scales, args.iters, args.e2e, dev)
    print(f"{'unfolded':12s} {r['unfolded_ms']:8.2f} ms/exec "
          f"{r['unfolded_images_per_sec']:7.1f} img/s")
    print(f"{'fold_bn':12s} {r['fold_bn_ms']:8.2f} ms/exec "
          f"{r['fold_bn_images_per_sec']:7.1f} img/s")
    print(f"speedup {r['speedup']:.3f}x   max |A-B| over all outputs: "
          f"{r['max_abs_diff']:.3e}")
    out = {k: v for k, v in r.items() if k != "outputs"}
    out.update(graph="e2e" if args.e2e else "detect+peaks", batch=args.batch,
               iters=args.iters,
               dtype="f32" if cfg.model.compute_dtype == torch.float32 else "bf16",
               device=device_name(dev))
    print(json.dumps(out), flush=True)
    out["outputs"] = r["outputs"]
    return out


if __name__ == "__main__":
    main()
