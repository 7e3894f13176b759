"""bf16 against float32 through the eval path, compared position by
position — the port's counterpart of tools/measure_bf16_drift.py.

    python -m multiposenet_tpu_torch.tools.measure_bf16_drift [--images 8]
        [--size 480] [--backbone resnet101] [--ckpt DIR]

The same weights run through the graph twice, with float32 and with
bfloat16 activations (``compute_dtype``), and each quantity the COCO eval
consumes is compared aligned (per heatmap cell, per peak, per anchor), so
that the numbers measure precision, not a cascade of flipped decisions:

  heatmaps : largest and rms difference, against the float32 range;
  peaks    : through the device peak finder at 192 slots per joint, the
             share of float32 peaks without an exact bf16 twin, and for
             the 5 strongest summits of each (image, joint) the share that
             moved and the largest shift of the nearest bf16 peak;
  scores   : per-anchor largest class probability, largest and rms drift;
  boxes    : per-anchor decoded and clipped corners, drift in pixels.

Without ``--ckpt`` (a port checkpoint, for example the synthetic gate's
trained model) the weights are drawn from seed 0, and the heatmap output
conv is rescaled so that the float32 heatmaps peak near 0.7: random
weights then give real peaks above ``thre1``.  The JAX tool can also take
its weights from a checkout of the reference's torch network
(measure_bf16_drift.py:36-71); that checkout is not part of this
repository, so that branch is left out.

K1 runs twice (the peak pipelines of the two arms).  The last line of
standard output is one JSON object; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Optional

import numpy as np
import torch

from multiposenet_tpu_torch.tools.benchlib import (device_name, load_model,
                                                   random_images, tool_device,
                                                   with_model)

PEAK_TARGET = 0.7
TOP_SUMMITS = 5


def nn_stats(v32, c32, v16, c16, top_n: Optional[int]):
    """The ``top_n`` strongest float32 peaks of each (image, joint) (slots
    are score-sorted; None: all) -> (count, share whose nearest bf16 peak
    is not at the same position, largest finite distance in pixels)."""
    nn, total = [], 0
    for b in range(v32.shape[0]):
        for j in range(v32.shape[1]):
            sel = np.where(v32[b, j])[0][:top_n]
            a = c32[b, j][sel]
            total += len(a)
            if len(a) == 0:
                continue
            c = c16[b, j][v16[b, j]]
            if len(c) == 0:
                nn.append(np.full(len(a), np.inf))
                continue
            nn.append(np.linalg.norm(a[:, None] - c[None, :], axis=-1).min(axis=1))
    nn = np.concatenate(nn) if nn else np.zeros(0)
    moved = float((nn > 0).mean()) if len(nn) else 0.0
    mx = float(nn[np.isfinite(nn)].max()) if np.isfinite(nn).any() else 0.0
    return total, moved, mx


def rescale_heatmap_head(model, cfg, imgs) -> float:
    """Scale the heatmap output conv so that the float32 heatmaps of the
    first image peak near PEAK_TARGET; returns the factor."""
    from multiposenet_tpu_torch.engine.inference import make_full_pipeline

    probe = make_full_pipeline(model, cfg, tuple(imgs.shape[1:3]),
                               device=imgs.device)
    heat, _, _ = probe.forward(imgs[:1])
    scale = PEAK_TARGET / max(float(heat.float().abs().max()), 1e-9)
    with torch.no_grad():
        model.convfin.weight.mul_(scale)
        model.convfin.bias.mul_(scale)
    return scale


def drift(model_a, cfg_a, model_b, cfg_b, imgs) -> Dict:
    """Arm A (float32) against arm B on ``imgs`` (uint8, on the device)."""
    from multiposenet_tpu_torch.engine.inference import make_full_pipeline
    from multiposenet_tpu_torch.ops.anchors import anchors_for_shape
    from multiposenet_tpu_torch.ops.boxes import clip_boxes, decode_boxes

    hw = tuple(imgs.shape[1:3])
    dev = imgs.device
    big = lambda c: dataclasses.replace(  # noqa: E731
        c, peaks=dataclasses.replace(c.peaks, max_peaks_per_joint=192))
    # random-weight heatmaps hold far more local maxima than a trained
    # model's: at 32 slots per joint the top-k saturates and ulp-level
    # jitter swaps which near-equal peaks are kept; 192 slots see them all
    run_a = make_full_pipeline(model_a, big(cfg_a), hw, device=dev)
    run_b = make_full_pipeline(model_b, big(cfg_b), hw, device=dev)
    ha, ca, ra = (t.float().cpu().numpy() for t in run_a.forward(imgs))
    hb, cb, rb = (t.float().cpu().numpy() for t in run_b.forward(imgs))
    pa, pb = run_a(imgs).peaks, run_b(imgs).peaks

    rng_dyn = float(ha.max() - ha.min())
    hm_max = float(np.abs(ha - hb).max())
    hm_rms = float(np.sqrt(np.mean((ha - hb) ** 2)))
    va, vb = pa.valid.cpu().numpy(), pb.valid.cpu().numpy()
    cpa = pa.coords.float().cpu().numpy()
    cpb = pb.coords.float().cpu().numpy()
    n_all, moved_all, _ = nn_stats(va, cpa, vb, cpb, None)
    n_top, moved_top, max_top = nn_stats(va, cpa, vb, cpb, TOP_SUMMITS)

    ds = np.abs(ca.max(axis=2) - cb.max(axis=2))
    anchors = torch.from_numpy(np.array(anchors_for_shape(hw, cfg_a.anchors)))[None]
    box = lambda r: clip_boxes(decode_boxes(anchors, torch.from_numpy(r)),  # noqa: E731
                               *hw).numpy()
    db = np.abs(box(ra) - box(rb))
    return {
        "heatmap_max_abs_diff": hm_max,
        "heatmap_dynamic_range": rng_dyn,
        "heatmap_max_share_of_range": hm_max / max(rng_dyn, 1e-9),
        "heatmap_rms_diff": hm_rms,
        "peaks_all": n_all, "peaks_all_without_twin": moved_all,
        "top5_peaks": n_top, "top5_moved": moved_top, "top5_max_px": max_top,
        "score_max_drift": float(ds.max()),
        "score_rms_drift": float(np.sqrt(np.mean(ds ** 2))),
        "box_max_drift_px": float(db.max()),
        "box_rms_drift_px": float(np.sqrt(np.mean(db ** 2))),
    }


def print_table(d: Dict) -> None:
    print("| quantity | f32 vs bf16 drift |")
    print("|---|---|")
    print(f"| heatmap max abs diff | {d['heatmap_max_abs_diff']:.2e} "
          f"({d['heatmap_max_share_of_range']:.2%} of dynamic range "
          f"{d['heatmap_dynamic_range']:.3f}) |")
    print(f"| heatmap rms diff | {d['heatmap_rms_diff']:.2e} |")
    print(f"| all {d['peaks_all']} f32 peaks (capacity-truncated sea of ~equal "
          f"maxima) | {d['peaks_all_without_twin']:.1%} lack an exact bf16 twin |")
    print(f"| top-{TOP_SUMMITS} summits per (image,joint) ({d['top5_peaks']} peaks) "
          f"| {d['top5_moved']:.1%} moved (max {d['top5_max_px']:.2f}px) |")
    print(f"| per-anchor score drift | max {d['score_max_drift']:.2e}, rms "
          f"{d['score_rms_drift']:.2e} |")
    print(f"| per-anchor decoded box drift | max {d['box_max_drift_px']:.3f}px, "
          f"rms {d['box_rms_drift_px']:.3f}px |")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="measure_bf16_drift")
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--size", type=int, default=480)
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--ckpt", default=None,
                    help="a port checkpoint (weights and BN statistics)")
    return ap.parse_args(argv)


def main(argv=None, device=None, state_dict=None) -> Dict:
    """Measure and print the table and JSON line.  ``state_dict`` (of the
    unfolded graph) replaces the checkpoint or seed-0 weights."""
    from multiposenet_tpu_torch.config import Config, ModelConfig
    from multiposenet_tpu_torch.models.posenet import build_posenet

    args = parse_args(argv)
    dev = tool_device(device)
    cfg32 = Config(model=ModelConfig(backbone=args.backbone))
    cfg16 = with_model(cfg32, compute_dtype=torch.bfloat16)
    model32 = (build_posenet(cfg32.model, dev, state_dict) if state_dict is not None
               else load_model(cfg32, dev, args.ckpt))
    imgs = random_images(args.images, args.size, dev)
    scale = None
    if args.ckpt is None:
        scale = rescale_heatmap_head(model32, cfg32, imgs)
        print(f"# convfin rescaled x{scale:.1f} so f32 heatmaps peak "
              f"~{PEAK_TARGET}")
    model16 = build_posenet(cfg16.model, dev, model32.state_dict())
    d = drift(model32, cfg32, model16, cfg16, imgs)
    print(f"backbone={args.backbone} size={args.size} images={args.images} "
          f"backend={dev.type}")
    print_table(d)
    out = {**d, "convfin_scale": scale, "images": args.images, "size": args.size,
           "backbone": args.backbone, "device": device_name(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
