"""Split the e2e pose pipeline's throughput into its stages — the port's
counterpart of tools/bench_e2e_stages.py.

    python -m multiposenet_tpu_torch.tools.bench_e2e_stages [--f32]
        [--iters 20] [--batch 64] [--max-people 20]

The whole pipeline (images to grouped people) is slower than detect +
peaks alone by more than the PRN stage's FLOPs say.  Four stages, each
``--iters`` batches enqueued and then fetched, on the host clock:

  A. detect + peaks (``make_full_pipeline``), minimal fetch (the scores);
  B. the e2e pipeline, minimal fetch (``chosen`` only);
  C. the e2e pipeline, the whole ``PoseAssignments`` fetched;
  D. C + ``format_pose_batch`` (the bench's headline protocol).

B - A is the device's PRN and grouping; C - B the copy of
``PoseAssignments`` to the host (its bytes are printed); D - C the host's
dict building, which is also timed alone on the fetched batches.  The
configuration is bench.py's: ResNet-101, 480², batch 64, bf16 unless
``--f32``, ``max_people`` 20, seed-0 weights, ``RandomState(0)`` images.

K1 runs once per batch: 2 warm-up batches + 4 x ``--iters``.  The last
line of standard output is one JSON object; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from multiposenet_tpu_torch.tools.benchlib import (bench_config, device_name,
                                                   random_images, synchronize,
                                                   tool_device)


def measure_stages(detect, e2e, imgs, scales, iters: int,
                   dev: torch.device) -> Dict:
    """The four stages' images/s, the host formatting alone, the bytes of
    one fetched ``PoseAssignments``, and each stage's last outputs
    (``outputs``: A's scores, B's ``chosen``, C's ``PoseAssignments`` and
    D's person lists, all on the host)."""
    from multiposenet_tpu_torch.engine.inference import format_pose_batch

    batch = imgs.shape[0]
    detect(imgs).detections.scores.cpu()                     # warm-up
    format_pose_batch(e2e(imgs, scales)[1].cpu())

    def rate(t0):
        return batch * iters / (time.perf_counter() - t0)

    synchronize(dev)
    t0 = time.perf_counter()
    outs = [detect(imgs) for _ in range(iters)]
    a_out = [o.detections.scores.cpu() for o in outs]
    a = rate(t0)

    synchronize(dev)
    t0 = time.perf_counter()
    outs = [e2e(imgs, scales)[1] for _ in range(iters)]
    b_out = [o.chosen.cpu() for o in outs]
    b = rate(t0)

    synchronize(dev)
    t0 = time.perf_counter()
    outs = [e2e(imgs, scales)[1] for _ in range(iters)]
    fetched = [o.cpu() for o in outs]
    c = rate(t0)
    nbytes = sum(t.numel() * t.element_size() for t in fetched[0])

    synchronize(dev)
    t0 = time.perf_counter()
    outs = [e2e(imgs, scales)[1] for _ in range(iters)]
    d_out = [format_pose_batch(o.cpu()) for o in outs]
    d = rate(t0)

    t0 = time.perf_counter()
    for f in fetched:
        format_pose_batch(f)
    fmt_ms = (time.perf_counter() - t0) / iters * 1e3
    return {
        "A_images_per_sec": a, "B_images_per_sec": b,
        "C_images_per_sec": c, "D_images_per_sec": d,
        "prn_grouping_ms_per_batch": 1e3 * batch * (1 / b - 1 / a),
        "fetch_ms_per_batch": 1e3 * batch * (1 / c - 1 / b),
        "pose_assignments_bytes": nbytes,
        "format_ms_per_batch": fmt_ms,
        "outputs": {"A": a_out[-1], "B": b_out[-1], "C": fetched[-1],
                    "D": d_out[-1]},
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="bench_e2e_stages")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--max-people", type=int, default=20)
    ap.add_argument("--size", type=int, default=480)
    ap.add_argument("--backbone", default="resnet101")
    return ap.parse_args(argv)


def main(argv=None, device=None, model=None, cfg=None) -> Dict:
    """Measure the stages and print the split and its JSON line.  ``model``
    and ``cfg`` (built, on ``device``) replace the seed-0 model."""
    from multiposenet_tpu_torch.engine.inference import (
        make_e2e_pose_pipeline, make_full_pipeline)
    from multiposenet_tpu_torch.models.posenet import build_posenet

    args = parse_args(argv)
    dev = tool_device(device)
    if cfg is None:
        cfg = bench_config(args.f32, args.backbone, args.size, args.max_people)
    if model is None:
        model = build_posenet(cfg.model, dev, seed=0)
    size, batch, n = args.size, args.batch, args.iters
    e2e = make_e2e_pose_pipeline(model, cfg, (size, size), device=dev)
    detect = make_full_pipeline(model, cfg, (size, size), device=dev)
    imgs, scales = random_images(batch, size, dev), torch.ones(batch, device=dev)
    m = measure_stages(detect, e2e, imgs, scales, n, dev)
    dtype = "f32" if cfg.model.compute_dtype == torch.float32 else "bf16"
    print(f"batch={batch} iters={n} dtype={dtype} "
          f"max_people={cfg.prn.max_people}")
    print(f"A detect+peaks minimal fetch : {m['A_images_per_sec']:7.1f} img/s")
    print(f"B e2e         minimal fetch : {m['B_images_per_sec']:7.1f} img/s   "
          f"(device PRN+grouping cost: {m['prn_grouping_ms_per_batch']:+.1f} ms/batch)")
    print(f"C e2e         full fetch    : {m['C_images_per_sec']:7.1f} img/s   "
          f"(PoseAssignments D2H {m['pose_assignments_bytes'] / 1e6:.1f} MB/batch: "
          f"{m['fetch_ms_per_batch']:+.1f} ms/batch)")
    print(f"D e2e         fetch+format  : {m['D_images_per_sec']:7.1f} img/s   "
          f"(host format alone: {m['format_ms_per_batch']:.1f} ms/batch)")
    out = {k: v for k, v in m.items() if k != "outputs"}
    out.update(batch=batch, iters=n, dtype=dtype, max_people=cfg.prn.max_people,
               device=device_name(dev))
    print(json.dumps(out), flush=True)
    out["outputs"] = m["outputs"]
    return out


if __name__ == "__main__":
    main()
