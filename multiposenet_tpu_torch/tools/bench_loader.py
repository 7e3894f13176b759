"""Input-pipeline throughput on the host — the port's counterpart of
tools/bench_loader.py.

    python -m multiposenet_tpu_torch.tools.bench_loader [--images 96]
        [--batch 16] [--epochs 3] [--workers 1,2,4,8,16]
        [--root DIR]

Writes a synthetic COCO-sized keypoint dataset (640x480 images, mask_miss
PNGs and the CMU-style index records that ``KeypointDataset`` reads) and
measures ``KeypointDataset`` -> ``Loader`` throughput (decode, augment,
targets, stacking) for each worker count, with the workers as threads and
as processes (``Loader(processes=True)``).  The rate is the consumer's:
samples per second over ``--epochs`` epochs, from the start of the first
to the last batch's arrival, the workers' start included (each worker
builds whole batches, so a count above the epoch's batches cannot show);
a process pool is shut down before the next count, so that one count's
processes do not slow the next.

The records are the JAX tool's ``make_synthetic_dataset``'s, drawn in its
order from ``RandomState(seed)``: the same image count, sizes and record
layout.  The JAX tool writes blurred noise as JPEG with cv2; here it is
written as PNG (``data/image_io.write_png``), blurred by a numpy
gaussian (5 taps, sigma 2), since the card's machine has no cv2.

The last line of standard output is one JSON object; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from multiposenet_tpu_torch.tools.benchlib import device_name, tool_device


def _blur(img: np.ndarray) -> np.ndarray:
    """A separable 5-tap gaussian (sigma 2) with reflected borders, so that
    the images compress like photos rather than noise."""
    x = np.arange(-2, 3, dtype=np.float64)
    k = np.exp(-x * x / 8.0)
    k /= k.sum()
    out = img.astype(np.float32)
    for axis in (0, 1):
        pad = [(0, 0)] * 3
        pad[axis] = (2, 2)
        p = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        out = sum(np.float32(w) * np.take(p, range(i, i + n), axis=axis)
                  for i, w in enumerate(k))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _write_pair(root: str, rel: str, mask_path: str, img: np.ndarray) -> None:
    from multiposenet_tpu_torch.data.image_io import write_png

    write_png(os.path.join(root, rel), _blur(img))
    write_png(mask_path, np.full(img.shape[:2], 255, np.uint8))


def make_synthetic_dataset(root: str, n_images: int, seed: int = 0) -> List[Dict]:
    """COCO-shaped keypoint records, images and mask_miss PNGs under
    ``root`` (the reference COCO.json 'root' entries,
    datasets/coco.py:17-36); the JAX tool's draws in its order.  The PNGs
    are blurred and compressed by a pool of threads (numpy and zlib release
    the interpreter lock)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    mask_dir = os.path.join(root, "mask2014")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    records, writes = [], []
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for i in range(n_images):
            h, w = 480, 640
            img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            stem = f"{i:012d}"
            rel = f"images/COCO_train2014_{stem}.png"
            writes.append(pool.submit(
                _write_pair, root, rel,
                os.path.join(mask_dir, f"train2014_mask_miss_{stem}.png"), img))

            def person(cx, cy):
                j = np.zeros((17, 3), np.float32)
                j[:, 0] = cx + rng.uniform(-60, 60, 17)
                j[:, 1] = cy + rng.uniform(-90, 90, 17)
                j[:, 2] = rng.choice([0.0, 1.0, 2.0], 17, p=[0.2, 0.5, 0.3])
                return j

            n_other = int(rng.randint(0, 4))
            others = [person(rng.uniform(100, w - 100), rng.uniform(100, h - 100))
                      for _ in range(n_other)]
            records.append({
                "dataset": "COCO",
                "isValidation": 0.0,
                "img_paths": rel,
                "img_width": w, "img_height": h,
                "objpos": [float(rng.uniform(150, w - 150)),
                           float(rng.uniform(150, h - 150))],
                "scale_provided": float(rng.uniform(0.6, 1.4)),
                "joint_self": person(w / 2, h / 2).tolist(),
                "joint_others": [o.tolist() for o in others],
                "numOtherPeople": n_other,
            })
        for fut in writes:
            fut.result()
    return records


def measure(loader, epochs: int) -> float:
    """Samples per second over ``epochs`` passes, from the start of the
    first pass to the last batch's arrival, every batch counted.  (The JAX
    tool starts the clock at the first batch's arrival; a pool builds a
    whole batch per worker, so with a few batches an epoch they all arrive
    together and nothing would be left to time.)"""
    n = 0
    t0 = time.perf_counter()
    for _ in range(epochs):
        for batch in loader:
            n += batch["image"].shape[0]
    if n == 0:
        raise ValueError("no batch to measure; increase --images (drop_last "
                         "trims partial batches)")
    return n / (time.perf_counter() - t0)


def bench_modes(ds, batch: int, epochs: int, workers, modes) -> Dict:
    """{mode: {workers: samples/s}} for every mode and worker count."""
    from multiposenet_tpu_torch.data.loader import Loader

    results: Dict[str, Dict[int, float]] = {}
    for mode in modes:
        for w in workers:
            loader = Loader(ds, batch, shuffle=True, num_workers=w, seed=0,
                            prefetch=4, processes=mode == "processes")
            try:
                sps = measure(loader, epochs)
            finally:
                loader.close()
            results.setdefault(mode, {})[w] = sps
            print(json.dumps({"workers": w, "mode": mode, "samples_per_sec": sps,
                              "batch": batch, "inp_size": ds.cfg.inp_size}),
                  flush=True)
    return results


def keypoint_dataset(root: str, records: List[Dict], inp_size: int = 480):
    from multiposenet_tpu_torch.config import DataConfig
    from multiposenet_tpu_torch.data.datasets import KeypointDataset

    return KeypointDataset(records, list(range(len(records))), root, root,
                           DataConfig(inp_size=inp_size), augment=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="bench_loader")
    ap.add_argument("--images", type=int, default=96)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--workers", default="1,2,4,8,16")
    ap.add_argument("--root", default=None,
                    help="reuse (or write) the synthetic dataset here")
    return ap.parse_args(argv)


def main(argv=None, device=None) -> Dict:
    args = parse_args(argv)
    dev = tool_device(device)     # the machine the rate is measured on
    root = args.root or tempfile.mkdtemp(prefix="mpn_loader_bench_")
    index = os.path.join(root, "index.json")
    if not os.path.exists(index):
        print(f"generating {args.images} synthetic images under {root} ...",
              file=sys.stderr)
        records = make_synthetic_dataset(root, args.images)
        with open(index, "w") as f:
            json.dump(records, f)
    with open(index) as f:
        records = json.load(f)
    ds = keypoint_dataset(root, records)
    results = bench_modes(ds, args.batch, args.epochs,
                          [int(w) for w in args.workers.split(",")],
                          ("threads", "processes"))
    best = max(v for r in results.values() for v in r.values())
    out = {"metric": "loader_samples_per_sec", "best": best,
           "by_workers": results, "device": device_name(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
