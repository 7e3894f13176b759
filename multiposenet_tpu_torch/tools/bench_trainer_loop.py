"""ms per step through ``Trainer._train_one_epoch`` — the port's
counterpart of tools/bench_trainer_loop.py.

    python -m multiposenet_tpu_torch.tools.bench_trainer_loop [--steps 30]
        [--batch 16] [--size 480] [--backbone resnet101] [--f32]
        [--preput] [--chained] [--save-freq-step N] [--sync-save]

Drives the real epoch loop (``device_prefetch``, the buffered log
fetches, meters, ``print_freq`` logging, step checkpoints) of the keypoint
stage over in-memory batches (the JAX tool's ``make_batch``; no disk, so
that the loop's own cost shows: ``bench_loader`` measures the input
pipeline), after a warm-up epoch over the 4 distinct batches, and reports
ms per step on the host clock with the device synchronised at both ends.

- ``--chained`` also times the bare train step on one batch already on the
  device, ``--steps`` times in a row, in the same process: the loop's
  overhead is the difference.
- ``--save-freq-step N`` checkpoints every N global steps (the warm-up
  epoch's steps count) inside the timed epoch, through the Trainer's
  ``AsyncSaver``, or with ``--sync-save`` through a synchronous save (the
  save stall A/B).
- ``--preput`` puts the batches on the device before the timed epoch.

Checkpoints go to a temporary directory, removed at the end.  The peak device memory is printed.  The
last line of standard output is one JSON object; ``main`` returns it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from multiposenet_tpu_torch.tools.benchlib import (device_name, synchronize,
                                                   tool_device)


def make_batches(n: int, batch: int, size: int,
                 rng: np.random.RandomState) -> List[Dict[str, np.ndarray]]:
    """``n`` keypoint batches, each drawn as the JAX tool's ``make_batch``
    draws it (bench_trainer_loop.py:75-84): two people of 18 visible
    joints per image, two padded slots, a full mask."""
    out = []
    for _ in range(n):
        joints = np.full((batch, 4, 18, 3), 2.0, np.float32)
        for p in range(2):
            joints[:, p, :, 0] = rng.uniform(5, size - 5, (batch, 18))
            joints[:, p, :, 1] = rng.uniform(5, size - 5, (batch, 18))
            joints[:, p, :, 2] = 1.0
        out.append({"image": (rng.rand(batch, size, size, 3) * 255).astype(np.uint8),
                    "joints": joints,
                    "mask": np.ones((batch, size // 4, size // 4), np.float32)})
    return out


class SyncSaver:
    """The Trainer's saver with every save written before the step goes on
    (the stall an ``AsyncSaver`` takes off the loop)."""

    def save(self, save_dir, state, epoch, max_n_ckpts=0, step=None):
        from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib

        fut = concurrent.futures.Future()
        fut.set_result(ckpt_lib.save_checkpoint(save_dir, state, epoch,
                                                max_n_ckpts, step=step))
        return fut

    def wait(self):
        return None


class TimedSaver:
    """The Trainer's saver with each ``save`` call's time on the caller's
    thread recorded (``caller_ms``)."""

    def __init__(self, inner):
        self.inner = inner
        self.caller_ms: List[float] = []

    def save(self, *args, **kw):
        t0 = time.perf_counter()
        fut = self.inner.save(*args, **kw)
        self.caller_ms.append((time.perf_counter() - t0) * 1e3)
        return fut

    def __getattr__(self, name):
        return getattr(self.inner, name)


def loop_config(batch: int, size: int, backbone: str, f32: bool,
                save_dir: str, print_freq: int = 10,
                save_freq_step: int = 10 ** 9):
    from multiposenet_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                               TrainConfig)

    return Config(
        model=ModelConfig(backbone=backbone,
                          compute_dtype=torch.float32 if f32 else torch.bfloat16),
        data=DataConfig(inp_size=size),
        train=TrainConfig(batch_size=batch, max_epoch=1, print_freq=print_freq,
                          val_freq=0, val_nbatch_end_epoch=0,
                          save_freq_step=save_freq_step, save_dir=save_dir,
                          exp_name="bench_loop", re_init=True))


def time_loop(cfg, dev: torch.device, steps: int, preput: bool = False,
              chained: bool = False, sync_save: bool = False,
              model=None) -> Dict:
    """The warm-up epoch, the timed epoch of ``steps`` steps and, with
    ``chained``, the bare step; ``model`` (on ``dev``) replaces the seed-0
    model."""
    from multiposenet_tpu_torch.engine.trainer import Trainer

    batch, size = cfg.train.batch_size, cfg.data.inp_size
    batches = make_batches(4, batch, size, np.random.RandomState(0))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = Trainer(cfg, model=model, train_data=batches, device=dev)
    saver = TimedSaver(SyncSaver() if sync_save else t.saver)
    t.saver = saver
    synchronize(dev)
    t0 = time.perf_counter()
    t._train_one_epoch()                       # warm-up: cuDNN plans, caches
    synchronize(dev)
    warm = time.perf_counter() - t0

    epoch = [batches[i % len(batches)] for i in range(steps)]
    if preput:
        epoch = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
                 for b in epoch]
    t.train_data = epoch
    saver.caller_ms.clear()
    synchronize(dev)
    t0 = time.perf_counter()
    t._train_one_epoch()
    synchronize(dev)
    dt = time.perf_counter() - t0
    t.saver.wait()
    out = {"metric": "trainer_epoch_ms_per_step",
           "value": dt / steps * 1e3,
           "images_per_sec": batch / (dt / steps),
           "steps": steps, "batch": batch, "size": size,
           "backbone": cfg.model.backbone,
           "dtype": "f32" if cfg.model.compute_dtype == torch.float32 else "bf16",
           "preput": preput,
           "save_freq_step": (cfg.train.save_freq_step
                              if cfg.train.save_freq_step < 10 ** 9 else None),
           "sync_save": sync_save, "save_caller_ms": list(saver.caller_ms),
           "warmup_epoch_s": warm, "backend": dev.type}

    if chained:
        dev_batch = {k: torch.as_tensor(v).to(dev) for k, v in batches[0].items()}
        args = t._step_args(t.scheduler.lr)
        t.train_step(t.state, dev_batch, *args)            # warm
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            _, logs = t.train_step(t.state, dev_batch, *args)
        float(logs["loss"])
        synchronize(dev)
        chained_ms = (time.perf_counter() - t0) / steps * 1e3
        out["chained_ms_per_step"] = chained_ms
        out["engine_overhead_pct"] = (out["value"] / chained_ms - 1.0) * 100.0
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == "cuda" else None)
    out["global_steps"] = t.global_step
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="bench_trainer_loop")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=480)
    ap.add_argument("--backbone", default="resnet101")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--print-freq", type=int, default=10)
    ap.add_argument("--preput", action="store_true",
                    help="put every batch on the device before timing")
    ap.add_argument("--chained", action="store_true",
                    help="also time the bare train step in this process")
    ap.add_argument("--save-freq-step", type=int, default=10 ** 9,
                    help="checkpoint every N steps inside the timed epoch")
    ap.add_argument("--sync-save", action="store_true",
                    help="synchronous saves instead of the AsyncSaver")
    return ap.parse_args(argv)


def main(argv=None, device=None, model=None) -> Dict:
    args = parse_args(argv)
    dev = tool_device(device)
    save_dir = tempfile.mkdtemp(prefix="mpn_bench_loop_")
    try:
        cfg = loop_config(args.batch, args.size, args.backbone, args.f32,
                          save_dir, args.print_freq, args.save_freq_step)
        out = time_loop(cfg, dev, args.steps, args.preput, args.chained,
                        args.sync_save, model=model)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    out["device"] = device_name(dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
