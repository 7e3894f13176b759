"""The multi-process dry run — the port's counterpart of
``__graft_entry__.dryrun_multichip``: the data-parallel training and
inference surface driven once over n processes, and checked.

For each stage (keypoint, detection, PRN) one SGD step runs in n processes
joined in a process group (``parallel.distributed.spawn_ranks``), each on
its equal share of one global batch of ``b = 2n`` (two samples per process,
so that the local mean and the mean over processes are both non-trivial),
and one step runs in this process alone on the whole batch.  The two must
give the same loss and the same updated parameters within ``max(1e-5,
5e-6 * sqrt(n))``, the JAX dry run's bound: the group changes only the order
of float32 sums, while a wrong mean weighting or a dropped shard moves them
by 1e-2 or more.  SGD keeps the parameters linear in the averaged gradient
(Adam's first step is about lr * sign(g), which hides a gradient's size).
The keypoint stage's BatchNorm running statistics must be bit-equal in
every process.  Then one batch of ``b`` images runs through the
mesh-sharded e2e pipeline (forward -> NMS kernel K1 -> peaks -> PRN ->
grouping) over a mesh of n entries of the device, on the updated keypoint
model.

TF32 is off and cuDNN deterministic in every process of the run, so that
one GPU computes alike in each of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as tdist

from multiposenet_tpu_torch.config import Config, DataConfig, ModelConfig, resolve_device
from multiposenet_tpu_torch.parallel import distributed as pdist

STAGES = (("keypoint", 0), ("detection", 1), ("prn", 2))   # (stage, model seed)
DROPOUT_SEED = 3
LR = 1e-4


def dryrun_config(size: int) -> Config:
    """resnet50 at ``size`` px, SGD (the JAX dry run's configuration)."""
    cfg = Config(model=ModelConfig(backbone="resnet50"),
                 data=DataConfig(inp_size=size))
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              optimizer="sgd"))


def dryrun_batches(n: int, size: int, cfg: Config) -> Dict[str, Dict[str, np.ndarray]]:
    """The global batches of each stage (``b = 2n``) and the inference
    images, drawn from ``RandomState(0)`` in the JAX dry run's order."""
    rng = np.random.RandomState(0)
    b = 2 * n
    joints = np.full((b, 2, 18, 3), 2.0, np.float32)
    joints[:, 0, :, 0] = rng.uniform(5, size - 5, (b, 18))
    joints[:, 0, :, 1] = rng.uniform(5, size - 5, (b, 18))
    joints[:, 0, :, 2] = 1.0
    kp = {"image": (rng.rand(b, size, size, 3) * 255).astype(np.uint8),
          "joints": joints,
          "mask": np.ones((b, size // 4, size // 4), np.float32)}
    boxes = -np.ones((b, 4, 5), np.float32)
    boxes[:, 0] = [4.0, 6.0, 40.0, 50.0, 0.0]
    boxes[:, 1] = [30.0, 20.0, 60.0, 60.0, 0.0]
    det = {"image": (rng.rand(b, size, size, 3) * 255).astype(np.uint8),
           "boxes": boxes}
    gh, gw = cfg.model.prn_height, cfg.model.prn_width
    wm = np.zeros((b, gh, gw, 17), np.float32)
    lm = np.zeros((b, gh, gw, 17), np.float32)
    for i in range(b):
        for j in range(17):
            wm[i, rng.randint(gh), rng.randint(gw), j] = 1.0
            lm[i, rng.randint(gh), rng.randint(gw), j] = 1.0
    prn = {"weights_marks": wm, "label_marks": lm}
    images = (rng.rand(b, size, size, 3) * 255).astype(np.uint8)
    return {"keypoint": kp, "detection": det, "prn": prn,
            "inference": {"image": images}}


@contextlib.contextmanager
def exact_math():
    """TF32 off and deterministic cuDNN inside the block."""
    b = torch.backends
    prev = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
            b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = prev


def stage_step(cfg: Config, stage: str, seed: int, batch: Dict[str, np.ndarray],
               device: torch.device):
    """One train step of ``stage`` from the model drawn from ``seed``, on
    ``batch`` (this process's share).  Returns (loss, the trainable
    parameters after the step on the CPU, the model)."""
    from multiposenet_tpu_torch.engine.train_steps import (
        STEP_FACTORIES, create_train_state, is_trainable)
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet

    model = build_trainable_posenet(cfg.model, device, seed=seed)
    state = create_train_state(cfg, stage, model=model)
    train_step, _ = STEP_FACTORIES[stage](cfg, device=device)
    args = ((LR, torch.Generator(device).manual_seed(DROPOUT_SEED))
            if stage == "prn" else (LR,))
    _, logs = train_step(state, batch, *args)
    params = {k: p.detach().cpu() for k, p in model.named_parameters()
              if is_trainable(k, stage)}
    return float(logs["loss"]), params, model


def _bn_buffers(model) -> torch.Tensor:
    return torch.cat([t.detach().float().flatten()
                      for k, t in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))])


def _rank_steps(cfg: Config, batches, out_dir: str) -> Dict[str, float]:
    """Each stage's step in one process of the group, on its share of the
    global batch.  Process 0 saves the updated trainable parameters; every
    process returns its losses and how far its BatchNorm statistics are
    from process 0's."""
    rank, n = pdist.process_index(), pdist.process_count()
    device = pdist.process_device()
    out = {}
    with exact_math():
        for stage, seed in STAGES:
            g = batches[stage]
            per = next(iter(g.values())).shape[0] // n
            local = {k: v[rank * per:(rank + 1) * per] for k, v in g.items()}
            loss, params, model = stage_step(cfg, stage, seed, local, device)
            out[stage] = loss
            if rank == 0:
                torch.save(params, os.path.join(out_dir, f"{stage}.pt"))
            if stage == "keypoint":
                flat = _bn_buffers(model).to(pdist.collective_device())
                every = [torch.empty_like(flat) for _ in range(n)]
                tdist.all_gather(every, flat)
                out["bn_max_diff"] = max(float((e - every[0]).abs().max())
                                         for e in every)
            del model, params
    return out


def _max_diff(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    if a.keys() != b.keys():
        raise AssertionError("the processes trained other parameters")
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def dryrun_multichip(n: int, size: int = 64, device=None,
                     backend: Optional[str] = None, timeout: float = 900.0,
                     threads: Optional[int] = None) -> dict:
    """Run the dry run over ``n`` processes on ``device`` (``cuda`` unless
    the caller names another; every process of one machine takes GPU
    ``rank % device_count``) with ``backend`` (``parallel.distributed``'s
    default unless given: two processes on one GPU need ``gloo``).  Prints
    the JAX dry run's check lines; raises on a failed check or a failed
    process.  Returns the measured differences, the checks and the
    inference outputs' shapes."""
    from multiposenet_tpu_torch.engine.inference import make_sharded_e2e_pipeline
    from multiposenet_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    if size % 32:
        raise ValueError(f"size must be divisible by 32, got {size}")
    cfg = dryrun_config(size)
    batches = dryrun_batches(n, size, cfg)
    b = 2 * n
    tol = max(1e-5, 5e-6 * math.sqrt(n))
    checks, report = [], {"tol": tol}

    with exact_math():
        single = {}
        for stage, seed in STAGES:
            loss, params, model = stage_step(cfg, stage, seed, batches[stage], dev)
            single[stage] = (loss, params)
            if stage == "keypoint":
                kp_model = model
            else:
                del model

    with tempfile.TemporaryDirectory(prefix="mpn_dryrun_") as tmp:
        ranks = pdist.spawn_ranks(_rank_steps, n, args=(cfg, batches, tmp),
                                  device=dev.type, backend=backend,
                                  timeout=timeout, threads=threads)
        for stage, _ in STAGES:
            loss_n = float(np.mean([r[stage] for r in ranks]))
            if not np.isfinite(loss_n):
                raise AssertionError(f"non-finite {stage} loss {loss_n}")
            checks.append(f"{stage} DP step ok (loss={loss_n:.5f})")
            dl = abs(loss_n - single[stage][0])
            dp = _max_diff(torch.load(os.path.join(tmp, f"{stage}.pt")),
                           single[stage][1])
            if dl >= tol:
                raise AssertionError(f"{stage} {n}-process vs 1-process loss "
                                     f"differs by {dl:.2e}")
            if dp >= tol:
                raise AssertionError(f"{stage} {n}-process vs 1-process params "
                                     f"differ by {dp:.2e}")
            report[stage] = {"loss": loss_n, "dloss": dl, "dparams": dp}
            checks.append(f"{stage} {n}-process == 1-process on the same global "
                          f"batch (|dloss|={dl:.1e}, max|dparams|={dp:.1e}: "
                          "grad all-reduce correct)")
    bn = max(r["bn_max_diff"] for r in ranks)
    if bn != 0.0:
        raise AssertionError(f"BatchNorm running statistics differ between "
                             f"processes by {bn:.2e}")
    report["bn_max_diff"] = bn
    checks.append(f"keypoint BatchNorm running statistics equal in all {n} "
                  "processes (global-batch statistics)")

    # one batch through the mesh-sharded e2e pipeline, on the updated
    # keypoint model (JAX: the post-step keypoint state)
    cfg_inf = dataclasses.replace(cfg, prn=dataclasses.replace(cfg.prn,
                                                               max_people=8))
    mesh = make_mesh(devices=[dev] * n)
    with exact_math():
        infer = make_sharded_e2e_pipeline(kp_model, cfg_inf, (size, size), mesh)
        images = torch.from_numpy(batches["inference"]["image"])
        out, assigns = infer(images, torch.ones(b))
    if tuple(out.heatmaps.shape) != (b, size // 4, size // 4, 18):
        raise AssertionError(f"heatmaps {tuple(out.heatmaps.shape)}")
    if not bool(torch.isfinite(out.heatmaps).all()):
        raise AssertionError("non-finite heatmaps")
    if out.detections.boxes.shape[0] != b or out.peaks.scores.shape[0] != b:
        raise AssertionError("detections or peaks lost images")
    if tuple(assigns.chosen.shape) != (b, 8, 17):
        raise AssertionError(f"assignments {tuple(assigns.chosen.shape)}")
    if not bool(torch.isfinite(assigns.fallback_xy).all()):
        raise AssertionError("non-finite fallback keypoints")
    checks.append(f"sharded e2e inference ok (forward+NMS+peaks+PRN+grouping, "
                  f"batch {b} over {n} devices)")
    report["inference"] = {"heatmaps": tuple(out.heatmaps.shape),
                           "chosen": tuple(assigns.chosen.shape)}

    print(f"dryrun_multichip({n}):")
    for c in checks:
        print(f"  - {c}")
    report["checks"] = checks
    return report


def _main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser("python -m multiposenet_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, nargs="?", default=None,
                   help="processes (default: the GPU count)")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, help="nccl / gloo (default: "
                   "nccl on CUDA, gloo on the CPU)")
    a = p.parse_args(argv)
    n = a.n or torch.cuda.device_count()
    dryrun_multichip(n, a.size, device=a.device, backend=a.backend)


if __name__ == "__main__":
    _main()
