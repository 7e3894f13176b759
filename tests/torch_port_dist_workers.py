"""Functions that tests/test_torch_port_distributed.py runs in each process
of a gloo process group on the CPU (``parallel.distributed.spawn_ranks``
starts the processes, which import this module by name)."""

import json
import os

import numpy as np
import torch

from multiposenet_tpu_torch.parallel import distributed as pdist


def topology():
    """The helpers' answers in this process; ``per_host_batch`` of a global
    batch of 7 must raise."""
    try:
        pdist.per_host_batch(7)
        remainder = None
    except ValueError as e:
        remainder = str(e)
    return {"count": pdist.process_count(), "index": pdist.process_index(),
            "primary": pdist.is_primary(), "device": str(pdist.process_device()),
            "per_host": pdist.per_host_batch(8), "remainder": remainder}


def gather():
    """Each process contributes a payload whose length depends on its rank,
    gathered twice: decoded everywhere, then on the primary only."""
    rank = pdist.process_index()
    obj = {"rank": rank, "rows": list(range(rank * 3 + 1)), "name": "é" * rank}
    return (pdist.gather_objects(obj),
            pdist.gather_objects(obj, decode=pdist.is_primary()))


def fail_then_wait():
    """Process 1 raises; process 0 waits for it in a collective."""
    if pdist.process_index() == 1:
        raise ValueError("process 1 fails")
    pdist.gather_objects("never answered")


def preprocess_f64(img: torch.Tensor) -> torch.Tensor:
    """The image normalisation in float64, which rounds alike in every
    program (XLA may contract the float32 one into an FMA, depending on the
    fusion)."""
    from multiposenet_tpu_torch.engine.inference import IMAGENET_MEAN, IMAGENET_STD

    mean = torch.from_numpy(IMAGENET_MEAN.astype(np.float64))
    std = torch.from_numpy(IMAGENET_STD.astype(np.float64))
    return (img.double() / 255.0 - mean) / std


def keypoint_step(sd_path: str, cfg, batch: dict, lr: float, out_path: str):
    """One float64 keypoint SGD step on this process's half of ``batch``
    (normalised in float64)
    from the state dict at ``sd_path``; process 0 saves the state dict after
    the step.  Returns the logs and the BatchNorm running statistics."""
    from multiposenet_tpu_torch.engine import train_steps as tts
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet

    tts.preprocess_on_device = preprocess_f64
    rank, n = pdist.process_index(), pdist.process_count()
    model = build_trainable_posenet(cfg.model, torch.device("cpu"),
                                    torch.load(sd_path)).double()
    state = tts.create_train_state(cfg, "keypoint", model=model)
    per = batch["image"].shape[0] // n
    local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
    train_step, _ = tts.make_keypoint_steps(cfg, device="cpu")
    _, logs = train_step(state, local, lr)
    sd = model.state_dict()
    if rank == 0:
        torch.save(sd, out_path)
    stats = torch.cat([t.flatten() for k, t in sd.items()
                       if k.endswith(("running_mean", "running_var"))])
    return {k: float(v) for k, v in logs.items()}, stats.numpy()


def coco_eval(cfg, stub, ann_file: str, img_dir: str, fail_after=None):
    """``coco_eval`` with the forward stubbed by ``stub`` and no explicit
    shard; with ``fail_after=(rank, k)`` that process's image reader raises
    on its k-th image.  Returns (metrics, result rows)."""
    from multiposenet_tpu_torch.engine.evaluator import Evaluator, read_image_bgr
    from multiposenet_tpu_torch.models.posenet import build_posenet

    torch.set_num_threads(2)
    model = build_posenet(cfg.model, torch.device("cpu"), seed=0)
    ev = Evaluator(cfg, model=model, device="cpu")
    ev.pipeline = stub.port_pipeline
    read = [0]

    def load_image(name):
        read[0] += 1
        if fail_after and fail_after == (pdist.process_index(), read[0]):
            raise OSError(f"injected read failure on {name}")
        return read_image_bgr(img_dir, name)

    result_file = os.path.join(img_dir, f"rows{pdist.process_index()}.json")
    metrics = ev.coco_eval(ann_file=ann_file, result_file=result_file,
                           load_image=load_image)
    if not os.path.exists(result_file):     # only the primary writes rows
        return metrics, None
    with open(result_file) as f:
        return metrics, json.load(f)
