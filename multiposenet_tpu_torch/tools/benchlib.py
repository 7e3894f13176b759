"""What the measurement tools share: the device they run on and its name,
a wait for it, bench.py's configuration and images, the seeded model, and
the percentile of the JAX tools.

Every tool runs on the GPU, and on the CPU only when the caller asks for it
(``MPN_PLATFORM=cpu``, as for the CLI, or ``device="cpu"`` from Python):
without a GPU and without that request it raises.  A number measured on
the CPU is reported under ``"device": "cpu"``, never under a card's name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def tool_device(device=None) -> torch.device:
    """``device`` when the caller names one, else the CLI's choice: CUDA
    unless ``MPN_PLATFORM=cpu``; raises without a GPU."""
    if device is not None:
        from multiposenet_tpu_torch.config import resolve_device
        return resolve_device(device)
    from multiposenet_tpu_torch.cli import resolve_cli_device
    return resolve_cli_device()


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pctl(xs, q) -> float:
    """The JAX tools' percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(xs), q))


def with_model(cfg, **changes):
    """``cfg`` with ``cfg.model`` fields replaced."""
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **changes))


def load_model(cfg, dev: torch.device, ckpt: Optional[str] = None):
    """The serving model of ``cfg.model`` on ``dev``: a port checkpoint's
    weights and BN statistics (engine/checkpoint.model_state_for), else the
    random init drawn from seed 0."""
    from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
    from multiposenet_tpu_torch.models.posenet import build_posenet

    state = ckpt_lib.model_state_for(ckpt, cfg.model) if ckpt else None
    return build_posenet(cfg.model, dev, state, seed=0)


def bench_config(f32: bool = False, backbone: str = "resnet101", size: int = 480,
                 max_people: int = 20):
    """bench.py's configuration: ResNet-101, 480², bf16 unless ``f32``,
    ``max_people`` 20 (the COCO keypoint protocol's cap)."""
    from multiposenet_tpu_torch.config import Config, EvalConfig, ModelConfig

    cfg = Config(model=ModelConfig(
        backbone=backbone, compute_dtype=torch.float32 if f32 else torch.bfloat16),
        eval=EvalConfig(inp_size=size))
    return dataclasses.replace(cfg, prn=dataclasses.replace(cfg.prn,
                                                            max_people=max_people))


def random_images(n: int, size: int, dev: torch.device) -> torch.Tensor:
    """bench.py's images: (n, size, size, 3) uint8 from ``RandomState(0)``."""
    return torch.from_numpy((np.random.RandomState(0).rand(
        n, size, size, 3) * 255).astype(np.uint8)).to(dev)
