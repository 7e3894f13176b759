"""Configuration of the port — the JAX package's dataclass tree
(multiposenet_tpu/config.py) cut to the fields this port reads, with
``compute_dtype`` as a torch dtype.

The port has one path where the JAX package has switches: the NMS
suppression always runs as the CUDA kernel on a GPU tensor (ops/cuda_nms.py),
and the evaluator always builds the image pyramid, resizes and folds the
heatmaps, finds peaks and groups people on the device, with detections from
the scale-1.0 forward only.  So there is no ``use_pallas_nms``,
``device_resize``, ``device_peaks``, ``device_image_resize``, ``group_size``,
``detect_scale1_only`` or ``device_grouping`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (reference network/posenet.py:154-224)."""

    backbone: str = "resnet101"          # 'resnet50' | 'resnet101'
    num_joints: int = 18                 # internal joint count incl. synthesized neck
    num_interm_channels: int = 19        # convfin_k* emit 19 channels
    fpn_channels: int = 256
    keypoint_mid_channels: int = 128     # convt*/convs* width
    num_classes: int = 1                 # person only
    num_anchors: int = 9                 # 3 ratios x 3 scales
    prior: float = 0.01                  # classifier bias init
    prn_node_count: int = 1024           # PRN hidden width
    prn_coeff: int = 2                   # PRN grid = (28*coeff, 18*coeff)
    # activation dtype of convs and matmuls; parameters stay float32
    compute_dtype: torch.dtype = torch.float32

    @property
    def prn_height(self) -> int:
        return 28 * self.prn_coeff

    @property
    def prn_width(self) -> int:
        return 18 * self.prn_coeff


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """RetinaNet anchor layout (reference network/anchors.py:10-19)."""

    pyramid_levels: Tuple[int, ...] = (3, 4, 5, 6, 7)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    scales: Tuple[float, ...] = (1.0, 2.0 ** (1.0 / 3.0), 2.0 ** (2.0 / 3.0))

    @property
    def strides(self) -> Tuple[int, ...]:
        return tuple(2 ** l for l in self.pyramid_levels)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(2 ** (l + 2) for l in self.pyramid_levels)


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    """Detection thresholds (reference posenet.py:271,281; tester.py:236)."""

    score_thresh: float = 0.05      # in-graph candidate filter
    nms_thresh: float = 0.5         # IoU threshold, +1px convention
    test_score_thresh: float = 0.5  # post-NMS threshold at test time
    max_detections: int = 100       # fixed-K NMS capacity


@dataclasses.dataclass(frozen=True)
class PeakConfig:
    """Heatmap peak extraction (reference tester.py:157-158)."""

    thre1: float = 0.1              # peak score threshold
    max_peaks_per_joint: int = 32   # fixed capacity
    # crowd escalation: when a joint type fills every peak slot of an image
    # (the top-k may have truncated), the evaluator re-dispatches the image
    # at this capacity (reference tester.py:338-350 keeps unbounded peak
    # lists).  0 disables it
    escalate_max_peaks: int = 128
    win_size: int = 2               # 5x5 refinement patch
    refine: bool = True


@dataclasses.dataclass(frozen=True)
class PRNConfig:
    """PRN grouping (reference tester.py:333-513)."""

    in_thres: float = 0.21          # bbox expansion for the peak-inside test
    max_people: int = 64            # fixed PRN batch capacity per image
    # crowd escalation: an image with more boxes than max_people (or more
    # peaks of one joint type than max_peaks_per_joint) is grouped at the
    # escalated (peaks, people) tier instead of truncated (reference
    # tester.py:400-406 runs the PRN per person, unbounded).  0 disables it
    escalate_max_people: int = 256
    score_window: int = 15          # NxN window around a peak for PRN scoring


@dataclasses.dataclass(frozen=True)
class DataConfig:
    coco_root: str = "/data/COCO/"
    feat_stride: int = 4            # heatmap stride: peaks scale by it


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Tester parameters (reference tester.py:84-104)."""

    inp_size: int = 480             # model input: square (serving) or scale-1.0 height
    scale_search: Tuple[float, ...] = (0.5, 1.0, 1.5, 2.0, 2.5)
    flip: bool = True               # the mirrored image rides in each scale's batch
    testdata_dir: str = "./demo/test_images/"
    testresult_dir: str = "./demo/output/"
    write_json: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    detection: DetectionConfig = dataclasses.field(default_factory=DetectionConfig)
    peaks: PeakConfig = dataclasses.field(default_factory=PeakConfig)
    prn: PRNConfig = dataclasses.field(default_factory=PRNConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    no GPU is present — the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "multiposenet_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
