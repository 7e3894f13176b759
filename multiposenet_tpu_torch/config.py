"""Configuration of the port — the JAX package's dataclass tree
(multiposenet_tpu/config.py) cut to the fields this port reads, with
``compute_dtype`` as a torch dtype.

The NMS suppression always runs as the CUDA kernel on a GPU tensor
(ops/cuda_nms.py), so there is no ``use_pallas_nms``.  The evaluator's
switches are the JAX package's, with its defaults: by default it builds the
image pyramid, resizes and folds the heatmaps, finds peaks and groups
people on the device, with detections from the scale-1.0 forward only;
``device_resize``, ``device_peaks``, ``device_image_resize``,
``detect_scale1_only`` and ``PRNConfig.device_grouping`` turn each step
back to the reference's host chain, and ``group_size`` batches images.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
    prn_dropout: float = 0.5             # PRN dropout rate while training
    # activation dtype of convs and matmuls; parameters stay float32
    compute_dtype: torch.dtype = torch.float32
    # inference-only graph: the trunk BatchNorms folded into the convs
    # before them (models/fold_bn.fold_bn_state_dict makes its weights)
    fold_bn: bool = False

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
    # focal loss (reference losses.py:29-30, 65-77)
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    pos_iou: float = 0.5            # anchors at IoU >= pos_iou are positive
    neg_iou: float = 0.4            # ... below neg_iou negative; between, ignored
    smooth_l1_beta: float = 1.0 / 9.0


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
    min_num_keypoints: int = 3      # PRN training anns need more keypoints than this
    # the greedy mutual-best assignment on the device (ops/grouping.py);
    # False = the PRN stage alone on the device and the reference's
    # assignment on the host (eval/grouping.group_peaks)
    device_grouping: bool = True


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """COCO data pipeline (reference datasets/coco.py, coco_data/*)."""

    coco_root: str = "/data/COCO/"
    json_path: str = ""             # COCO.json keypoint index (CMU preprocessing)
    mask_dir: str = ""              # holds mask2014/{train,val}2014_mask_miss_*.png
    inp_size: int = 480             # training input: keypoint 480 / detection 608
    feat_stride: int = 4            # heatmap stride: peaks scale by it
    # augmentation (reference COCO_data_pipeline.py:25-40)
    scale_min: float = 0.8
    scale_max: float = 1.2
    scale_prob: float = 1.0
    target_dist: float = 0.6
    max_rotate_degree: float = 40.0
    center_perturb_max: float = 40.0
    flip_prob: float = 0.3
    sigma: float = 7.0              # heatmap target gaussian
    max_gt_boxes: int = 64          # padded GT box capacity (pad rows are -1)
    max_people: int = 32            # padded person capacity of the joint targets
    num_workers: int = 8            # data.loader.Loader worker threads


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Engine parameters (reference trainer.py:44-105 and the per-stage
    training scripts).  ``batch_size`` is the global batch: each of several
    processes takes its share (parallel/distributed.per_host_batch).  A
    torch step updates the state in place, so there is no
    ``donate_state``."""

    exp_name: str = "multipose101"
    subnet: str = "keypoint"        # 'keypoint' | 'detection' | 'prn'
    batch_size: int = 6
    max_epoch: int = 80
    init_lr: float = 1e-4
    weight_decay: float = 0.0
    optimizer: str = "adam"         # 'adam' | 'sgd'
    # grad clip by the INFINITY norm (reference trainer.py:255-256); None = off
    max_grad_norm: Optional[float] = None
    # ReduceLROnPlateau(factor=lr_decay, patience) on the val loss
    lr_decay: float = 0.1
    plateau_patience: int = 3
    save_dir: str = "./extra/models"
    ckpt: Optional[str] = None      # resume from; None = the newest in save_dir
    re_init: bool = False           # with ckpt None: start fresh, no auto-resume
    ignore_opt_state: bool = False  # resume the model only (partial restore)
    zero_epoch: bool = False        # resume the state but restart at epoch 0
    save_freq_epoch: int = 1
    save_freq_step: int = 10000
    save_nckpt_max: int = 8
    val_nbatch: int = 2
    val_freq: int = 2000
    val_nbatch_end_epoch: int = 200
    print_freq: int = 20
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Tester parameters (reference tester.py:84-104)."""

    inp_size: int = 480             # model input: square (serving) or scale-1.0 height
    scale_search: Tuple[float, ...] = (0.5, 1.0, 1.5, 2.0, 2.5)
    flip: bool = True               # the mirrored image rides in each scale's batch
    # resize and average the scales' heatmaps on the device (two matmuls
    # per scale); False = the reference's cv2 chain on the host
    # (eval/multiscale.resize_heatmap_to_original), every scale's
    # heatmaps fetched
    device_resize: bool = True
    # with device_resize, find peaks on the device after the fold; False =
    # fetch the folded (H, W, 18) map and find peaks on the host
    # (eval/multiscale.find_peaks_np, the reference's y-major order)
    device_peaks: bool = True
    # with device_resize, build the image pyramid on the device from one
    # upload (ops/pyramid.py); False = resize each scale on the host
    # (eval/multiscale.crop_with_factor) and upload it
    device_image_resize: bool = True
    # with the whole device path, dispatch up to this many images whose
    # bucketed scale shapes match together (engine/grouped_eval.py): one
    # pyramid, one forward per scale at batch group * 2, one fold + peaks
    group_size: int = 1
    # detections (and NMS) on the scale-1.0 forward only, the one scale
    # whose boxes the eval reads (reference tester.py:169); False = on
    # every scale
    detect_scale1_only: bool = True
    testdata_dir: str = "./demo/test_images/"
    testresult_dir: str = "./demo/output/"
    write_image: bool = False       # test(): <stem>_1heatmap.png, <stem>_2canvas.png
    write_json: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    detection: DetectionConfig = dataclasses.field(default_factory=DetectionConfig)
    peaks: PeakConfig = dataclasses.field(default_factory=PeakConfig)
    prn: PRNConfig = dataclasses.field(default_factory=PRNConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


def _stage_config(data: dict, **train) -> Config:
    c = Config()
    return dataclasses.replace(
        c, data=dataclasses.replace(c.data, **data),
        train=dataclasses.replace(c.train, **train))


def keypoint_train_config() -> Config:
    """Stage 1 (reference multipose_keypoint_train.py:16-113)."""
    return _stage_config(dict(inp_size=480), subnet="keypoint", batch_size=6,
                         max_epoch=80, init_lr=1e-4, plateau_patience=3)


def detection_train_config() -> Config:
    """Stage 2 (reference multipose_detection_train.py:19-53)."""
    return _stage_config(dict(inp_size=608), subnet="detection", batch_size=25,
                         max_epoch=50, init_lr=1e-5, plateau_patience=3)


def prn_train_config() -> Config:
    """Stage 3 (reference multipose_prn_train.py:22-85)."""
    return _stage_config({}, subnet="prn", batch_size=8, max_epoch=40,
                         init_lr=1e-3, plateau_patience=2)


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
