"""MultiPoseNet in plain PyTorch float32: the benchmark's frozen reference.

The architecture of the published model (LiMeng95/MultiPoseNet.pytorch,
network/posenet.py and network/fpn.py; Kocabas et al., ECCV 2018): a trunk
to four feature maps c2-c5 at strides 4-32, two FPN top-downs (RetinaNet
P3-P7 and keypoint P2-P5) whose input widths are the trunk's, the keypoint
subnet, the RetinaNet regression and classification heads and the PRN.
The trunk is the one that ``trunks/<family>.py`` builds for the
configuration's ``backbone`` name (``trunks/__init__.py``).  Parameter
names are the published ``state_dict`` keys, so one seeded state dict
loads into this module and into the program.

It imports nothing of the program.  Every layer is a plain ``torch``
operation; BatchNorm always normalises with its running statistics (the
frozen trunk of inference and of the detection stage).  ``quant`` rounds
the inputs and weights of every convolution and linear layer (the control:
the reference in a lower precision than the configuration states).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
TRUNKS_DIR = Path(__file__).resolve().parent / "trunks"

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


class Trunk(NamedTuple):
    """What a trunk file's ``build(name)`` returns: ``modules``, registered
    in this order on the FPN ahead of its pyramids (their ``state_dict``
    keys read ``fpn.<name>...``); ``run(fpn, x, q) -> [c2, c3, c4, c5]``,
    the forward over those modules of NCHW images; ``widths``, the channels
    of c2-c5."""
    modules: Dict[str, nn.Module]
    run: Callable[[nn.Module, torch.Tensor, Quant], List[torch.Tensor]]
    widths: Tuple[int, int, int, int]


def families(directory: Path) -> Dict[str, object]:
    """Backbone name -> the trunk file (module) of ``directory`` that
    builds it, from every ``*.py`` there not named ``_*``."""
    found: Dict[str, object] = {}
    for path in sorted(directory.glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"mpn_bench_trunk_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for name in mod.NAMES:
            if name in found:
                raise ValueError(f"backbone {name!r} is built by two trunk files in {directory}")
            found[name] = mod
    return found


def trunk(backbone: str) -> Trunk:
    """The trunk of ``backbone``, from the file under ``TRUNKS_DIR`` whose
    ``NAMES`` hold it."""
    found = families(TRUNKS_DIR)
    if backbone not in found:
        raise ValueError(
            f"no trunk file in {TRUNKS_DIR} builds backbone {backbone!r}; "
            f"found: {', '.join(sorted(found)) or 'none'}")
    return found[backbone].build(backbone)


def conv2d(x: torch.Tensor, w: torch.Tensor, b, stride=1, padding=0,
           quant: Quant = None) -> torch.Tensor:
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride, padding)


def conv(mod: nn.Conv2d, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    return conv2d(x, mod.weight, mod.bias, mod.stride, mod.padding, quant)


def linear(mod: nn.Linear, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    w = mod.weight
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.linear(x, w, mod.bias)


def bn(mod: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(x, mod.running_mean, mod.running_var, mod.weight,
                        mod.bias, False, 0.0, BN_EPS)


def upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest upsample of (B, C, h, w) to ``hw``: source pixel
    floor((i + 0.5) * h / th), a repeat at integer ratios."""
    h, w = x.shape[2], x.shape[3]
    th, tw = int(hw[0]), int(hw[1])
    if (th, tw) == (h, w):
        return x
    rows = torch.floor((torch.arange(th, dtype=torch.float32, device=x.device)
                        + 0.5) * h / th).long()
    cols = torch.floor((torch.arange(tw, dtype=torch.float32, device=x.device)
                        + 0.5) * w / tw).long()
    return x[:, :, rows][:, :, :, cols]


class FPN(nn.Module):
    """The trunk's modules, then both top-downs, sized from its widths."""

    def __init__(self, body: Trunk, ch: int = 256):
        super().__init__()
        for name, mod in body.modules.items():
            self.add_module(name, mod)
        self._run_trunk = body.run
        w2, w3, w4, w5 = body.widths
        c = lambda cin, k, s=1: nn.Conv2d(cin, ch, k, stride=s, padding=k // 2)  # noqa: E731
        self.conv6, self.conv7 = c(w5, 3, 2), c(ch, 3, 2)
        self.latlayer1, self.latlayer2, self.latlayer3 = c(w5, 1), c(w4, 1), c(w3, 1)
        self.toplayer0, self.toplayer1, self.toplayer2 = c(ch, 3), c(ch, 3), c(ch, 3)
        self.toplayer = c(w5, 1)
        self.flatlayer1, self.flatlayer2, self.flatlayer3 = c(w4, 1), c(w3, 1), c(w2, 1)
        self.smooth1, self.smooth2, self.smooth3 = c(ch, 3), c(ch, 3), c(ch, 3)

    def trunk(self, x: torch.Tensor, q: Quant) -> List[torch.Tensor]:
        return self._run_trunk(self, x, q)             # c2, c3, c4, c5

    def detection(self, c3, c4, c5, q: Quant) -> Tuple[torch.Tensor, ...]:
        p6 = self._pyramid_conv(self.conv6, c5, q)
        p7 = self._pyramid_conv(self.conv7, F.relu(p6), q)
        p5 = conv(self.latlayer1, c5, q)
        p4 = upsample_nearest(p5, c4.shape[2:]) + conv(self.latlayer2, c4, q)
        p3 = upsample_nearest(p4, c3.shape[2:]) + conv(self.latlayer3, c3, q)
        return (conv(self.toplayer2, p3, q), conv(self.toplayer1, p4, q),
                conv(self.toplayer0, p5, q), p6, p7)

    def keypoint(self, c2, c3, c4, c5, q: Quant) -> Tuple[torch.Tensor, ...]:
        fp5 = conv(self.toplayer, c5, q)
        fp4 = upsample_nearest(fp5, c4.shape[2:]) + conv(self.flatlayer1, c4, q)
        fp3 = upsample_nearest(fp4, c3.shape[2:]) + conv(self.flatlayer2, c3, q)
        fp2 = upsample_nearest(fp3, c2.shape[2:]) + conv(self.flatlayer3, c2, q)
        return (conv(self.smooth3, fp2, q), conv(self.smooth2, fp3, q),
                conv(self.smooth1, fp4, q), fp5)

    @staticmethod
    def _pyramid_conv(mod: nn.Conv2d, x: torch.Tensor, q: Quant) -> torch.Tensor:
        # over a 1x1 map only the centre tap sees data (tiny test inputs)
        if x.shape[-2:] == (1, 1):
            return conv2d(x, mod.weight[:, :, 1:2, 1:2], mod.bias, quant=q)
        return conv(mod, x, q)


class Head(nn.Module):
    """RetinaNet head: four 3x3 convs with ReLU and an output conv."""

    def __init__(self, out_ch: int, ch: int = 256):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"conv{i}", nn.Conv2d(ch, ch, 3, padding=1))
        self.output = nn.Conv2d(ch, out_ch, 3, padding=1)

    def run(self, x: torch.Tensor, per_anchor: int, q: Quant) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(conv(getattr(self, f"conv{i}"), x, q))
        out = conv(self.output, x, q)
        return out.permute(0, 2, 3, 1).reshape(out.shape[0], -1, per_anchor)


class PRN(nn.Module):
    def __init__(self, nodes: int, coeff: int):
        super().__init__()
        self.height, self.width = 28 * coeff, 18 * coeff
        d = self.height * self.width * 17
        self.dens1 = nn.Linear(d, nodes)
        self.bneck = nn.Linear(nodes, nodes)
        self.dens2 = nn.Linear(nodes, d)

    def run(self, grid: torch.Tensor, q: Quant = None) -> torch.Tensor:
        b = grid.shape[0]
        # the grid enters in the compute precision, residual included
        res = grid.reshape(b, -1) if q is None else q(grid.reshape(b, -1))
        out = F.relu(linear(self.dens1, res, q))
        out = F.relu(linear(self.bneck, out, q))
        out = F.relu(linear(self.dens2, out, q)) + res
        return torch.softmax(out, dim=1).reshape(b, self.height, self.width, 17)


class PoseNet(nn.Module):
    """The whole model; methods take NHWC float images (ImageNet-normalised)
    and return the published layouts: heatmaps (B, H/4, W/4, 18),
    classification (B, A, 1) sigmoid scores and regression (B, A, 4), the
    anchors in (y, x, anchor) order."""

    def __init__(self, backbone: str, ch: int, num_joints: int, num_anchors: int,
                 num_classes: int, prn_nodes: int, prn_coeff: int):
        super().__init__()
        self.num_classes = num_classes
        self.fpn = FPN(trunk(backbone), ch)
        for k in range(2, 6):
            self.add_module(f"convfin_k{k}", nn.Conv2d(ch, 19, 1))
        for i in range(1, 5):
            self.add_module(f"convt{i}", nn.Conv2d(ch, 128, 3, padding=1))
            self.add_module(f"convs{i}", nn.Conv2d(128, 128, 3, padding=1))
        self.conv2 = nn.Conv2d(4 * 128, 256, 3, padding=1)
        self.convfin = nn.Conv2d(256, num_joints, 1)
        self.regressionModel = Head(num_anchors * 4, ch)
        self.classificationModel = Head(num_anchors * num_classes, ch)
        self.prn = PRN(prn_nodes, prn_coeff)

    def heatmaps(self, kp_feats, q: Quant = None) -> torch.Tensor:
        fp2, fp3, fp4, fp5 = kp_feats
        hw = fp2.shape[2:]
        p = [conv(getattr(self, f"convs{i}"), conv(getattr(self, f"convt{i}"), f, q), q)
             for i, f in zip((1, 2, 3, 4), (fp5, fp4, fp3, fp2))]
        cat = torch.cat([upsample_nearest(t, hw) for t in p], dim=1)
        out = conv(self.convfin, F.relu(conv(self.conv2, cat, q)), q)
        return out.permute(0, 2, 3, 1)

    def detect(self, det_feats, q: Quant = None):
        reg = torch.cat([self.regressionModel.run(f, 4, q) for f in det_feats], 1)
        cls = torch.cat([torch.sigmoid(self.classificationModel.run(
            f, self.num_classes, q)) for f in det_feats], 1)
        return cls, reg

    def full_forward(self, img: torch.Tensor, q: Quant = None):
        c2, c3, c4, c5 = self.fpn.trunk(img.permute(0, 3, 1, 2), q)
        heat = self.heatmaps(self.fpn.keypoint(c2, c3, c4, c5, q), q)
        cls, reg = self.detect(self.fpn.detection(c3, c4, c5, q), q)
        return heat, cls, reg

    def detection_forward(self, img: torch.Tensor, q: Quant = None):
        """The detection stage's forward: the frozen trunk without autograd,
        then the RetinaNet pyramid and heads."""
        with torch.no_grad():
            _, c3, c4, c5 = self.fpn.trunk(img.permute(0, 3, 1, 2), q)
        return self.detect(self.fpn.detection(c3, c4, c5, q), q)


def build(cfg: dict, device="cpu") -> PoseNet:
    """An uninitialised reference model of configuration ``cfg`` (a
    configuration file's dict) on ``device`` (``meta`` for shapes only).
    An unknown ``backbone`` raises ``ValueError``."""
    with torch.device(device):
        return PoseNet(cfg["backbone"], cfg["fpn_channels"], cfg["num_joints"],
                       cfg["num_anchors"], cfg["num_classes"],
                       cfg["prn_node_count"], cfg["prn_coeff"])


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess(img_rgb_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB (B, H, W, 3) -> ImageNet-normalised float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=img_rgb_u8.device)
    std = torch.tensor(IMAGENET_STD, device=img_rgb_u8.device)
    return (img_rgb_u8.float() / torch.tensor(255.0, device=img_rgb_u8.device)
            - mean) / std
