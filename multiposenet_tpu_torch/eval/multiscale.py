"""Multi-scale evaluation helpers — the port's copy of the device path's
pieces of multiposenet_tpu/eval/multiscale.py (reference
evaluate/tester.py:38-81, 256-331): scale selection, the shape arithmetic of
crop/pad to factor-divisible, bucketed shapes, and the L/R channel swap of
the flip fold.  The evaluator resizes pixels and heatmaps on the device, so
none of the cv2 pieces are needed here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# L/R channel swap for flip averaging, 18-joint order (tester.py:326-327)
SWAP_HEAT_18 = [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 15, 14, 17, 16]


def get_multipliers(img_h: int, inp_size: int,
                    scale_search: Sequence[float] = (0.5, 1.0, 1.5, 2.0, 2.5)
                    ) -> List[float]:
    """Scales relative to the image height (reference tester.py:256-262)."""
    return [x * inp_size / float(img_h) for x in scale_search]


def _factor_closest(num: float, factor: int, is_ceil: bool = True) -> int:
    num = float(num) / factor
    num = np.ceil(num) if is_ceil else np.floor(num)
    return int(num) * factor


def crop_shape_only(shape_hw: Tuple[int, int], dest_size: float,
                    factor: int = 32, basedon: str = "min",
                    bucket: int = 0) -> Tuple[Tuple[int, int], float,
                                              Tuple[int, int]]:
    """The shape arithmetic of the reference's crop_with_factor
    (tester.py:38-81): returns (padded (H, W), im_scale, real (H, W)).  The
    ``basedon`` side is scaled to ``dest_size`` with cv2's rounding
    (round-half-to-even of dim * scale), and both sides are padded up to a
    multiple of max(factor, bucket)."""
    h, w = int(shape_hw[0]), int(shape_hw[1])
    base = {"min": min(h, w), "max": max(h, w), "w": w, "h": h}[basedon]
    im_scale = float(dest_size) / base
    rh = int(np.round(h * im_scale))
    rw = int(np.round(w * im_scale))
    eff = max(factor, bucket)
    return (_factor_closest(rh, eff), _factor_closest(rw, eff)), \
        im_scale, (rh, rw)
