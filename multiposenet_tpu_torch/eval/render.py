"""Skeleton / bbox rendering — the port of multiposenet_tpu/eval/render.py
(reference network/joint_utils.py:155-202): red box rectangles, per-joint
coloured dots and elliptical limb "sticks", drawn without cv2.

The JAX package draws with four cv2 primitives; each is written here from
OpenCV's own integer arithmetic (modules/imgproc/src/drawing.cpp), so the
canvas equals cv2's pixel for pixel (tests/test_torch_port_render.py):

- ``rectangle``, thickness 2: each side a thick line, i.e. a 4-vertex
  polygon offset by one pixel from the side in 16.16 fixed point, filled
  by ``fill_convex_poly`` (outline by ``_line_fixed``), and a radius-1
  ``circle`` at each corner;
- ``circle``, filled: the midpoint circle's horizontal spans;
- ``ellipse2poly``: points every ``delta`` degrees from OpenCV's float
  sine table (sin of whole degrees to 7 decimals), in double, rounded with
  ``cvRound`` and de-duplicated;
- ``fill_convex_poly``: the outline as 8-connected lines, then two edges
  walked down from the top vertex in 16.16 fixed point, one span per row.

The anti-aliased primitives (``LINE_AA``, which the synthetic dataset
draws with: multiposenet_tpu_torch/tools/make_synth_pose_dataset.py) are
OpenCV's too:

- ``line_aa``: ``LineAA``, a 16.16 line whose every step along the major
  axis blends three pixels across it with weights from a Gaussian table,
  scaled by the slope and, on the first and last two steps, by the
  endpoints' sub-pixel fractions; each blend is applied twice;
- ``fill_convex_poly(..., aa=True)``: the outline by ``line_aa``, then the
  interior spans from each left edge's ceiling to each right edge's floor;
- ``thick_line_aa`` (``cv2.line`` with ``LINE_AA``): the line's 4-vertex
  polygon and a filled anti-aliased disc of its width at each end;
- ``circle_aa`` (filled ``cv2.circle`` with ``LINE_AA``): ``EllipseEx``, a
  polygon from the double-precision ``ellipse2Poly`` in 16.16 fixed point
  (a vertex every 90, 30, 18 or 5 degrees by radius), filled as above.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from multiposenet_tpu_torch.data.imgproc import _clip_line, _line_pixels, _trunc_div

COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85], [255, 0, 0]]
# limbs over the 17-joint internal order (reference joint_utils.py:14-15)
LIMB_SEQ = np.array(
    [[0, 1], [1, 2], [2, 3], [0, 4], [4, 5], [5, 6], [0, 7], [7, 8],
     [8, 9], [0, 10], [10, 11], [11, 12], [0, 13], [13, 15], [0, 14],
     [14, 16]], dtype=np.int64)

_JOINT_RADIUS = 4
_STICK_HALFWIDTH = 2
_BBOX_COLOR = (0, 0, 255)  # BGR red

_SHIFT = 16                  # drawing.cpp's XY_SHIFT
_ONE = 1 << _SHIFT
# drawing.cpp's SinTable: sin of 0..450 whole degrees to 7 decimals, float
_SIN = np.array([f"{np.sin(np.deg2rad(k)):.7f}" for k in range(451)],
                np.float64).astype(np.float32)
# drawing.cpp's SlopeCorrTable and FilterTable (LineAA)
_SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192,
               194, 196, 198, 201, 203, 206, 209, 211, 214, 218, 221, 224,
               227, 231, 235, 238, 242, 246, 250, 254)
_FILTER = np.array(
    [168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
     254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
     194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
     68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7,
     5, 5], np.int64)


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, thickness=-1)``: OpenCV's
    ``Circle`` with fill, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            for y, x1, x2 in ((y11, x11, x12), (y12, x11, x12),
                              (y21, x21, x22), (y22, x21, x22)):
                _hline(img, y, x1, x2, color)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for y in (y11, y12):
                if 0 <= y < h:
                    _hline(img, y, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for y in (y21, y22):
                    if 0 <= y < h:
                        _hline(img, y, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _line_fixed(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``Line2``: an 8-connected line between 16.16 fixed-point
    points, clipped to the image."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2), ok = _clip_line(w << _SHIFT, h << _SHIFT, p1, p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    half = _ONE >> 1
    pts = []
    if abs(dx) > abs(dy):
        if dx < 0:
            dy = -dy
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        y_step = _trunc_div(dy << _SHIFT, abs(dx) | 1)
        pts.append(((x2 + half) >> _SHIFT, (y2 + half) >> _SHIFT))
        count = (x2 - x1) >> _SHIFT
        x, y = (x1 + half) >> _SHIFT, y1 + half
        for k in range(count + 1):
            pts.append((x + k, (y + k * y_step) >> _SHIFT))
    else:
        if dy < 0:
            dx = -dx
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        x_step = _trunc_div(dx << _SHIFT, abs(dy) | 1)
        pts.append(((x2 + half) >> _SHIFT, (y2 + half) >> _SHIFT))
        count = (y2 - y1) >> _SHIFT
        x, y = x1 + half, (y1 + half) >> _SHIFT
        for k in range(count + 1):
            pts.append(((x + k * x_step) >> _SHIFT, y + k))
    for x, y in pts:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color


def line_aa(img: np.ndarray, p1, p2, color) -> None:
    """OpenCV's ``LineAA``: an anti-aliased line between 16.16 fixed-point
    points on a uint8 (H, W, C) image, clipped to it."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2), ok = _clip_line(w << _SHIFT, h << _SHIFT, p1, p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if x_major:
        if dx < 0:
            dy = -dy
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        step = _trunc_div(dy << _SHIFT, abs(dx) | 1)
        a0, b0, a1 = x1, y1, x2 + _ONE
    else:
        if dy < 0:
            dx = -dx
            (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
        step = _trunc_div(dx << _SHIFT, abs(dy) | 1)
        a0, b0, a1 = y1, x1, y2 + _ONE
    # a: the major axis, b: the minor one
    ecount = (a1 >> _SHIFT) - (a0 >> _SHIFT)
    b0 += ((step * -(a0 & (_ONE - 1))) >> _SHIFT) + (_ONE >> 1)
    slope = (step >> (_SHIFT - 5)) & 0x3F
    slope ^= 0x3F if step < 0 else 0
    # 4-bit fractions of the end points
    i = (a0 >> (_SHIFT - 7)) & 0x78
    j = (a1 >> (_SHIFT - 7)) & 0x78
    slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    ep = np.zeros(9, np.int64)
    ep[8] = slope
    ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF
    ep[2] = (t1 >> 8) & 0x1FF
    ep[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF
    ep[5] = ((t1 + t0) >> 8) & 0x1FF
    ep[6] = (t2 >> 8) & 0x1FF
    ep[7] = ((t2 + t0) >> 8) & 0x1FF

    # every step at once: no pixel is visited twice by one line
    k = np.arange(ecount + 1, dtype=np.int64)
    major = (a0 >> _SHIFT) + k
    minor_fx = b0 + k * step
    sc, ec = k, ecount - k
    corr = ep[(((sc >= 2) + 1) & (sc | 2)) * 3 + (((ec >= 2) + 1) & (ec | 2))]
    dist = (minor_fx >> (_SHIFT - 5)) & 31
    n_major, n_minor = (w, h) if x_major else (h, w)
    keep = (major >= 0) & (major < n_major)
    color = np.asarray(color, np.int64)[: img.shape[2]]
    for off, tap in ((0, dist + 32), (1, dist), (2, 63 - dist)):
        minor = (minor_fx >> _SHIFT) - 1 + off
        sel = keep & (minor >= 0) & (minor < n_minor)
        if not sel.any():
            continue
        a = ((corr[sel] * _FILTER[tap[sel]]) >> 8) & 0xFF
        ys, xs = (minor[sel], major[sel]) if x_major else (major[sel], minor[sel])
        px = img[ys, xs].astype(np.int64)
        for _ in range(2):
            px += ((color - px) * a[:, None] + 127) >> 8
        img[ys, xs] = px


def fill_convex_poly(img: np.ndarray, pts, color, shift: int = 0,
                     aa: bool = False) -> None:
    """``cv2.fillConvexPoly(img, pts, color, LINE_8 or LINE_AA, shift)``:
    integer (x, y) vertices with ``shift`` fractional bits."""
    h, w = img.shape[:2]
    v = [(int(x), int(y)) for x, y in np.asarray(pts, np.int64).reshape(-1, 2)]
    n = len(v)
    up = _SHIFT - shift
    delta = 1 << shift >> 1
    half = _ONE >> 1
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    p0 = (v[-1][0] << up, v[-1][1] << up)
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        p = (x << up, y << up)
        if aa:
            line_aa(img, p0, p, color)
        elif shift == 0:
            px = _line_pixels(w, h, (p0[0] >> _SHIFT, p0[1] >> _SHIFT), (x, y))
            if px is not None:
                img[px[1], px[0]] = color
        else:
            _line_fixed(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [vertex index, step, x, dx, last row]
    edge = [[imin, 1, -_ONE, 0, ymin], [imin, n - 1, -_ONE, 0, ymin]]
    edges = n
    y = ymin
    # LINE_AA: each span from the left edge's ceiling to the right edge's
    # floor, and the edges are not advanced on the last row (but the first)
    lo, hi = (_ONE - 1, 0) if aa else (half, half)
    while True:
        for e in edge if not aa or y < ymax or y == ymin else ():
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % n
            while True:
                live = edges > 0
                edges -= 1
                if not live:
                    break
                ty = (v[idx][1] + delta) >> shift
                if ty > y:
                    xs, xe = v[idx0][0] << up, v[idx][0] << up
                    e[:] = [idx, di, xs,
                            _trunc_div((xe - xs) * 2 + (ty - y), 2 * (ty - y)), ty]
                    break
                idx0 = idx
                idx = (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            x1 = (edge[left][2] + lo) >> _SHIFT
            x2 = (edge[right][2] + hi) >> _SHIFT
            if x2 >= 0 and x1 < w:
                _hline(img, y, max(x1, 0), min(x2, w - 1), color)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 2) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` for thickness >
    1 (LINE_8): each side a thick line, closed."""
    (ax, ay), (bx, by) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    corners = [(ax, ay), (bx, ay), (bx, by), (ax, by)]
    p0 = corners[-1]
    for p in corners:
        _thick_line(img, p0, p, color, thickness)
        p0 = p


def thick_line(img: np.ndarray, pt1, pt2, color, thickness: int) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness)`` (LINE_8) for integer
    points and thickness > 1: the points clipped as ``cv2.line`` clips
    them, then ``ThickLine`` with round caps at both ends."""
    if thickness <= 1:
        raise ValueError(f"thick_line draws thickness > 1, not {thickness}")
    ends = _clip_thick(img, pt1, pt2, thickness)
    if ends is not None:
        _thick_line(img, *ends, color, int(thickness), start_cap=True)


def _clip_thick(img: np.ndarray, pt1, pt2, thickness: int):
    """``cv2.line``'s first step above thickness 1: the integer points
    clipped to the image grown by ``thickness`` on every side, or None
    when the segment misses it."""
    h, w = img.shape[:2]
    t = int(thickness)
    (ax, ay), (bx, by), ok = _clip_line(
        w + 2 * t, h + 2 * t, (int(pt1[0]) + t, int(pt1[1]) + t),
        (int(pt2[0]) + t, int(pt2[1]) + t))
    return ((ax - t, ay - t), (bx - t, by - t)) if ok else None


def _thick_line(img, p0, p1, color, thickness: int,
                start_cap: bool = False) -> None:
    """OpenCV's ``ThickLine`` (LINE_8, thickness > 1): the segment's
    polygon, then a round cap at its end, and with ``start_cap`` one at its
    start first (``cv2.line``; a closed polyline's side has the end cap
    alone)."""
    x0, y0 = p0[0] << _SHIFT, p0[1] << _SHIFT
    x1, y1 = p1[0] << _SHIFT, p1[1] << _SHIFT
    dx, dy = (x0 - x1) / _ONE, (y1 - y0) / _ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * _ONE * 0.5) / np.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        fill_convex_poly(img, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy),
                               (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)],
                         color, _SHIFT)
    for x, y in ((x0, y0), (x1, y1))[0 if start_cap else 1:]:
        circle(img, ((x + (_ONE >> 1)) >> _SHIFT, (y + (_ONE >> 1)) >> _SHIFT),
               (thick + (_ONE >> 1)) >> _SHIFT, color)


def _ellipse_points(center, axes, angle: int, arc_start: int, arc_end: int,
                    delta: int) -> list:
    """The double-precision ``ellipse2Poly``: (x, y) float points."""
    angle = int(angle)
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    a = angle + (360 if angle < 0 else 0)
    alpha, beta = float(_SIN[450 - a]), float(_SIN[a])
    cx, cy = float(center[0]), float(center[1])
    aw, ah = float(axes[0]), float(axes[1])
    out = []
    for i in range(arc_start, arc_end + delta, delta):
        t = min(i, arc_end)
        t += 360 if t < 0 else 0
        x = aw * float(_SIN[450 - t])
        y = ah * float(_SIN[t])
        out.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    return out


def ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int,
                 delta: int) -> np.ndarray:
    """``cv2.ellipse2Poly`` with integer arguments: (N, 2) int32 points."""
    out = []
    prev = None
    for x, y in _ellipse_points(center, axes, angle, arc_start, arc_end, delta):
        pt = (int(np.rint(x)), int(np.rint(y)))
        if pt != prev:
            out.append(pt)
            prev = pt
    if len(out) == 1:
        out = [(int(center[0]), int(center[1]))] * 2
    return np.asarray(out, np.int32).reshape(-1, 2)


def _disc_aa(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's ``EllipseEx`` of a full filled circle with ``LINE_AA``:
    16.16 fixed-point center and radius."""
    r = abs(int(radius))
    delta = (r + (_ONE >> 1)) >> _SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    v = []
    for x, y in _ellipse_points(center, (r, r), 0, 0, 360, delta):
        px = int(np.rint(x / _ONE)) << _SHIFT
        py = int(np.rint(y / _ONE)) << _SHIFT
        pt = (px + int(np.rint(x - px)), py + int(np.rint(y - py)))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [tuple(center)] * 2
    fill_convex_poly(img, v, color, _SHIFT, aa=True)


def circle_aa(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1, cv2.LINE_AA)``."""
    _disc_aa(img, (int(center[0]) << _SHIFT, int(center[1]) << _SHIFT),
             int(radius) << _SHIFT, color)


def thick_line_aa(img: np.ndarray, pt1, pt2, color, thickness: int) -> None:
    """``cv2.line(img, pt1, pt2, color, thickness, cv2.LINE_AA)`` for
    integer points: OpenCV's ``ThickLine`` with round caps at both ends
    (a plain ``line_aa`` at thickness 1).  Above thickness 1, as
    ``cv2.line`` does, the points are first clipped to the image grown by
    ``thickness`` on every side."""
    if thickness <= 1:
        line_aa(img, (int(pt1[0]) << _SHIFT, int(pt1[1]) << _SHIFT),
                (int(pt2[0]) << _SHIFT, int(pt2[1]) << _SHIFT), color)
        return
    ends = _clip_thick(img, pt1, pt2, thickness)
    if ends is None:
        return
    (ax, ay), (bx, by) = ends
    x0, y0 = ax << _SHIFT, ay << _SHIFT
    x1, y1 = bx << _SHIFT, by << _SHIFT
    dx, dy = (x0 - x1) / _ONE, (y1 - y0) / _ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (thick + odd * _ONE * 0.5) / np.sqrt(r)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        fill_convex_poly(img, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy),
                               (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)],
                         color, _SHIFT, aa=True)
    _disc_aa(img, (x0, y0), thick, color)
    _disc_aa(img, (x1, y1), thick, color)


def draw_person(canvas: np.ndarray, joints: Sequence[Sequence[float]],
                bbox: Sequence[float]) -> np.ndarray:
    """Draw one person's bbox, joints and limb sticks onto ``canvas``."""
    j = np.asarray(joints, dtype=np.float64).reshape(17, 3)
    xy = j[:, :2].astype(np.int64)
    # a dot is skipped when int(v) == 0, a limb when v == 0 (reference
    # joint_utils.py:164 and its limb check): for a fractional v the limb
    # is drawn but not the dot
    visible = j[:, 2].astype(np.int64) != 0
    limb_visible = j[:, 2] != 0

    bx, by, bw, bh = (float(v) for v in bbox[:4])
    rectangle(canvas, (int(bx), int(by)), (int(bx + bw), int(by + bh)),
              _BBOX_COLOR, 2)
    for idx in np.flatnonzero(visible):
        circle(canvas, xy[idx], _JOINT_RADIUS, COLORS[idx])

    ends = xy[LIMB_SEQ]                            # (16, 2, 2) int endpoints
    limb_ok = limb_visible[LIMB_SEQ].all(axis=1)
    mids = ends.astype(np.float64).mean(axis=1)
    deltas = (ends[:, 0] - ends[:, 1]).astype(np.float64)
    half_lens = np.hypot(deltas[:, 0], deltas[:, 1]) / 2.0
    angles = np.degrees(np.arctan2(deltas[:, 1], deltas[:, 0]))
    for idx in np.flatnonzero(limb_ok):
        poly = ellipse2poly((int(mids[idx, 0]), int(mids[idx, 1])),
                            (int(half_lens[idx]), _STICK_HALFWIDTH),
                            int(angles[idx]), 0, 360, 1)
        fill_convex_poly(canvas, poly, COLORS[idx])
    return canvas


def plot_results(img: np.ndarray, results: List[Dict]) -> np.ndarray:
    """Render a list of COCO-format person results onto ``img``."""
    for person in results:
        kp = np.asarray(person["keypoints"], dtype=np.float64).reshape(17, 3)
        img = draw_person(img, kp, person["bbox"])
    return img
