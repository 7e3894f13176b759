"""The comparisons that decide ``correct``: what the timed path produced,
held against the reference (``reference/``), number by number, each against
the limit its configuration file gives under ``checks``.

Serving, for each checked batch (two drawn from the seed and the window's
last), stage by stage; a stage after the forward starts from the program's
own output of the stage before it, so that each stage is judged alone:

- ``pack_diff``: bytes of the packed batch that differ from the frames
  padded to a square and turned RGB (exact);
- ``heat_err``, ``cls_err``, ``reg_err``: relative RMS error of the
  heatmaps, the detection scores before any threshold and the box deltas
  against the float32 reference forward of the same frames;
- ``det_diff``: entries of the kept top-100 (keep mask, anchor index,
  score, box) that differ from the reference's decoding and NMS of the
  program's scores and deltas (exact);
- ``peak_diff``: peaks whose validity differs, or whose refined location
  or value is not the maximum of the reference's float64 upsampled window
  to float32 rounding (``PEAK_RTOL``);
- ``prn_err``: relative RMS error of the PRN's output grids of the boxes
  that hold a person against the float32 PRN stage run on the program's
  peaks and boxes; ``cell_diff``:
  peak-in-box flags and grid cells that differ from that stage's, and
  per-peak window sums that differ from the reference's sums of the
  program's own PRN output beyond float32 rounding (``TABLE_RTOL``);
- ``person_diff``: frames whose served person list differs from the
  reference's grouping of the program's PRN stage (exact);
- ``chain_miss``: the share of people that the served lists and the
  reference's own chain from frames to person lists (its float32 forward,
  decoding, NMS, peaks, PRN stage and grouping) do not both find, a
  person matched by box IoU 0.5 (``info`` adds the counts and the share
  of the matched people's joints that agree).

Training: the first three steps, which set-up ran through the window's own
call and feed, against the reference's three steps from the same weights
and batches: ``loss_gap`` (the first step's loss), ``grad_gap`` (the first
gradient, as the optimizer's first moment holds it) and ``delta_gap`` (each
parameter's change over the three steps), the latter two by the worst
leaf: the gap between the two norms over the larger of the reference
leaf's norm and the median leaf's; and ``grad_err``, the relative error of
the whole first gradient (the norm of the difference over the reference's
norm), which tells the configuration's precision from a lower one where
norms alone do not.  After the window: ``window_nonfinite``, the values
the window's steps logged that are not finite (exact), and
``late_loss_gap``, the loss of one step more through the window's call,
feed and state against the reference's from the program's parameters at
that point.
"""

from __future__ import annotations

import contextlib
import math
import types
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mpn_bench.reference import model as ref_model
from mpn_bench.reference import post
from mpn_bench.reference import train as ref_train

REF_BLOCK = 16   # images per block of the reference forward


@contextlib.contextmanager
def exact_fp32():
    """float32 matmuls and convolutions without TF32."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale, as an fp8
    GEMM's operands are (the control of a bf16 configuration)."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def rel_rms(p: torch.Tensor, r: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> float:
    p, r = p.double(), r.double()
    if mask is not None:
        p, r = p[mask], r[mask]
    den = torch.sqrt((r * r).sum())
    return float(torch.sqrt(((p - r) ** 2).sum()) / den) if den > 0 else 0.0


def limited(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each limited number with its limit (a control read without a window
    has no window's numbers)."""
    return {k: {"value": float(values[k]), "limit": float(limits[k])}
            for k in limits if k in values}


# ------------------------------------------------------------------ serving

def pack(frames: Sequence[np.ndarray], inp: int, device) -> torch.Tensor:
    """BGR frames whose long side is ``inp`` -> (B, inp, inp, 3) RGB uint8,
    each padded with zeros at the bottom and right."""
    out = torch.zeros((len(frames), inp, inp, 3), dtype=torch.uint8)
    for i, f in enumerate(frames):
        if max(f.shape[:2]) != inp:
            raise ValueError("the reference packs frames whose long side is "
                             f"the model's input, got {f.shape[:2]}")
        out[i, :f.shape[0], :f.shape[1]] = torch.from_numpy(
            np.ascontiguousarray(f[..., ::-1]))
    return out.to(device)


def reference_forward(ref, images: torch.Tensor, quant=None):
    outs = [ref.full_forward(ref_model.preprocess(images[i:i + REF_BLOCK]), quant)
            for i in range(0, images.shape[0], REF_BLOCK)]
    return tuple(torch.cat(t) for t in zip(*outs))


def prn_inputs(peaks_p, dets_p, s: dict, scale: torch.Tensor):
    """The PRN stage's inputs from the program's peaks and detections:
    peaks in 17-joint order scaled to the frame, and the kept boxes sorted
    by score, the first ``max_people``, thresholded, as xywh."""
    sc = scale[:, None, None]
    pxy = peaks_p.coords[:, post.NECK_DROP] * sc[..., None]
    pvalid = peaks_p.valid[:, post.NECK_DROP]
    order = torch.argsort(-dets_p.scores, dim=1, stable=True)[:, :s["max_people"]]
    dsc = torch.gather(dets_p.scores, 1, order)
    dbx = torch.gather(dets_p.boxes, 1, order[..., None].expand(-1, -1, 4)) * sc
    thr = float(torch.tensor(s["test_score_thresh"], dtype=dsc.dtype))
    bvalid = dsc > thr
    xywh = torch.cat([dbx[..., :2], dbx[..., 2:] - dbx[..., :2]], dim=-1)
    return pxy, pvalid, torch.where(bvalid[..., None], xywh, 0.0), bvalid


def _rows_differ(served: List[dict], ref: List[dict]) -> bool:
    if len(served) != len(ref):
        return True
    for a, b in zip(served, ref):
        ka, kb = np.array(a["keypoints"]).reshape(-1, 3), np.array(b["keypoints"]).reshape(-1, 3)
        if (not np.allclose(a["bbox"], b["bbox"], rtol=1e-6, atol=1e-4)
                or not np.array_equal(ka[:, 2], kb[:, 2])
                or not np.allclose(ka[:, :2], kb[:, :2], rtol=0, atol=1e-3)
                or abs(a["score"] - b["score"]) > 1e-9):
            return True
    return False


def serve_numbers(cfg: dict, captured: Dict[int, dict], served: Dict[int, list],
                  frames: Sequence[np.ndarray], state_dict: dict, batch: int,
                  device, control: Optional[Callable] = None):
    """The serving comparisons of the checked batches -> (checks, info).
    ``control`` (a rounding function) puts the reference in that precision
    in the program's place for the forward and the PRN."""
    s = cfg["serve"]
    inp, stride = s["inp_size"], cfg["feat_stride"]
    ref = ref_model.build(cfg, device)
    ref.load_state_dict(state_dict)
    ref.eval().requires_grad_(False)
    gh, gw = ref.prn.height, ref.prn.width
    anc = torch.from_numpy(post.anchors((inp, inp))).to(device)
    v = dict(pack_diff=0, heat_err=0.0, cls_err=0.0, reg_err=0.0, det_diff=0,
             peak_diff=0, prn_err=0.0, cell_diff=0, person_diff=0)
    people = 0
    chain = np.zeros(5, np.int64)   # served, reference, matched, joints, agreeing
    with torch.no_grad(), exact_fp32():
        for bi, rec in sorted(captured.items()):
            fr = [frames[(bi * batch + r) % len(frames)] for r in range(batch)]
            images = pack(fr, inp, device)
            v["pack_diff"] += int((images != rec["images"]).sum())
            heat_r, cls_r, reg_r = reference_forward(ref, images)
            fwd = (rec["forward"] if control is None
                   else reference_forward(ref, images, control))
            for key, p, r in zip(("heat_err", "cls_err", "reg_err"), fwd,
                                 (heat_r, cls_r, reg_r)):
                v[key] = max(v[key], rel_rms(p, r))
            heat_p, cls_p, reg_p = rec["forward"]
            out = rec["out"]
            v["det_diff"] += _det_diff(post.detections(
                cls_p, reg_p, anc, inp, inp, s["score_thresh"], s["max_detections"],
                s["nms_thresh"]), out.detections)
            v["peak_diff"] += _peak_diff(post.peaks(
                heat_p, s["peak_thresh"], s["max_peaks"], stride, s["peak_window"]),
                out.peaks, stride)
            pxy, pvalid, xywh, bvalid = prn_inputs(out.peaks, out.detections, s,
                                                   torch.ones(batch, device=device))
            st = post.prn_stage(lambda g: ref.prn.run(g), pxy.float(), pvalid,
                                xywh.float(), bvalid, gh, gw, s["prn_in_thres"],
                                s["prn_window"])
            table_p, inside_p, prn_p, x0_p, y0_p = rec["prn"]
            if control is not None:
                prn_p = post.prn_stage(lambda g: ref.prn.run(g, control), pxy.float(),
                                       pvalid, xywh.float(), bvalid, gh, gw,
                                       s["prn_in_thres"], s["prn_window"]).prn_out
            # over the boxes that hold a person: an empty slot's output is
            # the same uniform grid on both sides
            v["prn_err"] = max(v["prn_err"], rel_rms(
                prn_p, st.prn_out, bvalid[:, :, None, None, None].expand_as(prn_p)))
            # the window sums of the program's own PRN output
            table_r = post.window_table(prn_p.float(), x0_p, y0_p, inside_p, pvalid,
                                        s["prn_window"])
            v["cell_diff"] += int((inside_p != st.inside).sum()
                                  + ((x0_p != st.x0) & st.inside).sum()
                                  + ((y0_p != st.y0) & st.inside).sum()
                                  + (~torch.isclose(table_p, table_r, rtol=TABLE_RTOL,
                                                    atol=0.0)).sum())
            if bi in served or control is not None:
                rows_r = _chain(ref, (heat_r, cls_r, reg_r), None, s, anc, stride, batch)
                rows_p = (served[bi] if control is None
                          else _chain(ref, fwd, control, s, anc, stride, batch))
                for a, b in zip(rows_p, rows_r):
                    chain += np.array(_agree(a, b, 2 * stride))
            if control is not None or bi not in served:
                continue
            tb, ins, pro, x0, y0 = (t.float().cpu().numpy() if t.is_floating_point()
                                    else t.cpu().numpy() for t in rec["prn"])
            pxy_h, xywh_h = pxy.cpu().numpy(), xywh.cpu().numpy()
            for r, nb in enumerate(bvalid.sum(1).tolist()):
                rows = post.group(tb[r, :nb], ins[r, :nb], x0[r, :nb], y0[r, :nb],
                                  pro[r, :nb], pxy_h[r], xywh_h[r, :nb])
                people += len(served[bi][r])
                v["person_diff"] += int(_rows_differ(served[bi][r], rows))
    v["chain_miss"] = 1.0 - chain[2] / max(chain[0], chain[1], 1)
    info = {"batches_checked": len(captured), "people_checked": people,
            "frames_differ": v["person_diff"],
            "chain_people_served_ref_matched": chain[:3].tolist(),
            "chain_joints_agree": float(chain[4] / max(chain[3], 1)),
            "numbers": {k: float(x) for k, x in v.items()}}
    return limited(v, cfg["checks"]["serve"]), info


def _chain(ref, fwd, quant, s: dict, anc, stride: int, batch: int) -> List[list]:
    """Person lists of a batch from forward outputs alone, every stage the
    reference's: decoding and NMS, peaks, the PRN stage (its network
    rounded by ``quant``) and the grouping."""
    inp = s["inp_size"]
    heat, cls, reg = fwd
    dets = post.detections(cls, reg, anc, inp, inp, s["score_thresh"],
                           s["max_detections"], s["nms_thresh"])
    pk = post.peaks(heat, s["peak_thresh"], s["max_peaks"], stride, s["peak_window"])
    pks = types.SimpleNamespace(coords=post.peak_coords(pk, stride), valid=pk.valid)
    pxy, pvalid, xywh, bvalid = prn_inputs(pks, dets, s,
                                           torch.ones(batch, device=heat.device))
    st = post.prn_stage(lambda g: ref.prn.run(g, quant), pxy.float(), pvalid,
                        xywh.float(), bvalid, ref.prn.height, ref.prn.width,
                        s["prn_in_thres"], s["prn_window"])
    tb, ins, pro, x0, y0 = (t.float().cpu().numpy() if t.is_floating_point()
                            else t.cpu().numpy() for t in st)
    pxy_h, xywh_h = pxy.float().cpu().numpy(), xywh.float().cpu().numpy()
    return [post.group(tb[r, :nb], ins[r, :nb], x0[r, :nb], y0[r, :nb], pro[r, :nb],
                       pxy_h[r], xywh_h[r, :nb])
            for r, nb in enumerate(bvalid.sum(1).tolist())]


def _iou_xywh(a, b) -> float:
    iw = min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0])
    ih = min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1])
    inter = max(iw, 0.0) * max(ih, 0.0)
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def _agree(rows_p: List[dict], rows_r: List[dict], tol: float):
    """One frame's people: (served, reference, matched, joints of the
    matched, joints that agree).  A reference person, in its order, matches
    the first unmatched served person whose box overlaps its own by IoU 0.5
    or more; a joint agrees when both mark it visible within ``tol`` pixels
    in x and y, or both mark it not visible."""
    free = list(range(len(rows_p)))
    matched = joints = agreeing = 0
    for b in rows_r:
        for i in free:
            a = rows_p[i]
            if _iou_xywh(a["bbox"], b["bbox"]) >= 0.5:
                free.remove(i)
                matched += 1
                ka = np.array(a["keypoints"]).reshape(-1, 3)
                kb = np.array(b["keypoints"]).reshape(-1, 3)
                vis = (ka[:, 2] > 0) & (kb[:, 2] > 0)
                near = (np.abs(ka[:, :2] - kb[:, :2]) <= tol).all(1)
                joints += len(ka)
                agreeing += int(((vis & near) | ((ka[:, 2] == 0) & (kb[:, 2] == 0))).sum())
                break
    return len(rows_p), len(rows_r), matched, joints, agreeing


# float32 against float64 (peaks) or another float32 summation order (window
# sums) differs by about 1.5e-7 relative; a wrong location or sum by far more
PEAK_RTOL = 1e-5
TABLE_RTOL = 1e-4


def _det_diff(d, dp) -> int:
    """Entries of the kept top-k that differ: keep, index, score, box."""
    return int((d.keep != dp.keep).sum() + (d.indices != dp.indices.long()).sum()
               + (d.scores.float() != dp.scores.float()).sum()
               + (d.boxes != dp.boxes).any(-1).sum())


def _peak_diff(pk, pp, stride: int) -> int:
    """Peaks whose validity differs, or whose refined location or value is
    not the reference's upsampled window's maximum to float32 rounding."""
    bad = pk.valid != pp.valid
    sf = pk.up.shape[-1]
    off = pp.coords.long() - pk.win_xy * stride
    inwin = ((off >= 0) & (off < sf)).all(-1)
    flat = pk.up.flatten(-2)
    upmax = flat.amax(-1)
    at = torch.gather(flat, -1, (off[..., 1].clamp(0, sf - 1) * sf
                                 + off[..., 0].clamp(0, sf - 1))[..., None])[..., 0]
    tol = PEAK_RTOL * upmax.abs()
    wrong = ~inwin | (upmax - at > tol) | ((pp.scores.double() - upmax).abs() > tol)
    return int((bad | (pk.valid & pp.valid & wrong)).sum())


# ------------------------------------------------------------------ training

def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: Sequence[str]) -> float:
    """The worst leaf's gap between the program's and the reference's
    norms, over the larger of the reference leaf's norm and the median
    leaf's."""
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], med, 1e-30)
               for n in names)


def vector_err(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               names: Sequence[str]) -> float:
    """||prog - ref|| / ||ref|| over all ``names`` leaves as one vector."""
    num = sum(float(((prog[n].double() - ref[n].double()) ** 2).sum()) for n in names)
    den = sum(float((ref[n].double() ** 2).sum()) for n in names)
    return math.sqrt(num / den) if den > 0 else 0.0


def train_numbers(cfg: dict, prog: dict, state_dict: dict, batches: Sequence[dict],
                  device, lr: float, ref_run: Optional[dict] = None,
                  late: Optional[dict] = None):
    """The training comparisons -> (checks, info).  ``prog`` holds the
    program's ``losses`` (3), first gradient ``grad`` and change ``delta``
    by parameter name; ``ref_run`` passes ``detection_steps`` options (the
    control's precision or a fault) for a reference that stands in for the
    program.  ``late`` holds the window's logged values (``window_logs``)
    and the step after the window: the program's trainable ``params``
    before it, its ``batch`` from the pool and its ``loss``."""
    t = cfg["train_detection"]
    ref = reference_steps(cfg, state_dict, batches, device, lr)
    if ref_run is not None:
        prog = reference_steps(cfg, state_dict, batches, device, lr, **ref_run)
    losses_r, grad_r, delta_r = ref["losses"], ref["grad"], ref["delta"]
    names = sorted(grad_r)
    gnorm = {n: float(grad_r[n].double().norm()) for n in names}
    med = float(np.median(list(gnorm.values())))
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone under Adam: their change is not compared
    moved = [n for n in names if gnorm[n] >= 1e-3 * med]
    # the first step's loss: later steps add Adam's noise (a weight whose
    # gradient is round-off moves by about lr either way), which grows the
    # gap tenfold by the third step on sound runs; their updates are
    # compared by delta_gap
    v = {"loss_gap": abs(prog["losses"][0] - losses_r[0]) / abs(losses_r[0]),
         "grad_gap": leaf_gap(prog["grad"], grad_r, names),
         "delta_gap": leaf_gap(prog["delta"], delta_r, moved),
         "grad_err": vector_err(prog["grad"], grad_r, names)}
    if late is not None:
        # every value the window logged is finite; the step after it has
        # the reference's loss from the same parameters and batch
        v["window_nonfinite"] = int((~torch.isfinite(late["window_logs"])).sum())
        loss_r = late_loss(cfg, state_dict, late, device)
        loss_p = (late["loss"] if ref_run is None
                  else late_loss(cfg, state_dict, late, device, **ref_run))
        v["late_loss_gap"] = abs(loss_p - loss_r) / abs(loss_r)
    info = {"losses_ref": losses_r, "losses": list(prog["losses"]),
            "leaves": len(names),
            "leaves_not_compared_delta": sorted(set(names) - set(moved)),
            "precision": t["compute_dtype"],
            "numbers": {k: float(x) for k, x in v.items()}}
    if late is not None:
        info["window_steps_logged"] = int(late["window_logs"].shape[0])
        info["late_loss"], info["late_loss_ref"] = late["loss"], loss_r
    return limited(v, cfg["checks"]["train_detection"]), info


def late_loss(cfg: dict, state_dict: dict, late: dict, device, **kw) -> float:
    """The reference's loss of ``late``'s batch from the weights with the
    program's trainable parameters at that step put in."""
    t = cfg["train_detection"]
    ref = ref_model.build(cfg, device)
    sd = dict(state_dict)
    sd.update(late["params"])
    ref.load_state_dict(sd)
    anc = torch.from_numpy(post.anchors((t["inp_size"], t["inp_size"]))).to(device)
    with exact_fp32():
        losses, _, _ = ref_train.detection_steps(ref, [late["batch"]], anc, 0.0, **kw)
    return losses[0]


def reference_steps(cfg: dict, state_dict: dict, batches: Sequence[dict], device,
                    lr: float, **kw) -> dict:
    t = cfg["train_detection"]
    ref = ref_model.build(cfg, device)
    ref.load_state_dict(state_dict)
    anc = torch.from_numpy(post.anchors((t["inp_size"], t["inp_size"]))).to(device)
    with exact_fp32():
        losses, grad, delta = ref_train.detection_steps(ref, batches, anc, lr, **kw)
    return {"losses": losses, "grad": grad, "delta": delta}
