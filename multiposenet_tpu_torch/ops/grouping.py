"""Greedy mutual-best peak-to-person assignment — PyTorch twin of
multiposenet_tpu/ops/grouping.py (reference evaluate/tester.py:431-483).

The reference's sequential double loop flattens into masked reductions
(see the JAX module for the derivation):

  cw[j,p]       = argmax_b t[b,j,p]                        (column winner)
  amin[j,p]     = argmin over valid columns of t[cw, j, :]  (first index)
  accept[b,j,p] = t > 0 & (cw == b | amin == p)
  chosen[b,j]   = argmax_p where(accept, t, -inf)

after deduplicating cell collisions (the last peak written to a grid cell
wins, tester.py:393).  Every function takes an optional leading image axis:
inputs of one image are (B, J, P) as in JAX, a batch of images
(N, B, J, P).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` rounded once, as JAX divides.  (``number / tensor`` in
    PyTorch is ``den.reciprocal() * num``, which rounds twice.)"""
    return torch.full_like(den, float(num)) / den


class Assignment(NamedTuple):
    chosen: torch.Tensor       # ([N,] B, J) int32 peak slot per joint, -1 none
    active_any: torch.Tensor   # ([N,] J) bool: joint type has any scored peak
    fallback_xy: torch.Tensor  # ([N,] B, J, 2) float32 PRN-argmax fallback
    active: torch.Tensor       # ([N,] B, J, P) bool post-dedupe activity


def assign_peaks(table: torch.Tensor, inside: torch.Tensor,
                 cell_x: torch.Tensor, cell_y: torch.Tensor,
                 prn_out: torch.Tensor, boxes_xywh: torch.Tensor) -> Assignment:
    """table (B, J, P) scores (0 where a peak is not in the box), inside
    (B, J, P) bool, cell_x / cell_y (B, J, P) int grid cells, prn_out
    (B, gh, gw, J), boxes_xywh (B, 4); each with an optional leading image
    axis N."""
    if table.dim() == 3:
        out = assign_peaks(table[None], inside[None], cell_x[None],
                           cell_y[None], prn_out[None], boxes_xywh[None])
        return Assignment(*(t[0] for t in out))
    n, num_b, num_j, num_p = table.shape
    gh, gw = prn_out.shape[2], prn_out.shape[3]
    dev = table.device

    # ---- dedupe: the last peak written to a cell wins ----------------------
    same_cell = ((cell_x[..., :, None] == cell_x[..., None, :]) &
                 (cell_y[..., :, None] == cell_y[..., None, :]))
    later = torch.ones(num_p, num_p, dtype=torch.bool, device=dev).triu(1)
    lose = (same_cell & inside[..., None, :] & later).any(dim=-1)
    active = inside & ~lose
    t = torch.where(active, table, 0.0).float()                # (N, B, J, P)

    # ---- mutual-best conditions -------------------------------------------
    cw = t.argmax(dim=1)                                       # (N, J, P)
    valid_col = active.any(dim=1)                              # (N, J, P)
    # rows[n, j, p, :] = t[n, cw[n, j, p], j, :]
    tj = t.transpose(1, 2)                                     # (N, J, B, P')
    rows = torch.gather(tj, 2, cw[..., None].expand(-1, -1, -1, num_p))
    rows_masked = torch.where(valid_col[:, :, None, :], rows, float("inf"))
    amin = rows_masked.argmin(dim=-1)                          # (N, J, P)

    b_idx = torch.arange(num_b, device=dev)[:, None, None]
    p_idx = torch.arange(num_p, device=dev)
    accept = (t > 0.0) & ((cw[:, None] == b_idx) |
                          (amin[:, None] == p_idx))
    masked = torch.where(accept, t, float("-inf"))
    chosen = masked.argmax(dim=-1).to(torch.int32)             # (N, B, J)
    has = masked.amax(dim=-1) > 0.0
    chosen = torch.where(has, chosen, -1)

    # ---- fallback: PRN argmax per (box, joint), in image coords ------------
    am = prn_out.reshape(n, num_b, gh * gw, num_j).argmax(dim=2)   # (N, B, J)
    my = (am // gw).float()
    mx = (am % gw).float()
    x_scale = rdiv(gw, torch.ceil(boxes_xywh[..., 2:3]))
    y_scale = rdiv(gh, torch.ceil(boxes_xywh[..., 3:4]))
    fx = mx / x_scale + boxes_xywh[..., 0:1]
    fy = my / y_scale + boxes_xywh[..., 1:2]
    return Assignment(chosen=chosen, active_any=active.any(dim=1).any(dim=-1),
                      fallback_xy=torch.stack([fx, fy], dim=-1), active=active)
