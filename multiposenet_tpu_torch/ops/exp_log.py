"""``exp`` and ``log`` of float32 tensors within an ulp, taken through float64.

On the CPU PyTorch takes ``torch.exp`` and ``torch.log`` from the Intel MKL
vector library it bundles, which in some runs computes one OpenMP worker
thread's share of a call with its AVX2 "enhanced performance" kernel
instead of the high-accuracy one it was asked for: float32 errors up to
1.4e-4 relative, in some runs and not others (ROADMAP §3, item 7).  Its
float64 kernels, that one included, err by at most 3.3e-9 (exp) and
3.2e-10 (log) relative, so a float32 tensor's exp or log taken through
float64 and rounded back is within 0.56 ulp whichever kernel ran.  The
route is the same on every device: a program exported on the CPU runs it
on the card as the live pipeline does there (a test of the device would
be fixed when the program is traced).  Other dtypes go straight to
``torch.exp`` / ``torch.log``.
"""

from __future__ import annotations

import torch


def _through_f64(fn, x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float32:
        return fn(x.double()).float()
    return fn(x)


def exp(x: torch.Tensor) -> torch.Tensor:
    return _through_f64(torch.exp, x)


def log(x: torch.Tensor) -> torch.Tensor:
    return _through_f64(torch.log, x)
