"""K1's (greedy NMS suppression, ``nms_suppress_kernel``) share of its
roofline, percent: the least time of its launches' work at their shapes
(``rooflines/k1.py``: the larger of operations over the float32 peak and
bytes over the memory bandwidth) over K1's device time in the trace."""

from mpn_bench import harness

_shares = harness.load_module(harness.BENCH_DIR / "metrics" / "_shares.py")


def read(ctx):
    lo, hi = ctx["trace_t0"], ctx["trace_t1"]
    k1 = [(s, e) for n, s, e in ctx["device_events"]
          if "nms_suppress" in n and s >= lo and e <= hi]
    fp32, hbm = _shares.peak(ctx, "fp32_flops"), _shares.peak(ctx, "hbm_bytes_per_s")
    # no launch in the window: the kernel is off the path, and its share
    # of the roofline is silent
    if not k1 or fp32 is None:
        return None
    s = ctx["config"]["serve"]
    ops, nbytes = harness.load_roofline("k1").work(ctx["batch"], s["max_detections"])
    least = max(ops / fp32, nbytes / hbm) * len(k1)
    return 100.0 * least / sum(e - s for s, e in k1)
