"""The detection train step's share of the device's TF32 dense peak (the
configuration's precision), percent: the frozen reference step's FLOPs
(trunk forward, RetinaNet pyramid and heads forward and backward) per
image x images per second of the traced window / the data-sheet peak."""

from mpn_bench import harness
from mpn_bench.reference import flops

_shares = harness.load_module(harness.BENCH_DIR / "metrics" / "_shares.py")


def read(ctx):
    peak = _shares.peak(ctx, "tf32_dense_flops")
    if peak is None:
        return None
    per_image = flops.detection_step_flops(ctx["config"], ctx["batch"]) / ctx["batch"]
    rate = ctx["trace_images"] / (ctx["trace_t1"] - ctx["trace_t0"])
    return 100.0 * per_image * rate / peak
