"""The serving step's share of the device's bf16 dense peak, percent: the
frozen reference forward's FLOPs per image (counted once, independent of
how the program computes them) x images per second of the traced window /
the data-sheet peak."""

from mpn_bench import harness
from mpn_bench.reference import flops

_shares = harness.load_module(harness.BENCH_DIR / "metrics" / "_shares.py")


def read(ctx):
    peak = _shares.peak(ctx, "bf16_dense_flops")
    if peak is None:
        return None
    rate = ctx["trace_images"] / (ctx["trace_t1"] - ctx["trace_t0"])
    return 100.0 * flops.serve_flops_per_image(ctx["config"]) * rate / peak
