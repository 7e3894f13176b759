"""Device idle share of the training window, percent (device trace)."""

from mpn_bench import harness

_shares = harness.load_module(harness.BENCH_DIR / "metrics" / "_shares.py")


def read(ctx):
    return _shares.idle_share(ctx)
