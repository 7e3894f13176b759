"""Shared arithmetic of the per-layer readers."""

from mpn_bench import harness


def idle_share(ctx):
    """Percent of the traced window in which no device operation ran: 100 x
    (1 - the union of the trace's device intervals inside it / its length).
    None without a trace."""
    events = ctx.get("device_events")
    if not events:
        return None
    lo, hi = ctx["trace_t0"], ctx["trace_t1"]
    iv = [(max(s, lo), min(e, hi)) for _, s, e in events if e > lo and s < hi]
    busy, _, _ = harness.union_busy(iv)
    return 100.0 * (1.0 - busy / (hi - lo))


def peak(ctx, key):
    """The data-sheet peak ``key`` of the run's CUDA device; None on the
    CPU, which has no entry.  A CUDA device missing from ``peaks.json``
    stops the run."""
    dev = ctx["device"]
    if dev.type != "cuda":
        return None
    import torch

    kind = torch.cuda.get_device_name(dev)
    row = harness.peaks_for(kind)
    if row is None:
        raise harness.CellError(f"peaks.json has no entry for {kind!r}")
    return row[key]
