"""Host ms per batch in the predictor's pack (``_pack``) and the host tail
(``format_pose_batch``), from the harness's spans of the traced window."""


def read(ctx):
    sp = ctx["spans"]
    lo, hi = ctx["t0"], ctx["t_end"]
    return 1e3 * (sp.total("pack", lo, hi) + sp.total("format", lo, hi)) / ctx["batches"]
