"""Benchmark of the PyTorch/CUDA port ``multiposenet_tpu_torch``: one run of
one cell of ``BENCHMARK.json``.

    python3 mpn_bench/run.py --workload r50-train-det --seed 7 --seconds 40 --trace 0

Makes the cell's weights and inputs from ``--seed``, warms up the shapes
the cell uses (set-up), measures for ``--seconds`` seconds, checks what the
timed path produced against the plain reference (``checks.py``), and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit
(also the last lines of standard error).

Exits non-zero and prints no result when no CUDA device is present, when
the cell needs more devices than there are, or when the process holds a
module of JAX or of the JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path

_ROOT = str(Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from mpn_bench import harness  # noqa: E402

harness.pin_caches()


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, start_time: float, files=None) -> dict:
    """One run of ``workload`` on ``device`` -> the result line's dict
    (``checks`` included).  ``files`` = (cell, config, traffic) overrides
    the cell's files (the tests' tiny cells)."""
    cell, cfg, spec = files or harness.cell_files(bench, workload)
    driver = importlib.import_module(f"mpn_bench.drivers.{spec['kind']}")
    ctx = driver.run(cfg, spec, seed, seconds, trace, device, start_time)
    ctx["trace"] = trace
    metrics = {}
    for m in harness.cell_metrics(bench, cell["name"], trace):
        # BENCHMARK.json's lists decide which metrics the cell reports; a
        # reader returns None only where its source is absent from the run
        # (a kernel that did not launch, a CPU device without peaks)
        value = harness.read_metric(m["name"], ctx)
        if value is None:
            print(f"metric {m['name']}: nothing to read in this run, left out",
                  file=sys.stderr)
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = harness.device_record(device, ctx["memory_peak"])
    if trace:
        busy, _, _ = harness.union_busy([(s, e) for _, s, e in ctx["device_events"]])
        dev["busy_s"] = busy
        dev["window_s"] = ctx["trace_hi"] - ctx["trace_lo"]
    result = {"correct": not harness.checks_failed(ctx["checks"]),
              "attempted": ctx["attempted"], "failed": ctx["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = ctx["breakdown"]
    result["info"] = ctx["check_info"]
    result["checks"] = ctx["checks"]
    return result


def main(argv=None) -> int:
    start = harness.process_start_time()
    args = parse(argv)
    bench = harness.load_bench()
    cell, _, _ = harness.cell_files(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), start)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded forbidden modules: {', '.join(found)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
