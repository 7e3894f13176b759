"""Compare two ``coco-eval --metrics-file`` JSONs (the fast device
defaults against the reference-exact host chain) and the second against
the reference's published baseline (BASELINE.md AP 0.590) — the port's
counterpart of tools/diff_parity_metrics.py, with the same table, options
and exit codes.

Prints a per-stat table and exits non-zero when
- |fast - ref| on any stat exceeds --mode-tol (the two modes implement the
  same protocol and must agree),
- the reference-exact AP falls below --baseline-ap - --baseline-tol,
- one mode produced metrics and the other none.
Two empty files (a dry run's untrained weights find nobody) agree
trivially; the baseline comparison then fails unless --no-baseline.

Usage:
  python -m multiposenet_tpu_torch.tools.diff_parity_metrics FAST.json REF.json \\
      [--baseline-ap 0.590] [--mode-tol 0.005] [--baseline-tol 0.01] \\
      [--no-baseline]   # dry runs on synthetic stand-in data
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("fast_json")
    ap.add_argument("ref_json")
    ap.add_argument("--baseline-ap", type=float, default=0.590)
    ap.add_argument("--mode-tol", type=float, default=0.005)
    ap.add_argument("--baseline-tol", type=float, default=0.01)
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the published-baseline comparison (dry runs "
                         "on synthetic stand-in data)")
    args = ap.parse_args(argv)

    with open(args.fast_json) as f:
        fast = json.load(f)
    with open(args.ref_json) as f:
        ref = json.load(f)

    keys = sorted(set(fast) & set(ref))
    if not keys and (fast or ref):
        print("FAIL: one mode produced metrics and the other none")
        return 1
    if not keys:
        print("NOTE: both modes produced no metrics (empty result sets — "
              "expected only for dry runs with untrained weights); modes "
              "agree trivially")
    bad_mode = []
    print(f"{'stat':<12} {'fast':>8} {'ref-exact':>10} {'delta':>9}")
    for k in keys:
        d = float(fast[k]) - float(ref[k])
        flag = ""
        if abs(d) > args.mode_tol:
            bad_mode.append(k)
            flag = "  <-- modes disagree"
        print(f"{k:<12} {float(fast[k]):8.4f} {float(ref[k]):10.4f} "
              f"{d:9.4f}{flag}")

    rc = 0
    if bad_mode:
        print(f"FAIL: fast vs reference-exact disagree beyond "
              f"{args.mode_tol} on: {', '.join(bad_mode)}")
        rc = 1
    if not args.no_baseline:
        ref_ap = float(ref.get("AP", -1.0))
        floor = args.baseline_ap - args.baseline_tol
        verdict = "PASS" if ref_ap >= floor else "FAIL"
        print(f"baseline: reference-exact AP {ref_ap:.4f} vs published "
              f"{args.baseline_ap:.3f} (floor {floor:.3f}) -> {verdict}")
        if ref_ap < floor:
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
