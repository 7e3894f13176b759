"""Assert an OKS AP floor, and zero capacity truncation, on a gate run —
the port's counterpart of tools/check_ap_floor.py.

- A metrics file (``coco-eval --metrics-file``) whose AP is below the
  floor, or that has no AP, fails.
- A ``coco-eval`` log with a WARNING-level capacity-truncation line of the
  port's logger fails.  Under the gate, escalation re-dispatches every
  saturated crowd image at a larger tier, so truncation is impossible by
  design: a "dropped", "truncated" or "saturated" WARNING means the output
  differs from the reference's unbounded processing (tester.py:338-350,
  400-406).  The INFO lines of the intended escalation ("re-dispatching",
  "escalating") pass.

The warnings come from engine/evaluator.py (peaks over the per-joint
capacity dropped, boxes over the PRN capacity dropped, a saturated
capacity that may have truncated) and engine/grouped_eval.py.

Usage: python -m multiposenet_tpu_torch.tools.check_ap_floor METRICS_JSON FLOOR [COCO_EVAL_LOG]
"""

from __future__ import annotations

import json
import re
import sys

# anchored on the port's logger names (utils/logging.py format:
# "... WARNING multiposenet_tpu_torch[.module]: ..."), so that another
# logger's WARNING line holding one of the words cannot fail the gate
TRUNCATION_RE = re.compile(
    r"WARNING\s+multiposenet_tpu_torch[\w.]*:.*(dropped|truncated|saturated)")


def check(metrics_path: str, floor: float) -> bool:
    with open(metrics_path) as f:
        m = json.load(f)
    ap = float(m.get("AP", -1.0))
    ok = ap >= floor
    print(f"synth-E2E gate: AP={ap:.3f} floor={floor:g} -> "
          f"{'PASS' if ok else 'FAIL'}")
    return ok


def truncation_lines(log_path: str) -> list:
    with open(log_path, errors="replace") as f:
        return [line.rstrip() for line in f if TRUNCATION_RE.search(line)]


def check_no_truncation(log_path: str) -> bool:
    bad = truncation_lines(log_path)
    if bad:
        print("synth-E2E gate: FAIL — capacity truncation under "
              "escalation:", file=sys.stderr)
        for line in bad:
            print("  " + line, file=sys.stderr)
        return False
    print("synth-E2E gate: zero capacity-truncation warnings")
    return True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ok = check(argv[0], float(argv[1]))
    if len(argv) > 2:
        ok = check_no_truncation(argv[2]) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
