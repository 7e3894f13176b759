"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process:

- the program's: a short run of the cell per seed, as ``run.py`` makes it
  (the window's checked batches or the first three train steps);
- the control's: the reference in the next precision below the
  configuration's in the program's place (serving, bf16: float8 e4m3 with
  per-tensor scales on every convolution's and linear layer's operands;
  training, float32 with TF32 convolutions: bf16 autocast);
- a training cell's fault: half of each batch left out, the mean over the
  rest (the reference so broken stands in for the program); the other
  fault, a state left unchanged, reads 1 by the measure and needs no run;
- for a training seed that is both a program's and a control's, the
  control and the fault also at the step after the window, from the
  program's parameters there (``late_loss_gap``).

    python3 mpn_bench/readings.py --workload r101-serve-b64 --seeds 1-12 \
        --control-seeds 1-3 [--seconds 3] [--out readings.json]

Prints one JSON line per reading and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = str(Path(__file__).resolve().parent.parent)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from mpn_bench import harness  # noqa: E402

harness.pin_caches()


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def values(checks: dict, info: dict) -> dict:
    """Every number the comparison computed, limited or not yet."""
    out = {k: c["value"] for k, c in checks.items()}
    out.update(info.get("numbers", {}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="readings.json")
    ap.add_argument("--cpu", action="store_true", help="tiny cell on the CPU")
    args = ap.parse_args(argv)

    import torch

    from mpn_bench import checks, traffic
    from mpn_bench.drivers import detection_batches, frame_stream

    if args.cpu:
        from mpn_bench.tests import tiny

        cell, cfg, spec = tiny.cell("serve" if "serve" in args.workload else "train")
        device = torch.device("cpu")
    else:
        bench = harness.load_bench(pending=True)
        cell, cfg, spec = harness.cell_files(bench, args.workload)
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    driver = {"frame_stream": frame_stream,
              "detection_batches": detection_batches}[spec["kind"]]
    rows = []

    def report(row):
        row["device"] = (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu")
        rows.append(row)
        print(json.dumps(row), flush=True)

    control_seeds = seeds(args.control_seeds)
    for s in seeds(args.seeds):
        t0 = time.time()
        ctx = driver.run(cfg, spec, s, args.seconds, False, device, time.time())
        info = {k: v for k, v in ctx["check_info"].items() if k != "numbers"}
        report({"who": "program", "seed": s,
                "numbers": values(ctx["checks"], ctx["check_info"]),
                "info": info, "s": time.time() - t0})
        if "late" in ctx and s in control_seeds:
            # the step after the window, from the program's state there,
            # with the reference in the control's precision or broken
            from mpn_bench import weights

            sd = weights.make_state_dict(cfg, s, device, "train_detection")
            late = ctx["late"]
            base = checks.late_loss(cfg, sd, late, device)
            for who, kw in (("control_bf16", {"autocast_dtype": torch.bfloat16}),
                            ("fault_half_batch", {"half_batch": True})):
                got = checks.late_loss(cfg, sd, late, device, **kw)
                report({"who": who, "seed": s,
                        "numbers": {"late_loss_gap": abs(got - base) / abs(base)},
                        "info": {"late_loss_ref": base, "late_loss": got},
                        "s": time.time() - t0})
            del sd, late
        del ctx
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for s in seeds(args.control_seeds):
        t0 = time.time()
        if spec["kind"] == "frame_stream":
            spans = harness.Spans()
            spans.on = False
            srv = frame_stream.Serving(cfg, spec, s, device, spans)
            rec = srv.serve(min(args.seconds, 1.0))
            captured, sd, frames, b = srv.captured, srv.state_dict, srv.frames, srv.batch
            srv.predictor = None
            del srv
            got, info = checks.serve_numbers(cfg, captured, rec["served"], frames, sd,
                                             b, device, control=checks.fp8_quant)
            report({"who": "control_fp8", "seed": s, "numbers": values(got, info),
                    "info": info, "s": time.time() - t0})
            del captured, sd
        else:
            from mpn_bench import weights

            t = cfg["train_detection"]
            sd = weights.make_state_dict(cfg, s, device, "train_detection")
            batches = traffic.detection_pool(spec, s, t["inp_size"], device)[:3]
            lr = t["init_lr"]
            for who, kw in (("control_bf16", {"autocast_dtype": torch.bfloat16}),
                            ("fault_half_batch", {"half_batch": True})):
                got, info = checks.train_numbers(cfg, None, sd, batches, device, lr,
                                                 ref_run=kw)
                report({"who": who, "seed": s, "numbers": values(got, info), "info": info,
                        "s": time.time() - t0})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
