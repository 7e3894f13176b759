"""AP ablation over the eval path's switches — the port's counterpart of
tools/ap_ablation.py.

Runs the whole ``coco-eval`` protocol (5 scales + flip) once per switch on
a trained checkpoint (normally the synthetic gate's PRN-stage best) and
reports each switch's AP and AP50 against the run with every default:
protocol-level evidence that each numerics-only default holds the AP.

With ``--assert-tol`` it exits non-zero when a bounded switch moves AP by
more than the tolerance, or an exact one changes any summary statistic.
The JAX tool's ``xla_nms`` row has no counterpart: kernel K1 serves every
path of the port, and its plain twin is the CPU path (it is held against
the twin bit for bit instead); the table says so.

Usage:
  python -m multiposenet_tpu_torch.tools.ap_ablation --coco-root ROOT \\
      --ckpt CKPT [--backbone resnet50] [--out-dir DIR] [--assert-tol 0.02] \\
      [--only name,name] [--max-images N] [--jobs N] [--device cpu]

Writes each switch's metrics json and ``ablation_table.md`` under
--out-dir and prints the table.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys

# (name, extra CLI flags, bounded: |dAP| <= tol asserted with --assert-tol).
# The host chain runs the reference's host implementations end to end; it
# is bounded too.
TOGGLES = [
    ("default", [], False),
    ("bf16", ["--bf16"], True),
    ("fold_bn", ["--fold-bn"], True),
    ("host_chain", ["--host-resize", "--host-peaks", "--host-image-resize",
                    "--host-grouping"], True),
    ("host_grouping", ["--host-grouping"], True),
    ("no_refine", ["--no-refine"], False),  # refinement moves AP in the
                                            # reference too: reported only
]
# switches whose output must equal the default run's in every summary
# statistic: the host grouping is the device grouping's twin, on the same
# heatmaps (deterministic cuDNN in every run)
EXACT = {"host_grouping"}
NO_COUNTERPART = {"xla_nms": "no counterpart: K1 serves every path"}


def run_eval(args, name: str, flags, out_dir: str) -> dict:
    metrics = os.path.join(out_dir, f"metrics_{name}.json")
    cmd = [sys.executable, "-m", "multiposenet_tpu_torch.cli", "coco-eval",
           "--coco-root", args.coco_root, "--backbone", args.backbone,
           "--ckpt", args.ckpt, "--deterministic",
           "--result-file", os.path.join(out_dir, f"results_{name}.json"),
           "--metrics-file", metrics] + list(flags)
    if args.max_images:
        cmd += ["--max-images", str(args.max_images)]
    if args.inp_size:
        cmd += ["--inp-size", str(args.inp_size)]
    env = dict(os.environ)
    if args.device == "cpu":
        env["MPN_PLATFORM"] = "cpu"
    print(f"== ablation '{name}': {' '.join(flags) or '(defaults)'}",
          flush=True)
    with open(os.path.join(out_dir, f"coco_eval_{name}.log"), "w") as log:
        r = subprocess.run(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)
    if r.returncode:
        raise RuntimeError(f"ablation '{name}' failed (rc {r.returncode}); "
                           f"see {log.name}")
    with open(metrics) as f:
        return json.load(f)


def table(rows: dict) -> str:
    """The markdown table of ``rows`` {name: (metrics, bounded)} against
    rows["default"]."""
    base = rows["default"][0]
    lines = ["| switch | AP | dAP | AP50 | dAP50 | bounded |",
             "|---|---|---|---|---|---|"]
    for name, _, _ in TOGGLES:
        if name not in rows:
            continue
        m, bounded = rows[name]
        ap_v, ap50 = float(m.get("AP", -1)), float(m.get("AP50", -1))
        dap = ap_v - float(base.get("AP", -1))
        dap50 = ap50 - float(base.get("AP50", -1))
        kind = "exact" if name in EXACT else "yes" if bounded else "no"
        lines.append(f"| {name} | {ap_v:.4f} | {dap:+.4f} | {ap50:.4f} "
                     f"| {dap50:+.4f} | {kind} |")
    for name, why in NO_COUNTERPART.items():
        lines.append(f"| {name} | - | - | - | - | {why} |")
    return "\n".join(lines)


def failures(rows: dict, tol: float) -> list:
    """(name, dAP or why) of each switch beyond ``tol`` or not identical."""
    base = rows["default"][0]
    out = []
    for name, (m, bounded) in rows.items():
        dap = float(m.get("AP", -1)) - float(base.get("AP", -1))
        if bounded and abs(dap) > tol:
            out.append((name, dap))
        if name in EXACT and m != base:
            diff = sorted(k for k in set(m) | set(base) if m.get(k) != base.get(k))
            out.append((name, f"not protocol-identical: {diff}"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coco-root", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--out-dir", default="./extra/ablation")
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--inp-size", type=int, default=None,
                    help="eval base size (the CLI's default when omitted)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--assert-tol", type=float, default=None,
                    help="fail if a bounded switch moves AP more than this")
    ap.add_argument("--jobs", type=int, default=1,
                    help="switches evaluated at once (separate processes)")
    ap.add_argument("--only", default=None,
                    help="comma-separated switch names to run (plus "
                         "'default', always run)")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    only = set(args.only.split(",")) | {"default"} if args.only else None
    names = {n for n, _, _ in TOGGLES}
    if only and only - names:
        ap.error(f"unknown switch(es) {sorted(only - names)}; "
                 f"choose from {sorted(names)}")
    todo = [(n, f, b) for n, f, b in TOGGLES if not only or n in only]
    # each run is its own process on the card; --jobs runs several at once
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as ex:
        futs = {n: (ex.submit(run_eval, args, n, f, args.out_dir), b)
                for n, f, b in todo}
        rows = {n: (fut.result(), b) for n, (fut, b) in futs.items()}

    text = table(rows)
    print(text)
    with open(os.path.join(args.out_dir, "ablation_table.md"), "w") as f:
        f.write(text + "\n")
    with open(os.path.join(args.out_dir, "ablation.json"), "w") as f:
        json.dump({k: v[0] for k, v in rows.items()}, f, indent=2)
    if args.assert_tol is None:
        return 0
    bad = failures(rows, args.assert_tol)
    if bad:
        print(f"FAIL: switches beyond |dAP| <= {args.assert_tol} or not "
              f"identical: {bad}")
        return 1
    print(f"PASS: every bounded switch within |dAP| <= {args.assert_tol}, "
          f"the exact ones identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
