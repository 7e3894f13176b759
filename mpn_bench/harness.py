"""The benchmark's machinery: caches, the cell's files, spans, the device
trace, the metric readers and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes, precisions, weight init and
  the limits of the comparison that decides ``correct``;
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  driver ``drivers/<kind>.py`` that runs it;
- ``metrics/<metric>.py``: ``read(ctx) -> float | None`` for every metric,
  end to end and per layer;
- ``rooflines/<kernel>.py``: the least work of a kernel at its shapes;
- ``reference/trunks/<family>.py``: the reference's trunk for each
  configuration ``backbone`` named in its ``NAMES``;
- ``pending/<cell>.json``: the ``BENCHMARK.json`` entries of a cell kept
  out of it for now, for the readings and the tests.
"""

from __future__ import annotations

import bisect
import functools
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / "_cache"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "multiposenet_tpu")


class CellError(RuntimeError):
    """The cell cannot run: a missing file, a missing device, a bad spec."""


def pin_caches() -> None:
    """Point every build and kernel cache at fixed directories inside the
    checkout; call before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_start_time() -> float:
    """The process's start on the ``time.time()`` clock, from /proc; the
    interpreter's first import of this module where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _IMPORTED_AT


_IMPORTED_AT = time.time()


def phases(start: float, marks: Sequence[Tuple[str, float]]) -> Dict[str, float]:
    """Seconds of each set-up phase from ``(name, time it ended)`` marks;
    the first phase runs from the process's start."""
    out, prev = {}, start
    for name, t in marks:
        out[name] = t - prev
        prev = t
    return out


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port must never load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


# ------------------------------------------------------------------ files

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_bench(pending: bool = False) -> dict:
    """``BENCHMARK.json``; with ``pending``, plus the entries of the cells
    kept out of it for now (``pending/<cell>.json``), which the readings
    and the tests still run."""
    bench = load_json(ROOT / "BENCHMARK.json")
    if pending:
        for path in sorted((BENCH_DIR / "pending").glob("*.json")):
            extra = load_json(path)
            for key in ("workloads", "end_to_end", "per_layer"):
                bench[key] = bench[key] + extra.get(key, [])
    return bench


def cell_files(bench: dict, workload: str) -> Tuple[dict, dict, dict]:
    """(cell, config, traffic) of ``workload`` in ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones with
    ``trace`` off, its per-layer ones with it on.  A metric without a
    ``workloads`` list is reported in every cell (per-layer: every cell that
    reports the end-to-end metric it moves)."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"mpn_bench_dyn.{path.parent.name}.{path.stem}", path)
    if spec is None:
        raise CellError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, ctx: dict) -> Optional[float]:
    return load_module(BENCH_DIR / "metrics" / f"{name}.py").read(ctx)


def load_roofline(kernel: str):
    return load_module(BENCH_DIR / "rooflines" / f"{kernel}.py")


def peaks_for(kind: str) -> Optional[dict]:
    """The data-sheet peaks of the device named ``kind``, or None."""
    table = load_json(BENCH_DIR / "peaks.json")
    return table.get(kind)


def derive_seed(seed: int, salt: int) -> int:
    """An independent 63-bit seed for one use of ``--seed``."""
    import numpy as np

    return int(np.random.SeedSequence([int(seed) % (2 ** 63), salt]
                                      ).generate_state(2, np.uint64)[0] >> 1)


# ------------------------------------------------------------------ spans

class Spans:
    """Host spans on the ``time.perf_counter`` clock, kept in memory:
    ``(name, start, end)`` with no nesting of one name in itself."""

    def __init__(self):
        self.rows: List[Tuple[str, float, float]] = []
        self.on = True

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.rows.append((name, t0, time.perf_counter()))
        return spanned

    def total(self, name: str, lo: float = -math.inf, hi: float = math.inf) -> float:
        return sum(e - s for n, s, e in self.rows if n == name and s >= lo and e <= hi)

    def labeller(self, order: Sequence[str]):
        """``label(t)``: the innermost span open at host time ``t``, by
        ``order`` (innermost first), or ``"other"``."""
        index = {}
        for name in order:
            iv = sorted((s, e) for n, s, e in self.rows if n == name)
            index[name] = ([s for s, _ in iv], iv)

        def label(t: float) -> str:
            for name in order:
                starts, iv = index[name]
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and iv[i][1] >= t:
                    return name
            return "other"
        return label


# ------------------------------------------------------------------ device trace

def union_busy(intervals: Sequence[Tuple[float, float]]) -> Tuple[float, float, float]:
    """(busy, idle, span) of [start, end) intervals: busy is the length of
    their union, idle the gaps inside the span (overlapping kernels count
    once)."""
    if not intervals:
        return 0.0, 0.0, 0.0
    iv = sorted(intervals)
    busy = idle = 0.0
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            idle += s - cur_e
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, idle, max(e for _, e in iv) - iv[0][0]


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The gaps of [lo, hi] that no interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(s, e) for s, e in gaps if e > s]


MARK = "mpn_bench_mark"
# The profiler drops device records near either end of a CUDA trace: at
# the start the first few (a few dozen once the process has traced many
# times, whether or not the card idled after the start), at the stop the
# last ones where its conversion of the device's clock to the host's runs
# ahead (the two part by up to tens of milliseconds over a few seconds).  A
# clock mark at either end was lost with them.  So PRIME_KERNELS
# one-element fills go ahead of the first mark, to take the loss at the
# start, and the host waits END_WAIT_S after the last mark before it stops
# the profiler; ``events`` reads nothing outside the marks, and says how
# many fills were dropped.
PRIME_KERNELS = 1024
PRIME_NAME = "FillFunctor"   # in the name of ``fill_``'s kernel
END_WAIT_S = 0.5


class DeviceTrace:
    """``torch.profiler`` over the measured window.  On a GPU it records the
    device's activity alone; a marker kernel (``torch.cuda._sleep``) launched
    after a synchronise at each end ties the device's clock to the host's,
    so that device events land on the ``perf_counter`` clock of the spans;
    ``PRIME_KERNELS`` fills go ahead of the first, and the profiler stops
    ``END_WAIT_S`` after the last.  On the CPU the "device events" are the
    top-level CPU ops, marked by a ``record_function`` at each end."""

    def __init__(self, device):
        import torch

        self.torch = torch
        self.device = device
        self.cuda = device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CUDA if self.cuda
                else torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.host_marks: List[float] = []

    def _mark(self):
        torch = self.torch
        if self.cuda:
            torch.cuda.synchronize()
            self.host_marks.append(time.perf_counter())
            torch.cuda._sleep(2000)
            torch.cuda.synchronize()
        else:
            self.host_marks.append(time.perf_counter())
            with torch.profiler.record_function(MARK):
                pass

    def start(self):
        self.prof.start()
        if self.cuda:
            buf = self.torch.empty(1, device=self.device)
            for _ in range(PRIME_KERNELS):
                buf.fill_(0.0)
        self._mark()

    def stop(self):
        self._mark()
        if self.cuda:
            time.sleep(END_WAIT_S)
        self.prof.stop()

    def events(self) -> List[Tuple[str, float, float]]:
        """``(name, start, end)`` of every device event between the two
        marks, in seconds on the host's ``perf_counter`` clock."""
        from torch.autograd import DeviceType

        raw = []
        for e in self.prof.events():
            if self.cuda:
                if e.device_type != DeviceType.CUDA:
                    continue
            elif e.device_type != DeviceType.CPU or e.cpu_parent is not None:
                continue
            raw.append((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6))
        marks = sorted(s for n, s, _ in raw
                       if ("spin_kernel" in n if self.cuda else n == MARK))
        if len(marks) < 2:
            raise CellError("the trace lacks its two clock marks")
        d0, d1 = marks[0], marks[-1]
        if self.cuda:
            kept = sum(1 for n, s, _ in raw if s < d0 and PRIME_NAME in n)
            print(f"device trace: the profiler dropped {PRIME_KERNELS - kept} of the "
                  f"{PRIME_KERNELS} fills ahead of the first clock mark", file=sys.stderr)
        h0, h1 = self.host_marks[0], self.host_marks[-1]
        if self.cuda:
            print(f"device trace: over the {h1 - h0:.3f} s between the clock marks the "
                  f"device's clock parted from the host's by {1e3 * ((d1 - d0) - (h1 - h0)):+.3f}"
                  f" ms (the profiler stops {END_WAIT_S} s after the last)", file=sys.stderr)
        rate = (h1 - h0) / (d1 - d0)
        out = []
        for n, s, e in raw:
            if s <= d0 or s >= d1 or n == MARK:
                continue
            out.append((n, h0 + (s - d0) * rate, h0 + (e - d0) * rate))
        return out


def breakdown(events: Sequence[Tuple[str, float, float]], lo: float, hi: float,
              label) -> dict:
    """The ten device ops that took most time, and the idle time inside
    [lo, hi] summed by the host span open at each gap's midpoint."""
    by_name: Dict[str, float] = {}
    for n, s, e in events:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    by_label: Dict[str, float] = {}
    for s, e in idle_gaps([(s, e) for _, s, e in events], lo, hi):
        key = label(0.5 * (s + e))
        by_label[key] = by_label.get(key, 0.0) + (e - s)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"device_ops": top(by_name), "idle_gaps": top(by_label)}


# ------------------------------------------------------------------ device

def device_record(device, memory_peak: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(memory_peak)}


# ------------------------------------------------------------------ result

def checks_failed(checks: Dict[str, dict]) -> List[str]:
    """Names of compared numbers above their limits (or not finite)."""
    return [k for k, c in checks.items()
            if not (math.isfinite(c["value"]) and c["value"] <= c["limit"])]


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output, ``checks`` last."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
