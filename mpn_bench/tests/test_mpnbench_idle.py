"""The device trace's arithmetic: busy as the union of intervals, idle
gaps, their labels by the host span open at the time, and the idle share
a metric reads."""

import time
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from mpn_bench import harness


def test_union_counts_overlaps_once():
    busy, idle, span = harness.union_busy([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)])
    assert (busy, idle, span) == (4.0, 2.0, 6.0)
    assert harness.union_busy([]) == (0.0, 0.0, 0.0)
    assert harness.union_busy([(1.0, 4.0), (2.0, 3.0)]) == (3.0, 0.0, 3.0)


def test_idle_gaps_inside_a_window():
    gaps = harness.idle_gaps([(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)], 0.0, 8.0)
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 8.0)]
    assert harness.idle_gaps([(0.0, 9.0)], 1.0, 8.0) == []


def test_breakdown_labels_gaps_by_the_open_span():
    spans = harness.Spans()
    spans.rows = [("format", 3.0, 5.0), ("pack", 6.0, 7.5), ("predict", 0.0, 8.0)]
    events = [("conv", 0.0, 3.0), ("conv", 5.0, 6.0), ("nms", 7.5, 8.0)]
    b = harness.breakdown(events, 0.0, 8.0, spans.labeller(("pack", "format", "predict")))
    assert b["device_ops"] == [["conv", 4.0], ["nms", 0.5]]
    assert b["idle_gaps"] == [["format", 2.0], ["pack", 1.5]]


def test_spans_total_in_a_window():
    spans = harness.Spans()
    f = spans.wrap("pack", lambda x: x + 1)
    assert f(1) == 2
    spans.on = False
    assert f(2) == 3
    assert len(spans.rows) == 1
    spans.rows = [("pack", 0.0, 1.0), ("pack", 2.0, 2.5), ("pack", 9.0, 10.0)]
    assert spans.total("pack", 0.0, 5.0) == 1.5


@pytest.mark.parametrize("reader", ["device_idle.serve", "device_idle.train"])
def test_idle_share_reader(reader):
    ctx = {"trace_t0": 10.0, "trace_t1": 20.0, "device": torch.device("cpu"),
           "device_events": [("a", 9.0, 12.0), ("b", 11.0, 14.0), ("c", 19.0, 25.0)]}
    # busy inside the window: 10-14 and 19-20, 5 s of 10; which cells read
    # it is BENCHMARK.json's to say, not the reader's
    assert harness.read_metric(reader, ctx) == pytest.approx(50.0)
    assert harness.read_metric(reader, dict(ctx, device_events=[])) is None


def test_metrics_of_a_cell():
    bench = harness.load_bench(pending=True)
    serve = {m["name"] for m in harness.cell_metrics(bench, "r101-serve-b64", False)}
    assert serve == {"serve_images_per_s", "serve_batch_p95_ms", "setup_s"}
    traced = {m["name"] for m in harness.cell_metrics(bench, "r50-train-det", True)}
    assert traced == {"device_idle.train", "mfu.train"}
    # a pending cell is no cell of BENCHMARK.json itself
    assert "r101-serve-b64" not in {w["name"] for w in harness.load_bench()["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


class FakeProfiler:
    """A CUDA trace as the profiler gives it: a kernel lands on the device's
    clock, the host's shifted by ``offset_s``, and is kept only where it
    ends before the stop; the first ``drop_first`` device records are lost,
    and ``drop`` loses that clock mark (1: the first, 2: the last)."""

    def __init__(self, drop_first: int = 0, drop: int = 0, offset_s: float = 0.0):
        self.drop_first, self.drop, self.offset_s = drop_first, drop, offset_s
        self.kernels = []

    def start(self):
        self.t_start = time.perf_counter()

    def stop(self):
        self.t_stop = time.perf_counter()

    def launch(self, name: str):
        t = time.perf_counter() + self.offset_s
        self.kernels.append((name, t, t + 2e-6))

    def events(self):
        out, marks = [], 0
        for name, s, e in self.kernels[self.drop_first:]:
            if e > self.t_stop:
                continue
            if "spin_kernel" in name:
                marks += 1
                if marks == self.drop:
                    continue
            us = lambda t: (t - self.t_start) * 1e6  # noqa: E731
            out.append(SimpleNamespace(name=name, device_type=DeviceType.CUDA, cpu_parent=None,
                                       time_range=SimpleNamespace(start=us(s), end=us(e))))
        return out


def _fake_trace(prof: FakeProfiler):
    """A CUDA ``DeviceTrace`` over ``prof``, with two kernels in its window."""
    tr = harness.DeviceTrace(torch.device("cpu"))
    tr.cuda, tr.prof = True, prof
    fill = SimpleNamespace(fill_=lambda v: prof.launch("elementwise_kernel<FillFunctor<float>>"))
    tr.torch = SimpleNamespace(
        empty=lambda *a, **k: fill,
        cuda=SimpleNamespace(synchronize=lambda: None,
                             _sleep=lambda cycles: prof.launch("spin_kernel(long)")))
    tr.start()
    launched = []
    for name in ("gemm", "relu"):
        time.sleep(0.002)
        launched.append((name, time.perf_counter()))
        prof.launch(name)
    time.sleep(0.002)
    tr.stop()
    return tr, launched


@pytest.mark.parametrize("drop_first,offset_s", [(0, 0.0), (1, 0.0), (40, 0.0),
                                               (harness.PRIME_KERNELS, 0.0), (3, 0.005)])
def test_the_clock_marks_survive_what_the_profiler_drops(drop_first, offset_s, capsys):
    """The profiler may drop a trace's first device records, and those that
    end after its stop on a device clock running ahead of the host's: the
    fills ahead of the first mark take the one loss, the wait after the
    last the other, and the window reads as in a trace that lost nothing,
    its kernels tied back to their launches."""
    tr, launched = _fake_trace(FakeProfiler(drop_first=drop_first, offset_s=offset_s))
    events = tr.events()
    assert [n for n, _, _ in events] == [n for n, _ in launched]
    for (_, s, e), (_, t) in zip(events, launched):
        assert s == pytest.approx(t, abs=2e-4) and e - s == pytest.approx(2e-6, abs=1e-7)
    err = capsys.readouterr().err
    assert f"dropped {drop_first} of the {harness.PRIME_KERNELS} fills" in err
    assert "the device's clock parted from the host's by " in err
    assert tr.prof.t_stop - tr.host_marks[-1] >= harness.END_WAIT_S


@pytest.mark.parametrize("drop_first,drop,offset_s", [
    (0, 1, 0.0), (0, 2, 0.0), (harness.PRIME_KERNELS + 1, 0, 0.0),
    (0, 0, 2 * harness.END_WAIT_S)])
def test_a_trace_that_lost_a_clock_mark_is_never_read(drop_first, drop, offset_s):
    tr, _ = _fake_trace(FakeProfiler(drop_first=drop_first, drop=drop, offset_s=offset_s))
    with pytest.raises(harness.CellError, match="two clock marks"):
        tr.events()
