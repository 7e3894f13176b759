"""The device trace's arithmetic: busy as the union of intervals, idle
gaps, their labels by the host span open at the time, and the idle share
a metric reads."""

import pytest
import torch

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
