"""Driver of ``frame_stream`` traffic: one client streams frames through the
port's serving front, ``BatchPredictor.predict_stream``, in a closed loop.

Set-up draws the weights on the device, builds the predictor, makes the
frame pool and serves two batches (the cuDNN plans, K1's build or load).
The window then serves batches until ``seconds`` have passed and ends when
the batch in flight has come back.  With ``trace`` the window runs under
the device trace with host spans around the predictor's calls: ``pack``
(each ``_pack``), ``dispatch`` (the pipeline's enqueue), ``fetch`` and
``format`` (``_finish_chunk`` and ``format_pose_batch`` inside it); what is
left of ``predict`` is the pinned buffer and the upload, ``upload``.

Probes on the pipeline keep, for a few batches drawn from the seed and for
the window's last batch, the packed images, the forward's outputs, the
detections, the peaks, the PRN stage's outputs and the served person
lists; ``checks.serve_numbers`` holds them against the reference once the
window has closed and the program is freed.
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import time
from typing import Dict, List

import numpy as np
import torch

from mpn_bench import checks, harness, traffic, weights

SALT_SAMPLE = 21
SAMPLED_BATCHES = 2          # drawn among the window's first SAMPLE_RANGE
SAMPLE_RANGE = 24
SPAN_ORDER = ("pack", "format", "fetch", "dispatch", "upload")


def port_config(cfg: dict):
    from multiposenet_tpu_torch import config as pc

    s = cfg["serve"]
    c = pc.Config()
    return dataclasses.replace(
        c,
        model=pc.ModelConfig(
            backbone=cfg["backbone"], num_joints=cfg["num_joints"],
            fpn_channels=cfg["fpn_channels"], num_anchors=cfg["num_anchors"],
            num_classes=cfg["num_classes"], prior=cfg["prior"],
            prn_node_count=cfg["prn_node_count"], prn_coeff=cfg["prn_coeff"],
            compute_dtype=getattr(torch, s["compute_dtype"])),
        detection=dataclasses.replace(
            c.detection, score_thresh=s["score_thresh"], nms_thresh=s["nms_thresh"],
            test_score_thresh=s["test_score_thresh"],
            max_detections=s["max_detections"]),
        peaks=dataclasses.replace(
            c.peaks, thre1=s["peak_thresh"], max_peaks_per_joint=s["max_peaks"],
            win_size=s["peak_window"]),
        prn=dataclasses.replace(c.prn, max_people=s["max_people"],
                                in_thres=s["prn_in_thres"],
                                score_window=s["prn_window"]),
        data=dataclasses.replace(c.data, feat_stride=cfg["feat_stride"]),
        eval=dataclasses.replace(c.eval, inp_size=s["inp_size"]))


class Serving:
    """The program under test and the probes on its timed path."""

    def __init__(self, cfg: dict, spec: dict, seed: int, device, spans: harness.Spans):
        from multiposenet_tpu_torch.engine import predictor as pred_mod

        self.batch = int(spec["batch"])
        self.marks = [("imports", time.time())]
        self.state_dict = weights.make_state_dict(cfg, seed, device, "serve")
        self.marks.append(("draw", time.time()))
        self.frames = traffic.frame_pool(spec, seed, device)
        self.marks.append(("traffic", time.time()))
        n = int(cfg["serve"]["calibrate"]["frames"])
        self.cls_bias = weights.calibrate_classifier(
            cfg, self.state_dict, checks.pack(self.frames[:n], cfg["serve"]["inp_size"],
                                              device))
        self.marks.append(("weights", time.time()))
        self.predictor = pred_mod.BatchPredictor(
            port_config(cfg), state_dict=self.state_dict,
            batch_size=self.batch, device=device)
        self.marks.append(("model", time.time()))
        rng = np.random.default_rng(harness.derive_seed(seed, SALT_SAMPLE))
        # window batches whose outputs are checked, besides the last one
        self.sample = set(int(i) for i in rng.choice(
            SAMPLE_RANGE, SAMPLED_BATCHES, replace=False))
        self.captured: Dict = {}
        self.capturing = False
        self._calls = 0
        self._install(pred_mod, spans)

    def _install(self, pred_mod, sp: harness.Spans):
        p = self.predictor
        pipe = p._pipeline
        fwd, prn_orig = pipe.forward, pipe.prn
        cur: dict = {}

        def forward(images):
            cur["forward"] = fwd(images)
            return cur["forward"]

        def prn(*args):
            cur["prn"] = prn_orig(*args)
            return cur["prn"]

        def pipeline(images, scales):
            out = pipe(images, scales)
            if self.capturing:
                i = self._calls
                self._calls += 1
                rec = {"images": images, "forward": cur["forward"],
                       "out": out[0], "prn": cur["prn"]}
                self.captured["last"] = (i, rec)
                if i in self.sample:
                    self.captured[i] = rec
            cur.clear()
            return out

        pipe.forward, pipe.prn = forward, prn
        p._pipeline = sp.wrap("dispatch", pipeline)
        p._pack = sp.wrap("pack", p._pack)
        p._finish_chunk = sp.wrap("fetch", p._finish_chunk)
        # the module's function, unwrapped from an earlier run in this process
        pred_mod.format_pose_batch = sp.wrap(
            "format", inspect.unwrap(pred_mod.format_pose_batch))
        p.predict = sp.wrap("predict", p.predict)

    def stream(self, stamps: Dict[int, float]):
        """The client's frames, forever; stamps each batch's first frame."""
        n, b = len(self.frames), self.batch
        for i in itertools.count():
            if i % b == 0:
                stamps[i // b] = time.perf_counter()
            yield self.frames[i % n]

    def serve(self, seconds: float) -> dict:
        """Serve until ``seconds`` have passed and the batch in flight is
        back; returns the window's record."""
        b = self.batch
        stamps: Dict[int, float] = {}
        latencies: List[float] = []
        served: Dict = {}
        current: list = []
        self.captured.clear()
        self._calls = 0
        self.capturing = True
        it = self.predictor.predict_stream(self.stream(stamps))
        t0 = t = time.perf_counter()
        end = t0 + seconds
        done = 0
        for k, res in enumerate(it):
            current.append(res)
            if k % b == b - 1:
                t = time.perf_counter()
                bi = k // b
                latencies.append(t - stamps[bi])
                done = k + 1
                if bi in self.sample:
                    served[bi] = current
                served["last"] = current
                current = []
                if t >= end:
                    break
        it.close()
        self.capturing = False
        last_i, last_rec = self.captured.pop("last")
        self.captured[last_i] = last_rec
        served[last_i] = served.pop("last")
        return {"t0": t0, "t_end": t, "frames": done, "batches": len(latencies),
                "latencies_s": latencies, "served": served}


def run(cfg: dict, spec: dict, seed: int, seconds: float, trace: bool,
        device, start_time: float) -> dict:
    spans = harness.Spans()
    spans.on = False
    srv = Serving(cfg, spec, seed, device, spans)
    for _ in range(int(spec.get("warmup_batches", 2))):
        list(srv.predictor.predict(srv.frames[:srv.batch]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - start_time
    srv.marks.append(("warmup", start_time + setup_s))
    phases = harness.phases(start_time, srv.marks)
    spans.on = trace
    from multiposenet_tpu_torch.ops import cuda_nms

    launches0 = cuda_nms.launches
    tracer = harness.DeviceTrace(device) if trace else None
    if tracer:
        tracer.start()
    rec = srv.serve(seconds)
    if tracer:
        tracer.stop()
    spans.on = False

    ctx = {"setup_s": setup_s,
           "window_s": rec["t_end"] - rec["t0"], "images": rec["frames"],
           "batches": rec["batches"], "batch": srv.batch,
           "latencies_s": rec["latencies_s"], "spans": spans,
           "k1_launches": cuda_nms.launches - launches0, "config": cfg, "traffic": spec,
           "device": device, "t0": rec["t0"], "t_end": rec["t_end"]}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        ctx["memory_peak"] = torch.cuda.max_memory_allocated(device)
    else:
        ctx["memory_peak"] = 0
    if tracer:
        events = tracer.events()
        ctx["device_events"] = events
        ctx["trace_lo"], ctx["trace_hi"] = tracer.host_marks[0], tracer.host_marks[-1]
        ctx["trace_t0"], ctx["trace_t1"] = rec["t0"], rec["t_end"]
        ctx["trace_images"] = rec["frames"]
        ctx["breakdown"] = harness.breakdown(
            events, rec["t0"], rec["t_end"],
            _with_derived(spans).labeller(SPAN_ORDER))
    cls_bias = srv.cls_bias
    captured, served, frames = srv.captured, rec["served"], srv.frames
    state_dict, srv_batch = srv.state_dict, srv.batch
    srv.predictor = None
    del srv
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx["checks"], ctx["check_info"] = checks.serve_numbers(
        cfg, captured, served, frames, state_dict, srv_batch, device)
    lat = np.array(rec["latencies_s"]) * 1e3
    ctx["check_info"].update(
        k1_launches=ctx["k1_launches"], setup_s_by_phase=phases,
        classifier_bias=cls_bias,
        latency_ms_p50_p95_max=[float(np.percentile(lat, q)) for q in (50, 95, 100)])
    ctx["attempted"] = rec["frames"]
    ctx["failed"] = ctx["check_info"].get("frames_differ", 0)
    return ctx


def _with_derived(spans: harness.Spans) -> harness.Spans:
    """Spans plus ``upload``: the parts of each ``predict`` outside its
    pack, dispatch and fetch spans (the pinned buffer and its upload)."""
    out = harness.Spans()
    out.rows = list(spans.rows)
    inner = sorted((s, e) for n, s, e in spans.rows
                   if n in ("pack", "dispatch", "fetch"))
    for n, s, e in spans.rows:
        if n != "predict":
            continue
        for gs, ge in harness.idle_gaps(
                [(a, b) for a, b in inner if a < e and b > s], s, e):
            out.rows.append(("upload", gs, ge))
    return out
