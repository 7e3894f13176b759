"""Driver of ``detection_batches`` traffic: the detection stage's train
step (``engine/train_steps.STEP_FACTORIES['detection']``) fed through
``data/loader.device_prefetch``, as ``engine/trainer.Trainer`` runs an
epoch: the steps' logs stay on the device and are fetched every
``log_every`` steps.

Set-up draws the weights on the device, builds the train state (model and
AdamW over the RetinaNet pyramid and heads), makes the pool of pinned
batches and runs the first three steps through the window's own call and
feed; they are what ``checks.train_numbers`` compares.  The same state then
trains through the window, which ends on a synchronise; every loss the
window logs is kept, and one step more after it is compared with the
reference from the program's parameters at that point.  With ``trace`` the
window's first ``trace_seconds`` run under the device trace with host
spans ``step`` (the train step's enqueue), ``data`` (waiting for the
prefetch) and ``logs``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import torch

from mpn_bench import checks, harness, traffic, weights

CHECKED_STEPS = 3
SPAN_ORDER = ("logs", "data", "step")


def port_config(cfg: dict, spec: dict):
    from multiposenet_tpu_torch import config as pc

    t = cfg["train_detection"]
    c = pc.detection_train_config()
    return dataclasses.replace(
        c,
        model=pc.ModelConfig(
            backbone=cfg["backbone"], num_joints=cfg["num_joints"],
            fpn_channels=cfg["fpn_channels"], num_anchors=cfg["num_anchors"],
            num_classes=cfg["num_classes"], prior=cfg["prior"],
            prn_node_count=cfg["prn_node_count"], prn_coeff=cfg["prn_coeff"],
            compute_dtype=getattr(torch, t["compute_dtype"])),
        data=dataclasses.replace(c.data, inp_size=t["inp_size"],
                                 max_gt_boxes=int(spec["pad_boxes"])),
        train=dataclasses.replace(c.train, batch_size=int(spec["batch"]),
                                  init_lr=t["init_lr"]))


def trainable(state):
    return [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]


def run(cfg: dict, spec: dict, seed: int, seconds: float, trace: bool,
        device, start_time: float) -> dict:
    from multiposenet_tpu_torch.data.loader import device_prefetch
    from multiposenet_tpu_torch.engine import train_steps
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet

    t = cfg["train_detection"]
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = bool(t["tf32_conv"])
    pcfg = port_config(cfg, spec)
    lr = pcfg.train.init_lr
    marks = [("imports", time.time())]
    state_dict = weights.make_state_dict(cfg, seed, device, "train_detection")
    marks.append(("weights", time.time()))
    model = build_trainable_posenet(pcfg.model, device, state_dict)
    state = train_steps.create_train_state(pcfg, "detection", model=model)
    train_step, _ = train_steps.STEP_FACTORIES["detection"](pcfg, device)
    marks.append(("model", time.time()))
    pool = traffic.detection_pool(spec, seed, t["inp_size"], device)
    marks.append(("traffic", time.time()))
    feed = device_prefetch(itertools.cycle(pool), device, depth=int(spec["prefetch"]))

    spans = harness.Spans()
    spans.on = False
    step = spans.wrap("step", train_step)
    fetch = spans.wrap("data", lambda: next(feed))
    logged = []
    flush = spans.wrap("logs", lambda logs: logged.append(torch.stack(
        [torch.stack([v.float() for v in lg.values()]) for lg in logs]).cpu()))

    named = trainable(state)
    start = {n: p.detach().clone() for n, p in named}
    losses, grad = [], {}
    for i in range(CHECKED_STEPS):
        _, logs = step(state, fetch(), lr)
        losses.append(logs["loss"])
        if i == 0:
            # AdamW's first moment after one step is (1 - beta1) * grad
            b1 = state.optimizer.param_groups[0]["betas"][0]
            # (a step that updated nothing leaves no moment: it reads 0)
            grad = {n: state.optimizer.state[p].get("exp_avg", torch.zeros_like(p))
                    / (1.0 - b1) for n, p in named}
    delta = {n: p.detach() - start[n] for n, p in named}
    prog = {"losses": [float(x) for x in losses], "grad": grad, "delta": delta}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - start_time
    marks.append(("checked_steps", start_time + setup_s))

    log_every = int(spec["log_every"])
    batch = int(spec["batch"])
    spans.on = trace
    tracer = harness.DeviceTrace(device) if trace else None
    if tracer:
        tracer.start()
    pending, steps = [], 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    end = t0 + seconds
    # the trace covers the window's first trace_seconds: the profiler loses
    # events of a longer one (a clock mark among them)
    trace_end = t0 + min(seconds, float(spec["trace_seconds"]))
    traced = None
    while True:
        _, logs = step(state, fetch(), lr)
        pending.append(logs)
        steps += 1
        if steps % log_every == 0:
            flush(pending)
            pending = []
        now = time.perf_counter()
        if tracer and traced is None and now >= trace_end:
            tracer.stop()   # synchronises first: every step so far is done
            traced = (steps, tracer.host_marks[-1])
        if now >= end:
            break
    if pending:
        flush(pending)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_end = time.perf_counter()
    spans.on = False
    # one step more through the window's own call, feed and state, which
    # the reference repeats from the program's parameters at that point
    late = {"params": {n: p.detach().clone() for n, p in named},
            "batch": pool[(CHECKED_STEPS + steps) % len(pool)]}
    _, logs = step(state, fetch(), lr)
    late["loss"] = float(logs["loss"])
    late["window_logs"] = torch.cat(logged)

    ctx = {"setup_s": setup_s, "window_s": t_end - t0,
           "steps": steps, "batch": batch, "images": steps * batch, "spans": spans,
           "config": cfg, "traffic": spec, "device": device, "t0": t0, "t_end": t_end,
           "memory_peak": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0)}
    if tracer:
        events = tracer.events()
        ctx["device_events"] = events
        ctx["trace_lo"], ctx["trace_hi"] = tracer.host_marks[0], tracer.host_marks[-1]
        ctx["trace_t0"], ctx["trace_t1"] = t0, traced[1]
        ctx["trace_images"] = traced[0] * batch
        ctx["breakdown"] = harness.breakdown(events, t0, traced[1],
                                             spans.labeller(SPAN_ORDER))
    feed.close()
    checked = pool[:CHECKED_STEPS]
    del state, model, train_step, feed, step, fetch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx["checks"], ctx["check_info"] = checks.train_numbers(
        cfg, prog, state_dict, checked, device, lr, late=late)
    ctx["late"] = late
    ctx["check_info"]["setup_s_by_phase"] = harness.phases(start_time, marks)
    ctx["attempted"] = steps
    ctx["failed"] = 0
    return ctx
