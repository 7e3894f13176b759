#!/usr/bin/env python3
"""Chip smoke test of multiposenet_tpu_torch, the PyTorch/CUDA port: the
quickest proof that the port builds, is right and serves on an NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA GPU, nvcc and the repo

Phases (any failure exits non-zero, and no result line is printed):
  1. device   the card's name and power limit (nvidia-smi), then every CUDA
              source of the port built with nvcc, one process per source,
              started together;
  2. kernels  each hand-written kernel against its plain PyTorch twin on the
              card, bit for bit: NMS suppression at every (images,
              candidates) size where its word-blocked scan changes shape, up
              to 1024 candidates, fuzzed with duplicates, IoU exactly at the
              threshold, degenerate boxes and invalid slots, a suppression
              chain across 32-box words, and the serving path's own
              candidates (64 images x 100).  Then timed with CUDA events and
              CUDA graphs beside the twin and beside a bare ctypes launch,
              with a probe build of the kernel whose kernels stop after each
              stage (the split of its time, and the launch floor of an
              empty kernel);
  3. check    the CUDA pipeline against the same pipeline on the CPU (plain
              twins) on a small float32 input: equal grouped outputs;
  4. serving  BatchPredictor at full width (ResNet-101 FPN, 480 px, bf16,
              channels-last, max_people 20) answers 40 images of mixed
              sizes at batch 16; every kernel's launch count is zeroed just
              before and must have grown just after;
  5. e2e      the pipeline at bench.py's configuration (batch 64, 480 px,
              bf16, max_people 20) timed with CUDA events;
  5b. deploy  BN folding, export and the bench on the serving model: the
              folded forward (fold_bn_state_dict, the fold_bn=True graph)
              against the unfolded one in bf16, within 3 times bf16's own
              error against float32, both timed at batch 64 with CUDA
              events and profiled; the folded serving pipeline exported
              (torch.export, K1 as the operator mpn::nms_suppress) at batch
              16, saved, loaded, and served through
              BatchPredictor.from_exported on phase 4's 40 images, person
              rows equal to a live folded predictor's (deterministic cuDNN
              on both), K1 launched at least once per batch through the
              program; a program exported on the CPU (resnet50, 96 px)
              loaded onto the card, launching K1 there and equal to the
              live CUDA pipeline; then ``python -m
              multiposenet_tpu_torch.bench`` once at its defaults, its JSON
              line printed as a log line;
  6a. eval check  the multi-scale COCO evaluator on the card against the
              same evaluator on the CPU (plain twins) on 2 small images: the
              CPU run is fed the card's forward outputs for the same pyramid
              batches (which must be equal), and the folded peaks, boxes,
              person rows and OKS stats must agree; the peak threshold
              overfills a joint's slots, so images are dispatched again
              from the worker thread at the escalated capacity; NMS
              launched once per image dispatch; then the host chain
              (``device_resize`` off: K1 on every scale) and grouped
              dispatch (``group_size`` 2) on both devices the same way;
  6b. coco_eval  Evaluator.coco_eval at the reference's protocol (480 px, 5
              scales + flip, max_people 64, 32 peaks per joint, escalation
              at 128/256) on the serving model over 16 images at COCO sizes
              with a synthetic GT: a warm-up pass, whose NMS inputs are
              held against the plain twin bit for bit, then a timed pass
              with the split by stage (CUDA events) and its launch counts,
              then the image loop alone, pipelined and serial over the same
              images, timed and profiled;
  6c. variants  every evaluator variant at 6b's width on 4 of its images
              of one size: default, host peaks, host image resize, host
              grouping, the host chain, detections on every scale, and
              group_size 4 (one group, K1 at B = 8); per variant a warm-up
              pass whose K1 inputs are held against the plain twin, a timed
              pass with its exact K1 launch count (the host variants, on
              the default path's forward shapes, in one pass that is
              both), its rows against the
              default path's; the device's busy share of the default and
              the grouped loop; ``cli test`` on demo/test_images, whose
              two PNGs per image must decode at the image's size;
  7a. train check  one train step of each stage (keypoint, detection, PRN)
              on the card and on the CPU from the same seeded weights and
              batch (resnet50, 96 px, batch 2, float32, TF32 off, PRN
              dropout off): losses to 1e-4, updates of the trainable
              parameters, frozen parameters bit-unchanged, the keypoint
              stage's BatchNorm running statistics; each step again in
              float64, where the trainable gradients are held too;
  7b. training  the reference's stage chain at its configurations through
              Trainer.train (ResNet-101 FPN, float32): keypoint at 480 px
              batch 6, detection at 608 px batch 25 from the keypoint
              checkpoint, PRN at batch 8 from the detection checkpoint, on
              synthetic in-memory batches: per stage a warm-up epoch, an
              epoch timed with CUDA events, an epoch under torch.profiler,
              the checkpoint, validation and best copy (2 + 6 + 3 steps a
              stage, cut for phases 11 and 12's time), one timed
              AsyncSaver save; every loss finite, the other stages' groups
              bit-unchanged, and the keypoint loss falling over 3 steps on a
              fixed batch;
  8. cli      the port's command line (``cli.main``) on a synthetic COCO
              tree of PNG files written to a temporary directory (drawn
              people on 640x480, 480x640 and 640x427 images, polygon, RLE
              and crowd segmentations, a CMU-style COCO.json, mask2014
              PNGs): the keypoint and detection datasets timed on one
              thread and through Loader; then, ResNet-101 throughout,
              train keypoint (480 px, batch 6, 8 workers), detection (608
              px, from the keypoint checkpoint) and PRN (from the detection
              one) for one epoch each, val, coco-eval (bf16, no
              escalation) with a metrics file, two --eval-shard runs merged
              by merge-results (equal to the unsharded rows and stats),
              test on a PNG directory, and merge-results again through a
              ``python -m multiposenet_tpu_torch.cli`` subprocess; every
              loss finite, every checkpoint restoring, NMS launched at
              least once per coco-eval image;
  9. dist     several processes on the one card: 9a the dry run
              (parallel/dryrun.dryrun_multichip) over 2 processes with
              backend gloo (NCCL refuses two processes on one GPU), resnet50
              64 px, TF32 off and deterministic cuDNN: each stage's
              2-process step equal to the 1-process step within max(1e-5,
              5e-6 sqrt(2)), BatchNorm statistics equal, the mesh-sharded
              e2e batch with K1 held against its twin; then a one-process
              NCCL group: a DDP keypoint step, a broadcast, gather_objects;
              9b the keypoint stage at the reference's configuration
              (ResNet-101 float32, 480 px, global batch 6) as 2 processes x
              3 over gloo, timed (2 + 3 steps), with the
              gradient all-reduce timed by a
              DDP communication hook; 9c coco_eval auto-sharded over 2
              processes at 6b's configuration on 6b's images, stats and
              rows equal to one process's (deterministic cuDNN in both),
              a first pass in each new process whose K1 inputs are held
              against the twin there, then a timed pass equal to it; 9d
              BatchPredictor on a mesh of two entries of the card at batch
              16 on phase 4's 40 images, rows equal to an unsharded
              predictor's at the per-device batch 8;
  10. gate    the synthetic end-to-end gate at its recipe, as ``python -m
              multiposenet_tpu_torch.tools.synth_e2e_gate`` runs it: a
              learnable crowd dataset (144 PNG images from seed 0), the
              keypoint, detection and PRN stages (ResNet-50) trained on the
              card with deterministic cuDNN, each from the previous stage's
              best checkpoint, the 5-scale + flip coco-eval at base
              capacities of 8 peaks and 8 people so that crowds escalate
              (6 loader workers: the batches repeat whatever their number),
              AP >= 0.60 and zero truncation asserted, then the ablation's
              bf16 and host_grouping runs (bf16 within 0.02 AP, host
              grouping identical); K1's launches equal to the eval's image
              dispatches, and its inputs on the first eval image held
              against the twin bit for bit;
  11. tools   each measurement tool of multiposenet_tpu_torch/tools called
              through its ``main`` in this process, at full width, on phase
              4's serving weights and configuration where they match:
              bench_serving (batch sizes 1, 4, 8, 16; 30 requests; the
              idle share of each size under the profiler), bench_e2e_stages
              (batch 64, 5 iterations), bench_reference_shaped (10 images,
              float32, the serving weights), profile_trace --e2e (5
              executions; the span must fit the host's wall window and
              span / N agree with the CUDA-event time), bench_fold_bn (5 iterations),
              measure_bf16_drift (4 images, 480 px), bench_loader (128
              images, 8 batches, so that 8 workers have work: 4 and 8
              workers as threads and as processes, one epoch, batch 16,
              480 px), bench_trainer_loop (ResNet-101, 480 px, batch 16,
              bf16: a warm-up epoch of 4 steps, 10 timed steps with one
              save, the chained step; again with the batches on the device
              and no save) and bench_train_mfu
              (keypoint and PRN stages, 10 steps each), the training tools
              with cuDNN's autotuning off, as `cli train` runs; K1's launches
              zeroed before each tool that runs it and equal to the tool's
              dispatches after it, its inputs on the reference-shaped
              path's first image held against the twin; every rate and
              latency finite and positive.  Phase 2 also holds and times K1
              at that path's B = 1 on its own candidates;
  12. last tools  the last tools of multiposenet_tpu_torch/tools, each in
              its own process as a user runs it (the second and third at
              once), beside phase 10 (both are mostly loaders and process
              start-up and time nothing on the card): make_demo (ResNet-50, 128 px,
              200 steps a stage; two scenes, their renders and the JSON,
              people found in each scene, K1 once per image);
              train_synth_e2e, the ResNet-101 recipe at full width (480 and
              608 px, bf16) on 32 + 12 images of 640x480, one epoch a stage,
              then its 5-scale + flip coco-eval (every stage ran, metrics
              written, K1 once per eval image dispatch); and
              real_parity_runbook --dry-run (import-torch, coco-eval fast,
              reference-exact and bf16 on stand-in crowds at 96 px with
              the escalated re-dispatch firing, both verdicts 0; K1 once
              per image dispatch, and once per scale and image on the host
              chain).  Each process counts its own K1 launches from 0.

Training reaches no hand-written kernel: the conv stack runs on cuDNN, the
rest as PyTorch ops.  The weights are random, drawn from a seed; the detection output convs are
rescaled so that scores and boxes vary between anchors, and the thresholds
are lowered so that boxes and peaks exist (the eval's peak threshold is set
from the images' own folded heatmaps; in 6a the heatmap output conv is
also rescaled per joint, so that every joint has peaks).  Through phase
7 the images are made in memory (the evaluator takes them through its
``load_image`` argument); phase 8 writes them as PNG files, which the port
reads without cv2, and raises the output biases of its briefly trained
model so that its eval has boxes and people to score.  The last two
lines of standard output are the kernels' JSON line and the result line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from multiposenet_tpu_torch.data.image_io import write_png

SEED = 0
INP = 480
SERVE_BATCH = 16
BENCH_BATCH = 64
MAX_PEOPLE = 20
K = 100                      # max_detections at the serving configuration
# (images, candidates) for the suppression kernel: one word, a word's edges,
# two words, the serving size, a 9th word with one box, and MAX_K
NMS_CASES = ((1, 1), (3, 31), (3, 32), (3, 33), (2, 64), (BENCH_BATCH, K),
             (4, 257), (2, 1024))
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
F32_FLOPS = 67e12            # H100 SXM float32 rate outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels(sources):
    """Every CUDA source of the port and K1's probe build, one nvcc process
    each, all started together.  Returns the build seconds of each source
    and the loaded probe library."""
    from multiposenet_tpu_torch import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources) + 1) as ex:
        built = {src: ex.submit(_build.build, src) for src in sources}
        probe = ex.submit(build_nms_probe)
        for src, fut in built.items():
            log(f"build: {src} -> {fut.result().name}")
        probe = probe.result()
    log(f"build: {len(sources)} source(s) and the probe build in "
        f"{time.perf_counter() - t0:.2f} s")
    return dict(_build.build_seconds), probe


def cuda_time_ms(fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, per_graph: int = 20, replays: int = 50) -> float:
    """Device time per call of ``fn``: ``per_graph`` calls captured in one
    CUDA graph and replayed, so no host work sits between the launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


# ---------------------------------------------------------------- phase 2

def fuzz_nms_inputs(b: int, k: int, gen: torch.Generator):
    """(b, k, 4) score-sorted-like boxes in a 480 px frame + (b, k) valid,
    with duplicates, IoU exactly 0.5 pairs, degenerate boxes and invalid
    slots (one image all invalid, one all valid)."""
    u = lambda *s: torch.rand(*s, generator=gen)  # noqa: E731
    ctr = u(b, k, 2) * 400 + 40
    wh = u(b, k, 2) * 150 + 8
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)
    boxes[:, 1::5] = boxes[:, 0::5][:, : boxes[:, 1::5].shape[1]]     # duplicates
    n = len(range(3, k, 10))                                         # IoU == 0.5
    xy = torch.floor(u(b, n, 2) * 300)
    first, second = slice(2, 2 + 10 * n, 10), slice(3, 3 + 10 * n, 10)
    boxes[:, first, :2] = xy
    boxes[:, first, 2:] = xy + 9
    boxes[:, second, :2] = xy
    boxes[:, second, 2] = xy[..., 0] + 9
    boxes[:, second, 3] = xy[..., 1] + 4
    boxes[:, 4::7, 2] = boxes[:, 4::7, 0] - u(b, boxes[:, 4::7].shape[1]) * 5  # x2 < x1
    boxes[:, 6::9, 2:] = boxes[:, 6::9, :2] - 1.0                    # zero area
    valid = u(b, k) < 0.85
    if b >= 3:
        valid[0] = False
        valid[1] = True
    return boxes.float().contiguous(), valid.contiguous()


def chain_nms_inputs(k: int, gen: torch.Generator):
    """Two images of k candidates with a suppression chain planted far from
    the fuzz: box a (slot 3, word 0) suppresses b (slot 35, word 1), and b
    overlaps c (slot k - 2, the last word).  In image 0 b is dead, so c
    survives; in image 1 a is invalid, so b lives and c goes.  Returns the
    inputs and the keep bits expected at (a, b, c) in each image."""
    boxes, valid = fuzz_nms_inputs(2, k, gen)
    slots = [3, 35, k - 2]
    boxes[:, slots] = torch.tensor([[1000., 1000., 1019., 1019.],
                                    [1006., 1000., 1025., 1019.],
                                    [1012., 1000., 1031., 1019.]])
    valid[:, slots] = True
    valid[1, slots[0]] = False
    expect = torch.tensor([[True, False, True], [False, True, False]])
    return boxes, valid, slots, expect


def nms_candidates(pipe, images: torch.Tensor):
    """The (B, K, 4) boxes and (B, K) valid mask that the serving path (an
    e2e or a full pipeline) hands the suppression kernel for ``images``."""
    from multiposenet_tpu_torch.ops.boxes import clip_boxes, decode_boxes
    from multiposenet_tpu_torch.ops.nms import topk_candidates

    det = pipe.cfg.detection
    _, cls, reg = pipe.forward(images)
    anchors = getattr(pipe, "base", pipe).anchors
    boxes = clip_boxes(decode_boxes(anchors[None], reg.float()), INP, INP)
    _, _, top_boxes, valid = topk_candidates(boxes, cls.amax(dim=2),
                                             det.max_detections, det.score_thresh)
    return top_boxes.float().contiguous(), valid.contiguous()


def check_nms_kernel(boxes, valid, thresh: float, label: str,
                     quiet: bool = False) -> tuple:
    from multiposenet_tpu_torch.ops.cuda_nms import nms_suppress_cuda
    from multiposenet_tpu_torch.ops.nms import nms_suppress_plain

    got = nms_suppress_cuda(boxes, valid, thresh)
    want = nms_suppress_plain(boxes, valid, thresh)
    torch.cuda.synchronize()
    mismatch = int((got != want).sum())
    if not quiet:
        log(f"kernel nms_suppress [{label}]: B={boxes.shape[0]} "
            f"K={boxes.shape[1]} kept={int(got.sum())} "
            f"suppressed={int((valid & ~got).sum())} mismatches={mismatch}")
    if mismatch:
        raise AssertionError(f"nms_suppress kernel disagrees with its plain "
                             f"twin on {mismatch} slots ({label})")
    return got, int((got.int() - want.int()).abs().max())


def nms_bound_ms(b: int, k: int):
    """Least time for the suppression of (b, k) candidates on an H100: each
    input and output byte moved once against the memory rate, and the IoU
    arithmetic (~15 float32 ops per pair i < j, 5 per box area) against the
    float32 rate.  The greedy scan's dependent steps are not in this bound."""
    n_bytes = b * k * 4 * 4 + b * k + b * k
    n_ops = b * (k * (k - 1) // 2 * 15 + 5 * k)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# Probe kernels, appended to a copy of csrc/nms_suppress.cu and built apart
# from the package: the kernel's stages run alone, so that differences of
# their times split the kernel's time.  Stage 0 launches an empty kernel at
# K1's launch shape; 1 stages; 2 stages and builds the bitmask.  Each writes
# a keep mask that depends on what it built, so nothing is optimised away.
# They call the source's own device functions (Shared, stage, build_mask,
# write_keep, mask_pitch, kThreads): a change of those names or signatures
# is made here too.
NMS_PROBE_CU = r"""
namespace {
template <int kStages>
__global__ void __launch_bounds__(kThreads)
nms_probe_kernel(const float4* __restrict__ boxes,
                 const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, int k, float thresh) {
  if (kStages == 0) return;
  extern __shared__ float4 smem[];
  const int words = (k + 31) / 32;
  const Shared s(smem, k, words);
  const size_t img = blockIdx.x;
  stage(s, boxes + img * k, valid + img * k, k, words);
  __syncthreads();
  if (kStages >= 2) {
    build_mask(s, k, words, thresh);
    __syncthreads();
  }
  const int t = threadIdx.x;
  if (t < words)
    s.kept[t] = s.valid[t] & ~(kStages >= 2
        ? s.mask[32 * t * mask_pitch(words) + t]
        : __float_as_uint(s.area[32 * t]));
  __syncthreads();
  write_keep(s, keep + img * k, k);
}
}  // namespace

extern "C" int nms_probe_launch(int stages, const void* boxes,
                                const void* valid, void* keep, int b, int k,
                                float thresh, void* stream) {
  void (*kernel)(const float4*, const uint8_t*, uint8_t*, int, float) =
      stages == 0 ? nms_probe_kernel<0>
                  : stages == 1 ? nms_probe_kernel<1> : nms_probe_kernel<2>;
  const size_t smem = nms_suppress_smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}
"""
NMS_PROBE_STAGES = ("launch", "stage", "bitmask")


def build_nms_probe():
    """csrc/nms_suppress.cu with the probe kernels appended, built with the
    package's flags into its build directory under a hash of the text and
    the flags, as ``_build`` keys the package's libraries, and loaded."""
    import ctypes
    import hashlib
    import os

    from multiposenet_tpu_torch import _build

    src = (_build.CSRC_DIR / "nms_suppress.cu").read_text() + NMS_PROBE_CU
    flags = (*_build.NVCC_FLAGS, "-Xptxas", "-v")
    digest = hashlib.sha256((src + " ".join(flags)).encode()).hexdigest()[:16]
    lib = _build.BUILD_DIR / f"nms_probe-{digest}.so"
    if not lib.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = lib.with_suffix(".cu")
        cu.write_text(src)
        tmp = lib.with_name(lib.stem + ".tmp.so")
        proc = subprocess.run([_build.nvcc_path(), *flags, "-o", str(tmp),
                               str(cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu.name}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        # registers and spills of each kernel, as the package's build has them
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"ptxas [probe build]: {line.strip()}")
    so = ctypes.CDLL(str(lib))
    for fn in (so.nms_probe_launch, so.nms_suppress_launch):
        fn.restype = ctypes.c_int
    so.nms_probe_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    so.nms_suppress_launch.argtypes = so.nms_probe_launch.argtypes[1:]
    return so


def time_nms_probes(probe, boxes, valid, thresh: float, rounds: int = 2):
    """Device ms per launch (CUDA graph) of each probe stage and of the whole
    kernel of the probe build, in ``rounds`` rounds; the whole kernel is
    first held against the plain twin.  Returns the best of the rounds."""
    from multiposenet_tpu_torch.ops.nms import nms_suppress_plain

    b, k = valid.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=valid.device)
    args = (boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
            float(thresh))

    def launcher(stages):
        def fn():
            stream = torch.cuda.current_stream().cuda_stream
            err = (probe.nms_suppress_launch(*args, stream) if stages is None
                   else probe.nms_probe_launch(stages, *args, stream))
            if err != 0:
                raise RuntimeError(f"probe launch failed: CUDA error {err}")
        return fn

    launcher(None)()
    torch.cuda.synchronize()
    if not torch.equal(keep, nms_suppress_plain(boxes, valid, thresh)):
        raise AssertionError("nms_suppress [probe build] disagrees with its "
                             "plain twin")
    names = (*NMS_PROBE_STAGES, "whole")
    times = {n: [] for n in names}
    for _ in range(rounds):
        for stages, name in enumerate(names):
            fn = launcher(stages if stages < len(NMS_PROBE_STAGES) else None)
            times[name].append(graph_time_ms(fn))
    ms = {n: min(t) for n, t in times.items()}
    log("kernel nms_suppress probe: "
        + ", ".join(f"{n} {' / '.join(f'{x:.5f}' for x in t)} ms"
                    for n, t in times.items())
        + f"; split of the best: launch {ms['launch']:.5f}, staging "
        f"{ms['stage'] - ms['launch']:.5f}, bitmask "
        f"{ms['bitmask'] - ms['stage']:.5f}, scan and write "
        f"{ms['whole'] - ms['bitmask']:.5f} ms at B={b} K={k}")
    return ms


def host_ms_per_call(fn, calls: int = 500) -> float:
    """Host time per call of ``fn`` with no synchronisation between calls:
    what the caller pays on the CPU to enqueue one launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return host * 1e3


# ---------------------------------------------------------------- model set-up

def serving_config(batch_people: int = MAX_PEOPLE):
    from multiposenet_tpu_torch.config import Config, EvalConfig, ModelConfig

    cfg = Config(model=ModelConfig(backbone="resnet101",
                                   compute_dtype=torch.bfloat16),
                 eval=EvalConfig(inp_size=INP))
    return dataclasses.replace(
        cfg,
        detection=dataclasses.replace(cfg.detection, score_thresh=0.05,
                                      test_score_thresh=0.1),
        # random heatmaps are tiny: any positive local maximum is a peak
        peaks=dataclasses.replace(cfg.peaks, thre1=0.0),
        prn=dataclasses.replace(cfg.prn, max_people=batch_people))


@torch.no_grad()
def spread_detection_heads(model, images: torch.Tensor, logit_std=1.5,
                           delta_std=1.0) -> None:
    """Rescale the detection output convs (drawn N(0, 0.01)) so that the
    random trunk's tiny features give logits and box deltas of order one.
    The output convs are linear in their weights, so one forward measures
    the spread and one multiply sets it."""
    from multiposenet_tpu_torch.engine.inference import preprocess_on_device

    spreads = {}

    def hook(name):
        # the weight's share of the output, in float32: under bf16 the
        # output itself rounds away a spread this small around the bias
        def fn(mod, inp, _out):
            wx = torch.nn.functional.conv2d(inp[0].float(), mod.weight.float(),
                                            None, padding=mod.padding)
            spreads.setdefault(name, []).append(wx.std().item())
        return fn

    heads = {"cls": model.classificationModel.output,
             "reg": model.regressionModel.output}
    handles = [m.register_forward_hook(hook(n)) for n, m in heads.items()]
    try:
        model.full_forward(preprocess_on_device(images))
    finally:
        for h in handles:
            h.remove()
    for name, target in (("cls", logit_std), ("reg", delta_std)):
        # the pyramid levels differ by orders of magnitude: scale the
        # widest (P3, most anchors) to the target
        s = max(spreads[name])
        if not s > 0:
            raise AssertionError(f"{name} head output has no spread")
        heads[name].weight.mul_(target / s)


def mixed_images(rng: np.random.RandomState, n: int):
    sizes = [(480, 640), (640, 480), (480, 480), (360, 500), (720, 540),
             (300, 300), (512, 384), (240, 320)]
    out = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        out.append(img)
    return out


def check_people(results, n_images: int) -> int:
    if len(results) != n_images:
        raise AssertionError(f"{len(results)} result lists for {n_images} images")
    n_people = 0
    for people in results:
        if not isinstance(people, list):
            raise AssertionError("a result is not a list")
        for p in people:
            kp = np.asarray(p["keypoints"], np.float64)
            bb = np.asarray(p["bbox"], np.float64)
            if kp.shape != (51,) or bb.shape != (4,):
                raise AssertionError(f"bad person shapes {kp.shape} {bb.shape}")
            if not (np.isfinite(kp).all() and np.isfinite(bb).all()
                    and 0.0 <= p["score"] <= 1.0):
                raise AssertionError(f"non-finite or out-of-range person {p}")
            n_people += 1
    if not any(results):
        raise AssertionError("every image came back without people")
    return n_people


# ---------------------------------------------------------------- phase 3

def check_against_cpu() -> None:
    """Small float32 resnet50 pipeline on the card against the same pipeline
    on the CPU (plain twins) on identical (heatmaps, cls, reg)."""
    from multiposenet_tpu_torch.config import Config, EvalConfig, ModelConfig
    from multiposenet_tpu_torch.engine.inference import (
        format_pose_batch, make_e2e_pose_pipeline)
    from multiposenet_tpu_torch.models.posenet import build_posenet

    size = 128
    cfg = Config(model=ModelConfig(backbone="resnet50"),
                 eval=EvalConfig(inp_size=size))
    cfg = dataclasses.replace(
        cfg,
        detection=dataclasses.replace(cfg.detection, max_detections=32,
                                      test_score_thresh=0.1),
        peaks=dataclasses.replace(cfg.peaks, thre1=0.0, max_peaks_per_joint=8),
        prn=dataclasses.replace(cfg.prn, max_people=8))
    gpu_model = build_posenet(cfg.model, torch.device("cuda"), seed=SEED + 1,
                              head_output_std=0.01)
    imgs = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, 256, (4, size, size, 3), dtype=np.uint8))
    spread_detection_heads(gpu_model, imgs.cuda())
    cpu_model = build_posenet(cfg.model, torch.device("cpu"),
                              {k: v.cpu() for k, v in gpu_model.state_dict().items()})
    gpu = make_e2e_pose_pipeline(gpu_model, cfg, (size, size), device="cuda")
    cpu = make_e2e_pose_pipeline(cpu_model, cfg, (size, size), device="cpu")
    scales = torch.tensor([1.0, 1.5, 2.0, 1.25])
    heads = gpu.forward(imgs.cuda())
    out_g, a_g = gpu.postprocess(*heads, scales.cuda())
    out_c, a_c = cpu.postprocess(*(h.cpu() for h in heads), scales)
    a_g = a_g.cpu()
    for name in ("chosen", "active", "active_any", "peak_xy", "peak_valid",
                 "box_valid"):
        if not torch.equal(getattr(a_g, name), getattr(a_c, name)):
            raise AssertionError(f"CUDA and CPU pipelines differ in {name}")
    for name in ("boxes_xywh", "fallback_xy"):
        torch.testing.assert_close(getattr(a_g, name), getattr(a_c, name),
                                   rtol=1e-5, atol=1e-4)
    if not torch.equal(out_g.detections.keep.cpu(), out_c.detections.keep):
        raise AssertionError("CUDA and CPU NMS keep masks differ")
    people = format_pose_batch(a_g)
    n = sum(len(p) for p in people)
    if not n:
        raise AssertionError("the small reference input grouped nobody")
    log(f"check: CUDA pipeline == CPU pipeline on 4 x {size} px resnet50 f32 "
        f"({n} people, {int(out_c.detections.keep.sum())} boxes kept)")


# ---------------------------------------------------------------- phase 5b

# bound on the folded bf16 forward's error against the unfolded bf16 one,
# in units of the unfolded bf16 forward's own error against float32: both
# bf16 forwards round at every layer, at other places, so their difference
# may reach the sum of two such errors, and a maximum over millions of
# values is noisy
FOLD_REL_TOL = 3.0


def max_rel_err(got, want) -> float:
    """max |got - want| over the largest |want|, in float32."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN picks the same algorithm for the same convolution, so that two
    runs of one computation (a live pipeline, its exported program) are
    bit-comparable; the previous settings come back after."""
    prev = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = prev


def device_move_check(card: str) -> int:
    """A program exported on the CPU (resnet50, 96 px, bf16) runs on the card
    after ``load_pose_pipeline(..., device="cuda")``: it launches K1 there
    and equals the live CUDA pipeline of the same weights.  Returns K1's
    launches through the program."""
    from multiposenet_tpu_torch.config import Config, EvalConfig, ModelConfig
    from multiposenet_tpu_torch.engine.export_model import (
        export_pose_pipeline, load_pose_pipeline)
    from multiposenet_tpu_torch.engine.inference import make_e2e_pose_pipeline
    from multiposenet_tpu_torch.models.posenet import build_posenet
    from multiposenet_tpu_torch.ops import cuda_nms

    size = 96
    cfg = Config(model=ModelConfig(backbone="resnet50",
                                   compute_dtype=torch.bfloat16),
                 eval=EvalConfig(inp_size=size))
    cfg = dataclasses.replace(
        cfg,
        detection=dataclasses.replace(cfg.detection, max_detections=32,
                                      test_score_thresh=0.1),
        peaks=dataclasses.replace(cfg.peaks, thre1=0.0, max_peaks_per_joint=8),
        prn=dataclasses.replace(cfg.prn, max_people=8))
    cpu_model = build_posenet(cfg.model, torch.device("cpu"), seed=SEED + 2,
                              head_output_std=0.01)
    imgs = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, 256, (2, size, size, 3), dtype=np.uint8))
    spread_detection_heads(cpu_model, imgs)
    t0 = time.perf_counter()
    blob = export_pose_pipeline(cpu_model, cfg, 2, device="cpu")
    export_s = time.perf_counter() - t0
    sp = load_pose_pipeline(blob, device="cuda")
    gpu_model = build_posenet(cfg.model, torch.device("cuda"),
                              {k: v.cuda() for k, v in cpu_model.state_dict().items()})
    live = make_e2e_pose_pipeline(gpu_model, cfg, (size, size), device="cuda")
    imgs = imgs.cuda()
    scales = torch.tensor([1.0, 1.5], device="cuda")
    want = live(imgs, scales)[1]
    cuda_nms.launches = 0
    got = sp(imgs, scales)
    torch.cuda.synchronize()
    launches = cuda_nms.launches
    if launches < 1:
        raise AssertionError("the CPU-exported program did not launch K1 on "
                             "the card")
    for name, g, w in zip(got._fields, got, want):
        if g.device.type != "cuda" or not torch.equal(g, w):
            raise AssertionError(f"CPU-exported program on the card differs "
                                 f"from the live CUDA pipeline in {name}")
    log(f"deploy: a program exported on the CPU (resnet50 96 px bf16, "
        f"{len(blob) / 1e6:.1f} MB, export + save {export_s:.1f} s on the "
        f"host) loaded onto cuda: K1 launches {launches}, 8 outputs equal to "
        f"the live CUDA pipeline ({int(want.box_valid.sum())} boxes, "
        f"{int(want.peak_valid.sum())} peaks) [{card}]")
    return launches


def deployment_phase(model, cfg, bench_imgs, images, card: str) -> dict:
    """Phase 5b at full width (the serving model: ResNet-101, 480 px, bf16):
    BN folding checked and timed against the unfolded forward, the folded
    serving pipeline exported, saved, loaded and served through
    ``BatchPredictor.from_exported`` against a live folded predictor, a
    CPU-exported program run on the card, and the port's bench."""
    import tempfile

    from multiposenet_tpu_torch import bench
    from multiposenet_tpu_torch.engine import export_model
    from multiposenet_tpu_torch.engine.inference import make_e2e_pose_pipeline
    from multiposenet_tpu_torch.engine.predictor import BatchPredictor
    from multiposenet_tpu_torch.models.fold_bn import fold_bn_state_dict
    from multiposenet_tpu_torch.models.posenet import build_posenet
    from multiposenet_tpu_torch.ops import cuda_nms

    t_phase = time.perf_counter()
    fcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              fold_bn=True))
    folded = build_posenet(fcfg.model, torch.device("cuda"),
                           fold_bn_state_dict(model.state_dict()))
    pipe = make_e2e_pose_pipeline(model, cfg, (INP, INP), device="cuda")
    fpipe = make_e2e_pose_pipeline(folded, fcfg, (INP, INP), device="cuda")

    # the folded bf16 forward against the unfolded one, beside bf16's own
    # error against the unfolded float32 forward: the fold only reassociates,
    # so its error must stay within FOLD_REL_TOL times bf16's own
    ref = pipe.forward(bench_imgs)
    got = fpipe.forward(bench_imgs)
    bf16_cfg = model.cfg
    model.cfg = dataclasses.replace(bf16_cfg, compute_dtype=torch.float32)
    try:
        f32 = pipe.forward(bench_imgs)
    finally:
        model.cfg = bf16_cfg
    errs = {}
    for name, g, r, f in zip(("heatmaps", "cls", "reg"), got, ref, f32):
        fold_err, bf16_err = max_rel_err(g, r), max_rel_err(r, f)
        errs[name] = (fold_err, bf16_err)
        if not (np.isfinite(fold_err) and fold_err <= FOLD_REL_TOL * bf16_err):
            raise AssertionError(
                f"folded {name} off the unfolded by {fold_err:.3e} of its "
                f"largest value; bf16 itself is {bf16_err:.3e} off float32")
    log("fold: folded vs unfolded forward (bf16, batch 64), max error over "
        "the largest value, beside bf16's own against float32: "
        + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, (a, b) in errs.items()))
    del ref, got, f32

    fwd = lambda p: (lambda: p.forward(bench_imgs))  # noqa: E731
    unfolded_ms = [cuda_time_ms(fwd(pipe), 10, warmup=2)]
    folded_ms = [cuda_time_ms(fwd(fpipe), 10, warmup=3)]
    folded_ms.append(cuda_time_ms(fwd(fpipe), 10, warmup=2))
    unfolded_ms.append(cuda_time_ms(fwd(pipe), 10, warmup=2))
    prof = {"folded": device_busy(fwd(fpipe)), "unfolded": device_busy(fwd(pipe))}
    log(f"fold: batch {BENCH_BATCH} x {INP}px resnet101 bf16 forward "
        f"unfolded {unfolded_ms[0]:.3f} / {unfolded_ms[1]:.3f} ms, folded "
        f"{folded_ms[0]:.3f} / {folded_ms[1]:.3f} ms (CUDA events; order "
        f"unfolded, folded, folded, unfolded) [{card}]")
    for name, p in prof.items():
        log(f"fold: {name} forward profiled: wall {p['wall_ms']:.2f} ms, "
            f"kernels {p['kernel_ms']:.2f} ms, busy {p['busy_share']:.3f}; "
            "top: " + "; ".join(f"{k} {ms:.2f}" for k, ms in p["top"]))

    # the folded serving pipeline exported at the serving batch, then served
    # from the artifact against a live folded predictor, with deterministic
    # cuDNN algorithms on both sides
    t0 = time.perf_counter()
    program = export_model.export_program(folded, fcfg, SERVE_BATCH, device="cuda")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = export_model.save_program(program)
    save_s = time.perf_counter() - t0
    del program
    with deterministic_cudnn():
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "pose.pt2")
            with open(path, "wb") as f:
                f.write(blob)
            t0 = time.perf_counter()
            aot = BatchPredictor.from_exported(path, device="cuda")
            load_s = time.perf_counter() - t0
        if (aot.batch_size, aot.inp) != (SERVE_BATCH, INP):
            raise AssertionError(f"artifact signature {aot.batch_size} x "
                                 f"{aot.inp}, expected {SERVE_BATCH} x {INP}")
        live = BatchPredictor(fcfg, model=folded, batch_size=SERVE_BATCH,
                              device="cuda")
        want = live.predict(images)
        cuda_nms.launches = 0
        t0 = time.perf_counter()
        got = aot.predict(images)
        serve_s = time.perf_counter() - t0
        launches = cuda_nms.launches
    n_batches = -(-len(images) // SERVE_BATCH)
    n_people = check_people(got, len(images))
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        raise AssertionError(f"the exported program's person rows differ from "
                             f"the live folded predictor's on {bad} images")
    if launches < n_batches:
        raise AssertionError(f"K1 launched {launches} times through the "
                             f"loaded program, expected >= {n_batches}")
    log(f"export: folded serving pipeline at batch {SERVE_BATCH} x {INP}px "
        f"bf16: {len(blob) / 1e6:.1f} MB, export {export_s:.1f} s, save "
        f"{save_s:.1f} s, load {load_s:.1f} s; from_exported answered "
        f"{len(images)} images in {serve_s:.3f} s, {n_people} people, person "
        f"rows equal to the live folded predictor's; K1 launches {launches} "
        f"[{card}]")
    del aot, live, blob, folded, fpipe, pipe

    with deterministic_cudnn():
        moved = device_move_check(card)
    t0 = time.perf_counter()
    line = bench.main()
    if line["mfu"] is None or line["device_busy_ms_per_exec"] is None:
        raise AssertionError("the bench left mfu or device_busy_ms_per_exec unset")
    log(f"bench: python -m multiposenet_tpu_torch.bench in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    log(f"deploy: phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "moved_launches": moved}


# ---------------------------------------------------------------- phase 6

# (h, w) of COCO val2017-typical images
EVAL_SIZES = ((480, 640), (640, 480), (427, 640), (612, 612))
EVAL_SCALES = (0.5, 1.0, 1.5, 2.0, 2.5)   # the reference's protocol
EVAL_IMAGES = 16


def synthetic_gt(shapes, rng: np.random.RandomState) -> dict:
    """A COCO keypoint GT over images of the given (h, w): one or two people
    per image at random places, every keypoint visible."""
    images, anns = [], []
    for i, (h, w) in enumerate(shapes):
        images.append({"id": i + 1, "height": h, "width": w,
                       "file_name": f"{i + 1}.png"})
        for _ in range(1 + i % 2):
            bw, bh = rng.uniform(0.2, 0.5) * w, rng.uniform(0.3, 0.7) * h
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            kps = np.stack([x0 + rng.uniform(0, bw, 17), y0 + rng.uniform(0, bh, 17),
                            np.full(17, 2.0)], axis=1)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1, "iscrowd": 0, "num_keypoints": 17,
                         "area": float(bw * bh),
                         "bbox": [float(x0), float(y0), float(bw), float(bh)],
                         "keypoints": kps.reshape(-1).tolist()})
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1, "name": "person"}]}


def eval_config(base, inp: int, scales, **sections):
    """``base`` with the multi-scale eval settings and the given fields of
    its ``detection`` / ``peaks`` / ``prn`` sections replaced."""
    from multiposenet_tpu_torch.config import EvalConfig

    cfg = dataclasses.replace(base, eval=EvalConfig(
        inp_size=inp, scale_search=tuple(scales), flip=True))
    for name, fields in sections.items():
        cfg = dataclasses.replace(cfg, **{name: dataclasses.replace(
            getattr(cfg, name), **fields)})
    return cfg


def folded_peak_scores(model, cfg, images, n: int, device) -> np.ndarray:
    """(images, 18, n): the scores of each joint's ``n`` best local maxima
    in each image's folded heatmap, descending."""
    from multiposenet_tpu_torch.engine.evaluator import Evaluator
    from multiposenet_tpu_torch.eval.multiscale import get_multipliers

    probe = Evaluator(eval_config(cfg, cfg.eval.inp_size, cfg.eval.scale_search,
                                  peaks=dict(thre1=0.0, max_peaks_per_joint=n,
                                             escalate_max_peaks=0)),
                      model=model, device=device)
    best = []
    for img in images:
        mult = get_multipliers(img.shape[0], cfg.eval.inp_size,
                               cfg.eval.scale_search)
        _, (_, scores, _) = probe._get_outputs_device(mult, img, with_flip=True)
        best.append(-np.sort(-scores, axis=1))
    return np.stack(best)


@torch.no_grad()
def spread_keypoint_heads(model, cfg, images, rank: int, device) -> None:
    """Rescale the heatmap output conv (``convfin``, 1x1, no bias) per joint
    so that every joint's ``rank``-th best folded peak (the most of it over
    ``images``) is as high as the highest joint's.  A random model's joints
    differ by an order of magnitude, so one global peak threshold would
    leave most of them without peaks.  A joint and its mirror twin get one
    factor: the flip fold averages the two."""
    from multiposenet_tpu_torch.eval.multiscale import SWAP_HEAT_18

    top = folded_peak_scores(model, cfg, images, rank, device)[:, :, -1].max(0)
    top = np.maximum(top, top[list(SWAP_HEAT_18)])
    if not (top > 0).all():
        raise AssertionError(f"a joint has no positive peak: {top}")
    factor = torch.from_numpy((top.max() / top).astype(np.float32))
    model.convfin.weight.mul_(factor.to(model.convfin.weight.device)[:, None, None, None])


def calibrate_thre1(model, cfg, images, k: int, device) -> float:
    """A peak threshold under which each of ``images`` has fewer than ``k``
    peaks of every joint, and the most crowded joint of one image has
    ``k - 1``, taken from the folded heatmaps' peaks.  A random model's
    heatmaps are tiny and bumpy, so the reference's 0.1 finds nothing and 0
    finds every local maximum, which would escalate every image."""
    best = folded_peak_scores(model, cfg, images, 4 * k, device)
    best = best.reshape(-1, best.shape[2])
    j = int(best[:, k - 1].argmax())
    # midway between two peaks of the most crowded joint, so that no peak
    # sits at the threshold, where rounding would decide it
    return float((best[j, k - 2] + best[j, k - 1]) / 2)


def run_coco_eval(ev, gt: dict, images, **kw):
    """``ev.coco_eval`` over in-memory images with ``gt`` written to a
    temporary JSON file.  Returns (metrics, result rows)."""
    import os
    import tempfile

    by_name = {rec["file_name"]: img for rec, img in zip(gt["images"], images)}
    with tempfile.TemporaryDirectory() as d:
        ann_file = os.path.join(d, "gt.json")
        result_file = os.path.join(d, "results.json")
        with open(ann_file, "w") as f:
            json.dump(gt, f)
        metrics = ev.coco_eval(ann_file=ann_file, result_file=result_file,
                               load_image=by_name.__getitem__, **kw)
        with open(result_file) as f:
            return metrics, json.load(f)


def batch_key(images: torch.Tensor, with_detections: bool) -> tuple:
    import hashlib

    a = images.cpu().numpy()
    return a.shape, hashlib.sha1(a.tobytes()).hexdigest(), with_detections


def hook_forwards(ev, store: dict, replay: bool) -> None:
    """Record every forward of ``ev`` in ``store`` under its input batch, or
    (``replay``) answer each forward from ``store`` instead: the replaying
    evaluator then gets the recording one's heads exactly, and a pyramid
    batch the recording one never built fails the lookup."""
    make = ev.pipeline

    def pipeline(hw, with_peaks=True, with_detections=True):
        pipe = make(hw, with_peaks, with_detections)
        if getattr(pipe, "hooked", False):
            return pipe
        run = pipe.forward

        def forward(images):
            key = batch_key(images, with_detections)
            if replay:
                if key not in store:
                    raise AssertionError("a CPU pyramid batch differs from "
                                         "every CUDA one")
                return store[key]
            heads = run(images)
            store[key] = tuple(None if t is None else t.cpu() for t in heads)
            return heads
        pipe.forward, pipe.hooked = forward, True
        return pipe
    ev.pipeline = pipeline


def record_fetches(ev) -> list:
    """Keep every (boxes, peaks) that ``ev`` fetches, in fetch order."""
    fetched = []
    fetch = ev._fetch_image_device

    def record(handle):
        fetched.append(fetch(handle))
        return fetched[-1]
    ev._fetch_image_device = record
    return fetched


def compare_rows(gpu_rows, cpu_rows, what: str) -> tuple:
    """Person rows of two runs of one eval: equal images, scores and
    visibilities, a keypoint on a peak exactly equal; a keypoint without one
    (v=0) falls back to the PRN's argmax inside its box, so it moves with
    the box.  Returns (keypoints on peaks, largest box or fallback |diff|)."""
    if len(gpu_rows) != len(cpu_rows) or not gpu_rows:
        raise AssertionError(f"{what}: {len(gpu_rows)} CUDA result rows against "
                             f"{len(cpu_rows)} CPU ones")
    n_peak_kps, err = 0, 0.0
    for g, c in zip(gpu_rows, cpu_rows):
        gk = np.reshape(g["keypoints"], (17, 3))
        ck = np.reshape(c["keypoints"], (17, 3))
        on_peak = ck[:, 2] > 0
        if (g["image_id"] != c["image_id"] or g["score"] != c["score"]
                or not np.array_equal(gk[:, 2], ck[:, 2])
                or not np.array_equal(gk[on_peak], ck[on_peak])):
            raise AssertionError(f"{what}: CUDA and CPU person rows differ: {g} {c}")
        n_peak_kps += int(on_peak.sum())
        err = max(err, float(np.abs(np.subtract(g["bbox"], c["bbox"])).max()),
                  float(np.abs(gk[~on_peak] - ck[~on_peak]).max(initial=0.0)))
    return n_peak_kps, err


def check_eval_against_cpu(device: str = "cuda") -> dict:
    """Phase 6a: the evaluator on the card against the same evaluator on
    the CPU (plain twins), resnet50 float32, 2 noise images of two sizes,
    inp_size 128, 3 scales, flip.  The CPU run is fed the CUDA run's
    forward outputs for the same input batches; everything after the
    forward runs on both devices.  The joints' heatmaps are evened out and
    the peak threshold set so that the most crowded joint has 16 peaks:
    more than the 8 slots of the base tier, so that image is dispatched
    again from the worker thread at 32, and grouped at the escalated
    (32 peaks, 32 people) tier.  Then the host chain (``device_resize``
    off: host crops, every scale with detections, host resize and peaks)
    and grouped dispatch (``group_size`` 2: each image's group filled with
    a replica) on both devices the same way."""
    from multiposenet_tpu_torch.config import Config, ModelConfig
    from multiposenet_tpu_torch.engine.evaluator import Evaluator
    from multiposenet_tpu_torch.models.posenet import build_posenet
    from multiposenet_tpu_torch.ops import cuda_nms

    rng = np.random.RandomState(SEED + 2)
    cfg = eval_config(Config(model=ModelConfig(backbone="resnet50")), 128,
                      (0.5, 1.0, 1.5),
                      detection=dict(max_detections=32, test_score_thresh=0.05),
                      peaks=dict(max_peaks_per_joint=8, escalate_max_peaks=32),
                      prn=dict(max_people=8, escalate_max_people=32))
    gpu_model = build_posenet(cfg.model, torch.device(device), seed=SEED + 2,
                              head_output_std=0.01)
    spread_detection_heads(gpu_model, torch.from_numpy(rng.randint(
        0, 256, (2, 128, 128, 3), dtype=np.uint8)).to(device))
    shapes = ((160, 224), (237, 189))
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]
    gt = synthetic_gt(shapes, rng)
    spread_keypoint_heads(gpu_model, cfg, images, 16, device)
    cpu_model = build_posenet(cfg.model, torch.device("cpu"),
                              {k: v.cpu() for k, v in gpu_model.state_dict().items()})
    thre1 = calibrate_thre1(gpu_model, cfg, images, 17, device)
    cfg = dataclasses.replace(cfg, peaks=dataclasses.replace(cfg.peaks, thre1=thre1))

    heads = {}
    gpu = Evaluator(cfg, model=gpu_model, device=device)
    hook_forwards(gpu, heads, replay=False)
    gpu_fetched = record_fetches(gpu)
    cuda_nms.launches = 0
    gpu_metrics, gpu_rows = run_coco_eval(gpu, gt, images)
    launches = cuda_nms.launches
    cpu = Evaluator(cfg, model=cpu_model, device="cpu")
    hook_forwards(cpu, heads, replay=True)
    cpu_fetched = record_fetches(cpu)
    cpu_metrics, cpu_rows = run_coco_eval(cpu, gt, images)

    if len(gpu_fetched) != len(cpu_fetched):
        raise AssertionError("the CUDA and CPU evaluators fetched different "
                             "numbers of images")
    score_err = box_err = score_max = 0.0
    for (gb, (gc, gs, gv)), (cb, (cc, cs, cv)) in zip(gpu_fetched, cpu_fetched):
        if not (np.array_equal(gc, cc) and np.array_equal(gv, cv)):
            raise AssertionError("CUDA and CPU folded peaks differ")
        score_err = max(score_err, float(np.abs(gs - cs).max()))
        score_max = max(score_max, float(np.abs(cs[cv]).max(initial=0.0)))
        if len(gb) != len(cb):
            raise AssertionError("CUDA and CPU scale-1.0 boxes differ in number")
        if gb:
            box_err = max(box_err, float(np.abs(np.subtract(gb, cb)).max()))
    # the fold's matmuls sum in another order on the card: float32 rounding
    if not score_max > 0 or score_err > 1e-5 * score_max:
        raise AssertionError(f"CUDA and CPU peak scores differ by {score_err} "
                             f"(largest {score_max})")
    n_peak_kps, err = compare_rows(gpu_rows, cpu_rows, "device path")
    box_err = max(box_err, err)
    if box_err > 1e-4:
        raise AssertionError(f"CUDA and CPU boxes differ by {box_err}")
    if gpu_metrics.keys() != cpu_metrics.keys() or any(
            abs(gpu_metrics[k] - cpu_metrics[k]) > 1e-6 for k in gpu_metrics):
        raise AssertionError(f"OKS stats differ: {gpu_metrics} {cpu_metrics}")
    if not gpu.escalated or gpu.escalated != cpu.escalated:
        raise AssertionError(f"escalated images: CUDA {gpu.escalated}, CPU "
                             f"{cpu.escalated}; expected the same, not none")
    n_kps = 17 * len(gpu_rows)
    if n_peak_kps < n_kps // 10:
        raise AssertionError(f"only {n_peak_kps} of {n_kps} keypoints lie on "
                             "peaks: the comparison would hold the "
                             "assignment to almost nothing")
    dispatches = len(images) + len(gpu.escalated)
    if launches != dispatches:
        raise AssertionError(f"K1 launched {launches} times for {dispatches} "
                             "image dispatches")
    log(f"eval check: CUDA Evaluator == CPU Evaluator on 2 noise images "
        f"{shapes}, resnet50 f32, inp 128, scales (0.5, 1.0, 1.5), flip, "
        f"thre1 {thre1:.3e}: {len(gpu_rows)} person rows equal ({n_peak_kps} "
        f"of {n_kps} keypoints on peaks, exact; boxes and the keypoints that "
        f"fall back into them max |diff| {box_err:.2e}), folded peak coords "
        f"and valid equal in {len(gpu_fetched)} fetches (scores max |diff| "
        f"{score_err:.2e} of {score_max:.2e}), OKS stats equal; images "
        f"{gpu.escalated} escalated to 32 peaks on both; K1 launched "
        f"{launches} times for {dispatches} image dispatches")
    out = {"launches": launches}

    # the host chain (K1 on every scale) and grouped dispatch (K1 once per
    # group of 2 at B = 4, and once per escalated image at B = 2)
    for name, fields, per_dispatch in (
            ("host_resize", dict(device_resize=False), 3),
            ("group_size_2", dict(group_size=2), 1)):
        vcfg = dataclasses.replace(cfg, eval=dataclasses.replace(cfg.eval, **fields))
        gpu = Evaluator(vcfg, model=gpu_model, device=device)
        hook_forwards(gpu, heads, replay=False)
        cuda_nms.launches = 0
        gpu_metrics, gpu_rows = run_coco_eval(gpu, gt, images)
        launches = cuda_nms.launches
        cpu = Evaluator(vcfg, model=cpu_model, device="cpu")
        hook_forwards(cpu, heads, replay=True)
        cpu_metrics, cpu_rows = run_coco_eval(cpu, gt, images)
        n_peak_kps, err = compare_rows(gpu_rows, cpu_rows, name)
        if err > 1e-4:
            raise AssertionError(f"{name}: CUDA and CPU boxes differ by {err}")
        if gpu_metrics.keys() != cpu_metrics.keys() or any(
                abs(gpu_metrics[k] - cpu_metrics[k]) > 1e-6 for k in gpu_metrics):
            raise AssertionError(f"{name}: OKS stats differ: {gpu_metrics} "
                                 f"{cpu_metrics}")
        if gpu.escalated != cpu.escalated:
            raise AssertionError(f"{name}: escalated images: CUDA {gpu.escalated}, "
                                 f"CPU {cpu.escalated}")
        expect = per_dispatch * len(images) + len(gpu.escalated)
        if launches != expect:
            raise AssertionError(f"{name}: K1 launched {launches} times, "
                                 f"expected {expect}")
        log(f"eval check {name}: CUDA == CPU on the same 2 images: "
            f"{len(gpu_rows)} person rows equal ({n_peak_kps} keypoints on "
            f"peaks, exact; boxes max |diff| {err:.2e}), OKS stats equal, "
            f"escalated {gpu.escalated}; K1 launched {launches} times")
        out[name] = launches
    return out


def stage_split(times, n_images: int) -> dict:
    """Per image: {stage: (device ms between its events, host ms of its
    enqueue)} for the pyramid, each scale's forward, the fold + peaks and
    the PRN + assignment, and {"host finish": (None, host ms)}."""
    dev = times.device_ms()
    names = [("pyramid", "pyramid")]
    names += [(f"forward x{sc}", f"forward {i}") for i, sc in enumerate(EVAL_SCALES)]
    names += [("fold + peaks", "fold_peaks"), ("PRN + assign", "prn_assign")]
    split = {}
    for label, name in names:
        ms = dev.get(name)
        split[label] = (None if ms is None else ms / n_images,
                        times.host_s.get(f"enqueue {name}", 0.0) * 1e3 / n_images)
    split["host finish"] = (None, times.host_s.get("finish", 0.0) * 1e3 / n_images)
    return split


def format_split(split: dict) -> str:
    return ", ".join(
        f"{k} {'-' if d is None else f'{d:.3f}'} / {h:.3f}"
        for k, (d, h) in split.items())


def device_busy(fn, top: int = 8) -> dict:
    """Wall ms of ``fn()`` under torch.profiler (CUDA activity only), the
    sum of its kernels' device ms, their ratio (the device's busy share;
    kernels that overlap on two streams count twice) and the ``top``
    kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()]
    kernel_ms = sum(ms for _, ms in rows)
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / wall_ms,
            "top": [(name[:60], ms) for name, ms in rows[:top]]}


def record_nms_inputs():
    """Make each call of K1's wrapper also keep a copy of its inputs.
    Returns the list of (boxes, valid, thresh) copies and a function that
    puts the wrapper back."""
    from multiposenet_tpu_torch.ops import cuda_nms

    calls = []
    launch = cuda_nms.nms_suppress_cuda

    def record(boxes, valid, thresh):
        calls.append((boxes.clone(), valid.clone(), thresh))
        return launch(boxes, valid, thresh)
    cuda_nms.nms_suppress_cuda = record
    return calls, lambda: setattr(cuda_nms, "nms_suppress_cuda", launch)


def check_eval_nms_inputs(calls, k: int, batches=(2,), label: str = "eval") -> int:
    """K1 against its plain twin, bit for bit, on every candidate set that
    the eval handed it: (B, k) with B in ``batches`` (an image and its
    mirror at a scale, or a group of them)."""
    if not calls:
        raise AssertionError(f"{label}: the eval never called the NMS kernel")
    errs, kept, suppressed = [], 0, 0
    for boxes, valid, thresh in calls:
        if valid.shape[1] != k or valid.shape[0] not in batches:
            raise AssertionError(f"{label}: NMS inputs of shape "
                                 f"{tuple(valid.shape)}, expected (B, {k}) with "
                                 f"B in {batches}")
        got, err = check_nms_kernel(boxes, valid, thresh, f"{label} candidates",
                                    quiet=True)
        errs.append(err)
        kept += int(got.sum())
        suppressed += int((valid & ~got).sum())
    if not suppressed:
        raise AssertionError(f"{label}: no eval candidate was suppressed: the "
                             "check would not test the suppression")
    shapes = sorted({tuple(v.shape) for _, v, _ in calls})
    log(f"kernel nms_suppress [{label} candidates]: {len(calls)} calls at "
        f"{shapes} recorded on the warm-up pass, kept={kept} "
        f"suppressed={suppressed} mismatches=0")
    return max(errs)


def time_eval_loop(ev):
    """Wrap ``ev._coco_eval_loop`` (the image loop of coco_eval, without
    reading the GT or scoring) so that each call appends its wall seconds,
    to the device's end, to the returned list."""
    loop = ev._coco_eval_loop
    seconds = []

    def timed(*args):
        t0 = time.perf_counter()
        out = loop(*args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    ev._coco_eval_loop = timed
    return seconds


def full_width_eval(model, base_cfg, card: str, device: str = "cuda") -> dict:
    """Phase 6b: coco_eval at the reference's protocol on the serving model
    (ResNet-101 FPN, bf16, channels-last): inp_size 480, 5 scales, flip,
    max_people 64, 32 peaks per joint, escalation at 128 / 256; 16 noise
    images at COCO sizes with a synthetic GT.  One warm-up pass (cuDNN
    plans of every shape), which also records K1's inputs for a check
    against the plain twin; then the timed pass through coco_eval, with the
    split by stage and its image loop timed apart from the GT and the
    scoring; then the image loop alone, pipelined and serial (no worker
    thread) over the same images, in the order serial, serial, pipelined,
    and the two under torch.profiler for the device's busy share."""
    from multiposenet_tpu_torch.data.coco_json import COCOIndex
    from multiposenet_tpu_torch.engine.evaluator import Evaluator, StageTimes
    from multiposenet_tpu_torch.eval.multiscale import get_multipliers
    from multiposenet_tpu_torch.ops import cuda_nms

    rng = np.random.RandomState(SEED + 3)
    n_images = EVAL_IMAGES
    shapes = [EVAL_SIZES[i % len(EVAL_SIZES)] for i in range(n_images)]
    images = [rng.randint(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]
    gt = synthetic_gt(shapes, rng)
    cfg = eval_config(base_cfg, INP, EVAL_SCALES,
                      peaks=dict(max_peaks_per_joint=32, escalate_max_peaks=128),
                      prn=dict(max_people=64, escalate_max_people=256))
    thre1 = calibrate_thre1(model, cfg, images, 16, device)
    cfg = dataclasses.replace(cfg, peaks=dataclasses.replace(cfg.peaks, thre1=thre1))
    ev = Evaluator(cfg, model=model, device=device)
    loop_s = time_eval_loop(ev)

    calls, restore = record_nms_inputs()
    t0 = time.perf_counter()
    try:
        run_coco_eval(ev, gt, images)
    finally:
        restore()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    nms_err = check_eval_nms_inputs(calls, cfg.detection.max_detections)
    del calls

    ev.stage_times = StageTimes()
    cuda_nms.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, rows = run_coco_eval(ev, gt, images)
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    launches = cuda_nms.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    split = stage_split(ev.stage_times, n_images)
    pipelined_s = loop_s[-1]

    check_people([[r for r in rows if r["image_id"] == i + 1]
                  for i in range(n_images)], n_images)
    stats = [metrics.get(k) for k in sorted(metrics)]
    if len(stats) != 10 or not np.isfinite(stats).all():
        raise AssertionError(f"OKS stats not 10 finite numbers: {metrics}")
    dispatches = n_images + len(ev.escalated)
    if launches != dispatches:
        raise AssertionError(f"K1 launched {launches} times for {dispatches} "
                             "image dispatches")
    log(f"coco_eval: {n_images} images {sorted(set(shapes))} at inp {INP}, "
        f"scales {EVAL_SCALES}, flip, {cfg.model.backbone} "
        f"{str(cfg.model.compute_dtype).split('.')[-1]}, max_people 64, peaks "
        f"32 (escalation 128/256), thre1 {thre1:.3e}: "
        f"{timed_s / n_images * 1e3:.2f} ms/image wall ({timed_s:.3f} s; "
        f"warm-up pass {warm_s:.1f} s), of which the image loop "
        f"{pipelined_s / n_images * 1e3:.2f} ms/image and the GT, scoring and "
        f"result JSON {(timed_s - pipelined_s) / n_images * 1e3:.2f} ms/image; "
        f"per image, ms on the device between "
        f"each stage's events / ms of host enqueue: {format_split(split)}; "
        f"K1 launches {launches} for {dispatches} image dispatches "
        f"({len(ev.escalated)} escalated); {len(rows)} person rows; peak "
        f"memory {peak_gib:.2f} GiB; OKS "
        + " ".join(f"{k} {metrics[k]:.4f}" for k in metrics) + f" [{card}]")

    # the image loop alone over the same images, as coco_eval runs it
    # (pipelined: a worker thread fetches and finishes image n while image
    # n + 1 is dispatched) and one image at a time (serial)
    index = COCOIndex(dataset=gt)
    img_ids = index.get_img_ids(cat_ids=[1])
    by_name = {rec["file_name"]: img for rec, img in zip(gt["images"], images)}

    def pipelined():
        ev._coco_eval_loop(index, img_ids, by_name.__getitem__, 64)

    def serial():
        with torch.no_grad():
            for img_id in img_ids:
                name = index.load_imgs(img_id)[0]["file_name"]
                img = by_name[name]
                mult = get_multipliers(img.shape[0], INP, EVAL_SCALES)
                ev._fetch_finish_escalating(
                    ev._dispatch_image_device(mult, img, with_flip=True), img,
                    mult, 64, name, img_id)
        torch.cuda.synchronize()

    def wall_s(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    # with the stage events on, as in the timed pass: its split beside this
    ev.stage_times = StageTimes()
    serial_on_s = wall_s(serial)
    serial_split = stage_split(ev.stage_times, n_images)
    ev.stage_times = None
    serial_off_s = wall_s(serial)
    pipelined()
    pipelined_off_s = loop_s[-1]
    ms = lambda s: f"{s / n_images * 1e3:.2f}"  # noqa: E731
    log(f"coco_eval image loop, ms/image wall, pipelined / serial over the "
        f"same {n_images} images: {ms(pipelined_s)} / {ms(serial_on_s)} with "
        f"the stage events on (pipelined from the timed pass), "
        f"{ms(pipelined_off_s)} / {ms(serial_off_s)} with them off; serial, "
        f"per image, device ms / host enqueue ms: {format_split(serial_split)} "
        f"[{card}]")
    busy = {"pipelined": device_busy(pipelined), "serial": device_busy(serial)}
    for name, b in busy.items():
        log(f"coco_eval image loop, {name}, profiled (CUDA activity only): "
            f"{b['wall_ms'] / n_images:.2f} ms/image wall, kernels "
            f"{b['kernel_ms'] / n_images:.2f} ms/image: device busy share "
            f"{b['busy_share']:.3f}; top kernels by device ms/image: "
            + ", ".join(f"{k} {v / n_images:.3f}" for k, v in b["top"])
            + f" [{card}]")

    return {"launches": launches, "max_abs_err": nms_err,
            "ms_per_image": timed_s / n_images * 1e3,
            "loop_ms_per_image": pipelined_s / n_images * 1e3,
            "split_ms": split, "serial_ms_per_image": serial_on_s / n_images * 1e3,
            "serial_split_ms": serial_split, "escalated": len(ev.escalated),
            "images": images, "gt": gt, "cfg": cfg}


# ---------------------------------------------------------------- phase 6c

# variant -> (eval / prn fields, K1 launches per image dispatch (per group
# with group_size), batch rows per launch)
EVAL_VARIANTS = {
    "default": ({}, 1, 2),
    "host_peaks": (dict(eval=dict(device_peaks=False)), 1, 2),
    "host_image_resize": (dict(eval=dict(device_image_resize=False)), 1, 2),
    "host_grouping": (dict(prn=dict(device_grouping=False)), 1, 2),
    "host_resize": (dict(eval=dict(device_resize=False)), len(EVAL_SCALES), 2),
    "detect_all_scales": (dict(eval=dict(detect_scale1_only=False)),
                          len(EVAL_SCALES), 2),
    "group_size_4": (dict(eval=dict(group_size=4)), 1, 8),
}
# variants run once, K1's inputs recorded on the timed pass: they run the
# default path's forward shapes (their cuDNN plans are made) and differ on
# the host, where the host chain takes seconds an image, so a warm-up pass
# would double the phase's longest part
ONE_PASS_VARIANTS = {"host_peaks", "host_image_resize", "host_grouping",
                     "host_resize"}
# a keypoint at full resolution sits on the smooth top of an upsampled peak,
# where the input's rounding moves the maximum by a pixel
NEAR_PX = 2
# rows equal to the default path's exactly: the same device numbers reach
# the same (or, for host grouping, the reference's host) assignment
EXACT_VARIANTS = ("detect_all_scales", "host_grouping")


def row_agreement(rows, ref) -> dict:
    """Rows of a variant against the default path's, each matched to the
    default row of its image with the nearest box (a box's score, and so
    the rows' order, moves with the input's rounding): the rows of each,
    the share of matched keypoints equal in x, y and v, the largest |diff|
    of the matched keypoints visible in both and of the matched boxes, and
    the share with equal v within ``NEAR_PX`` pixels."""
    free = {}
    for r in ref:
        free.setdefault(r["image_id"], []).append(r)
    n_kps = n_equal = n_near = 0
    kp_err = box_err = 0.0
    for r in rows:
        cands = free.get(r["image_id"], [])
        if not cands:
            continue
        d = [float(np.abs(np.subtract(r["bbox"], c["bbox"])).max()) for c in cands]
        w = cands.pop(int(np.argmin(d)))
        box_err = max(box_err, min(d))
        a, b = np.reshape(r["keypoints"], (17, 3)), np.reshape(w["keypoints"], (17, 3))
        n_kps += 17
        n_equal += int((a == b).all(axis=1).sum())
        n_near += int(((a[:, 2] == b[:, 2])
                       & (np.abs(a[:, :2] - b[:, :2]) <= NEAR_PX).all(axis=1)).sum())
        both = (a[:, 2] > 0) & (b[:, 2] > 0)
        kp_err = max(kp_err, float(np.abs(a[both, :2] - b[both, :2]).max(initial=0.0)))
    return {"rows": len(rows), "ref_rows": len(ref),
            "kp_equal_share": n_equal / max(n_kps, 1),
            "kp_near_share": n_near / max(n_kps, 1), "kp_max_diff": kp_err,
            "box_max_diff": box_err}


def eval_variants(model, full_eval: dict, card: str, device: str = "cuda") -> dict:
    """Phase 6c: every evaluator variant at 6b's full width (its model and
    configuration, the joints' heatmaps evened out and the threshold set
    anew as in 6a) on 4 of 6b's images of one size, so that
    ``group_size`` 4 makes one group.  Per variant: a warm-up pass (cuDNN
    plans of new shapes), whose K1 inputs are held against the plain twin
    (on the timed pass for ``ONE_PASS_VARIANTS``); a timed pass, whose K1
    launches must be those of its path; its rows
    against the default path's (equal for the variants that compute the
    same numbers; for the others, whose inputs or peak finder differ, the
    agreement is printed and a gross fault — a wrong image, mirror or
    scale, which scrambles most keypoints — fails it).  The device's busy
    share of the default and the grouped image loop; then ``cli test`` on
    demo/test_images with its two PNGs per image."""
    import tempfile

    from multiposenet_tpu_torch import cli
    from multiposenet_tpu_torch.data.coco_json import COCOIndex
    from multiposenet_tpu_torch.data.image_io import read_image
    from multiposenet_tpu_torch.engine.evaluator import Evaluator
    from multiposenet_tpu_torch.ops import cuda_nms

    t_phase = time.perf_counter()
    first = full_eval["images"][0].shape[:2]
    pick = [i for i, img in enumerate(full_eval["images"])
            if img.shape[:2] == first][:4]
    images = [full_eval["images"][i] for i in pick]
    ids = {i + 1 for i in pick}
    src = full_eval["gt"]
    gt = {"images": [r for r in src["images"] if r["id"] in ids],
          "annotations": [a for a in src["annotations"] if a["image_id"] in ids],
          "categories": src["categories"]}
    base = full_eval["cfg"]
    # 6b's threshold leaves peaks on the neck alone, the most crowded joint
    # of the random model, and the rows drop the neck: even the joints out
    # as 6a does (the model is not used after this phase), so that the rows
    # hold keypoints on peaks for the variants to agree on
    spread_keypoint_heads(model, base, images, 16, device)
    thre1 = calibrate_thre1(model, base, images, 16, device)
    base = dataclasses.replace(base, peaks=dataclasses.replace(base.peaks, thre1=thre1))
    k = base.detection.max_detections
    n = len(images)
    results, out = {}, {}
    for name, (sections, per_dispatch, batch) in EVAL_VARIANTS.items():
        cfg = base
        for section, fields in sections.items():
            cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
                getattr(cfg, section), **fields)})
        ev = Evaluator(cfg, model=model, device=device)
        loop_s = time_eval_loop(ev)
        calls, restore = record_nms_inputs()
        try:
            if name not in ONE_PASS_VARIANTS:
                run_coco_eval(ev, gt, images)        # warm-up: K1's inputs
                restore()
            cuda_nms.launches = 0
            metrics, rows = run_coco_eval(ev, gt, images)
            launches = cuda_nms.launches
        finally:
            restore()
        nms_err = check_eval_nms_inputs(calls, k, (2, batch), name)
        del calls
        # an escalated image is dispatched again alone, on the per-image path
        grouped = name.startswith("group")
        expect = ((1 if grouped else n) * per_dispatch
                  + (1 if grouped else per_dispatch) * len(ev.escalated))
        if launches != expect:
            raise AssertionError(f"{name}: K1 launched {launches} times for {n} "
                                 f"images ({len(ev.escalated)} escalated), "
                                 f"expected {expect}")
        check_people([[r for r in rows if r["image_id"] == i + 1] for i in pick], n)
        results[name] = rows
        out[name] = {"launches": launches, "ms_per_image": loop_s[-1] / n * 1e3,
                     "escalated": len(ev.escalated), "max_abs_err": nms_err,
                     "evaluator": ev}
        if name == "default":
            # ~90 boxes an image share ~16 peaks a joint: most keypoints
            # fall back into their box, but a person's worth per image must
            # lie on peaks for the comparisons to hold the peaks at all
            kps = np.array([r["keypoints"][2::3] for r in rows])
            on_peak = int((kps > 0).sum())
            if on_peak < 17 * n:
                raise AssertionError(f"only {on_peak} of {kps.size} keypoints lie "
                                     "on peaks: the variants' rows would agree "
                                     "on almost nothing")
            agree = (f"the reference: {on_peak} of {kps.size} keypoints on peaks, "
                     f"thre1 {thre1:.3e}")
        elif name in EXACT_VARIANTS:
            n_peak, err = compare_rows(rows, results["default"], name)
            if err > 1e-4:
                raise AssertionError(f"{name}: boxes differ from the default "
                                     f"path's by {err}")
            agree = f"rows equal to the default path's ({n_peak} keypoints on peaks)"
        else:
            a = row_agreement(rows, results["default"])
            out[name]["agreement"] = a
            if a["kp_near_share"] < 0.5:
                raise AssertionError(f"{name}: rows disagree with the default "
                                     f"path's beyond rounding: {a}")
            agree = (f"against the default path: {a['rows']} / {a['ref_rows']} "
                     f"rows, keypoints equal {a['kp_equal_share']:.4f}, within "
                     f"{NEAR_PX} px {a['kp_near_share']:.4f}, largest "
                     f"keypoint |diff| {a['kp_max_diff']:.1f} px, box "
                     f"{a['box_max_diff']:.3e}")
        log(f"eval variant {name}: {n} images {images[0].shape[:2]}, "
            f"{out[name]['ms_per_image']:.2f} ms/image wall (image loop, to the "
            f"device's end), K1 launches {launches} (expected {expect}, "
            f"{len(ev.escalated)} escalated), {len(rows)} person rows, AP "
            f"{metrics.get('AP', float('nan')):.4f}; {agree} [{card}]")

    index = COCOIndex(dataset=gt)
    img_ids = index.get_img_ids(cat_ids=[1])
    by_name = {rec["file_name"]: img for rec, img in zip(gt["images"], images)}
    for name in ("default", "group_size_4"):
        ev = out[name]["evaluator"]
        b = device_busy(lambda: ev._coco_eval_loop(index, img_ids,
                                                   by_name.__getitem__, 64))
        out[name]["busy"] = b
        log(f"eval variant {name}, image loop profiled (CUDA activity only): "
            f"{b['wall_ms'] / n:.2f} ms/image wall, kernels {b['kernel_ms'] / n:.2f} "
            f"ms/image: device busy share {b['busy_share']:.3f}; top kernels by "
            f"device ms/image: " + ", ".join(f"{kk} {v / n:.3f}" for kk, v in b["top"])
            + f" [{card}]")
    for v in out.values():
        del v["evaluator"]

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demo", "test_images")
    with tempfile.TemporaryDirectory() as tmp:
        cuda_nms.launches = 0
        people = cli.main(["test", "--testdata", data, "--testresult", tmp])
        test_launches = cuda_nms.launches
        names = sorted(f for f in os.listdir(data) if f.endswith(".png"))
        for f in names:
            h, w = read_image(os.path.join(data, f)).shape[:2]
            stem = os.path.join(tmp, f.split(".", 1)[0])
            hm = read_image(stem + "_1heatmap.png", 0)
            canvas = read_image(stem + "_2canvas.png")
            if hm is None or canvas is None or hm.shape != (h, w) or \
                    canvas.shape != (h, w, 3):
                raise AssertionError(f"cli test: {f} ({h}x{w}) gave heatmap "
                                     f"{None if hm is None else hm.shape} and canvas "
                                     f"{None if canvas is None else canvas.shape}")
        if test_launches < len(names):
            raise AssertionError(f"cli test launched K1 {test_launches} times for "
                                 f"{len(names)} images")
    log(f"cli test on demo/test_images: {len(names)} images, {len(people)} people, "
        f"<stem>_1heatmap.png and <stem>_2canvas.png decode at each image's size; "
        f"K1 launched {test_launches} times; phase 6c wall "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"variants": out, "cli_test_launches": test_launches}


# ---------------------------------------------------------------- phase 7

TRAIN_STAGES = ("keypoint", "detection", "prn")
# 7b: steps of the warm-up epoch, the timed epoch and the profiled epoch
# cut from 3 + 20 + 8, then from 3 + 12 + 6 and 3 + 8 + 4, for phases 11
# and 12's time
TRAIN_EPOCH_STEPS = (2, 6, 3)
CHECK_LR = 1e-4


def train_batch(stage: str, cfg, b: int, rng: np.random.RandomState) -> dict:
    """A synthetic batch of ``stage`` as a data loader hands it to the
    trainer: numpy arrays on the host.  Keypoint: 3 people of random
    joints (v 0 or 1) in ``max_people`` slots, a mask in [0.5, 1);
    detection: 1-4 person boxes in ``max_gt_boxes`` rows padded with -1;
    PRN: sparse one-hot marks."""
    size = cfg.data.inp_size
    if stage == "keypoint":
        joints = np.full((b, cfg.data.max_people, 18, 3), 2.0, np.float32)
        joints[:, :3, :, :2] = rng.uniform(0, size, (b, 3, 18, 2))
        joints[:, :3, :, 2] = rng.randint(0, 2, (b, 3, 18))
        return {"image": rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8),
                "joints": joints,
                "mask": rng.uniform(0.5, 1.0, (b, size // 4, size // 4)
                                    ).astype(np.float32)}
    if stage == "detection":
        boxes = np.full((b, cfg.data.max_gt_boxes, 5), -1.0, np.float32)
        for i in range(b):
            n = rng.randint(1, 5)
            xy = rng.uniform(0, 0.6 * size, (n, 2))
            boxes[i, :n, :2] = xy
            boxes[i, :n, 2:4] = xy + rng.uniform(0.1 * size, 0.4 * size, (n, 2))
            boxes[i, :n, 4] = 0.0
        return {"image": rng.randint(0, 256, (b, size, size, 3), dtype=np.uint8),
                "boxes": boxes}
    gh, gw = cfg.model.prn_height, cfg.model.prn_width
    return {"weights_marks": (rng.rand(b, gh, gw, 17) > 0.99).astype(np.float32),
            "label_marks": (rng.rand(b, gh, gw, 17) > 0.995).astype(np.float32)}


def one_train_step(cfg, stage: str, start: dict, batch: dict, device: str,
                   dtype=torch.float32):
    """One train step of ``stage`` from the weights ``start`` on ``device``;
    returns its logs as floats, the state_dict after it and the trainable
    parameters' gradients, on the CPU."""
    from multiposenet_tpu_torch.engine import train_steps as ts
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet

    model = build_trainable_posenet(cfg.model, torch.device(device), start).to(dtype)
    state = ts.create_train_state(cfg, stage, model=model)
    step, _ = ts.STEP_FACTORIES[stage](cfg, device=device)
    extra = (torch.Generator(device).manual_seed(0),) if stage == "prn" else ()
    _, logs = step(state, batch, CHECK_LR, *extra)
    return ({k: float(v) for k, v in logs.items()},
            {k: v.detach().cpu() for k, v in model.state_dict().items()},
            {k: p.grad.detach().cpu() for k, p in model.named_parameters()
             if p.grad is not None})


def compare_train_steps(stage: str, start: dict, a, b, update_tol,
                        max_share: float, stats_rtol: float,
                        grad_rtol=None) -> dict:
    """Hold step ``a`` (the card) against step ``b`` (the CPU): the loss to
    1e-4 and the other logs to 1e-3 relative; frozen parameters
    bit-unchanged on both; running statistics within ``stats_rtol`` of each
    tensor's largest value (keypoint) or bit-unchanged.  The trainable
    parameters' updates: at most ``max_share`` of their elements off by
    more than 1e-2 lr, and none by more than ``update_tol`` lr (None: by
    more than one Adam step can move it both ways, 2 lr).  With
    ``grad_rtol`` the trainable gradients too, which Adam's first step
    reduces to about their sign: each tensor within ``grad_rtol`` of its
    largest CPU gradient, or of 1e-9 of the stage's largest where that is
    larger."""
    from multiposenet_tpu_torch.engine.train_steps import is_trainable

    (la, sa, ga), (lb, sb, gb) = a, b
    for k in lb:
        tol = 1e-4 if k == "loss" else 1e-3
        if not (np.isfinite(la[k]) and abs(la[k] - lb[k]) <= tol * abs(lb[k])):
            raise AssertionError(f"{stage} step: {k} {la[k]} on the card, "
                                 f"{lb[k]} on the CPU")
    worst, worst_key, off, n = 0.0, "", 0, 0
    for k, x in start.items():
        if k.endswith("num_batches_tracked"):
            continue
        x = x.to(sa[k].dtype)
        if k.endswith(("running_mean", "running_var")):
            if stage != "keypoint":
                if not (torch.equal(sa[k], x) and torch.equal(sb[k], x)):
                    raise AssertionError(f"{stage} step moved {k}")
            elif (sa[k] - sb[k]).abs().max() > stats_rtol * sb[k].abs().max():
                raise AssertionError(f"{stage} step: {k} differs")
            continue
        if not is_trainable(k, stage):
            if not (torch.equal(sa[k], x) and torch.equal(sb[k], x)):
                raise AssertionError(f"{stage} step moved frozen {k}")
            continue
        d = ((sa[k] - x) - (sb[k] - x)).abs().double() / CHECK_LR
        if float(d.max()) > worst:
            worst, worst_key = float(d.max()), k
        off += int((d > 1e-2).sum())
        n += d.numel()
    limit = 2.0 + 1e-3 if update_tol is None else update_tol
    if worst > limit or off > max_share * n:
        raise AssertionError(f"{stage} step: {off} of {n} update elements off "
                             f"by more than 1e-2 lr, the most {worst:.3g} lr "
                             f"in {worst_key}")
    out = {"worst_update_lr": worst, "worst_key": worst_key, "share_off": off / n}
    if grad_rtol is not None:
        if set(ga) != set(gb) or not gb:
            raise AssertionError(f"{stage} step: gradients of {sorted(ga)} on "
                                 f"the card, of {sorted(gb)} on the CPU")
        top = max(float(g.abs().max()) for g in gb.values())
        rel = {k: float((ga[k] - g).abs().max())
               / max(float(g.abs().max()), 1e-9 * top) for k, g in gb.items()}
        k = max(rel, key=rel.get)
        if rel[k] > grad_rtol:
            raise AssertionError(f"{stage} step: gradient of {k} off by "
                                 f"{rel[k]:.3g} of its largest value")
        out.update(worst_grad_rel=rel[k], worst_grad_key=k)
    return out


def check_training_against_cpu(device: str = "cuda") -> None:
    """Phase 7a: one train step of each stage on the card and on the CPU
    from the same seeded weights (detection output convs drawn at std 0.01,
    so that gradients reach every trainable layer) and batch: resnet50,
    96 px, batch 2, TF32 off, PRN dropout off; float32, then float64.  In
    float32 the two devices round differently and a few elements flip: a
    ReLU gate of a value near zero, or the keypoint stage's ill-conditioned
    gradient (BatchNorm on 18 values per channel in layer4), and Adam moves
    each element by about lr whatever its gradient's size.  So at most 1% of
    the update elements may be off by more than 1e-2 lr; in float64 none
    may be off by more than 5e-2 lr, and each trainable gradient is within
    1e-6 of its tensor's largest CPU value."""
    from multiposenet_tpu_torch.config import Config, DataConfig, ModelConfig
    from multiposenet_tpu_torch.engine.inference import full_fp32_matmul
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet

    cfg = Config(model=ModelConfig(backbone="resnet50", prn_dropout=0.0),
                 data=DataConfig(inp_size=96, max_people=4, max_gt_boxes=8))
    cfg64 = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=torch.float64))
    start = build_trainable_posenet(cfg.model, torch.device("cpu"), seed=SEED + 7,
                                    head_output_std=0.01).state_dict()
    rng = np.random.RandomState(SEED + 7)
    report = []
    with full_fp32_matmul():
        for stage in TRAIN_STAGES:
            batch = train_batch(stage, cfg, 2, rng)
            for c, dtype, tol, share in ((cfg, torch.float32, None, 1e-2),
                                         (cfg64, torch.float64, 5e-2, 0.0)):
                f64 = dtype == torch.float64
                a = one_train_step(c, stage, start, batch, device, dtype)
                b = one_train_step(c, stage, start, batch, "cpu", dtype)
                got = compare_train_steps(stage, start, a, b, tol, share,
                                          1e-9 if f64 else 2e-3,
                                          grad_rtol=1e-6 if f64 else None)
                report.append(
                    f"{stage} {str(dtype).split('.')[-1]} loss "
                    f"{a[0]['loss']:.10g} / {b[0]['loss']:.10g}, updates "
                    f"{100 * got['share_off']:.4f}% off by > 1e-2 lr, max "
                    f"{got['worst_update_lr']:.3g} lr ({got['worst_key']})"
                    + (f", gradients within {got['worst_grad_rel']:.3g} of "
                       f"each tensor's largest ({got['worst_grad_key']})"
                       if f64 else ""))
    log("train check: one step per stage, CUDA / CPU, resnet50 96 px batch 2, "
        "TF32 off, lr 1e-4, frozen parameters bit-unchanged on both: "
        + "; ".join(report))


class EpochBatches:
    """In-memory training data: epoch ``e`` yields ``counts[e]`` batches,
    cycling through ``pool``."""

    def __init__(self, pool, counts):
        self.pool, self.counts, self.epoch = pool, counts, 0

    def __len__(self):
        return self.counts[min(self.epoch, len(self.counts) - 1)]

    def __iter__(self):
        n = len(self)
        self.epoch += 1
        return (self.pool[i % len(self.pool)] for i in range(n))


def train_stage(cfg, stage: str, init_ckpt, save_root: str, card: str,
                device: str = "cuda") -> dict:
    """One stage of 7b through ``Trainer.train``: a warm-up epoch, an epoch
    timed with CUDA events around every step, an epoch under
    torch.profiler, then the checkpoint, the validation and the best copy
    of the last epoch.  Returns the stage's numbers and its checkpoint."""
    from torch.profiler import ProfilerActivity, profile

    from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
    from multiposenet_tpu_torch.engine.train_steps import is_trainable
    from multiposenet_tpu_torch.engine.trainer import Trainer

    b = cfg.train.batch_size
    rng = np.random.RandomState(SEED + 10 + TRAIN_STAGES.index(stage))
    pool = [train_batch(stage, cfg, b, rng) for _ in range(3)]
    t0 = time.perf_counter()
    trainer = Trainer(cfg, train_data=EpochBatches(pool, TRAIN_EPOCH_STEPS),
                      val_data=pool[:1], init_ckpt_params=init_ckpt, device=device)
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    events, losses, marks = [], [], {}
    step_fn = trainer.train_step

    def timed_step(state, batch, *args):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step_fn(state, batch, *args)
        ev[1].record()
        events.append((trainer.last_epoch, ev))
        losses.append(out[1]["loss"])
        return out
    trainer.train_step = timed_step
    prof = profile(activities=[ProfilerActivity.CUDA])

    def on_start(tr):
        torch.cuda.synchronize()
        if tr.last_epoch == 2:
            torch.cuda.reset_peak_memory_stats()
        if tr.last_epoch == 3:
            prof.start()
        marks[tr.last_epoch] = time.perf_counter()

    def on_end(tr):
        torch.cuda.synchronize()
        marks[tr.last_epoch] = time.perf_counter() - marks[tr.last_epoch]
        if tr.last_epoch == 2:
            marks["peak"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if tr.last_epoch == 3:
            prof.stop()
    trainer.on_start_epoch_hooks.append(on_start)
    trainer.on_end_epoch_hooks.append(on_end)
    trainer.train()
    total_s = time.perf_counter() - t0

    loss = torch.stack([x.float() for x in losses]).cpu()
    if not torch.isfinite(loss).all():
        raise AssertionError(f"{stage}: a non-finite loss in {loss.tolist()}")
    end = trainer.model.state_dict()
    moved = set()
    for k, v in end.items():
        bn = k.endswith(("running_mean", "running_var", "num_batches_tracked"))
        if bn and stage == "keypoint":
            continue
        if bn or not is_trainable(k, stage):
            if not torch.equal(v, start[k]):
                raise AssertionError(f"{stage} stage changed {k}, not its own")
        elif not torch.equal(v, start[k]):
            moved.add(k)
    if not moved:
        raise AssertionError(f"{stage} stage trained nothing")

    timed = [ev for epoch, ev in events if epoch == 2]
    ms = timed[0][0].elapsed_time(timed[-1][1]) / len(timed)
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()]
    kernel_ms = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    n_prof = TRAIN_EPOCH_STEPS[2]

    # one checkpoint save of the whole train state, as the trainer makes it
    t1 = time.perf_counter()
    fut = trainer.saver.save(os.path.join(save_root, "timing"), trainer.state, 0)
    enqueue_ms = (time.perf_counter() - t1) * 1e3
    fut.result()
    save_ms = (time.perf_counter() - t1) * 1e3
    ckpt = ckpt_lib.latest_checkpoint(trainer.save_dir)

    fell = None
    if stage == "keypoint":
        fixed = [step_fn(trainer.state, pool[0], CHECK_LR)[1]["loss"] for _ in range(3)]
        fell = [float(x) for x in fixed]
        if not fell[-1] < fell[0]:
            raise AssertionError(f"keypoint loss did not fall over 3 steps: {fell}")
    unit = "samples" if stage == "prn" else "images"
    size = "" if stage == "prn" else f" {cfg.data.inp_size} px"
    log(f"train {stage}: {cfg.model.backbone}{size} batch {b} "
        f"{str(cfg.model.compute_dtype).split('.')[-1]} through Trainer.train "
        f"({' + '.join(map(str, TRAIN_EPOCH_STEPS))} steps, lr {cfg.train.init_lr:g}, "
        f"TF32 convs {torch.backends.cudnn.allow_tf32}, TF32 matmuls "
        f"{torch.backends.cuda.matmul.allow_tf32}): {ms:.2f} ms/step between "
        f"CUDA events over {len(timed)} steps = {b / ms * 1e3:.1f} {unit}/s; "
        f"wall {marks[2] / len(timed) * 1e3:.2f} ms/step; peak memory "
        f"{marks['peak']:.2f} GiB; profiled {n_prof} steps: wall "
        f"{marks[3] / n_prof * 1e3:.2f} ms/step, kernels {kernel_ms / n_prof:.2f} "
        f"ms/step, device busy share {kernel_ms / (marks[3] * 1e3):.3f}; top "
        f"kernels ms/step: " + ", ".join(f"{k[:50]} {v / n_prof:.3f}" for k, v in rows[:6])
        + f"; one AsyncSaver save {save_ms:.0f} ms ({enqueue_ms:.1f} ms on the "
        f"caller); losses {loss[0]:.5g} -> {loss[-1]:.5g}, all finite; "
        f"{len(moved)} tensors of its own groups moved, every other bit-unchanged"
        + (f"; fixed-batch losses at lr 1e-4 {fell}" if fell else "")
        + f"; stage wall {total_s:.1f} s [{card}]")
    return {"ms_per_step": ms, "ckpt": ckpt, "peak_gib": marks["peak"],
            "busy_share": kernel_ms / (marks[3] * 1e3)}


def full_width_training(card: str, device: str = "cuda", configs=None) -> dict:
    """Phase 7b: the reference's stage chain at its configurations, ResNet-101
    FPN float32: keypoint (480 px, batch 6), then detection (608 px, batch
    25) from the keypoint checkpoint, then PRN (batch 8) from the detection
    checkpoint, each through Trainer on in-memory synthetic batches."""
    import shutil

    from multiposenet_tpu_torch.config import (
        detection_train_config, keypoint_train_config, prn_train_config)

    configs = configs or {"keypoint": keypoint_train_config(),
                          "detection": detection_train_config(),
                          "prn": prn_train_config()}
    save_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "extra", "chip_smoke_train")
    shutil.rmtree(save_root, ignore_errors=True)
    out, ckpt = {}, None
    try:
        for stage in TRAIN_STAGES:
            cfg = configs[stage]
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, max_epoch=len(TRAIN_EPOCH_STEPS),
                save_freq_epoch=len(TRAIN_EPOCH_STEPS), val_nbatch_end_epoch=1,
                val_freq=0, save_freq_step=10 ** 9, print_freq=10 ** 9,
                save_dir=save_root, exp_name=stage, seed=SEED))
            out[stage] = train_stage(cfg, stage, ckpt, save_root, card, device)
            ckpt = out[stage]["ckpt"]
    finally:
        shutil.rmtree(save_root, ignore_errors=True)
    return out


# ---------------------------------------------------------------- phase 8

# every row filter, Average and Paeth on few rows (they decode byte by byte)
PNG_FILTERS = (3, 4) + (1, 2, 0) * 300
# COCO image sizes of the synthetic tree, (h, w)
SYNTH_SIZES = ((480, 640), (640, 480), (427, 640))
# a standing figure in units of body height, COCO keypoint order
SYNTH_BODY = np.array([
    (0.00, 0.06), (0.03, 0.04), (-0.03, 0.04), (0.055, 0.06), (-0.055, 0.06),
    (0.11, 0.18), (-0.11, 0.18), (0.17, 0.33), (-0.17, 0.33), (0.20, 0.47),
    (-0.20, 0.47), (0.07, 0.52), (-0.07, 0.52), (0.09, 0.73), (-0.09, 0.73),
    (0.09, 0.95), (-0.09, 0.95)])
SYNTH_LIMBS = ((15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11),
               (6, 12), (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (0, 1),
               (0, 2), (1, 3), (2, 4))


def synth_person(rng: np.random.RandomState, h: int, w: int, tall) -> tuple:
    """A figure of body height in ``tall`` inside an (h, w) image:
    (17, 3) keypoints (v = 2, some 1) and its height."""
    size = rng.uniform(*tall)
    t = np.deg2rad(rng.uniform(-15, 15))
    pts = (SYNTH_BODY + rng.uniform(-0.03, 0.03, (17, 2))) * size
    pts = pts @ np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]).T
    lo, hi = pts.min(0), pts.max(0)
    pts += [rng.uniform(8 - lo[0], w - 8 - hi[0]), rng.uniform(8 - lo[1], h - 8 - hi[1])]
    vis = np.where(rng.rand(17) < 0.1, 1.0, 2.0)
    return np.concatenate([pts, vis[:, None]], axis=1), size


def draw_person(img: np.ndarray, kp: np.ndarray, size: float,
                rng: np.random.RandomState) -> np.ndarray:
    """Draw limbs as thick segments and joints as discs of fixed colours;
    returns the figure's silhouette."""
    h, w = img.shape[:2]
    shape = np.zeros((h, w), bool)

    def stamp(target, p, q, radius):
        """Set the pixels of ``target`` within ``radius`` of segment pq."""
        x0, y0 = np.floor(np.minimum(p, q) - radius).astype(int)
        x1, y1 = np.ceil(np.maximum(p, q) + radius).astype(int) + 1
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
        ys, xs = np.mgrid[y0:y1, x0:x1]
        d = q - p
        t = np.clip(((xs - p[0]) * d[0] + (ys - p[1]) * d[1]) / max(d @ d, 1e-6), 0, 1)
        hit = (xs - p[0] - t * d[0]) ** 2 + (ys - p[1] - t * d[1]) ** 2 <= radius ** 2
        target[y0:y1, x0:x1] |= hit
        return (slice(y0, y1), slice(x0, x1)), hit

    for i, j in SYNTH_LIMBS:
        stamp(shape, kp[i, :2], kp[j, :2], max(2.0, size / 36))
    stamp(shape, kp[0, :2], kp[0, :2], 0.055 * size)
    img[shape] = rng.randint(60, 140, 3)
    for j in range(17):
        disc = np.zeros((h, w), bool)
        win, hit = stamp(disc, kp[j, :2], kp[j, :2], max(2.0, size / 45))
        img[win][hit] = ((37 * j) % 256, (91 * j + 80) % 256, (53 * j + 160) % 256)
    return shape


def smooth_background(rng: np.random.RandomState, h: int, w: int) -> np.ndarray:
    """A bilinear blend of a random 4 x 4 colour grid plus mild noise."""
    grid = rng.uniform(30, 225, (4, 4, 3))

    def axis(n):
        t = np.linspace(0, 3, n)
        i = np.minimum(t.astype(int), 2)
        return i, (t - i)[:, None]
    iy, fy = axis(h)
    ix, fx = axis(w)
    rows = grid[:, ix] * (1 - fx)[None] + grid[:, ix + 1] * fx[None]
    bg = rows[iy] * (1 - fy)[:, :, None] + rows[iy + 1] * fy[:, :, None]
    return np.clip(bg + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def write_synthetic_coco(root: str, n_train: int, n_val: int, seed: int = SEED,
                         sizes=SYNTH_SIZES, tall=(150.0, 340.0)) -> dict:
    """A COCO tree in the layout of tools/make_synth_pose_dataset.py with
    PNG files, written without cv2 (``write_png``): drawn people on smooth
    backgrounds; per image a CMU-style keypoint record per person in
    ``COCO.json`` and a ``mask2014`` mask_miss PNG; polygon and RLE
    (compressed and counts-list) segmentations in
    ``annotations/person_keypoints_{train,val}2017.json``, with one crowd
    annotation, whose region mask_miss zeroes.  Returns the counts."""
    import shutil

    from multiposenet_tpu_torch.data.rle import encode_rle

    rng = np.random.RandomState(seed)
    for d in ("images/val2017", "mask2014", "annotations", "train2017", "val2017"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    records = []
    coco = {s: {"images": [], "annotations": []} for s in ("train2017", "val2017")}
    n_ann = 0
    for i in range(n_train + n_val):
        val = i >= n_train
        split, tag = ("val2017", "val") if val else ("train2017", "train")
        h, w = sizes[i % len(sizes)]
        img = smooth_background(rng, h, w)
        mask_miss = np.full((h, w), 255, np.uint8)
        people = [synth_person(rng, h, w, tall) for _ in range(1 + i % 3)]
        stem = f"{i:012d}"
        coco[split]["images"].append({"id": i, "file_name": f"{stem}.png",
                                      "width": w, "height": h})
        for p, (kp, size) in enumerate(people):
            shape = draw_person(img, kp, size, rng)
            n_ann += 1
            x0, y0 = kp[:, :2].min(0) - 4
            x1, y1 = kp[:, :2].max(0) + 4
            if p % 2:
                segm = [[float(x0), float(y0), float(x1), float(y0),
                         float(x1), float(y1), float(x0), float(y1)]]
            else:
                segm = encode_rle(shape.astype(np.uint8))
            coco[split]["annotations"].append({
                "id": n_ann, "image_id": i, "category_id": 1, "iscrowd": 0,
                "num_keypoints": 17, "keypoints": kp.reshape(-1).tolist(),
                "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                "area": float(shape.sum()), "segmentation": segm})
        if i == 1:
            # one crowd region, as an uncompressed RLE; mask_miss zeroes it
            crowd = np.zeros((h, w), np.uint8)
            crowd[h // 8: h // 4, w // 8: w // 3] = 1
            mask_miss[crowd > 0] = 0
            flat = crowd.T.reshape(-1)
            runs = np.diff(np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1,
                                           [flat.size]])).tolist()
            n_ann += 1
            coco[split]["annotations"].append({
                "id": n_ann, "image_id": i, "category_id": 1, "iscrowd": 1,
                "num_keypoints": 0, "keypoints": [0] * 51,
                "bbox": [w / 8, h / 8, w / 3 - w / 8, h / 4 - h / 8],
                "area": float(crowd.sum()),
                "segmentation": {"size": [h, w], "counts": runs}})
        kp_name = f"COCO_{tag}2014_{stem}.png"
        write_png(os.path.join(root, "images", kp_name), img, PNG_FILTERS)
        write_png(os.path.join(root, "mask2014", f"{tag}2014_mask_miss_{stem}.png"),
                  mask_miss, PNG_FILTERS)
        for d in [split] + (["images/val2017"] if val else []):
            shutil.copyfile(os.path.join(root, "images", kp_name),
                            os.path.join(root, d, f"{stem}.png"))
        # the CMU index flips visibility: 1 visible, 0 occluded, 2 missing
        cmu = [np.concatenate([k[:, :2], np.where(k[:, 2:] == 2, 1.0, 0.0)], 1)
               for k, _ in people]
        for p, (kp, size) in enumerate(people):
            lo, hi = kp[:, :2].min(0), kp[:, :2].max(0)
            others = [cmu[q].tolist() for q in range(len(people)) if q != p]
            records.append({
                "dataset": "COCO_val" if val else "COCO",
                "isValidation": float(val), "img_paths": kp_name,
                "img_width": float(w), "img_height": float(h), "image_id": i,
                "objpos": ((lo + hi) / 2).tolist(),
                "scale_provided": float(size / 368.0),
                "joint_self": cmu[p].tolist(), "joint_others": others,
                "numOtherPeople": float(len(others))})
    with open(os.path.join(root, "COCO.json"), "w") as f:
        json.dump({"root": records}, f)
    cat = {"id": 1, "name": "person", "supercategory": "person"}
    for split, d in coco.items():
        with open(os.path.join(root, "annotations",
                               f"person_keypoints_{split}.json"), "w") as f:
            json.dump({**d, "categories": [cat]}, f)
    return {"images": n_train + n_val, "val_images": n_val,
            "records": len(records),
            "train_records": sum(r["isValidation"] == 0.0 for r in records),
            "val_records": sum(r["isValidation"] != 0.0 for r in records),
            "annotations": n_ann}


def time_dataset(ds, n: int, workers: int, batch: int) -> tuple:
    """ms per sample of ``ds``: ``n`` samples on this thread, then one epoch
    of batches through ``Loader`` with ``workers`` threads (its start
    included)."""
    from multiposenet_tpu_torch.data.loader import Loader

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    for i in range(n):
        ds.__getitem__(i % len(ds), rng=rng)
    one = (time.perf_counter() - t0) * 1e3 / n
    loader = Loader(ds, batch, shuffle=True, num_workers=workers, seed=SEED)
    t0 = time.perf_counter()
    got = sum(len(b["image"]) for b in loader)
    return one, (time.perf_counter() - t0) * 1e3 / got


def raise_output_biases(ckpt: str, out: str, cls_bias: float = 3.0,
                        heat_bias: float = 0.3) -> str:
    """A copy of checkpoint ``ckpt``'s model state with the classifier and
    heatmap output biases raised, so that a briefly trained model's
    detections pass the test threshold and its heatmaps hold peaks above
    thre1: the eval then has boxes and people to group and score."""
    from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib

    sd = ckpt_lib.load_checkpoint(ckpt)["model"]
    sd["classificationModel.output.bias"] = torch.full_like(
        sd["classificationModel.output.bias"], cls_bias)
    sd["convfin.bias"] = sd["convfin.bias"] + heat_bias
    os.makedirs(out, exist_ok=True)
    torch.save({"model": sd}, os.path.join(out, ckpt_lib.STATE_FILE))
    return out


def cli_phase(card: str, device: str = "cuda", backbone: str = "resnet101",
              sizes=SYNTH_SIZES, n_train: int = 24, n_val: int = 12,
              kp_size: int = 480, det_size: int = 608, kp_batch: int = 6,
              workers: int = 8, tall=(150.0, 340.0)) -> dict:
    """Phase 8: the port's CLI in process (``cli.main``) on a synthetic
    COCO tree of PNG files: train keypoint, detection (from the keypoint
    checkpoint) and PRN (from the detection one), val, coco-eval, the two
    shards and merge-results, test; one command through a real ``python -m
    multiposenet_tpu_torch.cli`` subprocess.  Checks every loss finite,
    every checkpoint restoring, the 10 stats, merged equal to unsharded and
    K1 launched on every coco-eval image; times the datasets and the
    keypoint stage's data wait per step against its step time."""
    import shutil
    import tempfile

    from multiposenet_tpu_torch import cli
    from multiposenet_tpu_torch.config import ModelConfig
    from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
    from multiposenet_tpu_torch.engine import trainer as trainer_mod
    from multiposenet_tpu_torch.models.posenet import PoseNet
    from multiposenet_tpu_torch.ops import cuda_nms

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mpn_cli_smoke_")
    coco, save = os.path.join(root, "coco"), os.path.join(root, "models")
    saved_env = os.environ.get("MPN_PLATFORM")
    saved_bench = torch.backends.cudnn.benchmark
    if device == "cpu":
        os.environ["MPN_PLATFORM"] = "cpu"
    records, walls = {}, {}
    base_trainer = trainer_mod.Trainer

    class RecordingTrainer(base_trainer):
        """Records every step's loss, host wait for data and step span."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            rec = records.setdefault(self.subnet, {"losses": [], "waits": [],
                                                   "events": []})
            step = self.train_step

            def timed(state, batch, *args):
                rec["waits"].append(self.data_timer.duration)
                ev = None
                if self.device.type == "cuda":
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                out = step(state, batch, *args)
                if ev is not None:
                    ev[1].record()
                    rec["events"].append(ev)
                rec["losses"].append(out[1]["loss"])
                return out
            self.train_step = timed

    def run(name: str, argv):
        t0 = time.perf_counter()
        out = cli.main(argv)
        walls[name] = time.perf_counter() - t0
        return out

    def read_json(path):
        with open(path) as f:
            return json.load(f)

    try:
        tree = write_synthetic_coco(coco, n_train, n_val, sizes=sizes, tall=tall)
        common = ["--coco-root", coco, "--backbone", backbone, "--save-dir", save,
                  "--num-workers", str(workers)]
        # the detection batch: the reference's 25, cut to the records of the
        # smaller split, so that validation has a whole batch
        det_batch = min(25, tree["val_records"])
        log(f"cli: synthetic COCO tree {tree} in {time.perf_counter() - t_phase:.1f} s; "
            f"detection batch {det_batch} (the reference's 25 cut to the "
            f"{tree['val_records']} validation records)")

        # both datasets in batches of the keypoint stage's size, so that the
        # Loader's epoch keeps every worker busy
        data_ms = {}
        for subnet, size in (("keypoint", kp_size), ("detection", det_size)):
            args = argparse.Namespace(
                backbone=backbone, coco_root=coco, ckpt=None, exp_name=None,
                inp_size=size, batch_size=kp_batch, lr=None, max_epoch=None,
                num_workers=workers, save_dir=save, bf16=False)
            ds = cli.make_loaders(cli.build_config(args, subnet), subnet, True).dataset
            data_ms[subnet] = time_dataset(ds, 2 * kp_batch, workers, kp_batch)
        log(f"cli: dataset ms per sample at batch {kp_batch} (this host, one "
            f"thread / an epoch through Loader with {workers} workers): "
            + "; ".join(f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in data_ms.items())
            + f" [{card}]")

        trainer_mod.Trainer = RecordingTrainer
        stages = (("keypoint", kp_size, kp_batch, None),
                  ("detection", det_size, det_batch, "keypoint"),
                  ("prn", None, 8, "detection"))
        ckpts = {}
        for subnet, size, batch, init in stages:
            argv = ["train", "--subnet", subnet, *common, "--exp-name", subnet,
                    "--batch-size", str(batch), "--max-epoch", "1"]
            if size:
                argv += ["--inp-size", str(size)]
            if init:
                argv += ["--init-params", ckpts[init]]
            run(f"train {subnet}", argv)
            ckpts[subnet] = ckpt_lib.latest_checkpoint(os.path.join(save, subnet))
            loss = torch.stack([x.float() for x in records[subnet]["losses"]]).cpu()
            if not torch.isfinite(loss).all():
                raise AssertionError(f"cli train {subnet}: a non-finite loss {loss}")
            template = PoseNet(ModelConfig(backbone=backbone)).state_dict()
            _, stats = ckpt_lib.restore_model_state_partial(ckpts[subnet], template)
            if stats["missing"] or stats["shape_skipped"]:
                raise AssertionError(f"{ckpts[subnet]} does not restore: {stats}")
        trainer_mod.Trainer = base_trainer

        # the first steps wait for the loader's start and cuDNN's autotuning
        kp = records["keypoint"]
        n_steps = ", ".join(f"{k} {len(v['losses'])} steps" for k, v in records.items())
        waits = np.array(kp["waits"]) * 1e3
        steps = np.array([s.elapsed_time(e) for s, e in kp["events"]])
        later = slice(2, None) if len(waits) > 2 else slice(None)
        log(f"cli train: {backbone} keypoint {kp_size} px batch {kp_batch}, "
            f"detection {det_size} px batch {det_batch}, PRN batch 8, 1 epoch "
            f"each ({n_steps}); every loss finite, every checkpoint restores; "
            f"keypoint data wait per step (ms) {np.round(waits, 1).tolist()} "
            f"against ms per step between CUDA events "
            f"{np.round(steps, 1).tolist()}: after the first two steps, "
            f"median wait {np.median(waits[later]):.1f} ms, median step "
            + (f"{np.median(steps[later]):.1f} ms" if steps.size else "not timed")
            + f" [{card}]")

        # one convolution algorithm per shape from here on, so that the
        # shards and the unsharded eval compute the same numbers
        torch.backends.cudnn.benchmark = False
        val_loss = run("val", ["val", "--subnet", "keypoint", *common, "--exp-name",
                               "keypoint", "--inp-size", str(kp_size), "--batch-size",
                               str(kp_batch), "--max-batches", "2", "--ckpt",
                               ckpts["keypoint"]])
        if not np.isfinite(val_loss):
            raise AssertionError(f"cli val: loss {val_loss}")

        # bf16 activations, as a deployment evaluates; the random model's
        # heatmaps are flat above the raised bias and fill every joint's peak
        # slots, so escalation would re-dispatch each image at 128 peaks and
        # 256 people, several seconds each
        eval_ckpt = raise_output_biases(ckpts["prn"], os.path.join(root, "eval_ckpt"))
        ev_args = ["--coco-root", coco, "--backbone", backbone, "--ckpt", eval_ckpt,
                   "--inp-size", str(kp_size), "--bf16", "--no-escalate"]
        metrics_file = os.path.join(root, "metrics.json")
        result_file = os.path.join(root, "results.json")
        cuda_nms.launches = 0
        metrics = run("coco-eval", ["coco-eval", *ev_args, "--metrics-file",
                                    metrics_file, "--result-file", result_file])
        launches = cuda_nms.launches
        if len(metrics) != 10 or read_json(metrics_file) != metrics:
            raise AssertionError(f"cli coco-eval: {metrics}, metrics file "
                                 f"{read_json(metrics_file)}")
        if device == "cuda" and launches < tree["val_images"]:
            raise AssertionError(f"cli coco-eval launched K1 {launches} times "
                                 f"for {tree['val_images']} images")
        shards = [os.path.join(root, f"shard{i}.json") for i in range(2)]
        for i, path in enumerate(shards):
            run(f"coco-eval {i}:2", ["coco-eval", *ev_args, "--eval-shard", f"{i}:2",
                                     "--result-file", path])
        merged_file = os.path.join(root, "merged.json")
        merged = run("merge-results", ["merge-results", *shards, "--coco-root", coco,
                                       "--out", merged_file])
        key = lambda r: (r["image_id"], -r["score"], r["keypoints"])  # noqa: E731
        unsharded = sorted(read_json(result_file), key=key)
        if merged != metrics or sorted(read_json(merged_file), key=key) != unsharded:
            raise AssertionError(f"merged shards {merged} != unsharded {metrics}, "
                                 "or their result rows differ")
        results = run("test", ["test", *ev_args[:-1], "--testdata",
                               os.path.join(coco, "images", "val2017"),
                               "--testresult", os.path.join(root, "test_out")])
        if len(read_json(os.path.join(root, "test_out",
                                      "multipose_results.json"))) != len(results):
            raise AssertionError("cli test: result JSON disagrees")

        t0 = time.perf_counter()
        again = os.path.join(root, "merged_again.json")
        proc = subprocess.run(
            [sys.executable, "-m", "multiposenet_tpu_torch.cli", "merge-results",
             *shards, "--coco-root", coco, "--out", again],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
            text=True, timeout=300)
        if proc.returncode != 0 or read_json(again) != read_json(merged_file):
            raise AssertionError(f"python -m multiposenet_tpu_torch.cli merge-results "
                                 f"failed ({proc.returncode}): {proc.stderr[-2000:]}")
        walls["python -m merge-results"] = time.perf_counter() - t0
        wall = time.perf_counter() - t_phase
        log(f"cli eval: val loss {val_loss:.6f}; coco-eval over {tree['val_images']} "
            f"images, {len(unsharded)} result rows, AP {metrics['AP']:.4f}, 10 stats "
            f"in the metrics file, K1 launched {launches} times; shards 0:2 + 1:2 "
            f"merged equal the unsharded rows and stats; test: {len(results)} "
            f"people; wall per command (s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
            + f"; phase wall {wall:.1f} s [{card}]")
        return {"launches": launches, "data_ms": data_ms, "wall_s": wall,
                "walls": walls, "kp_waits_ms": waits.tolist(),
                "kp_steps_ms": steps.tolist(), "metrics": metrics}
    finally:
        trainer_mod.Trainer = base_trainer
        torch.backends.cudnn.benchmark = saved_bench
        if saved_env is None:
            os.environ.pop("MPN_PLATFORM", None)
        else:
            os.environ["MPN_PLATFORM"] = saved_env
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- main

# ---------------------------------------------------------------- phase 9

DIST_RANKS = 2
# 9b: warm-up and timed steps (cut from 3 + 10, then from 3 + 6 and 3 + 4)
DIST_KP_STEPS = (2, 3)


def _counting_ddp(made: list):
    """A DistributedDataParallel that the train steps build (their module
    global is replaced in this process) and that appends itself to
    ``made``."""
    from multiposenet_tpu_torch.engine import train_steps

    base = train_steps.DistributedDataParallel

    class Counted(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    train_steps.DistributedDataParallel = Counted


def nccl_rank() -> dict:
    """9a, in a one-process NCCL group: one keypoint step through DDP
    (resnet50, 64 px, the dry run's batch), a broadcast and gather_objects,
    every collective over NCCL."""
    import torch.distributed as tdist

    from multiposenet_tpu_torch.parallel import distributed as pdist
    from multiposenet_tpu_torch.parallel.dryrun import (
        dryrun_batches, dryrun_config, exact_math, stage_step)

    if tdist.get_backend() != "nccl":
        raise AssertionError(f"backend {tdist.get_backend()}, expected nccl")
    made = []
    _counting_ddp(made)
    dev = pdist.process_device()
    cfg = dryrun_config(64)
    with exact_math():
        loss, _, _ = stage_step(cfg, "keypoint", 0,
                                dryrun_batches(1, 64, cfg)["keypoint"], dev)
    if len(made) != 1 or not np.isfinite(loss):
        raise AssertionError(f"{len(made)} DDP modules, loss {loss}")
    t = torch.arange(4, dtype=torch.float32, device=dev) * (pdist.process_index() + 1)
    tdist.broadcast(t, src=0)
    gathered = pdist.gather_objects({"rank": pdist.process_index(), "loss": loss})
    return {"backend": tdist.get_backend(), "device": str(dev), "loss": loss,
            "broadcast": t.tolist(), "gathered": gathered}


def dist_keypoint_rank(cfg, steps) -> dict:
    """9b, in each process: the keypoint stage's train step on this
    process's share of the global batch, ``steps`` = (warm-up, timed);
    the gradient all-reduce timed by a DDP communication hook (host wall
    from a bucket's hand-off to its reduced gradient, summed over the
    step's buckets; they overlap the backward).  Then the same timed steps
    with BatchNorm on each process's own batch (``local_bn``), which takes
    the statistics all-reduces out of the step."""
    import torch.distributed as tdist
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    from multiposenet_tpu_torch.engine import train_steps
    from multiposenet_tpu_torch.models.fpn import BatchNorm
    from multiposenet_tpu_torch.models.posenet import build_trainable_posenet
    from multiposenet_tpu_torch.parallel import distributed as pdist

    comm = []

    def timed_allreduce(_state, bucket):
        t0 = time.perf_counter()

        def done(fut):
            comm.append(time.perf_counter() - t0)
            return fut.value()
        return default_hooks.allreduce_hook(None, bucket).then(done)

    made = []
    _counting_ddp(made)
    rank, n = pdist.process_index(), pdist.process_count()
    dev = pdist.process_device()
    model = build_trainable_posenet(cfg.model, dev, seed=SEED)
    state = train_steps.create_train_state(cfg, "keypoint", model=model)
    step, _ = train_steps.make_keypoint_steps(cfg, device=dev)
    rng = np.random.RandomState(SEED + 9 + rank)
    local = cfg.train.batch_size // n
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                train_batch("keypoint", cfg, local, rng).items()} for _ in range(2)]
    warm, timed = steps
    step(state, batches[0], CHECK_LR)
    made[0].register_comm_hook(None, timed_allreduce)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm) and m.global_stats]

    def run(n_warm: int) -> dict:
        """n_warm untimed steps, then ``timed`` timed ones."""
        for i in range(n_warm):
            step(state, batches[i % 2], CHECK_LR)
        torch.cuda.synchronize()
        tdist.barrier()
        comm.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses = []
        for i in range(timed):
            _, logs = step(state, batches[i % 2], CHECK_LR)
            losses.append(logs["loss"])
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = torch.stack(losses).cpu().numpy()
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite keypoint losses {losses}")
        return {"ms_per_step": wall / timed * 1e3,
                "event_ms_per_step": start.elapsed_time(end) / timed,
                "allreduce_ms_per_step": sum(comm) / timed * 1e3,
                "buckets_per_step": len(comm) / timed}

    out = run(warm - 1)
    # the same steps with each process's BatchNorm on its own batch: the
    # difference is what the statistics all-reduces (one per BatchNorm
    # layer in the forward, one in the backward) cost a step
    for m in bns:
        m.global_stats = False
    out["local_bn"] = run(2)
    grad_numel = sum(p.numel() for p in state.trainable_parameters())
    out.update(bn_allreduces_per_step=2 * len(bns), grad_mb=grad_numel * 4 / 1e6,
               local_batch=local,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    return out


def dist_eval_rank(state_path: str, cfg, images, gt) -> dict:
    """9c, in each process: coco_eval over 6b's images with no explicit
    shard (the process group shards them), deterministic cuDNN, twice: a
    first pass in the new process, whose K1 inputs are recorded and held
    against the plain twin here, then a timed pass that must give the same
    stats and rows."""
    import tempfile

    from multiposenet_tpu_torch.engine.evaluator import Evaluator
    from multiposenet_tpu_torch.models.posenet import build_posenet
    from multiposenet_tpu_torch.ops import cuda_nms
    from multiposenet_tpu_torch.parallel import distributed as pdist

    rank = pdist.process_index()
    dev = pdist.process_device()
    model = build_posenet(cfg.model, dev, torch.load(state_path))
    ev = Evaluator(cfg, model=model, device=dev)
    by_name = {rec["file_name"]: img for rec, img in zip(gt["images"], images)}
    passes = []
    with tempfile.TemporaryDirectory() as d, deterministic_cudnn():
        ann_file = os.path.join(d, "gt.json")
        result_file = os.path.join(d, "results.json")
        with open(ann_file, "w") as f:
            json.dump(gt, f)
        for first in (True, False):
            if first:
                calls, restore = record_nms_inputs()
            cuda_nms.launches = 0
            t0 = time.perf_counter()
            try:
                metrics = ev.coco_eval(ann_file=ann_file, result_file=result_file,
                                       load_image=by_name.__getitem__)
            finally:
                if first:
                    restore()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rows = None
            if os.path.exists(result_file):
                with open(result_file) as f:
                    rows = json.load(f)
                os.unlink(result_file)
            passes.append((metrics, rows, wall, cuda_nms.launches))
    (metrics, rows, first_s, _), (metrics2, rows2, wall, launches) = passes
    if (metrics2, rows2) != (metrics, rows):
        raise AssertionError(f"process {rank}: the second pass differs")
    n_local = len(range(rank, len(images), pdist.process_count()))
    if launches != n_local + len(ev.escalated):
        raise AssertionError(f"process {rank}: K1 launched {launches} times for "
                             f"{n_local} images + {len(ev.escalated)} escalated")
    err = check_eval_nms_inputs(calls, cfg.detection.max_detections,
                                label=f"distributed eval, process {rank}")
    return {"metrics": metrics, "rows": rows, "launches": launches,
            "max_abs_err": err, "images": n_local,
            "escalated": len(ev.escalated), "wall_s": wall, "first_s": first_s}


def sorted_rows(rows):
    return sorted(rows, key=lambda r: (r["image_id"], -r["score"], r["keypoints"]))


def distributed_phase(card: str, serve_state: dict, serve_cfg, serve_images,
                      eval_inputs: dict, one_process_kp_ms: float,
                      device: str = "cuda", kp_cfg=None) -> dict:
    """Phase 9: several processes on the one H100.  9a the dry run over 2
    processes (gloo: NCCL refuses two processes on one GPU) and a
    one-process NCCL group; 9b the keypoint stage at its reference
    configuration as 2 processes x 3; 9c auto-sharded coco_eval in 2
    processes against one process; 9d BatchPredictor on a mesh of two
    entries of the card against an unsharded predictor.  ``device`` and a
    smaller ``kp_cfg`` (9b's configuration) serve a rehearsal on the CPU."""
    import tempfile

    from multiposenet_tpu_torch.config import keypoint_train_config
    from multiposenet_tpu_torch.engine.evaluator import Evaluator
    from multiposenet_tpu_torch.engine.predictor import BatchPredictor
    from multiposenet_tpu_torch.models.posenet import build_posenet
    from multiposenet_tpu_torch.ops import cuda_nms
    from multiposenet_tpu_torch.parallel import distributed as pdist
    from multiposenet_tpu_torch.parallel import make_mesh
    from multiposenet_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.perf_counter()
    out = {"max_abs_err": 0}

    # ---- 9a: the dry run, then NCCL in a group of one
    log("dist: 9a dryrun_multichip(2) on cuda:0 with backend gloo, explicit "
        "(NCCL refuses two processes on one GPU)")
    calls, restore = record_nms_inputs()
    cuda_nms.launches = 0
    t0 = time.perf_counter()
    try:
        dry = dryrun_multichip(DIST_RANKS, size=64, device=device, backend="gloo",
                               timeout=600)
    finally:
        restore()
    out["dryrun_s"] = time.perf_counter() - t0
    out["dryrun_e2e_launches"] = cuda_nms.launches
    if cuda_nms.launches != DIST_RANKS:
        raise AssertionError(f"dry run's sharded e2e batch launched K1 "
                             f"{cuda_nms.launches} times, expected {DIST_RANKS}")
    for boxes, valid, thresh in calls:
        out["max_abs_err"] = max(out["max_abs_err"], check_nms_kernel(
            boxes, valid, thresh, "dry run e2e candidates")[1])
    log("dist: 9a dry run " + "; ".join(
        f"{s} |dloss| {dry[s]['dloss']:.2e} max|dparams| {dry[s]['dparams']:.2e}"
        for s in ("keypoint", "detection", "prn"))
        + f" (bound {dry['tol']:.1e}); BN statistics equal; K1 "
        f"{out['dryrun_e2e_launches']} launches; {out['dryrun_s']:.1f} s [{card}]")
    t0 = time.perf_counter()
    (nccl,) = pdist.spawn_ranks(nccl_rank, 1, device=device, timeout=300)
    if nccl["gathered"] != [{"rank": 0, "loss": nccl["loss"]}] \
            or nccl["broadcast"] != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError(f"NCCL group: {nccl}")
    log(f"dist: 9a one-process {nccl['backend']} group on {nccl['device']}: DDP "
        f"keypoint step loss {nccl['loss']:.5f}, broadcast and gather_objects "
        f"ok in {time.perf_counter() - t0:.1f} s")

    # ---- 9b: the keypoint stage at full width, 2 processes x 3
    cfg = kp_cfg or keypoint_train_config()
    t0 = time.perf_counter()
    kp = pdist.spawn_ranks(dist_keypoint_rank, DIST_RANKS,
                           args=(cfg, DIST_KP_STEPS), device=device,
                           backend="gloo", timeout=600)
    ms = max(r["ms_per_step"] for r in kp)
    local_ms = max(r["local_bn"]["ms_per_step"] for r in kp)
    out["keypoint"] = {"ms_per_step": ms,
                       "images_per_s": cfg.train.batch_size / ms * 1e3,
                       "allreduce_ms_per_step": [r["allreduce_ms_per_step"] for r in kp],
                       "local_bn_ms_per_step": local_ms,
                       "bn_allreduce_ms_per_step": ms - local_ms,
                       "per_process": kp}

    def per(key, src=lambda r: r):
        return ", ".join(f"{src(r)[key]:.2f}" for r in kp)
    local = lambda r: r["local_bn"]  # noqa: E731
    log(f"dist: 9b keypoint stage ResNet-101 f32 480 px, global batch "
        f"{cfg.train.batch_size} as {DIST_RANKS} processes x {kp[0]['local_batch']} "
        f"sharing one card over gloo (not a multi-GPU number): "
        f"{ms:.2f} ms/step ({per('ms_per_step')} per process; CUDA events "
        f"{per('event_ms_per_step')}) = {out['keypoint']['images_per_s']:.1f} "
        f"images/s, against one process's {one_process_kp_ms:.2f} ms/step (7b); "
        f"gradient all-reduce {per('allreduce_ms_per_step')} ms/step of hook "
        f"wall ({kp[0]['buckets_per_step']:.0f} buckets, {kp[0]['grad_mb']:.1f} MB "
        f"of gradients); with BatchNorm on each process's batch {local_ms:.2f} "
        f"ms/step ({per('ms_per_step', local)} per process; gradient all-reduce "
        f"{per('allreduce_ms_per_step', local)} ms/step of hook wall), so the "
        f"{kp[0]['bn_allreduces_per_step']} BatchNorm statistics all-reduces "
        f"take {ms - local_ms:.2f} ms/step; peak "
        f"{max(r['peak_gib'] for r in kp):.2f} GiB per process; "
        f"{time.perf_counter() - t0:.1f} s with start-up [{card}]")

    # ---- 9c: auto-sharded coco_eval against one process
    ecfg, images, gt = eval_inputs["cfg"], eval_inputs["images"], eval_inputs["gt"]
    model = build_posenet(ecfg.model, torch.device(device), serve_state)
    with deterministic_cudnn():
        ev = Evaluator(ecfg, model=model, device=device)
        want, want_rows = run_coco_eval(ev, gt, images)
    with tempfile.TemporaryDirectory() as d:
        state_path = os.path.join(d, "serve.pt")
        torch.save(serve_state, state_path)
        t0 = time.perf_counter()
        ev_ranks = pdist.spawn_ranks(dist_eval_rank, DIST_RANKS,
                                     args=(state_path, ecfg, images, gt),
                                     device=device, backend="gloo", timeout=600)
        eval_s = time.perf_counter() - t0
    primary = ev_ranks[0]
    if primary["metrics"] != want:
        raise AssertionError(f"distributed stats {primary['metrics']} differ "
                             f"from one process's {want}")
    if sorted_rows(primary["rows"]) != sorted_rows(want_rows):
        raise AssertionError("distributed rows differ from one process's")
    if any(r["metrics"] or r["rows"] is not None for r in ev_ranks[1:]):
        raise AssertionError("a non-primary process returned results")
    out["distributed_coco_eval_launches"] = sum(r["launches"] for r in ev_ranks)
    out["max_abs_err"] = max(out["max_abs_err"], *(r["max_abs_err"] for r in ev_ranks))
    out["eval"] = {"wall_s": [r["wall_s"] for r in ev_ranks],
                   "first_s": [r["first_s"] for r in ev_ranks],
                   "images": [r["images"] for r in ev_ranks]}
    log(f"dist: 9c coco_eval auto-sharded over {DIST_RANKS} processes on one "
        f"card (gloo; 6b's configuration, {len(images)} images as "
        f"{[r['images'] for r in ev_ranks]}, deterministic cuDNN): stats and "
        f"{len(want_rows)} rows equal one process's; coco_eval wall "
        f"{', '.join(f'{r['wall_s']:.2f}' for r in ev_ranks)} s per process "
        f"(first pass in the new process "
        f"{', '.join(f'{r['first_s']:.2f}' for r in ev_ranks)} s), "
        f"{eval_s:.1f} s with start-up; K1 "
        f"{[r['launches'] for r in ev_ranks]} launches "
        f"({[r['escalated'] for r in ev_ranks]} escalated); OKS AP "
        f"{want['AP']:.4f} [{card}]")
    del model, ev

    # ---- 9d: sharded serving against the unsharded predictor
    model = build_posenet(serve_cfg.model, torch.device(device), serve_state)
    mesh = make_mesh(devices=[device] * DIST_RANKS)
    with deterministic_cudnn():
        sharded = BatchPredictor(serve_cfg, model=model, batch_size=SERVE_BATCH,
                                 mesh=mesh)
        plain = BatchPredictor(serve_cfg, model=model,
                               batch_size=SERVE_BATCH // mesh.size, device=device)
        # warm-up, K1's inputs recorded and held against its twin below
        calls, restore = record_nms_inputs()
        try:
            sharded.predict(serve_images)
        finally:
            restore()
        want = plain.predict(serve_images)
        torch.cuda.synchronize()
        cuda_nms.launches = 0
        t0 = time.perf_counter()
        got = sharded.predict(serve_images)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
    out["sharded_serving_launches"] = cuda_nms.launches
    n_batches = -(-len(serve_images) // SERVE_BATCH)
    if cuda_nms.launches != n_batches * mesh.size or len(calls) != cuda_nms.launches:
        raise AssertionError(f"sharded serving launched K1 {cuda_nms.launches} "
                             f"times ({len(calls)} on the warm-up pass), "
                             f"expected {n_batches * mesh.size}")
    for boxes, valid, thresh in calls:
        out["max_abs_err"] = max(out["max_abs_err"], check_nms_kernel(
            boxes, valid, thresh, "sharded serving candidates", quiet=True)[1])
    if got != want:
        raise AssertionError("sharded serving rows differ from the unsharded "
                             "predictor's")
    n_people = check_people(got, len(serve_images))
    log(f"dist: 9d BatchPredictor on a mesh of {mesh.devices}, batch "
        f"{SERVE_BATCH}: {len(serve_images)} images in {serve_s:.3f} s, "
        f"{n_people} people, rows equal an unsharded predictor's at the "
        f"per-device batch {SERVE_BATCH // mesh.size} (deterministic cuDNN); "
        f"K1 {out['sharded_serving_launches']} launches, bit-equal to its twin on the "
        f"{len(calls)} candidate sets of the warm-up pass "
        f"{sorted({tuple(v.shape) for _, v, _ in calls})} [{card}]")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"dist: phase 9 wall {out['wall_s']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------- phase 10

GATE_FLOOR = 0.60
# the ablation switches phase 10 runs beside the default; fold_bn,
# host_chain and no_refine are left to the standalone gate
# (python -m multiposenet_tpu_torch.tools.synth_e2e_gate)
GATE_ABLATION = ("bf16", "host_grouping")
# the gate's loader workers in the smoke (its recipe's 4 elsewhere): under
# --deterministic each batch is drawn from its own seed, so the batches and
# the AP repeat whatever the number of workers; the stages are loader-bound
GATE_WORKERS = 6


def gate_first_image_nms(coco: str, ckpt: str, device: str = "cuda") -> tuple:
    """The gate's eval on its first val image, in this process: K1's inputs
    recorded and held against the plain twin bit for bit, and K1 launched
    once per dispatch.  Returns (max error, launches, dispatches)."""
    import argparse

    from multiposenet_tpu_torch import cli
    from multiposenet_tpu_torch.ops import cuda_nms

    p = argparse.ArgumentParser()
    cli._common(p)
    args = p.parse_args(["--coco-root", coco, "--backbone", "resnet50",
                         "--ckpt", ckpt])
    cfg, ev = cli._load_eval(args, device=torch.device(device))
    # the gate's coco-eval capacities (--max-peaks 8 --max-people 8)
    ev.cfg = dataclasses.replace(
        ev.cfg, peaks=dataclasses.replace(ev.cfg.peaks, max_peaks_per_joint=8),
        prn=dataclasses.replace(ev.cfg.prn, max_people=8))
    calls, restore = record_nms_inputs()
    cuda_nms.launches = 0
    try:
        with deterministic_cudnn():
            ev.coco_eval(max_images=1)
    finally:
        restore()
    launches, dispatches = cuda_nms.launches, 1 + len(ev.escalated)
    if launches != dispatches:
        raise AssertionError(f"gate eval: K1 launched {launches} times for "
                             f"{dispatches} dispatches of the first image")
    err = check_eval_nms_inputs(calls, cfg.detection.max_detections,
                                label="gate eval, first image")
    return err, launches, dispatches


def gate_phase(card: str) -> dict:
    """Phase 10: the synthetic end-to-end gate at its recipe, as a user runs
    it (``python -m multiposenet_tpu_torch.tools.synth_e2e_gate``): the
    crowd dataset, the three stages trained on the card, the 5-scale + flip
    coco-eval with escalation, the AP floor and zero truncation, the
    ablation's ``GATE_ABLATION`` switches.  Its figures are held again here
    from its JSON line and its eval log, K1's launches against the eval's
    dispatches, and K1's inputs on the first eval image against the twin."""
    import shutil
    import tempfile

    from multiposenet_tpu_torch.tools import check_ap_floor

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mpn_gate_smoke_")
    coco, save = os.path.join(root, "coco"), os.path.join(root, "models")
    try:
        cmd = [sys.executable, "-m", "multiposenet_tpu_torch.tools.synth_e2e_gate",
               "--root", coco, "--save-dir", save, "--floor", str(GATE_FLOOR),
               "--only", ",".join(GATE_ABLATION), "--num-workers", str(GATE_WORKERS)]
        log(f"gate: {' '.join(cmd[1:])}")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        lines, best, first = [], None, None
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                log(f"gate| {lines[-1]}")
                if lines[-1].startswith("gate: prn best checkpoint "):
                    best = lines[-1].split("checkpoint ", 1)[1]
                if lines[-1].startswith("gate: coco-eval done") and best:
                    # the first eval image again, here, while the gate's
                    # ablation runs
                    first = ex.submit(gate_first_image_nms, coco, best)
            rc = proc.wait()
        result = None
        if lines and lines[-1].startswith("{"):
            result = json.loads(lines[-1])
        if rc or result is None or not result["passed"]:
            raise AssertionError(f"the synthetic gate failed (rc {rc}): {result}")
        if not result["AP"] >= GATE_FLOOR:
            raise AssertionError(f"gate AP {result['AP']} under {GATE_FLOOR}")
        bad = check_ap_floor.truncation_lines(os.path.join(save, "coco_eval.log"))
        if bad:
            raise AssertionError(f"gate eval truncated: {bad}")
        dispatches = result["eval_images"] + result["escalated_images"]
        if result["nms_suppress_launches"] != dispatches:
            raise AssertionError(
                f"gate eval: K1 launched {result['nms_suppress_launches']} "
                f"times for {dispatches} image dispatches")
        if os.path.abspath(best) != os.path.abspath(result["best_checkpoint"]):
            raise AssertionError(f"gate: best checkpoint {best} printed, "
                                 f"{result['best_checkpoint']} reported")
        err, first_launches, _ = first.result()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    rows = " ".join(f"{k} AP {v['AP']:.4f}" for k, v in (result["ablation"] or {}).items())
    log(f"gate: AP {result['AP']:.4f} AP50 {result['AP50']:.4f} AP75 "
        f"{result['AP75']:.4f} AR {result['AR']:.4f} (floor {GATE_FLOOR}); "
        f"wall s " + " ".join(f"{k} {v:.1f}" for k, v in result["wall_s"].items())
        + f"; {result['escalated_images']} of {result['eval_images']} eval "
        f"images escalated, K1 launches {result['nms_suppress_launches']}; "
        f"ablation {rows}; no deterministic implementation: "
        f"{result['nondeterministic_ops'] or 'none'}; phase 10 wall "
        f"{wall:.1f} s [{card}]")
    return {**result, "launches": result["nms_suppress_launches"],
            "first_image_launches": first_launches, "max_abs_err": err,
            "wall_s_phase": wall}


# ---------------------------------------------------------------- phase 11

def finite_positive(label: str, **values) -> None:
    for k, v in values.items():
        if not (isinstance(v, (int, float)) and np.isfinite(v) and v > 0):
            raise AssertionError(f"{label}: {k} = {v!r}, expected finite and > 0")


def tools_phase(card: str, serve_state: dict, cfg, device: str = "cuda",
                depth: dict = None) -> dict:
    """Phase 11: each measurement tool of ``multiposenet_tpu_torch/tools``
    called in this process through its ``main``, at full width.  The
    inference tools take phase 4's serving model (its weights from
    ``serve_state``, its configuration ``cfg``; the reference-shaped
    baseline and the bf16 drift build their float32 twin from the same
    weights); the training tools draw theirs from seed 0.  For every tool
    that runs K1 its launch count is zeroed just before and must equal the
    tool's own dispatch count just after; the reference-shaped path's K1
    inputs on its first image are held against the twin bit for bit; the
    trace must reconcile; every rate and latency must be finite and
    positive.  ``depth`` shrinks the runs (a CPU rehearsal)."""
    import shutil
    import tempfile

    from multiposenet_tpu_torch.models.posenet import build_posenet
    from multiposenet_tpu_torch.ops import cuda_nms
    from multiposenet_tpu_torch.tools import (
        bench_e2e_stages, bench_fold_bn, bench_loader, bench_reference_shaped,
        bench_serving, bench_train_mfu, bench_trainer_loop, measure_bf16_drift,
        profile_trace)

    d = dict(requests=30, batch_sizes="1,4,8,16", stage_batch=BENCH_BATCH,
             stage_iters=5, ref_images=10, trace_iters=5, trace_batch=BENCH_BATCH,
             fold_iters=5, fold_batch=BENCH_BATCH, drift_images=4, size=INP,
             loader_images=128, loader_workers="4,8", loader_batch=16,
             loop_batch=16, loop_steps=10, loop_backbone="resnet101",
             mfu_batch=16, mfu_iters=10, mfu_backbone="resnet101")
    d.update(depth or {})
    dev = torch.device(device)
    t_phase = time.perf_counter()
    model = build_posenet(cfg.model, dev, serve_state)
    out, wall, launches = {}, {}, {}

    def run(name: str, fn, expect=None):
        cuda_nms.launches = 0
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        n = cuda_nms.launches
        want = 0 if expect is None else expect(res)
        if n != want:
            raise AssertionError(f"tools: {name} launched K1 {n} times, "
                                 f"expected {want}")
        if expect is not None:
            launches[name] = n
        out[name] = res
        log(f"tools: {name} in {wall[name]:.1f} s, K1 launches {n}")
        return res

    size = ["--size", str(d["size"])]
    r = run("bench_serving", lambda: bench_serving.main(
        ["--requests", str(d["requests"]), "--batch-sizes", d["batch_sizes"]],
        device=dev, model=model, cfg=cfg), lambda r: r["predict_calls"])
    for row in r["rows"]:
        finite_positive(f"bench_serving batch {row['batch']}", p50=row["p50_ms"],
                        p95=row["p95_ms"], ips=row["images_per_sec"])
        if dev.type == "cuda" and not 0.0 <= row["idle_share"] <= 1.0:
            raise AssertionError(f"bench_serving idle share {row['idle_share']}")

    it = d["stage_iters"]
    r = run("bench_e2e_stages", lambda: bench_e2e_stages.main(
        ["--batch", str(d["stage_batch"]), "--iters", str(it)] + size,
        device=dev, model=model, cfg=cfg), lambda r: 2 + 4 * it)
    finite_positive("bench_e2e_stages", **{k: r[f"{k}_images_per_sec"]
                                          for k in "ABCD"},
                    nbytes=r["pose_assignments_bytes"],
                    format_ms=r["format_ms_per_batch"])

    # the reference-shaped baseline: the float32 graph of the same weights
    ref_cfg = bench_reference_shaped.reference_config(cfg.model.backbone)
    ref_model = build_posenet(ref_cfg.model, dev, serve_state)
    calls, restore = record_nms_inputs()
    try:
        r = run("reference_shaped", lambda: bench_reference_shaped.main(
            ["--images", str(d["ref_images"])] + size, device=dev,
            model=ref_model, cfg=ref_cfg), lambda r: 1 + d["ref_images"])
    finally:
        restore()
    finite_positive("reference_shaped", ips=r["value"], ms=r["ms_per_image"])
    ref_err = check_eval_nms_inputs(calls[:1], ref_cfg.detection.max_detections,
                                    batches=(1,), label="reference-shaped, first image")
    del ref_model, calls

    ti = d["trace_iters"]
    r = run("profile_trace", lambda: profile_trace.main(
        ["--e2e", "--iters", str(ti), "--batch", str(d["trace_batch"])] + size,
        device=dev, model=model, cfg=cfg), lambda r: 1 + 2 * ti)
    if not r["reconciled"]:
        raise AssertionError(f"profile_trace does not reconcile: {r}")
    finite_positive("profile_trace", busy=r["device_busy_ms_per_exec"],
                    span=r["span_ms_per_exec"])

    fi = d["fold_iters"]
    r = run("fold_bn_ab", lambda: bench_fold_bn.main(
        ["--iters", str(fi), "--batch", str(d["fold_batch"])] + size,
        device=dev, model=model, cfg=cfg), lambda r: 2 * (1 + fi))
    finite_positive("bench_fold_bn", unfolded=r["unfolded_images_per_sec"],
                    folded=r["fold_bn_images_per_sec"])
    del model

    r = run("bf16_drift", lambda: measure_bf16_drift.main(
        ["--images", str(d["drift_images"]), "--backbone", cfg.model.backbone]
        + size, device=dev, state_dict=serve_state), lambda r: 2)
    if not all(np.isfinite(v) for v in r.values() if isinstance(v, float)):
        raise AssertionError(f"bf16 drift not finite: {r}")

    root = tempfile.mkdtemp(prefix="mpn_loader_smoke_")
    try:
        r = run("bench_loader", lambda: bench_loader.main(
            ["--images", str(d["loader_images"]), "--batch", str(d["loader_batch"]),
             "--epochs", "1", "--workers", d["loader_workers"], "--root", root],
            device=dev))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for mode, by in r["by_workers"].items():
        finite_positive(f"bench_loader {mode}", **{f"w{w}": v for w, v in by.items()})

    # the training tools run as `cli train` does and as they do alone: with
    # cuDNN's autotuning off (the smoke turns it on for serving), which
    # also spares a ~20 s autotune of the batch-16 step's convolutions
    torch.backends.cudnn.benchmark = False
    r = run("bench_trainer_loop", lambda: bench_trainer_loop.main(
        ["--steps", str(d["loop_steps"]), "--batch", str(d["loop_batch"]),
         "--backbone", d["loop_backbone"], "--chained",
         "--save-freq-step", str(d["loop_steps"])] + size, device=dev))
    finite_positive("bench_trainer_loop", ms=r["value"], chained=r["chained_ms_per_step"])
    if len(r["save_caller_ms"]) != 1:
        raise AssertionError(f"bench_trainer_loop: {len(r['save_caller_ms'])} "
                             "saves in the timed epoch, expected 1")
    # the same loop with the batches on the device and no save: what the
    # copies and the save add to the loop
    r = run("bench_trainer_loop_preput", lambda: bench_trainer_loop.main(
        ["--steps", str(d["loop_steps"]), "--batch", str(d["loop_batch"]),
         "--backbone", d["loop_backbone"], "--preput"] + size, device=dev))
    finite_positive("bench_trainer_loop --preput", ms=r["value"])

    for subnet in ("keypoint", "prn"):
        r = run(f"train_mfu_{subnet}", lambda: bench_train_mfu.main(
            ["--subnet", subnet, "--batch", str(d["mfu_batch"]), "--iters",
             str(d["mfu_iters"]), "--backbone", d["mfu_backbone"]] + size,
            device=dev))
        finite_positive(f"bench_train_mfu {subnet}", ms=r["ms_per_step"],
                        gflops=r["gflops_per_image"])
        if dev.type == "cuda":
            finite_positive(f"bench_train_mfu {subnet}", mfu=r["mfu"])

    torch.backends.cudnn.benchmark = True
    phase_s = time.perf_counter() - t_phase
    log(f"tools: phase 11 in {phase_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in wall.items()) + f") [{card}]")
    return {"results": out, "wall_s": wall, "launches": launches,
            "max_abs_err": ref_err, "phase_s": phase_s}


# ---------------------------------------------------------------- phase 12

# make_demo at its size with 200 steps a stage (its default is 3000)
DEMO_ARGS = ("--size", "128", "--steps", "200")
# the ResNet-101 recipe at full width, 32 + 12 images and one epoch a stage:
# 8 val images give 14 keypoint val records, less than one batch of 16, so
# no val loss and no best checkpoint; 12 give 29.  Two loader workers: it
# runs beside phase 10's loaders
RECIPE_ARGS = ("--n-train", "32", "--n-val", "12", "--max-epoch", "1",
               "--num-workers", "2")


# intra-op threads of phase 12's processes: they run beside phase 10's, and
# both feed the card from loader worker processes; all-core thread pools in
# every process oversubscribe the host's cores
LAST_TOOLS_THREADS = "2"


def run_tool(module: str, args, log_path: str) -> tuple:
    """``python -m multiposenet_tpu_torch.tools.<module> args``, its output to
    ``log_path``: (wall s, its last line's JSON object)."""
    cmd = [sys.executable, "-m", f"multiposenet_tpu_torch.tools.{module}", *args]
    log(f"last tools: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            env=dict(os.environ,
                                     OMP_NUM_THREADS=LAST_TOOLS_THREADS)).returncode
    wall = time.perf_counter() - t0
    with open(log_path, errors="replace") as f:
        lines = f.read().splitlines()
    if rc or not lines or not lines[-1].startswith("{"):
        raise AssertionError(f"{module} failed (rc {rc}) after {wall:.1f} s:\n"
                             + "\n".join(lines[-30:]))
    return wall, json.loads(lines[-1])


def last_tools_phase(card: str, device: str = "cuda", demo_args=DEMO_ARGS,
                     recipe_args=RECIPE_ARGS) -> dict:
    """Phase 12: the last tools of multiposenet_tpu_torch/tools, each as a
    user runs it, one process each, (b) and (c) at once: (a) ``make_demo``
    (three stages on drawn scenes, then ``Evaluator.test`` on two held-out
    scenes: each scene, its two renders and the JSON written, people found
    in each scene, K1 launched once per image); (b) ``train_synth_e2e``, the
    ResNet-101 recipe at full width (480 and 608 px) on 32 + 12 images, one
    epoch a stage (every stage ran, the eval wrote its metrics, K1 launched
    once per eval image dispatch); (c) ``real_parity_runbook --dry-run``
    (three coco-eval modes, the escalated re-dispatch in the fast and bf16
    modes, both verdicts 0; K1 once per image dispatch in fast and bf16 and
    once per scale of each image on the reference-exact host chain).  Each
    process counts its own K1 launches from 0.  ``demo_args`` and
    ``recipe_args`` shrink the runs (a CPU rehearsal, ``device="cpu"``,
    where K1 does not launch)."""
    import shutil
    import tempfile

    from multiposenet_tpu_torch.config import EvalConfig
    from multiposenet_tpu_torch.tools.real_parity_runbook import DRY_MAX_IMAGES

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="mpn_last_tools_")
    wall, launches = {}, {}
    try:
        # ---- 12a: the demo
        demo_dir = os.path.join(root, "demo")
        wall["make_demo"], demo = run_tool(
            "make_demo", [*demo_args, "--out", demo_dir, "--device", device],
            os.path.join(root, "make_demo.log"))
        scenes = sorted(demo["persons_per_scene"])
        if scenes != ["scene1.png", "scene2.png"] or sorted(
                os.listdir(os.path.join(demo_dir, "test_images"))) != scenes:
            raise AssertionError(f"make_demo wrote scenes {scenes}")
        want = ["multipose_results.json"] + [
            f"{n[:-4]}_{k}.png" for n in scenes for k in ("1heatmap", "2canvas")]
        if demo["written"] != sorted(want):
            raise AssertionError(f"make_demo wrote {demo['written']}")
        if on_card and not all(demo["persons_per_scene"].values()):
            raise AssertionError(f"make_demo found no one in a scene: "
                                 f"{demo['persons_per_scene']}")
        if demo["nms_suppress_launches"] != (len(scenes) if on_card else 0):
            raise AssertionError(f"make_demo: K1 launched "
                                 f"{demo['nms_suppress_launches']} times")
        launches["make_demo_test"] = demo["nms_suppress_launches"]
        log(f"last tools: make_demo in {wall['make_demo']:.1f} s (stages "
            + ", ".join(f"{k} {v:.1f}" for k, v in demo["wall_s"].items())
            + f" s), people per scene {demo['persons_per_scene']}, K1 "
            f"launches {launches['make_demo_test']} [{card}]")

        # ---- 12b and 12c at once: the recipe's loaders and the runbook's
        # process start-ups use different resources
        save = os.path.join(root, "synth_models")
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            recipe_run = ex.submit(run_tool, "train_synth_e2e", [
                *recipe_args, "--root", os.path.join(root, "synth"),
                "--save-dir", save, "--device", device],
                os.path.join(root, "train_synth_e2e.log"))
            book_run = ex.submit(run_tool, "real_parity_runbook", [
                "--dry-run", "--out", os.path.join(root, "parity"),
                "--device", device], os.path.join(root, "real_parity_runbook.log"))
            wall["train_synth_e2e"], recipe = recipe_run.result()
            wall["real_parity_runbook"], book = book_run.result()

        # ---- 12b: the ResNet-101 recipe at smoke depth
        if set(recipe["wall_s"]) != {"dataset", "keypoint", "detection", "prn",
                                     "coco_eval"}:
            raise AssertionError(f"train_synth_e2e ran {sorted(recipe['wall_s'])}")
        if not os.path.isfile(os.path.join(save, "synth_e2e_metrics.json")):
            raise AssertionError("train_synth_e2e's eval wrote no metrics file")
        dispatches = recipe["eval_images"] + recipe["escalated_images"]
        if recipe["nms_suppress_launches"] != (dispatches if on_card else 0):
            raise AssertionError(f"train_synth_e2e: K1 launched "
                                 f"{recipe['nms_suppress_launches']} times for "
                                 f"{dispatches} eval image dispatches")
        launches["synth_e2e_coco_eval"] = recipe["nms_suppress_launches"]
        log(f"last tools: train_synth_e2e in {wall['train_synth_e2e']:.1f} s "
            "(" + ", ".join(f"{k} {v:.1f}" for k, v in recipe["wall_s"].items())
            + f" s); AP {recipe['AP']} AR {recipe['AR']}; "
            f"{recipe['escalated_images']} of {recipe['eval_images']} eval "
            f"images escalated, K1 launches {launches['synth_e2e_coco_eval']} "
            f"[{card}]")
        shutil.rmtree(save, ignore_errors=True)

        # ---- 12c: the parity runbook's dry run
        if not book["passed"] or book["verdicts"] != {"fast_vs_ref": 0,
                                                      "bf16_vs_fast": 0}:
            raise AssertionError(f"runbook dry run: verdicts {book['verdicts']}")
        n_scales = len(EvalConfig().scale_search)
        for mode, res in book["modes"].items():
            if mode != "ref" and not res["escalated_images"]:
                raise AssertionError(f"runbook {mode}: no escalated re-dispatch")
            want = (DRY_MAX_IMAGES * n_scales if mode == "ref"
                    else DRY_MAX_IMAGES + res["escalated_images"])
            if res["nms_suppress_launches"] != (want if on_card else 0):
                raise AssertionError(f"runbook {mode}: K1 launched "
                                     f"{res['nms_suppress_launches']} times, "
                                     f"expected {want}")
            launches[f"runbook_{mode}"] = res["nms_suppress_launches"]
        log(f"last tools: real_parity_runbook --dry-run in "
            f"{wall['real_parity_runbook']:.1f} s (" + ", ".join(
                f"{m} {r['wall_s']:.1f} s, {r['escalated_images']} escalated, "
                f"K1 {r['nms_suppress_launches']}" for m, r in book["modes"].items())
            + f"); verdicts {book['verdicts']} [{card}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    log(f"last tools: phase 12 in {phase_s:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in wall.items()) + f") [{card}]")
    return {"wall_s": wall, "launches": launches, "phase_s": phase_s,
            "demo": demo, "recipe": recipe, "runbook": book}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU",
              file=sys.stderr)
        return 2
    from multiposenet_tpu_torch.engine.inference import (
        format_pose_batch, make_e2e_pose_pipeline)
    from multiposenet_tpu_torch.engine.predictor import BatchPredictor
    from multiposenet_tpu_torch.models.posenet import build_posenet
    from multiposenet_tpu_torch.ops import cuda_nms
    from multiposenet_tpu_torch.ops.nms import nms_suppress, nms_suppress_plain

    t_start = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # ---- 1. build ----------------------------------------------------------
    build_s, probe = build_kernels([cuda_nms.SOURCE])

    # ---- 2. kernel against its twin ----------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    thresh = 0.5
    errs = []
    for b, k in NMS_CASES:
        fb, fv = (t.cuda() for t in fuzz_nms_inputs(b, k, gen))
        errs.append(check_nms_kernel(fb, fv, thresh, "fuzz")[1])
    for k in (K, cuda_nms.MAX_K):
        cb, cv, slots, expect = chain_nms_inputs(k, gen)
        got, err = check_nms_kernel(cb.cuda(), cv.cuda(), thresh,
                                    "chain across words")
        errs.append(err)
        if not torch.equal(got[:, slots].cpu(), expect):
            raise AssertionError(f"chain across words at K={k}: keep "
                                 f"{got[:, slots].tolist()}, expected "
                                 f"{expect.tolist()}")

    cfg = serving_config()
    t0 = time.perf_counter()
    model = build_posenet(cfg.model, torch.device("cuda"), seed=SEED,
                          head_output_std=0.01)
    rng = np.random.RandomState(SEED)
    bench_imgs = torch.from_numpy(
        rng.randint(0, 256, (BENCH_BATCH, INP, INP, 3), dtype=np.uint8)).cuda()
    spread_detection_heads(model, bench_imgs[:8])
    torch.cuda.synchronize()
    log(f"model: resnet101 FPN bf16 channels-last, random seed {SEED}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    pipe = make_e2e_pose_pipeline(model, cfg, (INP, INP), device="cuda")
    rb, rv = nms_candidates(pipe, bench_imgs)
    max_err = max(*errs, check_nms_kernel(rb, rv, thresh, "serving inputs")[1])

    # plain, kernel, kernel, plain; the wrapper call as the path pays it
    # (host checks, allocation, stream, ctypes) and the kernel alone in a CUDA
    # graph.  Its host time is paired with that of a bare ctypes launch of
    # the probe build's copy of the kernel (no checks, stream looked up once):
    # wrapper, bare, bare, wrapper.
    call = lambda: cuda_nms.nms_suppress_cuda(rb, rv, thresh)  # noqa: E731
    plain = lambda: nms_suppress_plain(rb, rv, thresh)  # noqa: E731
    bare_keep = torch.empty_like(rv)
    bare_args = (rb.data_ptr(), rv.data_ptr(), bare_keep.data_ptr(),
                 BENCH_BATCH, K, thresh, torch.cuda.current_stream().cuda_stream)
    bare = lambda: probe.nms_suppress_launch(*bare_args)  # noqa: E731
    plain_ms = cuda_time_ms(plain, 20, warmup=2)
    call_ms = cuda_time_ms(call, 200)
    kernel_ms = graph_time_ms(call)
    host_ms = host_ms_per_call(call)
    bare_ms = host_ms_per_call(bare)
    bare_ms2 = host_ms_per_call(bare)
    host_ms2 = host_ms_per_call(call)
    # the registered operator mpn::nms_suppress, as the pipeline calls it,
    # against the ctypes wrapper it dispatches to: wrapper, op, op, wrapper
    op = lambda: nms_suppress(rb, rv, thresh)  # noqa: E731
    wrap_ms = [host_ms_per_call(call)]
    op_host_ms = host_ms_per_call(op)
    op_host_ms2 = host_ms_per_call(op)
    wrap_ms.append(host_ms_per_call(call))
    kernel_ms2 = graph_time_ms(call)
    call_ms2 = cuda_time_ms(call, 200)
    plain_ms2 = cuda_time_ms(plain, 20, warmup=2)
    bound_ms, bound_by = nms_bound_ms(BENCH_BATCH, K)
    bound_share = bound_ms / kernel_ms
    log(f"kernel nms_suppress: {kernel_ms:.5f} / {kernel_ms2:.5f} ms per launch "
        f"on the device (CUDA graph), {call_ms:.5f} / {call_ms2:.5f} ms per "
        f"wrapper call, {host_ms:.5f} / {host_ms2:.5f} ms of host time per "
        f"wrapper call against {bare_ms:.5f} / {bare_ms2:.5f} ms per bare "
        f"ctypes launch; through the operator mpn::nms_suppress "
        f"{op_host_ms:.5f} / {op_host_ms2:.5f} ms of host time per call "
        f"against the wrapper's {wrap_ms[0]:.5f} / {wrap_ms[1]:.5f}; plain twin "
        f"{plain_ms:.4f} / {plain_ms2:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}), bound share {bound_share:.5f} at "
        f"B={BENCH_BATCH} K={K} [{card}]")
    split = time_nms_probes(probe, rb, rv, thresh)
    # the eval path's shape: one image and its mirror, K candidates
    eb, ev_ = (t.cuda() for t in fuzz_nms_inputs(2, K, gen))
    max_err = max(max_err, check_nms_kernel(eb, ev_, thresh, "eval shape")[1])
    eval_ms = graph_time_ms(lambda: cuda_nms.nms_suppress_cuda(eb, ev_, thresh))
    eval_bound_ms, eval_bound_by = nms_bound_ms(2, K)
    log(f"kernel nms_suppress at the eval's B=2 K={K}: {eval_ms:.5f} ms per "
        f"launch on the device (CUDA graph), bound {eval_bound_ms:.7f} ms "
        f"({eval_bound_by}) [{card}]")
    # the grouped eval's shape: 4 images and their mirrors (6c)
    gb, gv = (t.cuda() for t in fuzz_nms_inputs(8, K, gen))
    max_err = max(max_err, check_nms_kernel(gb, gv, thresh, "grouped eval shape")[1])
    group_ms = graph_time_ms(lambda: cuda_nms.nms_suppress_cuda(gb, gv, thresh))
    group_bound_ms, group_bound_by = nms_bound_ms(8, K)
    log(f"kernel nms_suppress at the grouped eval's B=8 K={K}: {group_ms:.5f} ms "
        f"per launch on the device (CUDA graph), bound {group_bound_ms:.7f} ms "
        f"({group_bound_by}) [{card}]")

    # the reference-shaped baseline's shape (phase 11): one image, K
    # candidates, from the float32 graph of the serving weights on the
    # tool's own first image
    from multiposenet_tpu_torch.engine.inference import make_full_pipeline
    from multiposenet_tpu_torch.tools import bench_reference_shaped
    ref_cfg = bench_reference_shaped.reference_config(cfg.model.backbone)
    ref_pipe = make_full_pipeline(
        build_posenet(ref_cfg.model, torch.device("cuda"), model.state_dict()),
        ref_cfg, (INP, INP), device="cuda", with_peaks=False)
    ob, ov = nms_candidates(ref_pipe, torch.from_numpy(
        bench_reference_shaped.reference_images(1, INP)[0]).cuda())
    del ref_pipe
    max_err = max(max_err, check_nms_kernel(ob, ov, thresh,
                                            "reference-shaped B=1 inputs")[1])
    one_ms = graph_time_ms(lambda: cuda_nms.nms_suppress_cuda(ob, ov, thresh))
    one_bound_ms, one_bound_by = nms_bound_ms(1, K)
    log(f"kernel nms_suppress at the reference-shaped B=1 K={K}: {one_ms:.5f} ms "
        f"per launch on the device (CUDA graph), bound {one_bound_ms:.7f} ms "
        f"({one_bound_by}), bound share {one_bound_ms / one_ms:.5f} [{card}]")

    # ---- 3. small reference check -------------------------------------------
    check_against_cpu()
    eval_check = check_eval_against_cpu()                         # phase 6a

    # ---- 4. serving: the main path ------------------------------------------
    predictor = BatchPredictor(cfg, model=model, batch_size=SERVE_BATCH,
                               device="cuda")
    images = mixed_images(rng, 40)
    predictor.predict(images[:SERVE_BATCH])          # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    cuda_nms.launches = 0
    t0 = time.perf_counter()
    results = predictor.predict(images)
    serve_s = time.perf_counter() - t0
    launches = {"nms_suppress": cuda_nms.launches}
    n_people = check_people(results, len(images))
    n_batches = -(-len(images) // SERVE_BATCH)
    log(f"serving: {len(images)} images of mixed sizes at batch {SERVE_BATCH} "
        f"({n_batches} batches, ragged tail) in {serve_s:.3f} s; "
        f"{sum(bool(r) for r in results)} images with people, {n_people} people; "
        f"kernel launches {launches}")
    for name, n in launches.items():
        if n < n_batches:
            raise AssertionError(f"kernel {name} launched {n} times on the "
                                 f"serving path, expected >= {n_batches}")

    # ---- 5. e2e at bench.py's configuration ----------------------------------
    scales = torch.ones(BENCH_BATCH, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    e2e_ms = cuda_time_ms(lambda: pipe(bench_imgs, scales), 10, warmup=3)
    fwd_ms = cuda_time_ms(lambda: pipe.forward(bench_imgs), 10, warmup=2)
    heads = pipe.forward(bench_imgs)
    post_ms = cuda_time_ms(lambda: pipe.postprocess(*heads, scales), 10, warmup=2)
    t0 = time.perf_counter()
    iters = 5
    outs = [pipe(bench_imgs, scales)[1] for _ in range(iters)]
    people = [format_pose_batch(a.cpu()) for a in outs]
    host_s = (time.perf_counter() - t0) / iters
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check_people(people[0], BENCH_BATCH)
    log(f"e2e: batch {BENCH_BATCH} x {INP}px resnet101 bf16 max_people "
        f"{MAX_PEOPLE}: {e2e_ms:.2f} ms/batch on the device = "
        f"{BENCH_BATCH / e2e_ms * 1e3:.1f} images/s (forward {fwd_ms:.2f} ms, "
        f"post-processing {post_ms:.2f} ms); with host formatting "
        f"{host_s * 1e3:.2f} ms/batch = {BENCH_BATCH / host_s:.1f} images/s; "
        f"peak memory {peak_gib:.2f} GiB [{card}]")

    # ---- 5b. deployment: fold, export, serve from the artifact, bench ---------
    deploy = deployment_phase(model, cfg, bench_imgs, images, card)

    # ---- 6b. multi-scale COCO eval at full width -----------------------------
    full_eval = full_width_eval(model, cfg, card)
    # the serving model's weights as phases 4-6b ran it, for phase 9
    serve_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}

    # ---- 6c. every evaluator variant at 6b's width, cli test's images -------
    variants = eval_variants(model, full_eval, card)
    # phase 9 rebuilds the serving model from serve_state (6c rescaled the
    # heatmap conv of this one) and reruns 6b's inputs
    eval_inputs = {k: full_eval[k] for k in ("images", "gt", "cfg")}
    del model, predictor, pipe, heads, outs, bench_imgs, full_eval["images"]
    torch.cuda.empty_cache()

    # ---- 7. training: CUDA against CPU, then the stage chain at full width ----
    check_training_against_cpu()
    training = full_width_training(card)

    # ---- 8. the CLI on a synthetic COCO tree of PNG files ---------------------
    cli = cli_phase(card)

    # ---- 9. several processes on the one card --------------------------------
    dist = distributed_phase(card, serve_state, cfg, images, eval_inputs,
                             training["keypoint"]["ms_per_step"])

    # ---- 10. the synthetic end-to-end gate: a trained model's AP ------------
    # ---- 12. the last tools, in their own processes beside the gate: both
    # phases are mostly loaders and process start-up, and neither times the
    # card; each process counts its own K1 launches
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        last_tools = ex.submit(last_tools_phase, card)
        gate = gate_phase(card)
        last = last_tools.result()

    # ---- 11. the measurement tools at full width -----------------------------
    tools = tools_phase(card, serve_state, cfg)

    kernels = [{
        "name": "nms_suppress",
        "route": "cuda",
        "source": "multiposenet_tpu_torch/csrc/nms_suppress.cu",
        "replaces": "multiposenet_tpu/ops/pallas_nms.py:33",
        "tpu_kernel": "multiposenet_tpu/ops/pallas_nms.py::_nms_suppress_kernel",
        "launches": (launches["nms_suppress"] + full_eval["launches"]
                     + cli["launches"] + deploy["launches"]
                     + sum(v["launches"] for v in variants["variants"].values())
                     + variants["cli_test_launches"]
                     + dist["dryrun_e2e_launches"]
                     + dist["distributed_coco_eval_launches"]
                     + dist["sharded_serving_launches"]
                     + gate["launches"] + gate["first_image_launches"]
                     + sum(tools["launches"].values())
                     + sum(last["launches"].values())),
        "launches_by_path": {"serving": launches["nms_suppress"],
                             "coco_eval": full_eval["launches"],
                             "coco_eval_check": eval_check["launches"],
                             "coco_eval_check_host_resize": eval_check["host_resize"],
                             "coco_eval_check_group_size_2": eval_check["group_size_2"],
                             **{f"coco_eval_{k}": v["launches"]
                                for k, v in variants["variants"].items()},
                             "cli_test": variants["cli_test_launches"],
                             "cli_coco_eval": cli["launches"],
                             "exported_serving": deploy["launches"],
                             "exported_on_cpu": deploy["moved_launches"],
                             "dryrun_e2e": dist["dryrun_e2e_launches"],
                             "distributed_coco_eval": dist["distributed_coco_eval_launches"],
                             "sharded_serving": dist["sharded_serving_launches"],
                             "synth_gate_coco_eval": gate["launches"],
                             "synth_gate_first_image": gate["first_image_launches"],
                             **tools["launches"], **last["launches"]},
        "eval_variant_ms_per_image": {k: v["ms_per_image"]
                                      for k, v in variants["variants"].items()},
        "max_abs_err": max(max_err, full_eval["max_abs_err"], dist["max_abs_err"],
                           gate["max_abs_err"], tools["max_abs_err"],
                           *(v["max_abs_err"] for v in variants["variants"].values())),
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "call_ms": call_ms,
        "host_ms": host_ms,
        "op_host_ms": op_host_ms,
        "bare_host_ms": bare_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_share": bound_share,
        "probe_ms": split,
        "eval_shape_ms": eval_ms,
        "eval_shape_bound_ms": eval_bound_ms,
        "group_shape_ms": group_ms,
        "group_shape_bound_ms": group_bound_ms,
        "reference_shaped_shape_ms": one_ms,
        "reference_shaped_shape_bound_ms": one_bound_ms,
        "library_ms": None,
        "build_s": build_s.get(cuda_nms.SOURCE),
    }]
    log(f"smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
