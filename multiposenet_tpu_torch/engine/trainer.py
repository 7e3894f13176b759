"""Training engine — the reference Trainer (training/trainer.py:108-362)
around the port's per-stage train steps; PyTorch twin of
multiposenet_tpu/engine/trainer.py.

- epoch loop with per-step meters and fps/ETA logging (print_freq); the
  log line's data wait and host ms per step of each train-step phase come
  from the spans of utils/trace.py (``data.wait``, ``train.*``)
- periodic step checkpoints (save_freq_step) and epoch checkpoints
- in-epoch quick validation every val_freq steps (val_nbatch batches)
- end-of-epoch validation (val_nbatch_end_epoch) and the best-ckpt copy,
  which replaces the run's previous one
- ReduceLROnPlateau on the val loss (factor lr_decay, patience, min mode)
- auto-resume from the newest checkpoint when cfg.train.ckpt is None
- staged init: partial model load (weights and BN statistics) from another
  stage's checkpoint; ``ignore_opt_state`` and ``zero_epoch``
- epoch hooks (on_start_epoch / on_end_epoch)
- preemption: SIGTERM/SIGINT checkpoint after the current step, then exit

Targets and losses are computed on the device inside the step, the learning
rate is an argument of the step, batches reach the device two steps ahead
(``data.loader.device_prefetch``), and the steps' logs stay on the device
until a print fetches them all in one copy.

Several processes (parallel/distributed.py): each process runs a Trainer
on its own device and its own shard of the data (``cfg.train.batch_size``
is the global batch, which must divide by the process count), and the
train steps average the gradients (engine/train_steps.py).  After a resume
or a staged init, process 0's model, optimizer state and counters are
broadcast to the others, since only process 0 writes checkpoints and the
others may have restored nothing or something older.  Only process 0
writes checkpoints and metrics.  A stop signal is not agreed between the
processes (nor in the JAX package): signal every process.
"""

from __future__ import annotations

import datetime
import os
import shutil
import signal
import time
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as tdist

from multiposenet_tpu_torch.config import Config, resolve_device
from multiposenet_tpu_torch.data.loader import device_prefetch
from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
from multiposenet_tpu_torch.engine.train_steps import STEP_FACTORIES, create_train_state
from multiposenet_tpu_torch.models.posenet import PoseNet, build_trainable_posenet
from multiposenet_tpu_torch.parallel import distributed as pdist
from multiposenet_tpu_torch.utils import trace
from multiposenet_tpu_torch.utils.logging import logger
from multiposenet_tpu_torch.utils.meters import AverageValueMeter
from multiposenet_tpu_torch.utils.metrics import MetricsWriter


def _to_cpu(obj):
    """A copy of a nest of dicts, lists and tuples with every tensor on the
    CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _replace_best(path_fut, val_loss: float, previous: Optional[str]) -> str:
    """The best copy of ``path_fut``'s checkpoint in place of ``previous``;
    returns the checkpoint's path (``AsyncSaver.wait`` reports it)."""
    path = path_fut.result()
    best = ckpt_lib.copy_best(path, val_loss)
    if previous is not None and previous != best:
        shutil.rmtree(previous, ignore_errors=True)
    return path


class ReduceLROnPlateau:
    """min-mode plateau scheduler (torch semantics: factor, patience)."""

    def __init__(self, init_lr: float, factor: float = 0.1, patience: int = 3,
                 min_lr: float = 0.0):
        self.lr = init_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                new_lr = max(self.lr * self.factor, self.min_lr)
                if new_lr < self.lr:
                    logger.info("plateau: reducing lr %.3g -> %.3g", self.lr, new_lr)
                self.lr = new_lr
                self.num_bad = 0
        return self.lr


class Trainer:
    def __init__(self, cfg: Config, model: Optional[PoseNet] = None,
                 train_data: Optional[Iterable] = None,
                 val_data: Optional[Iterable] = None,
                 init_ckpt_params: Optional[str] = None, device=None):
        """``train_data``/``val_data``: iterables of batch dicts of numpy
        arrays or tensors (``data.loader.Loader``, or batches in memory).
        ``model``: a PoseNet on ``device``; by default one drawn from
        ``cfg.train.seed``.  ``init_ckpt_params``: a checkpoint of another
        stage to start from (weights and BN statistics).  Inside a process
        group the default device is the process's own, and the data is
        this process's shard."""
        self.cfg = cfg
        n_proc = pdist.process_count()
        if cfg.train.batch_size % n_proc:
            raise ValueError(
                f"batch_size {cfg.train.batch_size} must be divisible by the "
                f"process count {n_proc} (each process takes an equal share); "
                f"use --batch-size {(cfg.train.batch_size // n_proc + 1) * n_proc}")
        self.device = resolve_device(
            pdist.process_device() if device is None and pdist.is_active()
            else device)
        self.train_data = train_data
        self.val_data = val_data
        self.subnet = cfg.train.subnet
        self.save_dir = os.path.join(cfg.train.save_dir, cfg.train.exp_name)

        self.last_epoch = 0
        self.global_step = 0
        self.on_start_epoch_hooks: List[Callable] = []
        self.on_end_epoch_hooks: List[Callable] = []

        # staged init: weights + BN running statistics from another stage's
        # checkpoint (the reference's load_net carries running_mean/var,
        # net_utils.py:69-110; the detection and PRN stages run the trunk's
        # BN on them)
        staged = None
        if init_ckpt_params and model is None:
            model = build_trainable_posenet(
                cfg.model, self.device,
                ckpt_lib.model_state_for(init_ckpt_params, cfg.model, cfg.train.seed))
            staged = init_ckpt_params
        self.state = create_train_state(cfg, self.subnet, model=model,
                                        device=self.device)
        self.model = self.state.model
        if init_ckpt_params and staged is None:
            self._load_model_partial(init_ckpt_params)

        # resume (reference trainer.py:152-168)
        resume = cfg.train.ckpt
        if resume is None and not cfg.train.re_init:
            resume = ckpt_lib.latest_checkpoint(self.save_dir)
        if resume and os.path.isdir(resume):
            if cfg.train.ignore_opt_state:
                self._load_model_partial(resume)
            else:
                ckpt_lib.restore_checkpoint(resume, self.state)
                if not cfg.train.zero_epoch:
                    self.last_epoch = self.state.step // max(
                        1, len(train_data) if train_data is not None else 1)
                    m = ckpt_lib.CKPT_RE.match(os.path.basename(resume))
                    if m:
                        self.last_epoch = int(m.group(1))
                        if m.group(2) is not None:
                            # a mid-epoch (step or preemption) checkpoint:
                            # the epoch it was taken in did not finish
                            self.last_epoch -= 1
            # keep the step-checkpoint names monotonic across resumes, so
            # that latest_checkpoint() never prefers a stale one
            self.global_step = self.state.step
            logger.info("resumed from %s (epoch %d, step %d)", resume,
                        self.last_epoch, self.global_step)

        if n_proc > 1:
            self._broadcast_from_primary()

        self.train_step, self.val_step = STEP_FACTORIES[self.subnet](
            cfg, device=self.device)

        self.scheduler = ReduceLROnPlateau(
            cfg.train.init_lr, cfg.train.lr_decay, cfg.train.plateau_patience)
        # the PRN stage's dropout masks (the JAX trainer splits PRNGKey(seed + 1))
        # (the same seed in every process: each draws the global batch's masks)
        self.generator = torch.Generator(self.device).manual_seed(cfg.train.seed + 1)
        # several processes: process 0 alone writes checkpoints and metrics;
        # validation and the plateau scheduler run on every process on the
        # global mean of the val logs, so learning rates stay in step
        self.is_primary = pdist.is_primary()
        self.metrics = MetricsWriter(self.save_dir) if self.is_primary else None
        # checkpoints are written on a background thread; waits happen only
        # where the file must exist (best-copy, preemption, end of training)
        self.saver = ckpt_lib.AsyncSaver() if self.is_primary else None
        self._stop_requested = False

    def _broadcast_from_primary(self) -> None:
        """Process 0's parameters, buffers, optimizer state and counters on
        every process."""
        for t in self.model.state_dict().values():
            tdist.broadcast(t, src=0)
        payload = [{"optimizer": _to_cpu(self.state.optimizer.state_dict()),
                    "step": self.state.step, "last_epoch": self.last_epoch,
                    "global_step": self.global_step}]
        tdist.broadcast_object_list(payload, src=0)
        got = payload[0]
        self.state.optimizer.load_state_dict(got["optimizer"])
        self.state.step = got["step"]
        self.last_epoch = got["last_epoch"]
        self.global_step = got["global_step"]

    def _load_model_partial(self, path: str) -> None:
        sd, _ = ckpt_lib.restore_model_state_partial(path, self.model.state_dict())
        self.model.load_state_dict(sd)

    def install_signal_handlers(self):
        """Graceful preemption: SIGTERM/SIGINT finish the current step,
        checkpoint, then exit with ``SystemExit(0)``; auto-resume picks the
        run back up."""
        def _handler(signum, _frame):
            logger.warning("signal %d received: will checkpoint and stop "
                           "after the current step", signum)
            self._stop_requested = True
        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)

    # ------------------------------------------------------------------

    def _step_args(self, lr: float):
        if self.subnet == "prn":
            return (lr, self.generator)
        return (lr,)

    def train(self):
        best_loss = float("inf")
        best_path = None
        for _ in range(self.last_epoch, self.cfg.train.max_epoch):
            self.last_epoch += 1
            logger.info("Start training epoch %d", self.last_epoch)
            for hook in self.on_start_epoch_hooks:
                hook(self)

            self._train_one_epoch()

            for hook in self.on_end_epoch_hooks:
                hook(self)

            if (self.last_epoch % self.cfg.train.save_freq_epoch == 0
                    or self.last_epoch == self.cfg.train.max_epoch):
                path_fut = None
                if self.is_primary:
                    # the save overlaps the end-of-epoch validation
                    path_fut = self.saver.save(
                        self.save_dir, self.state, self.last_epoch,
                        self.cfg.train.save_nckpt_max)
                if self.cfg.train.val_nbatch_end_epoch > 0 and self.val_data is not None:
                    val_loss = self.validate(self.cfg.train.val_nbatch_end_epoch)
                    if val_loss < best_loss:
                        if path_fut is not None:
                            best = ckpt_lib.best_path(os.path.abspath(os.path.join(
                                self.save_dir, f"ckpt_{self.last_epoch}")), val_loss)
                            logger.info("found better ckpt (%.5f -> %.5f): %s",
                                        best_loss, val_loss, best)
                            # on the saver's thread once the checkpoint is on
                            # disk; the copy it supersedes holds a worse model
                            # (the reference keeps every one on disk)
                            self.saver.then(_replace_best, path_fut, val_loss,
                                            best_path)
                            best_path = best
                        best_loss = val_loss
                    self.scheduler.step(val_loss)
        if self.saver is not None:
            self.saver.wait()

    def _flush_logs(self, pending: List[Dict[str, torch.Tensor]], meters
                    ) -> Optional[Dict[str, float]]:
        """Fetch every buffered step's logs in one copy to the host and feed
        the meters.  Returns the newest step's logs as floats."""
        if not pending:
            return None
        keys = list(pending[0])
        fetched = torch.stack([torch.stack([logs[k].float() for k in keys])
                               for logs in pending]).cpu().tolist()
        pending.clear()
        for row in fetched:
            for k, v in zip(keys, row):
                meters.setdefault(k, AverageValueMeter()).add(v)
        return dict(zip(keys, fetched[-1]))

    def _train_one_epoch(self):
        cfg = self.cfg.train
        meters: Dict[str, AverageValueMeter] = {}

        n_batches = len(self.train_data) if hasattr(self.train_data, "__len__") else None
        batches = device_prefetch(iter(self.train_data), self.device, depth=2)
        # the steps' logs stay on the device between prints: reading one
        # per step would wait for the device every step
        pending: List[Dict[str, torch.Tensor]] = []

        def flush_logs():
            with trace.span("train.logs"):
                return self._flush_logs(pending, meters)

        t_print, spans_then = time.perf_counter(), trace.totals()
        interval_steps = 0
        for step, batch in enumerate(batches):
            _, logs = self.train_step(self.state, batch,
                                      *self._step_args(self.scheduler.lr))
            pending.append(logs)
            self.global_step += 1
            interval_steps += 1

            if step % cfg.print_freq == 0:
                newest = flush_logs()  # waits for the device
                # step wall time and the spans' host seconds, averaged
                # over the print interval
                step_time = (time.perf_counter() - t_print) / interval_steps
                spans_now = trace.totals()
                self._print_log(step, n_batches, meters, step_time,
                                _seconds_per_step(spans_now, spans_then, interval_steps))
                if self.metrics is not None:
                    self.metrics.write(self.global_step, newest, prefix="train/")
                t_print, spans_then = time.perf_counter(), spans_now
                interval_steps = 0

            if self.global_step % cfg.save_freq_step == 0 and self.is_primary:
                flush_logs()
                self.saver.save(self.save_dir, self.state, self.last_epoch,
                                cfg.save_nckpt_max, step=self.global_step)

            if (self.val_data is not None and cfg.val_freq > 0
                    and self.global_step % cfg.val_freq == 0):
                self.validate(cfg.val_nbatch)

            if self._stop_requested:
                if self.is_primary:
                    fut = self.saver.save(self.save_dir, self.state,
                                          self.last_epoch, cfg.save_nckpt_max,
                                          step=self.global_step)
                    # this save's own future, not saver.wait(): an earlier
                    # logged failure must not mask the exit checkpoint
                    logger.info("checkpointed at step %d after stop request "
                                "(%s)", self.global_step, fut.result())
                raise SystemExit(0)
        flush_logs()

    def validate(self, max_batches: int) -> float:
        """Meter every scalar the val step emits (per-stage losses, max/min
        heatmap, ...), as the reference's val loss does (tester.py:515-543);
        returns the mean 'loss'.  The logs are fetched in one copy."""
        pending = []
        for i, batch in enumerate(self.val_data):
            if i >= max_batches:
                break
            pending.append(self.val_step(self.state, batch))
        meters: Dict[str, AverageValueMeter] = {}
        if self._flush_logs(pending, meters) is None:
            logger.warning("validation loader produced no batches "
                           "(dataset smaller than batch_size?)")
            return float("inf")
        means = {k: m.value()[0] for k, m in meters.items()}
        logger.info("validation (%d batches): %s", meters["loss"].n,
                    "  ".join(f"{k}={v:.6f}" for k, v in sorted(means.items())))
        if self.metrics is not None:
            self.metrics.write(self.global_step, means, prefix="val/")
        return means["loss"]

    def _print_log(self, step, n_batches, meters, step_time: float,
                   span_seconds: Dict[str, float]):
        """The meters, then ``(data wait/step time s, fps, rest)`` and the
        host ms per step of each ``train.*`` span (``span_seconds``: seconds
        per step by span name, over the print interval)."""
        lines = [f"{self.cfg.train.exp_name}: epoch {self.last_epoch} "
                 f"[{step}/{n_batches or '?'}] lr={self.scheduler.lr:.2e}"]
        for k, m in meters.items():
            mean, _ = m.value()
            lines.append(f"\t{k}: {mean:.10f}")
        bt = step_time + 1e-9
        dt = span_seconds.get("data.wait", 0.0) + 1e-9
        fps = self.cfg.train.batch_size / bt
        if n_batches:
            rest = datetime.timedelta(seconds=int((n_batches - step) * bt))
        else:
            rest = "?"
        lines.append(f"\t({dt:.3f}/{bt:.3f}s, fps:{fps:.1f}, rest: {rest})")
        phases = [f"{name[len('train.'):]} {1e3 * s:.2f}"
                  for name, s in span_seconds.items() if name.startswith("train.")]
        if phases:
            lines.append(f"\thost ms/step: {', '.join(phases)}")
        logger.info("\n".join(lines))


def _seconds_per_step(now: Dict[str, tuple], then: Dict[str, tuple], steps: int
                      ) -> Dict[str, float]:
    """Seconds per step of each span that ran between two ``trace.totals()``."""
    out = {}
    for name, (calls, seconds) in now.items():
        calls0, seconds0 = then.get(name, (0, 0.0))
        if calls > calls0:
            out[name] = (seconds - seconds0) / max(steps, 1)
    return out
