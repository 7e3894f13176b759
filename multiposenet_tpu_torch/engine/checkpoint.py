"""Checkpoint I/O — torch-native, with the reference's resume semantics;
PyTorch twin of multiposenet_tpu/engine/checkpoint.py.

A checkpoint is a directory ``ckpt_{epoch}[_s{step}]`` holding one
``state.pt``: the model ``state_dict`` (with the BatchNorm running
statistics), the optimizer's ``state_dict``, the step, the epoch and the
stage.  It covers what reference network/net_utils.py:12-110 and
trainer.py:159-231 do with HDF5 and pickled optimizer sidecars:

- save the whole train state, and prune to the newest ``max_n_ckpts``;
- auto-resume from the newest checkpoint in save_dir (trainer.py:159-168);
- best-checkpoint copies by val loss (trainer.py:203-211), hard-linked;
- PARTIAL loads for staged training: a stage starts from another stage's
  checkpoint; its weights and BN statistics load, the optimizer state does
  not, and shape mismatches and missing keys are tolerated with a warning
  (net_utils.py:69-110).

The JAX package's checkpoints are orbax directories, which need JAX to read;
a JAX tree crosses into the port as arrays through
``weights.state_dict_from_flax``.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from multiposenet_tpu_torch.utils.logging import logger

# `ckpt_{epoch}` for epoch checkpoints, `ckpt_{epoch}_s{step}` for in-epoch
# (periodic or preemption) checkpoints; auto-resume orders by (epoch, step)
# so two preemptions inside one epoch never overwrite each other.
CKPT_RE = re.compile(r"ckpt_(\d+)(?:_s(\d+))?$")
STATE_FILE = "state.pt"


def _ckpt_name(epoch: int, step: Optional[int] = None) -> str:
    return f"ckpt_{epoch}" if step is None else f"ckpt_{epoch}_s{step}"


def _map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` applied to every tensor of a nest of dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, Mapping):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


def _payload(state) -> Dict[str, Any]:
    """The checkpoint's content; its tensors are the state's own."""
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "subnet": state.subnet}


def _write(save_dir: str, payload: Dict[str, Any], epoch: int,
           max_n_ckpts: int, step: Optional[int]) -> str:
    """Write ``payload`` (tensors on any device) as ``ckpt_{epoch}[_s{step}]``
    under save_dir, through a temporary directory renamed into place, so a
    crash never leaves a half-written checkpoint under a checkpoint's name;
    then prune to the newest ``max_n_ckpts``."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(save_dir, _ckpt_name(epoch, step)))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(dict(_map_tensors(payload, lambda t: t.cpu()), epoch=epoch),
               os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)

    if max_n_ckpts > 0:
        for e, s in list_checkpoints(save_dir)[:-max_n_ckpts]:
            victim = os.path.join(save_dir, _ckpt_name(e, s if s >= 0 else None))
            shutil.rmtree(victim, ignore_errors=True)
    return path


def save_checkpoint(save_dir: str, state, epoch: int, max_n_ckpts: int = 0,
                    step: Optional[int] = None) -> str:
    """Write ``state`` (engine.train_steps.TrainState) as
    ``ckpt_{epoch}[_s{step}]`` under save_dir and return its path.  Pass
    ``step`` for in-epoch saves (save_freq_step, preemption) so they get
    distinct names (reference trainer.py:271-274)."""
    return _write(save_dir, _payload(state), epoch, max_n_ckpts, step)


def save_model_checkpoint(save_dir: str, state_dict: Mapping[str, torch.Tensor],
                          epoch: int = 0) -> str:
    """A checkpoint of a model state alone (no optimizer state, step 0):
    what ``--ckpt`` and ``restore_model_state_partial`` read, written as
    ``ckpt_{epoch}`` under save_dir.  Returns its path."""
    return _write(save_dir, {"model": dict(state_dict), "step": 0,
                             "subnet": None}, epoch, 0, None)


class AsyncSaver:
    """Checkpoint writes on a background thread, so the train loop keeps
    enqueueing steps while a checkpoint goes to disk.

    ``save()`` snapshots the state ON THE CALLER'S THREAD: every tensor is
    copied on the device, on the current stream, before any later step is
    enqueued there, so the snapshot holds the state as it was at the call
    even though the next steps update the parameters in place.  An event
    recorded after the copies lets the worker read them to the host on a
    side stream without waiting for those later steps.

    A single worker writes the saves (and the pruning they trigger) in
    submission order.  Each snapshot pins a copy of the state in device
    memory until it is written, so ``save()`` first waits for the previous
    save: at most one is in flight, and a slow disk degrades to synchronous
    saves instead of exhausting device memory.

    A failure is logged as soon as it happens (done-callback) and re-raised
    by ``wait()``, which drains every pending save; call it wherever the
    checkpoint must be on disk (best-copy, end of training).  The
    preemption path waits on its own save's future instead, so an earlier
    logged failure cannot mask a successful exit checkpoint.
    """

    def __init__(self):
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: List[concurrent.futures.Future] = []

    @staticmethod
    def _log_failure(fut: concurrent.futures.Future) -> None:
        exc = fut.exception()
        if exc is not None:
            logger.error("background checkpoint save failed: %r", exc)

    @staticmethod
    def _write_snapshot(snap, device: torch.device,
                        ready: Optional[torch.cuda.Event], save_dir: str,
                        epoch: int, max_n_ckpts: int, step: Optional[int]) -> str:
        if ready is None:
            return _write(save_dir, snap, epoch, max_n_ckpts, step)
        side = torch.cuda.Stream(device)
        with torch.cuda.stream(side):
            side.wait_event(ready)
            host = _map_tensors(snap, lambda t: t.to("cpu"))
        return _write(save_dir, host, epoch, max_n_ckpts, step)

    def save(self, save_dir: str, state, epoch: int, max_n_ckpts: int = 0,
             step: Optional[int] = None) -> concurrent.futures.Future:
        """Enqueue a ``save_checkpoint``; returns a future of its path.
        Blocks (without raising) until the previous save has finished."""
        if self._pending:
            concurrent.futures.wait(self._pending)
            # failures were logged by the done-callback; keep them so that
            # wait() can still re-raise, drop the ones that succeeded
            self._pending = [f for f in self._pending if f.exception() is not None]
        with torch.no_grad():
            snap = _map_tensors(_payload(state), lambda t: t.detach().clone())
        device = next(state.model.parameters()).device
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        fut = self._executor().submit(self._write_snapshot, snap, device, ready,
                                      save_dir, epoch, max_n_ckpts, step)
        fut.add_done_callback(self._log_failure)
        self._pending.append(fut)
        return fut

    def _executor(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-save")
        return self._pool

    def then(self, fn: Callable, *args) -> concurrent.futures.Future:
        """Run ``fn(*args)``, which returns a checkpoint's path, on the
        saver's thread once every save enqueued so far is on disk (a best
        copy of the newest one); ``wait()`` and the next ``save()`` wait for
        it as for a save."""
        fut = self._executor().submit(fn, *args)
        fut.add_done_callback(self._log_failure)
        self._pending.append(fut)
        return fut

    def wait(self) -> Optional[str]:
        """Block until every enqueued save has finished; re-raise the first
        failure after all have completed; return the newest successful
        save's path (None if nothing was pending)."""
        pending, self._pending = self._pending, []
        concurrent.futures.wait(pending)
        path = None
        first_exc = None
        for fut in pending:
            exc = fut.exception()
            if exc is not None:
                first_exc = first_exc or exc
            else:
                path = fut.result()
        if first_exc is not None:
            raise first_exc
        return path


def list_checkpoints(save_dir: str) -> List[Tuple[int, int]]:
    """Sorted (epoch, step) pairs, step -1 for an epoch checkpoint, which
    sorts after the step checkpoints of its epoch (it supersedes them)."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        m = CKPT_RE.match(name)
        if m and os.path.isdir(os.path.join(save_dir, name)):
            epoch = int(m.group(1))
            step = int(m.group(2)) if m.group(2) is not None else -1
            out.append((epoch, step))
    return sorted(out, key=lambda t: (t[0], float("inf") if t[1] < 0 else t[1]))


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Newest checkpoint path for auto-resume (reference trainer.py:159-168)."""
    ckpts = list_checkpoints(save_dir)
    if not ckpts:
        return None
    e, s = ckpts[-1]
    return os.path.join(save_dir, _ckpt_name(e, s if s >= 0 else None))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The content of checkpoint directory ``path``, tensors on the CPU."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, state):
    """Full restore into a train state of the same stage, in place: model
    (strict), optimizer state and step.  Returns the state."""
    ckpt = load_checkpoint(path)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


def _is_bn_stat(key: str) -> bool:
    return key.endswith(("running_mean", "running_var"))


def restore_model_state_partial(path: str, template: Mapping[str, torch.Tensor]
                                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Partial load of a checkpoint's model state — weights AND BatchNorm
    running statistics, as the reference's load_net restores the whole
    state_dict (net_utils.py:69-110) — over ``template`` (a model's
    ``state_dict``).  Keys whose shape differs are skipped with a warning;
    keys the checkpoint lacks keep the template's value.

    Returns (state_dict, stats) with the JAX function's stats keys:
    ``loaded``, ``shape_skipped`` and ``missing`` count parameters and BN
    statistics, ``bn_loaded`` the BN statistics loaded.  BatchNorm's
    ``num_batches_tracked`` (no Flax counterpart) loads but is not counted.
    """
    src = load_checkpoint(path)["model"]
    out: Dict[str, torch.Tensor] = {}
    stats = {"loaded": 0, "shape_skipped": 0, "missing": 0, "bn_loaded": 0}
    for k, v in template.items():
        counted = not k.endswith("num_batches_tracked")
        if k in src and tuple(src[k].shape) == tuple(v.shape):
            out[k] = src[k]
            stats["loaded"] += counted
            stats["bn_loaded"] += _is_bn_stat(k)
            continue
        if k in src:
            logger.warning("shape mismatch for %s: ckpt %s vs model %s", k,
                           tuple(src[k].shape), tuple(v.shape))
            stats["shape_skipped"] += counted
        else:
            stats["missing"] += counted
        out[k] = v
    if not stats["bn_loaded"] and any(_is_bn_stat(k) for k in template):
        logger.warning("checkpoint %s carries no BN statistics: the running "
                       "statistics keep their template values", path)
    logger.info("partial model-state restore from %s: %s", path, stats)
    return out, stats


def model_state_for(path: str, model_cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The model state that ``restore_model_state_partial`` of ``path``
    gives a PoseNet drawn from ``seed``.  The checkpoint is read over a
    template of meta tensors first: the random init (seconds on the CPU for
    the PRN's 71 M weights) is drawn only when the checkpoint lacks some of
    the model's entries."""
    from multiposenet_tpu_torch.models.posenet import PoseNet, build_trainable_posenet

    with torch.device("meta"):
        template = PoseNet(model_cfg).state_dict()
    sd, _ = restore_model_state_partial(path, template)
    if any(v.is_meta for v in sd.values()):
        template = build_trainable_posenet(model_cfg, torch.device("cpu"),
                                           seed=seed).state_dict()
        sd, _ = restore_model_state_partial(path, template)
    return sd


def best_path(ckpt_path: str, val_loss: float) -> str:
    return f"{ckpt_path}_{val_loss:.5f}.best"


def copy_best(ckpt_path: str, val_loss: float) -> str:
    """Best-model copy ``ckpt_{e}_{loss}.best`` (reference trainer.py:203-211).
    Its files are hard links to the checkpoint's (a copy where the file
    system has none): a checkpoint is never written in place, so the copy
    keeps the content when the checkpoint is pruned, and costs no writes."""
    best = best_path(ckpt_path, val_loss)
    if os.path.exists(best):
        shutil.rmtree(best)
    shutil.copytree(ckpt_path, best, copy_function=_link_or_copy)
    return best


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)
