"""Several processes — torch.distributed, the port's counterpart of
multiposenet_tpu/parallel/distributed.py.

The JAX package joins one process per host into one global mesh with
``jax.distributed``.  Here each process drives one device and joins a
``torch.distributed`` process group: NCCL between GPUs, gloo on the CPU.

- ``initialize()`` joins the group (or does nothing: one process)
- ``process_count()`` / ``process_index()`` / ``is_primary()`` — topology
- ``process_device()`` — the device this process drives
- ``per_host_batch(global_batch)`` — this process's share of a global batch
- ``gather_objects(obj)`` — every process's JSON object, on every process
- ``spawn_ranks(fn, n)`` — run ``fn`` in n new processes joined in a group

Distributed mode is opt-in, as in JAX: a coordinator address (the CLI's
``--coordinator``, or ``MPN_COORDINATOR_ADDRESS``) gives ``tcp://host:port``
(an address with a scheme, such as ``file:///path``, is used as it is), and
``MPN_DISTRIBUTED=1`` gives ``env://``, so that ``torchrun``'s ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` work.  Otherwise
``initialize`` does nothing and the helpers answer 1, 0 and True, so the
engine calls them unconditionally.
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as tdist

from multiposenet_tpu_torch.config import resolve_device
from multiposenet_tpu_torch.utils.logging import logger

# the device this process drives, set by initialize()
_device: Optional[torch.device] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Join the process group; returns True when it has more than one
    process.  ``device`` is the kind of device the processes drive
    (``cuda`` unless the caller names another; without a GPU that raises):
    each process takes ``cuda:{LOCAL_RANK}``, or ``cuda:{process_id %
    device_count}``.  ``backend`` defaults to ``nccl`` on CUDA and ``gloo``
    on the CPU; any other choice is the caller's, explicitly (two processes
    on one GPU need ``gloo``: NCCL refuses a duplicate GPU).  Safe to call
    twice."""
    global _device
    if tdist.is_initialized():
        return tdist.get_world_size() > 1
    addr = coordinator_address or os.environ.get("MPN_COORDINATOR_ADDRESS")
    if not addr and os.environ.get("MPN_DISTRIBUTED") != "1":
        return False
    if addr:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init_method = addr if "://" in addr else f"tcp://{addr}"
    else:
        init_method = "env://"
        num_processes = (int(os.environ["WORLD_SIZE"]) if num_processes is None
                         else num_processes)
        process_id = (int(os.environ["RANK"]) if process_id is None
                      else process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} not in [0, {num_processes})")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else process_id % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    chosen = backend or ("nccl" if dev.type == "cuda" else "gloo")
    tdist.init_process_group(chosen, init_method=init_method,
                             world_size=num_processes, rank=process_id)
    _device = dev
    logger.info("torch.distributed: process %d/%d on %s, backend %s (%s)",
                process_id, num_processes, dev, chosen,
                "explicit" if backend else "default for the device")
    return num_processes > 1


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _device
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _device = None


def is_active() -> bool:
    """True inside a process group, whatever its size."""
    return tdist.is_available() and tdist.is_initialized()


def process_count() -> int:
    return tdist.get_world_size() if is_active() else 1


def process_index() -> int:
    return tdist.get_rank() if is_active() else 0


def is_primary() -> bool:
    """True on the process that writes checkpoints, metrics and results."""
    return process_index() == 0


def process_device() -> Optional[torch.device]:
    """The device ``initialize`` gave this process; None outside a group."""
    return _device if is_active() else None


def per_host_batch(global_batch_size: int) -> int:
    """This process's share of the global batch; the global batch must
    divide evenly."""
    n = process_count()
    if global_batch_size % n != 0:
        raise ValueError(
            f"global batch_size {global_batch_size} must be divisible by the "
            f"process count {n}")
    return global_batch_size // n


def collective_device() -> torch.device:
    """Where this process's collective buffers live: its GPU under NCCL, the
    host otherwise."""
    if tdist.get_backend() == "nccl":
        return _device
    return torch.device("cpu")


def gather_objects(obj, decode: bool = True) -> Optional[List[Any]]:
    """All-gather one JSON-serialisable object per process: every process
    returns ``[obj_0, ..., obj_{P-1}]``, and ``[obj]`` outside a group.

    The objects travel as UTF-8 JSON in uint8 tensors over the group's own
    collectives (no shared filesystem), the lengths gathered first so that
    ragged payloads pad to one shape.  ``decode=False`` still joins both
    collectives (every process must call this, or the others wait forever)
    but returns None without decoding the others' payloads."""
    if not is_active():
        return [obj] if decode else None
    dev = collective_device()
    n = process_count()
    data = torch.frombuffer(bytearray(json.dumps(obj).encode("utf-8")),
                            dtype=torch.uint8).to(dev)
    size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(n)]
    tdist.all_gather(sizes, size)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.uint8, device=dev)
    padded[:data.numel()] = data
    every = [torch.empty_like(padded) for _ in range(n)]
    tdist.all_gather(every, padded)
    if not decode:
        return None
    return [json.loads(bytes(t[:s].cpu().numpy()).decode("utf-8"))
            for t, s in zip(every, sizes)]


# ---------------------------------------------------------------------------
# n processes on one machine
# ---------------------------------------------------------------------------

class RankFailure(RuntimeError):
    """One or more ranks of ``spawn_ranks`` failed; ``errors`` maps each
    failed rank to its traceback (or to how it ended)."""

    def __init__(self, errors: dict):
        self.errors = dict(sorted(errors.items()))
        super().__init__("\n".join(f"rank {r}: {e}" for r, e in self.errors.items()))


def _rank_main(fn, rank: int, n: int, init_method: str, backend, device,
               threads, args: Sequence, out) -> None:
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize(init_method, n, rank, backend=backend, device=device)
        out.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def spawn_ranks(fn: Callable, n: int, args: Sequence = (), device="cuda",
                backend: Optional[str] = None, timeout: float = 900.0,
                threads: Optional[int] = None, grace: float = 30.0) -> List[Any]:
    """Run ``fn(*args)`` in ``n`` new processes (the ``spawn`` start method)
    joined in one process group (``initialize`` with a ``file://`` address
    in a new temporary directory, ``device`` and ``backend`` as there), and
    return their results in rank order.  ``fn`` must be importable by name
    and its arguments and results picklable; ``threads`` sets each
    process's ``torch.set_num_threads``.

    Raises ``RankFailure`` with every failed rank's traceback if any rank
    raised or died.  After the first failure the other ranks get ``grace``
    seconds to finish (a rank waiting in a collective for the failed one
    never would) and are then ended; past ``timeout`` every rank still
    running is ended.  No process outlives the call."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mpn_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "init")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, init_method, backend, device,
                                   threads, tuple(args), out))
                 for r in range(n)]
        for p in procs:
            p.start()
        results, errors = {}, {}
        deadline = time.monotonic() + timeout
        exited_at = {}
        try:
            while len(results) + len(errors) < n:
                now = time.monotonic()
                if now >= deadline:
                    for r in range(n):
                        if r not in results and r not in errors:
                            errors[r] = (f"still running after {timeout:.0f} s"
                                         if not errors else
                                         "ended: another rank had failed")
                    break
                try:
                    r, ok, value = out.get(timeout=min(1.0, deadline - now))
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if (p.exitcode is not None and r not in results
                                and r not in errors):
                            # its report may still be in the pipe
                            first = exited_at.setdefault(r, now)
                            if now - first > 5.0:
                                errors[r] = f"exited with code {p.exitcode}"
                    if errors:
                        deadline = min(deadline, now + grace)
                    continue
                if ok:
                    results[r] = value
                else:
                    errors[r] = value
                    deadline = min(deadline, time.monotonic() + grace)
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
    if errors:
        raise RankFailure(errors)
    return [results[r] for r in range(n)]
