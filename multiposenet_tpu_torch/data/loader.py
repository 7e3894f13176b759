"""Threaded prefetching batch loader and the host-to-device prefetch — the
port's copy of multiposenet_tpu/data/loader.py.

``Loader`` (numpy and threads only) replaces the reference's torch
DataLoader (datasets/dataloader.py:6-38): worker threads build samples,
batches are stacked as numpy arrays and emitted in order, a few steps
ahead.  With several processes each loads its own shard of the dataset
(``shard_id``, ``num_shards``).  ``device_prefetch`` puts batches on the
process's device two steps ahead of the train loop.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import traceback
import weakref
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from multiposenet_tpu_torch.config import resolve_device
from multiposenet_tpu_torch.utils import trace


class _WorkerError:
    """A worker's exception on its way to the consuming thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Loader:
    """Batches of ``dataset`` in order, built by ``num_workers`` threads.
    An exception raised while building a sample is raised in the iterating
    thread, which then stops the other workers.

    ``batch_size`` is this process's batch.  With several processes pass
    ``shard_id=process_index``, ``num_shards=process_count``: every shard
    shuffles the same permutation (same seed and epoch) and takes its
    stride of it, so the shards are disjoint and together cover the
    dataset once per epoch, but for up to ``num_shards - 1`` trailing
    samples: every shard has the same length, since processes that ran
    different numbers of steps would wait forever in the next collective.

    Each worker draws its samples' augmentation from its own generator (as
    the JAX ``Loader`` does), so which batch meets which draws depends on
    the workers' timing.  ``seed_per_batch`` draws each batch from a
    generator of (seed, epoch, shard, batch index) instead, so that a run's
    batches repeat whatever the number of workers.

    The workers are threads, as in the JAX package, or with ``processes``
    processes: the samples are then built outside the interpreter lock of
    the process that enqueues the train steps, which threads hold back
    (the augmentation is Python and numpy).  The processes are forked on
    the first epoch, serve every later one (the dataset must not change)
    and build each epoch's batches one epoch ahead of the caller.  They
    run dataset code alone, never the GPU.  Forked, not spawned: spawned
    workers ran the synthetic gate's keypoint and detection stages 1.5×
    slower on the H100 (cause not isolated)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4, shard_id: int = 0, num_shards: int = 1,
                 seed_per_batch: bool = False, processes: bool = False):
        if num_shards < 1 or not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed_per_batch = seed_per_batch
        self.processes = processes
        self._pool = None
        self.epoch = 0

    def _shard_size(self) -> int:
        return len(self.dataset) // self.num_shards

    def close(self) -> None:
        """Stop the worker processes (``processes=True``) now rather than
        when the Loader is collected; a later epoch forks new ones."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __len__(self):
        n = self._shard_size()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self, epoch: int):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        order = order[self.shard_id::self.num_shards][: self._shard_size()]
        n = len(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            yield order[i: i + self.batch_size]

    def _worker_rng(self, wid: int, epoch: int) -> np.random.Generator:
        return np.random.default_rng((self.seed + epoch) * 10007 + wid)

    def _batch(self, epoch: int, bi: int, idxs, rng) -> Dict[str, np.ndarray]:
        if self.seed_per_batch:
            rng = np.random.default_rng((self.seed, epoch, self.shard_id, bi))
        samples = [self.dataset.__getitem__(int(i), rng=rng) for i in idxs]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self.epoch += 1
        if self.processes:
            return self._iter_processes(self.epoch)
        return self._iter_threads(list(self._index_batches(self.epoch)))

    def _queue_epochs(self, epoch: int) -> None:
        """Epoch ``epoch``'s batches, then the next one's behind them, so
        that the workers go on while the caller validates and checkpoints."""
        for e in (epoch, epoch + 1):
            if e not in self._queued:
                for bi, b in enumerate(self._index_batches(e)):
                    self._pool.jobs.put((e, bi, b))
                self._queued.add(e)
        self._queued.discard(epoch - 1)

    def _iter_processes(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        if self._pool is None:
            self._pool = _WorkerPool(self)
            weakref.finalize(self, self._pool.close)
            self._queued, self._ahead = set(), {}
        self._queue_epochs(epoch)
        pool = self._pool
        n = len(self)
        results = self._ahead.pop(epoch, {})
        done = False
        try:
            for want in range(n):
                while want not in results:
                    e, bi, item = pool.get()
                    if isinstance(item, _WorkerError):
                        raise item.exc
                    if e == epoch:
                        results[bi] = item
                    elif e > epoch:
                        self._ahead.setdefault(e, {})[bi] = item
                yield results.pop(want)
            done = True
        finally:
            if not done:
                # this epoch's jobs would still be in flight next epoch
                pool.close()
                self._pool = None

    def _iter_threads(self, batches) -> Iterator[Dict[str, np.ndarray]]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        idx_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            idx_q.put((bi, b))

        results: Dict[int, Dict] = {}
        results_lock = threading.Lock()
        next_emit = [0]
        done = threading.Event()

        def worker(wid: int):
            try:
                fill(wid)
            except BaseException as e:  # raised in the consumer's thread
                out_q.put(_WorkerError(e))

        def fill(wid: int):
            rng = self._worker_rng(wid, self.epoch)
            while not done.is_set():
                try:
                    bi, idxs = idx_q.get_nowait()
                except queue.Empty:
                    return
                batch = self._batch(self.epoch, bi, idxs, rng)
                with results_lock:
                    results[bi] = batch
                # emit in order
                while True:
                    with results_lock:
                        if next_emit[0] in results:
                            item = results.pop(next_emit[0])
                            next_emit[0] += 1
                        else:
                            break
                    out_q.put(item)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            for _ in range(len(batches)):
                item = out_q.get()
                if isinstance(item, _WorkerError):
                    raise item.exc
                yield item
        finally:
            done.set()


class _WorkerPool:
    """A Loader's worker processes: (epoch, batch index, indices) jobs in,
    (epoch, batch index, batch or _WorkerError) out."""

    def __init__(self, loader: Loader):
        ctx = mp.get_context("fork")
        self.jobs = ctx.Queue()
        self.out = ctx.Queue(maxsize=loader.prefetch + loader.num_workers)
        self.procs = [ctx.Process(target=_process_worker,
                                  args=(loader, w, self.jobs, self.out),
                                  daemon=True)
                      for w in range(loader.num_workers)]
        for p in self.procs:
            p.start()

    def get(self):
        while True:
            try:
                return self.out.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in self.procs if p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"a loader worker process ended (exit "
                                       f"codes {dead})") from None

    def close(self) -> None:
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            p.join(5)
        for q in (self.jobs, self.out):
            q.cancel_join_thread()
            q.close()


def _process_worker(loader: Loader, wid: int, jobs, out) -> None:
    """A loader worker process: each job's batch, with the worker's
    generator of that epoch, until the pool is closed."""
    torch.set_num_threads(1)
    epoch, rng = None, None
    while True:
        e, bi, idxs = jobs.get()
        if e != epoch:
            epoch, rng = e, loader._worker_rng(wid, e)
        try:
            out.put((e, bi, loader._batch(e, bi, idxs, rng)))
        except BaseException:  # raised in the consumer's process
            out.put((e, bi, _WorkerError(RuntimeError(
                f"loader worker {wid}, batch {bi}: "
                f"{traceback.format_exc()}"))))
            return


def device_prefetch(iterator: Iterable, device=None, depth: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Overlap host-to-device copies with compute: a background thread puts
    each batch (a dict of numpy arrays or tensors) on ``device`` up to
    ``depth`` batches ahead of the consumer.

    On a GPU the thread copies each array into pinned host memory and
    enqueues a ``non_blocking`` copy on a side stream, then records an
    event.  The consumer's current stream waits on that event before the
    batch is handed out, and each tensor is recorded on the consumer's
    stream (``record_stream``), so its memory is not reused before the
    consumer's work on it has run.

    The consumer's wait for each batch is the span ``data.wait``
    (utils/trace.py).  An exception in the source iterator is raised in the
    consumer; a consumer that stops early stops the thread (its puts time
    out and check the stop flag).
    """
    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_cuda else None
    out_q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def put_on_device(batch):
        if not on_cuda:
            return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}, None
        with torch.cuda.stream(side):
            out = {}
            for k, v in batch.items():
                t = torch.as_tensor(v)
                if t.device.type == "cpu":
                    t = t.pin_memory()
                out[k] = t.to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def _put(item) -> bool:
        """Stop-aware put: never blocks past the consumer's exit."""
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def pump():
        try:
            for batch in iterator:
                if not _put((None, put_on_device(batch))):
                    return
        except BaseException as e:  # propagate into the consumer
            _put((e, None))
            return
        _put((None, _END))

    th = threading.Thread(target=pump, daemon=True, name="device_prefetch")
    th.start()
    try:
        while True:
            with trace.span("data.wait"):
                exc, item = out_q.get()
            if exc is not None:
                raise exc
            if item is _END:
                return
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for t in batch.values():
                    t.record_stream(stream)
            yield batch
    finally:
        stop.set()
