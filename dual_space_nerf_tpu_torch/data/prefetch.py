"""Multi-worker host loader with prefetch, as the JAX package's
`data/prefetch.py`.

Items of one epoch are prepared ahead of the train step by ``num_workers``
threads (the default) or forked worker processes, into a bounded queue.
The epoch order is ``np.random.default_rng(seed).shuffle(order)`` per
epoch, as in the JAX package, so an ordered loader yields the JAX loader's
index order for the same seed.

- ``backend="thread"``: each worker runs ``dataset[i]`` and the transform
  (the device copies of the train batch and mesh).
- ``backend="process"`` (or DSNERF_LOADER_BACKEND=process): forked worker
  processes run ``dataset[i]`` alone; the transform runs on the consumer
  thread. The pool forks after CUDA is initialised, which is safe only
  because the children never touch CUDA. The real datasets' JPEG and PNG
  decoders are C called through ctypes, which releases the GIL (so the
  threads decode in parallel) and starts no thread pool of its own, so a
  forked child needs no setting where the JAX package pins cv2's pool
  (`cv2.setNumThreads(0)`).

A loader holds at most ``prefetch + num_workers`` items that are started
and not yet yielded (`window`). Ordered, no item ``seq`` is started
(thread backend) or handed to the pool (process backend) before item ``seq
- window`` was yielded, so one slow item cannot pull the rest of the epoch
into the reorder buffer; the consumer keeps reading the bounded queue
meanwhile (stopping it would deadlock a worker that holds the head).
Unordered, the thread backend's bounded queue keeps the count, and the
process backend hands the pool an item only for one yielded.

An exception in a worker or in the transform fails the epoch in the
consumer. Abandoning an epoch (``break``, generator GC, a new ``iter()``)
stops the workers: they check a per-epoch stop event between items, and
the bounded queue takes timed puts, so no worker blocks forever.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
from typing import Callable, Iterator

import numpy as np

_SENTINEL = object()

_WORKER_DATASET = None


def _init_worker(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _get_item(i: int):
    try:
        return _WORKER_DATASET[int(i)]
    except Exception as exc:  # the cause does not survive the pickle to the parent
        raise RuntimeError(f"prefetch worker failed on dataset[{i}]: {exc!r}") from None


class PrefetchLoader:
    """Iterates a dataset for one epoch per ``iter()``. Yield order is
    completion order under the default ``ordered=False`` (torch
    DataLoader(shuffle=True)'s semantics), the shuffled index order under
    ``ordered=True``. Each ``iter()`` advances an epoch counter and forwards
    it to ``dataset.set_epoch(epoch)`` when the dataset has one."""

    def __init__(
        self,
        dataset,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 8,
        seed: int | None = None,
        transform: Callable | None = None,
        backend: str | None = None,
        ordered: bool = False,
    ):
        self.dataset = dataset
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.rng = np.random.default_rng(seed)
        self.transform = transform
        self.ordered = ordered
        self._epoch = 0
        # the environment wins over the config, as in the JAX package
        backend = os.environ.get("DSNERF_LOADER_BACKEND") or backend or "thread"
        if backend not in ("thread", "process"):
            raise ValueError(
                f"PrefetchLoader backend {backend!r}: expected "
                "'thread' or 'process' (DSNERF_LOADER_BACKEND)"
            )
        self.backend = backend

    def __len__(self) -> int:
        return len(self.dataset)

    @property
    def window(self) -> int:
        """Items an epoch may hold started and not yet yielded."""
        return self.prefetch + self.num_workers

    def _iter_process(self, order) -> Iterator:
        """Forked workers sample items (the dataset's numpy tables are
        shared copy-on-write); the transform runs here, on the consumer.
        The pool's task thread takes the indices from a generator that
        hands out one more only for each item yielded, ``window`` ahead
        (`imap` would otherwise dispatch the whole epoch)."""
        ctx = multiprocessing.get_context("fork")
        pool = ctx.Pool(self.num_workers, initializer=_init_worker, initargs=(self.dataset,))
        stop = threading.Event()
        slots = threading.Semaphore(self.window)

        def dispatch():
            for i in order:
                while not slots.acquire(timeout=0.1):
                    if stop.is_set():  # lets pool.terminate() join the task thread
                        return
                yield int(i)

        try:
            imap = pool.imap if self.ordered else pool.imap_unordered
            for item in imap(_get_item, dispatch()):
                if self.transform is not None:
                    item = self.transform(item)
                yield item
                slots.release()
        finally:
            stop.set()
            pool.terminate()
            pool.join()

    def __iter__(self) -> Iterator:
        self._epoch += 1
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        if self.backend == "process":
            yield from self._iter_process(order)
            return

        idx_q: queue.Queue = queue.Queue()
        for seq, i in enumerate(order):
            idx_q.put((seq, int(i)))
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        n_alive = threading.Semaphore(0)
        stop = threading.Event()
        error: list = [None]  # (index, exception) of a failed worker
        yielded = [0]  # ordered: items yielded so far (the consumer's next_seq)
        moved = threading.Condition()

        def worker():
            try:
                while not stop.is_set():
                    try:
                        seq, i = idx_q.get_nowait()
                    except queue.Empty:
                        return
                    if self.ordered:  # start seq only once seq - window is yielded
                        with moved:
                            while seq >= yielded[0] + self.window and not stop.is_set():
                                moved.wait(timeout=0.1)
                        if stop.is_set():
                            return
                    try:
                        item = self.dataset[i]
                        if self.transform is not None:
                            item = self.transform(item)
                    except BaseException as exc:
                        # fail the epoch: stopping drains the pool, the
                        # closer posts the sentinel, the consumer re-raises
                        error[0] = (i, exc)
                        stop.set()
                        return
                    while not stop.is_set():
                        try:
                            out_q.put((seq, item), timeout=0.1)
                            break
                        except queue.Full:
                            continue
            finally:
                n_alive.release()

        workers = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for w in workers:
            w.start()

        def closer():
            for _ in workers:
                n_alive.acquire()
            # after a worker error the consumer still waits on get(): the
            # sentinel must arrive; after the consumer left (stop set by the
            # consumer) nobody reads, so the retries are bounded
            attempts = 0
            while not stop.is_set() or (error[0] is not None and attempts < 600):
                attempts += 1
                try:
                    out_q.put(_SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    continue

        threading.Thread(target=closer, daemon=True).start()

        try:
            # ordered: re-assemble by submission sequence; the workers'
            # window keeps the buffer at most prefetch + num_workers items
            buffered: dict = {}
            next_seq = 0
            while True:
                got = out_q.get()
                if got is _SENTINEL:
                    if error[0] is not None:
                        i, exc = error[0]
                        raise RuntimeError(f"prefetch worker failed on dataset[{i}]") from exc
                    return
                seq, item = got
                if not self.ordered:
                    yield item
                    continue
                buffered[seq] = item
                while next_seq in buffered:
                    yield buffered.pop(next_seq)
                    next_seq += 1
                    with moved:
                        yielded[0] = next_seq
                        moved.notify_all()
        finally:
            # epoch end, break or generator GC: stop the workers and wait
            # for them, so none outlives the iterator mid-item
            stop.set()
            for w in workers:
                w.join(timeout=5.0)
