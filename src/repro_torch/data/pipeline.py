"""Host data pipeline: sharded, prefetched, checkpointable iterators (copy
of ``repro/data/pipeline.py``; numpy and threads only).

Design for 1000+ node clusters:
  * each data-loader host owns a disjoint slice of the index space
    (``index = cursor * world + host_rank``) — no coordination needed;
  * the ONLY pipeline state is the integer cursor, so checkpoint/restore
    and elastic re-sharding (changing ``world``) are trivial and exact;
  * a background thread keeps a small prefetch queue ahead of the step loop
    so host-side generation overlaps device compute;
  * worker failures PROPAGATE: a ``make_batch`` that raises is retried a
    bounded number of times inside the worker (transient blips — a flaky
    filesystem, a remote reader hiccup), and if it still fails the error
    travels through the queue and ``__next__`` raises
    :class:`DataWorkerError`. The consumer never hangs on a dead worker,
    and a deterministic ``make_batch`` bug can never become a silent
    respawn-forever loop (the drill: ``repro.chaos.flaky_make_batch``).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class DataWorkerError(RuntimeError):
    """The prefetch worker's ``make_batch`` failed (after its bounded
    retries) or the worker died without delivering; raised on the
    consumer thread by ``__next__``. The cursor is NOT advanced past the
    failed batch — a retry after fixing the cause resumes exactly
    there."""


class ShardedIterator:
    """Deterministic, restartable batch iterator.

    ``make_batch(seed, start_index, batch_size) -> dict of np arrays`` must
    be a pure function (our synthetic generators are; a real corpus reader
    keyed by record index satisfies the same contract).

    ``worker_retries``: extra in-worker attempts after a ``make_batch``
    failure, with ``retry_backoff * 2**i`` seconds between attempts,
    before the error is delivered to the consumer.
    """

    def __init__(self, make_batch: Callable[[int, int, int], Dict[str, Any]],
                 batch_size: int, seed: int = 0,
                 host_rank: int = 0, world: int = 1,
                 prefetch: int = 2, worker_retries: int = 2,
                 retry_backoff: float = 0.05):
        self.make_batch = make_batch
        self.batch_size = batch_size
        self.seed = seed
        self.host_rank = host_rank
        self.world = world
        self.cursor = 0
        self.worker_retries = int(worker_retries)
        self.retry_backoff = float(retry_backoff)
        self._prefetch = prefetch
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        # batch_size / world are recorded for observability: restoring under
        # a different world is SUPPORTED (elastic re-sharding — the cursor
        # semantics stay exact), but it changes which records each host sees,
        # so a mismatch is worth a log line rather than silence.
        return {"cursor": self.cursor, "seed": self.seed,
                "batch_size": self.batch_size, "world": self.world}

    def load_state_dict(self, state: Dict[str, int]):
        self._drain()
        for key in ("batch_size", "world"):
            if key in state and int(state[key]) != getattr(self, key):
                logging.getLogger("repro_torch.data").warning(
                    "ShardedIterator restored with %s=%d (checkpoint had "
                    "%d); cursor semantics stay exact but the record->host "
                    "assignment changes", key, getattr(self, key),
                    int(state[key]))
        self.cursor = int(state["cursor"])
        self.seed = int(state["seed"])

    # -- iteration -----------------------------------------------------------
    def _index_for(self, cursor: int) -> int:
        return (cursor * self.world + self.host_rank) * self.batch_size

    def _produce(self, cursor: int):
        return self.make_batch(self.seed, self._index_for(cursor),
                               self.batch_size)

    def _produce_with_retries(self, cursor: int):
        for attempt in range(self.worker_retries + 1):
            try:
                return self._produce(cursor)
            except Exception:
                if attempt >= self.worker_retries or self._stop.is_set():
                    raise
                logging.getLogger("repro_torch.data").warning(
                    "make_batch failed at cursor %d (attempt %d/%d); "
                    "retrying", cursor, attempt + 1, self.worker_retries + 1,
                    exc_info=True)
                time.sleep(self.retry_backoff * (2 ** attempt))

    def _put(self, item: Tuple[int, Any, bool]) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        cursor = self.cursor
        while not self._stop.is_set():
            try:
                batch = self._produce_with_retries(cursor)
            except Exception as e:      # noqa: BLE001 — delivered, not lost
                # deliver the failure and EXIT: the old behavior (die
                # silently, get respawned by _ensure_thread from the
                # stale self.cursor) turned any deterministic
                # make_batch bug into an invisible infinite respawn loop
                self._put((cursor, e, True))
                return
            if not self._put((cursor, batch, False)):
                return
            cursor += 1

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            # a dead worker always leaves its parting error on the queue
            # (consumed by __next__ below); respawns only happen after
            # that error has been raised, from the un-advanced cursor
            if self._thread is not None and self._queue is not None \
                    and not self._queue.empty():
                return
            self._stop.clear()
            self._queue = queue.Queue(maxsize=self._prefetch)
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _drain(self):
        if self._thread is not None:
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except (queue.Empty, AttributeError):
                pass
            self._thread.join(timeout=2.0)
            self._thread = None

    def __next__(self) -> Dict[str, Any]:
        self._ensure_thread()
        while True:
            try:
                cursor, payload, is_err = self._queue.get(timeout=1.0)
                break
            except queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    # worker died; one last non-blocking look in case it
                    # delivered between our timeout and the liveness check
                    try:
                        cursor, payload, is_err = self._queue.get_nowait()
                        break
                    except queue.Empty:
                        # died without delivering (interpreter teardown,
                        # thread killed): fail loudly, never hang
                        self._thread = None
                        raise DataWorkerError(
                            f"data worker died without delivering a batch "
                            f"(cursor {self.cursor})") from None
        if is_err:
            self._drain()
            raise DataWorkerError(
                f"make_batch failed at cursor {cursor} (start index "
                f"{self._index_for(cursor)}) after "
                f"{self.worker_retries + 1} attempts: {payload}") \
                from payload
        # the queue is strictly ordered, so cursor tracks consumption exactly
        self.cursor = cursor + 1
        return payload

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def close(self):
        self._drain()
