"""Training-data pipeline: deterministic sharded batching + prefetch.

Every batch is a pure function of ``(seed, step, shard)``: numpy's
``PCG64(SeedSequence([seed, step, shard]))``, the JAX package's own
draw, so the port's batches are bitwise the reference's.  A background
thread prefetches ahead of the device (``Prefetcher``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.data.tokenizer import HashTokenizer


def synthetic_lm_batches(vocab_size: int, batch: int, seq_len: int,
                         seed: int = 0, shard: int = 0,
                         n_shards: int = 1
                         ) -> Callable[[int], Dict[str, np.ndarray]]:
    """Returns step -> {tokens, labels} (int32 numpy) for this worker's
    shard."""
    if batch % n_shards != 0:
        raise ValueError(f"batch {batch} not divisible by shards {n_shards}")
    local = batch // n_shards

    def make(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(
            np.random.PCG64(np.random.SeedSequence([seed, step, shard])))
        toks = rng.integers(4, vocab_size, size=(local, seq_len + 1),
                            dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return make


class TokenBatcher:
    """Chunk/QA text -> padded token batches (for the encoder/summarizer)."""

    def __init__(self, tokenizer: HashTokenizer, max_len: int = 256):
        self.tok = tokenizer
        self.max_len = max_len

    def batch(self, texts) -> Dict[str, np.ndarray]:
        n = len(texts)
        out = np.zeros((n, self.max_len), dtype=np.int32)
        mask = np.zeros((n, self.max_len), dtype=np.bool_)
        for i, t in enumerate(texts):
            ids = self.tok.encode(t)[: self.max_len]
            out[i, : len(ids)] = ids
            mask[i, : len(ids)] = True
        return {"tokens": out, "mask": mask}


class Prefetcher:
    """Background-thread prefetch of ``make_batch(step)`` results, in
    step order, from ``start_step`` up to ``end_step`` (or without end).
    A ``make_batch`` error is raised to the consumer in place of the
    next batch; ``close()`` stops the thread."""

    def __init__(self, make_batch: Callable[[int], Dict[str, np.ndarray]],
                 start_step: int = 0, depth: int = 2,
                 end_step: Optional[int] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, args=(make_batch, start_step, end_step),
            daemon=True)
        self._thread.start()

    def _worker(self, make_batch, start, end):
        step = start
        while not self._stop.is_set() and (end is None or step < end):
            try:
                item = (step, make_batch(step))
            except BaseException as e:  # noqa: BLE001 (the consumer re-raises)
                # a make_batch failure must still reach the consumer:
                # stash it and fall through to the sentinel, else
                # __iter__ blocks forever on a dead worker
                self._error = e
                break
            try:
                self._q.put(item, timeout=0.5)
                step += 1
            except queue.Full:
                continue
        # terminal sentinel, stop-aware like the main loop: a full
        # queue after end_step must not wedge the thread past close()
        while not self._stop.is_set():
            try:
                self._q.put(None, timeout=0.5)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                return
            yield item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
