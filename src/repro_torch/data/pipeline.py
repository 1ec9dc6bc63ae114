"""Host data pipeline, after ``repro.data.pipeline``: a deterministic
synthetic corpus, sequence packing, shard-aware loading, background
prefetch and straggler mitigation. numpy only, so any (seed, step, shard)
batch is byte-equal to the reference's.

  * every host loads only its data-parallel shard (``shard_id/num_shards``),
  * a background thread fills a bounded queue (prefetch depth), so input
    stalls never serialize with the step,
  * a straggler timeout on the queue get: if the loader misses the deadline
    the step re-uses the previous batch and the event is counted,
  * determinism: the corpus is a counter-based PRNG stream, so restoring
    from a checkpoint at step s replays the exact token stream from s.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    shard_id: int = 0
    num_shards: int = 1
    seed: int = 1234
    prefetch: int = 2
    straggler_timeout_s: float = 10.0
    pack_documents: bool = True
    mean_doc_len: int = 512


def synthetic_corpus(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Deterministic synthetic LM batch for (step, shard).

    Documents are Zipf-distributed token runs with EOS separators, packed
    back-to-back into fixed-length rows (standard packing); loss mask is 1
    everywhere except padding.
    """
    local_batch = cfg.global_batch // cfg.num_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.shard_id])
    )
    eos = 0
    if cfg.pack_documents:
        rows = np.empty((local_batch, cfg.seq_len + 1), np.int32)
        for b in range(local_batch):
            pos = 0
            row = np.empty(cfg.seq_len + 1, np.int32)
            while pos < cfg.seq_len + 1:
                dlen = int(rng.geometric(1.0 / cfg.mean_doc_len))
                dlen = min(dlen, cfg.seq_len + 1 - pos)
                doc = rng.zipf(1.3, size=dlen) % (cfg.vocab_size - 1) + 1
                row[pos : pos + dlen] = doc
                pos += dlen
                if pos < cfg.seq_len + 1:
                    row[pos] = eos
                    pos += 1
            rows[b] = row
    else:
        rows = (rng.zipf(1.3, size=(local_batch, cfg.seq_len + 1)) % (cfg.vocab_size - 1) + 1).astype(np.int32)
    return {
        "tokens": rows[:, :-1],
        "targets": rows[:, 1:].astype(np.int32),
        "loss_mask": np.ones((local_batch, cfg.seq_len), np.float32),
    }


class HostLoader:
    """Background prefetching loader with straggler skip-and-log."""

    def __init__(self, cfg: DataConfig, make_batch=synthetic_corpus, start_step: int = 0):
        self.cfg = cfg
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._last_batch: Optional[Dict[str, np.ndarray]] = None
        self.straggler_events = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.25)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        try:
            step, batch = self._q.get(timeout=self.cfg.straggler_timeout_s)
            self._last_batch = batch
            return batch
        except queue.Empty:
            # Straggler mitigation: never stall the step on a slow host.
            self.straggler_events += 1
            if self._last_batch is not None:
                return self._last_batch
            # First batch genuinely missing: block once.
            step, batch = self._q.get()
            self._last_batch = batch
            return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
