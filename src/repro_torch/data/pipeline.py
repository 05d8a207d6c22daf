"""Synthetic tokenized data pipeline: deterministic, host-sharded,
background-prefetched.

Determinism contract: batch contents are a pure function of
(seed, step, host), so a restart or an elastic rescale replays the exact
stream from the restored step — the data pipeline never needs
checkpointing beyond the step counter.  On a multi-host cluster each
process draws only its `process_index` slice of the global batch.

The port's own copy of `repro/data/pipeline.py`, line for line (numpy
only), so both packages draw the same batches bit for bit.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class TokenPipeline:
    def __init__(self, *, vocab: int, batch: int, seq_len: int,
                 seed: int = 0, host: int = 0, n_hosts: int = 1,
                 prefetch: int = 2, extras: Optional[dict] = None,
                 structured: bool = False):
        assert batch % n_hosts == 0
        self.vocab = vocab
        self.local_batch = batch // n_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host = host
        self.extras = extras or {}
        # structured=True draws from a noisy affine-recurrence language
        # (t_{i+1} = (31·t_i + 7) mod V, 10% noise) so training drivers show
        # an actually-falling loss instead of ln(V) on uniform noise.
        self.structured = structured
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread: Optional[threading.Thread] = None

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host]))
        if self.structured:
            toks = np.empty((self.local_batch, self.seq_len + 1),
                            dtype=np.int64)
            toks[:, 0] = rng.integers(0, self.vocab, self.local_batch)
            noise = rng.random((self.local_batch, self.seq_len)) < 0.1
            rand = rng.integers(0, self.vocab,
                                (self.local_batch, self.seq_len))
            for i in range(self.seq_len):
                nxt = (31 * toks[:, i] + 7) % self.vocab
                toks[:, i + 1] = np.where(noise[:, i], rand[:, i], nxt)
            toks = toks.astype(np.int32)
        else:
            toks = rng.integers(0, self.vocab,
                                (self.local_batch, self.seq_len + 1),
                                dtype=np.int32)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        for name, shape in self.extras.items():
            out[name] = rng.normal(size=(self.local_batch, *shape)).astype(
                np.float32)
        return out

    # ---- prefetching iterator ------------------------------------------------
    def start(self, from_step: int = 0) -> None:
        self._step = from_step
        self._stop.clear()

        def worker():
            s = from_step
            while not self._stop.is_set():
                b = self.batch_at(s)
                while not self._stop.is_set():
                    try:
                        self._q.put((s, b), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                s += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[tuple[int, dict[str, np.ndarray]]]:
        while True:
            yield self._q.get()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()
