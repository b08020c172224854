"""Host streaming driver — the replacement for the GNU Radio
thread-per-block runtime (SURVEY §7.1 "thin host streaming driver").

A producer (file reader, socket, SDR bridge) pushes fixed-size sample
blocks into a bounded ring; the driver thread frames them with correct
overlap carry-over (reference autocorrelate history semantics), dispatches
the jit-compiled pipeline asynchronously (JAX dispatch returns before the
device finishes — consecutive blocks overlap host framing with device
compute, which is GNU Radio's pipeline parallelism without threads-per-
block), and emits results on an output queue.

Failure detection (SURVEY §5): a full ring drops whole blocks and counts
them — the analog of UHD overflow 'O' indications — exposed in
`StreamStats`; processing never stalls the producer.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Optional

import numpy as np


@dataclasses.dataclass
class StreamStats:
    blocks_in: int = 0
    blocks_dropped: int = 0
    blocks_processed: int = 0
    samples_processed: int = 0
    windows_emitted: int = 0
    # Subspace-escalation observability (DoaResult.escalation_*,
    # accumulated over emitted blocks): windows the safety net fired
    # on, and flagged windows that exceeded subspace_escalate_capacity
    # and stayed unescalated — overflow > 0 under sustained threshold-
    # SNR load means the capacity is saturating.
    windows_escalated: int = 0
    escalation_overflow: int = 0

    @property
    def drop_fraction(self) -> float:
        return self.blocks_dropped / max(self.blocks_in, 1)


class StreamingDriver:
    """Feed blocks of (block_samples, N) complex64; receive per-block
    pipeline results on `results` (a Queue of (block_index, DoaResult)).

    block_samples must be a multiple of the config hop. The driver re-serves
    the trailing `overlap` samples of each block in front of the next one,
    so the window sequence is identical to offline processing of the
    concatenated stream.
    """

    def __init__(self, pipeline, block_samples: int, *,
                 ring_capacity: int = 8, correction=None,
                 max_in_flight: int = 2):
        cfg = pipeline.config
        if block_samples % cfg.hop:
            raise ValueError("block_samples must be a multiple of hop")
        self._pipe = pipeline
        self._cfg = cfg
        self._block = block_samples
        self._corr = correction
        self._ring: queue.Queue = queue.Queue(maxsize=ring_capacity)
        self.results: queue.Queue = queue.Queue()
        self.stats = StreamStats()
        self._tail: Optional[np.ndarray] = None  # last `overlap` samples
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False
        # True double buffering: keep up to max_in_flight dispatched
        # blocks un-fenced, so host framing of block i+1 (and i+2 …)
        # overlaps device compute of block i; the oldest is completion-
        # fenced (a tiny device→host fetch) before being emitted.
        self._max_in_flight = max(1, max_in_flight)

    # -- producer side -------------------------------------------------
    def push(self, block: np.ndarray) -> bool:
        """Producer call. Non-blocking: returns False (and counts a drop)
        if the ring is full — backpressure by dropping, like an SDR."""
        self.stats.blocks_in += 1
        try:
            self._ring.put_nowait(np.asarray(block))
            return True
        except queue.Full:
            self.stats.blocks_dropped += 1
            return False

    def start(self):
        self._started = True
        self._thread.start()
        return self

    def stop(self, wait: bool = True):
        self._stop.set()
        if wait and self._started:
            self._thread.join()

    # -- consumer thread -----------------------------------------------
    def _fence_emit(self, idx, res):
        first = next(iter(res.peak_angles.values()), None)
        if first is not None:
            np.asarray(first.ravel()[:1])       # completion fence
            self.stats.windows_emitted += int(first.shape[0])
        if getattr(res, "escalation_flagged", None) is not None:
            self.stats.windows_escalated += int(res.escalation_flagged)
            self.stats.escalation_overflow += int(
                res.escalation_overflow)
        self.results.put((idx, res))

    def _run(self):
        import collections
        overlap = self._cfg.overlap
        pending = collections.deque()
        while not (self._stop.is_set() and self._ring.empty()):
            try:
                block = self._ring.get(timeout=0.05)
            except queue.Empty:
                while pending:
                    self._fence_emit(*pending.popleft())
                continue
            if self._tail is not None and overlap > 0:
                x = np.concatenate([self._tail, block], axis=0)
            else:
                x = block
            if overlap > 0:
                self._tail = block[-overlap:]
            res = self._pipe(x, self._corr)     # async dispatch
            idx = self.stats.blocks_processed
            self.stats.blocks_processed += 1
            self.stats.samples_processed += block.shape[0]
            pending.append((idx, res))
            while len(pending) >= self._max_in_flight:
                self._fence_emit(*pending.popleft())
        while pending:
            self._fence_emit(*pending.popleft())

    # -- convenience ----------------------------------------------------
    def run_iter(self, blocks: Iterable[np.ndarray]):
        """Synchronous helper: process an iterable of blocks, yielding
        (index, result) in order. Bypasses the ring (no drops)."""
        overlap = self._cfg.overlap
        for i, block in enumerate(blocks):
            if self._tail is not None and overlap > 0:
                x = np.concatenate([self._tail, block], axis=0)
            else:
                x = block
            if overlap > 0:
                self._tail = np.asarray(block)[-overlap:]
            self.stats.blocks_in += 1
            self.stats.blocks_processed += 1
            self.stats.samples_processed += np.asarray(block).shape[0]
            yield i, self._pipe(x, self._corr)


def iterate_file_blocks(path: str, block_samples: int, num_channels=None):
    """Yield (block_samples, N) blocks from a recorded IQ file."""
    from doa_tpu.io.recorded import load_iq

    x = load_iq(path, num_channels)
    T = (x.shape[0] // block_samples) * block_samples
    for i in range(0, T, block_samples):
        yield x[i : i + block_samples]
