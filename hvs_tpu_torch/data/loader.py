"""Host data loaders: threaded prefetch with gradient-accumulation merging,
and a camera or video stream loader.

Counterpart of ``hvs_tpu/data/loader.py`` (numpy and cv2, copied):

  * ``MHCDataLoader``: shuffling, worker threads, an ordered prefetch queue
    of stacked numpy batches (static shapes), and gradient-accumulation
    micro-batch merging. An abandoned iterator (``break``, garbage
    collection) stops its workers: each hand-off is cancellable and the
    iterator joins its threads, since a thread still inside OpenCV at
    interpreter teardown aborts the process;
  * ``StreamingDataLoader``: a cv2 capture thread with frame skipping to a
    target rate and a bounded queue that drops the oldest frame.

``ShardedDataLoader`` (one index shard per process) waits for data
parallelism (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


def default_collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack same-shape sample dicts (static shapes by construction)."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}


class MHCDataLoader:
    """Threaded prefetching loader: batches come out in index order whatever
    the number of workers (each worker takes a ticket in order)."""

    def __init__(
        self,
        dataset,
        batch_size: int = 8,
        shuffle: bool = False,
        num_workers: int = 2,
        drop_last: bool = True,
        collate_fn: Optional[Callable] = None,
        prefetch: int = 2,
        seed: int = 0,
        gradient_accumulation_steps: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        self.gradient_accumulation_steps = gradient_accumulation_steps

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        batches: List[np.ndarray] = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        batch_iter = iter(batches)
        lock = threading.Lock()
        done = threading.Event()
        order: "queue.Queue" = queue.Queue()

        def worker():
            while not done.is_set():
                with lock:
                    try:
                        batch_idx = next(batch_iter)
                    except StopIteration:
                        return
                    ticket: "queue.Queue" = queue.Queue(maxsize=1)
                    order.put(ticket)
                try:
                    samples = [self.dataset[int(i)] for i in batch_idx]
                    item: Any = self.collate_fn(samples)
                except Exception as e:  # surface errors to the consumer
                    item = e
                # Cancellable hand-off: if the consumer abandoned the iterator
                # (break / GC), done is set and nobody will ever take this
                # ticket — exit instead of blocking forever.
                while not done.is_set():
                    try:
                        ticket.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        threads = [
            threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        produced = 0
        accum: List[Dict[str, np.ndarray]] = []
        try:
            while produced < len(batches):
                ticket = order.get()
                item = ticket.get()
                produced += 1
                if isinstance(item, Exception):
                    raise item
                if self.gradient_accumulation_steps > 1:
                    # Merge micro-batches along the batch axis.
                    accum.append(item)
                    if len(accum) == self.gradient_accumulation_steps:
                        yield {
                            k: np.concatenate([a[k] for a in accum]) for k in item
                        }
                        accum = []
                else:
                    yield item
        finally:
            done.set()
            # Wait for workers to leave native code (cv2 decode/resize): a
            # thread still inside OpenCV at interpreter teardown aborts the
            # whole process ("terminate called without an active exception").
            for t in threads:
                t.join(timeout=2.0)
        self.epoch += 1


class StreamingDataLoader:
    """Camera/video stream loader: capture thread, target-FPS throttle, bounded
    oldest-drop queue, infinite iterator."""

    def __init__(
        self,
        source: Any = 0,
        target_fps: float = 30.0,
        buffer_size: int = 4,
        preprocess: Optional[Callable[[np.ndarray], Any]] = None,
    ):
        self.source = source
        self.target_fps = target_fps
        self.buffer: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self.preprocess = preprocess
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.frames_captured = 0
        self.frames_dropped = 0

    def start(self) -> "StreamingDataLoader":
        import cv2

        cap = cv2.VideoCapture(self.source)
        if not cap.isOpened():
            raise RuntimeError(f"cannot open stream source: {self.source!r}")

        def loop():
            min_interval = 1.0 / self.target_fps if self.target_fps > 0 else 0.0
            last = 0.0
            while not self._stop.is_set():
                ok, frame = cap.read()
                if not ok:
                    break
                now = time.time()
                if now - last < min_interval:
                    continue  # frame-skip to target FPS
                last = now
                self.frames_captured += 1
                item = frame if self.preprocess is None else self.preprocess(frame)
                if self.buffer.full():
                    try:
                        self.buffer.get_nowait()  # drop oldest
                        self.frames_dropped += 1
                    except queue.Empty:
                        pass
                self.buffer.put(item)
            cap.release()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def __iter__(self):
        while not self._stop.is_set():
            try:
                yield self.buffer.get(timeout=1.0)
            except queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    return

    def stats(self) -> Dict[str, float]:
        return {
            "frames_captured": self.frames_captured,
            "frames_dropped": self.frames_dropped,
            "buffer_fill": self.buffer.qsize(),
        }
