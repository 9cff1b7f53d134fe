"""Serving loop: request batching and pipelined dispatch.

Port of count_pipnet_tpu/serving/engine.py. A service receives single
images at unpredictable times and must trade latency against the device's
preference for large batches:

* **Batch-size ladder**: requests are padded up to the nearest size in
  ``batch_sizes``, so the forward sees a few fixed shapes.
* **Deadline batching**: a collector thread groups requests until the
  largest ladder size is full or ``max_wait_ms`` passed since the oldest
  pending request.
* **Pipelined dispatch**: CUDA launches are asynchronous, so the collector
  enqueues batch i+1 while batch i runs; a drain thread copies results to
  the host (``.cpu()`` of each output leaf waits for the device). At most
  ``max_inflight`` batches are outstanding.

Works with any ``infer_fn(x) -> tensor | tuple | list | dict`` of tensors
with a leading batch dimension, e.g. models.serving.make_serving_fn (the
softmax path) as it is, or with_seed_counter around make_gumbel_serving_fn.
Data-parallel serving over several devices (the JAX engine's ``mesh``):
``infer_fn`` from models.serving.shard_serving_fn and ``devices`` its
device list, so that every ladder size splits evenly across them.
"""

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ServingEngine", "autotune_batch_size"]


def _map_leaves(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_host(t):
    """Copy one output leaf to a host numpy array (waits for the device)."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class _Pending:
    __slots__ = ("img", "future", "t_submit")

    def __init__(self, img, future, t_submit):
        self.img = img
        self.future = future
        self.t_submit = t_submit


class ServingEngine:
    """Batched, pipelined inference server.

    Args:
      infer_fn: callable(batch_f32 [B, H, W, C] numpy) -> result tree whose
        leaves have leading dim B (e.g. (counts, logits)).
      input_shape: per-image shape (H, W, C).
      batch_sizes: ascending ladder of batch sizes; requests are padded to
        the smallest size >= the group.
      max_wait_ms: deadline from the OLDEST pending request before a
        partial batch is dispatched.
      max_inflight: batches allowed in flight before the collector blocks
        (2 = double buffering).
      devices: the devices of a sharded ``infer_fn``
        (models.serving.shard_serving_fn), which splits each ladder batch
        into equal shards, one a device; every ladder size must divide by
        their count.
    """

    def __init__(self, infer_fn: Callable,
                 input_shape: Tuple[int, int, int],
                 batch_sizes: Sequence[int] = (1, 8, 32, 128, 256),
                 max_wait_ms: float = 2.0,
                 max_inflight: int = 2,
                 devices: Optional[Sequence] = None):
        if not batch_sizes or list(batch_sizes) != sorted(batch_sizes):
            raise ValueError("batch_sizes must be ascending and non-empty")
        if devices is not None:
            n = len(devices)
            bad = [b for b in batch_sizes if b % n]
            if bad:
                raise ValueError(
                    f"batch_sizes {bad} not divisible by the {n}-device "
                    f"mesh: every ladder size must shard evenly")
        self.devices = devices
        self.infer_fn = infer_fn
        self.input_shape = tuple(input_shape)
        self.batch_sizes = tuple(int(b) for b in batch_sizes)
        self.max_wait_ms = float(max_wait_ms)
        self.max_inflight = int(max_inflight)

        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue()
        self._running = False
        self._collector = None
        self._drainer = None
        self._lock = threading.Lock()
        # bounded latency window: stats() sorts it on every call
        self._stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                       "latencies_ms": deque(maxlen=10000)}

    # -- public API ---------------------------------------------------------

    def start(self):
        if self._running:
            return self
        self._running = True
        self._collector = threading.Thread(target=self._collect_loop,
                                           daemon=True)
        self._drainer = threading.Thread(target=self._drain_loop,
                                         daemon=True)
        self._collector.start()
        self._drainer.start()
        return self

    def stop(self):
        if not self._running:
            return
        self._running = False
        self._queue.put(None)          # wake the collector
        self._collector.join(timeout=30)
        self._inflight.put(None)       # wake the drainer
        self._drainer.join(timeout=30)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def submit(self, img: np.ndarray) -> Future:
        """Enqueue one image; returns a Future resolving to the result tree
        sliced to this request (leading dim removed, numpy leaves)."""
        if not self._running:
            raise RuntimeError("engine is not running (start() it first, "
                               "or it was stopped)")
        img = np.asarray(img, np.float32)
        if img.shape != self.input_shape:
            raise ValueError(
                f"image shape {img.shape} != engine {self.input_shape}")
        fut: Future = Future()
        self._queue.put(_Pending(img, fut, time.perf_counter()))
        return fut

    def submit_many(self, imgs) -> list:
        return [self.submit(im) for im in imgs]

    def stats(self) -> dict:
        """Counters + latency percentiles over the last <=10k requests."""
        with self._lock:
            lat = sorted(self._stats["latencies_ms"])
            out = {
                "requests": self._stats["requests"],
                "batches": self._stats["batches"],
                "padded_slots": self._stats["padded_slots"],
            }
            if lat:
                out["latency_ms_p50"] = lat[len(lat) // 2]
                out["latency_ms_p99"] = lat[min(len(lat) - 1,
                                                int(len(lat) * 0.99))]
            return out

    # -- internals ----------------------------------------------------------

    def _ladder(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def _collect_loop(self):
        max_b = self.batch_sizes[-1]
        pending: list = []
        while True:
            timeout = None
            if pending:
                age = (time.perf_counter() - pending[0].t_submit) * 1e3
                timeout = max(0.0, (self.max_wait_ms - age)) * 1e-3
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                item = False                 # deadline hit: flush
            if item is None:
                # a submit() racing stop() may have enqueued requests
                # behind the sentinel: drain them so no future strands
                while True:
                    try:
                        extra = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if extra is not None:
                        pending.append(extra)
                break
            if item is not False:
                pending.append(item)
            full = len(pending) >= max_b
            aged = pending and (time.perf_counter() - pending[0].t_submit) \
                * 1e3 >= self.max_wait_ms
            if pending and (full or aged or not self._running):
                group, pending = pending[:max_b], pending[max_b:]
                self._dispatch(group)
        while pending:                       # final flush on stop
            group, pending = pending[:max_b], pending[max_b:]
            self._dispatch(group)

    def _dispatch(self, group):
        n = len(group)
        b = self._ladder(n)
        batch = np.zeros((b,) + self.input_shape, np.float32)
        for i, p in enumerate(group):
            batch[i] = p.img
        # backpressure: at most max_inflight batches outstanding
        while self._inflight.qsize() >= self.max_inflight:
            time.sleep(1e-4)
        try:
            result = self.infer_fn(batch)    # asynchronous on a GPU
        except Exception as e:               # launch / shape failure
            for p in group:
                p.future.set_exception(e)
            return
        with self._lock:
            self._stats["batches"] += 1
            self._stats["padded_slots"] += b - n
        self._inflight.put((group, result))

    def _drain_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                break
            group, result = item
            try:
                host = _map_leaves(_to_host, result)   # waits for the device
            except Exception as e:           # a fault surfaced at the sync
                for p in group:
                    p.future.set_exception(e)
                continue
            t_done = time.perf_counter()
            for i, p in enumerate(group):
                p.future.set_result(_map_leaves(lambda t: t[i], host))
            with self._lock:
                self._stats["requests"] += len(group)
                self._stats["latencies_ms"].extend(
                    (t_done - p.t_submit) * 1e3 for p in group)


def _sync():
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def autotune_batch_size(infer_fn: Callable,
                        input_shape: Tuple[int, int, int],
                        candidates: Sequence[int] = (32, 64, 128, 256,
                                                     512),
                        iters: int = 5) -> dict:
    """Measure steady-state throughput per candidate batch size and return
    {'best': B, 'throughput': {B: img_per_sec}}: the offline companion to
    the engine's ladder (run on the idle device)."""
    rng = np.random.default_rng(0)
    results = {}
    for b in candidates:
        x = rng.normal(size=(b,) + tuple(input_shape)).astype(np.float32)
        _map_leaves(_to_host, infer_fn(x))    # warm up
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            r = infer_fn(x)
        _map_leaves(_to_host, r)
        _sync()
        results[b] = b * iters / (time.perf_counter() - t0)
    best = max(results, key=results.get)
    return {"best": best, "throughput": results}
