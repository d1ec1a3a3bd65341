"""Batching transcription server: many sessions, one batched engine call
(port of spittle_tpu/parallel/serving.py, on one card).

Concurrent push-to-talk sessions submit audio to a queue; a dispatcher
coalesces requests into length-bucketed batches padded to a small ladder of
batch sizes, runs one batched engine call and resolves per-request futures.
Optionally a stager thread assembles and copies group k+1 while a runner
thread computes group k (the engine's stage_batch/transcribe_staged seam),
and an SLA policy degrades to bucket-fitted encoder contexts, then sheds.

Under a device mesh (parallel/mesh.py) the engine splits each window batch
over the mesh's data dim. The reference runs one controller over many
devices; torch runs one process per card, and every rank must make the
same engine calls in the same order. So the server (the front) runs on
rank 0 and broadcasts each engine call, batch and params, to the other
ranks, each of which runs follow(): the SPMD counterpart of the single
controller, not a feature of its own.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from spittle_tpu_torch.engine.base import TranscribeParams, TranscriptionResult
from spittle_tpu_torch.utils.logging import get_logger
from spittle_tpu_torch.utils.threads import spawn
from spittle_tpu_torch.utils.tracing import span

# Audio-length buckets (seconds): requests pad up to the bucket edge so the
# engine sees a small, fixed set of shapes.
DEFAULT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 30.0)
SAMPLE_RATE = 16_000

_log = get_logger("serving")


class ServerOverloaded(RuntimeError):
    """Request rejected by admission control: the queue's estimated wait
    exceeds the configured shed deadline (sla_ms * shed_factor). Callers
    should surface this as retryable backpressure (the HTTP front maps it
    to 503): under sustained overload, failing fast beats queueing toward
    multi-second tails."""


@dataclasses.dataclass
class _Request:
    samples: np.ndarray
    params: TranscribeParams
    future: Future
    enqueued_at: float


def bucket_for(n_samples: int, buckets: Sequence[float] = DEFAULT_BUCKETS) -> int:
    """Samples -> bucket length in samples (last bucket for longer audio)."""
    for b in buckets:
        if n_samples <= int(b * SAMPLE_RATE):
            return int(b * SAMPLE_RATE)
    return int(buckets[-1] * SAMPLE_RATE)


class BatchingTranscriptionServer:
    """Coalesces transcribe requests into batched engine calls.

    engine: any engine with transcribe_batch (and, for overlap_transfers,
    stage_batch/transcribe_staged).
    max_batch: cap per engine call (the serving configuration targets 32).
    max_wait_ms: dispatch latency budget: a lone request never waits
    longer than this before running.
    mesh: optional DeviceMesh covering every rank of the process group;
    batched calls split their windows over its first (data) dim. Run the
    server on rank 0 and follow() on every other rank.
    """

    def __init__(
        self,
        engine,
        max_batch: int = 32,
        max_wait_ms: float = 10.0,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        mesh=None,
        fit_audio_ctx: bool = False,
        overlap_transfers: bool = False,
        prefetch: int = 1,
        sla_ms: Optional[float] = None,
        shed_factor: float = 4.0,
    ):
        self.engine = engine
        # Overload policy (opt-in via sla_ms): DEGRADE when the estimated
        # queue wait exceeds sla_ms (new groups run at the bucket-fitted
        # reduced encoder context, fit_audio_ctx's, so service time drops
        # and the queue drains); SHED when it exceeds sla_ms * shed_factor
        # (submit raises ServerOverloaded). The estimate is (groups ahead
        # + busy groups) x an EWMA of the measured per-group service time.
        self.sla_ms = sla_ms
        self.shed_factor = shed_factor
        self.shed_count = 0
        self.degraded_groups = 0
        self._busy_groups = 0
        self._busy_lock = threading.Lock()
        self._service_s: dict = {}  # bucket_len -> EWMA seconds
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.buckets = tuple(buckets)
        self.mesh = mesh
        if mesh is not None:
            # Every batch size must divide the data dim, or the engine
            # replicates the batch on the full-load batches the mesh exists
            # for: the cap is rounded up to a multiple (filler rows are
            # silence), and the engine splits its windows over the dim.
            m = mesh.size(0)
            if self.max_batch % m:
                self.max_batch = ((self.max_batch + m - 1) // m) * m
            engine.mesh = mesh
            self.engine = _Broadcasting(engine)
        # Opt-in: run each bucket at a reduced encoder context that just
        # covers it (whisper.cpp's audio_ctx); requests that set their own
        # params.audio_ctx are left untouched.
        self.fit_audio_ctx = fit_audio_ctx
        # Opt-in cross-group pipeline: a stager thread runs the window
        # assembly and host->device copy of group k+1 while group k
        # computes. Groups whose params need the sequential path flow
        # through un-staged.
        self.overlap_transfers = overlap_transfers and hasattr(
            engine, "stage_batch"
        )
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._shutdown = threading.Event()
        self.batch_sizes: List[int] = []  # observability
        self._threads: List[threading.Thread] = []
        if self.overlap_transfers:
            # At most TWO groups in flight: one computing, one staging.
            # Deeper pipelines remove the backpressure that lets requests
            # accumulate into batches while a group computes; _in_flight
            # gates _collect so the accumulation window extends to the
            # previous group's completion, as on the sequential path, while
            # group k+1's assembly and copy still overlap group k's compute.
            self._stage_q: "queue.Queue" = queue.Queue(maxsize=1)
            self._run_q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
            self._in_flight = 0
            self._in_flight_lock = threading.Lock()
            self._threads.append(spawn(self._stage_loop, name="serving-stager"))
            self._threads.append(spawn(self._run_loop, name="serving-runner"))
        self._thread = spawn(self._dispatch_loop, name="serving-dispatch")
        self._threads.append(self._thread)

    # -- client API ------------------------------------------------------

    def submit(
        self, samples: np.ndarray, params: Optional[TranscribeParams] = None
    ) -> Future:
        if self.sla_ms is not None:
            wait_ms = self._estimated_wait_s() * 1000.0
            if wait_ms > self.sla_ms * self.shed_factor:
                with self._busy_lock:  # submit runs on many client threads
                    self.shed_count += 1
                raise ServerOverloaded(
                    f"estimated queue wait {wait_ms:.0f} ms exceeds shed "
                    f"deadline {self.sla_ms * self.shed_factor:.0f} ms "
                    f"(sla {self.sla_ms:.0f} ms x {self.shed_factor})"
                )
        fut: Future = Future()
        samples = np.asarray(samples)
        if samples.dtype != np.int16:
            # int16 is the wire format (engines normalize on the device);
            # everything else must arrive as float32 in [-1, 1].
            samples = samples.astype(np.float32, copy=False)
        self._queue.put(
            _Request(
                samples=samples,
                params=params or TranscribeParams(),
                future=fut,
                enqueued_at=time.monotonic(),
            )
        )
        return fut

    def transcribe(
        self, samples: np.ndarray, params: Optional[TranscribeParams] = None,
        timeout: float = 300.0,
    ) -> TranscriptionResult:
        """Synchronous client call."""
        return self.submit(samples, params).result(timeout=timeout)

    def warmup(
        self,
        params: Optional[TranscribeParams] = None,
        bucket_s: Optional[float] = None,
        dtypes=(np.int16, np.float32),
    ) -> None:
        """Run every (bucket, ladder size, PCM dtype) shape once so no live
        request pays a first call's costs (allocator growth, cuDNN and
        cuBLAS plans). Warm with the params production traffic will send.
        Under sla_ms the bucket-fitted DEGRADE shapes are warmed too. Narrow
        with bucket_s / dtypes if boot time matters more than the first
        request's latency."""
        if bucket_s is not None:
            bucket_list = [bucket_s]
        else:
            bucket_list = list(self.buckets)
        sizes = self._ladder_sizes()
        for b in bucket_list:
            bucket_len = int(b * SAMPLE_RATE)
            base = params or TranscribeParams()
            variants = [self._fitted_params(bucket_len, base)]
            if self.sla_ms is not None and not self.fit_audio_ctx:
                fitted = self._bucket_ctx_params(bucket_len, base)
                if fitted not in variants:
                    variants.append(fitted)
            for run_params in variants:
                for dtype in dtypes:
                    silence = np.zeros(bucket_len, dtype)
                    for n in sizes:
                        self.engine.transcribe_batch([silence] * n, run_params)

    def shutdown(self) -> None:
        self._shutdown.set()
        self._queue.put(None)
        self._thread.join(timeout=5)
        if self.overlap_transfers:
            self._stage_q.put(None)  # stager forwards the sentinel
            for t in self._threads:
                if t is not self._thread:
                    t.join(timeout=5)
        if self.mesh is not None:
            self.engine.release()

    # -- dispatcher ------------------------------------------------------

    def _collect(self) -> List[_Request]:
        """Block for one request, then drain for up to max_wait."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-signal shutdown
                break
            batch.append(nxt)
        return batch

    def _group_by_bucket(
        self, batch: List[_Request]
    ) -> List[Tuple[Optional[int], List[_Request]]]:
        groups = {}
        max_bucket = int(self.buckets[-1] * SAMPLE_RATE)
        for req in batch:
            if len(req.samples) > max_bucket:
                # Over-bucket audio is not truncated to the last bucket: it
                # goes through an unpadded long-form engine call.
                key = (None, req.params)
            else:
                key = (
                    bucket_for(len(req.samples), self.buckets),
                    req.params,
                )
            groups.setdefault(key, []).append(req)
        return [(k[0], reqs) for k, reqs in groups.items()]

    def _dispatch_loop(self) -> None:
        while not self._shutdown.is_set():
            batch = []
            try:
                if self.overlap_transfers:
                    # Wait for pipeline room BEFORE collecting, so arrivals
                    # pool into the next batch instead of being collected
                    # into tiny groups that queue behind the pipeline.
                    while not self._shutdown.is_set():
                        with self._in_flight_lock:
                            if self._in_flight < 2:
                                break
                        time.sleep(0.001)
                batch = self._collect()
                if not batch:
                    continue
                groups = self._group_by_bucket(batch)
                # Shortest-bucket-first: a 1 s utterance grouped with a
                # long-form request must not wait behind it.
                groups.sort(key=lambda g: g[0] if g[0] is not None else 1 << 60)
                for bucket_len, reqs in groups:
                    with self._busy_lock:
                        self._busy_groups += 1
                    if self.overlap_transfers:
                        with self._in_flight_lock:
                            self._in_flight += 1
                        self._stage_q.put((bucket_len, reqs))
                    else:
                        self._run_group(bucket_len, reqs)
            except Exception as e:
                # Exception barrier: _run_group fails its own group's
                # futures; anything escaping here (collect, grouping) fails
                # the batch and keeps the dispatcher alive.
                _log.exception("serving dispatch iteration failed")
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    # -- overload policy --------------------------------------------------

    def _estimated_wait_s(self, exclude_self: bool = False) -> float:
        """Queue-wait estimate for an arriving request: groups already
        computing or staged plus the groups the current backlog will form,
        each at the EWMA service time (0.5 s prior until measured).
        exclude_self: the dispatch path asks on behalf of a group that is
        already counted busy; its own service time is not wait."""
        svc = max(self._service_s.values(), default=0.5)
        backlog_groups = -(-self._queue.qsize() // self.max_batch)
        with self._busy_lock:
            busy = self._busy_groups
        ahead = backlog_groups + busy - (1 if exclude_self else 0)
        return max(ahead, 0) * svc

    def _degrade_active(self) -> bool:
        return (
            self.sla_ms is not None
            and self._estimated_wait_s(exclude_self=True) * 1000.0
            > self.sla_ms
        )

    def _note_service(self, bucket_len, seconds: float) -> None:
        prev = self._service_s.get(bucket_len)
        self._service_s[bucket_len] = (
            seconds if prev is None else 0.5 * prev + 0.5 * seconds
        )

    @staticmethod
    def _bucket_ctx_params(
        bucket_len: int, params: TranscribeParams
    ) -> TranscribeParams:
        if params.audio_ctx:
            return params  # caller's explicit choice wins
        ctx = -(-bucket_len // 320)  # encoder positions covering bucket
        ctx = -(-ctx // 64) * 64  # tile-friendly multiple
        return dataclasses.replace(params, audio_ctx=ctx)

    def _fitted_params(
        self, bucket_len: Optional[int], params: TranscribeParams
    ) -> TranscribeParams:
        """Bucket-matched reduced audio context: always in fit_audio_ctx
        mode, and under an sla_ms overload as the DEGRADE arm."""
        degrade = self._degrade_active()
        if not ((self.fit_audio_ctx or degrade) and bucket_len):
            return params
        fitted = self._bucket_ctx_params(bucket_len, params)
        if degrade and not self.fit_audio_ctx and fitted is not params:
            self.degraded_groups += 1
        return fitted

    def _ladder_size(self, n: int) -> int:
        """Next power-of-two batch size (capped at max_batch): a static
        ladder keeps the set of batch shapes the engine sees tiny (and
        warmup() runs each)."""
        for size in self._ladder_sizes():
            if size >= n:
                return size
        return self.max_batch

    def _ladder_sizes(self) -> List[int]:
        """The full static shape ladder: warmup() runs exactly these. It
        starts at the mesh's data-dim size under a mesh (every rung
        splits evenly; __init__ rounded max_batch up)."""
        sizes = [self.mesh.size(0) if self.mesh is not None else 1]
        while sizes[-1] * 2 < self.max_batch:
            sizes.append(sizes[-1] * 2)
        if sizes[-1] != self.max_batch:
            sizes.append(self.max_batch)
        return sizes

    def _pad_group(
        self, bucket_len: Optional[int], reqs: List[_Request]
    ) -> List[np.ndarray]:
        if bucket_len is None:
            # Long-form group: ragged, unpadded; the engine's windowed
            # seek loop covers the full audio.
            return [r.samples for r in reqs]
        padded = [
            np.pad(
                r.samples[:bucket_len],
                (0, max(0, bucket_len - len(r.samples))),
            )
            for r in reqs
        ]
        target = self._ladder_size(len(padded))
        filler = target - len(padded)
        if filler > 0:
            silence = np.zeros(bucket_len, padded[0].dtype)
            padded.extend(silence for _ in range(filler))
        return padded

    def _stage_loop(self) -> None:
        """Assembly and host->device copy of the NEXT group while the
        runner computes the current one."""
        while True:
            item = self._stage_q.get()
            if item is None:
                self._run_q.put(None)
                return
            bucket_len, reqs = item
            try:
                padded = self._pad_group(bucket_len, reqs)
                run_params = self._fitted_params(bucket_len, reqs[0].params)
                staged = None
                if bucket_len is not None:
                    staged = self.engine.stage_batch(padded, run_params)
            except Exception as e:
                _log.exception("serving stage failed")
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)
                with self._in_flight_lock:
                    self._in_flight -= 1
                with self._busy_lock:
                    self._busy_groups -= 1
                continue
            self._run_q.put((bucket_len, reqs, padded, run_params, staged))

    def _run_loop(self) -> None:
        while True:
            item = self._run_q.get()
            if item is None:
                return
            try:
                self._run_staged_item(item)
            finally:
                with self._in_flight_lock:
                    self._in_flight -= 1
                with self._busy_lock:
                    self._busy_groups -= 1

    def _run_staged_item(self, item) -> None:
        bucket_len, reqs, padded, run_params, staged = item
        self.batch_sizes.append(len(reqs))
        queue_ms = max(
            (time.monotonic() - r.enqueued_at) * 1000 for r in reqs
        )
        t_run = time.monotonic()
        try:
            with span("serving.batch", size=len(reqs),
                      bucket=bucket_len, queue_ms=round(queue_ms, 1)):
                if staged is not None:
                    results = self.engine.transcribe_staged(staged)
                else:
                    results = self.engine.transcribe_batch(padded, run_params)
        except Exception as e:
            _log.exception("serving staged run failed")
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        self._note_service(bucket_len, time.monotonic() - t_run)
        for r, res in zip(reqs, results):
            r.future.set_result(res)

    def _run_group(
        self, bucket_len: Optional[int], reqs: List[_Request]
    ) -> None:
        padded = self._pad_group(bucket_len, reqs)
        self.batch_sizes.append(len(reqs))
        queue_ms = max(
            (time.monotonic() - r.enqueued_at) * 1000 for r in reqs
        )
        run_params = self._fitted_params(bucket_len, reqs[0].params)
        t_run = time.monotonic()
        try:
            with span("serving.batch", size=len(reqs),
                      bucket=bucket_len, queue_ms=round(queue_ms, 1)):
                results = self.engine.transcribe_batch(padded, run_params)
        except Exception as e:
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        finally:
            with self._busy_lock:
                self._busy_groups -= 1
        self._note_service(bucket_len, time.monotonic() - t_run)
        for r, res in zip(reqs, results):
            r.future.set_result(res)


class _Broadcasting:
    """Rank 0's engine behind a server under a mesh: each compute call is
    broadcast (kind, batch, params) to the ranks running follow() before
    rank 0 makes it. stage_batch makes no collective call, so the
    broadcast waits for transcribe_staged (one thread, the runner or the
    dispatcher, makes every compute call)."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def transcribe_batch(self, batch, params=None):
        dist.broadcast_object_list([("batch", list(batch), params)], src=0)
        return self._engine.transcribe_batch(batch, params)

    def stage_batch(self, batch, params=None):
        handle = self._engine.stage_batch(batch, params)
        return None if handle is None else (handle, list(batch), params)

    def transcribe_staged(self, staged):
        handle, batch, params = staged
        dist.broadcast_object_list([("staged", batch, params)], src=0)
        return self._engine.transcribe_staged(handle)

    def release(self) -> None:
        """Ends the other ranks' follow() loops (there are none without a
        process group)."""
        if dist.is_initialized():
            dist.broadcast_object_list([None], src=0)


def follow(engine, mesh) -> None:
    """The loop of every rank but 0 beside rank 0's
    BatchingTranscriptionServer(mesh=mesh): it makes the engine calls that
    rank 0 broadcasts, with the same batches and params, until rank 0's
    server shuts down. The results are rank 0's to return."""
    engine.mesh = mesh
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            return
        kind, batch, params = msg[0]
        if kind == "staged":
            engine.transcribe_staged(engine.stage_batch(batch, params))
        else:
            engine.transcribe_batch(batch, params)
