"""spittle_tpu_torch's batching server and HTTP front on the CPU: the JAX
package's serving cases that need no mesh, held with recording engines, and
the same concurrent requests through the JAX server over the JAX engine and
the port's server over the port's engine on the trained tiny checkpoint.

Every wait is bounded (Future.result / Thread.join timeouts) and every
server is shut down in `finally`, so a hang fails one test."""

import http.client
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.parallel import http_server as jhttp
from spittle_tpu.parallel.serving import BatchingTranscriptionServer as JServer
from spittle_tpu_torch.audio.mulaw import mulaw_encode
from spittle_tpu_torch.audio.wav import save_wav_file
from spittle_tpu_torch.engine.base import TranscribeParams, TranscriptionResult
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.parallel.http_server import (
    TranscriptionHTTPServer,
    _parse_audio,
)
from spittle_tpu_torch.parallel.serving import (
    DEFAULT_BUCKETS,
    BatchingTranscriptionServer,
    ServerOverloaded,
    bucket_for,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "trained_tiny")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402

WAIT = 30  # seconds any one future or join may take


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Many small torch ops per test; beside the suite's other workers,
    intra-op threads only oversubscribe the cores. One thread for this
    module, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class RecordingEngine:
    """Records batch shapes and answers with lengths."""

    device = "cpu"

    def __init__(self, delay=0.0):
        self.batches = []
        self.delay = delay

    def transcribe_batch(self, batch, params=None):
        self.batches.append([len(b) for b in batch])
        if self.delay:
            time.sleep(self.delay)
        return [TranscriptionResult(text=f"len={len(b)}") for b in batch]


class StagingRecordingEngine(RecordingEngine):
    """The stage_batch/transcribe_staged seam; records which path each
    group took."""

    def __init__(self, delay=0.0):
        super().__init__(delay)
        self.staged_runs = []
        self.direct_runs = []

    def stage_batch(self, batch, params=None):
        if params is not None and not params.parallel_windows:
            return None
        return ("staged", [np.asarray(b) for b in batch], params)

    def transcribe_staged(self, handle):
        _tag, batch, params = handle
        self.staged_runs.append(len(batch))
        if self.delay:
            time.sleep(self.delay)
        return [TranscriptionResult(text=f"len={len(b)}") for b in batch]

    def transcribe_batch(self, batch, params=None):
        self.direct_runs.append(len(batch))
        return super().transcribe_batch(batch, params)


class ParamsDelayEngine:
    """Records the params of every batch; fixed per-call delay."""

    device = "cpu"

    def __init__(self, delay=0.0):
        self.calls = []
        self.delay = delay

    def transcribe_batch(self, batch, params=None):
        self.calls.append((len(batch), params))
        if self.delay:
            time.sleep(self.delay)
        return [TranscriptionResult(text="x") for _ in batch]


def _pw(cls=TranscribeParams, **kw):
    return cls(parallel_windows=True, condition_on_previous_text=False, **kw)


def test_bucket_for():
    assert bucket_for(100) == 16000
    assert bucket_for(16000) == 16000
    assert bucket_for(16001) == 32000
    assert bucket_for(16000 * 100) == 16000 * 30


def test_single_request_roundtrip():
    srv = BatchingTranscriptionServer(RecordingEngine(), max_wait_ms=5)
    try:
        res = srv.transcribe(np.ones(8000, np.float32), timeout=WAIT)
        assert res.text == "len=16000"  # padded to the 1 s bucket
    finally:
        srv.shutdown()


def test_concurrent_requests_coalesce():
    srv = BatchingTranscriptionServer(RecordingEngine(delay=0.05), max_wait_ms=50)
    try:
        futs = [srv.submit(np.ones(8000, np.float32)) for _ in range(8)]
        results = [f.result(timeout=WAIT) for f in futs]
        assert all(r.text == "len=16000" for r in results)
        assert max(srv.batch_sizes) >= 2
    finally:
        srv.shutdown()


def test_buckets_and_params_not_mixed():
    eng = RecordingEngine(delay=0.02)
    srv = BatchingTranscriptionServer(eng, max_wait_ms=60)
    try:
        futs = [srv.submit(np.ones(8000, np.float32)),
                srv.submit(np.ones(60000, np.float32)),  # 5 s bucket
                srv.submit(np.ones(8000, np.float32)),
                srv.submit(np.ones(8000, np.float32), TranscribeParams(language="de"))]
        [f.result(timeout=WAIT) for f in futs]
        for shapes in eng.batches:  # every engine batch is length-homogeneous
            assert len(set(shapes)) == 1
        # two buckets and two params: three groups at least
        assert len(eng.batches) >= 3 and sum(srv.batch_sizes) == 4
    finally:
        srv.shutdown()


def test_engine_error_propagates():
    class Boom:
        def transcribe_batch(self, batch, params=None):
            raise ValueError("engine down")

    srv = BatchingTranscriptionServer(Boom(), max_wait_ms=5)
    try:
        with pytest.raises(ValueError, match="engine down"):
            srv.transcribe(np.ones(100, np.float32), timeout=5)
        # the dispatcher survives
        with pytest.raises(ValueError):
            srv.transcribe(np.ones(100, np.float32), timeout=5)
    finally:
        srv.shutdown()


def test_max_batch_respected():
    srv = BatchingTranscriptionServer(RecordingEngine(delay=0.05), max_batch=4,
                                      max_wait_ms=200)
    try:
        futs = [srv.submit(np.ones(100, np.float32)) for _ in range(10)]
        [f.result(timeout=WAIT) for f in futs]
        assert max(srv.batch_sizes) <= 4
    finally:
        srv.shutdown()


def test_over_bucket_audio_not_truncated_and_short_first():
    eng = RecordingEngine(delay=0.01)
    srv = BatchingTranscriptionServer(eng, max_wait_ms=80)
    try:
        n = 16000 * 45  # 45 s > the 30 s bucket
        f_long = srv.submit(np.ones(n, np.float32))
        f_short = srv.submit(np.ones(8000, np.float32))
        assert f_long.result(timeout=WAIT).text == f"len={n}"
        f_short.result(timeout=WAIT)
        # shortest bucket first: the padded 1 s group, then the long item
        assert eng.batches[:2] == [[16000], [n]]
    finally:
        srv.shutdown()


def test_i16_requests_preserved_not_cast_unscaled():
    class DtypeEngine:
        def transcribe_batch(self, batch, params=None):
            return [TranscriptionResult(text=str(b.dtype)) for b in batch]

    srv = BatchingTranscriptionServer(DtypeEngine(), max_wait_ms=5)
    try:
        assert srv.transcribe(np.ones(8000, np.int16), timeout=WAIT).text == "int16"
        assert srv.transcribe(np.ones(8000, np.float64),
                              timeout=WAIT).text == "float32"
    finally:
        srv.shutdown()


def test_batch_size_ladder_padding():
    eng = RecordingEngine(delay=0.05)
    srv = BatchingTranscriptionServer(eng, max_batch=32, max_wait_ms=80)
    try:
        futs = [srv.submit(np.ones(8000, np.float32)) for _ in range(3)]
        [f.result(timeout=WAIT) for f in futs]
        assert {len(b) for b in eng.batches} <= {1, 2, 4, 8}
        assert sum(srv.batch_sizes) == 3  # real request counts, not padded
        assert srv._ladder_sizes() == [1, 2, 4, 8, 16, 32]
        assert [srv._ladder_size(n) for n in (1, 3, 5, 17, 32)] == [1, 4, 8, 32, 32]
    finally:
        srv.shutdown()
    srv = BatchingTranscriptionServer(RecordingEngine(), max_batch=24)
    try:
        assert srv._ladder_sizes() == [1, 2, 4, 8, 16, 24]
        padded = srv._pad_group(16000, [
            type("R", (), {"samples": np.ones(9000, np.int16)})()] * 3)
        assert len(padded) == 4 and all(p.dtype == np.int16 for p in padded)
        assert all(len(p) == 16000 for p in padded) and padded[3].sum() == 0
    finally:
        srv.shutdown()


def test_warmup_runs_the_ladder():
    eng = RecordingEngine()
    srv = BatchingTranscriptionServer(eng, max_batch=32, max_wait_ms=5)
    try:
        srv.warmup(dtypes=(np.float32,))
        assert [len(b) for b in eng.batches] == [1, 2, 4, 8, 16, 32] * len(
            DEFAULT_BUCKETS)
        assert {b[0] for b in eng.batches} == {int(s * 16000) for s in DEFAULT_BUCKETS}
    finally:
        srv.shutdown()


def test_warmup_respects_bucket_and_dtype_narrowing():
    calls = []

    class DtypeRecordingEngine:
        def transcribe_batch(self, batch, params=None):
            calls.append((len(batch), len(batch[0]), batch[0].dtype))
            return [TranscriptionResult(text="") for _ in batch]

    srv = BatchingTranscriptionServer(DtypeRecordingEngine(), max_batch=4,
                                      max_wait_ms=5)
    try:
        srv.warmup(bucket_s=5.0)
        assert {c[1] for c in calls} == {16000 * 5}
        assert {str(c[2]) for c in calls} == {"int16", "float32"}
        assert [c[0] for c in calls] == [1, 2, 4] * 2
    finally:
        srv.shutdown()


@pytest.mark.parametrize("fit", [True, False])
def test_fit_audio_ctx(fit):
    """fit_audio_ctx runs each bucket at the reduced encoder context that
    covers it; an explicit request audio_ctx wins; off by default."""
    eng = ParamsDelayEngine()
    srv = BatchingTranscriptionServer(eng, max_wait_ms=5, fit_audio_ctx=fit)
    try:
        srv.transcribe(np.ones(16000 * 4, np.float32), timeout=WAIT)  # 5 s
        srv.transcribe(np.ones(16000 * 25, np.float32), timeout=WAIT)  # 30 s
        srv.transcribe(np.ones(16000 * 4, np.float32),
                       TranscribeParams(audio_ctx=100), timeout=WAIT)
        seen = [p.audio_ctx for _, p in eng.calls]
        assert seen == ([256, 1536, 100] if fit else [None, None, 100])
    finally:
        srv.shutdown()


class _DataMesh:
    """A DeviceMesh's surface the server reads: its first (data) dim."""

    mesh_dim_names = ("data",)

    def __init__(self, n):
        self.n = n

    def size(self, dim=None):
        return self.n


def test_mesh_raises():
    """A mesh no longer raises: the server takes the reference's two rules
    (max_batch rounded up to the data dim, the ladder starting at it) and
    hands the engine the mesh. Serving under a real gloo mesh is held in
    tests/test_torch_mesh.py."""
    eng = RecordingEngine()
    eng.mesh = None
    srv = BatchingTranscriptionServer(eng, max_batch=6, mesh=_DataMesh(4))
    try:
        assert srv.max_batch == 8
        assert srv._ladder_sizes() == [4, 8]
        assert srv._ladder_size(1) == 4
        assert eng.mesh is srv.mesh
    finally:
        srv.shutdown()
    with pytest.raises(AttributeError):
        BatchingTranscriptionServer(RecordingEngine(), mesh=object())


# -- the stager/runner pipeline -------------------------------------------


def test_overlap_pipeline_roundtrip():
    eng = StagingRecordingEngine()
    srv = BatchingTranscriptionServer(eng, max_batch=4, max_wait_ms=5.0,
                                      overlap_transfers=True)
    try:
        futs = [srv.submit(np.zeros(16000, np.float32), _pw()) for _ in range(6)]
        assert all(f.result(timeout=WAIT).text == "len=16000" for f in futs)
        assert sum(eng.staged_runs) >= 6 and eng.direct_runs == []
        names = {t.name for t in srv._threads}
        assert names == {"serving-stager", "serving-runner", "serving-dispatch"}
    finally:
        srv.shutdown()
    assert not any(t.is_alive() for t in srv._threads)


def test_overlap_unstageable_params_fall_back_to_direct():
    eng = StagingRecordingEngine()
    srv = BatchingTranscriptionServer(eng, max_batch=4, max_wait_ms=5.0,
                                      overlap_transfers=True)
    try:
        fut = srv.submit(np.zeros(16000, np.float32),
                         TranscribeParams(parallel_windows=False))
        assert fut.result(timeout=WAIT).text.startswith("len=")
        assert eng.direct_runs and not eng.staged_runs
    finally:
        srv.shutdown()


@pytest.mark.parametrize("where", ["run", "stage"])
def test_overlap_error_fails_futures_and_recovers(where):
    class FlakyEngine(StagingRecordingEngine):
        calls = 0

        def stage_batch(self, batch, params=None):
            if where == "stage":
                self.calls += 1
                if self.calls == 1:
                    raise RuntimeError("copy failed")
            return super().stage_batch(batch, params)

        def transcribe_staged(self, handle):
            if where == "run":
                self.calls += 1
                if self.calls == 1:
                    raise RuntimeError("device fell over")
            return super().transcribe_staged(handle)

    srv = BatchingTranscriptionServer(FlakyEngine(), max_batch=4, max_wait_ms=5.0,
                                      overlap_transfers=True)
    try:
        f1 = srv.submit(np.zeros(16000, np.float32), _pw())
        with pytest.raises(RuntimeError):
            f1.result(timeout=WAIT)
        f2 = srv.submit(np.zeros(16000, np.float32), _pw())
        assert f2.result(timeout=WAIT).text.startswith("len=")
    finally:
        srv.shutdown()


def test_overlap_actually_overlaps_under_load():
    """N groups of (stage 60 ms + run 60 ms) finish well under N * 120 ms."""
    stage_s = run_s = 0.06

    class SlowStager(StagingRecordingEngine):
        def stage_batch(self, batch, params=None):
            time.sleep(stage_s)
            return super().stage_batch(batch, params)

    srv = BatchingTranscriptionServer(SlowStager(delay=run_s), max_batch=1,
                                      max_wait_ms=1.0, overlap_transfers=True)
    try:
        n = 8
        t0 = time.monotonic()
        futs = [srv.submit(np.zeros(16000, np.float32), _pw()) for _ in range(n)]
        for f in futs:
            f.result(timeout=WAIT)
        elapsed = time.monotonic() - t0
        assert elapsed < n * (stage_s + run_s) * 0.85, elapsed
    finally:
        srv.shutdown()


def test_full_f32_holds_across_threads():
    """ops.full_f32 is held by several threads at once (the HTTP front's
    resamples beside the engine): inside, TF32 is off for every holder;
    after the last leaves, the settings are restored."""
    import sys

    from spittle_tpu_torch.ops import full_f32

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    seen = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(300):
                with full_f32():
                    seen.append((torch.backends.cuda.matmul.allow_tf32,
                                 torch.backends.cudnn.allow_tf32))

        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        assert len(seen) == 16 * 300 and set(seen) == {(False, False)}
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        sys.setswitchinterval(interval)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# -- admission control (sla_ms) --------------------------------------------


def test_sla_degrade_applies_fitted_context():
    eng = ParamsDelayEngine(delay=0.15)
    srv = BatchingTranscriptionServer(eng, max_batch=2, max_wait_ms=5.0,
                                      sla_ms=50.0, shed_factor=1e9)
    try:
        audio = np.zeros(16000, np.float32)
        srv.submit(audio).result(timeout=WAIT)  # idle: not degraded
        assert srv.degraded_groups == 0 and eng.calls[0][1].audio_ctx is None
        futs = [srv.submit(audio) for _ in range(10)]
        for f in futs:
            f.result(timeout=WAIT)
    finally:
        srv.shutdown()
    assert srv.degraded_groups > 0
    assert 64 in [p.audio_ctx for _, p in eng.calls if p and p.audio_ctx]


def test_sla_shed_raises_server_overloaded():
    srv = BatchingTranscriptionServer(ParamsDelayEngine(delay=0.3), max_batch=1,
                                      max_wait_ms=1.0, sla_ms=20.0, shed_factor=2.0)
    try:
        futs, shed = [], 0
        for _ in range(30):
            try:
                futs.append(srv.submit(np.zeros(16000, np.float32)))
            except ServerOverloaded:
                shed += 1
        assert shed > 0 and srv.shed_count == shed
        for f in futs:
            f.result(timeout=60)  # accepted requests still complete
    finally:
        srv.shutdown()


def test_no_sla_means_no_policy():
    eng = ParamsDelayEngine(delay=0.05)
    srv = BatchingTranscriptionServer(eng, max_batch=2, max_wait_ms=5.0)
    try:
        futs = [srv.submit(np.zeros(16000, np.float32)) for _ in range(12)]
        for f in futs:
            f.result(timeout=WAIT)
    finally:
        srv.shutdown()
    assert srv.shed_count == 0 and srv.degraded_groups == 0
    assert all(p is None or p.audio_ctx is None for _, p in eng.calls)


def test_sla_warmup_runs_degraded_shapes():
    eng = ParamsDelayEngine()
    srv = BatchingTranscriptionServer(eng, max_batch=2, max_wait_ms=5.0, sla_ms=100.0)
    try:
        srv.warmup(bucket_s=1.0, dtypes=(np.float32,))
    finally:
        srv.shutdown()
    ctxs = {p.audio_ctx for _, p in eng.calls}
    assert None in ctxs and 64 in ctxs


# -- the HTTP front ----------------------------------------------------------


def _post(conn, body, headers=None):
    conn.request("POST", "/transcribe", body, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_http_transcribe_and_health(tmp_path):
    srv = BatchingTranscriptionServer(RecordingEngine(), max_wait_ms=5)
    http_srv = TranscriptionHTTPServer(srv)
    http_srv.start()
    try:
        host, port = http_srv.address
        assert host == "127.0.0.1" and port > 0
        conn = http.client.HTTPConnection(host, port, timeout=WAIT)
        wav = str(tmp_path / "a.wav")
        save_wav_file(wav, np.ones(8000, np.float32) * 0.1)
        assert _post(conn, open(wav, "rb").read()) == (
            200, {"text": "len=16000", "language": None, "segments": []})
        # raw f32 at 48 kHz, resampled to 1 s
        status, payload = _post(conn, (np.ones(48000, np.float32) * 0.1).tobytes(),
                                {"X-Sample-Rate": "48000"})
        assert status == 200 and payload["text"] == "len=16000"
        mu = mulaw_encode(np.ones(16000, np.float32) * 0.1).tobytes()
        status, payload = _post(conn, mu, {"X-PCM-Format": "mulaw"})
        assert status == 200 and payload["text"] == "len=16000"
        status, payload = _post(conn, np.ones(30000, "<i2").tobytes(),
                                {"X-PCM-Format": "s16le"})
        assert status == 200 and payload["text"] == "len=32000"
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["ok"] and health["batches"] == [1, 1, 1, 1]
        conn.request("GET", "/nope")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
        conn.request("POST", "/nope", b"")
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
        conn.close()
    finally:
        http_srv.stop()
        srv.shutdown()


def test_http_headers_become_params_and_errors_500():
    seen = []

    class ParamsEngine:
        device = "cpu"

        def transcribe_batch(self, batch, params=None):
            seen.append(params)
            if params.language == "xx":
                raise ValueError("bad language")
            return [TranscriptionResult(text="ok") for _ in batch]

    srv = BatchingTranscriptionServer(ParamsEngine(), max_wait_ms=5)
    http_srv = TranscriptionHTTPServer(srv)
    http_srv.start()
    try:
        conn = http.client.HTTPConnection(*http_srv.address, timeout=WAIT)
        body = np.zeros(1600, np.float32).tobytes()
        status, _ = _post(conn, body, {
            "X-Language": "de", "X-Translate": "1", "X-Initial-Prompt": "hi",
            "X-Beam-Size": "3", "X-Audio-Ctx": "128"})
        assert status == 200
        assert seen[-1] == TranscribeParams(language="de", translate=True,
                                            initial_prompt="hi", beam_size=3,
                                            audio_ctx=128)
        status, payload = _post(conn, body, {"X-Language": "xx"})
        assert status == 500 and payload["error"] == "ValueError: bad language"
        conn.close()
    finally:
        http_srv.stop()
        srv.shutdown()


def test_http_front_maps_shed_to_503():
    srv = BatchingTranscriptionServer(ParamsDelayEngine(delay=0.5), max_batch=1,
                                      max_wait_ms=1.0, sla_ms=10.0, shed_factor=1.0)
    http_srv = TranscriptionHTTPServer(srv)
    http_srv.start()
    codes = []
    try:
        host, port = http_srv.address
        body = np.zeros(16000, np.float32).tobytes()

        def worker():
            req = urllib.request.Request(f"http://{host}:{port}/transcribe",
                                         data=body, headers={"X-Language": "en"})
            try:
                with urllib.request.urlopen(req, timeout=WAIT) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                assert json.loads(e.read())["retryable"] is True

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert 503 in codes and 200 in codes
    finally:
        http_srv.stop()
        srv.shutdown()


@pytest.mark.parametrize("case", [
    dict(fmt="mulaw", rate=None),
    dict(fmt="mulaw", rate=8000),
    dict(fmt="s16le", rate=None),
    dict(fmt="s16le", rate=44100),
    dict(fmt="", rate=None),
    dict(fmt="", rate=22050),
    dict(fmt="wav", rate=16000),
    dict(fmt="wav", rate=48000),
])
def test_parse_audio_matches_jax(tmp_path, case):
    """Every body format, with and without a resample: the same dtype and
    length, int16 kept where no resample is needed, values within 1e-5 of
    the peak (the resample's f32 convs) and exact otherwise."""
    rng = np.random.default_rng(11)
    rate = case["rate"] or 16000
    x = (0.3 * np.sin(2 * np.pi * 440 * np.arange(rate) / rate)
         + 0.01 * rng.standard_normal(rate)).astype(np.float32)
    if case["fmt"] == "mulaw":
        body = mulaw_encode(x).tobytes()
    elif case["fmt"] == "s16le":
        body = (x * 32767).astype("<i2").tobytes()
    elif case["fmt"] == "wav":
        path = str(tmp_path / "x.wav")
        save_wav_file(path, x, rate)
        body = open(path, "rb").read()
    else:
        body = x.tobytes()
    fmt = "" if case["fmt"] == "wav" else case["fmt"]
    ref = np.asarray(jhttp._parse_audio(body, "", case["rate"], fmt))
    ours = _parse_audio(body, "", case["rate"], fmt, device="cpu")
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    if rate == 16000:
        assert ours.dtype == (np.float32 if case["fmt"] == "" else np.int16)
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_parse_audio_explicit_format_beats_riff_sniff():
    codes = np.full(16000, 128, np.uint8)
    codes[:4] = [0x52, 0x49, 0x46, 0x46]  # b"RIFF"
    audio = _parse_audio(codes.tobytes(), "", None, pcm_format="mulaw")
    assert audio.dtype == np.int16 and audio.size == 16000
    s16 = np.zeros(8000, "<i2")
    s16[0], s16[1] = 0x4952, 0x4646  # little-endian b"RIFF"
    audio = _parse_audio(s16.tobytes(), "", None, pcm_format="s16le")
    assert audio.dtype == np.int16 and audio.size == 8000


def test_parse_audio_resamples_on_the_card_by_default(monkeypatch):
    """Without a device the front resamples on "cuda", which raises without
    a card; 16 kHz bodies need no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    body = np.zeros(4800, np.float32).tobytes()
    assert _parse_audio(body, "", None).size == 4800
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _parse_audio(body, "", 48000)


# -- the trained tiny checkpoint through both servers --------------------------


def _speech(i, case):
    """The case's tones, cut 0.3 s after the last one (the 5 s bucket), or
    at 7 s for every other case (the 10 s bucket)."""
    audio, _, t_end = tcc.utterance(case["word_ids"])
    return audio[: int((t_end + 0.3 if i % 2 else 7.0) * 16000)]


def _concurrently(srv, audios, params):
    """Submit every audio from its own thread at once; the results in order."""
    futs = [None] * len(audios)
    start = threading.Barrier(len(audios))

    def submit(i):
        start.wait(timeout=WAIT)
        futs[i] = srv.submit(audios[i], params)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(audios))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    return [f.result(timeout=300) for f in futs]


def test_trained_tiny_through_both_servers_equal():
    """The same concurrent requests through the JAX server over the JAX
    engine and through the port's server (stager and runner) over
    WhisperEngine(device="cpu"): texts and segments equal, tokens equal to
    the goldens."""
    with open(os.path.join(DATA, "goldens.json")) as f:
        cases = json.load(f)["cases"]
    audios = [_speech(i, c) for i, c in enumerate(cases)]
    assert {bucket_for(len(a)) for a in audios} == {80000, 160000}
    npz = os.path.join(DATA, "params.npz")
    kw = dict(max_batch=8, max_wait_ms=500.0, overlap_transfers=True)
    params = dict(language="en", temperatures=(0.0,))

    port = WhisperEngine(device="cpu")
    port.load_model(npz)
    srv = BatchingTranscriptionServer(port, **kw)
    try:
        got = _concurrently(srv, audios, _pw(**params))
    finally:
        srv.shutdown()
    ref_eng = JaxEngine()
    ref_eng.load_model(npz)
    jsrv = JServer(ref_eng, **kw)
    try:
        ref = _concurrently(jsrv, audios, _pw(JParams, **params))
    finally:
        jsrv.shutdown()

    def view(r):
        return r.text, [(s.start, s.end, s.text) for s in r.segments]

    assert [view(r) for r in got] == [view(r) for r in ref]
    assert [r.tokens for r in got] == [c["greedy_tokens"] for c in cases]
