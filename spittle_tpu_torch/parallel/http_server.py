"""HTTP serving front for the batching transcription server (port of
spittle_tpu/parallel/http_server.py).

Endpoints:
  POST /transcribe   body: WAV bytes, raw f32 PCM, raw s16le, or mu-law PCM
                     (X-PCM-Format: s16le | mulaw; X-Sample-Rate for raw) ->
                     {"text", "language", "segments": [...]}
  GET  /healthz      {"ok": true, "batches": [...recent batch sizes...]}

stdlib http.server (threaded); the work runs in the batching server's
engine, so handler threads block on futures. Audio at a rate other than
16 kHz is resampled on the engine's device.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from spittle_tpu_torch.audio.mulaw import mulaw_decode_np
from spittle_tpu_torch.audio.resample import resample
from spittle_tpu_torch.audio.wav import load_wav_file
from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.engine.base import TranscribeParams, normalize_pcm
from spittle_tpu_torch.utils.threads import spawn

from .serving import BatchingTranscriptionServer, ServerOverloaded


def _parse_audio(
    body: bytes,
    content_type: str,
    sample_rate: Optional[int],
    pcm_format: str = "",
    device="cuda",
):
    """WAV bytes, raw f32le, raw s16le, or 8-bit mu-law
    (X-PCM-Format: s16le | mulaw) -> 16 kHz PCM on the host.

    int16 stays int16 when no resample is needed: it is the engine's wire
    format. mu-law decodes to int16 here so the engine's wire stays
    compact. Another rate is resampled on `device` ("cuda" by default;
    the HTTP front passes its engine's)."""
    # An explicit X-PCM-Format outranks content sniffing: raw PCM can
    # legitimately start with the bytes "RIFF" (for the 8-bit mu-law wire
    # that is just four mid-amplitude samples).
    if pcm_format == "mulaw":
        audio = (
            mulaw_decode_np(np.frombuffer(body, np.uint8)) * 32767.0
        ).astype(np.int16)
        rate = sample_rate or 16000
    elif pcm_format == "s16le":
        audio = np.frombuffer(body, "<i2")
        rate = sample_rate or 16000
    elif body[:4] == b"RIFF":
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            f.write(body)
            path = f.name
        try:
            audio, rate = load_wav_file(path, keep_int16=True)
        finally:
            os.unlink(path)
    else:
        audio = np.frombuffer(body, np.float32)
        rate = sample_rate or 16000
    if rate != 16000:
        x = torch.from_numpy(normalize_pcm(audio).copy()).to(resolve_device(device))
        audio = resample(x, rate, 16000).cpu().numpy()
    return audio


class _Server(ThreadingHTTPServer):
    # Many sessions connect at once (the serving configuration's 32); the
    # stdlib's listen backlog of 5 resets the connections past it.
    request_queue_size = 128


class TranscriptionHTTPServer:
    """The HTTP front of a BatchingTranscriptionServer, on host:port (port
    0 picks a free one; see `address`). Request audio at another rate is
    resampled on the server's engine's device."""

    def __init__(
        self,
        server: BatchingTranscriptionServer,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.batcher = server
        self.device = resolve_device(server.engine.device)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code: int, payload) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {
                        "ok": True,
                        "batches": outer.batcher.batch_sizes[-20:],
                    })
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/transcribe":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    sr = self.headers.get("X-Sample-Rate")
                    audio = _parse_audio(
                        body, self.headers.get("Content-Type", ""),
                        int(sr) if sr else None,
                        self.headers.get("X-PCM-Format", ""),
                        device=outer.device,
                    )
                    actx = self.headers.get("X-Audio-Ctx")
                    params = TranscribeParams(
                        language=self.headers.get("X-Language") or None,
                        translate=self.headers.get("X-Translate") == "1",
                        initial_prompt=self.headers.get("X-Initial-Prompt") or None,
                        beam_size=int(self.headers.get("X-Beam-Size", "1")),
                        # whisper.cpp's audio_ctx (a speed knob)
                        audio_ctx=int(actx) if actx else None,
                    )
                    result = outer.batcher.transcribe(audio, params)
                    self._json(200, {
                        "text": result.text,
                        "language": result.language,
                        "segments": [
                            {"start": s.start, "end": s.end, "text": s.text}
                            for s in result.segments
                        ],
                    })
                except ServerOverloaded as e:
                    # Admission control shed: retryable backpressure.
                    self._json(503, {"error": str(e), "retryable": True})
                except Exception as e:  # robust serving loop
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = _Server((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self):
        return self.httpd.server_address

    def start(self) -> None:
        self._thread = spawn(self.httpd.serve_forever, name="http-serve")

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
