"""Developer CLI of the PyTorch port (port of spittle_tpu/cli.py's
subcommands that reach an engine): transcribe a WAV file, show its speech
spans, or serve the batching HTTP front.

Usage:
  python -m spittle_tpu_torch.cli transcribe audio.wav --model random:tiny.en
  python -m spittle_tpu_torch.cli vad audio.wav
  python -m spittle_tpu_torch.cli serve --model random:large-v3-turbo

Everything runs on the card unless --torch-device cpu is given (without a
card the default raises). The JAX CLI's microphone capture (--mic,
record), rolling-rewrite replay, desktop app and model catalog drive host
modules the port does not carry.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from spittle_tpu_torch.utils.logging import get_logger

_log = get_logger("cli")


def _engine_overrides(args) -> dict:
    """CLI flags -> WhisperEngine.from_env overrides (flags win over env;
    absent flags defer to SPITTLE_* / defaults). The device is always
    --torch-device's."""
    ov = {"device": getattr(args, "torch_device", "cuda")}
    if getattr(args, "wire", None):
        ov["wire"] = args.wire
    if getattr(args, "quantize_encoder", False):
        ov["quantize_encoder"] = True
    if getattr(args, "quantize_decoder", None):
        ov["quantize_decoder"] = args.quantize_decoder
    if getattr(args, "quantize_cache", False):
        ov["quantize_cache"] = True
    return ov


def _resample_16k(audio, rate: int, device):
    """float32 PCM at `rate` -> 16 kHz numpy, resampled on `device`."""
    import torch

    from spittle_tpu_torch.audio.resample import resample

    x = torch.from_numpy(audio).to(device)
    return resample(x, rate, 16000).cpu().numpy()


def cmd_transcribe(args) -> int:
    from spittle_tpu_torch.audio.wav import load_wav_file
    from spittle_tpu_torch.device import resolve_device
    from spittle_tpu_torch.engine.base import TranscribeParams, normalize_pcm
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.utils.tracing import get_tracer

    tracer = get_tracer()
    if not args.audio:
        print("error: provide a WAV path", file=sys.stderr)
        return 2
    # int16 is the engine's wire format: half the host->device bytes,
    # normalized on the device.
    audio, rate = load_wav_file(args.audio, keep_int16=True)
    if rate != 16000:
        audio = _resample_16k(normalize_pcm(audio), rate,
                              resolve_device(args.torch_device))

    engine = WhisperEngine.from_env(**_engine_overrides(args))
    t0 = time.perf_counter()
    with tracer.span("model_load"):
        engine.load_model(args.model)
        if args.draft_model:
            engine.load_draft_model(args.draft_model)
        elif getattr(args, "self_draft_stride", 0):
            engine.load_self_draft(stride=args.self_draft_stride)
    _log.info("model %s loaded on %s in %.3f s", args.model, engine.device,
              time.perf_counter() - t0)
    params = TranscribeParams(
        language=args.language,
        translate=args.translate,
        initial_prompt=args.initial_prompt,
        beam_size=args.beam_size,
        word_timestamps=args.words,
        condition_on_previous_text=not (
            args.no_condition or args.parallel_windows
        ),
        parallel_windows=args.parallel_windows,
        audio_ctx=args.audio_ctx,
    )
    t0 = time.perf_counter()
    with tracer.span("transcribe"):
        if args.vad:
            result = engine.transcribe_vad_segments(audio, params)
        else:
            result = engine.transcribe_samples(audio, params)
    _log.info("transcribed %s (%.2f s of audio) in %.3f s: %d segments, "
              "%d tokens", args.audio, len(audio) / 16000,
              time.perf_counter() - t0, len(result.segments), len(result.tokens))
    print(result.text)
    if args.timestamps:
        for seg in result.segments:
            print(f"[{seg.start:7.2f} -> {seg.end:7.2f}] {seg.text}")
    if args.words:
        for w in result.words:
            print(f"  {w.start:7.2f} -> {w.end:7.2f}  {w.word}")
    if args.stats:
        print(json.dumps(tracer.stats(), indent=2), file=sys.stderr)
    return 0


def cmd_vad(args) -> int:
    from spittle_tpu_torch.audio.vad.segmenter import segment_speech
    from spittle_tpu_torch.audio.wav import load_wav_file
    from spittle_tpu_torch.device import resolve_device

    dev = resolve_device(args.torch_device)
    audio, rate = load_wav_file(args.audio)
    if rate != 16000:
        audio = _resample_16k(audio, rate, dev)
    segments = segment_speech(audio, device=dev)
    total = 0.0
    for s in segments:
        print(f"speech {s.start_sec:8.2f}s -> {s.end_sec:8.2f}s")
        total += s.end_sec - s.start_sec
    print(f"{len(segments)} segments, {total:.2f}s speech of "
          f"{len(audio) / 16000:.2f}s audio")
    _log.info("vad %s: %d segments", args.audio, len(segments))
    return 0


def cmd_serve(args) -> int:
    """Batching HTTP transcription server (parallel/serving.py front)."""
    from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
    from spittle_tpu_torch.parallel.http_server import TranscriptionHTTPServer
    from spittle_tpu_torch.parallel.serving import BatchingTranscriptionServer

    engine = WhisperEngine.from_env(**_engine_overrides(args))
    engine.load_model(args.model)
    if args.draft_model:
        engine.load_draft_model(args.draft_model)
    elif getattr(args, "self_draft_stride", 0):
        engine.load_self_draft(stride=args.self_draft_stride)
    server = BatchingTranscriptionServer(
        engine, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        fit_audio_ctx=args.fit_audio_ctx,
    )
    if args.warmup:
        print("warming batch-size ladder...", flush=True)
        server.warmup()
    http = TranscriptionHTTPServer(server, host=args.host, port=args.port)
    http.start()
    print(f"serving on http://{http.address[0]}:{http.address[1]} "
          f"(model={args.model}, max_batch={args.max_batch})")
    _log.info("serving %s on %s:%d", args.model, *http.address[:2])
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        http.stop()
        server.shutdown()
    return 0


def _torch_device_flag(p) -> None:
    p.add_argument("--torch-device", default="cuda",
                   help="torch device the engine runs on: cuda (default; "
                        "raises without a card) or cpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spittle-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("transcribe", help="transcribe a WAV file")
    t.add_argument("audio", nargs="?", default=None)
    t.add_argument("--model", default="random:tiny.en",
                   help="GGML file, safetensors dir, .npz or random:<config>")
    t.add_argument("--language", default=None)
    t.add_argument("--translate", action="store_true")
    t.add_argument("--initial-prompt", default=None)
    t.add_argument("--beam-size", type=int, default=1)
    t.add_argument("--vad", action="store_true",
                   help="VAD-segment long audio before transcribing")
    t.add_argument("--timestamps", action="store_true")
    t.add_argument("--words", action="store_true",
                   help="word-level timestamps (cross-attention DTW)")
    t.add_argument("--stats", action="store_true")
    t.add_argument("--self-draft-stride", type=int, default=0,
                   help="speculative decode with a layer-dropped draft "
                        "of the SAME model (every Nth decoder layer); "
                        "needs no second checkpoint")
    t.add_argument("--draft-model", default=None,
                   help="small same-vocab model for speculative decoding")
    t.add_argument("--wire", default=None, choices=["auto", "mulaw"],
                   help="host->device audio wire format (default: "
                        "SPITTLE_WIRE or auto)")
    t.add_argument("--quantize-encoder", action="store_true",
                   help="W8A8 int8 encoder GEMMs (K2 on the card)")
    t.add_argument("--quantize-decoder", nargs="?", const="int8",
                   default=None, choices=["int8", "int4", "w8a8"],
                   help="int8 decoder weights + int8/int4 cross-KV "
                        "(bare flag = int8)")
    t.add_argument("--quantize-cache", action="store_true",
                   help="int8 self-attention KV cache (quantized on write)")
    t.add_argument("--no-condition", action="store_true",
                   help="disable condition_on_previous_text prompt carry")
    t.add_argument("--audio-ctx", type=int, default=None,
                   help="reduced encoder context (whisper.cpp audio_ctx "
                        "analog): encode only the first N positions "
                        "(N/50 seconds) per window — faster, not "
                        "bit-equal to the full window")
    t.add_argument("--parallel-windows", action="store_true",
                   help="decode all 30s windows in one batch "
                        "(implies --no-condition)")
    _torch_device_flag(t)
    t.set_defaults(fn=cmd_transcribe)

    v = sub.add_parser("vad", help="show speech segments of a WAV file")
    v.add_argument("audio")
    _torch_device_flag(v)
    v.set_defaults(fn=cmd_vad)

    s = sub.add_parser("serve", help="batching HTTP transcription server")
    s.add_argument("--model", default="random:tiny.en")
    s.add_argument("--self-draft-stride", type=int, default=0,
                   help="layer-dropped self-draft speculative decoding")
    s.add_argument("--draft-model", default=None,
                   help="small same-vocab model for speculative decoding")
    s.add_argument("--wire", default=None, choices=["auto", "mulaw"])
    s.add_argument("--quantize-encoder", action="store_true")
    s.add_argument("--quantize-decoder", nargs="?", const="int8",
                   default=None, choices=["int8", "int4", "w8a8"])
    s.add_argument("--quantize-cache", action="store_true")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8090)
    s.add_argument("--max-batch", type=int, default=32)
    s.add_argument("--max-wait-ms", type=float, default=10.0)
    s.add_argument("--fit-audio-ctx", action="store_true",
                   help="run each length bucket at the reduced encoder "
                        "context covering it (whisper.cpp audio_ctx trade)")
    s.add_argument("--warmup", action="store_true",
                   help="run the batch-size ladder once before accepting "
                        "traffic")
    _torch_device_flag(s)
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
