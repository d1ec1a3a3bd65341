"""Whisper engine: batched long-form transcription on the card (port of
spittle_tpu/engine/whisper_engine.py, parallel-windows path).

What the port carries: `random:<config>` and spittle .npz models, the
mu-law or int16 PCM wire, the W8A8 encoder, the bf16/f32 decoder or the
weight-only int8 decoder with int8 or int4 cross-K/V (quantize_decoder)
and an int8 self-cache (quantize_cache), the encoder-attention forms
(encoder_attention), greedy temperature-0 decoding, parallel windows
with overlap-stitch, `transcribe_batch` and the pipelined
`transcribe_stream` (prefetch thread, overlap_fetch). A window is two mel
frames per encoder position: 30 s for the stock 1500 positions, longer for
a model with a larger n_audio_ctx (past 4096 positions the encoder's
self-attention runs K5), shorter under TranscribeParams.audio_ctx (a
push-to-talk utterance). Everything else raises NotImplementedError
pointing at ROADMAP.md: the sequential seek path, temperature ladders
longer than one rung, language detection, beam search, speculative
decoding, word timestamps, the "w8a8" decoder, and the GGML/safetensors
loaders.

The engine runs on the card by default (device="cuda") and raises when
there is none; the CPU is used only when the caller passes device="cpu".
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spittle_tpu_torch.audio.mel import HOP_LENGTH, log_mel_spectrogram
from spittle_tpu_torch.audio.mulaw import mulaw_decode, mulaw_encode
from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.models.whisper.config import CONFIGS, WhisperConfig
from spittle_tpu_torch.models.whisper.decode import DecodeOptions, greedy_decode
from spittle_tpu_torch.models.whisper.model import encode, sinusoidal_positions
from spittle_tpu_torch.models.whisper.tokenizer import (
    WhisperTokenizer,
    make_test_vocab,
)
from spittle_tpu_torch.models.whisper.weights import (
    cast_params,
    load_npz_checkpoint,
    params_from_jax,
    random_params,
)
from spittle_tpu_torch.ops import full_f32
from spittle_tpu_torch.ops.attention import check_encoder_attention
from spittle_tpu_torch.ops.quant import (
    quantize_whisper_decoder,
    quantize_whisper_encoder_w8a8,
)

from .base import Segment, TranscribeParams, TranscriptionResult

FRAMES_PER_SECOND = 100


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to spittle_tpu_torch yet (see ROADMAP.md, "
        "queue 1)"
    )


def _pcm_f32(w: torch.Tensor) -> torch.Tensor:
    """Device-side PCM normalize: wire format -> float32 [-1, 1)."""
    if w.dtype == torch.int16:
        return w.to(torch.float32) / 32768.0
    if w.dtype == torch.uint8:
        return mulaw_decode(w)
    return w.to(torch.float32)


def _as_audio(a) -> np.ndarray:
    """Accept float32 [-1,1] or int16 PCM; other dtypes convert to f32."""
    a = np.asarray(a)
    if a.dtype == np.int16:
        return a
    return a.astype(np.float32, copy=False)


def select_core_segments(segments, seek_s, window_s, overlap_s,
                         is_first, is_last):
    """Overlap-stitch: keep items whose midpoint lies in this window's
    core region (absolute seconds). Core regions of consecutive windows
    partition the timeline, so nothing duplicates or drops."""
    lo = seek_s if is_first else seek_s + overlap_s / 2
    hi = seek_s + window_s if is_last else seek_s + window_s - overlap_s / 2
    return [x for x in segments if lo <= (x.start + x.end) / 2 < hi]


class WhisperEngine:
    """Batched Whisper transcription in PyTorch."""

    # The reference engine's default ladder and no-speech gate.
    FALLBACK_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    LOGPROB_THRESHOLD = -1.0
    NO_SPEECH_THRESHOLD = 0.6

    def __init__(
        self,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
        quantize_encoder: bool = False,
        quantize_decoder=False,
        quantize_cache: bool = False,
        wire: str = "auto",
        encoder_attention: str = "fullkv",
    ):
        """device: "cuda" (default; raises without a card) or "cpu".
        dtype: compute dtype of the weights (layer norms stay f32); by
        default bf16 on the card, whose attention kernels take bf16, and
        f32 on the CPU. An f32 model whose attention shapes reach a kernel
        raises on the card.
        quantize_encoder: W8A8 int8 encoder GEMMs (kernel K2 on the card).
        quantize_decoder: False, True or "int8", or "int4": weight-only
        int8 decoder block weights, and cross-attention K/V quantized to
        int8 (K3 on the card) or int4 packed two per byte (K6). "w8a8"
        is not ported yet and raises NotImplementedError.
        quantize_cache: int8 self-attention cache, one scale per position.
        wire: "auto" ships the input's own PCM dtype host->device; "mulaw"
        ships 8-bit mu-law codes, decoded on the device.
        encoder_attention: the encoder self-attention form, which the
        reference takes from the environment: "fullkv" (K1 on the card),
        "q8" (int8 products, K7; SPITTLE_ATTN_Q8=1), "packed" (K8;
        SPITTLE_PACKED_ATTENTION=1), "pair" (K9;
        SPITTLE_PACKED_ATTENTION=pair) or "pipe" (K10; SPITTLE_ATTN_PIPE=1).
        Anything else raises ValueError. It may be changed between
        batches."""
        self.device = resolve_device(device)
        self.encoder_attention = encoder_attention
        if wire not in ("auto", "mulaw"):
            raise ValueError(f"wire must be 'auto' or 'mulaw', got {wire!r}")
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        if quantize_decoder is True:
            quantize_decoder = "int8"
        if quantize_decoder == "w8a8":
            raise _not_ported('quantize_decoder="w8a8" (int8 x int8 '
                              'cross-attention)')
        if quantize_decoder not in (False, "int8", "int4"):
            raise ValueError(
                "quantize_decoder must be False, True/'int8', 'int4' or "
                f"'w8a8', got {quantize_decoder!r}")
        self.quantize_encoder = quantize_encoder
        self.quantize_decoder = quantize_decoder
        self.quantize_cache = quantize_cache
        self.wire = wire
        self.cfg: Optional[WhisperConfig] = None
        self.params = None
        # The encoder's position table on the device, made once per model.
        self._positions: Optional[torch.Tensor] = None
        self.tokenizer: Optional[WhisperTokenizer] = None
        self._space_token: Optional[int] = None
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        # Wall seconds per stage of the most recent batches (frontend =
        # mel + encoder, decode = cross-K/V + prefill + greedy loop,
        # finalize = fetch + parse), summed until reset.
        self.stage_seconds: Dict[str, float] = {}
        self.last_decode_steps: List[int] = []

    # -- lifecycle -------------------------------------------------------

    def load_model(self, model_path: str, seed: int = 0) -> None:
        """`random:<config>` (numpy-seeded weights) or a spittle .npz."""
        if model_path.startswith("random:"):
            self.cfg = CONFIGS[model_path.split(":", 1)[1]]
            self.params = random_params(self.cfg, seed=seed, dtype=self.dtype,
                                        device=self.device)
            self.tokenizer = WhisperTokenizer(self.cfg, make_test_vocab())
        elif model_path.endswith(".npz"):
            self.cfg, tree, extras = load_npz_checkpoint(model_path)
            params = params_from_jax(tree, device=self.device)
            self.params = cast_params(params, self.dtype)
            if "vocab" not in extras:
                raise _not_ported("tokenizer files beside an .npz")
            vocab = {tok: i for i, tok in enumerate(extras["vocab"])}
            self.tokenizer = WhisperTokenizer(self.cfg, vocab)
        else:
            raise _not_ported("GGML and safetensors loading")
        # The reference's order: the decoder first, then the encoder.
        if self.quantize_decoder:
            self.params = quantize_whisper_decoder(self.params)
        if self.quantize_encoder:
            self.params = quantize_whisper_encoder_w8a8(self.params)
        self._positions = torch.from_numpy(sinusoidal_positions(
            self.cfg.n_audio_ctx, self.cfg.n_audio_state)).to(
            device=self.device, dtype=self.dtype)
        space = self.tokenizer.encode(" ")
        self._space_token = space[0] if space else None

    @property
    def is_loaded(self) -> bool:
        return self.params is not None

    @property
    def encoder_attention(self) -> str:
        return self._encoder_attention

    @encoder_attention.setter
    def encoder_attention(self, form: str) -> None:
        self._encoder_attention = check_encoder_attention(form)

    # -- helpers ---------------------------------------------------------

    @property
    def window_frames(self) -> int:
        """Mel frames per full window: two per encoder position (3000 for
        the stock 1500 positions; a custom n_audio_ctx scales the window)."""
        return self.cfg.n_audio_ctx * 2

    @property
    def window_samples(self) -> int:
        return self.window_frames * HOP_LENGTH

    def _window_geometry(self, params: TranscribeParams) -> Tuple[int, int]:
        """(window_frames, window_samples) for this call. params.audio_ctx
        shrinks the window: the encoder runs over audio_ctx positions =
        2 * audio_ctx mel frames, so a short utterance skips the padded
        frames in the encoder and in every step's cross-K/V read."""
        if params.audio_ctx:
            wf = min(2 * params.audio_ctx, self.window_frames)
            return wf, wf * HOP_LENGTH
        return self.window_frames, self.window_samples

    def _check_params(self, params: TranscribeParams) -> None:
        if not params.parallel_windows or params.condition_on_previous_text:
            raise _not_ported("the sequential seek path (prompt carry)")
        if len(params.temperatures or self.FALLBACK_TEMPERATURES) > 1:
            raise _not_ported("a temperature ladder longer than one rung")
        if params.temperatures and params.temperatures[0] != 0.0:
            raise _not_ported("temperature sampling")
        if params.language is None and self.cfg.multilingual:
            raise _not_ported("language detection")
        if params.beam_size > 1:
            raise _not_ported("beam search")
        if params.word_timestamps:
            raise _not_ported("word timestamps")

    def _decode_options(self, params: TranscribeParams) -> DecodeOptions:
        return DecodeOptions(
            task="translate" if params.translate else "transcribe",
            language=params.language,
            space_token=self._space_token,
            max_tokens=params.max_tokens or self.cfg.n_text_ctx // 2,
            quant_kv=bool(self.quantize_decoder),
            quant_kv_bits=4 if self.quantize_decoder == "int4" else 8,
            quant_cache=self.quantize_cache,
        )

    def _base_prompt(self, params: TranscribeParams) -> Tuple[int, ...]:
        """initial_prompt -> conditioning tokens, truncated to
        n_text_ctx/2 - 1."""
        if not params.initial_prompt:
            return ()
        max_prompt = self.cfg.n_text_ctx // 2 - 1
        ids = self.tokenizer.encode(" " + params.initial_prompt.strip())
        return tuple(ids[-max_prompt:])

    def _time(self, stage: str, seconds: float) -> None:
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + seconds

    # -- windows ---------------------------------------------------------

    def _assemble_windows(self, audios, items,
                          window_samples: Optional[int] = None) -> np.ndarray:
        """items: [(audio_idx, start_sample)] -> [len(items), window] PCM
        (int16 when every input is int16, else f32), mu-law encoded when
        wire == "mulaw". window_samples: a reduced window's length."""
        ws = window_samples or self.window_samples
        all_i16 = all(a.dtype == np.int16 for a in audios)
        dtype = np.int16 if all_i16 else np.float32
        windows = np.zeros((len(items), ws), dtype)
        for wi, (i, start) in enumerate(items):
            chunk = audios[i][start : start + ws]
            if chunk.dtype == np.int16 and not all_i16:
                chunk = chunk.astype(np.float32) / 32768.0
            windows[wi, : len(chunk)] = chunk
        if self.wire == "mulaw":
            return mulaw_encode(windows)
        return windows

    def _plan_parallel_windows(self, audios, params: TranscribeParams):
        """Host half of the parallel-windows path: window plan + PCM batch.
        Returns (plan, windows, content_frames, overlap)."""
        n = len(audios)
        content_frames = [max(1, len(a) // HOP_LENGTH) for a in audios]
        wf, ws = self._window_geometry(params)
        overlap = min(int(params.parallel_overlap_s * FRAMES_PER_SECOND),
                      wf // 2)
        stride = max(wf - overlap, 1)
        # Stop at content - overlap: the previous window already covers
        # the rest.
        plan = [
            (i, seek)
            for i in range(n)
            for seek in range(0, max(content_frames[i] - overlap, 1), stride)
        ]
        windows = self._assemble_windows(
            audios, [(i, seek * HOP_LENGTH) for i, seek in plan],
            window_samples=ws,
        )
        return plan, windows, content_frames, overlap

    def _place_windows(self, windows: np.ndarray):
        """Host->device transfer of a window batch. On the card the copy
        runs from pinned memory on a side stream; the returned event
        orders it before the consumer's use (_windows_ready)."""
        host = torch.from_numpy(windows)
        if self.device.type == "cpu":
            return host, None
        host = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, ready

    def _windows_ready(self, placed) -> torch.Tensor:
        dev, ready = placed
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            dev.record_stream(stream)
        return dev

    def _frontend(self, windows: torch.Tensor) -> torch.Tensor:
        """windows [B, samples] wire PCM on the device -> encoder output
        [B, samples / 320, D]: a window shorter than the model's encodes
        with the first positions."""
        mel = log_mel_spectrogram(_pcm_f32(windows), n_mels=self.cfg.n_mels)
        return encode(self.params, mel, self.cfg, self.encoder_attention,
                      self._positions)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- transcription ---------------------------------------------------

    def transcribe_batch(self, batch: Sequence[np.ndarray],
                         params: Optional[TranscribeParams] = None
                         ) -> List[TranscriptionResult]:
        """Batched long-form transcription over parallel windows."""
        if not self.is_loaded:
            raise RuntimeError("no model loaded")
        params = params or TranscribeParams()
        self._check_params(params)
        audios = [_as_audio(a) for a in batch]
        plan, windows, content_frames, overlap = self._plan_parallel_windows(
            audios, params
        )
        staged = (plan, self._place_windows(windows), content_frames, overlap)
        return self._finalize_parallel_windows(self._dispatch_parallel_windows(
            audios, params, self._base_prompt(params), staged
        ))

    def transcribe_stream(self, batches, params=None, prefetch: int = 1,
                          overlap_fetch: bool = False):
        """Pipelined batched transcription. A producer thread plans and
        assembles batch k+1's windows and starts their host->device copy
        while batch k computes. Yields List[TranscriptionResult] per batch,
        in order. overlap_fetch: run batch k+1's device half before batch
        k's fetch and parse (results still yield in order, one batch
        later). Requires parallel windows without prompt carry."""
        if not self.is_loaded:
            raise RuntimeError("no model loaded")
        params = params or TranscribeParams(
            parallel_windows=True, condition_on_previous_text=False
        )
        self._check_params(params)
        base_prompt = self._base_prompt(params)
        q: _queue.Queue = _queue.Queue(maxsize=max(1, prefetch))
        done = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # Bounded put that gives up once the consumer has left.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        def producer():
            # Exception barrier: nothing escapes the thread; a failure is
            # handed to the consumer, which raises it.
            try:
                for batch in batches:
                    if stop.is_set():
                        return
                    audios = [_as_audio(a) for a in batch]
                    plan, windows, content_frames, overlap = (
                        self._plan_parallel_windows(audios, params)
                    )
                    staged = (plan, self._place_windows(windows),
                              content_frames, overlap)
                    if not _put((audios, staged)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                _put(("__error__", e))
            else:
                _put(done)

        t = threading.Thread(target=producer, name="spittle-torch-prefetch",
                             daemon=True)
        t.start()
        try:
            held = None
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, tuple) and item[0] == "__error__":
                    raise item[1]
                audios, staged = item
                disp = self._dispatch_parallel_windows(
                    audios, params, base_prompt, staged
                )
                if not overlap_fetch:
                    yield self._finalize_parallel_windows(disp)
                    continue
                if held is not None:
                    yield self._finalize_parallel_windows(held)
                held = disp
            if held is not None:
                yield self._finalize_parallel_windows(held)
        finally:
            stop.set()
            t.join(timeout=5.0)

    def _dispatch_parallel_windows(self, audios, params: TranscribeParams,
                                   base_prompt, staged) -> dict:
        """Device half: frontend + greedy decode of every window."""
        plan, placed, content_frames, overlap = staged
        wf, _ = self._window_geometry(params)
        # full_f32: an f32 model's products and stem convolutions must
        # match the reference's f32 arithmetic, so TF32 stays off here.
        with torch.inference_mode(), full_f32():
            t0 = time.perf_counter()
            xa = self._frontend(self._windows_ready(placed))
            self._sync()
            t1 = time.perf_counter()
            out = greedy_decode(self.params, xa, self.cfg,
                                self._decode_options(params),
                                prompt_tokens=base_prompt)
            self._sync()
            t2 = time.perf_counter()
        self._time("frontend", t1 - t0)
        self._time("decode", t2 - t1)
        self.last_decode_steps.append(out["steps"])
        return dict(out=out, params=params, plan=plan,
                    content_frames=content_frames, overlap=overlap, wf=wf,
                    n=len(audios))

    def _finalize_parallel_windows(self, disp) -> List[TranscriptionResult]:
        """Host half: fetch tokens, no-speech skip, parse and stitch."""
        t0 = time.perf_counter()
        cfg = self.cfg
        out = disp["out"]
        params = disp["params"]
        plan = disp["plan"]
        content_frames = disp["content_frames"]
        overlap = disp["overlap"]
        wf = disp["wf"]
        n = disp["n"]
        tokens = out["tokens"].cpu().numpy()
        avg_lp = out["avg_logprob"].cpu().numpy()
        ns_prob = out["no_speech_prob"].cpu().numpy()
        sb = out["sample_begin"]

        seg_tokens: List[List[int]] = [[] for _ in range(n)]
        segments: List[List[Segment]] = [[] for _ in range(n)]
        # Stitch flags come from the ACTUAL plan (its last window may end
        # before seek + stride).
        last_seek: Dict[int, int] = {}
        for j, sk in plan:
            last_seek[j] = max(sk, last_seek.get(j, 0))
        for wi, (i, seek) in enumerate(plan):
            gen = []
            for t in tokens[wi, sb:]:
                if t == cfg.eot:
                    break
                gen.append(int(t))
            win_offset = seek / FRAMES_PER_SECOND
            window_frames = min(wf, content_frames[i] - seek)
            if (float(ns_prob[wi]) > self.NO_SPEECH_THRESHOLD
                    and float(avg_lp[wi]) < self.LOGPROB_THRESHOLD):
                continue  # silence window (no-speech skip)
            segs, gen, _ = self._parse_window(
                gen, win_offset, window_sec=window_frames / FRAMES_PER_SECOND,
                keep_tail=True,
            )
            if overlap:
                segs = select_core_segments(
                    segs, win_offset, wf / FRAMES_PER_SECOND,
                    overlap / FRAMES_PER_SECOND, seek == 0,
                    seek == last_seek[i],
                )
            segments[i].extend(segs)
            seg_tokens[i].extend(gen)

        def item_text(i: int) -> str:
            # With overlap-stitching the transcript is the stitched
            # segments' text (raw tokens would repeat the overlap).
            if overlap:
                return "".join(s.text for s in segments[i]).strip()
            return self.tokenizer.decode(seg_tokens[i]).strip()

        results = [
            TranscriptionResult(
                text=item_text(i), segments=segments[i],
                language=params.language, tokens=list(seg_tokens[i]),
            )
            for i in range(n)
        ]
        self._time("finalize", time.perf_counter() - t0)
        return results

    def _parse_window(
        self,
        gen_tokens: List[int],
        offset_sec: float,
        window_sec: float = 30.0,
        keep_tail: bool = False,
    ) -> Tuple[List[Segment], List[int], int]:
        """Split decoded tokens at consecutive-timestamp pairs into segments
        (whisper.cpp result_len / OpenAI transcribe-loop semantics).

        Returns (segments, kept tokens, seek advance in mel frames; 0 =
        advance the full window). keep_tail=True keeps trailing tokens after
        the last pair as an open segment (fixed-stride parallel windows)."""
        ts_begin = self.cfg.timestamp_begin
        tok = self.tokenizer
        is_ts = [t >= ts_begin for t in gen_tokens]
        consecutive = [
            k + 1
            for k in range(len(gen_tokens) - 1)
            if is_ts[k] and is_ts[k + 1]
        ]
        single_ts_ending = len(gen_tokens) >= 2 and not is_ts[-2] and is_ts[-1]
        segs: List[Segment] = []

        def emit(sl: List[int]) -> None:
            if not sl:
                return
            start_t = (sl[0] - ts_begin) * 0.02 if sl[0] >= ts_begin else 0.0
            end_t = ((sl[-1] - ts_begin) * 0.02 if sl[-1] >= ts_begin
                     else window_sec)
            end_t = max(end_t, start_t)  # open tail may out-run window_sec
            segs.append(Segment(
                start=offset_sec + start_t, end=offset_sec + end_t,
                text=tok.decode([t for t in sl if t < ts_begin]),
            ))

        if consecutive:
            slices = list(consecutive)
            if single_ts_ending or (keep_tail and consecutive[-1] < len(gen_tokens)):
                slices.append(len(gen_tokens))
            last = 0
            for cur in slices:
                emit(gen_tokens[last:cur])
                last = cur
            kept = list(gen_tokens[:last])
            if single_ts_ending or keep_tail:
                advance = 0
            else:
                last_ts_pos = gen_tokens[last - 1] - ts_begin
                advance = int(last_ts_pos * 0.02 * FRAMES_PER_SECOND)
        else:
            # No consecutive pair: the whole window is one segment.
            ts = [t for t in gen_tokens if t >= ts_begin]
            end = window_sec
            if ts and ts[-1] != ts_begin:
                end = (ts[-1] - ts_begin) * 0.02
            text_toks = [t for t in gen_tokens if t < ts_begin]
            if text_toks:
                segs.append(Segment(start=offset_sec, end=offset_sec + end,
                                    text=tok.decode(text_toks)))
            kept = list(gen_tokens)
            advance = 0
        return segs, kept, advance
