"""Whisper engine: transcription on the card (port of
spittle_tpu/engine/whisper_engine.py).

What the port carries: `random:<config>` models and checkpoints (whisper.cpp
GGML files with their own mel filterbank and vocabulary, HF safetensors
directories read without the safetensors package, spittle .npz files,
tokenizer files beside a checkpoint that embeds no vocabulary, and an
alignment_heads.json sidecar), the mu-law or int16 PCM wire, the W8A8 encoder, the bf16/f32 decoder or the
weight-only int8 decoder with int8, int4 or "w8a8" cross-K/V
(quantize_decoder; "w8a8" runs both cross-attention products int8 x int8,
K14 on the card) and an int8 self-cache (quantize_cache), speculative
decoding at temperature 0 with a draft model (load_draft_model) or a
layer subset of the main decoder (load_self_draft), the encoder-attention forms
(encoder_attention), `transcribe_samples` (the dictation app's call) and
`transcribe_batch` over the sequential seek loop (timestamp-guided seeks,
the no-speech skip, a single item's prompt carry) or parallel windows
with overlap-stitch, the pipelined `transcribe_stream` (prefetch thread,
overlap_fetch), the serving seam `stage_batch`/`transcribe_staged`, the
VAD-gated `transcribe_vad_segments`, language detection, the temperature ladder (greedy at 0, or beam
search under TranscribeParams.beam_size, sampled above it, gated on
compression ratio and avg_logprob), word timestamps (cross-attention DTW)
on both paths and suppress_non_speech. A window is two mel frames per encoder position:
30 s for the stock 1500 positions, longer for a model with a larger
n_audio_ctx (past 4096 positions the encoder's self-attention runs K5),
shorter under TranscribeParams.audio_ctx (a push-to-talk utterance).

The engine runs on the card by default (device="cuda") and raises when
there is none; the CPU is used only when the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
import os
import queue as _queue
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from spittle_tpu_torch.audio.mel import HOP_LENGTH, log_mel_spectrogram
from spittle_tpu_torch.audio.mulaw import mulaw_decode, mulaw_encode
from spittle_tpu_torch.audio.vad.segmenter import segment_speech
from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.models.whisper.alignment import (
    load_alignment_heads,
    word_timestamps,
)
from spittle_tpu_torch.models.whisper.beam import beam_decode
from spittle_tpu_torch.models.whisper.config import CONFIGS, WhisperConfig
from spittle_tpu_torch.models.whisper.decode import (
    DecodeOptions,
    detect_language,
    greedy_decode,
)
from spittle_tpu_torch.models.whisper.model import encode, sinusoidal_positions
from spittle_tpu_torch.models.whisper.speculative import speculative_greedy_decode
from spittle_tpu_torch.models.whisper.tokenizer import (
    WhisperTokenizer,
    load_tokenizer,
    make_test_vocab,
    non_speech_tokens,
)
from spittle_tpu_torch.models.whisper.weights import (
    cast_params,
    load_params,
    params_from_jax,
    random_params,
)
from spittle_tpu_torch.ops import full_f32
from spittle_tpu_torch.ops.attention import check_encoder_attention
from spittle_tpu_torch.ops.quant import (
    quantize_whisper_decoder,
    quantize_whisper_encoder_w8a8,
)
from spittle_tpu_torch.parallel.multihost import global_batch_from_local

from .base import (
    Segment,
    TranscribeParams,
    TranscriptionResult,
    Word,
    normalize_pcm,
)

FRAMES_PER_SECOND = 100
# The config attributes a loaded draft must share with the main model.
DRAFT_ATTRS = ("n_vocab", "sot", "eot", "timestamp_begin", "lang_begin",
               "n_audio_ctx")


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

    # The reference engine's quality-gated temperature ladder
    # (whisper.cpp's fallback) and no-speech gate.
    FALLBACK_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    COMPRESSION_RATIO_THRESHOLD = 2.4
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
        suppress_non_speech: bool = False,
    ):
        """device: "cuda" (default; raises without a card) or "cpu".
        dtype: compute dtype of the weights (layer norms stay f32); by
        default bf16 on the card, whose attention kernels take bf16, and
        f32 on the CPU. An f32 model whose attention shapes reach a kernel
        raises on the card.
        quantize_encoder: W8A8 int8 encoder GEMMs (kernel K2 on the card).
        quantize_decoder: False, True or "int8", "int4" or "w8a8":
        weight-only int8 decoder block weights, and cross-attention K/V
        quantized to int8 (K3 on the card), int4 packed two per byte (K6),
        or int8 with both cross-attention products int8 x int8, q and P
        quantized per row ("w8a8": K14 on the card, at every row count;
        beam search takes plain int8, K3, as the reference). word_timestamps
        is refused under a quantized decoder (ValueError): the reference's
        alignment pass cannot take its int8 weights.
        quantize_cache: int8 self-attention cache, one scale per position.
        wire: "auto" ships the input's own PCM dtype host->device; "mulaw"
        ships 8-bit mu-law codes, decoded on the device.
        encoder_attention: the encoder self-attention form, which the
        reference takes from the environment: "fullkv" (K1 on the card),
        "q8" (int8 products, K7; SPITTLE_ATTN_Q8=1), "packed" (K8;
        SPITTLE_PACKED_ATTENTION=1), "pair" (K9;
        SPITTLE_PACKED_ATTENTION=pair) or "pipe" (K10; SPITTLE_ATTN_PIPE=1).
        Anything else raises ValueError. It may be changed between
        batches.
        suppress_non_speech: suppress the non-speech symbol tokens
        (whisper.cpp's suppress_non_speech_tokens, off there too)."""
        self.device = resolve_device(device)
        self.encoder_attention = encoder_attention
        if wire not in ("auto", "mulaw"):
            raise ValueError(f"wire must be 'auto' or 'mulaw', got {wire!r}")
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.dtype = dtype
        if quantize_decoder is True:
            quantize_decoder = "int8"
        if quantize_decoder not in (False, "int8", "int4", "w8a8"):
            raise ValueError(
                "quantize_decoder must be False, True/'int8', 'int4' or "
                f"'w8a8', got {quantize_decoder!r}")
        self.quantize_encoder = quantize_encoder
        self.quantize_decoder = quantize_decoder
        self.quantize_cache = quantize_cache
        self.wire = wire
        self.suppress_non_speech = suppress_non_speech
        self.cfg: Optional[WhisperConfig] = None
        self.params = None
        # The encoder's position table on the device, made once per model.
        self._positions: Optional[torch.Tensor] = None
        self.tokenizer: Optional[WhisperTokenizer] = None
        self._space_token: Optional[int] = None
        self._non_speech: Optional[Tuple[int, ...]] = None
        # Per model: a GGML file's own mel filterbank on the device (None:
        # librosa's), and the DTW heads of an alignment_heads.json sidecar
        # (None: the upper half of the decoder layers).
        self.mel_filters: Optional[torch.Tensor] = None
        self.alignment_heads: Optional[List[Tuple[int, int]]] = None
        # Speculative decoding's draft (load_draft_model, load_self_draft):
        # its config and weights, whether it is the main model's own layer
        # subset (which shares the main encoder's output), and the mean
        # rounds / accepted positions / emitted tokens of the latest
        # speculative decode.
        self.draft_cfg: Optional[WhisperConfig] = None
        self.draft_params = None
        self._self_draft = False
        self.last_spec_stats: Optional[Dict[str, float]] = None
        self._copy_stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        # Wall seconds per stage of the most recent batches (frontend =
        # mel + encoder; decode = language detection and every rung of the
        # ladder: cross-K/V, prefill, decode loop, fetch and gates;
        # finalize = parse and stitch; align = its word-timestamp passes,
        # counted in finalize too), summed until reset.
        self.stage_seconds: Dict[str, float] = {}
        # Per decode call (each rung of each window batch): the steps run
        # after the prefill and the prefix rows (beam_size x the prefix
        # under beam search); per window batch: the rungs of the ladder it
        # took. Appended until reset.
        self.last_decode_steps: List[int] = []
        self.last_prefix_rows: List[int] = []
        self.last_decode_rungs: List[int] = []
        # A device mesh (parallel/mesh.py) over whose first ("data") dim the
        # parallel-windows path splits its window batches; the weights stay
        # whole on every rank, as the reference's engine keeps them. Every
        # rank of the mesh must make the same calls (parallel/serving.py's
        # follow loop does so behind a server).
        self.mesh = None

    # -- lifecycle -------------------------------------------------------

    def load_model(self, model_path: str, seed: int = 0) -> None:
        """`random:<config>` (numpy-seeded weights), a whisper.cpp GGML
        file, an HF safetensors directory or a spittle .npz. A checkpoint
        that embeds no vocabulary takes the tokenizer files beside it
        (load_tokenizer); a GGML file's mel filterbank replaces librosa's;
        an alignment_heads.json beside the weights sets the DTW heads."""
        # Every per-model cache is reset: a reload must not keep the last
        # model's filterbank, suppression ids, heads or positions.
        self._non_speech = None
        self.mel_filters = None
        self.alignment_heads = None
        self._positions = None
        if model_path.startswith("random:"):
            self.cfg = CONFIGS[model_path.split(":", 1)[1]]
            self.params = random_params(self.cfg, seed=seed, dtype=self.dtype,
                                        device=self.device)
            self.tokenizer = WhisperTokenizer(self.cfg, make_test_vocab())
        else:
            self.cfg, tree, extras = load_params(model_path)
            self.params = cast_params(params_from_jax(tree, device=self.device),
                                      self.dtype)
            if "mel_filters" in extras:
                self.mel_filters = torch.from_numpy(extras["mel_filters"]).to(
                    self.device)
            if "vocab" in extras:
                vocab = {tok: i for i, tok in enumerate(extras["vocab"])}
                self.tokenizer = WhisperTokenizer(self.cfg, vocab)
            else:
                self.tokenizer = load_tokenizer(
                    self.cfg, model_path if os.path.isdir(model_path)
                    else os.path.dirname(model_path))
            self.alignment_heads = load_alignment_heads(model_path)
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

    def unload_model(self) -> None:
        self.cfg = None
        self.params = None
        self._positions = None
        self.tokenizer = None
        self._space_token = None
        self._non_speech = None
        self.mel_filters = None
        self.alignment_heads = None
        self.draft_cfg = None
        self.draft_params = None
        self._self_draft = False

    def load_draft_model(self, model_path: str) -> None:
        """A draft Whisper for speculative decoding: `random:<config>`
        (numpy-seeded weights, seed 1) or a checkpoint, in the engine's
        dtype, unquantized. It must share the main model's token table and
        audio context (DRAFT_ATTRS; ValueError otherwise). Greedy decodes
        at temperature 0 then verify draft tokens four at a time and still
        give the main model's transcript. The draft encodes each window
        itself, with librosa's filterbank at its own n_mels."""
        if not self.is_loaded:
            raise RuntimeError("load the main model before the draft")
        if model_path.startswith("random:"):
            draft_cfg = CONFIGS[model_path.split(":", 1)[1]]
            draft_params = random_params(draft_cfg, seed=1, dtype=self.dtype,
                                         device=self.device)
        else:
            draft_cfg, tree, _ = load_params(model_path)
            draft_params = cast_params(params_from_jax(tree, device=self.device),
                                       self.dtype)
        for attr in DRAFT_ATTRS:
            if getattr(self.cfg, attr) != getattr(draft_cfg, attr):
                raise ValueError(f"draft incompatible with main model on {attr}")
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self._self_draft = False

    def load_self_draft(self, stride: int = 2) -> None:
        """A layer-dropped self-draft for speculative decoding: the main
        decoder's blocks 0, stride, 2*stride, ... and always the last, as
        the main model holds them (quantized or not), sharing its
        embeddings, final norm, encoder and the encoder's output (no
        second encode)."""
        if not self.is_loaded:
            raise RuntimeError("load the main model first")
        n = self.cfg.n_text_layer
        idx = sorted(set(range(0, n, max(stride, 1))) | {n - 1})
        take = torch.tensor(idx, device=self.device)

        def pick(node):
            if isinstance(node, dict):
                return {k: pick(v) for k, v in node.items()}
            return node.index_select(0, take)

        dec = dict(self.params["decoder"])
        dec["blocks"] = pick(dec["blocks"])
        self.draft_params = {**self.params, "decoder": dec}
        self.draft_cfg = dataclasses.replace(
            self.cfg, name=f"{self.cfg.name}-selfdraft{stride}",
            n_text_layer=len(idx))
        self._self_draft = True

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
        # The reference's alignment pass multiplies by the decoder's
        # weights as plain arrays, and a quantized decoder's are int8
        # dicts: it raises TypeError there, so the port computes nothing.
        if params.word_timestamps and self.quantize_decoder:
            raise ValueError(
                "word_timestamps needs an unquantized decoder: the alignment "
                f"pass cannot take quantize_decoder={self.quantize_decoder!r}")

    def _decode_options(self, params: TranscribeParams) -> DecodeOptions:
        suppress: Tuple[int, ...] = ()
        if self.suppress_non_speech:
            if self._non_speech is None:
                self._non_speech = non_speech_tokens(self.tokenizer)
            suppress = self._non_speech
        return DecodeOptions(
            task="translate" if params.translate else "transcribe",
            language=params.language,
            space_token=self._space_token,
            suppress_tokens=suppress,
            max_tokens=params.max_tokens or self.cfg.n_text_ctx // 2,
            quant_kv=bool(self.quantize_decoder),
            quant_kv_bits=4 if self.quantize_decoder == "int4" else 8,
            quant_kv_w8a8=self.quantize_decoder == "w8a8",
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

    def _data_split(self, b: int) -> Optional[Tuple[int, int]]:
        """This rank's rows [lo, hi) of a batch of b windows split over the
        mesh's data dim; None without a mesh, or where the data dim does
        not divide b (the batch is then replicated, as the reference
        places it)."""
        if self.mesh is None:
            return None
        m = self.mesh.size(0)
        if b % m:
            return None
        r = self.mesh.get_local_rank(self.mesh.mesh_dim_names[0])
        return r * b // m, (r + 1) * b // m

    def _place_windows(self, windows: np.ndarray, split: bool = True):
        """Host->device transfer of a window batch: (rows, ready event).
        With a mesh (and split), only this rank's rows of the data dim
        (_data_split of the batch size, which the consumer works out
        again). On the card the copy runs from pinned memory on a side
        stream; the event orders it before the consumer's use
        (_windows_ready)."""
        rows = self._data_split(windows.shape[0]) if split else None
        host = torch.from_numpy(windows if rows is None
                                else windows[rows[0]:rows[1]])
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

    def _frontend(self, windows: torch.Tensor, split=None) -> torch.Tensor:
        """windows [B, samples] wire PCM on the device -> encoder output
        [B, samples / 320, D]: a window shorter than the model's encodes
        with the first positions. split: the windows are this rank's rows
        of the mesh's data dim; the global batch is assembled from every
        rank's rows (global_batch_from_local) so that the encoder computes
        the global function (a MoE encoder routes over the whole batch)."""
        mel = log_mel_spectrogram(_pcm_f32(windows), n_mels=self.cfg.n_mels,
                                  filters=self.mel_filters)
        if split is not None:
            mel = global_batch_from_local(mel, self.mesh)
        xa = encode(self.params, mel, self.cfg, self.encoder_attention,
                    self._positions)
        return xa.to_local() if split is not None else xa

    def _gather_rows(self, *arrays: np.ndarray) -> List[np.ndarray]:
        """Every data rank's rows of each array, concatenated in rank order
        (all_gather over the mesh's data dim); arrays of tokens are padded
        with EOT to the longest rank's length first."""
        group = self.mesh.get_group(self.mesh.mesh_dim_names[0])
        m = self.mesh.size(0)
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            if t.dim() == 2:
                n = torch.tensor([t.shape[1]], device=self.device)
                lens = [torch.empty_like(n) for _ in range(m)]
                dist.all_gather(lens, n, group=group)
                width = int(max(int(x) for x in lens))
                t = torch.nn.functional.pad(t, (0, width - t.shape[1]),
                                            value=self.cfg.eot)
            parts = [torch.empty_like(t) for _ in range(m)]
            dist.all_gather(parts, t, group=group)
            out.append(torch.cat(parts).cpu().numpy())
        return out

    def _draft_frontend(self, windows: torch.Tensor, xa: torch.Tensor):
        """The draft's encoder output for the same windows: None without a
        draft, xa itself for a self-draft, else the draft's own encode of
        its own mel (its n_mels, librosa's filterbank: a GGML file's
        filters are not used, as in the reference)."""
        if self.draft_params is None:
            return None
        if self._self_draft:
            return xa
        mel = log_mel_spectrogram(_pcm_f32(windows), n_mels=self.draft_cfg.n_mels)
        return encode(self.draft_params, mel, self.draft_cfg, self.encoder_attention)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- transcription ---------------------------------------------------

    def transcribe_samples(self, samples,
                           params: Optional[TranscribeParams] = None
                           ) -> TranscriptionResult:
        """One utterance (the dictation app's call): transcribe_batch of
        one item."""
        return self.transcribe_batch([samples], params)[0]

    def transcribe_batch(self, batch: Sequence[np.ndarray],
                         params: Optional[TranscribeParams] = None
                         ) -> List[TranscriptionResult]:
        """Batched long-form transcription. Each item is 16 kHz mono PCM
        (float32 in [-1, 1] or int16) of any length. By default the
        sequential seek loop: all items' current windows decode as one
        batch, then items with audio left re-enter the next round at their
        timestamp-guided seeks, a single item conditioned on its text so
        far. parallel_windows decodes every window of every item in one
        batch instead (condition_on_previous_text must be off)."""
        if not self.is_loaded:
            raise RuntimeError("no model loaded")
        params = params or TranscribeParams()
        self._check_params(params)
        audios = [_as_audio(a) for a in batch]
        if not params.parallel_windows:
            return self._transcribe_sequential(audios, params,
                                               self._base_prompt(params))
        if params.condition_on_previous_text:
            raise ValueError(
                "parallel_windows requires condition_on_previous_text=False "
                "(windows decode independently)")
        return self.transcribe_staged(self.stage_batch(audios, params))

    def stage_batch(self, batch, params: Optional[TranscribeParams] = None):
        """Host + transfer half of a batched transcription: the window
        plan, the PCM assembly and the host->device copy (pinned, on the
        side stream), everything a stager thread can do while the previous
        batch computes. Returns the handle transcribe_staged takes,
        (audios, (plan, placed, content_frames, overlap), params), or None
        when the params need the sequential path (prompt carry, or not
        parallel_windows), which cannot be staged."""
        params = params or TranscribeParams()
        if not params.parallel_windows or params.condition_on_previous_text:
            return None
        if not self.is_loaded:
            raise RuntimeError("no model loaded")
        self._check_params(params)
        return self._stage(batch, params)

    def _stage(self, batch, params: TranscribeParams):
        """The parallel-windows plan of `batch`, assembled and placed."""
        audios = [_as_audio(a) for a in batch]
        plan, windows, content_frames, overlap = self._plan_parallel_windows(
            audios, params
        )
        staged = (plan, self._place_windows(windows), content_frames, overlap)
        return (audios, staged, params)

    def transcribe_staged(self, handle) -> List[TranscriptionResult]:
        """Compute half for a stage_batch handle: the device half, then the
        fetch, the ladder's other rungs, parse and stitch."""
        audios, staged, params = handle
        return self._finalize_parallel_windows(self._dispatch_parallel_windows(
            audios, params, self._base_prompt(params), staged
        ))

    def transcribe_vad_segments(self, audio, params: Optional[TranscribeParams] = None,
                                vad_params=None) -> TranscriptionResult:
        """Long-form transcription gated by the Silero + SmoothedVad chain:
        the buffer's speech spans (Silero over every 30 ms frame on the
        engine's device), all spans transcribed as one batch, the text
        stitched with absolute timestamps. vad_params: Silero weights
        (load_silero_params); by default the bundled ones on the engine's
        device."""
        audio = normalize_pcm(audio)
        spans = segment_speech(audio, params=vad_params, device=self.device)
        if not spans:
            return TranscriptionResult(text="")
        chunks = [audio[s.start_sample : s.end_sample] for s in spans]
        results = self.transcribe_batch(chunks, params)
        segments: List[Segment] = []
        texts = []
        words: List[Word] = []
        for span, res in zip(spans, results):
            if res.text:
                texts.append(res.text)
            for seg in res.segments:
                segments.append(Segment(start=seg.start + span.start_sec,
                                        end=seg.end + span.start_sec,
                                        text=seg.text))
            for w in res.words:
                words.append(Word(w.word, w.start + span.start_sec,
                                  w.end + span.start_sec))
        return TranscriptionResult(
            text=" ".join(texts).strip(),
            segments=segments,
            language=results[0].language if results else None,
            words=words,
        )

    def _words(self, gen, xa_row, prefix, window_frames: int,
                win_offset: float) -> List[Word]:
        """Word timings of one window's kept tokens `gen` (the alignment
        pass over xa_row [1, T, D], replaying `prefix`), shifted by the
        window's offset in seconds; timed as the "align" stage."""
        t0 = time.perf_counter()
        with full_f32():
            timings = word_timestamps(
                self.params, gen, xa_row, n_frames=window_frames // 2,
                cfg=self.cfg, tokenizer=self.tokenizer,
                prefix=tuple(int(t) for t in prefix), heads=self.alignment_heads)
        self._time("align", time.perf_counter() - t0)
        return [Word(w.word, w.start + win_offset, w.end + win_offset)
                for w in timings]

    def _transcribe_sequential(self, audios, params: TranscribeParams,
                               base_prompt) -> List[TranscriptionResult]:
        """The sequential seek loop (the reference's transcribe_batch
        without parallel_windows): per round the frontend over the active
        items' windows, language detection on round 0, the temperature
        ladder, parse, seek advance and the prompt carry."""
        cfg, tok = self.cfg, self.tokenizer
        n = len(audios)
        prompt_tokens = base_prompt
        seeks = [0] * n  # in mel frames
        wf, ws = self._window_geometry(params)
        content_frames = [max(1, len(a) // HOP_LENGTH) for a in audios]
        seg_tokens: List[List[int]] = [[] for _ in range(n)]
        segments: List[List[Segment]] = [[] for _ in range(n)]
        words: List[List[Word]] = [[] for _ in range(n)]
        languages: List[Optional[str]] = [params.language] * n
        lang_tokens: Optional[np.ndarray] = None  # [n], from round 0
        opts = self._decode_options(params)
        round_idx = 0
        while True:
            active = [i for i in range(n) if seeks[i] < content_frames[i]]
            if not active:
                break
            windows = self._assemble_windows(
                audios, [(i, seeks[i] * HOP_LENGTH) for i in active],
                window_samples=ws,
            )
            with torch.inference_mode(), full_f32():
                t0 = time.perf_counter()
                placed = self._windows_ready(self._place_windows(windows,
                                                                 split=False))
                xa = self._frontend(placed)
                draft_xa = self._draft_frontend(placed, xa)
                self._sync()
                t1 = time.perf_counter()
                lt = None
                if cfg.multilingual:
                    if params.language is None and round_idx == 0:
                        probs = detect_language(self.params, xa, cfg)
                        (det,) = self._fetch(probs.argmax(dim=-1))
                        lang_tokens = np.full(n, cfg.lang_begin, np.int64)
                        for bi, i in enumerate(active):
                            lang_tokens[i] = cfg.lang_begin + det[bi]
                            languages[i] = tok.lang_code(int(lang_tokens[i]))
                    if lang_tokens is not None:
                        lt = torch.from_numpy(lang_tokens[active]).to(self.device)
                out = self._decode_with_fallback(xa, opts, params, lt,
                                                 prompt_tokens, draft_xa=draft_xa)
            t2 = time.perf_counter()
            tokens = out["tokens"]
            sb = out["sample_begin"]
            for bi, i in enumerate(active):
                gen = []
                for t in tokens[bi, sb:]:
                    if t == cfg.eot:
                        break
                    gen.append(int(t))
                win_offset = seeks[i] / FRAMES_PER_SECOND
                window_frames = min(wf, content_frames[i] - seeks[i])
                # No-speech skip: a window that looks like silence with a
                # weak decode is dropped and the seek moves a full window.
                if (float(out["no_speech_prob"][bi]) > self.NO_SPEECH_THRESHOLD
                        and float(out["avg_logprob"][bi]) < self.LOGPROB_THRESHOLD):
                    seeks[i] += window_frames
                    continue
                segs, gen, advance = self._parse_window(
                    gen, win_offset, window_sec=window_frames / FRAMES_PER_SECOND,
                )
                if params.word_timestamps and gen:
                    words[i].extend(self._words(gen, xa[bi:bi + 1], tokens[bi, :sb],
                                                window_frames, win_offset))
                segments[i].extend(segs)
                seg_tokens[i].extend(gen)
                # Clamped to the encoded window: under audio_ctx the
                # timestamp vocabulary still spans the full window.
                seeks[i] += (min(advance, window_frames) if advance > 0
                             else window_frames)
            # Prompt carry: a single utterance's later windows condition
            # on the text decoded so far.
            if n == 1 and params.condition_on_previous_text and seg_tokens[0]:
                prompt_tokens = self._carried_prompt(base_prompt, seg_tokens[0])
            round_idx += 1
            self._time("frontend", t1 - t0)
            self._time("decode", t2 - t1)
            self._time("finalize", time.perf_counter() - t2)
        return [
            TranscriptionResult(
                text=tok.decode(seg_tokens[i]).strip(), segments=segments[i],
                language=languages[i], words=words[i], tokens=list(seg_tokens[i]),
            )
            for i in range(n)
        ]

    def _carried_prompt(self, base_prompt, seg_tokens) -> Tuple[int, ...]:
        """The next window's prompt: base prompt + text tokens so far,
        truncated to n_text_ctx/2 - 1, then from 32 tokens on cut to the
        last 32, 64, 128 or n_text_ctx/2 - 1 (the largest that fits: the
        reference's buckets, which bound its recompiles)."""
        cfg = self.cfg
        max_prompt = cfg.n_text_ctx // 2 - 1
        text_tokens = [t for t in seg_tokens if t < cfg.timestamp_begin]
        combined = (list(base_prompt) + text_tokens)[-max_prompt:]
        if len(combined) >= 32:
            k = max(bb for bb in (32, 64, 128, max_prompt) if bb <= len(combined))
            combined = combined[-k:]
        return tuple(combined)

    def transcribe_stream(self, batches, params=None, prefetch: int = 1,
                          overlap_fetch: bool = False):
        """Pipelined batched transcription. A producer thread plans and
        assembles batch k+1's windows and starts their host->device copy
        while batch k computes. Yields List[TranscriptionResult] per batch,
        in order. overlap_fetch: run batch k+1's device half (frontend,
        language detection, the ladder's first rung) before batch k's
        fetch, retries and parse (results still yield in order, one batch
        later). Always parallel windows; condition_on_previous_text must
        be off."""
        if not self.is_loaded:
            raise RuntimeError("no model loaded")
        params = params or TranscribeParams(
            parallel_windows=True, condition_on_previous_text=False
        )
        self._check_params(params)
        if params.condition_on_previous_text:
            raise ValueError(
                "transcribe_stream requires condition_on_previous_text=False "
                "(windows decode independently)")
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
                    if not _put(self._stage(batch, params)):
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
                audios, staged, _ = item
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
        """Device half: frontend, language detection on each item's first
        window (kept on the device: the codes are resolved at the fetch in
        _finalize_parallel_windows) and the ladder's first rung over every
        window. Under a mesh that splits the batch, this rank's rows only;
        each item's language is detected on the rank that holds its first
        window and summed over the data dim."""
        cfg = self.cfg
        plan, placed, content_frames, overlap = staged
        split = self._data_split(len(plan))
        lo, hi = split if split is not None else (0, len(plan))
        wf, _ = self._window_geometry(params)
        # full_f32: an f32 model's products and stem convolutions must
        # match the reference's f32 arithmetic, so TF32 stays off here.
        with torch.inference_mode(), full_f32():
            t0 = time.perf_counter()
            windows = self._windows_ready(placed)
            xa = self._frontend(windows, split)
            draft_xa = self._draft_frontend(windows, xa)
            self._sync()
            t1 = time.perf_counter()
            det = lt = None
            if cfg.multilingual and params.language is None:
                first = [next(w for w, (j, _) in enumerate(plan) if j == i)
                         for i in range(len(audios))]
                if split is None:
                    det = detect_language(self.params, xa[first], cfg).argmax(dim=-1)
                else:
                    mine = [i for i, w in enumerate(first) if lo <= w < hi]
                    det = torch.zeros(len(audios), dtype=torch.int64,
                                      device=xa.device)
                    if mine:
                        det[mine] = detect_language(
                            self.params, xa[[first[i] - lo for i in mine]],
                            cfg).argmax(dim=-1)
                    dist.all_reduce(det, group=self.mesh.get_group(
                        self.mesh.mesh_dim_names[0]))
                lt = cfg.lang_begin + det[[i for i, _ in plan[lo:hi]]]
            opts = self._decode_options(params)
            out0 = self._dispatch_decode(xa, opts, params, lt, base_prompt,
                                         draft_xa=draft_xa)
            self._sync()
            t2 = time.perf_counter()
        self._time("frontend", t1 - t0)
        self._time("decode", t2 - t1)
        return dict(out0=out0, xa=xa, draft_xa=draft_xa, opts=opts, lt=lt, det=det,
                    base_prompt=base_prompt, params=params, plan=plan,
                    content_frames=content_frames, overlap=overlap, wf=wf,
                    n=len(audios), split=split)

    def _finalize_parallel_windows(self, disp) -> List[TranscriptionResult]:
        """Host half: fetch the first rung and run the ladder's other
        rungs (timed as decode), resolve the language codes, then the
        no-speech skip, parse and stitch (timed as finalize)."""
        t0 = time.perf_counter()
        cfg = self.cfg
        params = disp["params"]
        plan = disp["plan"]
        content_frames = disp["content_frames"]
        overlap = disp["overlap"]
        wf = disp["wf"]
        n = disp["n"]
        languages: List[Optional[str]] = [params.language] * n
        if disp["det"] is not None:
            (det,) = self._fetch(disp["det"])
            languages = [self.tokenizer.lang_code(int(cfg.lang_begin + d))
                         for d in det]
        out = self._finish_decode(disp["out0"], disp["xa"], disp["opts"],
                                  params, disp["lt"], disp["base_prompt"],
                                  draft_xa=disp["draft_xa"])
        xa = disp["xa"]
        if disp["split"] is not None:
            # The caller gets every row: the data ranks' rows in rank order.
            out["tokens"], out["avg_logprob"], out["no_speech_prob"] = (
                self._gather_rows(out["tokens"], out["avg_logprob"],
                                  out["no_speech_prob"]))
            if params.word_timestamps:
                (xa,) = self._gather_rows(xa.float().cpu().numpy())
                xa = torch.from_numpy(xa).to(self.device, disp["xa"].dtype)
        t1 = time.perf_counter()
        self._time("decode", t1 - t0)
        tokens = out["tokens"]
        avg_lp = out["avg_logprob"]
        ns_prob = out["no_speech_prob"]
        sb = out["sample_begin"]

        seg_tokens: List[List[int]] = [[] for _ in range(n)]
        segments: List[List[Segment]] = [[] for _ in range(n)]
        words: List[List[Word]] = [[] for _ in range(n)]
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
            win_words = []
            if params.word_timestamps and gen:
                win_words = self._words(gen, xa[wi:wi + 1], tokens[wi, :sb],
                                        window_frames, win_offset)
            if overlap:
                # Segments and words alike keep what lies in the core.
                segs, win_words = (select_core_segments(
                    items, win_offset, wf / FRAMES_PER_SECOND,
                    overlap / FRAMES_PER_SECOND, seek == 0, seek == last_seek[i],
                ) for items in (segs, win_words))
            segments[i].extend(segs)
            words[i].extend(win_words)
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
                language=languages[i], words=words[i], tokens=list(seg_tokens[i]),
            )
            for i in range(n)
        ]
        self._time("finalize", time.perf_counter() - t1)
        return results

    # -- the temperature ladder ------------------------------------------

    @staticmethod
    def _compression_ratio(text: str) -> float:
        if not text:
            return 0.0
        raw = text.encode("utf-8")
        return len(raw) / len(zlib.compress(raw))

    def _tokens_to_text(self, row, sample_begin: int) -> str:
        gen = []
        for t in row[sample_begin:]:
            if t == self.cfg.eot:
                break
            gen.append(int(t))
        return self.tokenizer.decode(gen)

    def _fetch(self, *tensors: torch.Tensor) -> List[np.ndarray]:
        """One device->host fetch of several tensors: on the card, copies
        into pinned host memory queued on the current stream and one
        wait."""
        if self.device.type == "cpu":
            return [t.numpy() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in host]

    def _decode_once(self, xa, opts: DecodeOptions, params: TranscribeParams,
                     lt, prompt_tokens, draft_xa=None):
        """One rung over xa: at temperature 0 beam search when
        params.beam_size > 1, else speculative decoding when there is a
        draft (draft_xa, its encoder output), else greedy; sampled above 0
        (the reference's rule). Records the decode's steps (main-model
        passes under speculative decoding) and prefix rows (beam_size x
        the prefix under beam search)."""
        beams = params.beam_size if opts.temperature == 0.0 else 1
        with torch.inference_mode(), full_f32():
            if beams > 1:
                out = beam_decode(self.params, xa, self.cfg, opts,
                                  beam_size=beams, lang_tokens=lt,
                                  prompt_tokens=prompt_tokens)
            elif draft_xa is not None and opts.temperature == 0.0:
                out = speculative_greedy_decode(
                    self.params, self.draft_params, xa, draft_xa, self.cfg,
                    self.draft_cfg, opts, lang_tokens=lt,
                    prompt_tokens=prompt_tokens)
            else:
                out = greedy_decode(self.params, xa, self.cfg, opts,
                                    lang_tokens=lt, prompt_tokens=prompt_tokens)
        self.last_decode_steps.append(out["steps"])
        self.last_prefix_rows.append(max(beams, 1) * out["sample_begin"])
        return out

    def _decode_with_fallback(self, xa, opts, params, lt, prompt_tokens,
                              draft_xa=None):
        """Per-item retry ladder: a window whose decode looks degenerate
        (compression ratio > 2.4 or avg logprob < -1.0) re-decodes at the
        next temperature."""
        return self._finish_decode(
            self._dispatch_decode(xa, opts, params, lt, prompt_tokens,
                                  draft_xa=draft_xa),
            xa, opts, params, lt, prompt_tokens, draft_xa=draft_xa,
        )

    def _dispatch_decode(self, xa, opts, params, lt, prompt_tokens,
                         draft_xa=None):
        """The ladder's first rung, not fetched."""
        ladder = params.temperatures or self.FALLBACK_TEMPERATURES
        return self._decode_once(
            xa, dataclasses.replace(opts, temperature=ladder[0]), params, lt,
            prompt_tokens, draft_xa=draft_xa,
        )

    def _finish_decode(self, out, xa, opts, params, lt, prompt_tokens,
                       draft_xa=None):
        """Fetch the first rung and run the ladder's others: each rung
        past 0 re-decodes only the pending items (their rows of xa and
        lt), one fetch per rung. An item is accepted when its text's
        compression ratio is <= 2.4 and its avg_logprob >= -1.0; every
        rung overwrites the pending items' results, so an item that fails
        every rung keeps the last rung's. A speculative rung's mean rounds,
        accepted positions and emitted tokens go to last_spec_stats.
        Returns numpy "tokens", "avg_logprob", "no_speech_prob" and
        "sample_begin"."""
        n = xa.shape[0]
        best = None
        pending = list(range(n))
        ladder = params.temperatures or self.FALLBACK_TEMPERATURES
        rungs = 0
        for ri, temp in enumerate(ladder):
            if ri > 0:
                t_opts = dataclasses.replace(opts, temperature=temp)
                if len(pending) != n:
                    rows = torch.tensor(pending, device=xa.device)
                    out = self._decode_once(
                        xa[rows], t_opts, params,
                        lt[rows] if lt is not None else None, prompt_tokens,
                        draft_xa=draft_xa[rows] if draft_xa is not None else None)
                else:
                    out = self._decode_once(xa, t_opts, params, lt,
                                            prompt_tokens, draft_xa=draft_xa)
            rungs += 1
            spec = "rounds" in out
            fetched = self._fetch(out["tokens"], out["avg_logprob"],
                                  out["no_speech_prob"],
                                  *((out["length"],) if spec else ()))
            tokens, avg_lp, ns_prob = fetched[:3]
            if spec:
                self.last_spec_stats = {
                    "rounds": float(out["rounds"]),
                    "accepted_total": float(out["accepted_total"]),
                    "emitted": float(np.mean(fetched[3])),
                }
            sb = out["sample_begin"]
            if best is None:
                best = {"tokens": tokens.copy(), "avg_logprob": avg_lp.copy(),
                        "no_speech_prob": ns_prob.copy(), "sample_begin": sb}
            still = []
            for bi, item in enumerate(pending):
                text = self._tokens_to_text(tokens[bi], sb)
                ok = (self._compression_ratio(text)
                      <= self.COMPRESSION_RATIO_THRESHOLD
                      and avg_lp[bi] >= self.LOGPROB_THRESHOLD)
                best["tokens"][item] = tokens[bi]
                best["avg_logprob"][item] = avg_lp[bi]
                best["no_speech_prob"][item] = ns_prob[bi]
                if not ok:
                    still.append(item)
            pending = still
            if not pending:
                break
        self.last_decode_rungs.append(rungs)
        return best

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
