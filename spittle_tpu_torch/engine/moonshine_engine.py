"""Moonshine engine (port of spittle_tpu/engine/moonshine_engine.py).

Sources: `random:<config>` (models.moonshine.model.CONFIGS, seeded
weights), a committed `.npz`, or an HF directory holding
`model.safetensors` (MoonshineForConditionalGeneration names) with
`vocab.txt` or `tokenizer.json` beside it. The decode budget grows with
the audio: min(max_tokens, max(8, int(seconds * 7))) for the batch's
longest item. Plain PyTorch ops in f32; no kernel of the port's csrc
runs here.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from spittle_tpu_torch.io.npz_checkpoint import load_family_npz
from spittle_tpu_torch.models.moonshine.model import (
    CONFIGS,
    MoonshineConfig,
    encode,
    greedy_decode,
    random_params,
)
from spittle_tpu_torch.models.moonshine.weights import (
    config_from_hf_tensors,
    params_from_hf_tensors,
)
from spittle_tpu_torch.models.whisper.weights import load_safetensors
from spittle_tpu_torch.ops import full_f32

from ._family import FamilyEngine
from .base import Segment, TranscribeParams, TranscriptionResult
from .parakeet_engine import SentencePieceTable

MIN_SAMPLES = 1024  # the conv stem needs at least about one stem window


class MoonshineEngine(FamilyEngine):
    def load_model(self, model_path: str, seed: int = 0) -> None:
        if model_path.startswith("random:"):
            self.cfg = CONFIGS[model_path.split(":", 1)[1]]
            self.params = random_params(self.cfg, seed, self.dtype,
                                        self.device)
            self.table = SentencePieceTable.test_table(self.cfg.vocab_size)
            return
        if model_path.endswith(".npz"):
            self.cfg, tree, pieces = load_family_npz(model_path,
                                                     MoonshineConfig)
            self.params = self._tensors(tree)
            self.table = SentencePieceTable(pieces)
            return
        st = os.path.join(model_path, "model.safetensors")
        if not os.path.exists(st):
            raise FileNotFoundError(f"{model_path}: expected model.safetensors")
        tensors = load_safetensors(st)
        self.cfg = config_from_hf_tensors(tensors)
        self.params = self._tensors(params_from_hf_tensors(tensors, self.cfg))
        self.table = SentencePieceTable.load(model_path)

    def transcribe_batch(
        self,
        batch: Sequence[np.ndarray],
        params: Optional[TranscribeParams] = None,
    ) -> List[TranscriptionResult]:
        if not self.is_loaded:
            raise RuntimeError("no model loaded")
        audios, padded = self._padded(batch, MIN_SAMPLES)
        # Moonshine's budget scales with the audio (about 6.5 tokens/s).
        max_tok = min(self.cfg.max_tokens,
                      max(8, int(padded.shape[1] / 16000 * 7)))
        with torch.inference_mode(), full_f32():
            with self._stage("encode"):
                xa = encode(self.params, padded, self.cfg)
            with self._stage("decode"):
                tokens, lengths, steps = greedy_decode(self.params, xa,
                                                       self.cfg, max_tok)
                self.last_decode_steps.append(steps)
                tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
        out = []
        for i, audio in enumerate(audios):
            text = self.table.decode(tokens[i, : lengths[i]].tolist())
            dur = len(audio) / 16000.0
            out.append(TranscriptionResult(
                text=text,
                segments=[Segment(0.0, dur, text)] if text else [],
                language="en",
            ))
        return out
