"""SenseVoice engine (port of spittle_tpu/engine/sensevoice_engine.py).

The request's language (zh/en/ja/ko/yue/auto) and use_itn pick the prompt
frames. Sources: `random:<config>` (models.sensevoice.model.CONFIGS,
seeded weights), a committed `.npz`, or a FunASR SenseVoiceSmall
directory: `model.safetensors` or `model.pt` (read with
torch.load(weights_only=True)), `am.mvn` and a `*.bpe.model`
SentencePiece model. Plain PyTorch ops in f32; no kernel of the port's
csrc runs here.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from spittle_tpu_torch.io.npz_checkpoint import load_family_npz
from spittle_tpu_torch.models.parakeet.features import HOP, parakeet_features
from spittle_tpu_torch.models.parakeet.nemo import sentencepiece_pieces
from spittle_tpu_torch.models.sensevoice.model import (
    CONFIGS,
    SenseVoiceConfig,
    ctc_collapse_ids,
    encode,
    lfr_stack,
    parse_kaldi_cmvn,
    prompt_ids_for,
    random_params,
)
from spittle_tpu_torch.models.sensevoice.weights import (
    config_from_funasr_tensors,
    params_from_funasr_tensors,
)
from spittle_tpu_torch.models.whisper.weights import load_safetensors
from spittle_tpu_torch.ops import full_f32

from ._family import FamilyEngine
from .base import Segment, TranscribeParams, TranscriptionResult
from .parakeet_engine import SentencePieceTable


class SenseVoiceEngine(FamilyEngine):
    def __init__(self, device="cuda", dtype=torch.float32,
                 use_itn: bool = True):
        super().__init__(device, dtype)
        self.use_itn = use_itn

    def load_model(self, model_path: str, seed: int = 0) -> None:
        if model_path.startswith("random:"):
            self.cfg = CONFIGS[model_path.split(":", 1)[1]]
            self.params = random_params(self.cfg, seed, self.dtype,
                                        self.device)
            self.table = SentencePieceTable.test_table(self.cfg.vocab_size)
            return
        if model_path.endswith(".npz"):
            self.cfg, tree, pieces = load_family_npz(model_path,
                                                     SenseVoiceConfig)
            self.params = self._tensors(tree)
            self.table = SentencePieceTable(pieces)
            return
        # FunASR SenseVoiceSmall release layout; config from tensor shapes.
        tensors = self._read_checkpoint(model_path)
        self.cfg = config_from_funasr_tensors(tensors)
        tree = params_from_funasr_tensors(tensors, self.cfg)
        mvn_path = os.path.join(model_path, "am.mvn")
        if os.path.exists(mvn_path):
            tree.update(parse_kaldi_cmvn(mvn_path) or {})
        self.params = self._tensors(tree)
        self.table = self._load_table(model_path)

    @staticmethod
    def _read_checkpoint(model_path: str):
        st = os.path.join(model_path, "model.safetensors")
        if os.path.exists(st):
            return load_safetensors(st)
        pt = os.path.join(model_path, "model.pt")
        if os.path.exists(pt):
            state = torch.load(pt, map_location="cpu", weights_only=True)
            return {k: v.numpy() for k, v in state.items()}
        raise FileNotFoundError(
            f"{model_path}: expected model.safetensors or model.pt"
        )

    @staticmethod
    def _load_table(model_path: str) -> SentencePieceTable:
        for name in sorted(os.listdir(model_path)):
            if name.endswith(".bpe.model") or name == "tokenizer.model":
                with open(os.path.join(model_path, name), "rb") as f:
                    return SentencePieceTable(sentencepiece_pieces(f.read()))
        return SentencePieceTable.load(model_path)

    def transcribe_batch(
        self,
        batch: Sequence[np.ndarray],
        params: Optional[TranscribeParams] = None,
    ) -> List[TranscriptionResult]:
        if not self.is_loaded:
            raise RuntimeError("no model loaded")
        params = params or TranscribeParams()
        language = params.language or "auto"
        audios, padded = self._padded(batch, HOP * 16)
        pids = np.tile(prompt_ids_for(self.cfg, language, self.use_itn),
                       (len(audios), 1))
        with torch.inference_mode(), full_f32():
            with self._stage("features"):
                mel = parakeet_features(padded, n_mels=self.cfg.n_mels)
                feats = lfr_stack(mel, self.cfg.lfr_m, self.cfg.lfr_n)
            with self._stage("encode"):
                logits = encode(self.params, feats,
                                torch.from_numpy(pids).to(self.device),
                                self.cfg)
            with self._stage("decode"):
                # The argmax on the device: only the [B, T] id matrix comes
                # to the host, not the [B, T, vocab] logits.
                ids = logits.argmax(dim=-1).cpu().numpy()
        decoded = ctc_collapse_ids(ids, self.cfg.blank_id, self.cfg.n_prompt)
        out = []
        for audio, toks in zip(audios, decoded):
            text = self.table.decode(toks)
            dur = len(audio) / 16000.0
            out.append(TranscriptionResult(
                text=text,
                segments=[Segment(0.0, dur, text)] if text else [],
                language=None if language == "auto" else language,
            ))
        return out
