"""Parakeet FastConformer-TDT engine (port of
spittle_tpu/engine/parakeet_engine.py).

load / unload / transcribe with a segment spanning the first and last
emission (80 ms encoder frames). v3 has no language head: the result's
`language` is the language of the decoded text (text.lang_id), or the
request's when the text is inconclusive. ParakeetForCTC checkpoints
decode greedily through the CTC head instead.

Sources: `random:<config>` (models.parakeet.config.CONFIGS, seeded
weights), a committed `.npz`, a NeMo `.nemo` archive, or a directory
holding `model.safetensors` (a ParakeetForCTC export, or a TDT tree in
the stacked layout under "/"-joined names) with `vocab.txt` or
`tokenizer.json` beside it. Plain PyTorch ops in f32; no kernel of the
port's csrc runs here.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from spittle_tpu_torch.io.npz_checkpoint import load_family_npz
from spittle_tpu_torch.models.parakeet.config import CONFIGS, ParakeetConfig
from spittle_tpu_torch.models.parakeet.decode import (
    ctc_greedy_decode,
    tdt_greedy_decode,
)
from spittle_tpu_torch.models.parakeet.features import HOP, parakeet_features
from spittle_tpu_torch.models.parakeet.model import encode, random_params
from spittle_tpu_torch.models.parakeet.nemo import load_nemo
from spittle_tpu_torch.models.parakeet.weights import (
    config_from_hf_ctc_tensors,
    config_from_tree,
    params_from_hf_ctc_tensors,
    unflatten,
)
from spittle_tpu_torch.models.whisper.weights import load_safetensors
from spittle_tpu_torch.ops import full_f32
from spittle_tpu_torch.text.lang_id import detect_language

from ._family import FamilyEngine
from .base import Segment, TranscribeParams, TranscriptionResult

SECONDS_PER_FRAME = 8 * HOP / 16000.0  # 80 ms per encoder frame


class SentencePieceTable:
    """Minimal SentencePiece piece table: id -> piece, '▁' = space."""

    def __init__(self, pieces: Sequence[str]):
        self.pieces = list(pieces)

    @classmethod
    def load(cls, model_dir: str) -> "SentencePieceTable":
        vocab_txt = os.path.join(model_dir, "vocab.txt")
        if os.path.exists(vocab_txt):
            with open(vocab_txt, encoding="utf-8") as f:
                return cls([line.rstrip("\n").split("\t")[0] for line in f])
        tok_json = os.path.join(model_dir, "tokenizer.json")
        if os.path.exists(tok_json):
            with open(tok_json, encoding="utf-8") as f:
                data = json.load(f)
            vocab = data.get("model", {}).get("vocab")
            if isinstance(vocab, list):
                return cls([p[0] for p in vocab])
            if isinstance(vocab, dict):
                inv = sorted(vocab.items(), key=lambda kv: kv[1])
                return cls([k for k, _ in inv])
        raise FileNotFoundError(f"no vocab.txt/tokenizer.json in {model_dir}")

    @classmethod
    def test_table(cls, n: int) -> "SentencePieceTable":
        pieces = [f"▁tok{i}" if i % 3 == 0 else f"tok{i}" for i in range(n)]
        return cls(pieces)

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            if 0 <= i < len(self.pieces):
                out.append(self.pieces[i])
        return "".join(out).replace("▁", " ").strip()


class ParakeetEngine(FamilyEngine):
    def __init__(self, device="cuda", dtype=torch.float32):
        super().__init__(device, dtype)
        self.mode = "tdt"  # or "ctc" (ParakeetForCTC checkpoints)

    def load_model(self, model_path: str, seed: int = 0) -> None:
        self.mode = "tdt"
        if model_path.startswith("random:"):
            self.cfg = CONFIGS[model_path.split(":", 1)[1]]
            self.params = random_params(self.cfg, seed, self.dtype,
                                        self.device)
            self.table = SentencePieceTable.test_table(self.cfg.vocab_size)
            return
        if model_path.endswith(".npz"):
            self.cfg, tree, pieces = load_family_npz(model_path,
                                                     ParakeetConfig)
            self.params = self._tensors(tree)
            self.table = SentencePieceTable(pieces)
            return
        if model_path.endswith(".nemo"):
            self.cfg, tree, pieces = load_nemo(model_path)
            self.params = self._tensors(tree)
            self.table = (SentencePieceTable(pieces) if pieces else
                          SentencePieceTable.load(
                              os.path.dirname(model_path) or "."))
            return
        st_path = os.path.join(model_path, "model.safetensors")
        if not os.path.exists(st_path):
            raise FileNotFoundError(
                f"{model_path}: no supported Parakeet checkpoint found "
                "(expected model.safetensors or a .nemo archive)"
            )
        raw = load_safetensors(st_path)
        if "ctc_head.weight" in raw:
            # HF ParakeetForCTC export: config inferred from shapes, CTC
            # greedy decode (blank = last id, NeMo convention).
            self.cfg = config_from_hf_ctc_tensors(raw)
            self.params = self._tensors(
                params_from_hf_ctc_tensors(raw, self.cfg))
            self.mode = "ctc"
        else:
            # A TDT tree in the stacked layout, "/"-joined names.
            tree = unflatten(raw)
            name = ("parakeet-tdt-0.6b-v3" if "v3" in model_path
                    else "parakeet-tdt-0.6b-v2")
            self.cfg = config_from_tree(tree, name)
            self.params = self._tensors(tree)
        self.table = SentencePieceTable.load(model_path)

    def transcribe_batch(
        self,
        batch: Sequence[np.ndarray],
        params: Optional[TranscribeParams] = None,
    ) -> List[TranscriptionResult]:
        if not self.is_loaded:
            raise RuntimeError("no model loaded")
        params = params or TranscribeParams()
        # At least 16 hops, so the conv subsampling sees full frames.
        audios, padded = self._padded(batch, HOP * 16)
        with torch.inference_mode(), full_f32():
            with self._stage("features"):
                feats = parakeet_features(padded, n_mels=self.cfg.n_mels)
            with self._stage("encode"):
                enc = encode(self.params, feats, self.cfg)
            lens = torch.tensor(
                [min(len(a) // HOP // 8 + 1, enc.shape[1]) for a in audios],
                device=self.device)
            with self._stage("decode"):
                if self.mode == "ctc":
                    id_lists = ctc_greedy_decode(self.params, enc, lens,
                                                 blank=self.cfg.vocab_size)
                else:
                    tokens, counts, frames, steps = tdt_greedy_decode(
                        self.params, enc, lens, self.cfg)
                    self.last_decode_steps.append(steps)
                    tokens, counts, frames = (tokens.cpu().numpy(),
                                              counts.cpu().numpy(),
                                              frames.cpu().numpy())
        results = []
        for i, audio in enumerate(audios):
            if self.mode == "ctc":
                text = self.table.decode(id_lists[i])
                segments = ([Segment(0.0, len(audio) / 16000.0, text)]
                            if text else [])
            else:
                ids = tokens[i, : counts[i]].tolist()
                text = self.table.decode(ids)
                segments = []
                if ids:
                    start = frames[i, 0] * SECONDS_PER_FRAME
                    end = frames[i, counts[i] - 1] * SECONDS_PER_FRAME
                    segments = [Segment(start=float(start), end=float(end),
                                        text=text)]
            results.append(TranscriptionResult(
                text=text, segments=segments,
                language=detect_language(text) or params.language))
        return results
