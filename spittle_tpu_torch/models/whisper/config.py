"""Whisper model configurations (the port's copy of
spittle_tpu/models/whisper/config.py, kept in step with it).

Hyperparameters are the public OpenAI Whisper family settings; the model
catalog mapping follows the app's model catalog: small, medium,
large-v3-turbo ("turbo"), large-v3 ("large"), plus tiny/base for tests and
Breeze-ASR-25 (a large-v2 fine-tune).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    # Optional Switch-style top-1 MoE encoder FFN (research/fine-tune
    # variant; no published Whisper checkpoint uses it). 0 = dense. With
    # E experts the encoder MLP becomes a routed mixture whose expert
    # weights shard over the mesh's 'model' axis (expert parallelism,
    # parallel/expert_parallel.py).
    moe_experts: int = 0

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def multilingual(self) -> bool:
        return self.n_vocab >= 51865

    # Special-token layout (OpenAI Whisper tokenizer): after the byte-BPE
    # vocabulary come <|endoftext|>, <|startoftranscript|>, one token per
    # language, <|translate|>, <|transcribe|>, <|startoflm|>,
    # <|startofprev|>, <|nospeech|>, <|notimestamps|>, then 1501 timestamp
    # tokens <|0.00|>..<|30.00|> at 0.02 s steps. English-only models use
    # the same layout shifted down by one (eot=50256).

    @property
    def sot(self) -> int:
        return 50258 if self.multilingual else 50257

    @property
    def eot(self) -> int:
        return 50257 if self.multilingual else 50256

    @property
    def n_langs(self) -> int:
        # 99 languages for the 51864/51865 vocabs; large-v3 (51866) adds yue
        return self.n_vocab - self.sot - 1508

    @property
    def lang_begin(self) -> int:
        return self.sot + 1

    @property
    def translate(self) -> int:
        return self.sot + 1 + self.n_langs

    @property
    def transcribe(self) -> int:
        return self.translate + 1

    @property
    def sot_lm(self) -> int:
        return self.transcribe + 1

    @property
    def sot_prev(self) -> int:
        return self.transcribe + 2

    @property
    def no_speech(self) -> int:
        return self.transcribe + 3

    @property
    def no_timestamps(self) -> int:
        return self.transcribe + 4

    @property
    def timestamp_begin(self) -> int:
        # <|0.00|>; 1500 further tokens at 0.02 s steps follow
        return self.no_timestamps + 1


def _cfg(name, mels, state, head, layer, vocab, dec_layer=None):
    return WhisperConfig(
        name=name,
        n_mels=mels,
        n_audio_ctx=1500,
        n_audio_state=state,
        n_audio_head=head,
        n_audio_layer=layer,
        n_vocab=vocab,
        n_text_ctx=448,
        n_text_state=state,
        n_text_head=head,
        n_text_layer=layer if dec_layer is None else dec_layer,
    )


CONFIGS = {
    "tiny.en": _cfg("tiny.en", 80, 384, 6, 4, 51864),
    "tiny": _cfg("tiny", 80, 384, 6, 4, 51865),
    "base.en": _cfg("base.en", 80, 512, 8, 6, 51864),
    "base": _cfg("base", 80, 512, 8, 6, 51865),
    "small.en": _cfg("small.en", 80, 768, 12, 12, 51864),
    "small": _cfg("small", 80, 768, 12, 12, 51865),
    "medium.en": _cfg("medium.en", 80, 1024, 16, 24, 51864),
    "medium": _cfg("medium", 80, 1024, 16, 24, 51865),
    "large-v2": _cfg("large-v2", 80, 1280, 20, 32, 51865),
    # Breeze ASR 25 is a large-v2 fine-tune (reference catalog "breeze-asr")
    "breeze-asr": _cfg("breeze-asr", 80, 1280, 20, 32, 51865),
    "large-v3": _cfg("large-v3", 128, 1280, 20, 32, 51866),
    "large-v3-turbo": _cfg("large-v3-turbo", 128, 1280, 20, 32, 51866, dec_layer=4),
}

# Reference catalog id -> config name (model_catalog.json models[].id)
CATALOG_TO_CONFIG = {
    "small": "small",
    "medium": "medium",
    "turbo": "large-v3-turbo",
    "large": "large-v3",
    "breeze-asr": "breeze-asr",
}
