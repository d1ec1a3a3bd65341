"""Parakeet FastConformer-TDT configuration (the port's copy of
spittle_tpu/models/parakeet/config.py, CONFIGS included).

The reference serves NVIDIA parakeet-tdt-0.6b v2/v3 through transcribe-rs
ONNX (`managers/transcription.rs:278-296,505-513`; catalog entries in
model_catalog.json). Hyperparameters follow the public NeMo FastConformer-XL
recipe for the 0.6B TDT models: 8x depthwise-separable conv subsampling,
24 conformer layers, d_model 1024, 8 heads, ff 4096, conv kernel 9,
relative positional attention; TDT prediction network LSTM(640) with a
joint producing vocab+blank plus a 5-way duration head (0..4 frames).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ParakeetConfig:
    name: str = "parakeet-tdt-0.6b"
    n_mels: int = 80  # 128 for NeMo's default? v2/v3 use 128-mel; see note
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 8
    ff_mult: int = 4
    conv_kernel: int = 9
    subsampling_factor: int = 8
    subsampling_channels: int = 256
    pred_hidden: int = 640
    pred_layers: int = 1
    joint_hidden: int = 640
    vocab_size: int = 1024  # SentencePiece BPE (v2 English)
    durations: int = 5  # TDT duration bins 0..4
    max_symbols_per_step: int = 10

    @property
    def blank_id(self) -> int:
        return self.vocab_size  # last joint logit is blank

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


CONFIGS = {
    "parakeet-tdt-0.6b-v2": ParakeetConfig(name="parakeet-tdt-0.6b-v2"),
    "parakeet-tdt-0.6b-v3": ParakeetConfig(
        name="parakeet-tdt-0.6b-v3", vocab_size=8192
    ),
    "parakeet-test": ParakeetConfig(
        name="parakeet-test", n_mels=80, d_model=64, n_layers=2, n_heads=4,
        ff_mult=2, conv_kernel=9, subsampling_channels=32, pred_hidden=32,
        joint_hidden=32, vocab_size=64,
    ),
}
