"""What the Parakeet, SenseVoice and Moonshine engines share: the device
and dtype contract, the load state, padding a batch of PCM onto the
device, and the per-stage timers."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spittle_tpu_torch.device import resolve_device
from spittle_tpu_torch.models.whisper.weights import params_from_jax

from .base import TranscribeParams, TranscriptionResult, normalize_pcm


class FamilyEngine:
    """Runs on the card unless the caller passes device="cpu" (and raises
    without one). The families run in f32 only: their decisions (the TDT
    LSTM and joint argmaxes above all) flip at lower precision."""

    def __init__(self, device="cuda", dtype=torch.float32):
        if dtype != torch.float32:
            raise ValueError(f"{type(self).__name__} runs in torch.float32 "
                             f"only, not {dtype}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.cfg = None
        self.params = None
        self.table = None
        # Seconds per stage (features, encode, decode) summed over calls
        # since the caller last cleared it; decode-loop steps per batch.
        self.stage_seconds: Dict[str, float] = {}
        self.last_decode_steps: List[int] = []

    def unload_model(self) -> None:
        self.cfg = self.params = self.table = None

    @property
    def is_loaded(self) -> bool:
        return self.params is not None

    def transcribe_samples(
        self, samples: np.ndarray, params: Optional[TranscribeParams] = None
    ) -> TranscriptionResult:
        return self.transcribe_batch([samples], params)[0]

    def _tensors(self, tree):
        """A nested tree of numpy arrays -> tensors on the engine's device.
        Read-only arrays (views of a checkpoint file's buffer) are copied
        first, so no tensor aliases memory torch may not write."""
        def writable(node):
            if isinstance(node, dict):
                return {k: writable(v) for k, v in node.items()}
            return node if node.flags.writeable else np.array(node)

        return params_from_jax(writable(tree), device=self.device)

    def _padded(self, batch: Sequence[np.ndarray], min_len: int):
        """-> (the PCM as float32 numpy arrays, [B, max(longest, min_len)]
        f32 zero-padded batch on the device)."""
        audios = [normalize_pcm(a) for a in batch]
        padded = np.zeros((len(audios), max(max(len(a) for a in audios),
                                            min_len)), np.float32)
        for i, a in enumerate(audios):
            padded[i, : len(a)] = a
        return audios, torch.from_numpy(padded).to(self.device)

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Adds the stage's seconds to stage_seconds, the device's work
        included (it synchronizes on the card before and after)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_seconds[name] = (self.stage_seconds.get(name, 0.0)
                                    + time.perf_counter() - t0)
