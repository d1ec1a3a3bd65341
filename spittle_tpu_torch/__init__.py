"""PyTorch/CUDA port of spittle_tpu's batched Whisper transcription path.

The JAX package (spittle_tpu) is the reference; this package computes the
same functions with plain PyTorch ops and, on an NVIDIA Hopper card,
hand-written CUDA kernels (spittle_tpu_torch/csrc) in place of the
Pallas TPU kernels. It imports neither jax nor spittle_tpu.

Entry points: spittle_tpu_torch.engine.whisper_engine.WhisperEngine, and
the plain-PyTorch ParakeetEngine, SenseVoiceEngine and MoonshineEngine
(engine/parakeet_engine.py, sensevoice_engine.py, moonshine_engine.py).
Each runs on the card unless the caller passes device="cpu".
"""
