"""PyTorch/CUDA port of spittle_tpu's batched Whisper transcription path.

The JAX package (spittle_tpu) is the reference; this package computes the
same functions with plain PyTorch ops and, on an NVIDIA Hopper card,
hand-written CUDA kernels (spittle_tpu_torch/csrc) in place of the
Pallas TPU kernels. It imports neither jax nor spittle_tpu.

Entry point: spittle_tpu_torch.engine.whisper_engine.WhisperEngine, which
runs on the card unless the caller passes device="cpu".
"""
