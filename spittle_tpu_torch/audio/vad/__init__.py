"""The Silero + SmoothedVad chain (port of spittle_tpu/audio/vad)."""

from .silero import SileroVad, load_silero_params, silero_forward
from .smoothed import SmoothedVad, VadFrame, smooth_probs

__all__ = [
    "SileroVad",
    "load_silero_params",
    "silero_forward",
    "SmoothedVad",
    "VadFrame",
    "smooth_probs",
]
