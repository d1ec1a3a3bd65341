"""SpecAugment for fine-tuning (Park et al. 2019): port of
spittle_tpu/train/augment.py.

Frequency and time masking of the mel spectrogram, each batch element with
masks of its own. The numbers of masks are fixed; their widths and starts
are drawn from a torch.Generator (jax.random keys in the reference: the
same seed gives other numbers, so the tests hand both the same draws).
The masks are built by comparisons against an arange, not by scatter, and
masked cells take the per-sample mean unless a mask value is given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_bands(generator: torch.Generator, batch: int, length: int,
               max_width: int, n_masks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(widths, starts), each int64 [batch, n_masks] on the generator's
    device: a width uniform in [0, max_width], then a start uniform in
    [0, max(length - width, 1)), the reference's randint bounds."""
    dev = generator.device
    shape = (batch, n_masks)
    widths = torch.randint(0, max_width + 1, shape, generator=generator,
                           device=dev)
    hi = torch.clamp(length - widths, min=1)
    u = torch.rand(shape, generator=generator, device=dev, dtype=torch.float64)
    starts = torch.minimum((u * hi).long(), hi - 1)
    return widths, starts


def axis_mask(widths: torch.Tensor, starts: torch.Tensor,
              length: int) -> torch.Tensor:
    """[B, length] bool: True where masked, the union of each row's bands
    [start, start + width)."""
    idx = torch.arange(length, device=widths.device)
    bands = (idx >= starts[..., None]) & (idx < (starts + widths)[..., None])
    return bands.any(dim=1)


def spec_augment(generator: torch.Generator, mel: torch.Tensor,
                 freq_masks: int = 2, time_masks: int = 10,
                 freq_width: int = 27, time_frac: float = 0.05,
                 mask_value: Optional[float] = None) -> torch.Tensor:
    """mel [B, n_mels, T] with freq_masks frequency bands of width up to
    freq_width and time_masks time bands of width up to time_frac * T
    (adaptive masking, as in the NeMo / ESPnet recipes) set to mask_value,
    by default the per-sample mean (a log-mel of 0 would be a loud band).
    The draws are made on the generator's device, mel's as a rule."""
    b, n_mels, t = mel.shape
    max_t = max(int(t * time_frac), 1)
    if mask_value is None:
        fill = mel.mean(dim=(1, 2), keepdim=True)
    else:
        fill = torch.tensor(mask_value, dtype=mel.dtype, device=mel.device)
    fmask = axis_mask(*draw_bands(generator, b, n_mels, freq_width, freq_masks),
                      n_mels)
    tmask = axis_mask(*draw_bands(generator, b, t, max_t, time_masks), t)
    masked = (fmask[:, :, None] | tmask[:, None, :]).to(mel.device)
    return torch.where(masked, fill, mel)
