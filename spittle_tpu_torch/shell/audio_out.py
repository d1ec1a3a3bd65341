"""Audio feedback playback: synthesized theme sounds + system player.

Port of spittle_tpu/shell/audio_out.py.

The reference plays bundled start/stop WAVs through rodio with a volume
setting and an optional output-device override
(`src-tauri/src/audio_feedback.rs:1-137`, themes
marimba/pop/custom). This module supplies the two pieces the round-1
port left as hooks:

- `synthesize_theme_sounds`: generates the marimba/pop start/stop WAVs
  (short synthesized tones — the reference bundles equivalent assets as
  resources; we synthesize so no binary assets ship in the repo),
- `system_player`: a real `player` callable for app.ui_state.
  AudioFeedback, probing paplay -> pw-play -> aplay -> afplay the same
  way textout.py probes typing tools, applying volume where the tool
  supports it and falling back to a pre-scaled temp WAV where it
  doesn't.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Callable, List, Optional

import numpy as np

from spittle_tpu_torch.audio.wav import load_wav_file, save_wav_file

SAMPLE_RATE = 16000


def _tone(freqs, amps, dur_s: float, decay: float,
          attack_s: float = 0.002) -> np.ndarray:
    """Struck-bar style tone: summed partials with exponential decay."""
    t = np.arange(int(SAMPLE_RATE * dur_s)) / SAMPLE_RATE
    x = sum(
        a * np.sin(2 * np.pi * f * t) * np.exp(-t * decay)
        for f, a in zip(freqs, amps)
    )
    attack = np.minimum(t / attack_s, 1.0)
    x = x * attack
    peak = np.max(np.abs(x)) or 1.0
    return (0.5 * x / peak).astype(np.float32)


def _marimba(base_hz: float) -> np.ndarray:
    # Marimba partials sit near 1 : 3.9 : 9.2 with fast upper decay.
    return _tone(
        [base_hz, base_hz * 3.9, base_hz * 9.2], [1.0, 0.4, 0.15],
        dur_s=0.28, decay=14.0,
    )


def _pop(base_hz: float) -> np.ndarray:
    # Short pitched blip with a downward chirp.
    t = np.arange(int(SAMPLE_RATE * 0.12)) / SAMPLE_RATE
    freq = base_hz * (1.0 - 0.35 * t / t[-1])
    phase = 2 * np.pi * np.cumsum(freq) / SAMPLE_RATE
    x = np.sin(phase) * np.exp(-t * 30.0)
    x = x * np.minimum(t / 0.001, 1.0)
    peak = np.max(np.abs(x)) or 1.0
    return (0.5 * x / peak).astype(np.float32)


THEME_SYNTH = {
    "marimba_start.wav": lambda: _marimba(660.0),   # E5, rising feel
    "marimba_stop.wav": lambda: _marimba(440.0),    # A4
    "pop_start.wav": lambda: _pop(900.0),
    "pop_stop.wav": lambda: _pop(600.0),
}


def synthesize_theme_sounds(resources_dir: str, force: bool = False) -> List[str]:
    """Write any missing theme WAVs into resources_dir; returns paths."""
    os.makedirs(resources_dir, exist_ok=True)
    out = []
    for name, gen in THEME_SYNTH.items():
        path = os.path.join(resources_dir, name)
        if force or not os.path.exists(path):
            save_wav_file(path, gen())
        out.append(path)
    return out


# -- player probing (textout.py tool-chain pattern) -------------------------

# (tool, volume argv builder or None). paplay takes 0..65536 linear;
# afplay takes -v 0..1; aplay/pw-play get a pre-scaled temp file.
_PLAYERS = (
    ("paplay", lambda v: [f"--volume={int(max(0.0, min(v, 1.0)) * 65536)}"]),
    ("pw-play", None),
    ("aplay", None),
    ("afplay", lambda v: ["-v", f"{max(0.0, min(v, 1.0)):.3f}"]),
)


def probe_player(which=shutil.which) -> Optional[str]:
    for tool, _vol in _PLAYERS:
        if which(tool):
            return tool
    return None


def _scaled_copy(path: str, volume: float) -> str:
    """Volume-scaled WAV at a DETERMINISTIC cache path per
    (source, volume, mtime): feedback plays hundreds of times per
    session, and a fresh mkstemp per play leaked one temp file per
    start/stop sound on the non-blocking path."""
    import hashlib

    try:
        mtime = int(os.stat(path).st_mtime)
    except OSError:
        mtime = 0
    key = hashlib.sha1(
        f"{os.path.abspath(path)}|{volume:.3f}|{mtime}".encode()
    ).hexdigest()[:16]
    tmp = os.path.join(
        tempfile.gettempdir(), f"spittle_fb_{key}.wav"
    )
    if not os.path.exists(tmp):
        samples, sr = load_wav_file(path)
        save_wav_file(tmp, (samples * max(0.0, min(volume, 1.0))).astype(
            np.float32), sr)
    return tmp


def build_player_cmd(tool: str, path: str, volume: float):
    """(argv, temp_path_or_None) for one playback invocation."""
    vol_args = dict(_PLAYERS)[tool]
    if vol_args is not None or volume >= 0.999:
        argv = [tool] + (vol_args(volume) if vol_args else []) + [path]
        return argv, None
    tmp = _scaled_copy(path, volume)
    return [tool, tmp], tmp


def system_player(
    run=subprocess.run, which=shutil.which, blocking: bool = False
) -> Optional[Callable[[str, float], None]]:
    """A `player(path, volume)` callable for AudioFeedback, or None when
    no playback tool exists (headless CI — AudioFeedback keeps working,
    recording plays in `.played`)."""
    tool = probe_player(which)
    if tool is None:
        return None

    def play(path: str, volume: float) -> None:
        # build_player_cmd's scaled copy is a deterministic
        # per-(sound, volume) cache file reused across plays — it is
        # intentionally NOT unlinked (a non-blocking player may still
        # be reading it).
        argv, _tmp = build_player_cmd(tool, path, volume)
        if blocking:
            run(argv, capture_output=True, timeout=10)
        else:
            subprocess.Popen(
                argv, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
            )

    return play
