"""Audio device enumeration (Linux-first).

Port of spittle_tpu/shell/audio_devices.py.

Counterpart of the reference's cpal device listing
(`src-tauri/src/audio_toolkit/audio/device.rs`: CpalDeviceInfo with
index/name/is_default). Probes PipeWire/PulseAudio (`pactl`) first, then
ALSA (`arecord -l` / `aplay -l`); parsers are pure and tested against
captured output shapes.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class DeviceInfo:
    index: int
    name: str
    is_default: bool = False


def parse_pactl_sources(output: str, default_name: str = "") -> List[DeviceInfo]:
    """`pactl list short sources` lines: idx\tname\tmodule\tformat\tstate."""
    out = []
    for line in output.splitlines():
        parts = line.split("\t")
        if len(parts) >= 2 and parts[0].strip().isdigit():
            name = parts[1].strip()
            if name.endswith(".monitor"):
                continue  # loopbacks are outputs, not mics
            out.append(
                DeviceInfo(int(parts[0]), name, is_default=name == default_name)
            )
    return out


def parse_arecord_l(output: str) -> List[DeviceInfo]:
    """`arecord -l` card lines: 'card 0: NAME [desc], device 0: ...'."""
    out = []
    for m in re.finditer(
        r"card (\d+): (\S+) \[([^\]]+)\], device (\d+): ([^\[]+)", output
    ):
        card, _, desc, dev, devname = m.groups()
        out.append(
            DeviceInfo(
                index=int(card) * 100 + int(dev),
                name=f"{desc.strip()}: {devname.strip()} (hw:{card},{dev})",
            )
        )
    if out:
        out[0].is_default = True
    return out


def _run(cmd) -> Optional[str]:
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=5)
        if r.returncode == 0:
            return r.stdout.decode(errors="replace")
    except Exception:
        pass
    return None


def list_input_devices(which=shutil.which, run=_run) -> List[DeviceInfo]:
    if which("pactl"):
        default = (run(["pactl", "get-default-source"]) or "").strip()
        output = run(["pactl", "list", "short", "sources"])
        if output:
            devices = parse_pactl_sources(output, default)
            if devices:
                return devices
    if which("arecord"):
        output = run(["arecord", "-l"])
        if output:
            return parse_arecord_l(output)
    return []


def list_output_devices(which=shutil.which, run=_run) -> List[DeviceInfo]:
    if which("pactl"):
        default = (run(["pactl", "get-default-sink"]) or "").strip()
        output = run(["pactl", "list", "short", "sinks"])
        if output:
            return [
                DeviceInfo(d.index, d.name, d.name == default)
                for d in parse_pactl_sources(output)
            ]
    if which("aplay"):
        output = run(["aplay", "-l"])
        if output:
            return parse_arecord_l(output)
    return []
