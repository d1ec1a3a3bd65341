"""Probe: registers, spills and serialisation notes of every kernel the
port builds, from `nvcc -Xptxas -v` on each source in csrc/ (one nvcc per
source, all started together, the build's own flags).

Prints one JSON line per kernel instance (its mangled name, registers,
spill stores and loads in bytes, shared memory) and one per source with
any ptxas note on wgmma serialisation (C7510-C7520) or on setmaxnreg
being ignored (C7508).

    python -m spittle_tpu_torch.probes.ptxas_report [source.cu ...]

Runs where nvcc is (the card's machine); it needs no card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List

from spittle_tpu_torch.ops import _build

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")
_NOTE = re.compile(r"(C75(?:0[0-9]|1[0-9]|20))")


def parse(text: str) -> List[dict]:
    """One record per 'Compiling entry function' block of ptxas's output."""
    records, cur = [], None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"kernel": m.group(1)}
            records.append(cur)
            continue
        if cur is None:
            continue
        if (m := _SPILL.search(line)):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        if (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
            if (s := _SMEM.search(line)):
                cur["smem"] = int(s.group(1))
    return records


def main(names=None, out=print) -> List[dict]:
    cus = [p for p in sorted(_build.CSRC.glob("*.cu")) if not names or p.name in names]
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(cu, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(cu),
             "-o", str(Path(tmp) / (cu.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for cu in cus]
        for cu, p in procs:
            text, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cu.name}:\n{text}")
            for rec in parse(text):
                rec["source"] = cu.name
                results.append(rec)
                out(json.dumps(rec))
            notes = sorted(set(_NOTE.findall(text)))
            out(json.dumps({"source": cu.name, "ptxas_notes": notes}))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
