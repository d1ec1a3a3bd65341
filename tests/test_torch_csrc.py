"""The port's CUDA sources against the build's table of C entries, on the
CPU (no nvcc, no card): every entry of `_build.SIGNATURES` is exported by
exactly one `SPT_API int <name>(` in spittle_tpu_torch/csrc/*.cu, no
source exports an entry the table lacks (ctypes would never bind it), and
every source names in its header note the TPU kernel it replaces, as a
path under spittle_tpu/ or scripts/ that exists, and every quoted
#include names a header beside it (one that the build's source hash
covers). This keeps kernels that move between sources bound and
attributed, and shared code that moves into a header rebuilt.
"""

import re
from pathlib import Path

import pytest

from spittle_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted(_build.CSRC.glob("*.cu"))
HEADERS = sorted(_build.CSRC.glob("*.cuh"))
_INCLUDE = re.compile(r'#include\s+"([^"]+)"')
_EXPORT = re.compile(r"SPT_API\s+int\s+(\w+)\s*\(")
_TPU_PATH = re.compile(r"\b((?:spittle_tpu|scripts)/[\w/]+\.py)")


def _exports():
    found = {}
    for cu in SOURCES:
        for name in _EXPORT.findall(cu.read_text()):
            found.setdefault(name, []).append(cu.name)
    return found


def _header_note(cu: Path) -> str:
    lines = []
    for line in cu.read_text().splitlines():
        if not line.startswith("//"):
            break
        lines.append(line[2:])
    return "\n".join(lines)


def test_sources_present():
    assert SOURCES, f"no CUDA sources under {_build.CSRC}"


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_entry_exported_once(name):
    where = _exports().get(name, [])
    assert len(where) == 1, f"{name} is exported by {where or 'no source'}"


def test_no_unlisted_export():
    unlisted = sorted(set(_exports()) - set(_build.SIGNATURES))
    assert not unlisted, f"SPT_API entries missing from _build.SIGNATURES: {unlisted}"


@pytest.mark.parametrize("cu", SOURCES, ids=[p.name for p in SOURCES])
def test_header_names_the_tpu_kernel(cu):
    paths = _TPU_PATH.findall(_header_note(cu))
    assert paths, f"{cu.name}: the header note names no spittle_tpu/ or scripts/ path"
    missing = [p for p in paths if not (REPO / p).is_file()]
    assert not missing, f"{cu.name}: named paths not in the repo: {missing}"


@pytest.mark.parametrize("src", SOURCES + HEADERS,
                         ids=[p.name for p in SOURCES + HEADERS])
def test_local_includes_are_in_csrc(src):
    names = _INCLUDE.findall(src.read_text())
    missing = [n for n in names if not (_build.CSRC / n).is_file()]
    assert not missing, f"{src.name} includes {missing}, not in {_build.CSRC}"
    assert all(n.endswith(".cuh") for n in names), \
        f"{src.name}: a quoted include the source hash does not cover: {names}"
