"""The code that builds edited copies of a kernel's source, on the CPU:
the development probe of K3/K4/K6's heads per item and K6's int4 slice
(probes/decode_cross_items.py) and the card tests' mutation check
(tests/test_torch_kernel_mutations.py). Every text they edit is still in
its source and each edit changes it, so that a run on the card times or
breaks what it names. The builds, timings and mutants run only on the
card.
"""

import re

import pytest

from spittle_tpu_torch.ops import _build
from spittle_tpu_torch.ops import attention as att
from spittle_tpu_torch.probes import decode_cross_items
from test_torch_kernel_mutations import MUTATIONS, REPO


@pytest.mark.parametrize("pattern,values", [
    (decode_cross_items._HEADS, decode_cross_items.HEADS),
    (decode_cross_items._SLICE, decode_cross_items.INT4_SLICES),
])
def test_decode_cross_items_settings_found(pattern, values):
    """kHeads and kInt4Slice are each set once in the source, to one of
    the values the probe times."""
    text = (_build.CSRC / "decode_cross_attention_mh.cu").read_text()
    assert len(re.findall(pattern, text)) == 1
    assert decode_cross_items.chosen(pattern) in values


def test_int4_slice_as_the_host_assumes():
    """The source's kInt4Slice is the slice the host sizes K6's partial
    records by (one position per byte)."""
    assert decode_cross_items.chosen(decode_cross_items._SLICE) == att.item_positions(1)


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_mutation_edits_still_apply(name):
    """Each mutant's edits name text still in its source (a source whose
    lines moved would leave the mutant failing for that reason alone)."""
    for rel, old, new in MUTATIONS[name][1]:
        assert old in (REPO / rel).read_text() and old != new, (name, rel)
