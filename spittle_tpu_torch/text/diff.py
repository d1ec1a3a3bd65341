"""Minimal text diff for post-processed replacement.

Port of spittle_tpu/text/diff.py.

Port of the reference's prefix/suffix diff used to patch already-pasted text
with the LLM-post-processed version using the fewest keystrokes
(`src-tauri/src/pipeline.rs:598-657`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TextDiff:
    """Minimal edit turning the original (visible) text into the processed one.

    suffix_chars: length of the common suffix the caret must move left over.
    delete_chars: characters of the original's changed middle region to delete.
    insert: replacement text typed in place of the deleted region.
    """

    suffix_chars: int
    delete_chars: int
    insert: str


def compute_text_diff(original: str, processed: str) -> Optional[TextDiff]:
    """Common-prefix/common-suffix diff; None if the texts are identical."""
    if original == processed:
        return None

    orig = list(original)
    proc = list(processed)

    prefix_len = 0
    for a, b in zip(orig, proc):
        if a != b:
            break
        prefix_len += 1

    max_suffix = min(len(orig), len(proc)) - prefix_len
    suffix_len = 0
    for a, b in zip(reversed(orig), reversed(proc)):
        if suffix_len >= max_suffix or a != b:
            break
        suffix_len += 1

    delete_chars = len(orig) - prefix_len - suffix_len
    insert = "".join(proc[prefix_len : len(proc) - suffix_len])
    return TextDiff(suffix_chars=suffix_len, delete_chars=delete_chars, insert=insert)


def apply_text_diff(original: str, diff: TextDiff) -> str:
    """Apply a TextDiff to a string buffer (used by tests and the replay
    harness; the desktop front end applies it with keystrokes instead)."""
    keep_prefix = len(original) - diff.suffix_chars - diff.delete_chars
    prefix = original[:keep_prefix]
    suffix = original[len(original) - diff.suffix_chars :] if diff.suffix_chars else ""
    return prefix + diff.insert + suffix
