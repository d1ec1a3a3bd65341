"""Simplified/Traditional Chinese variant conversion (OpenCC subset).

Port of spittle_tpu/text/zh_convert.py.

Implements the two conversions the reference performs on transcripts
via ferrous_opencc (reference: src-tauri/src/pipeline.rs:929-967):

- `selected_language == "zh-Hans"` -> `BuiltinConfig::Tw2sp`
  (Traditional-TW, with phrases, -> Simplified) -> :func:`tw2sp`
- `selected_language == "zh-Hant"` -> `BuiltinConfig::S2twp`
  (Simplified -> Traditional-TW, with phrases) -> :func:`s2twp`

The conversion algorithm matches OpenCC's: greedy longest-match
segmentation over a merged phrase+character dictionary, with unmatched
characters passed through unchanged. Tables live in
:mod:`spittle_tpu_torch.text.zh_data` (hand-curated high-frequency subset —
see that module's docstring for coverage notes).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional, Tuple

from . import zh_data


def _char_pairs(lines) -> Dict[str, str]:
    table: Dict[str, str] = {}
    for line in lines:
        if len(line) % 2:
            raise ValueError(f"odd-length zh pair line: {line[:8]}...")
        for i in range(0, len(line), 2):
            table.setdefault(line[i], line[i + 1])
    return table


@lru_cache(maxsize=None)
def _tables() -> Tuple[Dict[str, str], int, Dict[str, str], int]:
    """Build (t2s_table, t2s_maxlen, s2t_table, s2t_maxlen) once."""
    t2s_chars = _char_pairs(zh_data._T2S_PAIR_LINES)

    # Simplified -> Traditional: invert the primary pairs (first listed
    # traditional form wins), then pin the ambiguous defaults.
    s2t_chars: Dict[str, str] = {}
    for trad, simp in t2s_chars.items():
        s2t_chars.setdefault(simp, trad)
    s2t_chars.update(zh_data.S2T_DEFAULTS)

    # Variant-only forms simplify but never invert (妳->你, 裏->里, ...).
    t2s_chars.update(_char_pairs(zh_data._T2S_ONLY_LINES))

    t2s: Dict[str, str] = dict(t2s_chars)
    # tw2sp phrases: localization vocabulary inverted + explicit guards.
    for simp, trad in zh_data.S2TW_LOCALIZATION.items():
        t2s[trad] = simp
    for simp, trad in zh_data.S2T_PHRASES.items():
        # Round-trip the disambiguation phrases so e.g. 頭髮 -> 头发 even
        # though the char tables already get it right, and 皇后 -> 皇后.
        t2s[trad] = simp
    t2s.update(zh_data.T2S_PHRASES)

    s2t: Dict[str, str] = dict(s2t_chars)
    s2t.update(zh_data.S2T_PHRASES)
    s2t.update(zh_data.S2TW_LOCALIZATION)

    # Identity mappings are dead weight for the matcher; drop them.
    t2s = {k: v for k, v in t2s.items() if k != v or len(k) > 1}
    s2t = {k: v for k, v in s2t.items() if k != v or len(k) > 1}

    t2s_max = max(map(len, t2s)) if t2s else 1
    s2t_max = max(map(len, s2t)) if s2t else 1
    return t2s, t2s_max, s2t, s2t_max


def _convert(text: str, table: Dict[str, str], max_len: int) -> str:
    out = []
    i, n = 0, len(text)
    while i < n:
        # Greedy longest match, OpenCC's segmentation rule.
        for length in range(min(max_len, n - i), 0, -1):
            rep = table.get(text[i : i + length])
            if rep is not None:
                out.append(rep)
                i += length
                break
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def s2twp(text: str) -> str:
    """Simplified -> Traditional (Taiwan standard, with phrases)."""
    _, _, s2t, s2t_max = _tables()
    return _convert(text, s2t, s2t_max)


def tw2sp(text: str) -> str:
    """Traditional (Taiwan) -> Simplified (with phrases)."""
    t2s, t2s_max, _, _ = _tables()
    return _convert(text, t2s, t2s_max)


def convert_chinese_variant(selected_language: str, text: str) -> Optional[str]:
    """The pipeline's `convert_chinese` hook (reference
    `maybe_convert_chinese_variant`, pipeline.rs:929-967): zh-Hans users
    get transcripts normalized to Simplified, zh-Hant users to
    Traditional-TW; any other language returns None (no conversion)."""
    if selected_language == "zh-Hans":
        return tw2sp(text)
    if selected_language == "zh-Hant":
        return s2twp(text)
    return None
