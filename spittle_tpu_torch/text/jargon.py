"""Jargon system: domain term dictionaries, prompt building, corrections.

Port of spittle_tpu/text/jargon.py.

Behavior-parity port of `src-tauri/src/jargon.rs`: seven
builtin profiles (term/correction data in config/data/jargon_profiles.json),
user packs, dictionary merging with custom-first casing priority, the
"Technical dictation" initial prompt capped at 1000 chars, and
regex corrections with protected-span masking (backticks, URLs, paths,
@refs, CLI flags).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

_DATA = os.path.join(
    os.path.dirname(__file__), "..", "config", "data", "jargon_profiles.json"
)


@dataclass(frozen=True)
class JargonCorrection:
    from_: str
    to: str


@dataclass
class JargonProfile:
    label: str
    terms: List[str] = field(default_factory=list)
    corrections: List[JargonCorrection] = field(default_factory=list)


@dataclass
class JargonSettings:
    enabled_profiles: List[str] = field(default_factory=list)
    custom_terms: List[str] = field(default_factory=list)
    custom_corrections: List[JargonCorrection] = field(default_factory=list)


@dataclass
class ActiveDictionary:
    terms: List[str] = field(default_factory=list)
    corrections: List[JargonCorrection] = field(default_factory=list)


@lru_cache(maxsize=1)
def builtin_profiles() -> Dict[str, JargonProfile]:
    with open(os.path.normpath(_DATA), encoding="utf-8") as f:
        raw = json.load(f)
    return {
        pid: JargonProfile(
            label=p["label"],
            terms=list(p["terms"]),
            corrections=[
                JargonCorrection(from_=c["from"], to=c["to"])
                for c in p["corrections"]
            ],
        )
        for pid, p in raw.items()
    }


def compute_active_dictionary(
    settings: JargonSettings,
    profiles: Dict[str, JargonProfile] | None = None,
) -> ActiveDictionary:
    """Merge custom + enabled-profile terms and corrections.

    Custom terms win on casing; profiles merge in alphabetical id order;
    custom corrections override profile corrections; corrections sort
    longest-from-first (ties alphabetical)."""
    profiles = builtin_profiles() if profiles is None else profiles

    terms_map: Dict[str, str] = {}
    for term in settings.custom_terms:
        terms_map[term.lower()] = term

    profile_ids = sorted(
        pid for pid in settings.enabled_profiles if pid in profiles
    )
    for pid in profile_ids:
        for term in profiles[pid].terms:
            terms_map.setdefault(term.lower(), term)

    terms: List[str] = []
    seen = set()
    for term in settings.custom_terms:
        key = term.lower()
        if key not in seen:
            seen.add(key)
            terms.append(terms_map[key])
    for pid in profile_ids:
        for term in profiles[pid].terms:
            key = term.lower()
            if key not in seen:
                seen.add(key)
                terms.append(terms_map[key])

    corrections_map: Dict[str, JargonCorrection] = {}
    for pid in profile_ids:
        for corr in profiles[pid].corrections:
            corrections_map[corr.from_.lower()] = corr
    for corr in settings.custom_corrections:
        corrections_map[corr.from_.lower()] = corr

    corrections = sorted(
        corrections_map.values(),
        key=lambda c: (-len(c.from_.encode()), c.from_),
    )
    return ActiveDictionary(terms=terms, corrections=corrections)


def build_initial_prompt(dictionary: ActiveDictionary) -> str:
    """"Technical dictation. Common terms: ..." capped at 1000 chars."""
    if not dictionary.terms:
        return ""
    prefix = "Technical dictation. Common terms: "
    suffix = "."
    available = 1000 - len(prefix) - len(suffix)
    parts: List[str] = []
    current = 0
    for term in dictionary.terms:
        addition = len(term) if not parts else len(term) + 2
        if current + addition > available:
            break
        parts.append(term)
        current += addition
    if not parts:
        return ""
    return f"{prefix}{', '.join(parts)}{suffix}"


_PROTECTED = re.compile(
    r"@[\w\-./]+"  # @tokens like @file.rs
    r"|`[^`]+`"  # backtick code
    r"|https?://\S+"  # URLs
    r"|(?:~/|/[\w\-]+(?:/[\w\-.*]+)+)"  # file paths
    r"|(?:^|\s)--?[\w\-]+=?(?:[\w\-./]+)?"  # CLI flags
)


def _mask_protected_spans(text: str) -> Tuple[str, List[Tuple[str, str]]]:
    matches = list(_PROTECTED.finditer(text))
    spans: List[Tuple[str, str]] = []
    masked = text
    for idx in range(len(matches) - 1, -1, -1):
        m = matches[idx]
        placeholder = f"⟦S{idx}⟧"  # ⟦S0⟧, ⟦S1⟧ ...
        spans.append((placeholder, m.group(0)))
        masked = masked[: m.start()] + placeholder + masked[m.end() :]
    spans.reverse()
    return masked, spans


def apply_corrections(
    text: str, corrections: Sequence[JargonCorrection]
) -> str:
    """Whole-word replacements (longest first), skipping protected spans."""
    if not corrections or not text:
        return text
    masked, spans = _mask_protected_spans(text)
    for corr in corrections:
        pattern = re.compile(rf"\b{re.escape(corr.from_)}\b", re.IGNORECASE)
        masked = pattern.sub(corr.to.replace("\\", r"\\"), masked)
    restored = masked
    for placeholder, original in spans:
        restored = restored.replace(placeholder, original)
    for placeholder, _ in spans:
        if placeholder in restored:
            return text  # fail-safe: placeholder survived replacement
    return restored
