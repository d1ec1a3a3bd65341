"""Transcription text post-processing (port of spittle_tpu/text/filters.py).

Behavior-parity port of the reference text toolkit
(`src-tauri/src/audio_toolkit/text.rs`): fuzzy custom-word
correction (Levenshtein + Soundex over 1..3-word n-grams), filler/stutter
filtering, whole-output hallucination rejection, and segment-boundary
cleanup. Pure host-side string logic; runs after the engine's decode returns
token text (reference call site: `managers/transcription.rs:537-580`).
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# String similarity primitives
# ---------------------------------------------------------------------------


_native_lev = None  # resolved lazily; False = unavailable


def _resolve_native_lev():
    """C++ fast path (native/spittle_audio.cpp: levenshtein_u32); the
    reference runs this loop natively too (Rust strsim)."""
    global _native_lev
    if _native_lev is None:
        try:
            import ctypes

            from spittle_tpu_torch.native.ringbuffer import load_native

            lib = load_native()
            if lib is None:
                _native_lev = False
            else:
                fn = lib.levenshtein_u32
                fn.restype = ctypes.c_int64
                fn.argtypes = [
                    ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                ]
                _native_lev = fn
        except Exception:
            _native_lev = False
    return _native_lev


def _levenshtein_py(a: str, b: str) -> int:
    # One-row DP.
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, start=1):
            cur[j] = min(
                prev[j] + 1,  # deletion
                cur[j - 1] + 1,  # insertion
                prev[j - 1] + (ca != cb),  # substitution
            )
        prev = cur
    return prev[-1]


def levenshtein(a: str, b: str) -> int:
    """Unicode-codepoint Levenshtein distance (semantics of strsim::levenshtein)."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    fn = _resolve_native_lev()
    if fn:
        import ctypes

        ab = a.encode("utf-32-le")
        bb = b.encode("utf-32-le")
        return fn(
            ctypes.cast(ab, ctypes.POINTER(ctypes.c_uint32)), len(a),
            ctypes.cast(bb, ctypes.POINTER(ctypes.c_uint32)), len(b),
        )
    return _levenshtein_py(a, b)


_SOUNDEX_CODES = {
    **dict.fromkeys("bfpv", "1"),
    **dict.fromkeys("cgjkqsxz", "2"),
    **dict.fromkeys("dt", "3"),
    "l": "4",
    **dict.fromkeys("mn", "5"),
    "r": "6",
}


def soundex_code(word: str) -> str:
    """American Soundex code of `word` (letters only considered)."""
    letters = [c for c in word.lower() if "a" <= c <= "z"]
    if not letters:
        return ""
    first = letters[0]
    code = [first.upper()]
    prev_digit = _SOUNDEX_CODES.get(first, "")
    for c in letters[1:]:
        digit = _SOUNDEX_CODES.get(c, "")
        if digit and digit != prev_digit:
            code.append(digit)
            if len(code) == 4:
                break
        # 'h'/'w' do not reset the previous code; vowels do.
        if c not in "hw":
            prev_digit = digit
    return "".join(code).ljust(4, "0")


def soundex_match(a: str, b: str) -> bool:
    return bool(a) and bool(b) and soundex_code(a) == soundex_code(b)


# ---------------------------------------------------------------------------
# Custom-word fuzzy correction
# ---------------------------------------------------------------------------


def _byte_len(s: str) -> int:
    return len(s.encode("utf-8"))


def _build_ngram(words: Sequence[str]) -> str:
    """Strip non-alphanumeric from both ends of each word, lowercase, concat."""
    out = []
    for w in words:
        out.append(_trim_non_alnum(w).lower())
    return "".join(out)


def _trim_non_alnum(word: str) -> str:
    start = 0
    end = len(word)
    while start < end and not word[start].isalnum():
        start += 1
    while end > start and not word[end - 1].isalnum():
        end -= 1
    return word[start:end]


def _find_best_match(
    candidate: str,
    custom_words: Sequence[str],
    custom_words_nospace: Sequence[str],
    threshold: float,
) -> Optional[Tuple[str, float]]:
    # Byte lengths mirror the reference's str::len() semantics.
    cand_len = _byte_len(candidate)
    if not candidate or cand_len > 50:
        return None

    best: Optional[str] = None
    best_score = float("inf")
    for original, nospace in zip(custom_words, custom_words_nospace):
        ns_len = _byte_len(nospace)
        len_diff = abs(cand_len - ns_len)
        max_len = max(cand_len, ns_len)
        # Max 25% length difference (at least 2 chars allowed) to prevent
        # n-grams from over-matching much shorter custom words.
        if len_diff > max(max_len * 0.25, 2.0):
            continue

        dist = levenshtein(candidate, nospace)
        # Normalize over codepoint length like strsim's distance domain.
        norm = max(len(candidate), len(nospace))
        lev_score = dist / norm if norm > 0 else 1.0
        combined = lev_score * 0.3 if soundex_match(candidate, nospace) else lev_score
        if combined < threshold and combined < best_score:
            best = original
            best_score = combined
    if best is None:
        return None
    return best, best_score


def _preserve_case_pattern(original: str, replacement: str) -> str:
    # Char-wise check: digits are neither upper nor lower (matches Rust
    # char::is_uppercase, unlike Python str.isupper()).
    if original and all(c.isupper() for c in original):
        return replacement.upper()
    if original and original[0].isupper():
        return replacement[0].upper() + replacement[1:] if replacement else replacement
    return replacement


def _extract_punctuation(word: str) -> Tuple[str, str]:
    prefix_end = 0
    while prefix_end < len(word) and not word[prefix_end].isalnum():
        prefix_end += 1
    if prefix_end == len(word):
        # Entirely non-alphanumeric: whole word is the prefix, no suffix
        # (mirrors the reference's overlapping take_while behavior only in
        # the all-punctuation case).
        return word, ""
    suffix_start = 0
    for c in reversed(word):
        if c.isalnum():
            break
        suffix_start += 1
    prefix = word[:prefix_end] if prefix_end else ""
    suffix = word[len(word) - suffix_start :] if suffix_start else ""
    return prefix, suffix


def apply_custom_words(
    text: str, custom_words: Sequence[str], threshold: float
) -> str:
    """Fuzzy-correct `text` against `custom_words`.

    Greedy longest-n-gram-first (3..1) matching so that multi-word speech
    artifacts like "Charge B" correct to "ChargeBee". Case pattern of the
    first original word and surrounding punctuation are preserved.
    """
    if not custom_words:
        return text

    custom_lower = [w.lower() for w in custom_words]
    custom_nospace = [w.replace(" ", "") for w in custom_lower]

    words = text.split()
    result: List[str] = []
    i = 0
    while i < len(words):
        matched = False
        for n in (3, 2, 1):
            if i + n > len(words):
                continue
            ngram_words = words[i : i + n]
            ngram = _build_ngram(ngram_words)
            found = _find_best_match(ngram, custom_words, custom_nospace, threshold)
            if found is not None:
                replacement, _ = found
                prefix, _ = _extract_punctuation(ngram_words[0])
                _, suffix = _extract_punctuation(ngram_words[n - 1])
                corrected = _preserve_case_pattern(ngram_words[0], replacement)
                result.append(f"{prefix}{corrected}{suffix}")
                i += n
                matched = True
                break
        if not matched:
            result.append(words[i])
            i += 1
    return " ".join(result)


# ---------------------------------------------------------------------------
# Segment boundary cleanup
# ---------------------------------------------------------------------------


def _strip_segment_tail(s: str) -> str:
    t = s.strip()
    for suffix in (".", "...", "!", "?", ","):
        while t.endswith(suffix):
            t = t[: -len(suffix)]
    return t.strip()


def clean_segment_boundaries(segments: Iterable[str], remaining: str) -> str:
    """Strip trailing punctuation per segment, lowercase, join with spaces."""
    parts: List[str] = []
    for segment in segments:
        trimmed = _strip_segment_tail(segment)
        if trimmed:
            parts.append(trimmed.lower())
    remaining_trimmed = _strip_segment_tail(remaining)
    if remaining_trimmed:
        parts.append(remaining_trimmed.lower())
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Filler / stutter / hallucination filtering
# ---------------------------------------------------------------------------

FILLER_WORDS = (
    "uh", "um", "uhm", "umm", "uhh", "uhhh", "ah", "eh", "hmm", "hm",
    "mmm", "mm", "mh", "ha", "ehh",
)

_FILLER_PATTERNS = [
    re.compile(rf"\b{re.escape(w)}\b[,.]?", re.IGNORECASE) for w in FILLER_WORDS
]

_MULTI_SPACE = re.compile(r"\s{2,}")

HALLUCINATION_PHRASES = (
    "thank you for watching",
    "thanks for watching",
    "thank you for listening",
    "thanks for listening",
    "please subscribe",
    "like and subscribe",
    "see you next time",
    "see you in the next video",
    "bye bye",
    "bye",
    "thank you",
    "thanks",
    "subtitles by",
    "you",
)

_HALLUCINATION_REGEXES = [
    re.compile(
        r"^(for more information[,.]?\s*)?(visit|go to)\s+\S+"
        r"(\s+(or\s+)?(visit|go to)\s+\S+)*(\s+for more information)?[.,]?\s*$",
        re.IGNORECASE | re.DOTALL,
    ),
    re.compile(
        r"^for more information[,.]?\s*(visit|go to)\s+\S+[.,]?\s*$",
        re.IGNORECASE | re.DOTALL,
    ),
    re.compile(
        r"^subtitles\s+(by|provided by|created by)\s+.*$",
        re.IGNORECASE | re.DOTALL,
    ),
]


def collapse_stutters(text: str) -> str:
    """Collapse 3+ consecutive repeats of 1-2 letter words to one instance."""
    words = text.split()
    if not words:
        return text
    result: List[str] = []
    i = 0
    while i < len(words):
        word = words[i]
        lower = word.lower()
        if _byte_len(lower) <= 2 and lower.isalpha():
            count = 1
            while i + count < len(words) and words[i + count].lower() == lower:
                count += 1
            result.append(word)
            i += count if count >= 3 else 1
        else:
            result.append(word)
            i += 1
    return " ".join(result)


def is_hallucination(text: str) -> bool:
    """Whole-output check against known Whisper hallucination phrases."""
    stripped = "".join(c for c in text.strip() if c.isalnum() or c.isspace())
    normalized = stripped.strip().lower()
    if not normalized:
        return False
    if normalized in HALLUCINATION_PHRASES:
        return True
    trimmed = text.strip()
    return any(r.match(trimmed) for r in _HALLUCINATION_REGEXES)


def filter_transcription_output(text: str) -> str:
    """Remove fillers and stutters; discard known whole-output hallucinations."""
    filtered = text
    for pattern in _FILLER_PATTERNS:
        filtered = pattern.sub("", filtered)
    filtered = collapse_stutters(filtered)
    filtered = _MULTI_SPACE.sub(" ", filtered)
    filtered = filtered.strip()
    if is_hallucination(filtered):
        return ""
    return filtered
