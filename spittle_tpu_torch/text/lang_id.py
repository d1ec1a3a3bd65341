"""Deterministic text language identification for the Parakeet v3 set
(the port's copy of spittle_tpu/text/lang_id.py, pure Python).

Parakeet-TDT v3 is multilingual with no explicit language head: the
language a transcription is *in* is implicit in the decoded text. The
reference surfaces the model's decision in the result it returns
(`src-tauri/src/managers/transcription.rs:505-513` builds the result
the engine decided on); echoing the caller's request instead loses
information whenever the request was absent or wrong. This module
derives the language from the decoded token text so
`TranscriptionResult.language` can carry what the model actually
produced.

Two-stage classifier, fully deterministic and dependency-free:

1. **Script partition** (unambiguous): Greek -> el; Cyrillic -> {ru,
   uk, bg}; everything else Latin -> the remaining 21 v3 languages.
2. **Evidence scoring** within the partition: function-word (stopword)
   hits on word boundaries (weight 3 — closed-class words are the
   strongest short-text signal) plus language-distinctive letters
   (weight 1: ы/э -> ru, і/ї/є -> uk, ъ -> bg, ñ -> es, ß -> de,
   ő/ű -> hu, ...). Ties and empty evidence return None so the caller
   can fall back to the requested language.

The v3 language set (25 European languages) is the NVIDIA model card's
list, mirrored in the reference catalog's parakeet_v3 group
(`src-tauri/resources/model_catalog.json`).
"""

from __future__ import annotations

from typing import Dict, Optional

# Function words per language. Short, high-frequency, closed-class —
# chosen to be discriminative WITHIN the script partition (e.g. "de" is
# shared by es/pt/fr/nl so it carries little weight alone; "y"/"el" vs
# "e"/"o" vs "et"/"le" split es/pt/fr).
_STOPWORDS: Dict[str, tuple] = {
    # Latin script
    "en": ("the", "and", "of", "to", "is", "that", "it", "was", "with"),
    "de": ("der", "die", "und", "das", "ist", "nicht", "ein", "mit", "ich"),
    "es": ("el", "la", "que", "los", "una", "es", "por", "con", "para", "y"),
    "pt": ("o", "a", "que", "os", "uma", "é", "por", "com", "para", "não"),
    "fr": ("le", "la", "les", "et", "est", "une", "des", "que", "pas", "je"),
    "it": ("il", "la", "che", "di", "è", "una", "per", "non", "sono", "gli"),
    "nl": ("de", "het", "een", "en", "van", "dat", "is", "niet", "ik", "je"),
    "sv": ("och", "att", "det", "som", "en", "är", "på", "inte", "jag"),
    "da": ("og", "at", "det", "som", "en", "er", "på", "ikke", "jeg", "af"),
    "fi": ("ja", "on", "ei", "että", "se", "hän", "oli", "mutta", "kun"),
    "et": ("ja", "on", "ei", "et", "see", "ta", "oli", "aga", "kui", "oma"),
    "pl": ("i", "w", "nie", "na", "się", "że", "jest", "do", "to", "z"),
    "cs": ("a", "je", "se", "na", "že", "to", "v", "s", "do", "není"),
    "sk": ("a", "je", "sa", "na", "že", "to", "v", "s", "do", "nie"),
    "sl": ("in", "je", "se", "na", "da", "to", "v", "z", "ne", "so"),
    "hr": ("i", "je", "se", "na", "da", "to", "u", "s", "ne", "su"),
    "hu": ("és", "a", "az", "nem", "hogy", "is", "egy", "van", "meg"),
    "ro": ("și", "de", "în", "la", "cu", "nu", "este", "pe", "un", "o"),
    "lt": ("ir", "yra", "kad", "tai", "su", "ne", "bet", "kaip", "jis"),
    "lv": ("un", "ir", "ka", "tas", "ar", "ne", "bet", "kā", "viņš", "es"),
    "mt": ("u", "li", "il", "ta", "hu", "ma", "fil", "dan", "kien"),
    # Cyrillic script
    "ru": ("и", "в", "не", "на", "что", "это", "он", "как", "его", "был"),
    "uk": ("і", "в", "не", "на", "що", "це", "він", "як", "його", "був"),
    "bg": ("и", "в", "не", "на", "че", "това", "той", "как", "него", "бе"),
    # Greek script
    "el": ("και", "το", "η", "να", "του", "δεν", "με", "που", "από"),
}

# Language-distinctive letters (present ~only in that language within
# its script partition).
_CHAR_CUES: Dict[str, str] = {
    "ru": "ыэё",
    "uk": "іїєґ",
    "bg": "ъ",
    "es": "ñ¿¡",
    "pt": "ãõ",
    "de": "ß",
    "fr": "œàêç",
    "hu": "őű",
    "pl": "łńść",
    "cs": "řěů",
    "da": "øå",
    "sv": "å",
    "ro": "țș",
    "lv": "āēīū",
    "lt": "ėųį",
    "et": "õ",
    "mt": "ħġż",
}

_CYRILLIC = ("ru", "uk", "bg")
_GREEK = ("el",)
_LATIN = tuple(
    k for k in _STOPWORDS if k not in _CYRILLIC and k not in _GREEK
)

PARAKEET_V3_LANGUAGES = tuple(sorted(_STOPWORDS))


def _script(text: str) -> str:
    cyr = sum(1 for c in text if "Ѐ" <= c <= "ӿ")
    grk = sum(1 for c in text if "Ͱ" <= c <= "Ͽ")
    lat = sum(1 for c in text if c.isalpha() and c <= "ɏ")
    best = max(cyr, grk, lat)
    if best == 0:
        return "none"
    return "cyrillic" if cyr == best else "greek" if grk == best else "latin"


def detect_language(text: str) -> Optional[str]:
    """Best-guess ISO 639-1 code for `text`, or None when inconclusive.

    None (rather than a default) lets the engine fall back to the
    caller's requested language — detection only ever *adds*
    information, it never overrides silence with a guess built on no
    evidence.
    """
    text = (text or "").strip().lower()
    if not text:
        return None
    script = _script(text)
    if script == "none":
        return None
    if script == "greek":
        return "el"
    candidates = _CYRILLIC if script == "cyrillic" else _LATIN

    words = [w.strip(".,;:!?\"'()[]«»„“”") for w in text.split()]
    scores = {}
    for lang in candidates:
        s = 3 * sum(1 for w in words if w in _STOPWORDS[lang])
        for ch in _CHAR_CUES.get(lang, ""):
            s += text.count(ch)
        scores[lang] = s
    top = max(scores.values())
    if top == 0:
        # No stopword/cue evidence: Cyrillic still narrows to ru (the
        # dominant prior of the partition is worth more than None —
        # every Cyrillic v3 language shares the base alphabet); Latin
        # stays inconclusive.
        return "ru" if script == "cyrillic" else None
    winners = [k for k, v in scores.items() if v == top]
    if len(winners) > 1:
        return None  # tie: no decision beats a coin flip
    return winners[0]
