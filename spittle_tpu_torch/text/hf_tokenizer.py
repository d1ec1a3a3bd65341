"""A reader of Hugging Face `tokenizer.json` files that needs no
`tokenizers` package: encode(text).ids and decode(ids) give what
`tokenizers.Tokenizer.from_file(path)` gives, for the forms the port's
checkpoints ship.

- Models: WordLevel (vocab, unk_token) and Unigram ([piece, score] vocab,
  unk_id; unknown characters fused into one unk, as sentencepiece does).
- Normalizers: Sequence, Precompiled (sentencepiece's charsmap), Strip,
  Replace (a string or a regex pattern).
- Pre-tokenizers: Sequence, Whitespace, WhitespaceSplit, Metaspace (under
  prepend_scheme or the older add_prefix_space).
- Post-processor: TemplateProcessing (the single-sequence template).
- Decoder: Metaspace, or none (tokens joined by spaces).
- Added tokens (extracted from the raw text before normalizing, the
  special ones dropped by decode).

HF's T5 conversion (transformers' T5Converter) writes a Unigram model,
Sequence[Precompiled, Strip(right), Replace(" {2,}", "▁")], Metaspace
pre-tokenizer and decoder, a TemplateProcessing that appends </s>, and the
<extra_id_N> added tokens. Any other component raises NotImplementedError
naming it.

`Precompiled` is sentencepiece's darts-clone double array: a u32 byte count
of the trie, the trie's u32 units, then the NUL-separated normalized
strings. tokenizers looks up each grapheme (under 6 bytes) and takes the
FIRST (shortest) key that is a prefix of it; a longer grapheme, or one with
no match, is looked up one character at a time. `build_precompiled_charsmap`
writes such a blob from a {key: normalized} mapping.
"""

from __future__ import annotations

import base64
import json
import re
import struct
import unicodedata
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

# Rust's char::is_whitespace (the White_Space property); str.isspace also
# takes the \x1c-\x1f separators, which tokenizers keeps.
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))
_K_UNK_PENALTY = 10.0


def _unsupported(kind: str, obj) -> NotImplementedError:
    name = obj.get("type") if isinstance(obj, dict) else obj
    return NotImplementedError(f"tokenizer.json {kind} {name!r} is not supported")


# -- strings with their original offsets -------------------------------------

# A piece of text being normalized and pre-tokenized: its characters, for
# each the offset in the original input of the character it came from, and
# the original offset where the piece starts (a segment's own start; a
# split's first character's). Metaspace's "first" scheme prepends only to
# a piece that starts at original offset 0.
_Piece = Tuple[str, List[int], int]


def _is_word(c: str) -> bool:
    """Rust regex's Unicode \\w: letters, marks, decimal digits, connector
    punctuation, letter numbers, ZWNJ/ZWJ."""
    cat = unicodedata.category(c)
    return cat[0] in "LM" or cat in ("Nd", "Pc", "Nl") or c in "\u200c\u200d"


# -- graphemes ---------------------------------------------------------------

def _gcb(c: str) -> str:
    """A character's grapheme-cluster-break class (UAX #29), for the
    classes that join characters: CR, LF, Control, Extend, ZWJ,
    SpacingMark, Regional_Indicator, Hangul L/V/T/LV/LVT, Other."""
    o = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if c == "\u200d":
        return "ZWJ"
    if 0x1F1E6 <= o <= 0x1F1FF:
        return "RI"
    if 0x1100 <= o <= 0x115F or 0xA960 <= o <= 0xA97C:
        return "L"
    if 0x1160 <= o <= 0x11A7 or 0xD7B0 <= o <= 0xD7C6:
        return "V"
    if 0x11A8 <= o <= 0x11FF or 0xD7CB <= o <= 0xD7FB:
        return "T"
    if 0xAC00 <= o <= 0xD7A3:
        return "LV" if (o - 0xAC00) % 28 == 0 else "LVT"
    cat = unicodedata.category(c)
    if (cat in ("Mn", "Me") or c == "\u200c" or 0xFF9E <= o <= 0xFF9F
            or 0x1F3FB <= o <= 0x1F3FF or 0xE0020 <= o <= 0xE007F):
        return "Extend"
    if cat == "Mc":
        return "SpacingMark"
    if cat in ("Cc", "Zl", "Zp") or (cat == "Cf" and c not in "\u200c\u200d"):
        return "Control"
    return "Other"


def _graphemes(s: str) -> List[str]:
    """Extended grapheme clusters (UAX #29's rules GB3-GB13, without the
    Prepend class, Indic conjuncts and emoji ZWJ sequences)."""
    out: List[str] = []
    prev = None
    ri = 0
    for c in s:
        cur = _gcb(c)
        join = prev is not None and (
            (prev == "CR" and cur == "LF")
            or (prev not in ("CR", "LF", "Control")
                and cur not in ("CR", "LF", "Control")
                and (cur in ("Extend", "ZWJ", "SpacingMark")
                     or (prev == "L" and cur in ("L", "V", "LV", "LVT"))
                     or (prev in ("LV", "V") and cur in ("V", "T"))
                     or (prev in ("LVT", "T") and cur == "T")
                     or (prev == "RI" and cur == "RI" and ri % 2 == 1))))
        if join:
            out[-1] += c
        else:
            out.append(c)
        ri = ri + 1 if cur == "RI" else 0
        prev = cur
    return out


# -- Precompiled (sentencepiece's charsmap) ----------------------------------

class _Precompiled:
    def __init__(self, blob: bytes):
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{trie_size // 4}I", blob, 4)
        self.normalized = blob[4 + trie_size:]

    def _first_match(self, key: bytes) -> Optional[int]:
        """The value of the shortest key in the trie that is a prefix of
        `key` (darts-clone's common prefix search, first result)."""
        u = self.units
        pos = 0
        unit = u[0]
        pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(u):
                return None
            unit = u[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                return u[pos] & ((1 << 31) - 1)
        return None

    def transform(self, chunk: str) -> Optional[str]:
        at = self._first_match(chunk.encode())
        if at is None:
            return None
        end = self.normalized.index(b"\0", at)
        return self.normalized[at:end].decode()

    def __call__(self, piece: _Piece) -> _Piece:
        text, offs, origin = piece
        chars: List[str] = []
        new_offs: List[int] = []
        # tokenizers drops the count of characters removed (mapped to "")
        # before any is emitted, so every later character aligns `lost`
        # characters early.
        lost = 0

        def emit(norm: str, at: int, n_old: int) -> None:
            nonlocal lost
            if not norm and not new_offs:
                lost += n_old
            chars.append(norm)
            new_offs.extend([offs[at - lost]] * len(norm))

        i = 0
        for g in _graphemes(text):
            norm = self.transform(g) if len(g.encode()) < 6 else None
            if norm is not None:
                emit(norm, i, len(g))
            else:
                for k, c in enumerate(g):
                    norm = self.transform(c)
                    emit(c if norm is None else norm, i + k, 1)
            i += len(g)
        return "".join(chars), new_offs, origin


def build_precompiled_charsmap(mapping: Dict[str, str]) -> bytes:
    """A Precompiled charsmap blob that maps each key to its string: a
    darts-clone double array (every node's children in a block of 256
    units of its own) followed by the NUL-terminated strings."""
    blob = bytearray()
    root: dict = {}
    for key in sorted(mapping):
        if not key:
            raise ValueError("charsmap keys must be non-empty")
        node = root
        for b in key.encode():
            node = node.setdefault(b, {})
        node[None] = len(blob)
        blob += mapping[key].encode() + b"\0"
    units: Dict[int, int] = {}
    blocks = [256]

    def place(node: dict, pos: int, label: int) -> None:
        base = blocks[0]
        blocks[0] += 256
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("charsmap too large: a node offset past 2**21")
        units[pos] = (offset << 10) | (int(None in node) << 8) | label
        if None in node:
            units[base] = node[None] | (1 << 31)
        for c, child in node.items():
            if c is not None:
                place(child, base ^ c, c)

    place(root, 0, 0)
    trie = struct.pack(f"<{blocks[0]}I", *(units.get(i, 0) for i in range(blocks[0])))
    return struct.pack("<I", len(trie)) + trie + bytes(blob)


# -- normalizers -------------------------------------------------------------

def _normalizer(spec):
    if spec is None:
        return lambda piece: piece
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def run(piece):
            for step in steps:
                piece = step(piece)
            return piece
        return run
    if kind == "Precompiled":
        cmap = spec.get("precompiled_charsmap")
        if not cmap:
            return lambda piece: piece
        return _Precompiled(base64.b64decode(cmap))
    if kind == "Strip":
        left, right = spec.get("strip_left", False), spec.get("strip_right", False)

        def strip(piece):
            text, offs, origin = piece
            a, b = 0, len(text)
            while left and a < b and text[a] in _WHITESPACE:
                a += 1
            while right and b > a and text[b - 1] in _WHITESPACE:
                b -= 1
            return text[a:b], offs[a:b], origin
        return strip
    if kind == "Replace":
        pat = spec["pattern"]
        if "Regex" in pat:
            regex = re.compile(pat["Regex"])
        else:
            regex = re.compile(re.escape(pat["String"]))
        content = spec["content"]

        def replace(piece):
            text, offs, origin = piece
            chars, new_offs, last = [], [], 0
            for m in regex.finditer(text):
                if m.start() == m.end():
                    continue
                chars.append(text[last:m.start()])
                new_offs += offs[last:m.start()]
                chars.append(content)
                new_offs += [offs[m.start()]] * len(content)
                last = m.end()
            chars.append(text[last:])
            new_offs += offs[last:]
            return "".join(chars), new_offs, origin
        return replace
    raise _unsupported("normalizer", spec)


# -- pre-tokenizers ----------------------------------------------------------

def _split_runs(piece: _Piece, keep) -> List[_Piece]:
    """Maximal runs of characters of one class, keep(c) -> class or None
    (dropped)."""
    text, offs, _ = piece
    out: List[_Piece] = []
    cur = None
    start = 0
    for i, c in enumerate(text + "\0"):
        cls = keep(c) if i < len(text) else None
        if cls != cur or cls is None:
            if cur is not None:
                out.append((text[start:i], offs[start:i], offs[start]))
            start, cur = i, cls
    return out


def _metaspace_scheme(spec) -> str:
    scheme = spec.get("prepend_scheme", "always")
    aps = spec.get("add_prefix_space")
    if aps is not None and aps != (scheme != "never"):
        raise ValueError("add_prefix_space does not match declared prepend_scheme")
    if scheme not in ("always", "first", "never"):
        raise _unsupported("Metaspace prepend_scheme", scheme)
    return scheme


def _pre_tokenizer(spec):
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(pieces):
            for step in steps:
                pieces = step(pieces)
            return pieces
        return run
    if kind == "WhitespaceSplit":
        return lambda pieces: [
            p for piece in pieces
            for p in _split_runs(piece, lambda c: None if c in _WHITESPACE else 1)]
    if kind == "Whitespace":  # \w+|[^\w\s]+
        return lambda pieces: [
            p for piece in pieces for p in _split_runs(
                piece, lambda c: 1 if _is_word(c) else
                (None if c in _WHITESPACE else 2))]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = _metaspace_scheme(spec)
        split = spec.get("split", True)

        def metaspace(pieces):
            out: List[_Piece] = []
            for text, offs, origin in pieces:
                text = text.replace(" ", rep)
                if (text and not text.startswith(rep)
                        and (scheme == "always" or (scheme == "first" and origin == 0))):
                    text, offs = rep + text, [offs[0]] + offs
                if not split:
                    out.append((text, offs, origin))
                    continue
                cuts = [i for i, c in enumerate(text) if c == rep and i > 0]
                for a, b in zip([0] + cuts, cuts + [len(text)]):
                    if a < b:
                        out.append((text[a:b], offs[a:b], offs[a]))
            return out
        return metaspace
    raise _unsupported("pre_tokenizer", spec)


# -- models ------------------------------------------------------------------

class _WordLevel:
    def __init__(self, spec):
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.inv = {i: t for t, i in self.vocab.items()}

    def tokenize(self, text: str) -> List[int]:
        if text in self.vocab:
            return [self.vocab[text]]
        if self.unk not in self.vocab:
            raise ValueError(f"WordLevel: {text!r} is out of vocabulary and "
                             "the model has no unk_token")
        return [self.vocab[self.unk]]

    def id_to_token(self, i: int) -> Optional[str]:
        return self.inv.get(i)


class _Unigram:
    """tokenizers' Unigram.encode_optimized: Viterbi over the pieces that
    start at each character, an unknown character scored min_score - 10,
    consecutive unknowns fused into one unk."""

    def __init__(self, spec):
        if spec.get("byte_fallback"):
            raise _unsupported("Unigram option", "byte_fallback")
        self.pieces = [p for p, _ in spec["vocab"]]
        self.scores = [float(s) for _, s in spec["vocab"]]
        self.ids = {p: i for i, p in enumerate(self.pieces)}
        self.unk_id = spec.get("unk_id")
        self.min_score = min(self.scores, default=0.0)
        self.max_len = max((len(p) for p in self.pieces), default=0)

    def tokenize(self, text: str) -> List[int]:
        n = len(text)
        unk_score = self.min_score - _K_UNK_PENALTY
        best = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        node_id = [0] * (n + 1)
        for s in range(n):
            here = best[s]
            single = False
            for ln in range(1, min(self.max_len, n - s) + 1):
                i = self.ids.get(text[s:s + ln])
                if i is None:
                    continue
                cand = self.scores[i] + here
                if start[s + ln] is None or cand > best[s + ln]:
                    best[s + ln], start[s + ln], node_id[s + ln] = cand, s, i
                single |= ln == 1
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: an unknown character and no unk_id")
                cand = unk_score + here
                if start[s + 1] is None or cand > best[s + 1]:
                    best[s + 1], start[s + 1], node_id[s + 1] = cand, s, self.unk_id
        words: List[str] = []
        unk_run: List[str] = []
        end = n
        while end > 0:
            s = start[end]
            if node_id[end] == self.unk_id:
                unk_run.append(text[s:end])
            else:
                if unk_run:
                    words.append("".join(reversed(unk_run)))
                    unk_run = []
                words.append(text[s:end])
            end = s
        if unk_run:
            words.append("".join(reversed(unk_run)))
        return [self.ids.get(w, self.unk_id) for w in reversed(words)]

    def id_to_token(self, i: int) -> Optional[str]:
        return self.pieces[i] if 0 <= i < len(self.pieces) else None


def _model(spec):
    kind = spec.get("type")
    if kind == "WordLevel":
        return _WordLevel(spec)
    if kind == "Unigram":
        return _Unigram(spec)
    raise _unsupported("model", spec)


# -- post-processor and decoder ----------------------------------------------

def _post_processor(spec):
    if spec is None:
        return lambda ids: ids
    if spec.get("type") != "TemplateProcessing":
        raise _unsupported("post_processor", spec)
    special = spec.get("special_tokens", {})
    parts = []
    for item in spec["single"]:
        if "Sequence" in item:
            parts.append(None)
        else:
            parts.append(list(special[item["SpecialToken"]["id"]]["ids"]))

    def apply(ids: List[int]) -> List[int]:
        out: List[int] = []
        for p in parts:
            out += ids if p is None else p
        return out
    return apply


def _decoder(spec):
    if spec is None:
        return lambda tokens: " ".join(tokens)
    if spec.get("type") != "Metaspace":
        raise _unsupported("decoder", spec)
    rep = spec.get("replacement", "▁")
    scheme = _metaspace_scheme(spec)

    def decode(tokens: Sequence[str]) -> str:
        # The first token loses every replacement character unless the
        # scheme is "never"; elsewhere each becomes a space.
        return "".join(
            tok.replace(rep, "" if i == 0 and scheme != "never" else " ")
            for i, tok in enumerate(tokens))
    return decode


# -- the tokenizer -----------------------------------------------------------

@dataclass
class Encoding:
    ids: List[int]


class HFTokenizer:
    """tokenizer.json -> encode / decode (see the module docstring)."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, key)
        self.added: Dict[str, int] = {}
        self.special = set()
        for tok in spec.get("added_tokens", []):
            for flag in ("single_word", "lstrip", "rstrip", "normalized"):
                if tok.get(flag):
                    raise _unsupported(f"added token option {flag} of",
                                       tok["content"])
            self.added[tok["content"]] = tok["id"]
            if tok.get("special"):
                self.special.add(tok["content"])
        self.added_inv = {i: t for t, i in self.added.items()}
        self._split = (re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
            if self.added else None)
        self.normalizer = _normalizer(spec.get("normalizer"))
        self.pre_tokenizer = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        self.post_processor = _post_processor(spec.get("post_processor"))
        self.decoder = _decoder(spec.get("decoder"))

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def _encode_text(self, text: str, at: int) -> List[int]:
        piece = self.normalizer((text, list(range(at, at + len(text))), at))
        if not piece[0]:
            return []
        ids: List[int] = []
        for word, _, _ in self.pre_tokenizer([piece]):
            if word:
                ids += self.model.tokenize(word)
        return ids

    def encode(self, text: str) -> Encoding:
        ids: List[int] = []
        last = 0
        for m in (self._split.finditer(text) if self._split else ()):
            if m.start() > last:
                ids += self._encode_text(text[last:m.start()], last)
            ids.append(self.added[m.group(0)])
            last = m.end()
        if last < len(text):
            ids += self._encode_text(text[last:], last)
        return Encoding(self.post_processor(ids))

    def id_to_token(self, i: int) -> Optional[str]:
        tok = self.added_inv.get(i)
        return tok if tok is not None else self.model.id_to_token(i)

    def decode(self, ids: Sequence[int]) -> str:
        """The text of ids, special tokens and unknown ids dropped
        (tokenizers' decode with skip_special_tokens=True)."""
        tokens = []
        for i in ids:
            tok = self.id_to_token(int(i))
            if tok is not None and tok not in self.special:
                tokens.append(tok)
        return self.decoder(tokens)
