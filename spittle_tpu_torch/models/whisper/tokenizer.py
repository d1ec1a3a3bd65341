"""Whisper byte-level BPE tokenizer (the port's copy of
spittle_tpu/models/whisper/tokenizer.py; no tiktoken dependency).

Replicates the GPT-2-style byte-level BPE used by all Whisper models. The
vocabulary comes from a checkpoint's embedded table (GGML, .npz), from
files beside it (load_tokenizer: a `*.tiktoken` file of base64 token /
rank lines, or an HF `vocab.json`), or from make_test_vocab;
non_speech_tokens gives suppress_non_speech's list.

Special tokens (sot/eot/languages/task/timestamps) are synthesized from the
WhisperConfig token layout; see config.py.
"""

from __future__ import annotations

import base64
import json
import os
import re
from typing import Dict, Iterable, List, Tuple

from .config import WhisperConfig

# Canonical Whisper language order; token id = lang_begin + index.
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su"
).split()
LANGUAGES_V3 = LANGUAGES + ["yue"]

# GPT-2 pre-tokenization pattern. The "other" class is [^\s\p{L}\p{N}],
# which INCLUDES underscore (it is neither letter nor number); a plain
# [^\s\w] would exclude it since \w covers '_' — that silently dropped
# underscores from encoded text (caught by the hypothesis roundtrip).
_PAT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+"""
    r"""|\s+(?!\S)|\s+""",
    re.UNICODE,
)


class WhisperTokenizer:
    """Byte-level BPE with Whisper special tokens."""

    def __init__(self, cfg: WhisperConfig, vocab: Dict[bytes, int]):
        self.cfg = cfg
        self.vocab = vocab  # token bytes -> id
        self.id_to_bytes = {v: k for k, v in vocab.items()}
        # merge ranks: BPE rank == token id order for byte-pair-merge format
        self._ranks = vocab
        self.languages = LANGUAGES_V3 if cfg.n_langs == 100 else LANGUAGES

    # -- special tokens --------------------------------------------------

    def lang_token(self, lang: str) -> int:
        return self.cfg.lang_begin + self.languages.index(lang)

    def lang_code(self, token: int) -> str:
        return self.languages[token - self.cfg.lang_begin]

    def special_str(self, token: int) -> str:
        c = self.cfg
        if token >= c.timestamp_begin:
            return f"<|{(token - c.timestamp_begin) * 0.02:.2f}|>"
        named = {
            c.eot: "<|endoftext|>",
            c.sot: "<|startoftranscript|>",
            c.translate: "<|translate|>",
            c.transcribe: "<|transcribe|>",
            c.sot_lm: "<|startoflm|>",
            c.sot_prev: "<|startofprev|>",
            c.no_speech: "<|nospeech|>",
            c.no_timestamps: "<|notimestamps|>",
        }
        if token in named:
            return named[token]
        if c.lang_begin <= token < c.lang_begin + c.n_langs:
            return f"<|{self.lang_code(token)}|>"
        return f"<|special_{token}|>"

    # -- BPE -------------------------------------------------------------

    def _bpe_merge(self, piece: bytes) -> List[int]:
        """Greedy lowest-rank byte-pair merging of one pre-token."""
        if piece in self._ranks:
            return [self._ranks[piece]]
        parts: List[bytes] = [bytes([b]) for b in piece]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                cand = parts[i] + parts[i + 1]
                rank = self._ranks.get(cand)
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_i = i
            if best_i < 0:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            tid = self._ranks.get(p)
            if tid is None:
                # unknown byte sequence: fall back to raw bytes
                out.extend(self._ranks.get(bytes([b]), 0) for b in p)
            else:
                out.append(tid)
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        for piece in _PAT.findall(text):
            tokens.extend(self._bpe_merge(piece.encode("utf-8")))
        return tokens

    def decode(
        self, tokens: Iterable[int], include_special: bool = False
    ) -> str:
        base_limit = self.cfg.eot
        data = bytearray()
        out: List[str] = []

        def flush():
            nonlocal data
            if data:
                out.append(data.decode("utf-8", errors="replace"))
                data = bytearray()

        for t in tokens:
            t = int(t)
            if t >= base_limit:
                if include_special:
                    flush()
                    out.append(self.special_str(t))
                continue
            data.extend(self.id_to_bytes.get(t, b""))
        flush()
        return "".join(out)

    def decode_with_timestamps(self, tokens: Iterable[int]) -> str:
        return self.decode(tokens, include_special=True)


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping (the alphabet
    of HF vocab.json token strings)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def load_vocab_tiktoken(path: str) -> Dict[bytes, int]:
    """tiktoken format: one `<base64-token> <rank>` per line."""
    vocab: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tok_b64, rank = line.split()
            vocab[base64.b64decode(tok_b64)] = int(rank)
    return vocab


def load_vocab_hf(vocab_json: str) -> Dict[bytes, int]:
    """HF vocab.json: printable-unicode token string -> id. Added special
    tokens, whose strings lie outside the byte alphabet, are skipped."""
    with open(vocab_json, encoding="utf-8") as f:
        table = json.load(f)
    dec = {c: b for b, c in _bytes_to_unicode().items()}
    vocab: Dict[bytes, int] = {}
    for tok_str, tid in table.items():
        try:
            vocab[bytes(dec[c] for c in tok_str)] = tid
        except KeyError:
            continue
    return vocab


def load_tokenizer(cfg: WhisperConfig, model_dir: str) -> WhisperTokenizer:
    """The vocabulary beside a checkpoint: multilingual.tiktoken,
    gpt2.tiktoken or vocab.tiktoken (first found), else vocab.json."""
    for name in ("multilingual.tiktoken", "gpt2.tiktoken", "vocab.tiktoken"):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            return WhisperTokenizer(cfg, load_vocab_tiktoken(path))
    vj = os.path.join(model_dir, "vocab.json")
    if os.path.exists(vj):
        return WhisperTokenizer(cfg, load_vocab_hf(vj))
    raise FileNotFoundError(f"no tokenizer vocab found in {model_dir}")


def non_speech_tokens(tokenizer: WhisperTokenizer) -> Tuple[int, ...]:
    """Token ids suppressed by suppress_non_speech_tokens (the OpenAI /
    whisper.cpp standard list): bracket/markup symbols and music notes,
    with and without a leading space, plus lone dash/quote variants."""
    symbols = list("\"#()*+/:;<=>@[\\]^_`{|}~「」『』") + (
        "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪"
    ).split()
    miscellaneous = set("♩♪♫♬♭♮♯")
    result = set()
    # The ids of " -" and " '" lead the list upstream.
    for tok in [tokenizer.encode(" -"), tokenizer.encode(" '")]:
        if len(tok) == 1:
            result.add(tok[0])
    for symbol in symbols + list(miscellaneous):
        for t in [tokenizer.encode(symbol), tokenizer.encode(" " + symbol)]:
            if len(t) == 1 or (symbol in miscellaneous and t):
                result.add(t[0])
    return tuple(sorted(result))


def make_test_vocab(n: int = 300) -> Dict[bytes, int]:
    """Tiny deterministic vocabulary for unit tests: all single bytes plus a
    few common merges. Token ids are NOT Whisper ids; tests only."""
    vocab: Dict[bytes, int] = {bytes([b]): b for b in range(256)}
    extras = [b" th", b"th", b"he", b" the", b"er", b"in", b" a", b" to",
              b"ing", b" and", b" of", b"en", b" he", b"es", b" is", b"on",
              b" it", b" you", b" that", b"or", b" for", b"an", b" this",
              b"at", b" test", b" hello", b" world"]
    for i, e in enumerate(extras[: n - 256]):
        vocab[e] = 256 + i
    return vocab
