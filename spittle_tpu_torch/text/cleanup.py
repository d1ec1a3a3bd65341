"""Local LLM text cleanup (port of spittle_tpu/text/cleanup.py).

The flan-t5-small cleanup provider: protected-span masking with ⟦Pn⟧
placeholders for @tokens, backtick code, URLs, paths and CLI flags, the
fail-open restore and validation, the prompt framing, sentence splitting,
and t5_seq2seq, a Seq2SeqFn(text) -> text over the port's T5 (models/t5)
and its own tokenizer.json reader (text/hf_tokenizer.py). CleanupManager
returns the original text on any provider failure.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

_PROTECTED = re.compile(
    r"@[\w\-./]+"
    r"|`[^`]+`"
    r"|https?://\S+"
    r"|(?:~/|/[\w\-]+(?:/[\w\-.*]+)+)"
    r"|(?:^|\s)--?[\w\-]+=?(?:[\w\-./]+)?"
)

MAX_DECODE_TOKENS = 512
PROMPT_TEMPLATE = (
    "Fix grammar, punctuation, and capitalization. Do not change wording: "
    "{text}"
)


def mask_protected_spans(text: str) -> Tuple[str, List[Tuple[str, str]]]:
    matches = list(_PROTECTED.finditer(text))
    spans: List[Tuple[str, str]] = []
    masked = text
    for idx in range(len(matches) - 1, -1, -1):
        m = matches[idx]
        placeholder = f"⟦P{idx}⟧"
        spans.append((placeholder, m.group(0)))
        masked = masked[: m.start()] + placeholder + masked[m.end() :]
    spans.reverse()
    return masked, spans


def restore_protected_spans(text: str, spans: List[Tuple[str, str]]) -> str:
    for placeholder, original in spans:
        text = text.replace(placeholder, original)
    return text


def validate_cleanup(
    original: str, cleaned: str, spans: List[Tuple[str, str]]
) -> bool:
    """Sanity gate on provider output (cleanup.rs validate_cleanup):
    non-empty, within a 3x length band of the input, no placeholder
    leaked, and every protected span's content present — a model that
    DROPS a placeholder silently loses the @token/path/flag it stood
    for, which is worse than a leak."""
    if not cleaned or not cleaned.strip():
        return False
    lo, lc = len(original), len(cleaned)
    if lc * 3 < lo or lc > lo * 3:
        return False
    for placeholder, original_span in spans:
        if placeholder in cleaned:
            return False
        if original_span.strip() and original_span.strip() not in cleaned:
            return False
    return True


_SENTENCE_END = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> List[str]:
    """Split on sentence-final punctuation (cleanup.rs sentence batching:
    long inputs clean one sentence at a time)."""
    parts = [p.strip() for p in _SENTENCE_END.split(text)]
    return [p for p in parts if p]


class CleanupManager:
    """Masking + provider orchestration; falls back to the input text."""

    split_sentences = staticmethod(split_sentences)

    def __init__(self, seq2seq: Optional[Callable[[str], str]] = None):
        self._seq2seq = seq2seq

    @property
    def name(self) -> str:
        return "local-seq2seq-cleanup"

    @property
    def is_available(self) -> bool:
        return self._seq2seq is not None

    def cleanup(self, text: str) -> str:
        if not text.strip() or self._seq2seq is None:
            return text
        masked, spans = mask_protected_spans(text)
        try:
            result = self._seq2seq(PROMPT_TEMPLATE.format(text=masked))
        except Exception:
            return text  # fail open (cleanup.rs provider contract)
        if not result or not result.strip():
            return text
        restored = restore_protected_spans(result.strip(), spans)
        if not validate_cleanup(text, restored, spans):
            return text  # degenerate output or leaked placeholder
        return restored


def t5_seq2seq(model_dir: str, max_tokens: int = MAX_DECODE_TOKENS,
               device="cuda"):
    """A Seq2SeqFn from an HF flan-t5 checkpoint directory (*.safetensors,
    config.json, tokenizer.json), on `device` (the card by default; it
    raises without one). Pass the result to CleanupManager(seq2seq=...).
    Raises if the directory lacks weights or tokenizer."""
    import os

    import numpy as np

    from spittle_tpu_torch.models.t5 import greedy_generate, load_t5_dir

    from .hf_tokenizer import HFTokenizer

    cfg, params = load_t5_dir(model_dir, device=device)
    tok = HFTokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))

    def run(prompt: str) -> str:
        ids = tok.encode(prompt).ids
        if ids[-1] != cfg.eos_id:
            ids = ids + [cfg.eos_id]
        out = greedy_generate(
            params, np.asarray([ids], np.int32), cfg, max_tokens=max_tokens
        )
        row = [int(t) for t in out[0] if t not in (cfg.pad_id, cfg.eos_id)]
        return tok.decode(row)

    return run
