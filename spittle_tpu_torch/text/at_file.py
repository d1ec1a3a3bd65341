"""@file reference expansion.

Port of spittle_tpu/text/at_file.py.

Behavior-parity port of `src-tauri/src/at_file_expansion.rs`:
parse `@name` / `@"name with spaces"` tokens (skipping emails) and spoken
command aliases ("at/include/reference/for/file main dot rs"), normalize
spoken forms (dot/slash/underscore words, split extensions like "trade. r s"),
resolve against a cached workspace index (skip dirs, 50k entry cap, 5 s TTL)
with exact -> fuzzy basename/path matching (Damerau-Levenshtein word
tolerance), and rewrite unique matches to canonical @absolute/path form.
Expansion only activates inside Git repositories.
"""

from __future__ import annotations

import os
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

SKIP_DIRS = frozenset(
    {".git", "node_modules", "dist", "build", "target", ".next",
     "__pycache__", ".venv"}
)
MAX_ENTRIES = 50_000
MAX_DEPTH = 10
INDEX_CACHE_TTL = 5.0

_AT_RE = re.compile(r'@([a-zA-Z0-9_\-./]+)|@"([^"]+)"')
_COMMAND_RE = re.compile(
    r"\b(at|include|reference|for|file)\s+(?:file\s+)?([^\n,;:!?]+)",
    re.IGNORECASE,
)
_SPOKEN_SPLIT_EXT = [
    (re.compile(r"\.\s*r\s*s\b", re.IGNORECASE), ".rs"),
    (re.compile(r"\.\s*t\s*s\b", re.IGNORECASE), ".ts"),
    (re.compile(r"\.\s*j\s*s\b", re.IGNORECASE), ".js"),
    (re.compile(r"\.\s*p\s*y\b", re.IGNORECASE), ".py"),
    (re.compile(r"\.\s*g\s*o\b", re.IGNORECASE), ".go"),
    (re.compile(r"\.\s*m\s*d\b", re.IGNORECASE), ".md"),
    (re.compile(r"\.\s*j\s*s\s*x\b", re.IGNORECASE), ".jsx"),
    (re.compile(r"\.\s*t\s*s\s*x\b", re.IGNORECASE), ".tsx"),
]
_TRAILING_AFTER_EXT = re.compile(
    r"^(.+?\.[a-z0-9]{1,10})(?:\s+.*)?$", re.IGNORECASE
)


@dataclass
class AtToken:
    token: str
    start: int
    end: int


def damerau_levenshtein(a: str, b: str) -> int:
    """Optimal string alignment distance (strsim::damerau_levenshtein)."""
    la, lb = len(a), len(b)
    if la == 0:
        return lb
    if lb == 0:
        return la
    prev2: List[int] = []
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (
                i > 1 and j > 1
                and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]
            ):
                cur[j] = min(cur[j], prev2[j - 2] + 1)
        prev2, prev = prev, cur
    return prev[lb]


def levenshtein(a: str, b: str) -> int:
    from .filters import levenshtein as _lev

    return _lev(a, b)


# ---------------------------------------------------------------------------
# Token parsing / normalization
# ---------------------------------------------------------------------------


def normalize_token(raw: str, spoken_alias: bool) -> str:
    s = raw.strip()
    if spoken_alias:
        for old, new in (
            (" dot ", "."), (" slash ", "/"), (" backslash ", "/"),
            (" underscore ", "_"), (" hyphen ", "-"), (" dash ", "-"),
        ):
            s = s.replace(old, new)
        for pattern, replacement in _SPOKEN_SPLIT_EXT:
            s = pattern.sub(replacement, s)
        m = _TRAILING_AFTER_EXT.match(s)
        if m:
            s = m.group(1)
    s = s.strip("\"'` \t\r\n")
    return s.rstrip(".,;:!?)]}")


def is_file_like_token(token: str) -> bool:
    return "/" in token or "." in token


def looks_bare_spoken_file_alias(token: str) -> bool:
    if not token or "/" in token or "." in token:
        return False
    if len(token.split()) != 1:
        return False
    return all(c.isascii() and (c.isalnum() or c in "_-") for c in token)


def looks_file_like_speech(raw: str) -> bool:
    lower = raw.lower()
    return (
        " dot " in lower or "." in lower or " slash " in lower
        or " backslash " in lower or "/" in lower
    )


def parse_at_tokens(text: str) -> List[AtToken]:
    tokens: List[AtToken] = []
    for m in _AT_RE.finditer(text):
        start = m.start()
        if start > 0:
            prev = text[start - 1]
            if (prev.isascii() and prev.isalnum()) or prev == "_":
                continue  # email-like
        if m.group(1) is not None:
            value = normalize_token(m.group(1), False)
        else:
            value = m.group(2).strip()
        if value:
            tokens.append(AtToken(value, start, m.end()))

    for m in _COMMAND_RE.finditer(text):
        trigger = m.group(1).lower()
        raw = (m.group(2) or "").strip()
        if "@" in raw:
            continue
        if trigger == "for" and not looks_file_like_speech(raw):
            continue
        value = normalize_token(raw, True)
        if value and (
            is_file_like_token(value) or looks_bare_spoken_file_alias(value)
        ):
            tokens.append(AtToken(value, m.start(), m.end()))
    return tokens


# ---------------------------------------------------------------------------
# Fuzzy matching
# ---------------------------------------------------------------------------


def normalize_to_words(s: str) -> List[str]:
    words: List[str] = []
    current = ""
    for ch in s:
        if ch in "_- .":
            if current:
                words.append(current.lower())
                current = ""
        elif ch.isupper() and current and current[-1].islower():
            words.append(current.lower())
            current = ch
        else:
            current += ch
    if current:
        words.append(current.lower())
    return words


def words_close_enough(token: str, candidate: str) -> bool:
    if token.lower() == candidate.lower():
        return True
    t, c = token.lower(), candidate.lower()
    if damerau_levenshtein(t, c) <= 1:
        return True
    d = levenshtein(t, c)
    return d <= 1 or (d == 2 and max(len(t), len(c)) >= 6)


def fuzzy_basename_match(token: str, filename: str) -> bool:
    stem = filename.rsplit(".", 1)[0] if "." in filename else filename
    token_words = normalize_to_words(token)
    stem_words = normalize_to_words(stem)
    if not token_words or not stem_words:
        return False
    if len(token_words) != len(stem_words):
        return False
    return all(words_close_enough(t, s) for t, s in zip(token_words, stem_words))


def extension_matches(token_ext: str, file_ext: str) -> bool:
    if not file_ext:
        return False
    if file_ext.lower() == token_ext.lower():
        return True
    if len(token_ext) < 3 or len(file_ext) < 3:
        return False
    t, f = token_ext.lower(), file_ext.lower()
    d = levenshtein(t, f)
    return d <= 1 or (d == 2 and abs(len(t) - len(f)) <= 1)


def _split_token_ext(token: str) -> Tuple[str, Optional[str]]:
    if "." in token:
        name, ext = token.rsplit(".", 1)
        if " " not in ext and len(ext) <= 10:
            return name, ext
    return token, None


def fuzzy_path_match(token: str, workspace_root: str, candidate: str) -> bool:
    try:
        rel = os.path.relpath(candidate, workspace_root)
    except ValueError:
        return False
    if rel.startswith(".."):
        return False
    token_parts = [p for p in token.split("/") if p]
    cand_parts = rel.split(os.sep)
    if not token_parts or len(token_parts) != len(cand_parts):
        return False
    for tp, cp in zip(token_parts[:-1], cand_parts[:-1]):
        if not fuzzy_basename_match(tp, cp):
            return False
    token_file, cand_file = token_parts[-1], cand_parts[-1]
    cand_stem, cand_ext = (
        cand_file.rsplit(".", 1) if "." in cand_file else (cand_file, "")
    )
    token_stem, token_ext = _split_token_ext(token_file)
    if token_ext is not None and not extension_matches(token_ext, cand_ext):
        return False
    return fuzzy_basename_match(token_stem, cand_stem)


def resolve_token(
    token: str, workspace_root: str, entries: Sequence[str]
) -> Optional[str]:
    """Unique exact match, else unique fuzzy match, else None."""
    if "/" in token:
        target = os.path.join(workspace_root, token)
        exact = [e for e in entries if e == target]
    else:
        exact = [e for e in entries if os.path.basename(e) == token]
    if len(exact) == 1:
        return exact[0]

    if "/" in token:
        fuzzy = [e for e in entries if fuzzy_path_match(token, workspace_root, e)]
        return fuzzy[0] if len(fuzzy) == 1 else None

    token_name, token_ext = _split_token_ext(token)
    fuzzy = []
    for e in entries:
        filename = os.path.basename(e)
        if token_ext is not None:
            file_ext = filename.rsplit(".", 1)[1] if "." in filename else ""
            if not extension_matches(token_ext, file_ext):
                continue
        if fuzzy_basename_match(token_name, filename):
            fuzzy.append(e)
    return fuzzy[0] if len(fuzzy) == 1 else None


# ---------------------------------------------------------------------------
# Workspace index
# ---------------------------------------------------------------------------

_index_cache: Dict[str, Tuple[float, List[str]]] = {}
_index_lock = threading.Lock()


def walk_workspace(root: str) -> List[str]:
    entries: List[str] = []
    root = os.path.abspath(root)
    base_depth = root.rstrip(os.sep).count(os.sep)
    for dirpath, dirnames, filenames in os.walk(root):
        if dirpath.count(os.sep) - base_depth >= MAX_DEPTH:
            dirnames[:] = []
            continue
        dirnames[:] = sorted(d for d in dirnames if d not in SKIP_DIRS)
        for fname in sorted(filenames):
            entries.append(os.path.join(dirpath, fname))
            if len(entries) >= MAX_ENTRIES:
                return entries
    return entries


def get_workspace_entries_cached(root: str) -> List[str]:
    now = time.monotonic()
    with _index_lock:
        hit = _index_cache.get(root)
        if hit is not None and now - hit[0] <= INDEX_CACHE_TTL:
            return hit[1]
        entries = walk_workspace(root)
        _index_cache[root] = (now, entries)
        return entries


# ---------------------------------------------------------------------------
# Snippet extraction (LLM context attachments)
# ---------------------------------------------------------------------------

MAX_LINES = 200
MAX_CHARS = 25_000

_EXT_TO_LANG = {
    "rs": "rust", "ts": "typescript", "tsx": "typescript",
    "js": "javascript", "jsx": "javascript", "py": "python", "go": "go",
    "java": "java", "c": "c", "h": "c", "cpp": "cpp", "hpp": "cpp",
    "cc": "cpp", "rb": "ruby", "sh": "bash", "bash": "bash", "json": "json",
    "yaml": "yaml", "yml": "yaml", "toml": "toml", "md": "markdown",
    "html": "html", "css": "css", "sql": "sql", "swift": "swift",
    "kt": "kotlin", "kts": "kotlin",
}


def ext_to_lang(path: str) -> str:
    ext = path.rsplit(".", 1)[1].lower() if "." in os.path.basename(path) else ""
    return _EXT_TO_LANG.get(ext, "")


def extract_snippet(path: str, workspace_root: str) -> Optional[str]:
    """Fenced snippet capped at MAX_LINES/MAX_CHARS; None for binary files."""
    try:
        with open(path, "rb") as f:
            content = f.read()
    except OSError:
        return None
    if b"\0" in content[:8192]:
        return None
    try:
        text = content.decode("utf-8")
    except UnicodeDecodeError:
        return None
    lines: List[str] = []
    size = 0
    for i, line in enumerate(text.splitlines()):
        if i >= MAX_LINES or size + len(line) > MAX_CHARS:
            break
        lines.append(line)
        size += len(line) + 1
    rel = os.path.relpath(path, workspace_root)
    lang = ext_to_lang(path)
    body = "\n".join(lines)
    return (
        "\n" + "-" * 60 + f"\n### Referenced file: {rel}\n```{lang}\n{body}\n```"
    )


# ---------------------------------------------------------------------------
# Expansion
# ---------------------------------------------------------------------------


def format_resolved_at_path(path: str) -> str:
    return f'@"{path}"' if " " in path else f"@{path}"


def expand_at_refs(text: str, workspace_root: str) -> str:
    tokens = parse_at_tokens(text)
    if not tokens:
        return text
    entries = get_workspace_entries_cached(workspace_root)
    replacements: List[Tuple[int, int, str]] = []
    for tok in tokens:
        path = resolve_token(tok.token, workspace_root, entries)
        if path is not None:
            replacements.append((tok.start, tok.end, format_resolved_at_path(path)))
    if not replacements:
        return text
    result = text
    for start, end, rep in sorted(replacements, key=lambda r: -r[0]):
        if end <= len(result):
            result = result[:start] + rep + result[end:]
    return result


def is_git_repository(start: str) -> bool:
    current = os.path.abspath(start)
    while True:
        if os.path.exists(os.path.join(current, ".git")):
            return True
        parent = os.path.dirname(current)
        if parent == current:
            return False
        current = parent


def maybe_expand_at_refs(
    text: str,
    enabled: bool,
    workspace_root: Optional[str] = None,
) -> str:
    """Pipeline entry point: expand when enabled, a workspace resolves, and
    it is inside a Git repository (at_file_expansion.rs:586-626)."""
    if not enabled:
        return text
    root = workspace_root or os.getcwd()
    if not os.path.isdir(root):
        return text
    if not is_git_repository(root):
        return text
    return expand_at_refs(text, root)
