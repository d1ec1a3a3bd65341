"""Domain selector: timeout-bounded routing of jargon profiles and prompts.

Port of spittle_tpu/managers/domain_selector.py.

Behavior-parity port of `src-tauri/src/managers/
domain_selector.rs`: token-overlap scoring of jargon profiles (terms x1.0,
correction-from x1.2, correction-to x1.0, normalized by |terms| + 1.5 *
|corrections|) and post-process prompts (id+name signature x1.8 plus
keyword hits x0.2), strict sidecar timeouts run on a worker thread with
fail-open semantics, top-k + min-score filtering, and hysteresis that keeps
the previous winner unless beaten by a margin.
"""

from __future__ import annotations

import queue
import re
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

from spittle_tpu_torch.config.settings import AppSettings, LLMPrompt
from spittle_tpu_torch.utils.logging import get_logger
from spittle_tpu_torch.text.jargon import (
    JargonCorrection,
    JargonProfile,
    builtin_profiles,
)


@dataclass
class DomainContext:
    text: str


@dataclass
class _Ranked:
    profile_id: str
    score: float


def tokenize(text: str) -> Set[str]:
    # Split on anything that is not alphanumeric/+/# — including '_'
    # (Rust char::is_alphanumeric excludes underscores, so ids like
    # "default_action_items" split into words; domain_selector.rs:268-273).
    tokens = set()
    for tok in re.split(r"[^\w+#]+|_+", text, flags=re.UNICODE):
        tok = tok.strip().lower()
        if len(tok.encode()) > 1:
            tokens.add(tok)
    return tokens


def token_overlap_ratio(context: Set[str], candidate: Set[str]) -> float:
    if not candidate:
        return 0.0
    return sum(1 for t in candidate if t in context) / len(candidate)

_log = get_logger("domain_selector")


def score_profiles(
    profiles: Dict[str, JargonProfile], text: str
) -> List[_Ranked]:
    context = tokenize(text)
    if not context:
        return []
    ranked = []
    for pid, profile in profiles.items():
        score = 0.0
        for term in profile.terms:
            score += token_overlap_ratio(context, tokenize(term)) * 1.0
        for corr in profile.corrections:
            ft = tokenize(corr.from_)
            if ft:
                score += token_overlap_ratio(context, ft) * 1.2
            tt = tokenize(corr.to)
            if tt:
                score += token_overlap_ratio(context, tt) * 1.0
        norm = max(len(profile.terms) + len(profile.corrections) * 1.5, 1.0)
        normalized = min(max(score / norm, 0.0), 1.0)
        if normalized > 0.0:
            ranked.append(_Ranked(pid, normalized))
    ranked.sort(key=lambda r: (-r.score, r.profile_id))
    return ranked


PROMPT_KEYWORDS = {
    "default_action_items": (
        "action item", "todo", "next steps", "owner", "deadline", "task",
    ),
    "default_document_writer": (
        "document", "proposal", "design doc", "write-up", "spec", "draft",
    ),
    "default_meeting_notes": (
        "meeting", "agenda", "decisions", "attendees", "recap", "notes",
    ),
    "default_slack_message": (
        "slack", "channel", "team update", "quick update", "message",
    ),
}


def score_prompts(prompts: Sequence[LLMPrompt], text: str) -> List[_Ranked]:
    context = tokenize(text)
    if not context:
        return []
    joined = text.lower()
    ranked = []
    for prompt in prompts:
        score = 0.0
        signature = f"{prompt.id} {prompt.name}"
        score += token_overlap_ratio(context, tokenize(signature)) * 1.8
        for kw in PROMPT_KEYWORDS.get(prompt.id, ()):
            if kw in joined:
                score += 0.2
        normalized = min(max(score, 0.0), 1.0)
        if normalized > 0.0:
            ranked.append(_Ranked(prompt.id, normalized))
    ranked.sort(key=lambda r: (-r.score, r.profile_id))
    return ranked


def build_profile_map(settings: AppSettings) -> Dict[str, JargonProfile]:
    profiles = dict(builtin_profiles())
    for pack in settings.jargon_packs:
        profiles[pack.id] = JargonProfile(
            label=pack.label,
            terms=list(pack.terms),
            corrections=[
                JargonCorrection(from_=c.from_, to=c.to) for c in pack.corrections
            ],
        )
    return profiles


def _run_with_timeout(fn, timeout_s: float):
    """Run fn on a worker thread; None on timeout OR failure (the sidecar
    fails open both ways — a crash must not escape the thread, and the
    caller must not block the full timeout waiting on a dead worker)."""
    out: "queue.Queue" = queue.Queue()

    def worker():
        try:
            out.put(fn())
        except Exception:
            _log.exception("domain-selector sidecar call failed")
            out.put(None)

    threading.Thread(target=worker, daemon=True, name="domain-sidecar").start()
    try:
        return out.get(timeout=timeout_s)
    except queue.Empty:
        return None


class DomainSelectorManager:
    def __init__(self):
        self._last: Optional[_Ranked] = None
        self._last_prompt: Optional[_Ranked] = None
        self._lock = threading.Lock()

    def select_profiles_with_timeout(
        self, settings: AppSettings, context: DomainContext
    ) -> Optional[List[str]]:
        if not settings.domain_selector_enabled:
            return None
        if not context.text.strip():
            return None
        timeout = max(settings.domain_selector_timeout_ms, 25) / 1000.0
        top_k = max(settings.domain_selector_top_k, 1)
        min_score = min(max(settings.domain_selector_min_score, 0.0), 1.0)
        hysteresis = min(max(settings.domain_selector_hysteresis, 0.0), 1.0)

        profiles = build_profile_map(settings)
        text = context.text
        ranked = _run_with_timeout(lambda: score_profiles(profiles, text), timeout)
        if ranked is None:
            return None

        selected = [r for r in ranked if r.score >= min_score][:top_k]
        if not selected:
            return None

        with self._lock:
            last = self._last
            if last is not None:
                top = selected[0]
                switched = top.profile_id != last.profile_id
                beat = top.score >= last.score + hysteresis
                if switched and not beat:
                    selected.insert(0, _Ranked(last.profile_id, last.score))
                    selected = selected[:top_k]
            self._last = _Ranked(selected[0].profile_id, selected[0].score)
        return [r.profile_id for r in selected]

    def select_post_process_prompt_with_timeout(
        self,
        settings: AppSettings,
        context: DomainContext,
        prompts: Sequence[LLMPrompt],
    ) -> Optional[str]:
        if not settings.post_process_auto_prompt_selection:
            return None
        if not context.text.strip() or not prompts:
            return None
        timeout = min(max(settings.domain_selector_timeout_ms, 10), 80) / 1000.0
        min_score = min(max(settings.domain_selector_min_score, 0.0), 1.0)
        hysteresis = min(max(settings.domain_selector_hysteresis, 0.0), 1.0)
        text = context.text[:2000]
        prompts_copy = list(prompts)
        ranked = _run_with_timeout(
            lambda: score_prompts(prompts_copy, text), timeout
        )
        if ranked is None or not ranked or ranked[0].score < min_score:
            return None
        with self._lock:
            last = self._last_prompt
            if last is not None:
                top = ranked[0]
                switched = top.profile_id != last.profile_id
                beat = top.score >= last.score + hysteresis
                if switched and not beat:
                    ranked.insert(0, _Ranked(last.profile_id, last.score))
            selected = ranked[0]
            self._last_prompt = _Ranked(selected.profile_id, selected.score)
        return selected.profile_id
