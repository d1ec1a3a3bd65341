"""Transcription pipeline: the Stopped -> RawTextVisible -> PostProcessed ->
Done state machine (port of spittle_tpu/pipeline.py).

Behavior-parity rebuild of `src-tauri/src/pipeline.rs`:
segment reconstruction + normalization (:27-49,207-254), single-write
post-process flow with minimal-diff patching (:401-497), LLM prompt
assembly with the dictation-safety system message, segment-artifact
instructions, jargon spelling injection and @file preservation note
(:663-810), leaked-instruction stripping + zero-width scrub (:663-697,
:877-881), Chinese variant conversion hook (:929-967), async history save
(:374-389), and trailing space / auto-submit (:533-590).

OS actions (paste, keystroke diffs, overlay, tray) go through the
TextOutput/UiFrontend protocols; the desktop shell binds them to the OS,
tests bind them to buffers.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from enum import Enum
from typing import Callable, List, Optional, Protocol, Sequence

import numpy as np

from spittle_tpu_torch.config.settings import (
    APPLE_INTELLIGENCE_PROVIDER_ID,
    AppSettings,
    AutoSubmitKey,
    PasteMethod,
)
from spittle_tpu_torch.managers.domain_selector import (
    DomainContext,
    DomainSelectorManager,
    build_profile_map,
)
from spittle_tpu_torch.text.diff import compute_text_diff
from spittle_tpu_torch.utils import threads
from spittle_tpu_torch.text.jargon import (
    JargonCorrection,
    JargonSettings,
    compute_active_dictionary,
)
from spittle_tpu_torch import llm_client

BASE_DICTATION_SYSTEM_MESSAGE = (
    "You are a dictation post-processor. Follow these rules strictly:\n"
    "1) Do not invent facts, events, names, owners, dates, or outcomes.\n"
    "2) Preserve the speaker's exact claims and intent.\n"
    "3) If a detail is uncertain or missing, keep it vague rather than guessing.\n"
    "4) Keep technical identifiers, code tokens, file paths, CLI flags, and "
    "URLs unchanged.\n"
    "5) Do not add extra explanation or commentary beyond the requested "
    "output format."
)

SEGMENT_ARTIFACTS_MESSAGE = (
    "This text was transcribed from multiple independent audio chunks during "
    "live dictation. The speech recognition model processed each segment "
    "separately, which causes several artifacts you must fix: missing spaces "
    "between segments (words from adjacent segments may be concatenated "
    "together without a space), incorrect sentence-ending punctuation "
    "inserted mid-thought (periods, ellipses where the speaker was just "
    "pausing), incorrect capitalization at segment boundaries (words "
    "capitalized because they started a new segment, not a new sentence), "
    "ellipses or trailing punctuation where the speaker simply paused, and "
    "utterance completion artifacts (the model may have added filler words "
    "or tried to complete a sentence at a segment boundary). Remove these "
    "artifacts and produce natural, flowing text that reflects what the "
    "speaker actually said."
)

_SPACE_BEFORE_PUNCT = re.compile(r"\s+([,.;:!?])")

_LEAKED_JARGON = re.compile(
    r"\n?\s*IMPORTANT:\s*Use these exact spellings for technical terms:"
    r"\s*.*?(?:\n\s*\n|$)",
    re.IGNORECASE | re.DOTALL,
)
_LEAKED_AT_FILE = re.compile(
    r"\n?\s*IMPORTANT:\s*Preserve any @file-style references exactly\s*"
    r"\(for example @main\.rs or @\"my file\.ts\"\)\.\s*Do not expand, "
    r"remove, or rewrite these references\.\s*",
    re.IGNORECASE | re.DOTALL,
)
_LEAKED_SEGMENT = re.compile(
    r"\n?\s*IMPORTANT:\s*This text was transcribed from multiple independent "
    r"audio segments split on silence\..*?Remove these artifacts and produce "
    r"natural, flowing text that reflects what the speaker actually said\.\s*",
    re.IGNORECASE | re.DOTALL,
)


def normalize_segment_text_for_post_process(text: str) -> str:
    collapsed = " ".join(text.split())
    return _SPACE_BEFORE_PUNCT.sub(r"\1", collapsed.strip())


def should_insert_boundary_space(left: str, right: str) -> bool:
    if not left or not right:
        return False
    ll, rf = left[-1], right[0]
    return (
        not ll.isspace()
        and ll not in "([{\"'"
        and not rf.isspace()
        and rf not in ".,;:!?)]}"
    )


def strip_leaked_prompt_instructions(text: str) -> str:
    text = _LEAKED_JARGON.sub("\n", text)
    text = _LEAKED_AT_FILE.sub("\n", text)
    text = _LEAKED_SEGMENT.sub("\n", text)
    return text.strip()


def scrub_invisible(text: str) -> str:
    for ch in ("​", "‌", "‍", "﻿"):
        text = text.replace(ch, "")
    return text


# ---------------------------------------------------------------------------
# Output / UI seams
# ---------------------------------------------------------------------------


class TextOutput(Protocol):
    """Where final text goes (clipboard.rs paste/paste_raw/apply_text_diff)."""

    def paste(self, text: str) -> None: ...

    def paste_raw(self, text: str) -> None: ...

    def apply_text_diff(self, suffix_chars: int, delete_chars: int, insert: str) -> None: ...

    def press_key(self, key: str) -> None: ...


class BufferTextOutput:
    """In-memory visible-text buffer implementing TextOutput (tests/harness).

    paste() appends a trailing space like the reference's live segment paste;
    paste_raw() appends verbatim."""

    def __init__(self):
        self.buffer = ""
        self.keys: List[str] = []

    def paste(self, text: str) -> None:
        self.buffer += text + " "

    def paste_raw(self, text: str) -> None:
        self.buffer += text

    def apply_text_diff(self, suffix_chars: int, delete_chars: int, insert: str) -> None:
        keep = len(self.buffer) - suffix_chars - delete_chars
        suffix = self.buffer[len(self.buffer) - suffix_chars:] if suffix_chars else ""
        self.buffer = self.buffer[:keep] + insert + suffix

    def press_key(self, key: str) -> None:
        self.keys.append(key)


class PipelineState(Enum):
    STOPPED = "stopped"
    RAW_TEXT_VISIBLE = "raw_text_visible"
    POST_PROCESSED = "post_processed"
    DONE = "done"


def _apple_llm_default_available() -> bool:
    """The port has no shell yet (spittle_tpu/shell/apple_llm.py, the
    macOS arm64 FoundationModels shim, comes with the shell slice), so the
    provider reports unavailable: what the reference's hook returns off
    macOS, where the pipeline falls open to the raw transcription."""
    return False


def _apple_llm_default_process(prompt: str, token_limit: int) -> str:
    raise RuntimeError("Apple Intelligence shim is not loaded")


@dataclass
class PipelineHooks:
    """Optional integration points (overlay/tray/history/at-file/OpenCC)."""

    show_processing_overlay: Callable[[], None] = lambda: None
    hide_overlay: Callable[[], None] = lambda: None
    set_tray_idle: Callable[[], None] = lambda: None
    save_history: Optional[Callable[..., None]] = None
    expand_at_refs: Optional[Callable[[str], str]] = None
    convert_chinese: Optional[Callable[[str, str], Optional[str]]] = None
    send_chat_completion: Callable = llm_client.send_chat_completion
    # Apple Intelligence FFI seam (pipeline.rs:817,831): unavailable until
    # the port carries the shell (see _apple_llm_default_available).
    apple_intelligence_available: Callable[[], bool] = (
        lambda: _apple_llm_default_available())
    apple_intelligence_process: Callable[[str, int], str] = (
        lambda prompt, limit: _apple_llm_default_process(prompt, limit))


class TranscriptionPipeline:
    """Drives one utterance from samples to pasted (and post-processed) text."""

    def __init__(
        self,
        samples: np.ndarray,
        pasted_segments: Sequence[str],
        settings: AppSettings,
        post_process: bool,
        binding_id: str,
        transcribe: Callable[[np.ndarray], str],
        output: TextOutput,
        hooks: Optional[PipelineHooks] = None,
        domain_selector: Optional[DomainSelectorManager] = None,
    ):
        self.samples = np.asarray(samples, np.float32)
        self.pasted_segments = list(pasted_segments)
        self.settings = settings
        self.post_process = post_process
        self.binding_id = binding_id
        self.transcribe = transcribe
        self.output = output
        self.hooks = hooks or PipelineHooks()
        self.domain_selector = domain_selector
        self.state = PipelineState.STOPPED
        # Exposed after run() for tests / the shell:
        self.raw_text = ""
        self.final_text = ""

    # -- run ------------------------------------------------------------

    def run(self) -> None:
        try:
            raw = self._transcribe_and_paste()
            if raw is None:
                # Empty transcription (e.g. pure silence) is a terminal state
                # too: the overlay/tray must still be reset here, not only on
                # the success and exception paths.
                self.hooks.hide_overlay()
                self.hooks.set_tray_idle()
                self.state = PipelineState.DONE
                return
            if not self.post_process:
                self._finalize()
                return
            self._post_process_text()
            self._apply_diff_and_finalize()
        except Exception:
            self.hooks.hide_overlay()
            self.hooks.set_tray_idle()
            self.state = PipelineState.DONE
            raise

    # -- transitions -----------------------------------------------------

    def _expand(self, text: str) -> str:
        if not self.settings.at_file_expansion_enabled:
            return text
        if self.hooks.expand_at_refs is None:
            return text
        return self.hooks.expand_at_refs(text)

    def _transcribe_and_paste(self) -> Optional[str]:
        remaining = self.transcribe(self.samples)
        joined = "".join(self.pasted_segments)
        transcription = (
            remaining if not self.pasted_segments
            else joined if not remaining
            else joined + remaining
        )
        if not transcription:
            return None

        if self.post_process:
            had_segments = bool(self.pasted_segments)
            cleaned_remaining = (
                normalize_segment_text_for_post_process(remaining)
                if had_segments and remaining
                else remaining
            )
            if had_segments:
                if not cleaned_remaining:
                    raw_text = joined
                elif should_insert_boundary_space(joined, cleaned_remaining):
                    raw_text = f"{joined} {cleaned_remaining}"
                else:
                    raw_text = joined + cleaned_remaining
            else:
                raw_text = transcription
            self.raw_text = raw_text
            self._had_segments = had_segments
            self._raw_text_pasted = False  # single-write mode
            self.hooks.show_processing_overlay()
            self.state = PipelineState.RAW_TEXT_VISIBLE
            return raw_text

        # Non-post-process path: paste now.
        if not self.pasted_segments:
            self.output.paste(self._expand(transcription))
        elif remaining:
            self.output.paste(self._expand(remaining))
        self.raw_text = self.final_text = transcription
        self.hooks.hide_overlay()
        self.hooks.set_tray_idle()
        self.state = PipelineState.DONE
        return transcription

    def _post_process_text(self) -> None:
        raw_text = self.raw_text
        final_text = raw_text
        post_processed_text: Optional[str] = None
        post_process_prompt: Optional[str] = None

        converted = self._maybe_convert_chinese_variant(raw_text)
        if converted is not None:
            final_text = converted

        processed = self._post_process_transcription(final_text, self._had_segments)
        if processed is not None:
            post_processed_text = processed
            final_text = processed
            pid = self.settings.post_process_selected_prompt_id
            if pid:
                for p in self.settings.post_process_prompts:
                    if p.id == pid:
                        post_process_prompt = p.prompt
                        break
        elif final_text != raw_text:
            post_processed_text = final_text

        if self.hooks.save_history is not None:
            threads.spawn(
                self.hooks.save_history,
                args=(self.samples, raw_text, post_processed_text,
                      post_process_prompt),
                name="save-history",
            )

        self.final_text = self._expand(final_text)
        self.state = PipelineState.POST_PROCESSED

    def _apply_diff_and_finalize(self) -> None:
        raw_text, final_text = self.raw_text, self.final_text
        if not self._raw_text_pasted:
            if final_text:
                self.output.paste_raw(final_text)
            self._apply_trailing_space_and_autosubmit()
        else:
            diff = compute_text_diff(raw_text, final_text)
            if diff is not None:
                self.output.apply_text_diff(
                    diff.suffix_chars, diff.delete_chars, diff.insert
                )
            self._apply_trailing_space_and_autosubmit()
        self.hooks.hide_overlay()
        self.hooks.set_tray_idle()
        self.state = PipelineState.DONE

    def _finalize(self) -> None:
        self.hooks.hide_overlay()
        self.hooks.set_tray_idle()
        self.state = PipelineState.DONE

    def _apply_trailing_space_and_autosubmit(self) -> None:
        s = self.settings
        if s.append_trailing_space:
            self.output.paste_raw(" ")
        if s.auto_submit and s.paste_method is not PasteMethod.NONE:
            self.output.press_key(
                {
                    AutoSubmitKey.ENTER: "enter",
                    AutoSubmitKey.CTRL_ENTER: "ctrl+enter",
                    AutoSubmitKey.CMD_ENTER: "cmd+enter",
                }[s.auto_submit_key]
            )

    # -- LLM post-processing --------------------------------------------

    def _active_provider(self):
        for p in self.settings.post_process_providers:
            if p.id == self.settings.post_process_provider_id:
                return p
        return None

    def _select_prompt_id(self, transcription: str) -> Optional[str]:
        fallback = self.settings.post_process_selected_prompt_id
        if not self.settings.post_process_auto_prompt_selection:
            return fallback
        if self.domain_selector is None:
            return fallback
        selected = self.domain_selector.select_post_process_prompt_with_timeout(
            self.settings, DomainContext(text=transcription),
            self.settings.post_process_prompts,
        )
        return selected or fallback

    def _effective_profiles_for_text(self, text: str) -> List[str]:
        profile_ids = list(self.settings.jargon_enabled_profiles)
        if self.domain_selector is not None:
            auto = self.domain_selector.select_profiles_with_timeout(
                self.settings, DomainContext(text=text)
            )
            if auto:
                if self.settings.domain_selector_blend_manual_profiles:
                    for p in auto:
                        if p not in profile_ids:
                            profile_ids.append(p)
                else:
                    profile_ids = auto
        return profile_ids

    def _post_process_transcription(
        self, transcription: str, had_segments: bool
    ) -> Optional[str]:
        s = self.settings
        provider = self._active_provider()
        if provider is None:
            return None
        model = s.post_process_models.get(provider.id, "")
        if not model.strip():
            return None
        prompt_id = self._select_prompt_id(transcription)
        if not prompt_id:
            return None
        prompt = next(
            (p.prompt for p in s.post_process_prompts if p.id == prompt_id), None
        )
        if not prompt or not prompt.strip():
            return None

        processed_prompt = prompt.replace("${output}", transcription)

        system_parts = [BASE_DICTATION_SYSTEM_MESSAGE]
        if had_segments:
            system_parts.append(SEGMENT_ARTIFACTS_MESSAGE)
        system_message = "\n\n".join(system_parts)

        if (
            s.jargon_enabled_profiles
            or s.jargon_custom_terms
            or s.jargon_packs
        ):
            jargon = JargonSettings(
                enabled_profiles=self._effective_profiles_for_text(transcription),
                custom_terms=list(s.jargon_custom_terms),
                custom_corrections=[
                    JargonCorrection(from_=c.from_, to=c.to)
                    for c in s.jargon_custom_corrections
                ],
            )
            dictionary = compute_active_dictionary(jargon, build_profile_map(s))
            if dictionary.terms:
                processed_prompt += (
                    "\n\nIMPORTANT: Use these exact spellings for technical "
                    "terms: " + ", ".join(dictionary.terms)
                )

        if s.at_file_expansion_enabled:
            processed_prompt += (
                '\n\nIMPORTANT: Preserve any @file-style references exactly '
                '(for example @main.rs or @"my file.ts"). Do not expand, '
                "remove, or rewrite these references."
            )

        if provider.id == APPLE_INTELLIGENCE_PROVIDER_ID:
            # On-device FoundationModels provider (pipeline.rs:815-856):
            # no system-message support, so the system text is folded
            # into the prompt; the provider's "model" field carries a
            # word-budget integer; every failure falls open to the raw
            # transcription. Off-macOS the hook reports unavailable,
            # matching the reference's cfg stub (:852-856).
            if not self.hooks.apple_intelligence_available():
                return None
            ai_prompt = (
                f"[System instruction: {system_message}]\n\n{processed_prompt}"
                if system_message
                else processed_prompt
            )
            try:
                token_limit = int(model.strip())
            except ValueError:
                token_limit = 0
            try:
                result = self.hooks.apple_intelligence_process(
                    ai_prompt, token_limit
                )
            except RuntimeError:
                return None  # error path logs + falls open (:845-848)
            sanitized = strip_leaked_prompt_instructions(result)
            if not sanitized.strip():
                return None
            return sanitized

        api_key = s.post_process_api_keys.get(provider.id, "")
        try:
            content = self.hooks.send_chat_completion(
                provider, api_key, model, processed_prompt, system_message
            )
        except RuntimeError:
            return None  # fail open to the raw transcription (:888-899)
        if content is None:
            return None
        return strip_leaked_prompt_instructions(scrub_invisible(content))

    def _maybe_convert_chinese_variant(self, text: str) -> Optional[str]:
        lang = self.settings.selected_language
        if lang not in ("zh-Hans", "zh-Hant"):
            return None
        if self.hooks.convert_chinese is None:
            return None
        return self.hooks.convert_chinese(lang, text)
