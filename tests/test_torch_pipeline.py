"""The port's TranscriptionPipeline against the JAX package's on the CPU:
the same fake transcribe, the same stub send_chat_completion, parametrised
over post-processing on and off, pasted segments, trailing space and
auto-submit, a Chinese variant, jargon and @file prompts, and the LLM's
failure modes. Each case must give the same TextOutput operations, the
same chat request, the same save_history arguments and the same final
state; llm_client's request and reply parsing are held on a local
transport. Every comparison is exact (host code, no tolerance)."""

import dataclasses
import json
import threading

import numpy as np
import pytest

from spittle_tpu import llm_client as jllm
from spittle_tpu import pipeline as jpipe
from spittle_tpu.config import settings as jset
from spittle_tpu.text import zh_convert as jzh
from spittle_tpu_torch import llm_client as tllm
from spittle_tpu_torch import pipeline as tpipe
from spittle_tpu_torch.config import settings as tset
from spittle_tpu_torch.text import zh_convert as tzh

PROMPT_ID = "default_improve_transcriptions"


def _post(**kw):
    base = dict(post_process_models={"openai": "gpt-x"},
                post_process_selected_prompt_id=PROMPT_ID,
                post_process_api_keys={"openai": "sk-test"})
    base.update(kw)
    return base


# (name, settings changes, post_process, pasted segments, transcription,
#  what the stub LLM answers: text, None, or "raise")
CASES = [
    ("plain", {}, False, [], "hello world", None),
    ("plain, empty transcription", {}, False, [], "", None),
    ("plain, segments", {}, False, ["Hello there. ", "how are "], "you today", None),
    ("plain, segments, nothing left", {}, False, ["only segments "], "", None),
    ("post, one word edited", _post(), True, [], "the quick brown fox",
     "the quick red fox"),
    ("post, segments", _post(), True, ["so we went. ", "to the"],
     "  market , then home", "So we went to the market, then home."),
    ("post, trailing space and enter", _post(append_trailing_space=True,
                                             auto_submit=True), True, [],
     "send it now", "Send it now."),
    ("post, ctrl+enter", _post(auto_submit=True, auto_submit_key="ctrl_enter"),
     True, [], "ship it", "Ship it."),
    ("post, auto-submit without paste", _post(auto_submit=True, paste_method="none",
                                              append_trailing_space=True),
     True, [], "no keys", "No keys."),
    ("post, llm fails open", _post(append_trailing_space=True), True, [],
     "keep me raw", "raise"),
    ("post, llm returns nothing", _post(), True, [], "still raw", None),
    ("post, leaked instructions scrubbed", _post(), True, [], "clean this",
     "Clean​ this.\n\nIMPORTANT: Use these exact spellings for technical "
     "terms: React, Vue\n\n"),
    ("post, no model set", {"post_process_selected_prompt_id": PROMPT_ID}, True, [],
     "no model", "unused"),
    ("post, zh-Hant", _post(selected_language="zh-Hant"), True, [],
     "头发软件网络", "頭髮軟體網路!"),
    ("post, zh-Hans, no llm answer", _post(selected_language="zh-Hans"), True, [],
     "頭髮軟體網路", None),
    ("post, jargon and @file", _post(jargon_enabled_profiles=["web_dev"],
                                     jargon_custom_terms=["Spittle"],
                                     at_file_expansion_enabled=True),
     True, [], "open @main.rs in type script", "Open @main.rs in TypeScript."),
    ("plain, @file expansion", dict(at_file_expansion_enabled=True), False, [],
     "look at @notes.md", None),
]


class RecordingOutput:
    """A package's BufferTextOutput with every call logged."""

    def __init__(self, pipe_mod):
        self.inner = pipe_mod.BufferTextOutput()
        self.ops = []

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def call(*args):
            self.ops.append((name, *args))
            return fn(*args)
        return call


def run_case(pipe_mod, set_mod, convert, case):
    name, changes, post_process, segments, transcription, answer = case
    settings = set_mod.AppSettings.from_dict(changes)
    chat, saved, hooks_log = [], [], []
    saved_evt = threading.Event()

    def send_chat_completion(provider, api_key, model, prompt, system):
        chat.append((dataclasses.asdict(provider), api_key, model, prompt, system))
        if answer == "raise":
            raise RuntimeError("HTTP 500")
        return answer

    def save_history(samples, raw, post, prompt):
        saved.append((np.asarray(samples).copy(), raw, post, prompt))
        saved_evt.set()

    hooks = pipe_mod.PipelineHooks(
        show_processing_overlay=lambda: hooks_log.append("processing"),
        hide_overlay=lambda: hooks_log.append("hide"),
        set_tray_idle=lambda: hooks_log.append("idle"),
        save_history=save_history,
        expand_at_refs=lambda t: t.replace("@notes.md", "[notes.md contents]"),
        convert_chinese=convert,
        send_chat_completion=send_chat_completion,
    )
    samples = np.random.default_rng(len(name)).standard_normal(1600).astype(np.float32)
    heard = []

    def transcribe(s):
        heard.append(np.asarray(s).copy())
        return transcription

    out = RecordingOutput(pipe_mod)
    pipe = pipe_mod.TranscriptionPipeline(
        samples=samples, pasted_segments=segments, settings=settings,
        post_process=post_process, binding_id="transcribe", transcribe=transcribe,
        output=out, hooks=hooks)
    pipe.run()
    if post_process and transcription + "".join(segments):
        assert saved_evt.wait(10)
    return dict(ops=out.ops, buffer=out.inner.buffer, keys=out.inner.keys,
                chat=chat, saved=[(s.tolist(), r, p, q) for s, r, p, q in saved],
                hooks=hooks_log, state=pipe.state.value, raw=pipe.raw_text,
                final=pipe.final_text, heard=[h.tolist() for h in heard])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pipeline_matches_reference(case):
    got = run_case(tpipe, tset, tzh.convert_chinese_variant, case)
    want = run_case(jpipe, jset, jzh.convert_chinese_variant, case)
    assert got == want
    assert got["state"] == "done"


def test_post_processed_text_is_patched_by_the_minimal_diff():
    """With the raw text already visible, the post-processed text lands as
    compute_text_diff's patch (the path the single-write flow skips)."""
    for pipe_mod, set_mod in ((tpipe, tset), (jpipe, jset)):
        out = pipe_mod.BufferTextOutput()
        out.paste_raw("the quick brown fox")
        pipe = pipe_mod.TranscriptionPipeline(
            samples=np.zeros(16, np.float32), pasted_segments=[],
            settings=set_mod.AppSettings(), post_process=True, binding_id="t",
            transcribe=lambda s: "", output=out)
        pipe.raw_text, pipe.final_text = "the quick brown fox", "the quick red fox"
        pipe._raw_text_pasted = True
        pipe._apply_diff_and_finalize()
        assert out.buffer == "the quick red fox"


def test_apple_intelligence_is_unavailable_until_the_shell():
    """The port's default hook asks shell/apple_llm.default_client(), which
    is None off macOS arm64 (as the reference's), so the provider reports
    unavailable and falls open."""
    hooks = tpipe.PipelineHooks()
    assert hooks.apple_intelligence_available() is False
    with pytest.raises(RuntimeError):
        hooks.apple_intelligence_process("p", 10)


@pytest.mark.parametrize("provider_id,api_key,system,reply", [
    ("openai", "sk-1", "be brief", {"choices": [{"message": {"content": "hi"}}]}),
    ("anthropic", "ak-2", None, {"choices": [{"message": {"content": " x "}}]}),
    ("custom", "", "s", {"choices": []}),
    ("groq", "g", "s", "not json"),
    ("openrouter", "o", "s", 500),
])
def test_llm_client_request_and_reply(provider_id, api_key, system, reply):
    def run(llm, set_mod):
        provider = next(p for p in set_mod.AppSettings().post_process_providers
                        if p.id == provider_id)
        sent = []

        def transport(url, headers, body, timeout):
            sent.append((url, headers, json.loads(body) if body else None, timeout))
            if isinstance(reply, int):
                return reply, b"error"
            raw = reply if isinstance(reply, str) else json.dumps(reply)
            return 200, raw.encode()
        try:
            result = llm.send_chat_completion(provider, api_key, "m", "prompt",
                                              system, transport=transport)
        except RuntimeError as exc:
            result = ("raised", str(exc))
        return sent, result

    assert run(tllm, tset) == run(jllm, jset)
