"""The port's text chain and settings against the JAX package on the CPU:
compute_text_diff, filter_transcription_output, apply_custom_words, the
jargon dictionary, initial prompt and corrections, convert_chinese_variant,
the settings store across the two packages, and the copied JSON data.
Every comparison is exact (host string code, no tolerance)."""

import dataclasses
import filecmp
import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spittle_tpu.config import catalog as jcat
from spittle_tpu.config import settings as jset
from spittle_tpu.managers import domain_selector as jds
from spittle_tpu.text import diff as jdiff
from spittle_tpu.text import filters as jfil
from spittle_tpu.text import jargon as jjar
from spittle_tpu.text import zh_convert as jzh
from spittle_tpu_torch.config import catalog as tcat
from spittle_tpu_torch.config import settings as tset
from spittle_tpu_torch.managers import domain_selector as tds
from spittle_tpu_torch.text import diff as tdiff
from spittle_tpu_torch.text import filters as tfil
from spittle_tpu_torch.text import jargon as tjar
from spittle_tpu_torch.text import zh_convert as tzh

# tests/test_properties.py's alphabets: printable codepoints up to U+2FFF,
# and a small alphabet with accents and CJK that makes shared prefixes
# and suffixes likely.
TEXT = st.text(alphabet=st.characters(min_codepoint=32, max_codepoint=0x2FFF),
               max_size=60)
SMALL_TEXT = st.text(alphabet=st.sampled_from("abcdefg äöü 日本"), max_size=24)
WORDS = st.lists(st.sampled_from(
    ["um", "uh", "hello", "Hello", "world", "I", "so", "Chat", "G", "P", "T",
     "helo", "wrold", "GPT4", "next", "js", "kubernetes", "cube", "ernetes",
     "w", "wh", "why", ",", ".", "that's", "right", "Mac", "Book", "Pro"]),
    max_size=14).map(" ".join)

# The JAX tests' own cases (tests/test_text_diff.py, test_text_filters.py).
DIFF_CASES = [
    ("hello world", "hello world"), ("abc", "xyz"),
    ("hello world", "hello there"), ("good morning", "bad morning"),
    ("the quick brown fox", "the slow brown fox"), ("hello world", "hello big world"),
    ("hello big world", "hello world"), ("so um I think we should go", "I think we should go"),
    ("hello world", "hello world."), ("one two three four", "one 2 three four"),
    ("So um like I was thinking. uh we should", "So I was thinking we should"),
    ("hello worldthis is a test", "hello world this is a test"),
    ("hello world ", "Hello world."), ("", "something"), ("something", ""),
    ("this is great. and. um. we should", "This is great, and we should."),
]
FILTER_CASES = [
    "So um I was thinking uh about this", "UM this is UH a test",
    "Well, um, I think, uh. that's right", "Hello    world   test",
    "  Hello world  ", "  Um, so I was, uh, thinking about this  ",
    "This is a perfectly normal sentence.", "w wh wh wh wh wh wh wh wh wh why",
    "I I I I think so so so so", "No NO no NO no", "I I think so",
    "", "um", "Thank you.", "thanks for watching!", "you", ". . .",
]
CUSTOM_CASES = [
    ("hello world", ["Hello", "World"], 0.5), ("helo wrold", ["hello", "world"], 0.5),
    ("hello world", [], 0.5), ("I use Chat G P T daily", ["ChatGPT"], 0.5),
    ("use Chat G P T for this", ["ChatGPT"], 0.5), ("Open AI GPT model", ["OpenAI", "GPT"], 0.5),
    ("CHARGE B is great", ["ChargeBee"], 0.5), ("using Mac Book Pro", ["MacBook Pro"], 0.5),
    ("use GPT4 for this", ["GPT-4"], 0.5), ("kubernetes, helm.", ["Kubernetes", "Helm"], 0.3),
]
PROFILES = sorted(jjar.builtin_profiles())
ZH_CASES = [
    ("zh-Hans", "頭髮軟體網路資訊"), ("zh-Hant", "头发软件网络信息"),
    ("zh-Hant", "皇后发现了面条里只有一只虫"), ("zh-Hans", "我們應該開發這個軟體"),
    ("en", "hello"), ("zh-Hans", ""), ("zh-Hant", "mixed 中文 and English 计算机"),
]


@pytest.mark.parametrize("original,processed", DIFF_CASES)
def test_text_diff_cases(original, processed):
    assert tdiff.compute_text_diff(original, processed) == _diff(
        jdiff.compute_text_diff(original, processed))


def _diff(d):
    return None if d is None else tdiff.TextDiff(**dataclasses.asdict(d))


@settings(max_examples=80, deadline=None)
@given(st.one_of(TEXT, SMALL_TEXT), st.one_of(TEXT, SMALL_TEXT))
def test_text_diff_hypothesis(original, processed):
    got = tdiff.compute_text_diff(original, processed)
    assert got == _diff(jdiff.compute_text_diff(original, processed))
    if got is not None:
        assert tdiff.apply_text_diff(original, got) == processed


@pytest.mark.parametrize("text", FILTER_CASES)
def test_filter_cases(text):
    assert tfil.filter_transcription_output(text) == jfil.filter_transcription_output(text)


@settings(max_examples=80, deadline=None)
@given(st.one_of(TEXT, WORDS))
def test_filter_hypothesis(text):
    assert tfil.filter_transcription_output(text) == jfil.filter_transcription_output(text)


@pytest.mark.parametrize("text,words,threshold", CUSTOM_CASES)
def test_custom_words_cases(text, words, threshold):
    assert (tfil.apply_custom_words(text, words, threshold)
            == jfil.apply_custom_words(text, words, threshold))


@settings(max_examples=60, deadline=None)
@given(WORDS, st.lists(st.sampled_from(
    ["ChatGPT", "OpenAI", "GPT-4", "Kubernetes", "MacBook Pro", "hello", "NextJS"]),
    max_size=4), st.sampled_from([0.18, 0.3, 0.5]))
def test_custom_words_hypothesis(text, words, threshold):
    assert (tfil.apply_custom_words(text, words, threshold)
            == jfil.apply_custom_words(text, words, threshold))


def test_levenshtein_native_and_python_agree():
    """The port's native Levenshtein (native/spittle_audio.cpp, built by
    the port's loader) equals its Python loop and the JAX package's."""
    pairs = [("kitten", "sitting"), ("", "abc"), ("日本語", "日本"), ("flaw", "lawn")]
    for a, b in pairs:
        want = jfil.levenshtein(a, b)
        assert tfil.levenshtein(a, b) == want == tfil._levenshtein_py(a, b)
    assert tfil._resolve_native_lev(), "g++ builds the native library here"


def _jargon(mod, profiles, terms, corrections):
    return mod.JargonSettings(
        enabled_profiles=list(profiles), custom_terms=list(terms),
        custom_corrections=[mod.JargonCorrection(f, t) for f, t in corrections])


def _dict_of(d):
    return (list(d.terms), [(c.from_, c.to) for c in d.corrections])


JARGON_CASES = [
    ((), (), ()), (("web_dev", "devops"), (), ()),
    (("web_dev",), ("typescript",), (("next js", "NextJS"),)),
    (tuple(PROFILES), ("Foo", "bar baz"), (("cube ernetes", "Kubernetes"),)),
    (("law_enforcement", "business"), (), ()), (("coding",), ("x" * 400,), ()),
]


@pytest.mark.parametrize("profiles,terms,corrections", JARGON_CASES)
def test_jargon_dictionary_and_prompt(profiles, terms, corrections):
    jd = jjar.compute_active_dictionary(_jargon(jjar, profiles, terms, corrections))
    td = tjar.compute_active_dictionary(_jargon(tjar, profiles, terms, corrections))
    assert _dict_of(td) == _dict_of(jd)
    assert tjar.build_initial_prompt(td) == jjar.build_initial_prompt(jd)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(PROFILES), max_size=3, unique=True),
       st.one_of(WORDS, TEXT,
                 st.just("deploy to `kube ctl` at https://next.js/x and ./next js --next-js")))
def test_jargon_corrections_hypothesis(profiles, text):
    corrections = (("next js", "Next.js"), ("kube ctl", "kubectl"))
    jd = jjar.compute_active_dictionary(_jargon(jjar, profiles, (), corrections))
    td = tjar.compute_active_dictionary(_jargon(tjar, profiles, (), corrections))
    assert (tjar.apply_corrections(text, td.corrections)
            == jjar.apply_corrections(text, jd.corrections))


def test_jargon_profile_map_from_settings():
    """build_profile_map over settings with a user pack: the same profiles."""
    pack = dict(id="mine", label="Mine", terms=["Zed"],
                corrections=[{"from": "zee", "to": "Zed"}])
    js = jset.AppSettings.from_dict({"jargon_packs": [pack]})
    ts = tset.AppSettings.from_dict({"jargon_packs": [pack]})
    jm, tm = jds.build_profile_map(js), tds.build_profile_map(ts)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert (tm[k].label, tm[k].terms, [(c.from_, c.to) for c in tm[k].corrections]) == (
            jm[k].label, jm[k].terms, [(c.from_, c.to) for c in jm[k].corrections])


@pytest.mark.parametrize("lang,text", ZH_CASES)
def test_convert_chinese_variant_cases(lang, text):
    assert tzh.convert_chinese_variant(lang, text) == jzh.convert_chinese_variant(lang, text)


@settings(max_examples=60, deadline=None)
@given(st.sampled_from(["zh-Hans", "zh-Hant", "auto"]),
       st.text(alphabet=st.sampled_from("头發发髮软體件网络網路里裡面麵只隻干乾 abc"),
               max_size=30))
def test_convert_chinese_variant_hypothesis(lang, text):
    assert tzh.convert_chinese_variant(lang, text) == jzh.convert_chinese_variant(lang, text)


def _changed(mod):
    """Settings with fields of every kind away from their defaults."""
    s = mod.AppSettings.from_dict({
        "push_to_talk": False, "selected_language": "zh-Hant",
        "custom_words": ["ChatGPT", "Kubernetes"], "word_correction_threshold": 0.3,
        "model_unload_timeout": "min5", "paste_method": "direct",
        "auto_submit": True, "auto_submit_key": "ctrl_enter",
        "post_process_enabled": True, "post_process_models": {"openai": "gpt-x"},
        "post_process_selected_prompt_id": "default_improve_transcriptions",
        "jargon_enabled_profiles": ["web_dev"],
        "jargon_custom_corrections": [{"from": "next js", "to": "Next.js"}],
        "audio_segment_size_seconds": 2.5, "append_trailing_space": True,
        "bindings": {"transcribe": {"id": "transcribe", "name": "T",
                                    "description": "d", "default_binding": "ctrl+space",
                                    "current_binding": "alt+space"}},
    })
    return s


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_settings_store_crosses_packages(tmp_path, writer):
    """A settings_store.json written by one package loads in the other
    with every field equal (enums by value)."""
    path = str(tmp_path / "settings_store.json")
    src, dst = (jset, tset) if writer == "jax" else (tset, jset)
    written = _changed(src)
    src.SettingsStore(path).save(written)
    loaded = dst.SettingsStore(path).load()
    assert loaded.to_dict() == written.to_dict()
    assert loaded.to_dict() == _changed(dst).to_dict()
    for k in ("model_unload_timeout", "paste_method", "auto_submit_key"):
        assert getattr(loaded, k).value == getattr(written, k).value


@pytest.mark.parametrize("key,value", [
    ("model_unload_timeout", "sec5"), ("paste_method", "none"),
    ("selected_language", "en"), ("audio_feedback_volume", 0.25),
    ("post_process_api_keys", {"openai": "k"}),
])
def test_coerce_setting(key, value):
    got, want = tset.coerce_setting(key, value), jset.coerce_setting(key, value)
    assert getattr(got, "value", got) == getattr(want, "value", want)


@pytest.mark.parametrize("name", ["builtin_prompts", "jargon_profiles",
                                  "model_catalog"])
def test_config_data_is_the_reference_bytes(name):
    ours = os.path.join(os.path.dirname(tset.__file__), "data", f"{name}.json")
    ref = os.path.join(os.path.dirname(jset.__file__), "data", f"{name}.json")
    assert filecmp.cmp(ours, ref, shallow=False)


def test_catalog_and_builtin_prompts():
    assert (dataclasses.asdict(tcat.load_model_catalog())
            == dataclasses.asdict(jcat.load_model_catalog()))
    assert ([(p.id, p.name, p.prompt) for p in tset.builtin_post_process_prompts()]
            == [(p.id, p.name, p.prompt) for p in jset.builtin_post_process_prompts()])
