"""The port's tokenizer.json reader (spittle_tpu_torch/text/hf_tokenizer.py)
against the `tokenizers` package on files this test builds: the WordLevel +
Whitespace form of tests/test_t5_cleanup_provider.py's checkpoint, and
the form HF's T5 conversion writes (Unigram with <extra_id_N> added
tokens; Sequence[Precompiled, Strip(right), Replace(" {2,}", "▁")];
Metaspace pre-tokenizer and decoder; TemplateProcessing appending </s>)
with a charsmap built by hand, under each Metaspace prepend scheme, the
older add_prefix_space field and a Sequence[WhitespaceSplit, Metaspace].
ids and decoded text must be equal, on fixed strings and on text drawn
from the vocabulary's characters (hypothesis)."""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")

from spittle_tpu_torch.text.hf_tokenizer import (  # noqa: E402
    HFTokenizer,
    build_precompiled_charsmap,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_EXTRA = 4
# The charsmap: full-width and ligature forms, an ideographic space, a
# decomposed é, and a key ("x") that is a prefix of another ("x" + a
# combining acute): tokenizers takes the first match for a grapheme.
CHARSMAP = {"Ａ": "A", "Ｂ": "B", "ﬁ": "fi", "　": " ", "é": "é",
            "x": "x", "x́": "X", "ｶ": "カ", "Ω": ""}
ALPHABET = "abcdefghxyzé AB.,!?-'"
EXTRA_CHARS = "Ａﬁ　́ｶﾞΩ\t\n"
STRINGS = [
    "", " ", "a", "hello world", "  leading and trailing  ", "ab  cd   e",
    "xＡyＡ", "ﬁne ﬁx", "caf́e x́ x́́́", "ｶﾞ ｶ",
    "a<extra_id_0>b <extra_id_1> c<extra_id_3>", "</s>x<pad>", "<unk>",
    "Ωmega Ω", "tab\tand\nnew line", "a　　b", "zzz qqq ☃ unknown",
    "gibberish!?,.", "<extra_id_0><extra_id_2>", "A  B. c-d'e",
]


def _unigram_vocab(seed=0):
    rng = np.random.default_rng(seed)
    letters = sorted(set("abcdefghxyzéABXfi.,!?-'カ"))
    pieces = ["▁"] + letters + ["▁" + c for c in letters]
    for _ in range(120):
        n = int(rng.integers(2, 5))
        w = "".join(rng.choice(letters[:12], n))
        pieces.append(("▁" + w) if rng.random() < 0.5 else w)
    pieces = list(dict.fromkeys(pieces))
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    vocab += [(p, float(-rng.uniform(1.0, 12.0))) for p in pieces]
    vocab += [(f"<extra_id_{i}>", 0.0) for i in range(N_EXTRA - 1, -1, -1)]
    return vocab


def _t5_spec(scheme="always", whitespace_split=False, legacy=False) -> str:
    """A T5-form tokenizer.json's text, written by the tokenizers package."""
    from tokenizers import (
        AddedToken,
        Regex,
        Tokenizer,
        decoders,
        models,
        normalizers,
        pre_tokenizers,
        processors,
    )

    vocab = _unigram_vocab()
    tok = Tokenizer(models.Unigram(vocab, unk_id=2, byte_fallback=False))
    tok.add_tokens([AddedToken(p, normalized=False, special=True)
                    for p, _ in vocab if p.startswith("<")])
    tok.normalizer = normalizers.Sequence([
        normalizers.Precompiled(build_precompiled_charsmap(CHARSMAP)),
        normalizers.Strip(left=False, right=True),
        normalizers.Replace(Regex(" {2,}"), "▁")])
    meta = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=scheme)
    tok.pre_tokenizer = (pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(),
                                                  meta])
                         if whitespace_split else meta)
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme=scheme)
    tok.post_processor = processors.TemplateProcessing(
        single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"],
        special_tokens=[("</s>", 1)])
    spec = json.loads(tok.to_str())
    if legacy:  # the older files: add_prefix_space in place of the scheme
        for part in (spec["pre_tokenizer"], spec["decoder"]):
            del part["prepend_scheme"], part["split"]
            part["add_prefix_space"] = True
    return json.dumps(spec)


def _t5_form(path, **kw):
    path.write_text(_t5_spec(**kw), encoding="utf-8")
    return str(path)


def _word_level_spec() -> str:
    """tests/test_t5_cleanup_provider.py:_make_checkpoint's tokenizer."""
    words = ["<pad>", "</s>", "<unk>"] + [f"w{i}" for i in range(61)]
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(
        {w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    return tok.to_str()


def _word_level(path):
    path.write_text(_word_level_spec(), encoding="utf-8")
    return str(path)


FORMS = {
    "always": dict(scheme="always"),
    "first": dict(scheme="first"),
    "never": dict(scheme="never"),
    "legacy_add_prefix_space": dict(legacy=True),
    "whitespace_split": dict(whitespace_split=True),
    "whitespace_split_first": dict(whitespace_split=True, scheme="first"),
}


@pytest.fixture(scope="module", params=sorted(FORMS))
def t5_pair(request, tmp_path_factory):
    path = _t5_form(tmp_path_factory.mktemp("tok") / "tokenizer.json",
                    **FORMS[request.param])
    return HFTokenizer.from_file(path), tokenizers.Tokenizer.from_file(path)


@pytest.fixture(scope="module")
def word_pair(tmp_path_factory):
    path = _word_level(tmp_path_factory.mktemp("tok") / "tokenizer.json")
    return HFTokenizer.from_file(path), tokenizers.Tokenizer.from_file(path)


def _same(ours, ref, text):
    want = ref.encode(text).ids
    got = ours.encode(text).ids
    assert got == want, text
    assert ours.decode(got) == ref.decode(want), text


@pytest.mark.parametrize("text", STRINGS)
def test_t5_form_matches_tokenizers(t5_pair, text):
    _same(*t5_pair, text)


def test_t5_form_decodes_any_ids(t5_pair):
    ours, ref = t5_pair
    rng = np.random.default_rng(1)
    n = ref.get_vocab_size()
    for _ in range(50):
        ids = rng.integers(0, n, int(rng.integers(0, 12))).tolist()
        assert ours.decode(ids) == ref.decode(ids), ids


@settings(max_examples=150, deadline=None)
@given(text=st.text(alphabet=ALPHABET + EXTRA_CHARS, max_size=40))
def test_t5_form_property(text):
    ours, ref = _PROPERTY_PAIR
    _same(ours, ref, text)


@pytest.mark.parametrize("text", ["w5 w6 w7", "w1,w2 (w3)", "  w60  ", "x y",
                                  "w10 w11 w12 w13", "", "é w3!!"])
def test_word_level_matches_tokenizers(word_pair, text):
    _same(*word_pair, text)


@settings(max_examples=100, deadline=None)
@given(words=st.lists(st.sampled_from(["w0", "w7", "w60", "w99", "<unk>",
                                       ",", "!!", "é", "_", " ", "\t"]),
                      max_size=12))
def test_word_level_property(words):
    _same(*_WORD_PAIR, "".join(words))


def test_extra_ids_are_added_tokens(t5_pair):
    ours, ref = t5_pair
    for i in range(N_EXTRA):
        tok = f"<extra_id_{i}>"
        assert ours.encode(tok).ids == ref.encode(tok).ids == [
            ref.token_to_id(tok), 1]
    assert ours.decode([ref.token_to_id("<extra_id_0>"), 5, 1]) == ref.decode(
        [ref.token_to_id("<extra_id_0>"), 5, 1])


def test_charsmap_normalizes_like_tokenizers():
    blob = build_precompiled_charsmap(CHARSMAP)
    from spittle_tpu_torch.text.hf_tokenizer import _Precompiled

    norm = tokenizers.normalizers.Precompiled(blob)
    ours = _Precompiled(blob)
    for s in STRINGS + ["xＡyＡ", "é", "x́́́", "\r\n"]:
        got, offs, _ = ours((s, list(range(len(s))), 0))
        assert got == norm.normalize_str(s), s
        assert len(offs) == len(got)
    assert ours(("xＡyＡ", [0, 1, 2, 3], 0))[0] == "xAyA"


def test_unknown_component_raises(tmp_path):
    path = _word_level(tmp_path / "tokenizer.json")
    spec = json.loads(open(path).read())
    spec["normalizer"] = {"type": "NFKC"}
    with pytest.raises(NotImplementedError, match="NFKC"):
        HFTokenizer(spec)
    spec["normalizer"] = None
    spec["model"] = {"type": "BPE", "vocab": {}, "merges": []}
    with pytest.raises(NotImplementedError, match="BPE"):
        HFTokenizer(spec)


def _from_str(spec: str):
    return HFTokenizer(json.loads(spec)), tokenizers.Tokenizer.from_str(spec)


# The hypothesis tests' pairs (module level: hypothesis takes no
# function-scoped fixtures), built from the JSON text itself.
_PROPERTY_PAIR = _from_str(_t5_spec(whitespace_split=True, scheme="first"))
_WORD_PAIR = _from_str(_word_level_spec())
