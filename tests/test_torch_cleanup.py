"""The port's cleanup provider (spittle_tpu_torch/text/cleanup.py) against
the JAX package's (spittle_tpu/text/cleanup.py): the copied masking,
restore, validation and sentence split on tests/test_cleanup.py's strings,
CleanupManager's fail-open contract, and t5_seq2seq on the CPU on
tests/test_t5_cleanup_provider.py's checkpoint directory, with its
WordLevel tokenizer and with a T5-form Unigram tokenizer.json (the port
reads it with its own reader, the reference with `tokenizers`)."""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from spittle_tpu.text import cleanup as jclean  # noqa: E402
from spittle_tpu_torch.text import cleanup as tclean  # noqa: E402
from spittle_tpu_torch.text.hf_tokenizer import build_precompiled_charsmap  # noqa: E402

from test_t5_cleanup_provider import VOCAB, _make_checkpoint  # noqa: E402

MASK_STRINGS = [
    "open @auth.ts and @src/utils.rs please",
    "run `cargo test --all` then check",
    "see https://example.com/docs?q=1 and http://a.b/c",
    "edit /home/user/project/main.rs and ~/notes.txt",
    "use --verbose and -o=out.txt when running",
    "run `make test` at /tmp/x --now w3 w4",
    "no protected spans at all", "", "@a @b `c` --d",
]
VALIDATE_CASES = [
    ("some text", "", []), ("some text", "   ", []),
    ("this is a relatively long sentence here", "hi", []),
    ("short", "this is way too long for the original short text here", []),
    ("open @auth.ts now", "open ⟦P0⟧ now", [("⟦P0⟧", "@auth.ts")]),
    ("open @auth.ts now", "open now please", [("⟦P0⟧", "@auth.ts")]),
    ("hello world this is", "Hello world, this is.", []),
]
SENTENCES = ["Hello world. This is a test! Another sentence? Final one.",
             "no terminal punctuation", "  a.  b!c ?d  ", ""]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_constants_match():
    assert tclean.PROMPT_TEMPLATE == jclean.PROMPT_TEMPLATE
    assert tclean.MAX_DECODE_TOKENS == jclean.MAX_DECODE_TOKENS
    assert tclean._PROTECTED.pattern == jclean._PROTECTED.pattern


@pytest.mark.parametrize("text", MASK_STRINGS)
def test_mask_and_restore_match(text):
    masked, spans = tclean.mask_protected_spans(text)
    assert (masked, spans) == jclean.mask_protected_spans(text)
    assert (tclean.restore_protected_spans(masked, spans)
            == jclean.restore_protected_spans(masked, spans) == text)


@pytest.mark.parametrize("case", VALIDATE_CASES)
def test_validate_cleanup_matches(case):
    assert tclean.validate_cleanup(*case) == jclean.validate_cleanup(*case)


@pytest.mark.parametrize("text", SENTENCES)
def test_split_sentences_matches(text):
    assert tclean.split_sentences(text) == jclean.split_sentences(text)
    assert (tclean.CleanupManager.split_sentences(text)
            == jclean.CleanupManager.split_sentences(text))


@pytest.mark.parametrize("provider", [
    None, lambda p: "x", lambda p: "", lambda p: 1 / 0,
    lambda p: p.split(": ", 1)[1].upper(), lambda p: p.split(": ", 1)[1] + " ⟦P0⟧",
])
@pytest.mark.parametrize("text", MASK_STRINGS[:6])
def test_cleanup_manager_matches(provider, text):
    ours, ref = tclean.CleanupManager(provider), jclean.CleanupManager(provider)
    assert ours.name == ref.name and ours.is_available == ref.is_available
    assert ours.cleanup(text) == ref.cleanup(text)


def _unigram_tokenizer(path):
    """A T5-form tokenizer.json over the checkpoint's 64 ids."""
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models
    from tokenizers import normalizers, pre_tokenizers, processors

    rng = np.random.default_rng(5)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    pieces = ["▁"] + letters + ["▁" + c for c in letters[:20]]
    while len(pieces) < VOCAB - 3 - 2:
        w = "".join(rng.choice(letters[:8], int(rng.integers(2, 4))))
        if w not in pieces:
            pieces.append(w)
    vocab = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    vocab += [(p, float(-rng.uniform(1.0, 10.0))) for p in pieces]
    vocab += [("<extra_id_1>", 0.0), ("<extra_id_0>", 0.0)]
    assert len(vocab) == VOCAB
    tok = Tokenizer(models.Unigram(vocab, unk_id=2, byte_fallback=False))
    tok.add_tokens([AddedToken(p, normalized=False, special=True)
                    for p, _ in vocab if p.startswith("<")])
    tok.normalizer = normalizers.Sequence([
        normalizers.Precompiled(build_precompiled_charsmap({"Ａ": "a", "ｂ": "b"})),
        normalizers.Strip(left=False, right=True),
        normalizers.Replace(Regex(" {2,}"), "▁")])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁",
                                                 prepend_scheme="always")
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(
        single=["$A", "</s>"], special_tokens=[("</s>", 1)])
    path.write_text(tok.to_str(), encoding="utf-8")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("t5")
    _make_checkpoint(d)
    return d


@pytest.fixture(scope="module")
def unigram_checkpoint(tmp_path_factory, checkpoint):
    d = tmp_path_factory.mktemp("t5_unigram")
    for name in ("model.safetensors", "config.json"):
        (d / name).write_bytes((checkpoint / name).read_bytes())
    _unigram_tokenizer(d / "tokenizer.json")
    return d


PROMPTS = {"word_level": ["w5 w6 w7", "w10 w11 w12 w13", "w1 w60 unknown w2",
                          tclean.PROMPT_TEMPLATE.format(text="w3 w4")],
           "unigram": ["abc de f", "Ａｂ cab  fed", "hello world <extra_id_0> x",
                       tclean.PROMPT_TEMPLATE.format(text="a b c")]}


@pytest.mark.parametrize("form", sorted(PROMPTS))
def test_t5_seq2seq_matches_reference(checkpoint, unigram_checkpoint, form):
    d = str(checkpoint if form == "word_level" else unigram_checkpoint)
    ours = tclean.t5_seq2seq(d, max_tokens=8, device="cpu")
    ref = jclean.t5_seq2seq(d, max_tokens=8)
    for prompt in PROMPTS[form]:
        assert ours(prompt) == ref(prompt), prompt
    mgr = tclean.CleanupManager(seq2seq=ours)
    text = "run `make test` at /tmp/x --now w3 w4"
    assert mgr.cleanup(text) == jclean.CleanupManager(seq2seq=ref).cleanup(text)


def test_t5_seq2seq_runs_on_the_card_by_default(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclean.t5_seq2seq(str(checkpoint))
    json.loads((checkpoint / "config.json").read_text())  # the dir is intact
