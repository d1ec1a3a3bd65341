"""Speculative decoding in spittle_tpu_torch against the JAX reference on
the CPU: decode_block (the verify pass, with JAX's clamps at the end of
the context) against the reference's and against K decode steps,
speculative_greedy_decode against the reference's (tokens, rounds,
accepted positions, lengths, log-probs) over drafts, block sizes,
timestamps, quantizations and the timing rig, its two ValueErrors, and
the engine's draft loaders and both transcription paths with a draft
against the JAX engine. The same numpy-seeded weights go into both
packages through params_from_jax; each tolerance says why.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spittle_tpu.engine.base import TranscribeParams as JParams
from spittle_tpu.engine.whisper_engine import WhisperEngine as JaxEngine
from spittle_tpu.models.whisper import config as jcfg
from spittle_tpu.models.whisper import decode as jdec
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.models.whisper import speculative as jspec
from spittle_tpu.models.whisper.tokenizer import make_test_vocab
from spittle_tpu.models.whisper.weights import save_npz_checkpoint
from spittle_tpu.ops import quant as jquant
from spittle_tpu_torch.engine.base import TranscribeParams
from spittle_tpu_torch.engine.whisper_engine import WhisperEngine
from spittle_tpu_torch.models.whisper import config as tcfg
from spittle_tpu_torch.models.whisper import decode as tdec
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper import speculative as tspec
from spittle_tpu_torch.models.whisper.weights import params_from_jax

from test_torch_app_path import NARROW, _numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "trained_tiny")
NPZ = os.path.join(DATA, "params.npz")
sys.path.insert(0, os.path.join(REPO, "scripts"))
import train_committed_checkpoint as tcc  # noqa: E402

# The narrow model with one encoder layer (the encoder is not run; the
# self-draft is decoder block 0 of 2) and four text heads: Dh 32, so that
# the int8 and int4 cross-attention take the plain int8 math in both
# packages. At Dh 64 the port takes K3/K6's route at <= 8 rows, whose
# plain version rounds p * vs to bf16 as the kernels do, where the
# reference's XLA path keeps f32 (ROADMAP queue 3, "Kernel route
# rounding"): ~3e-4 in the logits, which flips near-tied tokens and is
# held in tests/test_torch_quant.py. "w8a8" runs K14's plain version at
# any Dh.
SPEC_CFG = dict(NARROW, n_audio_layer=1, n_text_head=4)
MAX_TOKENS = 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Eager torch loops beside the suite's other workers: one intra-op
    thread for this module, the previous count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    """The main model, a self-draft (decoder block 0 of the main model)
    and an unrelated draft of the same shape, each as (JAX tree, the
    port's tree), and an encoder output for two windows."""
    jc, tc = jcfg.WhisperConfig(**SPEC_CFG), tcfg.WhisperConfig(**SPEC_CFG)
    main = _numpy_tree(jc, seed=21)
    other = _numpy_tree(jc, seed=22)
    xa = np.random.default_rng(23).standard_normal(
        (2, jc.n_audio_ctx, jc.n_audio_state)).astype(np.float32)
    return jc, tc, main, other, xa


def _self_draft(tree, cfg, layers=(0,)):
    """The main tree's decoder blocks `layers` as a draft, and its cfg."""
    dec = dict(tree["decoder"])
    dec["blocks"] = jax.tree.map(lambda a: a[np.asarray(layers)], dec["blocks"])
    return {**tree, "decoder": dec}, dataclasses.replace(cfg, n_text_layer=len(layers))


def _cache_t(jcache):
    """The reference's cache [L, 2, B, H, Dh, ctx] (or its int8 dict) in
    the port's ctx-major layout."""
    if isinstance(jcache, dict):
        return {"qw": np.swapaxes(np.asarray(jcache["qw"]), -1, -2),
                "scale": np.asarray(jcache["scale"])}
    return np.swapaxes(np.asarray(jcache), -1, -2)


# ---------------------------------------------------------------------------
# decode_block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant_cache", [False, True])
@pytest.mark.parametrize("at_end", [False, True])
def test_decode_block_matches_reference(models, quant_cache, at_end):
    """decode_block of K = 4 tokens after a 5-token prefill against the
    reference's, in f32, over the plain and the int8 self-cache: logits to
    1e-5 and the written cache to 1e-5 (int8: codes equal). at_end: the
    block starts at ctx - 2 of a 32-position cache with 32 position
    embeddings, where JAX clamps the write and the embeddings' start to
    28 while the mask keeps pos + j."""
    jc, tc, main, _, xa = models
    jp, tp = jax.tree.map(jnp.asarray, main), params_from_jax(main)
    ctx = 32
    rng = np.random.default_rng(30)
    prefix = rng.integers(0, 5000, (2, 5))
    block = rng.integers(0, 5000, (2, 4))
    jkv = jmod.precompute_cross_kv(jp, jnp.asarray(xa), jc)
    tkv = tmod.precompute_cross_kv(tp, _t(xa), tc)
    _, jcache = jmod.decoder_prefill(jp, jnp.asarray(prefix, jnp.int32), jkv, jc, ctx,
                                     quant_cache=quant_cache)
    _, tcache = tmod.decoder_prefill(tp, _t(prefix), tkv, tc, ctx,
                                     quant_cache=quant_cache)
    pos = ctx - 2 if at_end else 5
    if at_end:  # the embeddings' clamp too: pos + 4 > 32 rows
        jp = {**jp, "decoder": {**jp["decoder"],
                                "pos_emb": jp["decoder"]["pos_emb"][:ctx]}}
        tp = {**tp, "decoder": {**tp["decoder"],
                                "pos_emb": tp["decoder"]["pos_emb"][:ctx]}}
    jl, jcache = jmod.decode_block(jp, jnp.asarray(block, jnp.int32), jnp.int32(pos),
                                   jcache, jkv, jc)
    tl = tmod.decode_block(tp, _t(block), pos, tcache, tkv, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    want = _cache_t(jcache)
    if quant_cache:
        np.testing.assert_array_equal(tcache["qw"].numpy(), want["qw"])
        np.testing.assert_allclose(tcache["scale"].numpy(), want["scale"], rtol=1e-6)
    else:
        np.testing.assert_allclose(tcache.numpy(), want, atol=1e-5)


def test_decode_block_equals_k_decode_steps(models):
    """Without clamps, decode_block of K tokens is K decode steps: the
    same logits (to 1e-5: the products' blocking differs) and caches."""
    jc, tc, main, _, xa = models
    tp = params_from_jax(main)
    tkv = tmod.precompute_cross_kv(tp, _t(xa), tc)
    prefix = _t(np.random.default_rng(31).integers(0, 5000, (2, 3)))
    block = _t(np.random.default_rng(32).integers(0, 5000, (2, 3)))
    _, c1 = tmod.decoder_prefill(tp, prefix, tkv, tc, 32)
    c2 = c1.clone()
    got = tmod.decode_block(tp, block, 3, c1, tkv, tc)
    want = torch.stack([tmod.decode_step(tp, block[:, j], 3 + j, c2, tkv, tc)
                        for j in range(3)], dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(c1, c2, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# speculative_greedy_decode
# ---------------------------------------------------------------------------

QUANT = {
    "float": {},
    "int8": dict(quant_kv=True, quant_cache=True),
    "int4": dict(quant_kv=True, quant_kv_bits=4),
    "w8a8": dict(quant_kv=True, quant_kv_w8a8=True, quant_cache=True),
}
CASES = {  # draft, draft_k, timestamps, quantization, extra options
    "self-k4-ts": ("self", 4, True, "float", {}),
    "other-k2-nots": ("other", 2, False, "float", {}),
    "self-k4-int8": ("self", 4, True, "int8", {}),
    "self-k2-int4-nots": ("self", 2, False, "int4", {}),
    "other-k4-w8a8": ("other", 4, True, "w8a8", {}),
    "self-k4-rig": ("self", 4, True, "float", dict(rig_advance=3)),
    # A carried prompt of 40 tokens: prefix + budget reaches n_text_ctx
    # (64), the caches hold 64 columns and the last blocks clamp.
    "self-k4-ctx-end": ("self", 4, True, "int8", dict(max_tokens=30)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_speculative_matches_reference(models, case):
    """Tokens, rounds, accepted positions and lengths equal the
    reference's; avg_logprob and no_speech_prob within 1e-5 (f32 logits;
    int4: 1e-5 too, K6's bf16 rounding is a card kernel's, not the plain
    math's), "w8a8" 2e-3 (a P code moved by one per row, K14's tolerance).
    Without the rig, the tokens are also greedy_decode's."""
    draft_kind, k, ts, quant, extra = CASES[case]
    jc, tc, main, other, xa = models
    if draft_kind == "self":
        dtree, jdc = _self_draft(main, jc)
    else:
        dtree, jdc = other, jc
    tdc = tcfg.WhisperConfig(**jdc.__dict__)
    kw = dict(language="en", timestamps=ts, max_tokens=MAX_TOKENS, **QUANT[quant])
    kw.update(extra)
    prompt = tuple(range(300, 340)) if case.endswith("ctx-end") else ()
    jp, jd = jax.tree.map(jnp.asarray, main), jax.tree.map(jnp.asarray, dtree)
    if kw.get("quant_kv"):
        jp, jd = jquant.quantize_whisper_decoder(jp), jquant.quantize_whisper_decoder(jd)
    tp, td = params_from_jax(jp), params_from_jax(jd)
    ref = jspec.speculative_greedy_decode(
        jp, jd, jnp.asarray(xa), jnp.asarray(xa), jc, jdc, jdec.DecodeOptions(**kw),
        draft_k=k, prompt_tokens=prompt)
    got = tspec.speculative_greedy_decode(
        tp, td, _t(xa), _t(xa), tc, tdc, tdec.DecodeOptions(**kw), draft_k=k,
        prompt_tokens=prompt)
    assert got["sample_begin"] == ref["sample_begin"]
    assert np.array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    assert got["rounds"] == int(ref["rounds"])
    assert got["accepted_total"] == int(ref["accepted_total"])
    assert np.array_equal(got["length"].numpy(), np.asarray(ref["length"]))
    tol = 2e-3 if quant == "w8a8" else 1e-5
    np.testing.assert_allclose(got["avg_logprob"].numpy(),
                               np.asarray(ref["avg_logprob"]), atol=tol)
    np.testing.assert_allclose(got["no_speech_prob"].numpy(),
                               np.asarray(ref["no_speech_prob"]), atol=1e-5)
    if case.endswith("ctx-end"):
        # The budget ran out at the context's end: the last blocks started
        # past n_text_ctx - K and were clamped, so (in both packages) their
        # tokens need not be greedy_decode's.
        assert got["tokens"].shape[1] == tc.n_text_ctx
        assert got["sample_begin"] + got["accepted_total"] >= tc.n_text_ctx
    elif "rig_advance" not in extra:
        greedy = tdec.greedy_decode(tp, _t(xa), tc, tdec.DecodeOptions(**kw),
                                    prompt_tokens=prompt)
        assert torch.equal(got["tokens"], greedy["tokens"])


def test_speculative_matches_reference_bf16(models):
    """The self-draft case in bf16: both packages cast the weights by
    their engines' rule (layer norms f32, every other f32 leaf bf16) and
    take a bf16 encoder output. The port's speculative decode emits its
    own greedy_decode's tokens and lengths exactly, and advances by the
    reference's rule (rounds and accepted positions consistent with its
    tokens). Against the reference: the port's bf16 decoder logits on the
    reference's speculative tokens within 4e-3 (four bf16 ulps at the
    logits' scale of ~0.24), and the tokens compared one by one. Item 1
    agrees throughout. Item 0 parts at position 9 (the reference's
    timestamp token 50427, the port's 50428; everything before agrees):
    a near tie, which the teacher-forced logits there show. The two
    tokens' logits lie 2.4e-4 apart in the reference's and 4.9e-4 in the
    port's, each package's gap in favour of its own token, both under the
    4e-3 bound: XLA and torch round bf16 products at other places
    (ROADMAP queue 3, "Reference behaviours")."""
    from spittle_tpu.engine.whisper_engine import _cast_params_bf16
    from spittle_tpu_torch.models.whisper.weights import cast_params

    jc, tc, main, _, xa = models
    dtree, jdc = _self_draft(main, jc)
    tdc = tcfg.WhisperConfig(**jdc.__dict__)
    kw = dict(language="en", timestamps=True, max_tokens=MAX_TOKENS)
    jp, jd = (_cast_params_bf16(jax.tree.map(jnp.asarray, t)) for t in (main, dtree))
    tp, td = (cast_params(params_from_jax(t), torch.bfloat16) for t in (main, dtree))
    jxa, txa = jnp.asarray(xa, jnp.bfloat16), _t(xa).to(torch.bfloat16)
    got = tspec.speculative_greedy_decode(tp, td, txa, txa, tc, tdc,
                                          tdec.DecodeOptions(**kw), draft_k=4)
    greedy = tdec.greedy_decode(tp, txa, tc, tdec.DecodeOptions(**kw))
    assert torch.equal(got["tokens"], greedy["tokens"])
    assert torch.equal(got["length"], greedy["length"])
    assert got["accepted_total"] >= got["rounds"] >= 1
    assert got["sample_begin"] + got["accepted_total"] >= got["tokens"].shape[1]
    ref = jspec.speculative_greedy_decode(jp, jd, jxa, jxa, jc, jdc,
                                          jdec.DecodeOptions(**kw), draft_k=4)
    toks = np.asarray(ref["tokens"])[:, :-1]
    jl, _ = jmod.decoder_prefill(jp, jnp.asarray(toks, jnp.int32),
                                 jmod.precompute_cross_kv(jp, jxa, jc), jc, 32)
    tl, _ = tmod.decoder_prefill(tp, _t(toks), tmod.precompute_cross_kv(tp, txa, tc),
                                 tc, 32)
    tl, jl = tl.float().numpy(), np.asarray(jl, np.float32)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=4e-3)
    mine, theirs = got["tokens"].numpy(), np.asarray(ref["tokens"])
    assert mine.shape == theirs.shape
    parted = [np.flatnonzero(a != b) for a, b in zip(mine, theirs)]
    assert [p[:1].tolist() for p in parted] == [[9], []]
    pos, a, b = 9, theirs[0, 9], mine[0, 9]
    assert (a, b) == (50427, 50428)
    # Logits at pos - 1 predict position pos; each package's gap between
    # its own token and the other's.
    ref_gap = jl[0, pos - 1, a] - jl[0, pos - 1, b]
    port_gap = tl[0, pos - 1, b] - tl[0, pos - 1, a]
    assert 0 < ref_gap < 4e-3 and 0 < port_gap < 4e-3, (ref_gap, port_gap)


@pytest.mark.parametrize("what", ["temperature", "token table"])
def test_speculative_refusals(models, what):
    jc, tc, main, _, xa = models
    tp = params_from_jax(main)
    opts, dc = tdec.DecodeOptions(), tc
    if what == "temperature":
        opts, match = tdec.DecodeOptions(temperature=0.2), "temperature-0 only"
    else:
        dc = tcfg.WhisperConfig(**{**tc.__dict__, "n_vocab": tc.n_vocab - 1})
        match = "token layout mismatch on n_vocab"
    with pytest.raises(ValueError, match=match):
        tspec.speculative_greedy_decode(tp, tp, _t(xa), _t(xa), tc, dc, opts)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def goldens():
    with open(os.path.join(DATA, "goldens.json")) as f:
        return json.load(f)


def _as_dicts(results):
    return [dict(text=r.text, tokens=list(r.tokens), language=r.language,
                 segments=[(s.start, s.end, s.text) for s in r.segments])
            for r in results]


def test_self_draft_layers_match_reference(tmp_path):
    """load_self_draft(stride) takes the reference's layers (0, stride,
    ... and always the last) of the loaded decoder as it holds them (here
    the weight-only int8 decoder of a 5-layer model), shares the encoder,
    and names the draft as the reference does; unload_model clears it."""
    cfg = jcfg.WhisperConfig(**{**SPEC_CFG, "name": "spec-5-layers",
                                "n_text_layer": 5})
    path = str(tmp_path / "five.npz")
    save_npz_checkpoint(path, cfg, _numpy_tree(cfg, seed=24), make_test_vocab())
    port = WhisperEngine(device="cpu", quantize_decoder="int8")
    ref = JaxEngine(quantize_decoder="int8")
    for eng in (port, ref):
        eng.load_model(path)
    for stride, layers in ((1, 5), (2, 3), (3, 3), (4, 2)):
        port.load_self_draft(stride)
        ref.load_self_draft(stride)
        assert port.draft_cfg == tcfg.WhisperConfig(**ref.draft_cfg.__dict__)
        assert port.draft_cfg.n_text_layer == layers
        want = jax.tree_util.tree_leaves_with_path(ref.draft_params["decoder"]["blocks"])
        for key_path, leaf in want:
            node = port.draft_params["decoder"]["blocks"]
            for k in key_path:
                node = node[k.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        assert port.draft_params["encoder"] is port.params["encoder"]
    port.unload_model()
    assert port.draft_params is None and port.draft_cfg is None
    assert not port._self_draft


@pytest.mark.parametrize("path", ["sequential-self", "parallel-loaded"])
def test_engine_with_draft_matches_jax_engine(tmp_path, goldens, path):
    """The trained tiny checkpoint with a self-draft (sequential seeks,
    the app's call) or a loaded draft (a copy of the checkpoint under
    another name: its own encode; parallel windows), against the JAX
    engine with the same draft: text, tokens, segments and
    last_spec_stats equal, and the tokens are the goldens' greedy ones."""
    cases = goldens["cases"][:3]
    audio = [tcc.utterance(c["word_ids"])[0] for c in cases]
    port, ref = WhisperEngine(device="cpu"), JaxEngine()
    for eng in (port, ref):
        eng.load_model(NPZ)
        if path == "sequential-self":
            eng.load_self_draft(2)
        else:
            draft = tmp_path / "draft.npz"
            draft.write_bytes(open(NPZ, "rb").read())
            eng.load_draft_model(str(draft))
    base = dict(language="en", condition_on_previous_text=False, temperatures=(0.0,))
    if path == "sequential-self":
        got = [port.transcribe_samples(a, TranscribeParams(**base)) for a in audio[:2]]
        want = [ref.transcribe_samples(a, JParams(**base)) for a in audio[:2]]
        cases = cases[:2]
    else:
        got = port.transcribe_batch(audio, TranscribeParams(parallel_windows=True, **base))
        want = ref.transcribe_batch(audio, JParams(parallel_windows=True, **base))
    assert _as_dicts(got) == _as_dicts(want)
    assert [r.tokens for r in got] == [c["greedy_tokens"] for c in cases]
    assert port.last_spec_stats == pytest.approx(ref.last_spec_stats, rel=0, abs=1e-6)
    assert port.last_spec_stats["rounds"] > 0
