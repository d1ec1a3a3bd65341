"""The port's T5 (spittle_tpu_torch.models.t5) against the JAX T5 on the
CPU, on the same weights: HF-named flan-T5 tensors (gated GELU, an untied
LM head) drawn from numpy at HF's initialisation scales and mapped
through both packages' HF-name loaders, as tests/test_t5_torch_parity.py
maps a transformers model's for the JAX T5. Encoder states,
teacher-forced logits and greedy_generate's tokens must agree; and
load_t5_dir reads a safetensors directory with the port's own reader.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spittle_tpu.models import t5 as jt5
from spittle_tpu_torch.models import t5 as tt5

JCFG = jt5.T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=3,
                    num_heads=4)
TCFG = tt5.T5Config(**JCFG.__dict__)


@pytest.fixture(scope="module")
def tensors():
    """A T5ForConditionalGeneration state_dict's names and shapes, drawn
    as T5PreTrainedModel._init_weights draws them (factor 1): the shared
    table N(0, 1), the LM head and k/v/wi N(0, d^-0.5), q N(0, (d *
    d_kv)^-0.5), o N(0, (H * d_kv)^-0.5), wo N(0, d_ff^-0.5), the
    position tables N(0, d^-0.5); the norms 1 + 0.1 N, so that they
    matter."""
    rng = np.random.default_rng(0)
    d, inner, ff = JCFG.d_model, JCFG.inner, JCFG.d_ff

    def w(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    t = {"shared.weight": w(JCFG.vocab_size, d),
         "lm_head.weight": w(JCFG.vocab_size, d, std=d ** -0.5)}
    for side in ("encoder", "decoder"):
        t[f"{side}.final_layer_norm.weight"] = 1 + w(d, std=0.1)
        t[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = \
            w(JCFG.rel_buckets, JCFG.num_heads, std=d ** -0.5)
        for i in range(JCFG.num_layers):
            pre = f"{side}.block.{i}.layer"
            attns = [("0.SelfAttention", 0)]
            if side == "decoder":
                attns.append(("1.EncDecAttention", 1))
            for name, idx in attns:
                t[f"{pre}.{name}.q.weight"] = w(inner, d, std=(d * JCFG.d_kv) ** -0.5)
                t[f"{pre}.{name}.k.weight"] = w(inner, d, std=d ** -0.5)
                t[f"{pre}.{name}.v.weight"] = w(inner, d, std=d ** -0.5)
                t[f"{pre}.{name}.o.weight"] = w(d, inner, std=inner ** -0.5)
                t[f"{pre}.{idx}.layer_norm.weight"] = 1 + w(d, std=0.1)
            f = 2 if side == "decoder" else 1
            t[f"{pre}.{f}.DenseReluDense.wi_0.weight"] = w(ff, d, std=d ** -0.5)
            t[f"{pre}.{f}.DenseReluDense.wi_1.weight"] = w(ff, d, std=d ** -0.5)
            t[f"{pre}.{f}.DenseReluDense.wo.weight"] = w(d, ff, std=ff ** -0.5)
            t[f"{pre}.{f}.layer_norm.weight"] = 1 + w(d, std=0.1)
    return t


@pytest.fixture(scope="module")
def params(tensors):
    return (jt5.params_from_hf_tensors(tensors, JCFG),
            tt5.params_from_hf_tensors(tensors, TCFG, device="cpu"))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    tokens = rng.integers(2, JCFG.vocab_size, (2, 11)).astype(np.int64)
    tokens[1, 8:] = JCFG.pad_id  # a ragged batch exercises the mask
    return tokens, tokens != JCFG.pad_id


def test_relative_buckets_match_reference():
    """Bidirectional and causal buckets over distances past max_distance,
    where the log-spaced buckets saturate."""
    rel = np.arange(-300, 301)
    for bidirectional in (True, False):
        got = tt5.model._relative_bucket(torch.from_numpy(rel), bidirectional, 32, 128)
        want = jt5.model._relative_bucket(jnp.asarray(rel, jnp.int32), bidirectional,
                                          32, 128)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encoder_matches_reference(params, inputs):
    jp, tp = params
    tokens, mask = inputs
    want = jt5.t5_encode(jp, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask), JCFG)
    got = tt5.t5_encode(tp, torch.from_numpy(tokens), torch.from_numpy(mask), TCFG)
    # f32 on both sides: summation order only.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_decoder_logits_match_reference(params, inputs):
    jp, tp = params
    tokens, mask = inputs
    dec = np.random.default_rng(1).integers(2, JCFG.vocab_size, (2, 7))
    jenc = jt5.t5_encode(jp, jnp.asarray(tokens, jnp.int32), jnp.asarray(mask), JCFG)
    want = jt5.t5_decoder_forward(jp, jnp.asarray(dec, jnp.int32), jenc,
                                  jnp.asarray(mask), JCFG)
    tenc = tt5.t5_encode(tp, torch.from_numpy(tokens), torch.from_numpy(mask), TCFG)
    got = tt5.t5_decoder_forward(tp, torch.from_numpy(dec), tenc,
                                 torch.from_numpy(mask), TCFG)
    # f32 on both sides; summed in another order over three layers, the
    # logits move by up to ~2e-5.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_decode_steps_match_teacher_forced_logits(params, inputs):
    """The incremental path (cross-K/V once, the cache written in place
    one column per step) gives the teacher-forced logits, position by
    position, to 5e-5 (one row against all rows: the products' blocking
    differs, ~1e-5)."""
    _, tp = params
    tokens, mask = inputs
    dec = torch.from_numpy(np.random.default_rng(2).integers(2, JCFG.vocab_size, (2, 6)))
    tok, m = torch.from_numpy(tokens), torch.from_numpy(mask)
    enc = tt5.t5_encode(tp, tok, m, TCFG)
    want = tt5.t5_decoder_forward(tp, dec, enc, m, TCFG)
    cross = tt5.precompute_cross_kv(tp, enc, TCFG)
    cache = tt5.init_kv_cache(TCFG, 2, 8)
    for pos in range(dec.shape[1]):
        got = tt5.t5_decode_step(tp, dec[:, pos], pos, cache, cross, m, TCFG)
        torch.testing.assert_close(got, want[:, pos], rtol=0, atol=5e-5)


def test_greedy_generate_matches_reference(params, inputs):
    jp, tp = params
    tokens, _ = inputs
    want = jt5.greedy_generate(jp, tokens, JCFG, max_tokens=16)
    got = tt5.greedy_generate(tp, tokens, TCFG, max_tokens=16)
    np.testing.assert_array_equal(got, want)


def test_load_t5_dir_reads_safetensors(tmp_path, tensors):
    """An HF directory (two .safetensors files and config.json) read by the
    port's own safetensors reader gives params_from_hf_tensors' tree and
    the config; without config.json and a cfg it raises."""
    from safetensors.numpy import save_file

    names = sorted(tensors)
    save_file({k: tensors[k] for k in names[::2]}, str(tmp_path / "a.safetensors"))
    save_file({k: tensors[k] for k in names[1::2]}, str(tmp_path / "b.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(dict(
        vocab_size=JCFG.vocab_size, d_model=JCFG.d_model, d_kv=JCFG.d_kv,
        d_ff=JCFG.d_ff, num_layers=JCFG.num_layers, num_heads=JCFG.num_heads,
        relative_attention_num_buckets=32, relative_attention_max_distance=128,
        eos_token_id=1, pad_token_id=0)))
    cfg, got = tt5.load_t5_dir(str(tmp_path), device="cpu")
    assert cfg == TCFG
    want = tt5.params_from_hf_tensors(tensors, TCFG, device="cpu")

    def check(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                check(a[k], b[k])
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    check(got, want)
    (tmp_path / "config.json").unlink()
    with pytest.raises(FileNotFoundError, match="config.json"):
        tt5.load_t5_dir(str(tmp_path), device="cpu")


def test_default_device_is_the_card(tensors):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt5.params_from_hf_tensors(tensors, TCFG)
