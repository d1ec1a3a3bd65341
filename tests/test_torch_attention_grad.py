"""K1 under autograd and its backward, K15's plain version, against the JAX
package on the CPU: flash_attention_fullkv_bwd_plain (the wrapper's CPU
route) and the autograd Function the dispatch takes under grad against
jax.vjp of the reference's attention_reference (non-causal, causal,
kv_len < Tk), the forms without a backward kernel raising under grad,
decoder_forward and encode against the reference's, and _stem_gemm
against the reference's and the convolutions. All f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.models.whisper.config import WhisperConfig as JConfig
from spittle_tpu.ops import attention as jatt
from spittle_tpu_torch.models.whisper import model as tmod
from spittle_tpu_torch.models.whisper.config import WhisperConfig
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.ops import attention as att

# Dh 64 and 128 positions: the dispatch's K1 route (the encoder's, and the
# decoder's causal self-attention at 128 tokens).
K1_CFG = dict(name="k1-grad", n_mels=80, n_audio_ctx=128, n_audio_state=128,
              n_audio_head=2, n_audio_layer=2, n_vocab=512, n_text_ctx=128,
              n_text_state=128, n_text_head=2, n_text_layer=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Beside the other test workers, more intra-op threads oversubscribe.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(tq, tk, seed=0):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((2, 3, t, 64)).astype(np.float32) * 0.35
            for t in (tq, tk))
    v = rng.standard_normal((2, 3, tk, 64)).astype(np.float32)
    do = rng.standard_normal((2, 3, tq, 64)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, kv_len):
    out, vjp = jax.vjp(
        lambda a, b, c: jatt.attention_reference(a, b, c, causal=causal,
                                                 kv_len=kv_len),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


CASES = [(160, 160, False, None), (160, 160, True, None), (150, 160, False, 130)]
IDS = ["full", "causal", "kv_len-130"]


def _close(got, want, rel):
    """max |got - want| within rel of the largest |want|."""
    got = got.detach().numpy() if torch.is_tensor(got) else got
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("tq,tk,causal,kv_len", CASES, ids=IDS)
def test_bwd_plain_matches_jax_vjp(tq, tk, causal, kv_len):
    q, k, v, do = _qkv(tq, tk)
    o_ref, grads = _jax_grads(q, k, v, do, causal, kv_len)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o = att.flash_attention_fullkv_plain(*t[:3], causal=causal, kv_len=kv_len)
    _close(o, o_ref, 1e-5)
    got = att.flash_attention_fullkv_bwd(t[0], t[1], t[2], o, t[3],
                                         causal=causal, kv_len=kv_len)
    # f32 on both sides, sums of at most 160 terms in another order, and
    # D from K1's o (rounded once more than XLA's transpose carries it).
    for g, want in zip(got, grads):
        _close(g, want, 1e-5)
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


@pytest.mark.parametrize("tq,tk,causal,kv_len", CASES, ids=IDS)
def test_dispatch_under_grad_takes_k1_function(tq, tk, causal, kv_len):
    q, k, v, do = _qkv(tq, tk, seed=1)
    _, grads = _jax_grads(q, k, v, do, causal, kv_len)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = att.multihead_attention(*leaves, causal=causal, kv_len=kv_len)
    assert type(o.grad_fn).__name__ == "_FullKVAttentionBackward"
    o.backward(torch.from_numpy(do))
    for t, want in zip(leaves, grads):
        _close(t.grad, want, 1e-5)
    with torch.no_grad():  # no grad: the kernel wrapper as before
        assert att.multihead_attention(*leaves, causal=causal,
                                       kv_len=kv_len).grad_fn is None


@pytest.mark.parametrize("form", ["q8", "pipe", "packed", "pair", "long"])
def test_forms_without_backward_raise_under_grad(form):
    tk = 4160 if form == "long" else 160
    q, k, v, _ = _qkv(160, tk, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if form in ("packed", "pair"):
        # Packed [B, T, H * 64] projections: three heads for K8, two (the
        # pair form's even count) for K9.
        heads = 3 if form == "packed" else 2
        packed = [t.permute(0, 2, 1, 3)[:, :, :heads].reshape(2, -1, heads * 64)
                  for t in leaves]

        def call():
            return att.multihead_attention_packed(*packed, heads, form=form)
    else:
        def call():
            return att.multihead_attention(
                *leaves, form="fullkv" if form == "long" else form)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        call()
    with torch.no_grad():
        assert torch.isfinite(call()).all()


@pytest.fixture(scope="module")
def k1_model():
    jcfg, cfg = JConfig(**K1_CFG), WhisperConfig(**K1_CFG)
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    # Biases noised, so that every bias term shows in the outputs.
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
                         if path[-1].key.endswith(("_b", "bq", "bv", "bo"))
                         and "ln" not in path[-1].key else a), jp)
    mel = rng.standard_normal((2, 80, 2 * jcfg.n_audio_ctx)).astype(np.float32)
    tokens = rng.integers(0, jcfg.n_vocab, (2, jcfg.n_text_ctx)).astype(np.int32)
    return jcfg, cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp)), mel, tokens


def test_encode_and_decoder_forward_match_reference(k1_model):
    jcfg, cfg, jp, tp, mel, tokens = k1_model
    xa_ref = jmod.encode(jp, jnp.asarray(mel), jcfg)
    logits_ref = jmod.decoder_forward(jp, jnp.asarray(tokens), xa_ref, jcfg)
    leaves = [t.requires_grad_() for t in jax.tree.leaves(tp)]
    xa = tmod.encode(tp, torch.from_numpy(mel), cfg)
    logits = tmod.decoder_forward(tp, torch.from_numpy(tokens).long(), xa, cfg)
    assert logits.dtype == torch.float32 and logits.grad_fn is not None
    _close(xa, np.asarray(xa_ref), 1e-5)
    _close(logits, np.asarray(logits_ref), 1e-5)
    # The precomputed cross-K/V buffers and both attention routes keep
    # the graph: every leaf gets a gradient.
    logits.square().mean().backward()
    assert all(t.grad is not None for t in leaves)
    del leaves


def test_stem_gemm_matches_reference_and_convs(k1_model):
    jcfg, cfg, jp, tp, mel, _ = k1_model
    got = tmod._stem_gemm(tp["encoder"], torch.from_numpy(mel))
    want = np.asarray(jmod._stem_gemm(jp["encoder"], jnp.asarray(mel)))
    _close(got, want, 1e-5)
    pos = torch.zeros(cfg.n_audio_ctx, cfg.n_audio_state)
    conv = tmod._encoder_stem(tp["encoder"], torch.from_numpy(mel), cfg, pos)
    gemm = tmod._encoder_stem(tp["encoder"], torch.from_numpy(mel), cfg, pos,
                              stem_gemm=True)
    assert gemm.is_contiguous()
    _close(gemm, conv.detach().numpy(), 1e-5)
    xa = tmod.encode(tp, torch.from_numpy(mel), cfg, stem_gemm=True)
    _close(xa, np.asarray(jmod.encode(jp, jnp.asarray(mel), jcfg)), 1e-5)
