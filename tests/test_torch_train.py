"""The port's training path (spittle_tpu_torch/train, decoder_forward,
save_family_npz) against the JAX package on the CPU, f32, one intra-op
thread: at the reference test's tiny config (tests/test_train.py, Dh 16:
plain attention) and at Dh 64 with 128 audio positions and 128 tokens,
where the dispatch takes K1 as its autograd Function with K15's plain
version as the backward.

- cross_entropy_loss and every leaf's gradient against
  jax.value_and_grad of the reference's;
- one AdamW step against optax's adamw;
- 8 steps lower the loss; remat gives the same loss and gradients;
- the MoE objective's l1 - l0 = alpha * aux, and a step moves the router;
- spec_augment's properties (tests/test_augment.py's), and its masks
  against a numpy copy of the reference's formula on the same draws;
- a checkpoint round trip, and a resumed run equal to an unbroken one;
- save_family_npz read back by both packages' load_family_npz.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spittle_tpu.io import npz_checkpoint as jnpz
from spittle_tpu.models.whisper import model as jmod
from spittle_tpu.models.whisper.config import WhisperConfig as JConfig
from spittle_tpu.train import step as jstep
from spittle_tpu_torch.io import npz_checkpoint as tnpz
from spittle_tpu_torch.models.whisper.config import WhisperConfig
from spittle_tpu_torch.models.whisper.weights import params_from_jax
from spittle_tpu_torch.train import augment, cross_entropy_loss, make_train_step
from spittle_tpu_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

# tests/test_train.py's config, and one at Dh 64 whose encoder (128
# positions) and decoder (128 tokens) take the K1 route.
TINY = dict(name="t", n_mels=80, n_audio_ctx=32, n_audio_state=64,
            n_audio_head=4, n_audio_layer=2, n_vocab=512, n_text_ctx=16,
            n_text_state=64, n_text_head=4, n_text_layer=2)
K1 = dict(TINY, name="t-k1", n_audio_ctx=128, n_audio_state=128,
          n_audio_head=2, n_text_ctx=128, n_text_state=128, n_text_head=2)
CONFIGS = {"tiny": TINY, "k1": K1}
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # Beside the other test workers, more intra-op threads oversubscribe.
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setup(name, moe=0, seed=0):
    """(JAX cfg, port cfg, JAX params with noised biases, batch of numpy
    arrays with a ragged mask)."""
    over = dict(CONFIGS[name], moe_experts=moe)
    jcfg, cfg = JConfig(**over), WhisperConfig(**over)
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
                         if path[-1].key.endswith(("_b", "bq", "bv", "bo"))
                         and "ln" not in path[-1].key else a), jp)
    t = jcfg.n_text_ctx
    mask = np.ones((2, t), np.float32)
    mask[1, t // 2:] = 0.0
    batch = dict(
        mel=rng.standard_normal((2, 80, 2 * jcfg.n_audio_ctx)).astype(np.float32),
        tokens=rng.integers(0, jcfg.n_vocab, (2, t)).astype(np.int32),
        targets=rng.integers(0, jcfg.n_vocab, (2, t)).astype(np.int32),
        mask=mask)
    return jcfg, cfg, jp, batch


def _port(jp):
    return params_from_jax(jax.tree.map(np.array, jp))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _args(batch):
    return [torch.from_numpy(batch[k]) for k in ("mel", "tokens", "targets", "mask")]


@pytest.fixture(scope="module", params=["tiny", "k1"])
def reference(request):
    """The reference's loss and gradients, and its params after one step."""
    jcfg, cfg, jp, batch = _setup(request.param)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(jstep.cross_entropy_loss),
                          static_argnums=(5,))(
        jp, jb["mel"], jb["tokens"], jb["targets"], jb["mask"], jcfg)
    tx = optax.adamw(LR, weight_decay=0.01)
    updates, _ = tx.update(grads, tx.init(jp), jp)
    stepped = optax.apply_updates(jp, updates)
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, jp=jp, batch=batch,
                loss=float(loss), grads=_flat(jax.tree.map(np.asarray, grads)),
                stepped=_flat(jax.tree.map(np.asarray, stepped)))


def test_loss_and_every_gradient_match_reference(reference, monkeypatch):
    from spittle_tpu_torch.ops import attention as att

    calls = []
    bwd = att.flash_attention_fullkv_bwd
    monkeypatch.setattr(att, "flash_attention_fullkv_bwd",
                        lambda *a, **k: calls.append(1) or bwd(*a, **k))
    cfg = reference["cfg"]
    params = _port(reference["jp"])
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = cross_entropy_loss(params, *_args(reference["batch"]), cfg)
    loss.backward()
    loss = loss.detach()
    # K1's backward ran for every block on the K1 route (2 encoder, 2
    # decoder), none at Dh 16.
    assert len(calls) == (4 if reference["name"] == "k1" else 0)
    np.testing.assert_allclose(float(loss), reference["loss"], rtol=1e-5)
    assert set(leaves) == set(reference["grads"])
    for name, t in leaves.items():
        want = reference["grads"][name]
        # f32 throughout; sums in another order than XLA's, and the K1
        # route's plain backward from K1's output: within 1e-4 of the
        # leaf's largest gradient (a missing term moves a leaf by far more).
        err = float(np.abs(_np(t.grad) - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()) + 1e-9, (name, err)


def test_one_adamw_step_matches_optax(reference):
    """On the first step the update is lr * g / (|g| + eps) + decay, about
    lr * sign(g): where |g| is near 0 the two sides may differ by up to
    2 * lr, so every element is held to that bound. Where |g| is over 1e-2
    of the leaf's largest (a hundred times the gradients' disagreement,
    1e-4 of it at most) and over 100 * eps, a gradient error e moves the
    update by at most lr * e * eps / g^2 (below lr * 1e-4): those elements
    are held to f32 rounding of the parameter plus lr * 1e-3."""
    cfg = reference["cfg"]
    params = _port(reference["jp"])
    init, step = make_train_step(cfg, learning_rate=LR, device="cpu")
    _, _, loss = step(params, init(params), reference["batch"])
    np.testing.assert_allclose(float(loss), reference["loss"], rtol=1e-5)
    for name, t in _flat(params).items():
        got, want = _np(t), reference["stepped"][name]
        g = np.abs(reference["grads"][name])
        far = np.abs(got - want)
        assert far.max() <= 2 * LR + 1e-6, name
        sure = (g > 1e-2 * g.max()) & (g > 1e-6)
        assert (far[sure] <= 1e-3 * LR + 1e-6 * np.abs(want[sure])).all(), name


def test_loss_decreases_over_8_steps():
    _, cfg, jp, batch = _setup("tiny")
    params = _port(jp)
    init, step = make_train_step(cfg, learning_rate=LR, device="cpu")
    state = init(params)
    losses = [float(step(params, state, batch)[2]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", ["tiny", "k1"])
def test_remat_gives_the_same_loss_and_gradients(name):
    """Recomputing the forwards in the backward changes nothing: one
    thread, the same ops in the same order, so the same bits."""
    _, cfg, jp, batch = _setup(name)
    got = []
    for remat in (False, True):
        params = _port(jp)
        leaves = _flat(params)
        for t in leaves.values():
            t.requires_grad_(True)
        loss = cross_entropy_loss(params, *_args(batch), cfg, remat=remat)
        loss.backward()
        got.append((float(loss.detach()), {k: _np(t.grad) for k, t in leaves.items()}))
    assert got[0][0] == got[1][0]
    for k in got[0][1]:
        np.testing.assert_array_equal(got[0][1][k], got[1][1][k], err_msg=k)


def test_moe_objective_adds_alpha_aux_and_trains_the_router():
    """tests/test_whisper_moe.py's check on the port: the loss at alpha 0
    and 0.01 differ by 0.01 * aux, the reference's loss is the port's, and
    a step moves the router (its gradient flows through the gate)."""
    from spittle_tpu_torch.models.whisper.model import encode_with_aux

    jcfg, cfg, jp, batch = _setup("tiny", moe=4, seed=1)
    params = _port(jp)
    args = _args(batch)
    l0 = float(cross_entropy_loss(params, *args, cfg, moe_aux_weight=0.0))
    l1 = float(cross_entropy_loss(params, *args, cfg, moe_aux_weight=0.01))
    _, aux = encode_with_aux(params, args[0], cfg)
    np.testing.assert_allclose(l1 - l0, 0.01 * float(aux), rtol=1e-3)
    jb = [jnp.asarray(batch[k]) for k in ("mel", "tokens", "targets", "mask")]
    np.testing.assert_allclose(
        l1, float(jstep.cross_entropy_loss(jp, *jb, jcfg, moe_aux_weight=0.01)),
        rtol=1e-5)
    router = params["encoder"]["blocks"]["moe_router"]
    before = router.detach().clone()
    init, step = make_train_step(cfg, learning_rate=1e-4, device="cpu")
    _, _, loss = step(params, init(params), batch)
    assert np.isfinite(float(loss))
    assert float((router.detach() - before).abs().max()) > 0


# -- SpecAugment ----------------------------------------------------------------


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_spec_augment_masks_bands_with_the_sample_mean():
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 80, 200)).astype(np.float32)) + 5.0
    out = augment.spec_augment(_gen(0), mel)
    assert out.shape == mel.shape
    changed = (out != mel).numpy()
    assert 0.01 < changed.mean() < 0.9
    for i in range(2):
        if changed[i].any():
            np.testing.assert_allclose(out[i].numpy()[changed[i]],
                                       mel[i].mean().item(), rtol=1e-5)


def test_spec_augment_deterministic_per_seed_and_batch_independent():
    mel = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 40, 120)).astype(np.float32))
    a = augment.spec_augment(_gen(1), mel)
    assert torch.equal(a, augment.spec_augment(_gen(1), mel))
    assert not torch.equal(a, augment.spec_augment(_gen(2), mel))
    masks = [(a[i] != mel[i]).numpy() for i in range(4)]
    assert any(not np.array_equal(masks[0], m) for m in masks[1:])


def test_spec_augment_zero_masks_is_identity():
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 80, 50)).astype(np.float32))
    out = augment.spec_augment(_gen(0), mel, freq_masks=0, time_masks=0)
    assert torch.equal(out, mel)


def test_spec_augment_draw_bounds():
    """The reference's randint bounds: width in [0, max_width], start in
    [0, max(length - width, 1))."""
    w, s = augment.draw_bands(_gen(3), 64, 30, 27, 10)
    w, s = w.numpy(), s.numpy()
    assert w.min() >= 0 and w.max() <= 27 and w.max() >= 20
    assert (s >= 0).all() and (s < np.maximum(30 - w, 1)).all()


def test_spec_augment_equals_reference_formula_on_the_same_draws(monkeypatch):
    """The same (width, start) draws through the port and a numpy copy of
    the reference's _axis_mask and fill: the same output, bit for bit."""
    rng = np.random.default_rng(4)
    b, n_mels, t, fm, tm = 3, 80, 300, 2, 10
    max_t = max(int(t * 0.05), 1)
    draws = []
    for length, max_w, n in ((n_mels, 27, fm), (t, max_t, tm)):
        w = rng.integers(0, max_w + 1, (b, n))
        draws.append((w, rng.integers(0, np.maximum(length - w, 1))))
    it = iter(draws)
    monkeypatch.setattr(augment, "draw_bands",
                        lambda *a: tuple(torch.from_numpy(x) for x in next(it)))
    mel = rng.standard_normal((b, n_mels, t)).astype(np.float32)
    got = augment.spec_augment(_gen(0), torch.from_numpy(mel))

    def ref_mask(w, s, length):  # the reference's _axis_mask, per sample
        idx = np.arange(length)[None, :]
        return ((idx >= s[:, None]) & (idx < (s + w)[:, None])).any(axis=0)

    want = mel.copy()
    for i in range(b):
        m = ref_mask(draws[0][0][i], draws[0][1][i], n_mels)[:, None] | \
            ref_mask(draws[1][0][i], draws[1][1][i], t)[None, :]
        want[i][m] = torch.from_numpy(mel[i]).mean().item()
    np.testing.assert_array_equal(got.numpy(), want)


# -- checkpoints ---------------------------------------------------------------


def _trainer():
    _, cfg, jp, batch = _setup("tiny")
    init, step = make_train_step(cfg, learning_rate=LR, device="cpu")
    return jp, batch, init, step


def test_checkpoint_roundtrip_and_empty(tmp_path):
    jp, batch, init, step = _trainer()
    params = _port(jp)
    state = init(params)
    step(params, state, batch)
    save_checkpoint(str(tmp_path), params, state, step=1)
    assert latest_step(str(tmp_path)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1"]
    fresh = _port(jax.tree.map(lambda a: a * 0 + 1, jp))
    r_params, r_state, r_step = restore_checkpoint(str(tmp_path),
                                                   (fresh, init(fresh)))
    assert r_step == 1 and r_params is fresh
    for name, t in _flat(params).items():
        assert torch.equal(_flat(r_params)[name], t.detach()), name
    assert restore_checkpoint(str(tmp_path / "nothing"), (None, None)) is None


def test_resumed_run_equals_unbroken(tmp_path):
    jp, batch, init, step = _trainer()
    params = _port(jp)
    state = init(params)
    unbroken = [float(step(params, state, batch)[2]) for _ in range(3)]
    first = _port(jp)
    st = init(first)
    resumed = [float(step(first, st, batch)[2])]
    save_checkpoint(str(tmp_path), first, st, step=1)
    del first, st
    fresh = _port(jax.tree.map(np.zeros_like, jp))
    p2, s2, n = restore_checkpoint(str(tmp_path), (fresh, init(fresh)))
    assert n == 1
    resumed += [float(step(p2, s2, batch)[2]) for _ in range(2)]
    assert resumed == unbroken
    for name, t in _flat(params).items():
        assert torch.equal(_flat(p2)[name], t), name


def test_interrupted_save_leaves_no_step(tmp_path, monkeypatch):
    """A save interrupted after its write, before the rename, leaves the
    earlier step_<n> as it was and no new one; a plain tree's step holds
    the one state.pt file it always has."""
    from spittle_tpu_torch.train import checkpoint as ckpt

    jp, batch, init, step = _trainer()
    params = _port(jp)
    state = init(params)
    step(params, state, batch)
    save_checkpoint(str(tmp_path), params, state, step=1)
    assert sorted(p.name for p in (tmp_path / "step_1").iterdir()) == ["state.pt"]
    written = []

    def interrupted(tmp, final):
        written.append(sorted(p.name for p in pathlib.Path(tmp).iterdir()))
        raise KeyboardInterrupt
    monkeypatch.setattr(ckpt, "_publish", interrupted)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(str(tmp_path), params, state, step=2)
    assert written == [["state.pt"]]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1"]
    assert latest_step(str(tmp_path)) == 1
    monkeypatch.undo()
    save_checkpoint(str(tmp_path), params, state, step=2)
    assert latest_step(str(tmp_path)) == 2


# -- the families' .npz writer -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Cfg:
    name: str
    width: int


@pytest.mark.parametrize("store", [np.float16, np.float32])
def test_save_family_npz_reads_back_in_both_packages(tmp_path, store):
    rng = np.random.default_rng(7)
    tree = {"enc": {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
                    "b16": torch.from_numpy(rng.standard_normal(5).astype(np.float32)
                                            ).to(torch.bfloat16),
                    "idx": np.arange(6, dtype=np.int32)},
            "head": rng.standard_normal((2, 2)).astype(np.float32)}
    cfg, pieces = _Cfg("tiny", 4), ["<unk>", "▁a", "b"]
    path = str(tmp_path / "fam.npz")
    tnpz.save_family_npz(path, cfg, tree, pieces, store_dtype=store)
    ref_path = str(tmp_path / "ref.npz")
    jnpz.save_family_npz(ref_path, cfg, {
        "enc": {k: (v.float().numpy() if torch.is_tensor(v) else v)
                for k, v in tree["enc"].items()}, "head": tree["head"]},
        pieces, store_dtype=store)
    for load in (tnpz.load_family_npz, jnpz.load_family_npz):
        got_cfg, got, got_pieces = load(path, _Cfg)
        ref_cfg, ref, _ = load(ref_path, _Cfg)
        assert got_cfg == cfg == ref_cfg and got_pieces == pieces
        assert _flat(got).keys() == _flat(ref).keys()
        for k, v in _flat(ref).items():
            np.testing.assert_array_equal(_flat(got)[k], v, err_msg=k)
        assert _flat(got)["enc/idx"].dtype == np.int32
