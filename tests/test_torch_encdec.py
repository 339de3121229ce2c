"""The port's encoder-decoder (seamless-m4t-medium) against the JAX package's.

At ``reduced()`` width (2 encoder and 4 decoder layers, d_model 128, 4
heads of 32) with the JAX init's parameters carried across by
``repro_torch.bridge``: each function of ``models/encdec.py`` and the two
cross-attention layers beside their twins, then the ``Model`` end to end.
The full-width init is traced with fake tensors (nothing allocated).
Training's fp32 frames (``make_batch``) against the bf16 weights: the
encoder in fp32 and the bf16 decoder's cross-attention over its fp32 K/V
against the JAX functions' type promotion (the gradient tree is in
``tests/test_torch_training.py``).

Tolerances, with their reasons (those of ``tests/test_torch_models.py``):

* 2e-5 in fp32 for the functions: both sides do the same fp32 arithmetic
  in another summation order, so the point is the algorithm.
* The whole model in bf16: the bounds of ``tests/test_models_decode.py`` —
  median softmax error below 0.05 and tie-aware argmax agreement (a pick
  whose reference probability lies within 0.02 of the top counts).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import unbox
from repro.models import build_model as jax_build_model
from repro.models import encdec as JED
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import encdec as TED
from repro_torch.models import layers as TL
from repro_torch.serving.engine import RealEngine

torch.set_num_threads(2)

ARCH = "seamless-m4t-medium"
FULL_PARAMS = 681_912_320      # jax.eval_shape of the JAX init, full width
F32 = dict(rtol=2e-5, atol=2e-5)
TIE_EPS = 0.02
B, S, P, S_ENC = 2, 24, 16, 12  # tests/test_models_decode.py's shapes
IMPLS = ("plain", "kernel")


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _prob_err(a, b):
    return float((a.float().softmax(-1) - b.float().softmax(-1)).abs().max())


def _tie_agree(got, want, tie_eps=TIE_EPS):
    """tests/test_models_decode.py::agree_step on [B, V] logits."""
    p_ref = want.float().softmax(-1)
    a_got, a_ref = got.argmax(-1), want.argmax(-1)
    p_top = p_ref.gather(-1, a_ref[:, None])[:, 0]
    p_picked = p_ref.gather(-1, a_got[:, None])[:, 0]
    return bool(((a_got == a_ref) | (p_top - p_picked < tie_eps)).all())


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def models(cfgs):
    jcfg, tcfg = cfgs
    jm = jax_build_model(jcfg)
    jparams = unbox(jm.init(jax.random.PRNGKey(0)))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def f32(cfgs, models):
    """fp32 configs (fp32 KV caches) and the encoder-decoder's parameters
    in fp32 on both sides."""
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype="float32")
                  for c in cfgs)
    ep = models[1]["encdec"]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), ep)
    tp = bridge.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ep))
    return jcfg, tcfg, jp, tp


def both(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def frames(seed, n=S_ENC, d=128):
    return np.random.default_rng(seed).standard_normal((B, n, d))


def bf16_frames(seed, n=S_ENC):
    """The same bf16 frame embeddings on both sides."""
    x = jnp.asarray(frames(seed, n), jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()


# ------------------------------------------------------------------ init
def test_config_is_the_jax_config():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_get_config(ARCH))


def test_init_draws_the_jax_tree(cfgs, models):
    """The port's own init: the JAX init's keys, shapes and dtypes (fp32
    LayerNorm scale and bias, bf16 position tables) and count."""
    _, jparams, tm, _ = models
    own = tm.init(0, device="cpu")
    assert sorted(own) == ["embed", "encdec"]
    assert sorted(own["encdec"]) == sorted(jparams["encdec"])
    jl, tl = jax.tree.leaves(jparams), list(_leaves(own))
    assert [tuple(a.shape) for a in jl] == [tuple(t.shape) for t in tl]
    assert [str(a.dtype) for a in jl] == \
        [str(t.dtype).replace("torch.", "") for t in tl]
    norm = own["encdec"]["enc_blocks"]["norm_attn"]
    assert norm["scale"].dtype == norm["bias"].dtype == torch.float32
    d = cfgs[1].d_model
    pos = own["encdec"]["pos_dec"].float()
    assert abs(float(pos.std()) - d ** -0.5) < 0.1 * d ** -0.5


def test_full_width_init_draws_the_jax_tree():
    """12 + 12 layers at full width, traced with fake tensors: the JAX
    init's shapes and dtypes, 681,912,320 parameters (with both 32768-row
    position tables)."""
    jshapes = jax.tree.leaves(unbox(jax.eval_shape(
        jax_build_model(jax_get_config(ARCH)).init, jax.random.PRNGKey(0))))
    with FakeTensorMode():
        own = list(_leaves(build_model(get_config(ARCH)).init(
            0, device="cpu")))
    assert [tuple(a.shape) for a in jshapes] == [tuple(t.shape) for t in own]
    assert [str(a.dtype) for a in jshapes] == \
        [str(t.dtype).replace("torch.", "") for t in own]
    assert sum(t.numel() for t in own) == FULL_PARAMS
    assert sum(int(np.prod(a.shape)) for a in jshapes) == FULL_PARAMS


@pytest.mark.parametrize("enc_len", [0, 7])
def test_init_cache_matches_jax(cfgs, models, enc_len):
    jm, _, tm, _ = models
    want = jm.init_cache(3, 20, enc_len=enc_len)
    got = tm.init_cache(3, 20, enc_len=enc_len, device="cpu")
    assert sorted(got) == sorted(want) == ["cross_k", "cross_v", "self"]
    assert sorted(got["self"]) == sorted(want["self"])
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    assert got["cross_k"].shape[2] == (enc_len or 20)


# ------------------------------------------------------------- functions
@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(f32, impl):
    jcfg, tcfg, jp, tp = f32
    sj, st = both(frames(1))
    close(TED.encode(tcfg, tp, st, attn_impl=impl),
          JED.encode(jcfg, jp, sj), **F32)


def test_cross_kv_and_cross_cache_match_jax(f32):
    jcfg, tcfg, jp, tp = f32
    ej, et = both(frames(2))
    p = jax.tree.map(lambda a: a[1], jp["dec_blocks"])["cross_attn"]
    k, v = TL.cross_kv(tcfg, {n: t[1] for n, t in
                              tp["dec_blocks"]["cross_attn"].items()}, et)
    kj, vj = JL.cross_kv(jcfg, p, ej)
    close(k, kj, **F32)
    close(v, vj, **F32)
    got = TED.build_cross_cache(tcfg, tp, et)
    want = JED.build_cross_cache(jcfg, jp, ej)
    assert got["cross_k"].shape == (4, B, S_ENC, 4, 32)
    for name in ("cross_k", "cross_v"):
        close(got[name], want[name], **F32)


@pytest.mark.parametrize("override", [0.0, 0.3])
@pytest.mark.parametrize("impl", IMPLS)
def test_cross_attention_forward_matches_jax(f32, impl, override):
    """Non-causal, S_dec = 5 queries over 12 encoder keys, at the config's
    scale (``attn_scale_override`` when set)."""
    jcfg, tcfg = (dataclasses.replace(c, attn_scale_override=override)
                  for c in f32[:2])
    jp, tp = f32[2:]
    rng = np.random.default_rng(3)
    xj, xt = both(rng.standard_normal((B, 5, 128)))
    kj, kt = both(rng.standard_normal((B, S_ENC, 4, 32)))
    vj, vt = both(rng.standard_normal((B, S_ENC, 4, 32)))
    pj = jax.tree.map(lambda a: a[0], jp["dec_blocks"])["cross_attn"]
    pt = {n: t[0] for n, t in tp["dec_blocks"]["cross_attn"].items()}
    close(TL.cross_attention_forward(tcfg, pt, xt, kt, vt, attn_impl=impl),
          JL.cross_attention_forward(jcfg, pj, xj, kj, vj), **F32)


def _jax_self_caches(jcfg, T):
    one = JL.kv_cache_init(jcfg, B, T)
    return jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (jcfg.num_layers,) + x.shape),
        one)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_forward_matches_jax(f32, impl):
    """The teacher-forced decoder over the cross cache, writing its self
    caches: x and every layer's cache against the JAX twin's (which
    projects the encoder's output itself)."""
    jcfg, tcfg, jp, tp = f32
    rng = np.random.default_rng(4)
    xj, xt = both(rng.standard_normal((B, P, 128)))
    ej, et = both(frames(5))
    pos = np.broadcast_to(np.arange(P), (B, P))
    want, wc = JED.decode_forward(jcfg, jp, xj, ej, positions=jnp.asarray(pos),
                                  self_caches=_jax_self_caches(jcfg, S))
    caches = TL.kv_cache_init(tcfg, B, S, device="cpu",
                              lead=(tcfg.num_layers,))
    got, gc = TED.decode_forward(tcfg, tp, xt, TED.build_cross_cache(
        tcfg, tp, et), positions=torch.from_numpy(pos.copy()),
        self_caches=caches, attn_impl=impl)
    assert gc is caches
    close(got, want, **F32)
    for name in ("k", "v"):
        close(gc[name], wc[name], **F32)


@pytest.mark.parametrize("override", [0.0, 0.3])
@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_matches_jax(f32, impl, override):
    """Three decode steps after a teacher-forced prefill of the self
    caches.  With ``attn_scale_override`` set, the self-attention takes
    the override and the cross-attention 1/sqrt(head_dim), as in the JAX
    twin."""
    jcfg, tcfg = (dataclasses.replace(c, attn_scale_override=override)
                  for c in f32[:2])
    jp, tp = f32[2:]
    rng = np.random.default_rng(6)
    ej, et = both(frames(7))
    xj, xt = both(rng.standard_normal((B, P, 128)))
    pos = np.broadcast_to(np.arange(P), (B, P))
    _, jc = JED.decode_forward(jcfg, jp, xj, ej, positions=jnp.asarray(pos),
                               self_caches=_jax_self_caches(jcfg, S))
    cross_j = JED.build_cross_cache(jcfg, jp, ej)
    cross_t = TED.build_cross_cache(tcfg, tp, et)
    tc = TL.kv_cache_init(tcfg, B, S, device="cpu", lead=(tcfg.num_layers,))
    TED.decode_forward(tcfg, tp, xt, cross_t, positions=torch.from_numpy(
        pos.copy()), self_caches=tc, attn_impl=impl)
    for t in range(P, P + 3):
        x1j, x1t = both(rng.standard_normal((B, 1, 128)))
        lens = np.full((B,), t, np.int32)
        want, jc = JED.decode_step(jcfg, jp, x1j, lengths=jnp.asarray(lens),
                                   self_caches=jc, cross_cache=cross_j)
        got, tc = TED.decode_step(tcfg, tp, x1t, lengths=torch.from_numpy(
            lens), self_caches=tc, cross_cache=cross_t, attn_impl=impl)
        close(got, want, **F32)
        for name in ("k", "v"):
            close(tc[name], jc[name], **F32)


def test_scale_override_moves_decode_step(f32):
    """The override case above is not vacuous: with it the decode step
    moves by far more than the tolerance."""
    jcfg, tcfg, jp, tp = f32
    rng = np.random.default_rng(8)
    xt = torch.from_numpy(rng.standard_normal((B, 1, 128)).astype(np.float32))
    cross = TED.build_cross_cache(tcfg, tp, torch.from_numpy(
        frames(9).astype(np.float32)))
    outs = []
    for c in (tcfg, dataclasses.replace(tcfg, attn_scale_override=0.3)):
        caches = TL.kv_cache_init(c, B, S, device="cpu", lead=(c.num_layers,))
        caches["k"].normal_(generator=torch.Generator().manual_seed(0))
        outs.append(TED.decode_step(c, tp, xt, lengths=torch.full(
            (B,), 10, dtype=torch.int32), self_caches=caches,
            cross_cache=cross, attn_impl="plain")[0])
    assert float((outs[0] - outs[1]).abs().max()) > 1e3 * F32["atol"]


# ----------------------------------------------------------------- model
def test_model_logits_match_jax(models):
    """bf16, bridged parameters: the port's teacher-forced forward, its
    prefill and every decode step against the JAX Model's."""
    jm, jparams, tm, tparams = models
    tgt = np.random.default_rng(10).integers(0, 256, (B, S)).astype(np.int32)
    sj, st = bf16_frames(11)
    xj, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(
        jparams, {"src_embeds": sj, "tgt_tokens": jnp.asarray(tgt)})
    xt, aux = tm.forward(tparams, {"src_embeds": st,
                                   "tgt_tokens": torch.from_numpy(tgt)})
    assert float(aux) == 0.0 and aux.dtype == torch.float32
    full_t = tm._logits(tparams, xt)
    assert full_t.shape == (B, S, 256) and bool(torch.isfinite(full_t).all())
    errs = [_prob_err(full_t, torch.from_numpy(
        np.array(jm._logits(jparams, xj))))]

    cj = jm.init_cache(B, S, enc_len=S_ENC)
    ct = tm.init_cache(B, S, enc_len=S_ENC, device="cpu")
    lgj, cj, _ = jax.jit(jm.prefill)(
        jparams, {"src_embeds": sj, "tgt_tokens": jnp.asarray(tgt[:, :P])},
        cj)
    lgt, ct, lens = tm.prefill(tparams, {
        "src_embeds": st, "tgt_tokens": torch.from_numpy(tgt[:, :P])}, ct)
    assert lens.tolist() == [P] * B and lens.dtype == torch.int32
    steps = [(lgt, np.array(lgj))]
    decode = jax.jit(jm.decode)
    for t in range(P, S):
        lgj, cj = decode(jparams, jnp.asarray(tgt[:, t]), cj,
                         jnp.full((B,), t, jnp.int32))
        lgt, ct = tm.decode(tparams, torch.from_numpy(tgt[:, t]).long(), ct,
                            torch.full((B,), t, dtype=torch.int32))
        steps.append((lgt, np.array(lgj)))
    for got, want in steps:
        want = torch.from_numpy(want)
        errs.append(_prob_err(got, want))
        assert _tie_agree(got, want)
    assert np.median(errs) < 0.05, errs


def test_prefill_decode_matches_forward(models):
    """tests/test_models_decode.py::_consistency for the port alone."""
    _, _, tm, tparams = models
    tgt = torch.from_numpy(
        np.random.default_rng(12).integers(0, 256, (B, S)))
    st = bf16_frames(13)[1]
    x, _ = tm.forward(tparams, {"src_embeds": st, "tgt_tokens": tgt})
    full = tm._logits(tparams, x)
    cache = tm.init_cache(B, S, enc_len=S_ENC, device="cpu")
    lg, cache, _ = tm.prefill(tparams, {"src_embeds": st,
                                        "tgt_tokens": tgt[:, :P]}, cache)
    errs, agree = [_prob_err(lg, full[:, P - 1])], \
        [_tie_agree(lg, full[:, P - 1])]
    for t in range(P, S):
        lg, cache = tm.decode(tparams, tgt[:, t], cache,
                              torch.full((B,), t, dtype=torch.int32))
        errs.append(_prob_err(lg, full[:, t]))
        agree.append(_tie_agree(lg, full[:, t]))
    assert np.median(errs) < 0.05, errs
    assert np.mean(agree) >= 0.85


@pytest.mark.parametrize("enc_len", [0, 5, S_ENC, 40])
def test_prefill_replaces_the_cross_cache(models, enc_len):
    """Whatever ``enc_len`` the cache was made with (0: max_len), the
    prefill leaves cross K/V of the encoder's own length, equal to
    ``build_cross_cache`` of its output; the self caches are written in
    place; and every decode step equals the one over a cache made at the
    encoder's length."""
    _, _, tm, tparams = models
    cfg = tm.cfg
    tgt = torch.from_numpy(np.random.default_rng(14).integers(0, 256, (B, S)))
    st = bf16_frames(15)[1]
    batch = {"src_embeds": st, "tgt_tokens": tgt[:, :P]}
    runs = []
    for n in (enc_len, S_ENC):
        cache = tm.init_cache(B, S, enc_len=n, device="cpu")
        self_k = cache["self"]["k"]
        lg, cache, lens = tm.prefill(tparams, batch, cache)
        assert cache["self"]["k"] is self_k
        assert bool(self_k[:, :, :P].ne(0).any())
        steps = [lg]
        for t in range(P, S):
            lg, cache = tm.decode(tparams, tgt[:, t], cache,
                                  torch.full((B,), t, dtype=torch.int32))
            steps.append(lg)
        runs.append((cache, steps))
    cache = runs[0][0]
    want = TED.build_cross_cache(cfg, tparams["encdec"], TED.encode(
        cfg, tparams["encdec"], st))
    for name in ("cross_k", "cross_v"):
        assert cache[name].shape == (cfg.num_layers, B, S_ENC, 4, 32)
        assert torch.equal(cache[name], want[name])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_decode_clips_the_position_table(models):
    """A decode step's learned position is ``pos_dec[clip(lengths, 0,
    POS_TABLE_LEN - 1)]``, as in the JAX twin: at lengths past the table
    the step equals the one at its last row over the same cache slot, and
    matches JAX there; a row inside the table moves it."""
    jm, jparams, tm, tparams = models
    last = TED.POS_TABLE_LEN - 1
    tok = np.random.default_rng(16).integers(0, 256, (B,)).astype(np.int32)
    sj, st = bf16_frames(17)
    tgt = np.random.default_rng(18).integers(0, 256, (B, P)).astype(np.int32)
    cj = jax.jit(jm.prefill)(jparams, {"src_embeds": sj,
                                       "tgt_tokens": jnp.asarray(tgt)},
                             jm.init_cache(B, S, enc_len=S_ENC))[1]
    ct = tm.prefill(tparams, {"src_embeds": st, "tgt_tokens":
                              torch.from_numpy(tgt)},
                    tm.init_cache(B, S, enc_len=S_ENC, device="cpu"))[1]
    snapshot = {k: v.clone() for k, v in ct["self"].items()}

    def step(length):
        ct["self"].update({k: v.clone() for k, v in snapshot.items()})
        return tm.decode(tparams, torch.from_numpy(tok).long(), ct,
                         torch.full((B,), length, dtype=torch.int32))[0]

    # the same slot (length % S) at each of these lengths
    at_last, past = step(last), step(last + 5 * S)
    inside = step(last - S)
    assert torch.equal(at_last, past)
    assert _prob_err(at_last, inside) > 1e-3
    want, _ = jax.jit(jm.decode)(jparams, jnp.asarray(tok), cj,
                                 jnp.full((B,), last + 5 * S, jnp.int32))
    want = torch.from_numpy(np.array(want))
    assert _prob_err(past, want) < 0.05 and _tie_agree(past, want)


def test_src_embeds_must_take_the_weights_dtype(models):
    """fp32 frames against bf16 weights promote the encoder to fp32, as
    the JAX package's type promotion does (no longer refused): the
    teacher-forced logits and a prefill against the JAX Model's on the
    same fp32 frames, under the bounds of tests/test_models_decode.py;
    the prefill keeps an fp32 cross cache, which decode attends in fp32."""
    jm, jparams, tm, tparams = models
    tgt = np.random.default_rng(19).integers(0, 256, (B, S)).astype(np.int32)
    src = np.asarray(frames(19), np.float32) * 0.02
    jb = {"src_embeds": jnp.asarray(src), "tgt_tokens": jnp.asarray(tgt)}
    tb = {"src_embeds": torch.from_numpy(src.copy()),
          "tgt_tokens": torch.from_numpy(tgt).long()}
    xj, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(jparams, jb)
    want = torch.from_numpy(np.array(jm._logits(jparams, xj)))
    x, _ = tm.forward(tparams, tb)
    assert x.dtype == torch.bfloat16
    got = tm._logits(tparams, x)
    for i in range(S):
        assert _prob_err(got[:, i], want[:, i]) < 0.05
        assert _tie_agree(got[:, i], want[:, i])
    cache = tm.init_cache(B, S, device="cpu")
    lg, cache, _ = tm.prefill(tparams, {"src_embeds": tb["src_embeds"],
                                        "tgt_tokens": tb["tgt_tokens"][:, :P]},
                              cache)
    assert cache["cross_k"].dtype == cache["cross_v"].dtype == torch.float32
    assert _prob_err(lg, want[:, P - 1]) < 0.05
    lg, _ = tm.decode(tparams, tb["tgt_tokens"][:, P], cache,
                      torch.full((B,), P, dtype=torch.int32))
    assert _prob_err(lg, want[:, P]) < 0.05 and _tie_agree(lg, want[:, P])


@pytest.mark.parametrize("impl", IMPLS)
def test_fp32_frames_encode_matches_jax(models, cfgs, impl):
    """make_batch's fp32 frames against the init's bf16 weights: the whole
    encoder in fp32 on both sides (each weight widened at its product),
    so fp32's tolerance holds; the cross K/V come out fp32 too."""
    jcfg, tcfg = cfgs
    _, jparams, _, tparams = models
    jp, tp = jparams["encdec"], tparams["encdec"]
    src = np.asarray(frames(23), np.float32) * 0.02
    want = JED.encode(jcfg, jp, jnp.asarray(src))
    got = TED.encode(tcfg, tp, torch.from_numpy(src.copy()), attn_impl=impl)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    close(got, want, **F32)
    cj = JED.build_cross_cache(jcfg, jp, want)
    ct = TED.build_cross_cache(tcfg, tp, got)
    for name in ("cross_k", "cross_v"):
        assert ct[name].dtype == torch.float32
        close(ct[name], cj[name], **F32)


@pytest.mark.parametrize("impl", IMPLS)
def test_mixed_dtype_cross_attention_matches_jax(models, cfgs, impl):
    """A bf16 decoder's cross-attention over an fp32 encoder's K/V: the
    JAX twin's einsums promote q exactly and its blocked_attention
    returns q's dtype; the port makes one fp32 call on q widened, its
    output cast to bf16, then the bf16 out-projection.  Within the bf16
    kernel tolerance (2e-2), after the one rounding of the attention's
    output on both sides."""
    jcfg, tcfg = cfgs
    _, jparams, _, tparams = models
    rng = np.random.default_rng(24)
    xj, xt = bf16_frames(25, n=5)
    kj, kt = both(rng.standard_normal((B, S_ENC, 4, 32)))
    vj, vt = both(rng.standard_normal((B, S_ENC, 4, 32)))
    pj = jax.tree.map(lambda a: a[0],
                      jparams["encdec"]["dec_blocks"])["cross_attn"]
    pt = {n: t[0] for n, t in
          tparams["encdec"]["dec_blocks"]["cross_attn"].items()}
    want = JL.cross_attention_forward(jcfg, pj, xj, kj, vj)
    got = TL.cross_attention_forward(tcfg, pt, xt, kt, vt, attn_impl=impl)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    close(got, want, rtol=2e-2, atol=2e-2)


def test_kernel_and_plain_impls_agree_on_cpu(models, cfgs):
    """attn_impl='kernel' (the kernels' plain versions on the CPU: flash
    for the encoder, the decoder's prefill and the cross-attention, paged
    for both decode attentions) against attn_impl='plain'."""
    _, _, tm, tparams = models
    plain = build_model(cfgs[1], attn_impl="plain")
    tgt = torch.from_numpy(np.random.default_rng(20).integers(0, 256, (B, S)))
    st = bf16_frames(21)[1]
    outs = []
    for m in (tm, plain):
        cache = m.init_cache(B, S, device="cpu")
        lg, cache, _ = m.prefill(tparams, {"src_embeds": st,
                                           "tgt_tokens": tgt[:, :P]}, cache)
        steps = [lg]
        for t in range(P, S):
            lg, cache = m.decode(tparams, tgt[:, t], cache,
                                 torch.full((B,), t, dtype=torch.int32))
            steps.append(lg)
        outs.append(steps)
    for a, b in zip(*outs):
        assert _prob_err(a, b) < 0.05 and _tie_agree(a, b)


def test_engine_refuses_an_encoder_decoder(models):
    """The engine feeds token prompts; the reference engine has no
    src_embeds path either: a loud refusal, before any session opens."""
    _, _, tm, tparams = models
    with pytest.raises(ValueError, match="src_embeds"):
        RealEngine(tm, tparams, mode="dynamic_pd", device="cpu")
