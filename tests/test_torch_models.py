"""The port's model layers and dense decoder against the JAX package's.

Each ported function in ``repro_torch.models.layers`` is run beside its
twin in ``repro.models.layers`` on the same numpy-drawn inputs and on
parameters carried across by ``repro_torch.bridge``.  The reduced olmo-1b
(4 layers, d=128) is then held against the JAX ``Model`` end to end, and
the port's prefill plus decode against its own teacher-forced forward.

Tolerances, with their reasons:

* 2e-5 in fp32 for a single layer: both sides do the same fp32 arithmetic
  in another summation order, so the point is the algorithm.
* Whole model in bf16 (the model's own working type): the bounds of
  ``tests/test_models_decode.py`` — median softmax error below 0.05 and
  tie-aware argmax agreement (a pick whose reference probability is
  within 0.02 of the top counts as agreement).  The two frameworks round
  bf16 at different places, so logits may differ by a few bf16 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import unbox
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import Activation, MoEConfig, Norm, SSMConfig
from repro_torch.configs.base import Family, PosEmb
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(2)

F32 = dict(rtol=2e-5, atol=2e-5)
TIE_EPS = 0.02


def both(x, dtype=np.float32):
    """One numpy array as a JAX array and a torch tensor (fp32 or int)."""
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


def f32_params(tree):
    """A JAX param tree (unboxed) as fp32 on both sides."""
    jt = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    return jt, bridge.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), tree))


@pytest.fixture(scope="module")
def cfgs():
    """(JAX config, port config) for olmo-1b at smoke width."""
    return jax_get_config("olmo-1b").reduced(), get_config("olmo-1b").reduced()


@pytest.fixture(scope="module")
def models(cfgs):
    jcfg, tcfg = cfgs
    jm = jax_build_model(jcfg)
    jparams = unbox(jm.init(jax.random.PRNGKey(0)))
    tparams = bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(tcfg), tparams


# ----------------------------------------------------------------- bridge
def test_bridge_keeps_structure_and_bits(models):
    """Param boxes unwrap, stacked layer lists keep their repeats axis, and
    bf16 arrives bit for bit."""
    from repro.distributed.sharding import Param
    jm, jparams, _, tparams = models
    boxed = bridge.params_from_numpy(
        jax.tree.map(lambda p: Param(np.asarray(p.value), p.axes),
                     jm.init(jax.random.PRNGKey(0)),
                     is_leaf=lambda p: isinstance(p, Param)))
    jl, jdef = jax.tree.flatten(jparams)
    for t in (tparams, boxed):
        tl = [x for x in _leaves(t)]
        assert len(tl) == len(jl)
        for a, b in zip(jl, tl):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                else np.asarray(a),
                b.view(torch.uint16).numpy() if b.dtype == torch.bfloat16
                else b.numpy())
    wq = tparams["blocks"][0]["attn"]["wq"]
    assert wq.shape[0] == 4 and wq.dtype == torch.bfloat16


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_init_matches_jax_shapes_and_dtypes(cfgs, models):
    """The port's own initialiser draws the same tree as the JAX one."""
    _, jparams, tm, _ = models
    own = tm.init(0, device="cpu")
    jl = jax.tree.leaves(jparams)
    tl = list(_leaves(own))
    assert [tuple(a.shape) for a in jl] == [tuple(b.shape) for b in tl]
    assert [str(a.dtype) for a in jl] == \
        [str(b.dtype).replace("torch.", "") for b in tl]
    # std 1/sqrt(fan_in) like dense_param / embed_param
    d = cfgs[1].d_model
    assert abs(float(own["embed"].float().std()) - d ** -0.5) < 0.1 * d ** -0.5


# ----------------------------------------------------------------- layers
@pytest.mark.parametrize("norm", [Norm.NONPARAM_LN, Norm.RMSNORM,
                                  Norm.LAYERNORM])
def test_apply_norm(cfgs, norm):
    jcfg, tcfg = (dataclasses.replace(c, norm=norm) for c in cfgs)
    rng = np.random.default_rng(1)
    xj, xt = both(rng.standard_normal((2, 5, 128)) * 3 + 1)
    p = {"scale": rng.standard_normal(128) + 1, "bias": rng.standard_normal(128)}
    pj = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    pt = {k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()}
    close(TL.apply_norm(tcfg, pt, xt), JL.apply_norm(jcfg, pj, xj), **F32)


def test_rope():
    rng = np.random.default_rng(2)
    pj, pt = both(rng.integers(0, 2000, (2, 7)), np.int32)
    cj, sj = JL.rope_cos_sin(pj, 32, 10_000.0)
    ct, st = TL.rope_cos_sin(pt, 32, 10_000.0)
    close(ct, cj, **F32)
    close(st, sj, **F32)
    xj, xt = both(rng.standard_normal((2, 7, 4, 32)))
    close(TL.apply_rope(xt, ct, st), JL.apply_rope(xj, cj, sj), **F32)
    # a rotation: norms are kept
    np.testing.assert_allclose(
        TL.apply_rope(xt, ct, st).norm(dim=-1).numpy(),
        xt.norm(dim=-1).numpy(), rtol=1e-5)


@pytest.mark.parametrize("causal,window,softcap,ragged", [
    (True, 0, 0.0, False), (True, 8, 0.0, False), (True, 0, 20.0, False),
    (False, 0, 0.0, True), (True, 0, 0.0, True)])
def test_blocked_attention(causal, window, softcap, ragged):
    rng = np.random.default_rng(3)
    B, S, T, H, KVH, D = 2, 37, 37, 4, 2, 16
    qj, qt = both(rng.standard_normal((B, S, H, D)))
    kj, kt = both(rng.standard_normal((B, T, KVH, D)))
    vj, vt = both(rng.standard_normal((B, T, KVH, D)))
    kw = dict(causal=causal, scale=0.3, window=window, softcap=softcap,
              block_q=16, block_kv=8)
    jkw, tkw = dict(kw), dict(kw)
    if ragged:   # absolute query positions against a partly filled cache
        pos = rng.integers(0, T, (B, S)).astype(np.int32)
        lens = np.asarray([30, 19], np.int32)
        jkw.update(q_positions=jnp.asarray(pos), kv_lengths=jnp.asarray(lens))
        tkw.update(q_positions=torch.from_numpy(pos),
                   kv_lengths=torch.from_numpy(lens))
    close(TL.blocked_attention(qt, kt, vt, **tkw),
          JL.blocked_attention(qj, kj, vj, **jkw), **F32)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 15.0)])
def test_decode_attention(window, softcap):
    rng = np.random.default_rng(4)
    B, T, H, KVH, D = 3, 24, 8, 2, 16
    qj, qt = both(rng.standard_normal((B, 1, H, D)))
    kj, kt = both(rng.standard_normal((B, T, KVH, D)))
    vj, vt = both(rng.standard_normal((B, T, KVH, D)))
    lj, lt = both([24, 9, 1], np.int32)
    kw = dict(scale=0.25, window=window, softcap=softcap)
    want = JL.decode_attention(qj, kj, vj, lengths=lj, **kw)
    close(TL.decode_attention(qt, kt, vt, lengths=lt, **kw), want, **F32)
    if window == 0:
        # the kernel path's view of the slot cache as identity-mapped pages
        close(TL.paged_decode_attention(qt, kt, vt, lengths=lt, scale=0.25,
                                        softcap=softcap), want, **F32)


@pytest.mark.parametrize("S", [5, 16, 21])
def test_kv_writes(cfgs, S):
    """Prefill write (short prompt, and S >= T ring-aligned), then a decode
    write at lengths % T, against the JAX writes."""
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype="float32")
                  for c in cfgs)
    rng = np.random.default_rng(S)
    B, T = 2, 16
    kj, kt = both(rng.standard_normal((B, S, 4, 32)))
    vj, vt = both(rng.standard_normal((B, S, 4, 32)))
    cj = JL.kv_write_prefill(JL.kv_cache_init(jcfg, B, T), kj, vj)
    ct = TL.kv_write_prefill(TL.kv_cache_init(tcfg, B, T, device="cpu"),
                             kt, vt)
    k1j, k1t = both(rng.standard_normal((B, 1, 4, 32)))
    v1j, v1t = both(rng.standard_normal((B, 1, 4, 32)))
    lj, lt = both([S, 3], np.int32)
    cj = JL.kv_write_decode(cj, k1j, v1j, lj)
    ct = TL.kv_write_decode(ct, k1t, v1t, lt)
    for a, b in zip(JL.kv_read(cj, jnp.float32), TL.kv_read(ct)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_attention_forward_and_decode(cfgs, models, impl):
    """One attention layer on bridged fp32 parameters: prefill writes the
    cache, then two decode steps read it back (``kernel`` takes the CPU
    side of the kernels' dispatch: their plain versions)."""
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype="float32")
                  for c in cfgs)
    _, jparams, _, _ = models
    pj, pt = f32_params(jax.tree.map(lambda a: a[0],
                                     jparams["blocks"][0]["attn"]))
    rng = np.random.default_rng(6)
    B, S, T = 2, 11, 16
    xj, xt = both(rng.standard_normal((B, S, 128)))
    posj, post = both(np.broadcast_to(np.arange(S), (B, S)), np.int32)
    cj = JL.kv_cache_init(jcfg, B, T)
    ct = TL.kv_cache_init(tcfg, B, T, device="cpu")
    oj, cj = JL.attention_forward(jcfg, pj, xj, posj, cache=cj)
    ot, ct = TL.attention_forward(tcfg, pt, xt, post, cache=ct,
                                  attn_impl=impl)
    close(ot, oj, **F32)
    for step in range(2):
        x1j, x1t = both(rng.standard_normal((B, 1, 128)))
        lj, lt = both([S + step, S + step], np.int32)
        oj, cj = JL.attention_decode(jcfg, pj, x1j, lj, cache=cj)
        ot, ct = TL.attention_decode(tcfg, pt, x1t, lt, cache=ct,
                                     attn_impl=impl)
        close(ot, oj, **F32)
    close(ct["k"], cj["k"], **F32)


@pytest.mark.parametrize("act", [Activation.SWIGLU, Activation.GEGLU,
                                 Activation.GELU, Activation.SQUARED_RELU])
def test_mlp(cfgs, act):
    jcfg, tcfg = (dataclasses.replace(c, activation=act) for c in cfgs)
    jp = unbox(JL.mlp_params(jcfg, jax.random.PRNGKey(1)))
    pj, pt = f32_params(jp)
    assert set(pt) == set(TL.mlp_params(tcfg, torch.Generator(),
                                        device="cpu"))
    xj, xt = both(np.random.default_rng(7).standard_normal((2, 3, 128)))
    close(TL.apply_mlp(tcfg, pt, xt), JL.apply_mlp(jcfg, pj, xj), **F32)


def test_attention_params_shapes(cfgs):
    jp = unbox(JL.attention_params(cfgs[0], jax.random.PRNGKey(2)))
    tp = TL.attention_params(cfgs[1], torch.Generator(), device="cpu",
                             lead=(3,))
    for name in ("wq", "wk", "wv", "wo"):
        assert tuple(tp[name].shape) == (3, *jp[name].shape)
        assert tp[name].dtype == torch.bfloat16
    assert TL._attn_scale(cfgs[1]) == pytest.approx(
        float(JL._attn_scale(cfgs[0])))


# ------------------------------------------------------------ whole model
def _tie_agree(lg, ref):
    """tests/test_models_decode.py::agree_step, in torch."""
    p_ref = ref.float().softmax(-1)
    a_got, a_ref = lg.argmax(-1), ref.argmax(-1)
    p_top = p_ref.gather(-1, a_ref[..., None])[..., 0]
    p_pick = p_ref.gather(-1, a_got[..., None])[..., 0]
    return bool(((a_got == a_ref) | (p_top - p_pick < TIE_EPS)).all())


def _prob_err(a, b):
    return float((a.float().softmax(-1) - b.float().softmax(-1)).abs().max())


B, S, P = 2, 24, 16


def test_model_logits_match_jax(models):
    """Reduced olmo-1b, bridged bf16 parameters: the port's forward, prefill
    and every decode step against the JAX Model's."""
    jm, jparams, tm, tparams = models
    toks = np.random.default_rng(8).integers(0, 256, (B, S)).astype(np.int32)
    xj, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(
        jparams, {"tokens": jnp.asarray(toks)})
    xt, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks).long()})
    full_j = np.array(jm._logits(jparams, xj))
    full_t = tm._logits(tparams, xt)
    assert full_t.shape == (B, S, 256)
    errs = [_prob_err(full_t, torch.from_numpy(full_j))]

    cj = jm.init_cache(B, S)
    ct = tm.init_cache(B, S, device="cpu")
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode)
    lgj, cj, _ = prefill(jparams, {"tokens": jnp.asarray(toks[:, :P])}, cj)
    lgt, ct, lens = tm.prefill(tparams,
                               {"tokens": torch.from_numpy(toks[:, :P])
                                .long()}, ct)
    assert lens.tolist() == [P, P]
    steps = [(lgt, np.array(lgj))]
    for t in range(P, S):
        lgj, cj = decode(jparams, jnp.asarray(toks[:, t]), cj,
                         jnp.full((B,), t, jnp.int32))
        lgt, ct = tm.decode(tparams, torch.from_numpy(toks[:, t]).long(), ct,
                            torch.full((B,), t, dtype=torch.int32))
        steps.append((lgt, np.array(lgj)))
    for got, want in steps:
        want = torch.from_numpy(want)
        errs.append(_prob_err(got, want))
        assert _tie_agree(got, want)
    assert np.median(errs) < 0.05, errs
    assert bool(torch.isfinite(full_t).all())


def test_prefill_decode_matches_forward(models):
    """tests/test_models_decode.py::_consistency for the port alone."""
    _, _, tm, tparams = models
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, 256, (B, S))).long()
    x, aux = tm.forward(tparams, {"tokens": toks})
    full = tm._logits(tparams, x)
    assert float(aux) == 0.0
    cache = tm.init_cache(B, S, device="cpu")
    lg, cache, _ = tm.prefill(tparams, {"tokens": toks[:, :P]}, cache)
    errs, agree = [_prob_err(lg, full[:, P - 1])], \
        [_tie_agree(lg, full[:, P - 1])]
    for t in range(P, S):
        lg, cache = tm.decode(tparams, toks[:, t], cache,
                              torch.full((B,), t, dtype=torch.int32))
        errs.append(_prob_err(lg, full[:, t]))
        agree.append(_tie_agree(lg, full[:, t]))
    assert np.median(errs) < 0.05, errs
    assert np.mean(agree) >= 0.85


@pytest.mark.parametrize("tied", [True, False])
def test_logits_in_chunks_match_the_whole_head(cfgs, monkeypatch, tied):
    """``Model._logits`` widens the head to fp32 in row chunks of at most
    LOGITS_CHUNK_BYTES: at 100 rows a chunk (three chunks of the 256-row
    vocab, the last ragged) it equals one product with the whole fp32
    head, tied embedding or untied ``head`` [d, V]."""
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(cfgs[1], tie_embeddings=tied)
    m = build_model(cfg)
    params = m.init(0, device="cpu")
    x = torch.randn(2, 3, cfg.d_model,
                    generator=torch.Generator().manual_seed(0)).bfloat16()
    head = params["embed"].t() if tied else params["head"]
    want = torch.einsum("...d,dv->...v", x.float(), head.float())
    monkeypatch.setattr(TM, "LOGITS_CHUNK_BYTES", 4 * cfg.d_model * 100)
    got = m._logits(params, x)
    assert got.shape == (2, 3, cfg.vocab_size) and got.dtype == torch.float32
    close(got, want, **F32)


@pytest.mark.parametrize("where", ["cpu prefill", "cpu autograd", "meta"])
def test_logits_off_the_card_take_the_widened_product(cfgs, where):
    """Off a card (a CPU prefill under inference mode, ``meta`` shapes) and
    under autograd, ``Model._logits`` widens the head: each call adds one
    to ``LOGITS_PRODUCTS["widened_f32"]`` and nothing to ``"bf16_f32"``,
    the product that reads a bf16 head as stored on a card."""
    from repro_torch.models import model as TM
    cfg = cfgs[1]
    m = build_model(cfg)
    dev = "meta" if where == "meta" else "cpu"
    params = m.init(0, device=dev)
    before = dict(TM.LOGITS_PRODUCTS)
    if where == "cpu prefill":
        toks = torch.arange(8).reshape(1, 8) % cfg.vocab_size
        logits, _, _ = m.prefill(params, {"tokens": toks},
                                 m.init_cache(1, 8, device="cpu"))
    else:
        x = torch.randn(2, 3, cfg.d_model, device=dev).bfloat16()
        if where == "meta":
            with torch.inference_mode():
                logits = m._logits(params, x)
        else:
            head = params["embed" if cfg.tie_embeddings else "head"]
            head.requires_grad_(True)
            logits = m._logits(params, x)
            logits.sum().backward()
            assert head.grad is not None
    assert logits.dtype == torch.float32
    assert logits.shape[-1] == cfg.vocab_size
    assert TM.LOGITS_PRODUCTS["widened_f32"] == before["widened_f32"] + 1
    assert TM.LOGITS_PRODUCTS["bf16_f32"] == before["bf16_f32"]


def test_kernel_and_plain_impls_agree_on_cpu(models, cfgs):
    """attn_impl='kernel' (the kernels' plain versions on the CPU) and
    attn_impl='plain' (the JAX model's own attention) give the same model."""
    _, _, tm, tparams = models
    plain = build_model(cfgs[1], attn_impl="plain")
    toks = torch.from_numpy(
        np.random.default_rng(10).integers(0, 256, (1, 20))).long()
    outs = []
    for m in (tm, plain):
        cache = m.init_cache(1, 24, device="cpu")
        lg, cache, _ = m.prefill(tparams, {"tokens": toks}, cache)
        lg2, _ = m.decode(tparams, toks[:, -1], cache,
                          torch.tensor([20], dtype=torch.int32))
        outs.append((lg, lg2))
    for a, b in zip(*outs):
        assert _prob_err(a, b) < 0.05 and _tie_agree(a, b)


def test_stack_cache_layout(cfgs):
    cache = TT.stack_cache_init(cfgs[1], 3, 16, device="cpu")
    assert len(cache) == len(TT.block_pattern(cfgs[1])) == 1
    assert tuple(cache[0]["k"].shape) == (4, 3, 16, 4, 32)
    assert cache[0]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("change,item", [
    # item 8's hybrid stacks (jamba-1.5-large brought them), with dense or
    # MoE FFNs: no longer refused
    (dict(family=Family.HYBRID, ssm=SSMConfig(), attn_every=2), None),
    (dict(family=Family.HYBRID, ssm=SSMConfig(), attn_every=2,
          moe=MoEConfig(num_experts=4, top_k=2, every=2)), None),
    # a hybrid stack without the ssm its Mamba blocks need: invalid
    (dict(attn_every=2), "ssm"),
    # item 9's encoder-decoder and learned positions (seamless-m4t-medium
    # brought them): no longer refused
    (dict(encoder_layers=2, family=Family.AUDIO, pos_emb=PosEmb.LEARNED),
     None),
    (dict(pos_emb=PosEmb.LEARNED), None),
    # item 6's variants (gemma2-2b, starcoder2-3b, qwen2-vl-2b and
    # nemotron-4-340b brought them) and item 7's MoE FFNs (mixtral-8x7b,
    # grok-1-314b): no longer refused
    (dict(moe=MoEConfig(num_experts=4, top_k=2)), None),
    (dict(family=Family.VLM), None),
    (dict(pos_emb=PosEmb.MROPE), None),
    (dict(kv_cache_dtype="int8"), None),
    (dict(sliding_window=16), None),
    (dict(local_global_alternating=True, sliding_window=16), None),
    (dict(use_post_norm=True), None),
])
def test_build_model_refuses_unported_features(cfgs, change, item):
    """Every feature of the configs is ported now; a hybrid stack without
    an ``ssm`` is refused as invalid, naming it.  The encoder-decoder
    (with its learned positions), learned positions in a decoder-only
    config (no positional signal, as in the JAX package), hybrid stacks,
    MoE FFNs, the VLM family, M-RoPE, int8 KV caches, the sliding window,
    local/global alternation and post-norm (item None) build, and the
    model runs a prefill past the window and one decode step (an
    encoder-decoder on 12 frames beside its target tokens)."""
    cfg = dataclasses.replace(cfgs[1], **change)
    if item is not None:
        with pytest.raises(ValueError, match=item):
            build_model(cfg)
        return
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.arange(20)[None] % cfg.vocab_size
    batch = {"tokens": toks}
    if cfg.is_encdec:
        frames = torch.randn(1, 12, cfg.d_model,
                             generator=torch.Generator().manual_seed(0))
        batch = {"src_embeds": frames.bfloat16(), "tgt_tokens": toks}
    cache = model.init_cache(1, 24, device="cpu")
    _, cache, lens = model.prefill(params, batch, cache)
    lg, _ = model.decode(params, toks[:, -1], cache, lens)
    assert lg.shape == (1, cfg.vocab_size) and bool(torch.isfinite(lg).all())

