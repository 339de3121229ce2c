"""The port's gemma2-2b against the JAX package's.

gemma2-2b brings the attention variants of ROADMAP queue 1 item 6 onto the
port's main path: even layers attend over a sliding window (4096 at full
width, 16 at smoke width) with ring-buffer KV caches of
``min(max_len, window)`` slots, odd layers over the whole sequence; an
attention-logit softcap (50) and a final-logit softcap (30); post-norms
after the mixer and the MLP; GeGLU; embeddings scaled by sqrt(d_model)
and tied to the head.  Each is run here beside its twin in the JAX
package at ``reduced()`` width (4 layers, d_model 128, head_dim 32,
window 16) on parameters carried across by ``repro_torch.bridge``.

Tolerances, with their reasons:

* 2e-5 in fp32 for a single block or attention call: the same fp32
  arithmetic in another summation order.
* Whole model in bf16: the bounds of ``tests/test_models_decode.py`` —
  median softmax error below 0.05 and tie-aware argmax agreement (a pick
  whose reference probability is within 0.02 of the top counts), since the
  two frameworks round bf16 at different places.
* Cache writes: exact (they copy values).
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
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(2)

F32 = dict(rtol=2e-5, atol=2e-5)
TIE_EPS = 0.02
WINDOW = 16                  # reduced() window
B, S = 2, 40                 # decode runs from P to S, past the ring's wrap


def both(x, dtype=np.float32):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


def f32_tree(tree):
    """A (sub)tree of JAX params as fp32 on both sides."""
    return (jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
            bridge.params_from_numpy(
                jax.tree.map(lambda a: np.asarray(a, np.float32), tree)))


@pytest.fixture(scope="module")
def cfgs():
    return (jax_get_config("gemma2-2b").reduced(),
            get_config("gemma2-2b").reduced())


@pytest.fixture(scope="module")
def models(cfgs):
    jcfg, tcfg = cfgs
    jm = jax_build_model(jcfg)
    jparams = unbox(jm.init(jax.random.PRNGKey(0)))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def reference(models):
    """Tokens and the JAX model's teacher-forced logits [B, S, V]."""
    jm, jparams, _, _ = models
    toks = np.random.default_rng(8).integers(0, 256, (B, S)).astype(np.int32)
    x, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(
        jparams, {"tokens": jnp.asarray(toks)})
    return toks, torch.from_numpy(np.array(jm._logits(jparams, x)))


def _prob_err(a, b):
    return float((a.float().softmax(-1) - b.float().softmax(-1)).abs().max())


def _tie_agree(lg, ref):
    """tests/test_models_decode.py::agree_step, in torch."""
    p_ref = ref.float().softmax(-1)
    a_got, a_ref = lg.argmax(-1), ref.argmax(-1)
    p_top = p_ref.gather(-1, a_ref[..., None])[..., 0]
    p_pick = p_ref.gather(-1, a_got[..., None])[..., 0]
    return bool(((a_got == a_ref) | (p_top - p_pick < TIE_EPS)).all())


def test_config_is_the_jax_one(cfgs):
    full_j, full_t = jax_get_config("gemma2-2b"), get_config("gemma2-2b")
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert (full_t.head_dim, full_t.sliding_window) == (256, 4096)
    assert cfgs[1].sliding_window == WINDOW
    assert [d.window for d in TT.block_pattern(cfgs[1])] == [WINDOW, 0]


def test_bridge_carries_post_norms_bit_for_bit(models):
    """The bridge needs no change: gemma2's post-norm scales (and every
    other leaf) arrive with their shapes, dtypes and bits."""
    _, jparams, tm, tparams = models
    for j, (jb, tb) in enumerate(zip(jparams["blocks"], tparams["blocks"])):
        assert set(tb) == set(jb) >= {"post_norm_mixer", "post_norm_ffn"}
        for name in ("post_norm_mixer", "post_norm_ffn", "norm_mixer"):
            want = np.asarray(jb[name]["scale"])
            got = tb[name]["scale"]
            assert tuple(got.shape) == want.shape == (2, 128)
            assert str(got.dtype).replace("torch.", "") == str(want.dtype)
            np.testing.assert_array_equal(got.numpy(), want)
    own = tm.init(0, device="cpu")
    assert [sorted(b) for b in own["blocks"]] == \
        [sorted(b) for b in tparams["blocks"]]


def test_forward_logits_match_jax(models, reference):
    """The teacher-forced forward: scaled embeddings, post-norms, GeGLU,
    both attention kinds with the logit softcap, the final softcap."""
    _, _, tm, tparams = models
    toks, ref = reference
    x, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks).long()})
    got = tm._logits(tparams, x)
    assert got.shape == ref.shape == (B, S, 256)
    assert float(got.abs().max()) < 30.0          # the final softcap
    assert _prob_err(got, ref) < 0.05
    assert _tie_agree(got, ref)


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_binding_logit_softcap_matches_jax(models, reference, attn_impl):
    """Every query projection scaled by 100, so the attention scores (std
    ~100) pass the logit softcap of 50: the forward still matches JAX, and
    the same forward without the cap misses the 0.05 bound five times
    over, so the cap is applied, and applied as JAX applies it.  ``kernel`` takes the kernels' plain
    versions on the CPU."""
    jm, jparams, _, _ = models
    boosted = dict(jparams, blocks=[
        dict(b, attn=dict(b["attn"], wq=b["attn"]["wq"] * 100))
        for b in jparams["blocks"]])
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, boosted))
    toks, _ = reference
    x, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(
        boosted, {"tokens": jnp.asarray(toks)})
    ref = torch.from_numpy(np.array(jm._logits(boosted, x)))
    tcfg = get_config("gemma2-2b").reduced()
    got, uncapped = (
        m._logits(tparams, m.forward(
            tparams, {"tokens": torch.from_numpy(toks).long()})[0])
        for m in (build_model(tcfg, attn_impl=attn_impl),
                  build_model(dataclasses.replace(tcfg,
                                                  attn_logit_softcap=0.0),
                              attn_impl=attn_impl)))
    assert _prob_err(got, ref) < 0.05
    assert _tie_agree(got, ref)
    assert _prob_err(uncapped, ref) > 5 * 0.05


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
@pytest.mark.parametrize("P", [12, 24])
def test_prefill_decode_across_the_ring_matches_jax(models, reference,
                                                    attn_impl, P):
    """Prefill P tokens, then decode to S = 40 against the JAX model's
    teacher-forced logits: the local layers' 16-slot ring wraps during
    decode (P = 12) or already in the prefill (P = 24).  ``kernel`` takes
    the kernels' plain versions on the CPU."""
    jm, jparams, _, tparams = models
    tm = build_model(get_config("gemma2-2b").reduced(), attn_impl=attn_impl)
    toks, ref = reference
    tt = torch.from_numpy(toks).long()
    cache = tm.init_cache(B, S, device="cpu")
    lg, cache, _ = tm.prefill(tparams, {"tokens": tt[:, :P]}, cache)
    steps = [(lg, ref[:, P - 1])]
    for t in range(P, S):
        lg, cache = tm.decode(tparams, tt[:, t], cache,
                              torch.full((B,), t, dtype=torch.int32))
        steps.append((lg, ref[:, t]))
    errs = [_prob_err(got, want) for got, want in steps]
    assert np.median(errs) < 0.05, errs
    assert all(_tie_agree(got, want) for got, want in steps)

    # and the JAX model's own prefill of the same prompt
    jc = jm.init_cache(B, S)
    lgj, jc, _ = jax.jit(jm.prefill)(
        jparams, {"tokens": jnp.asarray(toks[:, :P])}, jc)
    assert _prob_err(steps[0][0], torch.from_numpy(np.array(lgj))) < 0.05


@pytest.mark.parametrize("max_len", [8, 16, 40])
def test_cache_shapes_per_pattern_position(cfgs, max_len):
    """Position 0 (local) is a ring of min(max_len, 16) slots, position 1
    (global) holds max_len, as the JAX stack_cache_init makes them."""
    jcfg, tcfg = cfgs
    got = TT.stack_cache_init(tcfg, 3, max_len, device="cpu")
    want = JT.stack_cache_init(jcfg, 3, max_len)
    assert [tuple(c["k"].shape) for c in got] == \
        [tuple(c["k"].shape) for c in want] == \
        [(2, 3, min(max_len, WINDOW), 4, 32), (2, 3, max_len, 4, 32)]
    assert all(c["v"].shape == c["k"].shape and
               c["k"].dtype == torch.bfloat16 for c in got)


@pytest.mark.parametrize("S_", [16, 21, 37])
def test_ring_alignment_after_long_prefill(cfgs, S_):
    """tests/test_layers.py::test_kv_ring_buffer_prefill for the port: a
    prefill at least as long as the ring keeps exactly its last W
    positions, slot j holding a position p with p % W == j, as the JAX
    write does; a decode write then lands at slot p % W."""
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype="float32")
                  for c in cfgs)
    W = WINDOW
    cache = TL.kv_cache_init(tcfg, 1, 64, W, device="cpu")
    assert cache["k"].shape[1] == W
    k = torch.arange(S_, dtype=torch.float32)[None, :, None, None] * \
        torch.ones(1, S_, 4, 32)
    TL.kv_write_prefill(cache, k, k)
    got = cache["k"][0, :, 0, 0]
    assert sorted(got.tolist()) == list(range(S_ - W, S_))
    assert all(int(got[j]) % W == j for j in range(W))
    jc = JL.kv_write_prefill(JL.kv_cache_init(jcfg, 1, 64, window=W),
                             jnp.asarray(k.numpy()), jnp.asarray(k.numpy()))
    np.testing.assert_array_equal(cache["k"].numpy(), np.asarray(jc["k"]))
    one = torch.full((1, 1, 4, 32), -1.0)
    TL.kv_write_decode(cache, one, one, torch.tensor([S_], dtype=torch.int32))
    assert float(cache["k"][0, S_ % W, 0, 0]) == -1.0


@pytest.mark.parametrize("mode", ["full", "decode"])
@pytest.mark.parametrize("j", [0, 1])
def test_post_norm_block_matches_jax(cfgs, models, j, mode):
    """One block (pattern position j: 0 local, 1 global) with its post-norms
    against JAX transformer._apply_block, on fp32 parameters: a 20-token
    full pass that writes the cache, or one decode step after it."""
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype="float32")
                  for c in cfgs)
    _, jparams, _, _ = models
    pj, pt = f32_tree(jax.tree.map(lambda a: a[0], jparams["blocks"][j]))
    jdesc, tdesc = JT.block_pattern(jcfg)[j], TT.block_pattern(tcfg)[j]
    rng = np.random.default_rng(20 + j)
    n, T = 20, 24
    xj, xt = both(rng.standard_normal((B, n, 128)))
    posj, post = both(np.broadcast_to(np.arange(n), (B, n)), np.int32)
    cj = JL.kv_cache_init(jcfg, B, T, jdesc.window)
    ct = TL.kv_cache_init(tcfg, B, T, tdesc.window, device="cpu")
    yj, cj, _ = JT._apply_block(jcfg, jdesc, pj, xj, mode="full",
                                positions=posj, cache=cj)
    yt, _ = TT._apply_block(tcfg, tdesc, pt, xt, mode="full",
                            positions=post, cache=ct)
    if mode == "decode":
        xj, xt = both(rng.standard_normal((B, 1, 128)))
        lj, lt = both([n, n], np.int32)
        yj, cj, _ = JT._apply_block(jcfg, jdesc, pj, xj, mode="decode",
                                    lengths=lj, cache=cj)
        yt, _ = TT._apply_block(tcfg, tdesc, pt, xt, mode="decode",
                                lengths=lt, cache=ct)
    close(yt, yj, **F32)
    close(ct["k"], cj["k"], **F32)


def test_non_ring_windowed_decode(cfgs, models):
    """A windowed layer over a cache longer than its window (T = 24 > 16;
    the port's own caches are rings and never get here): the plain path
    masks the window as JAX decode_attention does, and the kernel path
    refuses it, since the paged kernel has no window."""
    jcfg, tcfg = (dataclasses.replace(c, kv_cache_dtype="float32")
                  for c in cfgs)
    _, jparams, _, _ = models
    pj, pt = f32_tree(jax.tree.map(lambda a: a[0],
                                   jparams["blocks"][0]["attn"]))
    rng = np.random.default_rng(30)
    n, T = 20, 24
    xj, xt = both(rng.standard_normal((B, n, 128)))
    posj, post = both(np.broadcast_to(np.arange(n), (B, n)), np.int32)
    cj = JL.kv_cache_init(jcfg, B, T)               # no window: T slots
    ct = TL.kv_cache_init(tcfg, B, T, device="cpu")
    _, cj = JL.attention_forward(jcfg, pj, xj, posj, window=WINDOW, cache=cj)
    TL.attention_forward(tcfg, pt, xt, post, window=WINDOW, cache=ct,
                         attn_impl="plain")
    x1j, x1t = both(rng.standard_normal((B, 1, 128)))
    lj, lt = both([n, 7], np.int32)
    kept = {k: v.clone() for k, v in ct.items()}
    with pytest.raises(ValueError, match="no window"):
        TL.attention_decode(tcfg, pt, x1t, lt, window=WINDOW, cache=ct,
                            attn_impl="kernel")
    assert all(torch.equal(ct[k], kept[k]) for k in kept)   # untouched
    oj, _ = JL.attention_decode(jcfg, pj, x1j, lj, window=WINDOW, cache=cj)
    ot, _ = TL.attention_decode(tcfg, pt, x1t, lt, window=WINDOW, cache=ct,
                                attn_impl="plain")
    close(ot, oj, **F32)
