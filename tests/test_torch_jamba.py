"""jamba-1.5-large's hybrid stack against the JAX package's.

jamba-1.5-large repeats a pattern of seven Mamba-2 blocks and one
attention block (``attn_every=8``), with MoE FFNs on every other block
(``MoEConfig(every=2)``), no positional embedding and an int8 KV cache.
Its stacked cache mixes two kinds: a Mamba position keeps fp32 ``conv``
and ``ssm`` state, the attention position int8 ``k``/``v`` with fp32
scales.  Each piece is run here beside its twin in ``repro.models`` at
``reduced()`` width (16 layers, d_model 128, 4 experts, SSM N = 16,
P = 16, chunk 32) on parameters carried across by ``repro_torch.bridge``,
and served by the port's engine in all four modes.

Tolerances, with their reasons:

* The caches, block by block: each block gets the JAX block's input and
  the same fp32 parameters, so both sides do the same fp32 arithmetic in
  another order.  The conv and SSM state and the int8 scales are held to
  2e-5; the int8 values bit for bit (both sides quantize K/V that agree
  to fp32 rounding, and round half to even).
* Whole model in bf16: the MoE bounds of ``tests/test_models_decode.py``,
  median softmax error below 0.05 and tie-aware argmax agreement at 0.7
  of the positions, since the two frameworks round bf16 at other places
  and a near-tied top-k pick may flip an expert.
* Engine: token for token against the port's own sequential greedy run
  (the same eager model); that run against JAX teacher-forced under the
  MoE bound, at 0.7 of the picks or more within 0.02 of the JAX top
  probability.
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
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch.serve import run_real
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import (RealEngine, _insert_slot,
                                        _pack_cache, _unpack_cache)
from repro_torch.serving.request import Request

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
F32 = dict(rtol=2e-5, atol=2e-5)
TIE_EPS = 0.02
MIN_AGREE = 0.7              # tests/test_models_decode.py, MoE
B, S, P = 2, 40, 24          # prefill P tokens, decode to S
# the card's cut: one 8-layer pattern repeat at full width (jax.eval_shape
# of the JAX init), with all 16 experts and with the first 8
REPEAT_PARAMS = {16: 45_144_659_968, 8: 25_817_044_992}
MAX_LEN = 64
PROMPT = 40                  # two SSD chunks of 32, the second ragged


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _prob_err(a, b):
    return float((a.float().softmax(-1) - b.float().softmax(-1)).abs().max())


def _tie_agree(lg, ref):
    """tests/test_models_decode.py::agree_step, in torch."""
    p_ref = ref.float().softmax(-1)
    a_got, a_ref = lg.argmax(-1), ref.argmax(-1)
    p_top = p_ref.gather(-1, a_ref[..., None])[..., 0]
    p_pick = p_ref.gather(-1, a_got[..., None])[..., 0]
    return bool(((a_got == a_ref) | (p_top - p_pick < TIE_EPS)).all())


def _gate(got, want):
    """The MoE bounds of tests/test_models_decode.py, position by position
    over [B, n, V] logits."""
    n = got.shape[1]
    errs = [_prob_err(got[:, i], want[:, i]) for i in range(n)]
    agree = [_tie_agree(got[:, i], want[:, i]) for i in range(n)]
    assert np.median(errs) < 0.05, errs
    assert np.mean(agree) >= MIN_AGREE, agree
    assert bool(torch.isfinite(got).all())


@pytest.fixture(scope="module")
def setup():
    """(JAX model, JAX params, port config, port model, port params) at
    smoke width."""
    jm = jax_build_model(jax_get_config(ARCH).reduced())
    jparams = unbox(jm.init(jax.random.PRNGKey(0)))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    cfg = get_config(ARCH).reduced()
    return jm, jparams, cfg, build_model(cfg), tparams


@pytest.fixture(scope="module")
def reference(setup):
    """Tokens and the JAX model's dropless teacher-forced logits and
    loss."""
    jm, jparams, _, _, _ = setup
    toks = np.random.default_rng(8).integers(0, 256, (B, S)).astype(np.int32)
    x, aux = jax.jit(lambda p, b: jm.forward(p, b, remat=False,
                                             dropless=True))(
        jparams, {"tokens": jnp.asarray(toks)})
    return toks, torch.from_numpy(np.array(jm._logits(jparams, x))), \
        float(aux)


# ----------------------------------------------------------------- configs
def test_config_is_the_jax_one():
    full_j, full_t = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(full_t.reduced()) == \
        dataclasses.asdict(full_j.reduced())


@pytest.mark.parametrize("reduced", [False, True])
def test_block_pattern_is_the_jax_one(reduced):
    """Seven Mamba-2 blocks, then one attention block; MoE FFNs at the odd
    positions; the same blocks and repeats on both sides."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    got = [(d.mixer, d.ffn, d.window) for d in TT.block_pattern(tcfg)]
    assert got == [(d.mixer, d.ffn, d.window)
                   for d in JT.block_pattern(jcfg)]
    assert got == [("mamba", "dense", 0), ("mamba", "moe", 0)] * 3 + \
        [("mamba", "dense", 0), ("attn", "moe", 0)]
    assert TT.num_repeats(tcfg) == JT.num_repeats(jcfg) == \
        (2 if reduced else 9)


@pytest.mark.parametrize("experts", [16, 8])
def test_one_repeat_init_draws_the_jax_tree(experts):
    """One pattern repeat at full width (8 layers), all 16 experts or the
    first 8, traced with fake tensors (nothing allocated): the port's init
    draws the JAX init's shapes and dtypes, 45,144,659,968 and
    25,817,044,992 parameters."""
    cfgs = [dataclasses.replace(c, num_layers=8) for c in
            (jax_get_config(ARCH), get_config(ARCH))]
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, num_experts=experts)) for c in cfgs)
    jshapes = jax.tree.leaves(unbox(jax.eval_shape(
        jax_build_model(jcfg).init, jax.random.PRNGKey(0))))
    with FakeTensorMode():
        own = build_model(tcfg).init(0, device="cpu")
    assert sorted(own["blocks"][1]) == ["mamba", "moe", "norm_ffn",
                                        "norm_mixer"]
    assert sorted(own["blocks"][7]) == ["attn", "moe", "norm_ffn",
                                        "norm_mixer"]
    # the JAX tree flattens each dict's keys sorted
    own = list(_leaves(own))
    assert [tuple(a.shape) for a in jshapes] == [tuple(t.shape) for t in own]
    assert [str(a.dtype) for a in jshapes] == \
        [str(t.dtype).replace("torch.", "") for t in own]
    assert sum(t.numel() for t in own) == REPEAT_PARAMS[experts]


def test_stack_cache_init_matches_jax():
    """The mixed stacked cache: the same keys, shapes and dtypes at every
    pattern position, fp32 conv/ssm state for a Mamba position and int8
    K/V with fp32 scales for the attention one."""
    jcfg, tcfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = JT.stack_cache_init(jcfg, 3, 20)
    got = TT.stack_cache_init(tcfg, 3, 20, device="cpu")
    assert len(got) == len(want) == 8
    for g, w, d in zip(got, want, TT.block_pattern(tcfg)):
        assert sorted(g) == sorted(w) == (
            ["k", "k_scale", "v", "v_scale"] if d.is_attn
            else ["conv", "ssm"])
        for k in g:
            assert tuple(g[k].shape) == tuple(w[k].shape)
            assert str(g[k].dtype).replace("torch.", "") == str(w[k].dtype)


# ----------------------------------------------------------------- caches
def _block_caches(jcfg, tcfg, desc):
    if desc.mixer == "mamba":
        return (JM.mamba_cache_init(jcfg, B),
                TM.mamba_cache_init(tcfg, B, device="cpu"))
    return (JL.kv_cache_init(jcfg, B, S),
            TL.kv_cache_init(tcfg, B, S, device="cpu"))


# the JAX block, compiled once for each (block, mode)
_jax_block = jax.jit(JT._apply_block, static_argnums=(0, 1),
                     static_argnames=("mode", "dropless"))


def _same_cache(got, want):
    for k in got:
        if got[k].dtype == torch.int8:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            close(got[k], want[k], **F32)


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_caches_match_jax_block_by_block(setup, attn_impl):
    """The stack's blocks in order, over both repeats, each fed the JAX
    block's input (fp32 parameters, a P-token prefill dropless, then one
    decode step): every block's written cache equals JAX's (int8 K/V bit
    for bit; conv and SSM state and the scales within 2e-5), its output
    within 2e-5 of the output's scale, and the cache is written in
    place."""
    _, jparams, tcfg, _, _ = setup
    jcfg = jax_get_config(ARCH).reduced()
    blocks = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jparams["blocks"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, P, tcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(P), (B, P)).astype(np.int32)
    lens = np.full((B,), P, np.int32)
    kinds = set()
    for r in range(TT.num_repeats(tcfg)):
        for j, desc in enumerate(TT.block_pattern(tcfg)):
            sub = jax.tree.map(lambda a: a[r], blocks[j])
            pj, pt = jax.tree.map(jnp.asarray, sub), \
                bridge.params_from_numpy(sub)
            jd = JT.BlockDesc(desc.mixer, desc.ffn, desc.window)
            cj, ct = _block_caches(jcfg, tcfg, desc)
            buffers = {k: t.data_ptr() for k, t in ct.items()}
            steps = [dict(mode="full", x=x, kw=dict(positions=pos)),
                     dict(mode="decode", x=x1, kw=dict(lengths=lens))]
            for step in steps:
                jkw = {k: jnp.asarray(v) for k, v in step["kw"].items()}
                tkw = {k: torch.from_numpy(v.copy()).long()
                       if k == "positions" else torch.from_numpy(v.copy())
                       for k, v in step["kw"].items()}
                yj, cj, _ = _jax_block(
                    jcfg, jd, pj, jnp.asarray(step["x"]), mode=step["mode"],
                    cache=cj, dropless=True, **jkw)
                yt, _ = TT._apply_block(
                    tcfg, desc, pt, torch.from_numpy(step["x"].copy()),
                    mode=step["mode"], cache=ct, attn_impl=attn_impl,
                    dropless=True, **tkw)
                yj = np.asarray(yj)
                scale = float(np.abs(yj).max())
                close(yt / scale, yj / scale, **F32)
                _same_cache(ct, cj)
                step["x"][...] = yj          # the JAX output feeds on
            assert {k: t.data_ptr() for k, t in ct.items()} == buffers
            kinds.add(tuple(sorted(ct)))
    assert kinds == {("conv", "ssm"), ("k", "k_scale", "v", "v_scale")}


# ------------------------------------------------------------ whole model
def test_forward_matches_jax(setup, reference):
    """Teacher-forced logits (dropless) and the summed load-balancing loss
    of the eight MoE blocks."""
    _, _, _, tm, tparams = setup
    toks, ref, aux_ref = reference
    x, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                        dropless=True)
    got = tm._logits(tparams, x)
    assert got.shape == ref.shape == (B, S, 256)
    _gate(got, ref)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), aux_ref, rtol=2e-2)


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_prefill_decode_matches_jax(setup, reference, attn_impl):
    """Prefill P = 24 positions (a ragged SSD chunk), then decode to S = 40
    one token at a time, over the mixed cache, against the JAX model's
    teacher-forced logits; and the prefill against the JAX model's own
    prefill."""
    jm, jparams, tcfg, _, tparams = setup
    toks, ref, _ = reference
    tm = build_model(tcfg, attn_impl=attn_impl)
    tt = torch.from_numpy(toks).long()
    cache = tm.init_cache(B, S, device="cpu")
    lg, cache, lens = tm.prefill(tparams, {"tokens": tt[:, :P]}, cache)
    assert lens.tolist() == [P] * B
    steps = [lg]
    for t in range(P, S):
        lg, cache = tm.decode(tparams, tt[:, t], cache,
                              torch.full((B,), t, dtype=torch.int32))
        steps.append(lg)
    got = torch.stack(steps, 1)
    _gate(got, ref[:, P - 1:])
    attn = [c for c in cache if "k" in c]
    assert len(attn) == 1 and attn[0]["k"].dtype == torch.int8
    assert bool((attn[0]["k_scale"][:, :, :S] > 0).all())
    lgj, _, _ = jax.jit(jm.prefill)(jparams,
                                    {"tokens": jnp.asarray(toks[:, :P])},
                                    jm.init_cache(B, S))
    lgj = torch.from_numpy(np.array(lgj))
    assert _prob_err(got[:, 0], lgj) < 0.05


# ------------------------------------------------------------------ engine
def mk_requests(cfg, n=6, out=8, gap=0.01):
    """tests/test_engine.py::mk_requests at PROMPT tokens."""
    return [Request(prompt_len=PROMPT, max_new_tokens=out,
                    prompt_tokens=np.random.default_rng(s).integers(
                        0, cfg.vocab_size, PROMPT).tolist(),
                    arrival_time=s * gap)
            for s in range(n)]


def reference_outputs(model, params, reqs):
    """Sequential greedy decoding of each request alone (batch 1)."""
    outs = []
    for r in reqs:
        cache = model.init_cache(1, MAX_LEN, device="cpu")
        toks = torch.tensor(r.prompt_tokens, dtype=torch.long)[None]
        lg, cache, _ = model.prefill(params, {"tokens": toks}, cache)
        seq = [int(lg[0].argmax())]
        n = r.prompt_len
        for _ in range(r.max_new_tokens - 1):
            lg, cache = model.decode(params, torch.tensor([seq[-1]]), cache,
                                     torch.tensor([n], dtype=torch.int32))
            seq.append(int(lg[0].argmax()))
            n += 1
        outs.append(seq)
    return outs


@pytest.fixture(scope="module")
def greedy(setup):
    _, _, cfg, tm, tparams = setup
    return reference_outputs(tm, tparams, mk_requests(cfg))


@pytest.mark.parametrize("mode,kw", [
    ("passthrough", {}),
    ("static_colocate", {}),
    ("dynamic_pd", {}),
    ("disagg", {}),
    ("disagg", {"kv_chunk_layers": 3}),     # the blob cut between leaves
])
def test_engine_matches_reference(setup, greedy, mode, kw):
    """The reduced jamba served in every mode: slot inserts, decode steps
    and the disagg transfer (in one blob, and in three chunks cut on leaf
    boundaries) carry each sequence's mixed cache (conv and SSM state
    beside the int8 K/V and scales), with the same tokens as the
    sequential greedy run, and every buffer freed after."""
    _, _, cfg, tm, tparams = setup
    reqs = mk_requests(cfg)
    eng = RealEngine(tm, tparams, mode=mode, max_num_seqs=2,
                     max_len=MAX_LEN, device="cpu", **kw)
    try:
        res = eng.run(reqs, timeout=120)
    finally:
        eng.shutdown()
    assert res["completed"] == len(reqs) and res["failed"] == 0
    assert [r.output_tokens for r in reqs] == greedy
    assert [sorted(c) for c in eng.replicas[0].slot_cache] == \
        [["conv", "ssm"]] * 7 + [["k", "k_scale", "v", "v_scale"]]
    if mode != "passthrough":
        for dev in eng.session.stats().values():
            assert dev["buffers"] == 0 and dev["allocated_bytes"] == 0


def test_reference_agrees_with_jax(setup, greedy):
    """The port's greedy tokens, teacher-forced through the JAX Model,
    under the MoE bound of tests/test_models_decode.py: at 0.7 of the
    picks or more, the pick is the JAX argmax or within 0.02 of its
    probability (the reduced model's distributions over 256 tokens are
    flat, top probabilities near 0.05, so one flipped expert moves a pick
    past 0.02)."""
    jm, jparams, cfg, _, _ = setup
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode)
    agree = []
    for r, seq in zip(mk_requests(cfg), greedy):
        lg, cache, _ = prefill(
            jparams, {"tokens": jnp.asarray([r.prompt_tokens], jnp.int32)},
            jm.init_cache(1, MAX_LEN))
        for i, tok in enumerate(seq):
            p = np.asarray(jax.nn.softmax(lg[0].astype(jnp.float32)))
            agree.append(bool(p.max() - p[tok] < TIE_EPS))
            lg, cache = decode(jparams, jnp.asarray([tok], jnp.int32), cache,
                               jnp.asarray([r.prompt_len + i], jnp.int32))
    assert np.mean(agree) >= MIN_AGREE, agree


def test_mixed_cache_packs_and_inserts_bit_for_bit(setup):
    """The disagg transfer's uint8 packing of a mixed cache, leaves of
    two dtypes (fp32 conv and SSM state and scales, int8 K/V): every leaf
    keeps its dtype and bits through pack, unpack and the insert into one
    slot, and the other slots stay untouched."""
    _, _, cfg, tm, _ = setup
    one = tm.init_cache(1, 8, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for layer in one:
        for k, t in layer.items():
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen)
                    if t.dtype == torch.int8 else
                    torch.randn(t.shape, generator=gen))
    blob, keys, spec = _pack_cache(one)
    assert keys == [["conv", "ssm"]] * 7 + [["k", "k_scale", "v", "v_scale"]]
    assert {dt for _, dt in spec} == {torch.float32, torch.int8}
    back = _unpack_cache(blob, keys, spec, torch.device("cpu"))
    full = tm.init_cache(3, 8, device="cpu")
    _insert_slot(full, back, 1)
    for a, b in zip(one, full):
        for k in a:
            assert b[k].dtype == a[k].dtype
            assert torch.equal(b[k][:, 1], a[k][:, 0])
            assert not b[k][:, 0].any() and not b[k][:, 2].any()


def test_serve_cuts_layers_and_experts():
    """launch/serve.py's --layers and --experts: the reduced jamba's first
    pattern repeat with 2 of its 4 experts serves every request; fewer
    experts than top-k, or an FFN without experts, are refused."""
    res = run_real(ARCH, "passthrough", 2, 100.0, prompt_len=8, max_new=2,
                   verbose=False, device="cpu", reduced=True, layers=8,
                   experts=2)
    assert res["completed"] == 2 and res["failed"] == 0
    with pytest.raises(ValueError, match="experts"):
        run_real(ARCH, "passthrough", 1, 100.0, verbose=False, device="cpu",
                 reduced=True, experts=1)
    with pytest.raises(ValueError, match="experts"):
        run_real("olmo-1b", "passthrough", 1, 100.0, verbose=False,
                 device="cpu", reduced=True, experts=2)
