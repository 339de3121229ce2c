"""The port's Mixture-of-Experts against the JAX package's.

``repro_torch.models.moe`` is run beside its twin ``repro.models.moe`` on
the same numpy-drawn inputs and on parameters carried across by
``repro_torch.bridge``: the expert FFN in all four activations, the
routing (top-k, capacity positions counted along each batch row, the
overflow dropped), ``apply_moe`` in both dispatches (``plain``: the
reference's one-hot GShard products; ``kernel``: the sorted per-expert
products of a prefill and the batched one-token products of a decode), in
dropless and capacity routing, with chunks that pad.  Then mixtral-8x7b
(SwiGLU experts, a sliding window) and grok-1-314b (GeGLU experts, a
softcap of 30, int8 KV caches) at ``reduced()`` width (4 layers, d_model
128, 4 experts top-2) against the JAX ``Model``.  Last, the gradient of
``apply_moe`` under capacity routing, as training routes, on both
dispatches against ``jax.grad`` of the reference (the models' whole
gradient trees are in ``tests/test_torch_training.py``).

Tolerances, with their reasons:

* Routing indices, capacity positions and the keep mask: exact.  Both
  sides do the same fp32 arithmetic on the same inputs, and ties go to
  the lower expert index on both.
* 2e-5 in fp32 for the expert FFN, ``apply_moe`` and its loss: the same
  fp32 arithmetic in another summation order.
* 2e-2 in bf16 (the kernel tolerance of ``tests/test_kernels.py``): both
  sides round the products to bf16, at other places in the two frameworks
  (JAX's SiLU and GELU round twice in bf16).  The loss stays at 2e-5: the
  router runs in fp32 on both sides.
* The expert outputs are large: ``w_up`` and ``w_gate`` are drawn with
  std 1/sqrt(E) (the reference's fan rule), so on unit-RMS rows, as the
  norm before the layer gives, y reaches 70 and more, where one bf16 step
  is 0.5, far above 2e-2; and a token's two gated slot outputs may cancel
  in their sum, so an element near zero carries the rounding of summands
  near the largest.  So y is compared in units of the JAX output's largest
  magnitude (both sides divided by it): each bound above reads as a
  fraction of the output's scale, and a wrong expert, gate or drop moves
  an element by a large part of it.
* Whole model in bf16: the MoE bounds of ``tests/test_models_decode.py``
  (:71-74) — median softmax error below 0.05 and tie-aware argmax
  agreement (a pick whose reference probability is within 0.02 of the top
  counts) on at least 0.7 of the positions, since a bf16 difference can
  flip a borderline top-k pick and so the expert a token goes to; the
  load-balancing loss within 2e-2.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import unbox
from repro.models import build_model as jax_build_model
from repro.models import moe as JM
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import Activation
from repro_torch.models import build_model
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

torch.set_num_threads(2)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
TIE_EPS = 0.02
MIN_AGREE = 0.7              # tests/test_models_decode.py, MoE
ARCHS = ("mixtral-8x7b", "grok-1-314b")
# full-width parameter counts (jax.eval_shape of the JAX init); mixtral's
# 8-layer cut is what the card serves
FULL_PARAMS = {"mixtral-8x7b": 46_702_792_704,
               "grok-1-314b": 316_489_340_928}
CUT_PARAMS = 11_872_309_248
B, S, P = 2, 40, 24          # prefill P tokens, decode to S


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


def close_scaled(got, want, dtype):
    """``close`` in units of the reference output's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    close(got / scale, want / scale, **(F32 if dtype == "float32" else BF16))


def exact(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def cfgs(arch="mixtral-8x7b", **change):
    """(JAX config, port config) at smoke width, with ``change`` applied
    (``moe`` fields through ``capacity_factor``)."""
    out = []
    for c in (jax_get_config(arch).reduced(), get_config(arch).reduced()):
        if "capacity_factor" in change:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=change["capacity_factor"]))
        out.append(dataclasses.replace(
            c, **{k: v for k, v in change.items()
                  if k != "capacity_factor"}))
    return out


def moe_trees(jcfg, dtype, skew=0.0):
    """One MoE layer's parameters from the JAX init, on both sides:
    ``float32`` casts every leaf to fp32, ``bfloat16`` keeps the init's
    types (fp32 router, bf16 experts).  ``skew`` is added to the router's
    column of expert 0."""
    tree = unbox(JM.moe_params(jcfg, jax.random.PRNGKey(3)))
    tree = jax.tree.map(np.asarray, tree)
    if dtype == "float32":
        tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    tree["router"] = tree["router"].copy()
    tree["router"][:, 0] += skew
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree)


def inputs(shape, dtype, seed=0, shift=0.0, zero_tail=0):
    """x on both sides (bf16 rounded once, by JAX); ``zero_tail`` zeroes
    the last positions (their router logits tie: all experts equal)."""
    x = np.random.default_rng(seed).standard_normal(shape) + shift
    if zero_tail:
        x[:, -zero_tail:] = 0.0
    xj = jnp.asarray(x, jnp.float32)
    if dtype == "bfloat16":
        xj = xj.astype(jnp.bfloat16)
    return xj, bridge.tensor_from_numpy(np.asarray(xj))


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_jax_one(arch):
    full_j, full_t = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(full_t.reduced()) == \
        dataclasses.asdict(full_j.reduced())


@pytest.mark.parametrize("arch,layers", [("mixtral-8x7b", 0),
                                         ("mixtral-8x7b", 8),
                                         ("grok-1-314b", 0)])
def test_full_width_init_draws_the_jax_tree(arch, layers):
    """The port's init at full published width (traced with fake tensors,
    nothing allocated) draws the JAX init's shapes and dtypes, the MoE
    subtree included: mixtral-8x7b has 46,702,792,704 parameters, its
    8-layer cut 11,872,309,248."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if layers:
        jcfg, tcfg = (dataclasses.replace(c, num_layers=layers)
                      for c in (jcfg, tcfg))
    jshapes = jax.tree.leaves(unbox(jax.eval_shape(
        jax_build_model(jcfg).init, jax.random.PRNGKey(0))))
    with FakeTensorMode():
        own = build_model(tcfg).init(0, device="cpu")
    assert sorted(own["blocks"][0]) == ["attn", "moe", "norm_ffn",
                                        "norm_mixer"]
    own = list(_leaves(own))
    assert [tuple(a.shape) for a in jshapes] == [tuple(t.shape) for t in own]
    assert [str(a.dtype) for a in jshapes] == \
        [str(t.dtype).replace("torch.", "") for t in own]
    n = sum(t.numel() for t in own)
    assert n == (CUT_PARAMS if layers else FULL_PARAMS[arch])


def test_init_scales_follow_the_first_axis():
    """As in the JAX twin, ``dense_param`` takes its fan from the shape's
    first axis: w_up and w_gate [E, d, f] are drawn with std 1/sqrt(E),
    w_down [E, f, d] with 1/sqrt(f), the fp32 router [d, E] with
    1/sqrt(d).  Both inits agree on each std within 5 %."""
    jcfg, tcfg = cfgs()
    jtree = unbox(JM.moe_params(jcfg, jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    own = TM.moe_params(tcfg, gen, device="cpu")
    E, d, f = tcfg.moe.num_experts, tcfg.d_model, tcfg.d_ff
    want = {"router": d ** -0.5, "w_up": E ** -0.5, "w_gate": E ** -0.5,
            "w_down": f ** -0.5}
    assert sorted(own) == sorted(want) == sorted(jtree)
    assert own["router"].dtype == torch.float32
    for name, std in want.items():
        got = float(own[name].float().std())
        ref = float(np.asarray(jtree[name], np.float32).std())
        assert abs(got / std - 1) < 0.05 and abs(ref / std - 1) < 0.05
        assert tuple(own[name].shape) == tuple(jtree[name].shape)
        assert str(own[name].dtype).replace("torch.", "") == \
            str(jtree[name].dtype)


def test_stack_holds_moe_blocks():
    cfg = get_config("mixtral-8x7b")
    assert TT.block_pattern(cfg) == [TT.BlockDesc("attn_local", "moe", 4096)]
    params = build_model(cfg.reduced()).init(0, device="cpu")
    moe = params["blocks"][0]["moe"]
    assert "mlp" not in params["blocks"][0]
    assert tuple(moe["w_up"].shape) == (4, 4, 128, 256)      # [R, E, d, f]
    assert tuple(moe["router"].shape) == (4, 128, 4)


# -------------------------------------------------------------- expert FFN
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", list(Activation))
def test_expert_ffn_matches_jax(act, dtype):
    jcfg, tcfg = cfgs(activation=act)
    pj, pt = moe_trees(jcfg, dtype)
    assert ("w_gate" in pt) == (act in (Activation.SWIGLU,
                                        Activation.GEGLU))
    xj, xt = inputs((2, 4, 5, 128), dtype, seed=1)
    got = TM._expert_ffn(tcfg, pt, xt)
    assert got.dtype == xt.dtype and got.shape == (2, 4, 5, 128)
    close_scaled(got, JM._expert_ffn(jcfg, pj, xj), dtype)


# ----------------------------------------------------------------- routing
def jax_routing(cfg, router, xc, C):
    """The reference's routing, step for step (src/repro/models/moe.py
    :72-84): (slot experts, gates, capacity positions, keep)."""
    moe = cfg.moe
    Bx, s, _ = xc.shape
    E, k = moe.num_experts, moe.top_k
    logits = jnp.einsum("bsd,de->bse", xc.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    idx_f = gate_idx.reshape(Bx, s * k)
    gate_f = gate_vals.reshape(Bx, s * k)
    mask = jax.nn.one_hot(idx_f, E, dtype=jnp.float32)
    pos = jnp.cumsum(mask, axis=1) * mask
    cap_idx = (jnp.sum(pos, axis=-1) - 1.0).astype(jnp.int32)
    return idx_f, gate_f, cap_idx, cap_idx < C


# name -> (config change, router skew, x shift, zero tail, dropless)
ROUTES = {
    "dropless": ({}, 0.0, 0.0, 0, True),
    "capacity": ({}, 0.0, 0.0, 0, False),
    "drops": (dict(capacity_factor=0.5), 0.0, 0.0, 0, False),
    "skewed": ({}, 0.05, 1.0, 0, False),
    "ties": ({}, 0.0, 0.0, 7, True),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_matches_jax_exactly(case):
    """Top-k experts, capacity positions and the keep mask equal the
    reference's exactly; gates within 2e-5.  ``drops`` (capacity factor
    0.5) and ``skewed`` (a router that favours expert 0) overflow and drop
    slots; ``ties`` ends each row in zero rows, whose router softmax is
    uniform, so its top-k ties break to experts 0 and 1 as lax.top_k's."""
    change, skew, shift, tail, dropless = ROUTES[case]
    jcfg, tcfg = cfgs(**change)
    pj, pt = moe_trees(jcfg, "float32", skew)
    xj, xt = inputs((2, 24, 128), "float32", seed=2, shift=shift,
                    zero_tail=tail)
    C = TM.capacity(tcfg, 24, dropless)
    assert C == (48 if dropless else math.ceil(
        48 * tcfg.moe.capacity_factor / 4))
    r = TM.route(tcfg, pt, xt, C)
    idx, gate, pos, keep = jax_routing(jcfg, pj["router"], xj, C)
    exact(r.idx, idx)
    exact(r.pos, pos)
    exact(r.keep, keep)
    close(r.gate, gate, **F32)
    assert bool(r.keep.all()) == (case in ("dropless", "capacity", "ties"))
    if case == "ties":
        assert r.idx[:, -14:].tolist() == [[0, 1] * 7] * 2
    if case == "skewed":
        assert float((r.idx[:, 0::2] == 0).float().mean()) > 0.9


# --------------------------------------------------------------- apply_moe
# name -> (config change, skew, shift, (B, S), chunk_size, dropless)
MOES = {
    "dropless": ({}, 0.0, 0.0, (2, 40), 0, True),
    "capacity": ({}, 0.0, 0.0, (2, 40), 0, False),
    "drops": (dict(capacity_factor=0.5), 0.0, 0.0, (2, 40), 0, False),
    "skewed": ({}, 0.05, 1.0, (2, 40), 0, False),
    # S = 40 in chunks of 16: the last one half padding, each routed per
    # batch row
    "ragged": ({}, 0.0, 0.0, (2, 40), 16, False),
    "ragged-dropless": ({}, 0.0, 0.0, (2, 40), 16, True),
    # one token at a time, as decode routes
    "decode": ({}, 0.0, 0.0, (4, 1), 1, True),
    "one-token-chunks": ({}, 0.0, 0.0, (2, 5), 1, False),
}
_JAX_MOE = {}


def jax_moe(case, dtype):
    """The JAX twin's (y, aux) for a case, and the case's inputs."""
    change, skew, shift, shape, chunk, dropless = MOES[case]
    jcfg, tcfg = cfgs(**change)
    pj, pt = moe_trees(jcfg, dtype, skew)
    xj, xt = inputs((*shape, 128), dtype, seed=4, shift=shift)
    if (case, dtype) not in _JAX_MOE:
        _JAX_MOE[case, dtype] = JM.apply_moe(jcfg, pj, xj, chunk_size=chunk,
                                             dropless=dropless)
    return tcfg, pt, xt, chunk, dropless, _JAX_MOE[case, dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("case", list(MOES))
def test_apply_moe_matches_jax(case, impl, dtype):
    """y and the load-balancing loss against the JAX twin, on both
    dispatches.  ``drops`` and ``skewed`` must drop slots (checked on the
    first chunk's routing); ``ragged`` pads its last chunk, whose zero
    rows count in the loss as the reference's do."""
    tcfg, pt, xt, chunk, dropless, (yj, auxj) = jax_moe(case, dtype)
    y, aux = TM.apply_moe(tcfg, pt, xt, chunk_size=chunk, dropless=dropless,
                          attn_impl=impl)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    assert aux.dtype == torch.float32 and aux.shape == ()
    close_scaled(y, yj, dtype)
    close(aux, auxj, **F32)
    if case in ("drops", "skewed"):
        cs = xt.shape[1] if chunk == 0 else chunk
        r = TM.route(tcfg, pt, xt[:, :cs], TM.capacity(tcfg, cs, dropless))
        assert not bool(r.keep.all())


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("dropless", [False, True])
def test_one_chunk_matches_jax_route_chunk(dropless, impl):
    """A sequence of one chunk against JAX's ``_route_chunk`` (y, aux),
    with a capacity factor of 0.5 that drops slots unless dropless."""
    jcfg, tcfg = cfgs(capacity_factor=0.5)
    pj, pt = moe_trees(jcfg, "float32")
    xj, xt = inputs((2, 24, 128), "float32", seed=5)
    yj, auxj = JM._route_chunk(jcfg, pj, xj, dropless)
    y, aux = TM.apply_moe(tcfg, pt, xt, chunk_size=24, dropless=dropless,
                          attn_impl=impl)
    close_scaled(y, yj, "float32")
    close(aux, auxj, **F32)


def test_kernel_dispatch_makes_no_onehot_product(monkeypatch):
    """The kernel path never calls the one-hot GShard products; a prefill
    of three chunks reads the expert counts back once, a decode step never
    (it also runs on the meta device, which has no values to read)."""
    jcfg, tcfg = cfgs()
    _, pt = moe_trees(jcfg, "bfloat16")

    def refuse(*a, **k):
        raise AssertionError("one-hot dispatch on the kernel path")
    reads = []
    host_counts = TM._host_counts
    monkeypatch.setattr(TM, "_onehot_moe", refuse)
    monkeypatch.setattr(TM, "_host_counts",
                        lambda c: reads.append(1) or host_counts(c))
    _, x = inputs((2, 40, 128), "bfloat16", seed=6)
    TM.apply_moe(tcfg, pt, x, chunk_size=16, dropless=True)
    assert len(reads) == 1
    TM.apply_moe(tcfg, pt, x[:, :1], chunk_size=1, dropless=True)
    assert len(reads) == 1
    meta = {k: v.to("meta") for k, v in pt.items()}
    y, aux = TM.apply_moe(tcfg, meta, x[:, :1].to("meta"), chunk_size=1,
                          dropless=True)
    assert y.shape == (2, 1, 128) and y.device.type == "meta"
    with pytest.raises(AssertionError, match="one-hot"):
        TM.apply_moe(tcfg, pt, x, dropless=True, attn_impl="plain")


# -------------------------------------------------------------- the bridge
_SETUPS = {}


def setup(arch):
    """(JAX model, JAX params, port config, port params) at smoke width."""
    if arch not in _SETUPS:
        jm = jax_build_model(jax_get_config(arch).reduced())
        jparams = unbox(jm.init(jax.random.PRNGKey(0)))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
        _SETUPS[arch] = (jm, jparams, get_config(arch).reduced(), tparams)
    return _SETUPS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_moe_subtree(arch):
    """The stacked MoE subtree crosses bit for bit: the router in fp32, the
    experts in bf16 through the uint16 view."""
    _, jparams, _, tparams = setup(arch)
    jm, tm = jparams["blocks"][0]["moe"], tparams["blocks"][0]["moe"]
    assert sorted(jm) == sorted(tm) == ["router", "w_down", "w_gate",
                                        "w_up"]
    assert tm["router"].dtype == torch.float32
    for name in ("w_up", "w_gate", "w_down"):
        assert tm[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(jm[name]).view(np.uint16),
            tm[name].view(torch.uint16).numpy())
    np.testing.assert_array_equal(np.asarray(jm["router"]),
                                  tm["router"].numpy())


# -------------------------------------------------------------- whole model
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
    """The MoE bounds of tests/test_models_decode.py, position by
    position over [B, n, V] logits."""
    n = got.shape[1]
    errs = [_prob_err(got[:, i], want[:, i]) for i in range(n)]
    agree = [_tie_agree(got[:, i], want[:, i]) for i in range(n)]
    assert np.median(errs) < 0.05, errs
    assert np.mean(agree) >= MIN_AGREE, agree
    assert bool(torch.isfinite(got).all())


_REFS = {}


def _reference(arch, dropless=True):
    """Tokens, and the JAX model's teacher-forced logits [B, S, V] and
    loss."""
    if (arch, dropless) not in _REFS:
        jm, jparams, _, _ = setup(arch)
        toks = np.random.default_rng(8).integers(0, 256, (B, S)) \
            .astype(np.int32)
        x, aux = jax.jit(lambda p, b: jm.forward(
            p, b, remat=False, dropless=dropless))(
                jparams, {"tokens": jnp.asarray(toks)})
        _REFS[arch, dropless] = (toks, torch.from_numpy(np.array(
            jm._logits(jparams, x))), float(aux))
    return _REFS[arch, dropless]


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, dropless):
    """Teacher-forced logits and the summed load-balancing loss."""
    _, _, tcfg, tparams = setup(arch)
    toks, ref, aux_ref = _reference(arch, dropless)
    tm = build_model(tcfg)
    x, aux = tm.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                        dropless=dropless)
    got = tm._logits(tparams, x)
    assert got.shape == ref.shape == (B, S, 256)
    _gate(got, ref)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), aux_ref, rtol=2e-2)


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_jax(arch, attn_impl):
    """Prefill P = 24 positions (dropless), then decode to S = 40 one
    token at a time against the JAX model's dropless teacher-forced logits
    (mixtral's 16-slot rings wrap in the prefill; grok decodes over its
    int8 caches with a softcap of 30), and the prefill against the JAX
    model's own prefill."""
    jm, jparams, tcfg, tparams = setup(arch)
    toks, ref, _ = _reference(arch)
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
    if tcfg.kv_cache_dtype == "int8":
        assert all(c["k"].dtype == torch.int8 for c in cache)
    if tcfg.sliding_window:
        assert [c["k"].shape[2] for c in cache] == [16]
    lgj, _, _ = jax.jit(jm.prefill)(jparams,
                                    {"tokens": jnp.asarray(toks[:, :P])},
                                    jm.init_cache(B, S))
    lgj = torch.from_numpy(np.array(lgj))
    assert _prob_err(got[:, 0], lgj) < 0.05


def test_prefill_routes_dropless():
    """With a capacity factor of 0.1 capacity routing drops most slots, so
    the prefill's logits (dropless, as the reference's) equal the last
    position of ``forward(dropless=True)`` and differ from
    ``forward(dropless=False)``'s."""
    _, _, tcfg, tparams = setup("mixtral-8x7b")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.1))
    tm = build_model(tcfg)
    toks = torch.from_numpy(_reference("mixtral-8x7b")[0]).long()[:, :P]
    lg, _, _ = tm.prefill(tparams, {"tokens": toks},
                          tm.init_cache(B, P, device="cpu"))
    last = [tm._logits(tparams, tm.forward(tparams, {"tokens": toks},
                                           dropless=d)[0][:, -1])
            for d in (True, False)]
    torch.testing.assert_close(lg, last[0])
    assert _prob_err(lg, last[1]) > 1e-3


# ---------------------------------------------------------------- gradient
GRAD_CASES = ("capacity", "drops", "skewed", "ragged")
GRAD_REL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("case", GRAD_CASES)
def test_apply_moe_gradient_matches_jax_grad(case, impl, dtype):
    """The gradient of <y, c> + 10 aux (capacity routing, as training
    routes; ``drops`` and ``skewed`` drop slots, ``ragged`` pads its last
    chunk) with respect to x, the router and the three expert weights,
    against ``jax.grad`` of the reference's one-hot dispatch: each within
    1e-5 of its norm in fp32 (the same fp32 sums in another order), 2e-2
    in bf16 (both sides round the products to bf16 at other places;
    measured at most 4.4e-7 and 6.9e-3).  The
    aux term's weight makes the router's path through ``probs`` count
    beside its path through the gates."""
    change, skew, shift, shape, chunk, dropless = MOES[case]
    assert not dropless
    jcfg, tcfg = cfgs(**change)
    pj, pt = moe_trees(jcfg, dtype, skew)
    xj, xt = inputs((*shape, 128), dtype, seed=4, shift=shift)
    c = np.random.default_rng(9).standard_normal((*shape, 128)) \
        .astype(np.float32)

    def jloss(p, x):
        y, aux = JM.apply_moe(jcfg, p, x, chunk_size=chunk)
        return jnp.sum(y.astype(jnp.float32) * c) + 10.0 * aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(pj, xj)
    names = sorted(pt)
    leaves = [pt[n].requires_grad_() for n in names] + [xt.requires_grad_()]
    y, aux = TM.apply_moe(tcfg, pt, xt, chunk_size=chunk, attn_impl=impl)
    loss = torch.sum(y.float() * torch.from_numpy(c)) + 10.0 * aux
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(names + ["x"], got, [jgp[n] for n in names]
                          + [jgx]):
        w = np.asarray(w, np.float32)
        assert g.dtype == leaves[(names + ["x"]).index(name)].dtype, name
        err = float(np.linalg.norm(g.float().numpy() - w)
                    / np.linalg.norm(w))
        assert err < GRAD_REL[dtype], (name, err)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_dropped_slots_give_their_gate_no_gradient(impl):
    """With a capacity factor of 0.5 a third of the slots overflow: the
    output's gradient reaches the gate of every kept slot and of no
    dropped one, on both dispatches."""
    jcfg, tcfg = cfgs(capacity_factor=0.5)
    _, pt = moe_trees(jcfg, "float32")
    _, x = inputs((2, 24, 128), "float32", seed=5)
    C = TM.capacity(tcfg, 24, False)
    r = TM.route(tcfg, pt, x, C)
    gate = r.gate.detach().requires_grad_()
    r = r._replace(gate=gate)
    if impl == "plain":
        y = TM._onehot_moe(tcfg, pt, x, r, C)
    else:
        y = TM._sorted_moe(tcfg, pt, x, r,
                           torch.ones(2, 24, dtype=torch.bool))
    (g,) = torch.autograd.grad(y.square().sum(), gate)
    assert 0 < int((~r.keep).sum()) < r.keep.numel()
    assert bool((g[~r.keep] == 0).all())
    assert bool((g[r.keep] != 0).all())


def test_sorted_dispatch_gradient_is_deterministic():
    """Two identical backward passes through the sorted dispatch give the
    same bits (on the card too: tests/test_torch_cuda.py), and a
    one-token chunk under autograd takes it, not the batched decode
    products."""
    jcfg, tcfg = cfgs(capacity_factor=0.5)
    _, pt = moe_trees(jcfg, "bfloat16")
    _, x = inputs((2, 40, 128), "bfloat16", seed=6)
    leaves = [pt[n].requires_grad_() for n in sorted(pt)]
    runs = []
    for _ in range(2):
        y, aux = TM.apply_moe(tcfg, pt, x, chunk_size=16)
        runs.append(torch.autograd.grad(y.float().square().sum() + aux,
                                        leaves))
    assert all(torch.equal(a, b) for a, b in zip(*runs))

    def refuse(*a, **k):
        raise AssertionError("the batched decode products under autograd")
    import unittest.mock
    with unittest.mock.patch.object(TM, "_dense_moe", refuse):
        y, _ = TM.apply_moe(tcfg, pt, x[:, :1], chunk_size=1, dropless=True)
    assert y.requires_grad


def test_a_recompute_that_routes_otherwise_raises(monkeypatch):
    """Under remat each block's recompute reads the expert counts again;
    were they to differ from the forward's (a near tie rounded the other
    way), the recomputed expert products would change shape, and
    torch.utils.checkpoint raises instead of differentiating another
    routing.  Simulated by moving one slot between two experts' counts on
    every read after the forward's."""
    from torch.utils.checkpoint import CheckpointError
    cfg = get_config("mixtral-8x7b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (2, 48)))
    reads = []
    host_counts = TM._host_counts

    def counts(c):
        out = host_counts(c)
        reads.append(1)
        if len(reads) > cfg.num_layers:          # the backward's recompute
            a, b = [e for e, n in enumerate(out) if n][:2]
            out[a], out[b] = out[a] - 1, out[b] + 1
        return out
    monkeypatch.setattr(TM, "_host_counts", counts)
    loss, _ = model.loss(params, {"tokens": toks}, remat=True)
    assert len(reads) == cfg.num_layers
    with pytest.raises(CheckpointError):
        torch.autograd.grad(loss, leaves)
