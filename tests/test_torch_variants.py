"""The rest of the attention variants against the JAX package's.

Three configurations bring them onto the port's path:

* starcoder2-3b: a sliding window on every layer (so every cache is a
  ring), parametric LayerNorm, non-gated GELU, G = 12 at full width;
* qwen2-vl-2b: the VLM backbone, fed token ids or precomputed ``embeds``
  with M-RoPE ``[3, B, S]`` positions (temporal / height / width rows);
* nemotron-4-340b: int8 KV caches (per-(b, t, head) fp32 scales), squared
  ReLU, an untied head.

Each is run here beside its twin in ``repro.models`` at ``reduced()``
width (4 layers, d_model 128, head_dim 32) on parameters carried across by
``repro_torch.bridge``.

Tolerances, with their reasons:

* Quantized int8 values, scales and dequantized values: exact.  Both
  sides do the same fp32 division and round half to even.
* 2e-5 in fp32 for cos/sin tables and a single attention layer: the same
  fp32 arithmetic in another order.
* Whole model in bf16: the bounds of ``tests/test_models_decode.py`` —
  median softmax error below 0.05 and tie-aware argmax agreement (a pick
  whose reference probability is within 0.02 of the top counts), since the
  two frameworks round bf16 at different places.
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
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import PosEmb
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

torch.set_num_threads(2)

F32 = dict(rtol=2e-5, atol=2e-5)
TIE_EPS = 0.02
ARCHS = ("starcoder2-3b", "qwen2-vl-2b", "nemotron-4-340b")
# full-width parameter counts (jax.eval_shape of the JAX init)
FULL_PARAMS = {"starcoder2-3b": 3_029_710_848, "qwen2-vl-2b": 1_543_656_960}
B, S, P = 2, 40, 24          # prefill P tokens, decode to S
IMAGE_AT, GRID = 4, 4        # the embeds case: a 4 x 4 patch grid at s0 = 4


def both(x, dtype=np.float32):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


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


def _prob_err(a, b):
    return float((a.float().softmax(-1) - b.float().softmax(-1)).abs().max())


def _tie_agree(lg, ref):
    """tests/test_models_decode.py::agree_step, in torch."""
    p_ref = ref.float().softmax(-1)
    a_got, a_ref = lg.argmax(-1), ref.argmax(-1)
    p_top = p_ref.gather(-1, a_ref[..., None])[..., 0]
    p_pick = p_ref.gather(-1, a_got[..., None])[..., 0]
    return bool(((a_got == a_ref) | (p_top - p_pick < TIE_EPS)).all())


_SETUPS = {}


def setup(arch):
    """(JAX model, JAX params, port config, port params) at smoke width,
    built once per arch."""
    if arch not in _SETUPS:
        jm = jax_build_model(jax_get_config(arch).reduced())
        jparams = unbox(jm.init(jax.random.PRNGKey(0)))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
        _SETUPS[arch] = (jm, jparams, get_config(arch).reduced(), tparams)
    return _SETUPS[arch]


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_jax_one(arch):
    full_j, full_t = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(full_t.reduced()) == \
        dataclasses.asdict(full_j.reduced())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_init_draws_the_jax_tree(arch):
    """The port's init at full published width (traced with fake tensors,
    nothing allocated) draws the JAX init's shapes and dtypes: starcoder2-3b
    has 3,029,710,848 parameters and qwen2-vl-2b 1,543,656,960, with no
    linear biases on either side."""
    jshapes = jax.tree.leaves(unbox(jax.eval_shape(
        jax_build_model(jax_get_config(arch)).init, jax.random.PRNGKey(0))))
    with FakeTensorMode():
        own = list(_leaves(build_model(get_config(arch)).init(
            0, device="cpu")))
    assert [tuple(a.shape) for a in jshapes] == [tuple(t.shape) for t in own]
    assert [str(a.dtype) for a in jshapes] == \
        [str(t.dtype).replace("torch.", "") for t in own]
    if arch in FULL_PARAMS:
        assert sum(t.numel() for t in own) == FULL_PARAMS[arch]


def test_nemotron_cut_init_draws_the_jax_tree():
    """The card's nemotron-4-340b: its published width cut to 4 of 96
    layers (fake tensors, nothing allocated) draws the JAX init's shapes
    and dtypes, 23,253,553,152 parameters, 46.5 GB in bf16."""
    jcfg, tcfg = (dataclasses.replace(c, num_layers=4) for c in (
        jax_get_config("nemotron-4-340b"), get_config("nemotron-4-340b")))
    jshapes = jax.tree.leaves(unbox(jax.eval_shape(
        jax_build_model(jcfg).init, jax.random.PRNGKey(0))))
    with FakeTensorMode():
        own = list(_leaves(build_model(tcfg).init(0, device="cpu")))
    assert [tuple(a.shape) for a in jshapes] == [tuple(t.shape) for t in own]
    assert sum(t.numel() for t in own) == 23_253_553_152
    assert (4, 18432, 96, 192) in [tuple(t.shape) for t in own]   # wq


def test_starcoder2_rings_on_every_layer():
    cfg = get_config("starcoder2-3b")
    assert {d.window for d in TT.block_pattern(cfg)} == {4096}
    assert TT.num_repeats(cfg) == 30
    cache = TT.stack_cache_init(cfg.reduced(), 2, 40, device="cpu")
    assert [tuple(c["k"].shape) for c in cache] == [(4, 2, 16, 2, 32)]


# ------------------------------------------------------------------ M-RoPE
@pytest.mark.parametrize("head_dim", [32, 64, 128, 256])
def test_mrope_sections(head_dim):
    got = TL.mrope_sections(head_dim)
    assert got == JL.mrope_sections(head_dim)
    assert sum(got) == head_dim // 2
    if head_dim == 128:
        assert got == (16, 24, 24)          # Qwen2-VL's published split


def _thw_positions(rng, B_, S_):
    """[3, B, S] positions whose temporal, height and width rows differ."""
    return rng.integers(0, 3000, (3, B_, S_)).astype(np.int32)


@pytest.mark.parametrize("head_dim,theta", [(32, 1e6), (128, 1e6),
                                            (64, 10_000.0)])
def test_mrope_cos_sin_matches_jax(head_dim, theta):
    pj, pt = both(_thw_positions(np.random.default_rng(head_dim), 2, 9),
                  np.int32)
    cj, sj = JL.mrope_cos_sin(pj, head_dim, theta)
    ct, st = TL.mrope_cos_sin(pt, head_dim, theta)
    assert ct.shape == (2, 9, head_dim // 2) == st.shape
    close(ct, cj, **F32)
    close(st, sj, **F32)
    # each band takes its row: the temporal band is RoPE of row t, etc.
    t, h, _ = TL.mrope_sections(head_dim)
    for row, (lo, hi) in enumerate([(0, t), (t, t + h),
                                    (t + h, head_dim // 2)]):
        c_row, _ = TL.rope_cos_sin(pt[row], head_dim, theta)
        close(ct[..., lo:hi], c_row[..., lo:hi].numpy(), **F32)


@pytest.mark.parametrize("form", ["thw", "bs"])
def test_mrope_tables_need_no_device_values(form):
    """Every shape in the M-RoPE tables follows from the input's shape,
    so building them on a device never waits for the device (a size read
    from a tensor's values would; the meta device, which has no values,
    refuses such an op)."""
    cfg = get_config("qwen2-vl-2b")
    shape = (3, 2, 7) if form == "thw" else (2, 7)
    cos, sin = TL.positional_cos_sin(
        cfg, torch.zeros(shape, dtype=torch.long, device="meta"))
    assert cos.shape == sin.shape == (2, 7, cfg.head_dim // 2)
    assert cos.device.type == "meta"


@pytest.mark.parametrize("pos_emb,form", [(PosEmb.MROPE, "thw"),
                                          (PosEmb.MROPE, "bs"),
                                          (PosEmb.ROPE, "bs")])
def test_positional_cos_sin_matches_jax(pos_emb, form):
    """[3, B, S] rows that differ, or the [B, S] text-only form, which
    M-RoPE replicates across t/h/w: then it equals plain RoPE."""
    jcfg, tcfg = (dataclasses.replace(c, pos_emb=pos_emb) for c in (
        jax_get_config("qwen2-vl-2b").reduced(),
        get_config("qwen2-vl-2b").reduced()))
    rng = np.random.default_rng(5)
    pos = _thw_positions(rng, 2, 11) if form == "thw" else \
        rng.integers(0, 3000, (2, 11)).astype(np.int32)
    pj, pt = both(pos, np.int32)
    cj, sj = JL.positional_cos_sin(jcfg, pj)
    ct, st = TL.positional_cos_sin(tcfg, pt)
    close(ct, cj, **F32)
    close(st, sj, **F32)
    rope = TL.rope_cos_sin(pt if form == "bs" else pt[0], 32, 1e6)[0]
    assert torch.allclose(ct, rope, **F32) == (form == "bs")


def test_positional_cos_sin_none():
    cfg = get_config("mamba2-780m").reduced()
    assert TL.positional_cos_sin(cfg, torch.zeros(1, 3, dtype=torch.long)) \
        == (None, None)


# ----------------------------------------------------------------- int8 KV
def _int8_cfgs():
    return (jax_get_config("nemotron-4-340b").reduced(),
            get_config("nemotron-4-340b").reduced())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_exactly_as_jax(dtype):
    """Bit for bit, ties included: every k/v row of 32 holds 127 (so the
    scale is 1 and x / scale is x) and the halves 0.5 ... 14.5 with both
    signs, which round half to even."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32) * 3
    ties = np.zeros((1, 1, 4, 32), np.float32)
    ties[..., 0] = 127.0
    ties[..., 1:] = np.concatenate([np.arange(16) + 0.5,
                                    -(np.arange(15) + 0.5)])
    x[:1, :1] = ties
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        xj, xt = xj.astype(jnp.bfloat16), xt.bfloat16()
    qj, sj = JL._quantize_kv(xj)
    qt, st = TL._quantize_kv(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    exact(qt, qj)
    exact(st, sj)
    assert qt[0, 0, 0, 1:17].tolist() == [0, 2, 2, 4, 4, 6, 6, 8, 8, 10,
                                          10, 12, 12, 14, 14, 16]
    for out in ("float32", "bfloat16"):
        dj = JL._dequantize_kv(qj, sj, getattr(jnp, out))
        dt = TL._dequantize_kv(qt, st, getattr(torch, out))
        assert dt.dtype == getattr(torch, out)
        exact(dt.float(), np.asarray(dj, np.float32))


def test_int8_cache_init():
    jcfg, tcfg = _int8_cfgs()
    got = TL.kv_cache_init(tcfg, 3, 20, device="cpu", lead=(2,))
    want = JL.kv_cache_init(jcfg, 3, 20)
    assert sorted(got) == sorted(want) == ["k", "k_scale", "v", "v_scale"]
    for k in got:
        assert tuple(got[k].shape) == (2, *want[k].shape)
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
    ring = TL.kv_cache_init(tcfg, 1, 64, 16, device="cpu")
    assert tuple(ring["k_scale"].shape) == (1, 16, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_", [5, 16, 21, 37])
def test_int8_kv_writes_exactly_as_jax(S_, dtype):
    """Prefill (S < T, and S >= T: a ring, quantized after the roll), then
    two decode writes at ``lengths % T``: the int8 values, the scales and
    the dequantized read equal JAX's, and the port wrote its cache in
    place."""
    jcfg, tcfg = _int8_cfgs()
    rng = np.random.default_rng(S_)
    T = 16
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))

    def kv(shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)

    (kj, kt), (vj, vt) = kv((B, S_, 4, 32)), kv((B, S_, 4, 32))
    cj = JL.kv_write_prefill(JL.kv_cache_init(jcfg, B, T), kj, vj)
    ct = TL.kv_cache_init(tcfg, B, T, device="cpu")
    buffers = {k: t.data_ptr() for k, t in ct.items()}
    assert TL.kv_write_prefill(ct, kt, vt) is ct
    for step in range(2):
        (k1j, k1t), (v1j, v1t) = kv((B, 1, 4, 32)), kv((B, 1, 4, 32))
        lj, lt = both([S_ + step, 3 + step], np.int32)
        cj = JL.kv_write_decode(cj, k1j, v1j, lj)
        TL.kv_write_decode(ct, k1t, v1t, lt)
    assert {k: t.data_ptr() for k, t in ct.items()} == buffers
    for k in ct:
        exact(ct[k], cj[k])
    assert ct["k"].dtype == torch.int8 and bool((ct["k_scale"] > 0).any())
    for a, b in zip(JL.kv_read(cj, jdt), TL.kv_read(ct, tdt)):
        exact(b.float(), np.asarray(a, np.float32))


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_int8_attention_layer_matches_jax(impl):
    """One attention layer on fp32 parameters over an int8 cache: prefill
    attends over the unquantized K/V and writes the quantized cache; two
    decode steps dequantize the whole cache and attend (``kernel`` takes
    the paged kernel's plain version on the CPU)."""
    jcfg, tcfg = _int8_cfgs()
    _, jparams, _, _ = setup("nemotron-4-340b")
    sub = jax.tree.map(lambda a: np.asarray(a[0], np.float32),
                       jparams["blocks"][0]["attn"])
    pj = jax.tree.map(jnp.asarray, sub)
    pt = bridge.params_from_numpy(sub)
    rng = np.random.default_rng(6)
    n, T = 11, 16
    xj, xt = both(rng.standard_normal((B, n, 128)))
    posj, post = both(np.broadcast_to(np.arange(n), (B, n)), np.int32)
    cj = JL.kv_cache_init(jcfg, B, T)
    ct = TL.kv_cache_init(tcfg, B, T, device="cpu")
    oj, cj = JL.attention_forward(jcfg, pj, xj, posj, cache=cj)
    ot, ct = TL.attention_forward(tcfg, pt, xt, post, cache=ct,
                                  attn_impl=impl)
    close(ot, oj, **F32)
    for step in range(2):
        x1j, x1t = both(rng.standard_normal((B, 1, 128)))
        lj, lt = both([n + step, n + step], np.int32)
        oj, cj = JL.attention_decode(jcfg, pj, x1j, lj, cache=cj)
        ot, ct = TL.attention_decode(tcfg, pt, x1t, lt, cache=ct,
                                     attn_impl=impl)
        close(ot, oj, **F32)
    close(ct["k_scale"], cj["k_scale"], **F32)
    assert ct["k"].dtype == torch.int8


# -------------------------------------------------------------- whole model
def _image_batch(jm, jparams, toks):
    """The embeds case: text embedded from ``toks`` at positions i, i, i,
    and a GRID x GRID patch grid of random bf16 embeds at IMAGE_AT, its
    rows at t = s0, h = s0 + row, w = s0 + col.  Returns (embeds [B,S,d]
    as float32 holding bf16 values, positions [3,B,S] int32)."""
    rng = np.random.default_rng(21)
    emb = np.array(jnp.take(jparams["embed"], jnp.asarray(toks), axis=0)
                   .astype(jnp.float32))
    n_img = GRID * GRID
    img = jnp.asarray(rng.standard_normal((toks.shape[0], n_img,
                                           emb.shape[-1])) * 0.05)
    emb[:, IMAGE_AT:IMAGE_AT + n_img] = np.asarray(
        img.astype(jnp.bfloat16).astype(jnp.float32))
    pos = np.broadcast_to(np.arange(toks.shape[1]), (3, *toks.shape)).copy()
    patch = np.arange(n_img)
    pos[0, :, IMAGE_AT:IMAGE_AT + n_img] = IMAGE_AT
    pos[1, :, IMAGE_AT:IMAGE_AT + n_img] = IMAGE_AT + patch // GRID
    pos[2, :, IMAGE_AT:IMAGE_AT + n_img] = IMAGE_AT + patch % GRID
    return emb, pos.astype(np.int32)


def _jax_batch(emb, pos):
    return {"embeds": jnp.asarray(emb).astype(jnp.bfloat16),
            "positions": jnp.asarray(pos)}


def _torch_batch(emb, pos):
    return {"embeds": torch.from_numpy(emb).bfloat16(),
            "positions": torch.from_numpy(pos)}


def _reference(arch, inputs):
    """Tokens, the JAX model's teacher-forced logits [B, S, V] and, for
    the embeds case, its (embeds, positions)."""
    jm, jparams, _, _ = setup(arch)
    toks = np.random.default_rng(8).integers(0, 256, (B, S)).astype(np.int32)
    image = _image_batch(jm, jparams, toks) if inputs == "embeds" else None
    batch = (_jax_batch(*image) if image is not None
             else {"tokens": jnp.asarray(toks)})
    x, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(jparams, batch)
    return toks, torch.from_numpy(np.array(jm._logits(jparams, x))), image


def _prefill_decode(tm, tparams, toks, image, cache_len=S):
    """The port's prefill of P positions (tokens, or the image batch's
    first P embeds and positions), then decode of the rest of ``toks``
    teacher-forced.  Returns the logits [B, S-P+1, V] and the cache."""
    tt = torch.from_numpy(toks).long()
    cache = tm.init_cache(B, cache_len, device="cpu")
    if image is None:
        batch = {"tokens": tt[:, :P]}
    else:
        emb, pos = image
        batch = _torch_batch(emb[:, :P], pos[..., :P])
    lg, cache, lens = tm.prefill(tparams, batch, cache)
    assert lens.tolist() == [P] * B
    steps = [lg]
    for t in range(P, S):
        lg, cache = tm.decode(tparams, tt[:, t], cache,
                              torch.full((B,), t, dtype=torch.int32))
        steps.append(lg)
    return torch.stack(steps, 1), cache


def _gate(got, want):
    errs = [_prob_err(got[:, i], want[:, i]) for i in range(got.shape[1])]
    assert np.median(errs) < 0.05, errs
    assert all(_tie_agree(got[:, i], want[:, i])
               for i in range(got.shape[1]))
    assert bool(torch.isfinite(got).all())


CASES = [("starcoder2-3b", "tokens"), ("qwen2-vl-2b", "tokens"),
         ("qwen2-vl-2b", "embeds"), ("nemotron-4-340b", "tokens")]


@pytest.mark.parametrize("arch,inputs", CASES)
def test_forward_matches_jax(arch, inputs):
    _, _, tcfg, tparams = setup(arch)
    toks, ref, image = _reference(arch, inputs)
    tm = build_model(tcfg)
    batch = (_torch_batch(*image) if image is not None
             else {"tokens": torch.from_numpy(toks).long()})
    x, aux = tm.forward(tparams, batch)
    got = tm._logits(tparams, x)
    assert got.shape == ref.shape == (B, S, 256) and float(aux) == 0.0
    _gate(got, ref)


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
@pytest.mark.parametrize("arch,inputs", CASES)
def test_prefill_decode_matches_jax(arch, inputs, attn_impl):
    """Prefill P = 24 positions, then decode to S = 40 against the JAX
    model's teacher-forced logits (starcoder2's 16-slot rings wrap in the
    prefill; nemotron decodes over its dequantized int8 cache), and the
    prefill against the JAX model's own prefill of the same batch."""
    jm, jparams, tcfg, tparams = setup(arch)
    toks, ref, image = _reference(arch, inputs)
    got, cache = _prefill_decode(build_model(tcfg, attn_impl=attn_impl),
                                 tparams, toks, image)
    _gate(got, ref[:, P - 1:])
    if tcfg.kv_cache_dtype == "int8":
        assert all(c["k"].dtype == torch.int8 and
                   bool((c["k_scale"][:, :, :S] > 0).all()) for c in cache)
    jc = jm.init_cache(B, S)
    batch = (_jax_batch(image[0][:, :P], image[1][..., :P]) if image
             else {"tokens": jnp.asarray(toks[:, :P])})
    lgj, _, _ = jax.jit(jm.prefill)(jparams, batch, jc)
    lgj = torch.from_numpy(np.array(lgj))
    assert _prob_err(got[:, 0], lgj) < 0.05 and _tie_agree(got[:, 0], lgj)


def test_mrope_rows_reach_the_logits():
    """The embeds case with the image's [3,B,S] rows against the same
    embeds at replicated positions (plain RoPE): past the image the logits
    move, by ten times or more the port's distance from JAX, so the
    sections reach every layer."""
    _, _, tcfg, tparams = setup("qwen2-vl-2b")
    toks, ref, (emb, pos) = _reference("qwen2-vl-2b", "embeds")
    tm = build_model(tcfg)
    replicated = np.broadcast_to(np.arange(S, dtype=np.int32), pos.shape)
    got, flat = (tm._logits(tparams, tm.forward(
        tparams, _torch_batch(emb, p.copy()))[0])[:, P - 1:]
        for p in (pos, replicated))
    err = float((got - ref[:, P - 1:]).abs().mean())
    moved = float((flat - got).abs().mean())
    assert moved > 10 * err, (moved, err)


def test_int8_cache_moves_decode_within_the_gate():
    """nemotron's int8 cache against the same model with bf16 caches: the
    prefill (over unquantized K/V) is the same, every decode step's logits
    differ, and they stay within the model gate."""
    _, _, tcfg, tparams = setup("nemotron-4-340b")
    toks, _, _ = _reference("nemotron-4-340b", "tokens")
    outs = [_prefill_decode(build_model(c), tparams, toks, None)[0]
            for c in (tcfg, dataclasses.replace(tcfg,
                                                kv_cache_dtype="bfloat16"))]
    assert torch.equal(outs[0][:, 0], outs[1][:, 0])
    assert all(not torch.equal(outs[0][:, i], outs[1][:, i])
               for i in range(1, outs[0].shape[1]))
    _gate(outs[0], outs[1])


# nemotron-4-340b's published head_dim and G at smoke width: 12 query heads
# over one KV head of 192 (d_model stays 128, so the projections widen)
D192 = dict(head_dim=192, num_heads=12, num_kv_heads=1)
_D192 = {}


def _d192_setup():
    """(JAX model, JAX params, port config, port params) of the reduced
    nemotron-4-340b at head_dim 192, built once."""
    if not _D192:
        jcfg = dataclasses.replace(
            jax_get_config("nemotron-4-340b").reduced(), **D192)
        jm = jax_build_model(jcfg)
        jparams = unbox(jm.init(jax.random.PRNGKey(0)))
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
        tcfg = dataclasses.replace(get_config("nemotron-4-340b").reduced(),
                                   **D192)
        _D192.update(setup=(jm, jparams, tcfg, tparams))
    return _D192["setup"]


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_head_dim_192_model_matches_jax(attn_impl):
    """The reduced nemotron-4-340b at head_dim 192 with G = 12: the
    teacher-forced forward, and a prefill of P = 24 positions plus decode
    to S = 40 over its int8 cache (``kernel`` takes both kernels' plain
    versions on the CPU), against the JAX model's teacher-forced logits."""
    jm, jparams, tcfg, tparams = _d192_setup()
    toks = np.random.default_rng(8).integers(0, 256, (B, S)).astype(np.int32)
    x, _ = jax.jit(lambda p, b: jm.forward(p, b, remat=False))(
        jparams, {"tokens": jnp.asarray(toks)})
    ref = torch.from_numpy(np.array(jm._logits(jparams, x)))
    tm = build_model(tcfg, attn_impl=attn_impl)
    got = tm._logits(tparams, tm.forward(
        tparams, {"tokens": torch.from_numpy(toks).long()})[0])
    _gate(got, ref)
    got, cache = _prefill_decode(tm, tparams, toks, None)
    _gate(got, ref[:, P - 1:])
    assert [tuple(c["k"].shape) for c in cache] == [(4, B, S, 1, 192)]
    assert all(c["k"].dtype == torch.int8 for c in cache)
