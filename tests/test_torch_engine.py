"""The port's RealEngine: every mode serves the same tokens as a sequential
greedy run of the port's own model, and that run agrees with the JAX
package's ``tests/test_engine.py::reference_outputs``.  Seven of the
port's models are served at smoke width: olmo-1b (KV caches), mamba2-780m
(conv and SSM state caches, the SSD scan's plain version on the CPU),
gemma2-2b (a 16-slot ring cache on its local layers beside its global
layers' full cache, softcaps and post-norms), starcoder2-3b (16-slot rings
on every layer, LayerNorm, GELU), qwen2-vl-2b (the VLM backbone on token
ids: M-RoPE with t = h = w), nemotron-4-340b (int8 KV caches with fp32
scales, squared ReLU) and mixtral-8x7b (MoE FFNs, routed dropless in
prefill and decode, over 16-slot rings on every layer).

Engine against the port's reference: token for token (the engine runs the
same eager torch model, so nothing may differ).  Port against JAX:
teacher-forced, under the tie-aware bound of ``tests/test_models_decode.py``
(each token the port picked has a JAX reference probability within 0.02
of the JAX top pick), because bf16 rounds at other places in the two
frameworks and a near-tie may flip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import unbox
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import (RealEngine, _insert_slot,
                                        _pack_cache, _unpack_cache)
from repro_torch.serving.request import Request

torch.set_num_threads(2)

MAX_LEN = 64
TIE_EPS = 0.02


def _setup(arch):
    """A reduced arch with the JAX model's parameters carried across."""
    jm = jax_build_model(jax_get_config(arch).reduced())
    jparams = unbox(jm.init(jax.random.PRNGKey(0)))
    cfg = get_config(arch).reduced()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return cfg, build_model(cfg), params, jm, jparams


@pytest.fixture(scope="module")
def setup():
    return _setup("olmo-1b")


@pytest.fixture(scope="module")
def mamba_setup():
    return _setup("mamba2-780m")


@pytest.fixture(scope="module")
def gemma_setup():
    return _setup("gemma2-2b")


@pytest.fixture(scope="module", params=["starcoder2-3b", "qwen2-vl-2b",
                                        "nemotron-4-340b", "mixtral-8x7b"])
def variant_setup(request):
    return _setup(request.param)


# mamba2's prompts span two scan chunks of 32 (the second one ragged)
MAMBA_PROMPT = 40
# gemma2's prompts: the first past its 16-token window (the local layers'
# ring wraps in the prefill), the others wrap it while decoding 8 tokens
GEMMA_PROMPTS = (24, 10, 12, 9, 14, 11)


def mk_requests(cfg, n=6, prompt=12, out=8, gap=0.01):
    """tests/test_engine.py::mk_requests (prompts from numpy seeds)."""
    return [Request(prompt_len=prompt, max_new_tokens=out,
                    prompt_tokens=np.random.default_rng(s).integers(
                        0, cfg.vocab_size, prompt).tolist(),
                    arrival_time=s * gap)
            for s in range(n)]


def gemma_requests(cfg, out=8, gap=0.01):
    """mk_requests with GEMMA_PROMPTS' lengths."""
    return [Request(prompt_len=n, max_new_tokens=out,
                    prompt_tokens=np.random.default_rng(s).integers(
                        0, cfg.vocab_size, n).tolist(),
                    arrival_time=s * gap)
            for s, n in enumerate(GEMMA_PROMPTS)]


def reference_outputs(model, params, reqs, max_len=MAX_LEN):
    """Sequential greedy decoding of each request alone (batch 1)."""
    outs = []
    for r in reqs:
        cache = model.init_cache(1, max_len, device="cpu")
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
def reference(setup):
    cfg, model, params, _, _ = setup
    return reference_outputs(model, params, mk_requests(cfg))


@pytest.fixture(scope="module")
def mamba_reference(mamba_setup):
    cfg, model, params, _, _ = mamba_setup
    return reference_outputs(model, params,
                             mk_requests(cfg, prompt=MAMBA_PROMPT))


@pytest.fixture(scope="module")
def gemma_reference(gemma_setup):
    cfg, model, params, _, _ = gemma_setup
    return reference_outputs(model, params, gemma_requests(cfg))


def variant_requests(cfg):
    """A windowed model's traffic crosses its window (gemma2's lengths);
    the others take mk_requests' 12-token prompts."""
    return gemma_requests(cfg) if cfg.sliding_window else mk_requests(cfg)


@pytest.fixture(scope="module")
def variant_reference(variant_setup):
    cfg, model, params, _, _ = variant_setup
    return reference_outputs(model, params, variant_requests(cfg))


def run_engine(setup, reqs, **kw):
    _, model, params, _, _ = setup
    kw.setdefault("max_num_seqs", 2)
    eng = RealEngine(model, params, max_len=MAX_LEN, device="cpu", **kw)
    try:
        res = eng.run(reqs, timeout=120)
    finally:
        eng.shutdown()
    return eng, res


@pytest.mark.parametrize("mode,kw", [
    ("passthrough", {}),
    ("static_colocate", {}),
    ("dynamic_pd", {}),
    ("disagg", {}),
    ("dynamic_pd", {"replicas": 2}),
    ("dynamic_pd", {"replicas": 2, "compute_queues": 2}),
    ("disagg", {"replicas": 2, "kv_chunk_layers": 2}),
])
def test_engine_matches_reference(setup, reference, mode, kw):
    cfg = setup[0]
    reqs = mk_requests(cfg)
    eng, res = run_engine(setup, reqs, mode=mode, **kw)
    assert res["completed"] == len(reqs) and res["failed"] == 0
    assert [r.output_tokens for r in reqs] == reference
    assert res["ttft_mean_s"] > 0 and res["tpot_mean_s"] > 0
    if kw.get("replicas", 1) > 1:
        assert {r.instance for r in reqs} == {"replica0", "replica1"}
    if mode == "disagg":
        assert eng.session.device_count() == 2 * kw.get("replicas", 1)
    if mode != "passthrough":       # every table drains: no leaked KV
        for dev in eng.session.stats().values():
            assert dev["buffers"] == 0 and dev["streams"] == 0
            assert dev["allocated_bytes"] == 0
        assert len(eng.session.shared_events) == 0


def test_engine_defaults_to_cuda(setup):
    """The engine runs on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    _, model, params, _, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealEngine(model, params, mode="passthrough")


def test_pack_cache_round_trip_and_order(setup):
    """The disagg transfer packs through a uint8 view in a fixed order:
    layers in order, then each layer's keys sorted (jax.tree.flatten's
    order for a list of dicts)."""
    cfg, model, _, _, _ = setup
    cache = model.init_cache(1, 8, device="cpu")
    for i, layer in enumerate(cache):
        for j, k in enumerate(sorted(layer)):
            layer[k].copy_(torch.randn(layer[k].shape) + 10 * j + 100 * i)
    blob, keys, spec = _pack_cache(cache)
    assert blob.dtype == np.uint8
    assert blob.nbytes == sum(t.numel() * t.element_size()
                              for layer in cache for t in layer.values())
    assert keys == [sorted(layer) for layer in cache]
    first = cache[0][keys[0][0]]
    np.testing.assert_array_equal(
        blob[:first.numel() * 2].view(np.uint16),
        first.reshape(-1).view(torch.uint16).numpy())
    back = _unpack_cache(blob, keys, spec, torch.device("cpu"))
    for a, b in zip(cache, back):
        for k in a:
            assert b[k].dtype == a[k].dtype and torch.equal(a[k], b[k])


def _agrees_with_jax(setup, reference, reqs):
    """The port's greedy tokens, teacher-forced through the JAX Model:
    every port pick is the JAX argmax or a near-tie under the JAX
    probabilities, and the port's run equals JAX's free-running
    ``reference_outputs`` up to the first such tie."""
    from test_engine import reference_outputs as jax_reference_outputs
    cfg, _, _, jm, jparams = setup

    class Jitted:       # the JAX Model, its two steps compiled once
        init_cache = staticmethod(jm.init_cache)
        prefill = staticmethod(jax.jit(jm.prefill))
        decode = staticmethod(jax.jit(jm.decode))

    jax_out = jax_reference_outputs(cfg, Jitted, jparams, reqs,
                                    max_len=MAX_LEN)
    for r, port_seq, jax_seq in zip(reqs, reference, jax_out):
        cache = jm.init_cache(1, MAX_LEN)
        lg, cache, _ = Jitted.prefill(
            jparams, {"tokens": jnp.asarray([r.prompt_tokens], jnp.int32)},
            cache)
        first_tie = None
        for i, tok in enumerate(port_seq):
            p = np.asarray(jax.nn.softmax(lg[0].astype(jnp.float32)))
            assert p.max() - p[tok] < TIE_EPS, (i, tok, int(p.argmax()))
            if tok != int(p.argmax()) and first_tie is None:
                first_tie = i
            lg, cache = Jitted.decode(
                jparams, jnp.asarray([tok], jnp.int32), cache,
                jnp.asarray([r.prompt_len + i], jnp.int32))
        n = len(port_seq) if first_tie is None else first_tie
        assert port_seq[:n] == jax_seq[:n]


def test_reference_agrees_with_jax(setup, reference):
    _agrees_with_jax(setup, reference, mk_requests(setup[0]))


@pytest.mark.parametrize("mode", ["passthrough", "static_colocate",
                                  "dynamic_pd", "disagg"])
def test_mamba2_engine_matches_reference(mamba_setup, mamba_reference, mode):
    """Reduced mamba2 served in every mode: the slot cache holds each
    sequence's conv and SSM state, and disagg moves them between devices."""
    cfg = mamba_setup[0]
    reqs = mk_requests(cfg, prompt=MAMBA_PROMPT)
    eng, res = run_engine(mamba_setup, reqs, mode=mode)
    assert res["completed"] == len(reqs) and res["failed"] == 0
    assert [r.output_tokens for r in reqs] == mamba_reference
    if mode != "passthrough":
        for dev in eng.session.stats().values():
            assert dev["buffers"] == 0 and dev["allocated_bytes"] == 0


def test_mamba2_reference_agrees_with_jax(mamba_setup, mamba_reference):
    _agrees_with_jax(mamba_setup, mamba_reference,
                     mk_requests(mamba_setup[0], prompt=MAMBA_PROMPT))


@pytest.mark.parametrize("mode", ["passthrough", "static_colocate",
                                  "dynamic_pd", "disagg"])
def test_gemma2_engine_matches_reference(gemma_setup, gemma_reference,
                                         mode):
    """Reduced gemma2 served in every mode: slot inserts and the disagg
    transfer carry each sequence's ring cache (16 slots, ring-aligned)
    beside its global cache, one prompt already past the window."""
    cfg = gemma_setup[0]
    reqs = gemma_requests(cfg)
    eng, res = run_engine(gemma_setup, reqs, mode=mode)
    assert res["completed"] == len(reqs) and res["failed"] == 0
    assert [r.output_tokens for r in reqs] == gemma_reference
    assert [c["k"].shape[2] for c in eng.replicas[0].slot_cache] == \
        [16, MAX_LEN]
    if mode != "passthrough":
        for dev in eng.session.stats().values():
            assert dev["buffers"] == 0 and dev["allocated_bytes"] == 0


def test_gemma2_reference_agrees_with_jax(gemma_setup, gemma_reference):
    _agrees_with_jax(gemma_setup, gemma_reference,
                     gemma_requests(gemma_setup[0]))


@pytest.mark.parametrize("mode", ["passthrough", "static_colocate",
                                  "dynamic_pd", "disagg"])
def test_variant_engine_matches_reference(variant_setup, variant_reference,
                                          mode):
    """starcoder2-3b, qwen2-vl-2b, nemotron-4-340b and mixtral-8x7b served
    in every mode: slot inserts and the disagg transfer carry starcoder2's
    and mixtral's rings (one prompt past the window) and nemotron's int8
    values with their fp32 scales; mixtral's MoE blocks change no cache."""
    cfg = variant_setup[0]
    reqs = variant_requests(cfg)
    eng, res = run_engine(variant_setup, reqs, mode=mode)
    assert res["completed"] == len(reqs) and res["failed"] == 0
    assert [r.output_tokens for r in reqs] == variant_reference
    cache = eng.replicas[0].slot_cache
    if cfg.sliding_window:
        assert [c["k"].shape[2] for c in cache] == [16]
    if cfg.kv_cache_dtype == "int8":
        assert [c["k"].dtype for c in cache] == [torch.int8]
    if mode != "passthrough":
        for dev in eng.session.stats().values():
            assert dev["buffers"] == 0 and dev["allocated_bytes"] == 0


def test_variant_reference_agrees_with_jax(variant_setup, variant_reference):
    _agrees_with_jax(variant_setup, variant_reference,
                     variant_requests(variant_setup[0]))


def test_int8_cache_packs_and_inserts_bit_for_bit():
    """An int8 cache (int8 values, fp32 scales) through the disagg
    transfer's uint8 packing and into a slot of the slot cache: every leaf
    keeps its dtype and bits, and the other slots stay untouched."""
    cfg = get_config("nemotron-4-340b").reduced()
    model = build_model(cfg)
    one = model.init_cache(1, 8, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for layer in one:
        layer["k"].copy_(torch.randint(-127, 128, layer["k"].shape,
                                       generator=gen))
        layer["v"].copy_(torch.randint(-127, 128, layer["v"].shape,
                                       generator=gen))
        layer["k_scale"].copy_(torch.rand(layer["k_scale"].shape,
                                          generator=gen))
        layer["v_scale"].copy_(torch.rand(layer["v_scale"].shape,
                                          generator=gen))
    blob, keys, spec = _pack_cache(one)
    assert keys == [["k", "k_scale", "v", "v_scale"]]
    assert [dt for _, dt in spec] == [torch.int8, torch.float32,
                                      torch.int8, torch.float32]
    back = _unpack_cache(blob, keys, spec, torch.device("cpu"))
    full = model.init_cache(3, 8, device="cpu")
    _insert_slot(full, back, 1)
    for a, b in zip(one, full):
        for k in a:
            assert b[k].dtype == a[k].dtype
            assert torch.equal(b[k][:, 1], a[k][:, 0])
            assert not b[k][:, 0].any() and not b[k][:, 2].any()
