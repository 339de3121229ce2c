"""The plain fp32 references against the port's own forward at smoke
width, on the benchmark's weights: the same function up to bf16."""
import json

import pytest
import torch

import flexbench_tiny as tiny


@pytest.fixture(autouse=True)
def _few_threads():
    with tiny.few_threads():
        yield

CONFIGS = ("mixtral-8x7b-l8", "nemotron-4-340b-l4")


def setup(name, seed=11, every_expert=False):
    from flexbench.lib import serve, spec, weights
    from repro_torch.models import build_model
    cfg = json.loads((tiny.ROOT / "flexbench" / "configs" /
                      f"{name}.json").read_text())
    cfg["model"].update(tiny.SMALL[name])
    if every_expert:
        moe = cfg["model"]["moe"]
        moe["top_k"] = moe["num_experts"]
    model = build_model(serve.model_config(cfg["model"]))
    params = weights.make(model, seed, "cpu", cfg.get("init"))
    return cfg, model, params, spec.reference(cfg["reference"])


@pytest.mark.parametrize("name,every_expert", [
    ("mixtral-8x7b-l8", True), ("nemotron-4-340b-l4", False)])
def test_reference_matches_the_port_forward(name, every_expert):
    """With every expert routed (top-k = E) no near tie can route the
    port's bf16 and the reference's fp32 apart: the products, norms,
    RoPE, window and gates are held to bf16's reach."""
    cfg, model, params, ref = setup(name, every_expert=every_expert)
    L = 40
    toks = torch.randint(0, cfg["model"]["vocab_size"], (L,),
                         generator=torch.Generator().manual_seed(1))
    want = torch.arange(L)
    got = ref.logits(params, cfg["model"], [(toks, want, L)])[0]
    with torch.inference_mode():
        x, _ = model.forward(params, {"tokens": toks[None]}, dropless=True)
        prog = model._logits(params, x[0]).float()
    rel = float((prog - got).norm() / got.norm())
    agree = float((prog.argmax(-1) == got.argmax(-1)).float().mean())
    assert rel < 0.05 and agree >= 0.9, (rel, agree)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_sees_its_window_and_its_cache(name):
    """Rows past the window see no earlier key; an int8 cache changes the
    decode rows alone."""
    cfg, model, params, ref = setup(name)
    m = cfg["model"]
    L = 48
    toks = torch.randint(0, m["vocab_size"], (L,),
                         generator=torch.Generator().manual_seed(2))
    want = torch.arange(L)
    full = ref.logits(params, m, [(toks, want, L)])[0]
    if m.get("sliding_window"):
        w = m["sliding_window"]
        # changing the first token moves no row whose window (and whose
        # keys' windows, layer on layer) has left it
        toks2 = toks.clone()
        toks2[0] = (toks[0] + 1) % m["vocab_size"]
        other = ref.logits(params, m, [(toks2, want, L)])[0]
        far = m["num_layers"] * (w - 1)
        assert torch.equal(other[far + 1:], full[far + 1:])
        assert not torch.equal(other[:w], full[:w])
    if m.get("kv_cache_dtype") == "int8":
        dec = ref.logits(params, m, [(toks, want, L // 2)])[0]
        assert torch.equal(dec[:L // 2], full[:L // 2])
        assert not torch.equal(dec[L // 2:], full[L // 2:])
        rel = float((dec - full).norm() / full.norm())
        assert rel < 0.05


def test_reference_routes_top2_as_the_port():
    """Top-2 routing: a near tie may go the other way in bf16 at a few
    rows, so the logits agree in argmax and on the whole."""
    cfg, model, params, ref = setup("mixtral-8x7b-l8")
    L = 40
    toks = torch.randint(0, cfg["model"]["vocab_size"], (L,),
                         generator=torch.Generator().manual_seed(1))
    got = ref.logits(params, cfg["model"], [(toks, torch.arange(L), L)])[0]
    with torch.inference_mode():
        x, _ = model.forward(params, {"tokens": toks[None]}, dropless=True)
        prog = model._logits(params, x[0]).float()
    rel = float((prog - got).norm() / got.norm())
    agree = float((prog.argmax(-1) == got.argmax(-1)).float().mean())
    assert rel < 0.2 and agree >= 0.9, (rel, agree)
