"""The port's Mamba-2 mixer and model against the JAX package's.

Each function of ``repro_torch.models.mamba2`` is run beside its twin in
``repro.models.mamba2`` on the same numpy-drawn inputs and on parameters
carried across by ``repro_torch.bridge``, at mamba2-780m's smoke width
(``reduced()``: 4 layers, d_model 128, 16 heads of P = 16, N = 16,
chunk 32).  The reduced model is then held against the JAX ``Model`` end
to end, and the port's prefill plus decode against its own forward.

Tolerances, with their reasons:

* 2e-5 in fp32 where both sides run the same algorithm (the JAX model's
  ``ssd_chunked`` and its twin, the decode step, the conv): the same fp32
  arithmetic in another summation order.
* 1e-4 in fp32 where the port's kernel path runs the SSD scan by the
  kernel's per-chunk algorithm (``ssd_scan_plain`` on the CPU) instead of
  the JAX model's ``ssd_chunked``: the state is carried chunk by chunk
  and its decay applied per row, a different summation order.
* Whole model in bf16: the bounds of ``tests/test_models_decode.py``
  (median softmax error below 0.05, tie-aware argmax agreement); the
  port's own prefill plus decode against its forward under that file's
  5e-3 for mamba2 (``test_mamba2_decode_exact``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import unbox
from repro.models import build_model as jax_build_model
from repro.models import mamba2 as JM
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT

torch.set_num_threads(2)

F32 = dict(rtol=2e-5, atol=2e-5)
SCAN = dict(rtol=1e-4, atol=1e-4)
TIE_EPS = 0.02
B, S, P = 2, 24, 16          # tests/test_models_decode.py


def both(x, dtype=np.float32):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def cfgs():
    return (jax_get_config("mamba2-780m").reduced(),
            get_config("mamba2-780m").reduced())


@pytest.fixture(scope="module")
def models(cfgs):
    jcfg, tcfg = cfgs
    jm = jax_build_model(jcfg)
    jparams = unbox(jm.init(jax.random.PRNGKey(0)))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def layer0(models):
    """Layer 0's mamba params in fp32 on both sides."""
    _, jparams, _, _ = models
    one = jax.tree.map(lambda a: np.asarray(a[0], np.float32),
                       jparams["blocks"][0]["mamba"])
    return (jax.tree.map(jnp.asarray, one),
            bridge.params_from_numpy(one))


# ----------------------------------------------------- params, cache, bridge
def test_mamba_params_match_jax_shapes_and_dtypes(cfgs):
    jcfg, tcfg = cfgs
    jp = unbox(JM.mamba_params(jcfg, jax.random.PRNGKey(0)))
    tp = TM.mamba_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu", lead=(3,))
    assert sorted(jp) == sorted(tp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3, *v.shape), k
        assert str(tp[k].dtype).split(".")[-1] == str(v.dtype), k
    # log(linspace(1, 16, H)) may differ by an ulp between the frameworks
    np.testing.assert_allclose(tp["A_log"][1].numpy(),
                               np.asarray(jp["A_log"]), **F32)


def test_cache_shapes_and_dtypes_match_jax(cfgs):
    jcfg, tcfg = cfgs
    jc = JT.stack_cache_init(jcfg, 3, 16)
    tc = TT.stack_cache_init(tcfg, 3, 16, device="cpu")
    assert len(jc) == len(tc) == 1
    assert sorted(jc[0]) == sorted(tc[0]) == ["conv", "ssm"]
    for k in ("conv", "ssm"):
        assert tuple(tc[0][k].shape) == jc[0][k].shape
        assert tc[0][k].dtype == torch.float32
        assert jc[0][k].dtype == jnp.float32
        assert not tc[0][k].any()


def test_bridge_keeps_every_mamba_leaf_bit_for_bit(models):
    _, jparams, _, tparams = models
    jflat = jax.tree_util.tree_leaves_with_path(jparams)
    mamba = [(p, a) for p, a in jflat if "mamba" in jax.tree_util.keystr(p)]
    assert len(mamba) == 8
    for path, a in mamba:
        t = tparams
        for k in path:
            t = t[k.key if hasattr(k, "key") else k.idx]
        a = np.asarray(a)
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.uint16).numpy(),
                                          a.view(np.uint16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)


# ------------------------------------------------------------- SSD core
def test_segsum_matches_jax():
    jx, tx = both(np.random.default_rng(0).standard_normal((3, 2, 9)))
    want = np.asarray(JM._segsum(jx))
    got = TM._segsum(tx).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], **F32)


def scan_inputs(seed, Bsz, Sq, H, Pd, G, N, init=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((Bsz, Sq, H, Pd)),
            np.logaddexp(0.0, rng.standard_normal((Bsz, Sq, H))),
            -np.exp(rng.standard_normal(H) * 0.3),
            rng.standard_normal((Bsz, Sq, G, N)) * 0.5,
            rng.standard_normal((Bsz, Sq, G, N)) * 0.5]
    if init:
        arrs.append(rng.standard_normal((Bsz, H, Pd, N)))
    pairs = [both(a) for a in arrs]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("Sq,H,Pd,G,N,chunk,init", [
    (64, 2, 16, 1, 16, 16, False),
    (70, 4, 16, 2, 32, 32, True),          # ragged tail, groups, state
    (24, 16, 16, 1, 16, 32, True),         # the reduced model's shape
])
def test_ssd_chunked_matches_jax(Sq, H, Pd, G, N, chunk, init):
    j, t = scan_inputs(Sq + H, 2, Sq, H, Pd, G, N, init)
    jy, jf = JM.ssd_chunked(*j[:5], chunk, initial_state=j[5] if init
                            else None)
    ty, tf = TM.ssd_chunked(*t[:5], chunk, initial_state=t[5] if init
                            else None)
    close(ty, jy, **F32)
    close(tf, jf, **F32)


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(3)
    arrs = [rng.standard_normal((2, 4, 16, 16)),        # state
            rng.standard_normal((2, 4, 16)),            # x_t
            np.logaddexp(0.0, rng.standard_normal((2, 4))),
            -np.exp(rng.standard_normal(4) * 0.3),
            rng.standard_normal((2, 2, 16)) * 0.5,      # B_t, 2 groups
            rng.standard_normal((2, 2, 16)) * 0.5]
    j, t = zip(*(both(a) for a in arrs))
    jy, js = JM.ssd_decode_step(*j)
    ty, ts = TM.ssd_decode_step(*t)
    close(ty, jy, **F32)
    close(ts, js, **F32)


def test_causal_conv_full_matches_jax():
    rng = np.random.default_rng(4)
    j, t = zip(*(both(a) for a in (rng.standard_normal((2, 11, 40)),
                                   rng.standard_normal((4, 40)),
                                   rng.standard_normal(40))))
    close(TM._causal_conv_full(*t), JM._causal_conv_full(*j), **F32)


# ----------------------------------------------------------------- mixer
@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("impl,tol", [("plain", F32), ("kernel", SCAN)])
def test_mamba_forward_matches_jax(cfgs, layer0, with_cache, impl, tol):
    jcfg, tcfg = cfgs
    jp, tp = layer0
    rng = np.random.default_rng(5)
    jx, tx = both(rng.standard_normal((2, 40, tcfg.d_model)))
    jc = tc = None
    if with_cache:      # a warm cache: prefill continuing earlier tokens
        conv = rng.standard_normal((2, 3, TM._dims(tcfg)[2]))
        ssm = rng.standard_normal((2, 16, 16, 16)) * 0.1
        jc = {"conv": jnp.asarray(conv, jnp.float32),
              "ssm": jnp.asarray(ssm, jnp.float32)}
        tc = {"conv": torch.tensor(conv, dtype=torch.float32),
              "ssm": torch.tensor(ssm, dtype=torch.float32)}
    jy, jnew = JM.mamba_forward(jcfg, jp, jx, jc)
    ty, tnew = TM.mamba_forward(tcfg, tp, tx, tc, attn_impl=impl)
    close(ty, jy, **tol)
    if with_cache:
        assert tnew is tc
        close(tc["conv"], jnew["conv"], **F32)
        close(tc["ssm"], jnew["ssm"], **tol)


def test_mamba_decode_matches_jax(cfgs, layer0):
    jcfg, tcfg = cfgs
    jp, tp = layer0
    rng = np.random.default_rng(6)
    jx, tx = both(rng.standard_normal((2, 1, tcfg.d_model)))
    conv = rng.standard_normal((2, 3, TM._dims(tcfg)[2]))
    ssm = rng.standard_normal((2, 16, 16, 16)) * 0.1
    jc = {"conv": jnp.asarray(conv, jnp.float32),
          "ssm": jnp.asarray(ssm, jnp.float32)}
    tc = {"conv": torch.tensor(conv, dtype=torch.float32),
          "ssm": torch.tensor(ssm, dtype=torch.float32)}
    jy, jnew = JM.mamba_decode(jcfg, jp, jx, jc)
    ty, tnew = TM.mamba_decode(tcfg, tp, tx, tc)
    assert tnew is tc
    close(ty, jy, **F32)
    close(tc["conv"], jnew["conv"], **F32)
    close(tc["ssm"], jnew["ssm"], **F32)


# ----------------------------------------------------------------- model
def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _prob_err(a, b) -> float:
    return float((_f32(a).softmax(-1) - _f32(b).softmax(-1)).abs().max())


def _tie_agree(got, ref) -> bool:
    """tests/test_models_decode.py::agree_step."""
    got, ref = _f32(got), _f32(ref)
    p_ref = ref.softmax(-1)
    a_got, a_ref = got.argmax(-1), ref.argmax(-1)
    p_top = p_ref.gather(-1, a_ref[..., None])[..., 0]
    p_picked = p_ref.gather(-1, a_got[..., None])[..., 0]
    return bool(((a_got == a_ref) | (p_top - p_picked < TIE_EPS)).all())


def _tokens(cfg, seed=7):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_model_logits_match_jax(models, cfgs):
    jm, jparams, tm, tparams = models
    toks = _tokens(cfgs[1])
    jx, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                       remat=False)
    jlog = np.asarray(jm._logits(jparams, jx), np.float32)
    with torch.inference_mode():
        tx, _ = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
        tlog = tm._logits(tparams, tx)
    errs = [_prob_err(tlog[:, t], jlog[:, t]) for t in range(S)]
    assert np.median(errs) < 0.05, errs
    assert _tie_agree(tlog, jlog)


def test_prefill_decode_matches_forward(models, cfgs):
    """The twin of tests/test_models_decode.py::test_mamba2_decode_exact:
    the kernel path's prefill (the scan's plain version on the CPU) plus
    recurrent decode against the port's own teacher-forced forward."""
    _, _, tm, tparams = models
    toks = torch.from_numpy(_tokens(cfgs[1], seed=8))
    with torch.inference_mode():
        x, _ = tm.forward(tparams, {"tokens": toks})
        full = tm._logits(tparams, x)
    cache = tm.init_cache(B, S, device="cpu")
    lg, cache, _ = tm.prefill(tparams, {"tokens": toks[:, :P]}, cache)
    worst = _prob_err(lg, full[:, P - 1])
    for t in range(P, S):
        lg, cache = tm.decode(tparams, toks[:, t], cache,
                              torch.full((B,), t, dtype=torch.int32))
        worst = max(worst, _prob_err(lg, full[:, t]))
    assert worst < 5e-3, worst


def test_kernel_and_plain_impls_agree_on_cpu(models, cfgs):
    """attn_impl='kernel' (the scan's plain version on the CPU) and
    attn_impl='plain' (the JAX model's own ssd_chunked) give the same
    model, through prefill and a decode step."""
    _, _, tm, tparams = models
    plain = build_model(cfgs[1], attn_impl="plain")
    toks = torch.from_numpy(_tokens(cfgs[1], seed=9))
    outs = []
    for m in (tm, plain):
        cache = m.init_cache(B, S, device="cpu")
        lg, cache, _ = m.prefill(tparams, {"tokens": toks}, cache)
        lg2, cache = m.decode(tparams, toks[:, -1], cache,
                              torch.full((B,), S, dtype=torch.int32))
        outs.append((lg, lg2, cache[0]["ssm"].clone()))
    (k1, k2, k_state), (p1, p2, p_state) = outs
    for a, b in ((k1, p1), (k2, p2)):
        assert _prob_err(a, b) < 5e-3 and _tie_agree(a, b)
    close(k_state, p_state, rtol=2e-2, atol=2e-2)
