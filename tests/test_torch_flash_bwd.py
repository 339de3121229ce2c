"""The gradient of the port's flash attention against JAX's.

The JAX model trains through ``repro.models.layers.blocked_attention``,
which XLA differentiates; no Pallas kernel has a backward.  The port's
``flash_attention_bwd_plain`` (the formulas of
``csrc/flash_attention_bwd.cu`` in plain torch, from the forward's output
and row log-sum-exp) and ``kernels.ops.FlashAttentionFn`` (the autograd
path that training takes) are held here against ``jax.vjp`` of
``blocked_attention`` on the same numpy-drawn q, k, v and output
gradient, over causal and not, a sliding window, a softcap that binds,
G = 1, 2, 4, every head dim the forward takes (32, 64, 128, 192, 256)
and a kv_len that cuts the keys.

Tolerances, of each gradient's norm: 1e-4 in fp32 (the same fp32
arithmetic in another order), 2e-2 in bf16 (the reference rounds the
probabilities to bf16 before P V, the port keeps them in fp32, and both
round each gradient to bf16 once).  The kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``).

Also here: the CPU-side refusals.  The CUDA wrappers refuse to run under
autograd (their outputs carry no gradient) before they look at the
device, and what the backward kernel does not take is refused before a
forward launches.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blocked_attention as jax_blocked
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ssd_scan as SSD

torch.set_num_threads(2)

REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name -> (B, S, H, KVH, D, kwargs); q_boost scales q so a softcap binds
CASES = {
    "causal G=1 D=128": (1, 80, 2, 2, 128, {}),
    "not causal G=1 D=64": (2, 70, 2, 2, 64, dict(causal=False)),
    "causal G=2 D=64": (1, 100, 4, 2, 64, {}),
    "window G=2 D=128": (1, 130, 4, 2, 128, dict(window=24)),
    "softcap G=4 D=64": (1, 90, 8, 2, 64, dict(softcap=5.0, q_boost=3.0)),
    "window softcap G=4 D=128": (1, 100, 8, 2, 128,
                                 dict(window=30, softcap=5.0, q_boost=3.0)),
    "not causal G=4 D=128": (1, 65, 4, 1, 128, dict(causal=False)),
    "causal G=2 D=32": (1, 90, 4, 2, 32, {}),
    "causal G=2 D=192": (1, 80, 4, 2, 192, {}),
    "window softcap G=2 D=256": (1, 100, 4, 2, 256,
                                 dict(window=30, softcap=5.0, q_boost=3.0)),
    "kv_len 70 of 100 not causal G=2 D=64": (1, 100, 4, 2, 64,
                                             dict(causal=False, kv_len=70)),
    "kv_len 50 of 80 causal G=2 D=256": (1, 80, 4, 2, 256, dict(kv_len=50)),
}


def draw(B, S, H, KVH, D, dtype, seed, q_boost=1.0):
    """q, k, v, dO as (JAX array, torch tensor) pairs of the same values."""
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, D), (B, S, KVH, D), (B, S, KVH, D), (B, S, H, D))
    out = []
    for i, shape in enumerate(shapes):
        x = rng.standard_normal(shape).astype(np.float32)
        if i == 0:
            x *= q_boost
        out.append((jnp.asarray(x, JNP[dtype]),
                    torch.from_numpy(x).to(TORCH[dtype])))
    return out


def jax_blocked_64(q, k, v, *, kv_len=None, **kw):
    """blocked_attention on the port's 64 x 64 tiles; a kv_len as its
    per-sequence kv_lengths."""
    if kv_len is not None:
        kw["kv_lengths"] = jnp.full((q.shape[0],), kv_len, jnp.int32)
    return jax_blocked(q, k, v, block_q=64, block_kv=64, **kw)


def jax_grads(qj, kj, vj, dj, **kw):
    def f(q, k, v):
        return jax_blocked_64(q, k, v, **kw)
    _, vjp = jax.vjp(f, qj, kj, vj)
    return [torch.from_numpy(np.array(g, np.float32)) for g in vjp(dj)]


@functools.lru_cache(maxsize=None)
def reference(case, dtype, uncapped=False):
    """The case's inputs and JAX's gradients (with the softcap dropped if
    ``uncapped``), computed once for both tests that use them."""
    shape, boost, kw = case_args(case)
    pairs = draw(*shape, dtype, 7, boost)
    if uncapped:
        kw = dict(kw, softcap=0.0)
    return pairs, jax_grads(*(j for j, _ in pairs), **kw)


def rel_err(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def case_args(case):
    B, S, H, KVH, D, kw = CASES[case]
    kw = dict(kw, scale=D ** -0.5)
    kw.setdefault("causal", True)
    boost = kw.pop("q_boost", 1.0)
    return (B, S, H, KVH, D), boost, kw


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(case, dtype):
    _, _, kw = case_args(case)
    ((_, qt), (_, kt), (_, vt), (_, dt)), want = reference(case, dtype)
    out, lse = FA.flash_attention_plain(qt, kt, vt, return_lse=True, **kw)
    got = FA.flash_attention_bwd_plain(qt, kt, vt, out, lse, dt, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TORCH[dtype] and g.shape == w.shape, name
        assert rel_err(g, w) < REL_TOL[dtype], (name, rel_err(g, w))
    if kw.get("softcap"):
        # the cap binds: without it the reference gradient moves ten
        # tolerances, so a backward that dropped the cap's factor fails
        _, uncapped = reference(case, dtype, uncapped=True)
        assert rel_err(uncapped[0], want[0]) > 10 * REL_TOL[dtype]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_fn_matches_jax_vjp(case, dtype):
    """The autograd path training takes: ops.flash_attention under grad
    goes through FlashAttentionFn (plain forward and backward on the CPU),
    with the forward's output the JAX reference's."""
    _, _, kw = case_args(case)
    ((qj, qt), (kj, kt), (vj, vt), (_, dt)), want = reference(case, dtype)
    q, k, v = (t.clone().requires_grad_() for t in (qt, kt, vt))
    out = ops.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None and "FlashAttentionFn" in \
        type(out.grad_fn).__name__
    ref = jax_blocked_64(qj, kj, vj, **kw)
    assert rel_err(out.detach(), torch.from_numpy(
        np.array(ref, np.float32))) < REL_TOL[dtype]
    got = torch.autograd.grad(out, (q, k, v), dt)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert rel_err(g, w) < REL_TOL[dtype], (name, rel_err(g, w))


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=20, softcap=3.0)],
                         ids=["causal", "noncausal", "window-softcap"])
def test_plain_lse_is_the_logsumexp_of_the_scores(kw):
    (_, q), (_, k), (_, v), _ = draw(2, 75, 4, 2, 64, "float32", 3)
    kw = dict(kw, scale=0.125)
    out, lse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, FA.flash_attention_plain(q, k, v, **kw))
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(2, dim=2)) * kw["scale"]
    if kw.get("softcap"):
        s = torch.tanh(s / kw["softcap"]) * kw["softcap"]
    pos = torch.arange(75)
    ok = torch.ones(75, 75, dtype=torch.bool)
    if kw["causal"]:
        ok &= pos[None] <= pos[:, None]
    if kw.get("window"):
        ok &= pos[None] > pos[:, None] - kw["window"]
    want = torch.logsumexp(torch.where(ok, s, -1e30), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def test_plain_backward_takes_kv_len():
    """The plain backward masks a kv_len as the forward does: keys past it
    get no gradient, and the rest equal autograd's through the forward."""
    (_, q), (_, k), (_, v), (_, d) = draw(1, 70, 4, 2, 64, "float32", 5)
    kw = dict(causal=False, scale=0.125, kv_len=50)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(FA.flash_attention_plain(qg, kg, vg, **kw),
                               (qg, kg, vg), d)
    out, lse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    got = FA.flash_attention_bwd_plain(q, k, v, out, lse, d, **kw)
    for g, w in zip(got, want):
        assert rel_err(g, w) < REL_TOL["float32"]
    assert float(got[1][:, 50:].abs().max()) == 0.0


# ------------------------------------------------------------- refusals
def _cpu_flash(requires_grad=True):
    (_, q), (_, k), (_, v), _ = draw(1, 16, 4, 2, 64, "float32", 1)
    return [t.requires_grad_(requires_grad) for t in (q, k, v)]


def test_refuse_grad_stand_in():
    """The check every CUDA wrapper runs first, on CPU tensors: it raises
    under grad on inputs that require grad, and only then."""
    q, k, v = _cpu_flash()
    with pytest.raises(RuntimeError, match="carries no gradient"):
        build.refuse_grad("kernel", q, k, v)
    build.refuse_grad("kernel", q.detach(), None)
    with torch.no_grad():
        build.refuse_grad("kernel", q, k, v)


def test_cuda_wrappers_refuse_autograd_before_the_device():
    """Outside FlashAttentionFn a kernel's output would silently drop the
    gradient on the card; the wrappers raise before anything else."""
    q, k, v = _cpu_flash()
    with pytest.raises(RuntimeError, match="flash_attention: .*no gradient"):
        FA.flash_attention_cuda(q, k, v, scale=0.1)
    with pytest.raises(RuntimeError, match="flash_attention_bwd: "):
        FA.flash_attention_bwd_cuda(q, k, v, q, torch.zeros(1, 4, 16), q,
                                    scale=0.1)
    kp = torch.zeros(4, 8, 2, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="paged_attention: "):
        PA.paged_attention_cuda(torch.zeros(2, 4, 64), kp, kp.detach(),
                                torch.zeros(2, 2, dtype=torch.int32),
                                torch.ones(2, dtype=torch.int32), scale=0.1)
    x = torch.zeros(1, 8, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan: "):
        SSD.ssd_scan_cuda(x, torch.zeros(1, 8, 2), torch.zeros(2),
                          torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16),
                          chunk=8)
    # without grad the same calls reach the device check
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(q, k, v, scale=0.1)


@pytest.mark.parametrize("D", FA.HEAD_DIMS)
def test_backward_takes_every_forward_head_dim(D):
    """The backward kernel takes every head dim the forward does, so
    FlashAttentionFn refuses none of them before the forward."""
    FA.check_bwd(torch.zeros(1, 8, 2, D))


@pytest.mark.parametrize("D", [16, 96])
def test_backward_refuses_a_head_dim_outside_them(D):
    with pytest.raises(ValueError, match=f"head_dim {D} not in"):
        FA.check_bwd(torch.zeros(1, 8, 2, D))
