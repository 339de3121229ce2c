"""The gradient of the port's SSD scan against JAX's.

The JAX model trains Mamba-2 through ``repro.models.mamba2.ssd_chunked``,
which XLA differentiates; the Pallas scan has no backward.  The port's
``ssd_scan_bwd_plain`` (the explicit formulas of
``csrc/ssd_scan_bwd.cu`` in plain torch, from the forward's inputs) and
``kernels.ops.SSDScanFn`` (the autograd path training takes, through
``ops.ssd_scan``) are held here against ``jax.vjp`` of ``ssd_chunked`` on
the same numpy-drawn inputs and cotangents (dy, dfinal), dfinal zero (as
in training) or not: with and without an initial state, a ragged tail,
S below the chunk, one group and several, head and state widths from
``DIMS``, fp32 and bf16.  ``ssd_scan_bwd_plain`` is also held against
``torch.autograd`` through ``ssd_scan_plain``, a second witness that does
not use JAX.

Tolerances, of each gradient's norm: 1e-4 in fp32 (the same fp32
arithmetic in another order; dcum's terms cancel, so ddt and dA keep
fewer of fp32's digits than dx), 2e-2 in bf16 (the reference rounds the
cotangents of its bf16 intermediates, the repeated B and C among them,
to bf16, where the port keeps every sum in fp32 and rounds dx, dB and dC
once), as ``tests/test_torch_flash_bwd.py``.  The kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py``).

Also here: the CPU-side refusals of the backward's wrapper and of
``check_bwd``, and the bf16 kernel's operand rounding, emulated.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SSD

torch.set_num_threads(2)

REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")

# name -> (B, S, H, P, G, N, chunk, initial state, dfinal not zero)
CASES = {
    "G=1 P=N=16": (2, 64, 2, 16, 1, 16, 16, False, False),
    "ragged tail G=2 P=N=32": (2, 70, 4, 32, 2, 32, 32, False, False),
    "initial state and dfinal, P=64 N=128": (1, 40, 2, 64, 1, 128, 16, True,
                                             True),
    "S < chunk, initial state and dfinal": (1, 20, 2, 32, 1, 32, 256, True,
                                            True),
    "ragged tail G=2 P=128 N=64, initial state": (1, 100, 4, 128, 2, 64, 32,
                                                  True, False),
    "mamba2-780m .reduced()": (2, 100, 16, 16, 1, 16, 32, False, False),
    "G=4 P=16 N=128, dfinal": (1, 50, 8, 16, 4, 128, 16, False, True),
    "initial state, dfinal zero": (2, 48, 4, 32, 2, 16, 16, True, False),
}


def draw(case, dtype):
    """The forward's inputs (x, dt, A, Bm, Cm, initial state or None) and
    the cotangents (dy, dfinal), as numpy float32 arrays:
    ``tests/test_kernels.py``'s SSD inputs (softplus dt, A < 0,
    B/C * 0.5)."""
    B, S, H, P, G, N, _, init, dfin = CASES[case]
    rng = np.random.default_rng(S + H + P + N)
    ins = [rng.standard_normal((B, S, H, P)),
           np.logaddexp(0.0, rng.standard_normal((B, S, H))),
           -np.exp(rng.standard_normal(H) * 0.3),
           rng.standard_normal((B, S, G, N)) * 0.5,
           rng.standard_normal((B, S, G, N)) * 0.5,
           rng.standard_normal((B, H, P, N)) if init else None]
    dy = rng.standard_normal((B, S, H, P))
    dfinal = (rng.standard_normal((B, H, P, N)) if dfin
              else np.zeros((B, H, P, N)))
    f32 = [None if a is None else a.astype(np.float32)
           for a in (*ins, dy, dfinal)]
    if dtype == "bfloat16":     # x, B, C and dy as the values bf16 holds
        for i in (0, 3, 4, 6):
            f32[i] = np.asarray(jnp.asarray(f32[i], jnp.bfloat16),
                                np.float32)
    return f32


def to_torch(arrs, dtype):
    low = (0, 3, 4, 6)                 # x, B, C, dy in the model's dtype
    return [None if a is None else
            torch.from_numpy(a.copy()).to(TORCH[dtype] if i in low
                                          else torch.float32)
            for i, a in enumerate(arrs)]


@functools.lru_cache(maxsize=None)
def reference(case, dtype):
    """JAX's gradients, as float32 torch tensors (dinit None without an
    initial state), computed once for every test that uses them."""
    chunk, init = CASES[case][6], CASES[case][7]
    x, dt, A, Bm, Cm, st, dy, dfinal = draw(case, dtype)
    low = JNP[dtype]
    prim = [jnp.asarray(x, low), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, low), jnp.asarray(Cm, low)]
    if init:
        prim.append(jnp.asarray(st))

    def f(x, dt, A, Bm, Cm, st=None):
        return jax_ssd_chunked(x, dt, A, Bm, Cm, chunk, initial_state=st)
    _, vjp = jax.vjp(f, *prim)
    grads = vjp((jnp.asarray(dy, low), jnp.asarray(dfinal)))
    out = [torch.from_numpy(np.array(g, np.float32)) for g in grads]
    return out + [None] * (6 - len(out))


def rel_err(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def assert_grads(got, want, dtype, dtypes):
    for name, g, w, dt in zip(GRADS, got, want, dtypes):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == dt and g.shape == w.shape, (name, g.dtype, g.shape)
        assert rel_err(g, w) < REL_TOL[dtype], (name, rel_err(g, w))


def grad_dtypes(dtype):
    low, f32 = TORCH[dtype], torch.float32
    return (low, f32, f32, low, low, f32)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(case, dtype):
    x, dt, A, Bm, Cm, st, dy, dfinal = to_torch(draw(case, dtype), dtype)
    got = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dfinal,
                                 chunk=CASES[case][6], initial_state=st)
    assert_grads(got, reference(case, dtype), dtype, grad_dtypes(dtype))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_fn_matches_jax_vjp(case, dtype):
    """The autograd path training takes: ops.ssd_scan under grad goes
    through SSDScanFn (plain forward and backward on the CPU)."""
    x, dt, A, Bm, Cm, st, dy, dfinal = to_torch(draw(case, dtype), dtype)
    ins = [t.requires_grad_() for t in (x, dt, A, Bm, Cm, st)
           if t is not None]
    y, final = ops.ssd_scan(*ins[:5], chunk=CASES[case][6],
                            initial_state=ins[5] if st is not None else None)
    assert y.grad_fn is not None and "SSDScanFn" in type(y.grad_fn).__name__
    got = torch.autograd.grad((y, final), ins, (dy, dfinal))
    assert_grads([*got] + [None] * (6 - len(got)), reference(case, dtype),
                 dtype, grad_dtypes(dtype))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_torch_autograd(case, dtype):
    """The second witness: autograd through ssd_scan_plain, whose three
    steps share no code with the backward's formulas."""
    x, dt, A, Bm, Cm, st, dy, dfinal = to_torch(draw(case, dtype), dtype)
    chunk = CASES[case][6]
    ins = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, st)
           if t is not None]
    y, final = SSD.ssd_scan_plain(*ins[:5], chunk=chunk,
                                  initial_state=ins[5] if st is not None
                                  else None)
    want = torch.autograd.grad((y, final), ins, (dy, dfinal))
    got = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dfinal, chunk=chunk,
                                 initial_state=st)
    assert_grads(got, [*want] + [None] * (6 - len(want)), dtype,
                 grad_dtypes(dtype))


def test_unused_final_state_is_a_zero_gradient():
    """Training uses y alone: SSDScanFn's backward gets the final state's
    gradient as zeros, the same gradients as dfinal = 0 given."""
    case = "ragged tail G=2 P=N=32"
    x, dt, A, Bm, Cm, st, dy, _ = to_torch(draw(case, "float32"), "float32")
    ins = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, _ = ops.ssd_scan(*ins, chunk=CASES[case][6])
    got = torch.autograd.grad(y, ins, dy)
    want = SSD.ssd_scan_bwd_plain(x.detach(), dt.detach(), A.detach(),
                                  Bm.detach(), Cm.detach(), dy,
                                  torch.zeros(2, 4, 32, 32),
                                  chunk=CASES[case][6])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------- refusals
def _cpu_inputs(requires_grad=False):
    x, dt, A, Bm, Cm, _, dy, dfinal = to_torch(
        draw("G=1 P=N=16", "float32"), "float32")
    return [t.requires_grad_(requires_grad) for t in (x, dt, A, Bm, Cm)], dy


def test_bwd_wrapper_refuses_autograd_before_the_device():
    """Outside SSDScanFn the backward's output would carry no gradient; the
    wrapper raises under autograd before anything else."""
    ins, dy = _cpu_inputs(requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan_bwd: .*no gradient"):
        SSD.ssd_scan_bwd_cuda(*ins, dy, chunk=16)
    with pytest.raises(RuntimeError, match="ssd_scan: .*no gradient"):
        SSD.ssd_scan_cuda(*ins, chunk=16)


def test_bwd_wrapper_refuses_cpu_tensors():
    ins, dy = _cpu_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_scan_bwd_cuda(*ins, dy, chunk=16)


@pytest.mark.parametrize("P,N", [(16, 16), (64, 128), (128, 32)])
def test_backward_takes_every_forward_width(P, N):
    SSD.check_bwd(torch.zeros(1, 8, 2, P), torch.zeros(1, 8, 1, N))


@pytest.mark.parametrize("P,N", [(8, 16), (64, 96), (256, 128)])
def test_backward_refuses_a_width_outside_them(P, N):
    with pytest.raises(ValueError, match="head_dim .* not in"):
        SSD.check_bwd(torch.zeros(1, 8, 2, P), torch.zeros(1, 8, 1, N))


def test_backward_refuses_half():
    with pytest.raises(TypeError, match="ssd_scan_bwd: x is torch.float16"):
        SSD.check_bwd(torch.zeros(1, 8, 2, 16, dtype=torch.float16),
                      torch.zeros(1, 8, 1, 16, dtype=torch.float16))


@pytest.mark.parametrize("H,G,dtype,heads", [
    (48, 1, torch.bfloat16, 8),      # mamba2-780m
    (256, 1, torch.bfloat16, 8),     # jamba-1.5-large
    (8, 2, torch.bfloat16, 4),
    (4, 2, torch.bfloat16, 2),
    (6, 2, torch.bfloat16, 1),
    (48, 1, torch.float32, 1),       # fp32: one head a rows block
])
def test_backward_workspace_follows_the_kernels_rules(H, G, dtype, heads):
    """The wrapper sizes the workspace by csrc/ssd_scan_bwd.cu's rules: a
    bf16 rows block sums dB and dC over the most heads of its group, up
    to 8, that divide the group; fp32 writes one partial a head; the
    state pass writes one partial of <G_c, S_c> a 1024 values of [P, N];
    bf16 adds the states' high and low tiles."""
    assert SSD.bwd_heads_per_block(H, G, dtype) == heads
    B, S, P, N, chunk = 2, 300, 64, 128, 128
    slots = B * H * 3                # 3 chunks of at most 128 rows
    tiles = 2 * slots * P * N if dtype == torch.bfloat16 else 0
    assert SSD.bwd_state_split(P, N) == 8
    assert SSD.bwd_workspace_floats(B, S, H, G, P, N, chunk, dtype) == (
        tiles + 2 * slots * P * N + 2 * B * S * (H // heads) * N
        + 2 * slots * chunk + slots * 8)


def test_reset_zeroes_the_backward_variant_counts():
    SSD.ssd_scan_bwd_cuda.variant_launches["wgmma"] = 3
    ops.reset_launch_counts()
    assert SSD.ssd_scan_bwd_cuda.variant_launches == {"wgmma": 0,
                                                      "cuda_core": 0}


# ------------------------------------------- the bf16 kernel's rounding
def split_bf16(t):
    """An fp32 operand as the bf16 kernel's two operands: the high part
    and the low part of what it leaves, each back in fp32.  A bf16 value
    splits into itself and zero."""
    hi = t.to(torch.bfloat16).float()
    return [hi, (t - hi).to(torch.bfloat16).float()]


# the einsums of ssd_scan_bwd_plain that the kernel does in fp32 and not as
# products on the tensor cores: the row scales of the state terms
ROW_SCALES = ("bcjgr,bcjgrn->bcjgn", "bcigr,bcigrn->bcign")


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [
    (2, 100, 16, 16, 1, 16, 32),       # mamba2-780m .reduced()
    (1, 512, 48, 64, 1, 128, 256),     # mamba2-780m's heads at full width
], ids=["reduced", "full-width-heads"])
def test_backward_operand_rounding_inside_the_card_tolerance(
        monkeypatch, B, S, H, P, G, N, chunk):
    """The bf16 backward kernel takes x, B, C and dy exactly as they
    arrive and splits every other operand of a product (the decayed
    weights, the states S_{c-1} and their gradients G_c, W) into a bf16
    high and low part.  Emulated here by running ssd_scan_bwd_plain with
    each product's first operand taken as those parts (C in C Bᵀ and dy in
    dy xᵀ split into themselves and zero): every gradient stays inside the
    card's tolerance against the fp32 plain version, 1e-2 of its norm and
    dA 1e-3 (chip_smoke.py, tests/test_torch_cuda.py).  Prints the shares
    of each tolerance, also with the low parts dropped (not asserted: the
    kernel forms dcum as dy·y − dt x·br, which these plain formulas do not,
    and on the card the weights' high parts alone left dA far outside its
    bound)."""
    rng = np.random.default_rng(S + H + P + N)
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(dtype)
    x = t(rng.standard_normal((B, S, H, P)), bf)
    dt = t(np.logaddexp(0.0, rng.standard_normal((B, S, H))))
    A = t(-np.exp(rng.standard_normal(H) * 0.3))
    Bm = t(rng.standard_normal((B, S, G, N)) * 0.5, bf)
    Cm = t(rng.standard_normal((B, S, G, N)) * 0.5, bf)
    st = t(rng.standard_normal((B, H, P, N)))
    dy = t(rng.standard_normal((B, S, H, P)), bf)
    dfinal = t(rng.standard_normal((B, H, P, N)))
    args = (x, dt, A, Bm, Cm, dy, dfinal)
    kw = dict(chunk=chunk, initial_state=st)
    want = SSD.ssd_scan_bwd_plain(*args, **kw)
    einsum = torch.einsum
    shares = {}
    for name, split in [("hi+lo", split_bf16),
                        ("hi only", lambda a: split_bf16(a)[:1])]:
        def split_einsum(eq, a, b, split=split):
            if eq in ROW_SCALES:
                return einsum(eq, a, b)
            return sum(einsum(eq, part, b) for part in split(a))
        with monkeypatch.context() as m:
            m.setattr(torch, "einsum", split_einsum)
            got = SSD.ssd_scan_bwd_plain(*args, **kw)
        shares[name] = {
            grad: rel_err(g, w) / (1e-3 if grad == "dA" else 1e-2)
            for grad, g, w in zip(GRADS, got, want)}
    print(f"SSD backward operand rounding [{B},{S},{H},{P}] N={N} "
          f"chunk={chunk}, share of the card's tolerance: " + "; ".join(
              f"{k}: " + ", ".join(f"{g} {v:.3g}" for g, v in m.items())
              for k, m in shares.items()))
    assert max(shares["hi+lo"].values()) < 1, shares
