"""The port's attention kernels against the JAX package's.

Each plain version (``repro_torch.kernels.*_plain``, the CPU side of the
kernel's dispatch) and each ported oracle (``repro_torch.kernels.ref``) is
held against the JAX oracles (``repro.kernels.ref``) and the Pallas kernels
run in ``interpret=True``, on the sweeps of ``tests/test_kernels.py``.
Inputs are drawn with numpy and handed to both frameworks.

Tolerances follow ``tests/test_kernels.py::tol_for``: 2e-5 in fp32 (both
sides compute in fp32, in another summation order), 2e-2 in bf16 (both
sides round the fp32 result to bf16, so they may differ by one bf16 step).
The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``
holds them against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import paged_attention as jax_paged
from repro.kernels import ref as JR
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref as TR

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol_for(dtype_name):
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(x, dtype_name="float32"):
    """One numpy array as a JAX array and a torch tensor of the same
    dtype (bf16 rounds the same fp32 values on both sides)."""
    jd, td = DTYPES[dtype_name]
    x = np.asarray(x)
    if x.dtype.kind in "iu":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    x = x.astype(np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x.copy()).to(td)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **tol)


# q's scale in the softcap cases: bf16 scores of std ~30 pass the cap of 50
# by far; fp32 ones of std ~4 move the output by ten of fp32's tolerances
# (at std ~30 the fp32 scores' own rounding, about 1e-4 of 50, would pass
# 2e-5)
CAP_BOOST = {"float32": 4.0, "bfloat16": 30.0}


def assert_cap_binds(capped, uncapped, dtype_name):
    """The plain version with the softcap and without it differ by ten
    tolerances or more, elementwise and in norm (1e-2 of the norm in bf16,
    2e-5 in fp32, as ``tests/test_torch_cuda.py`` holds the kernels)."""
    c, u = capped.float(), uncapped.float()
    rel = {"float32": 2e-5, "bfloat16": 1e-2}[dtype_name]
    assert float((u - c).norm() / c.norm()) > 10 * rel
    assert float((u - c).abs().max()) > 10 * tol_for(dtype_name)["atol"]


# ---------------------------------------------------------------- paged
def paged_case(rng, B, H, KVH, D, ps, maxp, *, dtype="float32", lengths=None,
               scale_q=1.0, permute=True):
    P = B * maxp + (1 if permute else 0)
    q = rng.standard_normal((B, H, D)) * scale_q
    kp = rng.standard_normal((P, ps, KVH, D))
    vp = rng.standard_normal((P, ps, KVH, D))
    order = rng.permutation(P) if permute else np.arange(P)
    pt = order[:B * maxp].reshape(B, maxp).astype(np.int32)
    if lengths is None:
        lengths = [1 + (i * 7) % (ps * maxp) for i in range(B)]
    ln = np.asarray(lengths, np.int32)
    return [both(a, dtype) for a in (q, kp, vp)] + [both(pt), both(ln)]


@pytest.mark.parametrize("B,H,KVH,D,ps,maxp", [
    (2, 4, 1, 32, 8, 3),
    (3, 8, 2, 64, 16, 4),
    (1, 12, 4, 128, 32, 2),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_sweep(B, H, KVH, D, ps, maxp, dtype):
    args = paged_case(np.random.default_rng(B * 100 + D), B, H, KVH, D, ps,
                      maxp, dtype=dtype)
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    scale = D ** -0.5
    want = JR.ref_paged_attention(*jargs, scale=scale)
    pallas = jax_paged(*jargs, scale=scale, interpret=True)
    plain = PA.paged_attention_plain(*targs, scale=scale)
    oracle = TR.ref_paged_attention(*targs, scale=scale)
    for got in (plain, oracle):
        assert got.dtype == DTYPES[dtype][1] and got.shape == (B, H, D)
        close(got, want, **tol_for(dtype))
        close(got, pallas, **tol_for(dtype))


def test_paged_attention_softcap():
    args = paged_case(np.random.default_rng(3), 2, 4, 2, 32, 8, 3,
                      lengths=[20, 9], scale_q=3.0, permute=False)
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    kw = dict(scale=0.2, softcap=30.0)
    want = JR.ref_paged_attention(*jargs, **kw)
    pallas = jax_paged(*jargs, interpret=True, **kw)
    for got in (PA.paged_attention_plain(*targs, **kw),
                TR.ref_paged_attention(*targs, **kw)):
        close(got, want, rtol=2e-5, atol=2e-5)
        close(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_head_dim_256(softcap, dtype):
    """gemma2-2b's decode heads: head_dim 256, G = 2, its softcap 50."""
    args = paged_case(np.random.default_rng(256), 3, 8, 4, 256, 16, 4,
                      dtype=dtype, lengths=[64, 17, 1], scale_q=3.0)
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    kw = dict(scale=256 ** -0.5, softcap=softcap)
    want = JR.ref_paged_attention(*jargs, **kw)
    pallas = jax_paged(*jargs, interpret=True, **kw)
    for got in (PA.paged_attention_plain(*targs, **kw),
                TR.ref_paged_attention(*targs, **kw)):
        assert got.dtype == DTYPES[dtype][1] and got.shape == (3, 8, 256)
        close(got, want, **tol_for(dtype))
        close(got, pallas, **tol_for(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_head_dim_256_softcap_binds(dtype):
    """q scaled by CAP_BOOST: the scores pass gemma2-2b's softcap of 50,
    so the cap moves the output far past the tolerance; with it, the plain
    version and ref.py match the JAX oracle and the Pallas kernel."""
    args = paged_case(np.random.default_rng(257), 3, 8, 4, 256, 16, 4,
                      dtype=dtype, lengths=[64, 17, 9],
                      scale_q=CAP_BOOST[dtype])
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    kw = dict(scale=256 ** -0.5, softcap=50.0)
    want = JR.ref_paged_attention(*jargs, **kw)
    pallas = jax_paged(*jargs, interpret=True, **kw)
    plain = PA.paged_attention_plain(*targs, **kw)
    assert_cap_binds(plain, PA.paged_attention_plain(*targs,
                                                     scale=kw["scale"]),
                     dtype)
    for got in (plain, TR.ref_paged_attention(*targs, **kw)):
        close(got, want, **tol_for(dtype))
        close(got, pallas, **tol_for(dtype))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_head_dim_192(softcap, dtype):
    """nemotron-4-340b's decode heads: head_dim 192, G = 12 (12 query
    heads over one KV head), ragged lengths over permuted pages."""
    args = paged_case(np.random.default_rng(192), 3, 12, 1, 192, 16, 4,
                      dtype=dtype, lengths=[64, 17, 1], scale_q=3.0)
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    kw = dict(scale=192 ** -0.5, softcap=softcap)
    want = JR.ref_paged_attention(*jargs, **kw)
    pallas = jax_paged(*jargs, interpret=True, **kw)
    for got in (PA.paged_attention_plain(*targs, **kw),
                TR.ref_paged_attention(*targs, **kw)):
        assert got.dtype == DTYPES[dtype][1] and got.shape == (3, 12, 192)
        close(got, want, **tol_for(dtype))
        close(got, pallas, **tol_for(dtype))


# ---------------------------------------------------------------- flash
def flash_case(rng, B, S, H, KVH, D, dtype="float32", T=None):
    T = T or S
    return [both(rng.standard_normal(shape), dtype) for shape in
            ((B, S, H, D), (B, T, KVH, D), (B, T, KVH, D))]


@pytest.mark.parametrize("S,H,KVH,D,bq,bk", [
    (64, 4, 2, 32, 16, 16),
    (100, 4, 4, 64, 32, 16),   # ragged tail
    (33, 8, 2, 128, 16, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(S, H, KVH, D, bq, bk, dtype):
    args = flash_case(np.random.default_rng(S + D), 2, S, H, KVH, D, dtype)
    (qj, kj, vj), (qt, kt, vt) = zip(*args)
    scale = D ** -0.5
    want = JR.ref_flash_attention(qj, kj, vj, scale=scale, causal=True)
    pallas = jax_flash(qj, kj, vj, scale=scale, block_q=bq, block_kv=bk,
                       interpret=True)
    for got in (FA.flash_attention_plain(qt, kt, vt, scale=scale),
                TR.ref_flash_attention(qt, kt, vt, scale=scale)):
        assert got.dtype == DTYPES[dtype][1] and got.shape == qt.shape
        close(got, want, **tol_for(dtype))
        close(got, pallas, **tol_for(dtype))


@pytest.mark.parametrize("window,softcap,causal", [
    (16, 0.0, True), (0, 25.0, True), (16, 25.0, True), (0, 0.0, False)])
def test_flash_attention_variants(window, softcap, causal):
    args = flash_case(np.random.default_rng(window + int(softcap)), 1, 80, 4,
                      2, 32)
    (qj, kj, vj), (qt, kt, vt) = zip(*args)
    kw = dict(scale=0.2, causal=causal, window=window, softcap=softcap)
    want = JR.ref_flash_attention(qj, kj, vj, **kw)
    pallas = jax_flash(qj, kj, vj, block_q=16, block_kv=16, interpret=True,
                       **kw)
    for got in (FA.flash_attention_plain(qt, kt, vt, **kw),
                TR.ref_flash_attention(qt, kt, vt, **kw)):
        close(got, want, rtol=2e-5, atol=2e-5)
        close(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window,softcap,causal", [
    (0, 0.0, True), (24, 0.0, True), (0, 50.0, True), (24, 50.0, True),
    (0, 50.0, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256(window, softcap, causal, dtype):
    """gemma2-2b's prefill heads: head_dim 256, G = 2, its softcap 50 and a
    window (24 here) that binds inside the 70-token prompt."""
    args = flash_case(np.random.default_rng(window + int(softcap)), 1, 70,
                      8, 4, 256, dtype)
    (qj, kj, vj), (qt, kt, vt) = zip(*args)
    kw = dict(scale=256 ** -0.5, causal=causal, window=window,
              softcap=softcap)
    want = JR.ref_flash_attention(qj, kj, vj, **kw)
    pallas = jax_flash(qj, kj, vj, block_q=32, block_kv=32, interpret=True,
                       **kw)
    for got in (FA.flash_attention_plain(qt, kt, vt, **kw),
                TR.ref_flash_attention(qt, kt, vt, **kw)):
        assert got.dtype == DTYPES[dtype][1] and got.shape == qt.shape
        close(got, want, **tol_for(dtype))
        close(got, pallas, **tol_for(dtype))


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256_softcap_binds(window, dtype):
    """q scaled by CAP_BOOST: the scores pass gemma2-2b's softcap of 50,
    so the cap moves the output far past the tolerance; with it, the plain
    version and ref.py match the JAX oracle and the Pallas kernel."""
    rng = np.random.default_rng(270 + window)
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.standard_normal(shape) * boost, dtype)
        for shape, boost in (((1, 70, 8, 256), CAP_BOOST[dtype]),
                             ((1, 70, 4, 256), 1.0),
                             ((1, 70, 4, 256), 1.0)))
    kw = dict(scale=256 ** -0.5, causal=True, window=window, softcap=50.0)
    want = JR.ref_flash_attention(qj, kj, vj, **kw)
    pallas = jax_flash(qj, kj, vj, block_q=32, block_kv=32, interpret=True,
                       **kw)
    plain = FA.flash_attention_plain(qt, kt, vt, **kw)
    assert_cap_binds(plain, FA.flash_attention_plain(
        qt, kt, vt, **dict(kw, softcap=0.0)), dtype)
    for got in (plain, TR.ref_flash_attention(qt, kt, vt, **kw)):
        close(got, want, **tol_for(dtype))
        close(got, pallas, **tol_for(dtype))


@pytest.mark.parametrize("window,causal", [(0, True), (24, True),
                                           (0, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_192(window, causal, dtype):
    """nemotron-4-340b's prefill heads: head_dim 192, G = 12 (12 query
    heads over one KV head), a 70-token prompt across the 64-row tiles,
    causal, windowed and not causal."""
    args = flash_case(np.random.default_rng(192 + window), 1, 70, 12, 1,
                      192, dtype)
    (qj, kj, vj), (qt, kt, vt) = zip(*args)
    kw = dict(scale=192 ** -0.5, causal=causal, window=window)
    want = JR.ref_flash_attention(qj, kj, vj, **kw)
    pallas = jax_flash(qj, kj, vj, block_q=32, block_kv=32, interpret=True,
                       **kw)
    for got in (FA.flash_attention_plain(qt, kt, vt, **kw),
                TR.ref_flash_attention(qt, kt, vt, **kw)):
        assert got.dtype == DTYPES[dtype][1] and got.shape == qt.shape
        close(got, want, **tol_for(dtype))
        close(got, pallas, **tol_for(dtype))


@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129])
def test_flash_attention_tile_edges(S):
    """Prompt lengths at the edges of the kernels' 64-key and 128-row
    tiles."""
    args = flash_case(np.random.default_rng(S), 1, S, 4, 2, 32)
    (qj, kj, vj), (qt, kt, vt) = zip(*args)
    want = JR.ref_flash_attention(qj, kj, vj, scale=0.3, causal=True)
    close(FA.flash_attention_plain(qt, kt, vt, scale=0.3), want,
          rtol=2e-5, atol=2e-5)


def test_flash_attention_kv_len():
    """kv_len masks the keys' tail (the Pallas wrapper's padding mask)."""
    args = flash_case(np.random.default_rng(5), 1, 48, 4, 2, 64, T=100)
    (qj, kj, vj), (qt, kt, vt) = zip(*args)
    kw = dict(scale=0.2, causal=False, kv_len=70)
    want = JR.ref_flash_attention(qj, kj, vj, **kw)
    for got in (FA.flash_attention_plain(qt, kt, vt, **kw),
                TR.ref_flash_attention(qt, kt, vt, **kw)):
        close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_matches_blocked_attention():
    """Cross-check (tests/test_kernels.py::test_kernels_match_model_layers):
    the flash plain version agrees with the port's blocked_attention and
    with the JAX model's blocked_attention."""
    from repro.models.layers import blocked_attention as jax_blocked
    from repro_torch.models.layers import blocked_attention
    args = flash_case(np.random.default_rng(11), 1, 48, 4, 2, 32)
    (qj, kj, vj), (qt, kt, vt) = zip(*args)
    a = FA.flash_attention_plain(qt, kt, vt, scale=0.25)
    b = blocked_attention(qt, kt, vt, causal=True, scale=0.25, block_q=16,
                          block_kv=16)
    c = jax_blocked(qj, kj, vj, causal=True, scale=0.25, block_q=16,
                    block_kv=16)
    close(a, b.numpy(), rtol=2e-5, atol=2e-5)
    close(a, c, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------- dispatch
def test_ops_dispatch_cpu_goes_to_plain_versions():
    """CPU tensors take the plain versions and launch nothing."""
    ops.reset_launch_counts()
    _, (qt, kt, vt) = zip(*flash_case(np.random.default_rng(1), 1, 20, 4, 2,
                                      32))
    out = ops.flash_attention(qt, kt, vt, scale=0.3)
    assert torch.equal(out, FA.flash_attention_plain(qt, kt, vt, scale=0.3))
    targs = [a[1] for a in paged_case(np.random.default_rng(2), 2, 4, 2, 32,
                                      8, 3)]
    out = ops.paged_attention(*targs, scale=0.3)
    assert torch.equal(out, PA.paged_attention_plain(*targs, scale=0.3))
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "paged_attention": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0}


def test_reset_zeroes_the_counts_by_kind():
    """Each wrapper keeps counts by kind beside ``.launches`` (flash by
    window, paged by slot-cache capacity, the SSD scan by variant, and
    flash's launches that were not causal); the reset zeroes them all and
    keeps the SSD scan's variant names."""
    assert set(ops.KIND_COUNTS) == set(ops.CUDA_WRAPPERS)
    for name, fn in ops.CUDA_WRAPPERS.items():
        fn.launches = 3
        getattr(fn, ops.KIND_COUNTS[name])[7] = 3
    FA.flash_attention_cuda.noncausal_launches = 3
    ops.reset_launch_counts()
    assert FA.flash_attention_cuda.noncausal_launches == 0
    for name, fn in ops.CUDA_WRAPPERS.items():
        assert fn.launches == 0
        kinds = getattr(fn, ops.KIND_COUNTS[name])
        assert set(kinds.values()) == {0}
        del kinds[7]
    assert set(ops.CUDA_WRAPPERS["ssd_scan"].variant_launches) == {
        "wgmma", "cuda_core"}


def test_cuda_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers check their inputs before any build or launch."""
    _, (qt, kt, vt) = zip(*flash_case(np.random.default_rng(1), 1, 20, 4, 2,
                                      32))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_cuda(qt, kt, vt, scale=0.3)
    targs = [a[1] for a in paged_case(np.random.default_rng(2), 2, 4, 2, 32,
                                      8, 3)]
    with pytest.raises(ValueError, match="CUDA"):
        PA.paged_attention_cuda(*targs, scale=0.3)
    with pytest.raises(ValueError, match="all lie on the CPU"):
        ops.flash_attention(qt, kt.to("meta"), vt, scale=0.3)
