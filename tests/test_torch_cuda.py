"""The port's CUDA kernels against their plain versions, on an NVIDIA card.

Every test here needs a card and skips without one: the kernels have no
interpret mode.  The file imports neither JAX nor the JAX package, so it
also runs on a machine that has only PyTorch; from the repository root:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Tolerances follow ``tests/test_kernels.py::tol_for``: 2e-5 in fp32 (the
same fp32 arithmetic in another summation order) and 2e-2 in bf16 (both
sides round the fp32 result to bf16, so they may differ by a bf16 step).
At gemma2-2b's head_dim 256 and nemotron-4-340b's 192 the error is also
held to 1e-2 (bf16) or 2e-5 (fp32) of the output's norm, since outputs
averaged over thousands of keys are about as small as the 2e-2 bound;
and cases whose q is scaled
(bf16 by 30, scores of std ~30 past the softcap of 50; fp32 by 4, as
far as fp32's own rounding of the scores stays inside 2e-5) make the plain
version without the cap differ by ten tolerances or more, so a kernel that
dropped the cap could not pass.
The SSD scan takes 1e-3 in fp32, as ``tests/test_kernels.py`` does for
it: its prefix sums and chunk products are summed in another order.
"""
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ssd_scan as SSD

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol_for(dtype_name):
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernels have "
                    "no interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def on(dev, x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dev, dtype)


def close(got, want, **tol):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), **tol)


REL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
CAP_BOOST = {"float32": 4.0, "bfloat16": 30.0}


def rel_err(got, want):
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def rel_close(got, want, dtype_name):
    """||got - want|| within REL_TOL of ||want||."""
    assert rel_err(got, want) < REL_TOL[dtype_name], rel_err(got, want)


def assert_cap_binds(want, uncapped, dtype_name):
    """The plain output with the softcap and without it differ by ten
    tolerances or more, elementwise and in norm."""
    assert rel_err(uncapped, want) > 10 * REL_TOL[dtype_name]
    assert float((uncapped.float() - want.float()).abs().max()) > \
        10 * tol_for(dtype_name)["atol"]


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,H,KVH,D,kw", [
    (64, 64, 4, 2, 32, {}),
    (100, 100, 4, 4, 64, {}),                    # ragged tail
    (33, 33, 8, 2, 128, {}),
    (80, 80, 4, 2, 32, dict(window=16)),
    (80, 80, 4, 2, 32, dict(softcap=25.0)),
    (80, 80, 4, 2, 32, dict(causal=False)),
    (48, 100, 4, 2, 64, dict(causal=False, kv_len=70)),
    (300, 300, 16, 16, 128, {}),                 # olmo-1b's heads
    (891, 891, 16, 16, 128, {}),                 # the main prefill shape
    (1, 1, 4, 2, 128, {}),                       # the 64-row tile edges
    (63, 63, 4, 2, 128, {}),
    (64, 64, 4, 2, 128, {}),
    (65, 65, 4, 2, 128, {}),
    (129, 129, 4, 2, 128, {}),
    (80, 80, 4, 2, 32, dict(window=16, softcap=25.0)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_plain(cuda, S, T, H, KVH, D, kw, dtype):
    rng = np.random.default_rng(S + T + D)
    q = on(cuda, rng.standard_normal((2, S, H, D)), DTYPES[dtype])
    k = on(cuda, rng.standard_normal((2, T, KVH, D)), DTYPES[dtype])
    v = on(cuda, rng.standard_normal((2, T, KVH, D)), DTYPES[dtype])
    before = FA.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, scale=D ** -0.5, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention_cuda.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    close(got, FA.flash_attention_plain(q, k, v, scale=D ** -0.5, **kw),
          **tol_for(dtype))


MASKS = {"causal": {}, "window": dict(window=256),
         "softcap": dict(softcap=50.0),
         "window-softcap": dict(window=100, softcap=50.0),
         "noncausal": dict(causal=False),
         "kv_len": dict(causal=False, kv_len=2 / 3)}   # of the keys


@pytest.mark.cuda
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("S", [142, 404, 891])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_attention_tensor_cores_at_model_width(cuda, D, S, mask):
    """The bf16 (wgmma) kernel at olmo-1b's 16 heads, at the engine's
    shortest, a middle and its longest prompt, under every mask: the P V
    product's shared-memory descriptors differ between D = 64 and 128."""
    kw = dict(MASKS[mask])
    if "kv_len" in kw:
        kw["kv_len"] = int(S * kw["kv_len"])
    rng = np.random.default_rng(S + D)
    q, k, v = (on(cuda, rng.standard_normal((1, S, 16, D)), torch.bfloat16)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, scale=D ** -0.5, **kw)
    torch.cuda.synchronize()
    close(got, FA.flash_attention_plain(q, k, v, scale=D ** -0.5, **kw),
          **tol_for("bfloat16"))


# gemma2-2b's attention: head_dim 256, 8 query heads over 4 KV heads
D256_MASKS = {"causal": {}, "window": dict(window=40),
              "softcap": dict(softcap=50.0),
              "window-softcap": dict(window=40, softcap=50.0),
              "noncausal": dict(causal=False),
              "noncausal-softcap": dict(causal=False, softcap=50.0),
              "kv_len": dict(causal=False, kv_len=2 / 3)}   # of the keys


@pytest.mark.cuda
@pytest.mark.parametrize("mask", list(D256_MASKS))
@pytest.mark.parametrize("S", [1, 63, 64, 65, 129, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256(cuda, S, mask, dtype):
    """Both kernels at head_dim 256 (bf16: the m64n256k16 P V product over
    four 128-byte swizzled column blocks; fp32: 210 KB of shared memory),
    at the 64-row tile edges, under every mask, with G = 2."""
    kw = dict(D256_MASKS[mask])
    if "kv_len" in kw:
        kw["kv_len"] = max(1, int(S * kw["kv_len"]))
    rng = np.random.default_rng(S + 256)
    q = on(cuda, rng.standard_normal((2, S, 8, 256)), DTYPES[dtype])
    k = on(cuda, rng.standard_normal((2, S, 4, 256)), DTYPES[dtype])
    v = on(cuda, rng.standard_normal((2, S, 4, 256)), DTYPES[dtype])
    before = FA.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, scale=256 ** -0.5, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention_cuda.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = FA.flash_attention_plain(q, k, v, scale=256 ** -0.5, **kw)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("S,window,dtype", [
    (65, 0, "float32"), (65, 40, "float32"), (129, 0, "float32"),
    (65, 0, "bfloat16"), (65, 40, "bfloat16"), (129, 0, "bfloat16"),
    (129, 40, "bfloat16"), (300, 0, "bfloat16"), (300, 40, "bfloat16"),
    (4400, 0, "bfloat16"), (4400, 4096, "bfloat16"),   # gemma2's prefill
])
def test_flash_attention_head_dim_256_softcap_binds(cuda, S, window, dtype):
    """q scaled by CAP_BOOST: the scores pass the softcap of 50, so the cap
    changes the output by far more than the tolerance, and the kernel
    still matches the plain version."""
    rng = np.random.default_rng(S + window)
    q = on(cuda, rng.standard_normal((1, S, 8, 256)) * CAP_BOOST[dtype],
           DTYPES[dtype])
    k, v = (on(cuda, rng.standard_normal((1, S, 4, 256)), DTYPES[dtype])
            for _ in range(2))
    kw = dict(scale=256 ** -0.5, window=window)
    want = FA.flash_attention_plain(q, k, v, softcap=50.0, **kw)
    assert_cap_binds(want, FA.flash_attention_plain(q, k, v, **kw), dtype)
    got = ops.flash_attention(q, k, v, softcap=50.0, **kw)
    torch.cuda.synchronize()
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 4096])
def test_flash_attention_gemma2_prefill(cuda, window):
    """gemma2-2b's prefill at 4400 tokens, past its 4096 window: a global
    (causal) and a local (window 4096) layer, softcap 50, bf16."""
    rng = np.random.default_rng(window)
    q = on(cuda, rng.standard_normal((1, 4400, 8, 256)), torch.bfloat16)
    k, v = (on(cuda, rng.standard_normal((1, 4400, 4, 256)), torch.bfloat16)
            for _ in range(2))
    kw = dict(scale=256 ** -0.5, window=window, softcap=50.0)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v, **kw)
    close(got, want, **tol_for("bfloat16"))
    rel_close(got, want, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("S,window", [(4400, 4096), (300, 256), (129, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_starcoder2_heads(cuda, S, window, dtype):
    """starcoder2-3b's heads (24 query over 2 KV heads of 128, G = 12)
    under a window every layer has, S past it: its 4400-token prefill
    against a 4096 window, and shorter cases across the 64-row tiles."""
    rng = np.random.default_rng(S + window)
    q = on(cuda, rng.standard_normal((1, S, 24, 128)), DTYPES[dtype])
    k, v = (on(cuda, rng.standard_normal((1, S, 2, 128)), DTYPES[dtype])
            for _ in range(2))
    kw = dict(scale=128 ** -0.5, window=window)
    before = FA.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention_cuda.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, **kw)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("S,window", [(4400, 4096), (300, 256), (129, 40),
                                      (65, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_mixtral_heads(cuda, S, window, dtype):
    """mixtral-8x7b's heads (32 query over 8 KV heads of 128, G = 4) under
    the 4096 window of every layer: its 4400-token prefill past the
    window, and shorter cases across the 64-row tiles."""
    rng = np.random.default_rng(S + window + 1)
    q = on(cuda, rng.standard_normal((1, S, 32, 128)), DTYPES[dtype])
    k, v = (on(cuda, rng.standard_normal((1, S, 8, 128)), DTYPES[dtype])
            for _ in range(2))
    kw = dict(scale=128 ** -0.5, window=window)
    before = FA.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention_cuda.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, **kw)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", list(D256_MASKS))
@pytest.mark.parametrize("S", [1, 63, 64, 65, 129, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_192(cuda, S, mask, dtype):
    """Both kernels at head_dim 192, nemotron-4-340b's (bf16: the
    m64n192k16 P V product over three 128-byte swizzled column blocks;
    fp32: 162 KB of shared memory), at the 64-row tile edges, under every
    mask, with G = 12 (24 query over 2 KV heads)."""
    kw = dict(D256_MASKS[mask])
    if "kv_len" in kw:
        kw["kv_len"] = max(1, int(S * kw["kv_len"]))
    rng = np.random.default_rng(S + 192)
    q = on(cuda, rng.standard_normal((2, S, 24, 192)), DTYPES[dtype])
    k = on(cuda, rng.standard_normal((2, S, 2, 192)), DTYPES[dtype])
    v = on(cuda, rng.standard_normal((2, S, 2, 192)), DTYPES[dtype])
    before = FA.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, scale=192 ** -0.5, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention_cuda.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = FA.flash_attention_plain(q, k, v, scale=192 ** -0.5, **kw)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [142, 404, 891])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_nemotron_heads(cuda, S, dtype):
    """nemotron-4-340b's heads at full width (96 query over 8 KV heads of
    192, G = 12), causal, at the engine's prompt lengths."""
    rng = np.random.default_rng(S + 96)
    q = on(cuda, rng.standard_normal((1, S, 96, 192)), DTYPES[dtype])
    k, v = (on(cuda, rng.standard_normal((1, S, 8, 192)), DTYPES[dtype])
            for _ in range(2))
    got = ops.flash_attention(q, k, v, scale=192 ** -0.5)
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v, scale=192 ** -0.5)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [142, 891])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_jamba_heads(cuda, S, dtype):
    """jamba-1.5-large's heads at full width (64 query over 8 KV heads of
    128, G = 8), causal, with no positional embedding (none reaches the
    kernel either way)."""
    rng = np.random.default_rng(S + 64)
    q = on(cuda, rng.standard_normal((1, S, 64, 128)), DTYPES[dtype])
    k, v = (on(cuda, rng.standard_normal((1, S, 8, 128)), DTYPES[dtype])
            for _ in range(2))
    got = ops.flash_attention(q, k, v, scale=128 ** -0.5)
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v, scale=128 ** -0.5)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [142, 404, 891])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_qwen2_vl_heads(cuda, S, dtype):
    """qwen2-vl-2b's heads (12 query over 2 KV heads of 128, G = 6),
    causal, at the engine's prompt lengths."""
    rng = np.random.default_rng(S)
    q = on(cuda, rng.standard_normal((1, S, 12, 128)), DTYPES[dtype])
    k, v = (on(cuda, rng.standard_normal((1, S, 2, 128)), DTYPES[dtype])
            for _ in range(2))
    got = ops.flash_attention(q, k, v, scale=128 ** -0.5)
    torch.cuda.synchronize()
    want = FA.flash_attention_plain(q, k, v, scale=128 ** -0.5)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,causal", [
    (4, 1500, 1500, False),          # the encoder over 1500 frames
    (1, 4096, 4096, False),          # at max_position_embeddings
    (4, 16, 1500, False),            # cross-attention of a 16-token prompt
    (4, 16, 16, True),               # the decoder's self-attention
    (2, 100, 37, False),             # S != T off the tile edges
    (2, 5, 1499, False),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_seamless_shapes(cuda, B, S, T, causal, dtype):
    """seamless-m4t-medium's heads (16 over 16 of 64, G = 1) at its three
    prefill uses, non-causal with S != T among them; each launch counted
    by causality."""
    rng = np.random.default_rng(S + T)
    q = on(cuda, rng.standard_normal((B, S, 16, 64)), DTYPES[dtype])
    k, v = (on(cuda, rng.standard_normal((B, T, 16, 64)), DTYPES[dtype])
            for _ in range(2))
    before = FA.flash_attention_cuda.noncausal_launches
    got = ops.flash_attention(q, k, v, causal=causal, scale=0.125)
    torch.cuda.synchronize()
    assert FA.flash_attention_cuda.noncausal_launches == \
        before + (not causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal, scale=0.125)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T,lengths", [
    (1500, [1500] * 4),              # cross: 4-token pages, full capacity
    (80, [17, 40, 79, 80]),          # the decoder's self cache
    (1499, [1499] * 4),              # an odd S_enc: 1-token pages
    (37, [37] * 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_seamless_caches(cuda, T, lengths, dtype):
    """Decode at seamless-m4t-medium's heads (16 over 16 of 64) over a
    dense cache of T slots viewed as identity pages of gcd(T, 64) tokens
    (models/layers.py:page_size), as the model's decode runs it: the
    cross-attention with every length at the capacity."""
    from repro_torch.models.layers import page_size
    B, H, D, ps = 4, 16, 64, page_size(T)
    rng = np.random.default_rng(T)
    q = on(cuda, rng.standard_normal((B, H, D)), DTYPES[dtype])
    kp, vp = (on(cuda, rng.standard_normal((B * T // ps, ps, H, D)),
                 DTYPES[dtype]) for _ in range(2))
    pt = torch.arange(B * T // ps, dtype=torch.int32,
                      device=cuda).view(B, T // ps)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = PA.paged_attention_cuda.capacity_launches.get(T, 0)
    got = ops.paged_attention(q, kp, vp, pt, ln, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert PA.paged_attention_cuda.capacity_launches[T] == before + 1
    want = PA.paged_attention_plain(q, kp, vp, pt, ln, scale=D ** -0.5)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,D,ps,maxp,identity", [
    (2, 4, 1, 32, 8, 3, False),
    (3, 8, 2, 64, 16, 4, False),
    (1, 12, 4, 128, 32, 2, False),
    (4, 16, 16, 128, 64, 5, True),              # olmo-1b's slot cache
    (2, 4, 2, 64, 12, 3, True),                 # a page size off 2^k
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_plain(cuda, B, H, KVH, D, ps, maxp,
                                       identity, dtype):
    rng = np.random.default_rng(B * 100 + D)
    P = B * maxp + (0 if identity else 1)
    q = on(cuda, rng.standard_normal((B, H, D)), DTYPES[dtype])
    kp = on(cuda, rng.standard_normal((P, ps, KVH, D)), DTYPES[dtype])
    vp = on(cuda, rng.standard_normal((P, ps, KVH, D)), DTYPES[dtype])
    order = np.arange(P) if identity else rng.permutation(P)
    pt = torch.from_numpy(order[:B * maxp].reshape(B, maxp)
                          .astype(np.int32)).to(cuda)
    lengths = torch.tensor([1 + (i * 37) % (ps * maxp) for i in range(B)],
                           dtype=torch.int32, device=cuda)
    before = PA.paged_attention_cuda.launches
    got = ops.paged_attention(q, kp, vp, pt, lengths, scale=D ** -0.5,
                              softcap=0.0 if identity else 30.0)
    torch.cuda.synchronize()
    assert PA.paged_attention_cuda.launches == before + 1
    close(got, PA.paged_attention_plain(q, kp, vp, pt, lengths,
                                        scale=D ** -0.5,
                                        softcap=0.0 if identity else 30.0),
          **tol_for(dtype))


def paged_inputs(dev, rng, B, H, KVH, D, ps, maxp, lengths, dtype):
    P = B * maxp + 1
    q = on(dev, rng.standard_normal((B, H, D)), dtype)
    kp = on(dev, rng.standard_normal((P, ps, KVH, D)), dtype)
    vp = on(dev, rng.standard_normal((P, ps, KVH, D)), dtype)
    pt = torch.from_numpy(rng.permutation(P)[:B * maxp].reshape(B, maxp)
                          .astype(np.int32)).to(dev)
    return q, kp, vp, pt, torch.tensor(lengths, dtype=torch.int32,
                                       device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,D,ps,maxp,lengths", [
    (4, 16, 16, 128, 64, 15, [1, 1, 1, 1]),     # length 1: splits empty
    (4, 16, 16, 128, 64, 15, [960] * 4),        # at capacity
    (1, 2, 1, 64, 16, 60, [40]),                # 30 splits over 2 chunks
    (2, 24, 2, 64, 16, 4, [50, 7]),             # G = 12: chunks of 8
    (33, 16, 8, 128, 16, 4,                     # B * KVH = 264: one split
     [1 + (i * 13) % 64 for i in range(33)]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_split_edges(cuda, B, H, KVH, D, ps, maxp, lengths,
                                     dtype):
    args = paged_inputs(cuda, np.random.default_rng(B + H + D), B, H, KVH,
                        D, ps, maxp, lengths, DTYPES[dtype])
    got = ops.paged_attention(*args, scale=D ** -0.5)
    torch.cuda.synchronize()
    close(got, PA.paged_attention_plain(*args, scale=D ** -0.5),
          **tol_for(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("H,ps,maxp,lengths", [
    (24, 64, 64, [4096, 715, 602, 385]),        # starcoder2's 4096-slot
    (24, 64, 64, [4096, 4097, 1, 4095]),        # rings, at and past T
    (12, 64, 15, [907, 715, 602, 385]),         # qwen2-vl's 960-slot cache
    (12, 64, 15, [960, 1, 2, 959]),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_starcoder2_and_qwen2_vl_heads(cuda, H, ps, maxp,
                                                       lengths, dtype):
    """Decode at starcoder2-3b's heads (G = 12: the kernel takes 8 heads,
    then 4) and qwen2-vl-2b's (G = 6), 2 KV heads of 128, over identity
    pages of the engine's slot caches."""
    B, KVH, D = 4, 2, 128
    rng = np.random.default_rng(H + maxp + lengths[1])
    q = on(cuda, rng.standard_normal((B, H, D)), DTYPES[dtype])
    kp, vp = (on(cuda, rng.standard_normal((B * maxp, ps, KVH, D)),
                 DTYPES[dtype]) for _ in range(2))
    pt = torch.arange(B * maxp, dtype=torch.int32,
                      device=cuda).view(B, maxp)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = PA.paged_attention_cuda.launches
    got = ops.paged_attention(q, kp, vp, pt, ln, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert PA.paged_attention_cuda.launches == before + 1
    want = PA.paged_attention_plain(q, kp, vp, pt, ln, scale=D ** -0.5)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[4096, 715, 602, 385],
                                     [4096, 4097, 1, 4095]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_mixtral_heads(cuda, lengths, dtype):
    """Decode at mixtral-8x7b's heads (32 query over 8 KV heads of 128,
    G = 4: the kernel's 8-head variant with 4 slots idle) over identity
    pages of its 4096-slot rings, at and past their capacity."""
    B, H, KVH, D, ps, maxp = 4, 32, 8, 128, 64, 64
    rng = np.random.default_rng(lengths[1])
    q = on(cuda, rng.standard_normal((B, H, D)), DTYPES[dtype])
    kp, vp = (on(cuda, rng.standard_normal((B * maxp, ps, KVH, D)),
                 DTYPES[dtype]) for _ in range(2))
    pt = torch.arange(B * maxp, dtype=torch.int32,
                      device=cuda).view(B, maxp)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = PA.paged_attention_cuda.launches
    got = ops.paged_attention(q, kp, vp, pt, ln, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert PA.paged_attention_cuda.launches == before + 1
    want = PA.paged_attention_plain(q, kp, vp, pt, ln, scale=D ** -0.5)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,ps,maxp,lengths", [
    (4, 8, 4, 64, 64, [4096, 5000, 1, 4095]),   # gemma2's 4096-slot ring:
                                                # lengths at and past T
    (4, 8, 4, 64, 70, [4432, 700, 586, 369]),   # its 4480-slot global cache
    (1, 2, 1, 16, 60, [40]),                    # 30 splits over 2 chunks
    (66, 8, 4, 16, 4,                           # B * KVH = 264: one split
     [1 + (i * 13) % 64 for i in range(66)]),
    (2, 16, 2, 16, 4, [50, 7]),                 # G = 8
    (2, 24, 2, 16, 4, [64, 3]),                 # G = 12: chunks of 8
])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_head_dim_256(cuda, B, H, KVH, ps, maxp, lengths,
                                      softcap, dtype):
    """head_dim 256: a token's row takes a whole warp (an fp32 lane two
    16-byte slices), at gemma2's shapes and the split plan's edges."""
    args = paged_inputs(cuda, np.random.default_rng(B + H + maxp), B, H,
                        KVH, 256, ps, maxp, lengths, DTYPES[dtype])
    before = PA.paged_attention_cuda.launches
    got = ops.paged_attention(*args, scale=256 ** -0.5, softcap=softcap)
    torch.cuda.synchronize()
    assert PA.paged_attention_cuda.launches == before + 1
    want = PA.paged_attention_plain(*args, scale=256 ** -0.5,
                                    softcap=softcap)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,ps,maxp,lengths", [
    (4, 8, 4, 64, 64, [4096, 5000, 1, 4095]),   # gemma2's 4096-slot ring
    (4, 8, 4, 64, 70, [4432, 700, 586, 369]),   # its 4480-slot global cache
    (2, 16, 2, 16, 4, [50, 7]),                 # G = 8
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_head_dim_256_softcap_binds(cuda, B, H, KVH, ps,
                                                    maxp, lengths, dtype):
    """q scaled by CAP_BOOST: the scores pass the softcap of 50, so the cap
    changes the output by far more than the tolerance, and the kernel
    still matches the plain version."""
    q, *rest = paged_inputs(cuda, np.random.default_rng(B + H + maxp), B,
                            H, KVH, 256, ps, maxp, lengths, DTYPES[dtype])
    args = ((q.float() * CAP_BOOST[dtype]).to(q.dtype), *rest)
    want = PA.paged_attention_plain(*args, scale=256 ** -0.5, softcap=50.0)
    assert_cap_binds(want, PA.paged_attention_plain(*args, scale=256 ** -0.5),
                     dtype)
    got = ops.paged_attention(*args, scale=256 ** -0.5, softcap=50.0)
    torch.cuda.synchronize()
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KVH,ps,maxp,lengths", [
    (4, 96, 8, 64, 17, [907, 715, 602, 385]),   # nemotron's 1088-slot
    (4, 96, 8, 64, 17, [1088, 1089, 1, 1087]),  # cache, at and past T
    (2, 24, 2, 16, 4, [50, 7]),                 # G = 12: 8 heads, then 4
    (3, 12, 1, 8, 5, [33, 1, 17]),              # G = 12 over one KV head
    (1, 2, 1, 16, 60, [40]),                    # 30 splits over 2 chunks
    (33, 96, 8, 16, 4,                          # B * KVH = 264: one split
     [1 + (i * 13) % 64 for i in range(33)]),
])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_head_dim_192(cuda, B, H, KVH, ps, maxp, lengths,
                                      softcap, dtype):
    """head_dim 192: a token's row is 24 16-byte slices in bf16 and 48 in
    fp32, so a whole warp takes it and the lanes past the row idle (8 of
    32 in bf16, 16 on an fp32 lane's second slice); at nemotron-4-340b's
    heads (G = 12), ragged lengths and the split plan's edges."""
    args = paged_inputs(cuda, np.random.default_rng(B + H + maxp + 192), B,
                        H, KVH, 192, ps, maxp, lengths, DTYPES[dtype])
    before = PA.paged_attention_cuda.launches
    got = ops.paged_attention(*args, scale=192 ** -0.5, softcap=softcap)
    torch.cuda.synchronize()
    assert PA.paged_attention_cuda.launches == before + 1
    want = PA.paged_attention_plain(*args, scale=192 ** -0.5,
                                    softcap=softcap)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[907, 715, 602, 385],
                                     [1088, 1089, 1, 1087]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_jamba_heads(cuda, lengths, dtype):
    """Decode at jamba-1.5-large's heads (64 query over 8 KV heads of 128,
    G = 8) over identity pages of its 1088-slot slot cache."""
    B, H, KVH, D, ps, maxp = 4, 64, 8, 128, 64, 17
    rng = np.random.default_rng(lengths[1] + 8)
    q = on(cuda, rng.standard_normal((B, H, D)), DTYPES[dtype])
    kp, vp = (on(cuda, rng.standard_normal((B * maxp, ps, KVH, D)),
                 DTYPES[dtype]) for _ in range(2))
    pt = torch.arange(B * maxp, dtype=torch.int32,
                      device=cuda).view(B, maxp)
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = ops.paged_attention(q, kp, vp, pt, ln, scale=D ** -0.5)
    torch.cuda.synchronize()
    want = PA.paged_attention_plain(q, kp, vp, pt, ln, scale=D ** -0.5)
    close(got, want, **tol_for(dtype))
    rel_close(got, want, dtype)


@pytest.mark.cuda
def test_paged_attention_tickets_reset(cuda):
    """The split combine's tickets return to 0 after every launch: two
    launches in a row and one on a second stream give the same output."""
    args = paged_inputs(cuda, np.random.default_rng(5), 4, 16, 16, 128, 64,
                        15, [907, 715, 602, 385], torch.bfloat16)
    assert PA.split_plan(4, 16, 960, PA.sm_count(cuda))[0] > 1
    first = PA.paged_attention_cuda(*args, scale=0.1)
    second = PA.paged_attention_cuda(*args, scale=0.1)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        third = PA.paged_attention_cuda(*args, scale=0.1)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, third)
    close(first, PA.paged_attention_plain(*args, scale=0.1),
          **tol_for("bfloat16"))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 16, 4, 32, device=cuda)
    k = torch.randn(1, 16, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_cuda(q.transpose(1, 2), k, k, scale=0.2)
    with pytest.raises(TypeError, match="bf16 or all fp32"):
        FA.flash_attention_cuda(q.half(), k.half(), k.half(), scale=0.2)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_cuda(q[..., :24].contiguous(),
                                k[..., :24].contiguous(),
                                k[..., :24].contiguous(), scale=0.2)
    pages = torch.randn(2, 8, 2, 32, device=cuda)
    pt = torch.zeros(1, 2, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        PA.paged_attention_cuda(q[:, 0], pages, pages, pt,
                                torch.ones(1, dtype=torch.int32, device=cuda),
                                scale=0.2)


@pytest.mark.cuda
def test_reduced_model_kernel_path_matches_plain_path(cuda):
    """olmo-1b at smoke width on the card: prefill plus decode through the
    kernels against the plain attention, teacher-forced, under the bounds
    of tests/test_models_decode.py (median softmax error below 0.05)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("olmo-1b").reduced()
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params = kernel.init(0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda)
    with torch.inference_mode():
        x, _ = plain.forward(params, {"tokens": toks})
        ref = plain._logits(params, x)
    cache = kernel.init_cache(2, 48, device=cuda)
    before = ops.launch_counts()
    lg, cache, _ = kernel.prefill(params, {"tokens": toks[:, :32]}, cache)
    errs = [float((lg.softmax(-1) - ref[:, 31].softmax(-1)).abs().max())]
    for t in range(32, 40):
        lg, cache = kernel.decode(params, toks[:, t], cache,
                                  torch.full((2,), t, dtype=torch.int32,
                                             device=cuda))
        errs.append(float((lg.softmax(-1) - ref[:, t].softmax(-1))
                          .abs().max()))
    after = ops.launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == \
        cfg.num_layers
    assert after["paged_attention"] - before["paged_attention"] == \
        8 * cfg.num_layers
    assert np.median(errs) < 0.05, errs
    assert math.isfinite(sum(errs))


@pytest.mark.cuda
def test_reduced_gemma2_kernel_path_matches_plain_path(cuda):
    """gemma2-2b at smoke width on the card (window 16, softcaps,
    post-norms): a 32-token prefill, which wraps the local layers' 16-slot
    ring, then 16 decode steps through the kernels, against the plain
    path's teacher-forced forward under the bounds of
    tests/test_models_decode.py."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("gemma2-2b").reduced()
    check_kernel_path(cuda, cfg, build_model(cfg).init(0, device=cuda))


@pytest.mark.cuda
def test_reduced_gemma2_kernel_path_with_a_binding_softcap(cuda):
    """The same with every query projection scaled by 100, so the
    attention scores (std ~100) pass the logit softcap of 50: the kernel
    path still matches the plain path, and its logits lie five times
    closer (mean absolute difference) to the plain path's than the plain
    path without the cap does."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("gemma2-2b").reduced()
    params = build_model(cfg).init(0, device=cuda)
    for block in params["blocks"]:
        block["attn"]["wq"] = block["attn"]["wq"] * 100
    got, ref = check_kernel_path(cuda, cfg, params)
    uncapped = build_model(dataclasses.replace(cfg, attn_logit_softcap=0.0),
                           attn_impl="plain")
    with torch.inference_mode():
        x, _ = uncapped.forward(params, {"tokens": model_tokens(cuda, cfg)})
        moved = (uncapped._logits(params, x)[:, 31:].float() - ref).abs()
    assert 5 * float((got - ref).abs().mean()) < float(moved.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen2-vl-2b",
                                  "nemotron-4-340b", "mixtral-8x7b",
                                  "grok-1-314b"])
def test_reduced_variant_kernel_path_matches_plain_path(cuda, arch):
    """starcoder2-3b (16-slot rings on every layer), qwen2-vl-2b (M-RoPE),
    nemotron-4-340b (int8 KV caches), mixtral-8x7b (MoE FFNs over 16-slot
    rings) and grok-1-314b (GeGLU experts, a softcap of 30, int8 caches)
    at smoke width on the card: a 32-token prefill and 16 decode steps
    through the kernels (and the sorted MoE dispatch) against the plain
    path's teacher-forced forward (one-hot MoE products).  The int8 cache
    holds int8 values with scales that are not zero, and its logits differ
    from the same model's with bf16 caches, within the same bounds."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    params = build_model(cfg).init(0, device=cuda)
    got, _ = check_kernel_path(cuda, cfg, params)
    if cfg.kv_cache_dtype == "int8":
        as_bf16 = dataclasses.replace(cfg, kv_cache_dtype="bfloat16")
        other, _ = check_kernel_path(cuda, as_bf16, params)
        assert not torch.equal(got[:, 1:], other[:, 1:])
        errs = [float((got[:, i].softmax(-1) - other[:, i].softmax(-1))
                      .abs().max()) for i in range(got.shape[1])]
        assert np.median(errs) < 0.05, errs


@pytest.mark.cuda
def test_reduced_qwen2_vl_embeds_on_the_card(cuda):
    """qwen2-vl-2b at smoke width fed embeds with [3, B, S] positions whose
    rows differ (a 4 x 4 patch grid at t = 4, h = 4 + row, w = 4 + col):
    the kernel path's prefill matches the plain path's, and differs from a
    prefill at replicated positions by more than that."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen2-vl-2b").reduced()
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params = kernel.init(0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    emb = torch.randn(2, 32, cfg.d_model, generator=gen,
                      device=cuda).bfloat16()
    flat = torch.arange(32, device=cuda)[None, None].expand(3, 2, 32)
    pos = flat.clone()
    patch = torch.arange(16, device=cuda)
    pos[0, :, 4:20] = 4
    pos[1, :, 4:20] = 4 + patch // 4
    pos[2, :, 4:20] = 4 + patch % 4
    outs = []
    for model, p in ((kernel, pos), (plain, pos), (kernel, flat)):
        cache = model.init_cache(2, 32, device=cuda)
        lg, _, _ = model.prefill(params, {"embeds": emb, "positions": p},
                                 cache)
        outs.append(lg.float())
    err = float((outs[0] - outs[1]).abs().mean())
    assert float((outs[0].softmax(-1) - outs[1].softmax(-1)).abs().max()) \
        < 0.05
    assert float((outs[2] - outs[0]).abs().mean()) > 5 * err


def moe_close(got, want):
    """The bf16 bounds in units of the plain output's largest magnitude:
    2e-2 elementwise, 1e-2 in norm.  The experts' outputs reach the
    hundreds at full width (w_up is drawn with std 1/sqrt(E), as in the
    JAX twin), where one bf16 step is a unit or more, and a token's two
    gated slots may cancel in their sum."""
    scale = float(want.float().abs().max())
    close(got / scale, want / scale, **tol_for("bfloat16"))
    rel_close(got, want, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 300), (4, 1)])
def test_moe_kernel_dispatch_at_full_layer_width(cuda, B, S):
    """One mixtral-8x7b MoE layer at full width (d_model 4096, 8 experts of
    d_ff 14336, top-2) on the card, dropless: a 300-token prefill (two
    chunks of 256, the second padded) and a decode step (chunk_size=1) on
    the kernel path (sorted per-expert products; the decode's product
    batched over the experts) against the plain one-hot path, y within
    moe_close's bounds and the loss within 2e-5; the prefill's routing
    reaches all 8 experts."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    cfg = get_config("mixtral-8x7b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = MOE.moe_params(cfg, gen, device=cuda)
    x = torch.randn(B, S, cfg.d_model, generator=gen,
                    device=cuda).bfloat16()
    kw = dict(chunk_size=1) if S == 1 else {}
    with torch.inference_mode():
        y, aux = MOE.apply_moe(cfg, p, x, dropless=True, **kw)
        y_ref, aux_ref = MOE.apply_moe(cfg, p, x, dropless=True,
                                       attn_impl="plain", **kw)
        r = MOE.route(cfg, p, x, MOE.capacity(cfg, S, True))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    moe_close(y, y_ref)
    close(aux, aux_ref, **tol_for("float32"))
    if S > 1:
        assert set(r.idx.unique().tolist()) == set(range(8))


def model_tokens(cuda, cfg):
    """The 48 tokens the reduced-model tests feed the model."""
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 48))).to(cuda)


def check_kernel_path(cuda, cfg, params):
    """A 32-token prefill and 16 decode steps on the kernel path against
    the plain path's teacher-forced forward (a windowed layer's 16-slot
    ring wraps in the prefill); returns both paths' logits at the 17
    positions compared, as fp32 [2, 17, V]."""
    from repro_torch.models import build_model
    from repro_torch.models.transformer import block_pattern, num_repeats
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    toks = model_tokens(cuda, cfg)
    with torch.inference_mode():
        x, _ = plain.forward(params, {"tokens": toks})
        ref = plain._logits(params, x)
    cache = kernel.init_cache(2, 48, device=cuda)
    assert [c["k"].shape[2] for c in cache] == [
        min(48, d.window) if d.window else 48 for d in block_pattern(cfg)]
    ops.reset_launch_counts()
    lg, cache, _ = kernel.prefill(params, {"tokens": toks[:, :32]}, cache)
    got = [lg]
    for t in range(32, 48):
        lg, cache = kernel.decode(params, toks[:, t], cache,
                                  torch.full((2,), t, dtype=torch.int32,
                                             device=cuda))
        got.append(lg)
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    assert ops.launch_counts()["paged_attention"] == 16 * cfg.num_layers
    # by kind: each layer's flash launch under its window, each of its
    # decode steps over its own cache's slots
    by_window, by_capacity = {}, {}
    for d in block_pattern(cfg):
        T = min(48, d.window) if d.window else 48
        by_window[d.window] = by_window.get(d.window, 0) + num_repeats(cfg)
        by_capacity[T] = by_capacity.get(T, 0) + 16 * num_repeats(cfg)
    assert {w: n for w, n in FA.flash_attention_cuda.window_launches.items()
            if n} == by_window
    assert {T: n for T, n in PA.paged_attention_cuda.capacity_launches
            .items() if n} == by_capacity
    got, ref = torch.stack(got, 1).float(), ref[:, 31:].float()
    errs = [float((got[:, i].softmax(-1) - ref[:, i].softmax(-1))
                  .abs().max()) for i in range(got.shape[1])]
    assert np.median(errs) < 0.05, errs
    assert math.isfinite(sum(errs))
    return got, ref


@pytest.mark.cuda
def test_reduced_jamba_kernel_path_matches_plain_path(cuda):
    """jamba-1.5-large at smoke width on the card (two repeats of seven
    Mamba-2 blocks and one attention block, MoE FFNs every other block, an
    int8 KV cache): a 32-token prefill and 16 decode steps on the kernel
    path against the plain path's teacher-forced forward, under the MoE
    bounds of tests/test_models_decode.py (median softmax error below
    0.05).  Counted by mixer: flash once a prefill and paged once a decode
    step in each attention layer, the SSD scan once a prefill in each
    Mamba layer, on the tensor cores."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import block_pattern, num_repeats
    cfg = get_config("jamba-1.5-large-398b").reduced()
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params = kernel.init(0, device=cuda)
    toks = model_tokens(cuda, cfg)
    with torch.inference_mode():
        x, _ = plain.forward(params, {"tokens": toks}, dropless=True)
        ref = plain._logits(params, x)[:, 31:].float()
    cache = kernel.init_cache(2, 48, device=cuda)
    assert [sorted(c) for c in cache] == [
        ["k", "k_scale", "v", "v_scale"] if d.is_attn else ["conv", "ssm"]
        for d in block_pattern(cfg)]
    ops.reset_launch_counts()
    lg, cache, _ = kernel.prefill(params, {"tokens": toks[:, :32]}, cache)
    got = [lg]
    for t in range(32, 48):
        lg, cache = kernel.decode(params, toks[:, t], cache,
                                  torch.full((2,), t, dtype=torch.int32,
                                             device=cuda))
        got.append(lg)
    n_attn = num_repeats(cfg) * sum(d.is_attn for d in block_pattern(cfg))
    assert ops.launch_counts() == {
        "flash_attention": n_attn, "flash_attention_bwd": 0,
        "paged_attention": 16 * n_attn, "ssd_scan": cfg.num_layers - n_attn,
        "ssd_scan_bwd": 0}
    assert SSD.ssd_scan_cuda.variant_launches["wgmma"] == \
        cfg.num_layers - n_attn
    got = torch.stack(got, 1).float()
    errs = [float((got[:, i].softmax(-1) - ref[:, i].softmax(-1))
                  .abs().max()) for i in range(got.shape[1])]
    assert np.median(errs) < 0.05, errs
    assert math.isfinite(sum(errs))


@pytest.mark.cuda
def test_reduced_seamless_kernel_path_matches_plain_path(cuda):
    """seamless-m4t-medium at smoke width on the card (2 encoder and 4
    decoder layers): 12 frames and a 16-token prompt, then 8 decode steps,
    on the kernel path against the plain path's teacher-forced forward
    (median softmax error below 0.05).  Counted: flash once a prefill in
    each encoder layer and twice in each decoder layer (self causal, cross
    not), paged twice a decode step in each decoder layer (the self cache
    and the 12-slot cross cache)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("seamless-m4t-medium").reduced()
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params = kernel.init(0, device=cuda)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24))).to(cuda)
    src = on(cuda, rng.standard_normal((2, 12, cfg.d_model)), torch.bfloat16)
    with torch.inference_mode():
        x, _ = plain.forward(params, {"src_embeds": src, "tgt_tokens": toks})
        ref = plain._logits(params, x)[:, 15:].float()
    cache = kernel.init_cache(2, 32, device=cuda)
    ops.reset_launch_counts()
    lg, cache, _ = kernel.prefill(params, {"src_embeds": src,
                                           "tgt_tokens": toks[:, :16]}, cache)
    got = [lg]
    for t in range(16, 24):
        lg, cache = kernel.decode(params, toks[:, t], cache,
                                  torch.full((2,), t, dtype=torch.int32,
                                             device=cuda))
        got.append(lg)
    L, E = cfg.num_layers, cfg.encoder_layers
    assert ops.launch_counts() == {"flash_attention": E + 2 * L,
                                   "flash_attention_bwd": 0,
                                   "paged_attention": 8 * 2 * L,
                                   "ssd_scan": 0, "ssd_scan_bwd": 0}
    assert FA.flash_attention_cuda.noncausal_launches == E + L
    assert {T: n for T, n in PA.paged_attention_cuda.capacity_launches
            .items() if n} == {32: 8 * L, 12: 8 * L}
    got = torch.stack(got, 1).float()
    errs = [float((got[:, i].softmax(-1) - ref[:, i].softmax(-1))
                  .abs().max()) for i in range(got.shape[1])]
    assert np.median(errs) < 0.05, errs
    assert math.isfinite(sum(errs))


def ssd_tol(dtype_name):
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" \
        else dict(rtol=1e-3, atol=1e-3)


def ssd_inputs(dev, seed, B, S, H, P, G, N, dtype, init):
    """tests/test_kernels.py's SSD inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = on(dev, rng.standard_normal((B, S, H, P)), dtype)
    dt = on(dev, np.logaddexp(0.0, rng.standard_normal((B, S, H))),
            torch.float32)                               # softplus
    A = on(dev, -np.exp(rng.standard_normal(H) * 0.3), torch.float32)
    Bm = on(dev, rng.standard_normal((B, S, G, N)) * 0.5, dtype)
    Cm = on(dev, rng.standard_normal((B, S, G, N)) * 0.5, dtype)
    st = on(dev, rng.standard_normal((B, H, P, N)), torch.float32) \
        if init else None
    return (x, dt, A, Bm, Cm), st


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,G,N,chunk,init", [
    (2, 64, 2, 16, 1, 16, 16, False),             # tests/test_kernels.py
    (2, 70, 4, 16, 2, 32, 32, False),             # ragged tail, grouped B/C
    (2, 32, 8, 64, 1, 128, 8, False),
    (1, 40, 2, 16, 1, 16, 16, True),              # initial state
    (2, 300, 4, 128, 2, 64, 64, True),            # P = 128
    (1, 20, 2, 32, 1, 32, 256, False),            # chunk > S
    (1, 891, 48, 64, 1, 128, 256, False),         # mamba2-780m prefill
    (1, 891, 48, 64, 1, 128, 256, True),
    (2, 100, 16, 16, 1, 16, 32, False),           # mamba2-780m .reduced()
    (2, 100, 16, 16, 1, 16, 32, True),
    (1, 300, 4, 128, 1, 128, 256, False),         # P = N = 128
    (1, 300, 4, 128, 1, 128, 256, True),
    (1, 891, 256, 64, 1, 128, 256, False),        # jamba-1.5-large prefill:
    (1, 891, 256, 64, 1, 128, 256, True),         # 256 heads, one group
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_plain(cuda, B, S, H, P, G, N, chunk, init, dtype):
    check_ssd_scan(cuda, B, S, H, P, G, N, chunk, init, dtype)


def check_ssd_scan(dev, B, S, H, P, G, N, chunk, init, dtype):
    """One launch through ops.ssd_scan against the plain version; bf16
    must run on the tensor cores ("wgmma"), fp32 on CUDA cores."""
    args, st = ssd_inputs(dev, S + P + N, B, S, H, P, G, N, DTYPES[dtype],
                          init)
    variant = "wgmma" if dtype == "bfloat16" else "cuda_core"
    before = SSD.ssd_scan_cuda.launches
    before_variant = dict(SSD.ssd_scan_cuda.variant_launches)
    y, fin = ops.ssd_scan(*args, chunk=chunk, initial_state=st)
    torch.cuda.synchronize()
    assert SSD.ssd_scan_cuda.launches == before + 1
    assert SSD.ssd_scan_cuda.variant_launches == {
        k: n + (k == variant) for k, n in before_variant.items()}
    assert y.dtype == args[0].dtype and y.shape == args[0].shape
    assert fin.dtype == torch.float32 and fin.shape == (B, H, P, N)
    y_ref, fin_ref = SSD.ssd_scan_plain(*args, chunk=chunk, initial_state=st)
    close(y, y_ref, **ssd_tol(dtype))
    close(fin, fin_ref, **ssd_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,chunk", [
    (63, 256), (64, 256), (65, 256), (255, 256), (256, 256), (257, 256),
    (1024, 256), (300, 64), (300, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_tile_edges(cuda, S, chunk, init, dtype):
    """mamba2-780m's widths (P 64, N 128, one group) at the edges of the
    bf16 kernel's 64-row tiles and of the chunks."""
    check_ssd_scan(cuda, 1, S, 8, 64, 1, 128, chunk, init, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 32, 64, 128])
@pytest.mark.parametrize("P", [16, 32, 64, 128])
def test_ssd_scan_every_width_on_the_tensor_cores(cuda, P, N):
    """Every (head_dim, state_dim) the wrapper takes, in bf16: each pair
    is its own instance of the three tensor-core kernels."""
    check_ssd_scan(cuda, 2, 130, 4, P, 2, N, 64, True, "bfloat16")


@pytest.mark.cuda
def test_ssd_scan_from_two_threads_on_one_stream(cuda):
    """Two host threads issue bf16 scans of two shapes onto the one
    default stream at once, as an engine's replicas and compute queues do.
    A call's three launches pass data through its workspace, so another
    call's launches landing between them must not touch it: every result
    matches the plain version on its own inputs.  In each of five trials a
    spin kernel holds the stream while the threads issue 200 calls each,
    so the launches queue behind it and the threads' calls overlap more
    often than they do on an idle card."""
    shapes = [(1, 891, 48, 64, 1, 128, 256), (2, 300, 16, 32, 2, 64, 128)]
    cases = []
    for i, (B, S, H, P, G, N, chunk) in enumerate(shapes):
        args, st = ssd_inputs(cuda, 40 + i, B, S, H, P, G, N,
                              torch.bfloat16, True)
        cases.append((args, st, chunk))
    refs = [SSD.ssd_scan_plain(*args, chunk=chunk, initial_state=st)
            for args, st, chunk in cases]
    reps = 200

    def run(i, start, out, errors):
        args, st, chunk = cases[i]
        try:
            start.wait()
            for _ in range(reps):
                out.append(ops.ssd_scan(*args, chunk=chunk,
                                        initial_state=st))
        except Exception as e:          # reported below, on the main thread
            errors.append(e)

    for _ in range(5):
        start = threading.Barrier(len(cases))
        results = [[] for _ in cases]
        errors = []
        torch.cuda._sleep(int(2e8))     # ~0.1 s of spinning on the stream
        threads = [threading.Thread(target=run,
                                    args=(i, start, results[i], errors))
                   for i in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        assert not errors, errors
        for (y_ref, fin_ref), got in zip(refs, results):
            assert len(got) == reps
            for y, fin in got:           # compared on the card: 2000 pairs
                torch.testing.assert_close(y.float(), y_ref.float(),
                                           **ssd_tol("bfloat16"))
                torch.testing.assert_close(fin, fin_ref,
                                           **ssd_tol("bfloat16"))


@pytest.mark.cuda
def test_ssd_scan_refuses_what_the_kernel_does_not_take(cuda):
    (x, dt, A, Bm, Cm), _ = ssd_inputs(cuda, 0, 1, 16, 2, 16, 1, 16,
                                       torch.float32, False)
    with pytest.raises(TypeError, match="bf16 or all fp32"):
        SSD.ssd_scan_cuda(x.half(), dt, A, Bm.half(), Cm.half(), chunk=8)
    with pytest.raises(TypeError, match="fp32"):
        SSD.ssd_scan_cuda(x, dt.bfloat16(), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        SSD.ssd_scan_cuda(x.transpose(1, 2), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="state_dim"):
        SSD.ssd_scan_cuda(x, dt, A, Bm[..., :8].contiguous(),
                          Cm[..., :8].contiguous(), chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        SSD.ssd_scan_cuda(x.repeat(1, 32, 1, 1), dt.repeat(1, 32, 1), A,
                          Bm.repeat(1, 32, 1, 1), Cm.repeat(1, 32, 1, 1),
                          chunk=512)
    with pytest.raises(ValueError, match="CPU or all on"):
        ops.ssd_scan(x, dt.cpu(), A, Bm, Cm, chunk=8)


@pytest.mark.cuda
def test_reduced_mamba2_kernel_path_matches_plain_path(cuda):
    """mamba2-780m at smoke width on the card: prefill through the SSD
    kernel plus recurrent decode, against the plain path's teacher-forced
    forward (the JAX model's own ssd_chunked), under the 5e-3 of
    tests/test_models_decode.py::test_mamba2_decode_exact."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("mamba2-780m").reduced()
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params = kernel.init(0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 56))).to(cuda)
    with torch.inference_mode():
        x, _ = plain.forward(params, {"tokens": toks})
        ref = plain._logits(params, x)
    cache = kernel.init_cache(2, 56, device=cuda)
    before = ops.launch_counts()["ssd_scan"]
    lg, cache, _ = kernel.prefill(params, {"tokens": toks[:, :48]}, cache)
    assert ops.launch_counts()["ssd_scan"] - before == cfg.num_layers
    worst = float((lg.softmax(-1) - ref[:, 47].softmax(-1)).abs().max())
    for t in range(48, 56):
        lg, cache = kernel.decode(params, toks[:, t], cache,
                                  torch.full((2,), t, dtype=torch.int32,
                                             device=cuda))
        worst = max(worst, float((lg.softmax(-1) - ref[:, t].softmax(-1))
                                 .abs().max()))
    assert worst < 5e-3, worst


# ------------------------------------------------ the flash backward kernel
# Each gradient is held to 2e-2 (bf16) or 2e-5 (fp32) of its norm against
# flash_attention_bwd_plain on the same q, k, v, dO and the kernel's own
# forward output and lse: the same fp32 sums in another order (bf16 also
# rounds each gradient once).

BWD_CASES = {
    "olmo causal": (2, 300, 16, 16, 128, {}),
    "seamless not causal": (2, 200, 16, 16, 64, dict(causal=False)),
    "G=2 window": (1, 200, 8, 4, 128, dict(window=48)),
    "G=4 softcap": (1, 160, 8, 2, 64, dict(softcap=5.0, q_boost=3.0)),
    "G=4 window softcap": (1, 150, 8, 2, 128,
                           dict(window=40, softcap=5.0, q_boost=3.0)),
    "edge S=2": (1, 2, 4, 2, 128, {}),   # S=1: dq = dk = 0, noise only
    "edge S=63": (1, 63, 4, 2, 128, {}),
    "edge S=64": (1, 64, 4, 2, 64, {}),
    "edge S=65": (1, 65, 4, 2, 128, {}),
    "edge S=129": (1, 129, 4, 2, 64, dict(causal=False)),
    # every head dim the forward takes, and kv_len
    "D=32 G=2": (2, 150, 8, 4, 32, {}),
    "D=32 window softcap": (1, 140, 8, 2, 32,
                            dict(window=40, softcap=5.0, q_boost=3.0)),
    "D=192 G=12": (1, 200, 24, 2, 192, {}),
    "D=192 window softcap": (1, 180, 8, 4, 192,
                             dict(window=48, softcap=5.0, q_boost=3.0)),
    "D=256 G=2 softcap": (1, 200, 8, 4, 256, dict(softcap=5.0, q_boost=3.0)),
    "D=256 window": (1, 300, 8, 4, 256, dict(window=100)),
    "D=256 not causal": (2, 130, 4, 2, 256, dict(causal=False)),
    "kv_len 70 of 100 not causal": (1, 100, 8, 4, 64,
                                    dict(causal=False, kv_len=70)),
    "kv_len 150 of 200 D=256": (1, 200, 8, 4, 256, dict(kv_len=150)),
    "kv_len 100 of 130 D=192 not causal": (1, 130, 8, 2, 192,
                                           dict(causal=False, kv_len=100)),
    "edge S=63 D=256": (1, 63, 4, 2, 256, {}),
    "edge S=65 D=256": (1, 65, 4, 2, 256, {}),
    "edge S=129 D=256 not causal": (1, 129, 4, 2, 256, dict(causal=False)),
    "edge S=65 D=192": (1, 65, 4, 2, 192, {}),
    "edge S=63 D=32": (1, 63, 4, 2, 32, {}),
}


def bwd_inputs(dev, B, S, H, KVH, D, dtype, seed, q_boost=1.0):
    rng = np.random.default_rng(seed)
    q = on(dev, rng.standard_normal((B, S, H, D)) * q_boost, dtype)
    k = on(dev, rng.standard_normal((B, S, KVH, D)), dtype)
    v = on(dev, rng.standard_normal((B, S, KVH, D)), dtype)
    dout = on(dev, rng.standard_normal((B, S, H, D)), dtype)
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BWD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_matches_plain(cuda, case, dtype):
    B, S, H, KVH, D, kw = BWD_CASES[case]
    kw = dict(kw, scale=D ** -0.5)
    boost = kw.pop("q_boost", 1.0)
    q, k, v, dout = bwd_inputs(cuda, B, S, H, KVH, D, DTYPES[dtype], S + D,
                               boost)
    out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    before = dict(FA.flash_attention_bwd_cuda.pass_launches)
    got = FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert all(FA.flash_attention_bwd_cuda.pass_launches[p] == before[p] + 1
               for p in FA.BWD_PASSES)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        rel_close(g, w, dtype)
    if kw.get("kv_len") is not None:      # keys past kv_len: no gradient
        for g in got[1:]:
            assert float(g[:, kw["kv_len"]:].abs().max()) == 0.0
    if kw.get("softcap"):
        # the cap binds: without it the plain gradient moves ten tolerances
        out0, lse0 = FA.flash_attention_plain(q, k, v, return_lse=True,
                                              **dict(kw, softcap=0.0))
        uncapped = FA.flash_attention_bwd_plain(q, k, v, out0, lse0, dout,
                                                **dict(kw, softcap=0.0))
        assert rel_err(uncapped[0], want[0]) > 10 * REL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [{}, dict(window=40, softcap=20.0),
                                dict(causal=False)],
                         ids=["causal", "window-softcap", "noncausal"])
def test_flash_attention_lse(cuda, D, dtype, kw):
    """The forward's lse is torch.logsumexp of the plain scores (scaled,
    capped, masked), at every head dim; asking for it leaves the output
    bit for bit as the serving path's."""
    B, S, H, KVH = 2, 150, 4, 2
    q, k, v, _ = bwd_inputs(cuda, B, S, H, KVH, D, DTYPES[dtype], D)
    kw = dict(kw, scale=D ** -0.5)
    out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, FA.flash_attention_cuda(q, k, v, **kw))
    kf = k.float().repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * kw["scale"]
    if kw.get("softcap"):
        s = torch.tanh(s / kw["softcap"]) * kw["softcap"]
    pos = torch.arange(S, device=cuda)
    ok = torch.ones(S, S, dtype=torch.bool, device=cuda)
    if kw.get("causal", True):
        ok &= pos[None] <= pos[:, None]
    if kw.get("window"):
        ok &= pos[None] > pos[:, None] - kw["window"]
    want = torch.logsumexp(torch.where(ok, s, -1e30), dim=-1)
    torch.testing.assert_close(lse, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_flash_attention_bwd_is_deterministic(cuda):
    q, k, v, dout = bwd_inputs(cuda, 2, 300, 8, 4, 128, torch.bfloat16, 3)
    kw = dict(scale=128 ** -0.5)
    out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    out2, lse2 = FA.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    a = FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    b = FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_flash_attention_fn_runs_both_kernels(cuda):
    """Under autograd ops.flash_attention goes through FlashAttentionFn:
    one forward and one backward launch, the gradients the plain ones."""
    q, k, v, dout = bwd_inputs(cuda, 1, 200, 8, 2, 128, torch.bfloat16, 4)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, scale=0.1, window=64)
    got = torch.autograd.grad(out, (q, k, v), dout)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    with torch.no_grad():
        o, lse = FA.flash_attention_plain(q, k, v, scale=0.1, window=64,
                                          return_lse=True)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, dout,
                                            scale=0.1, window=64)
    for g, w in zip(got, want):
        rel_close(g, w, "bfloat16")


@pytest.mark.cuda
def test_flash_attention_bwd_refuses_what_it_does_not_take(cuda):
    """A head dim outside the forward's is refused before the forward
    launches, a kv_len outside [0, T] by the backward's wrapper; a kv_len
    that cuts the keys trains (their rows of dk and dv are zero)."""
    q, k, v, dout = bwd_inputs(cuda, 1, 64, 4, 2, 96, torch.bfloat16, 5)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    with pytest.raises(ValueError, match="flash_attention_bwd: head_dim 96"):
        ops.flash_attention(q, k, v, scale=0.1)
    with pytest.raises(RuntimeError, match="carries no gradient"):
        FA.flash_attention_cuda(q, k, v, scale=0.1)
    q, k, v, dout = bwd_inputs(cuda, 1, 64, 4, 2, 64, torch.bfloat16, 5)
    out, lse = FA.flash_attention_cuda(q, k, v, return_lse=True, scale=0.1)
    with pytest.raises(ValueError, match="kv_len 65 outside"):
        FA.flash_attention_bwd_cuda(q, k, v, out, lse, dout, scale=0.1,
                                    kv_len=65)
    k = k.requires_grad_()
    out = ops.flash_attention(q, k, v, scale=0.1, kv_len=40)
    (dk,) = torch.autograd.grad(out, (k,), dout)
    assert float(dk[:, 40:].abs().max()) == 0.0
    assert float(dk[:, :40].abs().max()) > 0.0


@pytest.mark.cuda
def test_reduced_training_step_kernel_path_matches_plain_path(cuda):
    """olmo-1b at smoke width (head_dim 64) on the card: one loss and gradient on the kernel path (flash
    forward and backward kernels, remat recomputing each block) against
    the plain path (blocked_attention under autograd) from the same
    parameters and batch.  Loss within 1e-2; each gradient's cosine with
    the plain one at least 0.99 (bf16 rounds at other places)."""
    import dataclasses
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import make_batch
    from repro_torch.training.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), head_dim=64)
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params = kernel.init(0, device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_batch(cfg, 2, 200, step=0).items()}
    ops.reset_launch_counts()
    loss_k, _, grads_k = loss_and_grads(kernel, params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.num_layers     # remat
    assert counts["flash_attention_bwd"] == cfg.num_layers
    loss_p, _, grads_p = loss_and_grads(plain, params, batch)
    assert abs(float(loss_k) - float(loss_p)) < 1e-2
    for (path, a), b in zip(TR.flatten_with_paths(grads_k),
                            TR.leaves(grads_p)):
        a, b = a.float().flatten(), b.float().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos > 0.99, (path, cos)


@pytest.mark.cuda
def test_reduced_gemma2_training_step_kernel_path_matches_plain_path(cuda):
    """gemma2-2b at smoke width but its full head_dim 256 (window 16,
    softcaps, G = 2) on the card: one loss and gradient through the
    backward kernel at D = 256 against the plain path, as above."""
    import dataclasses
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import make_batch
    from repro_torch.training.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              head_dim=256)
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params = kernel.init(0, device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_batch(cfg, 2, 200, step=0).items()}
    ops.reset_launch_counts()
    loss_k, _, grads_k = loss_and_grads(kernel, params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd"] == cfg.num_layers
    loss_p, _, grads_p = loss_and_grads(plain, params, batch)
    assert abs(float(loss_k) - float(loss_p)) < 1e-2
    for (path, a), b in zip(TR.flatten_with_paths(grads_k),
                            TR.leaves(grads_p)):
        a, b = a.float().flatten(), b.float().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos > 0.99, (path, cos)


# ------------------------------------------------------- the SSD backward
# name -> (B, S, H, P, G, N, chunk, initial state and a final state's
# gradient): chip_smoke.py's shapes, mamba2-780m's training batch first
SSD_BWD_CASES = {
    "mamba2-780m training": (4, 2048, 48, 64, 1, 128, 256, False),
    "mamba2-780m .reduced()": (2, 100, 16, 16, 1, 16, 32, False),
    "G=2": (2, 300, 8, 64, 2, 128, 64, False),
    "jamba H=256 one group": (1, 1024, 256, 64, 1, 128, 256, False),
    "ragged tail": (2, 333, 4, 64, 1, 128, 128, False),
    "initial state, dfinal": (2, 200, 4, 32, 2, 64, 64, True),
    "S < chunk": (1, 20, 2, 32, 1, 32, 256, True),
    "P=N=128": (1, 300, 4, 128, 1, 128, 256, True),
    "P=128 N=16 G=4": (1, 150, 8, 128, 4, 16, 32, True),
    "P=16 N=128": (2, 70, 4, 16, 1, 128, 64, False),
}
# each gradient's error within this share of its norm: the same fp32 sums
# in another order; bf16 also rounds dx, dB and dC once.  dA is held to
# DA_REL_TOL: one sum a head over every row of the batch, of terms that
# cancel (|dA| is down to a fiftieth of the sum of its terms' magnitudes
# at these shapes), each itself a cumsum of the cancelling dcum
SSD_BWD_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
DA_REL_TOL = 1e-3
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def ssd_bwd_tol(name, dtype):
    return DA_REL_TOL if name == "dA" else SSD_BWD_REL_TOL[dtype]


def ssd_bwd_inputs(dev, case, dtype):
    B, S, H, P, G, N, chunk, init = SSD_BWD_CASES[case]
    args, st = ssd_inputs(dev, S + P + N, B, S, H, P, G, N, DTYPES[dtype],
                          init)
    rng = np.random.default_rng(S + H)
    dy = on(dev, rng.standard_normal((B, S, H, P)), DTYPES[dtype])
    dfinal = (on(dev, rng.standard_normal((B, H, P, N)), torch.float32)
              if init else None)
    return args, st, dy, dfinal, chunk


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SSD_BWD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_bwd_matches_plain(cuda, case, dtype):
    args, st, dy, dfinal, chunk = ssd_bwd_inputs(cuda, case, dtype)
    check_ssd_bwd(args, st, dy, dfinal, chunk, dtype)


def check_ssd_bwd(args, st, dy, dfinal, chunk, dtype):
    """One call of the backward kernel against the plain version: each
    pass launched once, bf16 on the tensor cores ("wgmma") and fp32 on
    CUDA cores, each gradient within its share of its norm."""
    kw = dict(chunk=chunk, initial_state=st)
    variant = "wgmma" if dtype == "bfloat16" else "cuda_core"
    before = dict(SSD.ssd_scan_bwd_cuda.pass_launches)
    before_variant = dict(SSD.ssd_scan_bwd_cuda.variant_launches)
    got = SSD.ssd_scan_bwd_cuda(*args, dy, dfinal, **kw)
    torch.cuda.synchronize()
    assert SSD.ssd_scan_bwd_cuda.pass_launches == {
        p: n + 1 for p, n in before.items()}
    assert SSD.ssd_scan_bwd_cuda.variant_launches == {
        k: n + (k == variant) for k, n in before_variant.items()}
    want = SSD.ssd_scan_bwd_plain(*args, dy, dfinal, **kw)
    for name, g, w in zip(SSD_GRADS, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert rel_err(g, w) < ssd_bwd_tol(name, dtype), (name,
                                                          rel_err(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("S,chunk", [
    (63, 64), (64, 64), (65, 64), (129, 64),
    (63, 256), (64, 256), (65, 256), (129, 256)])
def test_ssd_scan_bwd_tile_edges(cuda, S, chunk, init):
    """mamba2-780m's widths (P 64, N 128, one group) at the edges of the
    bf16 kernel's 64-row tiles, with and without an initial state and a
    final state's gradient."""
    B, H, P, G, N = 2, 8, 64, 1, 128
    args, st = ssd_inputs(cuda, S + P + N, B, S, H, P, G, N, torch.bfloat16,
                          init)
    rng = np.random.default_rng(S + H)
    dy = on(cuda, rng.standard_normal((B, S, H, P)), torch.bfloat16)
    dfinal = (on(cuda, rng.standard_normal((B, H, P, N)), torch.float32)
              if init else None)
    check_ssd_bwd(args, st, dy, dfinal, chunk, "bfloat16")


@pytest.mark.cuda
def test_ssd_scan_bwd_is_deterministic(cuda):
    args, st, dy, dfinal, chunk = ssd_bwd_inputs(
        cuda, "initial state, dfinal", "bfloat16")
    kw = dict(chunk=chunk, initial_state=st)
    a = SSD.ssd_scan_bwd_cuda(*args, dy, dfinal, **kw)
    b = SSD.ssd_scan_bwd_cuda(*args, dy, dfinal, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_ssd_scan_fn_runs_both_kernels(cuda):
    """Under autograd ops.ssd_scan goes through SSDScanFn: one forward
    launch, one call of the backward (its four passes, on the tensor
    cores), the gradients the plain ones; the scan's own wrapper still
    refuses autograd."""
    (x, dt, A, Bm, Cm), st, dy, dfinal, chunk = ssd_bwd_inputs(
        cuda, "initial state, dfinal", "bfloat16")
    ins = [t.requires_grad_() for t in (x, dt, A, Bm, Cm, st)]
    ops.reset_launch_counts()
    y, final = ops.ssd_scan(*ins[:5], chunk=chunk, initial_state=ins[5])
    got = torch.autograd.grad((y, final), ins, (dy, dfinal))
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
    assert SSD.ssd_scan_bwd_cuda.pass_launches == dict.fromkeys(
        SSD.BWD_PASSES, 1)
    assert SSD.ssd_scan_bwd_cuda.variant_launches == {"wgmma": 1,
                                                      "cuda_core": 0}
    with torch.no_grad():
        want = SSD.ssd_scan_bwd_plain(*ins[:5], dy, dfinal, chunk=chunk,
                                      initial_state=ins[5])
    for name, g, w in zip(SSD_GRADS, got, want):
        assert rel_err(g, w) < ssd_bwd_tol(name, "bfloat16"), name
    with pytest.raises(RuntimeError, match="ssd_scan: .*no gradient"):
        SSD.ssd_scan_cuda(*ins[:5], chunk=chunk)


@pytest.mark.cuda
def test_reduced_mamba2_training_step_kernel_path_matches_plain_path(cuda):
    """mamba2-780m at smoke width on the card: one loss and gradient
    through the SSD forward and backward kernels (remat: the forward twice
    a layer) against the plain path (ssd_chunked under autograd), as the
    attention models' steps above."""
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import make_batch
    from repro_torch.training.train_step import loss_and_grads
    cfg = get_config("mamba2-780m").reduced()
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params = kernel.init(0, device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_batch(cfg, 2, 200, step=0).items()}
    ops.reset_launch_counts()
    loss_k, _, grads_k = loss_and_grads(kernel, params, batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert ops.launch_counts() == {
        "flash_attention": 0, "flash_attention_bwd": 0,
        "paged_attention": 0, "ssd_scan": 2 * L, "ssd_scan_bwd": L}
    loss_p, _, grads_p = loss_and_grads(plain, params, batch)
    assert abs(float(loss_k) - float(loss_p)) < 1e-2
    for (path, a), b in zip(TR.flatten_with_paths(grads_k),
                            TR.leaves(grads_p)):
        a, b = a.float().flatten(), b.float().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos > 0.99, (path, cos)


# ---------------------- training the MoE blocks and the encoder-decoder
def moe_layer_case(dev, seed, d=None, capacity_factor=0.5):
    """mixtral-8x7b's smoke-width MoE layer on the card (bf16 experts, the
    fp32 router), d_model ``d`` if given, a capacity factor that drops
    slots, and unit-RMS rows [2, 96, d] (three chunks of 32)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    cfg = get_config("mixtral-8x7b").reduced()
    cfg = dataclasses.replace(cfg, d_model=d or cfg.d_model,
                              moe=dataclasses.replace(
                                  cfg.moe, capacity_factor=capacity_factor))
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = MOE.moe_params(cfg, gen, device=dev)
    x = torch.randn(2, 96, cfg.d_model, generator=gen, device=dev)
    return cfg, p, x.bfloat16()


def moe_grads(cfg, p, x, impl):
    from repro_torch.models import moe as MOE
    leaves = [p[n].requires_grad_() for n in sorted(p)] + \
        [x.requires_grad_()]
    y, aux = MOE.apply_moe(cfg, p, x, chunk_size=32, attn_impl=impl)
    loss = torch.sum(y.float() * torch.linspace(-1, 1, y.shape[-1],
                                                device=y.device)) + aux
    return torch.autograd.grad(loss, leaves)


@pytest.mark.cuda
def test_moe_sorted_dispatch_backward_matches_onehot(cuda):
    """The gradient through the sorted dispatch (the training path: per
    slot gathers and scatters by one permutation, one product an expert)
    against autograd through the one-hot dispatch, on the card, with
    capacity drops: x, the router and the three expert weights each
    within 2e-2 of its norm (bf16 products rounded at other places)."""
    from repro_torch.models import moe as MOE
    cfg, p, x = moe_layer_case(cuda, 11)
    r = MOE.route(cfg, p, x[:, :32], MOE.capacity(cfg, 32, False))
    assert not bool(r.keep.all())                 # slots are dropped
    got = moe_grads(cfg, p, x, "kernel")
    want = moe_grads(cfg, {n: t.detach() for n, t in p.items()},
                     x.detach(), "plain")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert rel_err(g, w) < 2e-2, rel_err(g, w)


@pytest.mark.cuda
def test_moe_sorted_dispatch_gradient_is_deterministic(cuda):
    """Two identical backward passes through the sorted dispatch give the
    same bits on the card (one writer to every gradient element: no
    accumulating index-put), at d_model 1024."""
    cfg, p, x = moe_layer_case(cuda, 12, d=1024)
    a = moe_grads(cfg, p, x, "kernel")
    b = moe_grads(cfg, p, x, "kernel")
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(2048, 2048), (200, 300)])
def test_flash_fp32_d64_not_causal_forward_and_backward(cuda, S, T):
    """seamless-m4t-medium's fp32 attention (the encoder, and the
    cross-attention of q widened to fp32 over the encoder's K/V), D = 64,
    not causal, through FlashAttentionFn: the output and (dq, dk, dv)
    within 2e-5 of their norms of the plain versions'."""
    rng = np.random.default_rng(S + T)
    q = on(cuda, rng.standard_normal((2, S, 16, 64)), torch.float32)
    k, v = (on(cuda, rng.standard_normal((2, T, 16, 64)), torch.float32)
            for _ in range(2))
    dout = on(cuda, rng.standard_normal((2, S, 16, 64)), torch.float32)
    kw = dict(causal=False, scale=0.125)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    assert FA.flash_attention_bwd_cuda.noncausal_launches == 1
    with torch.no_grad():
        o, lse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        want = FA.flash_attention_bwd_plain(q, k, v, o, lse, dout, **kw)
    rel_close(out.detach(), o, "float32")
    for g, w in zip(got, want):
        rel_close(g, w, "float32")


@pytest.mark.cuda
def test_mixed_dtype_cross_attention_takes_the_fp32_kernel(cuda):
    """A bf16 decoder's cross-attention over fp32 K/V: one fp32 kernel
    call on q widened (no plain attention), the output bf16, within the
    bf16 tolerance of the plain blocked_attention on the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("seamless-m4t-medium").reduced()
    gen = torch.Generator(device=cuda).manual_seed(13)
    p = L.attention_params(cfg, gen, device=cuda)
    x = torch.randn(2, 40, cfg.d_model, generator=gen,
                    device=cuda).bfloat16()
    k, v = (torch.randn(2, 56, cfg.num_kv_heads, cfg.head_dim,
                        generator=gen, device=cuda) for _ in range(2))
    ops.reset_launch_counts()
    with torch.no_grad():
        got = L.cross_attention_forward(cfg, p, x, k, v)
        assert ops.launch_counts()["flash_attention"] == 1
        assert FA.flash_attention_cuda.noncausal_launches == 1
        want = L.cross_attention_forward(cfg, p, x, k, v, attn_impl="plain")
    assert got.dtype == want.dtype == torch.bfloat16
    close(got, want, **tol_for("bfloat16"))


# the logits' product at nemotron-4-340b's width over a slice of its vocab
LOGITS_K, LOGITS_V = 18432, 32768
# ||got - want|| / ||want|| against the fp64 product of the same bf16
# values: fp32 sums meet it by far, a single bf16 rounding of partial sums
# breaks it by far (test_logits_read_the_bf16_head_with_fp32_sums)
LOGITS_REL_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("M", [1, 32])
def test_logits_read_the_bf16_head_with_fp32_sums(cuda, M, tied):
    """``Model._logits`` under inference mode on a plain bf16 head: one
    product of the bf16 operands as stored, summed and written in fp32.
    At K = 18432 over 32768 vocab rows (the untied [d, V] head and the
    tied [V, d] embedding), against the fp64 product of the same bf16
    values, ||err|| / ||want|| stays under LOGITS_REL_TOL = 1e-4 (on an
    H100 2.10e-5 in every case, the fp32 accumulation of its tensor
    cores), where two halves of K each summed exactly and rounded to bf16
    before they are added read 1.64e-3 to 1.66e-3: no bf16 partial sum
    enters, whatever ``allow_bf16_reduced_precision_reduction`` says.
    The argmax agrees with the widened fp32 product's, the call counts as
    ``bf16_f32``, and with grad enabled the same call widens the head
    instead."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import model as TM
    cfg = dataclasses.replace(get_config("nemotron-4-340b"),
                              vocab_size=LOGITS_V, tie_embeddings=tied)
    m = build_model(cfg)
    rng = np.random.default_rng(M + 2 * tied)
    x = on(cuda, rng.standard_normal((M, LOGITS_K), np.float32),
           torch.bfloat16)
    w = on(cuda, rng.standard_normal((LOGITS_K, LOGITS_V), np.float32)
           / LOGITS_K ** 0.5, torch.bfloat16)
    params = {"embed": w.t().contiguous()} if tied else {"head": w}
    want = x.double() @ w.double()

    def err64(got):
        return float((got.double() - want).norm() / want.norm())

    half = LOGITS_K // 2
    bf16_halves = sum((x[:, s].double() @ w[s].double()).bfloat16().double()
                      for s in (slice(0, half), slice(half, None)))
    before = dict(TM.LOGITS_PRODUCTS)
    with torch.inference_mode():
        got = m._logits(params, x)
    assert TM.LOGITS_PRODUCTS["bf16_f32"] == before["bf16_f32"] + 1
    assert TM.LOGITS_PRODUCTS["widened_f32"] == before["widened_f32"]
    assert got.dtype == torch.float32 and got.shape == (M, LOGITS_V)
    err, err_bf16 = err64(got), err64(bf16_halves)
    assert err < LOGITS_REL_TOL < err_bf16
    with torch.enable_grad():
        widened = m._logits(params, x)
    assert TM.LOGITS_PRODUCTS["bf16_f32"] == before["bf16_f32"] + 1
    assert TM.LOGITS_PRODUCTS["widened_f32"] == before["widened_f32"] + 1
    print(f"M={M} tied={tied}: bf16_f32 {err!r}, widened_f32 "
          f"{err64(widened)!r}, bf16 partial sums {err_bf16!r}")
    assert err64(widened) < LOGITS_REL_TOL
    assert torch.equal(got.argmax(-1), widened.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "seamless-m4t-medium",
                                  "jamba-1.5-large-398b"])
def test_reduced_moe_and_encdec_training_step_kernel_path_matches_plain_path(
        cuda, arch, monkeypatch):
    """At smoke width (head_dim 64) on the card: one loss and gradient on
    the kernel path (flash, the SSD scan and their backward kernels, the
    sorted MoE dispatch, remat) twice, bit for bit the same, with every
    attention layer's launches (seamless-m4t-medium trains on fp32 frames:
    its encoder and cross-attention launch the fp32 kernels, not causal);
    then against the plain path (blocked_attention, the one-hot
    dispatch).  seamless-m4t-medium in bf16: loss within 1e-2, each
    gradient's cosine at least 0.99.  mixtral-8x7b in fp32 (every
    parameter, and the embedding not rounded to bf16): loss within 1e-4,
    cosines at least 0.9999.  In bf16 the two paths round the router's
    input at other places, and at this width a near-tied top-k pick that
    flips between them, with the capacity drops it moves, takes the
    router's gradient to cosine 0.986 (CPU, plain versions); in fp32 both
    paths pick the same experts.  jamba-1.5-large (fp32, as mixtral) is
    held path by path (``jamba_paths_one_at_a_time``)."""
    import dataclasses
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import model as TMM
    from repro_torch.training import make_batch
    from repro_torch.training.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=64)
    kernel, plain = build_model(cfg), build_model(cfg, attn_impl="plain")
    params = kernel.init(0, device=cuda)
    batch = {k: torch.from_numpy(v).to(cuda)
             for k, v in make_batch(cfg, 2, 200, step=0).items()}
    ops.reset_launch_counts()
    loss_k, _, grads_k = loss_and_grads(kernel, params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n_attn = (cfg.encoder_layers + 2 * cfg.num_layers if cfg.is_encdec
              else cfg.num_layers // (cfg.attn_every or 1))
    assert counts["flash_attention"] == 2 * n_attn     # remat
    assert counts["flash_attention_bwd"] == n_attn
    assert FA.flash_attention_bwd_cuda.noncausal_launches == (
        cfg.encoder_layers + cfg.num_layers if cfg.is_encdec else 0)
    loss_2, _, grads_2 = loss_and_grads(kernel, params, batch)
    assert torch.equal(loss_k, loss_2)
    assert all(torch.equal(a, b) for a, b in zip(TR.leaves(grads_k),
                                                 TR.leaves(grads_2)))
    if cfg.attn_every:
        jamba_paths_one_at_a_time(cfg, kernel, batch, cuda, monkeypatch)
        return
    loss_tol, min_cos = 1e-2, 0.99
    if cfg.moe is not None:
        monkeypatch.setattr(TMM.Model, "_embed",
                            lambda self, p, t: p["embed"][t])
        params = TR.map_tree(lambda t: t.detach().float(), params)
        loss_k, _, grads_k = loss_and_grads(kernel, params, batch)
        loss_tol, min_cos = 1e-4, 0.9999
    loss_p, _, grads_p = loss_and_grads(plain, params, batch)
    assert abs(float(loss_k) - float(loss_p)) < loss_tol
    for (path, a), b in zip(TR.flatten_with_paths(grads_k),
                            TR.leaves(grads_p)):
        a, b = a.float().flatten(), b.float().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos > min_cos, (path, cos)


def jamba_paths_one_at_a_time(cfg, model, batch, cuda, monkeypatch):
    """jamba-1.5-large .reduced() at head_dim 64 (``cfg``, ``model``), fp32
    (every parameter, the embedding not rounded), one loss and gradient of
    the 2 x 200 ``batch``, its three paths swapped between kernel and
    plain one at a time
    (``tools/jamba_path_swap.py`` runs every combination, and a float64
    reference).  The card's measurement there (NVIDIA H100 80GB HBM3,
    700 W): with the MoE on the one-hot dispatch, the scan and flash
    kernels move the loss by 0 and each gradient leaf by at most 1.1e-4
    of its norm; with the scan and attention plain, the sorted dispatch
    moves the loss by 0 and a leaf by 1.8e-5; every such combination
    routes each slot as the all-plain path does.  Only the scan kernel
    and the sorted dispatch together moved it: 8 top-k picks flipped
    (near ties, which the two paths' fp32 roundings, summed in other
    orders, tip apart) and the loss by 4.3e-4 (the 4.3e-4 this test's
    predecessor saw), 4.3e-4 from float64 too; no capacity drop moved.
    So: with every slot routed alike, the loss within 1e-5 and every leaf
    within 1e-3 of its norm (cosine at least 0.99999); the whole kernel
    path's flips at most 1 % of the slots, its loss within 1e-3."""
    from repro_torch import tree as TR
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import model as TMM
    from repro_torch.models import moe as MOE
    from repro_torch.training.train_step import loss_and_grads
    monkeypatch.setattr(TMM.Model, "_embed", lambda self, p, t: p["embed"][t])
    params = TR.map_tree(lambda t: t.detach().float(),
                         model.init(0, device=cuda))
    saved = (M.mamba_forward, L.attention_forward, MOE.apply_moe, MOE.route)

    def run(scan, attn, moe):
        routes = []

        def on(fn, impl):
            return lambda *a, **kw: fn(*a, **dict(kw, attn_impl=impl))

        def route(*a, **kw):
            r = saved[3](*a, **kw)
            routes.append((r.idx, r.keep))
            return r
        monkeypatch.setattr(M, "mamba_forward", on(saved[0], scan))
        monkeypatch.setattr(L, "attention_forward", on(saved[1], attn))
        monkeypatch.setattr(MOE, "apply_moe", on(saved[2], moe))
        monkeypatch.setattr(MOE, "route", route)
        loss, _, grads = loss_and_grads(model, params, batch)
        return float(loss), TR.leaves(grads), routes

    plain = run("plain", "plain", "plain")
    slots = sum(idx.numel() for idx, _ in plain[2])
    for combo in (("kernel", "kernel", "plain"), ("plain", "plain", "kernel")):
        loss, grads, routes = run(*combo)
        assert all(torch.equal(a, b) and torch.equal(c, d) for (a, c), (b, d)
                   in zip(routes, plain[2])), combo
        assert abs(loss - plain[0]) < 1e-5, (combo, loss, plain[0])
        for g, w in zip(grads, plain[1]):
            g, w = g.flatten(), w.flatten()
            assert float((g - w).norm() / w.norm()) < 1e-3, combo
            assert float(g @ w / (g.norm() * w.norm())) > 0.99999, combo
    loss, _, routes = run("kernel", "kernel", "kernel")
    flips = sum(int((a != b).sum()) for (a, _), (b, _) in zip(routes,
                                                              plain[2]))
    assert flips <= 0.01 * slots, (flips, slots)
    assert abs(loss - plain[0]) < 1e-3, (loss, plain[0])


# ------------------------------------------------- the distributed layer
@pytest.fixture
def nccl_world(cuda):
    """A NCCL process group of one rank (a HashStore: no port), destroyed
    after the test."""
    import torch.distributed as dist
    torch.cuda.set_device(0)        # the mesh's communicators' device
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield dist
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_compressed_allreduce_at_one_rank_is_the_int8_fake_quant(
        nccl_world):
    """At one rank the compressed all-reduce and the int8 fake-quant
    compute the same function: the same bits, both dtypes, every shape,
    and on a transposed (not contiguous) gradient, as autograd may hand
    one (NCCL gathers into contiguous buffers alone)."""
    from repro_torch.distributed.collectives import compressed_allreduce
    from repro_torch.training import quantize_dequantize_int8
    reduce = compressed_allreduce(nccl_world.group.WORLD)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((7,), (33, 65), (4, 2048, 129)):
        for dtype in (torch.float32, torch.bfloat16):
            g = (torch.randn(shape, generator=gen, device="cuda")
                 * 3e-3).to(dtype)
            for x in (g, g.transpose(0, -1)):
                got, want = reduce(x), quantize_dequantize_int8(x)
                assert got.dtype == dtype and torch.equal(got, want), \
                    (shape, dtype, x.is_contiguous())


@pytest.mark.cuda
def test_placements_on_a_one_by_one_cuda_mesh(nccl_world):
    """olmo-1b .reduced() laid out by the train rules on the 1 x 1 (data,
    model) mesh: each local shard is the whole parameter; the production
    mesh needs 256 ranks and refuses one."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MeshConfig
    from repro_torch.distributed.sharding import (make_rules,
                                                  make_shardings)
    from repro_torch.launch.mesh import (make_mesh_from_config,
                                         make_production_mesh)
    from repro_torch.models import build_model
    mcfg = MeshConfig((1, 1), ("data", "model"))
    mesh = make_mesh_from_config(mcfg)
    assert mesh.device_type == "cuda"
    cfg = get_config("olmo-1b").reduced()
    ann = build_model(cfg).init_annotated(0, device="cuda")
    shardings = make_shardings(mesh, make_rules(cfg, mcfg, "train"), ann)
    sharded = 0
    for p, s in zip(TR.leaves(ann), TR.leaves(shardings)):
        d = s.distribute(p.value)
        assert isinstance(d, DTensor) and d.device_mesh is mesh
        assert torch.equal(d.to_local(), p.value)
        sharded += any(isinstance(pl, Shard) for pl in d.placements)
    assert sharded > 0
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()


@pytest.mark.cuda
def test_run_with_restarts_on_the_card_ends_bit_for_bit(nccl_world,
                                                        tmp_path):
    """olmo-1b .reduced() on the kernel path (flash and its backward), its
    gradients through the compressed all-reduce, six steps under
    run_with_restarts with a failure after step 1 has written into the
    state and one before step 4: the final state equals an uninterrupted
    run's bit for bit."""
    from repro_torch import tree as TR
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault_tolerance import (InjectedFailure,
                                                         run_with_restarts)
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_batch,
                                      make_train_step)
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=6),
                       grad_compression="int8")
    step = make_train_step(model, tcfg, group=nccl_world.group.WORLD)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                make_batch(cfg, 2, 256, step=i).items()} for i in range(6)]

    def fresh():
        params, opt = init_train_state(model, tcfg, 0, device="cuda")
        return {"params": params, "opt": opt}

    clean = fresh()
    for i in range(6):
        p, o, _ = step(clean["params"], clean["opt"], batches[i])
        clean = {"params": p, "opt": o}
    pending = {"after": {1}, "before": {4}}

    def step_fn(i, state):
        if i in pending["before"]:
            pending["before"].discard(i)
            raise InjectedFailure(f"before {i}")
        p, o, _ = step(state["params"], state["opt"], batches[i])
        if i in pending["after"]:
            pending["after"].discard(i)
            raise InjectedFailure(f"after {i}")
        return {"params": p, "opt": o}

    ops.reset_launch_counts()
    out = run_with_restarts(6, step_fn, fresh(),
                            Checkpointer(str(tmp_path), keep=2),
                            save_every=2)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bwd"] == \
        cfg.num_layers * 8              # eight step executions
    for (path, a), (_, b) in zip(TR.flatten_with_paths(out),
                                 TR.flatten_with_paths(clean)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
