"""The paged-attention split plan and the split plain version.

``split_plan`` cuts each sequence's capacity into the ranges that the CUDA
kernel's blocks take; ``paged_attention_plain`` computes one partial
(m, l, acc) per range and merges them as the kernel's last block does.
Here the plan's coverage is checked on its own, and the plain version with
1, 2, 5 and 16 splits is held against the JAX oracle
(``repro.kernels.ref.ref_paged_attention``) and the Pallas kernel run in
``interpret=True``, with empty splits and a length of 1 among the inputs.

Tolerances follow ``tests/test_kernels.py::tol_for``: 2e-5 in fp32 (both
sides compute in fp32, in another summation order), 2e-2 in bf16 (both
sides round the fp32 result to bf16, so they may differ by one bf16 step).
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jax_paged
from repro.kernels import ref as JR
from repro_torch.kernels import paged_attention as PA

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol_for(dtype_name):
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,KVH,capacity,sms", [
    (4, 16, 960, 132),            # olmo-1b's engine shape: 5 splits
    (1, 1, 960, 132),             # clamped to capacity / NT
    (3, 2, 100, 132),             # capacity off a multiple of NT
    (2, 4, 7, 132),               # capacity below NT
    (5, 3, 480, 10),
    (64, 8, 4096, 132),           # B * KVH >= 2 * SMs
])
def test_split_plan_covers_every_token_once(B, KVH, capacity, sms):
    n_split, span = PA.split_plan(B, KVH, capacity, sms)
    assert n_split >= 1 and span % PA.NT == 0
    hits = np.zeros(capacity, np.int64)
    for s in range(n_split):
        lo, hi = s * span, min((s + 1) * span, capacity)
        assert lo < hi, f"split {s} of {n_split} is empty by the plan"
        hits[lo:hi] += 1
    assert (hits == 1).all()
    assert n_split <= -(-2 * sms // (B * KVH))


@pytest.mark.parametrize("B,KVH,sms", [(4, 66, 132), (264, 1, 132),
                                       (16, 32, 132), (8, 8, 16)])
def test_split_plan_is_one_split_when_the_grid_fills_the_card(B, KVH, sms):
    assert B * KVH >= 2 * sms
    assert PA.split_plan(B, KVH, 4096, sms) == (1, PA.NT * 128)


def test_split_plan_reads_no_lengths(monkeypatch):
    """The plan's inputs are shapes and the SM count, so the decode path
    never waits on the card for ``lengths``."""
    assert list(inspect.signature(PA.split_plan).parameters) == \
        ["batch", "kv_heads", "capacity", "sms"]
    seen = []
    real = PA.split_plan
    monkeypatch.setattr(PA, "split_plan",
                        lambda *a: seen.append(a) or real(*a))
    q, kp, vp, pt, _ = paged_case(np.random.default_rng(0), 2, 4, 2, 32, 8,
                                  6, [1, 1])
    for lens in ([1, 48], [48, 1], [0, 17]):
        PA.paged_attention_plain(q[1], kp[1], vp[1], pt[1],
                                 torch.tensor(lens, dtype=torch.int32),
                                 scale=0.2)
    assert len(seen) == 3 and len(set(seen)) == 1


def both(x, dtype_name="float32"):
    jd, td = DTYPES[dtype_name]
    x = np.asarray(x)
    if x.dtype.kind in "iu":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    x = x.astype(np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x.copy()).to(td)


def paged_case(rng, B, H, KVH, D, ps, maxp, lengths, dtype="float32"):
    """Inputs as (jax, torch) pairs over a permuted page table."""
    P = B * maxp + 1
    pt = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    arrays = [both(rng.standard_normal(s), dtype) for s in
              ((B, H, D), (P, ps, KVH, D), (P, ps, KVH, D))]
    return arrays + [both(pt), both(np.asarray(lengths, np.int32))]


# (n_split wanted, B, KVH, ps, maxp): under CPU_SMS = 132 the plan asks
# for ceil(264 / (B * KVH)) splits of the capacity ps * maxp
SPLITS = [(1, 3, 88, 32, 2), (2, 3, 44, 32, 4), (5, 3, 18, 32, 15),
          (16, 17, 1, 32, 16)]


@pytest.mark.parametrize("n_split,B,KVH,ps,maxp", SPLITS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_jax(n_split, B, KVH, ps, maxp, dtype):
    H, D = 2 * KVH, 64
    capacity = ps * maxp
    assert PA.split_plan(B, KVH, capacity, PA.sm_count("cpu"))[0] == n_split
    # a length of 1 (every split but the first empty), the full capacity,
    # and lengths that end inside a split
    lengths = [1, capacity, capacity // 3 + 5] + [
        1 + (7 * i) % capacity for i in range(B - 3)]
    args = paged_case(np.random.default_rng(n_split), B, H, KVH, D, ps,
                      maxp, lengths, dtype)
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    scale = D ** -0.5
    want = JR.ref_paged_attention(*jargs, scale=scale)
    pallas = jax_paged(*jargs, scale=scale, interpret=True)
    got = PA.paged_attention_plain(*targs, scale=scale)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, H, D)
    for ref in (want, pallas):
        np.testing.assert_allclose(np.asarray(got.float()),
                                   np.asarray(ref, np.float32),
                                   **tol_for(dtype))


def test_split_plain_softcap_and_empty_sequence():
    """Softcap across 5 splits, and a length of 0: every split empty, so
    the merge's guarded denominator gives zeros, as the unsplit kernel
    did."""
    B, H, KVH, D, ps, maxp = 3, 36, 18, 32, 32, 15
    assert PA.split_plan(B, KVH, ps * maxp, PA.sm_count("cpu"))[0] == 5
    args = paged_case(np.random.default_rng(7), B, H, KVH, D, ps, maxp,
                      [0, 200, 3])
    jargs, targs = [a[0] for a in args], [a[1] for a in args]
    kw = dict(scale=0.6, softcap=30.0)
    got = PA.paged_attention_plain(*targs, **kw)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = JR.ref_paged_attention(*jargs, **kw)
    np.testing.assert_allclose(np.asarray(got[1:]), np.asarray(want)[1:],
                               rtol=2e-5, atol=2e-5)
