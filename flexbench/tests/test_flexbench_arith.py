"""The benchmark's operation and byte counts against hand counts at a
small shape."""
import pytest

import flexbench_tiny  # noqa: F401
from flexbench.lib import arith


def test_causal_pairs_by_hand():
    assert arith.causal_pairs(4) == 1 + 2 + 3 + 4
    assert arith.causal_pairs(5, window=2) == 1 + 2 + 2 + 2 + 2
    assert arith.causal_pairs(3, window=8) == 6
    for S, w in ((37, 5), (64, 64), (100, 33)):
        assert arith.causal_pairs(S, w) == sum(min(i + 1, w)
                                               for i in range(S))


def test_flash_call_by_hand():
    # S=3, H=2, KVH=1, D=4: 6 pairs x 4 H D = 6 * 4 * 2 * 4
    flops, nbytes = arith.flash_call(3, 2, 1, 4)
    assert flops == 6 * 4 * 2 * 4
    # q and out 3*2*4 each, k and v 3*1*4 each, 2 bytes
    assert nbytes == 2 * (24 + 12) * 2


def test_paged_call_by_hand():
    flops, nbytes = arith.paged_call([3, 1], H=2, KVH=1, D=4, ps=2)
    assert flops == 4 * 2 * 4 * 4
    # q, out: 2 rows x 2 x 4 x 2 B each; K and V rows: 4 tokens x 4 x 2 B
    # each; pages: ceil(3/2) + ceil(1/2) = 3 int32; lengths 2 int32
    assert nbytes == 2 * 16 * 2 + 2 * 4 * 4 * 2 + 3 * 4 + 2 * 4


def test_bound_takes_the_larger():
    assert arith.bound_s(989e12, 0) == pytest.approx(1.0)
    assert arith.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert arith.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


MOE = dict(num_layers=2, d_model=8, num_heads=2, num_kv_heads=1,
           head_dim=4, d_ff=16, vocab_size=10, activation="swiglu",
           sliding_window=3, moe={"num_experts": 4, "top_k": 2})
DENSE = dict(MOE, activation="sq_relu", moe=None, sliding_window=0)


def test_model_flops_by_hand():
    m = arith.ModelArith(MOE)
    attn = 8 * 2 * 4 * 2 + 8 * 1 * 4 * 2          # q, o; k, v
    ffn = 8 * 4 + 2 * 3 * 8 * 16                   # router, 2 experts
    assert m.layer_params == attn + ffn
    S = 5                                          # pairs 1+2+3+3+3 = 12
    want = 2 * (2 * S * (attn + ffn) + 4 * 2 * 4 * 12) + 2 * 8 * 10
    assert m.prefill_flops(S) == want
    assert m.decode_flops([3, 1]) == sum(
        2 * (2 * (attn + ffn) + 4 * 2 * 4 * c) + 2 * 8 * 10 for c in (3, 1))
    d = arith.ModelArith(DENSE)
    assert d.layer_params == attn + 2 * 8 * 16
    assert d.prefill_flops(2) == 2 * (2 * 2 * (attn + 2 * 8 * 16)
                                      + 4 * 2 * 4 * 3) + 2 * 8 * 10


def test_page_size():
    assert arith.page_size(4096) == 64 and arith.page_size(48) == 16
