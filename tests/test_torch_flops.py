"""The port's FLOP count of a training step against the JAX package's.

One training step of olmo-1b, mixtral-8x7b and mamba2-780m ``.reduced()``
at batch 1: ``FlopCounterMode`` over the port's ``loss_and_grads`` on
``meta`` tensors (the plain path, which the dry-run traces), and
``hlo_analysis.analyze`` of the JAX package's ``make_train_step``
compiled on one CPU device.

The sizes avoid padding: the reference's ``blocked_attention`` pads q to
a multiple of ``block_q`` = 512 and k/v to ``block_kv`` = 1024, so at
batch 2 x 256 it multiplies 8 times the (q, k) pairs the port does (the
port counted 0.281 of JAX's FLOPs for olmo-1b there, 0.518 for
mixtral-8x7b; measured).  Both checkpoint each q block and each kv block
inside it, so the backward recomputes their score and value products.
Measured, with what is left explained:

* olmo-1b at 1 x 2048 (two kv blocks a q block): equal, 5.7982e10 (and
  at olmo-1b's production cell, 256 x 4096, equal too: 1.24047e16);
* a q block of one kv block (S = 1024): the port recomputes its score
  product once more than XLA, whose nested recomputes share it there:
  2 B H bq bk D a block pair a layer (olmo-1b and mixtral-8x7b at
  1 x 1024 both 1.0737e9 above JAX); mixtral-8x7b runs at 1024, since
  at 2048 its MoE routes two capacity chunks, where the port counts
  4.1 % more and no reason is shown yet;
* mamba2-780m at 1 x 2048: the port counts 0.99901 of JAX's 8.4641e9,
  the SSD scan's three-operand einsums, which torch contracts pairwise
  left to right and XLA in its own order (their intermediate products
  differ); the bound is 2e-3.
"""
import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import unbox as jax_unbox
from repro.launch import hlo_analysis
from repro.models import build_model as jax_build_model
from repro.training import TrainConfig, adamw_init, make_batch
from repro.training import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import unbox
from repro_torch.models import build_model
from repro_torch.training.train_step import loss_and_grads

BATCH = 1
BLOCK_Q, BLOCK_KV = 512, 1024        # the reference's blocked_attention


def jax_step_flops(arch: str, seq: int) -> float:
    model = jax_build_model(jax_get_config(arch).reduced())
    params = jax_unbox(jax.eval_shape(model.init, jax.random.PRNGKey(0)))
    tcfg = TrainConfig()
    opt = jax.eval_shape(lambda p: adamw_init(tcfg.opt, p), params)
    batch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in make_batch(model.cfg, BATCH, seq).items()}
    compiled = jax.jit(jax_make_train_step(model, tcfg)).lower(
        params, opt, batch).compile()
    return hlo_analysis.analyze(compiled.as_text()).flops


def port_step_flops(arch: str, seq: int) -> float:
    model = build_model(get_config(arch).reduced(), attn_impl="plain")
    params = unbox(model.init_annotated(0, device="meta"))
    batch = {"tokens": torch.empty(BATCH, seq, dtype=torch.int32,
                                   device="meta")}
    with FlopCounterMode(display=False) as fc:
        loss_and_grads(model, params, batch)
    return float(fc.get_total_flops())


def score_recompute_flops(arch: str, seq: int) -> float:
    """The score product the port recomputes once more than XLA for each
    (q, kv) block pair whose q block has one kv block."""
    cfg = get_config(arch).reduced()
    pairs = (seq // BLOCK_Q) * (seq // BLOCK_KV)
    if cfg.attention_free or seq > BLOCK_KV:
        return 0.0
    return (2.0 * BATCH * cfg.num_heads * BLOCK_Q * BLOCK_KV * cfg.head_dim
            * pairs * cfg.num_attention_layers())


@pytest.mark.parametrize("arch,seq", [("olmo-1b", 2048),
                                      ("mixtral-8x7b", 1024)])
def test_attention_step_flops_equal_jax(arch, seq):
    assert port_step_flops(arch, seq) == \
        jax_step_flops(arch, seq) + score_recompute_flops(arch, seq)


def test_mamba2_step_flops_match_jax():
    port = port_step_flops("mamba2-780m", 2048)
    ref = jax_step_flops("mamba2-780m", 2048)
    assert abs(port / ref - 1.0) < 2e-3, port / ref
