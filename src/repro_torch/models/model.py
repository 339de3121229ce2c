"""Model API for the port's slices: the dense decoder, Mixture-of-Experts
decoders, attention-free Mamba-2, hybrid Mamba/attention stacks and the
encoder-decoder.

``build_model(cfg)`` returns a ``Model`` whose methods are functions of
(params, batch/cache), as in the JAX package:

    init(seed, device=)             -> param tree (plain dicts of tensors)
    init_annotated(seed, device=)   -> the same tree, each leaf a ``Param``
                                       boxed with its logical axes (the JAX
                                       twin's ``init``); device="meta"
                                       gives shapes alone
    forward(params, batch, remat=, dropless=)
                                    -> (hidden [B,S,d], aux) (teacher-forced)
    loss(params, batch, remat=)     -> (loss, {ce, aux, tokens}) (training)
    init_cache(B, max_len, enc_len=0, device=)
                                    -> cache (one stacked dict per pattern
                                       position: K/V for an attention
                                       block, conv/ssm state for a Mamba
                                       one; an encoder-decoder's stacked
                                       self K/V and its cross K/V)
    cache_axes(max_len)             -> logical-axes tree for the cache
    prefill(params, batch, cache)   -> (logits [B,V], cache, lengths)
    decode(params, tokens, cache, lengths) -> (logits [B,V], cache)
    input_specs(shape)              -> ({name: meta tensor}, {name: axes})
                                       for the dry-run

The slices cover the dense decoder olmo-1b needs, the attention-free
Mamba-2 stack of mamba2-780m, and the attention variants: gemma2-2b's
sliding windows with ring-buffer caches, local/global alternation, logit
softcaps, post-norms and scaled embeddings; starcoder2-3b's window on
every layer, LayerNorm and GELU; qwen2-vl-2b's VLM backbone, fed token ids
or precomputed ``embeds`` with M-RoPE ``[3, B, S]`` positions; int8 KV
caches (nemotron-4-340b); the MoE FFNs of mixtral-8x7b and grok-1-314b
(top-k routing with per-row expert capacity, dropless in prefill and
decode); jamba-1.5-large's hybrid stack (``attn_every``: Mamba-2 mixers
with one attention block a pattern, MoE FFNs every other block, no
positional embedding); and seamless-m4t-medium's encoder-decoder
(``encoder_layers``: learned position tables, a bidirectional encoder
over precomputed frame embeddings, a decoder with self- and
cross-attention; its batches are ``{"src_embeds", "tgt_tokens"}``).  As
in the JAX package, only the encoder-decoder owns position tables: a
decoder-only config with ``pos_emb=LEARNED`` runs with no positional
signal.  A hybrid config without its ``ssm`` block, which cannot build
its Mamba mixers, is refused as invalid.

Training (``loss``) covers every family the JAX package trains: on the
card each attention layer's backward runs the flash attention backward
kernel and each Mamba-2 layer's the SSD-scan backward kernel; MoE FFNs
(mixtral-8x7b, grok-1-314b, jamba-1.5-large's hybrid) route with capacity
and differentiate through the sorted dispatch (``models/moe.py``); the
encoder-decoder trains on ``training/data.py``'s fp32 frames, its encoder
in fp32 (``models/encdec.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import Family, ModelConfig, ShapeConfig, \
    ShapeKind
from repro_torch.core import profiler as _prof
from repro_torch.core import spans as _spans
from repro_torch.device import require_device
from repro_torch.distributed.sharding import (einsum_per_rank, embed_rows,
                                              is_dtensor, local_shape,
                                              logsumexp_last, shard_act,
                                              take_last)
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


# the fp32 copy of the head that a widened logits call makes, at most this
# many bytes at a time: two calls at once must not hold two whole copies
# of a large head (nemotron-4-340b's 256000 x 18432 is 18.9 GB in fp32;
# every other head the port serves is one chunk).  Serving on a card
# reads the bf16 head as stored and makes no copy
LOGITS_CHUNK_BYTES = 4 << 30

# calls of Model._logits by the product each took (see there), in the
# manner of the kernels' launch counts
LOGITS_PRODUCTS = {"bf16_f32": 0, "widened_f32": 0}

CE_CHUNK = 512  # sequence-chunked cross-entropy (bounds the logits buffer)


def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # "kernel" | "plain": the hand-written kernels (prefill and decode
    # attention, the SSD scan) and the sorted MoE dispatch, or the JAX
    # model's own plain versions; see models/layers.py, models/mamba2.py
    # and models/moe.py
    attn_impl: str = "kernel"

    def __post_init__(self):
        if self.cfg.attn_every and self.cfg.ssm is None:
            raise ValueError(
                f"{self.cfg.name}: attn_every={self.cfg.attn_every} builds "
                f"Mamba blocks, and the config has no ssm (SSMConfig) for "
                f"them")
        if self.attn_impl not in L.ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{L.ATTN_IMPLS}")

    # ------------------------------------------------------------- params
    def init(self, seed: int = 0, *, device="cuda") -> Dict:
        """Random parameters drawn from one explicit ``torch.Generator``
        seeded with ``seed`` on ``device``."""
        return self._init(seed, device, box=False)

    def init_annotated(self, seed: int = 0, *, device="cuda") -> Dict:
        """``init``'s tree with each parameter boxed as ``Param(value,
        axes)``, the logical axes the JAX twin's ``init`` gives it (stacked
        layers lead with ``"layers"``).  On ``device="meta"`` nothing is
        drawn or allocated: the tree of shapes and axes of any arch at full
        width, for the sharding rules."""
        return self._init(seed, device, box=True)

    def _init(self, seed: int, device, box: bool) -> Dict:
        cfg = self.cfg
        dev = _device(device)
        gen = None
        if dev.type != "meta":
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        kw = dict(device=dev, box=box)
        params: Dict[str, Any] = {
            "embed": L.embed_param(gen, (cfg.vocab_size, cfg.d_model),
                                   ("vocab", "embed"), **kw),
        }
        if cfg.is_encdec:
            params["encdec"] = ED.encdec_init(cfg, gen, **kw)
        else:
            params["blocks"] = T.stack_init(cfg, gen, **kw)
            params["norm_final"] = L.norm_init(cfg, cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            params["head"] = L.dense_param(gen, (cfg.d_model, cfg.vocab_size),
                                           ("embed", "vocab"), **kw)
        return params

    # ------------------------------------------------------------- pieces
    def _embed(self, params, tokens):
        x = embed_rows(params["embed"], tokens).to(torch.bfloat16)
        if self.cfg.scale_embedding:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _logits(self, params, x):
        """x: [..., d] -> logits [..., V] (fp32 products and sums, as the
        JAX twin's preferred_element_type=float32).  Two products, by what
        the call can observe (``LOGITS_PRODUCTS`` counts each):

        * ``bf16_f32``: a plain bf16 head and bf16 ``x`` on a card with
          grad disabled (``prefill``/``decode`` under inference mode): one
          ``mm`` that reads the bf16 operands as stored, the head once,
          and sums and writes the logits in fp32 (each bf16 x bf16
          product is exact in fp32; the sums run in the tensor cores'
          fp32 accumulators, which ``tests/test_torch_cuda.py`` holds
          within 1e-4 of the fp64 product's norm, below any bf16 partial
          sum).
        * ``widened_f32``: everything else (the training loss under
          autograd, a vocab-sharded ``DTensor`` head, the CPU, ``meta``
          shapes): the head widened to fp32 in chunks of at most
          LOGITS_CHUNK_BYTES along the vocab, each a strip of the head as
          it lies in memory (rows of the tied [V, d] embedding, columns of
          an untied [d, V] head).

        Inside a traced serving step, a span (``core/spans.py``) that
        names the product."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            head, eq, vocab_dim = params["embed"], "...d,vd->...v", 0
        else:
            head, eq, vocab_dim = params["head"], "...d,dv->...v", 1
        product = "bf16_f32" if _reads_bf16(x, head) else "widened_f32"
        LOGITS_PRODUCTS[product] += 1
        sp = None if _prof.ACTIVE is None else _spans.model_span(
            "logits", product=product)
        if product == "bf16_f32":
            w = head.t() if vocab_dim == 0 else head        # [d, V]
            logits = torch.mm(x.reshape(-1, cfg.d_model), w,
                              out_dtype=torch.float32)
            logits = logits.view(*x.shape[:-1], w.shape[1])
        else:
            logits = self._widened_logits(head, eq, vocab_dim, x)
        logits = _softcap(logits, cfg.final_logit_softcap)
        if logits.dim() == 3:
            logits = shard_act(logits, "batch", None, "act_vocab")
        elif logits.dim() == 2:
            logits = shard_act(logits, "batch", "act_vocab")
        if sp is not None:
            sp.close()
        return logits

    def _widened_logits(self, head, eq, vocab_dim, x):
        V = head.shape[vocab_dim]
        n = max(1, LOGITS_CHUNK_BYTES // (4 * self.cfg.d_model))
        xf = x.float()
        if local_shape(head)[vocab_dim] <= n:
            # the whole head (a rank's shard of it, under a DTensor
            # layout) in one product: no concatenation along the vocab,
            # which a vocab-sharded DTensor could only gather for
            return einsum_per_rank(eq, xf, head.float())
        return torch.cat([einsum_per_rank(eq, xf, head.narrow(
            vocab_dim, i, min(n, V - i)).float())
            for i in range(0, V, n)], dim=-1)

    def _inputs(self, params, batch):
        """(x [B,S,d] bf16, positions): a VLM's precomputed ``embeds`` with
        its ``positions`` ([3,B,S] or [B,S]; default arange), else the
        embedded ``tokens`` at arange positions."""
        if self.cfg.family == Family.VLM and "embeds" in batch:
            x = batch["embeds"].to(torch.bfloat16)
            positions = batch.get("positions")
        else:
            x = self._embed(params, batch["tokens"])
            positions = None
        if positions is None:
            B, S, _ = x.shape
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
        return shard_act(x, "batch", None, "act_embed"), positions

    def _encdec_pass(self, params, batch, self_caches=None, remat=False):
        """Encoder, cross K/V, teacher-forced decoder over the target
        tokens embedded with the learned positions 0..S-1; remat
        checkpoints each encoder and decoder layer.  Returns (x, the cross
        K/V of ``ED.build_cross_cache``)."""
        ep = params["encdec"]
        enc_out = ED.encode(self.cfg, ep, batch["src_embeds"],
                            attn_impl=self.attn_impl, remat=remat)
        cross = ED.build_cross_cache(self.cfg, ep, enc_out)
        B, S = batch["tgt_tokens"].shape
        x = self._embed(params, batch["tgt_tokens"])
        x = x + ep["pos_dec"][:S][None].to(x.dtype)
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, _ = ED.decode_forward(self.cfg, ep, x, cross, positions=positions,
                                 self_caches=self_caches,
                                 attn_impl=self.attn_impl, remat=remat)
        return x, cross

    # ------------------------------------------------------------ forward
    def forward(self, params, batch, *, remat: Optional[bool] = None,
                dropless: bool = False):
        """Teacher-forced pass to final hidden states.  Returns (x, aux):
        aux is the MoE blocks' summed load-balancing loss (zero without
        MoE).  remat (default ``cfg.remat``) checkpoints each repeat of
        the decoder stack when grad is enabled.  dropless=True routes
        without overflow (inference).  An encoder-decoder takes
        ``{"src_embeds", "tgt_tokens"}`` and checkpoints each of its
        encoder and decoder layers under remat."""
        remat = self.cfg.remat if remat is None else remat
        if self.cfg.is_encdec:
            x, _ = self._encdec_pass(params, batch, remat=remat)
            return x, x.new_zeros((), dtype=torch.float32)
        x, positions = self._inputs(params, batch)
        x, _, aux = T.stack_forward(self.cfg, params["blocks"], x,
                                    positions=positions,
                                    attn_impl=self.attn_impl,
                                    dropless=dropless, remat=remat)
        x = L.apply_norm(self.cfg, params["norm_final"], x)
        return x, aux

    # --------------------------------------------------------------- loss
    def _labels(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(labels [B,S], mask [B,S] fp32) aligned with forward()'s output:
        a VLM's ``labels`` where given (masked where negative), else the
        next token, the last position masked."""
        if self.cfg.is_encdec:
            t = batch["tgt_tokens"]
        elif self.cfg.family == Family.VLM and "labels" in batch:
            lab = batch["labels"]
            return lab, (lab >= 0).float()
        else:
            t = batch["tokens"]
        labels = torch.cat([t[:, 1:], torch.zeros_like(t[:, :1])], dim=1)
        mask = torch.cat([torch.ones_like(t[:, 1:], dtype=torch.float32),
                          torch.zeros_like(t[:, :1], dtype=torch.float32)],
                         dim=1)
        return labels, mask

    def loss(self, params, batch, *, remat: Optional[bool] = None):
        """Mean next-token cross-entropy over the masked positions, plus
        0.01 of the MoE aux loss.  Returns (loss, {ce, aux, tokens}).  The
        cross-entropy runs over chunks of CE_CHUNK positions, each under
        activation checkpointing, as the JAX twin's ``jax.checkpoint``ed
        scan: a chunk's fp32 logits (and the head widened to fp32 for
        them) are recomputed in the backward pass, not kept."""
        x, aux = self.forward(params, batch, remat=remat)
        labels, mask = self._labels(batch)
        B, S, _ = x.shape
        cs = min(CE_CHUNK, S)

        def ce_chunk(xc, yc, mc):
            logits = self._logits(params, xc)           # fp32 [B, cs, V]
            lse = logsumexp_last(logits)
            # a masked label may be negative: gather a real row (the mask
            # zeroes it), where the JAX twin's take_along_axis wraps
            ll = take_last(logits, yc.clamp(min=0))
            return torch.sum((lse - ll) * mc), torch.sum(mc)

        grad = torch.is_grad_enabled()
        total = x.new_zeros((), dtype=torch.float32)
        count = x.new_zeros((), dtype=torch.float32)
        for c0 in range(0, S, cs):
            args = (x[:, c0:c0 + cs], labels[:, c0:c0 + cs],
                    mask[:, c0:c0 + cs])
            ce, n = (checkpoint(ce_chunk, *args, use_reentrant=False)
                     if grad else ce_chunk(*args))
            total = total + ce
            count = count + n
        ce = total / torch.clamp(count, min=1.0)
        loss = ce + 0.01 * aux
        return loss, {"ce": ce, "aux": aux, "tokens": count}

    # -------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, enc_len: int = 0, *,
                   device="cuda"):
        """An encoder-decoder's cache: ``self``, one stacked K/V cache of
        ``max_len`` slots with a leading layers axis, and bf16
        ``cross_k``/``cross_v`` [L, B, enc_len or max_len, KVH, D], which a
        prefill replaces with its encoder's own length."""
        cfg, dev = self.cfg, _device(device)
        if not cfg.is_encdec:
            return T.stack_cache_init(cfg, batch, max_len, device=dev)
        shape = (cfg.num_layers, batch, enc_len or max_len,
                 cfg.num_kv_heads, cfg.head_dim)
        return {"self": L.kv_cache_init(cfg, batch, max_len, device=dev,
                                        lead=(cfg.num_layers,)),
                "cross_k": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=dev),
                "cross_v": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=dev)}

    def cache_axes(self, max_len: int):
        """Logical axes of each leaf of ``init_cache(B, max_len)``."""
        cfg = self.cfg
        if cfg.is_encdec:
            kv = ("layers",) + L.kv_cache_axes(False)
            out = {"self": {"k": kv, "v": kv},
                   "cross_k": kv, "cross_v": kv}
            if cfg.kv_cache_dtype == "int8":
                out["self"]["k_scale"] = kv[:-1]
                out["self"]["v_scale"] = kv[:-1]
            return out
        return T.stack_cache_axes(cfg, max_len)

    # ------------------------------------------------------------ prefill
    @torch.inference_mode()
    def prefill(self, params, batch, cache):
        """Prompt pass.  Returns (last-token logits [B,V], cache, lengths);
        the cache is written in place.  Runs under inference mode itself:
        grad mode is thread-local, and the daemons' worker threads do not
        inherit the caller's.

        An encoder-decoder writes its self caches in place and replaces
        ``cross_k``/``cross_v`` with its encoder's K/V, of the frames'
        own length whatever ``enc_len`` the cache was made with, as the
        JAX twin does."""
        if self.cfg.is_encdec:
            x, cross = self._encdec_pass(params, batch, cache["self"])
            cache.update(cross)
            B, S = batch["tgt_tokens"].shape
            lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
            return self._logits(params, x[:, -1]), cache, lengths
        x, positions = self._inputs(params, batch)
        B, S, _ = x.shape
        x, cache, _ = T.stack_forward(self.cfg, params["blocks"], x,
                                      positions=positions, caches=cache,
                                      attn_impl=self.attn_impl,
                                      dropless=True)
        x = L.apply_norm(self.cfg, params["norm_final"], x)
        lengths = batch.get("lengths")
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32,
                                 device=x.device)
            x_last = x[:, -1]
        else:
            x_last = x[torch.arange(B, device=x.device), lengths.long() - 1]
        return self._logits(params, x_last), cache, lengths

    # ------------------------------------------------------------- decode
    @torch.inference_mode()
    def decode(self, params, tokens, cache, lengths):
        """One token per sequence.  tokens: [B]; lengths: [B] int32, the
        count of tokens already in the cache.

        Updates the cache in place (the JAX twin returns a new one).  That
        is safe for the serving engine, which never inserts a slot into
        its slot cache while a decode is in flight (its
        ``_fill_slots_locked`` returns early while ``decode_inflight``)."""
        x = self._embed(params, tokens[:, None])
        if self.cfg.is_encdec:
            ep = params["encdec"]
            pos = embed_rows(ep["pos_dec"],
                             lengths.long().clamp(0, ED.POS_TABLE_LEN - 1))
            x, _ = ED.decode_step(self.cfg, ep, x + pos[:, None].to(x.dtype),
                                  lengths=lengths, self_caches=cache["self"],
                                  cross_cache=cache,
                                  attn_impl=self.attn_impl)
            return self._logits(params, x[:, 0]), cache
        x, cache, _ = T.stack_decode(self.cfg, params["blocks"], x,
                                     lengths=lengths, caches=cache,
                                     attn_impl=self.attn_impl)
        x = L.apply_norm(self.cfg, params["norm_final"], x)
        return self._logits(params, x[:, 0]), cache


    # -------------------------------------------------------- input specs
    def input_specs(self, shape: ShapeConfig):
        """(inputs, axes) for the dry-run: shape-only ``meta`` tensors of a
        step's batch at ``shape`` (int32 tokens and lengths, bf16 frames
        or VLM embeddings, M-RoPE positions [3, B, S], a VLM's training
        labels) and the logical axes of each, as the JAX twin's
        ``input_specs``.  DECODE gives ``tokens`` and ``lengths`` [B]; an
        encoder-decoder's prefill feeds one target token."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32, bf16 = torch.int32, torch.bfloat16

        def spec(*dims, dtype=i32):
            return torch.empty(dims, dtype=dtype, device="meta")

        if shape.kind == ShapeKind.DECODE:
            return ({"tokens": spec(B), "lengths": spec(B)},
                    {"tokens": ("batch",), "lengths": ("batch",)})
        if cfg.is_encdec:
            tgt_len = S if shape.kind == ShapeKind.TRAIN else 1
            return ({"src_embeds": spec(B, S, cfg.d_model, dtype=bf16),
                     "tgt_tokens": spec(B, tgt_len)},
                    {"src_embeds": ("batch", None, None),
                     "tgt_tokens": ("batch", None)})
        if cfg.family == Family.VLM:
            inputs = {"embeds": spec(B, S, cfg.d_model, dtype=bf16),
                      "positions": spec(3, B, S)}
            axes = {"embeds": ("batch", None, None),
                    "positions": (None, "batch", None)}
            if shape.kind == ShapeKind.TRAIN:
                inputs["labels"] = spec(B, S)
                axes["labels"] = ("batch", None)
            return inputs, axes
        return {"tokens": spec(B, S)}, {"tokens": ("batch", None)}


def _reads_bf16(x, head) -> bool:
    """Whether ``Model._logits`` can read the head as stored: plain
    (not ``DTensor``) bf16 ``x`` and head on a card, grad disabled."""
    return (not torch.is_grad_enabled() and head.is_cuda
            and head.dtype == torch.bfloat16 and x.dtype == torch.bfloat16
            and not is_dtensor(head) and not is_dtensor(x))


def _device(device) -> torch.device:
    """``device`` as a ``torch.device``: ``meta`` (shapes alone), or a
    device ``require_device`` accepts."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else require_device(dev)


def build_model(cfg: ModelConfig, *, attn_impl: str = "kernel") -> Model:
    return Model(cfg, attn_impl=attn_impl)
