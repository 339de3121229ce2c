"""Model API for the port's slices: the dense decoder, Mixture-of-Experts
decoders, attention-free Mamba-2 and hybrid Mamba/attention stacks.

``build_model(cfg)`` returns a ``Model`` whose methods are functions of
(params, batch/cache), as in the JAX package:

    init(seed, device=)             -> param tree (plain dicts of tensors)
    forward(params, batch, dropless=) -> (hidden [B,S,d], aux) (teacher-forced)
    init_cache(B, max_len, device=) -> cache (one stacked dict per pattern
                                       position: K/V for an attention
                                       block, conv/ssm state for a Mamba one)
    prefill(params, batch, cache)   -> (logits [B,V], cache, lengths)
    decode(params, tokens, cache, lengths) -> (logits [B,V], cache)

The slices cover the dense decoder olmo-1b needs, the attention-free
Mamba-2 stack of mamba2-780m, and the attention variants: gemma2-2b's
sliding windows with ring-buffer caches, local/global alternation, logit
softcaps, post-norms and scaled embeddings; starcoder2-3b's window on
every layer, LayerNorm and GELU; qwen2-vl-2b's VLM backbone, fed token ids
or precomputed ``embeds`` with M-RoPE ``[3, B, S]`` positions; int8 KV
caches (nemotron-4-340b); the MoE FFNs of mixtral-8x7b and grok-1-314b
(top-k routing with per-row expert capacity, dropless in prefill and
decode); and jamba-1.5-large's hybrid stack (``attn_every``: Mamba-2
mixers with one attention block a pattern, MoE FFNs every other block, no
positional embedding).  A config that uses a feature outside them is
refused when the ``Model`` is built, naming the ROADMAP item that brings
it, so nothing outside the slices is computed silently wrong; a hybrid
config without its ``ssm`` block, which cannot build its Mamba mixers, is
refused as invalid.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import Family, ModelConfig, PosEmb
from repro_torch.device import require_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap > 0 else x


def _unported(cfg: ModelConfig) -> str:
    """The first config feature outside the slice, with its ROADMAP item
    (queue 1), or ''."""
    if cfg.is_encdec or cfg.pos_emb == PosEmb.LEARNED:
        return "encoder-decoder and learned positions (item 9)"
    return ""


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    # "kernel" | "plain": the hand-written kernels (prefill and decode
    # attention, the SSD scan) and the sorted MoE dispatch, or the JAX
    # model's own plain versions; see models/layers.py, models/mamba2.py
    # and models/moe.py
    attn_impl: str = "kernel"

    def __post_init__(self):
        missing = _unported(self.cfg)
        if missing:
            raise NotImplementedError(
                f"{self.cfg.name}: {missing} is not ported yet; see "
                f"ROADMAP.md queue 1")
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
        cfg = self.cfg
        dev = require_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params: Dict[str, Any] = {
            "embed": L.embed_param(gen, (cfg.vocab_size, cfg.d_model),
                                   device=dev),
            "blocks": T.stack_init(cfg, gen, device=dev),
            "norm_final": L.norm_init(cfg, cfg.d_model, device=dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = L.dense_param(gen, (cfg.d_model, cfg.vocab_size),
                                           device=dev)
        return params

    # ------------------------------------------------------------- pieces
    def _embed(self, params, tokens):
        x = params["embed"][tokens].to(torch.bfloat16)
        if self.cfg.scale_embedding:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def _logits(self, params, x):
        """x: [..., d] -> logits [..., V] (fp32 products and sums, as the
        JAX twin's preferred_element_type=float32)."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = torch.einsum("...d,vd->...v", x.float(),
                                  params["embed"].float())
        else:
            logits = torch.einsum("...d,dv->...v", x.float(),
                                  params["head"].float())
        return _softcap(logits, cfg.final_logit_softcap)

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
        return x, positions

    # ------------------------------------------------------------ forward
    def forward(self, params, batch, *, dropless: bool = False):
        """Teacher-forced pass to final hidden states.  Returns (x, aux):
        aux is the MoE blocks' summed load-balancing loss (zero without
        MoE).  dropless=True routes without overflow (inference)."""
        x, positions = self._inputs(params, batch)
        x, _, aux = T.stack_forward(self.cfg, params["blocks"], x,
                                    positions=positions,
                                    attn_impl=self.attn_impl,
                                    dropless=dropless)
        x = L.apply_norm(self.cfg, params["norm_final"], x)
        return x, aux

    # -------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, *, device="cuda"):
        return T.stack_cache_init(self.cfg, batch, max_len,
                                  device=require_device(device))

    # ------------------------------------------------------------ prefill
    @torch.inference_mode()
    def prefill(self, params, batch, cache):
        """Prompt pass.  Returns (last-token logits [B,V], cache, lengths);
        the cache is written in place.  Runs under inference mode itself:
        grad mode is thread-local, and the daemons' worker threads do not
        inherit the caller's."""
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
        x, cache, _ = T.stack_decode(self.cfg, params["blocks"], x,
                                     lengths=lengths, caches=cache,
                                     attn_impl=self.attn_impl)
        x = L.apply_norm(self.cfg, params["norm_final"], x)
        return self._logits(params, x[:, 0]), cache


def build_model(cfg: ModelConfig, *, attn_impl: str = "kernel") -> Model:
    return Model(cfg, attn_impl=attn_impl)
