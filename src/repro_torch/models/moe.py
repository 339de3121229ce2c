"""Mixture-of-Experts layer: top-k routing with per-row expert capacity.

The twin of ``repro/models/moe.py``: the same routing, step by step, as
plain functions on tensors.  Router logits in fp32, softmax, top-k (ties to
the lower expert index, as ``lax.top_k``), renormalized gates; the k slots
of each token flattened to a pseudo-sequence ``t = s_i * k + j``; each
slot's capacity position counted along its batch row; slots past the
capacity ``C`` dropped; the Switch load-balancing loss.  The sequence is
cut into chunks, each routed alone; one pass over every chunk's batch rows
stands in for ``lax.scan`` (the plain dispatch then loops over the
chunks).

Two dispatches compute the same function:

* ``attn_impl="plain"``: the reference's GShard formulation, one-hot
  ``[B, s*k, E, C]`` dispatch and combine products around a ``[B, E, C, d]``
  expert batch.  Dropless routing makes ``C = s*k``, so it runs every expert
  over ``E*C`` rows, ``E`` times the work the routed slots need.
* ``attn_impl="kernel"`` (the default): no one-hot product.  A prefill or
  a training step gathers the kept slots of every chunk at once, sorted by
  expert, runs one product per expert over its contiguous rows (the expert
  counts are read to the host once a call) and writes each result, times
  its gate, back to its slot.  A one-token step (``chunk_size=1``, decode,
  never under autograd) runs every expert on every token in one product
  batched over the experts and gathers the picked ones: it reads nothing
  back to the host.

Both carry the reference's gradient (``jax.grad`` of the one-hot
dispatch): to the kept slots' inputs, the three expert weights, the gates
(the renormalized top-k probabilities) and through them and the aux
loss's ``probs`` to the router; the one-hot mask and the capacity
positions carry none, and a dropped slot gives its gate none.  The sorted
dispatch keeps one writer to each gradient element, so two identical
steps give the same bits: each token is copied once per slot (the
backward sums its k slot gradients in a fixed order), the slots are
gathered and scattered back by one permutation (no index repeats), and
each expert takes its weights from one ``torch.unbind`` (the backward
stacks them).  Under activation checkpointing the recompute routes as the
forward did: every operation before the router is deterministic on the
card (the flash kernel has one writer an output, cuBLAS gives the same
bits for the same shapes), so the router's fp32 product, its top-k and
the host counts repeat bit for bit; were a count to differ, the
recomputed expert products would change shape, and
``torch.utils.checkpoint`` raises rather than go on.

Neither is a hand-written kernel: the JAX package computes its expert
products as plain einsums, outside any Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Activation, ModelConfig
from repro_torch.core import profiler as _prof
from repro_torch.core import spans as _spans
from repro_torch.distributed.sharding import (einsum_per_rank, is_dtensor,
                                              replicated, shard_act)
from repro_torch.models import layers as L


def moe_params(cfg: ModelConfig, gen: Optional[torch.Generator], *, device,
               lead=(), box: bool = False) -> Dict:
    """``router`` fp32 [d, E]; bf16 ``w_up``/``w_gate`` [E, d, f] and
    ``w_down`` [E, f, d].  As in the JAX twin, ``dense_param`` takes its fan
    from the shape's first axis, so ``w_up`` and ``w_gate`` are scaled by
    1/sqrt(E), ``w_down`` by 1/sqrt(f)."""
    assert cfg.moe is not None
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    kw = dict(device=device, lead=lead, box=box)
    p = {
        "router": L.dense_param(gen, (d, e), ("embed", None),
                                dtype=torch.float32, **kw),
        "w_up": L.dense_param(gen, (e, d, f), ("expert", "embed", "mlp"),
                              **kw),
        "w_down": L.dense_param(gen, (e, f, d), ("expert", "mlp", "embed"),
                                fan_in=f, **kw),
    }
    if cfg.activation in (Activation.SWIGLU, Activation.GEGLU):
        p["w_gate"] = L.dense_param(gen, (e, d, f), ("expert", "embed", "mlp"),
                                    **kw)
    return p


def _expert_ffn(cfg: ModelConfig, p: Dict, xe):
    """xe: [B, E, C, d] -> [B, E, C, d], per-expert FFN.  On ``DTensor``s
    (``_moe_reduced``) an up product left partial by a split embed dim is
    all-reduced before the activation."""
    def up(w):
        return replicated(einsum_per_rank("becd,edf->becf", xe, w))
    h = up(p["w_up"])
    if cfg.activation == Activation.SWIGLU:
        h = F.silu(up(p["w_gate"])) * h
    elif cfg.activation == Activation.GEGLU:
        h = F.gelu(up(p["w_gate"]), approximate="tanh") * h
    elif cfg.activation == Activation.SQUARED_RELU:
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    h = shard_act(h, "batch", "expert", None, "mlp")
    return einsum_per_rank("becf,efd->becd", h, p["w_down"])


def _experts(p: Dict) -> list:
    """Each expert's weights under ``layers.apply_mlp``'s names, from one
    ``torch.unbind`` a tensor: under autograd its backward stacks the E
    experts' gradients into one tensor, where indexing each expert would
    allocate a zero tensor of all E for every expert's gradient."""
    names = {"w_up": "wi", "w_down": "wo", "w_gate": "wg"}
    parts = {names[n]: t.unbind(0) for n, t in p.items() if n in names}
    return [{n: t[e] for n, t in parts.items()}
            for e in range(p["w_up"].shape[0])]


def capacity(cfg: ModelConfig, s: int, dropless: bool) -> int:
    """Slots each expert takes from one batch row of an s-token chunk."""
    moe = cfg.moe
    if dropless:
        return s * moe.top_k
    return max(1, math.ceil(s * moe.top_k * moe.capacity_factor
                            / moe.num_experts))


class Routing(NamedTuple):
    """One chunk's routing for N batch rows of s tokens (sk = s * k)."""
    probs: torch.Tensor      # [N, s, E] fp32 router softmax
    idx: torch.Tensor        # [N, sk] int64 expert of each slot
    gate: torch.Tensor       # [N, sk] fp32 renormalized gate
    mask: torch.Tensor       # [N, sk, E] fp32 one-hot of idx
    pos: torch.Tensor        # [N, sk] int32 capacity position in its row
    keep: torch.Tensor       # [N, sk] bool: pos < C


def route(cfg: ModelConfig, p: Dict, xc, C: int) -> Routing:
    """The routing of the reference's ``_route_chunk`` for N batch rows of
    one chunk each, xc: [N, s, d].  Capacity positions count along each
    row alone."""
    N, s, _ = xc.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    logits = xc.float() @ p["router"]                        # [N, s, E]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts equal probabilities in index order:
    # lax.top_k's tie rule (padded zero rows route to experts 0..k-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    idx, gate = idx.reshape(N, s * k), gate.reshape(N, s * k)
    mask = F.one_hot(idx, E).float()                         # [N, sk, E]
    pos = ((torch.cumsum(mask, dim=1) * mask).sum(-1) - 1.0).to(torch.int32)
    return Routing(probs, idx, gate, mask, pos, pos < C)


def _onehot_moe(cfg: ModelConfig, p: Dict, xc, r: Routing, C: int,
                experts: slice = slice(None)):
    """The reference's GShard dispatch and combine of one chunk:
    xc [B, s, d] -> y.  ``experts``: the experts ``p`` holds (all of them
    but on a rank of an expert-parallel layout, whose y is then its
    experts' part of the sum)."""
    B, s, d = xc.shape
    k = cfg.moe.top_k
    disp, combine = _one_hot(r, C, experts)                 # [B, sk, E, C]
    x_f = torch.repeat_interleave(xc, k, dim=1)              # [B, sk, d]
    xe = torch.einsum("btec,btd->becd", disp.to(xc.dtype), x_f)
    xe = shard_act(xe, "batch", "expert", None, "act_embed")
    ye = _expert_ffn(cfg, p, xe)                             # [B, E, C, d]
    y = torch.einsum("btec,becd->btd", combine.to(xc.dtype), ye)
    return y.reshape(B, s, k, d).sum(dim=2)


def _one_hot(r: Routing, C: int, experts: slice):
    """The one-hot dispatch [N, sk, E, C] of ``r``'s kept slots to the
    experts ``experts`` and capacity positions, and the combine weights
    (each slot's dispatch times its gate)."""
    cap_oh = (r.pos[..., None] == torch.arange(C, device=r.pos.device)
              ).float()
    disp = (r.mask[..., experts, None] * cap_oh[:, :, None, :]
            * r.keep[..., None, None])
    return disp, disp * r.gate[:, :, None, None]


def _host_counts(counts) -> list:
    """The per-expert slot counts on the host: the sorted dispatch's one
    device-to-host read a call (counted in a traced serving step, as a CUDA
    graph cannot hold it)."""
    if _prof.ACTIVE is not None:
        _spans.readback()
    return counts.tolist()


def _sorted_moe(cfg: ModelConfig, p: Dict, rows, r: Routing, real):
    """Every chunk's kept slots at once, sorted by expert, one product per
    expert.  rows: [N, s, d] (N = chunks x batch rows); real: [N, s] bool,
    False on the padding of the last chunk (its slots count in the aux but
    skip the experts).  Each token is copied to its k slots and the slots
    are gathered and scattered back by one permutation, so every gradient
    element has one writer (the module docstring)."""
    N, s, d = rows.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    run = (r.keep & real.repeat_interleave(k, dim=1)).reshape(-1)
    key = torch.where(run, r.idx.reshape(-1), E)             # E: not run
    order = torch.argsort(key, stable=True)
    counts = _host_counts(torch.bincount(key, minlength=E + 1)[:E])
    order = order[:sum(counts)]
    slots = rows.reshape(N * s, 1, d).expand(N * s, k, d).reshape(-1, d)
    xs = slots.index_select(0, order)                        # sorted slots
    experts = _experts(p)
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(L.apply_mlp(cfg, experts[e], xs[start:start + n]))
        start += n
    out = torch.cat(outs) if outs else xs
    gate = r.gate.reshape(-1).index_select(0, order).to(rows.dtype)
    y = rows.new_zeros(N * s * k, d).index_copy(0, order,
                                                out * gate[:, None])
    return y.view(N, s, k, d).sum(dim=2)


def _dense_moe(cfg: ModelConfig, p: Dict, rows, r: Routing):
    """One-token chunks (decode): every expert runs every token in one
    product batched over the experts, then each slot takes its expert's
    row times its gate.  rows: [N, 1, d].  The top k experts of a token
    are distinct, so every slot holds capacity position 0 and none is
    dropped."""
    N, _, d = rows.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    xe = rows.view(1, 1, N, d).expand(1, E, N, d)
    ye = _expert_ffn(cfg, p, xe)[0]                          # [E, N, d]
    tok = torch.arange(N, device=rows.device).repeat_interleave(k)
    picked = ye[r.idx.reshape(-1), tok]                      # [N*k, d]
    y = picked * r.gate.reshape(-1, 1).to(rows.dtype)
    return y.view(N, 1, k, d).sum(dim=2)


def apply_moe(cfg: ModelConfig, p: Dict, x, *, chunk_size: int = 0,
              dropless: bool = False, attn_impl: str = "kernel"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y, aux_loss).  Chunks the sequence (S % chunk by
    zero-padding the last chunk); ``attn_impl`` picks the dispatch (see the
    module docstring).  One-token chunks under autograd take the sorted
    dispatch: the batched one, which runs every expert on every token, is
    decode's."""
    if chunk_size == 0:
        chunk_size = 256 if dropless else 1024  # dropless capacity is s*k
    if attn_impl == "plain" and is_dtensor(x):
        return _moe_per_rank(cfg, p, x, chunk_size, dropless)
    rows, r, C, slots, probs = _routed(cfg, p, x, chunk_size, dropless)
    # the aux loss before the dispatch, as the reference orders them: a
    # remat recompute stops at the last tensor the backward saves
    aux = _aux(cfg, x, chunk_size, slots, probs)
    return _dispatched(cfg, p, rows, r, C, x.shape, attn_impl), aux


def _routed(cfg: ModelConfig, p: Dict, x, chunk_size: int, dropless: bool):
    """``apply_moe``'s routing of x [B, S, d]: (rows, r, C, slots, probs).
    rows [nc * B, cs, d] are every chunk's batch rows (the last chunk
    zero-padded), chunk-major as the reference's scan, routed by one
    router product so both dispatches route alike; slots and probs
    [nc, E] each chunk's sums over its batch rows of the one-hot slots
    and of the router probabilities (padded rows included, as in the
    reference)."""
    B, S, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    cs = min(chunk_size, S)
    pad = (-S) % cs
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    nc = x.shape[1] // cs
    rows = x.reshape(B, nc, cs, d).transpose(0, 1).reshape(nc * B, cs, d)
    C = capacity(cfg, cs, dropless)
    r = route(cfg, p, rows, C)
    return (rows, r, C, r.mask.view(nc, B * cs * k, E).sum(1),
            r.probs.view(nc, B * cs, E).sum(1))


def _dispatched(cfg: ModelConfig, p: Dict, rows, r: Routing, C: int, shape,
                attn_impl: str, experts: slice = slice(None)):
    """The experts' output y [B, S, d] of ``_routed``'s rows, for x of
    ``shape``.  ``experts``: the experts ``p`` holds (the one-hot dispatch
    only)."""
    B, S, _ = shape
    N, cs, d = rows.shape
    nc = N // B
    if attn_impl == "plain":
        y = torch.cat([_onehot_moe(
            cfg, p, rows[c * B:(c + 1) * B],
            Routing(*(t[c * B:(c + 1) * B] for t in r)), C, experts)
            for c in range(nc)])
    elif cs == 1 and not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (rows, *p.values()))):
        y = _dense_moe(cfg, p, rows, r)
    else:
        real = (torch.arange(nc * cs, device=rows.device) < S).view(nc, 1, cs)
        y = _sorted_moe(cfg, p, rows, r, real.expand(nc, B, cs)
                        .reshape(nc * B, cs))
    y = y.view(nc, B, cs, d).transpose(0, 1).reshape(B, nc * cs, d)
    return y[:, :S]


def _aux(cfg: ModelConfig, x, chunk_size: int, slots, probs):
    """The Switch load-balancing loss of ``apply_moe``'s x from
    ``_routed``'s sums over all B batch rows: each chunk's fractions of
    slots and of router probability an expert takes, averaged over the
    chunks."""
    n = x.shape[0] * min(chunk_size, x.shape[1])      # a chunk's tokens
    aux = cfg.moe.num_experts * torch.sum(
        slots / (n * cfg.moe.top_k) * (probs / n), dim=-1)
    return aux[0] if aux.shape[0] == 1 else aux.sum() / aux.shape[0]


def _moe_per_rank(cfg: ModelConfig, p: Dict, x, chunk_size: int,
                  dropless: bool):
    """``apply_moe``'s plain path on ``DTensor``s: each rank routes its own
    batch rows (the router gathered) and runs the one-hot dispatch over
    the experts it holds, so its y is its experts' part of the sum
    (``Partial`` over the mesh dims that split the experts, or their mlp
    dim where the experts are not split); the aux loss is built from the
    ranks' sums of slot and probability counts.  The ranks that split the
    experts route the same rows alike: each returns 1/n of those sums as
    its part, so both the sums and the router's gradient add up once.
    As GSPMD partitions the one-hot dispatch laid out over batch and
    experts.

    Where the experts' embed dim is split too (FSDP), the layout is
    GSPMD's cheaper of two (``_reduce_cheaper``, from shapes): gather that
    dim of every expert weight (many rows a rank: a training step or a
    long prefill), or, where a rank holds few rows (one-token decode),
    keep the weights in place and reduce partial products
    (``_moe_reduced``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.distributed.sharding import (block_index, per_rank,
                                                  shard_dims)
    mesh = x.device_mesh
    E = cfg.moe.num_experts
    batch = shard_dims(x, 0)
    split_e = shard_dims(p["w_up"], 0)
    split_f = shard_dims(p["w_up"], 2)
    n_e = E // math.prod(mesh.size(i) for i in split_e)
    e0 = block_index(mesh, split_e) * n_e
    experts = slice(e0, e0 + n_e)
    if _reduce_cheaper(cfg, p, x, chunk_size, dropless, n_e):
        return _moe_reduced(cfg, p, x, chunk_size, dropless, experts)
    names = sorted(p)                # router, w_down, w_gate?, w_up

    def layout(name):
        dim_f = 1 if name == "w_down" else 2
        return tuple(Replicate() if name == "router" else
                     Shard(0) if i in split_e else
                     Shard(dim_f) if i in split_f else Replicate()
                     for i in range(mesh.ndim))

    def local(xl, *weights):
        pl = dict(zip(names, weights))
        rows, r, C, slots, probs = _routed(cfg, pl, xl, chunk_size, dropless)
        return (_dispatched(cfg, pl, rows, r, C, xl.shape, "plain", experts),
                slots / same, probs / same)
    same = math.prod(mesh.size(i) for i in split_e + split_f)
    rows_of = tuple(Shard(0) if i in batch else Replicate()
                    for i in range(mesh.ndim))
    summed = tuple(Partial() if i in batch + split_e + split_f
                   else Replicate() for i in range(mesh.ndim))
    y, slots, probs = per_rank(
        local, mesh, (x, *(p[n] for n in names)),
        (rows_of, *(layout(n) for n in names)),
        [tuple(Shard(0) if i in batch else
               Partial() if i in split_e + split_f else Replicate()
               for i in range(mesh.ndim)), summed, summed])
    return y, _aux(cfg, x, chunk_size, slots, probs)


def _reduce_cheaper(cfg: ModelConfig, p: Dict, x, chunk_size: int,
                    dropless: bool, n_e: int) -> bool:
    """Whether the expert weights stay in place (``_moe_reduced``): the
    bytes a rank would reduce, its up (and gate) products' partial sums
    all-reduced over the mesh dims that split the experts' embed dim
    (2 (g - 1) / g of them) and its output's embed blocks gathered
    ((g - 1) / g), are fewer than the bytes it would gather, the rest of
    that dim of its block of every expert weight ((g - 1) times its
    shard)."""
    from repro_torch.distributed.sharding import local_shape, shard_dims
    mesh = x.device_mesh
    split_d = shard_dims(p["w_up"], 1)
    if not split_d:
        return False
    g = math.prod(mesh.size(i) for i in split_d)
    B, S, d = x.shape
    rows = B // math.prod(mesh.size(i) for i in shard_dims(x, 0)
                          if i not in split_d)
    cs = min(chunk_size, S)
    nc = -(-S // cs)
    C = capacity(cfg, cs, dropless)
    f = local_shape(p["w_up"])[2]
    elt = p["w_up"].element_size()
    n_up = 1 + ("w_gate" in p)
    reduce = (2 * (g - 1) / g * n_up * rows * nc * n_e * C * f
              + (g - 1) / g * rows * S * d) * elt
    gather = (g - 1) * sum(math.prod(local_shape(p[n])) for n in p
                           if n != "router") * elt
    return reduce < gather


def _moe_reduced(cfg: ModelConfig, p: Dict, x, chunk_size: int,
                 dropless: bool, experts: slice):
    """``_moe_per_rank`` with the expert weights left where FSDP put them,
    as GSPMD lays out a product whose contraction dim the weight splits:
    the rows are replicated over the mesh dims that split the embed dim
    (gathered there if they were split), each rank routes them and
    dispatches its experts' slots keeping its own block of the embed dim;
    the expert FFN (``_expert_ffn``) then runs on ``DTensor``s, its up
    products partial sums reduced before the activation, its down product
    split along the embed dim, as is each rank's part of y (``Partial``
    over the mesh dims that split the experts)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.distributed.sharding import (block_index, per_rank,
                                                  shard_dims)
    mesh = x.device_mesh
    k = cfg.moe.top_k
    split_e = shard_dims(p["w_up"], 0)
    split_d = shard_dims(p["w_up"], 1)
    split_f = shard_dims(p["w_up"], 2)
    batch = [i for i in shard_dims(x, 0) if i not in split_d]
    g = math.prod(mesh.size(i) for i in split_d)
    B, S, d = x.shape
    cs = min(chunk_size, S)
    nc = -(-S // cs)
    d0 = block_index(mesh, split_d) * (d // g)
    same = math.prod(mesh.size(i) for i in split_e + split_f + split_d)

    def lay(dims):
        out = [Replicate()] * mesh.ndim
        for t_dim, mesh_dims in dims.items():
            for i in mesh_dims:
                out[i] = Shard(t_dim)
        return tuple(out)

    def dispatch(xl, router):
        rows, r, C, slots, probs = _routed(cfg, {"router": router}, xl,
                                           chunk_size, dropless)
        disp, combine = _one_hot(r, C, experts)             # [N, sk, e, C]
        x_f = torch.repeat_interleave(rows[..., d0:d0 + d // g], k, dim=1)
        xe = torch.einsum("btec,btd->becd", disp.to(xl.dtype), x_f)
        return xe, combine.to(xl.dtype), slots / same, probs / same
    summed = tuple(Partial() if i in batch + split_e + split_f + split_d
                   else Replicate() for i in range(mesh.ndim))
    xe, combine, slots, probs = per_rank(
        dispatch, mesh, (x, p["router"]),
        (lay({0: batch}), (Replicate(),) * mesh.ndim),
        [lay({0: batch, 1: split_e, 3: split_d}),
         lay({0: batch, 2: split_e}), summed, summed])
    ye = _expert_ffn(cfg, p, xe)

    def combined(cl, yl):
        y = torch.einsum("btec,becd->btd", cl, yl)
        N = y.shape[0]
        y = y.reshape(N, cs, k, -1).sum(dim=2)
        y = y.view(nc, N // nc, cs, -1).transpose(0, 1)
        return y.reshape(N // nc, nc * cs, -1)[:, :S]
    y = per_rank(combined, mesh, (combine, ye),
                 (lay({0: batch, 2: split_e}),
                  lay({0: batch, 1: split_e, 3: split_d})),
                 tuple(Shard(0) if i in batch else Shard(2) if i in split_d
                       else Partial() if i in split_e else Replicate()
                       for i in range(mesh.ndim)))
    return y, _aux(cfg, x, chunk_size, slots, probs)
