"""Decode paged attention: the CUDA kernel's wrapper and its plain version.

``paged_attention_cuda`` launches ``csrc/paged_attention.cu``, the port of
the TPU kernel ``repro/kernels/paged_attention.py:paged_attention_kernel``
(see that source for the design and what bounds it on the card).  Both
sides cut each sequence's capacity ``maxp * ps`` into the same split plan
(``split_plan``), from the shapes and the card's SM count alone, never from
``lengths``.  ``paged_attention_plain`` repeats the kernel's arithmetic in
plain torch: per split, all G query heads of a KV group scored against the
split's tokens, a partial (m, l, acc) in fp32, then the same merge with
``exp(m_i - M)`` weights.  The CPU tests exercise it, and ``chip_smoke.py``
holds the kernel against it on the card.  ``kernels.ops.paged_attention``
picks between the two by the tensors' device.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

NT = 32                  # a split's span is a multiple of this many tokens
CPU_SMS = 132            # the H100's SM count, the plan's default off a card
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 192, 256)
DTYPES = (torch.bfloat16, torch.float32)

_count_lock = threading.Lock()
_workspaces: Dict[Tuple[torch.device, int],
                  Tuple[torch.Tensor, torch.Tensor]] = {}


@functools.lru_cache(maxsize=None)
def split_plan(batch: int, kv_heads: int, capacity: int,
               sms: int) -> Tuple[int, int]:
    """(n_split, span): split s covers tokens [s * span, (s+1) * span) of
    [0, capacity), so the splits cover every token once.  About two blocks
    an SM, ``n_split = ceil(2 * sms / (batch * kv_heads))``, clamped to
    [1, ceil(capacity / NT)]; the span is rounded up to NT tokens, and the
    splits that rounding leaves empty are dropped."""
    n = -(-2 * sms // (batch * kv_heads))
    n = max(1, min(n, -(-capacity // NT)))
    span = NT * -(-capacity // (n * NT))
    return -(-capacity // span), span


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card (cached), CPU_SMS off a card."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_SMS
    return _cuda_sms(device.index if device.index is not None
                     else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _cuda_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def paged_attention_plain(q, k_pages, v_pages, page_tables, lengths, *,
                          scale: float, softcap: float = 0.0):
    """q: [B, H, D]; k/v_pages: [P, ps, KVH, D]; page_tables: [B, maxp];
    lengths: [B] -> [B, H, D] in q's dtype.  The split plan is the
    kernel's for the SM count of q's device (CPU_SMS on the CPU)."""
    B, H, D = q.shape
    _, ps, KVH, _ = k_pages.shape
    maxp = page_tables.shape[1]
    G = H // KVH
    n_split, span = split_plan(B, KVH, maxp * ps, sm_count(q.device))
    n_tok = torch.clamp(lengths.long().to(q.device), max=maxp * ps)
    pt = page_tables.long().to(q.device)
    qf = q.float().reshape(B, KVH, G, D)
    ms, ls, accs = [], [], []
    for s0 in range(0, n_split * span, span):
        t = torch.arange(s0, min(s0 + span, maxp * ps), device=q.device)
        page = pt[:, t // ps]                            # [B, nt]
        kt = k_pages[page, t % ps].float()               # [B, nt, KVH, D]
        vt = v_pages[page, t % ps].float()
        s = torch.einsum("bhgd,bthd->bhgt", qf, kt) * scale
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        valid = (t[None] < n_tok[:, None])[:, None, None]   # [B, 1, 1, nt]
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(-1)                                   # NEG_INF: empty
        p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhgt,bthd->bhgd", p, vt))
    m = torch.stack(ms)                                  # [n_split, B, KVH, G]
    w = torch.exp(m - m.amax(0))
    l = (torch.stack(ls) * w).sum(0)
    acc = (torch.stack(accs) * w[..., None]).sum(0)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def _check(q, k_pages, v_pages, page_tables, lengths):
    for name, t in {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                    "page_tables": page_tables, "lengths": lengths}.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"expected the CUDA device of q ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    for name, t in {"k_pages": k_pages, "v_pages": v_pages}.items():
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"paged_attention: q is {q.dtype} and {name} "
                            f"{t.dtype}; the kernel takes all bf16 or fp32")
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             f"aligned (the kernel loads 16-byte slices)")
    for name, t in {"page_tables": page_tables, "lengths": lengths}.items():
        if t.dtype != torch.int32:
            raise TypeError(f"paged_attention: {name} must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if q.numel() == 0 or k_pages.numel() == 0:
        raise ValueError("paged_attention: empty input")
    B, H, D = q.shape
    KVH = k_pages.shape[2]
    if k_pages.shape[3] != D or D not in HEAD_DIMS or H % KVH:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)} disagree (head_dim in "
                         f"{HEAD_DIMS}, heads a multiple of KV heads)")
    if page_tables.dim() != 2 or page_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_attention: page_tables "
                         f"{tuple(page_tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")


def _workspace(device: torch.device, stream: int, n_scratch: int,
               n_tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The combine's fp32 partials and int32 ticket counters for one
    stream, kept across launches (each launch leaves its tickets 0).
    Kernels on one stream run in order, and each stream has its own
    buffers, so no two launches share live partials or counters."""
    key = (device, stream)
    ws = _workspaces.get(key)
    if ws is None or ws[0].numel() < n_scratch or ws[1].numel() < n_tickets:
        ws = _workspaces[key] = (
            torch.empty(n_scratch, dtype=torch.float32, device=device),
            torch.zeros(n_tickets, dtype=torch.int32, device=device))
    return ws


def paged_attention_cuda(q, k_pages, v_pages, page_tables, lengths, *,
                         scale: float, softcap: float = 0.0):
    """Launch the CUDA kernel on the current stream; raises on anything
    the kernel does not take.  Page-table entries must lie in [0, P).
    Counts its launches in ``.launches``, and by the capacity of a
    sequence's pages (page-table width x page size, the slot cache's T) in
    ``.capacity_launches``.  Raises under autograd
    (``build.refuse_grad``): the kernel has no backward."""
    build.refuse_grad("paged_attention", q, k_pages, v_pages)
    _check(q, k_pages, v_pages, page_tables, lengths)
    B, H, D = q.shape
    _, ps, KVH, _ = k_pages.shape
    maxp = page_tables.shape[1]
    n_split, span = split_plan(B, KVH, maxp * ps, _cuda_sms(q.device.index))
    out = torch.empty_like(q)
    lib = build.load()
    fn = (lib.paged_attention_bf16 if q.dtype == torch.bfloat16
          else lib.paged_attention_f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scratch = tickets = None
        if n_split > 1:
            # ws is held until the launch is issued: a growth by another
            # thread frees the old pair, whose bytes must not be reused first
            ws = _workspace(q.device, stream, B * H * n_split * (D + 2),
                            B * KVH)
            scratch, tickets = ws[0].data_ptr(), ws[1].data_ptr()
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 scratch, tickets,
                 B, H, KVH, D, ps, maxp, n_split, span, float(scale),
                 float(softcap), stream)
    build.check(err, "paged_attention")
    with _count_lock:
        paged_attention_cuda.launches += 1
        counts = paged_attention_cuda.capacity_launches
        counts[maxp * ps] = counts.get(maxp * ps, 0) + 1
    return out


paged_attention_cuda.launches = 0
paged_attention_cuda.capacity_launches = {}
