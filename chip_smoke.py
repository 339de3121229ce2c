#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases; any failure exits non-zero (there is no caught phase and no CPU
fallback):

1. device   the card's name and power limit (nvidia-smi); no CUDA -> exit 1.
2. build    compile ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a.
3. kernels  each CUDA kernel against its plain torch version on the card,
            at the main path's shapes, the sweep shapes of
            ``tests/test_kernels.py`` and the edges of the kernels' tiles
            (the SSD scan also shows which variant ran: bf16 must take the
            tensor cores); times the kernel, the plain version
            and one PyTorch library call where one computes the same
            function, beside the card's bound, and the kernel's and the
            call's device time alone and the wrapper's host time.
            A model with a sliding window (gemma2-2b) gets cases and
            times at its own heads, window and logit softcap, with scores
            scaled past the cap so a kernel that dropped it would fail; its
            library call is flex_attention with the softcap as score_mod
            (SDPA without the softcap is timed beside, a different
            function).
Then for each model, olmo-1b, mamba2-780m and gemma2-2b, at full published
width (random weights from --seed):
4. model    a prefill plus 16 decode steps on the kernel path against the
            plain path, teacher-forced (a windowed model: a prompt 64
            tokens past its window; under a logit softcap, again with the
            query projections scaled by 100 so that the cap binds); then a
            prefill of the longest prompt and one decode step at the
            engine's shape, each timed and traced with torch.profiler
            (device busy share, launches, costliest kernels).
5. engine   RealEngine in passthrough, static_colocate, dynamic_pd and
            disagg: 8 requests, prompts of 128-1024 tokens (a windowed
            model's first one lengthened to 304 tokens past its window:
            4400 for gemma2-2b, so its local layers' 4096-slot ring
            wraps), 32 new tokens each, arriving as a burst.  Every
            request must complete, with the same tokens in every mode, and
            the launch counters (reset just before each mode) must show the
            engine ran through the model's kernels, every SSD scan on the
            tensor cores.
6. report   one ``{"kernels": [...]}`` line, then the card line, then
            ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# flex_attention (the softcapped library call) compiles through inductor
# and Triton: their caches stay inside the checkout
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                      os.path.join(ROOT, "build", "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
SPIN_CYCLES_PER_S = 2e9       # above the H100's 1.98 GHz boost clock, so a
                              # spin of n cycles lasts at least n / 2e9 s
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}   # tests/test_kernels.py
# a windowed model's attention cases also hold ||got - want|| / ||want||
# under this: both sides round to bf16, at most a step (2^-8) an element
REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
# q's scale in the softcap cases: bf16 scores of std ~30 pass a cap of 50
# by far; fp32 ones of std ~4 move the output by ten of fp32's tolerances
# (at std ~30 the fp32 scores' own rounding would pass 2e-5)
CAP_BOOST = {torch.bfloat16: 30.0, torch.float32: 4.0}
SSD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
ARCHS = ("olmo-1b", "mamba2-780m", "gemma2-2b")
# a windowed model's traffic lengthens its first prompt to window + 304
# tokens (4400 at gemma2-2b's 4096), and its model phase's prompt is
# window + 64 tokens: both past the window, so the ring caches wrap
PAST_WINDOW = 304
CHECK_PAST_WINDOW = 64
MAX_NUM_SEQS = 4
N_REQUESTS = 8
MAX_NEW = 32
MODEL_DECODE_STEPS = 16
TIE_EPS = 0.02                # tests/test_models_decode.py::agree_step
SSM_DECODE_EXACT = 5e-3       # tests/test_models_decode.py, mamba2
MODES = ("passthrough", "static_colocate", "dynamic_pd", "disagg")


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_label(ptxas_line: str) -> str:
    """``ssd_chunk_scan<64,128>`` or ``paged_attention_kernel<bf16,256,2>``
    from ptxas's "Compiling entry function '<mangled name>'" line (integer
    and bool template arguments, and the element type as bf16 or f32)."""
    m = re.search(r"\d+((?:flash|paged|ssd)_\w*?)(I|E)", ptxas_line)
    if m is None:
        return ptxas_line.strip()
    if m.group(2) == "E":
        return m.group(1)
    span = re.match(r"(?:L[ib]\d+E|\d+__nv_bfloat16|f)*",
                    ptxas_line[m.end():]).group(0)
    args = ["bf16" if a.endswith("bfloat16") else "f32" if a == "f"
            else a[2:-1]
            for a in re.findall(r"L[ib]\d+E|\d+__nv_bfloat16|f", span)]
    return f"{m.group(1)}<{','.join(args)}>"


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call, from CUDA events around ``iters``
    back-to-back calls.  Where a call's host-side work (argument checks,
    allocation, the launch) outlasts its kernel, the host's issue rate sets
    this time: it is the pace a caller sees."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_held(fn, iters: int, warmup: int = 2):
    """(device ms, host us) of one call.  A spin kernel holds the stream
    while the host issues ``iters`` calls, for longer than that takes, so
    the events around them time the card alone and the host clock times
    the issue alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_call_s = time.perf_counter() - t0     # host issue + device, a bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((iters * one_call_s + 1e-3) * SPIN_CYCLES_PER_S))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, 1e6 * host_s / iters


def kernel_times(kernel, plain, library, iters: int = 50):
    """The kernels line's times for one kernel: ``ms``, ``plain_ms`` and
    ``library_ms`` by ``time_ms``; beside them the kernel's and the library
    call's device time and the kernel wrapper's host time per call, by
    ``time_held``."""
    t = dict(ms=time_ms(kernel, iters),
             plain_ms=time_ms(plain, 3, warmup=1),
             library_ms=None if library is None else time_ms(library, iters))
    t["device_ms"], t["host_us"] = time_held(kernel, iters)
    t["library_device_ms"] = (None if library is None
                              else time_held(library, iters)[0])
    return t


def times_text(t) -> str:
    return " ".join(f"{k}={t[k]!r}" for k in (
        "ms", "device_ms", "host_us", "plain_ms", "library_ms",
        "library_device_ms", "bound_ms")) + f" ({t['bound_by']})"


def bound(flops: float, nbytes: float):
    """Least time for the work on the card (bf16 inputs: the tensor cores'
    bf16 peak), and whether operations or bytes set it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(got, want) -> float:
    """||got - want|| / ||want||."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def check_rel(name: str, got, want, dtype) -> float:
    rel = rel_err(got, want)
    require(rel < REL_TOL[dtype],
            f"{name}: kernel's error is {rel:.3g} of the output's norm "
            f"(bound {REL_TOL[dtype]})")
    return rel


def check_cap_binds(name: str, want, uncapped, dtype) -> float:
    """The plain version with the softcap and without it differ by ten
    tolerances or more, elementwise and in norm: a kernel that dropped the
    cap could not pass."""
    rel, err = rel_err(uncapped, want), max_err(uncapped, want)
    require(rel > 10 * REL_TOL[dtype] and err > 10 * TOL[dtype],
            f"{name}: the softcap does not bind (without it the output "
            f"moves {err:.3g}, {rel:.3g} of its norm)")
    return rel


def check_close(name: str, got, want, dtype, tols=TOL) -> float:
    err = max_err(got, want)
    tol = tols[dtype]
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    require(ok, f"{name}: kernel disagrees with its plain version "
                f"(max abs err {err:.3g}, tolerance {tol})")
    return err


# ------------------------------------------------------------------ traffic

def engine_traffic(seed: int, vocab: int, long_first: int = 0):
    """8 prompts of 128-1024 tokens; the first lengthened to
    ``long_first`` tokens if that is set.  The slot cache holds the
    longest prompt and its new tokens, rounded up to 64."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 1025, N_REQUESTS)
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in lens]
    if long_first:
        prompts[0] += rng.integers(0, vocab,
                                   long_first - len(prompts[0])).tolist()
    longest = max(len(p) for p in prompts)
    return prompts, 64 * math.ceil((longest + MAX_NEW) / 64)


# ------------------------------------------------------------ kernel checks

def layer_windows(cfg):
    """The windows of a model's attention layers, 0 for global."""
    from repro_torch.models.transformer import block_pattern
    return sorted({d.window for d in block_pattern(cfg)})


def flash_cases(prompt_lens, windowed):
    """(label, B, S, T, H, KVH, D, dtype, kwargs) — the engine's prefill
    shapes first, then the sweeps of tests/test_kernels.py, then each
    windowed model's (``windowed``: (cfg, its prompt lengths)) at its own
    heads and softcap: its longest prefill in every kind of layer, the
    64-row tile edges, kv_len.  Cases whose ``q_boost`` scales q past the
    cap also check that the cap binds; ``model`` marks a windowed model's
    cases (also held under REL_TOL), ``timed`` the shapes timed later."""
    cases = [(f"main S={s}", 1, s, s, 16, 16, 128, torch.bfloat16,
              dict(causal=True, scale=128 ** -0.5)) for s in prompt_lens]
    for S, H, KVH, D in [(64, 4, 2, 32), (100, 4, 4, 64), (33, 8, 2, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"sweep S={S} H={H}/{KVH} D={D}", 2, S, S, H, KVH,
                          D, dt, dict(causal=True, scale=D ** -0.5)))
    for dt in (torch.float32, torch.bfloat16):
        for window, softcap, causal in [(16, 0.0, True), (0, 25.0, True),
                                        (16, 25.0, True), (0, 0.0, False)]:
            cases.append((f"variant w={window} cap={softcap} "
                          f"causal={causal}", 1, 80, 80, 4, 2, 32, dt,
                          dict(causal=causal, scale=0.2, window=window,
                               softcap=softcap)))
        cases.append(("kv_len=70 of T=100", 1, 48, 100, 4, 2, 64, dt,
                      dict(causal=False, scale=0.2, kv_len=70)))
        for S in (1, 63, 64, 65, 129):              # the 64-row tile edges
            cases.append((f"edge S={S}", 1, S, S, 4, 2, 128, dt,
                          dict(causal=True, scale=128 ** -0.5)))
    for cfg, lens in windowed:
        H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        cap, S, name = cfg.attn_logit_softcap, max(lens), cfg.name
        base = dict(causal=True, scale=D ** -0.5, softcap=cap, model=name)
        for window in layer_windows(cfg):
            for boost in (1.0, CAP_BOOST[torch.bfloat16]) if cap else (1.0,):
                cases.append((f"{name} S={S} window={window} cap={cap:g} "
                              f"q*{boost:g}", 1, S, S, H, KVH, D,
                              torch.bfloat16,
                              dict(base, window=window, q_boost=boost,
                                   timed=boost == 1.0)))
        for dt in (torch.float32, torch.bfloat16):
            for S_ in (1, 63, 64, 65, 129):
                for window in (0, 40):
                    for boost in ((1.0, CAP_BOOST[dt]) if cap and S_ > 64
                                  else (1.0,)):
                        cases.append((f"{name} edge S={S_} window={window} "
                                      f"cap={cap:g} q*{boost:g}", 1, S_, S_,
                                      H, KVH, D, dt,
                                      dict(base, window=window,
                                           q_boost=boost)))
            cases.append((f"{name} kv_len=70 of T=100", 1, 48, 100, H, KVH,
                          D, dt, dict(base, causal=False, kv_len=70)))
    return cases


def check_flash(prompt_lens, windowed, gen):
    from repro_torch.kernels import flash_attention as FA
    main_err, errs = 0.0, {}
    for label, B, S, T, H, KVH, D, dt, kw in flash_cases(prompt_lens,
                                                         windowed):
        kw = dict(kw)
        boost, model = kw.pop("q_boost", 1.0), kw.pop("model", None)
        timed = kw.pop("timed", False)
        q = (torch.randn(B, S, H, D, generator=gen, device="cuda")
             * boost).to(dt)
        k = torch.randn(B, T, KVH, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, T, KVH, D, generator=gen, device="cuda").to(dt)
        got = FA.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        want = FA.flash_attention_plain(q, k, v, **kw)
        name = f"flash_attention {label} {str(dt)[6:]}"
        err = check_close(name, got, want, dt)
        text = f"max_abs_err={err:.3g}"
        if model:
            text += f" rel_err={check_rel(name, got, want, dt):.3g}"
        if boost > 1:
            uncapped = FA.flash_attention_plain(q, k, v,
                                                **dict(kw, softcap=0.0))
            text += (" (without the cap the plain output moves "
                     f"{check_cap_binds(name, want, uncapped, dt):.3g} of "
                     "its norm)")
        if label.startswith("main"):
            main_err = max(main_err, err)
        if timed:
            errs[model, kw["window"]] = err
        print(f"  {name}: {text}")

    # timing at the shortest prompt of the engine's traffic (its own line),
    # then at each windowed model's longest in every kind of layer, then at
    # olmo-1b's longest (the kernels line)
    S = min(prompt_lens)
    print(f"  flash_attention at q/k/v [1,{S},16,128] bf16 causal: "
          f"{times_text(time_flash(FA, S, gen))}")
    extra = []
    for cfg, lens in windowed:
        H, KVH, D, S = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        max(lens))
        for window in layer_windows(cfg):
            t = time_flash(FA, S, gen, H=H, KVH=KVH, D=D, window=window,
                           softcap=cfg.attn_logit_softcap)
            t["model"] = cfg.name
            t["shape"] = (f"q [1,{S},{H},{D}], k/v [1,{S},{KVH},{D}] bf16 "
                          f"causal, window {window}, softcap "
                          f"{cfg.attn_logit_softcap:g}")
            t["max_abs_err"] = errs[cfg.name, window]
            print(f"  flash_attention at {t['shape']}: {times_text(t)}")
            print_sdpa_without_softcap("flash_attention", t)
            extra.append(t)
    S = max(prompt_lens)
    t = time_flash(FA, S, gen)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:82",
                max_abs_err=main_err, **t,
                shape=f"q/k/v [1,{S},16,128] bf16 causal", windowed=extra)


def print_sdpa_without_softcap(kernel: str, t) -> None:
    if "sdpa_without_softcap_ms" in t:
        print(f"  {kernel} at {t['shape']}: SDPA without the softcap (a "
              f"different function): ms={t['sdpa_without_softcap_ms']!r} "
              f"device_ms={t['sdpa_without_softcap_device_ms']!r}")


def flex_softcap_call(q, k, v, want, *, scale: float, softcap: float,
                      mask_mod, B):
    """One call of ``torch.nn.attention.flex_attention`` computing the
    kernels' softcapped attention: the softcap as its score_mod, the mask
    as a block mask, GQA by enable_gqa; q [B, H, Sq, D], k/v [B, KVH, T,
    D].  It is compiled here, outside any timing, after dynamo's caches
    are cleared (a compiled graph is otherwise reused for a new mask_mod
    whose identity guard it passes), and returned only if it agrees with
    ``want`` (the plain version, [B, Sq, H, D]) under TOL and REL_TOL;
    otherwise None, so no time is reported for a different function."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / softcap) * softcap

    torch._dynamo.reset()
    flex = torch.compile(flex_attention, dynamic=False)
    block_mask = create_block_mask(mask_mod, B=B, H=None, Q_LEN=q.shape[2],
                                   KV_LEN=k.shape[2], device=q.device)

    def call():
        return flex(q, k, v, score_mod=score_mod, block_mask=block_mask,
                    scale=scale, enable_gqa=q.shape[1] != k.shape[1])

    t0 = time.monotonic()
    out = call().transpose(1, 2)
    torch.cuda.synchronize()
    err, rel = max_err(out, want), rel_err(out, want)
    agrees = (bool(torch.allclose(out.float(), want.float(),
                                  rtol=TOL[q.dtype], atol=TOL[q.dtype]))
              and rel < REL_TOL[q.dtype])
    print(f"    flex_attention (compiled in {time.monotonic() - t0:.1f} s) "
          f"against the plain version: max_abs_err={err:.3g} "
          f"rel_err={rel:.3g}: "
          + ("the same function" if agrees else
             "DISAGREES, so no library time is reported"))
    return call if agrees else None


def time_flash(FA, S: int, gen, H=16, KVH=16, D=128, window=0,
               softcap=0.0):
    """Kernel, plain and library times at q [1, S, H, D], k/v [1, S, KVH,
    D] bf16, causal, beside the card's bound for the (q, k) pairs the
    band holds.  The library call is SDPA; under a softcap, which SDPA
    lacks, it is flex_attention with the cap as its score_mod, and SDPA
    without the cap is timed apart (``sdpa_without_softcap_*``, a
    different function)."""
    q = torch.randn(1, S, H, D, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(1, S, KVH, D, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window:
        pos = torch.arange(S, device="cuda")
        mask = ((pos[None] <= pos[:, None])
                & (pos[None] > pos[:, None] - window))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=mask is None,
            scale=kw["scale"], enable_gqa=KVH != H)

    library = sdpa
    if softcap:
        if window:
            def mask_mod(b, h, q_idx, kv_idx):
                return (q_idx >= kv_idx) & (q_idx - kv_idx < window)
        else:
            def mask_mod(b, h, q_idx, kv_idx):
                return q_idx >= kv_idx
        library = flex_softcap_call(
            qt, kt, vt, FA.flash_attention_plain(q, k, v, **kw),
            scale=kw["scale"], softcap=softcap, mask_mod=mask_mod, B=None)
    t = kernel_times(lambda: FA.flash_attention_cuda(q, k, v, **kw),
                     lambda: FA.flash_attention_plain(q, k, v, **kw),
                     library)
    if softcap:
        t["sdpa_without_softcap_ms"] = time_ms(sdpa, 50)
        t["sdpa_without_softcap_device_ms"] = time_held(sdpa, 50)[0]
    pairs = (sum(min(i + 1, window) for i in range(S)) if window
             else S * (S + 1) // 2)                 # causal (q, k) pairs
    flops = 4.0 * H * D * pairs
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, k, v, out
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(t, bound_ms=bound_ms, bound_by=bound_by)


def paged_inputs(B, H, KVH, D, ps, maxp, dt, gen, *, identity, lengths,
                 q_boost=1.0):
    P = B * maxp + (0 if identity else 1)
    q = (torch.randn(B, H, D, generator=gen, device="cuda") * q_boost).to(dt)
    kp = torch.randn(P, ps, KVH, D, generator=gen, device="cuda").to(dt)
    vp = torch.randn(P, ps, KVH, D, generator=gen, device="cuda").to(dt)
    order = (torch.arange(P, device="cuda") if identity else
             torch.randperm(P, generator=gen, device="cuda"))
    pt = order[:B * maxp].view(B, maxp).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, ln


def check_paged(max_len, prompt_lens, windowed, gen):
    """``windowed``: (cfg, its prompt lengths, its max_len) for each model
    with a sliding window."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.models.layers import page_size
    ps = page_size(max_len)
    main_lens = [min(n + MAX_NEW // 2, max_len)
                 for n in prompt_lens[:MAX_NUM_SEQS]]
    # (label, B, H, KVH, D, ps, maxp, dtype, identity, lengths, scale, cap,
    #  meta: q_boost and model as in flash_cases)
    cases = [("main slot cache", MAX_NUM_SEQS, 16, 16, 128, ps,
              max_len // ps, torch.bfloat16, True, main_lens, 128 ** -0.5,
              0.0, {})]
    for B, H, KVH, D, pps, maxp in [(2, 4, 1, 32, 8, 3), (3, 8, 2, 64, 16, 4),
                                    (1, 12, 4, 128, 32, 2)]:
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"sweep B={B} H={H}/{KVH} D={D} ps={pps}", B, H,
                          KVH, D, pps, maxp, dt, False,
                          [1 + (i * 7) % (pps * maxp) for i in range(B)],
                          D ** -0.5, 0.0, {}))
    cases.append(("softcap", 2, 4, 2, 32, 8, 3, torch.float32, True, [20, 9],
                  0.2, 30.0, {}))
    maxp = max_len // ps
    for dt in (torch.float32, torch.bfloat16):
        cases += [
            ("length 1", MAX_NUM_SEQS, 16, 16, 128, ps, maxp, dt, True,
             [1] * MAX_NUM_SEQS, 128 ** -0.5, 0.0, {}),
            ("full capacity", MAX_NUM_SEQS, 16, 16, 128, ps, maxp, dt, True,
             [max_len] * MAX_NUM_SEQS, 128 ** -0.5, 0.0, {}),
            # 30 splits of 32 tokens over 2 chunks: 28 splits empty
            ("more splits than chunks", 1, 2, 1, 64, 16, 60, dt, False,
             [40], 0.125, 0.0, {}),
            ("G=12 in chunks of 8", 2, 24, 2, 64, 16, 4, dt, False, [50, 7],
             0.125, 30.0, {}),
            # B * KVH = 264 >= 2 * 132 SMs: one split, no partials
            ("one split", 33, 16, 8, 128, 16, 4, dt, False,
             [1 + (i * 13) % 64 for i in range(33)], 128 ** -0.5, 0.0, {}),
        ]
    # each windowed model's decode at its own heads and softcap: its ring
    # of `window` slots (the engine passes lengths up to T; the kernel
    # clamps those past it) and its global cache, as the engine's slot
    # caches hold them mid-decode
    timed = ["main slot cache"]
    for cfg, lens, w_max_len in windowed:
        H, KVH, D, name = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.name)
        cap, W = cfg.attn_logit_softcap, cfg.sliding_window
        ring_T = min(w_max_len, W)
        caches = [(f"{name} ring", ring_T,
                   [min(n, ring_T) for n in decode_lens(w_max_len, lens)])]
        if 0 in layer_windows(cfg):
            caches.append((f"{name} global", w_max_len,
                           decode_lens(w_max_len, lens)))
        meta = dict(model=name)
        for dt in (torch.float32, torch.bfloat16):
            for label, T, c_lens in caches:
                c_ps = page_size(T)
                for boost in (1.0, CAP_BOOST[dt]) if cap else (1.0,):
                    cases.append((f"{label} q*{boost:g}", MAX_NUM_SEQS, H,
                                  KVH, D, c_ps, T // c_ps, dt, True, c_lens,
                                  D ** -0.5, cap,
                                  dict(meta, q_boost=boost)))
            r_ps = page_size(ring_T)
            cases += [
                (f"{name} ring at and past T", MAX_NUM_SEQS, H, KVH, D, r_ps,
                 ring_T // r_ps, dt, True, [ring_T, ring_T + 1, 1,
                                            ring_T - 1], D ** -0.5, cap,
                 meta),
                (f"{name} one split", 264 // KVH, H, KVH, D, 16, 4, dt,
                 False, [1 + (i * 13) % 64 for i in range(264 // KVH)],
                 D ** -0.5, cap, meta),
            ]
        timed += [f"{label} q*1" for label, _, _ in caches]
    main_err = 0.0
    sms = PA.sm_count(torch.device("cuda"))
    to_time = {}
    for (label, B, H, KVH, D, pps, maxp, dt, ident, lens, scale, cap,
         meta) in cases:
        args = paged_inputs(B, H, KVH, D, pps, maxp, dt, gen,
                            identity=ident, lengths=lens,
                            q_boost=meta.get("q_boost", 1.0))
        want = PA.paged_attention_plain(*args, scale=scale, softcap=cap)
        n_split, span = PA.split_plan(B, KVH, maxp * pps, sms)
        name = f"paged_attention {label} {str(dt)[6:]}"
        # twice: the second launch finds the first one's tickets reset
        for _ in range(2):
            got = PA.paged_attention_cuda(*args, scale=scale, softcap=cap)
            torch.cuda.synchronize()
            err = check_close(name, got, want, dt)
        text = f"max_abs_err={err:.3g}"
        if "model" in meta:
            text += f" rel_err={check_rel(name, got, want, dt):.3g}"
        if meta.get("q_boost", 1.0) > 1:
            uncapped = PA.paged_attention_plain(*args, scale=scale)
            text += (" (without the cap the plain output moves "
                     f"{check_cap_binds(name, want, uncapped, dt):.3g} of "
                     "its norm)")
        if label.startswith("main"):
            main_err = err
        if label in timed and dt == torch.bfloat16:
            to_time[label] = (args, scale, cap, n_split, meta.get("model"),
                              err)
        print(f"  {name} ({n_split} splits of {span}): {text}")

    extra = []
    for label in timed[1:]:
        args, scale, cap, n_split, model, err = to_time[label]
        t = time_paged(PA, args, scale, cap)
        B, H, D = args[0].shape
        t["model"] = model
        t["shape"] = (f"{label.removesuffix(' q*1')}: q [{B},{H},{D}] over "
                      f"{tuple(args[1].shape)} bf16 pages, lengths "
                      f"{args[4].tolist()}, softcap {cap:g}, {n_split} "
                      f"splits")
        t["max_abs_err"] = err
        print(f"  paged_attention at {t['shape']}: {times_text(t)}")
        print_sdpa_without_softcap("paged_attention", t)
        extra.append(t)
    args, scale, cap, n_split, _, _ = to_time["main slot cache"]
    t = time_paged(PA, args, scale, cap)
    return dict(name="paged_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:77",
                max_abs_err=main_err, **t,
                shape=f"q [{MAX_NUM_SEQS},16,128], slot cache "
                      f"[{MAX_NUM_SEQS},{max_len},16,128] bf16, ps={ps}, "
                      f"lengths {main_lens}, {n_split} splits",
                windowed=extra)


def decode_lens(max_len: int, prompt_lens):
    """Each of the first MAX_NUM_SEQS requests' cache length half way
    through its decode."""
    return [min(n + MAX_NEW // 2, max_len) for n in prompt_lens[:MAX_NUM_SEQS]]


def time_paged(PA, args, scale: float, softcap: float = 0.0):
    """Kernel, plain and library times for one decode attention over an
    identity-paged cache (the engine's dense slot cache), beside the
    card's bound.  The library call is SDPA on the dense cache, masked to
    each length; under a softcap, flex_attention with the cap as its
    score_mod and the lengths as its block mask, and SDPA without the cap
    is timed apart (``sdpa_without_softcap_*``, a different function)."""
    q, kp, vp, pt, ln = args
    B, H, D = q.shape
    _, ps, KVH, _ = kp.shape
    T = pt.shape[1] * ps
    # identity page table: the pages are the dense [B, T, KVH, D] cache
    kd = kp.view(B, T, KVH, D).transpose(1, 2)
    vd = vp.view(B, T, KVH, D).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None] < ln[:, None].long())
    mask = mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask, scale=scale,
            enable_gqa=KVH != H)

    library = sdpa
    if softcap:
        held = ln.clamp(max=T)

        def mask_mod(b, h, q_idx, kv_idx):
            return kv_idx < held[b]
        library = flex_softcap_call(
            q[:, :, None], kd, vd,
            PA.paged_attention_plain(*args, scale=scale,
                                     softcap=softcap)[:, None],
            scale=scale, softcap=softcap, mask_mod=mask_mod, B=B)
    t = kernel_times(
        lambda: PA.paged_attention_cuda(*args, scale=scale, softcap=softcap),
        lambda: PA.paged_attention_plain(*args, scale=scale,
                                         softcap=softcap),
        library)
    if softcap:
        t["sdpa_without_softcap_ms"] = time_ms(sdpa, 50)
        t["sdpa_without_softcap_device_ms"] = time_held(sdpa, 50)[0]
    lens = [min(int(n), T) for n in ln.tolist()]
    n_tok = sum(lens)
    elt = q.element_size()
    flops = 4.0 * H * D * n_tok
    nbytes = (2 * q.numel() * elt                   # q read, out written
              + 2 * n_tok * KVH * D * elt           # the K and V rows used
              + sum(math.ceil(n / ps) for n in lens) * 4
              + B * 4)                              # page-table rows, lengths
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(t, bound_ms=bound_ms, bound_by=bound_by)


def ssd_inputs(B, S, H, P, G, N, dt_type, gen, *, init):
    """tests/test_kernels.py's SSD inputs (softplus dt, A < 0, B/C * 0.5)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    args = (randn(B, S, H, P).to(dt_type), F.softplus(randn(B, S, H)),
            -torch.exp(randn(H) * 0.3), (randn(B, S, G, N) * 0.5).to(dt_type),
            (randn(B, S, G, N) * 0.5).to(dt_type))
    return args, (randn(B, H, P, N) if init else None)


def ssd_cases(S: int):
    """(label, (B, S, H, P, G, N, chunk), dtype, init) — the sweeps of
    tests/test_kernels.py, the bf16 kernel's 64-row tile and chunk edges
    at mamba2-780m's widths, the reduced model's and the widest shapes,
    then the engine's prefill at the longest prompt."""
    main = (1, S, 48, 64, 1, 128, 256)          # mamba2-780m's prefill
    cases = []
    for dt_type in (torch.float32, torch.bfloat16):
        for shape in [(2, 64, 2, 16, 1, 16, 16), (2, 70, 4, 16, 2, 32, 32),
                      (2, 32, 8, 64, 1, 128, 8)]:
            cases.append(("sweep", shape, dt_type, False))
        cases.append(("initial state", (1, 40, 2, 16, 1, 16, 16), dt_type,
                      True))
    for init in (False, True):
        for S_, chunk in [(63, 256), (64, 256), (65, 256), (255, 256),
                          (256, 256), (257, 256), (1024, 256), (300, 64),
                          (300, 128)]:
            cases.append(("edge", (1, S_, 48, 64, 1, 128, chunk),
                          torch.bfloat16, init))
        cases += [("reduced", (2, 100, 16, 16, 1, 16, 32), torch.bfloat16,
                   init),
                  ("P=N=128", (1, 300, 4, 128, 1, 128, 256), torch.bfloat16,
                   init),
                  ("main", main, torch.bfloat16, init)]
    return main, cases


def check_ssd(prompt_lens, gen):
    from repro_torch.kernels import ssd_scan as SSD
    S = max(prompt_lens)
    main, cases = ssd_cases(S)
    main_err = 0.0
    for label, (B, S_, H, P, G, N, chunk), dt_type, init in cases:
        args, st = ssd_inputs(B, S_, H, P, G, N, dt_type, gen, init=init)
        variant = "wgmma" if dt_type == torch.bfloat16 else "cuda_core"
        before = SSD.ssd_scan_cuda.variant_launches[variant]
        y, fin = SSD.ssd_scan_cuda(*args, chunk=chunk, initial_state=st)
        torch.cuda.synchronize()
        require(SSD.ssd_scan_cuda.variant_launches[variant] == before + 1,
                f"ssd_scan {label}: {str(dt_type)[6:]} did not run the "
                f"{variant} kernel")
        y_ref, fin_ref = SSD.ssd_scan_plain(*args, chunk=chunk,
                                            initial_state=st)
        name = (f"ssd_scan {label} [{B},{S_},{H},{P}] G={G} N={N} "
                f"chunk={chunk} init={init} {str(dt_type)[6:]} ({variant})")
        err = max(check_close(f"{name} y", y, y_ref, dt_type, SSD_TOL),
                  check_close(f"{name} final state", fin, fin_ref, dt_type,
                              SSD_TOL))
        if label == "main":
            main_err = max(main_err, err)
        print(f"  {name}: max_abs_err={err:.3g}")

    # timing at the engine's longest prompt, with the initial state the
    # engine's prefill passes (the zeroed slot state)
    B, S, H, P, G, N, chunk = main
    args, st = ssd_inputs(B, S, H, P, G, N, torch.bfloat16, gen, init=True)
    t = kernel_times(
        lambda: SSD.ssd_scan_cuda(*args, chunk=chunk, initial_state=st),
        lambda: SSD.ssd_scan_plain(*args, chunk=chunk, initial_state=st),
        None)
    rows = [min(chunk, S - t0) for t0 in range(0, S, chunk)]
    flops = B * H * sum(q * (q + 1) * (N + P) + 4 * q * N * P for q in rows)
    x, dt, A, Bm, Cm = args
    nbytes = (2 * x.numel() * x.element_size()      # x read, y written
              + 2 * Bm.numel() * Bm.element_size()  # B, C read
              + dt.numel() * 4 + A.numel() * 4
              + 2 * st.numel() * 4)                 # state in and out
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:81",
                max_abs_err=main_err, **t, bound_ms=bound_ms,
                bound_by=bound_by,
                shape=f"x [1,{S},48,64] bf16, B/C [1,{S},1,128] bf16, "
                      f"state [1,48,64,128] fp32, chunk {chunk}")


# -------------------------------------------------------------------- model

def prefill_decode(model, params, toks, P: int):
    """Prefill ``toks[:, :P]``, then decode the rest teacher-forced.
    Returns (logits [B, S-P+1, V], prefill ms, ms a decode step), the
    times on the host clock to a synchronize."""
    B, S = toks.shape
    cache = model.init_cache(B, S, device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    lg, cache, _ = model.prefill(params, {"tokens": toks[:, :P]}, cache)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    steps = [lg]
    for t in range(P, S):
        lg, cache = model.decode(params, toks[:, t], cache,
                                 torch.full((B,), t, dtype=torch.int32,
                                            device="cuda"))
        steps.append(lg)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    return (torch.stack(steps, 1), 1e3 * (t1 - t0),
            1e3 * (t2 - t1) / (S - P))


def compare_logits(what: str, got, ref) -> float:
    """Print and gate: max softmax error below 0.05 and tie-aware argmax
    agreement (tests/test_models_decode.py)."""
    p_got, p_ref = got.softmax(-1), ref.softmax(-1)
    prob_err = max_err(p_got, p_ref)
    a_got, a_ref = got.argmax(-1), ref.argmax(-1)
    p_top = p_ref.gather(-1, a_ref[..., None])[..., 0]
    p_picked = p_ref.gather(-1, a_got[..., None])[..., 0]
    tie_agree = bool(((a_got == a_ref) | (p_top - p_picked < TIE_EPS)).all())
    exact = float((a_got == a_ref).float().mean())
    print(f"  model: {what}: max softmax err {prob_err:.3g} (bound 0.05; "
          f"prefill position {max_err(p_got[:, 0], p_ref[:, 0]):.3g}), "
          f"logits max abs diff {max_err(got, ref):.3g}, exact argmax "
          f"agreement {exact:.3f}, tie-aware agreement {tie_agree}")
    require(prob_err < 0.05, f"model: {what}: softmax error {prob_err}")
    require(tie_agree, f"model: {what}: argmax disagrees beyond tie_eps")
    return prob_err


def check_model(cfg, params, seed: int, B: int = 2, P: int = 256):
    """The kernel path's prefill of B x P tokens plus decode against the
    plain path's teacher-forced forward (the gate of
    tests/test_models_decode.py), and against the plain path's own prefill
    plus decode (the same steps, so only the kernels differ).  The fp32
    logits are built only at the positions compared."""
    from repro_torch.models import build_model
    kernel = build_model(cfg)
    plain = build_model(cfg, attn_impl="plain")
    rng = np.random.default_rng(seed + 1)
    S = P + MODEL_DECODE_STEPS
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                        dtype=torch.long, device="cuda")
    with torch.inference_mode():
        x, _ = plain.forward(params, {"tokens": toks})
        ref = plain._logits(params, x[:, P - 1:])          # [B, 17, V]
    got, prefill_ms, step_ms = prefill_decode(kernel, params, toks, P)
    print(f"  model: kernel path, host clock to a synchronize: prefill "
          f"{B}x{P} {prefill_ms!r} ms, decode step (batch {B}) "
          f"{step_ms!r} ms")
    require(bool(torch.isfinite(got).all()), "model: non-finite logits")
    require(tuple(got.shape) == (B, S - P + 1, cfg.vocab_size),
            f"model: logits shape {tuple(got.shape)}")
    steps = f"{B}x{P} prompt + {MODEL_DECODE_STEPS} decode steps"
    prob_err = compare_logits(
        f"{steps}, kernel path vs plain path teacher-forced", got, ref)
    if cfg.attention_free:
        where = "within" if prob_err < SSM_DECODE_EXACT else "above"
        print(f"  model: max softmax err {prob_err:.3g} is {where} the "
              f"{SSM_DECODE_EXACT} of tests/test_models_decode.py::"
              f"test_mamba2_decode_exact (reported, not gated)")
    same, _, _ = prefill_decode(plain, params, toks, P)
    compare_logits(f"{steps}, kernel path vs plain path, the same steps",
                   got, same)


def check_softcap_binds(cfg, params, seed: int, boost: float = 100.0,
                        P: int = 256) -> None:
    """The model phase's check at B = 1 and P tokens with every query
    projection scaled by ``boost``, so the attention scores pass the logit
    softcap: the kernel path must match the plain path under
    compare_logits' gates, and its logits must lie five times closer (mean
    absolute difference) to the plain path's than the plain path without
    the cap does, so a kernel path that lost the cap would fail."""
    import dataclasses

    from repro_torch.models import build_model
    boosted = dict(params, blocks=[
        dict(b, attn=dict(b["attn"], wq=b["attn"]["wq"] * boost))
        for b in params["blocks"]])
    rng = np.random.default_rng(seed + 3)
    S = P + MODEL_DECODE_STEPS
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, S)),
                        dtype=torch.long, device="cuda")
    refs = []
    with torch.inference_mode():
        for c in (cfg, dataclasses.replace(cfg, attn_logit_softcap=0.0)):
            plain = build_model(c, attn_impl="plain")
            x, _ = plain.forward(boosted, {"tokens": toks})
            refs.append(plain._logits(boosted, x[:, P - 1:]).float())
    got, _, _ = prefill_decode(build_model(cfg), boosted, toks, P)
    what = (f"query projections x{boost:g}, 1x{P} prompt + "
            f"{MODEL_DECODE_STEPS} decode steps")
    compare_logits(f"{what}, kernel path vs plain path teacher-forced",
                   got, refs[0])
    err = float((got.float() - refs[0]).abs().mean())
    moved = float((refs[1] - refs[0]).abs().mean())
    p_moved = max_err(refs[0].softmax(-1), refs[1].softmax(-1))
    print(f"  model: {what}: mean |logit difference| kernel vs plain "
          f"{err:.3g}, plain without the softcap vs plain {moved:.3g} "
          f"(gate: 5x apart; the softmax moves {p_moved:.3g})")
    require(5 * err < moved, f"model: {what}: the logit softcap does not "
                             f"bind (kernel path {err:.3g} from the plain "
                             f"path, without the cap {moved:.3g})")


def print_trace(prof, per: int, host_ms: float, what: str):
    """From a torch.profiler trace of ``per`` runs: the device's busy time
    a run, its share of ``host_ms``, the kernel launches and the costliest
    kernels.  Returns (busy ms, launches, {kernel: ms}), a run each."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / per
    n_launch = sum(e.count for e in kernels) / per
    print(f"  {what}: profiler: device busy {busy_ms!r} ms "
          f"({n_launch:.0f} kernel launches)")
    by_kernel = {e.key: e.self_device_time_total / 1e3 / per
                 for e in kernels}
    if busy_ms == 0:
        print(f"  {what}: device busy share: not measured (the profiler saw "
              f"no CUDA kernel)")
        return busy_ms, n_launch, by_kernel
    print(f"  {what}: device busy share {busy_ms / host_ms!r}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3 / per:8.4f} ms "
              f"x{e.count // per:<4d} {e.key[:90]}")
    return busy_ms, n_launch, by_kernel


def profile_prefill(cfg, params, prompt_len: int, seed: int, runs: int = 5):
    """One prefill of a ``prompt_len``-token prompt (batch 1) into a cache
    of that length, as the engine runs it: its host-clock time (median of
    ``runs``), then one run traced with torch.profiler.  Returns the host
    times and print_trace's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    model = build_model(cfg)
    cache = model.init_cache(1, prompt_len, device="cuda")
    rng = np.random.default_rng(seed + 2)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, prompt_len)),
                        dtype=torch.long, device="cuda")

    def run():
        model.prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize()

    run()                                           # warm up
    host_ms = []
    for _ in range(runs):
        t0 = time.monotonic()
        run()
        host_ms.append(1e3 * (time.monotonic() - t0))
    what = f"prefill of {prompt_len} tokens"
    print(f"  {what}: host clock {float(np.median(host_ms))!r} ms (median "
          f"of {runs}: {', '.join(f'{t:.3f}' for t in sorted(host_ms))})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    busy_ms, n_launch, by_kernel = print_trace(
        prof, 1, float(np.median(host_ms)), what)
    return dict(host_ms=host_ms, busy_ms=busy_ms, launches=n_launch,
                by_kernel=by_kernel)


def profile_decode(cfg, params, prompt_lens, max_len, steps: int = 8):
    """One decode step at the engine's shape (MAX_NUM_SEQS sequences over a
    max_len slot cache): its host-clock time, and from torch.profiler the
    device's busy time, its kernel launches and its costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import build_model
    model = build_model(cfg)
    B = MAX_NUM_SEQS
    cache = model.init_cache(B, max_len, device="cuda")
    lens = torch.tensor(prompt_lens[:B], dtype=torch.int32, device="cuda")
    toks = torch.zeros(B, dtype=torch.long, device="cuda")

    def run():
        for _ in range(steps):
            model.decode(params, toks, cache, lens)
        torch.cuda.synchronize()

    run()                                           # warm up
    host_ms = []          # the host clock spreads: take it several times
    for _ in range(5):
        t0 = time.monotonic()
        run()
        host_ms.append(1e3 * (time.monotonic() - t0) / steps)
    step_ms = float(np.median(host_ms))
    what = f"decode step at the engine's shape (batch {B}, cache {max_len})"
    print(f"  {what}: host clock {step_ms!r} ms (median of 5 runs of "
          f"{steps} steps: {', '.join(f'{t:.3f}' for t in sorted(host_ms))})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    print_trace(prof, steps, step_ms, what)


# ------------------------------------------------------------------- engine

def path_kernels(cfg):
    """The kernels a model's serving path runs, each with the phase that
    launches it once a layer: "prefill" (once a request) or "decode" (once
    a decode step)."""
    if cfg.attention_free:
        return {"ssd_scan": "prefill"}
    return {"flash_attention": "prefill", "paged_attention": "decode"}


def check_launches(cfg, mode: str, counts) -> None:
    """Gate one mode's launch counts on the model's path kernels."""
    n_layers = cfg.num_layers
    for name, n in counts.items():
        phase = path_kernels(cfg).get(name)
        if phase is None:
            require(n == 0, f"engine[{mode}]: {name} launched {n} times, "
                            f"off {cfg.name}'s path")
        elif phase == "prefill":
            require(n >= n_layers * N_REQUESTS,
                    f"engine[{mode}]: {name} launched {n} times, expected "
                    f">= {n_layers * N_REQUESTS}")
        else:
            # every request needs MAX_NEW - 1 decode steps after its prefill
            require(n >= n_layers * (MAX_NEW - 1) and n % n_layers == 0,
                    f"engine[{mode}]: {name} launched {n} times, expected "
                    f"a multiple of {n_layers} and "
                    f">= {n_layers * (MAX_NEW - 1)}")
            print(f"  engine[{mode}]: decode steps={n // n_layers}")


def run_engine(cfg, params, prompts, max_len):
    """Serve ``prompts`` in every mode.  Returns the launches of each
    kernel and the SSD scan's launches by variant, summed over the
    modes."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models import build_model
    from repro_torch.serving.engine import RealEngine
    from repro_torch.serving.request import Request

    model = build_model(cfg)
    one = model.init_cache(1, max_len, device="cuda")
    per_req = sum(t.numel() * t.element_size() for t in _leaves(one))
    print(f"  {cfg.name}: one request's cache is {per_req} bytes (what "
          f"disagg moves through host memory)")
    del one
    tokens, totals = {}, dict.fromkeys(launch_counts(), 0)
    variants = dict.fromkeys(ssd_scan_cuda.variant_launches, 0)
    for mode in MODES:
        reqs = [Request(prompt_len=len(p), max_new_tokens=MAX_NEW,
                        prompt_tokens=p, arrival_time=0.0) for p in prompts]
        reset_launch_counts()
        t0 = time.monotonic()
        eng = RealEngine(model, params, mode=mode,
                         max_num_seqs=MAX_NUM_SEQS, max_len=max_len,
                         device="cuda")
        try:
            res = eng.run(reqs, timeout=600)
        finally:
            eng.shutdown()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = launch_counts()
        for k, n in counts.items():
            totals[k] += n
        ssd_variants = dict(ssd_scan_cuda.variant_launches)
        for k, n in ssd_variants.items():
            variants[k] += n
        tokens[mode] = [r.output_tokens for r in reqs]
        print(f"  engine[{cfg.name} {mode}]: completed={res['completed']} "
              f"failed={res['failed']} ttft_mean_s={res['ttft_mean_s']!r} "
              f"ttft_p95_s={res['ttft_p95_s']!r} "
              f"tpot_mean_s={res['tpot_mean_s']!r} wall_s={wall!r} "
              f"launches={counts} ssd_scan variants={ssd_variants}")
        require(res["completed"] == N_REQUESTS and res["failed"] == 0,
                f"engine[{mode}]: {res['completed']}/{N_REQUESTS} completed")
        require(all(len(t) == MAX_NEW for t in tokens[mode]),
                f"engine[{mode}]: a request stopped short")
        check_launches(cfg, mode, counts)
        # the model runs in bf16: every prefill scan on the tensor cores
        require(ssd_variants["wgmma"] == counts["ssd_scan"],
                f"engine[{mode}]: ssd_scan variants {ssd_variants}, "
                f"{counts['ssd_scan']} launches")
    for mode in MODES[1:]:
        require(tokens[mode] == tokens[MODES[0]],
                f"engine: {mode} tokens differ from {MODES[0]}")
    print(f"  engine: tokens identical across {', '.join(MODES)}")
    return totals, variants


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} "
          f"(count={torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda})")
    print(card)

    # 2. build
    t0 = time.monotonic()
    lib_path = build.build()
    build.load()
    print(f"[build] {lib_path.relative_to(ROOT)} in "
          f"{time.monotonic() - t0:.1f} s")
    kernel, serialised = "", 0
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        if "Compiling entry" in line:
            kernel = kernel_label(line)
        elif "Used" in line or "spill" in line:
            print(f"  {kernel}: {line.split(':', 1)[-1].strip()}")
        serialised += "C7519" in line    # wgmma fenced by ptxas
    print(f"  ptxas injected {serialised} warpgroup.arrive fences")

    # 3. kernels against their plain versions
    from repro_torch.models import build_model
    cfgs = [get_config(a) for a in ARCHS]
    # the prompt lengths come first from the seed: the same for every vocab
    traffic = {cfg.name: engine_traffic(
        args.seed, cfg.vocab_size,
        cfg.sliding_window + PAST_WINDOW if cfg.sliding_window else 0)
        for cfg in cfgs}
    # the main shapes are the first model's (olmo-1b's heads)
    prompt_lens = [len(p) for p in traffic[ARCHS[0]][0]]
    max_len = traffic[ARCHS[0]][1]
    windowed = [(cfg, [len(p) for p in traffic[cfg.name][0]],
                 traffic[cfg.name][1]) for cfg in cfgs if cfg.sliding_window]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    print(f"[kernels] engine prompt lengths {prompt_lens}, max_len "
          f"{max_len}" + "".join(f"; {cfg.name}'s {lens}, max_len {n}"
                                 for cfg, lens, n in windowed))
    kernels = [check_flash(prompt_lens,
                           [(cfg, lens) for cfg, lens, _ in windowed], gen),
               check_paged(max_len, prompt_lens, windowed, gen),
               check_ssd(prompt_lens, gen)]
    for k in kernels:
        print(f"  {k['name']} at {k['shape']}: {times_text(k)}")

    launches = dict.fromkeys((k["name"] for k in kernels), 0)
    by_model, ssd_variants = {}, {}
    for cfg in cfgs:
        # 4. model
        prompts, max_len = traffic[cfg.name]
        lens = [len(p) for p in prompts]
        t0 = time.monotonic()
        params = build_model(cfg).init(args.seed, device="cuda")
        n_params = sum(t.numel() for t in _leaves(params))
        print(f"[model] {cfg.name} full width, {n_params} parameters, "
              f"initialised in {time.monotonic() - t0:.1f} s")
        if cfg.sliding_window:            # one prompt past the window
            check_model(cfg, params, args.seed, B=1,
                        P=cfg.sliding_window + CHECK_PAST_WINDOW)
        else:
            check_model(cfg, params, args.seed)
        if cfg.attn_logit_softcap:
            check_softcap_binds(cfg, params, args.seed)
        profile_prefill(cfg, params, max(lens), args.seed)
        profile_decode(cfg, params, lens, max_len)

        # 5. engine (the main path: counters reset just before each mode)
        print(f"[engine] {cfg.name}: {N_REQUESTS} requests x {MAX_NEW} new "
              f"tokens, burst, max_num_seqs={MAX_NUM_SEQS}")
        totals, variants = run_engine(cfg, params, prompts, max_len)
        by_model[cfg.name] = totals
        for name, n in totals.items():
            launches[name] += n
        for name, n in variants.items():
            ssd_variants[name] = ssd_variants.get(name, 0) + n
        del params
        torch.cuda.empty_cache()

    # 6. report
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_by_model"] = {m: n[k["name"]] for m, n in by_model.items()}
        k["passed"] = True
        if k["name"] == "ssd_scan":      # the variants the main path ran
            k["variant"] = "+".join(v for v, n in ssd_variants.items() if n)
            k["variant_launches"] = ssd_variants
        del k["shape"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
