"""Whether what the timed path served is correct.

After the window, a sample drawn from the seed of the requests the
engine finished (the one with the most served tokens always in it) is run
through the plain fp32 reference, teacher-forced over each prompt and its
served tokens.  At each position that produced a served token, the gap is
the reference's best logit minus the served token's logit (0 where the
served token is the reference's best).  The run is correct when every
sampled request served its full output, enough tokens were compared, and
the mean gap (and, where the cell gives it a limit, the widest) is within
the cell's limit.

Greedy decoding only: the engine serves the argmax.  The same reading of
a control (the reference in a lower precision, ``precision="fp8"``) takes
the control's own best token at each position.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def sample(finished: List, seed: int, min_tokens: int, min_requests: int,
           max_requests: int) -> List:
    """The request with the most served tokens, then others in an order
    drawn from the seed, until both ``min_tokens`` tokens and
    ``min_requests`` requests are in, or ``max_requests`` requests."""
    if not finished:
        return []
    reqs = sorted(finished, key=lambda r: (len(r.output_tokens),
                                           r.prompt_len), reverse=True)
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 3])
    rest = [reqs[i + 1] for i in rng.permutation(len(reqs) - 1)]
    out, n = [], 0
    for r in [reqs[0]] + rest:
        if (n >= min_tokens and len(out) >= min_requests) or \
                len(out) >= max_requests:
            break
        out.append(r)
        n += len(r.output_tokens)
    return out


def sequences(reqs: List, device) -> List:
    """(tokens, wanted positions, first decode row) of each request: the
    prompt and every served token but the last, and the positions whose
    logits gave the served tokens."""
    out = []
    for r in reqs:
        toks = list(r.prompt_tokens) + list(r.output_tokens[:-1])
        want = torch.arange(r.prompt_len - 1, len(toks), device=device)
        out.append((torch.tensor(toks, dtype=torch.long, device=device),
                    want, r.prompt_len))
    return out


def gaps(ref_logits: List, picked: List) -> torch.Tensor:
    """Every position's gap, all requests together: the reference's best
    logit minus the logit of the token picked there."""
    out = []
    for lg, tok in zip(ref_logits, picked):
        tok = torch.as_tensor(tok, device=lg.device)
        best = lg.max(dim=-1).values
        out.append(best - lg.gather(1, tok[:, None])[:, 0])
    return torch.cat(out).float().cpu()


def stats(g: torch.Tensor) -> Dict[str, float]:
    """The widest gap and the mean gap."""
    return {"gap": float(g.max()), "gap_mean": float(g.mean())}


def compare(ref, weights: Dict, model: Dict, reqs: List, device,
            control: bool = False) -> Dict:
    """The served tokens' widest gap (and, with ``control``, the
    control's) over ``reqs``."""
    seqs = sequences(reqs, device)
    with torch.no_grad():
        want = ref.logits(weights, model, seqs)
        served = [r.output_tokens for r in reqs]
        out = dict(stats(gaps(want, served)),
                   tokens=sum(len(s) for s in served))
        if control:
            low = ref.logits(weights, model, seqs, precision="fp8")
            picked = [lg.argmax(dim=-1) for lg in low]
            out.update({f"control_{k}": v
                        for k, v in stats(gaps(want, picked)).items()})
    return out


def verdict(cmp: Dict, reqs: List, limits: Dict) -> Dict:
    """The numbers compared, each with its limit, and whether all hold:
    the mean gap; the widest gap, where the cell gives it a limit (where
    its readings separate the program from the control); the tokens
    compared; and that every sampled request served its full output."""
    full = sum(len(r.output_tokens) == r.max_new_tokens for r in reqs)
    nan = float("nan")
    checks = {"gap_mean": {"value": cmp.get("gap_mean", nan),
                           "limit": limits["gap_mean_limit"], "holds": "max"}}
    if limits.get("gap_limit") is not None:
        checks["gap"] = {"value": cmp.get("gap", nan),
                         "limit": limits["gap_limit"], "holds": "max"}
    checks["tokens_compared"] = {"value": cmp.get("tokens", 0),
                                 "limit": limits["min_tokens"],
                                 "holds": "min"}
    checks["full_outputs"] = {"value": full, "limit": len(reqs),
                              "holds": "min"}
    ok = bool(reqs)
    for c in checks.values():
        v, lim = c["value"], c["limit"]
        ok = ok and v == v and bool(v <= lim if c["holds"] == "max"
                                    else v >= lim)
    return {"correct": ok, "checks": checks}
