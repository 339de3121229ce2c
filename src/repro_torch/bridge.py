"""Carry the JAX package's parameters across to the port.

``params_from_numpy(tree, device=)`` turns ``unbox(model.init(key))`` of
the JAX package, with its leaves given as numpy arrays (or anything
``np.asarray`` takes), into the port's parameter tree:

* ``Param`` boxes (an object with ``value`` and ``axes``) are unwrapped,
  so boxed and unboxed trees both work;
* dicts and the per-pattern stacked layer lists (leading repeats axis)
  keep their structure, which is the port's layout too;
* bfloat16 arrays travel as their raw 16-bit patterns (a uint16 view,
  reinterpreted as ``torch.bfloat16``), so no value is rounded twice.

``opt_state_from_numpy(state, device=)`` does the same for the JAX
package's AdamW state (``adamw_init``/``adamw_update``: moments ``m`` and
``v`` shaped like the parameters, and the int32 ``step``), so one AdamW
step can start from the same parameters, gradients and moments on both
sides.

The bridge itself imports no JAX; only the tests hand it JAX arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a, *, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, *, device="cpu"):
    if hasattr(tree, "value") and hasattr(tree, "axes"):     # a Param box
        return params_from_numpy(tree.value, device=device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device=device) for v in tree]
    return tensor_from_numpy(tree, device=device)


def opt_state_from_numpy(state, *, device="cpu"):
    """The JAX AdamW state ``{"m", "v", "step"}`` as the port's."""
    if set(state) != {"m", "v", "step"}:
        raise ValueError(f"an AdamW state has keys m, v and step, got "
                         f"{sorted(state)}")
    return {"m": params_from_numpy(state["m"], device=device),
            "v": params_from_numpy(state["v"], device=device),
            "step": tensor_from_numpy(np.asarray(state["step"], np.int32),
                                      device=device)}
