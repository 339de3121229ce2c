"""Atomic, async checkpointing of trees of tensors: the twin of
``repro/checkpoint/checkpoint.py`` (no JAX, no orbax).

Layout, as the JAX package writes it:
    <dir>/step_<N>/manifest.json          leaf paths + dtypes + shapes + step
    <dir>/step_<N>/host<k>.npz            the leaves
    <dir>/step_<N>/.complete              commit marker

Writes go to ``step_<N>.tmp`` and are renamed only after every file is
written, so a crashed save is never listed (``all_steps`` lists committed
steps only).  A save copies the tensors to host memory first, then writes
on the caller's thread or, with ``blocking=False``, on a writer thread
(one save in flight; its error is raised by the next ``wait``/``save``);
``keep`` bounds the committed steps kept.  npz holds no bfloat16, so bf16
leaves are stored as their 16-bit patterns and the manifest records the
dtype.  The tree is flattened by ``repro_torch.tree`` (JAX's leaf order
and path names) in place of ``jax.tree_util``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as TR


def _to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """The host copy of a leaf as numpy, and its logical dtype's name.  A
    copy also of a CPU leaf (``.cpu()`` would return the same storage): an
    async save writes it after ``save`` returns, while the caller updates
    the tensors in place."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_storable(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0):
        self.dir = directory
        self.keep = keep
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, *, blocking: bool = True) -> None:
        self.wait()  # one async save in flight at a time
        # copy to host memory NOW, so the caller may update the tensors
        host_items = [(path, *_to_storable(leaf))
                      for path, leaf in TR.flatten_with_paths(tree)]
        if blocking:
            self._write(step, host_items)
        else:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host_items),
                daemon=True)
            self._thread.start()

    def _write_guarded(self, step, host_items):
        try:
            self._write(step, host_items)
        except BaseException as e:  # raised on the next wait()/save()
            self._error = e

    def _write(self, step: int, host_items) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        arrays = {f"a{i}": arr for i, (_, arr, _) in enumerate(host_items)}
        np.savez(os.path.join(tmp, f"host{self.host_id}.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": [path for path, _, _ in host_items],
            "dtypes": [dt for _, _, dt in host_items],
            "shapes": [list(arr.shape) for _, arr, _ in host_items],
            "num_hosts": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, ".complete"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                path = os.path.join(self.dir, name, ".complete")
                if os.path.exists(path):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like_tree) -> Any:
        """Restore into the structure of ``like_tree``: each leaf a new
        tensor on its like-leaf's device, in the dtype it was saved in.
        Raises ValueError if the paths or a shape differ."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        items = TR.flatten_with_paths(like_tree)
        if [path for path, _ in items] != manifest["keys"]:
            raise ValueError(f"checkpoint {d}: tree structure mismatch")
        leaves = []
        with np.load(os.path.join(d, f"host{self.host_id}.npz")) as data:
            for i, (path, like) in enumerate(items):
                arr = data[f"a{i}"]
                if list(arr.shape) != list(like.shape):
                    raise ValueError(f"checkpoint {d}: shape mismatch at "
                                     f"{path}: {list(arr.shape)} saved, "
                                     f"{list(like.shape)} expected")
                leaves.append(_from_storable(arr, manifest["dtypes"][i],
                                             like.device))
        return TR.unflatten_like(like_tree, leaves)
