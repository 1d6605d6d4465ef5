"""Checkpoints with atomic commits, keep-last-k and async writes, the
counterpart of ``repro.training.checkpoint`` in the reference's layout:

  <root>/step_<N>.tmp/...          (in-flight write)
  <root>/step_<N>/manifest.json    (commit marker: written LAST)
  <root>/step_<N>/leaf_<i>.npy     (one file per tree leaf)

A checkpoint is valid iff its manifest exists, so a crash mid-write never
yields a half-readable "latest" checkpoint.  The manifest keeps each
leaf's path, shape and dtype; a bf16 leaf is written as its uint16 bits
(NumPy has no bfloat16), with ``"bfloat16"`` in the manifest.  Leaves of
other dtypes are written as they are, so a checkpoint of fp32 leaves that
the reference wrote restores here, and the other way round.

``restore`` places each leaf on the device (and in the dtype) of the
matching leaf of the target tree.  Restoring onto another mesh (the
reference's resharding restore) waits for the port's sharded placements
(ROADMAP.md M10b): the rule tables that will place the leaves are in
``repro_torch.distributed.sharding``, the placements are not.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_path,
                                    tree_unflatten)


def _to_host(leaf):
    """A host NumPy copy of a leaf (a copy even for a CPU tensor: the
    train step updates its tensors in place while a write is in flight)
    and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _from_host(arr, dtype_name: str):
    if dtype_name == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


class CheckpointManager:
    def __init__(self, root: str, keep_last: int = 3, async_write: bool = True):
        self.root = root
        self.keep_last = keep_last
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict = None):
        """Snapshot to host memory synchronously; write to disk (optionally
        in the background)."""
        named = tree_leaves_with_path(state)
        host = [_to_host(leaf) for _, leaf in named]
        manifest = {
            "step": int(step),
            "leaves": [
                {"name": name, "file": f"leaf_{i}.npy",
                 "shape": list(arr.shape), "dtype": dtype}
                for i, ((name, _), (arr, dtype)) in enumerate(zip(named, host))
            ],
            "extra": extra or {},
        }
        host_leaves = [arr for arr, _ in host]
        self.wait()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, manifest),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_leaves, manifest)

    def _write(self, step: int, host_leaves, manifest):
        final = os.path.join(self.root, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, leaf in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), leaf)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic commit
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.list_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def list_steps(self):
        out = []
        for d in sorted(os.listdir(self.root)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None):
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf on the device and in the dtype of ``like``'s leaf.  Returns
        (tree, step, extra)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoints in " + self.root)
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = tree_leaves(like)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(f"tree structure changed: {len(leaves)} leaves, "
                             f"the checkpoint has {len(manifest['leaves'])}")
        out = []
        for meta, ref in zip(manifest["leaves"], leaves):
            arr = np.load(os.path.join(d, meta["file"]))
            if list(arr.shape) != list(ref.shape):
                raise ValueError(f"{meta['name']}: shape {arr.shape} in the "
                                 f"checkpoint, {tuple(ref.shape)} expected")
            out.append(_from_host(arr, meta["dtype"]).to(
                device=ref.device, dtype=ref.dtype))
        return tree_unflatten(like, out), step, manifest.get("extra", {})
