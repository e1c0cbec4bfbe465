"""Checkpointing with async writes (the port of
``repro.checkpoint.manager``), in the reference's on-disk layout.

Layout: ``<dir>/step_<N>/shard_0.npz`` + ``manifest.json``.  The manifest
maps each flat key to its file, global shape and dtype; the keys are the
reference's (:mod:`repro_torch.tree`), so a checkpoint written by either
package restores in the other.  A bfloat16 leaf is stored as float32
(lossless) under its manifest dtype ``"bfloat16"``, as the reference's
``_storable`` stores it.  A write goes to a temporary directory that is
renamed into place (atomic publish), then the oldest steps beyond ``keep``
are removed.  With ``async_write`` the device-to-host copy happens in
:meth:`save` and a worker thread writes; :meth:`wait` drains it and
re-raises the worker's error.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
import uuid
from typing import Any, Optional

import numpy as np
import torch

from ..tree import flatten_with_keys, unflatten_like


def _host(t):
    """(NumPy array np.savez can hold, the manifest's dtype name) of a
    tensor or an array."""
    t = torch.as_tensor(t)
    dtype = str(t.dtype).removeprefix("torch.")
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.to(torch.float32)
    return t.numpy(), dtype


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        flat = {k: _host(v) for k, v in flatten_with_keys(tree)}
        if self.async_write and not blocking:
            self._ensure_worker()
            self._q.put((step, flat))
        else:
            self._write(step, flat)

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._loop, daemon=True)
            self._worker.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._write(*item)
            except BaseException as e:  # surfaced on next wait()
                self._err = e

    def _write(self, step: int, flat: dict):
        tmp = os.path.join(self.dir, f".tmp_{step}_{uuid.uuid4().hex[:8]}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}, "time": time.time()}
        np.savez(os.path.join(tmp, "shard_0.npz"),
                 **{k.replace("/", "__"): a for k, (a, _) in flat.items()})
        for k, (a, dtype) in flat.items():
            manifest["leaves"][k] = {
                "file": "shard_0.npz",
                "shape": list(a.shape),
                "dtype": dtype,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        try:
            os.rename(tmp, final)  # atomic publish
        except OSError:
            # concurrent writer published the same step; keep theirs
            shutil.rmtree(tmp, ignore_errors=True)
        self._gc()

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def wait(self):
        """Drain pending async writes (call before exit / restart)."""
        if self._worker and self._worker.is_alive():
            self._q.put(None)
            self._worker.join()
            self._worker = None
        if self._err:
            err, self._err = self._err, None
            raise err

    # -- read ----------------------------------------------------------------
    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """``template``'s tree with every leaf read from the checkpoint, on
        the template leaf's device and in its dtype (a NumPy leaf is
        restored as a NumPy array, as the reference restores every leaf)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        files: dict = {}
        try:
            new = []
            for key, leaf in flatten_with_keys(template):
                fn = manifest["leaves"][key]["file"]
                if fn not in files:
                    files[fn] = np.load(os.path.join(d, fn))
                arr = np.asarray(files[fn][key.replace("/", "__")]).reshape(leaf.shape)
                new.append(torch.from_numpy(arr).to(leaf.device, leaf.dtype)
                           if isinstance(leaf, torch.Tensor) else arr.astype(leaf.dtype))
        finally:
            for npz in files.values():
                npz.close()
        return unflatten_like(template, new)
