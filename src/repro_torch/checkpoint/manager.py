"""Fault-tolerant checkpointing, the counterpart of
``repro.checkpoint.manager``, in the reference's format:

- atomic: written to ``step_N.tmp/`` then renamed, so a crash mid-write
  never corrupts the newest checkpoint;
- async: the device-to-host gather runs on the caller (the only
  synchronous part of ``save``), serialisation on a background thread;
  a failed write is re-raised at the next ``wait()`` or ``save()``;
- integrity: a sha1 per leaf in the manifest and a sha1 of the manifest
  in ``CHECKSUM``, both checked on restore;
- retention: the newest ``keep`` checkpoints stay.

A tree is flattened in JAX's order with JAX's path strings
(``optim.adamw.tree_leaves``), so the manifest's paths, dtypes and sha1s
are the reference's strings for the same tree.  A bfloat16 leaf is
stored as its raw uint16 bits, as the reference stores it.  So a
checkpoint written by either package restores in the other by
``like=``.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves, tree_unflatten

log = logging.getLogger(__name__)

_CHECKSUM_FILE = "CHECKSUM"


def _gather(leaves) -> List[Tuple[np.ndarray, str]]:
    """Leaves -> (host array as stored, logical dtype name).  Device
    tensors copy into pinned memory behind one synchronise per device."""
    host, devices = [], set()
    for x in leaves:
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                devices.add(x.device)
                x = x.to("cpu", non_blocking=True)
        host.append(x)
    for d in devices:
        torch.cuda.synchronize(d)
    out = []
    for x in host:
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                # np.save cannot hold bfloat16: store the raw bits
                out.append((x.view(torch.int16).numpy().view(np.uint16),
                            "bfloat16"))
                continue
            x = x.numpy()
        arr = np.asarray(x)
        out.append((arr, str(arr.dtype)))
    return out


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = False):
        """Snapshot ``tree`` at ``step``: gathers to the host now,
        serialises in the background.  A failure of an earlier async
        write is re-raised here (via ``wait()``): a lost checkpoint is
        never silent."""
        flat = tree_leaves(tree)
        host = _gather([x for _, x in flat])    # device -> host (sync)
        paths = [p for p, _ in flat]
        self.wait()
        if self.async_write and not blocking:
            self._thread = threading.Thread(
                target=self._guarded_write, args=(step, host, paths),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, paths)

    def _guarded_write(self, step: int, host, paths):
        """Background-thread entry: capture failures, re-raised later."""
        try:
            self._write(step, host, paths)
        except BaseException as e:          # noqa: BLE001 — re-raised later
            self._error = e

    def _write(self, step: int, host, paths: List[str]):
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
        final = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        for i, ((arr, dtype), path) in enumerate(zip(host, paths)):
            fn = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append({
                "path": path, "file": fn, "shape": list(arr.shape),
                "dtype": dtype,
                "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
            })
        manifest_bytes = json.dumps(manifest).encode()
        with open(os.path.join(tmp, "manifest.json"), "wb") as f:
            f.write(manifest_bytes)
        # the manifest carries every leaf's sha1, so its own sha1 covers
        # the whole checkpoint: a torn manifest, a truncated leaf and
        # bit rot all surface as corruption
        with open(os.path.join(tmp, _CHECKSUM_FILE), "w") as f:
            f.write(hashlib.sha1(manifest_bytes).hexdigest())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self):
        """Join an in-flight async write; re-raise its failure (once)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "async checkpoint write failed (checkpoint lost)") from err

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _read_step(self, step: int):
        """Load and check ONE checkpoint directory -> (manifest, numpy
        leaves as stored).  Every corruption (torn manifest, CHECKSUM
        mismatch, truncated or unreadable leaf, leaf sha1 mismatch)
        raises ``IOError("checkpoint corruption ...")``."""
        d = os.path.join(self.dir, f"step_{step:09d}")
        try:
            with open(os.path.join(d, "manifest.json"), "rb") as f:
                manifest_bytes = f.read()
            manifest = json.loads(manifest_bytes)
        except (OSError, ValueError) as e:
            raise IOError(f"checkpoint corruption at step {step}: "
                          f"unreadable manifest ({e})") from e
        cs_path = os.path.join(d, _CHECKSUM_FILE)
        if os.path.exists(cs_path):     # absent on pre-checksum saves
            with open(cs_path) as f:
                want = f.read().strip()
            if hashlib.sha1(manifest_bytes).hexdigest() != want:
                raise IOError(f"checkpoint corruption at step {step}: "
                              f"manifest checksum mismatch")
        leaves = []
        for rec in manifest["leaves"]:
            try:
                arr = np.load(os.path.join(d, rec["file"]))
            except (OSError, ValueError, EOFError) as e:
                raise IOError(f"checkpoint corruption at {rec['path']}: "
                              f"unreadable leaf file ({e})") from e
            if list(arr.shape) != list(rec["shape"]):
                raise IOError(f"checkpoint corruption at {rec['path']}: "
                              f"shape mismatch")
            if hashlib.sha1(arr.tobytes()).hexdigest() != rec["sha1"]:
                raise IOError(f"checkpoint corruption at {rec['path']}")
            leaves.append(arr)
        return manifest, leaves

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """Load a checkpoint.  ``like`` gives the tree's structure; each
        leaf comes back as a tensor of the stored dtype on the device of
        ``like``'s leaf (the CPU where that leaf is no tensor).  Without
        ``like``: (manifest, numpy leaves as stored).

        With ``step=None`` a corrupt newest checkpoint FALLS BACK to the
        newest intact one (with a warning); the corruption IOError is
        raised only when none is intact, or when ``step`` was given (the
        caller asked for THAT state)."""
        if step is not None:
            manifest, leaves = self._read_step(step)
        else:
            steps = self.all_steps()
            if not steps:
                raise FileNotFoundError("no checkpoint found")
            manifest = leaves = None
            last_err: Optional[IOError] = None
            for s in reversed(steps):
                try:
                    manifest, leaves = self._read_step(s)
                except IOError as e:
                    log.warning("checkpoint step %d failed integrity "
                                "check (%s); falling back to the "
                                "previous one", s, e)
                    last_err = e
                    continue
                if s != steps[-1]:
                    log.warning(
                        "restored step %d instead of the newest step "
                        "%d: %d corrupt checkpoint(s) skipped",
                        s, steps[-1], len([x for x in steps if x > s]))
                break
            if leaves is None:
                raise IOError(
                    f"no intact checkpoint in {self.dir}: newest "
                    f"failure: {last_err}") from last_err
        if like is None:
            return manifest, leaves
        like_leaves = [x for _, x in tree_leaves(like)]
        if len(like_leaves) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                             f"like= has {len(like_leaves)}")
        out = []
        for arr, rec, ref in zip(leaves, manifest["leaves"], like_leaves):
            t = _as_tensor(arr, rec["dtype"])
            if isinstance(ref, torch.Tensor):
                t = t.to(ref.device)
            out.append(t)
        return tree_unflatten(like, out)
