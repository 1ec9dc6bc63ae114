"""Fault-tolerant checkpointing, after ``repro.checkpoint.ckpt``: atomic,
async, verified, resumable.

Layout (one directory per step):

    <root>/step_000042.tmp/      # written here first
        <name>.npz               # one per top-level tree (flat leaf index)
        MANIFEST.json            # leaf keys, shapes/dtypes, crc, digest
    <root>/step_000042/          # atomic rename on completion
    <root>/LATEST                # text file, updated last (commit point)

A checkpoint exists iff its directory was renamed and LATEST points at it:
a torn write leaves only a ``.tmp`` that restore ignores and cleanup
deletes. ``save`` copies the leaves to host memory synchronously and, unless
``blocking``, writes the files on a worker thread.

Trees are flattened in JAX's order with the reference's keys
(``repro_torch.pytree``), and the manifest has the reference's fields, so
either package's checkpoint restores into the port. numpy has no bfloat16
without ``ml_dtypes`` (which ships with JAX only): the port writes a bf16
leaf as its uint16 bit patterns with ``"dtype": "bfloat16"`` in the
manifest, and restores any leaf the manifest calls bfloat16 as
``torch.bfloat16`` bit for bit, including the JAX package's, which numpy
reads back as ``|V2`` void bytes. (The reference's own restore returns
those bytes, which its ``jnp.asarray`` then refuses.)
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree

PyTree = Any


class CheckpointCorrupt(IOError):
    """A committed checkpoint failed integrity verification on restore:
    a shard's CRC disagrees with the manifest, or the manifest's own
    content digest doesn't match its recorded fields (torn or bit-flipped
    manifest). Callers should fall back to an older step."""


def _manifest_digest(step: int, meta: Dict[str, Any], crc: Dict[str, int]) -> str:
    """sha256 over the manifest's semantic fields as canonical JSON (sorted
    keys): a manifest edited after commit no longer matches its digest."""
    blob = json.dumps({"step": step, "meta": meta, "crc": crc}, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def _host_copy(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of a leaf (a tensor or an array), taken now, and its
    manifest dtype name."""
    if not isinstance(leaf, torch.Tensor):
        a = np.array(leaf, copy=True)
        return a, str(a.dtype)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A stored leaf as a tensor on ``device``; bf16 by its bit patterns
    (uint16 from the port, ``|V2`` from the JAX package)."""
    if not a.flags.c_contiguous:
        a = np.array(a, order="C")
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, PyTree], blocking: bool = True) -> None:
        """Snapshot to host memory now; write asynchronously unless blocking."""
        self.wait()  # one outstanding write at a time
        snap = {}
        meta = {}
        for name, tree in state.items():
            items = [(k, *_host_copy(v)) for k, v in pytree.leaves_with_path(tree)]
            snap[name] = [(k, a) for k, a, _ in items]
            meta[name] = [{"key": k, "shape": list(a.shape), "dtype": d} for k, a, d in items]

        def write():
            try:
                tmp = os.path.join(self.root, f"step_{step:08d}.tmp")
                final = os.path.join(self.root, f"step_{step:08d}")
                os.makedirs(tmp, exist_ok=True)
                crc = {}
                for name, items in snap.items():
                    arrs = {f"leaf_{i}": v for i, (k, v) in enumerate(items)}
                    path = os.path.join(tmp, f"{name}.npz")
                    np.savez(path, **arrs)
                    with open(path, "rb") as f:
                        crc[name] = zlib.crc32(f.read())
                with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                    json.dump({"step": step, "meta": meta, "crc": crc,
                               "digest": _manifest_digest(step, meta, crc)}, f)
                if os.path.exists(final):
                    shutil.rmtree(tmp)
                else:
                    os.replace(tmp, final)
                with open(os.path.join(self.root, "LATEST.tmp"), "w") as f:
                    f.write(os.path.basename(final))
                os.replace(os.path.join(self.root, "LATEST.tmp"),
                           os.path.join(self.root, "LATEST"))
                self._gc()
            except Exception as e:  # surfaced on next wait()/save()
                self.last_error = e

        if blocking:
            write()
            if self.last_error:
                err, self.last_error = self.last_error, None
                raise err
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.root)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)
        for d in os.listdir(self.root):
            if d.endswith(".tmp") and d != "LATEST.tmp":
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.root, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.root, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, example_state: Dict[str, PyTree], step: Optional[int] = None
                ) -> Tuple[int, Dict[str, PyTree]]:
        """Returns (step, state) with ``example_state``'s trees, each leaf a
        tensor on its example leaf's device (the CPU for non-tensors)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no committed checkpoint found")
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        want_digest = manifest.get("digest")
        if want_digest is not None:  # manifests predating digests stay loadable
            got = _manifest_digest(manifest["step"], manifest["meta"], manifest["crc"])
            if got != want_digest:
                raise CheckpointCorrupt(f"manifest digest mismatch in {d}")
        out = {}
        for name, tree in example_state.items():
            path = os.path.join(d, f"{name}.npz")
            with open(path, "rb") as f:
                if zlib.crc32(f.read()) != manifest["crc"][name]:
                    raise CheckpointCorrupt(f"checkpoint corruption in {path}")
            items = pytree.leaves_with_path(tree)
            meta = manifest["meta"][name]
            keys, want = [k for k, _ in items], [m["key"] for m in meta]
            if keys != want:
                raise ValueError(f"tree mismatch for {name}: {keys[:3]}... vs {want[:3]}...")
            with np.load(path) as data:
                leaves = [_tensor(data[f"leaf_{i}"], m["dtype"],
                                  ex.device if isinstance(ex, torch.Tensor) else "cpu")
                          for i, ((_, ex), m) in enumerate(zip(items, meta))]
            out[name] = pytree.unflatten(tree, leaves)
        return manifest["step"], out
