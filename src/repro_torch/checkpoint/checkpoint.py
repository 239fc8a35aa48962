"""Sharded checkpoint save/restore with async writes and elastic resharding,
in the JAX package's format.

Format: one ``.npz`` per host shard + a JSON manifest (leaf paths, shapes,
dtypes, step, an md5 checksum a shard), under ``ckpt_dir/step_<step>/``.
A leaf's path is the string the JAX package gives it
(``distributed.sharding.path_str`` over ``repro_torch.tree``), so a
checkpoint written by either package loads in the port.

  * **async save**: the tensors are copied to the host synchronously,
    then the files are written on a background thread.
  * **atomic publish**: the step is written into ``step_<step>.tmp`` and
    renamed when complete.
  * **elastic reshard**: shard s of K holds slice s of a leaf's axis 0
    where K divides it (else shard 0 holds the whole leaf); ``load``
    reassembles whatever K was.
  * **integrity**: a step whose shard is missing or whose checksum fails
    is skipped, and the latest good step is used.

A ``bfloat16`` leaf is stored as its 16-bit words (a uint16 array) with
"bfloat16" in the manifest: numpy has no bfloat16. ``load`` also reads a
JAX-written one, which numpy saw as an opaque 2-byte (``V2``) array. (The
JAX package's own ``load`` cannot restore such a leaf: it has no cast from
``V2``.)
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import path_str
from repro_torch.tree import flatten_with_path, unflatten

def _flatten(tree):
    return [(path_str(path), leaf) for path, leaf in flatten_with_path(tree)]


def _leaf_key(i: int) -> str:
    return f"leaf_{i:05d}"


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def save(ckpt_dir: str, step: int, tree, *, shards: int = 1,
         async_write: bool = False) -> Optional[threading.Thread]:
    """Write ``tree`` under ckpt_dir/step_<step>/ in ``shards`` host files.
    With ``async_write`` the files are written on a thread, which is
    returned (join it before relying on the step)."""
    host = [(k, _to_host(v), str(v.dtype).removeprefix("torch."))
            for k, v in _flatten(tree)]
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d + ".tmp", exist_ok=True)

    def _write():
        manifest = {"step": step, "shards": shards,
                    "leaves": [{"path": k, "shape": list(v.shape),
                                "dtype": dt} for k, v, dt in host],
                    "checksums": {}}
        def shard(s):
            payload = {}
            for i, (_, v, _) in enumerate(host):
                if v.ndim >= 1 and v.shape[0] % shards == 0 and shards > 1:
                    n = v.shape[0] // shards
                    payload[_leaf_key(i)] = v[s * n:(s + 1) * n]
                elif s == 0:
                    payload[_leaf_key(i)] = v
            fn = os.path.join(d + ".tmp", f"shard_{s:04d}.npz")
            np.savez(fn, **payload)
            return _md5(fn)

        # the shards are written and hashed side by side, as their hosts
        # would (zlib's CRC and md5 release the interpreter lock)
        with ThreadPoolExecutor(shards) as pool:
            sums = list(pool.map(shard, range(shards)))
        manifest["checksums"] = {f"shard_{s:04d}.npz": h
                                 for s, h in enumerate(sums)}
        with open(os.path.join(d + ".tmp", "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(d + ".tmp", d)                    # atomic publish

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n[5:]) for n in os.listdir(ckpt_dir)
             if n.startswith("step_") and not n.endswith(".tmp")
             and verify(os.path.join(ckpt_dir, n))]
    return max(steps) if steps else None


def verify(step_dir: str) -> bool:
    mf = os.path.join(step_dir, "manifest.json")
    if not os.path.exists(mf):
        return False
    with open(mf) as f:
        manifest = json.load(f)
    paths = [os.path.join(step_dir, fn) for fn in manifest["checksums"]]
    if not all(os.path.exists(p) for p in paths):
        return False
    with ThreadPoolExecutor(len(paths)) as pool:
        got = list(pool.map(_md5, paths))
    return got == list(manifest["checksums"].values())


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A stored leaf as a tensor on ``device``, always in memory of torch's
    own allocator (numpy's buffers may be less aligned, and on the CPU a
    matmul can then round differently, which would break a bitwise
    resume)."""
    if dtype == "bfloat16":          # 16-bit words: ours uint16, JAX's V2
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr.astype(dtype, copy=False),
                                        order="C"))
    return t.to(device, copy=True)


def load(ckpt_dir: str, tree_like, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (elastic across shard
    counts), each leaf on the device of its ``tree_like`` leaf. Returns
    (tree, step), or (None, None) without a good step."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    payloads = [np.load(os.path.join(d, f"shard_{s:04d}.npz"))
                for s in range(manifest["shards"])]
    try:
        out = []
        for i, (k, like) in enumerate(_flatten(tree_like)):
            key = _leaf_key(i)
            parts = [p[key] for p in payloads if key in p.files]
            arr = parts[0] if len(parts) == 1 \
                else np.concatenate(parts, axis=0)
            spec = manifest["leaves"][i]
            if spec["path"] != k:
                raise ValueError(f"tree mismatch at {k} vs {spec['path']}")
            if list(arr.shape) != spec["shape"]:
                raise ValueError(f"{k}: shape {arr.shape} vs "
                                 f"{spec['shape']}")
            out.append(_to_tensor(arr, spec["dtype"], like.device))
    finally:
        for p in payloads:
            p.close()
    return unflatten(tree_like, out), step
