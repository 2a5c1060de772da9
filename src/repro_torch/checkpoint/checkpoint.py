"""Tree checkpoints in ``repro.checkpoint``'s file format (its port).

Layout: one ``<step>.ckpt`` file per save, a MessagePack map
    {"meta": {...}, "step": int, "leaves": {path: leaf}}
with every key a ``bin``, each ``path`` the ``jax.tree_util.keystr`` of
the leaf (``utils.tree.tree_leaves_with_path``; leaves in that order) and
each leaf a map ``{"dtype": numpy dtype.str, "shape": [...], "data":
raw bytes}``.  A file either package writes, the other loads.

The port streams: each leaf is copied to the host and written on its own
(its bytes straight from the host tensor), and each is read into its
own buffer, so a 6 GB train state never becomes one ``bytes`` object.
A save goes to ``<step>.ckpt.tmp`` and is renamed into place.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import codec
from repro_torch.utils.tree import tree_leaves_with_path, tree_map_with_path


def _host_array(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        raise TypeError("bfloat16 leaves have no numpy dtype to store")
    return x.detach().cpu().contiguous().numpy()


def save_checkpoint(
    directory: str, step: int, tree: Any, meta: Optional[Dict] = None
) -> str:
    """Serialize ``tree`` to ``<directory>/<step>.ckpt``; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    leaves = tree_leaves_with_path(tree)
    path = os.path.join(directory, f"{step}.ckpt")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(codec.map_header(3))
        f.write(codec.packb(b"meta"))
        f.write(codec.packb({k.encode(): v
                             for k, v in (meta or {}).items()}))
        f.write(codec.packb(b"step") + codec.packb(int(step)))
        f.write(codec.packb(b"leaves") + codec.map_header(len(leaves)))
        for key, x in leaves:
            arr = _host_array(x)
            f.write(codec.packb(key.encode()) + codec.map_header(3))
            f.write(codec.packb(b"dtype")
                    + codec.packb(arr.dtype.str.encode()))
            f.write(codec.packb(b"shape") + codec.packb(list(arr.shape)))
            f.write(codec.packb(b"data") + codec.bin_header(arr.nbytes))
            f.write(arr.reshape(-1).view(np.uint8).data)
    os.replace(tmp, path)
    return path


def _text(k: Any) -> Any:
    return k.decode() if isinstance(k, (bytes, bytearray)) else k


def load_checkpoint(path: str, like: Any):
    """Restore into the structure of ``like`` (shapes verified; each
    leaf takes ``like``'s dtype and device).  Returns ``(tree, step,
    meta)``."""
    with open(path, "rb") as f:
        payload = {_text(k): v for k, v in codec.Reader(f).read().items()}
    stored = {_text(k): v for k, v in payload["leaves"].items()}

    def restore(key: str, x: Any) -> torch.Tensor:
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf {key}")
        leaf = {_text(k): v for k, v in stored[key].items()}
        data = leaf["data"]
        arr = np.frombuffer(
            data if isinstance(data, bytearray) else bytearray(data),
            dtype=np.dtype(_text(leaf["dtype"]))).reshape(leaf["shape"])
        want = tuple(x.shape)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"shape mismatch at {key}: {arr.shape} vs {want}")
        return torch.from_numpy(arr).to(device=x.device, dtype=x.dtype)

    tree = tree_map_with_path(restore, like)
    meta = {_text(k): v for k, v in payload["meta"].items()}
    return tree, int(payload["step"]), meta


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[:-5]) for f in os.listdir(directory) if f.endswith(".ckpt")
    ]
    if not steps:
        return None
    return os.path.join(directory, f"{max(steps)}.ckpt")


__all__ = ["latest_checkpoint", "load_checkpoint", "save_checkpoint"]
