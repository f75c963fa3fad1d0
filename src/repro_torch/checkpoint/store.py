"""Checkpoints: a tree of tensors <-> npz with a JSON manifest (a port of
``repro.checkpoint.store``, on the same disk layout, so a checkpoint
written by either package restores in the other bit for bit).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json``, and
``<dir>/LATEST``.  The manifest holds each leaf's path (dict keys sorted,
list and tuple indices), its dtype name, the tree's structure (dict
insertion order kept) and the caller's metadata.  A leaf whose type numpy
cannot hold without ``ml_dtypes`` (bfloat16, the float8 types) is stored
as its raw bytes, shape ``shape + (itemsize,)`` uint8, its dtype name in
the manifest, as the reference stores it.

A step directory is written whole (arrays, then manifest) before
``LATEST`` points at it, and ``LATEST`` is replaced atomically (a temp
file, then ``os.replace``), so a reader sees the previous complete
checkpoint or the new one.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device

# torch dtypes numpy has no type for: stored as raw bytes under the name
# ml_dtypes gives them
_RAW = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
        torch.float8_e5m2: "float8_e5m2"}
_RAW_BY_NAME = {v: k for k, v in _RAW.items()}


def _flatten_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _tree_structure(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict", "items": {k: _tree_structure(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple", "items": [_tree_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list", "items": [_tree_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def _rebuild(struct, leaves_by_path, prefix=""):
    kind = struct["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, leaves_by_path, f"{prefix}/{k}" if prefix else str(k))
                for k, v in struct["items"].items()}
    if kind in ("tuple", "list"):
        seq = [_rebuild(v, leaves_by_path, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(struct["items"])]
        return tuple(seq) if kind == "tuple" else seq
    return leaves_by_path[prefix]


def _to_numpy(leaf):
    """(array to store, dtype name) of one leaf."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return (np.ascontiguousarray(arr) if arr.ndim else arr), arr.dtype.name
    t = leaf.detach().cpu().contiguous()
    if t.dtype in _RAW:
        raw = t.reshape(-1).view(torch.uint8).reshape(tuple(t.shape) + (t.element_size(),))
        return raw.numpy(), _RAW[t.dtype]
    return t.numpy(), t.numpy().dtype.name


def save_checkpoint(directory: str, state: Any, *, step: int,
                    metadata: dict | None = None) -> str:
    """Write ``state`` (tensors on any device, numpy arrays or scalars) as
    ``<directory>/step_<step>``, then point ``LATEST`` at it."""
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    arrays, dtypes, paths = {}, [], []
    for i, (p, leaf) in enumerate(_flatten_with_paths(state)):
        arrays[f"a{i}"], name = _to_numpy(leaf)
        dtypes.append(name)
        paths.append(p)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    manifest = {"step": step, "paths": paths, "dtypes": dtypes,
                "structure": _tree_structure(state), "metadata": metadata or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    _write_latest(directory, os.path.basename(path))
    return path


def _write_latest(directory: str, name: str) -> None:
    """Atomic ``LATEST`` update: a temp file, then ``os.replace``."""
    tmp = os.path.join(directory, f".LATEST.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, "LATEST"))


def read_latest_step(directory: str) -> int | None:
    """The step ``LATEST`` points at, or None when there is none yet."""
    try:
        with open(os.path.join(directory, "LATEST")) as f:
            name = f.read().strip()
    except FileNotFoundError:
        return None
    if not name.startswith("step_"):
        return None
    try:
        return int(name.split("_", 1)[1])
    except ValueError:
        return None


def _from_stored(arr, name, to_device, dev):
    raw = _RAW_BY_NAME.get(name) if name != arr.dtype.name else None
    if raw is not None:
        t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(-1).view(raw)
        t = t.reshape(arr.shape[:-1])
        return t.to(dev) if to_device else t
    if name != arr.dtype.name:
        raise TypeError(f"checkpoint leaf stored as {name!r}, which the port "
                        f"cannot read")
    if not to_device:
        return np.asarray(arr)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def restore_checkpoint(directory: str, *, step: int | None = None, device="cuda",
                       to_device: bool = True) -> tuple[Any, dict]:
    """Rebuild ``(state, manifest)`` of the checkpoint ``LATEST`` points at,
    or of ``step``.  Leaves land on ``device`` (the card by default, which
    raises without a GPU).  ``to_device=False`` keeps them numpy arrays on
    the host, as in the reference, except a bfloat16 or float8 leaf, which
    numpy cannot hold without ``ml_dtypes``: that one is a CPU tensor."""
    if step is None:
        with open(os.path.join(directory, "LATEST")) as f:
            name = f.read().strip()
        path = os.path.join(directory, name)
    else:
        path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dev = resolve_device(device) if to_device else None
    dtypes = manifest.get("dtypes", [])
    leaves_by_path = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, p in enumerate(manifest["paths"]):
            arr = data[f"a{i}"]
            name = dtypes[i] if i < len(dtypes) else arr.dtype.name
            leaves_by_path[p] = _from_stored(arr, name, to_device, dev)
    return _rebuild(manifest["structure"], leaves_by_path), manifest


def list_checkpoints(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name.split("_")[1]) for name in os.listdir(directory)
                  if name.startswith("step_"))
