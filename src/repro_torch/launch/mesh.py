"""Meshes (a port of ``repro.launch.mesh``): ``DeviceMesh`` es over the
ranks of the default process group, one device a rank.

``make_production_mesh`` is a function (importing this module starts no
process group): (16, 16) "data" x "model" on 256 ranks, or (2, 16, 16)
"pod" x "data" x "model" on 512.  FedGAN maps agents onto ("pod", "data").

Without a process group, a mesh starts one: from the environment
(``torchrun``'s ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``) when it names a
world, else a one-rank group on a ``HashStore``, so one card needs no
launcher.  The backend is NCCL on the card and gloo on the CPU.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.dist.sharding import mesh_dims  # noqa: F401  (canonical copy)


def _ensure_process_group(device: torch.device) -> None:
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(shape, axes, *, device="cuda", ranks=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group's
    ranks (the group is started if absent), or over ``ranks`` (a sequence
    of ``prod(shape)`` of them).  A mesh on ``"cuda"`` needs a card:
    without one this raises."""
    dev = resolve_device(device)
    _ensure_process_group(dev)
    world = dist.get_world_size()
    ranks = list(range(world)) if ranks is None else list(ranks)
    if math.prod(shape) != len(ranks) or not set(ranks) <= set(range(world)):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks of the "
                         f"process group's {world}; got {len(ranks)}: {ranks[:8]}")
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``: 256 or 512 ranks, one card each."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_serving_mesh(*, model_parallel: int = 1, devices=None, device="cuda"):
    """Serving mesh shaped from the ranks present: ("data", "model") with
    ``model_parallel`` ranks of tensor parallelism per replica and the rest
    as batch parallelism.  ``devices``: the ranks to span (default: every
    rank of the group, one without a launcher).  One card degenerates to a (1, 1)
    mesh on which every spec filters to replicated."""
    dev = resolve_device(device)
    _ensure_process_group(dev)
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    n = len(ranks)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} must divide the "
                         f"{n} available devices")
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"), device=dev,
                     ranks=ranks)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *, device="cpu"):
    """Small mesh for the CPU-rank tests (gloo; each rank's process group
    must be up, with ``prod(shape)`` ranks)."""
    return make_mesh(shape, axes, device=device)
