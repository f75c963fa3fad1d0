"""The device-resident round data pipeline (a port of
``repro.data.federated.DeviceFederatedData`` and ``round_key_schedule``).

Every agent's shard lives on the device, stacked under the (P, A) agent
grid; each local step gathers its (P, A, batch, ...) minibatch there from
a ``torch.Generator`` on the device.  No per-round host assembly, no
host-to-device copy on the round path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_leaves, tree_map


def round_key_schedule(seed: int, n_rounds: int, device="cuda") -> list:
    """One seeded ``torch.Generator`` on ``device`` per round.  The seeds
    come from numpy's ``SeedSequence(seed)``, a different algorithm from
    the generators they seed, so an init drawn from ``torch.Generator``
    seeded with the same ``seed`` shares no bits with any round."""
    dev = resolve_device(device)
    seeds = np.random.SeedSequence(seed).generate_state(n_rounds, dtype=np.uint64)
    return [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds]


@dataclasses.dataclass
class DeviceFederatedData:
    """Agent shards stacked on the device under the (P, A) grid.

    ``data`` leaves are (P, A, N, ...) with every agent's shard padded (by
    wrapping) to the fleet max N; ``sizes`` (P, A) holds the true per-agent
    sample counts so sampling never sees padding.  ``sample_step(gen)``
    draws one (P, A, batch, ...) minibatch uniformly per agent and merges
    ``sample_extra(gen, (P, A, batch))`` (e.g. latent z draws)."""

    data: Any                      # dict of tensors, leaves (P, A, N, ...)
    sizes: torch.Tensor            # (P, A) int64 true shard sizes
    batch_size: int
    sample_extra: Callable | None = None

    kind = "device"

    @property
    def agent_grid(self) -> tuple:
        return tuple(self.sizes.shape[:2])

    @property
    def device(self) -> torch.device:
        return self.sizes.device

    @classmethod
    def from_agent_data(cls, agent_data: Sequence[Any], agent_grid,
                        batch_size: int, *, sample_extra: Callable | None = None,
                        device="cuda") -> "DeviceFederatedData":
        """Stack per-agent datasets (len B = P*A, arbitrary sizes) into the
        device-resident layout on ``device``."""
        dev = resolve_device(device)
        P, A = agent_grid
        if P * A != len(agent_data):
            raise ValueError(f"agent_grid {agent_grid} != {len(agent_data)} datasets")
        sizes = [tree_leaves(d)[0].shape[0] for d in agent_data]
        n_max = max(sizes)

        def pad(x):
            n = x.shape[0]
            return x if n == n_max else x[torch.arange(n_max, device=x.device) % n]

        def stack(*xs):
            s = torch.stack([pad(x.to(dev)) for x in xs])
            return s.reshape((P, A) + tuple(s.shape[1:]))

        data = tree_map(stack, agent_data[0], *agent_data[1:])
        return cls(data=data,
                   sizes=torch.tensor(sizes, dtype=torch.int64).reshape(P, A).to(dev),
                   batch_size=batch_size, sample_extra=sample_extra)

    def sample_step(self, gen: torch.Generator):
        P, A = self.agent_grid
        B, b = P * A, self.batch_size
        n = self.sizes[..., None]
        u = torch.rand((P, A, b), generator=gen, device=self.device)
        idx = torch.minimum((u * n).long(), n - 1).reshape(B, b)
        rows = torch.arange(B, device=self.device)[:, None]

        def gather(x):
            flat = x.reshape((B,) + tuple(x.shape[2:]))
            g = flat[rows, idx]
            return g.reshape((P, A) + tuple(g.shape[1:]))

        batch = tree_map(gather, self.data)
        if self.sample_extra is not None:
            batch = {**batch, **self.sample_extra(gen, (P, A, b))}
        return batch
