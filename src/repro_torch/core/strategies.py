"""Sync strategies, first cut (a port of part of ``repro.core.strategies``).

A :class:`SyncStrategy` owns when, what and how agents sync, and its own
§3.2 wire-byte accounting.  Hooks called by ``FedGAN``:

  ``validate(cfg)``              static config check
  ``init_round_state(fed, st)``  extra state carried across rounds (the
                                 error-feedback residuals of a coded sync)
  ``state_axes()``               "client" (agent-stacked) or "shared" per
                                 carried entry
  ``round_sync(fed, st)``        after the K local steps
  ``bytes_per_round(cfg, params, opt=None)``
                                 per-agent send+receive wire bytes per round

Ported: ``LocalOnly``, ``FedAvgSync`` (plain average, fused and composed
coded sync) and ``PartialSharing``.  Secure aggregation, robust reduces,
participation subsampling and the other schedules are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.dist import collectives
from repro_torch.tree import tree_map

_OPT_KEY = {"gen": "opt_g", "disc": "opt_d"}


def _fedavg(fed, state, *, subtrees, average_opt_state, codec=None,
            error_feedback=True, fused=None):
    """The eq. (2)+(3) aggregation of ``subtrees``: weighted average over
    (P, A), broadcast back.  With ``codec`` the sync runs through
    ``collectives.coded_sync`` and, with ``error_feedback``, updates the
    per-agent uplink residuals (``state["ef"]``) and the shared downlink
    residual (``state["ef_down"]``)."""
    w = fed._w(state["step"].device)
    new = dict(state)
    params = dict(state["params"])
    if codec is None:
        for k in subtrees:
            params[k] = collectives.average_agents(state["params"][k], w)
    else:
        use_ef = error_feedback and "ef" in state
        ef = dict(state["ef"]) if use_ef else None
        ef_down = dict(state["ef_down"]) if use_ef else None
        for k in subtrees:
            params[k], e2, ed2 = collectives.coded_sync(
                state["params"][k], w, codec,
                ef=ef[k] if use_ef else None,
                ef_down=ef_down[k] if use_ef else None, fused=fused)
            if use_ef:
                ef[k], ef_down[k] = e2, ed2
        if use_ef:
            new["ef"], new["ef_down"] = ef, ef_down
    new["params"] = params
    if average_opt_state:
        for k in subtrees:
            opt = state[_OPT_KEY[k]]
            if codec is None:
                new[_OPT_KEY[k]] = collectives.average_agents(opt, w)
            else:
                # the moments ride the coded wire too, without residuals:
                # they are re-estimated every step anyway
                new[_OPT_KEY[k]] = collectives.coded_sync(opt, w, codec,
                                                          fused=fused)[0]
    return new


class SyncStrategy:
    """Base protocol; the defaults are the never-sync ablation."""

    name = "local_only"

    def validate(self, cfg):
        pass

    def init_round_state(self, fed, state) -> dict:
        return {}

    def state_axes(self) -> dict:
        return {}

    def round_sync(self, fed, state):
        return state

    def bytes_per_round(self, cfg, params, opt=None) -> int:
        return 0


@dataclasses.dataclass(frozen=True)
class LocalOnly(SyncStrategy):
    """Never sync (ablation lower bound)."""


@dataclasses.dataclass(frozen=True)
class FedAvgSync(SyncStrategy):
    """The paper's Algorithm 1 intermediary: K local steps, then a
    dataset-size-weighted parameter average of ``subtrees``.

    ``codec`` (a ``repro_torch.comm.Codec``: ``IntQuant``, ``TopK`` or a
    ``Sequential`` chain) ships both directions of the sync encoded; with
    ``error_feedback`` each agent carries an uplink residual and the
    intermediary a downlink residual.  ``fused_sync`` picks the path of the
    coded sync (the values are the same): None lets
    ``collectives.coded_sync`` fuse the float32 leaves through the qsync
    kernel when the codec has a ``fused_sync_spec``; False forces the
    composed per-leaf pipeline (the qpack kernels around the fedavg
    reduce); True requires the fused path and fails validation when the
    codec cannot ride it.  ``average_opt_state`` averages the optimizer
    moments of the synced subtrees too.  ``secure_agg`` is not ported and
    raises."""

    average_opt_state: bool = False
    subtrees: tuple = ("gen", "disc")
    codec: Any = None
    error_feedback: bool = True
    secure_agg: Any = None
    fused_sync: Any = None
    name = "fedgan"

    def validate(self, cfg):
        bad = [k for k in self.subtrees if k not in _OPT_KEY]
        if bad or not self.subtrees:
            raise ValueError(f"subtrees must be a non-empty subset of "
                             f"{tuple(_OPT_KEY)}, got {self.subtrees}")
        if self.codec is not None:
            self.codec.validate()
        if self.fused_sync:
            if self.codec is None:
                raise ValueError(
                    "fused_sync=True needs a codec= — the fused path IS the "
                    "coded sync; the plain average has nothing to fuse")
            if self.codec.fused_sync_spec() is None:
                raise ValueError(
                    f"fused_sync=True needs a codec with a fused_sync_spec; "
                    f"{self.codec.name!r} reshapes the payload and can only "
                    "run the composed per-leaf pipeline")
        if self.secure_agg is not None:
            raise NotImplementedError(
                "secure_agg= (pairwise-masked sync) is not ported yet")

    def init_round_state(self, fed, state) -> dict:
        if self.codec is None or not self.error_feedback:
            return {}
        return {
            # per-agent uplink residuals, agent-stacked like the params
            "ef": {k: tree_map(torch.zeros_like, state["params"][k])
                   for k in self.subtrees},
            # the intermediary's downlink residual: one shared copy
            "ef_down": {k: tree_map(lambda x: x.new_zeros(x.shape[2:]),
                                    state["params"][k]) for k in self.subtrees},
        }

    def state_axes(self) -> dict:
        if self.codec is None or not self.error_feedback:
            return {}
        return {"ef": "client", "ef_down": "shared"}

    def round_sync(self, fed, state):
        return _fedavg(fed, state, subtrees=self.subtrees,
                       average_opt_state=self.average_opt_state,
                       codec=self.codec, error_feedback=self.error_feedback,
                       fused=self.fused_sync)

    def bytes_per_round(self, cfg, params, opt=None) -> int:
        wire = sum(collectives.sync_bytes(params[k], codec=self.codec)
                   for k in self.subtrees)
        if self.average_opt_state and opt is not None:
            wire += sum(collectives.sync_bytes(opt[_OPT_KEY[k]], codec=self.codec)
                        for k in self.subtrees if _OPT_KEY[k] in opt)
        return 2 * wire  # send + receive, once per round


@dataclasses.dataclass(frozen=True)
class PartialSharing(FedAvgSync):
    """PS-FedGAN-style generator-only sharing (Wijesinghe et al. 2023):
    the intermediary averages the ``gen`` subtree; every discriminator
    stays local, adapted to its agent's data."""

    subtrees: tuple = ("gen",)
    name = "partial_sharing"


# the strategies the port has; the reference's others are not ported yet
STRATEGIES = {
    "fedgan": FedAvgSync,
    "local_only": LocalOnly,
    "partial_sharing": PartialSharing,
    "ps_fedgan": PartialSharing,
}


def get_strategy(name: str, **kwargs) -> SyncStrategy:
    """Instantiate a ported strategy by name (the CLI entry point)."""
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown or unported strategy {name!r}; "
                         f"ported: {sorted(STRATEGIES)}") from None
    return cls(**kwargs)
