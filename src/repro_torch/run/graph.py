"""One FedGAN round captured in a CUDA graph (the port's twin of the
reference's ``lax.scan`` over a chunk of rounds).

:class:`CapturedRound` runs the chunk's first round eagerly on a side
stream, which loads the kernel libraries, lets cuDNN and cuBLAS pick their
algorithms and allocates the lazy state, then captures
``FedGAN.round_from_data`` once in a ``torch.cuda.CUDAGraph``.  Every
later round is one replay: the state lives in static buffers that the
graph updates in place, and the round's metrics land in a static
(n_metrics,) output that the caller copies out before the next replay.

Random draws stay outside the graph.  Before each replay the round's K
steps' draws (``FedGAN.draw_step``: the minibatch uniforms, then the
``sample_extra`` draws, then any DP-SGD noise) are made eagerly from the
round's generator, in the eager round's order, into static input buffers
that the graph reads.  So a replayed round uses the bits of the eager
round from the same generator, and the design needs no generator
registered with the graph.

Kernel wrappers count launches when their Python runs, which under
capture records a launch and makes none.  The capture's counts are taken
back and added once per replay (``repro_torch.kernels.launch_counters``),
so the counters stay exact.

A capture that fails raises; nothing falls back to eager rounds.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import launch_counters
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


def _broadcast_dims(x: torch.Tensor) -> list:
    """The dims ``x`` broadcasts along (stride 0, size > 1): a synced
    leaf is one value expanded over the agent grid."""
    return [i for i, (n, s) in enumerate(zip(x.shape, x.stride())) if s == 0 and n > 1]


def _static_like(x: torch.Tensor) -> torch.Tensor:
    """A buffer of ``x``'s shape that broadcasts along the dims ``x`` does,
    holding ``x``'s values."""
    dims = _broadcast_dims(x)
    base = torch.empty([1 if i in dims else n for i, n in enumerate(x.shape)],
                       dtype=x.dtype, device=x.device)
    out = base.expand(x.shape)
    _write(out, x)
    return out


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst`` <- ``src``, writing each broadcast element of ``dst`` once
    (from index 0 of ``src`` along those dims)."""
    for i in _broadcast_dims(dst):
        dst, src = dst.narrow(i, 0, 1), src.narrow(i, 0, 1)
    dst.copy_(src)


def metric_row(metrics: dict, keys) -> torch.Tensor:
    """The round's (n_metrics,) row: the mean over its K steps of each
    metric, in ``keys`` order, on the device."""
    return torch.stack([torch.mean(metrics[k]) for k in keys])


class CapturedRound:
    """A round of ``fed`` over ``data`` (a ``DeviceFederatedData`` on a
    CUDA device), captured after one eager round from ``state`` with
    generator ``gen``.  ``metrics`` holds that first round's (n_metrics,)
    row (``keys`` names them); ``replay(gen)`` runs the next round and
    returns its row, a static buffer the next replay overwrites; ``state``
    is the current state, in static buffers."""

    def __init__(self, fed, data, state, gen: torch.Generator):
        self.fed, self.data = fed, data
        K = fed.cfg.sync_interval
        dev = data.device
        compute = torch.cuda.current_stream(dev)
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(compute)
        counters = launch_counters()
        with torch.cuda.stream(self.stream):
            # the chunk's first round, eager: the warm-up before capture
            draws = [fed.draw_step(state, data, gen) for _ in range(K)]
            out, m = fed.round_from_draws(state, data, draws)
            self.keys = sorted(m)
            self.metrics = metric_row(m, self.keys)
            self.state = tree_map(_static_like, out)
            self.draws = tree_map(torch.empty_like, draws)
            before = {name: fn.launches for name, fn in counters.items()}
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=self.stream):
                new, m = fed.round_from_draws(self.state, data, self.draws)
                self._write_state(new)
                self.row = metric_row(m, self.keys)
            # capture records launches and makes none: take its counts
            # back, and add them once per replay
            self.deltas = {}
            for name, fn in counters.items():
                if fn.launches != before[name]:
                    self.deltas[fn] = fn.launches - before[name]
                    fn.launches = before[name]
        compute.wait_stream(self.stream)

    def _write_state(self, new) -> None:
        leaves, treedef = tree_flatten(self.state)
        new_leaves, new_def = tree_flatten(new)
        if new_def != treedef:
            raise RuntimeError("captured round: the round changed the state's structure")
        for i, (dst, src) in enumerate(zip(leaves, new_leaves)):
            if (src.shape, src.dtype) != (dst.shape, dst.dtype):
                raise RuntimeError(f"captured round: state leaf {i} changed from "
                                   f"{tuple(dst.shape)} {dst.dtype} to "
                                   f"{tuple(src.shape)} {src.dtype}")
            if set(_broadcast_dims(dst)) - set(_broadcast_dims(src)):
                raise RuntimeError(
                    f"captured round: state leaf {i} {tuple(dst.shape)} was one value "
                    "broadcast over the agents after the first round and is not after "
                    "the captured one; its static buffer cannot hold it")
            _write(dst, src)

    def replay(self, gen: torch.Generator) -> torch.Tensor:
        """The next round: its draws from ``gen`` into the static inputs,
        then one replay.  Returns the static (n_metrics,) row."""
        for static in self.draws:
            new = self.fed.draw_step(self.state, self.data, gen)
            for dst, src in zip(tree_leaves(static), tree_leaves(new)):
                dst.copy_(src)
        self.graph.replay()
        for fn, n in self.deltas.items():
            fn.launches += n
        return self.row
