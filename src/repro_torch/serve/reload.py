"""Hot-reload: pick up newer generator checkpoints between decode ticks (a
port of ``repro.serve.reload``, over the port's ``checkpoint`` package,
which reads and writes the reference's layout).

A FedGAN run training in one process (``launch.train --ckpt-dir ...``) is
servable live from another: ``save_checkpoint`` writes the step directory
first and atomically repoints ``LATEST`` last, so a poll here either sees
the previous complete checkpoint or the new complete one.
``CheckpointWatcher.poll`` is cheap (one small file read) when nothing
changed; array IO only happens when a newer step appears.  In-flight
requests keep their caches — only the weights swap: the synced generator
is a drop-in replacement of the same shapes.
"""
from __future__ import annotations

import warnings

from repro_torch.checkpoint import read_latest_step, restore_checkpoint
from repro_torch.tree import tree_map


def generator_from_state(state, agent: tuple[int, int] = (0, 0)):
    """Extract one agent's generator params from a FedGAN train state.

    Train checkpoints hold every leaf with a leading (P, A) agent grid;
    after a sync all agents are identical, so serving reads agent (0, 0) by
    default."""
    gen = state["params"]["gen"]
    return tree_map(lambda x: x[agent], gen)


class CheckpointWatcher:
    """Polls a checkpoint directory for steps newer than the last one seen.

    ``extract`` maps the restored state to the params tree the engine
    serves (default: :func:`generator_from_state` for FedGAN train states;
    pass ``lambda s: s`` for raw Backbone params checkpoints).  Restored
    leaves land on ``device`` (the card unless the caller asks for the
    CPU).
    """

    def __init__(self, directory: str, *, extract=None, start_step: int = -1,
                 device="cuda"):
        self.directory = directory
        self.extract = extract if extract is not None else generator_from_state
        self.seen_step = start_step
        self.device = device
        self._bad_step = None  # step whose extract failed deterministically

    def poll(self):
        """(params, step) when a newer complete checkpoint exists, else
        None.  A checkpoint mid-write never surfaces: LATEST only points at
        complete step dirs; transient filesystem errors just defer to the
        next poll, while a deterministic read/extract failure (e.g. the
        wrong ``extract`` for the checkpoint's layout) warns once and stops
        re-reading that step — a newer step gets a fresh attempt."""
        try:
            step = read_latest_step(self.directory)
        except OSError:
            return None
        if step is None or step <= self.seen_step or step == self._bad_step:
            return None
        try:
            state, _ = restore_checkpoint(self.directory, step=step, device=self.device)
        except OSError:
            return None  # likely a filesystem race — retry next poll
        except (KeyError, ValueError, TypeError) as e:  # corrupt step dir: don't loop on it
            self._bad_step = step
            warnings.warn(f"CheckpointWatcher: step {step} in "
                          f"{self.directory} is unreadable ({e!r})",
                          stacklevel=2)
            return None
        try:
            params = self.extract(state)
        except (KeyError, ValueError, TypeError, IndexError) as e:
            self._bad_step = step
            warnings.warn(
                f"CheckpointWatcher: extracting step {step} from "
                f"{self.directory} failed ({e!r}); still serving the "
                f"previous params — wrong extract= for this checkpoint "
                f"layout?", stacklevel=2)
            return None
        self.seen_step = step
        return params, step
