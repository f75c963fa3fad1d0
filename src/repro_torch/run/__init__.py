# The training runtime: the round driver over the FederatedData pipelines,
# the eval harness, the K-sweep runner, and the virtual-client fleet
# (A_total clients on A_active device slots) with its async buffered
# aggregation on the simulated clock.
from repro_torch.run.driver import RoundDriver, RunResult, train
from repro_torch.run.evals import EvalSuite, eval_hook, evaluate, final_fd
from repro_torch.run.virtual import (ClientStore, StragglerPolicy, VirtualClientDriver,
                                     load_fleet_checkpoint, staleness_scale,
                                     staleness_weights)

__all__ = [
    "AsyncAggDriver", "ClientStore", "EvalSuite", "EventJournal", "LatencyModel",
    "RoundDriver", "RunResult", "SimClock", "StragglerPolicy", "VirtualClientDriver",
    "eval_hook", "evaluate", "final_fd", "load_fleet_checkpoint",
    "modeled_sync_makespan", "params_digest", "run_sweep", "staleness_scale",
    "staleness_weights", "summary_table", "train",
]


def __getattr__(name):
    # lazy: keeps `python -m repro_torch.run.experiments` and
    # `-m repro_torch.run.simclock` free of the runpy double-import warning
    if name in ("run_sweep", "summary_table"):
        from repro_torch.run import experiments
        return getattr(experiments, name)
    if name in ("AsyncAggDriver", "modeled_sync_makespan"):
        from repro_torch.run import async_agg
        return getattr(async_agg, name)
    if name in ("EventJournal", "LatencyModel", "SimClock", "params_digest"):
        from repro_torch.run import simclock
        return getattr(simclock, name)
    raise AttributeError(name)
