"""Planted host-sync violations (fixture for tests/test_torch_analysis.py).

The test finds each planted line by its text."""
import numpy as np
import torch


def leaky_round(state, metrics):
    loss = float(metrics["loss"])                      # planted: float() sync
    count = metrics["count"].item()                    # planted: .item() sync
    host = np.asarray(metrics["grad_norm"])            # planted: np.asarray sync
    steps = int(state["step"])                         # planted: int() sync
    rows = metrics["rows"].tolist()                    # planted: .tolist() sync
    fetched = state["params"].cpu()                    # planted: .cpu() sync
    arr = state["params"].numpy()                      # planted: .numpy() sync
    torch.cuda.synchronize()                           # planted: synchronize
    return loss, count, host, steps, rows, fetched, arr


def waived_round(state):
    # one fetch at the very end of the run, after all dispatches
    fetched = state["params"].cpu()  # analysis: allow(host-sync)
    return fetched


def fine_round(state):
    scale = float(1e-3)            # a constant: must NOT be flagged
    n = int(len(state))            # a host number: must NOT be flagged
    return torch.as_tensor(state["params"]) * scale * n
