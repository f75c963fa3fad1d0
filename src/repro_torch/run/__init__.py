from repro_torch.run.driver import RoundDriver, RunResult, train

__all__ = ["RoundDriver", "RunResult", "train"]
