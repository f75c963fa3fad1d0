from repro_torch.run.driver import RoundDriver, RunResult

__all__ = ["RoundDriver", "RunResult"]
