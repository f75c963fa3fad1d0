from repro_torch.data import synthetic
from repro_torch.data.federated import DeviceFederatedData, round_key_schedule

__all__ = ["synthetic", "DeviceFederatedData", "round_key_schedule"]
