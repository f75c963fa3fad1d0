"""repro_torch.privacy: the privacy and robustness axis of the FedGAN
runtime (a port of ``repro.privacy``).

  * :class:`DPSGD`: per-agent DP-SGD (per-example joint clip and Gaussian
    noise inside the local step) with the closed-form RDP accountant of
    :mod:`repro_torch.privacy.accountant`; ``FedGANConfig(dp=...)``.
  * :class:`SecureAgg`: pairwise-mask secure summing at the intermediary
    (``FedAvgSync(secure_agg=...)``); the mechanism is
    ``repro_torch.dist.collectives.masked_sync``.
  * Byzantine-robust aggregation: ``TrimmedMeanSync`` and
    ``CoordinateMedianSync`` in :mod:`repro_torch.core.strategies`, tried
    against the attacks of :mod:`repro_torch.privacy.attacks`.
"""
from repro_torch.privacy import accountant
from repro_torch.privacy.attacks import ATTACKS, WithByzantine, corrupt
from repro_torch.privacy.dpsgd import DPSGD, dp_grads, noise_like, per_example_grads
from repro_torch.privacy.secure import SecureAgg

__all__ = [
    "ATTACKS",
    "DPSGD",
    "SecureAgg",
    "WithByzantine",
    "accountant",
    "corrupt",
    "dp_grads",
    "noise_like",
    "per_example_grads",
]
