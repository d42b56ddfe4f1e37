"""Reliability tier: checkpoints and resume, fault injection, bounded
retries (counterpart of ``photon_ml_tpu/reliability``)."""

from photon_ml_torch.reliability.checkpoint import RunCheckpointer
from photon_ml_torch.reliability.faults import Fault, FaultInjector

__all__ = ["Fault", "FaultInjector", "RunCheckpointer"]
