"""Endpoint lifecycle: state machine, policy regeneration, fleet
table compilation, checkpoint/restore.

The port's own copy of the JAX package's endpoint/__init__.py.

Re-design of pkg/endpoint + pkg/endpointmanager: the
regeneration pipeline computes desired PolicyMapState per endpoint
(the control plane, identical semantics) and realizes it as stacked
device tensors for the verdict engine (replacing per-endpoint BPF
compile+load with one fleet lowering + a double-buffered flip).
"""

from cilium_tpu_torch.endpoint.endpoint import (
    STATE_CREATING,
    STATE_DISCONNECTED,
    STATE_DISCONNECTING,
    STATE_READY,
    STATE_REGENERATING,
    STATE_RESTORING,
    STATE_WAITING_FOR_IDENTITY,
    STATE_WAITING_TO_REGENERATE,
    Endpoint,
)
from cilium_tpu_torch.endpoint.manager import EndpointManager

__all__ = [
    "Endpoint",
    "EndpointManager",
    "STATE_CREATING",
    "STATE_WAITING_FOR_IDENTITY",
    "STATE_READY",
    "STATE_WAITING_TO_REGENERATE",
    "STATE_REGENERATING",
    "STATE_DISCONNECTING",
    "STATE_DISCONNECTED",
    "STATE_RESTORING",
]
