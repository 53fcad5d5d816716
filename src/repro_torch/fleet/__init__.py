"""Fleet control plane: placement, health sweeps, pre-copy auto-migration.

``FleetController`` is the cloud-provisioning layer over a pool of
``Shell``s (the RC3E framing): score-based placement of new tenants,
periodic health/QoS sweeps, and controller-triggered live migration off
hotspots and wedged members — pre-copy by default, so the service gap
is O(dirty delta).
"""
from repro_torch.fleet.controller import FleetController, FleetDecision

__all__ = ["FleetController", "FleetDecision"]
