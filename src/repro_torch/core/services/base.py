"""Service framework: reusable, *reconfigurable* shell services (Req. 1).

A service is shell-resident infrastructure (MMU, networking, compression,
encryption, sniffer).  Unlike prior shells, services are not static: the
shell can swap a service configuration at run time (paper §4), and apps
declare the services + constraints they require so a reconfiguration can
never strand a running app (the paper's fail-safe linking rule)."""
from __future__ import annotations

import abc
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


class Service(abc.ABC):
    """Base class.  Subclasses define NAME and a config dataclass.

    Port API v2: ``PORT_METHODS`` is the allowlist of operations a
    service port may dispatch; anything else completes with ``ok=False``.
    The port layer and ``port_capabilities()`` arrive with the shell
    slice of the port.
    """

    NAME: str = "service"
    PORT_METHODS: tuple = ("status", "configure")
    PORT_CSR_MAP: dict = {}
    PORT_MEM_MODEL: str = "none"

    def __init__(self, config: Any = None):
        self.config = config
        self.generation = 0              # bumped on every reconfigure
        self.loaded_at = time.perf_counter()

    # -- lifecycle -----------------------------------------------------------
    def configure(self, config: Any) -> None:
        """Run-time reconfiguration: apply a new config in place."""
        self.config = config
        self.generation += 1

    def unload(self) -> None:
        """Release resources when the shell drops this service."""

    # -- introspection -------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        return {"name": self.NAME, "generation": self.generation,
                "config": repr(self.config)}

    def satisfies(self, constraints: Dict[str, Any]) -> bool:
        """Whether this service instance meets an app's requirements.

        Constraints match attributes on the config: {"page_size": 2048}
        requires config.page_size == 2048; {"min_page_size": 1024} requires
        config.page_size >= 1024 (min_/max_ prefixes compare)."""
        for key, want in constraints.items():
            if key.startswith("min_"):
                have = getattr(self.config, key[4:], None)
                if have is None or have < want:
                    return False
            elif key.startswith("max_"):
                have = getattr(self.config, key[4:], None)
                if have is None or have > want:
                    return False
            else:
                have = getattr(self.config, key, None)
                if have != want:
                    return False
        return True


@dataclass
class ServiceRequirement:
    """An app's declared dependency on a shell service."""
    service: str
    constraints: Dict[str, Any] = field(default_factory=dict)


class ServiceRegistry:
    """The dynamic layer's service table."""

    def __init__(self):
        self._services: Dict[str, Service] = {}

    def add(self, svc: Service) -> None:
        self._services[svc.NAME] = svc

    def remove(self, name: str) -> Optional[Service]:
        svc = self._services.pop(name, None)
        if svc is not None:
            svc.unload()
        return svc

    def get(self, name: str) -> Optional[Service]:
        return self._services.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._services

    def names(self):
        return sorted(self._services)

    def check(self, req: ServiceRequirement) -> bool:
        svc = self.get(req.service)
        return svc is not None and svc.satisfies(req.constraints)

    def status(self) -> Dict[str, Any]:
        return {n: s.status() for n, s in self._services.items()}
