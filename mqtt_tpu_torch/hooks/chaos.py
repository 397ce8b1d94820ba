"""Chaos hook: seeded fault injection against a LIVE broker.

A copy of the JAX package's ``mqtt_tpu/hooks/chaos.py`` over the port's
``faults``. Attaches the injector between the degradation manager
(``resilience.ResilientMatcher``) and the device matcher of a running
server, so chaos runs use the exact wiring production uses — the staging
loop, the breaker, the watchdog, the $SYS gauges — instead of a lab
harness:

    from mqtt_tpu_torch.hooks.chaos import ChaosHook, ChaosOptions
    server.add_hook(ChaosHook(), ChaosOptions(
        server=server, seed=7, error_rate=0.2, corrupt_rate=0.05,
    ))

The hook installs at ``on_started`` (after ``serve()`` has built the
matcher and staging loop) and uninstalls at ``on_stopped``/``stop``,
releasing any injected hangs so guard threads retire. One departure:
uninstall waits (up to ``hang_s``) until every released hang has run its
batch's resolver, so no hung batch still pins a table buffer of the
port's ``TorchMatcher`` when it returns. ``injected`` exposes the
per-kind injection counts for assertions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import ON_STARTED, ON_STOPPED, Hook
from ..faults import FaultPlan, FaultyMatcher


@dataclass
class ChaosOptions:
    """Fault rates mirror :class:`mqtt_tpu_torch.faults.FaultPlan`; ``server``
    is required (hooks receive no server reference from the dispatcher,
    and chaos is an embedder/test-harness feature, never config-file
    enabled by accident)."""

    server: object = None
    seed: int = 0
    hang_rate: float = 0.0
    error_rate: float = 0.0
    issue_error_rate: float = 0.0
    corrupt_rate: float = 0.0
    slow_rate: float = 0.0
    hang_s: float = 30.0
    slow_s: float = 0.05
    at: Optional[dict] = None


class ChaosHook(Hook):
    def __init__(self) -> None:
        super().__init__()
        self.config: Optional[ChaosOptions] = None
        self.faulty: Optional[FaultyMatcher] = None
        self._host: Optional[object] = None  # whoever holds the wrapped ref

    def id(self) -> str:
        return "chaos"

    def provides(self, b: int) -> bool:
        return b in (ON_STARTED, ON_STOPPED)

    def init(self, config) -> None:
        if config is not None and not isinstance(config, ChaosOptions):
            raise ValueError("ChaosHook requires ChaosOptions")
        self.config = config or ChaosOptions()

    @property
    def injected(self) -> dict:
        """Per-kind injection counts (empty before install)."""
        return dict(self.faulty.injected) if self.faulty is not None else {}

    def on_started(self) -> None:
        if self.config is not None and self.config.server is not None:
            self.install(self.config.server)

    def install(self, server) -> None:
        """Interpose the fault injector on ``server``'s matcher. With the
        degradation manager active (the default), the injector wraps its
        ``inner`` so faults hit the breaker exactly where real device
        faults would."""
        if self.faulty is not None or server.matcher is None:
            return
        c = self.config or ChaosOptions()
        plan = FaultPlan(
            seed=c.seed,
            hang_rate=c.hang_rate,
            error_rate=c.error_rate,
            issue_error_rate=c.issue_error_rate,
            corrupt_rate=c.corrupt_rate,
            slow_rate=c.slow_rate,
            hang_s=c.hang_s,
            slow_s=c.slow_s,
            at=dict(c.at or {}),
        )
        target = server.matcher
        if hasattr(target, "inner"):  # ResilientMatcher: wrap beneath it
            self.faulty = FaultyMatcher(target.inner, plan)
            self._host = target
            target.inner = self.faulty
        else:
            self.faulty = FaultyMatcher(target, plan)
            self._host = server
            server.matcher = self.faulty
            if server._stage is not None:  # the stage captured the old ref
                server._stage.matcher = self.faulty
        self.log.warning(
            "chaos hook armed (seed=%d): fault injection is LIVE", c.seed
        )

    def uninstall(self) -> None:
        faulty = self.faulty
        if faulty is None:
            return
        faulty.release.set()  # un-wedge any injected hangs
        # a released hang resolves its batch, which drops the batch's pin
        # on the matcher's table buffer: wait for those resolvers
        faulty.wait_released(faulty.plan.hang_s)
        host = self._host
        if host is not None:
            if getattr(host, "inner", None) is faulty:
                host.inner = faulty.inner
            elif getattr(host, "matcher", None) is faulty:
                host.matcher = faulty.inner
                if getattr(host, "_stage", None) is not None:
                    host._stage.matcher = faulty.inner
        self.faulty = None
        self._host = None

    def on_stopped(self) -> None:
        self.uninstall()

    def stop(self) -> None:
        self.uninstall()
