"""Runtime loop-affinity witness: a copy of the JAX package's, beside the
lock-order witness in :mod:`.locked`.

Per-client transport and QoS state (the clients' ``OutboundQueue``) is
LOOP-OWNED: exactly one event loop may touch it directly, and every
foreign thread or loop must cross through a marshal seam
(``call_soon_threadsafe`` / ``run_coroutine_threadsafe``). The witness
records which (kind, seam) crossings actually happen and collects (or
raises on) guarded touches that bypass the seams.

The port has its own ``DEFAULT_LOOP_PLANE``, as it has its own lock
plane: nothing here reads or arms the JAX package's.

Cost discipline copied from :class:`locked.LockPlane`:

- instrumented touch points guard on ONE plane flag
  (``DEFAULT_LOOP_PLANE.active``); the disarmed cost is a single
  attribute read + branch;
- ``arm_witness(raise_on_violation=True)`` ESCALATES an existing
  recording witness to the raising tripwire and never de-escalates;
- known (kind, seam) pairs are a mutex-free dict probe; only a
  first-seen seam or a violation takes the witness mutex.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Optional


class LoopAffinityViolation(AssertionError):
    """A loop-owned object was touched from outside its owning loop
    without crossing a blessed marshal seam."""


def current_loop() -> Optional[asyncio.AbstractEventLoop]:
    """The running loop of THIS thread, or None for plain-thread
    context (the executor/staging/native-build threads).

    Uses the non-raising ``asyncio._get_running_loop`` (exported by
    ``asyncio.events.__all__`` since 3.7): the armed witness probes loop
    identity on EVERY instrumented queue touch, and paying the
    exception machinery of ``get_running_loop()`` in plain-thread
    context would triple the per-touch cost."""
    return asyncio._get_running_loop()


class LoopWitness:
    """Records every (kind, seam) affinity crossing observed at the
    instrumented touch points, with first-seen evidence, and collects
    (or raises on) guarded touches that bypass the seams."""

    def __init__(self, raise_on_violation: bool = False) -> None:
        self.raise_on_violation = raise_on_violation
        # (kind, seam) -> (thread name, detail) first-seen evidence
        self.edges: dict[tuple[str, str], tuple[str, str]] = {}
        self.violations: list[str] = []
        self._mutex = threading.Lock()

    # -- recording ---------------------------------------------------------

    def note(self, kind: str, seam: str, detail: str = "") -> None:
        """Record one legal seam traversal. Known seams are a single
        dict probe (no mutex) — the steady-state cost once the first
        traversal of each seam has been seen."""
        key = (kind, seam)
        if key in self.edges:
            return
        with self._mutex:
            self.edges.setdefault(
                key, (threading.current_thread().name, detail)
            )

    def note_crossing(
        self,
        kind: str,
        local_seam: str,
        cross_seam: str,
        owner: Optional[asyncio.AbstractEventLoop],
        detail: str = "",
    ) -> None:
        """A touch that is legal from EITHER side of the affinity
        boundary (thread-safe objects, marshaling submitters): record
        WHICH seam fired. ``owner`` None means no affinity established
        yet (e.g. a queue nobody has consumed from) — that counts as
        the local seam. The known-edge probe is inlined rather than
        delegated to :meth:`note`: this runs per OutboundQueue put."""
        key = (
            (kind, local_seam)
            if owner is None or asyncio._get_running_loop() is owner
            else (kind, cross_seam)
        )
        if key in self.edges:
            return
        with self._mutex:
            self.edges.setdefault(
                key, (threading.current_thread().name, detail)
            )

    # -- asserting ---------------------------------------------------------

    def check_owner(
        self,
        kind: str,
        seam: str,
        owner: Optional[asyncio.AbstractEventLoop],
        detail: str = "",
    ) -> None:
        """A guarded touch: legal ONLY on the owning loop (``owner``
        None = not yet attached, trivially legal). Off-loop touches are
        violations — collected always, raised when armed raising."""
        if owner is None or asyncio._get_running_loop() is owner:
            key = (kind, seam)
            if key in self.edges:
                return
            with self._mutex:
                self.edges.setdefault(
                    key, (threading.current_thread().name, detail)
                )
            return
        msg = (
            f"{kind}: guarded touch at seam {seam!r} off its owning loop "
            f"(thread {threading.current_thread().name!r}"
            f"{', ' + detail if detail else ''})"
        )
        with self._mutex:
            self.violations.append(msg)
        if self.raise_on_violation:
            raise LoopAffinityViolation(msg)


class LoopPlane:
    """Process-wide switchboard for the loop witness, mirroring
    :class:`locked.LockPlane`'s single ``active`` fast-path flag."""

    def __init__(self) -> None:
        self._mutex = threading.Lock()
        self.witness: Optional[LoopWitness] = None
        self.active = False

    def arm_witness(self, raise_on_violation: bool = False) -> LoopWitness:
        """Attach (or return the already-attached) witness.
        ``raise_on_violation=True`` ESCALATES an existing recording
        witness to the raising tripwire; it never de-escalates —
        disarm and re-arm for that (same contract as
        ``LockPlane.arm_witness``)."""
        with self._mutex:
            if self.witness is None:
                self.witness = LoopWitness(
                    raise_on_violation=raise_on_violation
                )
            elif raise_on_violation:
                self.witness.raise_on_violation = True
            self.active = True
            return self.witness

    def disarm_witness(self) -> None:
        with self._mutex:
            self.witness = None
            self.active = False

    def reset(self) -> None:
        """Drop recorded evidence IN PLACE (A/B rounds, test isolation)
        without detaching the witness."""
        with self._mutex:
            w = self.witness
            if w is not None:
                with w._mutex:
                    w.edges.clear()
                    w.violations.clear()


# the port's process default: the instrumented seams in ``clients``
# consult it; disarmed unless a caller arms it
DEFAULT_LOOP_PLANE = LoopPlane()
