"""Deterministic fault injection + the typed failure lattice (DESIGN.md §12).

The engine's failure model is only trustworthy if every failure path can be
exercised on demand, in a test, with a reproducible trigger.  This module is
that seam: a ``FaultInjector`` is threaded into ``JaxRealBackend`` and
consulted at each stage boundary — slot allocation, device-call launch,
user-hook emission, deadline evaluation — and fires *by call count*, never
by wall clock or randomness, so a chaos test replays bit-identically.

Sites (the ``Fault.site`` vocabulary):

    "alloc"     slot allocation (``_alloc_slot``): the pool is out of rows
                and may not grow (``pool_slots_max``).  Injected or real,
                the result is the same ``AllocationFault``.
    "device"    a jitted-call launch (``JaxRealBackend._call``).  Checked
                BEFORE the program runs, so a retry is a clean re-launch —
                donated buffers are never half-mutated.  ``transient=True``
                faults are retried in place (the abortable-segment replay
                machinery of DESIGN.md §8 is the recovery unit);
                ``transient=False`` raises ``PermanentDeviceFault``.
    "hook"      the per-token user callback boundary (``_emit``).
    "deadline"  deadline evaluation (``deadline_expired``): a firing fault
                makes the flow expire regardless of its real deadline.

Stage labels (``Fault.stage``) narrow a "device" fault to one boundary:
``prefill``, ``decode``, ``prefix_copy``, ``finish``, ``mask`` — ``None``
matches every stage of the site.  ``req_id`` narrows to one flow where the
call is flow-attributable (alloc / hook / deadline / prefill-side device
calls); batched decode launches carry no single owner.

``FlowFault`` is the quarantine envelope: the backend wraps a
flow-attributable failure in one and parks it for the scheduler's per-turn
poll, which retires *that* flow as ``failed`` while every other flow runs
to completion (``isolate_flow_faults=False`` restores raise-out).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

SITES = ("alloc", "device", "hook", "deadline")


class FaultError(Exception):
    """Base class of every injected (or real) backend failure."""


class TransientDeviceFault(FaultError):
    """A device-call launch failed but retrying may succeed (the injected
    analogue of a transient runtime error).  Retried by ``_call``; the
    already-buffered abortable segment is the replay unit."""


class PermanentDeviceFault(FaultError):
    """A device-call launch failed and will keep failing (retries
    exhausted, or ``transient=False``)."""


class AllocationFault(FaultError):
    """KV-pool slot allocation failed: the pool is at ``pool_slots_max``
    and the degradation ladder could not free a row (or the fault was
    injected).  Flow-attributable: quarantines the requesting flow."""


class HookFault(FaultError):
    """Injected user-hook exception (the deterministic stand-in for a
    misbehaving ``on_token`` callback)."""


class AdmissionRejected(FaultError):
    """Typed admission verdict: the degradation ladder walked every rung —
    evict, shrink, defer — and still had no capacity.  Never raised out of
    the engine; it is recorded as the rejected request's ``fault`` and the
    request retires with the ``rejected`` terminal status."""


class InvariantViolation(AssertionError):
    """``validate()`` found the backend's slot/refcount accounting
    inconsistent (raised only under the strict flag)."""


class FlowFault(Exception):
    """Envelope quarantining ONE flow: the scheduler retires ``req`` as
    ``failed`` at its next per-turn poll while all other flows continue."""

    def __init__(self, req, cause: BaseException, stage: str):
        super().__init__(f"flow {req.id} failed at {stage}: {cause!r}")
        self.req = req
        self.req_id = req.id
        self.cause = cause
        self.stage = stage


@dataclasses.dataclass
class Fault:
    """One deterministic trigger.

    Fires on the ``nth`` matching check (1-based) and the ``count - 1``
    checks after it; with ``period`` set it re-fires every ``period``
    matching checks from ``nth`` on (sustained-fault load for benchmarks).
    Matching is by ``site``, then ``stage``/``req_id`` where given.
    """

    site: str
    nth: int = 1
    count: int = 1
    period: Optional[int] = None
    transient: bool = True  # "device" site only
    req_id: Optional[int] = None
    stage: Optional[str] = None
    message: str = ""
    seen: int = 0  # matching checks observed (mutated by the injector)
    fired: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {SITES}")
        self.nth = max(int(self.nth), 1)
        self.count = max(int(self.count), 1)
        if self.period is not None:
            self.period = max(int(self.period), self.count)

    def _matches(self, site: str, req_id: Optional[int],
                 stage: Optional[str]) -> bool:
        if site != self.site:
            return False
        if self.stage is not None and stage != self.stage:
            return False
        if self.req_id is not None and req_id != self.req_id:
            return False
        return True

    def _fires_now(self) -> bool:
        k = self.seen - self.nth  # 0-based offset from the first firing
        if k < 0:
            return False
        if self.period is not None:
            return k % self.period < self.count
        return k < self.count

    def error(self) -> FaultError:
        msg = self.message or (f"injected {self.site} fault "
                               f"(n={self.seen}, stage={self.stage})")
        if self.site == "alloc":
            return AllocationFault(msg)
        if self.site == "hook":
            return HookFault(msg)
        return TransientDeviceFault(msg) if self.transient \
            else PermanentDeviceFault(msg)


class FaultInjector:
    """Deterministic per-site check counters driving a list of ``Fault``
    triggers.  ``check`` raises the mapped error when a fault fires;
    ``fires`` is the no-raise predicate (used by the "deadline" site).
    With no matching fault both are near-free no-ops, so the injector can
    stay threaded through production code paths."""

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults: List[Fault] = list(faults or [])
        self.checks = 0
        self.fired = 0

    def add(self, fault: Fault) -> Fault:
        self.faults.append(fault)
        return fault

    def _step(self, site: str, req_id: Optional[int],
              stage: Optional[str]) -> Optional[Fault]:
        self.checks += 1
        hit = None
        for f in self.faults:
            if not f._matches(site, req_id, stage):
                continue
            f.seen += 1
            if hit is None and f._fires_now():
                f.fired += 1
                hit = f
        if hit is not None:
            self.fired += 1
        return hit

    def check(self, site: str, req_id: Optional[int] = None,
              stage: Optional[str] = None) -> None:
        hit = self._step(site, req_id, stage)
        if hit is not None:
            raise hit.error()

    def fires(self, site: str, req_id: Optional[int] = None,
              stage: Optional[str] = None) -> bool:
        return self._step(site, req_id, stage) is not None

    def stats(self) -> dict:
        return {"fault_checks": self.checks,
                "faults_fired": self.fired}
