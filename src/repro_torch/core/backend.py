"""Probe backends: the seam that makes :class:`CacheXSession` multi-target.

The paper probes an opaque, hypervisor-hidden *LLC*; the same
probe-an-undocumented-memory-system move applies to any managed
accelerator pool (a TPU pod's effective VMEM / per-chip HBM bandwidth /
per-axis ICI health are exactly as hidden from a tenant as vCache
geometry is from a VM).  This module extracts what was implicit in the
GuestVM/LLC path into an explicit :class:`ProbeBackend` protocol so
``CacheXSession.attach(..., backend=...)`` can serve the *same query
surface* — ``topology()`` / ``colors()`` / ``contention()``,
subscriptions, epoch-stamped ``export()``/``import_()`` — over any
probing target.

Two protocols, both structural (duck-typed — nothing has to inherit):

:class:`ProbeTarget`
    what the ProbePlan executor (`repro_torch.core.probeplan.execute`) needs
    from a probing target.  `GuestVM` satisfies it natively.  Because the
    executor only sees this surface, every plan facility — `fuse`,
    `split_result`, `plan_cost`, signatures — works on any target that
    satisfies it.

:class:`ProbeBackend`
    the session-construction seam: ``attach`` (stage lifecycle against a
    live target) and ``import_`` (restore an epoch-stamped export).  The
    returned session must serve the CacheXSession query surface.

Backends self-register in :data:`_BACKENDS`.  ``"llc"`` — the classic
VEV→VCOL→VSCAN path — is registered eagerly and is *bit-identical* to
pre-backend sessions (the default ``attach()`` path doesn't even go
through the registry, so the LLC fast path cannot regress).  It is the
only backend this package registers; :func:`register_backend` accepts
further ones, eagerly or lazily by ``"module.path:Attr"``.

Export routing: each backend declares the export ``format`` strings it
owns; :func:`backend_for_format` lets ``CacheXSession.import_`` dispatch
a snapshot to the backend that wrote it.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional, Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class ProbeTarget(Protocol):
    """The probing surface `repro_torch.core.probeplan.execute` lowers onto.

    Lane/segment contents are backend-defined: guest virtual addresses
    for the LLC backend, encoded probe descriptors for the pod backend.
    The executor never interprets them — it just dispatches.
    """

    def access(self, gvas, vcpu: int = 0) -> None: ...          # Commit (unfused)

    def access_segments(self, segments) -> None: ...            # Commit (fused)

    def wait_ms(self, ms: float) -> None: ...                   # Wait

    def warm_timer(self) -> None: ...                           # WarmTimer

    def timed_access_batch(self, lanes, vcpu=0, salt: int = 0,
                           lane_bucket: int = 128,
                           batch_bucket: int = 8): ...          # Measure/Vote


class ProbeBackend(Protocol):
    """Constructs sessions over one kind of probing target.

    ``name``     registry key (``attach(backend=name)``).
    ``formats``  export ``format`` strings this backend's sessions write
                 (import routing).
    """

    name: str
    formats: Tuple[str, ...]

    def attach(self, target, platform, config=None, eager: bool = False): ...

    def import_(self, target, data: Dict, config=None,
                allow_stale: bool = False): ...


class LLCBackend:
    """The classic GuestVM/LLC path as an explicit backend.

    Thin: it just forwards to the original ``CacheXSession``
    constructors, so going through the registry is behaviourally
    identical to the pre-backend ``attach()`` (which still short-circuits
    around the registry entirely — see ``CacheXSession.attach``)."""

    name = "llc"

    @property
    def formats(self) -> Tuple[str, ...]:
        from repro_torch.core.abstraction import _ACCEPTED_FORMATS
        return tuple(_ACCEPTED_FORMATS)

    def attach(self, target, platform, config=None, eager: bool = False):
        from repro_torch.core.abstraction import CacheXSession
        return CacheXSession.attach(target, platform, config=config,
                                    eager=eager)

    def import_(self, target, data, config=None, allow_stale: bool = False):
        from repro_torch.core.abstraction import CacheXSession
        return CacheXSession.import_(target, data, config=config,
                                     allow_stale=allow_stale)


#: name -> backend instance, or "module:attr" string resolved on first use
_BACKENDS: Dict[str, object] = {
    "llc": LLCBackend(),
}


def register_backend(name: str, backend) -> None:
    """Register a backend under ``name``.  ``backend`` may be an instance
    or a lazy ``"module.path:Attr"`` string (instantiated on first
    :func:`get_backend`)."""
    _BACKENDS[name] = backend


def list_backends() -> Sequence[str]:
    """Registered backend names (lazy entries included, unresolved)."""
    return sorted(_BACKENDS)


def get_backend(name: str):
    """Resolve a backend by name, importing lazy entries on first use."""
    try:
        entry = _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown probe backend {name!r}; registered: "
                       f"{list_backends()}") from None
    if isinstance(entry, str):
        mod, _, attr = entry.partition(":")
        entry = getattr(importlib.import_module(mod), attr)()
        _BACKENDS[name] = entry
    return entry


def backend_for_format(fmt: Optional[str]):
    """The backend whose exports carry ``format == fmt`` (``None`` when no
    registered backend claims it).  Lazy entries resolve only when their
    name hints they could match (the pod backend claims
    ``cachex-pod-*``), so LLC imports never pay the pod import."""
    for name in list(_BACKENDS):
        entry = _BACKENDS[name]
        if isinstance(entry, str):
            if not (isinstance(fmt, str) and f"-{name}-" in fmt):
                continue
            entry = get_backend(name)
        if fmt in tuple(entry.formats):
            return entry
    return None
