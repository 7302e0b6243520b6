"""Chaos engine + soak harness: the port of ``repro/chaos``.

The paper's claim (async MBRL keeps learning while the real world keeps
moving) holds in practice only if the trainer survives crashes, stalls and
slow consumers WITHOUT breaking an invariant of the procs engine. This
package makes that a continuously checked property:

* :mod:`repro_torch.chaos.faults`: ``FaultPlan`` (seeded fault schedules:
  SIGKILLs across every role, fleet collectors included, SIGSTOP/SIGCONT
  stalls, delayed respawns) and ``ChaosSupervisor``, which injects a plan
  through the :class:`repro_torch.core.runtime.Supervisor` seam.
* :mod:`repro_torch.chaos.monitor`: ``InvariantMonitor``, checks DURING
  the run (exact criterion with refunds, strictly monotone versions across
  restarts, no new input shape after warm-up, bounded restart budgets).
* :mod:`repro_torch.chaos.audit`: ``ResourceAuditor``, which proves that
  nothing this process owns leaked (stores, run directories, descriptors,
  children) after a clean AND a chaotic shutdown.
* :mod:`repro_torch.chaos.soak`: the ``python -m repro_torch.chaos.soak``
  CLI tying them together, with ``micro`` / ``short`` / ``long`` profiles
  and a machine-readable ``SOAK_report.json``.
"""
from repro_torch.chaos.audit import ResourceAuditor
from repro_torch.chaos.faults import (KILL, STALL, ChaosSupervisor,
                                      FaultEvent, FaultPlan)
from repro_torch.chaos.monitor import InvariantMonitor

__all__ = ["ChaosSupervisor", "FaultEvent", "FaultPlan",
           "InvariantMonitor", "KILL", "PROFILES", "ResourceAuditor",
           "STALL", "run_soak"]


def __getattr__(name):
    # soak imports lazily: `python -m repro_torch.chaos.soak` first imports
    # this package, and an eager soak import here would import the
    # __main__ module twice (runpy's RuntimeWarning)
    if name in ("PROFILES", "run_soak"):
        from repro_torch.chaos import soak
        return getattr(soak, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
