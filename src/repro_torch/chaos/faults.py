"""Deterministic, seeded fault injection for ``AsyncTrainer(mode="procs")``:
the port of ``repro/chaos/faults.py``.

A :class:`FaultPlan` is a pure function of its seed: a sorted tuple of
:class:`FaultEvent`, each timed as a PROGRESS FRACTION of the global
``total_trajs`` criterion (not wall seconds: progress is the one clock
every run shares, so the same plan exercises the same run phases on a
loaded host and on a fast one). For the same seed and arguments it returns
the reference's events (the same Python ``random`` draws in the same
order). Fault kinds:

* ``kill``: SIGKILL the role's child mid-flight; ``arg`` seconds of
  respawn delay keep the role DOWN before its crash-restart (a restart
  from the latest snapshot, under fire).
* ``stall``: SIGSTOP the child for ``arg`` seconds, then SIGCONT. A
  stalled model worker is the paper's slow consumer; a stalled collector
  is a robot dropping off the fleet.

:class:`ChaosSupervisor` replays the plan through the
:class:`repro_torch.core.runtime.Supervisor` seam; the trainer knows
nothing of chaos. Injection is budget-aware (a kill with no
``max_restarts`` headroom left is skipped, and recorded as skipped) and
liveness-aware (an event for a role that is down, or already stalled, is
DEFERRED to the next tick, not dropped).

Stalls end on a timer thread of their own as well as on the tick: a
collector stopped while it holds the spool's counter lock blocks any
parent call that takes that lock (a refund), and the parent's tick could
then not resume it. The stall stays bounded by its ``arg``.
"""
from __future__ import annotations

import dataclasses
import os
import random
import signal
import threading
import time
from typing import Any, Dict, List, Tuple

from repro_torch.core.runtime import Supervisor

KILL = "kill"
STALL = "stall"

_FAMILIES = ("model", "policy", "collector")


def role_family(role: str) -> str:
    """``collector:3`` -> ``collector``; learners map to themselves."""
    return "collector" if role.startswith("collector") else role


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    at: float           # progress fraction (total_pushed/total_trajs)
    kind: str           # KILL | STALL
    role: str           # "model" | "policy" | "collector:<i>"
    arg: float = 0.0    # KILL: respawn delay (s); STALL: duration (s)

    def to_dict(self) -> Dict[str, Any]:
        return {"at": self.at, "kind": self.kind, "role": self.role,
                "arg": self.arg}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded fault schedule: the same (seed, shape arguments) give the
    same plan, so a failing soak reproduces from its reported seed."""

    seed: int
    events: Tuple[FaultEvent, ...]

    @staticmethod
    def generate(seed: int, *, n_collectors: int, n_faults: int = 12,
                 max_kills_per_role: int = 3,
                 window: Tuple[float, float] = (0.05, 0.85),
                 stall_s: Tuple[float, float] = (0.15, 0.8),
                 respawn_delay_s: Tuple[float, float] = (0.0, 0.4),
                 kill_fraction: float = 0.6) -> "FaultPlan":
        """Draw ``n_faults`` events covering ALL role families.

        Whatever the seed:
        * the first three events target model, policy and a collector;
        * kills per role never exceed ``max_kills_per_role`` (keep it
          ``<= RunConfig.max_restarts`` and the plan alone cannot exhaust a
          restart budget);
        * both kinds appear (a kill-only or stall-only draw is repaired
          deterministically);
        * every ``at`` lies inside ``window``, before the criterion lands.
        """
        lo, hi = window
        assert 0.0 < lo < hi < 1.0, window
        rng = random.Random(seed)
        roles = ["model", "policy"] + \
            [f"collector:{i}" for i in range(n_collectors)]
        kills_left = {r: int(max_kills_per_role) for r in roles}
        events: List[FaultEvent] = []
        for i in range(int(n_faults)):
            if i < 3:   # one event per role family, guaranteed
                role = ("model", "policy",
                        rng.choice(roles[2:]))[i]
            else:
                role = rng.choice(roles)
            want_kill = rng.random() < kill_fraction
            at = round(rng.uniform(lo, hi), 4)
            if want_kill and kills_left[role] > 0:
                kills_left[role] -= 1
                events.append(FaultEvent(
                    at, KILL, role, round(rng.uniform(*respawn_delay_s),
                                          3)))
            else:
                events.append(FaultEvent(
                    at, STALL, role, round(rng.uniform(*stall_s), 3)))
        kinds = {e.kind for e in events}
        if STALL not in kinds and events:
            e = events[-1]
            kills_left[e.role] += 1
            events[-1] = FaultEvent(e.at, STALL, e.role,
                                    round(rng.uniform(*stall_s), 3))
        if KILL not in kinds:
            for j, e in enumerate(events):
                if kills_left[e.role] > 0:
                    kills_left[e.role] -= 1
                    events[j] = FaultEvent(
                        e.at, KILL, e.role,
                        round(rng.uniform(*respawn_delay_s), 3))
                    break
        events.sort(key=lambda e: (e.at, e.role, e.kind))
        return FaultPlan(seed=int(seed), events=tuple(events))

    def families(self) -> Tuple[str, ...]:
        return tuple(sorted({role_family(e.role) for e in self.events}))


def _signal_proc(p, sig) -> bool:
    """Deliver ``sig`` to a live child; False if it died first."""
    try:
        os.kill(p.pid, sig)
        return True
    except (ProcessLookupError, PermissionError, TypeError):
        return False


class ChaosSupervisor(Supervisor):
    """Inject a :class:`FaultPlan` through the supervision seam.

    Bookkeeping (plain dicts, JSON-ready for ``SOAK_report.json``):
    ``injected``, the faults delivered, with the progress and the
    monotonic time they fired at; ``skipped``, events dropped with a reason
    (no restart-budget headroom, or the run completed first). Deferred
    events (target down or already stalled) are retried every tick.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._queue: List[FaultEvent] = list(plan.events)
        self.injected: List[Dict[str, Any]] = []
        self.skipped: List[Dict[str, Any]] = []
        # role -> (proc, resume deadline) for stalls in flight
        self._stalls: Dict[str, Tuple[Any, float]] = {}
        self._stall_lock = threading.Lock()
        # role -> delay to apply to its NEXT crash-restart
        self._next_respawn_delay: Dict[str, float] = {}

    # ----------------------------------------------------------- seam
    def on_tick(self) -> None:
        self._resume_due()
        prog = self._progress()
        due = [e for e in self._queue if e.at <= prog]
        if not due:
            return
        deferred = []
        for ev in due:
            if not self._inject(ev, prog):
                deferred.append(ev)
        self._queue = deferred + [e for e in self._queue if e.at > prog]

    def respawn_delay(self, role: str) -> float:
        return self._next_respawn_delay.pop(role, 0.0)

    def on_complete(self) -> None:
        self._release_stalls()
        for ev in self._queue:      # whatever never became injectable
            self.skipped.append(
                {**ev.to_dict(), "reason": "run completed first"})
        self._queue.clear()

    def on_teardown(self, procs) -> None:
        # a stopped child cannot handle the teardown's stop: make every
        # child runnable again before the parent joins it
        self._release_stalls()

    # -------------------------------------------------------- internals
    def _progress(self) -> float:
        tr = self.trainer
        return tr._proc_servers["data"].total_pushed / \
            max(tr.run_cfg.total_trajs, 1)

    def _resume_due(self) -> None:
        now = time.monotonic()
        with self._stall_lock:
            for role, (p, deadline) in list(self._stalls.items()):
                if now >= deadline:
                    _signal_proc(p, signal.SIGCONT)
                    del self._stalls[role]

    def _release_stalls(self) -> None:
        with self._stall_lock:
            for role, (p, _) in list(self._stalls.items()):
                _signal_proc(p, signal.SIGCONT)
            self._stalls.clear()

    def _inject(self, ev: FaultEvent, prog: float) -> bool:
        """True when the event is finished (injected or skipped); False to
        defer it to the next tick."""
        tr = self.trainer
        p = tr._procs.get(ev.role)
        if p is None or p.exitcode is not None:
            return False            # role down / mid-respawn: defer
        if ev.role in self._stalls:
            return False            # one stall at a time per role
        if ev.kind == KILL:
            rc = tr.run_cfg
            if tr.proc_info["restarts"].get(ev.role, 0) >= rc.max_restarts:
                self.skipped.append(
                    {**ev.to_dict(),
                     "reason": f"no headroom under max_restarts="
                               f"{rc.max_restarts}"})
                return True
            self._next_respawn_delay[ev.role] = float(ev.arg)
            if not _signal_proc(p, signal.SIGKILL):
                self._next_respawn_delay.pop(ev.role, None)
                return False
            self.injected.append(
                {**ev.to_dict(), "progress": round(prog, 4),
                 "t_monotonic": time.monotonic()})
            return True
        with self._stall_lock:
            if not _signal_proc(p, signal.SIGSTOP):
                return False
            self._stalls[ev.role] = (p, time.monotonic() + float(ev.arg))
        timer = threading.Timer(float(ev.arg), self._resume_due)
        timer.daemon = True
        timer.start()
        self.injected.append(
            {**ev.to_dict(), "progress": round(prog, 4),
             "t_monotonic": time.monotonic()})
        return True

    # ---------------------------------------------------------- report
    def report(self) -> Dict[str, Any]:
        fams = sorted({role_family(f["role"]) for f in self.injected})
        return {"seed": self.plan.seed,
                "planned": [e.to_dict() for e in self.plan.events],
                "injected": list(self.injected),
                "skipped": list(self.skipped),
                "n_injected": len(self.injected),
                "families_injected": fams}
