"""Invariant monitoring DURING a procs-mode run: the port of
``repro/chaos/monitor.py``.

Every invariant the tests check after a run is checked here while the run
is live, from the parent's supervision loop, through the
:class:`repro_torch.core.runtime.Supervisor` seam:

* **Exact criterion**: ``total_pushed`` never exceeds ``total_trajs``
  mid-run (refunds cannot overshoot), and lands EXACTLY on it at
  completion (crash refunds cannot undershoot).
* **Monotone versions**: the version words of both parameter stores only
  increase, across child crash-restarts too (the word lives in the store,
  so a restarted writer continues the sequence).
* **No retrace after warm-up**: each child publishes its
  ``compile_count`` (the distinct input shapes of its hot path, the port's
  stand-in for the reference's compile count) in its heartbeat; each role
  has a cap (model 1, policy 1, collector 1, or 2 with an env farm, whose
  final partial grant may run the one-robot rollout). The policy child's
  warm-up ``improve`` runs the steps' shapes, so it adds none.
* **Bounded restarts**: per-role crash counts never exceed
  ``max_restarts`` (the supervisor raises above it, so seeing it here
  means the budget check broke).

Violations accumulate as strings in ``.violations``; empty at the end of a
chaotic run is the soak's core pass criterion. A child stopped by a chaos
stall only pauses the counters; it is no violation.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

from repro_torch.core.runtime import Supervisor
from repro_torch.core.workers import heartbeat_slot


class InvariantMonitor(Supervisor):
    def __init__(self, *, check_every_s: float = 0.05):
        self.check_every_s = float(check_every_s)
        self.violations: List[str] = []
        self.stats: Dict[str, Any] = {}

    def attach(self, trainer) -> None:
        super().attach(trainer)
        rc = trainer.run_cfg
        self._collector_cap = 1 if rc.envs_per_collector == 1 else 2
        self._seen_versions = {"model": 0, "policy": 0}
        self._next_check = 0.0
        self.stats = {"ticks": 0, "checks": 0, "child_exits": [],
                      "max_compiles": {}, "max_versions": {},
                      "final": {}}

    # ----------------------------------------------------------- seam
    def on_tick(self) -> None:
        self.stats["ticks"] += 1
        now = time.monotonic()
        if now < self._next_check:
            return
        self._next_check = now + self.check_every_s
        self.stats["checks"] += 1
        self._check_versions()
        self._check_criterion_bound()
        self._check_budgets()
        self._check_compiles()

    def on_child_exit(self, role, exitcode, n_restarts) -> None:
        self.stats["child_exits"].append(
            {"role": role, "exitcode": int(exitcode),
             "n_restarts": int(n_restarts)})

    def on_complete(self) -> None:
        """At completion the criterion must land EXACTLY."""
        tr = self.trainer
        rc = tr.run_cfg
        data = tr._proc_servers["data"]
        pushed = data.total_pushed
        if pushed != rc.total_trajs:
            self._violate(
                f"criterion missed: run completed with total_pushed="
                f"{pushed}, expected exactly {rc.total_trajs}")
        self._check_versions()
        self._check_compiles()
        self.stats["final"] = {
            "total_pushed": int(pushed),
            "model_version": int(tr._proc_servers["model"].version),
            "policy_version": int(tr._proc_servers["policy"].version),
            "restarts": dict(tr.proc_info["restarts"])}

    # -------------------------------------------------------- checks
    def _violate(self, msg: str) -> None:
        if msg not in self.violations:
            self.violations.append(msg)

    def _check_versions(self) -> None:
        srv = self.trainer._proc_servers
        for name in ("model", "policy"):
            v = int(srv[name].version)
            seen = self._seen_versions[name]
            if v < seen:
                self._violate(
                    f"{name} version went BACKWARDS: {seen} -> {v} "
                    "(a restart must republish at a version >= the "
                    "snapshot's, never reset the store's version word)")
            self._seen_versions[name] = max(v, seen)
            self.stats["max_versions"][name] = self._seen_versions[name]

    def _check_criterion_bound(self) -> None:
        tr = self.trainer
        pushed = tr._proc_servers["data"].total_pushed
        if pushed > tr.run_cfg.total_trajs:
            self._violate(
                f"criterion OVERSHOT mid-run: total_pushed={pushed} > "
                f"total_trajs={tr.run_cfg.total_trajs} (ticket claims / "
                "crash refunds let extra trajectories through)")

    def _check_budgets(self) -> None:
        rc = self.trainer.run_cfg
        for role, n in self.trainer.proc_info["restarts"].items():
            if n > rc.max_restarts:
                self._violate(
                    f"restart budget exceeded silently: {role} at "
                    f"{n} > max_restarts={rc.max_restarts} without the "
                    "supervisor failing the run")

    def _check_compiles(self) -> None:
        tr = self.trainer
        rc = tr.run_cfg
        ch = tr._proc_channels
        for role in tr.proc_info["restarts"]:
            cap = (self._collector_cap if role.startswith("collector")
                   else 1)
            slot = heartbeat_slot(role, rc.n_collectors)
            _beat, compiles = ch.read_heartbeat(slot)
            c = int(compiles)
            if c < 0:
                continue    # the worker cannot tell: unknown, not a fault
            seen = self.stats["max_compiles"].get(role, 0)
            self.stats["max_compiles"][role] = max(seen, c)
            if c > cap:
                self._violate(
                    f"{role} RETRACED after warmup: compile count {c} > "
                    f"cap {cap} (a new input shape in the child's hot "
                    "path)")

    # ---------------------------------------------------------- report
    def report(self) -> Dict[str, Any]:
        return {"violations": list(self.violations),
                "stats": dict(self.stats)}
