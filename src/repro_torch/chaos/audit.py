"""Resource auditing: prove a procs run leaks NOTHING. The port of
``repro/chaos/audit.py``.

A crashed child, a store closed out of order or a forgotten handle can
strand a resource that outlives its run: a store's file, a run directory,
a pipe or socket descriptor in the parent, an orphaned child. Over an
hours-long soak those compound, so the soak counts ONE leaked resource as
a failure.

:class:`ResourceAuditor` takes a snapshot of what THIS process owns before
the run (``baseline()``) and diffs after (``audit()``):

* the port's lifetime registries (``servers.live_shm_segments`` /
  ``servers.live_data_servers``): a store constructed and never closed is
  a leak even before the kernel notices;
* the run and checkpoint directories this process's procs trainers created
  (``runtime.created_run_dirs``) that still exist;
* ``/proc/self/fd`` targets of leakable kinds (``pipe:``, ``socket:``,
  memfds, and any file under one of those directories); kernel object ids
  are unique, so a NEW pipe id still open after teardown is a leak even if
  the descriptor number was reused;
* direct children (``/proc/*/stat`` ppid scans), less multiprocessing's
  ``resource_tracker``, which lives as long as the parent.

It reads no host-wide listing: not ``/dev/shm`` (the port makes nothing
there, and other processes' entries there are not this run's) and not the
temporary directory (other processes' runs make directories there too).

``audit(settle_s=...)`` polls until clean or the settle window ends:
sockets and children close asynchronously.
"""
from __future__ import annotations

import gc
import os
import time
from typing import Any, Dict, Optional, Set

import torch

from repro_torch.core.runtime import created_run_dirs
from repro_torch.core.servers import live_data_servers, live_shm_segments

# fd targets that are IPC resources a run could leak; other kinds (files,
# devices, the event fds a runtime opens once) live as long as the process
_LEAKABLE_FD_PREFIXES = ("pipe:", "socket:", "/memfd:")


def _live_dirs() -> Set[str]:
    return {d for d in created_run_dirs() if os.path.isdir(d)}


def _fd_targets() -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        fds = os.listdir("/proc/self/fd")
    except OSError:
        return out
    for fd in fds:
        try:
            out[int(fd)] = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:     # the listing's own fd, or a racing close
            pass
    return out


def _child_procs() -> Dict[int, str]:
    """pid -> cmdline of every direct child of this process."""
    me = os.getpid()
    out: Dict[int, str] = {}
    try:
        entries = os.listdir("/proc")
    except OSError:
        return out
    for name in entries:
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            # field 4 is the ppid; comm (field 2) may hold spaces, so
            # split after the closing paren
            ppid = int(stat.rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid != me:
            continue
        try:
            with open(f"/proc/{name}/cmdline") as f:
                cmd = f.read().replace("\0", " ").strip()
        except OSError:
            cmd = "?"
        out[int(name)] = cmd
    return out


def _is_tracker(cmd: str) -> bool:
    return "resource_tracker" in cmd or "semaphore_tracker" in cmd


def warmup_ipc(device: Optional[str] = None) -> None:
    """Open the process-lifetime resources a procs run makes lazily, so
    that they are in ``baseline()`` and never read as run leaks:
    multiprocessing's resource tracker (a child and a pipe, started by the
    first spawn) and, on the card, the CUDA context (``device``; None: the
    card if there is one). Makes nothing in ``/dev/shm``; idempotent."""
    from multiprocessing import resource_tracker
    resource_tracker.ensure_running()
    dev = (torch.device(device) if device is not None else
           torch.device("cuda") if torch.cuda.is_available() else None)
    if dev is not None and dev.type == "cuda":
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    gc.collect()


class ResourceAuditor:
    def __init__(self):
        self.before: Dict[str, Any] = {}

    @staticmethod
    def snapshot() -> Dict[str, Any]:
        return {"fds": _fd_targets(), "children": _child_procs(),
                "dirs": _live_dirs()}

    def baseline(self) -> Dict[str, Any]:
        """Take the pre-run snapshot. Call AFTER ``warmup_ipc`` so that
        lazily opened process-lifetime descriptors are in it."""
        self.before = self.snapshot()
        return self.before

    def audit(self, *, settle_s: float = 3.0) -> Dict[str, Any]:
        """Diff now against the baseline; check again until clean or the
        settle window ends."""
        assert self.before, "call baseline() before audit()"
        deadline = time.monotonic() + float(settle_s)
        while True:
            # a handle kept alive only by an uncollected reference cycle
            # is pending reclamation, not leaked
            gc.collect()
            report = self._diff(self.snapshot())
            if report["ok"] or time.monotonic() >= deadline:
                return report
            time.sleep(0.1)

    def _diff(self, after: Dict[str, Any]) -> Dict[str, Any]:
        b = self.before
        leaked_dirs = sorted(after["dirs"] - b["dirs"])
        roots = tuple(d.rstrip("/") + "/" for d in created_run_dirs())
        before_targets = set(b["fds"].values())
        leaked_fds = sorted(
            f"fd {fd} -> {tgt}" for fd, tgt in after["fds"].items()
            if tgt not in before_targets
            and (tgt.startswith(_LEAKABLE_FD_PREFIXES)
                 or (roots and tgt.startswith(roots))))
        leaked_children = {
            str(pid): cmd for pid, cmd in after["children"].items()
            if pid not in b["children"] and not _is_tracker(cmd)}
        registries = {"shm_segments": list(live_shm_segments()),
                      "data_servers": int(live_data_servers())}
        ok = not (leaked_dirs or leaked_fds or leaked_children
                  or registries["shm_segments"]
                  or registries["data_servers"])
        return {"ok": ok, "leaked_dirs": leaked_dirs,
                "leaked_fds": leaked_fds,
                "leaked_children": leaked_children,
                "registries": registries}
