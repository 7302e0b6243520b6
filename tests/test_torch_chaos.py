"""The port's chaos tier (``repro_torch.chaos``) on the CPU, held against
the reference's ``repro.chaos`` where it makes no ``/dev/shm`` object.

Parity: ``FaultPlan.generate`` gives the reference's events for seeds
0-49 at several plan shapes, and ``InvariantMonitor`` raises the
reference's violations on the same stub trainers. Then the port
counterpart of every case in ``tests/test_chaos.py``: seeded plans, the
supervisor seam, the monitor on stub trainers, kill / stall / deferral on
a real child process, the resource auditor catching an fd leak and an
unclosed store (``reclaim_ipc_resources`` clears it), the stores' context
managers and registries, and the ``micro`` soak end to end. The auditor
reads no ``/dev/shm`` listing and no temporary-directory glob.
"""
import ast
import json
import os
import pathlib
import signal
import subprocess
import time

import pytest
import torch

from repro_torch.chaos import (KILL, STALL, ChaosSupervisor, FaultEvent,
                               FaultPlan, InvariantMonitor, ResourceAuditor)
from repro_torch.chaos.audit import warmup_ipc
from repro_torch.chaos.faults import role_family
from repro_torch.core import (RunConfig, Supervisor, SupervisorChain)
from repro_torch.core import servers as TS
from repro_torch.core.workers import heartbeat_slot

ROOT = pathlib.Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ fault plans
PLAN_SHAPES = [dict(n_collectors=2, n_faults=5, max_kills_per_role=2),
               dict(n_collectors=3, n_faults=14, max_kills_per_role=3),
               dict(n_collectors=1, n_faults=4, max_kills_per_role=0),
               dict(n_collectors=2, n_faults=3, max_kills_per_role=1,
                    kill_fraction=1.0)]


@pytest.mark.parametrize("kw", PLAN_SHAPES,
                         ids=["micro", "short", "no_kills", "all_kills"])
def test_fault_plans_equal_the_references_for_seeds_0_to_49(kw):
    from repro.chaos.faults import FaultPlan as JPlan
    for seed in range(50):
        got = FaultPlan.generate(seed, **kw)
        want = JPlan.generate(seed, **kw)
        assert [e.to_dict() for e in got.events] == \
            [e.to_dict() for e in want.events], seed
        assert got.families() == want.families()


def test_fault_plan_deterministic_and_covering():
    kw = dict(n_collectors=3, n_faults=14, max_kills_per_role=3)
    p1 = FaultPlan.generate(7, **kw)
    p2 = FaultPlan.generate(7, **kw)
    assert p1 == p2, "same seed must give an identical plan"
    assert FaultPlan.generate(8, **kw) != p1, "seeds must differ"
    assert len(p1.events) == 14
    assert p1.families() == ("collector", "model", "policy")
    assert {e.kind for e in p1.events} == {KILL, STALL}
    kills = {}
    for e in p1.events:
        assert 0.05 <= e.at <= 0.85
        if e.kind == KILL:
            kills[e.role] = kills.get(e.role, 0) + 1
    assert kills and max(kills.values()) <= 3
    ats = [e.at for e in p1.events]
    assert ats == sorted(ats)


def test_fault_plan_covers_all_families_for_many_seeds():
    for seed in range(20):
        p = FaultPlan.generate(seed, n_collectors=2, n_faults=5,
                               max_kills_per_role=2)
        assert p.families() == ("collector", "model", "policy"), seed


# ------------------------------------------------------- supervisor seam
class _Recording(Supervisor):
    def __init__(self, delay=0.0):
        self.calls = []
        self.delay = delay

    def attach(self, trainer):
        super().attach(trainer)
        self.calls.append("attach")

    def detach(self):
        super().detach()
        self.calls.append("detach")

    def on_tick(self):
        self.calls.append("tick")

    def respawn_delay(self, role):
        return self.delay


def test_supervisor_chain_fans_out_and_maxes_delay():
    a, b = _Recording(delay=0.2), _Recording(delay=0.7)
    chain = SupervisorChain(a, b)
    chain.attach(object())
    chain.on_tick()
    assert chain.respawn_delay("model") == 0.7, \
        "chain must take the MAX member delay"
    chain.detach()
    for m in (a, b):
        assert m.calls == ["attach", "tick", "detach"]
        assert m.trainer is None


def test_supervisor_rejected_outside_procs_mode():
    from repro_torch.core import AsyncTrainer
    with pytest.raises(ValueError, match="procs"):
        AsyncTrainer(None, None, None, mode="event",
                     supervisor=Supervisor())


# ------------------------------------------------- monitor (stub trainer)
class _FakeSrv:
    def __init__(self, version=0):
        self.version = version


class _FakeData:
    def __init__(self, pushed=0):
        self.total_pushed = pushed


class _FakeChannels:
    def __init__(self):
        self.beats = {}

    def read_heartbeat(self, slot):
        return self.beats.get(slot, (0.0, 0.0))


class _FakeTrainer:
    def __init__(self, rc):
        self.run_cfg = rc
        self._proc_servers = {"model": _FakeSrv(), "policy": _FakeSrv(),
                              "data": _FakeData()}
        self.proc_info = {"restarts": {"model": 0, "policy": 0,
                                       "collector:0": 0}}
        self._proc_channels = _FakeChannels()


def _monitored(rc=None, cls=InvariantMonitor, total=10):
    tr = _FakeTrainer(rc or RunConfig(total_trajs=total, max_restarts=2))
    mon = cls(check_every_s=0.0)
    mon.attach(tr)
    return tr, mon


def test_monitor_clean_run_has_no_violations():
    tr, mon = _monitored()
    tr._proc_servers["model"].version = 3
    tr._proc_servers["data"].total_pushed = 10
    mon.on_tick()
    mon.on_complete()
    assert mon.violations == []
    assert mon.report()["stats"]["final"]["total_pushed"] == 10


def test_monitor_flags_version_regression():
    tr, mon = _monitored()
    tr._proc_servers["model"].version = 5
    mon.on_tick()
    tr._proc_servers["model"].version = 2     # a restart reset the word
    mon.on_tick()
    assert any("BACKWARDS" in v for v in mon.violations)


def test_monitor_flags_criterion_overshoot_and_miss():
    tr, mon = _monitored()
    tr._proc_servers["data"].total_pushed = 11      # > total_trajs=10
    mon.on_tick()
    assert any("OVERSHOT" in v for v in mon.violations)
    tr2, mon2 = _monitored()
    tr2._proc_servers["data"].total_pushed = 9      # landed short
    mon2.on_complete()
    assert any("criterion missed" in v for v in mon2.violations)


def test_monitor_flags_retrace_and_budget():
    tr, mon = _monitored()
    slot = heartbeat_slot("model", tr.run_cfg.n_collectors)
    tr._proc_channels.beats[slot] = (1.0, 3.0)      # 3 shapes, cap 1
    tr.proc_info["restarts"]["collector:0"] = 99
    mon.on_tick()
    assert any("RETRACED" in v for v in mon.violations)
    assert any("restart budget" in v for v in mon.violations)
    # unknown compile counts (-1) are not violations
    tr2, mon2 = _monitored()
    slot2 = heartbeat_slot("policy", tr2.run_cfg.n_collectors)
    tr2._proc_channels.beats[slot2] = (1.0, -1.0)
    mon2.on_tick()
    assert mon2.violations == []


def _drive(tr, mon, script):
    """Apply each (what, value) of ``script`` to the stub trainer, with a
    tick after each, then complete."""
    for what, value in script:
        if what in ("model", "policy"):
            tr._proc_servers[what].version = value
        elif what == "pushed":
            tr._proc_servers["data"].total_pushed = value
        elif what == "restarts":
            tr.proc_info["restarts"]["collector:0"] = value
        else:                       # "compiles:<role>"
            slot = heartbeat_slot(what.split(":", 1)[1],
                                  tr.run_cfg.n_collectors)
            tr._proc_channels.beats[slot] = (1.0, float(value))
        mon.on_tick()
    mon.on_complete()
    return [v.split(" (")[0] for v in mon.violations]


SCRIPTS = {
    "clean": [("model", 3), ("policy", 2), ("pushed", 10)],
    "regression": [("model", 5), ("policy", 4), ("model", 2), ("policy", 1),
                   ("pushed", 10)],
    "overshoot": [("pushed", 11)],
    "miss": [("pushed", 9)],
    "retrace": [("model", 1), ("policy", 2), ("compiles:collector:0", 2),
                ("compiles:model", 2), ("pushed", 10)],
    "budget": [("restarts", 3), ("pushed", 10)],
    "unknown": [("compiles:policy", -1), ("pushed", 10)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_monitor_raises_the_references_violations(name):
    from repro.chaos.monitor import InvariantMonitor as JMonitor
    tr, mon = _monitored()
    jtr, jmon = _monitored(cls=JMonitor)
    got = _drive(tr, mon, SCRIPTS[name])
    want = _drive(jtr, jmon, SCRIPTS[name])
    assert got == want
    assert (got == []) == (name in ("clean", "unknown"))
    assert mon.stats["max_versions"] == jmon.stats["max_versions"]
    assert mon.stats["max_compiles"] == jmon.stats["max_compiles"]


# ------------------------------------------ chaos injection on a child
class _PopenProc:
    """A subprocess with the surface of ``mp.Process`` that chaos uses."""

    def __init__(self, argv=("sleep", "60")):
        self._p = subprocess.Popen(argv)
        self.pid = self._p.pid

    @property
    def exitcode(self):
        return self._p.poll()

    def kill(self):
        try:
            self._p.kill()
        except OSError:
            pass
        self._p.wait()


def _chaos_trainer(procs, total=10, pushed=5, max_restarts=2):
    tr = _FakeTrainer(RunConfig(total_trajs=total,
                                max_restarts=max_restarts))
    tr._procs = procs
    tr._proc_servers["data"].total_pushed = pushed
    return tr


def _state(p):
    with open(f"/proc/{p.pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0]


def _wait(cond, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def test_chaos_kill_injection_and_respawn_delay():
    p = _PopenProc()
    try:
        plan = FaultPlan(seed=0, events=(
            FaultEvent(at=0.1, kind=KILL, role="model", arg=0.25),))
        sup = ChaosSupervisor(plan)
        sup.attach(_chaos_trainer({"model": p}))
        sup.on_tick()       # progress 0.5 >= 0.1: fires
        assert len(sup.injected) == 1
        assert _wait(lambda: p.exitcode is not None, 10)
        assert p.exitcode == -signal.SIGKILL
        assert sup.respawn_delay("model") == 0.25
        assert sup.respawn_delay("model") == 0.0    # one-shot
    finally:
        p.kill()


def test_chaos_stall_then_resume():
    p = _PopenProc()
    try:
        plan = FaultPlan(seed=0, events=(
            FaultEvent(at=0.1, kind=STALL, role="model", arg=0.2),))
        sup = ChaosSupervisor(plan)
        sup.attach(_chaos_trainer({"model": p}))
        sup.on_tick()
        assert sup.injected and sup.injected[0]["kind"] == STALL
        assert _wait(lambda: _state(p) == "T"), "child not SIGSTOPped"
        time.sleep(0.25)
        sup.on_tick()       # stall expired: SIGCONT
        assert _wait(lambda: _state(p) != "T"), "child never resumed"
        assert p.exitcode is None
    finally:
        p.kill()


def test_chaos_stall_ends_without_a_tick():
    """A parent blocked on a lock the stopped child holds cannot tick: the
    stall's own timer resumes the child."""
    p = _PopenProc()
    try:
        sup = ChaosSupervisor(FaultPlan(seed=0, events=(
            FaultEvent(at=0.1, kind=STALL, role="collector:0", arg=0.2),)))
        sup.attach(_chaos_trainer({"collector:0": p}))
        sup.on_tick()
        assert _wait(lambda: _state(p) == "T")
        assert _wait(lambda: _state(p) != "T"), "no resume without a tick"
        assert not sup._stalls
    finally:
        p.kill()


def test_chaos_skips_kill_without_budget_headroom_and_defers_when_down():
    kill_model = FaultEvent(at=0.1, kind=KILL, role="model", arg=0.0)
    # no headroom: restarts already at max_restarts -> skipped, loudly
    dead = _FakeTrainer(RunConfig(total_trajs=10, max_restarts=2))
    dead._procs = {"model": _PopenProc()}
    try:
        dead._proc_servers["data"].total_pushed = 5
        dead.proc_info["restarts"]["model"] = 2
        sup = ChaosSupervisor(FaultPlan(seed=0, events=(kill_model,)))
        sup.attach(dead)
        sup.on_tick()
        assert not sup.injected
        assert sup.skipped and "headroom" in sup.skipped[0]["reason"]
    finally:
        dead._procs["model"].kill()

    # role currently down (exitcode set) -> deferred, not dropped
    class _DeadProc:
        pid = 1
        exitcode = -9
    tr = _chaos_trainer({"model": _DeadProc()})
    sup = ChaosSupervisor(FaultPlan(seed=0, events=(kill_model,)))
    sup.attach(tr)
    sup.on_tick()
    assert not sup.injected and not sup.skipped
    assert len(sup._queue) == 1
    sup.on_complete()       # the run ends first: flushed as skipped
    assert sup.skipped and "completed" in sup.skipped[0]["reason"]
    assert sup.report()["n_injected"] == 0


# ------------------------------------------------------- resource audit
def test_auditor_catches_fd_leak_then_clean():
    warmup_ipc("cpu")
    auditor = ResourceAuditor()
    auditor.baseline()
    r, w = os.pipe()
    report = auditor.audit(settle_s=0.3)
    assert not report["ok"]
    assert any("pipe:" in f for f in report["leaked_fds"])
    os.close(r)
    os.close(w)
    assert auditor.audit(settle_s=2.0)["ok"]


def test_auditor_catches_unclosed_store_then_reclaim(tmp_path):
    warmup_ipc("cpu")
    auditor = ResourceAuditor()
    auditor.baseline()
    srv = TS.ShmParameterServer({"w": torch.zeros(4)}, dir=str(tmp_path))
    data = TS.ProcDataServer(n_collectors=1, dir=str(tmp_path))
    srv.push({"w": torch.ones(4)})       # the writer maps and locks
    report = auditor.audit(settle_s=0.3)
    assert not report["ok"]
    assert report["registries"]["shm_segments"] == [srv.path], \
        "unclosed ShmParameterServer missing from the audit registry"
    assert report["registries"]["data_servers"] == 1
    assert TS.reclaim_ipc_resources() == 2
    report = auditor.audit(settle_s=2.0)
    assert report["ok"], report
    assert not os.path.exists(srv.path)


def test_auditor_reads_no_host_wide_listing():
    """Outside its docstrings the auditor names no ``/dev/shm`` and globs
    no temporary directory: it audits only what this process owns."""
    tree = ast.parse((ROOT / "src" / "repro_torch" / "chaos"
                      / "audit.py").read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef,
                                 ast.ClassDef))
            and ast.get_docstring(node) is not None}
    strings = [n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)
               and id(n) not in docs]
    assert strings and not any("/dev/shm" in s or "/tmp" in s
                               for s in strings)
    attrs = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert not attrs & {"glob", "iglob", "gettempdir", "scandir"}


# ------------------------------------- context managers + registries
def test_shm_server_context_manager_and_registry(tmp_path):
    base = TS.live_shm_segments()
    with TS.ShmParameterServer({"w": torch.zeros(2)},
                               dir=str(tmp_path)) as srv:
        assert len(TS.live_shm_segments()) == len(base) + 1
        srv.push({"w": torch.ones(2)})
        assert srv.version == 1
    assert TS.live_shm_segments() == base
    srv.close()     # idempotent


def test_proc_data_server_context_manager_and_registry(tmp_path):
    base = TS.live_data_servers()
    with TS.ProcDataServer(n_collectors=2, target=4,
                           dir=str(tmp_path)) as ds:
        assert TS.live_data_servers() == base + 1
        assert ds.try_claim(0, k=4) == 4
    assert TS.live_data_servers() == base
    ds.close()      # idempotent
    assert ds.total_pushed == 0     # counters stay readable after close


# ------------------------------------------------------ end-to-end soak
SOAK_KEYS = {"profile", "seed", "config", "started_unix", "runs", "aborted",
             "wall_s", "totals", "required", "problems", "ok"}
RUN_KEYS = {"kind", "seed", "wall_s", "error", "trace_rows", "trajs",
            "model_version", "policy_version", "restarts", "monitor",
            "faults", "audit"}


@pytest.mark.slow
@pytest.mark.timeout(150)
@pytest.mark.parametrize("transport", ["shm", "tcp"])
def test_soak_micro_end_to_end(tmp_path, transport):
    """The micro chaos profile: a real procs run under seeded kills and
    stalls completes with zero violations and zero leaks, over either
    transport, and the report has the reference's keys."""
    from repro_torch.chaos.soak import main
    out = tmp_path / "SOAK_report.json"
    code = main(["--profile", "micro", "--seed", "0", "--out", str(out),
                 "--device", "cpu", "--transport", transport])
    rep = json.loads(out.read_text())
    assert code == 0 and rep["ok"], rep["problems"]
    assert set(rep) == SOAK_KEYS
    (run,) = rep["runs"]
    assert set(run) == RUN_KEYS
    assert run["error"] is None
    assert run["monitor"]["violations"] == []
    assert run["audit"]["ok"], run["audit"]
    injected = run["faults"]["injected"]
    assert len(injected) >= 3
    assert {role_family(f["role"]) for f in injected} == \
        {"collector", "model", "policy"}
    assert run["trajs"] == rep["config"]["total_trajs"], \
        "chaos run missed the exact criterion"
    assert run["model_version"] >= 1 and run["policy_version"] >= 1


def test_soak_raises_without_a_card_and_never_falls_back(tmp_path):
    from repro_torch.chaos.soak import run_soak
    if torch.cuda.is_available():
        pytest.skip("a card is present: the soak runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_soak("micro", 0, out=str(tmp_path / "r.json"))
    assert not (tmp_path / "r.json").exists()


# ------------------------------------------------------- chip_smoke.py
@pytest.fixture
def kernel_stand_ins(monkeypatch):
    """The card's ``gmm_equal`` and ``imag_fused`` wrappers replaced by
    their plain versions under ``no_grad``, both dispatchers routed to them
    and the counters from 0 (in this process: spawned children run the
    plain route and launch nothing); ``torch.cuda.synchronize`` a
    no-op."""
    from repro_torch.kernels.gmm import cuda as gmm_cuda
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.imag import cuda as imag_cuda
    from repro_torch.kernels.imag import ops as imag_ops
    from repro_torch.kernels.imag import ref as imag_ref

    def gmm_equal(a, b):
        with torch.no_grad():
            return torch.matmul(a, b)

    def fused_step_sorted(members, norm, pol, s, eps, offsets):
        sizes = (offsets[1:] - offsets[:-1]).long()
        gid = torch.repeat_interleave(torch.arange(sizes.numel()), sizes)
        with torch.no_grad():
            return imag_ref.fused_step(members, norm, pol, s, eps, gid)

    monkeypatch.setattr(gmm_ops, "_use_kernel", lambda t, impl: impl != "ref")
    monkeypatch.setattr(gmm_cuda, "gmm_equal", gmm_equal)
    monkeypatch.setattr(imag_ops, "uses_kernel",
                        lambda t, impl=None: impl != "ref")
    monkeypatch.setattr(imag_cuda, "fused_step_sorted", fused_step_sorted)
    for name in ("equal_launches", "equal_bwd_launches"):
        monkeypatch.setattr(gmm_ops, name, 0)
    monkeypatch.setattr(imag_ops, "launches", 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return gmm_ops, imag_ops


IMAGINE_HORIZON = 10


def _chip_parts():
    from repro_torch.envs import make_env
    from repro_torch.mbrl import algos as TA
    from repro_torch.mbrl import dynamics as TD
    from repro_torch.mbrl import policy as TPI
    env = make_env("pendulum")
    ens = TD.EnsembleConfig(env.obs_dim, env.act_dim, hidden=32, n_models=2)
    pol = TPI.PolicyConfig(env.obs_dim, env.act_dim, hidden=16)
    acfg = TA.AlgoConfig(algo="me-trpo", imagine_batch=8,
                         imagine_horizon=IMAGINE_HORIZON, n_models=2)
    return env, ens, acfg, TA.make_algo(acfg, pol, env.reward,
                                        env.reset_batch)


class _NoSmi:
    """``chip_smoke.UtilSampler`` without ``nvidia-smi``."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def record(self):
        return {}


@pytest.mark.slow
@pytest.mark.timeout(240)
def test_chip_smoke_tcp_and_chaos_phases_count_and_check_on_the_cpu(
        kernel_stand_ins, monkeypatch, tmp_path):
    """A rehearsal of ``threads_tcp``, ``procs_tcp_join`` and ``chaos_run``
    at small sizes: each phase's checks pass (the procs children on the
    plain route, launching nothing), and the records serialise."""
    import importlib.util
    gmm_ops, imag_ops = kernel_stand_ins
    spec = importlib.util.spec_from_file_location("chip_smoke_chaos",
                                                  ROOT / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    monkeypatch.setattr(chip, "engine_parts", _chip_parts)
    monkeypatch.setattr(chip, "ENGINE_TRAJS", 12)
    monkeypatch.setattr(chip, "THREADS_SPEED", 20.0)
    monkeypatch.setattr(chip, "LEARN_ENV", "pendulum")
    monkeypatch.setattr(chip, "POLICY_HIDDEN", 16)
    monkeypatch.setattr(chip, "CHILD_ROUTE", "plain")
    monkeypatch.setattr(chip, "UtilSampler", _NoSmi)
    monkeypatch.setattr(chip, "ROOT", tmp_path)
    monkeypatch.setattr(chip, "PROCS_PACED", dict(
        total_trajs=8, pace_collection=True, collect_speed=20.0,
        min_final_policy_version=2))
    tcp = chip.threads_tcp(gmm_ops, imag_ops, device="cpu")
    assert tcp["trajs"] == 12 and tcp["net_info"]["trajs"] == 12
    assert tcp["imag_fused_launches"] == \
        tcp["policy_steps"] * IMAGINE_HORIZON > 0
    assert tcp["gmm_equal_launches"] > 0
    for pulls in tcp["pulls"].values():
        assert pulls["unchanged"] > 0 and pulls["unchanged_bytes"] == 0
    joined = chip.procs_tcp_join(gmm_ops, imag_ops, device="cpu")
    assert joined["trajs"] == 8 and joined["joined_trajs"] >= 1
    assert min(int(k) for k in joined["joined"]) >= 1
    assert sum(joined["trajs_per_collector"]) + joined["joined_trajs"] == 8
    chaos = chip.chaos_run(gmm_ops, imag_ops, device="cpu")
    assert chaos["trajs"] == 8 and chaos["audit"]["ok"]
    assert len(chaos["faults"]) >= 3
    assert chaos["families"] == ["collector", "model", "policy"]
    assert chaos["restarted_learners"]
    assert all(r["last_work"] > 0
               for r in chaos["restarted_learners"].values())
    json.dumps([tcp, joined, chaos])
