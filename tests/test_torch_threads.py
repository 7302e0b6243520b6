"""The port's threads engine (``AsyncTrainer(mode="threads")``) and what it
stands on, on the CPU at the reference tests' small widths (pendulum).

The threads cases are the reference's (``tests/test_runtime.py``,
``tests/test_fleet.py``, ``tests/test_env_farm.py``) run on the port: the
smoke run, relative and monotone trace times, N = 3 collectors landing
exactly on ``total_trajs``, a farm whose batch does not divide the target,
a whole-fleet sabotage raised from the main thread; then pacing (wall time
at least trajectories x robot time / ``collect_speed``), a failing learner,
and every thread joined. The schedule of real threads is not
deterministic, so nothing here compares a trace with the reference's.

Then the two repairs threads need: ``kernels.build.load`` builds a source
once when many threads reach its first launch together (``nvcc`` stood in
by a fake process), and the kernels' launch counters stay exact when many
threads launch at once. Then the launcher's ``--mode threads``, the
``torch_async_vs_sync`` example and a CPU rehearsal of ``chip_smoke.py``'s
threads phases with the kernels stood in by their plain versions. Every
test is bounded by ``pytest.mark.timeout`` and joins its threads with a
timeout; none starts a process.
"""
import importlib.util
import json
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import runtime as TR
from repro_torch.envs import make_env
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import cuda as fa_cuda
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.gmm import cuda as gmm_cuda
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.imag import cuda as imag_cuda
from repro_torch.kernels.imag import ops as imag_ops
from repro_torch.kernels.imag import ref as imag_ref
from repro_torch.kernels.ssd import cuda as ssd_cuda
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import train as launch
from repro_torch.mbrl import algos as TA
from repro_torch.mbrl import dynamics as TD
from repro_torch.mbrl import policy as TPI

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the reference's tests/test_runtime.py sizes, imagination cut further
HIDDEN, N_MODELS, POLICY_HIDDEN = 32, 2, 16
IMAGINE_BATCH, IMAGINE_HORIZON = 8, 10


def _parts():
    env = make_env("pendulum")
    ens = TD.EnsembleConfig(env.obs_dim, env.act_dim, hidden=HIDDEN,
                            n_models=N_MODELS)
    pol = TPI.PolicyConfig(env.obs_dim, env.act_dim, hidden=POLICY_HIDDEN)
    acfg = TA.AlgoConfig(algo="me-trpo", imagine_batch=IMAGINE_BATCH,
                         imagine_horizon=IMAGINE_HORIZON, n_models=N_MODELS)
    return env, ens, acfg, TA.make_algo(acfg, pol, env.reward,
                                        env.reset_batch)


def _trainer(rc_kw, **kw):
    env, ens, _, algo = _parts()
    rc = TR.RunConfig(seed=0, eval_rollouts=2, **rc_kw)
    return TR.AsyncTrainer(env, ens, algo, rc, mode="threads", device="cpu",
                           **kw)


def _engine_threads():
    return [th for th in threading.enumerate()
            if th.name.startswith("collect:") or th.name in ("model",
                                                             "policy")]


# ------------------------------------------------ the reference's cases
@pytest.mark.timeout(120)
def test_threads_mode_smoke():
    tr = _trainer(dict(total_trajs=3))
    trace = tr.run()
    assert tr.collector.collected == 3 and trace[-1]["trajs"] == 3
    assert tr.data_server.total_pushed == 3
    assert not _engine_threads()


@pytest.mark.timeout(120)
def test_threads_trace_times_relative_and_monotonic():
    tr = _trainer(dict(total_trajs=4, eval_every_policy_steps=1))
    t0 = time.monotonic()
    trace = tr.run()
    wall = time.monotonic() - t0
    times = [r["time"] for r in trace]
    assert all(0.0 <= t <= wall for t in times), (times, wall)
    assert times == sorted(times)
    assert all(np.isfinite(r["eval_return"]) for r in trace)


@pytest.mark.timeout(120)
def test_threads_fleet_criterion_exact():
    tr = _trainer(dict(total_trajs=6), n_collectors=3)
    trace = tr.run()
    assert tr.data_server.total_pushed == 6
    assert sum(c.collected for c in tr.collectors) == 6
    assert trace and trace[-1]["trajs"] == 6


class _Exploding:
    """An env whose rollouts raise, everything else delegated."""

    def __init__(self, env):
        self._env = env

    def __getattr__(self, name):
        return getattr(self._env, name)

    def rollout_batch(self, *args, **kw):
        raise RuntimeError("rollout exploded")


@pytest.mark.timeout(120)
def test_threads_collector_failure_is_loud():
    """A collector thread dying mid-run fails the run from the main
    thread; the whole fleet is sabotaged, since the schedule decides which
    member claims first."""
    tr = _trainer(dict(total_trajs=6), n_collectors=2)
    for c in tr.collectors:
        c.env = _Exploding(c.env)
    with pytest.raises(RuntimeError, match=r"collector \d+ failed") as exc:
        tr.run()
    assert "rollout exploded" in str(exc.value.__cause__)
    assert not _engine_threads()


@pytest.mark.timeout(120)
def test_threads_farm_exact_criterion_b_not_dividing():
    tr = _trainer(dict(total_trajs=9), n_collectors=2, envs_per_collector=4)
    trace = tr.run()
    assert tr.data_server.total_pushed == 9
    assert sum(c.collected for c in tr.collectors) == 9
    assert trace and trace[-1]["trajs"] == 9


# --------------------------------------------------------- beyond them
@pytest.mark.timeout(60)
def test_pace_collection_holds_the_robots_rate():
    """Four paced trajectories of 200 x 0.05 s robot time at
    ``collect_speed=20``: 0.5 s each, so at least 2 s of wall time."""
    tr = _trainer(dict(total_trajs=4, pace_collection=True,
                       collect_speed=20.0))
    t0 = time.monotonic()
    trace = tr.run()
    wall = time.monotonic() - t0
    env = tr.env
    assert wall >= 4 * env.horizon * env.dt / 20.0
    assert trace[-1]["time"] >= 2.0 and trace[-1]["trajs"] == 4


@pytest.mark.timeout(60)
def test_unpaced_run_is_not_held_to_robot_time():
    tr = _trainer(dict(total_trajs=2))
    tr.run()
    env = tr.env
    # two 10 s trajectories simulated well under their robot time
    assert tr.recorder.trace[-1]["time"] < 2 * env.horizon * env.dt


@pytest.mark.timeout(60)
@pytest.mark.parametrize("role", ["model", "policy"])
def test_threads_learner_failure_is_loud(role):
    tr = _trainer(dict(total_trajs=3))
    worker = tr.model_worker if role == "model" else tr.policy_worker

    def boom():
        raise RuntimeError(f"{role} exploded")
    worker.step = boom
    with pytest.raises(RuntimeError, match=f"the {role} worker failed"):
        tr.run()
    assert not _engine_threads()


def test_threads_mode_on_the_cpu_gives_no_role_stream():
    tr = _trainer(dict(total_trajs=1))
    assert tr._role_streams(["collect:0", "model"]) == {"collect:0": None,
                                                        "model": None}


# ------------------------------------------------- build.load under threads
class _FakeNvcc:
    """Stands in for ``subprocess.Popen([nvcc, ..., "-o", out, src])``:
    writes ``out`` after a short delay, so racing builders overlap."""
    started = 0
    lock = threading.Lock()

    def __init__(self, cmd, **kw):
        with _FakeNvcc.lock:
            _FakeNvcc.started += 1
        self.out = pathlib.Path(cmd[cmd.index("-o") + 1])
        self.returncode = None

    def communicate(self):
        time.sleep(0.05)
        self.out.write_bytes(b"library")
        self.returncode = 0
        return "ptxas info: Used 32 registers", None

    def poll(self):
        return self.returncode


@pytest.mark.timeout(60)
def test_load_builds_a_source_once_under_concurrent_first_use(
        tmp_path, monkeypatch):
    source = tmp_path / "stand_in.cu"
    source.write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_FakeNvcc, "started", 0)
    loaded = []
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: loaded.append(path) or object())
    barrier = threading.Barrier(8)
    got = []

    def first_launch():
        barrier.wait(timeout=10)
        got.append(build.load(source))

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert _FakeNvcc.started == 1 and len(loaded) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert build.library_path(source).read_bytes() == b"library"
    assert not list((tmp_path / "build").glob("*.tmp"))


# ------------------------------------------- launch counters under threads
def _equal(monkeypatch):
    monkeypatch.setattr(gmm_cuda, "gmm_equal", lambda a, b: a)
    a = torch.ones(1, 2, 2)
    return (lambda: gmm_ops._kernel_equal(a, a),
            lambda: gmm_ops._kernel_equal(a, a, backward=True),
            lambda: gmm_ops.equal_launches + gmm_ops.equal_bwd_launches)


def _ragged(monkeypatch):
    monkeypatch.setattr(gmm_cuda, "gmm_ragged", lambda l, r, o: l)
    monkeypatch.setattr(gmm_cuda, "gmm_ragged_dw", lambda a, b, o: a)
    a = torch.ones(2, 2)
    return (lambda: gmm_ops._kernel_ragged(a, a, None),
            lambda: (gmm_ops._kernel_ragged(a, a, None, backward=True),
                     gmm_ops._kernel_ragged_t(a, a, None)),
            lambda: (gmm_ops.ragged_launches + gmm_ops.ragged_bwd_launches
                     + gmm_ops.ragged_dw_launches))


def _imag(monkeypatch):
    monkeypatch.setattr(imag_cuda, "fused_step_sorted", lambda *a: a[4])
    s = torch.ones(2, 2)
    launch_one = (lambda: imag_ops.kernel_sorted(None, None, None, None,
                                                 None, s, None))
    return launch_one, launch_one, lambda: imag_ops.launches


def _flash(monkeypatch):
    monkeypatch.setattr(fa_cuda, "flash_attention", lambda q, k, v, **kw: q)
    q = torch.ones(1, 2, 1, 4)
    launch_one = (lambda: fa_ops.FlashAttention.apply(q, q, q, True, 0,
                                                      None))
    return launch_one, launch_one, lambda: fa_ops.launches


def _ssd(monkeypatch):
    monkeypatch.setattr(ssd_cuda, "ssd_chunked", lambda x, *a, **kw: x)
    x = torch.ones(1, 2, 1, 2)
    launch_one = (lambda: ssd_ops.SSDChunked.apply(x, None, None, None,
                                                   None, None, 8, False))
    return launch_one, launch_one, lambda: ssd_ops.launches


COUNTERS = {"gmm_equal": (_equal, ("equal_launches", "equal_bwd_launches")),
            "gmm_ragged": (_ragged, ("ragged_launches",
                                     "ragged_bwd_launches",
                                     "ragged_dw_launches")),
            "imag_fused": (_imag, ("launches",)),
            "flash_attention": (_flash, ("launches",)),
            "ssd_chunked": (_ssd, ("launches",))}
MODULES = {"gmm_equal": gmm_ops, "gmm_ragged": gmm_ops,
           "imag_fused": imag_ops, "flash_attention": fa_ops,
           "ssd_chunked": ssd_ops}


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kernel", list(COUNTERS))
def test_launch_counters_stay_exact_under_threads(kernel, monkeypatch):
    """Sixteen threads (more than the cores), each launching 200 times (the
    kernel stood in), with a short switch interval: not one count lost."""
    setup, names = COUNTERS[kernel]
    for name in names:
        monkeypatch.setattr(MODULES[kernel], name, 0)
    fwd, other, total = setup(monkeypatch)
    per_thread, n_threads = 200, 16

    def worker(i):
        for _ in range(per_thread):
            (fwd if i % 2 else other)()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    half = n_threads // 2 * per_thread
    # gmm_ragged's `other` launches twice (dx, then dW)
    assert total() == half + half * (2 if kernel == "gmm_ragged" else 1)


# ---------------------------------------------------------------- launcher
LAUNCH_SIZES = ["--env", "pendulum", "--n-models", str(N_MODELS),
                "--model-hidden", str(HIDDEN),
                "--policy-hidden", str(POLICY_HIDDEN),
                "--imagine-batch", str(IMAGINE_BATCH),
                "--imagine-horizon", str(IMAGINE_HORIZON), "--seed", "0"]


@pytest.mark.timeout(120)
def test_launcher_runs_the_threads_engine(tmp_path, capsys):
    """``--mode threads`` writes the reference's JSON: its keys and a fleet
    block whose per-collector counts sum to ``--trajs`` exactly."""
    out = tmp_path / "run.json"
    trace = launch.main(LAUNCH_SIZES + [
        "--mode", "threads", "--trajs", "5", "--n-collectors", "2",
        "--envs-per-collector", "2", "--device", "cpu", "--out", str(out)])
    got = json.loads(out.read_text())
    assert set(got) == {"engine", "algo", "env", "real_seconds", "trace",
                        "fleet"}
    assert set(got["fleet"]) == {"n_collectors", "envs_per_collector",
                                 "sim_robots", "noise_scales",
                                 "trajs_per_collector"}
    assert sum(got["fleet"]["trajs_per_collector"]) == 5
    assert got["fleet"]["sim_robots"] == 4
    assert got["trace"] == trace and trace[-1]["trajs"] == 5
    assert json.dumps(trace[-1], indent=1) in capsys.readouterr().out


# ---------------------------------------------------------------- example
@pytest.mark.timeout(180)
def test_torch_async_vs_sync_prints_the_three_rows(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_async_vs_sync", ROOT / "examples" / "torch_async_vs_sync.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    traces = mod.main(total_trajs=4, device="cpu", n_rollouts=2,
                      max_model_epochs=3, policy_steps=4)
    assert traces["async"][-1]["time"] == 40.0
    assert traces["fleet"][-1]["time"] == 10.0      # 4 collectors at once
    assert traces["sequential"][-1]["time"] > 40.0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == [
        "async", "async, fleet=4", "sequential", "wall-clock speed-up"]


# ------------------------------------------------------- chip_smoke.py
@pytest.fixture
def kernel_stand_ins(monkeypatch):
    """The card's ``gmm_equal`` and ``imag_fused`` wrappers replaced by
    their plain versions under ``no_grad``, both dispatchers routed to them
    and the counters from 0; ``torch.cuda.synchronize`` a no-op."""
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


@pytest.mark.timeout(180)
def test_chip_smoke_threads_phases_count_and_check_on_the_cpu(
        kernel_stand_ins, monkeypatch):
    """A rehearsal of ``threads_paced``, ``threads_fleet`` and
    ``model_free`` at small sizes: the phases' checks pass, each epoch's
    launches equal what its ring implies, and the records serialise."""
    spec = importlib.util.spec_from_file_location("chip_smoke_threads",
                                                  ROOT / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    monkeypatch.setattr(chip, "engine_parts", _parts)
    # 12 trajectories of 0.5 s: the model's first push comes after
    # min_warmup_trajs (4 trajectories, ~2 s), which leaves the policy
    # thread ~4 s for its steps on a loaded host
    monkeypatch.setattr(chip, "ENGINE_TRAJS", 12)
    monkeypatch.setattr(chip, "THREADS_SPEED", 20.0)
    monkeypatch.setattr(chip, "LEARN_ENV", "pendulum")
    monkeypatch.setattr(chip, "POLICY_HIDDEN", POLICY_HIDDEN)
    _, paced = chip.threads_paced(gmm_ops, imag_ops, device="cpu")
    assert paced["trajs"] == 12 and paced["collection_time_s"] == 6.0
    assert paced["wall_s"] >= 6.0 and paced["shapes"] == [1, 1]
    assert paced["imag_fused_launches"] == \
        paced["policy_steps"] * IMAGINE_HORIZON > 0
    assert paced["gmm_equal_launches"] > 0
    assert paced["worker_calls"]["collect"]["work"] == 12
    fleet = chip.threads_fleet(gmm_ops, imag_ops, device="cpu")
    assert sum(fleet["trajs_per_collector"]) == 12
    free = chip.model_free(device="cpu")
    assert [r["time"] for r in free["trace"]] == [52.5, 105.0]
    json.dumps([paced, fleet, free])


def test_chip_smoke_overlap_stats_sweep():
    spec = importlib.util.spec_from_file_location("chip_smoke_overlap",
                                                  ROOT / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    # stream 1: [0, 10) and [20, 30); stream 2: [5, 15) and [25, 26)
    stats = chip.overlap_stats([(0, 10, 1), (5, 15, 2), (20, 30, 1),
                                (25, 26, 2)])
    assert stats["kernels"] == 4 and stats["span_ms"] == 0.030
    assert stats["busy_ms"] == pytest.approx(0.025)
    # overlapping kernel time: [5, 10) on both, [25, 26) on both
    assert stats["overlap_share"] == pytest.approx(12 / 31)
    assert stats["kernel_ms_by_stream"] == {"1": 0.02, "2": 0.011}
