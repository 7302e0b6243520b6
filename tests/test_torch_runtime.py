"""The port's engines against the JAX reference, on the CPU at a small size:
the event-mode ``AsyncTrainer`` (one collector, and a fleet of farms whose
batch does not divide the target), the three synchronous trainers, the
eval recorder, ``RunConfig``, ``default_burst``, the clocks, the launcher
and the torch quickstart.

Each package's schedule is recorded by wrapping the ``step`` methods of
the trainer's own worker instances (nothing in either package is edited):
the worker's name, the step's arguments and whether it returned work. With
``early_stop=False`` every step's outcome depends only on the schedule, so
the schedules, and the trace's ``time``, ``trajs`` and ``env_steps``
columns, must be equal exactly; the eval returns come from different draws
(torch cannot replay ``jax.random``) and are only required to be finite.
The recorder's return is held to the reference's within 1e-4 of scale
with the reference's reset draws replayed into the port.
"""
import dataclasses
import importlib.util
import json
import pathlib
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import clock as JC
from repro.core import runtime as JR
from repro.core import workers as JW
from repro.envs import make_env as jmake_env
from repro.mbrl import AlgoConfig as JAlgoConfig
from repro.mbrl import EnsembleConfig as JEnsembleConfig
from repro.mbrl import PolicyConfig as JPolicyConfig
from repro.mbrl import make_algo as jmake_algo
from repro.mbrl import policy as JPI
from repro_torch.core import clock as TC
from repro_torch.core import runtime as TR
from repro_torch.core import workers as TW
from repro_torch.envs import make_env as tmake_env
from repro_torch.core.roles import split_roles
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_mesh
from repro_torch.mbrl import algos as TA
from repro_torch.mbrl import dynamics as TD
from repro_torch.mbrl import policy as TPI
from repro_torch.testing.parity import tree_from_jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the reference's tests/test_runtime.py sizes, imagination cut further
HIDDEN, N_MODELS, POLICY_HIDDEN = 32, 2, 16
IMAGINE_BATCH, IMAGINE_HORIZON = 8, 10
EVAL_ROLLOUTS = 2
RETURN_TOL = 1e-4       # of scale: the same f32 rollout, sums reordered
# the synchronous trainers: two rollouts a round, so the first round runs
# below min_warmup_trajs = 4 (the model and the policy idle) and the
# second round trains
SYNC_KW = dict(n_rollouts=2, max_model_epochs=3, policy_steps=4)
FLEET = dict(n_collectors=2, envs_per_collector=3, total_trajs=7,
             collect_noise=(1.0, 1.3))

ENGINES = {
    "async": ("AsyncTrainer", dict(total_trajs=5), {}),
    "async_fleet_farm": ("AsyncTrainer", FLEET, {}),
    "sequential": ("SequentialTrainer", dict(total_trajs=6), SYNC_KW),
    "partial_model": ("PartialAsyncModelPolicy", dict(total_trajs=6),
                      SYNC_KW),
    "partial_data": ("PartialAsyncDataPolicy", dict(total_trajs=6), SYNC_KW),
}


def _jax_trainer(cls, rc_kw, kw, env_name="pendulum"):
    env = jmake_env(env_name)
    ens = JEnsembleConfig(env.obs_dim, env.act_dim, hidden=HIDDEN,
                          n_models=N_MODELS)
    pol = JPolicyConfig(env.obs_dim, env.act_dim, hidden=POLICY_HIDDEN)
    acfg = JAlgoConfig(algo="me-trpo", imagine_batch=IMAGINE_BATCH,
                       imagine_horizon=IMAGINE_HORIZON, n_models=N_MODELS)
    algo = jmake_algo(acfg, pol, jax.vmap(env.reward), env.reset_batch)
    rc = JR.RunConfig(eval_rollouts=EVAL_ROLLOUTS, **rc_kw)
    return getattr(JR, cls)(env, ens, algo, rc, **kw)


def _torch_parts(env_name="pendulum"):
    env = tmake_env(env_name)
    ens = TD.EnsembleConfig(env.obs_dim, env.act_dim, hidden=HIDDEN,
                            n_models=N_MODELS)
    pol = TPI.PolicyConfig(env.obs_dim, env.act_dim, hidden=POLICY_HIDDEN)
    acfg = TA.AlgoConfig(algo="me-trpo", imagine_batch=IMAGINE_BATCH,
                         imagine_horizon=IMAGINE_HORIZON, n_models=N_MODELS)
    return env, ens, TA.make_algo(acfg, pol, env.reward, env.reset_batch)


def _torch_trainer(cls, rc_kw, kw, env_name="pendulum"):
    env, ens, algo = _torch_parts(env_name)
    rc = TR.RunConfig(eval_rollouts=EVAL_ROLLOUTS, **rc_kw)
    return getattr(TR, cls)(env, ens, algo, rc, device="cpu", **kw)


def _collectors(tr):
    return getattr(tr, "collectors", [tr.collector])


def _record_schedule(tr):
    """Wrap the trainer's worker instances' ``step``: each call appends
    (worker, arguments, returned work)."""
    log = []
    workers = [(f"collect:{i}", c) for i, c in enumerate(_collectors(tr))]
    workers += [("model", tr.model_worker), ("policy", tr.policy_worker)]
    for name, w in workers:
        def step(*args, _step=w.step, _name=name):
            out = _step(*args)
            log.append((_name, args, out is not None and out is not False))
            return out
        w.step = step
    return log


def _columns(trace, *keys):
    return [tuple(row[k] for k in keys) for row in trace]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_schedule_and_trace_equal_the_reference(engine):
    cls, rc_kw, kw = ENGINES[engine]
    rc_kw = dict(rc_kw, seed=0, early_stop=False)
    jtr, ttr = _jax_trainer(cls, rc_kw, kw), _torch_trainer(cls, rc_kw, kw)
    jlog, tlog = _record_schedule(jtr), _record_schedule(ttr)
    jtrace, ttrace = jtr.run(), ttr.run()
    assert tlog == jlog
    assert any(work for name, _, work in tlog if name == "policy")
    assert len(ttrace) == len(jtrace)
    cols = ("time", "trajs", "env_steps")
    assert _columns(ttrace, *cols) == _columns(jtrace, *cols)
    assert [c.collected for c in _collectors(ttr)] == \
        [c.collected for c in _collectors(jtr)]
    assert all(np.isfinite(r["eval_return"]) for r in ttrace + jtrace)
    assert set(ttrace[0]) == set(jtrace[0])
    assert ttr.model_worker.compile_count() == 1
    assert ttr.policy_worker.compile_count() == 1
    assert ttr.data_server.total_pushed == jtr.data_server.total_pushed


@pytest.mark.parametrize("engine", list(ENGINES))
def test_early_stop_on_keeps_the_trace_shape(engine):
    """With early stop on, the stop decisions follow float losses, so
    only the trace's shape is held: its keys, a nondecreasing time, the
    exact final count, and for the async engine a run time equal to the
    collection time."""
    cls, rc_kw, kw = ENGINES[engine]
    tr = _torch_trainer(cls, dict(rc_kw, seed=1, early_stop=True), kw)
    trace = tr.run()
    assert all(set(r) == {"time", "trajs", "env_steps", "eval_return"}
               for r in trace)
    times = [r["time"] for r in trace]
    assert times == sorted(times)
    assert trace[-1]["trajs"] == rc_kw["total_trajs"]
    assert all(np.isfinite(r["eval_return"]) for r in trace)
    if cls == "AsyncTrainer":
        env = tr.env
        per_step = env.horizon * env.dt
        steps = max(-(-c.collected // tr.run_cfg.envs_per_collector)
                    for c in tr.collectors)
        assert trace[-1]["time"] == steps * per_step
        if tr.run_cfg.n_collectors == 1:
            assert trace[-1]["time"] == rc_kw["total_trajs"] * per_step


def _reset_draws(env, key):
    """The draws the reference's ``reset(key)`` makes, in the layout of
    the port env ``env``'s ``reset_from``."""
    if env.name == "pendulum":
        return np.stack([np.asarray(jax.random.uniform(key, ())),
                         np.asarray(jax.random.uniform(
                             jax.random.fold_in(key, 1), ()))])
    if env.reset_dist == "uniform":
        return np.asarray(jax.random.uniform(key, env.reset_shape))
    return np.asarray(jax.random.normal(key, env.reset_shape))


@pytest.mark.parametrize("env_name", ["pendulum", "pr2_reach"])
def test_recorder_matches_reference_with_its_reset_draws(env_name):
    """The same policy in both packages; the reference's eval splits its
    key into ``eval_rollouts`` rollout keys and each rollout resets from
    the first half of its own split (``Env.rollout``)."""
    jenv, tenv = jmake_env(env_name), tmake_env(env_name)
    jp = JPI.init_policy(JPI.PolicyConfig(jenv.obs_dim, jenv.act_dim,
                                          hidden=POLICY_HIDDEN),
                         jax.random.key(5))
    tp = tree_from_jax(jax.tree.map(np.asarray, jp))
    jrec = JR._Recorder(jenv, EVAL_ROLLOUTS)
    trec = TR._Recorder(tenv, EVAL_ROLLOUTS)
    for i, key in enumerate(jax.random.split(jax.random.key(7), 3)):
        want = jrec.record(10.0 * i, i + 1, jp, key)
        draws = np.stack([_reset_draws(tenv, jax.random.split(k)[0])
                          for k in jax.random.split(key, EVAL_ROLLOUTS)])
        got = trec.record(10.0 * i, i + 1, tp,
                          reset_draws=torch.from_numpy(draws))
        assert abs(got - want) <= RETURN_TOL * max(1.0, abs(want))
    cols = ("time", "trajs", "env_steps")
    assert _columns(trec.trace, *cols) == _columns(jrec.trace, *cols)
    # without draws, the recorder draws the resets from a generator
    gen = torch.Generator().manual_seed(0)
    assert np.isfinite(trec.record(0.0, 0, tp, gen))


def test_clear_eval_cache_keeps_the_api_and_changes_no_eval():
    """``clear_eval_cache`` exists as in the reference; each recorder
    builds its own eval, so clearing changes no return."""
    env = tmake_env("pendulum")
    pol = TPI.init_policy(TPI.PolicyConfig(env.obs_dim, env.act_dim,
                                           hidden=POLICY_HIDDEN),
                          torch.Generator().manual_seed(0))
    draws = env.reset_draws(2, torch.Generator().manual_seed(1))
    before = TR._Recorder(env, 2).record(0.0, 0, pol, reset_draws=draws)
    assert TR.clear_eval_cache() is None
    after = TR._Recorder(env, 2).record(0.0, 0, pol, reset_draws=draws)
    assert after == before and np.isfinite(after)


def test_run_config_fields_and_defaults_equal_the_reference():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(TR.RunConfig) == spec(JR.RunConfig)


def test_run_seeds_are_four_fixed_draws_of_one_cpu_generator():
    gen = torch.Generator().manual_seed(3)
    want = tuple(int(s) for s in torch.randint(0, 2 ** 62, (4,),
                                               generator=gen))
    assert TR.run_seeds(3) == want
    assert len(set(want)) == 4 and TR.run_seeds(4) != want


@pytest.mark.parametrize("n_collectors", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("envs", [1, 3, 8, 9, 20])
def test_default_burst_matches_reference(n_collectors, envs):
    assert TW.default_burst(n_collectors, envs) == \
        JW.default_burst(n_collectors, envs)
    assert TW.default_burst(n_collectors) == JW.default_burst(n_collectors)


@pytest.mark.parametrize("pkg", [TC, JC], ids=["port", "reference"])
def test_virtual_clock_keeps_a_cursor_per_thread(pkg):
    clock = pkg.VirtualClock()
    assert clock.now() == 0.0 and clock.max_time() == 0.0
    seen = {}
    # thread idents are reused once a thread ends: the barrier keeps all
    # three alive, so each owns its cursor
    together = threading.Barrier(3, timeout=10)

    def worker(name, steps):
        for s in steps:
            clock.sleep(s)
        seen[name] = clock.now()
        together.wait()

    threads = [threading.Thread(target=worker, args=("a", [1.5, 2.0])),
               threading.Thread(target=worker, args=("b", [4.0, -3.0])),
               threading.Thread(target=worker, args=("c", [0.25] * 4))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert seen == {"a": 3.5, "b": 4.0, "c": 1.0}   # negative sleeps clamp
    assert clock.now() == 0.0                       # this thread's own
    assert clock.max_time() == 4.0
    clock.sleep(5.0)
    assert clock.now() == 5.0 and clock.max_time() == 5.0


def test_real_clock_reads_the_monotonic_clock():
    clock = TC.RealClock()
    t0 = clock.now()
    clock.sleep(0.0)
    clock.sleep(-1.0)
    clock.sleep(0.01)
    assert clock.now() - t0 >= 0.01


@pytest.mark.parametrize("kw,err,match", [
    # the threads and procs engines, the tcp transport and role meshes
    # (event and threads modes) are ported; an engine the reference does
    # not have is not, and the procs engine takes no role mesh (the
    # reference's ValueError, which names ROADMAP.md)
    (dict(mode="pod", mesh=make_mesh(4, device="cpu")), NotImplementedError,
     "ROADMAP.md"),
    (dict(mode="procs", roles=object()), ValueError, "ROADMAP.md"),
    (dict(mode="procs", mesh=make_mesh(4, device="cpu")), ValueError,
     'mode="procs" does not take a role mesh'),
    (dict(mode="procs", roles=split_roles(make_mesh(4, device="cpu"))),
     ValueError, 'mode="procs" does not take a role mesh'),
    (dict(mode="procs", supervisor=TR.Supervisor(), mesh=object()),
     ValueError, "ROADMAP.md"),
    (dict(mode="procs", supervisor=TR.Supervisor(), roles=object()),
     ValueError, "ROADMAP.md"),
    # the event engine refuses tcp with the reference's error
    (dict(rc=dict(transport="tcp")), ValueError,
     'transport="tcp" needs a real engine'),
], ids=["threads", "procs", "mesh", "roles", "supervisor",
        "procs_supervisor", "tcp"])
def test_unported_engines_and_options_raise_naming_the_roadmap(kw, err,
                                                                match):
    env, ens, algo = _torch_parts()
    kw = dict(kw)
    rc = TR.RunConfig(**kw.pop("rc", {}))
    with pytest.raises(err, match=match):
        TR.AsyncTrainer(env, ens, algo, rc, device="cpu", **kw)


@pytest.mark.parametrize("rc,match", [
    (dict(n_collectors=0), "n_collectors must be >= 1"),
    (dict(envs_per_collector=0), "envs_per_collector must be >= 1"),
    (dict(transport="udp"), "transport must be 'shm' or 'tcp'"),
    # a Supervisor hooks into the procs supervision loop only
    (dict(supervisor=TR.Supervisor()), "supervision loop only"),
])
def test_reference_value_errors_are_kept(rc, match):
    env, ens, algo = _torch_parts()
    rc = dict(rc)
    kw = {"supervisor": rc.pop("supervisor")} if "supervisor" in rc else {}
    with pytest.raises(ValueError, match=match):
        TR.AsyncTrainer(env, ens, algo, TR.RunConfig(**rc), device="cpu",
                        **kw)


@pytest.mark.parametrize("cls", ["AsyncTrainer", "SequentialTrainer",
                                 "PartialAsyncModelPolicy",
                                 "PartialAsyncDataPolicy"])
def test_engines_default_to_the_card(cls):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    env, ens, algo = _torch_parts()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(TR, cls)(env, ens, algo, TR.RunConfig())


# ---------------------------------------------------------------- launcher
LAUNCH_SIZES = ["--env", "pendulum", "--n-models", str(N_MODELS),
                "--model-hidden", str(HIDDEN),
                "--policy-hidden", str(POLICY_HIDDEN),
                "--imagine-batch", str(IMAGINE_BATCH),
                "--imagine-horizon", str(IMAGINE_HORIZON), "--seed", "0",
                "--no-early-stop"]
# the JSON the reference's run_mbrl writes (repro/launch/train.py): the
# fleet block for the in-process async engines, none for the others
REFERENCE_KEYS = {"engine", "algo", "env", "real_seconds", "trace"}
FLEET_KEYS = {"n_collectors", "envs_per_collector", "sim_robots",
              "noise_scales", "trajs_per_collector"}


def test_launcher_writes_the_references_json_for_a_fleet(tmp_path,
                                                          capsys):
    """One async fleet run through both launchers' ``run_mbrl``: the
    same keys, fleet block and trace columns (early stop off)."""
    argv = LAUNCH_SIZES + ["--trajs", "5", "--n-collectors", "2",
                           "--collect-noise", "1.0,1.3"]
    tout, jout = tmp_path / "torch.json", tmp_path / "jax.json"
    launch.main(argv + ["--device", "cpu", "--out", str(tout)])
    from repro.launch import train as jlaunch
    jlaunch.run_mbrl(launch.parser().parse_args(argv + ["--out",
                                                        str(jout)]))
    got, want = json.loads(tout.read_text()), json.loads(jout.read_text())
    assert set(got) == set(want) == REFERENCE_KEYS | {"fleet"}
    assert got["fleet"] == want["fleet"]
    assert set(got["fleet"]) == FLEET_KEYS
    assert sum(got["fleet"]["trajs_per_collector"]) == 5
    cols = ("time", "trajs", "env_steps")
    assert _columns(got["trace"], *cols) == _columns(want["trace"], *cols)
    printed = capsys.readouterr().out
    assert json.dumps(got["trace"][-1], indent=1) in printed


@pytest.mark.parametrize("engine", ["async", "sequential", "partial-model",
                                    "partial-data"])
def test_launcher_runs_each_engine_on_the_cpu(engine, tmp_path):
    """Early stop on; partial-data collects its first five rollouts
    before its loop, so it needs a target past them."""
    out = tmp_path / "run.json"
    trajs = 6 if engine == "partial-data" else 4
    trace = launch.main(LAUNCH_SIZES[:-1] + [
        "--trajs", str(trajs), "--engine", engine, "--device", "cpu",
        "--out", str(out)])
    got = json.loads(out.read_text())
    want = REFERENCE_KEYS | ({"fleet"} if engine == "async" else set())
    assert set(got) == want
    assert got["engine"] == engine and got["trace"] == trace
    assert trace[-1]["trajs"] >= trajs


@pytest.mark.parametrize("flags,err,match", [
    # the threads and procs engines, the tcp transport, --connect, --task
    # lm on every arch and --mesh with the async engine's event and threads
    # modes are ported; what stands is the reference's own refusals: a
    # role mesh with a synchronous engine (SystemExit) or with procs mode
    # (ValueError, also under the tcp control plane: "connect")
    (["--mode", "threads", "--engine", "partial-data", "--mesh", "2"],
     SystemExit, "--mesh is only supported by --engine async"),
    (["--mode", "procs", "--mesh", "2"], ValueError,
     'mode="procs" does not take a role mesh'),
    # the event mode over tcp meets the reference's error
    (["--transport", "tcp"], ValueError,
     'transport="tcp" needs a real engine'),
    (["--engine", "partial-model", "--mesh", "auto"], SystemExit,
     "--mesh is only supported by --engine async"),
    (["--task", "mbrl", "--mode", "procs", "--transport", "tcp",
      "--mesh", "auto"], ValueError, 'mode="procs" does not take a role '
     "mesh"),
    (["--task", "mbrl", "--engine", "sequential", "--mesh", "auto"],
     SystemExit, "--mesh is only supported by --engine async"),
], ids=["threads", "procs", "tcp", "mesh", "connect", "lm"])
def test_launcher_refuses_what_is_not_ported(flags, err, match):
    with pytest.raises(err, match=match):
        launch.main(LAUNCH_SIZES + ["--device", "cpu"] + flags)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "phi-3-vision-4.2b"])
def test_launcher_task_lm_trains_the_encdec_and_vision_archs(arch, capsys):
    """``--task lm`` on the two archs that came last: each REDUCED config
    takes a step with its frame or patch embeddings, a finite loss."""
    losses = launch.main(["--task", "lm", "--arch", arch, "--reduced",
                          "--steps", "1", "--batch", "2", "--seq", "16",
                          "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert "step    0 loss" in capsys.readouterr().out


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(LAUNCH_SIZES + ["--trajs", "1"])


# ------------------------------------------------------- chip_smoke.py
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_engines",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def kernel_stand_ins(monkeypatch):
    """The card's ``gmm_equal`` and ``imag_fused`` wrappers replaced by
    their plain versions computed under ``no_grad`` (like a ctypes launch,
    each returns a tensor with no graph), both dispatchers routed to them
    and the launch counters from 0, so the kernel route and its counts run
    on the CPU; ``torch.cuda.synchronize`` is a no-op."""
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


def test_chip_smoke_engine_phases_count_and_check_on_the_cpu(
        kernel_stand_ins, monkeypatch):
    """A rehearsal of ``chip_smoke.py``'s ``event_run`` (synchronised and
    not), ``sequential_run`` and ``quickstart`` at small sizes: the
    phases' checks pass, each epoch's launches equal what its ring
    implies, both engines collect the same trajectories, and the records
    serialise."""
    gmm_ops, imag_ops = kernel_stand_ins
    chip = _chip_smoke()

    def parts():
        env, ens, algo = _torch_parts()
        return env, ens, algo.cfg, algo
    monkeypatch.setattr(chip, "engine_parts", parts)
    monkeypatch.setattr(chip, "ENGINE_TRAJS", 6)
    event = chip.engine_run("event_run", TR.AsyncTrainer, gmm_ops, imag_ops,
                            device="cpu")
    assert event["robot_time_s"] == 60.0 and event["trajs"] == 6
    assert event["gmm_equal_launches"] > 0
    assert event["imag_fused_launches"] == \
        event["policy_steps"] * IMAGINE_HORIZON > 0
    assert event["worker_calls"]["eval"]["calls"] == event["evals"]
    assert event["worker_calls"]["collect"]["work"] == 6
    own = chip.engine_run("event_run", TR.AsyncTrainer, gmm_ops, imag_ops,
                          sync=False, device="cpu")
    assert not own["synchronised_steps"] and event["synchronised_steps"]
    assert own["trace_time"] == event["trace_time"]
    assert own["gmm_equal_launches"] == event["gmm_equal_launches"]
    seq = chip.engine_run("sequential_run", TR.SequentialTrainer, gmm_ops,
                          imag_ops, device="cpu", **SYNC_KW)
    assert seq["trajs"] == 6 and seq["collection_time_s"] == 60.0
    assert seq["robot_time_s"] > event["robot_time_s"]
    assert seq["imag_fused_launches"] == seq["policy_steps"] * IMAGINE_HORIZON
    qs = chip.quickstart(gmm_ops, imag_ops, total_trajs=5, device="cpu")
    assert qs["robot_time_s"] == 50.0 and qs["trajs"] == 5
    assert qs["imag_fused_launches"] == qs["policy_steps"] * 40 > 0
    assert qs["gmm_equal_launches"] > 0
    assert "total simulated robot time: 50.0 s" in qs["printed"][-1]
    json.dumps([event, own, seq, qs])


@pytest.mark.parametrize("trajs", [6, 7])
def test_chip_smoke_engine_run_refuses_a_short_collection(
        kernel_stand_ins, monkeypatch, trajs):
    """A synchronous engine whose rounds overshoot the target collects
    more than the event run, so ``engine_run`` refuses it: its robot time
    must come from training, not from extra trajectories."""
    gmm_ops, imag_ops = kernel_stand_ins
    chip = _chip_smoke()

    def parts():
        env, ens, algo = _torch_parts()
        return env, ens, algo.cfg, algo
    monkeypatch.setattr(chip, "engine_parts", parts)
    monkeypatch.setattr(chip, "ENGINE_TRAJS", trajs)
    kw = dict(SYNC_KW, n_rollouts=4, max_model_epochs=1, policy_steps=1)
    with pytest.raises(RuntimeError, match=f"trajectories, not {trajs}"):
        chip.engine_run("sequential_run", TR.SequentialTrainer, gmm_ops,
                        imag_ops, device="cpu", **kw)


# ---------------------------------------------------------------- examples
def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_quickstart_ends_at_the_collection_time(capsys):
    trace = _example("torch_quickstart").main(total_trajs=6, device="cpu")
    assert trace[-1]["time"] == 60.0 and trace[-1]["trajs"] == 6
    out = capsys.readouterr().out
    assert "total simulated robot time: 60.0 s" in out
    assert out.splitlines()[0].split() == ["robot-time", "trajs", "eval",
                                           "return"]


def test_torch_pr2_arm_reports_a_finite_final_distance(capsys):
    res = _example("torch_pr2_arm").main(tasks=("pr2_reach",),
                                         total_trajs=5, device="cpu")
    d = res["pr2_reach"]["final_distance"]
    assert np.isfinite(d) and d >= 0.0
    assert res["pr2_reach"]["trace"][-1]["time"] == 5 * 100 * 0.1
    assert "pr2_reach" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_pr2_arm"])
def test_torch_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main()
