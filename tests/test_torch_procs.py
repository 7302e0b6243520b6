"""The port's procs engine (``AsyncTrainer(mode="procs")``) and its
file-backed stores, on the CPU, held against the reference where the
reference has a counterpart that makes no ``/dev/shm`` entry.

The stores: the parameter store's bytes equal the reference's
``LeafCodec`` encoding at the reference's offsets; roundtrip, version
gating, zero copies on an unchanged pull, bf16 leaves; a reader that keeps
its cache when a writer dies mid-push and a restarted writer that waits for
the dead one's lock; the data spool's ``try_claim`` / ``push`` /
``push_batch`` / ``refund_inflight`` sequences against the reference's
in-process ``DataServer``; the backpressure error's text against the
reference's; handles that pickle without a tensor; every file under the
run's own directory and gone after ``close``. No reference
``ShmParameterServer`` or ``ProcDataServer`` is built: they make
``/dev/shm`` entries. The workers: ``push_init=False`` and the collector's
``compile_count`` against the reference's workers. The source: no
``multiprocessing`` shared-memory or synchronisation primitive in the port.

Then three end-to-end runs that spawn processes, each bounded by
``pytest.mark.timeout`` and a ``finally`` that kills its children: a clean
run of a fleet of two farms, a model child killed and restarted from its
snapshot, and a collector killed past its budget.
"""
import ast
import dataclasses
import io
import os
import pathlib
import pickle
import signal
import time
import types

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core import servers as JS
from repro.core import workers as JW
from repro.envs import make_env as jmake_env
from repro.mbrl import algos as JA
from repro.mbrl import policy as JPI
from repro_torch.checkpoint import io as tio
from repro_torch.core import runtime as TR
from repro_torch.core import servers as TS
from repro_torch.core import workers as TW
from repro_torch import kernels as TK
from repro_torch.envs import make_env
from repro_torch.launch import train as launch
from repro_torch.mbrl import algos as TA
from repro_torch.mbrl import dynamics as TD
from repro_torch.mbrl import policy as TPI

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
HIDDEN, N_MODELS, POLICY_HIDDEN = 32, 2, 16
IMAGINE_BATCH, IMAGINE_HORIZON = 8, 10


def _tree(seed, bf16=False):
    """An ensemble-shaped tree of seeded numpy arrays (and, with ``bf16``,
    a bf16 leaf and an int64 leaf): the store's payload."""
    rng = np.random.default_rng(seed)
    tree = {"members": {"w": [rng.standard_normal((2, 4, 8), np.float32),
                              rng.standard_normal((2, 8, 3), np.float32)],
                        "b": [rng.standard_normal((2, 8), np.float32),
                              rng.standard_normal((2, 3), np.float32)]},
            "norm": {"mu_in": rng.standard_normal(4).astype(np.float32),
                     "sig_in": np.ones(4, np.float32)}}
    if bf16:
        tree["extra"] = {"h": rng.standard_normal((5, 3)).astype(np.float32),
                         "count": np.arange(3, dtype=np.int64)}
    return tree


def _torch_tree(tree, bf16=False):
    out = tio.unflatten(tree, [torch.from_numpy(np.array(a))
                               for a in tio.flatten(tree)])
    if bf16:
        out["extra"]["h"] = out["extra"]["h"].to(torch.bfloat16)
    return out


def _reference_tree(tree, bf16=False):
    """The tree as the reference's codec takes it: numpy leaves (int64
    kept, which jax arrays would narrow without x64), the bf16 leaf an
    ``ml_dtypes`` array made by jax."""
    out = jax.tree.map(np.array, tree)
    if bf16:
        out["extra"]["h"] = np.asarray(
            jax.numpy.asarray(out["extra"]["h"]).astype(jax.numpy.bfloat16))
    return out


def _equal(a, b):
    fa, fb = tio.flatten(a), tio.flatten(b)
    return len(fa) == len(fb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(fa, fb))


# ------------------------------------------------- the parameter store
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_store_bytes_equal_the_reference_codec_at_its_offsets(tmp_path,
                                                              bf16):
    """The reference's layout: a 64-byte header (seqlock even after one
    push, version 1), then each leaf in ``LeafCodec`` order on a 64-byte
    boundary, its bytes the reference's encoding."""
    tree = _tree(0, bf16)
    codec = jio.LeafCodec(_reference_tree(tree, bf16))
    enc = codec.encode(_reference_tree(tree, bf16))
    with TS.ShmParameterServer(_torch_tree(tree, bf16),
                               dir=str(tmp_path)) as srv:
        assert srv.push(_torch_tree(tree, bf16)) == 1
        raw = pathlib.Path(srv.path).read_bytes()
    off = JS._SHM_HEADER
    assert np.frombuffer(raw[:16], np.int64).tolist() == [2, 1]
    for arr, n in zip(enc, codec.nbytes):
        assert raw[off:off + n] == arr.tobytes()
        off += max(int(n), 1)
        off += (-off) % JS._SHM_ALIGN
    assert len(raw) == off


def test_store_roundtrip_gating_and_zero_copy_unchanged_pull(tmp_path):
    a, b = _torch_tree(_tree(1)), _torch_tree(_tree(2))
    with TS.ShmParameterServer(a, dir=str(tmp_path)) as srv:
        assert srv.version == 0
        assert srv.pull_if_newer(0) == (None, 0)
        assert srv.pull() == (None, 0)
        assert srv.push(a) == 1
        got, ver = srv.pull_if_newer(0)
        assert ver == 1 and _equal(got, a)
        assert list(got) == list(a) and list(got["norm"]) == list(a["norm"])
        copies = srv.copies
        for _ in range(5):                  # unchanged: no copy at all
            assert srv.pull_if_newer(1) == (None, 1)
        assert srv.copies == copies
        assert srv.push(b) == 2
        got, ver = srv.pull_if_newer(1)
        assert ver == 2 and _equal(got, b)
        assert srv.copies == copies + len(tio.flatten(b))
        host, ver = srv.pull_host()
        assert ver == 2 and all(isinstance(x, np.ndarray)
                                for x in tio.flatten(host))
        # the pulled tensors are the caller's own: the next push does not
        # write through them
        srv.push(a)
        assert _equal(got, b)


def test_store_bf16_leaves_roundtrip_bit_equal(tmp_path):
    tree = _torch_tree(_tree(3, bf16=True), bf16=True)
    with TS.ShmParameterServer(tree, dir=str(tmp_path)) as srv:
        srv.push(tree)
        got, _ = srv.pull()
    assert got["extra"]["h"].dtype == torch.bfloat16
    assert _equal(got, tree)


def test_reader_survives_a_writer_killed_mid_push(tmp_path, monkeypatch):
    """A writer that dies mid-push leaves the sequence word odd: readers
    keep their cache. A restarted writer waits for the dead one's file
    lock (here the live first writer's: it refuses after the wait), then
    re-synchronises the sequence with its first push."""
    a, b = _torch_tree(_tree(4)), _torch_tree(_tree(5))
    with TS.ShmParameterServer(a, dir=str(tmp_path)) as creator:
        writer = pickle.loads(pickle.dumps(creator))    # the writer's
        reader = pickle.loads(pickle.dumps(creator))    # handle, a reader's
        writer.push(a)
        cache, ver = reader.pull_if_newer(0)
        assert ver == 1 and _equal(cache, a)
        # the writer dies after bumping the sequence and half the payload
        seq = writer._word(0)
        writer._set_word(0, seq + 1)
        writer._set_word(8, 2)          # the crash left a version behind
        assert reader.pull_if_newer(1) == (None, 1)     # keeps its cache
        monkeypatch.setattr(TS, "_WRITER_WAIT_S", 0.2)
        restarted = pickle.loads(pickle.dumps(creator))
        with pytest.raises(RuntimeError, match="one writer"):
            restarted.push(b)           # the old writer still holds it
        writer.close()                  # now it is gone: its lock with it
        assert restarted.push(b) == 3
        assert restarted._word(0) % 2 == 0
        got, ver = reader.pull_if_newer(1)
        assert ver == 3 and _equal(got, b)
        for h in (reader, restarted):
            h.close()


# ------------------------------------------------------ the data spool
def _traj(rng, h=4):
    return {"obs": rng.standard_normal((h, 3)).astype(np.float32),
            "act": rng.standard_normal((h, 1)).astype(np.float32)}


def _batch(rng, n, h=4):
    return {"obs": rng.standard_normal((n, h, 3)).astype(np.float32),
            "act": rng.standard_normal((n, h, 1)).astype(np.float32)}


CLAIM_SEQUENCE = [
    ("claim", 0, 3), ("claim", 1, 3), ("claim", 2, 3), ("claim", 0, 3),
    ("push_batch", 0, 3), ("push", 1), ("refund", 1), ("claim", 1, 3),
    ("push_batch", 1, 2), ("refund", 2), ("claim", 2, 1),
    ("push", 2), ("claim", 0, 3), ("refund", 0), ("total",), ("len",),
    ("claim", 0, 3), ("push_batch", 0, 2), ("claim", 1, 1), ("total",),
    ("len",),
]


def _apply(srv, op, rng):
    kind = op[0]
    if kind == "claim":
        return srv.try_claim(op[1], k=op[2])
    if kind == "push":
        return srv.push(_traj(rng), collector_id=op[1])
    if kind == "push_batch":
        return srv.push_batch(_batch(rng, op[2]), op[2],
                              collector_id=op[1])
    if kind == "refund":
        return srv.refund_inflight(op[1])
    if kind == "total":
        return srv.total_pushed
    return len(srv.drain())


def test_spool_tickets_equal_the_reference_data_server(tmp_path):
    """The same claims, pushes, batches and refunds, with the target 7
    armed, return what the reference's in-process DataServer returns; then
    the drain gives the same trajectories in push order."""
    ref = JS.DataServer(claim_backoff=0.0)
    ref.set_target(7)
    with TS.ProcDataServer(n_collectors=3, target=7, claim_backoff=0.0,
                           dir=str(tmp_path)) as srv:
        got = [_apply(srv, op, np.random.default_rng(i))
               for i, op in enumerate(CLAIM_SEQUENCE)]
        want = [_apply(ref, op, np.random.default_rng(i))
                for i, op in enumerate(CLAIM_SEQUENCE)]
        assert got == want
        # a later drain: the same trajectories in the same order
        rng = np.random.default_rng(99)
        single, batch = _traj(rng), _batch(rng, 3)
        srv.push(single)
        srv.push_batch(batch, 3)
        ref.push(single)
        ref.push_batch(batch, 3)
        mine, theirs = srv.drain(), ref.drain()
        assert len(mine) == len(theirs) == 4
        for m, t in zip(mine, theirs):
            assert set(m) == set(t)
            for k in m:
                assert isinstance(m[k], torch.Tensor)
                np.testing.assert_array_equal(m[k].numpy(), np.asarray(t[k]))
        assert srv.total_pushed == ref.total_pushed
        assert len(srv) == 0


def test_stores_satisfy_the_transport_protocols(tmp_path):
    tree = _torch_tree(_tree(9))
    with TS.ShmParameterServer(tree, dir=str(tmp_path)) as srv, \
            TS.ProcDataServer(dir=str(tmp_path)) as data:
        assert isinstance(srv, TS.ParameterTransport)
        assert isinstance(data, TS.DataTransport)


def test_spool_set_target_and_unarmed_claims(tmp_path):
    ref = JS.DataServer(claim_backoff=0.0)
    with TS.ProcDataServer(n_collectors=2, claim_backoff=0.0,
                           dir=str(tmp_path)) as srv:
        rng = np.random.default_rng(0)
        for s in (srv, ref):
            assert s.try_claim(0, k=5) == 5        # no target: k
            s.push(_traj(rng))
            s.set_target(4)
        assert [srv.try_claim(1, k=2) for _ in range(3)] == \
            [ref.try_claim(1, k=2) for _ in range(3)] == [2, 1, 0]


def test_backpressure_error_names_queue_consumer_and_timeout(tmp_path):
    """A push to a spool holding ``maxsize`` undrained items retries for
    ``push_timeout`` seconds and raises; the message is the reference's,
    with ``push_timeout_s`` named, and the timed-out item leaves no file."""
    want = None
    try:
        JS.ProcDataServer._raise_backpressure(
            types.SimpleNamespace(maxsize=2), 1, 0.2)
    except JS.BackpressureError as e:
        want = str(e)
    rng = np.random.default_rng(0)
    with TS.ProcDataServer(maxsize=2, push_timeout=0.2,
                           dir=str(tmp_path)) as srv:
        srv.push(_traj(rng))
        srv.push_batch(_batch(rng, 3), 3)
        t0 = time.monotonic()
        with pytest.raises(TS.BackpressureError) as err:
            srv.push(_traj(rng), collector_id=1)
        assert 0.2 <= time.monotonic() - t0 < 5.0
        assert not [n for n in os.listdir(srv.spool) if n.endswith(".tmp")]
        assert srv.total_pushed == 4 and len(srv) == 2
    msg = str(err.value)
    for part in want.split("push_timeout_s")[0].split(". "):
        assert part.strip() in msg, part
    assert "push_timeout_s=0.2" in msg and "(maxsize)" in msg


def test_files_live_under_the_run_dir_and_go_on_close(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    tree = _torch_tree(_tree(6))
    srv = TS.ShmParameterServer(tree, dir=str(run))
    data = TS.ProcDataServer(n_collectors=2, dir=str(run))
    ctl = TS.ProcControl(4, dir=str(run))
    srv.push(tree)
    data.push(_traj(np.random.default_rng(0)))
    paths = [pathlib.Path(p) for p in (srv.path, data.spool, ctl._path)]
    assert all(p.exists() and p.parent == run for p in paths)
    assert str(srv.path) in TS.live_shm_segments()
    assert TS.live_data_servers() >= 1
    for res in (srv, data, ctl):
        res.close()
        res.close()                     # idempotent
    assert os.listdir(run) == []
    assert str(srv.path) not in TS.live_shm_segments()


def test_reclaim_closes_stragglers(tmp_path):
    srv = TS.ShmParameterServer(_torch_tree(_tree(7)), dir=str(tmp_path))
    data = TS.ProcDataServer(dir=str(tmp_path))
    assert TS.reclaim_ipc_resources() >= 2
    assert srv.path not in TS.live_shm_segments()
    assert not os.path.exists(srv.path) and not os.path.exists(data.spool)


def test_control_block_stop_word_and_heartbeats(tmp_path):
    ctl = TS.ProcControl(3, dir=str(tmp_path))
    child = pickle.loads(pickle.dumps(ctl))
    ch = TW.ProcChannels(None, None, None, None, child, t0=0.0)
    assert not ctl.stop_requested() and ch.read_heartbeat(2) == (0.0, 0.0)
    timer = TW.StepTimer()
    timer.add(0.5, 3)
    timer.add(0.25, 4)
    timer.warmup_s, timer.warmup = 1.5, {"imag_fused": 10}
    ch.beat(2, 1, timer, resumed=3)
    slot = ctl.read(2)
    assert slot["compiles"] == 1 and slot["work"] == 7
    assert slot["work_s"] == 0.75 and slot["first_s"] == 0.5
    assert slot["resumed"] == 3 and slot["cuda"] == 0 and slot["beat"] > 0
    assert slot["warmup_s"] == 1.5 and slot["warmup:imag_fused"] == 10
    assert slot["warmup:gmm_equal"] == 0
    assert {k: slot[f"launches:{k}"] for k in TK.LAUNCH_COUNTERS} \
        == TK.launch_counts()
    ctl.request_stop()
    assert ch.stop_requested()
    child.close()
    ctl.close()
    assert os.listdir(tmp_path) == []


def test_launch_counts_read_every_ops_counter(monkeypatch):
    """``kernels.launch_counts`` names each of ``LAUNCH_COUNTERS`` once and
    reads the counter of ``kernels/*/ops.py`` behind it."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gmm import ops as gmm
    from repro_torch.kernels.imag import ops as imag
    from repro_torch.kernels.ssd import ops as ssd
    counters = {"flash_attention": (fa, "launches"),
                "gmm_equal": (gmm, "equal_launches"),
                "gmm_equal_bwd": (gmm, "equal_bwd_launches"),
                "gmm_ragged": (gmm, "ragged_launches"),
                "gmm_ragged_bwd": (gmm, "ragged_bwd_launches"),
                "gmm_ragged_dw": (gmm, "ragged_dw_launches"),
                "imag_fused": (imag, "launches"),
                "ssd_chunked": (ssd, "launches")}
    assert tuple(counters) == TK.LAUNCH_COUNTERS
    for i, (mod, attr) in enumerate(counters.values()):
        monkeypatch.setattr(mod, attr, 100 + i)
    assert TK.launch_counts() == {k: 100 + i
                                  for i, k in enumerate(counters)}


# ------------------------------------------------------------- pickling
class _NoTensorPickler(pickle.Pickler):
    def persistent_id(self, obj):
        if isinstance(obj, (torch.Tensor, torch.Generator, torch.nn.Module)):
            raise AssertionError(f"a {type(obj).__name__} would cross the "
                                 "process boundary")
        return None


def _plain_pickle(obj) -> bytes:
    buf = io.BytesIO()
    _NoTensorPickler(buf).dump(obj)
    return buf.getvalue()


def _procs_parts(env_name="pendulum"):
    env = make_env(env_name)
    ens = TD.EnsembleConfig(env.obs_dim, env.act_dim, hidden=HIDDEN,
                            n_models=N_MODELS)
    pol = TPI.PolicyConfig(env.obs_dim, env.act_dim, hidden=POLICY_HIDDEN)
    acfg = TA.AlgoConfig(algo="me-trpo", imagine_batch=IMAGINE_BATCH,
                         imagine_horizon=IMAGINE_HORIZON, n_models=N_MODELS)
    return env, ens, pol, acfg


def test_proc_spec_and_handles_pickle_without_a_tensor(tmp_path):
    env, ens, pol, acfg = _procs_parts()
    spec = TW.ProcSpec(env, ens, acfg, pol, TR.RunConfig(total_trajs=3), 7,
                       exploration=TW.ExplorationSchedule((1.0, 1.3)),
                       device="cpu")
    back = pickle.loads(_plain_pickle(spec))
    assert back == spec and back.cpu_threads == 1
    for f in dataclasses.fields(spec):
        assert dataclasses.is_dataclass(getattr(spec, f.name)) or isinstance(
            getattr(spec, f.name), (int, str))
    tree = _torch_tree(_tree(8))
    with TS.ShmParameterServer(tree, dir=str(tmp_path)) as srv, \
            TS.ProcDataServer(dir=str(tmp_path)) as data:
        srv.push(tree)
        for h in (srv, data, TS.ProcControl(2, dir=str(tmp_path))):
            _plain_pickle(h)
        other = pickle.loads(_plain_pickle(srv))
        got, ver = other.pull()
        assert ver == 1 and _equal(got, tree)
        other.close()
        assert os.path.exists(srv.path)     # a child's close keeps the file


def test_a_child_asked_for_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env, ens, pol, acfg = _procs_parts()
    spec = TW.ProcSpec(env, ens, acfg, pol, TR.RunConfig(), 0, device="cuda")
    closed = []
    ch = types.SimpleNamespace(close=lambda: closed.append(True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TW.proc_worker_main("model", spec, ch)
    assert closed == [True]


# ---------------------------------------------------- workers vs the JAX's
def test_push_init_false_holds_back_the_initial_policy():
    jenv = jmake_env("pendulum")
    jpol = JPI.PolicyConfig(jenv.obs_dim, jenv.act_dim, hidden=POLICY_HIDDEN)
    jcfg = JA.AlgoConfig(algo="me-trpo", imagine_batch=IMAGINE_BATCH,
                         imagine_horizon=IMAGINE_HORIZON, n_models=N_MODELS)
    jalgo = JA.make_algo(jcfg, jpol, jax.vmap(jenv.reward), jenv.reset_batch)
    env, ens, pol, acfg = _procs_parts()
    algo = TA.make_algo(acfg, pol, env.reward, env.reset_batch)
    for push_init in (False, True):
        jps, tps = JS.ParameterServer(), TS.ParameterServer()
        JW.PolicyImprovementWorker(jalgo, jps, JS.ParameterServer(),
                                   jax.random.key(0), push_init=push_init)
        TW.PolicyImprovementWorker(algo, tps, TS.ParameterServer(), 0,
                                   push_init=push_init, device="cpu")
        assert tps.version == jps.version == int(push_init)


@pytest.mark.parametrize("lanes,grants", [(1, [1, 1]), (3, [3, 2, 3, 1]),
                                          (3, [2, 1, 3])],
                         ids=["one", "farm", "farm_partial_first"])
def test_collector_compile_count_equals_the_references(lanes, grants):
    JW.clear_rollout_cache()        # the reference counts per compiled fn
    jenv = jmake_env("pendulum")
    jpol = JPI.PolicyConfig(jenv.obs_dim, jenv.act_dim, hidden=POLICY_HIDDEN)
    jw = JW.DataCollectionWorker(
        jenv, JS.ParameterServer(), JS.DataServer(),
        JPI.init_policy(jpol, jax.random.key(0)), jax.random.key(1),
        envs_per_step=lanes)
    env, _, pol, _ = _procs_parts()
    tw = TW.DataCollectionWorker(
        env, TS.ParameterServer(), TS.DataServer(),
        TPI.init_policy(pol, torch.Generator().manual_seed(0)), 1,
        envs_per_step=lanes, device="cpu")
    got, want = [tw.compile_count()], [jw.compile_count()]
    for g in grants:
        tw.step(g)
        jw.step(g)
        got.append(tw.compile_count())
        want.append(jw.compile_count())
    assert got == want
    assert max(got) <= (1 if lanes == 1 else 2)


# ------------------------------------------- no multiprocessing primitive
FORBIDDEN_MP = {"shared_memory", "Lock", "RLock", "Event", "Queue",
                "SimpleQueue", "JoinableQueue", "Value", "Array",
                "RawValue", "RawArray", "Semaphore", "BoundedSemaphore",
                "Condition", "Barrier", "Manager"}
FORBIDDEN_MP_MODULES = {"multiprocessing.shared_memory",
                        "multiprocessing.synchronize",
                        "multiprocessing.queues",
                        "multiprocessing.sharedctypes",
                        "multiprocessing.managers"}


def _mp_primitives(path: pathlib.Path):
    """Every use of a forbidden ``multiprocessing`` primitive in a file:
    ``from multiprocessing import <it>``, an import of its module, or an
    attribute of the ``multiprocessing`` module, of a context from
    ``get_context``, or of a parameter named ``ctx`` outside an autograd
    ``Function``."""
    tree = ast.parse(path.read_text(), str(path))
    mp_names, found = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in FORBIDDEN_MP_MODULES:
                    found.append(a.name)
                elif a.name == "multiprocessing":
                    mp_names.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module in FORBIDDEN_MP_MODULES:
                found.append(node.module)
            elif node.module == "multiprocessing":
                found += [a.name for a in node.names
                          if a.name in FORBIDDEN_MP]
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Call):
            fn = node.value.func
            if isinstance(fn, ast.Attribute) and fn.attr == "get_context":
                mp_names |= {t.id for t in node.targets
                             if isinstance(t, ast.Name)}
        elif isinstance(node, ast.FunctionDef) and node.name == "__init__":
            mp_names |= {a.arg for a in node.args.args if a.arg == "ctx"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in FORBIDDEN_MP \
                and isinstance(node.value, ast.Name) \
                and node.value.id in mp_names:
            found.append(f"{node.value.id}.{node.attr}")
    return found


def test_the_scan_finds_the_references_primitives():
    assert {"shared_memory", "ctx.Queue", "ctx.Lock", "ctx.Value",
            "ctx.Array"} <= set(_mp_primitives(ROOT / "src" / "repro"
                                               / "core" / "servers.py"))
    assert {"ctx.Queue", "ctx.Event", "ctx.Array"} <= set(
        _mp_primitives(ROOT / "src" / "repro" / "core" / "runtime.py"))


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_multiprocessing_primitive_in_the_port(path):
    assert _mp_primitives(path) == []


# --------------------------------------------------- end-to-end runs
def _procs_trainer(ckpt_dir, rc_kw, supervisor=None, **kw):
    env, ens, pol, acfg = _procs_parts()
    rc = TR.RunConfig(seed=0, eval_rollouts=2, snapshot_every_s=0.5,
                      ckpt_dir=str(ckpt_dir), **rc_kw)
    return TR.AsyncTrainer(env, ens, None, rc, mode="procs", algo_cfg=acfg,
                           pol_cfg=pol, supervisor=supervisor, device="cpu",
                           **kw)


def _kill_children(tr):
    for p in getattr(tr, "_procs", {}).values():
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def _finite(tree):
    return all(bool(torch.isfinite(t).all()) for t in tio.flatten(tree))


def _assert_clean_teardown(tr):
    assert not any(p.is_alive() for p in tr._procs.values())
    assert not os.path.exists(tr._run_dir)
    assert id(tr._proc_servers["data"]) not in TS._DATA_REGISTRY
    assert not [p for p in TS.live_shm_segments()
                if p.startswith(tr._run_dir)]


@pytest.mark.timeout(120)
def test_procs_run_lands_exactly_and_trains(tmp_path):
    """A clean run of a fleet, two collectors of three robots on 7
    trajectories: grants of 3 and a partial one land exactly, both learners
    get past their first push, the parent adopts finite params, the policy
    child sends trace rows, no child restarts, every child's report is on
    the plain route with no launch on the CPU, the snapshot loads, and
    nothing of the run is left behind."""
    tr = _procs_trainer(tmp_path, dict(total_trajs=7,
                                       min_final_model_version=1,
                                       min_final_policy_version=2),
                        n_collectors=2, envs_per_collector=3,
                        exploration=TW.ExplorationSchedule((1.0, 1.3)))
    try:
        trace = tr.run()
    finally:
        _kill_children(tr)
    info = tr.proc_info
    assert info["trajs"] == 7 and trace[-1]["trajs"] == 7
    assert tr.collector.collected == 7
    assert info["n_collectors"] == 2 and info["noise_scales"] == [1.0, 1.3]
    assert info["restarts"] == {"model": 0, "policy": 0, "collector:0": 0,
                                "collector:1": 0}
    assert info["model_version"] >= 1 and info["policy_version"] >= 2
    assert tr.model_server.version == 1 and tr.policy_server.version >= 1
    assert _finite(tr.model_worker.params)
    assert _finite(tr.policy_worker.state["policy"])
    assert all(np.isfinite(r["eval_return"]) for r in trace)
    times = [r["time"] for r in trace]
    assert times == sorted(times) and times[0] >= 0.0
    kids = info["children"]
    per = [kids[f"collector:{i}"]["work"] for i in range(2)]
    assert sum(per) == 7 and any(n % 3 for n in per)
    assert all(kids[f"collector:{i}"]["compile_count"] <= 2
               for i in range(2))
    assert kids["model"]["work"] >= 1 and kids["policy"]["work"] >= 1
    for rep in kids.values():
        assert rep["route"] == "plain" and rep["resumed_step"] == -1
        assert set(rep["launches"]) == set(TK.LAUNCH_COUNTERS)
        assert not any(rep["launches"].values())
        assert not any(rep["warmup_launches"].values())
    assert kids["policy"]["warmup_s"] > 0.0
    assert kids["model"]["warmup_s"] == 0.0
    assert kids["model"]["compile_count"] == 1
    spec = TW.ProcSpec(tr.env, tr.ens_cfg, tr.algo_cfg, tr.pol_cfg,
                       tr.run_cfg, 0)
    snap, step = tio.restore(info["ckpt_dir"], TW.snapshot_template(spec))
    assert step is not None and int(snap["model_version"]) >= 1
    _assert_clean_teardown(tr)


class _KillModelAfterSnapshot(TR.Supervisor):
    """SIGKILL the model child right after the first snapshot that holds
    a trained model, then keep the run going until the restarted child has
    published a newer version."""

    def __init__(self):
        self.killed = None

    def on_snapshot(self, step):
        srv = self.trainer._proc_servers["model"]
        if self.killed is None and srv.version >= 1:
            self.killed = {"step": step - 1, "version": srv.version}
            self.trainer.run_cfg.min_final_model_version = srv.version + 1
            os.kill(self.trainer._procs["model"].pid, signal.SIGKILL)


@pytest.mark.timeout(150)
def test_model_child_killed_comes_back_from_its_snapshot(tmp_path):
    sup = _KillModelAfterSnapshot()
    tr = _procs_trainer(tmp_path, dict(total_trajs=6, pace_collection=True,
                                       collect_speed=10.0), supervisor=sup)
    try:
        tr.run()
    finally:
        _kill_children(tr)
    info = tr.proc_info
    assert sup.killed is not None
    assert info["restarts"]["model"] == 1
    assert info["trajs"] == 6
    assert info["model_version"] > sup.killed["version"]
    assert info["children"]["model"]["resumed_step"] >= sup.killed["step"]
    assert _finite(tr.model_worker.params)
    _assert_clean_teardown(tr)


class _KillCollectorOnSpawn(TR.Supervisor):
    def __init__(self):
        self.exits = []

    def on_spawn(self, role, proc, resume):
        if role == "collector:0":
            proc.kill()

    def on_child_exit(self, role, exitcode, n_restarts):
        self.exits.append((role, exitcode, n_restarts))


@pytest.mark.timeout(120)
def test_collector_killed_past_its_budget_fails_loudly(tmp_path):
    sup = _KillCollectorOnSpawn()
    tr = _procs_trainer(tmp_path, dict(total_trajs=4, max_restarts=1),
                        supervisor=sup)
    try:
        with pytest.raises(RuntimeError,
                           match=r"collector:0 worker crashed \(exit -9\) "
                                 r"more than max_restarts=1"):
            tr.run()
    finally:
        _kill_children(tr)
    assert sup.exits == [("collector:0", -9, 1), ("collector:0", -9, 2)]
    assert sup.trainer is None              # detached in the teardown
    _assert_clean_teardown(tr)


def test_launcher_mode_procs_needs_the_async_engine():
    with pytest.raises(SystemExit, match="--engine async"):
        launch.main(["--mode", "procs", "--engine", "sequential",
                     "--device", "cpu", "--trajs", "1"])
