"""The serving path of the PyTorch port against the JAX reference.

``glm4-9b`` REDUCED in f32 on both sides, from one set of parameters (the
JAX ``init_params`` tree converted by ``repro_torch.testing.parity``):

* prefill logits and cache, then decode logits and cache, against the JAX
  ``build_serve_prefill`` / ``build_serve_decode`` on ``make_smoke_mesh()``
  at atol/rtol 1e-4 (the same function, f32 sums in another order);
* end to end, the JAX and the port ``WorldModelServer`` emit IDENTICAL
  greedy tokens for the same prompts, across a mid-run hot swap;
* the serving tier's own invariants on the port: FIFO admission, page
  conservation, backpressure, one decode shape and at most one prefill
  shape per bucket, ``grow_cache`` padding ``pos`` with -1, and entry
  points that refuse to run without CUDA unless given ``device="cpu"``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.servers import ParameterServer as JaxParameterServer
from repro.launch.mesh import make_smoke_mesh
from repro.models import api as japi
from repro.models import lm as JLM
from repro.serve import WorldModelServer as JaxWorldModelServer
from repro_torch.configs import get_config
from repro_torch.core.servers import BackpressureError, ParameterServer
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import api
from repro_torch.models import lm as LM
from repro_torch.serve import RequestQueue, WorldModelServer
from repro_torch.serve import __main__ as serve_main
from repro_torch.testing.parity import state_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"


@pytest.fixture(scope="module")
def cfgs():
    return (dataclasses.replace(jax_get_config("glm4-9b", reduced=True),
                                dtype="float32"),
            dataclasses.replace(get_config("glm4-9b", reduced=True),
                                dtype="float32"))


@pytest.fixture(scope="module")
def mesh():
    return make_smoke_mesh()


def _params(cfgs, mesh, seed):
    jcfg, tcfg = cfgs
    jp = JLM.init_params(jcfg, japi.shard_ctx(mesh), jax.random.key(seed))
    state = state_from_jax(jax.tree.map(np.asarray, jp))
    return jp, state, LM.LM.from_state_dict(tcfg, state)


@pytest.fixture(scope="module")
def v1(cfgs, mesh):
    return _params(cfgs, mesh, 1)


@pytest.fixture(scope="module")
def v2(cfgs, mesh):
    return _params(cfgs, mesh, 2)


@pytest.fixture(scope="module")
def server(cfgs, v1):
    """Shared small port server: 2 slots, buckets (8, 16), 8-token pages."""
    return WorldModelServer(cfgs[1], params=v1[2], device=CPU, n_slots=2,
                            max_seq=32, page_len=8, prompt_buckets=(8, 16))


def _prompt(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, n).astype(np.int32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the slice's programs against the reference -----------------------------


def test_prefill_then_decode_match_jax(cfgs, mesh, v1):
    jcfg, tcfg = cfgs
    jp, _, model = v1
    B, PLEN, GEN = 2, 8, 4
    plens = np.asarray([8, 5], np.int32)  # row 1 right-pads in the bucket
    tokens = np.stack([_prompt(tcfg, PLEN, s) for s in (3, 4)])
    tokens[1, plens[1]:] = 0
    jpre = japi.build_serve_prefill(jcfg, mesh, B, PLEN)
    jdec = japi.build_serve_decode(jcfg, mesh, B, PLEN + GEN)
    tpre = api.build_serve_prefill(tcfg, B, PLEN, device=CPU)
    tdec = api.build_serve_decode(tcfg, B, PLEN + GEN, device=CPU)

    jlg, jc = jpre.fn(jp, {"tokens": jnp.asarray(tokens)},
                      jnp.asarray(plens))
    tlg, tc = tpre.fn(model, {"tokens": torch.from_numpy(tokens)},
                      torch.from_numpy(plens))
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    for key in ("k", "v", "pos", "index"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=key)

    s_c = PLEN + GEN + 1
    jc, tc = japi.grow_cache(jc, s_c), api.grow_cache(tc, s_c)
    tok = np.argmax(_np(tlg)[:, :tcfg.vocab_size], -1).astype(np.int32)
    for step in range(GEN):
        active = np.asarray([True, step < 2])  # row 1 retires mid-way
        jlg, jc = jdec.fn(jp, jc, jnp.asarray(tok[:, None]),
                          jnp.asarray(active))
        tlg, tc = tdec.fn(model, tc, torch.from_numpy(tok[:, None].copy()),
                          torch.from_numpy(active))
        np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
        for key in ("k", "v", "pos", "index"):
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                       err_msg=f"step {step} {key}")
        tok = np.argmax(_np(tlg)[:, :tcfg.vocab_size], -1).astype(np.int32)
    assert tdec.fn.shape_count == 1 and tpre.fn.shape_count == 1


def test_servers_emit_identical_greedy_tokens_across_a_hot_swap(
        cfgs, mesh, v1, v2):
    jcfg, tcfg = cfgs
    jps, tps = JaxParameterServer(), ParameterServer()
    jps.push(v1[0])
    tps.push(v1[1])
    kw = dict(n_slots=2, max_seq=32, page_len=8, prompt_buckets=(8, 16))
    jsrv = JaxWorldModelServer(jcfg, mesh, param_server=jps, **kw)
    tsrv = WorldModelServer(tcfg, param_server=tps, device=CPU, **kw)
    specs = [(5, 6), (13, 4), (3, 7), (16, 3), (9, 5)]
    jr, tr = [], []
    for i, (plen, new) in enumerate(specs):
        prompt = _prompt(tcfg, plen, 50 + i)
        jr.append(jsrv.submit(prompt, max_new=new))
        tr.append(tsrv.submit(prompt, max_new=new))
        jsrv.step()
        tsrv.step()
        if i == 1:  # a mid-run training push, decoded from the next tick
            jps.push(v2[0])
            tps.push(v2[1])
    jsrv.run()
    tsrv.run()
    for j, t, (_, new) in zip(jr, tr, specs):
        assert tsrv.result(t).shape == (new,)
        np.testing.assert_array_equal(tsrv.result(t), jsrv.result(j))
    js, ts = jsrv.stats(), tsrv.stats()
    for key in ("tokens_generated", "decode_ticks", "hot_swaps", "version",
                "decode_compiles", "prefill_compiles", "admit_compiles"):
        assert ts[key] == js[key], key
    assert ts["hot_swaps"] == 1 and ts["version"] == 2


# -- the serving tier's invariants on the port ------------------------------


def test_grow_cache_pads_pos_with_empty_slots():
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.normal(size=(2, 3, 4, 2, 5)).astype(np.float32))
    cache = {"index": torch.tensor(4), "k": k, "v": k * 2,
             "pos": torch.tensor([0, 1, 2, 3], dtype=torch.int32),
             "k_scale": torch.ones((2, 3, 4, 2, 1)),
             "v_scale": torch.ones((2, 3, 4, 2, 1))}
    out = api.grow_cache(cache, 7)
    pad5 = ((0, 0),) * 2 + ((0, 3),) + ((0, 0),) * 2
    np.testing.assert_array_equal(out["k"].numpy(), np.pad(k.numpy(), pad5))
    np.testing.assert_array_equal(out["v"].numpy(),
                                  np.pad(2 * k.numpy(), pad5))
    assert out["k_scale"].shape == (2, 3, 7, 2, 1)
    # a 0-padded pos would alias position 0: the padding must be -1
    assert out["pos"].tolist() == [0, 1, 2, 3, -1, -1, -1]
    slot = {"index": torch.tensor([2]), "k": k[:, :1], "v": k[:, :1],
            "pos": torch.tensor([[0, 1, -1, -1]], dtype=torch.int32)}
    assert api.grow_cache(slot, 6)["pos"].tolist() == [[0, 1] + [-1] * 4]
    assert api.grow_cache(cache, 4)["k"] is cache["k"]
    with pytest.raises(ValueError, match="shrink"):
        api.grow_cache(cache, 3)
    with pytest.raises(ValueError, match="attention"):
        api.grow_cache({"ssm": k, "index": 0}, 8)


def test_churn_fifo_page_conservation_and_shape_counts(cfgs, server):
    tcfg = cfgs[1]
    start = len(server.sched.admit_order)
    specs = [(3, 4), (8, 3), (11, 5), (5, 2), (16, 4), (2, 6), (9, 3),
             (7, 5)]
    rids = []
    for i, (plen, new) in enumerate(specs):
        rids.append(server.submit(_prompt(tcfg, plen, 20 + i), max_new=new))
        if i % 3 == 2:
            server.step()
        free, held = server.sched.pool.accounting()
        assert free + held == server.sched.pool.n_pages
    while server.pending:
        server.step()
        free, held = server.sched.pool.accounting()
        assert free + held == server.sched.pool.n_pages
    assert server.sched.admit_order[start:] == rids  # FIFO
    for rid, (_, new) in zip(rids, specs):
        assert server.result(rid).shape == (new,)
    cc = server.sched.compile_counts()
    assert cc["decode"] == 1, cc
    assert cc["prefill"] <= len(server.sched.buckets), cc
    assert cc["admit"] <= len(server.sched.buckets), cc
    assert server.sched.pool.accounting() == (server.sched.pool.n_pages, 0)


def test_request_isolation_under_cotenancy(cfgs, server):
    tcfg = cfgs[1]
    prompt = _prompt(tcfg, 6, 10)
    rid = server.submit(prompt, max_new=5)
    server.run()
    alone = server.result(rid)
    again = server.submit(prompt, max_new=5)
    server.step()
    server.submit(_prompt(tcfg, 13, 11), max_new=4)
    server.submit(_prompt(tcfg, 3, 12), max_new=6)
    server.run()
    np.testing.assert_array_equal(server.result(again), alone)


def test_backpressure_and_submit_validation(cfgs, server):
    tcfg = cfgs[1]
    q = RequestQueue(maxsize=2, submit_timeout=0.0)
    q.submit("a")
    q.submit("b")
    with pytest.raises(BackpressureError, match="decode loop"):
        q.submit("c")
    assert q.pop() == "a" and q.pop() == "b"
    with pytest.raises(ValueError, match="largest.*bucket"):
        server.submit(_prompt(tcfg, 17, 0), max_new=2)
    with pytest.raises(ValueError, match="capacity"):
        server.submit(_prompt(tcfg, 16, 0), max_new=100)
    with pytest.raises(ValueError, match="empty"):
        server.submit([], max_new=2)
    old = server.queue.maxsize
    try:
        server.queue.maxsize = 1
        server.submit(_prompt(tcfg, 4, 1), max_new=1)
        with pytest.raises(BackpressureError):
            server.submit(_prompt(tcfg, 4, 2), max_new=1)
    finally:
        server.queue.maxsize = old
        server.run()


def test_page_exhaustion_blocks_admission(cfgs, v1):
    tcfg = cfgs[1]
    srv = WorldModelServer(tcfg, params=v1[2], device=CPU, n_slots=2,
                           max_seq=32, page_len=16, n_pages=2,
                           prompt_buckets=(16,))
    r1 = srv.submit(_prompt(tcfg, 14, 30), max_new=6)   # 20 tokens: 2 pages
    r2 = srv.submit(_prompt(tcfg, 12, 31), max_new=6)
    srv.step()
    assert srv.sched.slot_req[0] is not None
    assert len(srv.queue) == 1                          # r2 page-starved
    assert srv.sched.pool.accounting() == (0, 2)
    srv.run()
    assert srv.result(r1).shape == (6,) and srv.result(r2).shape == (6,)
    assert srv.sched.pool.accounting() == (2, 0)
    assert srv.sched.admit_order == [r1, r2]


def test_hot_swap_repoints_without_copies(cfgs, v1, v2):
    tcfg = cfgs[1]
    ps = ParameterServer()
    ps.push(v1[1])
    srv = WorldModelServer(tcfg, param_server=ps, device=CPU, n_slots=1,
                           max_seq=32, prompt_buckets=(8,))
    stored, _ = ps.pull()
    wq = srv.model.layers[0].attn.wq
    assert wq.data_ptr() == stored["layers.0.attn.wq"].data_ptr()
    assert stored["layers.0.attn.wq"].data_ptr() != \
        v1[1]["layers.0.attn.wq"].data_ptr()  # push snapshots a clone
    assert srv.maybe_swap() is False                    # unchanged version
    assert srv.model.layers[0].attn.wq is wq
    ps.push(v2[1])
    assert srv.maybe_swap() is True and srv.version == ps.version == 2
    stored, _ = ps.pull()
    assert srv.model.layers[0].attn.wq.data_ptr() == \
        stored["layers.0.attn.wq"].data_ptr()           # repointed, no copy
    assert not srv.model.layers[0].attn.wq.requires_grad


def test_serve_rejects_cache_layouts_it_does_not_support(cfgs):
    tcfg = cfgs[1]
    with pytest.raises(ValueError, match="attention KV cache"):
        api.build_serve_decode(dataclasses.replace(tcfg, family="ssm"), 2,
                               32, device=CPU)
    with pytest.raises(ValueError, match="attention KV cache"):
        api.build_serve_prefill(get_config("zamba2-7b", reduced=True), 1,
                                16, device=CPU)
    with pytest.raises(ValueError, match="sliding-window"):
        api.build_serve_prefill(dataclasses.replace(tcfg, attn_window=8), 1,
                                16, device=CPU)
    with pytest.raises(ValueError, match="encdec"):
        api.build_serve_prefill(get_config("seamless-m4t-medium",
                                           reduced=True), 1, 16, device=CPU)


def test_cpu_serving_never_launches_the_kernel(cfgs, v1, monkeypatch):
    monkeypatch.setattr(fa_ops, "launches", 0)
    srv = WorldModelServer(cfgs[1], params=v1[2], device=CPU, n_slots=1,
                           max_seq=32, prompt_buckets=(8,))
    srv.submit(_prompt(cfgs[1], 5, 60), max_new=2)
    srv.run()
    assert fa_ops.launches == 0


def test_entry_points_refuse_to_run_without_cuda(cfgs, v1, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = cfgs[1]
    for call in (lambda: LM.init_params(tcfg, 0),
                 lambda: LM.init_cache_slots(tcfg, 2, 16),
                 lambda: api.build_serve_prefill(tcfg, 1, 16),
                 lambda: api.build_serve_decode(tcfg, 2, 16),
                 lambda: WorldModelServer(tcfg, params=v1[2]),
                 lambda: serve_main.main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cli_runs_on_cpu_when_asked(capsys):
    assert serve_main.main(["--requests", "3", "--max-new", "3"],
                           device=CPU) == 0
    out = capsys.readouterr().out
    assert '"hot_swaps": 1' in out and '"decode_compiles": 1' in out
