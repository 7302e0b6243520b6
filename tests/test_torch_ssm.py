"""The Mamba2 serving path of the PyTorch port against the JAX reference.

``mamba2_2_7b`` REDUCED with chunk 32 (so the 40-token prompts span a
padded second chunk) on both sides, from one set of parameters: the JAX
``init_params`` tree converted by ``repro_torch.testing.parity``. In f32:

* the Mamba block's ``mamba_forward`` (with and without the state) and
  ``mamba_decode``;
* ``loss_forward``'s ``(sum, count)``;
* the lock-step prefill's logits and cache (``ssm``, ``conv_x``,
  ``conv_bc``, ``index``), one decode step's logits and cache, and eight
  greedy decode tokens, against the reference's ``api.build`` steps;

all at ``TOL`` (atol/rtol 1e-4: one function, f32 sums in another order).
One bf16 prefill and decode holds the logits to ``BF16_TOL`` of their
scale: the two frameworks may round bf16 intermediates at other places.
``loss_forward``'s dense branch is held against JAX on GLM-4-9B REDUCED.
The branches the port does not have yet raise with a pointer to the
roadmap.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import api as japi
from repro.models import lm as JLM
from repro.models import ssm as JS
from repro.models.config import InputShape as JInputShape
from repro.models.config import ShardCtx
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import api
from repro_torch.models import lm as LM
from repro_torch.models import ssm as S
from repro_torch.models.config import InputShape
from repro_torch.testing.parity import state_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 1e-2
CPU = "cpu"
CTX = ShardCtx()
B, SEQ, GEN = 2, 40, 8


def _cfgs(dtype):
    return tuple(dataclasses.replace(get(
        "mamba2_2_7b", reduced=True), ssm_chunk=32, dtype=dtype)
        for get in (jax_get_config, get_config))


def _params(cfgs, seed):
    jcfg, tcfg = cfgs
    jp = JLM.init_params(jcfg, CTX, jax.random.key(seed))
    state = state_from_jax(jax.tree.map(np.asarray, jp))
    return jp, state, LM.LM.from_state_dict(tcfg, state)


@pytest.fixture(scope="module")
def f32():
    cfgs = _cfgs("float32")
    return cfgs, _params(cfgs, 1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tokens(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["layers"]["mamba"])


def test_state_from_jax_carries_the_mamba_tree():
    """The converter carries ``{"embed", "layers": {"mamba": ...}}`` over
    leaf for leaf, bit for bit, each leaf in its own dtype (bf16 weights,
    f32 A_log / D / dt_bias)."""
    cfgs = _cfgs("bfloat16")
    jp, state, model = _params(cfgs, 2)
    mamba = jp["layers"]["mamba"]
    assert set(state) == {f"embed.{k}" for k in jp["embed"]} | {
        f"layers.{i}.mamba.{k}" for i in range(cfgs[1].num_layers)
        for k in mamba}
    for i in range(cfgs[1].num_layers):
        for k, v in mamba.items():
            t = state[f"layers.{i}.mamba.{k}"]
            assert str(t.dtype) == f"torch.{np.asarray(v).dtype}", k
            np.testing.assert_array_equal(_np(t), np.asarray(v[i], np.float32))
    assert model.layers[1].mamba.A_log.dtype == torch.float32
    assert model.layers[1].mamba.wx.dtype == torch.bfloat16


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_forward_matches_jax(f32, with_state):
    (jcfg, tcfg), (jp, _, model) = f32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, SEQ, tcfg.d_model)).astype(np.float32)
    s0 = None
    if with_state:
        s0 = (rng.standard_normal((B, tcfg.ssm_heads, tcfg.ssm_head_dim,
                                   tcfg.ssm_state)) * 0.5).astype(np.float32)
    jout, (jst, jtx, jtbc) = JS.mamba_forward(
        jcfg, CTX, _layer0(jp), jnp.asarray(x), return_state=True,
        initial_state=None if s0 is None else jnp.asarray(s0))
    out, (st, tx, tbc) = S.mamba_forward(
        tcfg, model.layers[0].mamba, torch.from_numpy(x), return_state=True,
        initial_state=None if s0 is None else torch.from_numpy(s0))
    for name, got, want in (("out", out, jout), ("ssm", st, jst),
                            ("tail_x", tx, jtx), ("tail_bc", tbc, jtbc)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=name)
    stateless = S.mamba_forward(tcfg, model.layers[0].mamba,
                                torch.from_numpy(x))
    if not with_state:
        np.testing.assert_allclose(_np(stateless), _np(jout), **TOL)


def test_mamba_decode_matches_jax(f32):
    (jcfg, tcfg), (jp, _, model) = f32
    rng = np.random.default_rng(4)
    W, gn2 = tcfg.ssm_conv - 1, 2 * tcfg.ssm_groups * tcfg.ssm_state
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    st = (rng.standard_normal((B, tcfg.ssm_heads, tcfg.ssm_head_dim,
                               tcfg.ssm_state)) * 0.5).astype(np.float32)
    cx = rng.standard_normal((B, W, tcfg.d_inner)).astype(np.float32)
    cbc = rng.standard_normal((B, W, gn2)).astype(np.float32)
    want = JS.mamba_decode(jcfg, CTX, _layer0(jp), *map(jnp.asarray,
                                                        (x, st, cx, cbc)))
    got = S.mamba_decode(tcfg, model.layers[0].mamba,
                         *map(torch.from_numpy, (x, st, cx, cbc)))
    for name, g, w in zip(("out", "ssm", "conv_x", "conv_bc"), got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL, err_msg=name)


def test_loss_forward_matches_jax(f32):
    (jcfg, tcfg), (jp, _, model) = f32
    tokens = _tokens(tcfg, (B, SEQ), 5)
    labels = _tokens(tcfg, (B, SEQ), 6)
    labels[0, :7] = -1                  # ignored positions
    js, jc, _ = JLM.loss_forward(jcfg, CTX, jp, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        remat=False)
    before = ssd_ops.launches
    s, c, aux = LM.loss_forward(tcfg, model, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)})
    assert ssd_ops.launches == before   # CPU tensors: the plain scan
    assert int(c) == int(jc) == B * SEQ - 7 and float(aux) == 0.0
    np.testing.assert_allclose(float(s), float(js), **TOL)


def test_dense_loss_forward_matches_jax():
    """``loss_forward``'s dense branch (the stack without a cache), on
    GLM-4-9B REDUCED in f32."""
    jcfg, tcfg = (dataclasses.replace(get("glm4-9b", reduced=True),
                                      dtype="float32")
                  for get in (jax_get_config, get_config))
    jp = JLM.init_params(jcfg, CTX, jax.random.key(11))
    model = LM.LM.from_state_dict(tcfg,
                                  state_from_jax(jax.tree.map(np.asarray, jp)))
    tokens, labels = _tokens(tcfg, (B, 16), 12), _tokens(tcfg, (B, 16), 13)
    js, jc, _ = JLM.loss_forward(jcfg, CTX, jp, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)},
        remat=False)
    s, c, _ = LM.loss_forward(tcfg, model, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)})
    assert int(c) == int(jc) == B * 16
    np.testing.assert_allclose(float(s), float(js), **TOL)


def _jax_steps(jcfg, mesh, S0, n_new):
    pre = japi.build(jcfg, mesh, JInputShape("p", S0, B, "prefill"))
    dec = japi.build(jcfg, mesh, JInputShape("d", S0 + n_new, B, "decode"))
    return pre, dec


def _port_steps(tcfg, S0, n_new):
    return (api.build(tcfg, InputShape("p", S0, B, "prefill"), device=CPU),
            api.build(tcfg, InputShape("d", S0 + n_new, B, "decode"),
                      device=CPU))


def test_prefill_and_decode_match_jax(f32, mesh1):
    (jcfg, tcfg), (jp, _, model) = f32
    tokens = _tokens(tcfg, (B, SEQ + 1), 7)
    jpre, jdec = _jax_steps(jcfg, mesh1, SEQ, 1)
    tpre, tdec = _port_steps(tcfg, SEQ, 1)
    jlg, jc = jpre.fn(jp, {"tokens": jnp.asarray(tokens[:, :SEQ])})
    tlg, tc = tpre.fn(model, {"tokens": torch.from_numpy(tokens[:, :SEQ])})
    assert tlg.shape == (B, tcfg.padded_vocab(1))
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    empty, jempty = (LM.init_cache(tcfg, B, device=CPU),
                     JLM.init_cache(jcfg, CTX, B, SEQ))
    for key in ("ssm", "conv_x", "conv_bc", "index"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        assert empty[key].dtype == tc[key].dtype, key
        np.testing.assert_array_equal(_np(empty[key]), _np(jempty[key]))
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=key)
    tok = tokens[:, SEQ:]
    jlg, jc = jdec.fn(jp, jc, jnp.asarray(tok))
    ssm_buf = tc["ssm"]
    tlg, tc = tdec.fn(model, tc, torch.from_numpy(tok.copy()))
    assert tc["ssm"] is ssm_buf         # updated in place
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    for key in ("ssm", "conv_x", "conv_bc", "index"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=key)


def test_greedy_decode_emits_jax_tokens(f32, mesh1):
    """As ``test_arch_smoke.py::test_multi_step_decode`` runs the
    reference: prefill 16 tokens, then 8 greedy decode steps; the port
    emits the same tokens, from logits within TOL, through one decode
    shape."""
    (jcfg, tcfg), (jp, _, model) = f32
    S0 = 16
    tokens = _tokens(tcfg, (B, S0), 8)
    jpre, jdec = _jax_steps(jcfg, mesh1, S0, GEN)
    tpre, tdec = _port_steps(tcfg, S0, GEN)
    jlg, jc = jpre.fn(jp, {"tokens": jnp.asarray(tokens)})
    tlg, tc = tpre.fn(model, {"tokens": torch.from_numpy(tokens)})
    jtoks, ttoks = [], []
    for _ in range(GEN):
        jt = jnp.argmax(jlg[:, :jcfg.vocab_size], -1)[:, None].astype(
            jnp.int32)
        tt = torch.argmax(tlg[:, :tcfg.vocab_size], -1)[:, None].to(
            torch.int32)
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
        jlg, jc = jdec.fn(jp, jc, jt)
        tlg, tc = tdec.fn(model, tc, tt)
        np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))
    assert int(tc["index"]) == S0 + GEN
    assert tdec.fn.shape_count == 1


def test_bf16_prefill_and_decode_match_jax(mesh1):
    cfgs = _cfgs("bfloat16")
    (jcfg, tcfg), (jp, _, model) = cfgs, _params(cfgs, 9)
    tokens = _tokens(tcfg, (B, SEQ + 1), 10)
    jpre, jdec = _jax_steps(jcfg, mesh1, SEQ, 1)
    tpre, tdec = _port_steps(tcfg, SEQ, 1)
    jlg, jc = jpre.fn(jp, {"tokens": jnp.asarray(tokens[:, :SEQ])})
    tlg, tc = tpre.fn(model, {"tokens": torch.from_numpy(tokens[:, :SEQ])})
    assert tc["ssm"].dtype == torch.float32
    assert tc["conv_x"].dtype == torch.bfloat16
    jlg2, _ = jdec.fn(jp, jc, jnp.asarray(tokens[:, SEQ:]))
    tlg2, _ = tdec.fn(model, tc, torch.from_numpy(tokens[:, SEQ:].copy()))
    for name, got, want in (("prefill", tlg, jlg), ("decode", tlg2, jlg2)):
        want = _np(want)
        err = np.abs(_np(got) - want).max()
        assert err <= BF16_TOL * max(1.0, np.abs(want).max()), (name, err)


def test_unported_branches_raise_with_a_roadmap_pointer():
    """What is not ported or not supported raises with a pointer to the
    roadmap: a role mesh for the procs engine (``mesh=`` or ``roles=``;
    the reference's own ValueError, per-process meshes being future work),
    and a gradient through the moe experts' bf16 kernel route
    (forward-only, as the reference's; the moe and hybrid families train
    through their plain routes, held against the reference in
    ``test_torch_lm_train.py``)."""
    from repro_torch.core import AsyncTrainer, RunConfig
    from repro_torch.core.roles import split_roles
    from repro_torch.envs import make_env
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.mbrl.algos import AlgoConfig, make_algo
    from repro_torch.mbrl.dynamics import EnsembleConfig
    from repro_torch.mbrl.policy import PolicyConfig
    env = make_env("pendulum")
    ens = EnsembleConfig(env.obs_dim, env.act_dim, hidden=8, n_models=2)
    pol = PolicyConfig(env.obs_dim, env.act_dim, hidden=8)
    algo = make_algo(AlgoConfig(imagine_batch=4, imagine_horizon=3,
                                n_models=2), pol, env.reward, env.reset_batch)
    mesh = make_mesh(4, device=CPU)
    for kw in (dict(mesh=mesh), dict(roles=split_roles(mesh))):
        with pytest.raises(ValueError, match="ROADMAP"):
            AsyncTrainer(env, ens, algo, RunConfig(total_trajs=1),
                         mode="procs", device=CPU, **kw)
    dy = torch.ones((3, 2), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gmm_ops.RaggedGroupedMatmulBf16.backward(None, dy)


def test_entry_points_refuse_to_run_without_cuda(f32, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = f32[0][1]
    for call in (lambda: LM.init_params(tcfg, 0),
                 lambda: LM.init_cache(tcfg, B),
                 lambda: api.build(tcfg, InputShape("p", 8, B, "prefill"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
