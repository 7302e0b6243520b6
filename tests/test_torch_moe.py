"""The moe family of the PyTorch port against the JAX reference.

The MoE FFN (``repro_torch.models.moe``) at ``ShardCtx()`` in f32, from one
set of parameters (the JAX ``init_moe`` tree converted leaf for leaf):
``_route``, ``_dispatch``, ``moe_forward_dropless`` and ``moe_forward``
against the JAX functions at ``TOL`` (atol/rtol 1e-4: one function, f32
sums in another order). The tokens are kept where every gap between the
sorted top ``k + 1`` router probabilities exceeds ``MARGIN``, so that the
two frameworks' sums cannot pick different experts. The dropless group
sizes sum to T·k; dropless equals the capacity buffers when nothing
overflows, the reference's own case.

Then the lock-step programs on the three REDUCED moe configs (``mixtral``
with its 64-token window, which the 70-token prompt wraps; ``moonshot``;
``qwen3-moe`` with ``qk_norm``) in f32: prefill logits and cache, ``GEN``
teacher-forced decodes and the final cache, against the reference's
``make_prefill`` / ``make_decode`` / ``init_cache``, which on this CPU
run the capacity buffers, as the port does on CPU tensors. The int8 cache
on ``moonshot`` (codes one step off only at a rounding tie); one bf16 run
whose prefill and decode logits agree to ``BF16_TOL`` of their scale with
the reference run op by op (``jax.disable_jit``: its bf16 roundings where
its code has them; XLA's fusions in the jitted scan skip some, which moves
the logits by about 1% at these widths); the slot programs of
the serve tier against ``make_prefill_slots`` / ``make_decode_slots``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import api as japi
from repro.models import lm as JLM
from repro.models import moe as JMOE
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import ShardCtx
from repro_torch.configs import get_config
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import moe as M
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.testing.parity import state_from_jax, tree_from_jax
from test_torch_lockstep import _assert_codes_at_ties

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 1e-2
MARGIN = 1e-4
CPU = "cpu"
CTX = ShardCtx()
B, GEN = 2, 6
# arch, prompt length (mixtral's window is 64: its ring wraps in the prompt)
CASES = [("mixtral-8x7b", 70), ("moonshot-v1-16b-a3b", 12),
         ("qwen3-moe-235b-a22b", 12)]
CASE_IDS = ["mixtral_window64", "moonshot", "qwen3_moe_qk_norm"]
# the reference's tests/test_kernels.py::test_moe_dropless_matches_capacity_path
SMALL = dict(name="t", family="moe", num_layers=1, d_model=16, num_heads=2,
             num_kv_heads=2, d_ff=32, vocab_size=64, num_experts=4, top_k=2,
             capacity_factor=8.0, dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(arch, dtype="float32"):
    return tuple(dataclasses.replace(get(arch, reduced=True), dtype=dtype)
                 for get in (jax_get_config, get_config))


def _block(cfg_kw, seed):
    jcfg, tcfg = JModelConfig(**cfg_kw), ModelConfig(**cfg_kw)
    jp = JMOE.init_moe(jcfg, CTX, jax.random.key(seed))
    return jcfg, tcfg, jp, tree_from_jax(jax.tree.map(np.asarray, jp))


def _separated_tokens(jcfg, jp, n, seed):
    """``n`` tokens (1, n, d) whose sorted top ``k + 1`` router
    probabilities (the reference's) are each more than ``MARGIN`` apart."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4 * n, jcfg.d_model)).astype(np.float32)
    h = JMOE.rmsnorm(jnp.asarray(x), jp["ln"])
    probs, _, _ = JMOE._route(jcfg, jp["router"], h)
    top = -np.sort(-np.asarray(probs), -1)[:, :jcfg.top_k + 1]
    keep = (-np.diff(top, axis=-1) > MARGIN).all(-1)
    assert keep.sum() >= n
    return x[keep][:n][None]


@pytest.fixture(scope="module")
def block():
    kw = dict(SMALL, d_model=32, d_ff=48)
    jcfg, tcfg, jp, tp = _block(kw, 0)
    return jcfg, tcfg, jp, tp, _separated_tokens(jcfg, jp, 24, 1)


def test_route_matches_jax(block):
    jcfg, tcfg, jp, tp, x = block
    h = x[0]
    jprobs, jw, jidx = JMOE._route(jcfg, jp["router"], jnp.asarray(h))
    probs, w, idx = M._route(tcfg, tp["router"], torch.from_numpy(h))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(probs), _np(jprobs), **TOL)
    np.testing.assert_allclose(_np(w), _np(jw), **TOL)


def test_dispatch_matches_jax_with_an_overflow(block):
    """Capacity 8 for 24 tokens a choice: some experts overflow into the
    last slot, whose contents the combine never reads."""
    jcfg, tcfg, jp, tp, x = block
    _, _, jidx = JMOE._route(jcfg, jp["router"], jnp.asarray(x[0]))
    idx = torch.from_numpy(np.array(jidx)).long()
    jbuf, jslots, jcounts = JMOE._dispatch(jcfg, jnp.asarray(x[0]), jidx, 8)
    buf, slots, counts = M._dispatch(tcfg, torch.from_numpy(x[0]), idx, 8)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(counts.max()) > 8
    np.testing.assert_array_equal(_np(buf)[:, :8], _np(jbuf)[:, :8])


def test_dropless_matches_jax_and_its_sizes_sum_to_t_k(block, monkeypatch):
    jcfg, tcfg, jp, tp, x = block
    sizes = []
    real = gmm_ops.grouped_matmul

    def spy(lhs, rhs, group_sizes=None, **kw):
        sizes.append(group_sizes.clone())
        return real(lhs, rhs, group_sizes, **kw)
    monkeypatch.setattr(gmm_ops, "grouped_matmul", spy)
    jy, jaux = jax.jit(lambda p, v: JMOE.moe_forward_dropless(jcfg, p, v))(
        jp, jnp.asarray(x))
    y, aux = M.moe_forward_dropless(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    T = x.shape[0] * x.shape[1]
    assert len(sizes) == 3
    for gs in sizes:
        assert gs.dtype == torch.int32 and gs.shape == (tcfg.num_experts,)
        assert int(gs.sum()) == T * tcfg.top_k
    # the plain route the card holds the kernel to, named through the layer
    y_ref, _ = M.moe_forward_dropless(tcfg, tp, torch.from_numpy(x),
                                      gmm_impl="ref")
    np.testing.assert_allclose(_np(y_ref), _np(jy), **TOL)


def test_moe_forward_matches_jax_and_takes_the_capacity_path(block):
    jcfg, tcfg, jp, tp, x = block
    cap_cfg = dataclasses.replace(jcfg, capacity_factor=8.0)
    jy, jaux = JMOE.moe_forward(cap_cfg, CTX, jp, jnp.asarray(x))
    y, aux = M.moe_forward(dataclasses.replace(tcfg, capacity_factor=8.0),
                           tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # a small capacity drops tokens on both sides alike
    small = dataclasses.replace(tcfg, capacity_factor=0.5)
    jy, _ = JMOE.moe_forward(dataclasses.replace(jcfg, capacity_factor=0.5),
                             CTX, jp, jnp.asarray(x))
    y, _ = M.moe_forward(small, tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    assert M.capacity(small, 24) == JMOE.capacity(small, 24)


def test_dropless_matches_capacity_when_nothing_drops():
    """The reference's own case (its ``test_moe_dropless_matches_capacity_
    path``): both dispatches of the port agree, and agree with the
    reference's dropless path."""
    jcfg, tcfg, jp, tp = _block(SMALL, 0)
    rng = np.random.default_rng(40)
    x = (rng.standard_normal((2, 8, 16)) * 0.5).astype(np.float32)
    y_cap, aux_cap = M.moe_forward_capacity(tcfg, tp, torch.from_numpy(x))
    y_drop, aux_drop = M.moe_forward_dropless(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y_drop), _np(y_cap), **TOL)
    np.testing.assert_allclose(float(aux_drop), float(aux_cap), rtol=1e-5)
    jy, _ = jax.jit(lambda p, v: JMOE.moe_forward_dropless(jcfg, p, v))(
        jp, jnp.asarray(x))
    np.testing.assert_allclose(_np(y_drop), _np(jy), **TOL)


# ------------------------------------------------- lock-step programs


@functools.cache
def _case(arch, seq):
    jcfg, tcfg = _cfgs(arch)
    jp = JLM.init_params(jcfg, CTX, jax.random.key(3))
    model = LM.LM.from_state_dict(tcfg,
                                  state_from_jax(jax.tree.map(np.asarray, jp)))
    tokens = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (B, seq + GEN)).astype(np.int32)
    return jcfg, tcfg, jp, model, tokens, seq


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request):
    return _case(*request.param)


def _assert_cache(got, want, keys, msg):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in keys:
        assert tuple(got[key].shape) == tuple(want[key].shape), (msg, key)
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), **TOL,
                                   err_msg=f"{msg}: {key}")


def test_params_carry_the_moe_leaves(case):
    jcfg, tcfg, jp, model, _, _ = case
    lp = model.layers[1].moe
    assert lp.router.dtype == torch.float32
    assert tuple(lp.we1.shape) == (tcfg.num_experts, tcfg.d_model, tcfg.d_ff)
    assert tuple(lp.we2.shape) == (tcfg.num_experts, tcfg.d_ff, tcfg.d_model)
    np.testing.assert_array_equal(_np(lp.we3),
                                  np.asarray(jp["layers"]["moe"]["we3"][1]))
    fresh = LM.init_params(tcfg, 0, device=CPU)
    assert ({k: tuple(v.shape) for k, v in fresh.state_dict().items()}
            == {k: tuple(v.shape) for k, v in model.state_dict().items()})


def test_prefill_and_decodes_match_jax(case):
    """Prefill, then ``GEN`` decodes fed the same tokens, fp cache."""
    _lockstep(*case, kv_int8=False)


def test_int8_prefill_and_decodes_match_jax(monkeypatch):
    """The int8 cache on ``moonshot``: its decodes start from the
    reference's prefill cache, as in ``test_torch_lockstep.py``, and the
    codes they write follow the same tie rule, against the port's own
    unrounded codes (``kv_quantize`` watched)."""
    unrounded = []
    quantize = L.kv_quantize

    def watched(x):
        q, scale = quantize(x)
        unrounded.append(_np(x) / _np(scale))
        return q, scale
    monkeypatch.setattr(L, "kv_quantize", watched)
    _lockstep(*_case(*CASES[1]), kv_int8=True, unrounded=unrounded)


def _lockstep(jcfg, tcfg, jp, model, tokens, seq, *, kv_int8,
              unrounded=None):
    ctx = ShardCtx(kv_int8=kv_int8)
    total = seq + GEN
    jpre = jax.jit(JLM.make_prefill(jcfg, ctx, B, seq))
    jdec = jax.jit(JLM.make_decode(jcfg, ctx, B, total))
    tpre = api.build(tcfg, InputShape("p", seq, B, "prefill"), device=CPU,
                     kv_int8=kv_int8)
    tdec = api.build(tcfg, InputShape("d", total, B, "decode"), device=CPU)

    prompt = tokens[:, :seq]
    jlg, jc = jpre(jp, {"tokens": jnp.asarray(prompt)})
    tlg, tc = tpre.fn(model, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    keys = ["index", "pos"] + (["k_scale", "v_scale"] if kv_int8
                               else ["k", "v"])
    _assert_cache(tc, jc, keys, "prefill")
    if kv_int8:
        _, jfp = jax.jit(JLM.make_prefill(jcfg, CTX, B, seq))(
            jp, {"tokens": jnp.asarray(prompt)})
        for kk in ("k", "v"):
            assert tc[kk].dtype == torch.int8
            _assert_codes_at_ties(tc[kk], jc[kk],
                                  jfp[kk] / jc[f"{kk}_scale"], kk)
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
        unrounded.clear()
    if tcfg.attn_window:
        assert tc["pos"].shape == (tcfg.attn_window,)
        assert int(tc["pos"].min()) == seq - tcfg.attn_window
    else:
        jc = japi.grow_cache(jc, total + 1)
        tc = api.grow_cache(tc, total + 1)
    for t in range(seq, total):
        tok = tokens[:, t:t + 1]
        jlg, jc = jdec(jp, jc, jnp.asarray(tok))
        tlg, tc = tdec.fn(model, tc, torch.from_numpy(tok.copy()))
        np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL,
                                   err_msg=f"decode at {t}")
    assert tdec.fn.shape_count == 1
    if not kv_int8:
        _assert_cache(tc, jc, keys + ["k", "v"], "after decoding")
        return
    _assert_cache(tc, jc, keys, "after decoding")
    nl = tcfg.num_layers
    for j, kk in enumerate(("k", "v")):
        # each decode step quantises k then v of every layer in turn
        unr = np.zeros(tc[kk].shape)
        for step in range(GEN):
            for i in range(nl):
                unr[i, :, seq + step] = unrounded[(step * nl + i) * 2 + j][:, 0]
        _assert_codes_at_ties(tc[kk], jc[kk], unr, f"decoded {kk}")


@pytest.mark.parametrize("prefilled", [False, True])
def test_init_cache_matches_jax(prefilled):
    for arch, seq in CASES:
        jcfg, tcfg = _cfgs(arch)
        for kv_int8 in (False, True):
            want = JLM.init_cache(jcfg, ShardCtx(kv_int8=kv_int8), B, seq,
                                  prefilled=prefilled)
            got = LM.init_cache(tcfg, B, seq, prefilled=prefilled,
                                kv_int8=kv_int8, device=CPU)
            assert set(got) == set(want)
            for key in want:
                assert tuple(got[key].shape) == tuple(want[key].shape), key
                assert str(got[key].dtype) == f"torch.{want[key].dtype}", key
                np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


def test_bf16_prefill_and_decode_match_jax():
    """bf16 weights and activations: the logits of the prefill and of one
    decode within ``BF16_TOL`` of their scale, against the reference run op
    by op (``jax.disable_jit``), so that each rounds bf16 where its code
    does."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", "bfloat16")
    seq = 12
    jp = JLM.init_params(jcfg, CTX, jax.random.key(4))
    model = LM.LM.from_state_dict(tcfg,
                                  state_from_jax(jax.tree.map(np.asarray, jp)))
    assert model.layers[0].moe.we1.dtype == torch.bfloat16
    tokens = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (B, seq + 1)).astype(np.int32)
    with jax.disable_jit():
        jlg, jc = JLM.make_prefill(jcfg, CTX, B, seq)(
            jp, {"tokens": jnp.asarray(tokens[:, :seq])})
    tlg, tc = api.build(tcfg, InputShape("p", seq, B, "prefill"),
                        device=CPU).fn(model,
                                       {"tokens": torch.from_numpy(
                                           tokens[:, :seq])})
    scale = float(np.abs(_np(jlg)).max())
    assert np.abs(_np(tlg) - _np(jlg)).max() <= BF16_TOL * scale
    jc, tc = japi.grow_cache(jc, seq + 2), api.grow_cache(tc, seq + 2)
    with jax.disable_jit():
        jlg, _ = JLM.make_decode(jcfg, CTX, B, seq + 1)(
            jp, jc, jnp.asarray(tokens[:, seq:]))
    tlg, tc = api.build(tcfg, InputShape("d", seq + 1, B, "decode"),
                        device=CPU).fn(model, tc,
                                       torch.from_numpy(tokens[:, seq:].copy()))
    assert tc["k"].dtype == torch.bfloat16
    assert np.abs(_np(tlg) - _np(jlg)).max() <= BF16_TOL * scale


def test_slot_programs_match_jax():
    """The serve tier's prefill of one right-padded bucket and its decodes
    with a slot retiring, on ``moonshot``, against the reference's slot
    programs at ``ShardCtx()``."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b")
    jp = JLM.init_params(jcfg, CTX, jax.random.key(7))
    model = LM.LM.from_state_dict(tcfg,
                                  state_from_jax(jax.tree.map(np.asarray, jp)))
    plen, gen = 8, 4
    plens = np.asarray([8, 5], np.int32)
    tokens = np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (B, plen)).astype(np.int32)
    tokens[1, plens[1]:] = 0
    jlg, jc = jax.jit(JLM.make_prefill_slots(jcfg, CTX, B, plen))(
        jp, {"tokens": jnp.asarray(tokens)}, jnp.asarray(plens))
    tlg, tc = api.build_serve_prefill(tcfg, B, plen, device=CPU).fn(
        model, {"tokens": torch.from_numpy(tokens)}, torch.from_numpy(plens))
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    for key in ("k", "v", "pos", "index"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=key)
    s_c = plen + gen + 1
    jc, tc = japi.grow_cache(jc, s_c), api.grow_cache(tc, s_c)
    jdec = jax.jit(JLM.make_decode_slots(jcfg, CTX, B, plen + gen))
    tdec = api.build_serve_decode(tcfg, B, plen + gen, device=CPU)
    tok = np.argmax(_np(tlg)[:, :tcfg.vocab_size], -1).astype(np.int32)
    for step in range(gen):
        active = np.asarray([True, step < 2])
        jlg, jc = jdec(jp, jc, jnp.asarray(tok[:, None]), jnp.asarray(active))
        tlg, tc = tdec.fn(model, tc, torch.from_numpy(tok[:, None].copy()),
                          torch.from_numpy(active))
        np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL,
                                   err_msg=f"decode {step}")
        tok = np.argmax(_np(tlg)[:, :tcfg.vocab_size], -1).astype(np.int32)
    for key in ("k", "v", "pos", "index"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=key)


def test_configs_have_the_reference_widths():
    for arch, _ in CASES:
        for reduced in (False, True):
            got = dataclasses.asdict(get_config(arch, reduced=reduced))
            want = jax_get_config(arch, reduced=reduced)
            assert got == {f: getattr(want, f) for f in got}, arch
    for arch in ("mixtral-8x7b", "qwen3-moe-235b-a22b",
                 "moonshot-v1-16b-a3b", "zamba2-7b"):
        want = jax_get_config(arch, long_context=True)
        got = get_config(arch, long_context=True)
        assert (got.name, got.attn_window) == (want.name, want.attn_window)


def test_cpu_moe_never_launches_the_kernel(case):
    _, tcfg, _, model, tokens, seq = case
    before = (gmm_ops.ragged_launches, gmm_ops.ragged_bf16_launches)
    LM.make_prefill(tcfg)(model, {"tokens": torch.from_numpy(tokens[:, :8])})
    assert (gmm_ops.ragged_launches, gmm_ops.ragged_bf16_launches) == before
