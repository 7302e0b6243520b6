"""The hybrid family (Zamba2) of the PyTorch port against the JAX reference.

``zamba2_7b`` REDUCED (3 mamba layers, the shared attention + MLP block
every 2: a full group and a tail of one, so two invocations) with chunk 32,
so that the 40-token prompts span a padded second chunk, on both sides from
one set of parameters (the JAX ``init_params`` tree, its ``shared`` block
included, converted by ``repro_torch.testing.parity``). In f32, at ``TOL``
(atol/rtol 1e-4: one function, f32 sums in another order): the grouping,
``loss_forward``, the lock-step prefill's logits and cache (the ssm states
over the layers, k / v over the shared block's invocations), ``GEN``
teacher-forced decodes and the final cache, against the reference's
``make_prefill`` / ``make_decode`` / ``init_cache``. One bf16 run (16-token
prompts at chunk 8, to keep the op-by-op reference short): the
logits of the prefill and of one decode within ``BF16_TOL`` of their scale,
against the reference run op by op (``jax.disable_jit``), which rounds
bf16 where its code does; XLA's fusions in the jitted scan skip some of
those roundings, and at these widths that alone moves its logits by about
2.5%. Block by block the port equals the op-by-op reference bit for bit,
but for an attention output here and there that rounds to the other bf16
neighbour (its f32 sums run in another order); the mamba layers after it
carry that ulp on, 1.4% of the logits' scale at the second invocation, so
``BF16_TOL`` is 2e-2 here, as ``test_torch_wm_dynamics.py``'s decodes.
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
from repro.models.config import ShardCtx
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import api
from repro_torch.models import lm as LM
from repro_torch.models.config import InputShape
from repro_torch.testing.parity import state_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 2e-2
CPU = "cpu"
CTX = ShardCtx()
B, SEQ, GEN = 2, 40, 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(dtype):
    return tuple(dataclasses.replace(get("zamba2-7b", reduced=True),
                                     ssm_chunk=32, dtype=dtype)
                 for get in (jax_get_config, get_config))


def _params(cfgs, seed):
    jcfg, tcfg = cfgs
    jp = JLM.init_params(jcfg, CTX, jax.random.key(seed))
    state = state_from_jax(jax.tree.map(np.asarray, jp))
    return jp, state, LM.LM.from_state_dict(tcfg, state)


@pytest.fixture(scope="module")
def f32():
    cfgs = _cfgs("float32")
    tokens = np.random.default_rng(5).integers(
        0, cfgs[1].vocab_size, (B, SEQ + GEN)).astype(np.int32)
    return cfgs, _params(cfgs, 1), tokens


def test_state_from_jax_carries_the_shared_block(f32):
    (_, tcfg), (jp, state, model), _ = f32
    shared = {f"shared.{blk}.{k}": v for blk in ("attn", "mlp")
              for k, v in jp["shared"][blk].items()}
    assert set(shared) <= set(state)
    for key, v in shared.items():
        np.testing.assert_array_equal(_np(state[key]), np.asarray(v))
    assert len(model.layers) == tcfg.num_layers
    fresh = LM.init_params(tcfg, 0, device=CPU)
    assert ({k: tuple(v.shape) for k, v in fresh.state_dict().items()}
            == {k: tuple(v.shape) for k, v in model.state_dict().items()})


@pytest.mark.parametrize("layers,every", [(3, 2), (81, 6), (7, 6), (6, 6),
                                          (4, 1)])
def test_grouping_matches_jax(layers, every):
    """``_hybrid_groups`` and ``n_shared_invocations``: Zamba2-7B has 13
    full groups of 6 and a tail of 3, so 14 invocations."""
    jcfg, tcfg = (dataclasses.replace(c, num_layers=layers, attn_every=every)
                  for c in _cfgs("float32"))
    assert LM._hybrid_groups(tcfg) == JLM._hybrid_groups(jcfg)
    assert LM.n_shared_invocations(tcfg) == JLM.n_shared_invocations(jcfg)
    assert LM.n_shared_invocations(get_config("zamba2-7b")) == 14


def test_loss_forward_matches_jax(f32):
    (jcfg, tcfg), (jp, _, model), tokens = f32
    batch = {"tokens": tokens[:, :SEQ], "labels": tokens[:, 1:SEQ + 1]}
    js, jc, jaux = jax.jit(lambda p, b: JLM.loss_forward(jcfg, CTX, p, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    s, c, aux = LM.loss_forward(tcfg, model, {
        k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    np.testing.assert_allclose(float(s), float(js), **TOL)
    assert int(c) == int(jc) and float(aux) == float(jaux) == 0.0


def test_prefill_and_decodes_match_jax(f32):
    (jcfg, tcfg), (jp, _, model), tokens = f32
    total = SEQ + GEN
    jpre = jax.jit(JLM.make_prefill(jcfg, CTX, B, SEQ))
    jdec = jax.jit(JLM.make_decode(jcfg, CTX, B, total))
    tpre = api.build(tcfg, InputShape("p", SEQ, B, "prefill"), device=CPU,
                     kv_int8=True)          # ignored, as the reference does
    tdec = api.build(tcfg, InputShape("d", total, B, "decode"), device=CPU)
    jlg, jc = jpre(jp, {"tokens": jnp.asarray(tokens[:, :SEQ])})
    tlg, tc = tpre.fn(model, {"tokens": torch.from_numpy(tokens[:, :SEQ])})
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    assert set(tc) == set(jc)
    n_inv = LM.n_shared_invocations(tcfg)
    assert tc["k"].shape == (n_inv, B, SEQ + 1, tcfg.num_kv_heads, tcfg.hd)
    for key in jc:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=f"prefill: {key}")
    jc, tc = japi.grow_cache(jc, total + 1), api.grow_cache(tc, total + 1)
    ssm_buf = tc["ssm"]
    for t in range(SEQ, total):
        tok = tokens[:, t:t + 1]
        jlg, jc = jdec(jp, jc, jnp.asarray(tok))
        tlg, tc = tdec.fn(model, tc, torch.from_numpy(tok.copy()))
        np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL,
                                   err_msg=f"decode at {t}")
    assert tc["ssm"] is ssm_buf          # written in place
    assert tdec.fn.shape_count == 1
    for key in jc:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=f"after decoding: {key}")


@pytest.mark.parametrize("prefilled", [False, True])
def test_init_cache_matches_jax(prefilled):
    jcfg, tcfg = _cfgs("float32")
    want = JLM.init_cache(jcfg, CTX, B, SEQ, prefilled=prefilled)
    got = LM.init_cache(tcfg, B, SEQ, prefilled=prefilled, device=CPU)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype) == f"torch.{want[key].dtype}", key
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


def test_bf16_prefill_and_decode_match_jax():
    cfgs = tuple(dataclasses.replace(c, ssm_chunk=8)
                 for c in _cfgs("bfloat16"))
    (jcfg, tcfg), (jp, _, model) = cfgs, _params(cfgs, 9)
    SEQ = 16
    tokens = np.random.default_rng(10).integers(
        0, tcfg.vocab_size, (B, SEQ + 1)).astype(np.int32)
    with jax.disable_jit():
        jlg, jc = JLM.make_prefill(jcfg, CTX, B, SEQ)(
            jp, {"tokens": jnp.asarray(tokens[:, :SEQ])})
    tlg, tc = LM.make_prefill(tcfg)(
        model, {"tokens": torch.from_numpy(tokens[:, :SEQ])})
    assert tc["k"].dtype == torch.bfloat16 and tc["ssm"].dtype == torch.float32
    scale = max(1.0, float(np.abs(_np(jlg)).max()))
    assert np.abs(_np(tlg) - _np(jlg)).max() <= BF16_TOL * scale
    jc, tc = japi.grow_cache(jc, SEQ + 2), api.grow_cache(tc, SEQ + 2)
    with jax.disable_jit():
        jlg, _ = JLM.make_decode(jcfg, CTX, B, SEQ + 1)(
            jp, jc, jnp.asarray(tokens[:, SEQ:]))
    tlg, _ = LM.make_decode(tcfg)(model, tc,
                                  torch.from_numpy(tokens[:, SEQ:].copy()))
    assert np.abs(_np(tlg) - _np(jlg)).max() <= BF16_TOL * scale


def test_config_has_the_reference_widths():
    for reduced in (False, True):
        got = dataclasses.asdict(get_config("zamba2-7b", reduced=reduced))
        want = jax_get_config("zamba2-7b", reduced=reduced)
        assert got == {f: getattr(want, f) for f in got}
    cfg = get_config("zamba2-7b")
    assert cfg.hd == 112 and cfg.ssm_heads == 112


def test_cpu_hybrid_never_launches_a_kernel(f32):
    (_, tcfg), (_, _, model), tokens = f32
    before = (fa_ops.launches, ssd_ops.launches)
    _, cache = LM.make_prefill(tcfg)(
        model, {"tokens": torch.from_numpy(tokens[:, :SEQ])})
    LM.make_decode(tcfg)(model, api.grow_cache(cache, SEQ + 2),
                         torch.from_numpy(tokens[:, SEQ:SEQ + 1].copy()))
    assert (fa_ops.launches, ssd_ops.launches) == before
