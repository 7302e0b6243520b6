"""The dense family's lock-step programs of the PyTorch port against the
JAX reference.

f32 REDUCED configs on both sides, from one set of parameters (the JAX
``init_params`` tree converted by ``repro_torch.testing.parity``):
``glm4-9b``, ``qwen3-14b`` (``qk_norm``) and a ``glm4-9b`` variant with a
4-token sliding window whose ring wraps inside the prompt and again while
decoding. For each, with fp and int8 KV caches: the prefill's logits and
cache, then ``GEN`` teacher-forced decodes (logits and the final cache),
against the reference's ``make_prefill`` / ``make_decode`` /
``init_cache`` at ``ShardCtx()`` (``kv_int8=True`` for the int8 cache;
its codes may sit one step off at a rounding tie, and nowhere else).
Also ``decode_mode``, ``kv_quantize`` / ``kv_dequantize``, the decode
attention body ``masked_decode`` (``valid`` shared or per row) and the
flash-attention family's ``decode_attention_partial`` /
``combine_partials``. All at ``TOL``
(atol/rtol 1e-4: one function, f32 sums in another order); the int8 codes
and scales of one input are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention import ref as jfa_ref
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.config import ShardCtx
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.config import InputShape
from repro_torch.testing.parity import state_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"
B, SEQ, GEN = 2, 12, 6
CASES = [("glm4-9b", 0), ("qwen3-14b", 0), ("glm4-9b", 4)]
CASE_IDS = ["glm4", "qwen3_qk_norm", "glm4_window4"]


def _cfgs(arch, window):
    return tuple(dataclasses.replace(get(arch, reduced=True), dtype="float32",
                                     attn_window=window)
                 for get in (jax_get_config, get_config))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def case(request):
    arch, window = request.param
    jcfg, tcfg = _cfgs(arch, window)
    jp = JLM.init_params(jcfg, ShardCtx(), jax.random.key(3))
    model = LM.LM.from_state_dict(tcfg,
                                  state_from_jax(jax.tree.map(np.asarray, jp)))
    tokens = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (B, SEQ + GEN)).astype(np.int32)
    return jcfg, tcfg, jp, model, tokens


def _assert_cache(got, want, keys, msg):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in keys:
        assert tuple(got[key].shape) == tuple(want[key].shape), (msg, key)
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), **TOL,
                                   err_msg=f"{msg}: {key}")


def _assert_codes_at_ties(got, want, unrounded, msg):
    """int8 codes equal, except a code one step off where the reference's
    unrounded code sits at a rounding tie: there an ulp of difference in
    the f32 sums before it picks the other side."""
    got, want = got.numpy().astype(int), np.asarray(want).astype(int)
    off = got != want
    assert np.abs(got - want).max() <= 1, msg
    frac = np.abs(np.asarray(unrounded, np.float64)) % 1.0
    assert np.all(np.abs(frac[off] - 0.5) < 1e-3), (msg, frac[off])


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "int8"])
def test_prefill_and_decodes_match_jax(case, kv_int8):
    """Prefill, then ``GEN`` decodes fed the same tokens: logits at each
    step and the caches after the prefill and after the last decode.

    An int8 prefill cache holds the reference's codes, or one step off at a
    rounding tie (``_assert_codes_at_ties``, against the reference's fp
    prefill keys over its scales). The int8 decodes then start from the
    reference's own prefill cache, so that such a tie does not carry into
    the decode logits."""
    jcfg, tcfg, jp, model, tokens = case
    ctx = ShardCtx(kv_int8=kv_int8)
    total = SEQ + GEN
    jpre = jax.jit(JLM.make_prefill(jcfg, ctx, B, SEQ))
    jdec = jax.jit(JLM.make_decode(jcfg, ctx, B, total))
    tpre = api.build(tcfg, InputShape("p", SEQ, B, "prefill"), device=CPU,
                     kv_int8=kv_int8)
    tdec = api.build(tcfg, InputShape("d", total, B, "decode"), device=CPU)

    prompt = tokens[:, :SEQ]
    jlg, jc = jpre(jp, {"tokens": jnp.asarray(prompt)})
    tlg, tc = tpre.fn(model, {"tokens": torch.from_numpy(prompt)})
    assert tlg.shape == (B, tcfg.padded_vocab(1)) and tlg.dtype == torch.float32
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    keys = ["index", "pos"] + (["k_scale", "v_scale"] if kv_int8
                               else ["k", "v"])
    _assert_cache(tc, jc, keys, "prefill")
    if kv_int8:
        _, jfp = jax.jit(JLM.make_prefill(jcfg, ShardCtx(), B, SEQ))(
            jp, {"tokens": jnp.asarray(prompt)})
        for kk in ("k", "v"):
            assert tc[kk].dtype == torch.int8
            _assert_codes_at_ties(tc[kk], jc[kk],
                                  jfp[kk] / jc[f"{kk}_scale"], kk)
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    if not tcfg.attn_window:     # the ring already holds its last slots
        jc = japi.grow_cache(jc, total + 1)
        tc = api.grow_cache(tc, total + 1)
    k_buf = tc["k"]
    for t in range(SEQ, total):
        tok = tokens[:, t:t + 1]
        jlg, jc = jdec(jp, jc, jnp.asarray(tok))
        tlg, tc = tdec.fn(model, tc, torch.from_numpy(tok.copy()))
        np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL,
                                   err_msg=f"decode at {t}")
    assert tc["k"] is k_buf          # written in place
    assert tdec.fn.shape_count == 1
    _assert_cache(tc, jc, keys + ["k", "v"], "after decoding")


def test_ring_wraps_in_the_window_variant():
    """The window-4 ring keeps the last 4 positions of the prompt, each in
    slot ``pos % 4``, and a decode overwrites the oldest."""
    _, tcfg = _cfgs("glm4-9b", 4)
    model = LM.init_params(tcfg, 0, device=CPU)
    tokens = torch.arange(SEQ + 1, dtype=torch.int32).repeat(B, 1)
    _, cache = LM.make_prefill(tcfg, SEQ)(model,
                                          {"tokens": tokens[:, :SEQ]})
    assert cache["pos"].tolist() == [8, 9, 10, 11]
    assert L.decode_mode(tcfg, B, SEQ)["kind"] == "W"
    _, cache = LM.make_decode(tcfg)(model, cache, tokens[:, SEQ:])
    assert cache["pos"].tolist() == [12, 9, 10, 11]
    assert int(cache["index"]) == SEQ + 1


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("prefilled", [False, True])
def test_init_cache_matches_jax(kv_int8, prefilled):
    for arch, window in CASES:
        jcfg, tcfg = _cfgs(arch, window)
        want = JLM.init_cache(jcfg, ShardCtx(kv_int8=kv_int8), B, SEQ,
                              prefilled=prefilled)
        got = LM.init_cache(tcfg, B, SEQ, prefilled=prefilled,
                            kv_int8=kv_int8, device=CPU)
        assert set(got) == set(want)
        for key in want:
            assert tuple(got[key].shape) == tuple(want[key].shape), key
            assert str(got[key].dtype) == f"torch.{want[key].dtype}", key
            np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


def test_decode_mode_matches_jax_on_one_device():
    for arch, window in CASES + [("glm4-9b", 64)]:
        jcfg, tcfg = _cfgs(arch, window)
        for batch, seq in ((1, 1), (2, 12), (8, 64), (3, 100)):
            want = JL.decode_mode(jcfg, ShardCtx(), batch, seq)
            assert L.decode_mode(tcfg, batch, seq) == {
                "kind": want["kind"], "s_cache": want["s_cache"]}, (arch, seq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_matches_jax_exactly(dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 5, 3, 64)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # the 1e-6 floor
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = JL.kv_quantize(jx)
    tq, ts = L.kv_quantize(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (2, 5, 3, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    got = L.kv_dequantize(tq, ts, getattr(torch, dtype))
    want = JL.kv_dequantize(jq, js, jnp.dtype(dtype))
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_masked_decode_matches_jax(per_row):
    """The decode attention body, ``masked_decode``, against the reference's
    ``_masked_decode``, with ``valid`` shared by the batch (lock-step) or
    per row (slot pool): output and logsumexp."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((3, 8, 32)).astype(np.float32)
    k = rng.standard_normal((3, 10, 2, 32)).astype(np.float32)
    v = rng.standard_normal((3, 10, 2, 32)).astype(np.float32)
    valid = rng.random((3, 10) if per_row else (10,)) < 0.6
    valid[..., 0] = True
    jo, jl = JL._masked_decode(*map(jnp.asarray, (q, k, v, valid)))
    to, tl = fa_ref.masked_decode(*map(torch.from_numpy, (q, k, v, valid)))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_decode_partials_and_their_combination_match_jax():
    """``decode_attention_partial`` over two slices of a cache, and
    ``combine_partials`` of them, against the reference's; the combination
    equals the partial over the whole cache."""
    rng = np.random.default_rng(9)
    Bq, S, Hq, Hkv, D, length = 2, 24, 8, 2, 32, 19
    q = rng.standard_normal((Bq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, S, Hkv, D)).astype(np.float32)
    outs, lses = [], []
    for start in (0, S // 2):
        sl = slice(start, start + S // 2)
        jo, jl = jfa_ref.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            length, start=start)
        to, tl = fa_ref.decode_attention_partial(
            torch.from_numpy(q), torch.from_numpy(k[:, sl].copy()),
            torch.from_numpy(v[:, sl].copy()), length, start=start)
        np.testing.assert_allclose(_np(to), _np(jo), **TOL)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        outs.append(to)
        lses.append(tl)
    got = fa_ref.combine_partials(torch.stack(outs), torch.stack(lses))
    want = jfa_ref.combine_partials(jnp.stack([jnp.asarray(_np(o))
                                               for o in outs]),
                                    jnp.stack([jnp.asarray(_np(x))
                                               for x in lses]))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    whole, _ = fa_ref.decode_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        length)
    np.testing.assert_allclose(_np(got), _np(whole), **TOL)


def test_cpu_lockstep_never_launches_the_kernel(case):
    _, tcfg, _, model, tokens = case
    before = fa_ops.launches
    logits, cache = LM.make_prefill(tcfg)(
        model, {"tokens": torch.from_numpy(tokens[:, :SEQ])})
    LM.make_decode(tcfg)(model, api.grow_cache(cache, SEQ + 2)
                         if not tcfg.attn_window else cache,
                         torch.from_numpy(tokens[:, SEQ:SEQ + 1].copy()))
    assert fa_ops.launches == before


def test_long_context_config_is_the_window_variant():
    """``get_config(..., long_context=True)`` gives the full-size
    sliding-window variant, as the reference's registry does."""
    for arch in ("glm4-9b", "qwen3-14b", "granite-3-8b", "mamba2-2.7b"):
        want = jax_get_config(arch, long_context=True)
        got = get_config(arch, long_context=True)
        assert (got.name, got.attn_window) == (want.name, want.attn_window)
    assert get_config("glm4-9b", reduced=True,
                      long_context=True).attn_window == 0
