"""The encoder-decoder family (Seamless-M4T) of the PyTorch port against
the JAX reference, and the configs of the two archs that came with it.

``seamless_m4t_medium`` REDUCED (2 encoder + 2 decoder layers, d 256) on
both sides from one set of parameters (the JAX ``encdec.init_params`` tree
converted by ``repro_torch.testing.parity.state_from_jax``). In f32, at
``TOL`` (atol/rtol 1e-4: one function, f32 sums in another order):
``encode``, ``decoder_forward`` with its collected caches,
``loss_forward``, ``init_cache``, the lock-step prefill's logits and every
cache entry, ``GEN`` teacher-forced decodes and the final cache, and the
reference's prefill -> decode consistency, whose full forward runs the
cross-attention at Sq = SEQ + 1 against Sk = SEQ. The train step against
the reference's ``api.build(..., "train")`` on ``make_smoke_mesh()`` runs
at d = 32, for the reason ``test_torch_lm_train.py`` gives (XLA:CPU sums a
leaf's squares for ``gnorm`` in sequence in f32). One bf16 prefill and
decode within ``BF16_TOL`` of the logits' scale, as
``test_torch_hybrid.py`` holds its bf16 run. The reference runs its CPU
route: ``attn_ops.attention`` is its plain ``chunked_attention`` there.

Also flash attention's cross-attention route: ``ops.attention`` and the
plain versions at Sq > Sk without the causal mask against the reference's
``naive_attention``; with it, Sq > Sk still raises.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import registry as jregistry
from repro.kernels.flash_attention import ref as jfa_ref
from repro.launch.mesh import make_smoke_mesh
from repro.models import api as japi
from repro.models import encdec as JE
from repro.models.config import InputShape as JInputShape
from repro.models.config import ShardCtx
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config, registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import api
from repro_torch.models import encdec as E
from repro_torch.models import lm as LM
from repro_torch.models.config import InputShape
from repro_torch.optim import optimizers as opt
from repro_torch.testing.parity import state_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = 2e-2
CPU = "cpu"
CTX = ShardCtx()
B, SEQ, ENC, GEN = 2, 12, 10, 3
ARCH = "seamless-m4t-medium"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(dtype="float32", **kw):
    return tuple(dataclasses.replace(get(ARCH, reduced=True), dtype=dtype,
                                     **kw)
                 for get in (jax_get_config, get_config))


def _params(cfgs, seed):
    jcfg, _ = cfgs
    jp = JE.init_params(jcfg, CTX, jax.random.key(seed))
    state = state_from_jax(jax.tree.map(np.asarray, jp))
    return jp, state, LM.Params(LM.nest_state(state))


def _inputs(cfg, seed, seq=SEQ + GEN, enc=ENC, dtype=np.float32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    frames = rng.standard_normal((B, enc, cfg.d_model)).astype(dtype)
    return tokens, frames


@pytest.fixture(scope="module")
def f32():
    cfgs = _cfgs()
    return cfgs, _params(cfgs, 3), _inputs(cfgs[1], 5)


def _assert_cache(got, want, msg):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), (msg, key)
        np.testing.assert_allclose(_np(got[key]), _np(want[key]), **TOL,
                                   err_msg=f"{msg}: {key}")


# ---------------------------------------------------------------- configs


def test_every_arch_id_resolves_to_the_references_config():
    """All ten ids resolve, by either spelling, and the port's CONFIG and
    REDUCED equal the reference's field for field, sources included."""
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.ALIASES == jregistry.ALIASES
    for arch in jregistry.ARCH_IDS:
        for reduced in (False, True):
            got = get_config(arch.replace("_", "-"), reduced=reduced)
            want = jax_get_config(arch, reduced=reduced)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
            assert got.source


def test_long_context_variants_follow_the_reference():
    assert registry.LONG_CONTEXT == jregistry.LONG_CONTEXT
    swa = get_config("phi-3-vision-4.2b", long_context=True)
    assert dataclasses.asdict(swa) == dataclasses.asdict(
        jax_get_config("phi-3-vision-4.2b", long_context=True))
    assert swa.attn_window == registry.LONG_WINDOW
    assert swa.name == "phi-3-vision-4.2b+swa"
    with pytest.raises(ValueError, match="not applicable"):
        get_config(ARCH, long_context=True)
    with pytest.raises(ValueError, match="not applicable"):
        jax_get_config(ARCH, long_context=True)
    assert get_config(ARCH, reduced=True, long_context=True).attn_window == 0


# ---------------------------------------------------------------- params


def test_state_from_jax_carries_the_encdec_tree(f32):
    """The reference's tree lands in the port's layout: the names and
    shapes of ``encdec.init_params``' module, each leaf bit for bit."""
    (_, tcfg), (jp, state, model), _ = f32
    own = E.init_params(tcfg, 0, device=CPU).state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in own.items()}
    assert len(model["enc_layers"]) == E._enc_layers(tcfg) == 2
    np.testing.assert_array_equal(
        _np(model["dec_layers"][1]["cross"]["wq"]),
        np.asarray(jp["dec_layers"]["cross"]["wq"][1]))
    np.testing.assert_array_equal(_np(model["enc_ln"]),
                                  np.asarray(jp["enc_ln"]))
    assert not any(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------- forward


def test_encode_and_decoder_forward_match_jax(f32):
    """The encoder (rope, no causal mask), then the decoder's hidden states
    and its collected caches (self k/v over SEQ, cross k/v over ENC)."""
    (jcfg, tcfg), (jp, _, model), (tokens, frames) = f32
    tok = tokens[:, :SEQ]
    jenc = jax.jit(lambda p, f: JE.encode(jcfg, CTX, p, f))(
        jp, jnp.asarray(frames))
    tenc = E.encode(tcfg, model, torch.from_numpy(frames))
    np.testing.assert_allclose(_np(tenc), _np(jenc), **TOL)
    jh, jys = jax.jit(lambda p, t, e: JE.decoder_forward(
        jcfg, CTX, p, t, e, collect_cache=True))(jp, jnp.asarray(tok), jenc)
    th, tys = E.decoder_forward(tcfg, model, torch.from_numpy(tok), tenc,
                                collect_cache=True)
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    assert len(tys) == len(jys) == 4
    for name, got, want in zip(("sk", "sv", "ck", "cv"), tys, jys):
        assert tuple(got.shape) == tuple(want.shape), name
        np.testing.assert_allclose(_np(got), _np(want), **TOL, err_msg=name)
    th2, ys = E.decoder_forward(tcfg, model, torch.from_numpy(tok), tenc)
    assert ys == () and torch.equal(th2, th)


def test_loss_forward_matches_jax(f32):
    (jcfg, tcfg), (jp, _, model), (tokens, frames) = f32
    labels = tokens.copy()
    labels[0, :4] = -1
    batch = {"enc_embeds": frames, "tokens": tokens, "labels": labels}
    js, jc, jaux = jax.jit(lambda p, b: JE.loss_forward(jcfg, CTX, p, b))(
        jp, jax.tree.map(jnp.asarray, batch))
    ts, tc, taux = E.loss_forward(tcfg, model,
                                  {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    np.testing.assert_allclose(float(ts), float(js), **TOL)
    assert int(tc) == int(jc) and float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("prefilled", [False, True])
def test_init_cache_matches_jax(prefilled):
    jcfg, tcfg = _cfgs()
    want = JE.init_cache(jcfg, CTX, B, SEQ, prefilled=prefilled)
    got = E.init_cache(tcfg, B, SEQ, prefilled=prefilled, device=CPU)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype) == f"torch.{want[key].dtype}", key
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))


# ---------------------------------------------------------------- lock step


def test_prefill_and_decodes_match_jax(f32):
    """``api.build``'s prefill (logits and every cache entry), then
    ``GEN`` decodes fed the same tokens (logits each step, the self cache
    written in place, the cross cache untouched) and the final cache."""
    (jcfg, tcfg), (jp, _, model), (tokens, frames) = f32
    total = SEQ + GEN
    jpre = jax.jit(JE.make_prefill(jcfg, CTX, B, SEQ))
    jdec = jax.jit(JE.make_decode(jcfg, CTX, B, total))
    tpre = api.build(tcfg, InputShape("p", SEQ, B, "prefill"), device=CPU)
    tdec = api.build(tcfg, InputShape("d", total, B, "decode"), device=CPU)
    batch = {"tokens": tokens[:, :SEQ], "enc_embeds": frames}
    jlg, jc = jpre(jp, jax.tree.map(jnp.asarray, batch))
    tlg, tc = tpre.fn(model, {k: torch.from_numpy(v.copy())
                              for k, v in batch.items()})
    assert tlg.shape == (B, tcfg.padded_vocab(1))
    assert tlg.dtype == torch.float32
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    _assert_cache(tc, jc, "prefill")
    jc, tc = japi.grow_cache(jc, total + 1), api.grow_cache(tc, total + 1)
    k_buf, cross = tc["k"], tc["cross_k"].clone()
    for t in range(SEQ, total):
        tok = tokens[:, t:t + 1]
        jlg, jc = jdec(jp, jc, jnp.asarray(tok))
        tlg, tc = tdec.fn(model, tc, torch.from_numpy(tok.copy()))
        np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL,
                                   err_msg=f"decode at {t}")
    assert tc["k"] is k_buf and torch.equal(tc["cross_k"], cross)
    assert tdec.fn.shape_count == 1
    _assert_cache(tc, jc, "after decoding")


def test_prefill_decode_consistency_with_cross_attention_past_the_encoder(
        f32):
    """The reference's consistency check: prefill(SEQ) then decode(token
    SEQ) equals the full forward over SEQ + 1 tokens against the same SEQ
    frames, whose cross-attention runs Sq = SEQ + 1 > Sk = SEQ without the
    causal mask. The port's full forward is also held against the
    reference's."""
    (jcfg, tcfg), (jp, _, model), _ = f32
    tokens, frames = _inputs(tcfg, 8, seq=SEQ + 1, enc=SEQ)
    pre = api.build(tcfg, InputShape("p", SEQ, B, "prefill"), device=CPU)
    dec = api.build(tcfg, InputShape("d", SEQ, B, "decode"), device=CPU)
    full = api.build(tcfg, InputShape("p2", SEQ + 1, B, "prefill"),
                     device=CPU)
    enc = torch.from_numpy(frames)
    tok = torch.from_numpy(tokens)
    _, cache = pre.fn(model, {"tokens": tok[:, :SEQ], "enc_embeds": enc})
    logits_d, cache = dec.fn(model, cache, tok[:, SEQ:].contiguous())
    assert int(cache["index"]) == SEQ + 1
    logits_f, fcache = full.fn(model, {"tokens": tok, "enc_embeds": enc})
    assert fcache["cross_k"].shape[2] == SEQ < tok.shape[1]
    np.testing.assert_allclose(_np(logits_d), _np(logits_f), **TOL)
    jlg, _ = jax.jit(JE.make_prefill(jcfg, CTX, B, SEQ + 1))(
        jp, {"tokens": jnp.asarray(tokens), "enc_embeds": jnp.asarray(frames)})
    np.testing.assert_allclose(_np(logits_f), _np(jlg), **TOL)


def test_bf16_prefill_and_decode_match_jax():
    """bf16 weights and activations on both sides: the prefill's logits and
    one decode's within ``BF16_TOL`` of their scale."""
    cfgs = _cfgs("bfloat16")
    jcfg, tcfg = cfgs
    jp, _, model = _params(cfgs, 4)
    tokens, frames = _inputs(tcfg, 9)
    batch = {"tokens": tokens[:, :SEQ], "enc_embeds": frames}
    jlg, jc = jax.jit(JE.make_prefill(jcfg, CTX, B, SEQ + 1))(
        jp, jax.tree.map(jnp.asarray, batch))
    tlg, tc = E.make_prefill(tcfg, SEQ + 1)(
        model, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    scale = np.abs(_np(jlg)).max()
    assert np.abs(_np(tlg) - _np(jlg)).max() <= BF16_TOL * scale
    tok = tokens[:, SEQ:SEQ + 1]
    jlg, _ = jax.jit(JE.make_decode(jcfg, CTX, B, SEQ + 1))(
        jp, jc, jnp.asarray(tok))
    tlg, _ = E.make_decode(tcfg)(model, tc, torch.from_numpy(tok.copy()))
    scale = np.abs(_np(jlg)).max()
    assert np.abs(_np(tlg) - _np(jlg)).max() <= BF16_TOL * scale


def test_cpu_encdec_never_launches_the_kernel(f32):
    (_, tcfg), (_, _, model), (tokens, frames) = f32
    before = fa_ops.launches
    _, cache = E.make_prefill(tcfg, SEQ + 1)(
        model, {"tokens": torch.from_numpy(tokens[:, :SEQ]),
                "enc_embeds": torch.from_numpy(frames)})
    E.make_decode(tcfg)(model, cache,
                        torch.from_numpy(tokens[:, SEQ:SEQ + 1].copy()))
    assert fa_ops.launches == before


# ---------------------------------------------------------------- training


def test_train_step_matches_jax():
    """One ``api.build(..., "train")`` step of each package, two
    microbatches, from one set of parameters at d = 32: loss, gnorm and
    every updated parameter. No flash launch: the step trains through the
    plain attention by design."""
    small = dict(d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                 vocab_size=128)
    cfgs = _cfgs(**small)
    jcfg, tcfg = cfgs
    shape = (8, 4, "train")
    jb = japi.build(jcfg, make_smoke_mesh(),
                    JInputShape("t", *shape, microbatch=2))
    tb = api.build(tcfg, InputShape("t", *shape, microbatch=2), device=CPU)
    assert tb.num_microbatches == jb.num_microbatches == 2
    jp, _, model = _params(cfgs, 6)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, tcfg.vocab_size, (4, 8)).astype(np.int32)
    labels = tokens.copy()
    labels[1, :2] = -1
    batch = {"tokens": tokens, "labels": labels,
             "enc_embeds": rng.standard_normal((4, 8, 32)).astype(
                 np.float32)}
    jp, _, jm = jb.fn(jp, jopt.adam(jcfg.lr).init(jp),
                      jax.tree.map(jnp.asarray, batch))
    before = fa_ops.launches
    model, tstate, tm = tb.fn(model, opt.adam(tcfg.lr).init(
        LM.trainable(model)), {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert fa_ops.launches == before
    for key in ("loss", "gnorm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    want = state_from_jax(jax.tree.map(np.asarray, jp))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name]), _np(w), **TOL,
                                   err_msg=name)
    assert int(tstate.step) == 1


def test_serve_tier_refuses_the_encdec_family():
    """As the reference's ``_slot_mode`` -> ``_block_kind``: the slot pool
    has no cross cache."""
    cfg = get_config(ARCH, reduced=True)
    for build in (api.build_serve_prefill, api.build_serve_decode):
        with pytest.raises(ValueError, match="encdec"):
            build(cfg, 2, 16, device=CPU)


# ---------------------------------------------------------------- attention


CROSS_SHAPES = [(1, 13, 12, 2, 2, 64), (2, 40, 7, 4, 2, 32),
                (1, 5, 9, 4, 4, 64)]


@pytest.mark.parametrize("shape", CROSS_SHAPES,
                         ids=["sq_sk_plus_1", "sq_gt_sk_gqa", "sq_lt_sk"])
def test_cross_attention_without_the_mask_matches_jax(shape):
    """``ops.attention`` (the CPU route), ``chunked_attention`` at small
    blocks (Sq and Sk ragged to them) and ``naive_attention``, all
    ``causal=False``, against the reference's ``naive_attention``; Sq >
    Sk in the first two."""
    Bq, Sq, Sk, Hq, Hkv, D = shape
    rng = np.random.default_rng(Sq * Sk)
    q = rng.standard_normal((Bq, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((Bq, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((Bq, Sk, Hkv, D)).astype(np.float32)
    want = jfa_ref.naive_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (fa_ops.attention(tq, tk, tv, causal=False),
                fa_ref.chunked_attention(tq, tk, tv, causal=False,
                                         block_q=8, block_k=4),
                fa_ref.naive_attention(tq, tk, tv, causal=False)):
        assert got.shape == tq.shape
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_causal_attention_still_refuses_more_queries_than_keys():
    """Under the causal mask Sq > Sk would leave query rows without a key:
    refused on every route before any launch, the kernel's included. The
    same shape without the mask passes that gate (on the CPU the kernel
    route then refuses the device)."""
    q = torch.zeros((1, 8, 2, 64))
    k = torch.zeros((1, 4, 2, 64))
    before = fa_ops.launches
    for impl in (None, "ref", "cuda"):
        with pytest.raises(ValueError, match="Sq <= Sk"):
            fa_ops.attention(q, k, k, causal=True, impl=impl)
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa_ops.attention(q, k, k, causal=False, impl="cuda")
    assert fa_ops.launches == before


def test_encdec_serve_example_runs_on_the_cpu_and_defaults_to_the_card(
        capsys):
    """``examples/torch_encdec_serve.py``: its REDUCED run on the CPU
    serves the batch; with no card and no ``device`` it raises."""
    path = (pathlib.Path(__file__).resolve().parent.parent / "examples"
            / "torch_encdec_serve.py")
    spec = importlib.util.spec_from_file_location("torch_encdec_serve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(device=CPU)
    assert out.shape == (mod.BATCH, mod.GEN)
    assert "served 4 requests" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main()
