"""The vision family (Phi-3-vision) of the PyTorch port against the JAX
reference.

``phi3_vision_4_2b`` REDUCED (2 layers, d 256) on both sides from one set
of parameters (the JAX ``init_params`` tree converted by
``repro_torch.testing.parity``). The frontend is the reference's stub:
``patch_embeds`` ``(B, SEQ // 8, d)`` replace the first token embeddings
(``lm.embed_inputs``). In f32 at ``TOL`` (atol/rtol 1e-4: one function,
f32 sums in another order): ``embed_inputs`` with and without
``patch_embeds``, the lock-step prefill's logits and cache and ``GEN``
teacher-forced decodes with the fp and the int8 cache (its codes may sit
one step off at a rounding tie, as in ``test_torch_lockstep.py``), one
train step at d = 32 against the reference's ``api.build(..., "train")``
on ``make_smoke_mesh()`` (``test_torch_lm_train.py`` gives why d = 32),
and greedy tokens of the serve tier's ``WorldModelServer`` on
``device="cpu"``, equal to the reference's lock-step greedy decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_smoke_mesh
from repro.models import api as japi
from repro.models import lm as JLM
from repro.models.config import InputShape as JInputShape
from repro.models.config import ShardCtx
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.core.servers import ParameterServer
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import api
from repro_torch.models import lm as LM
from repro_torch.models.config import InputShape
from repro_torch.optim import optimizers as opt
from repro_torch.serve import WorldModelServer
from repro_torch.testing.parity import state_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"
B, SEQ, GEN = 2, 16, 4
ARCH = "phi-3-vision-4.2b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(**kw):
    return tuple(dataclasses.replace(get(ARCH, reduced=True),
                                     dtype="float32", **kw)
                 for get in (jax_get_config, get_config))


def _params(cfgs, seed):
    jcfg, tcfg = cfgs
    jp = JLM.init_params(jcfg, ShardCtx(), jax.random.key(seed))
    state = state_from_jax(jax.tree.map(np.asarray, jp))
    return jp, state, LM.LM.from_state_dict(tcfg, state)


def _batch(cfg, seed, seq=SEQ, rows=B):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   (rows, seq)).astype(np.int32),
            "patch_embeds": rng.standard_normal(
                (rows, seq // 8, cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module")
def f32():
    cfgs = _cfgs()
    return cfgs, _params(cfgs, 3), _batch(cfgs[1], 5, seq=SEQ + GEN)


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _assert_codes_at_ties(got, want, unrounded, msg):
    """int8 codes equal, except a code one step off where the reference's
    unrounded code sits at a rounding tie."""
    got, want = got.numpy().astype(int), np.asarray(want).astype(int)
    off = got != want
    assert np.abs(got - want).max() <= 1, msg
    frac = np.abs(np.asarray(unrounded, np.float64)) % 1.0
    assert np.all(np.abs(frac[off] - 0.5) < 1e-3), (msg, frac[off])


@pytest.mark.parametrize("with_patches", [True, False],
                         ids=["patch_embeds", "tokens_only"])
def test_embed_inputs_matches_jax(f32, with_patches):
    """The frontend stub: with ``patch_embeds`` the first SEQ // 8
    positions are the patches (cast to the model's dtype) and the rest the
    tokens'; without, the token embeddings alone."""
    (jcfg, tcfg), (jp, _, model), batch = f32
    batch = dict(batch)
    if not with_patches:
        del batch["patch_embeds"]
    jx, jpos = JLM.embed_inputs(jcfg, ShardCtx(), jp,
                                jax.tree.map(jnp.asarray, batch))
    tx, tpos = LM.embed_inputs(tcfg, model, _torch(batch))
    np.testing.assert_array_equal(_np(tx), _np(jx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    n = (SEQ + GEN) // 8
    plain, _ = LM.embed_inputs(tcfg, model,
                               {"tokens": _torch(batch)["tokens"]})
    assert torch.equal(tx[:, n:], plain[:, n:])
    assert torch.equal(tx[:, :n], torch.from_numpy(batch["patch_embeds"])) \
        if with_patches else torch.equal(tx, plain)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp", "int8"])
def test_prefill_and_decodes_match_jax(f32, kv_int8):
    """Prefill of a batch with ``patch_embeds`` through ``api.build``,
    logits and cache, then ``GEN`` decodes fed the same tokens and the
    final cache. The int8 decodes start from the reference's own prefill
    cache, so that a code at a tie does not carry into their logits."""
    (jcfg, tcfg), (jp, _, model), batch = f32
    ctx = ShardCtx(kv_int8=kv_int8)
    total = SEQ + GEN
    tokens = batch["tokens"]
    prompt = {"tokens": tokens[:, :SEQ],
              "patch_embeds": batch["patch_embeds"][:, :SEQ // 8]}
    jlg, jc = jax.jit(JLM.make_prefill(jcfg, ctx, B, SEQ))(
        jp, jax.tree.map(jnp.asarray, prompt))
    tpre = api.build(tcfg, InputShape("p", SEQ, B, "prefill"), device=CPU,
                     kv_int8=kv_int8)
    tdec = api.build(tcfg, InputShape("d", total, B, "decode"), device=CPU)
    tlg, tc = tpre.fn(model, _torch(prompt))
    np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL)
    assert set(tc) == set(jc)
    for key in ("index", "pos") + (("k_scale", "v_scale") if kv_int8
                                   else ("k", "v")):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=key)
    if kv_int8:
        _, jfp = jax.jit(JLM.make_prefill(jcfg, ShardCtx(), B, SEQ))(
            jp, jax.tree.map(jnp.asarray, prompt))
        for kk in ("k", "v"):
            assert tc[kk].dtype == torch.int8
            _assert_codes_at_ties(tc[kk], jc[kk],
                                  jfp[kk] / jc[f"{kk}_scale"], kk)
        tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    jdec = jax.jit(JLM.make_decode(jcfg, ctx, B, total))
    jc, tc = japi.grow_cache(jc, total + 1), api.grow_cache(tc, total + 1)
    for t in range(SEQ, total):
        tok = tokens[:, t:t + 1]
        jlg, jc = jdec(jp, jc, jnp.asarray(tok))
        tlg, tc = tdec.fn(model, tc, torch.from_numpy(tok.copy()))
        np.testing.assert_allclose(_np(tlg), _np(jlg), **TOL,
                                   err_msg=f"decode at {t}")
    for key in jc:
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL,
                                   err_msg=f"after decoding: {key}")


def test_patch_embeds_change_the_first_token_logits(f32):
    """The frontend is on the prefill's path: the same tokens with and
    without patches give other logits, and the CPU route launches no
    kernel."""
    (_, tcfg), (_, _, model), batch = f32
    pre = api.build(tcfg, InputShape("p", SEQ, B, "prefill"), device=CPU)
    prompt = {"tokens": batch["tokens"][:, :SEQ],
              "patch_embeds": batch["patch_embeds"][:, :SEQ // 8]}
    before = fa_ops.launches
    with_p, _ = pre.fn(model, _torch(prompt))
    without, _ = pre.fn(model, _torch({"tokens": prompt["tokens"]}))
    assert fa_ops.launches == before
    assert (with_p - without).abs().max().item() > 1e-2


def test_train_step_matches_jax():
    """One train step with ``patch_embeds`` in the batch, two
    microbatches, at d = 32: loss, gnorm and every updated parameter."""
    cfgs = _cfgs(d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                 vocab_size=128)
    jcfg, tcfg = cfgs
    shape = (16, 4, "train")
    jb = japi.build(jcfg, make_smoke_mesh(),
                    JInputShape("t", *shape, microbatch=2))
    tb = api.build(tcfg, InputShape("t", *shape, microbatch=2), device=CPU)
    jp, _, model = _params(cfgs, 4)
    batch = _batch(tcfg, 6, seq=16, rows=4)
    batch["labels"] = batch["tokens"].copy()
    jp, _, jm = jb.fn(jp, jopt.adam(jcfg.lr).init(jp),
                      jax.tree.map(jnp.asarray, batch))
    before = fa_ops.launches
    model, _, tm = tb.fn(model, opt.adam(tcfg.lr).init(LM.trainable(model)),
                         _torch(batch))
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


def test_serve_tier_request_matches_jax(f32):
    """The continuous-batching server takes the vision family as a dense
    one, tokens only (its slot prefill's batch holds no patches): two
    requests through ``WorldModelServer`` give the greedy tokens of the
    reference's lock-step prefill and decodes of each prompt alone. The
    reference's own server cannot take this config (its slot prefill's
    input specs name ``patch_embeds``, which the server never passes), so
    it is not the comparison here."""
    (jcfg, tcfg), (jp, state, _), _ = f32
    tps = ParameterServer()
    tps.push(state)
    tsrv = WorldModelServer(tcfg, param_server=tps, device=CPU, n_slots=2,
                            max_seq=32, page_len=8, prompt_buckets=(8, 16))
    rng = np.random.default_rng(11)
    specs = [(11, 5), (6, 3)]
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n, _ in specs]
    rids = [tsrv.submit(p, max_new=new) for p, (_, new) in zip(prompts, specs)]
    tsrv.run()
    for rid, prompt, (plen, new) in zip(rids, prompts, specs):
        lg, cache = jax.jit(JLM.make_prefill(jcfg, ShardCtx(), 1, plen))(
            jp, {"tokens": jnp.asarray(prompt[None])})
        cache = japi.grow_cache(cache, plen + new + 1)
        dec = jax.jit(JLM.make_decode(jcfg, ShardCtx(), 1, plen + new))
        want = []
        for _ in range(new):
            tok = jnp.argmax(lg[:, :jcfg.vocab_size], -1).astype(jnp.int32)
            want.append(int(tok[0]))
            lg, cache = dec(jp, cache, tok[:, None])
        np.testing.assert_array_equal(tsrv.result(rid), want)
