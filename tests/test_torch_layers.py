"""Layers of the PyTorch port against the JAX reference.

Both packages run ``glm4-9b`` REDUCED with ``dtype="float32"`` from the
same parameters: the JAX ``init_params`` tree, turned into numpy and
converted by ``repro_torch.testing.parity``. Inputs are numpy-seeded. The
f32 comparisons hold at atol/rtol 1e-4 (the same function, sums taken in
another order). One bf16 case holds at 2e-2, two bf16 ulps at unit scale,
since the two frameworks may round a product's last bit differently.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models.config import ShardCtx
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.lm import LM
from repro_torch.testing.parity import state_from_jax, to_tensor

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
CTX = ShardCtx()


def _cfgs(dtype: str, arch: str = "glm4-9b"):
    return (dataclasses.replace(jax_get_config(arch, reduced=True),
                                dtype=dtype),
            dataclasses.replace(get_config(arch, reduced=True), dtype=dtype))


def _models(dtype: str, arch: str = "glm4-9b", seed: int = 1):
    jcfg, tcfg = _cfgs(dtype, arch)
    jp = JLM.init_params(jcfg, CTX, jax.random.key(seed))
    np_tree = jax.tree.map(np.asarray, jp)
    return jcfg, tcfg, jp, LM.from_state_dict(tcfg, state_from_jax(np_tree))


@pytest.fixture(scope="module")
def f32():
    return _models("float32")


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def test_state_dict_keys_mirror_the_jax_tree(f32):
    jcfg, tcfg, jp, model = f32
    keys = set(model.state_dict())
    want = {f"embed.{k}" for k in jp["embed"]}
    for i in range(tcfg.num_layers):
        for blk, leaves in jp["layers"].items():
            want |= {f"layers.{i}.{blk}.{k}" for k in leaves}
    assert keys == want
    np.testing.assert_array_equal(model.layers[1].attn.wq.numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"][1]))


def test_rmsnorm_and_rope_match_jax():
    x = _rand((2, 5, 4, 64), 0)
    w = _rand((64,), 1)
    np.testing.assert_allclose(
        _np(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(w))),
        _np(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    pos = np.arange(5, dtype=np.int32)
    np.testing.assert_allclose(
        _np(L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)),
        _np(JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), **TOL)
    per_row = np.asarray([[3], [11]], np.int32)  # decode: (B, 1)
    np.testing.assert_allclose(
        _np(L.rope(torch.from_numpy(x[:, :1]), torch.from_numpy(per_row),
                   1e4)),
        _np(JL.rope(jnp.asarray(x[:, :1]), jnp.asarray(per_row), 1e4)),
        **TOL)


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-14b"])
def test_attn_and_mlp_forward_match_jax(arch, f32):
    jcfg, tcfg, jp, model = f32 if arch == "glm4-9b" else _models(
        "float32", arch)
    x = _rand((2, 12, tcfg.d_model), 2)
    pos = np.arange(12, dtype=np.int32)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    jmlp = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    want, (wk, wv) = JL.attn_forward(jcfg, CTX, jattn, jnp.asarray(x),
                                     jnp.asarray(pos), return_kv=True)
    got, (gk, gv) = L.attn_forward(tcfg, model.layers[0].attn,
                                   torch.from_numpy(x),
                                   torch.from_numpy(pos), return_kv=True)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    np.testing.assert_allclose(
        _np(L.mlp_forward(tcfg, model.layers[0].mlp, torch.from_numpy(x))),
        _np(JL.mlp_forward(jcfg, CTX, jmlp, jnp.asarray(x))), **TOL)


def test_embed_and_logits_match_jax(f32):
    jcfg, tcfg, jp, model = f32
    tok = np.asarray([[0, 7, 511], [3, 3, 100]], np.int32)
    np.testing.assert_allclose(
        _np(L.embed_tokens(tcfg, model.embed, torch.from_numpy(tok))),
        _np(JL.embed_tokens(jcfg, CTX, jp["embed"], jnp.asarray(tok))),
        **TOL)
    h = _rand((3, tcfg.d_model), 4)
    got = L.lm_logits_last(tcfg, model.embed, torch.from_numpy(h))
    assert got.shape == (3, tcfg.padded_vocab(1)) and got.dtype == \
        torch.float32
    np.testing.assert_allclose(
        _np(got), _np(JL.lm_logits_last(jcfg, CTX, jp["embed"],
                                        jnp.asarray(h))), **TOL)


def test_attn_decode_slots_matches_jax_and_never_writes_inactive(f32):
    jcfg, tcfg, jp, model = f32
    B, S = 3, 10
    hd, kv = tcfg.hd, tcfg.num_kv_heads
    x = _rand((B, 1, tcfg.d_model), 5)
    kc = _rand((B, S, kv, hd), 6)
    vc = _rand((B, S, kv, hd), 7)
    index = np.asarray([4, 2, 9], np.int32)
    pos = np.full((B, S), -1, np.int32)
    for b, n in enumerate(index):
        pos[b, :n] = np.arange(n)
    active = np.asarray([True, False, True])
    mode = JLM._slot_mode(jcfg, CTX, B, S - 1)
    jattn = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    want = JL.attn_decode_slots(jcfg, CTX, jattn, jnp.asarray(x),
                                jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(pos), jnp.asarray(index),
                                jnp.asarray(active), mode)
    tkc, tvc, tpos = (torch.from_numpy(a.copy()) for a in (kc, vc, pos))
    got = L.attn_decode_slots(tcfg, model.layers[1].attn,
                              torch.from_numpy(x), tkc, tvc, tpos,
                              torch.from_numpy(index),
                              torch.from_numpy(active))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    assert got[1] is tkc and got[3] is tpos  # written in place
    np.testing.assert_array_equal(tkc[1].numpy(), kc[1])  # inactive row
    np.testing.assert_array_equal(tpos[1].numpy(), pos[1])
    assert tpos[0, 4] == 4 and tpos[2, 9] == 9


def test_bf16_attn_and_mlp_match_jax_at_bf16_tolerance():
    jcfg, tcfg, jp, model = _models("bfloat16")
    x = _rand((2, 12, tcfg.d_model), 8)
    pos = np.arange(12, dtype=np.int32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = to_tensor(np.asarray(jx))
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    jmlp = jax.tree.map(lambda a: a[0], jp["layers"]["mlp"])
    got = L.attn_forward(tcfg, model.layers[0].attn, tx,
                         torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        _np(got), _np(JL.attn_forward(jcfg, CTX, jattn, jx,
                                      jnp.asarray(pos))), **BF16_TOL)
    np.testing.assert_allclose(
        _np(L.mlp_forward(tcfg, model.layers[0].mlp, tx)),
        _np(JL.mlp_forward(jcfg, CTX, jmlp, jx)), **BF16_TOL)
