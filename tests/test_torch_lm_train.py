"""LM training of the PyTorch port against the JAX reference.

* The train step: the reference's ``api.build(cfg, make_smoke_mesh(),
  InputShape(..., "train"))`` and the port's ``api.build(cfg,
  InputShape(..., "train"))``, both f32 from one set of parameters, two
  microbatches, three steps on the same batches: ``loss``, ``gnorm`` and
  every parameter after each step at ``TOL`` (atol/rtol 1e-4). On
  ``glm4-9b`` REDUCED (the dense family, the plain attention by autograd),
  ``mamba2-2.7b`` REDUCED (the ssm family, the plain scan), the three moe
  archs REDUCED (4 experts, top 2, capacity factor 8: nothing overflows,
  so the reference's and the port's CPU capacity buffers hold every
  token) and ``zamba2-7b`` REDUCED (3 layers at ``attn_every`` 2: two
  invocations of the shared block, whose one set of leaves takes the sum
  of their gradients), all at d = 32 (see
  ``test_gnorm_is_the_global_norm_of_the_gradient`` for why).
* The optimizer additions: ``adamw`` exactly, ``cosine_schedule`` and
  ``warmup_cosine`` to an ulp of ``cos``.
* ``pick_microbatches`` as the reference's at dp=1.
* ``data.synthetic``: ``DynamicsTokenStream`` with JAX's draws injected and
  ``trajectory_tokens``, tokens equal.
* The moe train route of the card against the CPU's: the dropless
  dispatch with its products through ``ref.grouped_matmul_looped`` and the
  capacity buffers, output, aux loss and every gradient.
* The launcher's ``--task lm`` on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import synthetic as jsyn
from repro.launch.mesh import make_smoke_mesh
from repro.models import api as japi
from repro.models import lm as JLM
from repro.models.config import InputShape as JInputShape
from repro.models.config import ShardCtx
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.data import synthetic as syn
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.gmm import cuda as gmm_cuda
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import train as launch
from repro_torch.models import api
from repro_torch.models import lm as LM
from repro_torch.models import moe as M
from repro_torch.models.config import InputShape
from repro_torch.optim import optimizers as opt
from repro_torch.testing.parity import state_from_jax

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"
B, SEQ, STEPS = 4, 16, 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(get(arch, reduced=True), dtype="float32",
                                     **kw)
                 for get in (jax_get_config, get_config))


_MOE = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8, d_ff=32,
            vocab_size=128)
SMALL = {
    "dense": ("glm4-9b", dict(d_model=32, num_heads=4, num_kv_heads=2,
                              d_ff=64, vocab_size=128)),
    "ssm": ("mamba2-2.7b", dict(d_model=32, ssm_head_dim=16, ssm_chunk=8,
                                vocab_size=128)),
    "moe_moonshot": ("moonshot-v1-16b-a3b", _MOE),
    "moe_mixtral": ("mixtral-8x7b", _MOE),
    "moe_qwen3_qk_norm": ("qwen3-moe-235b-a22b", _MOE),
    "hybrid_zamba2": ("zamba2-7b", dict(d_model=32, num_heads=4,
                                        num_kv_heads=4, d_ff=64,
                                        ssm_head_dim=16, ssm_chunk=8,
                                        vocab_size=128)),
}


def _kernel_launches():
    return (fa_ops.launches, ssd_ops.launches, gmm_ops.ragged_bf16_launches,
            gmm_ops.ragged_launches)


def _no_overflow(cfg, tokens: int) -> bool:
    """Each token picks ``top_k`` distinct experts, so an expert receives at
    most one row a token: a capacity of ``tokens`` slots holds them all."""
    return M.capacity(cfg, tokens) >= tokens


@pytest.mark.parametrize("family", list(SMALL))
def test_train_step_matches_jax(family):
    arch, kw = SMALL[family]
    jcfg, tcfg = _cfgs(arch, **kw)
    if tcfg.family == "moe":
        assert (tcfg.num_experts, tcfg.top_k) == (4, 2)
        assert _no_overflow(tcfg, B // 2 * SEQ)      # a microbatch's tokens
    if tcfg.family == "hybrid":
        assert LM.n_shared_invocations(tcfg) == 2
    shape = (SEQ, B, "train")
    jb = japi.build(jcfg, make_smoke_mesh(),
                    JInputShape("t", *shape, microbatch=2))
    tb = api.build(tcfg, InputShape("t", *shape, microbatch=2), device=CPU)
    assert tb.num_microbatches == jb.num_microbatches == 2
    jp = JLM.init_params(jcfg, jb.ctx, jax.random.key(4))
    model = LM.LM.from_state_dict(tcfg,
                                  state_from_jax(jax.tree.map(np.asarray, jp)))
    jstate = jopt.adam(jcfg.lr).init(jp)
    tstate = opt.adam(tcfg.lr).init(LM.trainable(model))
    rng = np.random.default_rng(6)
    for step in range(STEPS):
        tokens = rng.integers(0, tcfg.vocab_size, (B, SEQ)).astype(np.int32)
        labels = tokens.copy()
        labels[0, :3] = -1
        jp, jstate, jm = jb.fn(jp, jstate, {"tokens": jnp.asarray(tokens),
                                            "labels": jnp.asarray(labels)})
        before = _kernel_launches()
        model, tstate, tm = tb.fn(model, tstate, {
            "tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)})
        assert _kernel_launches() == before
        for key in ("loss", "gnorm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **TOL,
                                       err_msg=f"step {step}: {key}")
        want = state_from_jax(jax.tree.map(np.asarray, jp))
        got = model.state_dict()
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(_np(got[name]), _np(w), **TOL,
                                       err_msg=f"step {step}: {name}")
        assert int(tstate.step) == step + 1
    assert not any(p.requires_grad for p in model.parameters())
    assert tb.fn.shape_count == 1


def test_gnorm_is_the_global_norm_of_the_gradient():
    """At GLM-4-9B REDUCED's widths (leaves of up to 131,072 elements) the
    step's ``gnorm`` is the norm of the reference's gradient
    (``jax.grad`` of its loss, equal to the port's leaf by leaf) summed in
    float64. The reference's own train step reads ~0.1% low there: on the
    CPU its ``jnp.vdot`` sums each leaf's squares in sequence in f32, which
    is why the step parity above runs at d = 32."""
    jcfg, tcfg = _cfgs("glm4-9b")
    jp = JLM.init_params(jcfg, ShardCtx(), jax.random.key(4))
    model = LM.LM.from_state_dict(tcfg,
                                  state_from_jax(jax.tree.map(np.asarray, jp)))
    tokens = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, SEQ)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    grads = jax.grad(lambda p: JLM.loss_forward(
        jcfg, ShardCtx(), p, jax.tree.map(jnp.asarray, batch),
        remat=False)[0] / tokens.size)(jp)
    want = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                       for g in jax.tree.leaves(grads)))
    step = LM.make_train_step(tcfg, opt.adam(tcfg.lr), 2)
    _, _, m = step(model, opt.adam(tcfg.lr).init(LM.trainable(model)),
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["gnorm"]), want, rtol=1e-5)


def test_train_step_clips_at_max_grad_norm():
    """A tiny ``max_grad_norm`` clips: SGD's update is then
    ``lr * max_grad_norm`` in global norm, whatever ``gnorm`` was."""
    _, tcfg = _cfgs("glm4-9b", max_grad_norm=1e-3)
    model = LM.init_params(tcfg, 1, device=CPU)
    before = {n: p.clone() for n, p in LM.trainable(model).items()}
    step = LM.make_train_step(tcfg, opt.sgd(1.0), 2)
    tokens = torch.randint(0, tcfg.vocab_size, (B, SEQ),
                           generator=torch.Generator().manual_seed(0))
    _, _, m = step(model, opt.sgd(1.0).init(LM.trainable(model)),
                   {"tokens": tokens, "labels": tokens})
    assert float(m["gnorm"]) > 1e-3
    moved = torch.sqrt(sum(((p - before[n]) ** 2).sum()
                           for n, p in LM.trainable(model).items()))
    np.testing.assert_allclose(float(moved), 1e-3, rtol=1e-3)


def test_kernel_loss_route_refuses_a_gradient_on_the_train_step(
        monkeypatch):
    """The train step names the plain routes itself; a loss through the
    kernel routes is forward-only. On the CPU the attention and scan
    kernels' routes are the plain version, so their named routes are what
    is checked. The moe experts' bf16 kernel route is wired as on the card
    (the dropless dispatch, the kernel's product stood in by the plain one
    under ``no_grad``, as a launch returns a tensor without a graph): with
    ``gmm_impl=None`` a gradient raises naming the roadmap; with the train
    step's ``gmm_impl="ref"`` it flows, and no kernel is launched."""
    import inspect
    src = inspect.getsource(LM.make_train_step)
    assert ('attn_impl="ref"' in src and 'ssd_impl="ref"' in src
            and 'gmm_impl="ref"' in src)

    def stand_in(a, b, offsets):
        with torch.no_grad():
            return gmm_ref.grouped_matmul(a, b, offsets[1:] - offsets[:-1])
    monkeypatch.setattr(gmm_ops, "_use_kernel", lambda t, impl: impl != "ref")
    monkeypatch.setattr(gmm_cuda, "gmm_ragged", stand_in)
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b", reduced=True),
                              **_MOE)
    assert cfg.dtype == "bfloat16"
    p = LM.init_params(cfg, 0, device=CPU)["layers"][0]["moe"]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, cfg.d_model), generator=gen).bfloat16()
    x.requires_grad_(True)
    before = gmm_ops.ragged_bf16_launches
    y, _ = M.moe_forward_dropless(cfg, p, x)
    assert gmm_ops.ragged_bf16_launches == before + 3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        y.float().sum().backward()
    y, _ = M.moe_forward_dropless(cfg, p, x, gmm_impl="ref")
    y.float().sum().backward()
    assert gmm_ops.ragged_bf16_launches == before + 3
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.parametrize("shape", [(8, 64, 0), (8, 2048, 0), (16, 4096, 0),
                                   (6, 4096, 0), (8, 64, 4)])
def test_pick_microbatches_matches_jax(shape):
    batch, seq, micro = shape
    cfg = get_config("glm4-9b", reduced=True)
    want = japi.pick_microbatches(
        jax_get_config("glm4-9b", reduced=True),
        JInputShape("t", seq, batch, "train", microbatch=micro), ShardCtx())
    got = api.pick_microbatches(
        cfg, InputShape("t", seq, batch, "train", microbatch=micro))
    assert got == want


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def test_adamw_matches_jax_exactly():
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": [rng.standard_normal(3).astype(np.float32)]}
    jo, to = jopt.adamw(1e-2, weight_decay=0.1), opt.adamw(1e-2,
                                                          weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = {"w": rng.standard_normal((5, 3)).astype(np.float32),
             "b": [rng.standard_normal(3).astype(np.float32)]}
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), opt.apply_updates(tp, tu)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), tp))):
            np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("make", [
    lambda m: m.cosine_schedule(3e-4, 20, 0.1),
    lambda m: m.warmup_cosine(1e-3, 5, 30),
    lambda m: m.warmup_cosine(2e-3, 0, 10, 0.5)],
    ids=["cosine", "warmup_cosine", "no_warmup"])
def test_schedules_match_jax(make):
    """The same f32 formula; XLA's and torch's f32 ``cos`` may differ by an
    ulp, which ``1 + cos`` near ``cos = -1`` magnifies (by up to 8 ulps of
    the result at these steps), hence rtol 1e-6 and not equality."""
    jf, tf = make(jopt), make(opt)
    for step in range(0, 40):
        want = np.asarray(jf(jnp.asarray(step, jnp.int32)), np.float32)
        got = tf(torch.tensor(step, dtype=torch.int32)).to(torch.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0,
                                   err_msg=str(step))


def test_dynamics_token_stream_matches_jax_with_its_draws():
    stream = jsyn.DynamicsTokenStream(vocab=97, seq_len=12, batch=3, seed=5)
    port = syn.DynamicsTokenStream(vocab=97, seq_len=12, batch=3, seed=5,
                                   device=CPU)
    for step in (0, 7):
        key = jax.random.fold_in(jax.random.key(5), step)
        k1, k2 = jax.random.split(key)
        s0 = np.asarray(jax.random.randint(k1, (3,), 0, 97))
        acts = np.asarray(jax.random.randint(k2, (3, 12), 0, 7))
        want = stream.batch_at(step)
        got = port.batch_at(step, s0=torch.from_numpy(s0.copy()),
                            acts=torch.from_numpy(acts.copy()))
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # its own draws: deterministic per (seed, step), in range
    a, b = port.batch_at(3), port.batch_at(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 97


@pytest.mark.parametrize("bounds", [False, True])
def test_trajectory_tokens_match_jax(bounds):
    rng = np.random.default_rng(3)
    obs = (rng.standard_normal((20, 3)) * 2).astype(np.float32)
    act = (rng.standard_normal((20, 2)) * 1.5).astype(np.float32)
    kw = dict(bins=17)
    if bounds:
        kw.update(obs_low=np.full(3, -1.5, np.float32),
                  obs_high=np.full(3, 2.5, np.float32))
    want = jsyn.trajectory_tokens(obs, act, **kw)
    got = syn.trajectory_tokens(torch.from_numpy(obs), torch.from_numpy(act),
                                **kw)
    assert got.dtype == torch.int32 and got.shape == (20 * 5,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_launcher_task_lm_trains_on_cpu(capsys):
    """``--task lm`` runs ``--steps`` train steps on fresh random tokens
    (labels equal to tokens, as in the reference) and prints each step's
    loss and gradient norm."""
    losses = launch.main(["--task", "lm", "--arch", "glm4-9b", "--reduced",
                          "--device", "cpu", "--steps", "3", "--seq", "32",
                          "--batch", "4"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "step    2 loss" in out
    assert "gnorm" in out


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-7b"])
def test_launcher_task_lm_trains_the_moe_and_hybrid_archs(arch, capsys):
    """``--task lm`` on a moe and the hybrid arch, REDUCED (bf16): two
    steps, each printing a finite loss."""
    losses = launch.main(["--task", "lm", "--arch", arch, "--reduced",
                          "--device", "cpu", "--steps", "2", "--seq", "16",
                          "--batch", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "step    0 loss" in out and "step    1 loss" in out
