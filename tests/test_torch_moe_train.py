"""The moe family's train route on the card against the one on the CPU.

The train step names ``gmm_impl="ref"``. On CUDA tensors the MoE FFN then
runs the dropless dispatch with its three ragged products through
``ref.grouped_matmul_looped`` (a loop over the experts: the rows split,
the weights unbound, the products joined); on CPU tensors the capacity
buffers' batched products, as the reference trains off-TPU. Here both run
on CPU tensors in f32 at each REDUCED moe arch's widths, the dropless one
with its products through the loop, where nothing overflows a buffer: the
output, the load-balance loss and the gradients of ``x`` and of every leaf
(``ln``, ``router``, ``we1``, ``we3``, ``we2``) agree at ``TOL``
(atol/rtol 1e-5), and an expert that no token picks gets a zero gradient
from both.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.models import lm as LM
from repro_torch.models import moe as M

TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 12
UNPICKED = 3          # the expert the router never picks
LEAVES = ("ln", "router", "we1", "we3", "we2")


def _looped(lhs, rhs, group_sizes, *, impl=None):
    assert impl == "ref"
    return gmm_ref.grouped_matmul_looped(lhs, rhs, group_sizes)


def _layer(arch):
    """A REDUCED moe layer in f32 whose router cannot pick ``UNPICKED``:
    its inputs are positive (log-normal, spread enough that the tokens
    pick the other experts apart), so are the normalised rows ``h``, and
    that expert's router column lies below minus every other column's
    magnitude, so its logit is below every other expert's."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    p = LM.init_params(cfg, 0, device="cpu")["layers"][0]["moe"]
    leaves = {n: p[n].detach().clone() for n in LEAVES}
    gen = torch.Generator().manual_seed(2)
    leaves["ln"] = 1.0 + 0.1 * torch.rand((cfg.d_model,), generator=gen)
    router = leaves["router"]
    router[:, UNPICKED] = -router.abs().max(1).values - 0.1
    x = torch.randn((B, S, cfg.d_model), generator=gen).mul(2.0).exp()
    return cfg, leaves, x


def _run(forward, cfg, leaves, x):
    leaves = {n: t.clone().requires_grad_(True) for n, t in leaves.items()}
    x = x.clone().requires_grad_(True)
    y, aux = forward(cfg, leaves, x)
    gen = torch.Generator().manual_seed(3)
    probe = torch.randn(y.shape, generator=gen)
    loss = (probe * y).sum() + 0.37 * aux
    grads = torch.autograd.grad(loss, [x] + [leaves[n] for n in LEAVES])
    return y.detach(), aux.detach(), dict(zip(("x",) + LEAVES, grads))


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x7b",
                                  "qwen3-moe-235b-a22b"])
def test_looped_dropless_route_matches_the_capacity_route(arch, monkeypatch):
    cfg, leaves, x = _layer(arch)
    T = B * S
    assert M.capacity(cfg, T) >= T          # nothing overflows a buffer
    _, _, idx = M._route(cfg, leaves["router"],
                         M.rmsnorm(x, leaves["ln"]).reshape(T, -1))
    picked = set(idx.reshape(-1).tolist())
    assert UNPICKED not in picked and len(picked) == cfg.num_experts - 1

    want = _run(M.moe_forward_capacity, cfg, leaves, x)
    before = gmm_ops.ragged_launches, gmm_ops.ragged_bf16_launches
    monkeypatch.setattr(gmm_ops, "grouped_matmul", _looped)
    got = _run(lambda c, p, xx: M.moe_forward_dropless(c, p, xx,
                                                       gmm_impl="ref"),
               cfg, leaves, x)
    assert (gmm_ops.ragged_launches, gmm_ops.ragged_bf16_launches) == before

    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **TOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), **TOL)
    for name in ("x",) + LEAVES:
        np.testing.assert_allclose(got[2][name].numpy(),
                                   want[2][name].numpy(), **TOL,
                                   err_msg=name)
    for grads in (got[2], want[2]):
        for name in ("we1", "we3", "we2"):
            assert not grads[name][UNPICKED].any(), name
            assert grads[name][sorted(picked)].abs().sum() > 0, name
        # the load-balance loss reaches every router column
        assert grads["router"][:, UNPICKED].abs().sum() > 0


def test_looped_product_carries_gradients_to_every_group():
    """``grouped_matmul_looped`` carries the gradient to the rows and to
    each group's weights as the gather form's autograd does, with an empty
    group (the middle one) at zero, and rows past the groups' sum in the
    last group; its backward writes each operand's gradient in one
    ``cat`` / ``stack`` (no ``SliceBackward`` or ``SelectBackward`` a
    group)."""
    gen = torch.Generator().manual_seed(4)
    sizes = torch.tensor([5, 0, 4], dtype=torch.int32)
    lhs = torch.randn((12, 6), generator=gen)
    rhs = torch.randn((3, 6, 4), generator=gen)
    probe = torch.randn((12, 4), generator=gen)
    grads = []
    for product in (gmm_ref.grouped_matmul_looped, gmm_ref.grouped_matmul):
        a, w = lhs.clone().requires_grad_(True), rhs.clone().requires_grad_(
            True)
        (probe * product(a, w, sizes)).sum().backward()
        grads.append((a.grad, w.grad))
    (ga, gw), (wa, ww) = grads
    np.testing.assert_allclose(ga.numpy(), wa.numpy(), **TOL)
    np.testing.assert_allclose(gw.numpy(), ww.numpy(), **TOL)
    assert not gw[1].any() and gw[0].abs().sum() > 0 and gw[2].abs().sum() > 0
    a = lhs.clone().requires_grad_(True)
    w = rhs.clone().requires_grad_(True)
    out = gmm_ref.grouped_matmul_looped(a, w, sizes)
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    names = {type(fn).__name__ for fn in seen}
    assert {"UnbindBackward0", "SplitWithSizesBackward0"} <= names
    assert not names & {"SelectBackward0", "SliceBackward0", "CopySlices"}


def test_chip_smoke_records_and_replays_the_looped_products(monkeypatch):
    """``chip_smoke.py``'s ``moe_train`` sizes the expert products' share
    of a step by recording them (``LoopedProducts``) and replaying them
    with their backward: a dropless forward through the loop records its
    three products (up, gate, down) with their operands and sizes, the
    function is restored on exit, and the replay differentiates each with
    respect to both operands, leaving no operand marked for a gradient."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_moe_train",
        Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    cfg, leaves, x = _layer("moonshot-v1-16b-a3b")
    monkeypatch.setattr(gmm_ops, "grouped_matmul", _looped)
    looped = gmm_ref.grouped_matmul_looped
    with chip.LoopedProducts(gmm_ref) as rec:
        M.moe_forward_dropless(cfg, leaves, x, gmm_impl="ref")
    assert gmm_ref.grouped_matmul_looped is looped
    T = B * S * cfg.top_k
    assert [(tuple(a.shape), tuple(w.shape)) for a, w, _ in rec.calls] == [
        ((T, cfg.d_model), tuple(leaves["we1"].shape)),
        ((T, cfg.d_model), tuple(leaves["we3"].shape)),
        ((T, cfg.d_ff), tuple(leaves["we2"].shape))]
    assert all(int(sizes.sum()) == T for _, _, sizes in rec.calls)
    rec.replay()
    assert not any(a.requires_grad or w.requires_grad
                   for a, w, _ in rec.calls)
