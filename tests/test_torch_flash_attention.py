"""Attention in the PyTorch port against the JAX reference.

The same numpy-seeded inputs go through the reference's Pallas kernel (in
interpret mode, as ``test_kernels_interpret.py`` runs it on the CPU), its
``naive`` oracle, and the port's plain versions and dispatcher, in f32 at
atol/rtol 1e-5: the functions are equal, only the order of f32 sums
differs. The hand-written CUDA kernel runs only on a card: its tests are
in ``test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro_torch.kernels.flash_attention import cuda as fa_cuda
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window  (test_kernels_interpret.py)
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 64, 192, 4, 1, 64, True, 64),     # prefix cache + sliding window
    (1, 64, 64, 2, 2, 32, False, 0),
    (1, 48, 48, 32, 2, 64, True, 0),      # GQA G=16, as GLM-4-9B
    (4, 4, 4, 4, 4, 32, True, 0),         # WMConfig defaults' prefill
    (3, 33, 40, 4, 4, 24, True, 16),      # the examples' head dim 24
]


def _inputs(case, seed=0):
    B, Sq, Sk, Hq, Hkv, D, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_port_attention_matches_jax(case):
    causal, win = case[6], case[7]
    q, k, v = _inputs(case)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want_pallas = np.asarray(jfa_ops.attention(
        jq, jk, jv, causal=causal, window=win, impl="pallas",
        interpret=True))
    want_naive = np.asarray(jfa_ref.naive_attention(
        jq, jk, jv, causal=causal, window=win))
    got = {
        "chunked": fa_ref.chunked_attention(tq, tk, tv, causal=causal,
                                            window=win),
        "naive": fa_ref.naive_attention(tq, tk, tv, causal=causal,
                                        window=win),
        "ops": fa_ops.attention(tq, tk, tv, causal=causal, window=win),
    }
    for name, out in got.items():
        assert out.shape == q.shape and out.dtype == torch.float32, name
        np.testing.assert_allclose(out.numpy(), want_pallas, **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(out.numpy(), want_naive, **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("block", [16, 40])
def test_chunked_blocks_straddle_like_kernel_tiles(block):
    """Many kv blocks with a ragged last one: the online-softmax recurrence
    the kernel runs, against the one-shot softmax."""
    case = (2, 100, 130, 8, 2, 64, True, 48)
    q, k, v = (torch.from_numpy(a) for a in _inputs(case, seed=3))
    got = fa_ref.chunked_attention(q, k, v, window=48, block_q=block,
                                   block_k=block)
    want = fa_ref.naive_attention(q, k, v, window=48)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_bf16_output_dtype_and_f32_softmax():
    case = (1, 32, 32, 4, 2, 64, True, 0)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(case, seed=5))
    got = fa_ops.attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = jfa_ref.naive_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)))
    # both round one f32 result to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def test_cpu_tensors_take_ref_and_never_count_a_launch(monkeypatch):
    monkeypatch.setattr(fa_ops, "launches", 0)
    q, k, v = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    fa_ops.attention(q, k, v)
    fa_ops.attention(q, k, v, impl="ref")
    assert fa_ops.launches == 0


def test_kernel_route_refuses_a_backward_and_ref_keeps_the_graph(
        monkeypatch):
    """The kernel route's wiring with a stand-in for the binding that
    allocates its output as the real one does (``torch.empty_like(q)``,
    filled outside autograd): a gradient through it raises with a pointer
    to the roadmap instead of silently losing the attention term, while
    ``impl="ref"`` keeps its graph and serving under ``no_grad`` still
    counts one launch a call."""
    def binding(q, k, v, *, causal, window, scale):
        o = torch.empty_like(q)
        with torch.no_grad():
            o.copy_(fa_ref.chunked_attention(q, k, v, causal=causal,
                                             window=window, scale=scale))
        return o

    monkeypatch.setattr(fa_ops.cuda, "flash_attention", binding)
    monkeypatch.setattr(fa_ops, "launches", 0)
    case = CASES[0]
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _inputs(case))
    want = fa_ops.attention(q, k, v, causal=case[6], impl="ref")
    assert want.grad_fn is not None
    got = fa_ops.attention(q, k, v, causal=case[6], impl="cuda")
    assert fa_ops.launches == 1
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        got.sum().backward()
    assert q.grad is None
    with torch.no_grad():
        served = fa_ops.attention(q, k, v, causal=case[6], impl="cuda")
    assert fa_ops.launches == 2 and served.grad_fn is None


def test_dispatch_refuses_what_it_cannot_run():
    q, k, v = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa_ops.attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        fa_cuda.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="unknown attention impl"):
        fa_ops.attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="Sq <= Sk"):
        fa_ops.attention(q, k[:, :64], v[:, :64])


def test_head_dims_run_in_the_next_compiled_instance():
    """Any head dim that is a multiple of 8 up to 128 runs in the next
    compiled instance up (its tail loaded as zeros); any other raises
    before a launch, on every device."""
    assert [fa_cuda.instance_dim(d) for d in (8, 24, 32, 40, 64, 72, 128)] \
        == [32, 32, 32, 64, 64, 128, 128]
    for d in (4, 36, 100, 136, 256):
        with pytest.raises(ValueError, match="head dims"):
            fa_cuda.instance_dim(d)


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(tmp_path,
                                                        monkeypatch):
    """The library name hashes the source, so an edited kernel never loads
    a stale build; without nvcc the build raises instead of falling back."""
    from repro_torch.kernels import build
    src = tmp_path / "k.cu"
    src.write_text("extern \"C\" int f() { return 0; }\n")
    first = build.library_path(src)
    src.write_text("extern \"C\" int f() { return 1; }\n")
    assert build.library_path(src) != first
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os, "access", lambda *_: False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([src])
    assert list((tmp_path / "out").iterdir()) == []


# ---------------------------------------------------------------------------
# The bf16 kernel's one arithmetic difference: P rounded to bf16 before P V

ATTN_ATOL_BF16 = 2e-2   # chip_smoke.ATTN_ATOL[bf16]: a bf16 ulp or two


def _bf16_p_attention(q, k, v, *, causal=True, window=0, block_k=64):
    """A model of the bf16 kernel on the CPU: f32 scores of bf16 inputs,
    online softmax over 64-row kv tiles (running max m and sum l of the
    f32 P), with P rounded to bf16 (round to nearest even, as
    ``__floats2bfloat162_rn``) before it multiplies V."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    q_idx = torch.arange(Sq) + (Sk - Sq)
    m = torch.full((B, Hkv, G, Sq), fa_ref.NEG_INF)
    l = torch.zeros((B, Hkv, G, Sq))
    o = torch.zeros((B, Hkv, G, Sq, D))
    for k0 in range(0, Sk, block_k):
        k_idx = torch.arange(k0, min(k0 + block_k, Sk))
        kt, vt = k[:, k0:k0 + block_k].float(), v[:, k0:k0 + block_k].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kt) * D ** -0.5
        mask = fa_ref._mask(q_idx, k_idx, causal, window)
        s = torch.where(mask, s, torch.full_like(s, fa_ref.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p16 = p.to(torch.bfloat16).float()
        o = o * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p16, vt)
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    return torch.einsum("bhgqd->bqhgd", o).reshape(B, Sq, Hq, D).to(q.dtype)


def test_sass_opcode_count_reads_predicated_and_plain_lines(monkeypatch):
    """The build phase's tensor-core count: opcodes of ``cuobjdump -sass``
    lines, predicated or not, matched by prefix."""
    from repro_torch.kernels import build
    sass = """
        /*0150*/                   HMMA.1688.F32.TF32 R4, R16, R20, R4 ;
                                                     /* 0x000fe20000000f00 */
        /*0160*/              @!P0 HMMA.16816.F32.BF16 R8, R16, R20, R8 ;
        /*0170*/                   FFMA R1, R2, R3, R4 ;
        /*0180*/                   LDSM.16.M88.4 R12, [R2] ;
"""
    monkeypatch.setattr(build, "cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(build.subprocess, "run", lambda *a, **k: type(
        "Done", (), {"stdout": sass})())
    assert build.count_sass("lib.so", "HMMA") == 2
    assert build.count_sass("lib.so", "FFMA") == 1
    assert build.count_sass("lib.so", "IMMA") == 0


@pytest.mark.parametrize("S", [16, 32, 64, 1024])
def test_bf16_p_stays_within_bf16_atol_of_f32_p(S):
    """At the serving buckets (GLM-4-9B: 32 q heads, 2 kv heads, D = 128)
    and at S = 1,024, rounding P to bf16 moves the bf16 output by no more
    than the tolerance the card holds the kernel to against the plain
    version, which multiplies f32 P by V widened to f32."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in
        ((1, S, 32, 128), (1, S, 2, 128), (1, S, 2, 128)))
    got = _bf16_p_attention(q, k, v)
    want = fa_ref.chunked_attention(q, k, v)
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_ATOL_BF16, err
