"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. A CUDA kernel has no CPU mode, so every test here
is marked ``gpu`` and skips without a card. The file imports no JAX, so it
also runs on a card machine that has none:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref

# kernel vs plain version, both rounding one f32 result to the output dtype:
# f32 outputs differ only by the order of f32 sums; bf16 outputs by up to
# a bf16 ulp or two (7.8e-3 at |o| < 2)
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

ATTN_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 64, 192, 4, 1, 64, True, 64),     # prefix cache + sliding window
    (1, 64, 64, 2, 2, 64, False, 0),
    (1, 100, 100, 32, 2, 128, True, 0),   # GQA G=16, S not a tile multiple
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_ref(card, case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, win = case
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, dtype) for shape in
        ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    before = fa_ops.launches
    got = fa_ops.attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa_ref.chunked_attention(q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=ATOL[dtype], rtol=ATOL[dtype])


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_unsupported_head_dim(card):
    q = torch.zeros((1, 8, 2, 32), device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.attention(q, q, q)
