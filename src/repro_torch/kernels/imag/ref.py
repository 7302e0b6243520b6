"""Plain PyTorch fused imagination step: the port of
``repro/kernels/imag/ref.py``.

One imagination step of the Dyna loop, as a single function of pre-drawn
randomness::

    mu   = policy_mlp(pol, s)                    # tanh-MLP mean
    pre  = mu + exp(pol.log_std) * eps           # pre-tanh action
    a    = tanh(pre)
    xn   = (concat(s, a) - mu_in) / sig_in       # dynamics input norm
    dyn  = member_mlp[member_idx[b]](xn[b])      # per-row assigned member
    s2   = s + dyn * sig_out + mu_out

``eps`` is standard-normal noise drawn outside the step, ``member_idx``
the uniform-prior member assignment. Like the reference's oracle, the
member selection evaluates all K members with the shared-input
``ensemble_mlp`` of ``kernels/gmm/ref.py`` and keeps each row's assigned
one: it is the bit-reference, not a fast path. The kernel in ``cuda.py``
is held against it on the card, and ``ops.FusedStep``'s backward is its
autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gmm import ref as gmm_ref


def policy_mu(pol, s):
    """Mean head of the tanh-squashed Gaussian policy (tanh hidden, linear
    out), kept local so the kernel family never imports ``mbrl``."""
    h = s
    n = len(pol["w"])
    for i, (w, b) in enumerate(zip(pol["w"], pol["b"])):
        h = h @ w + b
        if i < n - 1:
            h = torch.tanh(h)
    return h


def fused_step(members, norm, pol, s, eps, member_idx):
    """One fused imagination step on a batch.

    members: ``{"w": [(K, a, b) ...], "b": [(K, b) ...]}``; norm:
    ``mu_in/sig_in/mu_out/sig_out``; pol: ``w``/``b``/``log_std``; s:
    (B, obs); eps: (B, act) standard normal; member_idx: (B,) int in
    [0, K). Returns ``(s2, a, pre)``."""
    mu = policy_mu(pol, s)
    pre = mu + torch.exp(pol["log_std"]) * eps
    a = torch.tanh(pre)
    x = torch.cat([s, a], -1)
    xn = (x - norm["mu_in"]) / norm["sig_in"]
    dyn_all = gmm_ref.ensemble_mlp(members, xn)          # (K, B, obs)
    dyn = torch.take_along_dim(dyn_all, member_idx.long()[None, :, None],
                               dim=0)[0]
    s2 = s + dyn * norm["sig_out"] + norm["mu_out"]
    return s2, a, pre
