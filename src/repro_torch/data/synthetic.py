"""Data pipeline for world-model pre-training: the port of
``repro/data/synthetic.py``.

Two sources:

* ``DynamicsTokenStream``: deterministic synthetic 'tokenised dynamics'
  (s_{t+1} = f(s_t, a_t) mod V), an infinite, seekable stream for the
  training examples and the LM train step. Each batch is a pure function of
  (seed, step), so a restored run resumes on the same data.
* ``trajectory_tokens``: discretises real MBRL trajectories (obs/act from
  the replay buffer) into world-model token sequences by per-dimension
  uniform binning, with the reference's f32 arithmetic and truncating
  casts.

Randomness is injected: ``batch_at`` takes the start states and actions
the reference draws with ``jax.random`` (the parity tests pass JAX's
draws); without them it draws its own from a ``torch.Generator`` seeded by
(seed, step), which is deterministic but not the reference's stream.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device

N_ACTIONS = 7


@dataclasses.dataclass(frozen=True)
class DynamicsTokenStream:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    device: object = None

    def batch_at(self, step: int, *, s0=None, acts=None):
        """Batch for global step ``step``: ``{"tokens", "labels"}`` int32
        ``(batch, seq_len)``, labels equal to tokens as in the reference.
        ``s0`` (batch,) / ``acts`` (batch, seq_len) inject the draws;
        without them they come from a generator seeded by (seed, step)."""
        if s0 is None or acts is None:
            dev = resolve_device(self.device)
            gen = torch.Generator(device=dev).manual_seed(
                (self.seed << 32) ^ step)
            s0 = torch.randint(0, self.vocab, (self.batch,), generator=gen,
                               device=dev)
            acts = torch.randint(0, N_ACTIONS, (self.batch, self.seq_len),
                                 generator=gen, device=dev)
        s = torch.as_tensor(s0).to(torch.int64)
        a = torch.as_tensor(acts, device=s.device).to(torch.int64)
        toks = []
        for t in range(a.shape[1]):
            s = (s * 31 + a[:, t] * 131 + 17) % self.vocab
            toks.append(s)
        toks = torch.stack(toks, 1).to(torch.int32)
        return {"tokens": toks, "labels": toks}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def trajectory_tokens(obs, act, *, bins: int = 32, obs_low=None,
                      obs_high=None):
    """Discretise (H, obs_dim) observations + (H, act_dim) actions into a
    single interleaved token sequence: per timestep, [obs_dim tokens]
    [act_dim tokens]. Token ids are offset per dimension so the vocabulary
    factorises: vocab = bins * (obs_dim + act_dim)."""
    obs = torch.as_tensor(obs)
    act = torch.as_tensor(act, device=obs.device)
    H, D = obs.shape
    A = act.shape[1]
    lo = torch.as_tensor(obs_low, device=obs.device) \
        if obs_low is not None else obs.amin(0)
    hi = torch.as_tensor(obs_high, device=obs.device) \
        if obs_high is not None else obs.amax(0)
    obs_bin = torch.clamp(((obs - lo) / torch.clamp(hi - lo, min=1e-6)
                           * (bins - 1)).to(torch.int32), 0, bins - 1)
    act_bin = torch.clamp(((torch.clamp(act, -1, 1) + 1) / 2
                           * (bins - 1)).to(torch.int32), 0, bins - 1)
    dev = obs.device
    obs_tok = obs_bin + (torch.arange(D, device=dev) * bins)[None, :]
    act_tok = act_bin + ((D + torch.arange(A, device=dev)) * bins)[None, :]
    return torch.cat([obs_tok, act_tok], 1).reshape(-1).to(torch.int32)
