"""Transformer world-model dynamics: the port of
``repro/mbrl/wm_dynamics.py``.

The same ``predict(params, obs, act, generator)`` contract as the MLP
ensemble (``mbrl.dynamics``), backed by a token-level decoder LM from
``models/``: transitions are discretised by per-dimension binning into
sequences ``[obs tokens | act tokens | next-obs tokens]``; training is
teacher-forced next-token prediction with the loss masked to the next-obs
region; imagination decodes the next-obs tokens greedily.

The envs are Markov, so conditioning on a single (s, a) is exact: each
imagination step is one lock-step prefill of the ``d + a`` prompt tokens
(through the flash-attention kernel on the card) and ``d`` greedy decodes.
``make_algo(..., predict_fn=wm.predict_fn())`` swaps the ensemble for the
world model with no other change.

Tokens use the reference's f32 arithmetic and truncating casts. Training
runs by autograd of the plain attention (``attn_impl="ref"``), the
reference's own gradient route; its epoch permutation is injectable.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.models import api
from repro_torch.models import lm as LM
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import adam


@dataclasses.dataclass(frozen=True)
class WMConfig:
    obs_dim: int
    act_dim: int
    bins: int = 33
    d_model: int = 128
    num_layers: int = 2
    num_heads: int = 4
    lr: float = 1e-3


class WorldModelDynamics:
    """Random weights from ``seed`` on ``device`` (None: the card)."""

    def __init__(self, cfg: WMConfig, seed: int = 0, *, device=None):
        self.cfg = cfg
        d, a = cfg.obs_dim, cfg.act_dim
        vocab = cfg.bins * (d + a + d)   # per-position offsets, no aliasing
        self.mcfg = ModelConfig(
            name="wm", family="dense", num_layers=cfg.num_layers,
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_heads, d_ff=cfg.d_model * 4,
            vocab_size=vocab, lr=cfg.lr)
        self.device = resolve_device(device)
        self.seq = 2 * d + a
        self.params = LM.init_params(self.mcfg, seed, device=self.device)
        self._opt = adam(cfg.lr)
        self.opt_state = self._opt.init(LM.trainable(self.params))
        # normalisation bounds (updated from data)
        self.norm = {"lo": torch.full((d,), -1.0, device=self.device),
                     "hi": torch.full((d,), 1.0, device=self.device)}
        self._prefill = LM.make_prefill(self.mcfg)
        self._decode = LM.make_decode(self.mcfg)

    # ------------------------------------------------------------ tokens
    def _offsets(self, block: int, n: int):
        return (block + torch.arange(n, device=self.device)) * self.cfg.bins

    def tok_obs(self, obs, norm, block: int):
        """Observation bins offset into position block ``block`` (0 for s,
        ``d + a`` for s')."""
        bins = self.cfg.bins
        lo, hi = norm["lo"], norm["hi"]
        b = torch.clamp(((obs - lo) / torch.clamp(hi - lo, min=1e-6)
                         * (bins - 1)).to(torch.int32), 0, bins - 1)
        return (b + self._offsets(block, self.cfg.obs_dim)).to(torch.int32)

    def tok_act(self, act):
        bins = self.cfg.bins
        b = torch.clamp(((torch.clamp(act, -1, 1) + 1) / 2
                         * (bins - 1)).to(torch.int32), 0, bins - 1)
        return (b + self._offsets(self.cfg.obs_dim, self.cfg.act_dim)
                ).to(torch.int32)

    def tokens(self, obs, act, next_obs, norm=None):
        """The training batch of the reference's ``tok_batch``: tokens
        ``(n, 2d + a)`` and next-token labels, -1 outside the next-obs
        region."""
        norm = self.norm if norm is None else norm
        d, a = self.cfg.obs_dim, self.cfg.act_dim
        toks = torch.cat([self.tok_obs(obs, norm, 0), self.tok_act(act),
                          self.tok_obs(next_obs, norm, d + a)], 1)
        n = obs.shape[0]
        none = torch.full((n, d + a), -1, dtype=torch.int32,
                          device=toks.device)
        labels = torch.cat([none, toks[:, d + a:]], 1)
        # next-token objective: shift labels left by one
        labels = torch.cat([labels[:, 1:], none[:, :1]], 1)
        return {"tokens": toks, "labels": labels}

    def update_normalizer(self, obs):
        self.norm = {"lo": obs.amin(0) - 1e-3, "hi": obs.amax(0) + 1e-3}

    # ------------------------------------------------------------- train
    def _train_step(self, obs, act, next_obs):
        batch = self.tokens(obs, act, next_obs)

        def loss_fn():
            s, c, _ = LM.loss_forward(self.mcfg, self.params, batch,
                                      attn_impl="ref")
            return s / torch.clamp(c, min=1)
        loss, g = LM.value_and_grad(self.params, loss_fn)
        with torch.no_grad():
            upd, self.opt_state = self._opt.update(
                g, self.opt_state, LM.trainable(self.params))
        LM.apply_to(self.params, upd)
        return loss

    def train_epoch(self, obs, act, next_obs, perm=None, *, generator=None,
                    batch_size: int = 256) -> float:
        """One epoch of minibatches in the order of ``perm`` (a
        permutation of the rows; drawn from ``generator`` when None), the
        tail that does not fill a batch dropped. Returns the last loss."""
        n = obs.shape[0]
        bs = min(batch_size, n)
        if perm is None:
            perm = torch.randperm(n, generator=generator,
                                  device=generator.device if generator
                                  is not None else self.device)
        perm = torch.as_tensor(perm, device=obs.device)
        perm = perm[:(n // bs) * bs].reshape(-1, bs)
        loss = 0.0
        for idx in perm:
            loss = float(self._train_step(obs[idx], act[idx], next_obs[idx]))
        return loss

    # ----------------------------------------------------------- predict
    @torch.no_grad()
    def _predict(self, params, norm, obs, act):
        cfg = self.cfg
        d, a, bins = cfg.obs_dim, cfg.act_dim, cfg.bins
        prompt = torch.cat([self.tok_obs(obs, norm, 0), self.tok_act(act)],
                           1)                                 # (B, d+a)
        logits, cache = self._prefill(params, {"tokens": prompt})
        cache = api.grow_cache(cache, self.seq + 1)
        outs = []
        for j in range(d):
            off = (d + a + j) * bins
            tok = torch.argmax(logits[:, off:off + bins], -1) + off
            outs.append(tok)
            logits, cache = self._decode(params, cache,
                                         tok[:, None].to(torch.int32))
        toks = torch.stack(outs, 1)                           # (B, d)
        b = torch.clamp(toks - self._offsets(d + a, d)[None], 0,
                        bins - 1).to(torch.float32)
        return norm["lo"] + b / (bins - 1) * (norm["hi"] - norm["lo"])

    def predict_fn(self):
        """``predict(params, obs, act, generator)`` with the ensemble's
        contract (shape-checked and tagged by ``api.as_predict_fn``); the
        normaliser is the one of this moment, as in the reference."""
        norm = self.norm
        return api.as_predict_fn(
            lambda params, obs, act, generator: self._predict(
                params, norm, obs, act))

    def predict(self, obs, act, generator=None):
        return self._predict(self.params, self.norm, obs, act)
