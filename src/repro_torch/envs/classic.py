"""Pendulum swing-up, cart-pole swing-up and a planar hopper-like
benchmark as analytic batched torch dynamics: the port of
``repro/envs/classic.py``."""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.envs.base import Env, angle_normalize, uniform


@dataclasses.dataclass(frozen=True)
class Pendulum(Env):
    obs_dim: int = 3
    act_dim: int = 1
    horizon: int = 200
    dt: float = 0.05
    name: str = "pendulum"
    reset_shape: tuple = (2,)       # theta, theta-dot
    reset_dist: str = "uniform"
    g: float = 10.0
    m: float = 1.0
    l: float = 1.0
    max_torque: float = 2.0
    max_speed: float = 8.0

    def reset_from(self, draws):
        th = uniform(draws[..., 0], -math.pi, math.pi)
        thdot = uniform(draws[..., 1], -1.0, 1.0)
        return torch.stack([torch.cos(th), torch.sin(th), thdot], -1)

    def reward(self, s, a, s2):
        th = torch.atan2(s[..., 1], s[..., 0])
        u = torch.clamp(a[..., 0], -self.max_torque, self.max_torque)
        cost = angle_normalize(th) ** 2 + 0.1 * s[..., 2] ** 2 \
            + 0.001 * u ** 2
        return -cost

    def step(self, state, action):
        cos_th, sin_th, thdot = state.unbind(-1)
        th = torch.atan2(sin_th, cos_th)
        u = torch.clamp(action[..., 0], -self.max_torque, self.max_torque)
        thdot2 = thdot + (3 * self.g / (2 * self.l) * torch.sin(th)
                          + 3.0 / (self.m * self.l ** 2) * u) * self.dt
        thdot2 = torch.clamp(thdot2, -self.max_speed, self.max_speed)
        th2 = th + thdot2 * self.dt
        ns = torch.stack([torch.cos(th2), torch.sin(th2), thdot2], -1)
        return ns, self.reward(state, action, ns)


@dataclasses.dataclass(frozen=True)
class CartpoleSwingup(Env):
    obs_dim: int = 5
    act_dim: int = 1
    horizon: int = 200
    dt: float = 0.05
    name: str = "cartpole_swingup"
    reset_shape: tuple = (4,)
    reset_dist: str = "normal"
    mc: float = 1.0
    mp: float = 0.1
    l: float = 0.5
    g: float = 9.8
    fmax: float = 10.0

    def reset_from(self, draws):
        x = 0.05 * draws
        th = math.pi + x[..., 2]  # hanging down
        return torch.stack([x[..., 0], x[..., 1], torch.cos(th),
                            torch.sin(th), x[..., 3]], -1)

    def step(self, state, action):
        x, xdot, costh, sinth, thdot = state.unbind(-1)
        th = torch.atan2(sinth, costh)
        f = torch.clamp(action[..., 0], -1, 1) * self.fmax
        mt = self.mc + self.mp
        tmp = (f + self.mp * self.l * thdot ** 2 * sinth) / mt
        thacc = (self.g * sinth - costh * tmp) / (
            self.l * (4.0 / 3.0 - self.mp * costh ** 2 / mt))
        xacc = tmp - self.mp * self.l * thacc * costh / mt
        x = x + xdot * self.dt
        xdot = xdot + xacc * self.dt
        th = th + thdot * self.dt
        thdot = thdot + thacc * self.dt
        ns = torch.stack([x, xdot, torch.cos(th), torch.sin(th), thdot], -1)
        return ns, self.reward(state, action, ns)

    def reward(self, s, a, s2):
        f = torch.clamp(a[..., 0], -1, 1) * self.fmax
        return s2[..., 2] - 0.01 * s2[..., 0] ** 2 - 0.001 * f ** 2 \
            - 0.001 * s2[..., 4] ** 2


@dataclasses.dataclass(frozen=True)
class SpringHopper(Env):
    """1-D hopper: mass on an actuated spring leg; reward = forward hop
    velocity while staying alive. A cheap stand-in for locomotion tasks."""
    obs_dim: int = 4
    act_dim: int = 1
    horizon: int = 200
    dt: float = 0.02
    name: str = "spring_hopper"
    reset_shape: tuple = ()
    reset_dist: str = "normal"
    g: float = 9.8
    k_spring: float = 80.0
    m: float = 1.0

    def reset_from(self, draws):
        z = 1.0 + 0.05 * draws
        zero = torch.zeros_like(z)
        return torch.stack([zero, z, zero, zero], -1)  # x, z, xdot, zdot

    def step(self, state, action):
        x, z, xdot, zdot = state.unbind(-1)
        u = torch.clamp(action[..., 0], -1, 1)
        contact = z < 0.5
        zero = torch.zeros_like(z)
        f_spring = torch.where(contact, self.k_spring * (0.5 - z) * (1 + u),
                               zero)
        f_fwd = torch.where(contact, 3.0 * u, zero)
        zacc = f_spring / self.m - self.g
        xacc = f_fwd / self.m - 0.5 * xdot
        x = x + xdot * self.dt
        z = torch.clamp(z + zdot * self.dt, 0.05, 3.0)
        xdot = xdot + xacc * self.dt
        zdot = torch.where(z <= 0.05,
                           torch.clamp(zdot + zacc * self.dt, min=0.0),
                           zdot + zacc * self.dt)
        ns = torch.stack([x, z, xdot, zdot], -1)
        return ns, self.reward(state, action, ns)

    def reward(self, s, a, s2):
        u = torch.clamp(a[..., 0], -1, 1)
        return s2[..., 2] - 0.001 * u ** 2 \
            + 0.1 * torch.clamp(s2[..., 1], 0, 1)
