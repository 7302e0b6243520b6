"""Torque-controlled planar/spatial arms with the paper's PR2 reward: the
port of ``repro/envs/arm.py``.

``Reacher2`` is a 2-link planar arm; ``Arm7`` mirrors the paper's PR2
setup: 7 joints, torque control at 10 Hz, 23-D observation (7 angles,
7 velocities, 9 Cartesian points of the end-effector frame), and reward

    r(d) = -omega * d^2 - v * log(d^2 + alpha)        (omega=v=1, a=1e-5)

plus scaled quadratic penalties on joint velocities and torques (§5.5).
Tasks (reach / shape-match / lego-stack) differ only in target and
tolerance, as in the paper where objects are treated as fixed
end-effector extensions."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.envs.base import Env, uniform


def lorentzian_reward(d2, omega=1.0, v=1.0, alpha=1e-5):
    return -omega * d2 - v * torch.log(d2 + alpha)


@dataclasses.dataclass(frozen=True)
class Reacher2(Env):
    obs_dim: int = 8   # cos2, sin2, qdot2, fingertip xy
    act_dim: int = 2
    horizon: int = 100
    dt: float = 0.05
    name: str = "reacher2"
    reset_shape: tuple = (2,)
    reset_dist: str = "uniform"
    l1: float = 0.5
    l2: float = 0.5
    target: tuple = (0.6, 0.4)

    def _tip(self, q):
        q0, q1 = q[..., 0], q[..., 1]
        x = self.l1 * torch.cos(q0) + self.l2 * torch.cos(q0 + q1)
        y = self.l1 * torch.sin(q0) + self.l2 * torch.sin(q0 + q1)
        return torch.stack([x, y], -1)

    def _obs(self, q, qd):
        return torch.cat([torch.cos(q), torch.sin(q), qd, self._tip(q)], -1)

    def reset_from(self, draws):
        q = uniform(draws, -0.1, 0.1)
        return self._obs(q, torch.zeros_like(q))

    def step(self, state, action):
        q = torch.atan2(state[..., 2:4], state[..., 0:2])
        qd = state[..., 4:6]
        u = torch.clamp(action, -1, 1)
        qdd = 4.0 * u - 0.5 * qd      # damped double integrator per joint
        qd = torch.clamp(qd + qdd * self.dt, -8, 8)
        q = q + qd * self.dt
        ns = self._obs(q, qd)
        return ns, self.reward(state, action, ns)

    def reward(self, s, a, s2):
        u = torch.clamp(a, -1, 1)
        tip = s2[..., 6:8]
        target = torch.tensor(self.target, dtype=s2.dtype, device=s2.device)
        d2 = torch.sum((tip - target) ** 2, -1)
        return lorentzian_reward(d2) - 0.01 * torch.sum(s2[..., 4:6] ** 2, -1) \
            - 0.001 * torch.sum(u ** 2, -1)


_PR2_TASKS = {
    # target xyz in the arm frame; tolerance used only for reporting
    "reach": ((0.5, 0.2, 0.3), 0.02),
    "shape_match": ((0.45, -0.1, 0.15), 0.01),
    "lego_stack": ((0.4, 0.15, 0.1), 0.005),
}


@dataclasses.dataclass(frozen=True)
class Arm7(Env):
    obs_dim: int = 23  # 7q + 7qd + 9 cartesian points (3 frame points x 3)
    act_dim: int = 7
    horizon: int = 100
    dt: float = 0.1     # 10 Hz, as on the PR2
    name: str = "arm7_reach"
    reset_shape: tuple = (7,)
    reset_dist: str = "normal"
    task: str = "reach"
    link: float = 0.18

    def _target(self, like):
        return torch.tensor(_PR2_TASKS[self.task][0], dtype=like.dtype,
                            device=like.device)

    def _fk(self, q):
        """Simple spatial FK: alternating z/y rotation axes down the chain.
        Returns end-effector origin + two frame points (9 numbers)."""
        p = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
        R = torch.eye(3, dtype=q.dtype, device=q.device).expand(
            q.shape[:-1] + (3, 3))
        zero, one = torch.zeros_like(q[..., 0]), torch.ones_like(q[..., 0])
        for i in range(7):
            c, s = torch.cos(q[..., i]), torch.sin(q[..., i])
            if i % 2 == 0:  # rotate about z
                rows = [[c, -s, zero], [s, c, zero], [zero, zero, one]]
            else:           # about y
                rows = [[c, zero, s], [zero, one, zero], [-s, zero, c]]
            rot = torch.stack([torch.stack(r, -1) for r in rows], -2)
            R = R @ rot
            p = p + R[..., :, 0] * self.link   # R @ (link, 0, 0)
        fx = p + 0.05 * R[..., :, 0]
        fy = p + 0.05 * R[..., :, 1]
        return torch.cat([p, fx, fy], -1)

    def _obs(self, q, qd):
        return torch.cat([q, qd, self._fk(q)], -1)

    def reset_from(self, draws):
        q = 0.1 * draws
        return self._obs(q, torch.zeros_like(q))

    def step(self, state, action):
        q, qd = state[..., :7], state[..., 7:14]
        u = torch.clamp(action, -1, 1)
        qdd = 6.0 * u - 1.0 * qd - 0.3 * torch.sin(q)  # gravity-ish bias
        qd = torch.clamp(qd + qdd * self.dt, -4, 4)
        q = torch.clamp(q + qd * self.dt, -2.8, 2.8)
        ns = self._obs(q, qd)
        return ns, self.reward(state, action, ns)

    def reward(self, s, a, s2):
        u = torch.clamp(a, -1, 1)
        d2 = torch.sum((s2[..., 14:17] - self._target(s2)) ** 2, -1)
        return lorentzian_reward(d2) \
            - 0.05 * torch.sum(s2[..., 7:14] ** 2, -1) \
            - 0.01 * torch.sum(u ** 2, -1)

    def distance(self, state):
        return torch.linalg.vector_norm(
            state[..., 14:17] - self._target(state), dim=-1)


def make_env(name: str) -> Env:
    from repro_torch.envs.classic import (CartpoleSwingup, Pendulum,
                                          SpringHopper)
    table = {
        "pendulum": Pendulum(),
        "cartpole_swingup": CartpoleSwingup(),
        "spring_hopper": SpringHopper(),
        "reacher2": Reacher2(),
        "pr2_reach": Arm7(task="reach", name="arm7_reach"),
        "pr2_shape_match": Arm7(task="shape_match", name="arm7_shape"),
        "pr2_lego_stack": Arm7(task="lego_stack", name="arm7_lego"),
    }
    return table[name]
