"""The port's ``ReplayBuffer`` against a plain-python FIFO ring oracle,
over a seeded sweep (no hypothesis): the cases of the reference's
``tests/test_replay_property.py``, drawn from numpy generators.

The oracle is the documented contract, transition by transition: every
``round(1 / holdout_frac)``-th trajectory (at least every 2nd) goes to the
val ring; a trajectory longer than its ring keeps only its LAST ``cap``
transitions; writes land at ``cursor % cap`` and wrap. Each case checks the
exact slot layout of both rings (wrap-around order, not only the surviving
set), eviction, the val interleave count and the ``size`` / ``val_size`` /
``total_seen`` accounting, once with one ``add_traj`` a trajectory and once
with the same trajectories drained in bursts (``add_trajs``), whose
chunked scatters must leave the same rings.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.servers import ReplayBuffer


class _RingOracle:
    """Plain-python FIFO ring: value v written at slot (cursor + t) % cap."""

    def __init__(self, cap):
        self.cap = cap
        self.slots = [None] * cap
        self.cursor = 0
        self.written = 0

    def write(self, values):
        values = values[-self.cap:]          # traj > cap: keep the LAST cap
        for t, v in enumerate(values):
            self.slots[(self.cursor + t) % self.cap] = v
        self.cursor = (self.cursor + len(values)) % self.cap
        self.written += len(values)

    @property
    def size(self):
        return min(self.written, self.cap)


def _traj(i, h):
    vals = torch.tensor([i * 1000.0 + t for t in range(h)])
    return {"obs": vals[:, None], "act": -vals[:, None]}


def _bursts(rng, n):
    """Split ``range(n)`` into consecutive bursts of 1 to 5."""
    out, i = [], 0
    while i < n:
        k = int(rng.integers(1, 6))
        out.append(list(range(i, min(i + k, n))))
        i += k
    return out


def _check_against_oracle(lengths, cap, frac, bursts=None):
    rb = ReplayBuffer(cap, holdout_frac=frac, device="cpu")
    every = max(int(round(1 / frac)), 2) if frac > 0 else 0
    train_oracle = _RingOracle(cap)
    val_oracle = _RingOracle(rb.val_capacity)
    n_val = 0
    for i, h in enumerate(lengths):
        to_val = bool(every and (i + 1) % every == 0)
        n_val += to_val
        (val_oracle if to_val else train_oracle).write(
            [i * 1000.0 + t for t in range(h)])
    for group in bursts or [[i] for i in range(len(lengths))]:
        trajs = [_traj(i, lengths[i]) for i in group]
        if bursts is None:
            rb.add_traj(trajs[0])
        else:
            rb.add_trajs(trajs)

    assert rb.total_seen == len(lengths)
    assert n_val == (len(lengths) // every if every else 0)
    assert rb.size == train_oracle.size
    assert rb.val_size == val_oracle.size
    for ring, oracle in ((rb.train_view, train_oracle),
                         (rb.val_view, val_oracle)):
        data, size = ring()
        assert size == oracle.size
        if data is None:
            assert oracle.written == 0
            continue
        obs, act = data["obs"][:, 0].numpy(), data["act"][:, 0].numpy()
        for slot, expect in enumerate(oracle.slots):
            want = 0.0 if expect is None else expect  # untouched: zeros
            assert obs[slot] == want and act[slot] == -want, (
                f"slot {slot}: got {obs[slot]}, want {want} "
                f"(wrap-around order broken)")


@pytest.mark.parametrize("drain", ["one_by_one", "bursts"])
@pytest.mark.parametrize("seed", range(10))
def test_ring_matches_fifo_oracle(seed, drain):
    """Lengths 1-9, 1-25 trajectories, capacities 2-12 and val fractions
    0, 0.2 and 0.5: wrap-around and the val interleave. Every fourth
    seed draws one horizon for all, so that bursts scatter in chunks."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 26))
    lengths = (rng.integers(1, 10, n) if seed % 4 else
               np.full(n, rng.integers(1, 10))).tolist()
    cap = int(rng.integers(2, 13))
    frac = float(rng.choice([0.0, 0.2, 0.5]))
    _check_against_oracle(lengths, cap, frac,
                          _bursts(rng, n) if drain == "bursts" else None)


@pytest.mark.parametrize("drain", ["one_by_one", "bursts"])
@pytest.mark.parametrize("seed", range(5))
def test_traj_longer_than_capacity_keeps_last_cap(seed, drain):
    """Every trajectory exceeds the ring (capacity 2-6, lengths 7-30): only
    the newest ``cap`` transitions of the latest writes survive."""
    rng = np.random.default_rng(100 + seed)
    cap = int(rng.integers(2, 7))
    lengths = rng.integers(7, 31, int(rng.integers(1, 9))).tolist()
    _check_against_oracle(lengths, cap, 0.0,
                          _bursts(rng, len(lengths))
                          if drain == "bursts" else None)


def test_val_fraction_sweep_interleaves_every_nth():
    """At each val fraction, 40 trajectories of 3 transitions into rings
    larger than all of them: the val ring holds exactly the every-n-th
    trajectories, in order, and the train ring the rest."""
    for frac, every in ((0.2, 5), (0.25, 4), (0.5, 2), (0.9, 2)):
        rb = ReplayBuffer(200, val_capacity=200, holdout_frac=frac,
                          device="cpu")
        for i in range(40):
            rb.add_traj(_traj(i, 3))
        val_ids = [i for i in range(40) if (i + 1) % every == 0]
        train_ids = [i for i in range(40) if (i + 1) % every]
        for view, ids in ((rb.val_view, val_ids), (rb.train_view, train_ids)):
            data, size = view()
            assert size == 3 * len(ids)
            got = data["obs"][:size, 0].numpy()
            want = [i * 1000.0 + t for i in ids for t in range(3)]
            np.testing.assert_array_equal(got, want)
