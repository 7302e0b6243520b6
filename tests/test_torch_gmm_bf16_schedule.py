"""The bf16 ragged product's TMA and wgmma route, on the CPU: its schedule
and its planner.

The kernel (``gmm.cu``'s ``gmm_ragged_bf16_wgmma``) runs only on a card;
its blocks find their work units from the group offsets there, by a
prefix sum. ``ragged_bf16_units`` below is a model of that enumeration in
Python, the units in the order the blocks take them, and these tests hold
the model to the properties the kernel's correctness rests on, at ``chip_smoke.py``'s MoE
shapes (group sizes drawn from a numpy seed, as an untrained router
spreads them) and at the edge patterns of ``test_kernels_interpret.py``:
every output element of a covered row is owned by exactly one unit of its
own group, the rows past ``offsets[G]`` by units that store zeros, an
empty group has no unit, the units never outnumber the launch's blocks,
and a float64 product computed unit by unit, as the kernel stores it,
equals the plain product (the port's and the JAX oracle's). Then the
planner's route and tiles at the MoE's decode and prefill and at shapes a
tensor map cannot address, its refusals, and its agreement with the tiles
and the shared memory ``gmm.cu`` instantiates. The card holds the kernel
itself to the looped plain product (``test_torch_kernels_gpu.py``): a
fault in the kernel's own prefix sum or unit decoding shows there, at the
edge patterns and in the CUDA-graph replay with new group sizes, not
here.
"""
import dataclasses
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gmm import ref as jgmm_ref
from repro_torch.kernels.gmm import cuda as gmm_cuda
from repro_torch.kernels.gmm import ref as gmm_ref

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bf16_cases", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP = _chip_smoke()


def _routed_sizes(seed, experts, tokens, top_k):
    """chip_smoke.routed_sizes in numpy: each token's ``top_k`` distinct
    experts drawn at random."""
    rng = np.random.default_rng(seed)
    picks = rng.random((tokens, experts)).argsort(-1)[:, :top_k]
    return np.bincount(picks.reshape(-1), minlength=experts).tolist()


# name, G, M, K, N, group sizes; the MoE's rows as moe_check draws them
MOE_CASES = [(name, G, T * k, K, N, _routed_sizes(i, G, T, k))
             for i, (name, G, T, k, K, N) in enumerate(CHIP.MOE_GMM_CASES)]
EDGE_CASES = [(name, G, M, K, N, list(sizes))
              for name, G, M, K, N, sizes in CHIP.GMM_RAGGED_CASES
              if name.startswith("edge")]
# rows past offsets[G] (as gmm.cu's contract: they are zeroed), and a
# shape whose groups are large and N under 256
EXTRA_CASES = [("tail_rows", 3, 100, 64, 40, [10, 20, 30]),
               ("big_groups_narrow", 4, 1000, 64, 200, [300, 0, 500, 150])]
ALL_CASES = MOE_CASES + EDGE_CASES + EXTRA_CASES


def _plan(M, N, K, G):
    """The TMA route's plan at this shape: the planner's where it takes
    the route, else the tile it would take were the shape addressable."""
    plan = gmm_cuda.plan_ragged_bf16(M, N, K, G)
    if plan.route == gmm_cuda.ROUTE_WGMMA:
        return plan
    p = gmm_cuda.plan_ragged_bf16(M, -(-N // 8) * 8, 64, max(G, 1))
    return gmm_cuda._bf16_tma_plan(M, N, G, p.bm, p.bn, p.stages)


@dataclasses.dataclass(frozen=True)
class Unit:
    """One unit of the TMA route: block ``block`` multiplies rows
    ``[row0, row0 + bm)`` of lhs by ``rhs[group]`` into columns
    ``[col0, col0 + bn)`` and stores rows ``[row0, row_end)``; ``group``
    -1 stores zeros (rows no group covers)."""
    block: int
    group: int
    row0: int
    row_end: int
    col0: int


def ragged_bf16_units(offsets, M, N, plan):
    """The units ``gmm_ragged_bf16_wgmma_tc`` enumerates for these (G + 1)
    offsets, in the order of the blocks that take them: the rows fall into
    G + 2 ranges, ``[0, offsets[0])``, each group's ``[offsets[g],
    offsets[g + 1])`` and ``[offsets[G], M)``, each offset clamped to
    [0, M]; a range of ``n`` rows has ``ceil(n / bm)`` row tiles from its
    first row, and its units run column tile by column tile, row tile by
    row tile."""
    offs = [min(max(int(o), 0), M) for o in offsets]
    bounds = [0] + offs + [M]
    G = len(offs) - 1
    tiles_n = -(-N // plan.bn)
    units = []
    for r in range(G + 2):
        lo, hi = bounds[r], bounds[r + 1]
        rows = -(-(hi - lo) // plan.bm) if hi > lo else 0
        for x in range(tiles_n):
            for t in range(rows):
                row0 = lo + t * plan.bm
                units.append(Unit(len(units), r - 1 if 1 <= r <= G else -1,
                                  row0, min(hi, row0 + plan.bm),
                                  x * plan.bn))
    return units


def _offsets(sizes):
    return [0] + np.cumsum(sizes).tolist()


@pytest.mark.parametrize("case", ALL_CASES, ids=[c[0] for c in ALL_CASES])
def test_units_own_each_output_element_once_within_its_group(case):
    """For every column tile, the units' row ranges partition [0, M): each
    range inside one group (or the rows no group covers, for a zeroing
    unit), starting at that group's first row plus whole tiles; the column
    tiles partition [0, N). Blocks number the units 0, 1, ...; no group
    gives a unit that multiplies another group's rows."""
    name, G, M, K, N, sizes = case
    plan = _plan(M, N, K, G)
    offsets = _offsets(sizes)
    units = ragged_bf16_units(offsets, M, N, plan)
    assert [u.block for u in units] == list(range(len(units)))
    gid = np.full(M, -1)
    for g in range(G):
        gid[offsets[g]:offsets[g + 1]] = g
    tiles_n = -(-N // plan.bn)
    assert {u.col0 for u in units} == {x * plan.bn for x in range(tiles_n)}
    for x in range(tiles_n):
        rows = np.zeros(M, np.int32)
        for u in units:
            if u.col0 != x * plan.bn:
                continue
            assert u.row0 < u.row_end <= min(u.row0 + plan.bm, M)
            assert (gid[u.row0:u.row_end] == u.group).all()
            start = offsets[u.group] if u.group >= 0 else offsets[G]
            assert (u.row0 - start) % plan.bm == 0
            rows[u.row0:u.row_end] += 1
        assert (rows == 1).all()
    if M * N <= 1 << 20:
        owned = np.zeros((M, N), np.int32)
        for u in units:
            owned[u.row0:u.row_end, u.col0:u.col0 + plan.bn] += 1
        assert (owned == 1).all()


@pytest.mark.parametrize("case", ALL_CASES, ids=[c[0] for c in ALL_CASES])
def test_empty_groups_give_no_unit_and_the_bound_holds(case):
    """An empty group has no unit; a non-empty one ceil(size / bm) row
    tiles a column tile; the rows past offsets[G] are zeroing units; the
    count never exceeds the launch's blocks, (ceil(M / bm) + G + 1) x
    ceil(N / bn)."""
    name, G, M, K, N, sizes = case
    plan = _plan(M, N, K, G)
    units = ragged_bf16_units(_offsets(sizes), M, N, plan)
    tiles_n = -(-N // plan.bn)
    for g, size in enumerate(sizes):
        mine = [u for u in units if u.group == g]
        assert len(mine) == -(-size // plan.bm) * tiles_n
    zero = [u for u in units if u.group == -1]
    assert len(zero) == -(-(M - sum(sizes)) // plan.bm) * tiles_n
    assert plan.blocks == (-(-M // plan.bm) + G + 1) * tiles_n
    assert len(units) <= plan.blocks


def test_rows_past_the_last_offset_are_zeroing_units_and_the_bound_is_tight():
    """Offsets that stop short of M (and a first offset past 0): those
    rows are zeroing units; and sizes that maximise the row tiles (each
    group one row past a tile) still fit the launch."""
    plan = gmm_cuda.RaggedBf16Plan(gmm_cuda.ROUTE_WGMMA, 64, 128, 4, 0)
    units = ragged_bf16_units([5, 10, 30, 60], 100, 64, plan)
    zero = sorted((u.row0, u.row_end) for u in units if u.group == -1)
    assert zero == [(0, 5), (60, 100)]
    for G in (1, 3, 8, 64):
        for size in (1, 65, 127):
            M = size * G
            tma = gmm_cuda._bf16_tma_plan(M, 64, G, 64, 128, 4)
            units = ragged_bf16_units(_offsets([size] * G), M, 64, tma)
            assert len(units) == G * -(-size // 64) <= tma.blocks


@pytest.mark.parametrize("case", ALL_CASES, ids=[c[0] for c in ALL_CASES])
def test_float64_product_over_the_units_equals_the_plain_product(case):
    """Each unit multiplies its whole row box by its group's weights, as
    the kernel does, and stores only its own rows (zeros for a zeroing
    unit): the result equals the port's plain product and the JAX
    oracle's. At the MoE's shapes the contraction is cut to 16 and the
    check to the first two column tiles (the schedule does not depend on
    K)."""
    name, G, M, K, N, sizes = case
    plan = _plan(M, N, K, G)
    big = name in dict((c[0], c) for c in MOE_CASES)
    Kd, Nc = (16, min(N, 2 * plan.bn)) if big else (K, N)
    rng = np.random.default_rng(29)
    lhs = rng.standard_normal((M, Kd)).astype(np.float32)
    rhs = (rng.standard_normal((G, Kd, N)) * Kd ** -0.5).astype(np.float32)
    covered = sum(sizes)
    out = np.full((M, Nc), np.nan)
    for u in ragged_bf16_units(_offsets(sizes), M, N, plan):
        if u.col0 >= Nc:
            continue
        cols = slice(u.col0, min(u.col0 + plan.bn, Nc))
        if u.group < 0:
            out[u.row0:u.row_end, cols] = 0.0
            continue
        box = lhs[u.row0:min(u.row0 + plan.bm, M)].astype(np.float64)
        full = box @ rhs[u.group][:, cols].astype(np.float64)
        out[u.row0:u.row_end, cols] = full[:u.row_end - u.row0]
    assert not np.isnan(out).any()
    assert not out[covered:].any()
    gs = np.asarray(sizes, np.int32)
    want = gmm_ref.grouped_matmul(
        torch.from_numpy(lhs[:covered]).double(),
        torch.from_numpy(rhs[..., :Nc]).double(),
        torch.from_numpy(gs)).numpy()
    np.testing.assert_allclose(out[:covered], want, rtol=1e-12, atol=1e-12)
    oracle = np.asarray(jgmm_ref.grouped_matmul(
        jnp.asarray(lhs[:covered]), jnp.asarray(rhs[..., :Nc]),
        jnp.asarray(gs)))
    np.testing.assert_allclose(out[:covered], oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,route,tile", [
    ("moonlight_decode_up", "tma_wgmma", (64, 128, 4)),
    ("moonlight_decode_down", "tma_wgmma", (64, 128, 4)),
    ("moonlight_prefill_up", "tma_wgmma", (64, 128, 4)),
    ("moonlight_prefill_down", "tma_wgmma", (64, 128, 4)),
    ("mixtral_prefill_up", "tma_wgmma", (128, 256, 4)),
    ("mixtral_prefill_down", "tma_wgmma", (128, 256, 4)),
])
def test_plan_at_the_moe_shapes(name, route, tile):
    """The MoE's six products take the TMA route: 64-row units where the
    groups are small (decode: 48 rows over 64 experts; Moonlight's
    prefill: ~48 rows an expert), 128 x 256 on two warpgroups where they
    are large (Mixtral's ~512 rows an expert)."""
    _, G, M, K, N, _ = next(c for c in MOE_CASES if c[0] == name)
    plan = gmm_cuda.plan_ragged_bf16(M, N, K, G)
    assert (plan.route, (plan.bm, plan.bn, plan.stages)) == (route, tile)
    assert tile in gmm_cuda.BF16_TILES
    assert plan.blocks == (-(-M // plan.bm) + G + 1) * -(-N // plan.bn)


@pytest.mark.parametrize("M,N,G,tile", [
    (64 * 64, 1408, 64, (64, 128, 4)),       # 64 rows a group on average
    (64 * 64 + 1, 1408, 64, (128, 256, 4)),  # and one row more
    (1000, 200, 4, (128, 256, 4)),           # large groups, N under 256
    (48, 8, 64, (64, 128, 4)),               # decode, N under 128
    (0, 64, 4, (64, 128, 4)),                # no rows
])
def test_plan_takes_the_tile_by_the_rows_a_group(M, N, G, tile):
    """64 x 128 units where the groups average at most 64 rows, else 128 x
    256, whatever N (TMA fills zeros past it, the stores are masked)."""
    plan = gmm_cuda.plan_ragged_bf16(M, N, 64, G)
    assert plan.route == gmm_cuda.ROUTE_WGMMA
    assert (plan.bm, plan.bn, plan.stages) == tile


@pytest.mark.parametrize("shape", [
    (200, 70, 130, 3),      # edge_one_group_owns_all: rows of 260 bytes
    (5000, 23, 256, 5),     # the assigned predictor's last layer
    (5000, 256, 30, 5),     # and its first
    (64, 48, 0, 4),         # no contraction
    (64, 48, 32, 0),        # no group
])
def test_shapes_a_tensor_map_cannot_address_take_the_mma_sync_route(shape):
    M, N, K, G = shape
    plan = gmm_cuda.plan_ragged_bf16(M, N, K, G)
    base = gmm_cuda.plan_ragged(M, N, K)
    assert (plan.route, plan.bm, plan.bn, plan.blocks) == (
        gmm_cuda.ROUTE_MMA_SYNC, base.bm, base.bn, base.blocks)


def test_an_unaligned_operand_takes_the_mma_sync_route():
    tma = gmm_cuda.plan_ragged_bf16(3072, 1408, 2048, 64)
    off = gmm_cuda.plan_ragged_bf16(3072, 1408, 2048, 64, aligned=False)
    assert tma.route == gmm_cuda.ROUTE_WGMMA
    assert off.route == gmm_cuda.ROUTE_MMA_SYNC


def test_plan_refuses_what_the_kernel_cannot_launch():
    for shape in ((-1, 8, 8, 2), (8, -8, 8, 2), (8, 8, -8, 2),
                  (8, 8, 8, -1)):
        with pytest.raises(ValueError, match="negative"):
            gmm_cuda.plan_ragged_bf16(*shape)
    with pytest.raises(ValueError, match="groups"):
        gmm_cuda.plan_ragged_bf16(64, 64, 64, gmm_cuda.MAX_TMA_GROUPS + 1)
    top = gmm_cuda.plan_ragged_bf16(64, 64, 64, gmm_cuda.MAX_TMA_GROUPS)
    assert top.route == gmm_cuda.ROUTE_WGMMA
    assert gmm_cuda.plan_ragged_bf16(0, 64, 64, 4).blocks == 0


def _source():
    return (ROOT / "src" / "repro_torch" / "kernels" / "gmm" / "csrc"
            / "gmm.cu").read_text()


def test_the_planner_tiles_are_the_ones_gmm_cu_instantiates():
    found = re.findall(r"bm == (\d+) && bn == (\d+) && stages == (\d+)",
                       _source())
    assert tuple(tuple(map(int, t)) for t in found) == gmm_cuda.BF16_TILES
    assert re.search(rf"MAX_TMA_GROUPS = {gmm_cuda.MAX_TMA_GROUPS};",
                     _source())


@pytest.mark.parametrize("tile", gmm_cuda.BF16_TILES)
def test_every_tile_fits_shared_memory_and_its_blocks_per_sm(tile):
    """The ring (stages x (bm + bn) rows of 128 bytes), two barriers a
    stage, 1,024 bytes of alignment slack and the static boundary table
    fit the 227 KB a block may use; rings of at most 108 KB are launched
    two to an SM (``TmaTile::MIN_BLOCKS``) and fit twice."""
    bm, bn, stages = tile
    dynamic = stages * (bm + bn) * 128 + 16 * stages + 1024
    warps = (128 * bm // 64 + 32) // 32
    static = 4 * (gmm_cuda.MAX_TMA_GROUPS + 3) + 4 * warps + 12
    assert dynamic + static <= 232448
    if dynamic <= 108 * 1024:
        assert 2 * (dynamic + static + 1024) <= 233472


# ---------------------------------------------------- chip_smoke's replay
def test_kernel_plain_calls_pair_each_route_with_its_counterpart():
    """``lockstep_vs_plain`` routes once a layer a forward: the kernel
    run's prefill, the plain run's, the kernel run's decodes, the plain
    run's; the pairs match call for call."""
    assert CHIP.kernel_plain_calls(2, 3) == [
        (0, 2), (1, 3), (4, 10), (5, 11), (6, 12), (7, 13), (8, 14),
        (9, 15)]


def test_expert_choices_replay_takes_the_given_experts_on_the_cpu():
    """The routing hook on the port's MoE block (REDUCED Moonlight, CPU,
    the capacity dispatch): a forward that replays its own recorded
    choices gives the same output bit for bit, one that replays other
    choices takes them, with the router's own probabilities at those
    experts as its combine weights; the hook leaves ``_route`` as it
    found it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as M
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    p = M.init_moe(cfg, gen, "cpu")
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)).to(M.dtype_of(cfg))
    own_route = M._route
    with CHIP.ExpertChoices(M) as rec:
        want, _ = M.moe_forward(cfg, p, x)
    assert M._route is own_route and len(rec.raw) == 1
    with CHIP.ExpertChoices(M, {0: rec.raw[0]}) as same:
        got, _ = M.moe_forward(cfg, p, x)
    assert torch.equal(got, want) and torch.equal(same.raw[0], rec.raw[0])
    other = (rec.raw[0] + 1) % cfg.num_experts
    with CHIP.ExpertChoices(M, {0: other}) as moved:
        h = M.rmsnorm(x, p["ln"]).reshape(-1, cfg.d_model)
        probs, w, idx = M._route(cfg, p["router"], h)
    assert torch.equal(idx, other) and torch.equal(moved.idx[0],
                                                   other.sort(-1).values)
    want_w = probs.gather(-1, other)
    torch.testing.assert_close(w, want_w / want_w.sum(-1, keepdim=True))
    assert M._route is own_route
