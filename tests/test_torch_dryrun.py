"""The port's one-card dry run (``repro_torch/launch/dryrun.py``) against
the JAX reference's ``repro/launch/dryrun.py``, on the CPU.

* ``param_count`` / ``active_param_count`` (on the ``meta`` device) equal
  the reference's (``jax.eval_shape``) for every arch id at REDUCED and
  for GLM-4-9B at full size.
* ``dryrun_one``'s audit: the bytes by part, the weights' bytes against a
  real allocation, the deepest cut that fits, the reference's skip of
  ``long_500k``.
* ``dryrun_roles`` / ``--roles`` report the reference's split of the
  production mesh shapes.

The reference's module sets ``XLA_FLAGS`` (512 host devices) when it is
imported; the fixture starts JAX's backend first and puts the variable
back, so nothing of it reaches the rest of the process.
"""
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import registry as jregistry
from repro.core import roles as JROLES
from repro_torch.configs import registry
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models.config import INPUT_SHAPES, InputShape


@pytest.fixture(scope="module")
def jdry():
    jax.devices()                       # the device count is fixed now
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as module
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return module


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_counts_match_the_reference_at_reduced(jdry, arch):
    cfg = registry.get_config(arch, reduced=True)
    jcfg = jregistry.get_config(arch, reduced=True)
    assert dryrun.param_count(cfg) == jdry.param_count(jcfg)
    assert dryrun.active_param_count(cfg) == jdry.active_param_count(jcfg)


def test_param_counts_match_the_reference_at_full_size(jdry):
    cfg, jcfg = (registry.get_config("glm4-9b"),
                 jregistry.get_config("glm4-9b"))
    n = dryrun.param_count(cfg)
    assert n == jdry.param_count(jcfg) and n > 9e9
    assert dryrun.active_param_count(cfg) == n


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_every_arch_counts_as_the_reference_at_full_size(jdry, arch):
    """Every arch id at its published size, on the meta device: the
    totals the audit records (235 B for Qwen3-MoE) and the MoE's active
    share, equal to the reference's ``jax.eval_shape`` counts."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert dryrun.param_count(cfg) == jdry.param_count(jcfg)
    assert dryrun.active_param_count(cfg) == jdry.active_param_count(jcfg)


def test_shapes_are_the_reference_input_shapes(jdry):
    from repro.models.config import INPUT_SHAPES as JSHAPES
    assert {k: tuple(vars(v).values()) for k, v in INPUT_SHAPES.items()} \
        == {k: tuple(vars(v).values()) for k, v in JSHAPES.items()}


def test_weight_bytes_are_what_init_allocates():
    """The meta count of the weights' bytes against the bytes of the same
    weights made on the CPU (REDUCED GLM-4-9B, bf16)."""
    cfg = registry.get_config("glm4-9b", reduced=True)
    params = api._mod(cfg).init_params(cfg, 0, device="cpu")
    real = sum(t.numel() * t.element_size() for t in params.parameters())
    got = dryrun.step_bytes(cfg, InputShape("t", 16, 2, "train"))
    assert got["weights"] == real
    assert got["adam"] == 8 * dryrun.param_count(cfg)
    assert got["batch"] == 2 * 4 * 2 * 16
    assert got["total"] == sum(v for k, v in got.items() if k != "total")


def test_cache_bytes_follow_the_cache_and_int8_shrinks_them():
    cfg = registry.get_config("glm4-9b", reduced=True)
    shape = InputShape("d", 32, 2, "decode")
    fp = dryrun.step_bytes(cfg, shape)
    q = dryrun.step_bytes(cfg, shape, kv_int8=True)
    from repro_torch.models import lm as LM
    cache = LM.init_cache(cfg, 2, 32, device="cpu")
    assert fp["cache"] == sum(v.numel() * v.element_size()
                              for v in cache.values())
    assert 0 < q["cache"] < fp["cache"] and q["weights"] == fp["weights"]


def test_dryrun_one_audits_and_cuts_to_fit():
    rec = dryrun.dryrun_one("glm4-9b", "train_4k", card_gb=80.0,
                            verbose=False)
    assert rec["ok"] and rec["params"] > 9e9 and not rec["fits"]
    L = rec["deepest_fitting_layers"]
    assert 0 < L < rec["num_layers"] == 40
    cfg = registry.get_config("glm4-9b")
    shape = INPUT_SHAPES["train_4k"]
    import dataclasses
    fit = [dryrun.step_bytes(dataclasses.replace(cfg, num_layers=n),
                             shape)["total"] <= 80e9 for n in (L, L + 1)]
    assert fit == [True, False]
    assert "not_measured" in rec and "collective" in rec["not_measured"]


def test_long_context_is_skipped_where_the_reference_skips_it():
    for arch in registry.ARCH_IDS:
        skip = registry.LONG_CONTEXT[arch] == "skip"
        assert skip == (jregistry.LONG_CONTEXT[arch] == "skip")
    rec = dryrun.dryrun_one("seamless-m4t-medium", "long_500k",
                            verbose=False)
    assert "skipped" in rec and not rec["ok"]


@pytest.mark.parametrize("shape,flags", [
    ((16, 16), ["--mesh-shape", "16,16"]),
    ((2, 16, 16), ["--multi-pod"])])
def test_roles_report_the_reference_split(shape, flags, capsys):
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(shape)]
    devs = np.array([jax.devices()[0]] * int(np.prod(shape)), dtype=object)
    want = JROLES.split_roles(JMesh(devs.reshape(shape), axes),
                              ratios=(1, 2, 1))
    rec = dryrun.main(["--roles", "--n-collectors", "6",
                       "--envs-per-collector", "3"] + flags)
    assert rec["roles"] == want.describe()
    assert rec["mesh"] == "x".join(str(n) for n in shape)
    assert rec["sim_robots_total"] == 18
    assert rec["collector_devices_total"] == int(np.prod(
        want.collector.devices.shape))
    assert len(rec["fleet_devices"]) == 6
    assert '"roles"' in capsys.readouterr().out


def test_roles_of_the_local_cpu_fall_back_shared():
    with pytest.warns(UserWarning, match="shared sub-meshes"):
        rec = dryrun.dryrun_roles(device="cpu", verbose=False)
    assert rec["roles"]["shared"] and rec["mesh"] == "1"
    assert rec["fleet_devices"] == {"collector:0": "cpu"}
    assert torch.device(rec["fleet_devices"]["collector:0"]).type == "cpu"
