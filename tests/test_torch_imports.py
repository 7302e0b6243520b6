"""The PyTorch port stands alone: no module under ``src/repro_torch/``, not
``chip_smoke.py`` and not the ``examples/torch_*.py``, imports ``jax`` or
the JAX package ``repro``; every module imports on a host without a card,
``nvcc`` or ``triton``, and importing builds no kernel."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("torch_*.py")))
FORBIDDEN = {"jax", "jaxlib", "repro"}
# the modules of the collect -> learn slice, each under the scan above
SLICE2 = ["utils/tree.py", "optim/optimizers.py", "envs/base.py",
          "envs/classic.py", "envs/arm.py", "mbrl/policy.py",
          "kernels/gmm/ref.py", "kernels/gmm/cuda.py", "kernels/gmm/ops.py",
          "mbrl/dynamics.py", "mbrl/early_stop.py", "core/servers.py",
          "core/workers.py", "testing/parity.py"]
# the modules the imagine -> improve slice adds (it extends
# mbrl/dynamics.py and core/workers.py, listed above)
SLICE3 = ["kernels/imag/ref.py", "kernels/imag/cuda.py", "kernels/imag/ops.py",
          "mbrl/trpo.py", "mbrl/ppo.py", "mbrl/algos.py"]
# the modules the Mamba2 serving slice adds (it extends models/config.py,
# models/layers.py, models/lm.py and models/api.py)
SLICE4 = ["kernels/ssd/ref.py", "kernels/ssd/cuda.py", "kernels/ssd/ops.py",
          "models/ssm.py", "configs/mamba2_2_7b.py"]
# the engines slice: the clocks, the trainers and the launcher (it extends
# core/workers.py and core/__init__.py)
SLICE5 = ["core/clock.py", "core/runtime.py", "launch/train.py"]
# the threads slice: snapshots and the model-free baseline (it extends
# core/servers.py, core/runtime.py, mbrl/dynamics.py, kernels/build.py and
# the kernels' ops.py)
SLICE6 = ["checkpoint/__init__.py", "checkpoint/io.py",
          "mbrl/model_free.py"]
# the procs slice adds no module: it extends core/servers.py,
# core/workers.py, core/runtime.py and launch/train.py, each scanned above
SLICE7 = [("core/servers.py", ["ShmParameterServer", "ProcDataServer",
                               "ProcControl", "live_shm_segments",
                               "live_data_servers",
                               "reclaim_ipc_resources"]),
          ("core/workers.py", ["ProcSpec", "ProcChannels", "heartbeat_slot",
                               "heartbeat_slots", "proc_worker_main"]),
          ("core/runtime.py", ["Supervisor", "SupervisorChain"])]
# the tcp control plane and the chaos tier (they extend core/runtime.py,
# core/servers.py, checkpoint/io.py and launch/train.py, scanned above)
SLICE8 = ["net/__init__.py", "net/frame.py", "net/control.py",
          "net/client.py", "net/join.py", "chaos/__init__.py",
          "chaos/faults.py", "chaos/monitor.py", "chaos/audit.py",
          "chaos/soak.py"]
# the transformer world-model slice (it extends models/layers.py,
# models/lm.py, models/api.py, kernels/flash_attention/, optim/,
# configs/registry.py, testing/parity.py and launch/train.py)
SLICE9 = ["data/__init__.py", "data/synthetic.py", "mbrl/wm_dynamics.py"]
# the moe and hybrid slice (it extends kernels/gmm/, models/lm.py,
# models/api.py, configs/registry.py, testing/parity.py and launch/train.py)
SLICE10 = ["models/moe.py", "configs/mixtral_8x7b.py",
           "configs/moonshot_v1_16b_a3b.py", "configs/qwen3_moe_235b_a22b.py",
           "configs/zamba2_7b.py"]
# the encoder-decoder and vision slice (it extends models/layers.py,
# models/lm.py, models/api.py, kernels/flash_attention/, configs/registry.py,
# testing/parity.py and launch/train.py)
SLICE12 = ["models/encdec.py", "configs/seamless_m4t_medium.py",
           "configs/phi3_vision_4_2b.py"]
# the role-mesh slice (it extends core/servers.py, core/workers.py,
# core/runtime.py, mbrl/dynamics.py, mbrl/algos.py, net/client.py,
# models/config.py and launch/train.py)
SLICE14 = ["core/roles.py", "launch/mesh.py", "launch/dryrun.py"]
EXAMPLES = ["torch_quickstart.py", "torch_pr2_arm.py",
            "torch_async_vs_sync.py", "torch_train_world_model.py",
            "torch_wm_imagination.py", "torch_serve_world_model.py",
            "torch_encdec_serve.py"]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("module", SLICE2 + SLICE3 + SLICE4 + SLICE5
                         + SLICE6 + SLICE8 + SLICE9 + SLICE10
                         + SLICE12 + SLICE14)
def test_slice_module_is_scanned(module):
    assert PORT / module in FILES


@pytest.mark.parametrize("module,names", SLICE7,
                         ids=[m for m, _ in SLICE7])
def test_slice7_names_live_in_scanned_modules(module, names):
    assert PORT / module in FILES
    tree = ast.parse((PORT / module).read_text())
    defined = {n.name for n in tree.body
               if isinstance(n, (ast.ClassDef, ast.FunctionDef))}
    assert set(names) <= defined, sorted(set(names) - defined)


@pytest.mark.parametrize("example", EXAMPLES)
def test_torch_example_is_scanned(example):
    assert ROOT / "examples" / example in FILES


def test_every_module_imports_without_jax_or_a_build():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py")) if p.name != "__init__.py"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels import build\n"
        "assert not build._LOADED, build._LOADED\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
