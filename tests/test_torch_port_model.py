"""PyTorch port: the model snapshot, and the port's isolation from JAX.

The snapshot (humanoid_mppi_rl_tpu_torch/assets/humanoid.json) carries the
compiled humanoid across to the port so the card needs no mujoco; it must
equal a fresh export of build_from_mjcf. The port must import neither jax,
mujoco nor the JAX package, and its entry points must refuse to run on the
CPU unless asked to."""

import os
import subprocess
import sys

import pytest
import torch

from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs
from humanoid_mppi_rl_tpu_torch.ops.rollout_kernel import build_rollout_kernel
from humanoid_mppi_rl_tpu_torch.physics.model import (
    export_model_arrays, load_model, model_from_arrays, snapshot_json,
    snapshot_path)
from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi

ROOT = os.path.join(os.path.dirname(__file__), "..")
HUMANOID_XML = os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", "humanoid.xml")


def test_snapshot_equals_fresh_mjcf_export():
    fresh = snapshot_json(export_model_arrays(build_from_mjcf(HUMANOID_XML)))
    with open(snapshot_path("humanoid")) as f:
        assert f.read() == fresh, (
            "assets/humanoid.json is stale: regenerate it with "
            "snapshot_json(export_model_arrays(build_from_mjcf(...)))")


def test_export_round_trips():
    d = export_model_arrays(build_from_mjcf(HUMANOID_XML))
    m = model_from_arrays(d)
    assert snapshot_json(export_model_arrays(m)) == snapshot_json(d)
    assert (m.nq, m.nv, m.nu, m.nbody) == (28, 27, 21, 17)
    assert snapshot_json(export_model_arrays(load_model("humanoid"))) == snapshot_json(d)


_ISOLATED = r"""
import dataclasses, importlib, pkgutil, sys
for name in ("jax", "jaxlib", "mujoco", "humanoid_mppi_rl_tpu"):
    sys.modules[name] = None
import torch
import humanoid_mppi_rl_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
import chip_smoke
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState
spec, model, cfg, init = load_task("humanoid_bench", device="cpu")
cfg = dataclasses.replace(cfg, n_samples=16, horizon=2)
plan = make_kernel_mppi(model, spec.cost_factory, cfg, spec.cost_kwargs, device="cpu")
st = MPPIState.seeded(0, cfg.T, model.nu, device="cpu")
action, st, diag = plan(st, init)
assert action.shape == (model.nu,) and bool(torch.isfinite(st.U).all())
assert bool(torch.isfinite(diag.beta))
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "mujoco", "humanoid_mppi_rl_tpu"))
assert not loaded, loaded
print("ISOLATED-OK")
"""


def test_port_runs_without_jax_mujoco_or_the_jax_package():
    """Stands in for the card's installations, which have none of them."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


@pytest.mark.parametrize("entry", ["load_task", "make_kernel_mppi",
                                   "build_rollout_kernel"])
def test_entry_points_default_to_cuda_and_refuse_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    spec, model, cfg, _ = load_task("humanoid_bench", device="cpu")
    calls = {
        "load_task": lambda: load_task("humanoid_bench"),
        "make_kernel_mppi": lambda: make_kernel_mppi(
            model, kernel_costs.humanoid, cfg, spec.cost_kwargs),
        "build_rollout_kernel": lambda: build_rollout_kernel(
            model, kernel_costs.humanoid, 4),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
