"""PyTorch port: step(solver="coupled_pgs"), the JAX engine's legacy dual
constraint solver (physics/pgs.py against JAX physics/engine.py
_coupled_constraint_terms: 25 sweeps of the 4-colour projected
Gauss-Seidel, 4 block-pivoting steps, the lower objective kept), one
sample and over K, against the JAX package on the CPU in f64.

Plants: the cartpole (its slider limit), the hopper (15 floor pairs and
joint limits) and the humanoid (floor and self pairs), from
chip_smoke.plant_state's humanoid cases and the cartpole's and hopper's
shared inputs. Three chained one-sample steps and one step over K=8
against JAX's jitted step and its vmap; tolerances qpos 1e-10, qvel 1e-8.
make_physics_dynamics(solver="coupled_pgs") and the planner on it
(EpisodeRunner(planner_solver="coupled_pgs")) run the same step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import plant_state
from humanoid_mppi_rl_tpu.envs.tasks import load_plant as jax_load_plant
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
from humanoid_mppi_rl_tpu_torch.dynamics.physics import make_physics_dynamics
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import load_model
from test_torch_port_coupled_planner import batch_states

torch.set_num_threads(1)

F64 = torch.float64
K = 8
ROBOTS = ("cartpole", "hopper", "humanoid")
CASES = [("cartpole", 0), ("cartpole", 1), ("hopper", 0), ("hopper", 2),
         ("humanoid", "free_fall"), ("humanoid", "sunk"), ("humanoid", "self_contact")]


@pytest.fixture(scope="module")
def plants():
    """robot -> (JAX plant model, port plant model, JAX jitted pgs step,
    its vmap)."""
    out = {}
    for robot in ROBOTS:
        jm = jax_load_plant(robot)[0]
        fn = lambda s, u, jm=jm: jeng.step(jm, s, u, solver="coupled_pgs")
        out[robot] = (jm, load_model(f"{robot}_plant"), jax.jit(fn), jax.jit(jax.vmap(fn)))
    return out


def _case(pm, robot, case):
    if robot == "humanoid":
        return plant_state(pm, case, seed=4)
    qpos, qvel, ctrl = batch_states(pm, robot, 4, seed=4)
    return qpos[case], qvel[case], ctrl[case]


@pytest.mark.parametrize("robot,case", CASES)
def test_coupled_pgs_one_sample_matches_jax(plants, robot, case):
    jm, pm, jstep, _ = plants[robot]
    eng = Engine(pm, "cpu", F64)
    qpos, qvel, ctrl = _case(pm, robot, case)
    js = jeng.forward(jm, jnp.asarray(qpos), jnp.asarray(qvel))
    ps = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    for i in range(3):
        js, ps = jstep(js, jnp.asarray(ctrl)), eng.step(ps, torch.tensor(ctrl), solver="coupled_pgs")
        np.testing.assert_allclose(ps.qpos.numpy(), np.asarray(js.qpos), atol=1e-10,
                                   err_msg=f"{robot} {case} step {i}")
        np.testing.assert_allclose(ps.qvel.numpy(), np.asarray(js.qvel), atol=1e-8,
                                   err_msg=f"{robot} {case} step {i}")


@pytest.mark.parametrize("robot", ROBOTS)
def test_coupled_pgs_batched_matches_jax_vmap(plants, robot):
    """One step over K=8 through make_physics_dynamics against jax.vmap of
    JAX's; each sample equals the port's one-sample step."""
    jm, pm, _, jvstep = plants[robot]
    if robot == "humanoid":
        cases = [plant_state(pm, c, seed=s) for s in range(3)
                 for c in ("free_fall", "sunk", "self_contact")][:K]
        qpos, qvel, ctrl = (np.stack(x) for x in zip(*cases))
    else:
        qpos, qvel, ctrl = batch_states(pm, robot, K, seed=6)
    dyn = make_physics_dynamics(pm, solver="coupled_pgs", device="cpu", dtype=F64)
    eng = dyn.engine
    ps = eng.forward(torch.tensor(qpos), torch.tensor(qvel), torch.zeros(K, dtype=F64))
    pn = dyn(ps, torch.tensor(ctrl))
    js = jax.jit(jax.vmap(lambda q, v: jeng.forward(jm, q, v)))(jnp.asarray(qpos),
                                                                 jnp.asarray(qvel))
    jn = jvstep(js, jnp.asarray(ctrl))
    np.testing.assert_allclose(pn.qpos.numpy(), np.asarray(jn.qpos), atol=1e-10)
    np.testing.assert_allclose(pn.qvel.numpy(), np.asarray(jn.qvel), atol=1e-8)
    for k in range(K):
        one = eng.step(eng.forward(torch.tensor(qpos[k]), torch.tensor(qvel[k])),
                       torch.tensor(ctrl[k]), solver="coupled_pgs")
        torch.testing.assert_close(pn.qvel[k], one.qvel, rtol=1e-12, atol=1e-12)


def test_coupled_pgs_planner_runs():
    """EpisodeRunner(planner_solver="coupled_pgs") plans the cartpole on the
    dual solver over K and steps its plant."""
    runner = EpisodeRunner("cartpole", planner_solver="coupled_pgs",
                           mppi_override=dict(n_samples=4, horizon=3), device="cpu", dtype=F64)
    res = runner.run(max_steps=2, chunk=2)
    assert res.steps == 2 and np.isfinite(res.final_qpos).all()
