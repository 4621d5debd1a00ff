"""PyTorch port, slice 6: the Go1 coupled plant (box corners, exact
cylinder rims, cylinder self pairs, elliptic condim-3/6 blocks, frictionloss
rows) and collect_quadruped against the JAX package on the CPU.

The plant is held against the JAX engine's coupled step (jitted once) in
f64 at qpos 1e-10 / qvel 1e-9, with its constraint rows, on the states of
chip_smoke.go1_plant_state. The collection loop drives the JAX plant for
real and plans with the JAX stand-in of tests/test_torch_port_go1.py (the
rollout kernel's body as a plain loop), with the same noise on both sides
through noise_fn, as tests/test_torch_port_collect.py does for the humanoid."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import go1_plant_state
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics import newton as jnewton
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.collect import runner as prunner
from humanoid_mppi_rl_tpu_torch.costs.quadruped import GAIT_TUNED
from humanoid_mppi_rl_tpu_torch.envs.tasks import TASKS, load_task
from humanoid_mppi_rl_tpu_torch.physics import contact as pcontact
from humanoid_mppi_rl_tpu_torch.physics import engine as peng
from humanoid_mppi_rl_tpu_torch.physics import newton as pnewton
from humanoid_mppi_rl_tpu_torch.physics.model import load_model
from humanoid_mppi_rl_tpu_torch.utils import trajio as ptrajio
from test_torch_port_collect import _jax_writer
from test_torch_port_go1 import _jax_plan

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GO1_XML = os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", "go1.xml")
K, T, CHUNK, STEPS = 8, 2, 2, 4
TINY = dict(n_samples=K, horizon=T)
# a goal off to the side: in its first steps from `home` the trunk drifts
# toward -y, so the distance to the goal falls step by step, while the
# goal's x (0) stays ahead of the trunk, which drifts toward -x
GOAL = (0.0, -1.0)


@pytest.fixture(scope="module")
def jax_plant():
    m = build_from_mjcf(GO1_XML, include_self_collisions=True)
    return m, jax.jit(lambda q, v: jeng.forward(m, q, v)), jax.jit(lambda s, u: jeng.step(m, s, u))


@pytest.fixture(scope="module")
def jax_rows(jax_plant):
    """JAX's constraint rows and Newton solve of the Go1 under jax.jit (one
    compile each, where op by op compiles every primitive)."""
    m = jax_plant[0]
    return (jax.jit(lambda s: jnewton.build_rows(m, s, s.S, jnp.float64)),
            jax.jit(lambda s, a0, M: jnewton.newton_constraint_forces(m, s, s.S, a0, M,
                                                                      n_iter=25)))


@pytest.fixture(scope="module")
def port_engine():
    return peng.Engine(load_model("go1_plant"), device="cpu", dtype=torch.float64)


def _np(x):
    return np.asarray(x, dtype=np.float64)


@pytest.mark.parametrize("case", ["free_fall", "sunk", "self_contact"])
def test_go1_coupled_step_matches_jax(jax_plant, jax_rows, port_engine, case):
    """One coupled step in f64: qpos 1e-10, qvel 1e-9; the constraint rows
    (504: 12 joint limits, 12 frictionloss rows, then elliptic blocks: 136
    condim-3 floor points, the 4 condim-6 feet and the 8 kept self pairs)
    and the constraint
    force J^T f against the JAX Newton solve. "sunk" puts trunk box corners
    and hip cylinder rims on the floor, "self_contact" cylinder self pairs
    into each other."""
    jm, jfwd, jstep = jax_plant
    eng = port_engine
    qpos, qvel, ctrl = go1_plant_state(eng.model, case)
    js = jfwd(jnp.asarray(qpos), jnp.asarray(qvel))
    jnext = jstep(js, jnp.asarray(ctrl))
    ps = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    info = {}
    pnext = eng.step(ps, torch.tensor(ctrl), info=info)
    np.testing.assert_allclose(pnext.qpos.numpy(), _np(jnext.qpos), atol=1e-10)
    np.testing.assert_allclose(pnext.qvel.numpy(), _np(jnext.qvel), atol=1e-9)

    jr = jax_rows[0](js)
    pr = pnewton.build_rows(eng.rows, ps, ps.S)
    assert pr.J.shape == jr.J.shape and info["rows"] == jr.J.shape[0] == 504
    assert (pr.n_ineq, pr.n_fric, [b["dim"] for b in pr.blocks]) == (
        jr.n_ineq, jr.n_fric, [b["dim"] for b in jr.blocks]) == (12, 12, [3, 6, 6])
    np.testing.assert_allclose(pr.J.numpy(), _np(jr.J), atol=1e-12)
    np.testing.assert_allclose(pr.aref.numpy(), _np(jr.aref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(pr.R.numpy(), _np(jr.R), rtol=1e-12)
    np.testing.assert_array_equal(pr.active.numpy(), _np(jr.active))

    I, _ = peng.spatial_inertias(eng, ps.xpos, ps.xquat)
    M = peng.mass_matrix(eng, ps.S, I)
    a0 = torch.linalg.solve(M, torch.tensor(np.random.default_rng(2).normal(0, 5, jm.nv)))
    tau = pnewton.newton_constraint_forces(eng, ps, ps.S, a0, M, n_iter=25)
    jtau = jax_rows[1](js, jnp.asarray(a0.numpy()), jnp.asarray(M.numpy()))
    np.testing.assert_allclose(tau.numpy(), _np(jtau), rtol=1e-9, atol=1e-7)

    ct = eng.contact
    plane = pcontact._plane_rows(ct, ps, ps.S)["active"].numpy()
    selfr = pcontact._self_rows(ct, ps, ps.S)["active"].numpy()
    if case == "sunk":
        assert plane[ct.row_kind == 2].sum() >= 1 and plane[ct.row_kind == 3].sum() >= 1
    if case == "self_contact":
        assert selfr.sum() >= 3
    if case == "free_fall":
        assert plane.sum() == 0 and selfr.sum() == 0


def test_go1_self_pairs_are_the_jax_candidates(port_engine):
    """Self-pair candidates as the JAX engine takes them: the 607 sphere /
    capsule / cylinder pairs of the 655 body-body pairs (the 48 with a
    trunk box skipped), cylinders as inscribed capsules."""
    from humanoid_mppi_rl_tpu.physics import contact as jcontact

    jm = build_from_mjcf(GO1_XML, include_self_collisions=True)
    js = jcontact._self_pair_static(jm)
    ps = pcontact._self_pair_static(port_engine.model)
    assert ps["b1"].shape == js["b1"].shape == (607,)
    for k in ("b1", "b2", "pos1", "quat1", "r1", "h1", "pos2", "quat2", "r2", "h2", "mu",
              "invw", "solref", "solimp", "capcap", "margin", "condim", "friction5"):
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)
    cyl = [g for g in port_engine.model.geoms if g.gtype_orig == 5]
    assert any(max(float(g.size[1]) - float(g.size[0]), 0.0) in ps["h1"] for g in cyl)


def _noise(n_steps):
    cfg = TASKS["go1_collect"].mppi
    sigma = cfg.sigma * np.exp(np.float32(GAIT_TUNED[7]))
    rng = np.random.default_rng(5)
    return [sigma * rng.normal(0, 1, (T, 12, K)) for _ in range(n_steps)]


def _params():
    p = np.zeros(16)
    p[0:2] = GOAL
    p[4:13] = np.asarray(GAIT_TUNED, np.float32)
    return p


@pytest.fixture(scope="module")
def reference(jax_plant):
    """The JAX loop over STEPS control steps from the `home` keyframe with
    the goal and GAIT_TUNED in the params: logged rows (37 columns),
    actions, times, and the plant qpos after each step."""
    jpm, jfwd, jstep = jax_plant
    jm = build_from_mjcf(GO1_XML)
    spec, model, *_, cfg = load_task("go1_collect", device="cpu", dtype=torch.float64)
    cfg = dataclasses.replace(cfg, **TINY)
    kw = dict(spec.cost_kwargs, param_goal=True, param_gait=True)
    params = _params()
    plant = jfwd(jnp.asarray(dict(jm.keyframes)["home"]), jnp.zeros(jm.nv))
    U = np.zeros((T, jm.nu))
    rows, actions, times, after = [], [], [], []
    for noise in _noise(STEPS):
        rows.append(np.concatenate([_np(plant.qpos), _np(plant.qvel)]))
        times.append(float(plant.time))
        _, action, U, _ = _jax_plan(jm, "quadruped", kw, cfg, _np(plant.qpos),
                                    _np(plant.qvel), float(plant.time), U, noise, params)
        U = _np(U)
        actions.append(_np(action))
        plant = jstep(plant, jnp.asarray(action))
        after.append(_np(plant.qpos))
    return dict(rows=np.stack(rows), actions=np.stack(actions), times=np.array(times),
                after=np.stack(after))


def _collect(tmp_path, **kw):
    noise = [torch.tensor(n) for n in _noise(STEPS)]
    kw = dict(dict(n_runs=1, out_base=str(tmp_path), max_steps=STEPS, use_kernel=True,
                   mppi_override=TINY, chunk=CHUNK, gait_params=GAIT_TUNED,
                   goal_for_run=lambda i: GOAL, stall_steps=None, device="cpu",
                   dtype=torch.float64, noise_fn=lambda i: noise[i]), **kw)
    return prunner.collect_quadruped(**kw)


def _csvs(run_dir):
    return {f.split(".")[0]: ptrajio.read_csv(os.path.join(run_dir, f))
            for f in os.listdir(run_dir)}


def test_collect_quadruped_matches_jax(tmp_path, reference, monkeypatch):
    """K=8, T=2, f64, matched noise, chunks of 2: the goal tolerance set
    between the reference's distances to the goal after its second and third
    steps, so that the goal is first met at the third (inside the second
    chunk); the saved run_000 holds the reference's first three rows,
    actions and times, and its CSVs are byte-equal to the JAX writer's of
    the same rows (the arrays the port's logger held). A capped run saves
    nothing."""
    from humanoid_mppi_rl_tpu_torch.collect.logging import TrajectoryLogger

    held = {}
    save = TrajectoryLogger.save_run_dir

    def save_and_hold(self, run_dir, fmt="csv"):
        held.update(zip(("states", "actions", "times"), self.arrays()))
        return save(self, run_dir, fmt)
    monkeypatch.setattr(TrajectoryLogger, "save_run_dir", save_and_hold)
    dist = np.linalg.norm(reference["after"][:, :2] - np.asarray(GOAL), axis=1)
    assert (np.diff(dist) < 0).all() and (reference["after"][:, 0] < GOAL[0]).all()
    first = 2
    out = _collect(tmp_path / "goal", goal_tolerance=float(0.5 * (dist[1] + dist[2])))
    assert out == [dict(run=0, goal=True, steps_saved=first + 1, steps_executed=first + 1,
                        attempts=1, outcome="goal")]
    run_dir = tmp_path / "goal" / "run_000"
    got = _csvs(str(run_dir))
    n = first + 1
    assert got["states"].shape == (n, 37) and got["actions"].shape == (n, 12)
    want = {"states": reference["rows"][:n], "actions": reference["actions"][:n],
            "times": reference["times"][:n]}
    np.testing.assert_allclose(got["states"][:, :19], want["states"][:, :19], atol=1e-10)
    np.testing.assert_allclose(got["states"][:, 19:], want["states"][:, 19:], atol=1e-9)
    np.testing.assert_allclose(got["actions"], want["actions"], atol=1e-9)
    np.testing.assert_allclose(got["times"].reshape(-1), want["times"], atol=1e-15)
    jax_write = _jax_writer(tmp_path)
    assert sorted(held) == sorted(got)
    for name, arr in held.items():
        jax_write(str(tmp_path / f"{name}_jax.csv"), arr)
        assert filecmp.cmp(str(run_dir / f"{name}.csv"), str(tmp_path / f"{name}_jax.csv"),
                           shallow=False), name
    capped = _collect(tmp_path / "cap", goal_tolerance=0.0, fall_z=-1.0)
    assert capped == [dict(run=0, goal=False, steps_saved=STEPS, steps_executed=STEPS,
                           attempts=1, outcome="cap")]
    assert not os.path.exists(tmp_path / "cap")


def _recording_run(monkeypatch):
    calls = []
    orig = prunner.EpisodeRunner.run

    def run(self, **kw):
        calls.append(dict(seed=kw["seed"], params=np.asarray(kw["params"]).copy()))
        return orig(self, **kw)
    monkeypatch.setattr(prunner.EpisodeRunner, "run", run)
    return calls


def test_collect_quadruped_falls_retries_and_shards(tmp_path, monkeypatch):
    """A fall (trunk below fall_z = 10 m: at the first step) ends each
    attempt, is retried with a reseeded stream (seed + i + attempt * 65537),
    counts every attempt's steps and saves nothing; run i goes to shard
    i % num_shards; the goal ladder is (i + 2, 0) unless goal_for_run
    says otherwise; the gait deltas ride in params slots 4..12."""
    calls = _recording_run(monkeypatch)
    out = _collect(tmp_path, n_runs=3, num_shards=2, shard_index=1, fall_z=10.0, retries=1,
                   seed=7, goal_for_run=None, max_steps=1, chunk=1)
    assert out == [dict(run=1, goal=False, steps_saved=1, steps_executed=2, attempts=2,
                        outcome="fell")]
    assert [c["seed"] for c in calls] == [7 + 1, 7 + 1 + 65537]
    for c in calls:
        np.testing.assert_array_equal(c["params"][:4], [3.0, 0.0, 0.0, 0.0])
        np.testing.assert_array_equal(c["params"][4:], np.asarray(GAIT_TUNED, np.float32))
    assert not os.path.exists(tmp_path / "run_001")
    calls.clear()
    out = _collect(tmp_path, n_runs=2, goal_for_run=lambda i: (0.5 * i, -0.25),
                   goal_tolerance=1e9, gait_params=None, max_steps=1, chunk=1)
    assert [(r["run"], r["outcome"], r["steps_saved"]) for r in out] == [(0, "goal", 1),
                                                                         (1, "goal", 1)]
    assert [tuple(c["params"]) for c in calls] == [(0.0, -0.25), (0.5, -0.25)]
    assert sorted(os.listdir(tmp_path)) == ["run_000", "run_001"]
    assert {k: v.reshape(1, -1).shape[1] for k, v in _csvs(str(tmp_path / "run_001")).items()} \
        == {"states": 37, "actions": 12, "times": 1}


def test_collect_quadruped_needs_the_kernel_planner(tmp_path):
    """use_kernel=False plans on the array engine (make_mppi over the penalty
    tier, the goal baked into each run's cost, as the JAX collector does): one
    runner per run, the goal check still on params."""
    out = prunner.collect_quadruped(n_runs=2, out_base=str(tmp_path), use_kernel=False,
                                    mppi_override=dict(n_samples=2, horizon=2), max_steps=1,
                                    chunk=1, goal_tolerance=1e9, device="cpu")
    assert [(r["run"], r["outcome"], r["steps_saved"]) for r in out] == [(0, "goal", 1),
                                                                         (1, "goal", 1)]
    assert sorted(os.listdir(tmp_path)) == ["run_000", "run_001"]
