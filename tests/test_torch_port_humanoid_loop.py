"""PyTorch port: the humanoid closed estimator loop against the JAX package
on the CPU -- batched kinematics (physics/engine.fk, body_velocities,
Engine.forward on a K batch), costs/{base,humanoid}.py, the fk and predvel
estimator costs, the trained rollout_k surrogate's weights, the closed loop
through EstimatorRunner, and collect_humanoid_jl's goal advance.

Inputs come from numpy seeds (and the JAX loop's recorded trajectory,
artifacts/rollout_k_surrogate/estimator_fk_k8192_t25.npz). The kinematic
model is the humanoid plant (the JAX side: build_from_mjcf(...,
include_self_collisions=True)). Tolerances, in f64: kinematics 1e-12;
costs rtol 1e-10; the loop as tests/test_torch_port_estimator_loop.py's
(qpos 1e-10, qvel and actions 1e-9, times 1e-15); the trained forward in
f32 at 2e-5 (tests/test_estimator_kernel.py's).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_mppi_rl_tpu.collect import estimator as jest
from humanoid_mppi_rl_tpu.collect import runner as jrunner
from humanoid_mppi_rl_tpu.costs import base as jbase
from humanoid_mppi_rl_tpu.costs import humanoid as jhum
from humanoid_mppi_rl_tpu.dynamics.learned import make_learned_dynamics as jax_learned
from humanoid_mppi_rl_tpu.learning import train as jtrain
from humanoid_mppi_rl_tpu.models.predictors import make_model as jax_make_model
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu.solver import mppi as jmppi
from humanoid_mppi_rl_tpu_torch.collect import estimator as pest
from humanoid_mppi_rl_tpu_torch.collect import runner as prunner
from humanoid_mppi_rl_tpu_torch.costs import base as pbase
from humanoid_mppi_rl_tpu_torch.costs import humanoid as phum
from humanoid_mppi_rl_tpu_torch.envs import tasks as ptasks
from humanoid_mppi_rl_tpu_torch.models.convert import load_trained, params_from_flax, trained_path
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import load_model
from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv

ROOT = os.path.join(os.path.dirname(__file__), "..")
HUMANOID_XML = os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", "humanoid.xml")
SURROGATE = os.path.join(ROOT, "artifacts", "rollout_k_surrogate")
K, T, STEPS = 8, 3, 3
SMALL = dict(hidden_dim=32, attn_layers=2, dropout_rate=0.0)
NX = 30   # [qpos(28); foot_left z; foot_right z]


@pytest.fixture(scope="module")
def jm():
    return build_from_mjcf(HUMANOID_XML, include_self_collisions=True)


@pytest.fixture(scope="module")
def pm():
    return load_model("humanoid_plant")


@pytest.fixture(scope="module")
def eng(pm):
    return Engine(pm, device="cpu", dtype=torch.float64)


def _jax_forward(jm):
    return jax.jit(jax.vmap(lambda q, v, t: jeng.forward(jm, q, v, time=t)))


def _poses(m, n, seed, scale=0.3, quat_scale=None):
    """(qpos, qvel, time) for n samples about qpos0; `quat_scale` (n,)
    makes the root quaternions non-unit, as a surrogate predicts them."""
    rng = np.random.default_rng(seed)
    q = m.qpos0 + scale * rng.normal(size=(n, m.nq))
    q[:, 2] = 1.0 + 0.3 * rng.random(n)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=-1, keepdims=True)
    if quat_scale is not None:
        q[:, 3:7] *= quat_scale[:, None]
    return q, rng.normal(size=(n, m.nv)), rng.random(n) * 3.0


def _state(eng, q, v, t):
    f = lambda a: torch.from_numpy(np.asarray(a, np.float64))
    return eng.forward(f(q), f(v), f(t))


# ---- batched kinematics ---------------------------------------------------------

def test_batched_forward_matches_jax_and_the_one_sample_path(jm, eng):
    """K=7 (non-unit quaternions included) against JAX forward vmapped at
    1e-12; each row equal, bit for bit, to the port's one-sample call."""
    q, v, t = _poses(jm, 7, seed=0, quat_scale=np.linspace(0.9, 1.15, 7))
    got = _state(eng, q, v, t)
    want = _jax_forward(jm)(jnp.asarray(q), jnp.asarray(v), jnp.asarray(t))
    for name, shape in (("xpos", (7, 17, 3)), ("xquat", (7, 17, 4)), ("S", (7, 27, 6)),
                        ("body_vel", (7, 17, 6))):
        g = getattr(got, name).numpy()
        assert g.shape == shape
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)), atol=1e-12, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(got.time.numpy(), t)
    for k in range(7):
        one = eng.forward(got.qpos[k], got.qvel[k])
        for name in ("xpos", "xquat", "S", "body_vel"):
            assert torch.equal(getattr(got, name)[k], getattr(one, name)), (k, name)
    assert one.time.shape == () and float(one.time) == 0.0


# ---- costs/base and costs/humanoid ------------------------------------------------

def test_quat_rpy_and_body_com_linvel_match_jax(jm, eng):
    q, v, t = _poses(jm, 9, seed=1)
    st = _state(eng, q, v, t)
    want_state = _jax_forward(jm)(jnp.asarray(q), jnp.asarray(v), jnp.asarray(t))
    quats = np.random.default_rng(2).normal(size=(4, 9, 4))
    for g, w in zip(pbase.quat_rpy(torch.from_numpy(quats)), jbase.quat_rpy(jnp.asarray(quats))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-14)
    for body in ("shin_left", "foot_right", "torso"):
        b = jm.body_id(body)
        want = jax.vmap(lambda s: jbase.body_com_linvel(s, jm, b))(want_state)
        got = pbase.body_com_linvel(st, eng, b)
        assert got.shape == (9, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


def _gait_cases(m, eng, n=24, seed=3):
    """Seeded states on which every per-sample branch of make_costs takes
    both sides: left and right swing, clearance below and above 0.05 m."""
    q, v, t = _poses(m, n, seed=seed)
    st = _state(eng, q, v, t)
    ids = {b: m.body_id(b) for b in ("shin_left", "shin_right", "foot_left", "foot_right")}
    left = (pbase.body_com_linvel(st, eng, ids["shin_left"])[:, 0]
            > pbase.body_com_linvel(st, eng, ids["shin_right"])[:, 0]).numpy()
    zl, zr = st.xpos[:, ids["foot_left"], 2].numpy(), st.xpos[:, ids["foot_right"], 2].numpy()
    clearance = np.where(left, zl - zr, zr - zl)
    assert left.any() and (~left).any(), left
    assert (clearance < 0.05).any() and (clearance >= 0.05).any(), clearance
    return q, v, t, st


@pytest.mark.parametrize("weights", ["v3", "walk"])
def test_make_costs_match_jax(jm, eng, weights):
    """Running and terminal, K=24, against the JAX costs vmapped, rtol 1e-10."""
    kw = {"v3": (jhum.WEIGHTS_V3, phum.WEIGHTS_V3),
          "walk": (jhum.WEIGHTS_WALK, phum.WEIGHTS_WALK)}[weights]
    assert kw[0] == kw[1]
    extra = dict(target=(1.5, 0.3, 1.28), target_vel=(0.4, 0.1), w_foot_lift=10.0)
    q, v, t, st = _gait_cases(jm, eng)
    u = np.random.default_rng(4).normal(size=(len(q), jm.nu))
    jrun, jterm = jhum.make_costs(jm, **kw[0], **extra)
    prun, pterm = phum.make_costs(eng.model, **kw[1], **extra)
    js = _jax_forward(jm)(jnp.asarray(q), jnp.asarray(v), jnp.asarray(t))
    want_run = jax.vmap(lambda s, a: jrun(s, a, 0))(js, jnp.asarray(u))
    want_term = jax.vmap(lambda s: jterm(s, 0))(js)
    got_run = prun(st, torch.from_numpy(u), 0)
    got_term = pterm(st, 0)
    assert got_run.shape == got_term.shape == (len(q),)
    np.testing.assert_allclose(got_run.numpy(), np.asarray(want_run), rtol=1e-10)
    np.testing.assert_allclose(got_term.numpy(), np.asarray(want_term), rtol=1e-10)


def test_make_costs_walk_and_the_task_preset_share_one_table(jm, eng):
    assert ptasks.WEIGHTS_WALK is phum.WEIGHTS_WALK
    q, v, t, st = _gait_cases(jm, eng)
    u = torch.zeros(len(q), jm.nu, dtype=torch.float64)
    a = phum.make_costs_walk(eng.model, w_height=7.0)[0](st, u, 0)
    b = phum.make_costs(eng.model, **dict(phum.WEIGHTS_WALK, w_height=7.0))[0](st, u, 0)
    assert torch.equal(a, b)


# ---- the estimator costs ----------------------------------------------------------

def _aug_fk(m, n, seed):
    """[qpos; foot z; prev qpos; prev foot z; tau] with non-unit predicted
    quaternions and FD velocities of a few m/s."""
    rng = np.random.default_rng(seed)
    q, _, tau = _poses(m, n, seed, quat_scale=1.0 + 0.08 * rng.normal(size=n))
    prev = q + 0.01 * rng.normal(size=q.shape)
    prev[:, 3:7] /= np.linalg.norm(prev[:, 3:7], axis=-1, keepdims=True)
    fz = lambda: 0.1 * rng.random((n, 2))
    return np.concatenate([q, fz(), prev, fz(), tau[:, None]], axis=1)


def _aug_predvel(m, n, seed):
    rng = np.random.default_rng(seed)
    q, v, tau = _poses(m, n, seed, quat_scale=1.0 + 0.08 * rng.normal(size=n))
    x = np.concatenate([q, v, 0.1 * rng.random((n, 2))], axis=1)
    return np.concatenate([x, x + 0.01 * rng.normal(size=x.shape), tau[:, None]], axis=1)


def _recorded_aug(pm, kind):
    """Rows of the JAX loop's recorded trajectory in the costs' layouts."""
    path = os.path.join(SURROGATE, "estimator_fk_k8192_t25.npz")
    if not os.path.exists(path):
        pytest.skip("artifacts/ is absent (the recorded JAX trajectory)")
    d = np.load(path)
    s, tm = d["states"][:40], d["times"][:40]
    st = Engine(pm, "cpu", torch.float64).forward(torch.from_numpy(s[:, :28]),
                                                  torch.from_numpy(s[:, 28:]))
    feet = np.stack([st.xpos[:, pm.body_id("foot_left"), 2].numpy(),
                     st.xpos[:, pm.body_id("foot_right"), 2].numpy()], axis=1)
    x = np.concatenate([s[:, :28], feet] if kind == "fk" else [s, feet], axis=1)
    return np.concatenate([x[1:], x[:-1], tm[1:, None]], axis=1)


@pytest.mark.parametrize("kind", ["fk", "predvel"])
@pytest.mark.parametrize("source", ["seeded", "recorded"])
def test_estimator_costs_match_jax(jm, pm, kind, source):
    """humanoid_fk/predvel_estimator_costs, running and terminal, against
    JAX at rtol 1e-10 on a (K, 2 nx + 1) augmented batch."""
    if source == "recorded":
        x = _recorded_aug(pm, kind)
    else:
        x = (_aug_fk if kind == "fk" else _aug_predvel)(jm, 16, seed=5)
    u = np.random.default_rng(6).normal(size=(len(x), jm.nu))
    jfn = {"fk": jest.humanoid_fk_estimator_costs,
           "predvel": jest.humanoid_predvel_estimator_costs}[kind]
    pfn = {"fk": pest.humanoid_fk_estimator_costs,
           "predvel": pest.humanoid_predvel_estimator_costs}[kind]
    jrun, jterm = jfn(jm)
    prun, pterm = pfn(pm)
    want_run = jax.jit(lambda a, b: jrun(a, b, 0))(jnp.asarray(x), jnp.asarray(u))
    want_term = jax.jit(lambda a: jterm(a, 0))(jnp.asarray(x))
    got_run = prun(torch.from_numpy(x), torch.from_numpy(u), 0)
    got_term = pterm(torch.from_numpy(x), 0)
    assert got_run.shape == (len(x),)
    np.testing.assert_allclose(got_run.numpy(), np.asarray(want_run), rtol=1e-10)
    np.testing.assert_allclose(got_term.numpy(), np.asarray(want_term), rtol=1e-10)
    # one unbatched state scores as its batch row
    one = prun(torch.from_numpy(x[2]), torch.from_numpy(u[2]), 0)
    assert one.shape == () and torch.allclose(one, got_run[2], rtol=1e-14, atol=0)


def test_foot_state_fn_reads_the_plant(pm, eng):
    q, v, t = _poses(pm, 1, seed=7)
    st = eng.forward(torch.from_numpy(q[0]), torch.from_numpy(v[0]))
    x = pest.humanoid_foot_state_fn(pm)(st)
    assert x.shape == (NX,)
    assert torch.equal(x[:28], st.qpos)
    assert torch.equal(x[28:], st.xpos[[pm.body_id("foot_left"), pm.body_id("foot_right")], 2])


# ---- the trained weights ----------------------------------------------------------

def test_trained_weights_file_equals_the_orbax_restore(pm):
    """assets/rollout_k_surrogate_best.pt = params_from_flax of the orbax
    restore of artifacts/rollout_k_surrogate/ckpt/model_best, bit for bit;
    its forward on rows of the recorded loop equals flax apply at 2e-5."""
    path = os.path.join(SURROGATE, "ckpt", "model_best")
    if not os.path.isdir(path):
        pytest.skip("artifacts/ is absent (the orbax checkpoint)")
    net = jax_make_model("humanoid_attention")
    like = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 51), jnp.float32), deterministic=True)
    params = jax.tree_util.tree_map(np.asarray, jtrain.load_checkpoint(path, like))
    want = params_from_flax(params, make_model("humanoid_attention"))
    got = torch.load(trained_path("rollout_k_surrogate_best"), weights_only=True)
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], w), name
    aug = _recorded_aug(pm, "fk")
    d = np.load(os.path.join(SURROGATE, "estimator_fk_k8192_t25.npz"))
    x = np.concatenate([aug[:, :NX], d["actions"][1:len(aug) + 1]], axis=1).astype(np.float32)
    mod = load_trained("rollout_k_surrogate_best", device="cpu")
    ref = np.asarray(net.apply(params, jnp.asarray(x), deterministic=True))
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == (len(x), NX)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


# ---- the closed loop --------------------------------------------------------------

def _surrogate(seed=0):
    """(flax module in f64, its f64 params, the port module in f64): a small
    humanoid_attention, every bias and LayerNorm term nonzero, head x 0.01."""
    net = jax_make_model("humanoid_attention", compute_dtype=jnp.float64, **SMALL)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 51)), deterministic=True)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)
    head = params["params"]["Dense_1"]
    head["kernel"] = head["kernel"] * np.float32(0.01)
    head["bias"] = head["bias"] * np.float32(0.01)
    mod = make_model("humanoid_attention", **SMALL)
    mod.load_state_dict(params_from_flax(params, mod))
    return net, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params), mod.double()


def _jax_loop(jm, net, params, cfg, noises):
    """dev_estimator_walk.py --configs fk through JAX's control_step recipe
    (collect/estimator.py:396-415), the injected noise in place of the
    key's draw: rows, actions, times."""
    id_l, id_r = jm.body_id("foot_left"), jm.body_id("foot_right")
    dyn, augment = jest.make_fd_time_augmented(jax_learned(net.apply, params), NX,
                                               float(jm.timestep))
    running, terminal = jest.humanoid_fk_estimator_costs(jm)
    make_plan = jmppi.make_mppi(dyn, running, cfg, terminal_fn=terminal, batched_dynamics=True)
    plan = jax.jit(lambda ms, x, noise: make_plan(ms, x, noise=noise))
    step = jax.jit(lambda s, u: jeng.step(jm, s, u))
    plant = jax.jit(lambda q, v: jeng.forward(jm, q, v))(jnp.asarray(jm.qpos0), jnp.zeros(jm.nv))
    ms = jmppi.MPPIState.seeded(0, cfg.T, jm.nu)
    rows, actions, times = [], [], []
    for noise in noises:
        rows.append(np.concatenate([np.asarray(plant.qpos), np.asarray(plant.qvel)]))
        times.append(float(plant.time))
        x = jnp.concatenate([plant.qpos, plant.xpos[id_l, 2][None], plant.xpos[id_r, 2][None]])
        action, ms, _ = plan(ms, augment(x, plant.time), jnp.asarray(noise))
        actions.append(np.asarray(action, np.float64))
        plant = step(plant, action)
    return np.stack(rows), np.stack(actions), np.array(times)


def test_humanoid_estimator_loop_matches_jax(jm, pm):
    """3 control steps at K=8, T=3 in f64 with matched noise, rows fetched
    in chunks of 2: the port's EstimatorRunner on the module route."""
    cfg = dataclasses.replace(jest.ESTIMATOR_CONFIGS["humanoid"], n_samples=K, horizon=T)
    net, params, mod = _surrogate()
    rng = np.random.default_rng(11)
    noises = [cfg.sigma * rng.normal(size=(K, T, jm.nu)) for _ in range(STEPS)]
    want = _jax_loop(jm, net, params, cfg, noises)
    pcfg = dataclasses.replace(pest.ESTIMATOR_CONFIGS["humanoid"], n_samples=K, horizon=T)
    runner = pest.EstimatorRunner(
        "humanoid_collect", mod, pcfg, *pest.humanoid_fk_estimator_costs(pm),
        state_fn=pest.humanoid_foot_state_fn(pm), fd_time_augment=NX,
        device="cpu", dtype=torch.float64)
    log = runner.run(n_steps=STEPS, seed=0, chunk=2, noise_fn=lambda i: torch.from_numpy(noises[i]))
    states, actions, times = log.arrays()
    assert states.shape == (STEPS, 55) and actions.shape == (STEPS, 21)
    np.testing.assert_allclose(states[:, :28], want[0][:, :28], atol=1e-10)
    np.testing.assert_allclose(states[:, 28:], want[0][:, 28:], atol=1e-9)
    np.testing.assert_allclose(actions, want[1], atol=1e-9)
    np.testing.assert_allclose(times, want[2], atol=1e-15)
    assert np.abs(actions).max() > 1e-3 and np.abs(np.diff(states[:, 7:28], axis=0)).max() > 1e-6


def test_humanoid_loop_plans_through_the_estimator_kernel_wrapper(pm, monkeypatch):
    """batched_dynamics=True: T forwards of the (K, 51) batch per control
    step through make_flash_feature_attention (its plain version here)."""
    from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek

    cfg = dataclasses.replace(pest.ESTIMATOR_CONFIGS["humanoid"], n_samples=K, horizon=T)
    _, _, mod = _surrogate()
    runner = pest.EstimatorRunner("humanoid_collect", mod.float(), cfg,
                                  *pest.humanoid_fk_estimator_costs(pm),
                                  state_fn=pest.humanoid_foot_state_fn(pm),
                                  batched_dynamics=True, fd_time_augment=NX, device="cpu")
    shapes, plain = [], ek.forward_plain

    def counted(w, x, *a):
        shapes.append(tuple(x.shape))
        return plain(w, x, *a)
    monkeypatch.setattr(ek, "forward_plain", counted)
    ms, plant = runner.start()
    n0 = ek.launches
    action, ms, plant2, _ = runner.control_step(ms, plant)
    assert shapes == [(K, 51)] * T and ek.launches == n0
    assert torch.isfinite(action).all() and float(plant2.qpos[2]) > 0.7


# ---- collect_humanoid_jl ----------------------------------------------------------

def test_jl_goal_advance_matches_jax(jm, eng):
    """The goal advance on the same plant states and params, near the goal
    and away from it, step after step (the first reach keeps (1, 0))."""
    jadv = jrunner._jl_goal_advance((1.0, 0.0), 0.15)
    padv = prunner._jl_goal_advance((1.0, 0.0), 0.15)
    q, v, t = _poses(jm, 6, seed=8)
    q[:, :2] = [[1.05, 0.0], [1.1, 0.05], [3.0, 0.0], [2.0, 0.1], [2.02, -0.05], [0.0, 0.0]]
    jp = jnp.asarray([1.0, 0.0, 1.28, 0.0] + [0.0] * 12)
    pp = torch.tensor(np.asarray(jp), dtype=torch.float64)
    jfwd = jax.jit(lambda a, b: jeng.forward(jm, a, b))
    seen = []
    for k in range(6):
        st = eng.forward(torch.from_numpy(q[k]), torch.from_numpy(v[k]))
        jp = jadv(jfwd(jnp.asarray(q[k]), jnp.asarray(v[k])), jp)
        pp = padv(st, pp)
        np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
        seen.append(pp[:4].tolist())
    assert seen[0] == [1.0, 0.0, 1.28, 1.0] and seen[1] == [2.0, 0.0, 1.28, 2.0]
    assert seen[2] == seen[1] and seen[4] == [3.0, 0.0, 1.28, 3.0]


def test_collect_humanoid_jl_writes_its_csvs(tmp_path):
    out = prunner.collect_humanoid_jl(n_episodes=2, out_dir=str(tmp_path), max_steps=2,
                                      mppi_override=dict(n_samples=4, horizon=2), chunk=2,
                                      shard_index=1, num_shards=2, device="cpu")
    assert out == [(1, 2)]
    (run,) = os.listdir(tmp_path)
    assert run.endswith("_001")
    shapes = {k: read_csv(os.path.join(tmp_path, run, f"{k}.csv")).reshape(2, -1).shape[1]
              for k in ("states", "actions", "times")}
    assert shapes == {"states": 55, "actions": 21, "times": 1}
    # the array planner (the goal of the cost fixed at (1, 0, 1.28))
    out = prunner.collect_humanoid_jl(out_dir=str(tmp_path / "array"), max_steps=1,
                                      mppi_override=dict(n_samples=2, horizon=2), chunk=1,
                                      use_kernel=False, device="cpu")
    assert out == [(0, 1)] and len(os.listdir(tmp_path / "array")) == 1
