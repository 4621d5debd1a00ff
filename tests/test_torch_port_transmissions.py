"""PyTorch port, slice 11: the actuator transmissions beyond a joint's
(site wrenches and fixed tendons) and the ball predecessor rule, against
the JAX package on the CPU in f64.

Models: tests/test_engine_generality.py's SITE_ACT_XML (a free box with
three site motors, one on a child body) and TENDON_ACT_XML (a motor and a
position servo on two fixed tendons), committed as assets/
site_act_plant.json and assets/tendon_act_plant.json; and
tests/test_physics_parity.py's MULTI_JOINT_BALL_XML (hinge, ball and slide
on one body, ball and slide on its child: a ball's Sdot takes its own dofs
and not a trailing slide's). Inputs: chip_smoke.transmission_inputs.
Tolerances as tests/test_torch_port_arm5.py's: a step's qpos 1e-10, qvel
5e-8; the CUDA body against the plain version rtol 1e-9 (costs), atol
1e-10 (final state)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import transmission_inputs
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as tkc
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
from humanoid_mppi_rl_tpu_torch.ops import scalar_physics as tsph
from humanoid_mppi_rl_tpu_torch.physics import engine as peng
from humanoid_mppi_rl_tpu_torch.physics.model import (
    export_model_arrays, load_model, model_from_arrays, snapshot_json, snapshot_path)
from test_engine_generality import SITE_ACT_XML, TENDON_ACT_XML
from test_physics_parity import MULTI_JOINT_BALL_XML
from torch_port_small_robots import host_library, host_rollout, j, stack, t

F64 = torch.float64
NS, T = 8, 3
XML = {"site_act_plant": SITE_ACT_XML, "tendon_act_plant": TENDON_ACT_XML,
       "multi_joint_ball": MULTI_JOINT_BALL_XML}
NAMES = ("site_act_plant", "tendon_act_plant")


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, port model); the port's from its snapshot, the
    multi-joint ball model from a fresh export."""
    out = {}
    for name, xml in XML.items():
        jm = build_from_mjcf(xml=xml, include_self_collisions=True)
        pm = (load_model(name) if name in NAMES
              else model_from_arrays(export_model_arrays(jm, plant=True)))
        out[name] = (jm, pm)
    return out


def _inputs(pm, seed):
    """(qpos, qvel, ctrl) numpy arrays over NS samples; the multi-joint
    ball model's ball quaternions random unit ones."""
    x = transmission_inputs(pm, NS, T, F64, seed=seed, device="cpu")
    qpos, qvel = x[0].numpy().copy(), x[1].numpy()
    rng = np.random.default_rng(seed + 1)
    for jt in pm.joints:
        if jt.jtype == 1:
            q = rng.normal(0, 0.3, (4, NS)) + np.array([[1.0], [0], [0], [0]])
            qpos[jt.qposadr:jt.qposadr + 4] = q / np.linalg.norm(q, axis=0)
    return qpos, qvel, rng.uniform(-3, 3, (pm.nu, NS))


@pytest.mark.parametrize("name", NAMES)
def test_transmission_snapshots_equal_fresh_mjcf_export(models, name):
    """assets/{site,tendon}_act_plant.json equal a fresh export and survive
    a round trip; the site model's three site motors, the tendon model's
    two tendon actuators."""
    jm, _ = models[name]
    fresh = snapshot_json(export_model_arrays(jm, plant=True))
    with open(snapshot_path(name)) as f:
        assert f.read() == fresh, (
            f"assets/{name}.json is stale: regenerate it with snapshot_json(export_model_arrays("
            f"build_from_mjcf(xml=..., include_self_collisions=True), plant=True))")
    m = load_model(name)
    assert snapshot_json(export_model_arrays(model_from_arrays(
        export_model_arrays(m, plant=True)), plant=True)) == fresh
    if name == "site_act_plant":
        assert [a.site_bodyid for a in m.actuators] == [1, 1, 2]
        np.testing.assert_allclose(m.actuators[0].site_quat, jm.actuators[0].site_quat)
    else:
        assert [a.tendon_id for a in m.actuators] == [0, 1] and not m.tendon_limited.any()


@pytest.mark.parametrize("name", NAMES + ("multi_joint_ball",))
def test_transmission_scalar_step_matches_jax(models, name):
    """One plain penalty step against JAX scalar_step: the site wrenches'
    moments on their body's chain, the tendons' gear-scaled coordinates,
    the ball's Sdot before a trailing slide."""
    jm, pm = models[name]
    qpos, qvel, ctrl = _inputs(pm, seed=2)
    jq, jv, _ = jsph.scalar_step(jm, j(qpos), j(qvel), j(ctrl), jnp.zeros(NS))
    tq, tv, _ = tsph.scalar_step(pm, t(qpos), t(qvel), t(ctrl), torch.zeros(NS, dtype=F64))
    np.testing.assert_allclose(stack(tq, NS), stack(jq, NS), atol=1e-10)
    np.testing.assert_allclose(stack(tv, NS), stack(jv, NS), atol=5e-8)
    assert (np.abs(stack(tv, NS) - qvel).max(axis=0) > 1e-3).all()


@pytest.mark.parametrize("name", NAMES + ("multi_joint_ball",))
def test_transmission_engine_steps_match_jax(models, name):
    """The array engine against JAX step: the penalty tier over the K batch
    (vmapped JAX), and three coupled steps of the first sample; for the
    site and tendon models also the actuator forces alone (JAX
    _actuator_forces)."""
    jm, pm = models[name]
    qpos, qvel, ctrl = _inputs(pm, seed=4)
    eng = peng.Engine(pm, "cpu", F64)
    st = jax.vmap(lambda qp, qv: jeng.forward(jm, qp, qv))(jnp.asarray(qpos.T),
                                                          jnp.asarray(qvel.T))
    want = jax.vmap(lambda s, u: jeng.step(jm, s, u, solver="penalty"))(st, jnp.asarray(ctrl.T))
    ts = eng.forward(torch.tensor(qpos.T), torch.tensor(qvel.T), torch.zeros(NS, dtype=F64))
    got = eng.step(ts, torch.tensor(ctrl.T), solver="penalty")
    np.testing.assert_allclose(got.qpos.numpy(), np.asarray(want.qpos), atol=1e-10)
    np.testing.assert_allclose(got.qvel.numpy(), np.asarray(want.qvel), atol=5e-8)
    if name in NAMES:
        for k in range(NS):
            s = jeng.forward(jm, jnp.asarray(qpos[:, k]), jnp.asarray(qvel[:, k]))
            jf = jeng._actuator_forces(jm, s.qpos, s.qvel, jnp.asarray(ctrl[:, k]), state=s)
            tf = peng.actuator_forces(eng, ts.qpos[k], ts.qvel[k], torch.tensor(ctrl[:, k]),
                                      eng.forward(ts.qpos[k], ts.qvel[k]))
            np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-12)
    js = jeng.forward(jm, jnp.asarray(qpos[:, 0]), jnp.asarray(qvel[:, 0]))
    cs = eng.forward(torch.tensor(qpos[:, 0]), torch.tensor(qvel[:, 0]))
    for _ in range(3):
        js = jeng.step(jm, js, jnp.asarray(ctrl[:, 0]))
        cs = eng.step(cs, torch.tensor(ctrl[:, 0]))
        np.testing.assert_allclose(cs.qpos.numpy(), np.asarray(js.qpos), atol=1e-10)
        np.testing.assert_allclose(cs.qvel.numpy(), np.asarray(js.qvel), atol=5e-8)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("host_rollout_transmissions"))


@pytest.mark.parametrize("name", NAMES + ("multi_joint_ball",))
def test_transmission_kernel_body_matches_plain(models, host_lib, name):
    """The host-built CUDA body against the plain rollout (the cartpole
    cost, as JAX's kernel tests build such models with it), f64, K=8, T=3:
    costs and final states."""
    _, pm = models[name]
    x = list(transmission_inputs(pm, NS, T, F64, seed=6, device="cpu"))
    x[0] = torch.tensor(_inputs(pm, seed=6)[0])
    ro = rk.build_rollout_kernel(pm, tkc.cartpole, T, device="cpu")
    want = [a.numpy() for a in ro(*x)]
    got = host_rollout(host_lib, pm, tkc.cartpole, {}, x, torch.zeros(16, dtype=F64), T)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(got[1], want[1], atol=1e-10)
    np.testing.assert_allclose(got[2], want[2], atol=1e-10)
    assert np.abs(want[2] - x[1].numpy()).max() > 1e-2


def test_transmission_tables(models):
    """The transmissions in the kernel's tables: the site model's three
    site slots (bodies, frames, gears) and the chains their moments reach;
    the tendon model's two unlimited, driven tendons (no limit rows)."""
    _, site = models["site_act_plant"]
    tab = rk.tables_struct(F64).from_buffer_copy(
        rk.pack_tables(site, tkc.cartpole, {}, None, None, True, F64))
    assert tab.ntrn == 3 and list(tab.trn_kind[:3]) == [3, 3, 3]
    assert list(tab.trn_body[:3]) == [1, 1, 2] and list(tab.act_trn[:3]) == [0, 1, 2]
    np.testing.assert_allclose(list(tab.trn_gear[1]), [0, 0, 0, 0, 0, 0.5])
    np.testing.assert_allclose(list(tab.trn_quat[0]), site.actuators[0].site_quat)
    assert [tab.dof_acts[d] for d in range(7)] == [0b111] * 6 + [0b100]
    _, ten = models["tendon_act_plant"]
    tab = rk.tables_struct(F64).from_buffer_copy(
        rk.pack_tables(ten, tkc.cartpole, {}, None, None, True, F64))
    assert tab.nten == 2 and list(tab.ten_limited[:2]) == [0, 0] and tab.ten_dofmask == 0
    assert list(tab.trn_kind[:2]) == [2, 2] and list(tab.trn_ten[:2]) == [0, 1]
    assert [tab.dof_acts[d] for d in range(2)] == [0b11, 0b11]
