"""PyTorch port: mesh-vs-primitive and mesh-vs-mesh contact pairs
(physics/contact's geom-vs-mesh narrowphase, both directions, the top-2k
dedup and the relative jacobians of two dynamic bodies) in the coupled
tier (one sample and over K) and the penalty tier over K, against the
JAX package on the CPU in f64.

Models: tests/test_engine_generality.py's MESH_ON_BOX_XML, BOX_ON_MESH_XML,
MESH_ON_MESH_XML, TWO_DYN_STACK_XML, its two-dynamic box on a mesh, its
mesh over a world sphere and over a world capsule (the sphere and capsule
distance branches) and _clustered_cube_xml() (micron vertex clusters: the
dedup), committed as assets/*_plant.json. Each runs 20 coupled steps from
qpos0, and from qpos0 falling at 1.5 m/s (the pair's rows switch on
within the steps), against JAX's jitted step; a penalty step and a
coupled step over K=8 perturbed states against jax.vmap of JAX's
(tolerances: qpos 1e-10, qvel 1e-9 coupled and 1e-8 penalty,
tests/test_torch_port_plant.py's and tests/test_kernel.py's). The rollout
kernel still refuses a primitive-vs-mesh pair."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import MESH_SNAPSHOTS, mesh_states

from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.contact import collect_contact_rows as jax_rows
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.physics.contact import collect_contact_rows
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import (
    FREE, export_model_arrays, load_model, snapshot_json, snapshot_path)
from test_engine_generality import (BOX_ON_MESH_XML, MESH_ON_BOX_XML, MESH_ON_MESH_XML,
                                    TWO_DYN_STACK_XML, _clustered_cube_xml)

torch.set_num_threads(1)

F64 = torch.float64
K, STEPS = 8, 20
_WORLD_BOX = '<geom type="box" size="0.5 0.5 0.15" pos="0 0 0.15"/>'
MESH_MODELS = {
    "mesh_on_box_plant": MESH_ON_BOX_XML,
    "box_on_mesh_plant": BOX_ON_MESH_XML,
    "mesh_on_mesh_plant": MESH_ON_MESH_XML,
    "two_dyn_stack_plant": TWO_DYN_STACK_XML,
    "box_on_dyn_mesh_plant": BOX_ON_MESH_XML.replace(
        '<geom type="mesh" mesh="cube" pos="0 0 0.1"/>',
        '<geom type="plane" size="2 2 0.1"/>'
        '<body pos="0 0 0.12"><freejoint/>'
        '<geom type="mesh" mesh="cube" mass="1"/></body>'),
    "mesh_on_sphere_plant": MESH_ON_BOX_XML.replace(
        _WORLD_BOX, '<geom type="sphere" size="0.2" pos="0 0 0.1"/>'),
    "mesh_on_capsule_plant": MESH_ON_BOX_XML.replace(
        _WORLD_BOX, '<geom type="capsule" fromto="-0.3 0 0.1 0.3 0 0.1" size="0.2"/>'),
    "clustered_cube_plant": _clustered_cube_xml(),
}
NAMES = tuple(MESH_MODELS)
assert NAMES == MESH_SNAPSHOTS


@pytest.fixture(scope="module")
def models():
    """name -> (JAX model, port model from its snapshot)."""
    return {name: (build_from_mjcf(xml=xml), load_model(name))
            for name, xml in MESH_MODELS.items()}


_JITTED = {}


def _jax_step(jm, name: str, solver: str, batched: bool):
    """JAX's jitted step of model `name` (vmapped when batched), compiled
    once for the module."""
    key = (name, solver, batched)
    if key not in _JITTED:
        fn = lambda s, u: jeng.step(jm, s, u, solver=solver)
        _JITTED[key] = jax.jit(jax.vmap(fn) if batched else fn)
    return _JITTED[key]


def _start(pm, falling: bool):
    """qpos0 at rest, or every free body falling at 1.5 m/s."""
    qvel = np.zeros(pm.nv)
    if falling:
        for j in pm.joints:
            if j.jtype == FREE:
                qvel[j.dofadr + 2] = -1.5
    return np.asarray(pm.qpos0, dtype=np.float64), qvel


def _perturbed(pm, seed: int):
    """chip_smoke.mesh_states as (K, nq), (K, nv): the free bodies lowered
    into contact, tilted and moving."""
    qpos, qvel = mesh_states(pm, K, seed)
    return np.ascontiguousarray(qpos.T), np.ascontiguousarray(qvel.T)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_snapshot_equals_fresh_mjcf_export(models, name):
    """assets/<name>.json equals a fresh export of its MJCF; each model has a
    mesh pair without a plane, and the rollout kernel refuses it."""
    from humanoid_mppi_rl_tpu_torch.ops.rollout_kernel import check_kernel_supported

    jm, pm = models[name]
    with open(snapshot_path(name)) as f:
        assert f.read() == snapshot_json(export_model_arrays(jm, plant=True)), (
            f"assets/{name}.json is stale: regenerate it with snapshot_json("
            f"export_model_arrays(build_from_mjcf(xml=...), plant=True))")
    assert Engine(pm, "cpu", F64).contact.mesh_pairs
    with pytest.raises(NotImplementedError, match="array engine only"):
        check_kernel_supported(pm)


@pytest.mark.parametrize("falling", [False, True], ids=["rest", "falling"])
@pytest.mark.parametrize("name", NAMES)
def test_mesh_pairs_coupled_steps_match_jax(models, name, falling):
    """20 coupled steps from qpos0 against JAX's jitted step; the falling
    start switches the pair's rows on."""
    jm, pm = models[name]
    eng = Engine(pm, "cpu", F64)
    qpos, qvel = _start(pm, falling)
    jstep = lambda s: _jax_step(jm, name, "coupled", False)(s, jnp.zeros(pm.nu))
    js = jeng.forward(jm, jnp.asarray(qpos), jnp.asarray(qvel))
    ps = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    active = 0
    for i in range(STEPS):
        active += int(collect_contact_rows(eng.contact, ps, ps.S)["active"].sum())
        js, ps = jstep(js), eng.step(ps, torch.zeros(pm.nu, dtype=F64))
        np.testing.assert_allclose(ps.qpos.numpy(), np.asarray(js.qpos), atol=1e-10,
                                   err_msg=f"{name} step {i}")
        np.testing.assert_allclose(ps.qvel.numpy(), np.asarray(js.qvel), atol=1e-9,
                                   err_msg=f"{name} step {i}")
    assert falling == (active > 0), active


@pytest.mark.parametrize("name", NAMES)
def test_mesh_pairs_batched_steps_match_jax_vmap(models, name):
    """Over K=8 states in contact: the contact rows, a penalty step and a
    coupled step against jax.vmap of JAX's; the batched coupled step equals
    the one-sample one; a float32 step stays finite (the inert rows)."""
    jm, pm = models[name]
    eng = Engine(pm, "cpu", F64)
    qpos, qvel = _perturbed(pm, seed=3)
    ctrl = np.zeros((K, pm.nu))
    js, want = jax.jit(jax.vmap(lambda q, v: (lambda s: (s, jax_rows(jm, s, s.S)))(
        jeng.forward(jm, q, v))))(jnp.asarray(qpos), jnp.asarray(qvel))
    ps = eng.forward(torch.tensor(qpos), torch.tensor(qvel), torch.zeros(K, dtype=F64))
    got = collect_contact_rows(eng.contact, ps, ps.S, penalty=True)
    assert int(got["active"].sum()) > 0
    for key in ("pen", "active", "vn", "JpN", "Jt1", "Jp"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-10,
                                   err_msg=f"{name} {key}")
    for solver, tol in (("penalty", 1e-8), ("coupled", 1e-9)):
        jn = _jax_step(jm, name, solver, True)(js, jnp.asarray(ctrl))
        pn = eng.step(ps, torch.tensor(ctrl), solver=solver)
        np.testing.assert_allclose(pn.qpos.numpy(), np.asarray(jn.qpos), atol=1e-10,
                                   err_msg=f"{name} {solver}")
        np.testing.assert_allclose(pn.qvel.numpy(), np.asarray(jn.qvel), atol=tol,
                                   err_msg=f"{name} {solver}")
    for k in (0, K - 1):
        one = eng.step(eng.forward(torch.tensor(qpos[k]), torch.tensor(qvel[k])),
                       torch.tensor(ctrl[k]))
        torch.testing.assert_close(pn.qvel[k], one.qvel, rtol=1e-12, atol=1e-12)
    e32 = Engine(pm, "cpu", torch.float32)
    s32 = e32.forward(torch.tensor(qpos, dtype=torch.float32),
                      torch.tensor(qvel, dtype=torch.float32), torch.zeros(K))
    for solver in ("coupled", "penalty"):
        n32 = e32.step(s32, torch.zeros(K, pm.nu), solver=solver)
        assert torch.isfinite(n32.qpos).all() and torch.isfinite(n32.qvel).all(), solver
