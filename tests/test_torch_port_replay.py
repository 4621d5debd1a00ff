"""viz/replay of the PyTorch port against the JAX package's, on the CPU:
load_trajectory, kinematic_replay on seeded humanoid rows (the JAX side on
build_from_mjcf(humanoid.xml), the port on its snapshot) and
open_loop_model_rollout of the cartpole surrogate, both in f64 at 1e-10.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_mppi_rl_tpu.models.predictors import make_model as jax_make_model
from humanoid_mppi_rl_tpu.physics import build_from_mjcf
from humanoid_mppi_rl_tpu.viz import replay as jax_replay
from humanoid_mppi_rl_tpu_torch.models.convert import params_from_flax
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
from humanoid_mppi_rl_tpu_torch.physics.model import load_model
from humanoid_mppi_rl_tpu_torch.utils.trajio import write_csv
from humanoid_mppi_rl_tpu_torch.viz import replay as port_replay

HUMANOID_XML = os.path.join(os.path.dirname(__file__), "..", "humanoid_mppi_rl_tpu",
                            "assets", "humanoid.xml")


def _humanoid_rows(model, n: int, seed: int = 0) -> np.ndarray:
    """n seeded 57-column rows (the collector's layout: qpos, qvel, foot
    heights): the root moved and turned, every joint off qpos0."""
    rng = np.random.default_rng(seed)
    q = np.tile(model.qpos0, (n, 1)) + rng.normal(0.0, 0.3, (n, model.nq))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    return np.concatenate([q, rng.normal(0.0, 1.0, (n, model.nv + 2))], axis=1)


def test_load_trajectory_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for kind, shape in (("states", (5, 4)), ("actions", (5, 1)), ("times", (5,))):
        write_csv(str(tmp_path / f"{kind}.csv"), rng.normal(size=shape))
    ref = jax_replay.load_trajectory(str(tmp_path))
    got = port_replay.load_trajectory(str(tmp_path))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    s, a, t = port_replay.load_trajectory(states_csv=str(tmp_path / "states.csv"))
    assert s.shape == (5, 4) and a is None and t is None


@pytest.mark.parametrize("stride", [1, 3])
def test_kinematic_replay_matches_jax(stride):
    model = load_model("humanoid")
    states = _humanoid_rows(model, 7)
    ref = jax_replay.kinematic_replay(build_from_mjcf(HUMANOID_XML), states, stride=stride)
    got = port_replay.kinematic_replay(model, states, stride=stride, device="cpu")
    assert got.shape == ref.shape == (len(states[::stride]), model.nbody, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)


def test_kinematic_replay_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    model = load_model("cartpole")
    with pytest.raises(RuntimeError, match="cuda"):
        port_replay.kinematic_replay(model, np.zeros((2, 4)))


@pytest.mark.parametrize("mode", ["delta", "raw"])
def test_open_loop_model_rollout_matches_jax(mode):
    """The cartpole preset computing in f64 on both sides (weights
    f32-representable), its output cast to f32 as flax's is; 12 steps."""
    net = jax_make_model("cartpole_attention", compute_dtype=jnp.float64)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.float32))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.2, a.shape).astype(np.float32), shapes)
    mod = make_model("cartpole_attention")
    mod.load_state_dict(params_from_flax(params, mod))
    mod = mod.double()
    init = np.array([0.1, 3.0, -0.2, 0.5])
    actions = rng.normal(0.0, 1.0, (12, 1))
    ref = jax_replay.open_loop_model_rollout(
        net.apply, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params),
        init, actions, mode=mode)
    got = port_replay.open_loop_model_rollout(mod, init, actions, mode=mode)
    assert got.shape == ref.shape == (13, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_open_loop_model_rollout_keeps_the_training_flag(training):
    """The rollout runs in eval mode and leaves the caller's module as it
    found it."""
    torch.manual_seed(0)
    mod = make_model("cartpole_attention").train(training)
    got = port_replay.open_loop_model_rollout(mod, np.zeros(4), np.zeros((3, 1)))
    assert got.shape == (4, 4) and np.isfinite(got).all()
    assert mod.training is training
