"""PyTorch port, slice 2: the learned-surrogate (estimator) MPPI replan
against the JAX package, on the CPU.

The same numpy-seeded inputs and weights go through both packages: the
FeatureAttention module and its weight conversion, the flash kernel's plain
version (against the JAX kernel in Pallas interpret mode), the learned
dynamics, the estimator costs, and make_mppi over the surrogate with the
same injected noise.

Tolerances, with their reasons:
- f32 everywhere: 2e-5 (tests/test_estimator_kernel.py:43-44); only the
  order of f32 sums differs.
- bf16, the plain version vs the JAX kernel: the JAX side is compiled with
  xla_allow_excess_precision off, so that XLA rounds to bf16 after every
  op as the kernel's source says (with it on, XLA fuses bf16 ops in f32
  and the two differ by as much as bf16 differs from f32). Then most
  outputs agree bit for bit; where an f32 sum in front of a bf16 rounding
  differs in its last bits (another summation order), the rounding flips
  by 2^-8 relative and the flip propagates. Held: median |diff| <= 1e-3 and
  max |diff| <= 2e-2, each times max(1, max|y|).
- bf16 vs flax f32: 5e-2 on the flax init, as tests/test_estimator_kernel.py:64-65.
- the slice: f32 at 2e-5; bf16 at 2e-2 (the flips above, over T=5 steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from chip_smoke import exact_stage_cases, seeded_weights
from humanoid_mppi_rl_tpu.collect import estimator as jest
from humanoid_mppi_rl_tpu.dynamics.learned import make_learned_dynamics as jax_learned
from humanoid_mppi_rl_tpu.learning.torch_import import feature_attention_params
from humanoid_mppi_rl_tpu.models.predictors import make_model as jax_make_model
from humanoid_mppi_rl_tpu.ops.estimator_kernel import (
    make_flash_feature_attention as jax_flash)
from humanoid_mppi_rl_tpu.solver import mppi as jmppi
from humanoid_mppi_rl_tpu_torch.collect import estimator as port_est
from humanoid_mppi_rl_tpu_torch.dynamics.learned import (
    flat_state_from_physics, make_learned_dynamics)
from humanoid_mppi_rl_tpu_torch.models.convert import params_from_flax
from humanoid_mppi_rl_tpu_torch.models.predictors import PRESETS, make_model
from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek
from humanoid_mppi_rl_tpu_torch.ops.estimator_kernel import make_flash_feature_attention
from humanoid_mppi_rl_tpu_torch.physics.state import PhysicsState
from humanoid_mppi_rl_tpu_torch.solver import mppi as tmppi

# each preset at reduced width and depth (head count and token count kept)
SMALL = {"cartpole_attention": dict(hidden_dim=32),
         "quadruped_attention": dict(hidden_dim=64),
         "humanoid_attention": dict(hidden_dim=64, attn_layers=2)}


def _pair(preset, seed=0, perturb=True, **overrides):
    """(flax module, flax params, port module) with the same weights; a
    seeded perturbation makes every bias and LayerNorm term nonzero."""
    net = jax_make_model(preset, **overrides)
    F = net.state_dim + net.action_dim
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, F), jnp.float32),
                      deterministic=True)
    # f32 leaves (under x64 the flax init draws pos_embedding in f64)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    if perturb:
        rng = np.random.default_rng(seed)
        params = jax.tree_util.tree_map(
            lambda a: (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)
    mod = make_model(preset, **overrides)
    mod.load_state_dict(params_from_flax(params, mod))
    return net, params, mod


def _x(B, F, seed=1):
    return np.random.default_rng(seed).normal(size=(B, F)).astype(np.float32)


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_weights_round_trip_through_the_reference_layout(preset):
    """params_from_flax o torch_import.feature_attention_params is the
    identity on a flax init, and the state_dict fits the port's module."""
    net, params, mod = _pair(preset, perturb=False, **SMALL[preset])
    sd = {k: _np(v) for k, v in params_from_flax(params, mod).items()}
    assert set(sd) == set(mod.state_dict())
    back = feature_attention_params(sd, mod.num_heads, mod.attn_layers)
    flat_a = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_module_matches_flax_f32(preset):
    net, params, mod = _pair(preset, **SMALL[preset])
    x = _x(16, net.state_dim + net.action_dim)
    ref = np.asarray(net.apply(params, jnp.asarray(x), deterministic=True))
    got = _np(mod(torch.from_numpy(x)))
    assert got.shape == ref.shape == (16, net.state_dim)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_trained_checkpoint_carried_across():
    """The committed quad_pipeline surrogate (quadruped_attention with
    state_dim=19, F=31), restored by the JAX package and carried across."""
    import os

    from humanoid_mppi_rl_tpu.learning.train import load_checkpoint

    path = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "quad_pipeline", "ckpt", "model_best")
    net = jax_make_model("quadruped_attention", state_dim=19)
    like = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 31), jnp.float32),
                    deterministic=True)
    params = jax.tree_util.tree_map(np.asarray, load_checkpoint(path, like))
    mod = make_model("quadruped_attention", state_dim=19)
    mod.load_state_dict(params_from_flax(params, mod))
    x = _x(8, 31, seed=4)
    ref = np.asarray(net.apply(params, jnp.asarray(x), deterministic=True))
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), ref, atol=2e-5, rtol=2e-5)


def _strict(fn, *args):
    """fn jitted with bf16 rounded after every op (no excess precision)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def assert_bf16_close(got, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    d = np.abs(got - ref)
    assert np.median(d) <= 1e-3 * scale and d.max() <= 2e-2 * scale, (np.median(d), d.max(), scale)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", ["quadruped_attention", "humanoid_attention"])
def test_plain_matches_jax_flash_kernel(preset, cd):
    """B=23: not a multiple of the JAX kernel's block, nor of any tile."""
    net, params, mod = _pair(preset, **SMALL[preset])
    x = jnp.asarray(_x(23, net.state_dim + net.action_dim))
    jf = jax_flash(net, params, compute_dtype=getattr(jnp, cd), block_b=8, interpret=True)
    ref = np.asarray(_strict(lambda a: jf(None, a), x)(x))
    pf = make_flash_feature_attention(mod, getattr(torch, cd), device="cpu")
    got = _np(pf(torch.from_numpy(np.array(x))))
    if cd == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    else:
        assert_bf16_close(got, ref)


def test_plain_bf16_close_to_flax_f32():
    net, params, mod = _pair("quadruped_attention", perturb=False,
                             **SMALL["quadruped_attention"])
    x = _x(16, 49)
    ref = np.asarray(net.apply(params, jnp.asarray(x), deterministic=True))
    got = _np(make_flash_feature_attention(mod, torch.bfloat16, device="cpu")(torch.from_numpy(x)))
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


def test_plain_takes_leading_batch_dims():
    net, params, mod = _pair("cartpole_attention", **SMALL["cartpole_attention"])
    pf = make_flash_feature_attention(mod, torch.float32, device="cpu")
    x = torch.from_numpy(_x(24, 5))
    flat = pf(x)
    shaped = pf(x.reshape(4, 6, 5))
    assert shaped.shape == (4, 6, 4)
    torch.testing.assert_close(shaped.reshape(24, 4), flat, atol=1e-6, rtol=0)
    torch.testing.assert_close(pf.plain(x), flat, atol=0, rtol=0)


def _low_bit(t) -> int:
    """Exponent of the lowest set bit among t's nonzero entries."""
    a = t.detach().double().abs().flatten()
    m, e = torch.frexp(a[a > 0])
    mi = (m * 2.0 ** 53).long()
    return int((torch.log2((mi & -mi).double()) + e - 53).min())


class _SumSpans(TorchFunctionMode):
    """For each f32 product or last-axis sum/mean made under it, records the
    bits its terms span: log2(max sum of |terms|) minus the lowest set bit
    among them. Below 24, the f32 sum is exact in any order."""

    def __init__(self):
        super().__init__()
        self.spans = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("__matmul__", "matmul"):
            a, b = args
            if a.count_nonzero() and b.count_nonzero():
                S = float((a.double().abs() @ b.double().abs()).max())
                self.spans.append(np.log2(S) - _low_bit(a) - _low_bit(b))
        elif name in ("sum", "mean") and args[0].dtype == torch.float32:
            x = args[0]
            if x.count_nonzero():
                S = float(x.double().abs().sum(-1).max())
                self.spans.append(np.log2(S) - _low_bit(x))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_exact_stage_inputs_make_every_sum_exact(preset):
    """chip_smoke.py holds each estimator kernel alone against its plain
    stage bit for bit on exact_stage_cases. That is right only if every f32
    sum of the stage is exact in any order: checked here at the preset's
    full widths. And the bf16 roundings must matter there: the same stage
    on f32 copies of the inputs gives another answer."""
    for name, (stage, args, kw) in exact_stage_cases(
            make_model(preset), B=3, seed=0, device="cpu").items():
        plain = ek.STAGES[stage][1]
        mode = _SumSpans()
        with mode:
            got = plain(*args, **kw)
        assert mode.spans and max(mode.spans) < 24, (name, mode.spans)
        up = lambda a: a.float() if isinstance(a, torch.Tensor) else a
        unrounded = plain(*map(up, args), **{k: up(v) for k, v in kw.items()})
        assert not torch.equal(got.float(), unrounded.float()), name


def _untrimmed_plain(w, x, num_heads, state_dim, b_out):
    """forward_plain's stages over all F rows in every layer: the state rows
    are cut out only by the head."""
    scale = 1.0 / (w[0].shape[1] // num_heads) ** 0.5
    h = ek.encode_plain(x, w[0], w[1])
    for i in range(2, len(w), 10):
        ln1, w_qkv, b_qkv, w_o, b_o, ln2, w1, b1, w2, b2 = w[i:i + 10]
        a = ek.attention_plain(ek.gemm_plain(ek.layer_norm_plain(h, ln1), w_qkv, b_qkv),
                               num_heads, scale)
        h = ek.gemm_plain(a, w_o, b_o, res=h)
        f = ek.gemm_plain(ek.layer_norm_plain(h, ln2), w1, b1, relu=True)
        h = ek.gemm_plain(f, w2, b2, res=h)
    return ek.head_plain(h, w[0][4], b_out, state_dim)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_trimmed_plain_equals_untrimmed(preset, cd):
    """forward_plain runs the last layer past its attention on the state
    rows only; every stage is per row and every state query still sees all
    keys, so it equals the untrimmed forward bit for bit (B=3 and B=1)."""
    mod = seeded_weights(make_model(preset, **SMALL[preset]), seed=2)
    w = ek.pack_weights(mod, getattr(torch, cd), "cpu")
    b_out = float(mod.output_layer.bias.detach()[0])
    for B in (3, 1):
        x = torch.from_numpy(_x(B, mod.input_dim, seed=B))
        got = ek.forward_plain(w, x, mod.num_heads, mod.state_dim, b_out)
        want = _untrimmed_plain(w, x, mod.num_heads, mod.state_dim, b_out)
        assert got.shape == (B, mod.state_dim)
        assert torch.equal(got, want), (B, float((got - want).abs().max()))


@pytest.mark.parametrize("F, head_dim, rows", [
    (5, 16, 16), (16, 32, 16), (17, 64, 32), (37, 128, 48), (49, 128, 64), (51, 64, 64),
    (64, 16, 64), (49, 8, 64), (49, 48, 64)])
def test_attention_rows_pad_tokens_to_the_tensor_core_tile(F, head_dim, rows):
    assert ek.attention_rows(F, head_dim) == rows


@pytest.mark.parametrize("F, head_dim", [(65, 128), (49, 12), (49, 136), (0, 16)])
def test_attention_rows_refuses_what_the_bf16_kernel_cannot_take(F, head_dim):
    with pytest.raises(ValueError, match="bf16 attention kernel"):
        ek.attention_rows(F, head_dim)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_scratch_rows_hold_every_stage_output(preset):
    """The forward's buffers hold what the plain stages make at each row
    count: h the (B, F, H) stream plus the (B, state_dim, H) compacted rows,
    y each stage's H-wide output and big its 3H- and 4H-wide ones."""
    mod = make_model(preset, **SMALL[preset])
    F, Sd, H = mod.input_dim, mod.state_dim, mod.hidden_dim
    B = 3
    rows = ek.scratch_rows(B, F, Sd)
    assert rows == {"h": B * F + B * Sd, "y": B * F, "big": B * F}
    w = ek.pack_weights(mod, torch.float32, "cpu")
    sizes = {"H": [], "3H": [], "4H": []}

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if isinstance(out, torch.Tensor) and out.dim() == 3 and out.shape[0] == B:
                for k, n in (("H", H), ("3H", 3 * H), ("4H", 4 * H)):
                    if out.shape[-1] == n:
                        sizes[k].append(out.shape[0] * out.shape[1])
            return out

    with Record():
        ek.forward_plain(w, torch.from_numpy(_x(B, F)), mod.num_heads, Sd, 0.0)
    assert max(sizes["H"]) <= rows["y"] and max(sizes["3H"] + sizes["4H"]) <= rows["big"]
    assert min(sizes["H"]) == B * Sd == rows["h"] - rows["y"]


@pytest.mark.parametrize("mode, state_slice, ego_cols", [
    ("delta", None, None), ("delta", 6, (0, 1)), ("raw", 4, None)])
def test_learned_dynamics_matches_jax(mode, state_slice, ego_cols):
    net, params, mod = _pair("cartpole_attention", state_dim=6, action_dim=3, hidden_dim=32)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(10, 6)).astype(np.float32)
    u = rng.normal(size=(10, 3)).astype(np.float32)
    ref = jax_learned(net.apply, params, mode=mode, state_slice=state_slice,
                      ego_cols=ego_cols)(jnp.asarray(x), jnp.asarray(u), 0)
    xt = torch.from_numpy(x)
    got = make_learned_dynamics(mod, mode=mode, state_slice=state_slice,
                                ego_cols=ego_cols)(xt, torch.from_numpy(u), 0)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(_np(xt), x)      # ego zeroing works on a copy


def test_flat_state_from_physics():
    st = PhysicsState(qpos=torch.arange(3.0), qvel=torch.arange(3.0, 5.0), time=torch.tensor(0.0))
    torch.testing.assert_close(flat_state_from_physics(st), torch.arange(5.0))


_HOME = tuple(np.linspace(-0.5, 0.8, 12))
COSTS = {
    "humanoid": (lambda m: m.humanoid_estimator_costs(), 30, 21),
    "quadruped": (lambda m: m.quadruped_estimator_costs(), 37, 12),
    "humanoid_gait": (lambda m: m.humanoid_gait_estimator_costs(), 61, 21),
    "quadruped_gait": (lambda m: m.quadruped_gait_estimator_costs(_HOME), 75, 12),
    "quadruped_fd_gait": (lambda m: m.quadruped_fd_gait_estimator_costs(_HOME), 39, 12),
}


@pytest.mark.parametrize("name", sorted(COSTS))
def test_estimator_costs_match_jax(name):
    """The JAX costs per sample under vmap; the port's batched over K."""
    make, nx, nu = COSTS[name]
    rng = np.random.default_rng(7)
    x = rng.normal(0, 0.3, size=(16, nx))
    x[:, -1] = rng.uniform(0, 2, 16)   # the augmentation's clock (unused otherwise)
    u = rng.normal(size=(16, nu))
    jrun, jterm = make(jest)
    trun, tterm = make(port_est)
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    ref_r = jax.vmap(jrun, in_axes=(0, 0, None))(jnp.asarray(x), jnp.asarray(u), 3)
    ref_t = jax.vmap(jterm, in_axes=(0, None))(jnp.asarray(x), 5)
    got_r, got_t = trun(xt, ut, 3), tterm(xt, 5)
    assert got_r.shape == got_t.shape == (16,)
    np.testing.assert_allclose(_np(got_r), np.asarray(ref_r), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(_np(got_t), np.asarray(ref_t), rtol=1e-12, atol=1e-9)


def test_fd_time_augmented_matches_jax():
    net, params, mod = _pair("cartpole_attention", state_dim=4, action_dim=2, hidden_dim=32)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    u = rng.normal(size=(6, 2)).astype(np.float32)
    jdyn, jaug = jest.make_fd_time_augmented(jax_learned(net.apply, params), 4, 0.01)
    tdyn, taug = port_est.make_fd_time_augmented(make_learned_dynamics(mod), 4, 0.01)
    xa_j = jax.vmap(lambda r: jaug(r, 0.25))(jnp.asarray(x))
    xa_t = torch.stack([taug(r, 0.25) for r in torch.from_numpy(x)])
    np.testing.assert_allclose(_np(xa_t), np.asarray(xa_j), rtol=0, atol=0)
    ref = jdyn(xa_j, jnp.asarray(u), 0)
    got = tdyn(xa_t, torch.from_numpy(u), 0)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=2e-5, rtol=2e-5)


SLICE = dict(state_dim=6, action_dim=3, hidden_dim=64, num_heads=4, attn_layers=2)


def _jax_sharpened_update(costs, noise):
    w = jax.nn.softmax(-costs / 0.5)
    return jnp.einsum("k,ktu->tu", w, noise), (w, jnp.min(costs))


def _torch_sharpened_update(costs, noise):
    w = torch.softmax(-costs / 0.5, dim=0)
    return torch.einsum("k,ktu->tu", w, noise), (w, costs.min())


def _slice_plans(cd, update_mode, terminal, terminal_scale, update_op=False):
    net, params, mod = _pair("quadruped_attention", seed=2, perturb=False, **SLICE)
    cfg_kw = dict(n_samples=16, horizon=5, temperature=10.0, sigma=0.4,
                  update_mode=update_mode, tail_decay=0.1, terminal_scale=terminal_scale,
                  ctrl_low=(-1.0,) * 3, ctrl_high=(1.0,) * 3)
    jrun, jterm = jest.quadruped_estimator_costs()
    trun, tterm = port_est.quadruped_estimator_costs()
    jf = jax_flash(net, params, compute_dtype=getattr(jnp, cd), block_b=8, interpret=True)
    jplan = jmppi.make_mppi(jax_learned(jf, params, state_slice=6), jrun,
                            jmppi.MPPIConfig(**cfg_kw),
                            terminal_fn=jterm if terminal else None,
                            update_op=_jax_sharpened_update if update_op else None,
                            batched_dynamics=True)
    tf = make_flash_feature_attention(mod, getattr(torch, cd), device="cpu")
    tplan = tmppi.make_mppi(make_learned_dynamics(tf, state_slice=6), trun,
                            tmppi.MPPIConfig(**cfg_kw), terminal_fn=tterm if terminal else None,
                            update_op=_torch_sharpened_update if update_op else None)
    return jplan, tplan


@pytest.mark.parametrize("cd, update_mode, terminal, terminal_scale, update_op", [
    ("float32", "replace", True, 0.0, False),
    ("float32", "accumulate", False, 2.0, False),
    ("float32", "accumulate", True, 0.0, True),
    ("bfloat16", "replace", True, 0.0, False),
])
def test_slice_matches_jax_make_mppi(cd, update_mode, terminal, terminal_scale, update_op):
    """The port's make_mppi over the flash plain version against JAX
    make_mppi(batched_dynamics=True) over the interpret-mode flash kernel,
    with the same injected (K, T, nu) noise, two chained replans (on the
    flax init: with perturbed weights the costs spread so far that one
    sample takes all the weight). `update_op` swaps in a sharper weighting
    on both sides."""
    jplan, tplan = _slice_plans(cd, update_mode, terminal, terminal_scale, update_op)
    rng = np.random.default_rng(9)
    x0 = rng.normal(0, 0.3, size=6).astype(np.float32)
    U0 = rng.normal(0, 0.2, size=(5, 3)).astype(np.float32)
    jms = jmppi.MPPIState(U=jnp.asarray(U0), key=jax.random.PRNGKey(0))
    tms = tmppi.MPPIState(U=torch.from_numpy(U0), generator=torch.Generator())
    tol = dict(atol=2e-5, rtol=2e-5) if cd == "float32" else dict(atol=2e-2, rtol=2e-2)
    noises = (0.4 * rng.normal(size=(2, 16, 5, 3))).astype(np.float32)
    jplan = _strict(jplan, jms, jnp.asarray(x0), jnp.asarray(noises[0]))
    for step, noise in enumerate(noises):
        ja, jms, jd = jplan(jms, jnp.asarray(x0), jnp.asarray(noise))
        ta, tms, td = tplan(tms, torch.from_numpy(x0), noise=torch.from_numpy(noise))
        np.testing.assert_allclose(_np(ta), np.asarray(ja), **tol)
        np.testing.assert_allclose(_np(tms.U), np.asarray(jms.U), **tol)
        for f in ("beta", "mean_cost", "ess", "weight_entropy", "update_norm"):
            np.testing.assert_allclose(float(getattr(td, f)), float(getattr(jd, f)),
                                       err_msg=f"step {step}: {f}", **tol)
        if cd == "bfloat16":
            # a bf16 input rounding turns any difference in U into a flip
            # that T steps amplify, so each bf16 replan starts from one U
            tms = dataclasses.replace(tms, U=torch.from_numpy(np.array(jms.U)))


def test_noise_injection_needs_one_replan_per_step():
    net, params, mod = _pair("cartpole_attention", state_dim=4, action_dim=2, hidden_dim=32)
    run, term = port_est.quadruped_estimator_costs()
    cfg = tmppi.MPPIConfig(n_samples=8, horizon=3, temperature=10.0, sigma=0.4,
                           update_mode="replace", replans_per_step=2)
    plan = tmppi.make_mppi(make_learned_dynamics(mod), run, cfg, terminal_fn=term)
    ms = tmppi.MPPIState.seeded(0, 3, 2, device="cpu")
    x0 = torch.zeros(4)
    with pytest.raises(ValueError, match="replans_per_step=1"):
        plan(ms, x0, noise=torch.zeros(8, 3, 2))
    action, ms2, diag = plan(ms, x0)    # two passes, each with its own draw
    assert action.shape == (2,) and ms2.U.shape == (3, 2)
    assert torch.isfinite(ms2.U).all() and torch.isfinite(diag.ess)
    one = tmppi.make_mppi(make_learned_dynamics(mod), run,
                          dataclasses.replace(cfg, replans_per_step=1), terminal_fn=term)
    assert not torch.equal(one(tmppi.MPPIState.seeded(0, 3, 2, device="cpu"), x0)[1].U,
                           ms2.U)
