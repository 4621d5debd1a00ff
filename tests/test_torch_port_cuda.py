"""PyTorch port: the CUDA kernels (rollout, estimator) against their plain
PyTorch versions, and the coupled plant and collection loop, on the card.
Skips without one.

The card's machine has no jax, and tests/conftest.py imports it, so run
this file there without the conftest and without the xdist options:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

import numpy as np

from chip_smoke import (ATTENTION_TILES, arm5_inputs, arm5_states, attention_tile_check,
                        bf16_errors, cartpole_inputs, exact_stage_cases, go1_inputs,
                        go1_plant_state, hopper_gait_params, hopper_inputs, plant_state,
                        seeded_inputs, seeded_weights)
from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
from humanoid_mppi_rl_tpu_torch.costs.quadruped import GAIT_TUNED
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek
from humanoid_mppi_rl_tpu_torch.ops.kernel_costs import KERNEL_COSTS
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import load_model


@pytest.mark.cuda
@pytest.mark.parametrize("K", [64, 253])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernel_matches_plain_rollout(dtype, K):
    """K=253: the last block of samples is ragged (its spare warps run on
    the last sample's inputs and write nothing)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec, model, *_, cfg = load_task("humanoid_bench", dtype=dtype)
    T = 4
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, T, cost_kwargs=spec.cost_kwargs)
    x = seeded_inputs(model, K, T, dtype, seed=6)
    n0 = rk.launches
    got = ro(*x)
    torch.cuda.synchronize()
    assert rk.launches == n0 + 1
    want = ro.plain(*x)
    if dtype == torch.float64:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    else:
        rel = ((got[0] - want[0]).abs() / want[0].abs()).double()
        assert float(rel.median()) < 1e-3 and float(rel.max()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernel_launches_are_bit_identical(dtype):
    """Every sum in the kernel has one fixed order (no atomics): two launches
    on the same inputs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec, model, *_, cfg = load_task("humanoid_bench", dtype=dtype)
    T = 4
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, T, cost_kwargs=spec.cost_kwargs)
    x = seeded_inputs(model, 253, T, dtype, seed=8)
    first, second = ro(*x), ro(*x)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path():
    """A CUDA input to a rollout built for the CPU raises; it does not run
    the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec, model, *_, cfg = load_task("humanoid_bench", device="cpu")
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, 2, device="cpu")
    with pytest.raises(ValueError, match="built for cpu"):
        ro(*seeded_inputs(model, 8, 2, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_estimator_kernel_matches_plain(dtype):
    """Tolerances as chip_smoke.py's check_estimator: f32 1e-4; bf16 by
    bf16_errors (rounding flips where the f32 sums differ in order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    module = seeded_weights(make_model("quadruped_attention"), seed=5)
    apply = ek.make_flash_feature_attention(module, dtype)
    x = torch.tensor(np.random.default_rng(5).normal(size=(37, 49)),
                     dtype=torch.float32, device="cuda")
    n0 = ek.launches
    got = apply(x)
    torch.cuda.synchronize()
    assert ek.launches == n0 + 1
    want = apply.plain(x)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        e = bf16_errors(got, want)
        assert e["within"], e


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["quadruped_attention", "humanoid_attention"])
def test_cuda_estimator_stages_bit_exact(preset):
    """Each estimator kernel alone equals its plain stage bit for bit on
    inputs whose f32 sums are exact in any order (exact_stage_cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (stage, args, kw) in exact_stage_cases(make_model(preset), B=29, seed=7).items():
        kernel, plain = ek.STAGES[stage]
        assert torch.equal(kernel(*args, **kw), plain(*args, **kw)), name


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_estimator_path():
    """A CUDA input to a flash apply built for the CPU raises; it does not
    run the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    apply = ek.make_flash_feature_attention(make_model("cartpole_attention"), device="cpu")
    with pytest.raises(ValueError, match="built for cpu"):
        apply(torch.zeros(3, 5, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["quadruped_attention", "humanoid_attention",
                                    "cartpole_attention"])
def test_cuda_estimator_last_layer_stages_bit_exact(preset):
    """The last layer's stages on the state rows alone (the out-projection
    with its residual read through the row map, attention for the state
    queries, the head on compacted rows) equal their plain stages bit for
    bit on exact_stage_cases, at a ragged B."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = exact_stage_cases(make_model(preset), B=13, seed=8)
    names = ("gemm_out_residual_state_rows", "attention_state_queries", "head_state_rows")
    for name in names:
        stage, args, kw = cases[name]
        kernel, plain = ek.STAGES[stage]
        assert torch.equal(kernel(*args, **kw), plain(*args, **kw)), name


@pytest.mark.cuda
@pytest.mark.parametrize("preset, dtype", [
    ("quadruped_attention", torch.float32), ("quadruped_attention", torch.bfloat16),
    ("humanoid_attention", torch.float32), ("cartpole_attention", torch.bfloat16)])
def test_cuda_estimator_ragged_batch(preset, dtype):
    """B=61: no tile divides B*F or B*state_dim; the whole forward against
    the plain version at check_estimator's tolerances. humanoid in bf16 is
    held by check_estimator alone (seed 1): over its 7 bf16 layers the
    rounding flips put the median near the bound, and with these weights
    (seed 9) the previous wmma kernel and this one both exceed it (median
    |diff| 0.0147 and 0.0157 against 3e-3 * 3.13 = 0.0094)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    module = seeded_weights(make_model(preset), seed=9)
    apply = ek.make_flash_feature_attention(module, dtype)
    x = torch.tensor(np.random.default_rng(61).normal(size=(61, module.input_dim)),
                     dtype=torch.float32, device="cuda")
    got = apply(x)
    torch.cuda.synchronize()
    want = apply.plain(x)
    assert got.shape == (61, module.state_dim) and torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        e = bf16_errors(got, want)
        assert e["within"], e


@pytest.mark.cuda
@pytest.mark.parametrize("nt, hd", ATTENTION_TILES)
def test_cuda_attention_past_four_query_tiles_matches_plain(nt, hd):
    """Each instantiation of the bf16 attention at 5-8 query tiles (F up to
    128) and each padded head width equals its plain version bit for bit on
    exact inputs, for all queries and the state queries alone, and is
    within the bf16 tolerance on normal inputs (attention_tile_check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = attention_tile_check(nt, hd)
    assert out["F"] == 16 * nt - 3 and out["normal_inputs"]["within"], out


@pytest.mark.cuda
def test_cuda_bf16_apply_refuses_tokens_past_the_attention_tile():
    """The bf16 attention kernel takes F <= 128: a longer token row is
    refused when the apply is built, with the reason; f32 takes any F."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    module = make_model("cartpole_attention", state_dim=124, action_dim=5)
    with pytest.raises(ValueError, match="F=129"):
        ek.make_flash_feature_attention(module, torch.bfloat16)
    ek.make_flash_feature_attention(module, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["free_fall", "sunk", "self_contact"])
def test_cuda_plant_step_matches_cpu(case):
    """One coupled plant step on the card against the same step on the CPU
    in f64: f64 to 1e-9; f32 at the f32 tolerances of
    tests/test_torch_port_plant.py (qpos 1e-5, qvel 3e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model = load_model("humanoid_plant")
    qpos, qvel, ctrl = plant_state(model, case)
    ref_eng = Engine(model, device="cpu", dtype=torch.float64)
    ref = ref_eng.step(ref_eng.forward(torch.tensor(qpos), torch.tensor(qvel)), torch.tensor(ctrl))
    for dtype, atol_q, atol_v in ((torch.float64, 1e-9, 1e-9), (torch.float32, 1e-5, 3e-3)):
        eng = Engine(model, device="cuda", dtype=dtype)
        card = lambda a: torch.tensor(a, dtype=dtype, device="cuda")
        got = eng.step(eng.forward(card(qpos), card(qvel)), card(ctrl))
        torch.testing.assert_close(got.qpos.cpu().double(), ref.qpos, rtol=0, atol=atol_q)
        torch.testing.assert_close(got.qvel.cpu().double(), ref.qvel, rtol=0, atol=atol_v)


@pytest.mark.cuda
def test_cuda_episode_runner_runs():
    """EpisodeRunner.run(max_steps=4) on the card at a small K: one rollout
    kernel launch per control step, finite rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    runner = EpisodeRunner("humanoid_walk", use_kernel=True,
                           mppi_override=dict(n_samples=256, horizon=8))
    n0 = rk.launches
    res = runner.run(max_steps=4, chunk=2)
    states, actions, times = res.logger.arrays()
    assert rk.launches == n0 + 4 and res.steps == 4
    assert states.shape == (4, 55) and np.isfinite(states).all() and np.isfinite(actions).all()
    assert np.isfinite(res.final_qpos).all() and res.sim_time == pytest.approx(0.02)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["go1_collect", "go1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_go1_kernel_matches_plain_rollout(dtype, task):
    """The Go1 through the kernel (frictionloss, box corners, exact cylinder
    rims, the clock) against the plain rollout on go1_inputs (the seven
    poses, start times in [0, 24] s) at a ragged K=61, T=4, with the task's
    clamp; go1_collect with the goal and GAIT_TUNED in the params. Gates of
    chip_smoke.check_rollout; two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec, model, *_, cfg = load_task(task, dtype=dtype)
    kw = dict(spec.cost_kwargs, **(dict(param_goal=True, param_gait=True)
                                   if task == "go1_collect" else {}))
    p = np.zeros(16)
    if task == "go1_collect":
        p[0:2], p[4:13] = (2.0, 0.0), GAIT_TUNED
    T = 4
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, T, ctrl_low=cfg.ctrl_low,
                                 ctrl_high=cfg.ctrl_high, cost_kwargs=kw)
    x = go1_inputs(model, 61, T, dtype, seed=9)
    params = torch.tensor(p, dtype=dtype, device="cuda")
    n0 = rk.launches
    got, again = ro(*x, params=params), ro(*x, params=params)
    torch.cuda.synchronize()
    assert rk.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ro.plain(*x, params=params)
    if dtype == torch.float64:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    else:
        rel = ((got[0] - want[0]).abs() / want[0].abs()).double()
        assert float(rel.median()) < 1e-3 and float(rel.max()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["free_fall", "sunk", "self_contact"])
def test_cuda_go1_plant_step_matches_cpu(case):
    """One Go1 coupled plant step on the card (box corners, cylinder rims
    and self pairs, elliptic blocks, frictionloss rows) against the same
    step on the CPU, f64 to 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model = load_model("go1_plant")
    qpos, qvel, ctrl = go1_plant_state(model, case)
    ref_eng = Engine(model, device="cpu", dtype=torch.float64)
    ref = ref_eng.step(ref_eng.forward(torch.tensor(qpos), torch.tensor(qvel)), torch.tensor(ctrl))
    eng = Engine(model, device="cuda", dtype=torch.float64)
    card = lambda a: torch.tensor(a, dtype=torch.float64, device="cuda")
    got = eng.step(eng.forward(card(qpos), card(qvel)), card(ctrl))
    torch.testing.assert_close(got.qpos.cpu(), ref.qpos, rtol=0, atol=1e-9)
    torch.testing.assert_close(got.qvel.cpu(), ref.qvel, rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu():
    """Three scanned rollout steps (k=8, ego root x/y, clip 1.0) of the
    quad_pipeline surrogate at a narrow width, dropout 0, f32 (TF32 off):
    losses and weights on the card against the CPU's, rtol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from chip_smoke import QUAD_ROLLOUT_K, quad_train_config
    from humanoid_mppi_rl_tpu_torch.learning import train as tr

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = quad_train_config("unused", model_overrides=dict(
            state_dim=19, hidden_dim=64, dropout_rate=0.0))
        rng = np.random.default_rng(0)
        S = np.cumsum(0.01 * rng.normal(size=(96, QUAD_ROLLOUT_K + 1, 19)), axis=1)
        S = (S + rng.normal(size=(96, 1, 19))).astype(np.float32)
        A = rng.normal(size=(96, QUAD_ROLLOUT_K, 12)).astype(np.float32)
        idx = rng.permutation(96)[:3 * 32].reshape(3, 32)
        out = {}
        for dev in ("cpu", "cuda"):
            model, state = tr.create_train_state(cfg, np.zeros((1, 31)), 3, device=dev)
            step, _ = tr.make_scanned_rollout_steps(
                torch.tensor(S, device=dev), torch.tensor(A, device=dev), QUAD_ROLLOUT_K,
                ego_cols=(0, 1))
            losses = []
            for i in range(3):
                state, loss = step(state, torch.tensor(idx[i:i + 1], device=dev),
                                   tr.epoch_generator(0, i, dev))
                losses.append(float(loss))
            out[dev] = (losses, {k: v.cpu() for k, v in model.state_dict().items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    for name, w in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][name], w, rtol=1e-4, atol=1e-6, msg=name)


@pytest.mark.cuda
def test_cuda_estimator_runner_runs():
    """EstimatorRunner with the trained quad_pipeline weights through the
    estimator kernel (K=256, T=4), 3 control steps on the Go1 plant: T
    kernel forwards per step, finite rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from humanoid_mppi_rl_tpu_torch.collect.estimator import (
        ESTIMATOR_CONFIGS, EstimatorRunner, quadruped_fd_gait_estimator_costs)
    from humanoid_mppi_rl_tpu_torch.models.convert import load_trained

    pm = load_model("go1_plant")
    home = dict(pm.keyframes)["home"]
    lo, hi = pm.ctrl_range()
    cfg = dataclasses.replace(ESTIMATOR_CONFIGS["quadruped"], n_samples=256, horizon=4,
                              update_mode="accumulate", sigma=0.18, tail_decay=0.0,
                              ctrl_low=tuple(lo), ctrl_high=tuple(hi))
    runner = EstimatorRunner("go1_collect", load_trained("quad_pipeline_best"), cfg,
                             *quadruped_fd_gait_estimator_costs(home[7:19]),
                             state_fn=lambda plant: plant.qpos, batched_dynamics=True,
                             fd_time_augment=19, ego_cols=(0, 1))
    n0 = ek.launches
    states, actions, times = runner.run(n_steps=3, init_qpos=home, init_plan=home[7:19],
                                        chunk=2).arrays()
    assert ek.launches == n0 + 3 * 4
    assert states.shape == (3, 37) and np.isfinite(states).all() and np.isfinite(actions).all()
    np.testing.assert_allclose(times, [0.0, 0.002, 0.004], atol=1e-6)


@pytest.mark.cuda
def test_cuda_humanoid_estimator_loop_runs():
    """The humanoid closed loop on the trained rollout_k surrogate through
    the estimator kernel (K=256, T=4), 3 control steps on the humanoid
    plant with the FK walking cost: T kernel forwards per step, finite
    rows, the root above 0.7 m."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from humanoid_mppi_rl_tpu_torch.collect.estimator import (
        ESTIMATOR_CONFIGS, EstimatorRunner, humanoid_fk_estimator_costs,
        humanoid_foot_state_fn)
    from humanoid_mppi_rl_tpu_torch.models.convert import load_trained

    pm = load_model("humanoid_plant")
    cfg = dataclasses.replace(ESTIMATOR_CONFIGS["humanoid"], n_samples=256, horizon=4)
    runner = EstimatorRunner("humanoid_collect", load_trained("rollout_k_surrogate_best"), cfg,
                             *humanoid_fk_estimator_costs(pm),
                             state_fn=humanoid_foot_state_fn(pm), batched_dynamics=True,
                             fd_time_augment=30)
    n0 = ek.launches
    states, actions, times = runner.run(n_steps=3, chunk=2).arrays()
    assert ek.launches == n0 + 3 * 4
    assert states.shape == (3, 55) and actions.shape == (3, 21)
    assert np.isfinite(states).all() and np.isfinite(actions).all()
    assert states[:, 2].min() >= 0.7
    np.testing.assert_allclose(times, [0.0, 0.005, 0.01], atol=1e-6)


@pytest.mark.cuda
def test_cuda_collect_humanoid_jl_runs(tmp_path):
    """collect_humanoid_jl at the task's K=75, T=100 for 20 control steps
    on the card: one rollout launch per step, 55 / 21 / 1 columns saved."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import os

    from humanoid_mppi_rl_tpu_torch.collect.runner import collect_humanoid_jl
    from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv

    n0 = rk.launches
    out = collect_humanoid_jl(n_episodes=1, out_dir=str(tmp_path), max_steps=20, chunk=10)
    assert out == [(0, 20)] and rk.launches == n0 + 20
    (run,) = os.listdir(tmp_path)
    cols = {k: read_csv(os.path.join(tmp_path, run, f"{k}.csv")).reshape(20, -1).shape[1]
            for k in ("states", "actions", "times")}
    assert cols == {"states": 55, "actions": 21, "times": 1}
    assert np.isfinite(read_csv(os.path.join(tmp_path, run, "states.csv"))).all()


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["cartpole", "hopper"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_small_robot_kernel_matches_plain_rollout(dtype, robot):
    """The cartpole (slide joint past its limit) and the hopper (param_gait,
    the check's params, t0 in [0.3, 10] s) through the kernel against the
    plain rollout at K=256, T=4: the gates of chip_smoke.check_rollout; two
    launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec, model, *_, cfg = load_task(robot, dtype=dtype)
    kw, inputs = (({}, cartpole_inputs) if robot == "cartpole"
                  else (dict(param_gait=True), hopper_inputs))
    T = 4
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, T, cost_kwargs=kw)
    x = inputs(model, 256, T, dtype, seed=9)
    params = torch.tensor(hopper_gait_params(), dtype=dtype, device="cuda")
    n0 = rk.launches
    got, again = ro(*x, params=params), ro(*x, params=params)
    torch.cuda.synchronize()
    assert rk.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ro.plain(*x, params=params)
    if dtype == torch.float64:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    else:
        rel = ((got[0] - want[0]).abs() / want[0].abs()).double()
        assert float(rel.median()) < 1e-3 and float(rel.max()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("task, K, H, ncol", [("cartpole", 256, 100, 4),
                                              ("hopper", 4096, 100, 14)])
def test_cuda_small_robot_runs(task, K, H, ncol):
    """20 control steps of EpisodeRunner(task, use_kernel=True) on the card
    at main_cartpole's and main_hopper's K and H: one rollout launch a
    step, finite rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    runner = EpisodeRunner(task, use_kernel=True, mppi_override=dict(n_samples=K, horizon=H))
    n0 = rk.launches
    res = runner.run(max_steps=20, chunk=10)
    states, actions, _ = res.logger.arrays()
    assert rk.launches == n0 + 20 and res.steps == 20
    assert states.shape == (20, ncol) and np.isfinite(states).all() and np.isfinite(actions).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 253])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cost, kw", [("humanoid_v1", {"step_period": 4}), ("humanoid_v1", {}),
                                      ("humanoid_hard", {})],
                         ids=["v1_period4", "v1_period100", "hard"])
def test_cuda_humanoid_costs_match_plain_rollout(cost, kw, dtype, K):
    """humanoid_v1 (both swing sides in T=8 at step period 4) and
    humanoid_hard (humanoid_hard_inputs: every branch both ways) in the
    rollout kernel against its plain version, the gates of chip_smoke's
    `check`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from chip_smoke import humanoid_hard_inputs

    model = load_model("humanoid")
    T = 8 if cost == "humanoid_v1" else 4
    inputs = humanoid_hard_inputs if cost == "humanoid_hard" else seeded_inputs
    ro = rk.build_rollout_kernel(model, KERNEL_COSTS[cost], T, cost_kwargs=kw)
    x = inputs(model, K, T, dtype, seed=9)
    got, again = ro(*x), ro(*x)
    want = ro.plain(*x)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if dtype == torch.float64:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    else:
        # humanoid_hard's values cross zero (its -1000 x swing-foot velocity
        # term): its 0.99 quantile stands in for the max (chip_smoke's
        # HARD_F32_QUANTILE)
        rel = ((got[0] - want[0]).abs() / want[0].abs()).double()
        q = 0.99 if cost == "humanoid_hard" else 1.0
        assert float(rel.median()) < 1e-3 and float(torch.quantile(rel, q)) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("robot", ["humanoid", "go1"])
def test_cuda_penalty_step_matches_cpu(robot):
    """The batched penalty step on the card against the CPU in f64: feet in
    the floor, random joint velocities and controls, K=64, three steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model = load_model(robot)
    x = (go1_inputs if robot == "go1" else seeded_inputs)(model, 64, 3, torch.float64, seed=10,
                                                         device="cpu")
    qpos, qvel, noise = x[0].T.contiguous(), x[1].T.contiguous(), x[4]
    out = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(model, dev, torch.float64)
        st = eng.forward(qpos.to(dev), qvel.to(dev), torch.zeros(64, dtype=torch.float64,
                                                                  device=dev))
        for t in range(3):
            st = eng.step(st, noise[t].T.contiguous().to(dev), solver="penalty")
        out[dev] = st
    torch.testing.assert_close(out["cuda"].qpos.cpu(), out["cpu"].qpos, rtol=0, atol=1e-10)
    torch.testing.assert_close(out["cuda"].qvel.cpu(), out["cpu"].qvel, rtol=0, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("task, use_kernel", [("humanoid", True), ("humanoid_hard", True),
                                              ("humanoid_collect", False)])
def test_cuda_humanoid_tasks_run(task, use_kernel):
    """Short runs at small K of the new tasks on the kernel planner and of
    the array planner (make_mppi over the penalty engine): finite rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    runner = EpisodeRunner(task, use_kernel=use_kernel,
                           mppi_override=dict(n_samples=32, horizon=8))
    n0 = rk.launches
    res = runner.run(max_steps=3, chunk=3)
    states, actions, _ = res.logger.arrays()
    assert states.shape == (3, 55) and np.isfinite(states).all() and np.isfinite(actions).all()
    assert rk.launches - n0 == (3 if use_kernel else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [61, 256])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_arm5_kernel_matches_plain_rollout(dtype, K):
    """arm5 through the kernel (ball joints, springs and the shoulder limit,
    ball and free motors, every mesh vertex a contact point) against the
    plain rollout on arm5_inputs, T=4: f64 rtol 1e-9; f32 cost relative
    median < 1e-3, max < 1e-2; two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec, model, *_ = load_task("arm5_reach", dtype=dtype)
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, 4)
    x = arm5_inputs(model, K, 4, dtype, seed=12)
    got = ro(*x)
    assert all(torch.equal(a, b) for a, b in zip(got, ro(*x)))
    want = ro.plain(*x)
    if dtype == torch.float64:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    else:
        rel = ((got[0] - want[0]).abs() / want[0].abs()).double()
        assert float(rel.median()) < 1e-3 and float(rel.max()) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["coupled", "penalty"])
def test_cuda_arm5_steps_match_cpu(solver):
    """arm5's coupled plant step (one sample, each pose in turn) and penalty
    step (K=10 at once, the planner model) on the card against the CPU in
    f64, three steps: the mesh rows' ranking, the ball terms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model = load_model("arm5_plant" if solver == "coupled" else "arm5")
    qpos, qvel = (torch.tensor(a) for a in arm5_states(model, 10, seed=13))
    ctrl = torch.tensor(np.random.default_rng(14).uniform(-3, 3, (10, model.nu)))
    samples = [(qpos[:, k], qvel[:, k], ctrl[k]) for k in range(10)] if solver == "coupled" \
        else [(qpos.T.contiguous(), qvel.T.contiguous(), ctrl)]
    for qp, qv, u in samples:
        out = {}
        for dev in ("cpu", "cuda"):
            eng = Engine(model, dev, torch.float64)
            st = eng.forward(qp.to(dev), qv.to(dev),
                             torch.zeros(qp.shape[:-1], dtype=torch.float64, device=dev))
            for _ in range(3):
                st = eng.step(st, u.to(dev), solver=solver)
            out[dev] = st
        torch.testing.assert_close(out["cuda"].qpos.cpu(), out["cpu"].qpos, rtol=0, atol=1e-10)
        torch.testing.assert_close(out["cuda"].qvel.cpu(), out["cpu"].qvel, rtol=0, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "array"])
def test_cuda_arm5_reach_runs(use_kernel):
    """arm5_reach at small K on both planners: finite rows, one launch a
    control step on the kernel planner, none on the array planner."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    runner = EpisodeRunner("arm5_reach", use_kernel=use_kernel,
                           mppi_override=dict(n_samples=32, horizon=8))
    n0 = rk.launches
    res = runner.run(max_steps=3, chunk=3)
    states, actions, _ = res.logger.arrays()
    assert states.shape == (3, 29) and np.isfinite(states).all() and np.isfinite(actions).all()
    assert rk.launches - n0 == (3 if use_kernel else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mlp_batchnorm", "cross"])
def test_cuda_mlp_and_cross_surrogates_match_cpu(family):
    """The MLP (BatchNorm in eval mode on seeded running statistics) and the
    humanoid_cross model on the card against the CPU, f32 with TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from humanoid_mppi_rl_tpu_torch.models.predictors import MLPStatePredictor

    torch.manual_seed(0)
    if family == "cross":
        mod = make_model("humanoid_cross")
    else:
        mod = MLPStatePredictor(55, 21, 128, 2, use_batch_norm=True).eval()
        for bn in (m for m in mod.modules() if isinstance(m, torch.nn.BatchNorm1d)):
            bn.running_mean.normal_()
            bn.running_var.uniform_(0.5, 2.0)
    x = torch.randn(2048, mod.input_dim, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = mod(x)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            got = mod.cuda()(x.cuda()).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_cli_run_plans_on_the_rollout_kernel(tmp_path):
    """`run --kernel` on the card: one rollout launch per executed control
    step (a chunk of 50 runs whole), finite rows; `replay` of those rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from humanoid_mppi_rl_tpu_torch import cli
    from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv

    n0 = rk.launches
    assert cli.main(["run", "--task", "cartpole", "--kernel", "--steps", "5",
                     "--out", str(tmp_path / "run")]) == 0
    assert rk.launches - n0 == 50
    states = read_csv(str(tmp_path / "run" / "states.csv"))
    assert states.shape == (5, 4) and np.isfinite(states).all()
    assert cli.main(["replay", "--states", str(tmp_path / "run" / "states.csv"),
                     "--asset", "cartpole.xml"]) == 0


@pytest.mark.cuda
def test_cuda_one_rank_nccl_sharded_replan_equals_make_kernel_mppi():
    """make_sharded_kernel_mppi in a one-rank NCCL group at humanoid_bench
    (K=8192, H=64, f32) on the same injected noise as make_kernel_mppi:
    bit-identical action and plan, one rollout launch per replan."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch.distributed as dist

    from chip_smoke import _free_port
    from humanoid_mppi_rl_tpu_torch.parallel.mesh import make_mesh, make_sharded_kernel_mppi
    from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
    from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        spec, model, _, _, _, init, cfg = load_task("humanoid_bench")
        noise = cfg.sigma * torch.randn((cfg.T, model.nu, cfg.K), device="cuda",
                                        generator=torch.Generator("cuda").manual_seed(2))
        plan_s = make_sharded_kernel_mppi(model, spec.kernel_cost_factory, cfg, make_mesh(1),
                                          spec.cost_kwargs)
        plan_1 = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, spec.cost_kwargs)
        n0 = rk.launches
        a_s, st_s, _ = plan_s(MPPIState.seeded(0, cfg.T, model.nu), init, noise=noise)
        torch.cuda.synchronize()
        assert rk.launches == n0 + 1
        a_1, st_1, _ = plan_1(MPPIState.seeded(0, cfg.T, model.nu), init, noise=noise)
        assert torch.equal(a_s, a_1) and torch.equal(st_s.U, st_1.U)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_humanoid_lqr_stands_on_one_leg():
    """tests/test_lqr.py:64 on the card in float64: make_humanoid_lqr (101
    heights here; chip_smoke main_lqr sweeps 2,001), the spectral gates,
    and 200 controlled coupled steps within |z - z0| < 0.08, max |qvel| <
    0.5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from humanoid_mppi_rl_tpu_torch.solver.lqr import make_humanoid_lqr

    eng = Engine(load_model("humanoid"), "cuda", torch.float64)
    controller, d = make_humanoid_lqr(eng, n_heights=101)
    A, B, K = (m.cpu().numpy() for m in d["mats"])
    assert np.abs(np.linalg.eigvals(A)).max() > 1.01
    assert np.abs(np.linalg.eigvals(A - B @ K)).max() < 1.001
    st = eng.forward(torch.tensor(d["qpos0"], dtype=torch.float64, device="cuda"),
                     torch.zeros(eng.model.nv, dtype=torch.float64, device="cuda"))
    for _ in range(200):
        st = eng.step(st, controller(st))
    assert abs(float(st.qpos[2]) - float(d["qpos0"][2])) < 0.08
    assert float(st.qvel.abs().max()) < 0.5
