"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (with its own `seconds`):
  device  -- requires CUDA; prints the card's name and power limit
  build   -- nvcc-builds every kernel of the port from csrc/ (one nvcc per
             source, all started together), one line per source with the
             ptxas register/stack/spill/shared-memory lines and the count of
             HGMMA (wgmma) instructions in its SASS, which must be > 0 for
             the estimator library ("not available" without cuobjdump)
  check   -- the rollout kernel against its plain PyTorch version on the
             card (humanoid_bench model and cost, T=4, seeded inputs, K=256
             and the ragged K=253): f64 to rtol 1e-9; f32 median relative
             cost error < 1e-3, max < 1e-2; two launches on the same inputs
             bit-identical; the launch geometry (lanes per sample, samples
             per block, shared memory, samples resident per SM); and the
             kernel body's f32 sin/cos against sinf/cosf bit for bit on
             every float with |x| < 105615 (profiling build)
  main    -- slice 1 at full width: load_task("humanoid_bench") (K=8192,
             H=64, f32) + make_kernel_mppi, 2 warm-up and 20 timed chained
             replans; finite outputs, one kernel launch per replan; then
             one replan under torch.profiler (device busy share, device ms
             by kernel)
  time    -- the rollout kernel alone at the main path's shapes beside its
             plain version (outputs compared too: f32 cost rel median
             < 1e-3) and its bound; its K sweep (2048 .. 32768), geometry
             and ptxas registers/stack/spills; the occupancy sweep (one
             block of S samples per SM) and the time by phase of the step
             from the profiling build, at K=8192 and with one sample per SM
  main_collect -- slice 5 at full width: EpisodeRunner("humanoid_walk",
             use_kernel=True) (K=8192, H=64, f32) planning with the rollout
             kernel and stepping the coupled plant (array engine, floor and
             self contacts, Newton solver; eager PyTorch on the card): the
             rollout kernel against its plain version with the walk cost and
             a runtime goal (K=256 and 253, T=4: the gates of `check`); a
             warm-up run(max_steps=10, chunk=10) and a timed run(max_steps=
             20, chunk=20) (bench.py::_bench_collect's protocol at a cut
             depth: steps/s, control step ms); then 10 control steps one at a time, CUDA
             events around the plan and around the plant step (Newton
             iterations and constraint rows read after), one plant step
             under torch.profiler (device launches) and one control step
             (busy share); one plant step under
             torch.cuda.set_sync_debug_mode("error") (no host sync);
             one collect_humanoid episode (one chunk of 10, saved into a
             temporary directory; goal threshold opened to 1e9 so the goal
             gate saves it). Checks: one rollout launch per control
             step, every logged row finite, root height qpos[2] >= 0.7 over
             the 30 steps (scripts/dev_seed_evidence.py's fall rule), CSVs
             of 57 / 21 / 1 columns
  check_go1 -- slice 6: the rollout kernel against its plain version on the
             Go1 (go1.json: frictionloss, box corners, exact cylinder rims,
             140 contact points), both costs -- quadruped (go1_collect's,
             the goal and GAIT_TUNED in the params, the ctrlrange clamp) and
             quadruped_jl (go1's, the +-10 clamp) -- on go1_inputs (seven
             poses that switch on every new term, start times in [0, 24] s)
             at K=256 and 253, T=4: the gates of `check`
  main_go1 -- go1_collect at quad_pipeline's operating point (K=4096,
             H=32, f32, GAIT_TUNED, goal (2, 0)): 2 warm-up and 20 timed
             chained replans, one launch per replan, one profiled replan;
             go1 (quadruped_jl) the same with 10 timed; the kernel alone at
             K=4096 and 8192 (T=32) beside its bound from ops_per_rollout,
             and the plain version at K=4096
  main_quad_collect -- EpisodeRunner("go1_collect", use_kernel=True) at
             K=4096, H=32 with GAIT_TUNED and goal (2, 0) on the Go1 plant
             (go1_plant.json: 697 candidate pairs): 2 warm-up + 40 timed
             control steps, each run in one chunk; 2 steps split into plan and
             plant ms (CUDA events, Newton iterations, active rows); the
             device launches of one plant step; one plant step under
             set_sync_debug_mode("error"); every logged row finite and the
             trunk height >= 0.08 (the fall line) over the 42 steps; one
             collect_quadruped run in one chunk of 2 (goal tolerance opened
             to 1e9 so that its gate saves) read back: 37 / 12 / 1 columns
  check_estimator -- the estimator kernel against its plain version on the
             card, seeded weights with nonzero biases and LayerNorm terms,
             presets quadruped/humanoid/cartpole_attention at B=64 and 61:
             f32 to rtol=atol=1e-4; bf16 median |diff| <= 3e-3 and max
             |diff| <= 3e-2, each times max(1, max|y|) (TF32 and reduced-
             precision bf16 reductions off in the plain version's products);
             then each of its kernels alone (encode, LayerNorm, the four
             GEMM epilogues and the last layer's out-projection on the
             compacted state rows, attention over all queries and over the
             state queries, the head on full and on compacted rows) at each
             preset's widths, B=61, on inputs whose sums are exact in any
             order: bf16 bit for bit
  main_estimator -- slice 2 at full width: quadruped_attention (bf16) +
             make_learned_dynamics + quadruped_estimator_costs + make_mppi
             with ESTIMATOR_CONFIGS["quadruped"] (K=2048, T=50), 2 warm-up
             and 10 timed chained replans; finite outputs, T kernel
             forwards per replan
  time_estimator -- one forward alone at B=2048 and at B=65536 beside the
             plain version (outputs compared, bf16 tolerance above), its
             bound, and one PyTorch TransformerEncoder forward of the same
             weights as a yardstick (`library_ms`; the port never calls it);
             at B=2048 also each kernel alone at the forward's shapes
             (`stages`: each GEMM's ms and TFLOP/s, attention's and
             LayerNorm's ms and GB/s)
  train   -- slice 7, scripts/quad_pipeline.py's train stage at full width
             (PRESET_CONFIGS["quadruped"] + quad_train_config: the qpos
             surrogate, F=31, H=512, 4 heads, 2 layers, f32, TF32 off;
             rollout_k=8, clip 1.0, ego root x/y, scanned epochs, batch 64,
             Adam 1e-4 cosine to 1e-6): (a) train_model on main_quad_collect's
             45 logged rows (10 epochs, batch 16 and eval split 0.5 so that
             one full train and one full eval batch exist): every loss finite, the last eval loss below the
             first, the best/periodic/final checkpoints and state_last
             written, model_final's forward equal to the trained module's;
             (b) on a seeded linear-plant dataset of quad_data_goal's shape
             (16 runs, 42,597 pairs): 100 single-step epochs timed by CUDA
             events (ms per step, pairs/s, projected epoch), one 100-step
             scanned epoch (peak memory), a profiled 10-step epoch (busy
             share), the host syncs of one epoch (set_sync_debug_mode
             "warn": 1 expected) and one step under "error"
  check_estimator_trained -- the estimator kernel against its plain
             version on each set of trained weights at its loop's inputs,
             B=2048 and 253, f32 and bf16, the gates of check_estimator:
             quad_pipeline (assets/quad_pipeline_best.pt, F=31, home-pose
             inputs) and the humanoid's rollout_k surrogate
             (assets/rollout_k_surrogate_best.pt, humanoid_attention, F=51:
             perturbed plant poses with their FK foot heights, controls of
             sigma 0.4)
  main_estimator_loop -- quad_pipeline's estimator stage: EstimatorRunner
             on go1_collect's coupled plant, planning on the trained
             surrogate through the estimator kernel (bf16) at K=2048, T=32,
             accumulate update, sigma 0.18, the ctrlrange clamp, the FD gait
             cost, from `home` with the plan seeded at home: 2 warm-up and 2
             timed control steps (T forwards each), 1 split into plan and
             plant ms by CUDA events, one profiled control step (launches by
             kernel, busy share); every row finite, trunk z >= 0.08 m, the
             progress beside the JAX record
  main_humanoid_estimator_loop -- scripts/dev_estimator_walk.py --configs
             fk: EstimatorRunner on humanoid_collect's coupled plant (f32),
             planning on the trained rollout_k surrogate through the
             estimator kernel (bf16) at ESTIMATOR_CONFIGS["humanoid"] with
             T=25 (K=2048, replace update, sigma 0.4), the walking cost on
             the batched FK of the predicted qpos (f32), state [qpos; foot
             z]: 3 warm-up and 3 timed control steps, 3 split into plan
             and plant ms by CUDA events, one profiled control step (busy
             share, device launches by kernel) and the device launches of
             one replan (those outside the estimator kernel); T forwards per
             step, every row finite (55 / 21 columns), root z >= 0.7 m over
             every step, the progress beside the JAX record
  time_estimator also times the humanoid loop's forward alone (the trained
             rollout_k surrogate at B=2048, bf16) with its bound and library
  check_cartpole, check_hopper -- slice 9: the rollout kernel against its
             plain version at the gates of `check` (K=256 and 253, T=4) on
             the cartpole (slide joint; cartpole_inputs puts the cart past
             the slider's +-1 limit) and the planar hopper (slide, slide and
             hinge on one body; hopper_inputs: four poses with the foot in
             the floor, crouched, falling and in the air), the hopper with
             param_gait (HOP_GAIT in slots 4-9, t0 in [0.3, 10] s): each
             gait term (landing, knee anchor, hop clock) nonzero somewhere
  main_cartpole -- the swing-up of tests/test_e2e_cartpole.py:
             EpisodeRunner("cartpole", use_kernel=True) at K=256, T=100,
             f32, 400 control steps from (0, pi): one launch a step, mean
             |theta| < 0.15 over the last 40 steps and |x| < 0.5 at the end;
             5 steps split into replan and plant ms, the plant step's
             device launches, one profiled control step; the kernel alone
             beside its plain version and its bound
  main_hopper -- EpisodeRunner("hopper", use_kernel=True) at K=4096,
             H=100 (artifacts/hopper_k4096.npz's): 3 warm-up and 10 timed
             control steps (3 split), one launch a step, finite rows; the split, the
             kernel alone, torso z minimum and x progress as main_cartpole
  main_cartpole_pipeline -- two cartpole_collect episodes (K=75, T=100)
             of 100 steps written as CSV, PRESET_CONFIGS["cartpole"] trained
             on them for 10 epochs (eval loss falls), the trained weights at
             check_estimator_trained's gates (B=2048 and 253) and timed as
             time_estimator does, then EstimatorRunner("cartpole", ...,
             batched_dynamics=True) at ESTIMATOR_CONFIGS["cartpole"] (K=2048,
             T=100, bf16): 3 warm-up and 10 timed control steps, T forwards
             a step, 5 split into plan and plant ms, one profiled step and
             the replan's device launches outside the estimator kernel
  check_humanoid_costs -- slice 10: the rollout kernel with humanoid_v1
             (step periods 4 and 100, T=8: both swing sides inside the
             rollout at period 4, the terminal at the horizon) and
             humanoid_hard (humanoid_hard_inputs: lifted, spread and crossed
             legs, every branch of the cost taken and left at the start and
             at the end) against its plain version at K=256 and 253, the
             gates of `check` (humanoid_hard in f32: its 0.99 quantile in
             place of the max, HARD_F32_QUANTILE, with the plain version's
             own f32 error beside it); then the array planner's rollouts
             (rollout_costs_batched over the penalty engine, the kernel's
             cost on the engine's states) against the kernel's costs on the
             same noise, f64, K=256, T=16, rtol 1e-8, for humanoid_collect,
             humanoid and humanoid_hard
  main_humanoid -- the tasks humanoid (K=50, T=100) and humanoid_hard
             (K=30, T=75) through EpisodeRunner(use_kernel=True), f32, from
             qpos0, 12 and 8 control steps: one launch a step, finite
             55-column rows, root height; 3 steps split into replan and
             plant ms (CUDA events); each humanoid cost's kernel time at
             K=8192, T=64 (humanoid, humanoid_v1, humanoid_hard) with its
             bound, and the new costs' kernel beside their plain version at
             K=8192, T=8 (cost rel median < 1e-3)
  main_array_planner -- EpisodeRunner("humanoid_collect", use_kernel=False)
             at K=50, T=100, f32: make_mppi over the penalty engine batched
             over K (the JAX package's default planner), 1 warm-up and 1
             timed control step (replan and plant ms by CUDA events), one
             replan traced on the device only (launches, busy share), the
             PyTorch dispatches of one (count_dispatches), one replan under
             torch.cuda.set_sync_debug_mode("error"); no rollout-kernel
             launch (the path has no hand-written kernel, as JAX's has no
             Pallas one)
  main_v2py -- collect_humanoid_v2py at K=30, T=75, two replans a control
             step, 3 steps, saved into a temporary directory and read back:
             56 / 21 / 1 columns, the first row's FD velocity zero; the
             PyTorch dispatches of one control step's plan (count_dispatches)
  check_arm5 -- slice 11: the rollout kernel against its plain version on
             arm5 (the arm5 cost; arm5_inputs: the crate in the air, the
             shoulder past its 70 deg limit, the crate resting with a few
             vertices in the floor and face down with six, both ball
             springs loaded with the elbow past its limit; every motor
             driven) at the gates of `check` (K=256 and 253, T=4), each term
             switched on in some sample; then the transmission models
             (assets/site_act_plant.json: three site motors;
             assets/tendon_act_plant.json: a motor and a servo on fixed
             tendons) the same way with the cartpole cost
  time_arm5 -- the kernel alone with the arm5 cost at the task's K=64 and
             at K=8192, T=40, f32, beside its plain version and its bound;
             geometry, ptxas registers/stack/spills, the occupancy sweep and
             the step's cycles by phase
  main_arm5 -- arm5_reach through EpisodeRunner(use_kernel=True) (K=64,
             T=40, f32) for 12 control steps from qpos0: one launch a step,
             finite rows, the hand's distance to the target at the start and
             the end; 5 steps split into plan and plant ms (CUDA events),
             the plant step's device launches, one profiled control step,
             one plant step under set_sync_debug_mode("error")
  main_arm5_array -- arm5_reach on the array planner (use_kernel=False):
             1 warm-up and 1 timed replan, launches and busy share of one
             replan traced on the device, one replan under
             set_sync_debug_mode("error"), no rollout-kernel launch
  main_cli -- the command line (cli.main in process): tasks; run
             humanoid_bench --kernel (K=8192, H=64) for 20 logged steps, one
             rollout-kernel launch per executed control step (a chunk of 50
             runs whole); collect humanoid_walk --kernel; profile
             humanoid_bench --kernel (replan ms beside main's); run
             cartpole_collect on the default (array) planner for one chunk
             of 50 steps, no rollout-kernel launch -> train 2 epochs ->
             estimate on that checkpoint for 5 steps; estimate quadruped 1
             step; replay of the humanoid run; warm; bench refuses
  main_lqr -- slice 13, solver/lqr on the card in float64: the cartpole
             held upright from (0.1, 0.15) for 400 coupled steps (|theta| <
             0.02, |x| < 0.1: tests/test_lqr.py's gate, the K from
             make_lqr_controller's exact linearization and DARE); then
             make_humanoid_lqr on the one-leg stand with the full 2,001-height
             sweep, the spectral radius of A (> 1.01) and of A - BK (<
             1.001), and 200 controlled coupled steps (|z - z0| < 0.08, max
             |qvel| < 0.5); the gated steps end each Newton solve at
             convergence (early_exit, the masked loop's bits), then 4 more
             on the default path; seconds of the sweep, the balance Q, the
             linearization and DARE, ms of a controlled step each way
  check_sharded -- parallel/mesh in a one-rank NCCL group: the sharded
             kernel planner at humanoid_bench (K=8192, H=64, f32) against
             make_kernel_mppi on the same injected noise and with
             noise_block=1024 (bit-identical), the sharded array planner
             (humanoid_collect, K=50, T=8) against make_mppi on the same
             noise (bit-identical expected, gate 1e-6 relative), the blocked
             field drawn whole and in four slices (equal), then 20 sharded
             replans (one rollout launch each) timed in turns with 20
             unsharded ones
  main_coupled -- slice 14, planning on the coupled tier, the mesh pairs
             and coupled_pgs. f64 card against CPU (the Newton loop's early
             exit, the masked loop's bits): one cartpole replan at K=30,
             T=100 and one Go1 replan at K=8, H=5 on the coupled planner
             (action max |diff| < 1e-9); 5 coupled steps of each mesh
             snapshot from a contact state and one penalty step of each
             over K=256; 3 coupled_pgs steps of the cartpole, hopper and
             humanoid plants and one hopper step over K=64 (qpos 1e-10,
             qvel 1e-8). f32, the default masked path:
             EpisodeRunner("hopper", planner_solver="coupled") at K=4096,
             H=50 (scripts/dev_hopper.py's), 1 warm-up and 2 timed control
             steps, and one cartpole replan at K=30, T=100: replan and
             plant ms, one rollout step's device launches and busy share
             (profiler) and host syncs (sync debug mode "error"), then one
             replan with the early exit (its ms and the Newton iterations
             of each rollout step, the largest over K)
then a `kernels` line, the nvidia-smi line, and the final status line.
Any failed check raises, and the script exits non-zero without the status
line. It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
from concurrent.futures import ThreadPoolExecutor
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): device memory rate, f32 rate outside
# the tensor cores, dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
CHECK_KS, CHECK_T = (256, 253), 4   # 253: a ragged last block
WARMUP, TIMED = 2, 20
EST_WARMUP, EST_TIMED = 2, 10
EST_PRESETS = ("quadruped_attention", "humanoid_attention", "cartpole_attention")
EST_CHECK_B = (64, 61)
EST_TIME_B = (2048, 65536)
EST_PLAIN_CHUNK = 8192   # the plain forward at B=65536 runs in sample chunks (memory)
SWEEP_K = (2048, 4096, 8192, 16384, 32768)   # rollout kernel alone, T = the main path's H
COLLECT_TASK = "humanoid_walk"
# bench.py::_bench_collect's chunk of 50; its 50 warm-up and 100 timed
# control steps cut to 10 (in one chunk of 10) and 20 in one chunk of 20
# for the run time (50 in one chunk of 50 before main_coupled came)
COLLECT_WARMUP, COLLECT_TIMED, COLLECT_CHUNK = 10, 20, 20
# main_collect's depth, cut to leave the run time for the later phases:
# 10 control steps split into plan and plant (20 before), collect_humanoid
# in one chunk of 10 (50 before)
COLLECT_SPLIT_STEPS, HUM_COLLECT_CHUNK = 10, 10
FALL_Z = 0.7   # scripts/dev_seed_evidence.py:53
# the Go1 at scripts/quad_pipeline.py's operating point (collect_quadruped
# with use_kernel=True, K=4096, H=32, GAIT_TUNED, goals at (2 + i mod 3, 0))
GO1_K, GO1_H = 4096, 32
GO1_GOAL = (2.0, 0.0)
GO1_FALL_Z = 0.08   # collect_quadruped's fall line
GO1_JL_TIMED = 10   # timed replans of the go1 (quadruped_jl) task
GO1_TIME_K = (4096, 8192)   # the rollout kernel alone, T = GO1_H
# main_quad_collect's depth, cut to leave the run time for the later
# phases: 2 control steps split into plan and plant (20, 10, then 5
# before), collect_quadruped in one chunk of 2 (50, 10, then 5 before)
GO1_SPLIT_STEPS, GO1_COLLECT_CHUNK = 2, 2
# its logged control steps, each run in one chunk: 2 warm-up and 40 timed
# (50 and 100 in chunks of 50, then 5 and 40 before; a Go1 plant step
# takes 1.5-2 s on the card); the train chain's batch is cut to match
# (CHAIN_BATCH), and its 32 windows need the 40 timed rows
QUAD_WARMUP, QUAD_TIMED = 2, 40


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sass_count(library, opcode: str):
    """Lines of the library's SASS (`cuobjdump --dump-sass`) holding opcode,
    or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump")
    if tool is None:
        cand = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
        tool = cand if os.path.exists(cand) else None
    if tool is None:
        return None
    sass = subprocess.run([tool, "--dump-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return sum(opcode in ln for ln in sass.splitlines())


def ptxas_stats(log: str) -> dict:
    """{entry function: registers, stack frame, spill stores/loads, static
    shared memory} from nvcc's `-Xptxas -v` output."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_store_bytes", r"(\d+) bytes spill stores"),
                         ("spill_load_bytes", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pat, ln)
            if m:
                out[name][key] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def cuda_ms(fn, n: int) -> float:
    """Mean device time of fn() over n back-to-back calls (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def seeded_inputs(model, K, T, dtype, seed=0, device="cuda"):
    """Perturbed standing states sunk 0.25 m so the feet are in contact,
    random velocities, plan and noise: numpy, from a seed."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(model.qpos0[:, None], (1, K)) + rng.normal(0, 0.05, (model.nq, K))
    qpos[2] -= 0.25
    qpos[3:7] /= np.linalg.norm(qpos[3:7], axis=0)
    qvel = rng.normal(0, 0.3, (model.nv, K))
    U = rng.normal(0, 0.3, (T, model.nu))
    noise = rng.normal(0, 0.5, (T, model.nu, K))
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return (as_t(qpos), as_t(qvel), torch.zeros(1, K, dtype=dtype, device=device),
            as_t(U), as_t(noise))


# Go1 poses for the rollout checks, one per sample class (k % 7): (trunk
# height, roll, pitch, legs as (hip, thigh, calf) for all four or None for
# the keyframe's). Each puts a new kernel term in play: "stand" the feet
# 6 mm in; "margin" the feet 0.5 mm out, inside the 1 mm contact margin;
# "belly" (legs folded) the trunk box corners, the lying trunk cylinders,
# the capsules and the feet in; "tilted" the same rolled 0.3 and pitched
# 0.2 rad (tilted cylinders); "pitch90" the trunk cylinders standing
# clear of the floor, the hips' lying on it; "roll90" the hip cylinders
# standing on the floor (standing exactly: the cylinder's x-axis branch of
# the rim direction); "moving" the keyframe with fast leg joints (friction
# loss).
GO1_BELLY_LEGS = (0.0, 2.5, -2.8)
GO1_POSES = (("stand", 0.282, 0.0, 0.0, None), ("margin", 0.2883, 0.0, 0.0, None),
             ("belly", 0.05, 0.0, 0.0, GO1_BELLY_LEGS),
             ("tilted", 0.106, 0.3, 0.2, GO1_BELLY_LEGS),
             ("pitch90", 0.231, 0.0, np.pi / 2, None),
             ("roll90", 0.129, np.pi / 2, 0.0, GO1_BELLY_LEGS),
             ("moving", 0.27, 0.0, 0.0, None))


def go1_states(model, K: int, seed: int = 0):
    """qpos (nq, K), qvel (nv, K) numpy arrays: sample k in pose
    GO1_POSES[k % 7], thigh and calf angles perturbed by N(0, 0.02) (hips
    and trunk exact, so the standing cylinders stay exactly standing; the
    "margin" legs exact, so all four feet stay inside the margin), joint
    velocities N(0, 0.3) (N(0, 2) in "moving")."""
    rng = np.random.default_rng(seed)
    home = np.asarray(dict(model.keyframes)["home"], dtype=np.float64)
    qpos = np.tile(home[:, None], (1, K))
    qvel = rng.normal(0, 0.3, (model.nv, K))
    for k in range(K):
        name, z, roll, pitch, legs = GO1_POSES[k % len(GO1_POSES)]
        qpos[2, k], qpos[3:7, k] = z, _quat_rp(roll, pitch)
        if legs is not None:
            qpos[7:, k] = np.tile(legs, 4)
        noise = rng.normal(0, 0.02, (4, 2))
        if name != "margin":
            for leg in range(4):
                qpos[8 + 3 * leg:10 + 3 * leg, k] += noise[leg]
        if name == "moving":
            qvel[6:, k] = rng.normal(0, 2.0, model.nv - 6)
    return qpos, qvel


def go1_inputs(model, K, T, dtype, seed=0, device="cuda", t_max=24.0):
    """Rollout inputs on the Go1 poses of go1_states: start times drawn in
    [0, t_max] s (24 s: a 12,000-step run), a plan near the keyframe's
    joint targets and sigma-0.3 noise."""
    qpos, qvel = go1_states(model, K, seed)
    rng = np.random.default_rng(seed + 1)
    home = np.asarray(dict(model.keyframes)["home"])[7:]
    U = home[None, :] + rng.normal(0, 0.1, (T, model.nu))
    noise = rng.normal(0, 0.3, (T, model.nu, K))
    t0 = rng.uniform(0, t_max, (1, K))
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return tuple(as_t(a) for a in (qpos, qvel, t0, U, noise))


def plant_state(model, case: str, seed: int = 0):
    """(qpos, qvel, ctrl) numpy arrays of the humanoid plant from a seed:
    "free_fall" 0.5 m up, "sunk" 0.2 m into the floor (floor rows active),
    "self_contact" a mirror-symmetric folded pose in which four self pairs
    penetrate, two by equal depths (waist pitch, leg and arm joints; no
    penetrating capsule pair near parallel)."""
    rng = np.random.default_rng(seed)
    qpos = model.qpos0 + rng.normal(0, 0.05, model.nq)
    qpos[3:7] /= np.linalg.norm(qpos[3:7])
    if case == "free_fall":
        qpos[2] += 0.5
    elif case == "sunk":
        qpos[2] -= 0.2
    elif case == "self_contact":
        qpos = model.qpos0.copy()
        qpos[8] = 0.37
        qpos[10:16] = qpos[16:22] = (-0.38, -0.13, -1.18, -1.79, 0.16, -0.46)
        qpos[22:25] = qpos[25:28] = (0.55, 0.71, -1.41)
    else:
        raise ValueError(case)
    return qpos, rng.normal(0, 0.3, model.nv), rng.normal(0, 0.5, model.nu)


# Go1 leg angles (FR, FL, RR, RL: hip, thigh, calf) in which three hip
# cylinders and a calf touch other legs' geoms (no pair near parallel)
GO1_SELF_CONTACT_LEGS = (0.498, 2.073, -1.852, 0.14, 2.187, -1.086, -0.859, 0.723, -1.821,
                         0.104, -0.004, -2.818)


def _quat_rp(roll: float, pitch: float) -> np.ndarray:
    """Quaternion of a roll about x, then a pitch about y in the rolled frame."""
    cr, sr, cp, sp_ = np.cos(roll / 2), np.sin(roll / 2), np.cos(pitch / 2), np.sin(pitch / 2)
    return np.array([cr * cp, sr * cp, cr * sp_, sr * sp_])


def go1_plant_state(model, case: str, seed: int = 0):
    """(qpos, qvel, ctrl) numpy arrays of the Go1 plant from a seed, near
    its `home` keyframe: "free_fall" 0.3 m up; "sunk" the trunk at 0.08 m,
    rolled 0.3 and pitched 0.2 rad (trunk box corners, hip cylinder rims
    and feet on the floor); "self_contact" the legs folded into
    GO1_SELF_CONTACT_LEGS, 0.45 m up (cylinder self pairs penetrate)."""
    rng = np.random.default_rng(seed)
    qpos = np.asarray(dict(model.keyframes)["home"], dtype=np.float64).copy()
    qpos[7:] += rng.normal(0, 0.05, 12)
    if case == "free_fall":
        qpos[2] += 0.3
    elif case == "sunk":
        qpos[2], qpos[3:7] = 0.08, _quat_rp(0.3, 0.2)
    elif case == "self_contact":
        qpos[2], qpos[7:] = 0.45, GO1_SELF_CONTACT_LEGS
    else:
        raise ValueError(case)
    return qpos, rng.normal(0, 0.3, model.nv), rng.normal(0, 0.5, model.nu)


def device_profile(fn, launches_top: Optional[int] = None) -> dict:
    """One call of fn under torch.profiler, tracing the device only (the
    host-side op events of a call of 10^4-10^5 launches take a minute or
    more to aggregate): device time by kernel, its sum, the call's wall time
    and the device's busy share (the profiler's own launch overhead
    lengthens the wall time a little). With `launches_top`, also the call's
    device launches (device_launches' counts) from the same trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    by_kernel = {}
    for ev in events:
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            name = ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + ev.self_device_time_total / 1e3
    busy_ms = sum(by_kernel.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
           "device_ms_by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))}
    if launches_top is not None:
        out["device_launches"] = launch_counts(prof, launches_top, events)
    return out


def seeded_weights(module, seed: int):
    """Load weights drawn from a numpy seed: every bias, LayerNorm scale and
    offset nonzero (a fresh init has zero biases and unit scales), so every
    term of the forward is exercised."""
    from torch import nn

    rng = np.random.default_rng(seed)
    ln_scales = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, nn.LayerNorm)}
    sd = {}
    for name, p in module.state_dict().items():
        if name in ln_scales:
            a = 1.0 + 0.1 * rng.normal(size=p.shape)
        elif name == "pos_embedding":
            a = 0.5 * rng.normal(size=p.shape)
        elif p.ndim >= 2:
            a = rng.normal(size=p.shape) / np.sqrt(p.shape[-1])
        else:
            a = 0.1 * rng.normal(size=p.shape)
        sd[name] = torch.tensor(a, dtype=torch.float32)
    module.load_state_dict(sd)
    return module


def bf16_errors(got, want) -> dict:
    """|got - want| against the bf16 tolerance: a bf16 rounding flips
    wherever the f32 sum in front of it differs in its last bits (the
    kernel and the plain version sum in other orders), one flip is 2^-8
    relative, and flips propagate through the layers. Held: median |diff|
    <= 3e-3 and max |diff| <= 3e-2, each times max(1, max|y|)."""
    d = (got - want).abs().double()
    scale = max(1.0, float(want.abs().max()))
    e = {"max_abs": float(d.max()), "median_abs": float(d.median()), "scale": scale}
    e["within"] = e["median_abs"] <= 3e-3 * scale and e["max_abs"] <= 3e-2 * scale
    return e


def exact_stage_cases(module, B: int, seed: int, device="cuda") -> dict:
    """bf16 inputs for each kernel of the estimator forward alone, at the
    module's widths, on which every f32 sum is exact in any order (few
    mantissa bits, narrow exponent range): LayerNorm rows sum to a multiple
    of H, so mean and variance are exact and the kernel's rsqrtf and
    torch.rsqrt take the same argument; attention scores of a row tie or
    differ by >= 128, so every softmax weight is 0 or 1/count. The kernel
    must then equal its plain
    version bit for bit, while each bf16 rounding still changes the result
    (sums carry 10-16 bits, the encode's x is a grid value plus a part
    below half its bf16 ulp). Returns {case: (stage, args, kwargs)}."""
    rng = np.random.default_rng(seed)
    F, H, nh = module.input_dim, module.hidden_dim, module.num_heads
    hd = H // nh

    def t(a, dtype=torch.bfloat16):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def grid(shape, k, den):
        return rng.integers(-k, k + 1, size=shape) / den

    def centred_rows(shape, c_k, c_den, e_k, e_den):
        """Rows c + (e, -e pairs), shuffled: each row sums to H c exactly."""
        c = grid(shape[:-1] + (1,), c_k, c_den)
        e = grid(shape[:-1] + (H // 2,), e_k, e_den)
        rows = np.concatenate([e, -e], axis=-1)
        return c + rng.permuted(rows, axis=-1)

    ln = lambda: t(np.stack([rng.choice([0.75, 1.0, 1.25, 1.5], H), grid(H, 8, 8)]))
    mat = lambda n, k: t(rng.choice([0, 0.125, -0.125, 0.25, -0.25, 0.5, -0.5], (n, k)))
    cases = {}

    # x = +-k/4 and a part away from zero below half its bf16 ulp (>= 2^-10)
    sign = rng.choice([-1, 1], (B, F))
    x = sign * (rng.integers(1, 9, (B, F)) / 4 + rng.integers(0, 4, (B, F)) * 2.0 ** -12)
    w_half = grid(H // 2, 4, 4)
    w_enc = rng.permuted(np.concatenate([w_half, -w_half]))     # sums to 0
    enc = np.stack([w_enc, centred_rows((H,), 4, 8, 4, 8), *ln().float().cpu().numpy(),
                    grid(H, 8, 8)])
    cases["encode"] = ("encode", (t(x, torch.float32), t(enc), t(grid((F, H), 8, 8))), {})
    # rows scaled by 1, 1/4 or 1/16: in the small ones eps 1e-6 matters
    h = centred_rows((B, F, H), 4, 4, 6, 4) * 2.0 ** -rng.choice([0, 2, 4], (B, F, 1))
    cases["layer_norm"] = ("layer_norm", (t(h), ln()), {})
    Sd = module.state_dim
    # the last layer's out-projection runs on the Sd state rows of each
    # sample and reads its residual from the full (B, F, N) stream
    for name, K, N, Fq, res, relu in (("gemm_qkv", H, 3 * H, F, False, False),
                                      ("gemm_out_residual", H, H, F, True, False),
                                      ("gemm_ffn_up_relu", H, 4 * H, F, False, True),
                                      ("gemm_ffn_down_residual", 4 * H, H, F, True, False),
                                      ("gemm_out_residual_state_rows", H, H, Sd, True, False)):
        kw = {"relu": relu}
        if res:
            kw["res"] = t(grid((B, F, N), 8, 4))
        cases[name] = ("gemm", (t(grid((B, Fq, K), 8, 4)), mat(N, K), t(grid(N, 8, 8))), kw)

    # per (sample, head): q_i = b_i u, k_j = a_j u with u in {-1, 1}^hd, so
    # scores b_i a_j sqrt(hd): rows with b_i = 0 are uniform, the others put
    # 1/count on the tied best a_j and exp(<= -128) = 0 elsewhere
    u = rng.choice([-1.0, 1.0], (B, 1, nh, hd))
    q = rng.choice([-32.0, 0.0, 32.0], (B, F, nh, 1)) * u
    kk = rng.integers(0, 3, (B, F, nh, 1)) * u
    v = grid((B, F, nh, hd), 8, 4)
    qkv = np.concatenate([a.reshape(B, F, H) for a in (q, kk, v)], axis=-1)
    cases["attention"] = ("attention", (t(qkv), nh, 1.0 / hd ** 0.5), {})
    # the last layer's: the Sd state queries against all F keys
    cases["attention_state_queries"] = ("attention", (t(qkv), nh, 1.0 / hd ** 0.5),
                                        {"n_query": Sd})
    cases["head"] = ("head", (t(grid((B, F, H), 127, 32)), t(grid(H, 31, 32)), 0.375, Sd), {})
    # ... and the head on the compacted state rows
    cases["head_state_rows"] = ("head", (t(grid((B, Sd, H), 127, 32)), t(grid(H, 31, 32)),
                                         -0.625, Sd), {})
    return cases


def estimator_ops(module, B: int) -> int:
    """Product operations that one forward needs: in every layer but the
    last, 12 H^2 MACs per token (QKV, out-projection, FFN) plus 2 F H for
    scores and weighted values. The output keeps only the state_dim tokens,
    so in the last layer the action tokens need only their K and V
    projections (2 H^2); Q, attention, out-projection and FFN (10 H^2 +
    2 F H) count for the state_dim tokens alone. The encode and the head
    (F H and state_dim H per sample) are left out: under 0.01%."""
    F, Sd, H, L = module.input_dim, module.state_dim, module.hidden_dim, module.attn_layers
    full = F * (12 * H * H + 2 * F * H)
    last = F * 2 * H * H + Sd * (10 * H * H + 2 * F * H)
    return 2 * B * ((L - 1) * full + last)


def estimator_bytes(module, B: int, esize: int) -> dict:
    """Bytes of one forward: what the function must move (x in, the output,
    each weight once) and what the layer-wise design also moves (each kernel
    reads its inputs and writes its outputs once, in H-wide rows: per token
    and layer LN1 2, QKV 4, attention 4, out-projection 3 (A, residual, C),
    LN2 2, FFN up 5, FFN down 6, i.e. 26; in the last layer LN1, QKV and the
    attention's reads (9) for all tokens and the rest (17) for the state
    tokens only; the encode's output and the head's input)."""
    F, Sd, H, L = module.input_dim, module.state_dim, module.hidden_dim, module.attn_layers
    n_w = sum(p.numel() for p in module.parameters())
    function = 4 * B * F + 4 * B * Sd + esize * n_w
    M, Mq = B * F, B * Sd
    rows = (L - 1) * 26 * M + 9 * M + 17 * Mq if L else 0
    design = function + esize * H * (rows + M + Mq)
    return {"function": function, "design": design}


def stage_times(module, B: int, reps: int = 20) -> dict:
    """Device ms of each bf16 kernel alone at the shapes one forward at
    batch B gives it (CUDA events around `reps` back-to-back calls of the
    stage entry point, random inputs): the GEMMs with their TFLOP/s, the
    attention and the LayerNorm with their GB/s (inputs read once, outputs
    written once)."""
    from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek

    F, Sd, H, nh = module.input_dim, module.state_dim, module.hidden_dim, module.num_heads
    w = ek.pack_weights(module, torch.bfloat16, "cuda")
    ln1, w_qkv, b_qkv, w_o, b_o, ln2, w1, b1, w2, b2 = w[2:12]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def act(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=gen, device="cuda")).to(torch.bfloat16)

    h, y, big, qkv = act(B, F, H), act(B, F, H), act(B, F, 4 * H, s=0.1), act(B, F, 3 * H)
    yq, bigq, hq = act(B, Sd, H), act(B, Sd, 4 * H, s=0.1), act(B, Sd, H)
    scale = 1.0 / (H // nh) ** 0.5
    gemms = {"qkv": (y, w_qkv, b_qkv, None, False),
             "out_residual": (y, w_o, b_o, h, False),
             "ffn_up_relu": (y, w1, b1, None, True),
             "ffn_down_residual": (big, w2, b2, h, False),
             "out_residual_state_rows": (yq, w_o, b_o, h, False),
             "ffn_up_relu_state_rows": (yq, w1, b1, None, True),
             "ffn_down_residual_state_rows": (bigq, w2, b2, hq, False)}
    out = {}
    for name, (a, wt, b, res, relu) in gemms.items():
        fn = lambda: ek.gemm_cuda(a, wt, b, res=res, relu=relu)
        fn()
        ms = cuda_ms(fn, reps)
        M, (N, K) = a.shape[0] * a.shape[1], wt.shape
        out[f"gemm_{name}"] = {"M": M, "N": N, "K": K, "ms": ms,
                               "tflops": 2 * M * N * K / ms / 1e9}
    for name, n_query in (("attention", None), ("attention_state_queries", Sd)):
        fn = lambda: ek.attention_cuda(qkv, nh, scale, n_query=n_query)
        fn()
        ms = cuda_ms(fn, reps)
        n_bytes = 2 * (qkv.numel() + B * (n_query or F) * H)
        out[name] = {"B": B, "F": F, "n_query": n_query or F, "ms": ms,
                     "gb_per_s": n_bytes / ms / 1e6}
    for name, x in (("layer_norm", h), ("layer_norm_state_rows", hq)):
        fn = lambda: ek.layer_norm_cuda(x, ln1)
        fn()
        ms = cuda_ms(fn, reps)
        out[name] = {"rows": x.shape[0] * x.shape[1], "ms": ms,
                     "gb_per_s": 2 * 2 * x.numel() / ms / 1e6}
    return out


def library_forward(module):
    """The same forward through PyTorch's TransformerEncoder in bf16, with the
    encode and the head as torch ops around it: a yardstick only."""
    from torch import nn
    import torch.nn.functional as Fn

    H, nh, L = module.hidden_dim, module.num_heads, module.attn_layers
    layer = nn.TransformerEncoderLayer(H, nh, 4 * H, dropout=0.0, norm_first=True,
                                       layer_norm_eps=1e-6, batch_first=True)
    enc = nn.TransformerEncoder(layer, L, enable_nested_tensor=False)
    sd = module.state_dict()
    lib = {}
    names = {"self_attn.in_proj_weight": "attention.in_proj_weight",
             "self_attn.in_proj_bias": "attention.in_proj_bias",
             "self_attn.out_proj.weight": "attention.out_proj.weight",
             "self_attn.out_proj.bias": "attention.out_proj.bias",
             "linear1.weight": "ffn.0.weight", "linear1.bias": "ffn.0.bias",
             "linear2.weight": "ffn.3.weight", "linear2.bias": "ffn.3.bias",
             "norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
             "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias"}
    for i in range(L):
        lib.update({f"layers.{i}.{a}": sd[f"layers.{i}.{b}"] for a, b in names.items()})
    enc.load_state_dict(lib)
    enc = enc.to("cuda", torch.bfloat16).eval()
    w = {k: v.to("cuda", torch.bfloat16) for k, v in sd.items()
         if k.startswith(("feature_encoding", "pos_embedding", "output_layer"))}

    @torch.inference_mode()
    def forward(x):
        h = Fn.linear(x.to(torch.bfloat16)[..., None], w["feature_encoding.0.weight"],
                      w["feature_encoding.0.bias"])
        h = Fn.layer_norm(h, (H,), w["feature_encoding.1.weight"],
                          w["feature_encoding.1.bias"], eps=1e-6)
        h = enc(torch.relu(h) + w["pos_embedding"])
        out = Fn.linear(h, w["output_layer.weight"], w["output_layer.bias"])
        return out[..., 0][:, :module.state_dim].float()

    return forward


def ops_per_rollout(model, cost_factory, cost_kwargs, T, inputs=None, ctrl_bounds=(None, None),
                    params=None) -> int:
    """Scalar operations one sample's rollout needs: the plain version's
    arithmetic ops (0/1 constants already folded away), counted on the CPU
    at T=1 and T=2 on `inputs(model, K, T, dtype, device=...)` (default
    seeded_inputs) and extended linearly to T."""
    from torch.utils._python_dispatch import TorchDispatchMode

    inputs = inputs or seeded_inputs
    not_arith = {"select", "view", "expand", "stack", "clone", "copy_", "_to_copy",
                 "zeros_like", "zeros", "empty", "slice", "unsqueeze", "alias",
                 "detach", "lift_fresh", "cat", "squeeze", "unbind", "full",
                 "scalar_tensor", "fill_", "constant_pad_nd"}
    k = 3

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (isinstance(out, torch.Tensor) and out.numel() == k
                    and func.overloadpacket.__name__ not in not_arith):
                Count.n += 1
            return out

    def count(t):
        from humanoid_mppi_rl_tpu_torch.ops.rollout_kernel import build_rollout_kernel
        ro = build_rollout_kernel(model, cost_factory, t, ctrl_low=ctrl_bounds[0],
                                  ctrl_high=ctrl_bounds[1], cost_kwargs=cost_kwargs,
                                  device="cpu")
        x = inputs(model, k, t, torch.float64, device="cpu")
        p = None if params is None else torch.tensor(params, dtype=torch.float64)
        Count.n = 0
        with Count():
            ro(*x, params=p)
        return Count.n

    n1, n2 = count(1), count(2)
    return n1 + (T - 1) * (n2 - n1)


# the rollout kernel's phases between the HMR_MARKs of csrc/rollout_body.cuh
ROLLOUT_PHASES = (("inertia, bias acc, tendons, ctrl", 0, 1), ("bias force, contacts, tau", 1, 2),
                  ("tree accumulation", 2, 3), ("rhs, IC S", 3, 4), ("mass matrix", 4, 5),
                  ("Cholesky", 5, 6), ("solve L", 6, 7), ("solve L^T", 7, 8),
                  ("integrate", 8, 9), ("fk frames", 10, 11), ("fk S rows", 11, 12),
                  ("fk V, W", 12, 13), ("cost", 14, 15))


def rollout_launch(lib, ro, x, samples_per_block=None, smem_bytes=None):
    """One launch of the rollout kernel of library `lib` (the port's, or its
    profiling build) on inputs x, at the wrapper's geometry unless given."""
    import ctypes
    qpos0, qvel0, time0, U, noise = x
    nq, K = qpos0.shape
    geo = ro.geometry[qpos0.dtype]
    params = torch.zeros(16, dtype=qpos0.dtype, device="cuda")
    outs = (torch.empty(K, dtype=qpos0.dtype, device="cuda"), torch.empty_like(qpos0),
            torch.empty_like(qvel0))
    fn = lib.hmr_rollout_f64 if qpos0.dtype == torch.float64 else lib.hmr_rollout_f32
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 10 + [cint, cint, ptr, cint, cint]
    rc = fn(ro.tables[qpos0.dtype].data_ptr(),
            *[a.data_ptr() for a in (qpos0, qvel0, time0, U, noise, params, *outs)], K,
            U.shape[0],
            torch.cuda.current_stream().cuda_stream,
            samples_per_block or geo["samples_per_block"], smem_bytes or geo["smem_bytes"])
    if rc:
        raise RuntimeError(f"rollout launch failed: cudaError {rc}")
    return outs


def check_rollout(model, cost_factory, cost_kwargs, params=None, inputs=None,
                  ctrl_bounds=(None, None), T=CHECK_T, f32_quantile: float = 1.0) -> dict:
    """The rollout kernel against its plain version at K = CHECK_KS and T
    (CHECK_T by default), on `inputs(model, K, T, dtype, seed)` (default seeded_inputs),
    f64 to rtol=atol=1e-9, f32 cost relative error median < 1e-3 and max
    < 1e-2, two launches bit-identical. `f32_quantile` < 1 holds that
    quantile of the f32 relative error below 1e-2 in place of its max (for
    a signed cost whose values cross zero, where the per-sample relative
    error of any f32 evaluation is unbounded); the samples beyond 1e-2 are
    counted. Returns the errors by dtype and K, and the launch geometry by
    dtype."""
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    inputs = inputs or seeded_inputs
    ro = rk.build_rollout_kernel(model, cost_factory, T, ctrl_low=ctrl_bounds[0],
                                 ctrl_high=ctrl_bounds[1], cost_kwargs=cost_kwargs)
    errs = {}
    for K, dtype in ((K, dt) for K in CHECK_KS for dt in (torch.float64, torch.float32)):
        x = inputs(model, K, T, dtype, seed=1)
        p = None if params is None else torch.tensor(params, dtype=dtype, device="cuda")
        n0 = rk.launches
        ck, qk, vk = ro(*x, params=p)
        torch.cuda.synchronize()
        if rk.launches != n0 + 1:
            raise AssertionError("rollout kernel launch was not counted")
        again = ro(*x, params=p)
        if not all(torch.equal(a, b) for a, b in zip((ck, qk, vk), again)):
            raise AssertionError(f"K={K} {dtype}: two launches on the same inputs differ")
        cp, qp, vp = ro.plain(*x, params=p)
        rel = ((ck - cp).abs() / cp.abs()).double()
        e = {"cost_max_abs": float((ck - cp).abs().max()),
             "cost_rel_max": float(rel.max()), "cost_rel_median": float(rel.median()),
             "qpos_max_abs": float((qk - qp).abs().max()),
             "qvel_max_abs": float((vk - vp).abs().max())}
        for name, a in (("costs", ck), ("qpos_T", qk), ("qvel_T", vk)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"{dtype}: non-finite kernel {name}")
        if dtype == torch.float64:
            for a, b, name in ((ck, cp, "costs"), (qk, qp, "qpos_T"), (vk, vp, "qvel_T")):
                torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9, msg=name)
        else:
            top = e["cost_rel_max"]
            if f32_quantile < 1.0:
                top = e[f"cost_rel_q{f32_quantile:g}"] = float(torch.quantile(rel, f32_quantile))
                e["samples_rel_over_1e-2"] = int((rel > 1e-2).sum())
            if not (e["cost_rel_median"] < 1e-3 and top < 1e-2):
                raise AssertionError(f"K={K} f32 kernel vs plain: {e}")
        e["repeat_bit_identical"] = True
        errs[f"{str(dtype).replace('torch.', '')}/K={K}"] = e
    return errs, ro.geometry


def sincos_check() -> dict:
    """The rollout body's f32 sin/cos against the CUDA library's sinf/cosf,
    bit for bit, on every float with |x| < 105615 (profiling build)."""
    import ctypes
    from humanoid_mppi_rl_tpu_torch.ops import _build

    lib = _build.load_library("rollout_profile.cu")
    lib.hmr_check_sincos.argtypes = [ctypes.c_void_p] * 3
    tried, bad, first = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint32()
    rc = lib.hmr_check_sincos(ctypes.byref(tried), ctypes.byref(bad), ctypes.byref(first))
    if rc or bad.value:
        raise AssertionError(f"f32 sin/cos vs sinf/cosf: cudaError {rc}, {bad.value} of "
                             f"{tried.value} floats differ (first bits {first.value:#010x})")
    return {"floats": tried.value, "mismatches": 0}


def rollout_diagnostics(model, ro, T, inputs=None) -> dict:
    """(1) Occupancy sweep: one block of S samples per SM (the shared memory
    request forced to the largest block's), K = SMs * S, so each SM runs S
    warps: flat times mean each warp's own latency bounds the kernel,
    times growing with S mean the SM's instruction throughput does. (2) The kernel's
    time split by phase at the main path's K, from the profiling build.
    On `inputs(model, K, T, dtype, seed)` (default seeded_inputs)."""
    import ctypes
    from humanoid_mppi_rl_tpu_torch.ops import _build
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    inputs = inputs or seeded_inputs
    lib = rk._rollout_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geo = ro.geometry[torch.float32]
    top = lib.hmr_rollout_max_samples_per_block(0)
    smem = max(rk.shared_bytes(model, torch.float32, geo["ws_scalars"], S)
               for S in range(1, top + 1)
               if lib.hmr_rollout_occupancy(0, S, rk.shared_bytes(
                   model, torch.float32, geo["ws_scalars"], S)) > 0)
    sweep = {}
    for S in (1, 2, 4, 8, 16, geo["samples_per_block"]):
        if lib.hmr_rollout_occupancy(0, S, smem) < 1:
            continue
        x = inputs(model, sms * S, T, torch.float32, seed=2)
        rollout_launch(lib, ro, x, S, smem)
        sweep[S] = cuda_ms(lambda: rollout_launch(lib, ro, x, S, smem), 3)
    prof_lib = _build.load_library("rollout_profile.cu")
    prof_lib.hmr_profile_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    def phase_cycles(x, *geometry):
        u64 = ctypes.c_uint64 * 16
        sums, counts = u64(), u64()
        prof_lib.hmr_profile_take(ctypes.byref(sums), ctypes.byref(counts))  # zero
        rollout_launch(prof_lib, ro, x, *geometry)
        if prof_lib.hmr_profile_take(ctypes.byref(sums), ctypes.byref(counts)):
            raise RuntimeError("profiling build: reading the marks failed")
        cycles = {}
        for name, a, b in ROLLOUT_PHASES:
            if counts[a] != counts[b] or not counts[a]:
                raise AssertionError(f"phase {name}: marks {a}/{b} counted {counts[a]}/{counts[b]}")
            cycles[name] = ((sums[b] - sums[a]) % 2 ** 64) / counts[a]
        return cycles

    cycles = phase_cycles(inputs(model, 8192, T, torch.float32, seed=2))
    # the same with one sample per SM: each phase's own latency
    alone = phase_cycles(inputs(model, sms, T, torch.float32, seed=2), 1, smem)
    total = sum(cycles.values())
    return {"one_block_per_sm_ms_by_S": sweep, "sms": sms,
            "phase_cycles_per_sample_step": cycles,
            "phase_share": {k: v / total for k, v in cycles.items()},
            "phase_cycles_one_sample_per_sm": alone}


def device_launches(fn, top: int = 0) -> dict:
    """Device work items (kernels, and memcpy/memset apart) of one call of
    fn, from torch.profiler tracing the device only; None where it traced no
    device activity. With `top`, also the `top` most launched kernel names
    and their counts."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return launch_counts(prof, top)


def launch_counts(prof, top: int, events=None) -> dict:
    """device_launches' counts from a finished torch.profiler trace (or
    its key_averages(), `events`, when the caller has them)."""
    kernels = copies = 0
    by_name = {}
    for ev in (prof.key_averages() if events is None else events):
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.key.startswith(("Memcpy", "Memset")):
                copies += ev.count
            else:
                kernels += ev.count
                name = ev.key.replace("void ", "").split("(")[0].split("<")[0]
                by_name[name] = by_name.get(name, 0) + ev.count
    out = {"kernels": kernels or None, "memcpy_memset": copies}
    if top:
        out["by_kernel"] = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:top])
    return out


def collect_phase() -> dict:
    """main_collect (see the module docstring). Returns the collect path's
    numbers for the `kernels` line."""
    from humanoid_mppi_rl_tpu_torch.collect.runner import (
        EpisodeRunner, _humanoid_state_row, collect_humanoid)
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv

    t0 = time.perf_counter()
    # bench.py::_bench_collect's runner: the walk cost's own target
    runner = EpisodeRunner(COLLECT_TASK, use_kernel=True)
    cfg, model = runner.cfg, runner.model
    # collect_humanoid's planner cost (walk weights, the goal in the runtime
    # params) through the kernel against its plain version
    walk_check, _ = check_rollout(model, runner.spec.kernel_cost_factory,
                               dict(runner.spec.cost_kwargs, param_target=True),
                               params=np.pad([1.5, 0.2, 1.28], (0, 13)))
    row = _humanoid_state_row(model.body_id("foot_left"), model.body_id("foot_right"))

    rk.launches = 0
    warm = runner.run(max_steps=COLLECT_WARMUP, chunk=COLLECT_WARMUP, state_row_fn=row)
    torch.cuda.synchronize()
    warm_launches = rk.launches
    t1 = time.perf_counter()
    timed = runner.run(max_steps=COLLECT_TIMED, chunk=COLLECT_CHUNK, state_row_fn=row)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    timed_launches = rk.launches - warm_launches
    with tempfile.TemporaryDirectory() as out_dir:
        episode = collect_humanoid(n_episodes=1, task_name=COLLECT_TASK, use_kernel=True,
                                   max_steps=COLLECT_TIMED, save=True, out_dir=out_dir,
                                   goal_threshold=1e9, chunk=HUM_COLLECT_CHUNK)
        torch.cuda.synchronize()
        path_launches = rk.launches
        shapes = {}
        for d, _, files in os.walk(out_dir):
            for f in files:
                a = read_csv(os.path.join(d, f))
                if not np.isfinite(a).all():
                    raise AssertionError(f"{f}: non-finite CSV values")
                shapes[f.split("_")[0]] = a.shape[1]
    # a chunk always runs to its end: the episode's goal at step 1 still ran
    # HUM_COLLECT_CHUNK
    executed = COLLECT_WARMUP + COLLECT_TIMED + HUM_COLLECT_CHUNK
    if (warm_launches, timed_launches, path_launches) != (COLLECT_WARMUP, COLLECT_TIMED, executed):
        raise AssertionError(f"rollout launches {warm_launches}/{timed_launches}/{path_launches} "
                             f"for {COLLECT_WARMUP}/{COLLECT_TIMED}/{executed} control steps")
    heights = []
    for name, res, n in (("warm-up", warm, COLLECT_WARMUP), ("timed", timed, COLLECT_TIMED)):
        states, actions, times = res.logger.arrays()
        if states.shape != (n, 57) or actions.shape != (n, model.nu) or times.shape != (n,):
            raise AssertionError(f"{name}: logged {states.shape} {actions.shape} {times.shape}")
        if not (np.isfinite(states).all() and np.isfinite(actions).all()
                and np.isfinite(times).all() and np.isfinite(res.final_qpos).all()):
            raise AssertionError(f"{name}: non-finite logged rows")
        heights.append(states[:, 2])
    heights = np.concatenate(heights)
    if heights.min() < FALL_Z:
        raise AssertionError(f"the humanoid fell: root height {heights.min():.3f} < {FALL_Z}")
    if not (episode[0]["goal"] and episode[0]["steps_saved"] == 1):
        raise AssertionError(f"collect_humanoid: {episode}")
    if shapes != {"states": 57, "actions": 21, "times": 1}:
        raise AssertionError(f"CSV columns {shapes}")

    # control steps one at a time: plan and plant apart by CUDA events
    ms = runner.fresh_controller(1)
    plant = runner.init_state
    params = torch.zeros(16, dtype=torch.float32, device="cuda")
    plan_ms, plant_ms, step_ms, iters, active = [], [], [], [], []
    for _ in range(COLLECT_SPLIT_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        h0 = time.perf_counter()
        ev[0].record()
        action, ms, _ = runner.plan(ms, plant, params=params)
        ev[1].record()
        info = {}
        plant = runner.plant_dyn(plant, action, info=info)
        ev[2].record()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - h0) * 1e3)
        plan_ms.append(ev[0].elapsed_time(ev[1]))
        plant_ms.append(ev[1].elapsed_time(ev[2]))
        iters.append(int(info["iterations"]))
        active.append(float(info["active_rows"]))
    launches = device_launches(lambda: runner.plant_dyn(plant, action))
    prof = device_profile(lambda: runner.control_step(ms, plant, params))
    # one plant step with any host synchronisation raising
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nxt = runner.plant_dyn(plant, action)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    if not torch.isfinite(nxt.qpos).all():
        raise AssertionError("non-finite plant step")
    emit({"phase": "main_collect", "task": COLLECT_TASK, "K": cfg.K, "H": cfg.T,
          "dtype": "float32", "walk_cost_kernel_vs_plain": walk_check,
          "steps": COLLECT_WARMUP + COLLECT_TIMED, "timed_steps": COLLECT_TIMED,
          "steps_per_s": COLLECT_TIMED / wall, "control_step_ms": wall / COLLECT_TIMED * 1e3,
          "rollout_launches_per_control_step": timed_launches / COLLECT_TIMED,
          "rollout_launches_on_path": path_launches,
          "split_steps": COLLECT_SPLIT_STEPS,
          "plan_ms_median": statistics.median(plan_ms), "plant_ms_median": statistics.median(plant_ms),
          "control_step_host_ms_median": statistics.median(step_ms),
          "plan_ms": plan_ms, "plant_ms": plant_ms,
          "newton_iterations": iters, "newton_iterations_mean": float(np.mean(iters)),
          "constraint_rows": info["rows"], "active_rows_mean": float(np.mean(active)),
          "plant_step_device_launches": launches, "profiled_control_step": prof,
          "plant_step_sync_free": True, "root_height_min": float(heights.min()),
          "root_height_final": float(timed.final_qpos[2]),
          "x_travelled_timed": float(timed.final_qpos[0] - runner.init_state.qpos[0]),
          "collect_episode": episode[0], "csv_columns": shapes,
          "seconds": time.perf_counter() - t0})
    return {"launches_collect": path_launches, "control_steps": executed,
            "collect_control_step_ms": wall / COLLECT_TIMED * 1e3}


def go1_replans(task: str, K: int, H: int, params, warmup: int, timed: int,
                cost_kwargs=None) -> dict:
    """`warmup` + `timed` chained replans of load_task(task) at K, H, f32
    through make_kernel_mppi, from the task's initial state; one rollout
    launch per replan asserted; then one replan under torch.profiler."""
    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
    from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState

    spec, model, _, _, _, init, cfg = load_task(task)
    cfg = dataclasses.replace(cfg, n_samples=K, horizon=H)
    kw = dict(spec.cost_kwargs, **(cost_kwargs or {}))
    plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, kw)
    p = None if params is None else torch.tensor(params, dtype=torch.float32, device="cuda")
    ms = MPPIState.seeded(0, cfg.T, model.nu)
    rk.launches = 0
    times = []
    for i in range(warmup + timed):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        action, ms, diag = plan(ms, init, params=p)
        b.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(a.elapsed_time(b))
    launches = rk.launches
    if launches != warmup + timed:
        raise AssertionError(f"{task}: {launches} kernel launches for {warmup + timed} replans")
    for name, v in {"action": action, "U": ms.U, **dataclasses.asdict(diag)}.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{task}: non-finite {name}")
    lo, hi = (torch.tensor(b, device="cuda") for b in (cfg.ctrl_low, cfg.ctrl_high))
    if tuple(ms.U.shape) != (H, model.nu) or not ((action >= lo) & (action <= hi)).all():
        raise AssertionError(f"{task}: plan shape {tuple(ms.U.shape)} or action out of bounds")
    q1, q3 = np.percentile(times, [25, 75])
    med = statistics.median(times)
    prof = device_profile(lambda: plan(ms, init, params=p))
    return {"task": task, "cost": spec.kernel_cost, "K": K, "H": H, "dtype": "float32",
            "replans": timed, "launches": launches, "replan_ms_median": med,
            "replan_ms_q1": float(q1), "replan_ms_q3": float(q3),
            "replan_ms_min": min(times), "replan_ms_max": max(times),
            "rollouts_per_s": K / (med / 1e3), "beta": float(diag.beta),
            "ess": float(diag.ess), "profiled_replan": prof,
            "plan": plan, "spec": spec, "model": model, "cfg": cfg, "cost_kwargs": kw}


def go1_phases() -> dict:
    """check_go1, main_go1 and main_quad_collect (see the module
    docstring). Returns the Go1 numbers of the rollout kernel's entry of the
    `kernels` line, and under "collected_rows" main_quad_collect's logged
    rows (the learning loop trains on them)."""
    from humanoid_mppi_rl_tpu_torch.costs.quadruped import GAIT_TUNED
    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    params = np.zeros(16)
    params[0:2] = GO1_GOAL
    params[4:13] = GAIT_TUNED

    # ---- check_go1: the kernel against its plain version, both costs -------
    t0 = time.perf_counter()
    errs = {}
    for task, kw in (("go1_collect", dict(param_goal=True, param_gait=True)), ("go1", {})):
        spec, model, *_, cfg = load_task(task, dtype=torch.float64)
        e, geometry = check_rollout(model, spec.kernel_cost_factory, dict(spec.cost_kwargs, **kw),
                                    params=params if kw else None, inputs=go1_inputs,
                                    ctrl_bounds=(cfg.ctrl_low, cfg.ctrl_high))
        errs[spec.kernel_cost] = e
    emit({"phase": "check_go1", "kernel": "rollout", "K": list(CHECK_KS), "T": CHECK_T,
          "tasks": {"quadruped": "go1_collect, param_goal + param_gait (GAIT_TUNED, goal "
                                 f"{GO1_GOAL}), actuator ctrlrange clamp",
                    "quadruped_jl": "go1, +-10 clamp"},
          "inputs": "go1_inputs: poses " + ", ".join(p[0] for p in GO1_POSES)
                    + "; t0 ~ U[0, 24] s",
          "tolerance": {"float64": "rtol=atol=1e-9",
                        "float32": "cost rel median<1e-3, max<1e-2",
                        "repeat": "two launches bit-identical"},
          "geometry": {str(dt).replace("torch.", ""): geo for dt, geo in geometry.items()},
          "errors": errs, "seconds": time.perf_counter() - t0})

    # ---- main_go1: the Go1 replans at quad_pipeline's operating point -------
    t0 = time.perf_counter()
    main = go1_replans("go1_collect", GO1_K, GO1_H, params, WARMUP, TIMED,
                       cost_kwargs=dict(param_goal=True, param_gait=True))
    jl = go1_replans("go1", GO1_K, GO1_H, None, WARMUP, GO1_JL_TIMED)
    ro, model, spec, cfg = main["plan"].rollouts, main["model"], main["spec"], main["cfg"]
    kw = main["cost_kwargs"]
    # the kernel alone at the main path's shapes and at K=8192, beside its
    # plain version and its bound (operations from ops_per_rollout)
    p = torch.tensor(params, dtype=torch.float32, device="cuda")
    timing = {}
    n_rollout_ops = ops_per_rollout(model, spec.kernel_cost_factory, kw, GO1_H, inputs=go1_inputs,
                                    ctrl_bounds=(cfg.ctrl_low, cfg.ctrl_high), params=params)
    for K in GO1_TIME_K:
        x = go1_inputs(model, K, GO1_H, torch.float32, seed=2)
        ro(*x, params=p)
        kernel_ms = cuda_ms(lambda: ro(*x, params=p), 5)
        n_ops = K * n_rollout_ops
        n_bytes = 4 * (K * (2 * model.nq + 2 * model.nv + 1)
                       + GO1_H * model.nu * (K + 1) + rk.NP)
        t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_OPS_PER_S * 1e3
        timing[K] = {"kernel_ms": kernel_ms, "ops": n_ops, "bytes": n_bytes,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes > t_ops else "operations"}
        if K == GO1_K:
            out = {}
            timing[K]["plain_ms"] = cuda_ms(
                lambda: out.setdefault("plain", ro.plain(*x, params=p)), 1)
            ck, cp = ro(*x, params=p)[0].double(), out["plain"][0].double()
            rel = (ck - cp).abs() / cp.abs()
            timing[K]["kernel_vs_plain"] = {"cost_rel_median": float(rel.median()),
                                            "cost_rel_max": float(rel.max()),
                                            "cost_max_abs": float((ck - cp).abs().max())}
            if not (torch.isfinite(ck).all() and float(rel.median()) < 1e-3):
                raise AssertionError(f"go1 full-shape f32 kernel vs plain: {timing[K]}")
        del x
    torch.cuda.empty_cache()
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in ("plan", "spec", "model", "cfg", "cost_kwargs")}
    emit({"phase": "main_go1", "replan": strip(main), "replan_go1_jl": strip(jl),
          "params": params.tolist(), "kernel_alone_T": GO1_H, "kernel_alone": timing,
          "geometry": ro.geometry.get(torch.float32), "ops_per_rollout": n_rollout_ops,
          "seconds": time.perf_counter() - t0})

    collect, rows = quad_collect_phase(params)
    t = timing[GO1_K]
    return {"ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "at": {"K": GO1_K, "T": GO1_H},
            "ms_K8192": timing[8192]["kernel_ms"], "bound_ms_K8192": timing[8192]["bound_ms"],
            "max_abs_err": max(e["cost_max_abs"] for c in errs.values()
                               for k, e in c.items() if "float32" in k),
            "max_abs_err_f64": max(e["cost_max_abs"] for c in errs.values()
                                   for k, e in c.items() if "float64" in k),
            "cost_rel_median_f32": max(e["cost_rel_median"] for c in errs.values()
                                       for k, e in c.items() if "float32" in k),
            "paths": {"go1_collect replan": {"launches": main["launches"],
                                             "replans": WARMUP + TIMED},
                      "go1 replan": {"launches": jl["launches"],
                                     "replans": WARMUP + GO1_JL_TIMED},
                      **collect},
            "collected_rows": rows}


def quad_collect_phase(params):
    """main_quad_collect (see the module docstring). Returns the launch
    counts of the Go1 collection path and the logged (states, actions) of
    its warm-up and timed runs."""
    from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner, collect_quadruped
    from humanoid_mppi_rl_tpu_torch.costs.quadruped import GAIT_TUNED
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv

    t0 = time.perf_counter()
    tiny = dict(n_samples=GO1_K, horizon=GO1_H)
    runner = EpisodeRunner("go1_collect", use_kernel=True, mppi_override=tiny,
                           cost_kwargs_override=dict(param_goal=True, param_gait=True))
    cfg, model = runner.cfg, runner.model
    rk.launches = 0
    warm = runner.run(max_steps=QUAD_WARMUP, chunk=QUAD_WARMUP, params=params)
    torch.cuda.synchronize()
    warm_launches = rk.launches
    t1 = time.perf_counter()
    timed = runner.run(max_steps=QUAD_TIMED, chunk=QUAD_TIMED, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    timed_launches = rk.launches - warm_launches
    if (warm_launches, timed_launches) != (QUAD_WARMUP, QUAD_TIMED):
        raise AssertionError(f"go1 rollout launches {warm_launches}/{timed_launches} for "
                             f"{QUAD_WARMUP}/{QUAD_TIMED} control steps")
    heights = []
    for name, res, n in (("warm-up", warm, QUAD_WARMUP), ("timed", timed, QUAD_TIMED)):
        states, actions, times = res.logger.arrays()
        if states.shape != (n, 37) or actions.shape != (n, model.nu) or times.shape != (n,):
            raise AssertionError(f"go1 {name}: logged {states.shape} {actions.shape} {times.shape}")
        if not (np.isfinite(states).all() and np.isfinite(actions).all()
                and np.isfinite(times).all() and np.isfinite(res.final_qpos).all()):
            raise AssertionError(f"go1 {name}: non-finite logged rows")
        heights.append(states[:, 2])
    heights = np.concatenate(heights)
    if heights.min() < GO1_FALL_Z:
        raise AssertionError(f"the Go1 fell: trunk height {heights.min():.3f} < {GO1_FALL_Z}")

    # control steps one at a time: plan and plant apart by CUDA events
    ms = runner.fresh_controller(1)
    plant = runner.init_state
    p = torch.tensor(params, dtype=torch.float32, device="cuda")
    plan_ms, plant_ms, step_ms, iters, active = [], [], [], [], []
    for _ in range(GO1_SPLIT_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        h0 = time.perf_counter()
        ev[0].record()
        action, ms, _ = runner.plan(ms, plant, params=p)
        ev[1].record()
        info = {}
        plant = runner.plant_dyn(plant, action, info=info)
        ev[2].record()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - h0) * 1e3)
        plan_ms.append(ev[0].elapsed_time(ev[1]))
        plant_ms.append(ev[1].elapsed_time(ev[2]))
        iters.append(int(info["iterations"]))
        active.append(float(info["active_rows"]))
    launches = device_launches(lambda: runner.plant_dyn(plant, action))
    prof = device_profile(lambda: runner.control_step(ms, plant, p))
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nxt = runner.plant_dyn(plant, action)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    if not torch.isfinite(nxt.qpos).all():
        raise AssertionError("non-finite Go1 plant step")

    # one collect_quadruped run; the goal tolerance opened so that its gate saves
    n0 = rk.launches
    with tempfile.TemporaryDirectory() as out_base:
        episode = collect_quadruped(n_runs=1, out_base=out_base, use_kernel=True,
                                    mppi_override=tiny, max_steps=QUAD_TIMED,
                                    goal_tolerance=1e9, chunk=GO1_COLLECT_CHUNK,
                                    gait_params=np.asarray(GAIT_TUNED, np.float32),
                                    goal_for_run=lambda i: GO1_GOAL)
        torch.cuda.synchronize()
        shapes = {}
        for f in sorted(os.listdir(os.path.join(out_base, "run_000"))):
            a = read_csv(os.path.join(out_base, "run_000", f))
            if not np.isfinite(a).all():
                raise AssertionError(f"{f}: non-finite CSV values")
            shapes[f.split(".")[0]] = a.reshape(a.shape[0], -1).shape[1]
    collect_launches = rk.launches - n0
    ep = episode[0]
    if not (ep["goal"] and ep["steps_saved"] == 1 and ep["outcome"] == "goal"):
        raise AssertionError(f"collect_quadruped: {episode}")
    if shapes != {"states": 37, "actions": 12, "times": 1}:
        raise AssertionError(f"go1 CSV columns {shapes}")
    # a chunk always runs to its end: the goal at step 1 still ran GO1_COLLECT_CHUNK
    if collect_launches != GO1_COLLECT_CHUNK:
        raise AssertionError(f"collect_quadruped: {collect_launches} rollout launches "
                             f"for {GO1_COLLECT_CHUNK} control steps")
    emit({"phase": "main_quad_collect", "task": "go1_collect", "K": cfg.K, "H": cfg.T,
          "dtype": "float32", "params": params.tolist(),
          "steps": QUAD_WARMUP + QUAD_TIMED, "timed_steps": QUAD_TIMED,
          "steps_per_s": QUAD_TIMED / wall, "control_step_ms": wall / QUAD_TIMED * 1e3,
          "rollout_launches_per_control_step": timed_launches / QUAD_TIMED,
          "split_steps": GO1_SPLIT_STEPS,
          "plan_ms_median": statistics.median(plan_ms),
          "plan_ms_q1_q3": [float(x) for x in np.percentile(plan_ms, [25, 75])],
          "plant_ms_median": statistics.median(plant_ms),
          "plant_ms_q1_q3": [float(x) for x in np.percentile(plant_ms, [25, 75])],
          "control_step_host_ms_median": statistics.median(step_ms),
          "plan_ms": plan_ms, "plant_ms": plant_ms,
          "newton_iterations": iters, "newton_iterations_mean": float(np.mean(iters)),
          "constraint_rows": info["rows"], "active_rows_mean": float(np.mean(active)),
          "plant_step_device_launches": launches, "profiled_control_step": prof,
          "plant_step_sync_free": True, "trunk_height_min": float(heights.min()),
          "trunk_height_final": float(timed.final_qpos[2]),
          "x_travelled_timed": float(timed.final_qpos[0] - runner.init_state.qpos[0]),
          "collect_episode": episode[0], "csv_columns": shapes,
          "seconds": time.perf_counter() - t0})
    paths = {"go1_collect EpisodeRunner.run": {"launches": warm_launches + timed_launches,
                                                "control_steps": QUAD_WARMUP + QUAD_TIMED},
             "collect_quadruped": {"launches": collect_launches,
                                   "control_steps": GO1_COLLECT_CHUNK}}
    rows = {name: res.logger.arrays()[:2] for name, res in (("warmup", warm), ("timed", timed))}
    return paths, rows


def time_forward(module, x, model: str, stages: bool) -> dict:
    """time_estimator at one batch: the bf16 kernel's forward alone beside
    its plain version (outputs compared at the bf16 tolerance), its bound
    and one PyTorch TransformerEncoder forward of the same weights; with
    `stages`, each kernel alone too. Emits the phase line and returns the
    kernel's numbers."""
    from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek

    t0 = time.perf_counter()
    B = x.shape[0]
    apply = ek.make_flash_feature_attention(module)
    library = library_forward(module)
    reps = 5 if B <= 8192 else 2
    apply(x)
    kernel_ms = cuda_ms(lambda: apply(x), reps)
    got = apply(x)
    parts = []

    def plain():
        parts[:] = [apply.plain(x[i:i + EST_PLAIN_CHUNK]) for i in range(0, B, EST_PLAIN_CHUNK)]

    if B <= EST_PLAIN_CHUNK:
        plain()     # first use of the library's products outside the timing
    plain_ms = cuda_ms(plain, 1)
    want = torch.cat(parts)
    del parts[:]
    e = bf16_errors(got, want)
    if not (e["within"] and torch.isfinite(got).all()):
        raise AssertionError(f"{model} B={B} kernel vs plain: {e}")
    library(x)
    library_ms = cuda_ms(lambda: library(x), reps)
    lib_e = bf16_errors(library(x), want)
    n_ops = estimator_ops(module, B)
    n_bytes = estimator_bytes(module, B, esize=2)
    t_ops = n_ops / PEAK_BF16_OPS_PER_S * 1e3
    t_bytes = n_bytes["function"] / PEAK_BYTES_PER_S * 1e3
    out = {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "bytes" if t_bytes > t_ops else "operations",
           "max_abs_err": e["max_abs"]}
    emit({"phase": "time_estimator", "model": model, "dtype": "bfloat16",
          "B": B, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "plain_chunk": EST_PLAIN_CHUNK, "library_ms": library_ms,
          "library": "nn.TransformerEncoder(norm_first, eps=1e-6) in bf16 + torch encode/head",
          "ops": n_ops, "bytes_function": n_bytes["function"],
          "bytes_design": n_bytes["design"], "bound_ops_ms": t_ops,
          "bound_bytes_ms": t_bytes,
          "bound_design_bytes_ms": n_bytes["design"] / PEAK_BYTES_PER_S * 1e3,
          "kernel_tflops": n_ops / kernel_ms / 1e9,
          "kernel_vs_plain": e, "library_vs_plain": lib_e,
          "library_within_bf16_tolerance": lib_e["within"],
          "stages": stage_times(module, B) if stages else None,
          "seconds": time.perf_counter() - t0})
    return out


def estimator_phases() -> dict:
    """check_estimator, main_estimator and time_estimator; returns the
    estimator kernel's entry of the `kernels` line."""
    from humanoid_mppi_rl_tpu_torch.collect.estimator import (
        ESTIMATOR_CONFIGS, quadruped_estimator_costs)
    from humanoid_mppi_rl_tpu_torch.dynamics.learned import make_learned_dynamics
    from humanoid_mppi_rl_tpu_torch.models.convert import load_trained
    from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
    from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek
    from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState, make_mppi

    # the plain version's products in full f32: no TF32, and no reduced-
    # precision reductions in bf16 products (PyTorch's default allows them)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    def x_on_card(B, F, seed):
        x = np.random.default_rng(seed).normal(size=(B, F))
        return torch.tensor(x, dtype=torch.float32, device="cuda")

    # ---- check_estimator: kernel against its plain version -----------------
    t0 = time.perf_counter()
    errs = {}
    for preset in EST_PRESETS:
        module = seeded_weights(make_model(preset), seed=1)
        applies = {cd: ek.make_flash_feature_attention(module, cd)
                   for cd in (torch.float32, torch.bfloat16)}
        for B in EST_CHECK_B:
            x = x_on_card(B, module.input_dim, seed=B)
            plain = {}
            for cd, apply in applies.items():
                n0 = ek.launches
                got = apply(x)
                torch.cuda.synchronize()
                if ek.launches != n0 + 1:
                    raise AssertionError("estimator kernel launch was not counted")
                want = plain[cd] = apply.plain(x)
                key = f"{preset}/{str(cd).replace('torch.', '')}/B={B}"
                if tuple(got.shape) != (B, module.state_dim) or not torch.isfinite(got).all():
                    raise AssertionError(f"{key}: bad kernel output")
                if cd == torch.float32:
                    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=key)
                    errs[key] = {"max_abs": float((got - want).abs().max())}
                else:
                    e = bf16_errors(got, want)
                    if not e["within"]:
                        raise AssertionError(f"{key}: {e}")
                    # for scale: how far bf16 itself lies from f32
                    e["plain_bf16_vs_f32_median_abs"] = float(
                        (plain[torch.bfloat16] - plain[torch.float32]).abs().median())
                    errs[key] = e
    # each kernel alone on inputs whose sums are exact in any order: bf16
    # roundings placed anywhere but where the plain version places them
    # show as differences here, which summation order cannot explain
    exact = {}
    for preset in EST_PRESETS:
        cases = exact_stage_cases(make_model(preset), B=EST_CHECK_B[-1], seed=5)
        for name, (stage, args, kw) in cases.items():
            kernel, plain = ek.STAGES[stage]
            got, want = kernel(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            key = f"{preset}/{name}"
            differ = int((got != want).sum())
            exact[key] = {"differ": differ, "of": want.numel()}
            if differ or not torch.isfinite(got).all():
                raise AssertionError(f"{key}: kernel and plain differ in {differ} of "
                                     f"{want.numel()} (max {float((got - want).abs().max())})")
    emit({"phase": "check_estimator", "presets": list(EST_PRESETS), "B": list(EST_CHECK_B),
          "tolerance": {"float32": "rtol=atol=1e-4",
                        "bfloat16": "median|diff|<=3e-3*s, max|diff|<=3e-2*s, s=max(1,max|y|)",
                        "bit_exact_stages_bf16": "equal (exact_stage_cases, B=61)"},
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "errors": errs, "bit_exact_stages_bf16": exact,
          "seconds": time.perf_counter() - t0})

    # ---- main_estimator: the estimator replan at full width ----------------
    t0 = time.perf_counter()
    module = seeded_weights(make_model("quadruped_attention"), seed=0)
    with torch.no_grad():
        # a trained surrogate predicts small per-step deltas: scale the head
        # so that 50 seeded steps stay near the start and the weights spread
        module.output_layer.weight.mul_(0.01)
        module.output_layer.bias.mul_(0.01)
    apply = ek.make_flash_feature_attention(module)
    running, terminal = quadruped_estimator_costs()
    cfg = ESTIMATOR_CONFIGS["quadruped"]
    plan = make_mppi(make_learned_dynamics(apply, state_slice=module.state_dim), running, cfg,
                     terminal_fn=terminal)
    ms = MPPIState.seeded(0, cfg.T, module.action_dim)
    x0 = torch.tensor(np.random.default_rng(0).normal(0, 0.1, module.state_dim),
                      dtype=torch.float32, device="cuda")
    ek.launches = 0
    ek.kernel_launches.update(dict.fromkeys(ek.KINDS, 0))
    times = []
    for i in range(EST_WARMUP + EST_TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        action, ms, diag = plan(ms, x0)
        b.record()
        torch.cuda.synchronize()
        if i >= EST_WARMUP:
            times.append(a.elapsed_time(b))
    est_launches, per_kind = ek.launches, dict(ek.kernel_launches)
    n_replans = EST_WARMUP + EST_TIMED
    if est_launches != cfg.T * n_replans:
        raise AssertionError(f"{est_launches} estimator forwards for {n_replans} replans of T={cfg.T}")
    outs = {"action": action, "U": ms.U, **dataclasses.asdict(diag)}
    for name, v in outs.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite {name}")
    if tuple(action.shape) != (module.action_dim,) or tuple(ms.U.shape) != (cfg.T, module.action_dim):
        raise AssertionError("unexpected output shapes")
    q1, q3 = np.percentile(times, [25, 75])
    med = statistics.median(times)
    prof = device_profile(lambda: plan(ms, x0))
    emit({"phase": "main_estimator", "model": "quadruped_attention", "dtype": "bfloat16",
          "K": cfg.K, "T": cfg.T, "replans": EST_TIMED, "launches": est_launches,
          "launches_per_replan": est_launches / n_replans, "kernel_launches": per_kind,
          "replan_ms_median": med, "replan_ms_q1": float(q1), "replan_ms_q3": float(q3),
          "replan_ms_min": min(times), "replan_ms_max": max(times),
          "rollouts_per_s": cfg.K / (med / 1e3),
          "beta": float(diag.beta), "ess": float(diag.ess),
          "profiled_replan": prof, "seconds": time.perf_counter() - t0})

    # ---- time_estimator: one forward alone ---------------------------------
    module = seeded_weights(make_model("quadruped_attention"), seed=0)
    timed = {}
    for B in EST_TIME_B:
        x = x_on_card(B, module.input_dim, seed=3)
        timed[B] = time_forward(module, x, "quadruped_attention",
                                stages=B == ESTIMATOR_CONFIGS["quadruped"].K)
        del x
        torch.cuda.empty_cache()
    # the humanoid closed loop's forward: the trained rollout_k surrogate at
    # the loop's B on its own inputs
    human = time_forward(load_trained("rollout_k_surrogate_best"),
                         humanoid_loop_inputs(HUM_LOOP_K, seed=3),
                         "humanoid_attention (trained rollout_k_surrogate)", stages=False)
    torch.cuda.empty_cache()

    main_b = ESTIMATOR_CONFIGS["quadruped"].K
    check_max = max(v["max_abs"] for k, v in errs.items() if "bfloat16" in k)
    return {
        "name": "estimator",
        "route": "cuda",
        "source": "humanoid_mppi_rl_tpu_torch/ops/csrc/estimator_kernel.cu",
        "replaces": "humanoid_mppi_rl_tpu/ops/estimator_kernel.py:129",
        "launches": est_launches,
        "kernel_launches": per_kind,
        "max_abs_err": timed[main_b]["max_abs_err"],
        "max_abs_err_check_bf16": check_max,
        "max_abs_err_check_f32": max(v["max_abs"] for k, v in errs.items() if "float32" in k),
        "bit_exact_stage_cases_bf16": len(exact),
        "ms": timed[main_b]["kernel_ms"],
        "plain_ms": timed[main_b]["plain_ms"],
        "bound_ms": timed[main_b]["bound_ms"],
        "bound_by": timed[main_b]["bound_by"],
        "library_ms": timed[main_b]["library_ms"],
        "at_B": main_b,
        "B65536": timed[EST_TIME_B[-1]],
        "humanoid_attention_trained_B2048": human,
    }


# ---- the Go1 learning loop (scripts/quad_pipeline.py's train and estimator stages)

QUAD_ROLLOUT_K = 8
# quad_data_goal's shape: 16 saved runs, 42,597 pairs (42,613 rows)
QUAD_DATA_RUNS, QUAD_DATA_PAIRS = 16, 42597
CHAIN_EPOCHS, CHAIN_CKPT_EVERY = 10, 5
# the chain's 42 rows make 32 windows of k=8 (all in the timed run: the
# warm-up's 2 rows hold none), at eval split 0.5 one full train and one
# full eval batch of CHAIN_BATCH (the preset's 64 needed 150 rows); its 40
# pairs' training half (20) fills a batch too, which keeps train_model on
# its scanned rollout_k path
CHAIN_EVAL_SPLIT, CHAIN_BATCH = 0.5, 16
TRAIN_WARMUP_STEPS, TRAIN_TIMED_STEPS, TRAIN_SYNC_STEPS = 10, 100, 10
EST_LOOP_K, EST_LOOP_T = 2048, 32
# the Go1 loop's depth, cut to leave the run time for the later phases:
# 2 warm-up, 2 timed and 1 split steps (5, 50 and 6, then 3, 20 and 4,
# then 3, 10 and 4, then 3, 2 and 4, then 3, 2 and 2)
EST_LOOP_WARMUP, EST_LOOP_TIMED, EST_LOOP_SPLIT = 2, 2, 1
# the humanoid loop (scripts/dev_estimator_walk.py --configs fk): K=2048,
# T=25; 3 timed control steps of the JAX record's 120, cut for the run
# time (120, 60, 10, then 5 before; 3 warm-up and 3 split steps: 5, 10,
# then 5 before)
HUM_LOOP_K, HUM_LOOP_T = 2048, 25
HUM_LOOP_WARMUP, HUM_LOOP_TIMED, HUM_LOOP_SPLIT = 3, 3, 3
# the JAX record (artifacts/rollout_k_surrogate/estimator_summary.json,
# closed_loop.fk_cost_K2048_T25, on a TPU, another noise stream)
HUM_JAX_RECORD = {"steps": 120, "K": 2048, "T": 25, "forward_progress_m": 0.159,
                  "torso_z_min": 1.18}
# the JAX record (artifacts/quad_pipeline/summary.json and its
# estimator_closedloop.npz, 200 steps on a TPU): behaviour, not a target
JAX_LOOP_RECORD = {"steps": 200, "min_trunk_z": 0.27, "forward_progress_m": -0.1682,
                   "forward_progress_m_first_50": -0.010717, "min_trunk_z_first_50": 0.27}


def quad_train_config(ckpt_dir: str, **overrides):
    """PRESET_CONFIGS["quadruped"] with scripts/quad_pipeline.py's train
    overrides (the qpos surrogate: 19 state columns, rollout_k=8, global-norm
    clip 1.0, ego root x/y, scanned epochs)."""
    from humanoid_mppi_rl_tpu_torch.learning.train import PRESET_CONFIGS

    kw = dict(ckpt_dir=ckpt_dir, scan_epochs=True, rollout_k=QUAD_ROLLOUT_K, grad_clip=1.0,
              state_idxes=tuple(range(19)), model_overrides={"state_dim": 19},
              ego_xy_cols=(0, 1))
    kw.update(overrides)
    return dataclasses.replace(PRESET_CONFIGS["quadruped"], **kw)


def write_runs(root: str, runs: dict) -> tuple:
    """{name: (states, actions)} as <root>/{states,actions}/<name>.csv (the
    flat layout quad_pipeline trains from); returns the two dirs."""
    from humanoid_mppi_rl_tpu_torch.utils.trajio import write_csv

    dirs = tuple(os.path.join(root, kind) for kind in ("states", "actions"))
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for name, arrays in runs.items():
        for d, a in zip(dirs, arrays):
            write_csv(os.path.join(d, f"{name}.csv"), a)
    return dirs


def quad_linear_runs(seed: int = 0) -> dict:
    """QUAD_DATA_RUNS runs of [qpos-like (19); qvel-like (18)] rows and 12
    actions, QUAD_DATA_PAIRS pairs in all, from a stable numpy linear plant
    whose first 19 columns evolve on their own (so a net given those
    columns and the actions can fit them)."""
    rng = np.random.default_rng(seed)
    n_rows = QUAD_DATA_PAIRS + QUAD_DATA_RUNS
    lengths = [n_rows // QUAD_DATA_RUNS + (i < n_rows % QUAD_DATA_RUNS)
               for i in range(QUAD_DATA_RUNS)]
    A = 0.97 * np.eye(37) + 0.02 * rng.normal(size=(37, 37)) / np.sqrt(37)
    A[:19, 19:] = 0.0
    B = 0.05 * rng.normal(size=(37, 12))
    runs = {}
    for i, n in enumerate(lengths):
        u = 0.3 * rng.normal(size=(n, 12))
        x = np.empty((n, 37))
        x[0] = 0.3 * rng.normal(size=37)
        for t in range(n - 1):
            x[t + 1] = A @ x[t] + B @ u[t]
        runs[f"run_{i:03d}"] = (x, u)
    return runs


def count_syncs(fn):
    """(fn's result, the synchronizing CUDA calls it made), counted with
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchronizing" in str(w.message) for w in caught)


def train_phase(collected: dict) -> dict:
    """train (see the module docstring): (a) the chain on main_quad_collect's
    rows, (b) the step's time on a dataset of quad_data_goal's shape."""
    from humanoid_mppi_rl_tpu_torch.learning import train as tr
    from humanoid_mppi_rl_tpu_torch.learning.data import MultiTrajectoryDataset
    from humanoid_mppi_rl_tpu_torch.models.predictors import make_model

    # ---- (a) the chain: collect -> CSV -> dataset -> train -> checkpoints --
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        sdir, adir = write_runs(os.path.join(root, "data"), collected)
        ck = os.path.join(root, "ckpt")
        cfg = quad_train_config(ck, epochs=CHAIN_EPOCHS, ckpt_every=CHAIN_CKPT_EVERY,
                                eval_split=CHAIN_EVAL_SPLIT, batch_size=CHAIN_BATCH)
        out = tr.train_model(sdir, adir, cfg)
        torch.cuda.synchronize()
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            epochs = [e for e in map(json.loads, f) if e["kind"] == "epoch"]
        files = sorted(os.listdir(ck))
        model = out["model"]
        x = torch.tensor(np.concatenate([collected["timed"][0][:64, :19],
                                         collected["timed"][1][:64]], axis=1),
                         dtype=torch.float32, device="cuda")
        with torch.no_grad():
            mine = model.eval()(x)
            final = tr.load_checkpoint(out["final_checkpoint"],
                                       make_model("quadruped_attention", state_dim=19).cuda())(x)
            best = tr.load_checkpoint(out["best_checkpoint"],
                                      make_model("quadruped_attention", state_dim=19).cuda())(x)
    train_l = [e["train_loss"] for e in epochs]
    eval_l = [e["eval_loss"] for e in epochs]
    best_epoch = int(np.argmin(eval_l))
    want_files = {"model_best.pt", "model_final.pt", "state_last.pt", "train_summary.json",
                  "metrics.jsonl"} | {f"model_epoch_{e}.pt" for e in
                                      range(CHAIN_CKPT_EVERY, CHAIN_EPOCHS + 1, CHAIN_CKPT_EVERY)}
    if len(epochs) != CHAIN_EPOCHS or not np.isfinite(train_l + eval_l).all():
        raise AssertionError(f"chain losses: train {train_l}, eval {eval_l}")
    if not eval_l[-1] < eval_l[0]:
        raise AssertionError(f"the chain's eval loss did not fall: {eval_l}")
    if not want_files <= set(files):
        raise AssertionError(f"chain checkpoints: {files}")
    if not torch.equal(final, mine):
        raise AssertionError("model_final's forward differs from the trained module's")
    if best_epoch == CHAIN_EPOCHS - 1 and not torch.equal(best, mine):
        raise AssertionError("model_best (the last epoch) differs from the trained module")
    if not torch.isfinite(best).all():
        raise AssertionError("model_best's forward is not finite")
    chain = {"rows": {k: list(v[0].shape) for k, v in collected.items()},
             "n_pairs": out["n_pairs"], "epochs": CHAIN_EPOCHS, "eval_split": CHAIN_EVAL_SPLIT,
             "train_loss": train_l, "eval_loss": eval_l, "best_epoch": best_epoch,
             "checkpoints": files, "seconds": time.perf_counter() - t0}

    # ---- (b) the step's time on quad_data_goal's shape ----------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        sdir, adir = write_runs(root, quad_linear_runs(seed=0))
        cfg = quad_train_config(os.path.join(root, "ckpt"))
        ds = MultiTrajectoryDataset(sdir, adir, return_type=cfg.return_type,
                                    eval_split=cfg.eval_split, state_idxes=cfg.state_idxes,
                                    seed=cfg.seed, rollout_k=cfg.rollout_k)
    if len(ds) != QUAD_DATA_PAIRS or ds.n_trajectories != QUAD_DATA_RUNS:
        raise AssertionError(f"dataset: {len(ds)} pairs in {ds.n_trajectories} runs")
    dev = torch.device("cuda")
    B, k = cfg.batch_size, cfg.rollout_k
    steps_per_epoch = len(ds.win_train_idx) // B
    model, state = tr.create_train_state(cfg, ds.inputs[:1], steps_per_epoch)
    S = torch.as_tensor(ds.win_states, device=dev)
    A = torch.as_tensor(ds.win_actions, device=dev)
    train_epoch, eval_all = tr.make_scanned_rollout_steps(S, A, k, ego_cols=cfg.ego_xy_cols)
    perm = np.random.default_rng(0).permutation(len(ds.win_train_idx))
    pool = np.asarray(ds.win_train_idx, np.int64)[perm]
    n_idx = TRAIN_WARMUP_STEPS + 1 + 2 * TRAIN_TIMED_STEPS
    idx = tr.to_device(pool[: n_idx * B].reshape(n_idx, B), dev)
    parts = np.cumsum([0, TRAIN_WARMUP_STEPS, 1, TRAIN_TIMED_STEPS])
    warm_i, err_i, step_i = (idx[a:b] for a, b in zip(parts[:-1], parts[1:]))
    epoch_i = idx[parts[-1]:]
    gen = tr.epoch_generator(cfg.seed, 0, dev)
    state, loss0 = train_epoch(state, warm_i, gen)
    first_loss = float(loss0)
    def one_epoch():
        """An epoch as train_model runs it: the index upload, the steps,
        the loss fetch."""
        _, loss = train_epoch(state, tr.to_device(pool[:TRAIN_SYNC_STEPS * B].reshape(-1, B),
                                                  dev), gen)
        return float(loss)

    sync_loss, syncs = count_syncs(one_epoch)
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, err_loss = train_epoch(state, err_i, gen)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    # per step: single-step epochs back to back, CUDA events around each
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED_STEPS + 1)]
    ev[0].record()
    h0 = time.perf_counter()
    for i in range(TRAIN_TIMED_STEPS):
        state, _ = train_epoch(state, step_i[i:i + 1], gen)
        ev[i + 1].record()
    torch.cuda.synchronize()
    host_step_ms = (time.perf_counter() - h0) / TRAIN_TIMED_STEPS * 1e3
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TRAIN_TIMED_STEPS)]
    # one scanned epoch of TRAIN_TIMED_STEPS steps, its memory peak
    torch.cuda.reset_peak_memory_stats()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    state, loss_epoch = train_epoch(state, epoch_i, gen)
    b.record()
    last_loss = float(loss_epoch)
    scanned_ms = a.elapsed_time(b) / TRAIN_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    prof = device_profile(lambda: train_epoch(state, warm_i, gen))
    n_ev = len(ds.win_eval_idx) // B
    ev_out = eval_all(model, tr.to_device(
        np.asarray(ds.win_eval_idx[: n_ev * B], np.int64).reshape(n_ev, B), dev))
    eval_loss = float(ev_out[0].mean())
    losses = [first_loss, sync_loss, float(err_loss), last_loss, eval_loss]
    if not np.isfinite(losses).all():
        raise AssertionError(f"train losses {losses}")
    if syncs != 1:
        raise AssertionError(f"{syncs} host syncs in one scanned epoch (1 expected)")
    med = statistics.median(step_ms)
    q1, q3 = np.percentile(step_ms, [25, 75])
    timing = {"model": "quadruped_attention, state_dim=19 (F=31, H=512, 4 heads, 2 layers)",
              "dtype": "float32", "tf32": torch.backends.cuda.matmul.allow_tf32,
              "batch": B, "rollout_k": k, "n_pairs": len(ds), "n_windows": len(ds.win_states),
              "steps_per_epoch": steps_per_epoch, "timed_steps": TRAIN_TIMED_STEPS,
              "step_ms_median": med, "step_ms_q1_q3": [float(q1), float(q3)],
              "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
              "host_step_ms_mean": host_step_ms, "scanned_epoch_step_ms": scanned_ms,
              "windows_per_s": B / (med / 1e3), "pairs_per_s": B * k / (med / 1e3),
              "projected_epoch_s": steps_per_epoch * scanned_ms / 1e3,
              "peak_memory_bytes": peak, "host_syncs_per_epoch": syncs,
              "sync_free_step": True, "device_busy_share": prof["device_busy_share"],
              "profiled_epoch": {"steps": TRAIN_WARMUP_STEPS, "wall_ms": prof["wall_ms"],
                                 "device_busy_ms": prof["device_busy_ms"],
                                 "top_kernels_ms": dict(list(
                                     prof["device_ms_by_kernel"].items())[:8])},
              "loss_first_steps": first_loss, "loss_last_epoch": last_loss,
              "eval_loss": eval_loss, "seconds": time.perf_counter() - t0}
    emit({"phase": "train", "chain": chain, "timing": timing})
    return {"train_step_ms": med, "host_syncs_per_epoch": syncs}


def go1_loop_inputs(B: int, seed: int):
    """The Go1 closed loop's net inputs: home poses (root x/y zeroed, its
    ego columns) and home leg targets, perturbed: (B, 31) f32 on the card."""
    from humanoid_mppi_rl_tpu_torch.physics.model import load_model

    home = dict(load_model("go1_plant").keyframes)["home"]
    rng = np.random.default_rng(seed)
    q = home[:19] + 0.05 * rng.normal(size=(B, 19))
    q[:, :2] = 0.0
    u = home[7:19] + 0.18 * rng.normal(size=(B, 12))
    return torch.tensor(np.concatenate([q, u], axis=1), dtype=torch.float32, device="cuda")


def humanoid_loop_inputs(B: int, seed: int):
    """The humanoid closed loop's net inputs [qpos; foot_left z; foot_right
    z; u]: plant poses about qpos0 (root x/y as the plant gives them),
    their foot heights from the batched forward kinematics, and controls
    of the loop's sigma: (B, 51) f32 on the card."""
    from humanoid_mppi_rl_tpu_torch.collect.estimator import ESTIMATOR_CONFIGS
    from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
    from humanoid_mppi_rl_tpu_torch.physics.model import load_model

    pm = load_model("humanoid_plant")
    rng = np.random.default_rng(seed)
    q = pm.qpos0 + 0.05 * rng.normal(size=(B, pm.nq))
    q[:, :2] += 0.3 * rng.normal(size=(B, 2))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=-1, keepdims=True)
    eng = Engine(pm, "cuda", torch.float32)
    st = eng.forward(torch.tensor(q, dtype=torch.float32, device="cuda"),
                     torch.zeros(B, pm.nv, device="cuda"))
    feet = st.xpos[:, [pm.body_id("foot_left"), pm.body_id("foot_right")], 2]
    u = ESTIMATOR_CONFIGS["humanoid"].sigma * rng.normal(size=(B, pm.nu))
    return torch.cat([st.qpos, feet, torch.tensor(u, dtype=torch.float32, device="cuda")], 1)


# check_estimator_trained's weights: (asset, model, net inputs, batch sizes)
TRAINED_CHECKS = (
    ("quad_pipeline_best", "quadruped_attention, state_dim=19 (F=31)", go1_loop_inputs,
     (EST_LOOP_K, 253)),
    ("rollout_k_surrogate_best", "humanoid_attention (F=51, H=512, 8 heads, 7 layers)",
     humanoid_loop_inputs, (HUM_LOOP_K, 253)),
)


def check_weights(name: str, module, x_of, batches) -> dict:
    """The estimator kernel against its plain version on one set of
    weights, f32 and bf16, at each B of `batches` on x_of(B, seed): the
    gates of check_estimator. Returns the errors by dtype and B."""
    from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek

    errs = {}
    for B in batches:
        x = x_of(B, seed=B)
        for cd in (torch.float32, torch.bfloat16):
            apply = ek.make_flash_feature_attention(module, cd)
            n0 = ek.launches
            got = apply(x)
            torch.cuda.synchronize()
            if ek.launches != n0 + 1:
                raise AssertionError("estimator kernel launch was not counted")
            want = apply.plain(x)
            key = f"{str(cd).replace('torch.', '')}/B={B}"
            if tuple(got.shape) != (B, module.state_dim) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {key}: bad kernel output")
            if cd == torch.float32:
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4, msg=f"{name} {key}")
                errs[key] = {"max_abs": float((got - want).abs().max()),
                             "max_abs_y": float(want.abs().max())}
            else:
                e = bf16_errors(got, want)
                if not e["within"]:
                    raise AssertionError(f"{name} {key}: {e}")
                errs[key] = e
    return errs


def check_trained_phase() -> dict:
    """check_estimator_trained: the estimator kernel against its plain
    version on each set of trained weights at its closed loop's inputs.
    Returns {asset: errors by dtype and B}."""
    from humanoid_mppi_rl_tpu_torch.models.convert import load_trained

    out = {}
    for name, model, inputs, batches in TRAINED_CHECKS:
        t0 = time.perf_counter()
        errs = check_weights(name, load_trained(name), inputs, batches)
        emit({"phase": "check_estimator_trained", "weights": f"assets/{name}.pt",
              "model": model, "B": list(batches),
              "tolerance": {"float32": "rtol=atol=1e-4",
                            "bfloat16": "median|diff|<=3e-3*s, max|diff|<=3e-2*s, "
                                        "s=max(1,max|y|)"},
              "errors": errs, "seconds": time.perf_counter() - t0})
        out[name] = errs
    return out


def estimator_loop_phase() -> dict:
    """main_estimator_loop: quad_pipeline's estimator stage on the card."""
    import dataclasses as dc

    from humanoid_mppi_rl_tpu_torch.collect.estimator import (
        ESTIMATOR_CONFIGS, EstimatorRunner, quadruped_fd_gait_estimator_costs)
    from humanoid_mppi_rl_tpu_torch.models.convert import load_trained
    from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek
    from humanoid_mppi_rl_tpu_torch.physics.model import load_model

    t0 = time.perf_counter()
    pm = load_model("go1_plant")
    home = dict(pm.keyframes)["home"]
    lo, hi = pm.ctrl_range()
    # scripts/quad_pipeline.py:233-270
    cfg = dc.replace(ESTIMATOR_CONFIGS["quadruped"], n_samples=EST_LOOP_K, horizon=EST_LOOP_T,
                     update_mode="accumulate", sigma=0.3 * 0.6, tail_decay=0.0,
                     ctrl_low=tuple(float(v) for v in lo), ctrl_high=tuple(float(v) for v in hi),
                     clamp_rollout_ctrl=True)
    running, terminal = quadruped_fd_gait_estimator_costs(home[7:19], dt=float(pm.timestep))
    runner = EstimatorRunner("go1_collect", load_trained("quad_pipeline_best"), cfg, running,
                             terminal, state_fn=lambda plant: plant.qpos, batched_dynamics=True,
                             fd_time_augment=19, ego_cols=(0, 1))
    start = dict(init_qpos=home, init_plan=home[7:19], seed=0)
    ek.launches = 0
    ek.kernel_launches.update(dict.fromkeys(ek.KINDS, 0))
    warm = runner.run(n_steps=EST_LOOP_WARMUP, chunk=EST_LOOP_WARMUP, **start)
    torch.cuda.synchronize()
    warm_launches = ek.launches
    h0 = time.perf_counter()
    log = runner.run(n_steps=EST_LOOP_TIMED, chunk=EST_LOOP_TIMED, **start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - h0
    launches, per_kind = ek.launches, dict(ek.kernel_launches)
    n_steps = EST_LOOP_WARMUP + EST_LOOP_TIMED
    if (warm_launches, launches) != (EST_LOOP_WARMUP * cfg.T, n_steps * cfg.T):
        raise AssertionError(f"estimator forwards {warm_launches}/{launches} for "
                             f"{EST_LOOP_WARMUP}/{n_steps} control steps of T={cfg.T}")
    heights = []
    for name, lg, n in (("warm-up", warm, EST_LOOP_WARMUP), ("timed", log, EST_LOOP_TIMED)):
        states, actions, times = lg.arrays()
        if states.shape != (n, 37) or actions.shape != (n, 12) or times.shape != (n,):
            raise AssertionError(f"estimator loop {name}: {states.shape} {actions.shape}")
        if not (np.isfinite(states).all() and np.isfinite(actions).all()):
            raise AssertionError(f"estimator loop {name}: non-finite rows")
        heights.append(states[:, 2])
    heights = np.concatenate(heights)
    if heights.min() < GO1_FALL_Z:
        raise AssertionError(f"the Go1 fell in the closed loop: trunk {heights.min():.3f}")
    states, actions, _ = log.arrays()

    # control steps one at a time: plan and plant apart by CUDA events
    ms, plant = runner.start(**start)
    plan_ms, plant_ms, step_ms = [], [], []
    with torch.no_grad():
        for _ in range(EST_LOOP_SPLIT):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            h = time.perf_counter()
            ev[0].record()
            action, ms, _ = runner.plan(ms, runner.extract(plant))
            ev[1].record()
            plant = runner.plant_dyn(plant, action)
            ev[2].record()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - h) * 1e3)
            plan_ms.append(ev[0].elapsed_time(ev[1]))
            plant_ms.append(ev[1].elapsed_time(ev[2]))
    n0, k0 = ek.launches, dict(ek.kernel_launches)
    prof = device_profile(lambda: runner.control_step(ms, plant), launches_top=12)
    prof_kinds = {kk: ek.kernel_launches[kk] - k0[kk] for kk in ek.KINDS}
    prof_forwards = ek.launches - n0
    by_kernel = prof["device_launches"]
    if prof_forwards != cfg.T:
        raise AssertionError(f"{prof_forwards} estimator forwards in a control step (T={cfg.T})")
    q = lambda v: [float(x) for x in np.percentile(v, [25, 75])]
    emit({"phase": "main_estimator_loop", "task": "go1_collect",
          "weights": "assets/quad_pipeline_best.pt", "K": cfg.K, "T": cfg.T,
          "dtype": "bfloat16 surrogate, float32 plant", "cost": "quadruped_fd_gait",
          "update_mode": cfg.update_mode, "sigma": cfg.sigma,
          "steps": n_steps, "timed_steps": EST_LOOP_TIMED,
          "control_step_ms_mean_timed_run": wall / EST_LOOP_TIMED * 1e3,
          "split_steps": EST_LOOP_SPLIT,
          "control_step_host_ms_median": statistics.median(step_ms),
          "control_step_host_ms_q1_q3": q(step_ms),
          "plan_ms_median": statistics.median(plan_ms), "plan_ms_q1_q3": q(plan_ms),
          "plant_ms_median": statistics.median(plant_ms), "plant_ms_q1_q3": q(plant_ms),
          "plan_ms": plan_ms, "plant_ms": plant_ms,
          "estimator_forwards_per_control_step": launches / n_steps,
          "estimator_kernel_launches": per_kind,
          "profiled_control_step": {"estimator_forwards": prof_forwards,
                                    "estimator_kernels_by_kind": prof_kinds,
                                    "device_launches": by_kernel,
                                    "wall_ms": prof["wall_ms"],
                                    "device_busy_ms": prof["device_busy_ms"],
                                    "device_busy_share": prof["device_busy_share"]},
          "trunk_z_min": float(heights.min()),
          "forward_progress_m": float(states[-1, 0] - states[0, 0]),
          "final_root_xyz": [float(v) for v in states[-1, :3]],
          "jax_record_tpu": JAX_LOOP_RECORD,
          "seconds": time.perf_counter() - t0})
    return {"launches": launches, "control_steps": n_steps,
            "control_step_ms_median": statistics.median(step_ms)}


def humanoid_estimator_loop_phase() -> dict:
    """main_humanoid_estimator_loop: scripts/dev_estimator_walk.py --configs
    fk on the card -- the trained rollout_k surrogate through the estimator
    kernel (bf16), the walking cost on FK of its predicted qpos, the
    humanoid's coupled plant (f32)."""
    import dataclasses as dc

    from humanoid_mppi_rl_tpu_torch.collect.estimator import (
        ESTIMATOR_CONFIGS, EstimatorRunner, humanoid_fk_estimator_costs,
        humanoid_foot_state_fn)
    from humanoid_mppi_rl_tpu_torch.models.convert import load_trained
    from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek
    from humanoid_mppi_rl_tpu_torch.physics.model import load_model

    t0 = time.perf_counter()
    pm = load_model("humanoid_plant")
    cfg = dc.replace(ESTIMATOR_CONFIGS["humanoid"], n_samples=HUM_LOOP_K, horizon=HUM_LOOP_T)
    running, terminal = humanoid_fk_estimator_costs(pm)
    runner = EstimatorRunner("humanoid_collect", load_trained("rollout_k_surrogate_best"), cfg,
                             running, terminal, state_fn=humanoid_foot_state_fn(pm),
                             batched_dynamics=True, fd_time_augment=30)
    ek.launches = 0
    ek.kernel_launches.update(dict.fromkeys(ek.KINDS, 0))
    warm = runner.run(n_steps=HUM_LOOP_WARMUP, chunk=HUM_LOOP_WARMUP, seed=0)
    torch.cuda.synchronize()
    warm_launches = ek.launches
    h0 = time.perf_counter()
    log = runner.run(n_steps=HUM_LOOP_TIMED, chunk=HUM_LOOP_TIMED, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - h0
    launches, per_kind = ek.launches, dict(ek.kernel_launches)
    n_steps = HUM_LOOP_WARMUP + HUM_LOOP_TIMED
    if (warm_launches, launches) != (HUM_LOOP_WARMUP * cfg.T, n_steps * cfg.T):
        raise AssertionError(f"estimator forwards {warm_launches}/{launches} for "
                             f"{HUM_LOOP_WARMUP}/{n_steps} control steps of T={cfg.T}")
    heights = []
    for name, lg, n in (("warm-up", warm, HUM_LOOP_WARMUP), ("timed", log, HUM_LOOP_TIMED)):
        states, actions, times = lg.arrays()
        if states.shape != (n, 55) or actions.shape != (n, 21) or times.shape != (n,):
            raise AssertionError(f"humanoid loop {name}: {states.shape} {actions.shape}")
        if not (np.isfinite(states).all() and np.isfinite(actions).all()):
            raise AssertionError(f"humanoid loop {name}: non-finite rows")
        heights.append(states[:, 2])
    states, actions, _ = log.arrays()

    # control steps one at a time: plan and plant apart by CUDA events
    ms, plant = runner.start(seed=0)
    plan_ms, plant_ms, step_ms, split_z = [], [], [], []
    with torch.no_grad():
        for _ in range(HUM_LOOP_SPLIT):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            h = time.perf_counter()
            ev[0].record()
            action, ms, _ = runner.plan(ms, runner.extract(plant))
            ev[1].record()
            plant = runner.plant_dyn(plant, action)
            ev[2].record()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - h) * 1e3)
            plan_ms.append(ev[0].elapsed_time(ev[1]))
            plant_ms.append(ev[1].elapsed_time(ev[2]))
            split_z.append(float(plant.qpos[2]))
    heights = np.concatenate(heights + [np.array(split_z)])
    if not np.isfinite(heights).all() or heights.min() < FALL_Z:
        raise AssertionError(f"the humanoid fell in the closed loop: root z {heights.min():.3f}")
    n0, k0 = ek.launches, dict(ek.kernel_launches)
    prof = device_profile(lambda: runner.control_step(ms, plant), launches_top=12)
    prof_kinds = {kk: ek.kernel_launches[kk] - k0[kk] for kk in ek.KINDS}
    prof_forwards = ek.launches - n0
    if prof_forwards != cfg.T:
        raise AssertionError(f"{prof_forwards} estimator forwards in a control step (T={cfg.T})")
    by_kernel = prof["device_launches"]
    k1 = dict(ek.kernel_launches)
    with torch.no_grad():
        plan_launches = device_launches(lambda: runner.plan(ms, runner.extract(plant)))
    plan_est = sum(ek.kernel_launches[kk] - k1[kk] for kk in ek.KINDS)
    q = lambda v: [float(x) for x in np.percentile(v, [25, 75])]
    emit({"phase": "main_humanoid_estimator_loop", "task": "humanoid_collect",
          "weights": "assets/rollout_k_surrogate_best.pt",
          "model": "humanoid_attention (F=51, H=512, 8 heads, 7 layers)",
          "K": cfg.K, "T": cfg.T, "dtype": "bfloat16 surrogate, float32 plant and costs",
          "cost": "humanoid_fk_estimator_costs (humanoid_walk weights on FK of the "
                  "predicted qpos, FD velocities)",
          "update_mode": cfg.update_mode, "sigma": cfg.sigma, "temperature": cfg.temperature,
          "steps": n_steps, "timed_steps": HUM_LOOP_TIMED,
          "control_step_ms_mean_timed_run": wall / HUM_LOOP_TIMED * 1e3,
          "split_steps": HUM_LOOP_SPLIT,
          "control_step_host_ms_median": statistics.median(step_ms),
          "control_step_host_ms_q1_q3": q(step_ms),
          "plan_ms_median": statistics.median(plan_ms), "plan_ms_q1_q3": q(plan_ms),
          "plant_ms_median": statistics.median(plant_ms), "plant_ms_q1_q3": q(plant_ms),
          "plan_ms": plan_ms, "plant_ms": plant_ms,
          "estimator_forwards_per_control_step": launches / n_steps,
          "estimator_kernel_launches": per_kind,
          "profiled_control_step": {"estimator_forwards": prof_forwards,
                                    "estimator_kernels_by_kind": prof_kinds,
                                    "device_launches": by_kernel,
                                    "wall_ms": prof["wall_ms"],
                                    "device_busy_ms": prof["device_busy_ms"],
                                    "device_busy_share": prof["device_busy_share"]},
          "replan_device_launches": plan_launches,
          "replan_estimator_kernels": plan_est,
          "replan_launches_outside_estimator_kernel":
              None if plan_launches["kernels"] is None else plan_launches["kernels"] - plan_est,
          "root_z_min": float(heights.min()),
          "forward_progress_m": float(states[-1, 0] - states[0, 0]),
          "torso_z_min_timed": float(states[:, 2].min()),
          "final_root_xyz": [float(v) for v in states[-1, :3]],
          "jax_record": dict(HUM_JAX_RECORD, note="TPU, another noise stream"),
          "seconds": time.perf_counter() - t0})
    return {"launches": launches, "control_steps": n_steps,
            "control_step_ms_median": statistics.median(step_ms)}


def learning_phases(collected: dict) -> dict:
    """train, check_estimator_trained, main_estimator_loop and
    main_humanoid_estimator_loop; returns the numbers the estimator's entry
    of the `kernels` line adds."""
    train = train_phase(collected)
    checked = check_trained_phase()
    errs, herrs = checked["quad_pipeline_best"], checked["rollout_k_surrogate_best"]
    loop = estimator_loop_phase()
    hloop = humanoid_estimator_loop_phase()
    return {"paths": {"go1 estimator closed loop": {
                "launches": loop["launches"], "control_steps": loop["control_steps"]},
                      "humanoid estimator closed loop": {
                "launches": hloop["launches"], "control_steps": hloop["control_steps"]}},
            "max_abs_err_bf16_B2048": errs[f"bfloat16/B={EST_LOOP_K}"]["max_abs"],
            "max_abs_err_f32_B2048": errs[f"float32/B={EST_LOOP_K}"]["max_abs"],
            "closed_loop_control_step_ms": loop["control_step_ms_median"],
            "humanoid": {
                "max_abs_err_bf16_B2048": herrs[f"bfloat16/B={HUM_LOOP_K}"]["max_abs"],
                "max_abs_err_f32_B2048": herrs[f"float32/B={HUM_LOOP_K}"]["max_abs"],
                "closed_loop_control_step_ms": hloop["control_step_ms_median"]},
            "train_step_ms": train["train_step_ms"]}


# ---- slice 9: the cartpole and the planar hopper ---------------------------

# the swing-up of tests/test_e2e_cartpole.py: K=256 at the task's T=100, 400
# control steps from (0, pi); the pole upright over the last 40 steps
CART_K, CART_STEPS, CART_SETTLE = 256, 400, 40
CART_SPLIT_STEPS = 5   # 20 before, cut for the run time
# the hopper at artifacts/hopper_k4096.npz's K and H
# (tests/test_e2e_hopper.py:12-14): 3 warm-up, 10 timed and 3 split
# control steps (5 warm-up; 200, 100, 25, then 15 timed; 10, then 5 split
# before), cut for the run time
HOP_K, HOP_H, HOP_WARMUP, HOP_TIMED, HOP_SPLIT_STEPS = 4096, 100, 3, 10, 3
# check_hopper's param_gait deltas, slots 4..9: target velocity, landing
# weight, pitch log-scale, knee weight, hop-clock weight, knee anchor shift
HOP_GAIT = (0.2, 3.0, 0.3, 2.0, 5.0, -0.1)
# the cartpole learning loop: two cartpole_collect episodes (K=75, T=100,
# the reference's) of 100 steps, PRESET_CONFIGS["cartpole"] cut to 10
# epochs, then the closed loop at ESTIMATOR_CONFIGS["cartpole"]
# (episodes of 100 steps: 200 before, cut for the run time)
CART_EPISODES, CART_EPISODE_STEPS, CART_TRAIN_EPOCHS = 2, 100, 10
# 10 timed closed-loop steps (100, then 50 before), cut for the run time
CART_LOOP_WARMUP, CART_LOOP_TIMED, CART_LOOP_SPLIT = 3, 10, 5
CART_LOOP_CHECK_B = (2048, 253)
# hopper poses for the rollout checks (sample k in pose k % 4): (name, hip,
# knee, ankle, the foot's lowest point above the floor (m), vertical
# velocity mean (m/s)). "stand" and "crouch" put the foot 5 mm into the
# floor (crouch: torso below 0.85 m, the landing gate open); "falling" is
# the crouch 5 cm up, descending at 1.5 m/s (the landing term); "air" the
# straight leg 0.3 m up. The knee's range is 5..150 deg: the straight leg
# is past its lower limit.
HOPPER_POSES = (("stand", 0.0, 0.0, 0.0, -0.005, 0.0), ("crouch", -1.0, 2.0, -1.0, -0.005, 0.0),
                ("falling", -1.0, 2.0, -1.0, 0.05, -1.5), ("air", 0.0, 0.0, 0.0, 0.3, 0.0))


def cartpole_inputs(model, K, T, dtype, seed=0, device="cuda"):
    """Cartpole rollout inputs: the cart in [-1.15, 1.15] (past the slider's
    +-1 limit in about one sample in eight: the limit row acts), the pole
    at any angle, velocities N(0, 1), a plan and noise N(0, 0.5), start
    times in [0, 10] s."""
    rng = np.random.default_rng(seed)
    qpos = np.stack([rng.uniform(-1.15, 1.15, K), rng.uniform(-np.pi, np.pi, K)])
    qvel = rng.normal(0, 1.0, (model.nv, K))
    U = rng.normal(0, 0.5, (T, model.nu))
    noise = rng.normal(0, 0.5, (T, model.nu, K))
    t0 = rng.uniform(0, 10.0, (1, K))
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return tuple(as_t(a) for a in (qpos, qvel, t0, U, noise))


def hopper_foot_low(model, qpos: np.ndarray) -> np.ndarray:
    """Height (K,) of the foot capsule's lowest point for qpos (nq, K), by
    the port's kinematics on the CPU in f64."""
    from humanoid_mppi_rl_tpu_torch.physics import spatial as sp
    from humanoid_mppi_rl_tpu_torch.physics.engine import Engine

    eng = Engine(model, "cpu", torch.float64)
    st = eng.forward(torch.tensor(qpos.T), torch.zeros(qpos.shape[1], model.nv,
                                                       dtype=torch.float64))
    b = model.body_id("foot")
    g = next(g for g in model.geoms if g.bodyid == b)
    R = sp.quat_to_mat(st.xquat[:, b]).numpy()
    gp = st.xpos[:, b].numpy() + R @ np.asarray(g.pos)
    axis = R @ sp.quat_to_mat(torch.tensor(g.quat)).numpy()[:, 2]
    hl = float(g.size[1]) * np.abs(axis[:, 2])
    return gp[:, 2] - hl - float(g.size[0])


def hopper_states(model, K: int, seed: int = 0):
    """qpos (nq, K), qvel (nv, K) numpy arrays: sample k in pose
    HOPPER_POSES[k % 4], leg angles and torso pitch perturbed by N(0, 0.05),
    rootx in [-0.5, 0.5], the root height set so that the foot's lowest
    point is the pose's; velocities N(0, 0.3) plus the pose's vertical
    velocity."""
    rng = np.random.default_rng(seed)
    qpos = np.zeros((model.nq, K))
    qvel = rng.normal(0, 0.3, (model.nv, K))
    clear = np.zeros(K)
    for k in range(K):
        _, hip, knee, ankle, c, vz = HOPPER_POSES[k % len(HOPPER_POSES)]
        qpos[0, k] = rng.uniform(-0.5, 0.5)
        qpos[2:, k] = np.array([0.0, 0.0, hip, knee, ankle]) + rng.normal(0, 0.05, 5)
        qvel[1, k] += vz
        clear[k] = c
    qpos[1] += clear - hopper_foot_low(model, qpos)
    return qpos, qvel


def hopper_inputs(model, K, T, dtype, seed=0, device="cuda"):
    """Rollout inputs on the poses of hopper_states: a plan and noise
    N(0, 0.5), start times in [0.3, 10] s."""
    qpos, qvel = hopper_states(model, K, seed)
    rng = np.random.default_rng(seed + 1)
    U = rng.normal(0, 0.5, (T, model.nu))
    noise = rng.normal(0, 0.5, (T, model.nu, K))
    t0 = rng.uniform(0.3, 10.0, (1, K))
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return tuple(as_t(a) for a in (qpos, qvel, t0, U, noise))


def hopper_gait_params() -> np.ndarray:
    p = np.zeros(16)
    p[4:10] = HOP_GAIT
    return p


def hopper_gait_terms(qpos, qvel, time, params) -> dict:
    """The param_gait terms of kernel_costs.hopper in numpy: the landing
    term (gate x squared excess descent), the knee anchor and the hop clock."""
    gate = np.clip((0.85 - (qpos[1] + 1.0)) * 4.0, 0.0, 1.0)
    over = np.maximum(-qvel[1] - 0.4, 0.0)
    zstar = 0.92 + 0.18 * np.sin(time * (2 * np.pi / 0.75))
    return {"landing": params[5] * gate * over * over,
            "knee_anchor": params[7] * (qpos[5] - (1.2 + params[9])) ** 2,
            "clock": params[8] * (qpos[1] + 1.0 - zstar) ** 2}


def kernel_alone(ro, model, cost_factory, cost_kwargs, K, T, inputs, params=None,
                 plain: bool = True) -> dict:
    """The rollout kernel alone at (K, T) in f32 on `inputs` beside its
    plain version (cost rel median < 1e-3; `plain=False` leaves it out:
    plain_ms is then None) and its bound: the bytes of the inputs and
    outputs, and ops_per_rollout's operations at the f32 rate."""
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    x = inputs(model, K, T, torch.float32, seed=2)
    p = None if params is None else torch.tensor(params, dtype=torch.float32, device="cuda")
    ro(*x, params=p)
    kernel_ms = cuda_ms(lambda: ro(*x, params=p), 5)
    plain_ms, vs = None, None
    if plain:
        out = {}
        plain_ms = cuda_ms(lambda: out.setdefault("plain", ro.plain(*x, params=p)), 1)
        ck, cp = ro(*x, params=p)[0].double(), out["plain"][0].double()
        rel = (ck - cp).abs() / cp.abs()
        vs = {"cost_rel_median": float(rel.median()), "cost_rel_max": float(rel.max()),
              "cost_max_abs": float((ck - cp).abs().max())}
        if not (torch.isfinite(ck).all() and vs["cost_rel_median"] < 1e-3):
            raise AssertionError(f"full-shape f32 kernel vs plain: {vs}")
    n_rollout_ops = ops_per_rollout(model, cost_factory, cost_kwargs, T, inputs=inputs,
                                    params=params)
    n_ops = K * n_rollout_ops
    n_bytes = 4 * (K * (2 * model.nq + 2 * model.nv + 1) + T * model.nu * (K + 1) + rk.NP)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_OPS_PER_S * 1e3
    return {"K": K, "T": T, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "ops_per_rollout": n_rollout_ops, "ops": n_ops, "bytes": n_bytes,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations", "kernel_vs_plain": vs}


def split_control_steps(runner, n: int, params=None) -> dict:
    """n control steps of an EpisodeRunner one at a time from its initial
    state, CUDA events around the plan and around the plant step; then the
    device launches of one plant step and one profiled control step."""
    ms = runner.fresh_controller(1)
    plant = runner.init_state
    p = torch.zeros(16, dtype=torch.float32, device="cuda") if params is None else params
    plan_ms, plant_ms, step_ms = [], [], []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        h = time.perf_counter()
        ev[0].record()
        action, ms, _ = runner.plan(ms, plant, params=p)
        ev[1].record()
        plant = runner.plant_dyn(plant, action, 0)
        ev[2].record()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - h) * 1e3)
        plan_ms.append(ev[0].elapsed_time(ev[1]))
        plant_ms.append(ev[1].elapsed_time(ev[2]))
    launches = device_launches(lambda: runner.plant_dyn(plant, action, 0))
    prof = device_profile(lambda: runner.control_step(ms, plant, p))
    q = lambda v: [float(x) for x in np.percentile(v, [25, 75])]
    return {"split_steps": n, "replan_ms_median": statistics.median(plan_ms),
            "replan_ms_q1_q3": q(plan_ms), "plant_ms_median": statistics.median(plant_ms),
            "plant_ms_q1_q3": q(plant_ms), "control_step_host_ms_median": statistics.median(step_ms),
            "control_step_host_ms_q1_q3": q(step_ms),
            "plant_step_device_launches": launches,
            "profiled_control_step": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                           "device_busy_share")}}


def small_robot_checks() -> dict:
    """check_cartpole and check_hopper: the rollout kernel against its
    plain version at the gates of `check` (check_rollout). Returns the
    errors by robot."""
    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    out = {}
    t0 = time.perf_counter()
    spec, model, *_, cfg = load_task("cartpole", dtype=torch.float64)
    errs, geometry = check_rollout(model, spec.kernel_cost_factory, spec.cost_kwargs,
                                   inputs=cartpole_inputs)
    x = cartpole_inputs(model, CHECK_KS[0], CHECK_T, torch.float64, seed=1)
    past = int((x[0][0].abs() > 1.0).sum())
    if not past:
        raise AssertionError("no cartpole state past the slider's limit")
    emit({"phase": "check_cartpole", "kernel": "rollout", "K": list(CHECK_KS), "T": CHECK_T,
          "cost": "cartpole", "inputs": "cartpole_inputs: cart in [-1.15, 1.15], pole at any "
                                        "angle, t0 ~ U[0, 10] s",
          "samples_past_the_slider_limit": past,
          "tolerance": {"float64": "rtol=atol=1e-9", "float32": "cost rel median<1e-3, max<1e-2",
                        "repeat": "two launches bit-identical"},
          "geometry": {str(dt).replace("torch.", ""): geo for dt, geo in geometry.items()},
          "errors": errs, "seconds": time.perf_counter() - t0})
    out["cartpole"] = errs

    t0 = time.perf_counter()
    spec, model, *_, cfg = load_task("hopper", dtype=torch.float64)
    kw = dict(spec.cost_kwargs, param_gait=True)
    params = hopper_gait_params()
    errs, geometry = check_rollout(model, spec.kernel_cost_factory, kw, params=params,
                                   inputs=hopper_inputs)
    # every param_gait term acts: each nonzero in some sample of the plain
    # rollout's final states at the terminal's time
    x = hopper_inputs(model, CHECK_KS[0], CHECK_T, torch.float64, seed=1)
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, CHECK_T, cost_kwargs=kw)
    _, qT, vT = ro.plain(*x, params=torch.tensor(params, dtype=torch.float64, device="cuda"))
    t_end = (x[2][0] + CHECK_T * model.timestep).cpu().numpy()
    terms = hopper_gait_terms(qT.cpu().numpy(), vT.cpu().numpy(), t_end, params)
    nonzero = {k: int((v > 0).sum()) for k, v in terms.items()}
    touching = int((hopper_foot_low(model, x[0].cpu().numpy()) < 0).sum())
    if min(nonzero.values()) == 0 or not touching:
        raise AssertionError(f"hopper check: terms nonzero in {nonzero}, {touching} feet in")
    emit({"phase": "check_hopper", "kernel": "rollout", "K": list(CHECK_KS), "T": CHECK_T,
          "cost": "hopper, param_gait", "params": params.tolist(),
          "inputs": "hopper_inputs: poses " + ", ".join(p[0] for p in HOPPER_POSES)
                    + "; t0 ~ U[0.3, 10] s",
          "feet_in_the_floor": touching, "samples_with_term_nonzero": nonzero,
          "tolerance": {"float64": "rtol=atol=1e-9", "float32": "cost rel median<1e-3, max<1e-2",
                        "repeat": "two launches bit-identical"},
          "geometry": {str(dt).replace("torch.", ""): geo for dt, geo in geometry.items()},
          "errors": errs, "seconds": time.perf_counter() - t0})
    out["hopper"] = errs
    return out


def cartpole_phase() -> dict:
    """main_cartpole: the swing-up of tests/test_e2e_cartpole.py on the card."""
    from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    t0 = time.perf_counter()
    runner = EpisodeRunner("cartpole", use_kernel=True, mppi_override={"n_samples": CART_K})
    rk.launches = 0
    h0 = time.perf_counter()
    res = runner.run(max_steps=CART_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - h0
    launches = rk.launches
    if launches != CART_STEPS:
        raise AssertionError(f"cartpole: {launches} kernel launches for {CART_STEPS} steps")
    states, actions, _ = res.logger.arrays()
    if states.shape != (CART_STEPS, 4) or not (np.isfinite(states).all()
                                               and np.isfinite(actions).all()):
        raise AssertionError(f"cartpole rows: {states.shape}, finite {np.isfinite(states).all()}")
    theta = np.mod(states[:, 1] + np.pi, 2 * np.pi) - np.pi
    upright, cart_x = float(np.abs(theta[-CART_SETTLE:]).mean()), float(states[-1, 0])
    if not (upright < 0.15 and abs(cart_x) < 0.5):
        raise AssertionError(f"cartpole swing-up: mean |theta| {upright:.3f} over the last "
                             f"{CART_SETTLE} steps, cart x {cart_x:.3f}")
    split = split_control_steps(runner, CART_SPLIT_STEPS)
    spec, model, cfg = runner.spec, runner.model, runner.cfg
    alone = kernel_alone(runner.plan.rollouts, model, spec.kernel_cost_factory, spec.cost_kwargs,
                         cfg.K, cfg.T, cartpole_inputs)
    emit({"phase": "main_cartpole", "task": "cartpole", "K": cfg.K, "T": cfg.T,
          "dtype": "float32", "control_steps": CART_STEPS, "launches": launches,
          "control_step_ms_mean": wall / CART_STEPS * 1e3,
          "mean_abs_theta_last_40": upright, "final_cart_x": cart_x,
          "gate": "mean |theta| < 0.15 over the last 40 steps, |x| < 0.5 at the end "
                  "(tests/test_e2e_cartpole.py)",
          **split, "kernel_alone": alone, "seconds": time.perf_counter() - t0})
    return {"launches": launches, "control_steps": CART_STEPS, "kernel": alone,
            "replan_ms_median": split["replan_ms_median"],
            "plant_ms_median": split["plant_ms_median"]}


def hopper_phase() -> dict:
    """main_hopper: EpisodeRunner("hopper") at K=4096, H=100 on the card."""
    from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    t0 = time.perf_counter()
    runner = EpisodeRunner("hopper", use_kernel=True,
                           mppi_override={"n_samples": HOP_K, "horizon": HOP_H})
    rk.launches = 0
    runner.run(max_steps=HOP_WARMUP, chunk=HOP_WARMUP)
    h0 = time.perf_counter()
    res = runner.run(max_steps=HOP_TIMED, chunk=HOP_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - h0
    launches = rk.launches
    if launches != HOP_WARMUP + HOP_TIMED:
        raise AssertionError(f"hopper: {launches} kernel launches for "
                             f"{HOP_WARMUP + HOP_TIMED} control steps")
    states, actions, _ = res.logger.arrays()
    if states.shape != (HOP_TIMED, 14) or not (np.isfinite(states).all()
                                               and np.isfinite(actions).all()):
        raise AssertionError(f"hopper rows: {states.shape}, finite {np.isfinite(states).all()}")
    split = split_control_steps(runner, HOP_SPLIT_STEPS)
    spec, model, cfg = runner.spec, runner.model, runner.cfg
    alone = kernel_alone(runner.plan.rollouts, model, spec.kernel_cost_factory, spec.cost_kwargs,
                         cfg.K, cfg.T, hopper_inputs)
    torch.cuda.empty_cache()
    emit({"phase": "main_hopper", "task": "hopper", "K": cfg.K, "H": cfg.T, "dtype": "float32",
          "warmup_steps": HOP_WARMUP, "timed_steps": HOP_TIMED, "launches": launches,
          "control_step_ms_mean_timed_run": wall / HOP_TIMED * 1e3,
          "torso_z_min": float(1.0 + states[:, 1].min()),
          "x_progress_m": float(states[-1, 0] - states[0, 0]),
          "jax_record_tpu": {"steps": 524, "x_progress_m": 0.87, "speed_m_per_s": 0.34,
                             "note": "artifacts/hopper_k4096.npz: behaviour, not a target"},
          **split, "kernel_alone": alone, "seconds": time.perf_counter() - t0})
    return {"launches": launches, "control_steps": HOP_WARMUP + HOP_TIMED, "kernel": alone,
            "replan_ms_median": split["replan_ms_median"],
            "plant_ms_median": split["plant_ms_median"]}


def cartpole_pipeline_phase() -> dict:
    """main_cartpole_pipeline: collect -> CSV -> train -> the closed loop on
    the trained surrogate through the estimator kernel (the reference's
    cartpole_datacollection.jl, its trainer and cartpole_mppi_estimator.py)."""
    from humanoid_mppi_rl_tpu_torch.collect.estimator import (ESTIMATOR_CONFIGS,
                                                              EstimatorRunner)
    from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
    from humanoid_mppi_rl_tpu_torch.costs.cartpole import make_costs_flat
    from humanoid_mppi_rl_tpu_torch.learning import train as tr
    from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    t0 = time.perf_counter()
    collector = EpisodeRunner("cartpole_collect", use_kernel=True)
    rk.launches = 0
    runs = {}
    for ep in range(CART_EPISODES):
        res = collector.run(max_steps=CART_EPISODE_STEPS, seed=ep)
        states, actions, _ = res.logger.arrays()
        if states.shape != (CART_EPISODE_STEPS, 4) or not np.isfinite(states).all():
            raise AssertionError(f"cartpole_collect episode {ep}: {states.shape}")
        runs[f"episode_{ep}"] = (states, actions)
    collect_launches = rk.launches
    if collect_launches != CART_EPISODES * CART_EPISODE_STEPS:
        raise AssertionError(f"cartpole_collect: {collect_launches} kernel launches")
    collect_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        sdir, adir = write_runs(os.path.join(root, "data"), runs)
        ck = os.path.join(root, "ckpt")
        cfg = dataclasses.replace(tr.PRESET_CONFIGS["cartpole"], epochs=CART_TRAIN_EPOCHS,
                                  ckpt_dir=ck)
        out = tr.train_model(sdir, adir, cfg)
        torch.cuda.synchronize()
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            epochs = [e for e in map(json.loads, f) if e["kind"] == "epoch"]
    train_l = [e["train_loss"] for e in epochs]
    eval_l = [e["eval_loss"] for e in epochs]
    if len(epochs) != CART_TRAIN_EPOCHS or not np.isfinite(train_l + eval_l).all():
        raise AssertionError(f"cartpole training losses: train {train_l}, eval {eval_l}")
    if not eval_l[-1] < eval_l[0]:
        raise AssertionError(f"the cartpole surrogate's eval loss did not fall: {eval_l}")
    module = out["model"].eval()
    train_s = time.perf_counter() - t1

    # the trained weights at the gates of check_estimator_trained, on rows
    # of the collection with small perturbations
    rows = np.concatenate([np.concatenate(r, axis=1) for r in runs.values()])

    def x_of(B, seed):
        rng = np.random.default_rng(seed)
        x = rows[rng.integers(0, len(rows), B)] + rng.normal(0, 0.05, (B, rows.shape[1]))
        return torch.tensor(x, dtype=torch.float32, device="cuda")

    errs = check_weights("cartpole (trained in the run)", module, x_of, CART_LOOP_CHECK_B)
    emit({"phase": "check_estimator_trained", "weights": "cartpole_attention trained in "
          "main_cartpole_pipeline", "model": "cartpole_attention (F=5, H=64, 4 heads, 2 layers)",
          "B": list(CART_LOOP_CHECK_B),
          "tolerance": {"float32": "rtol=atol=1e-4",
                        "bfloat16": "median|diff|<=3e-3*s, max|diff|<=3e-2*s, s=max(1,max|y|)"},
          "errors": errs})
    forward = time_forward(module, x_of(ESTIMATOR_CONFIGS["cartpole"].K, seed=3),
                           "cartpole_attention (trained in the run)", stages=False)

    t2 = time.perf_counter()
    ecfg = ESTIMATOR_CONFIGS["cartpole"]
    runner = EstimatorRunner("cartpole", module, ecfg, *make_costs_flat(),
                             batched_dynamics=True)
    start = dict(init_qpos=(0.0, np.pi), seed=0)
    ek.launches = 0
    warm = runner.run(n_steps=CART_LOOP_WARMUP, chunk=CART_LOOP_WARMUP, **start)
    torch.cuda.synchronize()
    warm_launches = ek.launches
    h0 = time.perf_counter()
    log = runner.run(n_steps=CART_LOOP_TIMED, chunk=CART_LOOP_TIMED, **start)
    torch.cuda.synchronize()
    wall = time.perf_counter() - h0
    n_steps = CART_LOOP_WARMUP + CART_LOOP_TIMED
    launches = ek.launches
    if (warm_launches, launches) != (CART_LOOP_WARMUP * ecfg.T, n_steps * ecfg.T):
        raise AssertionError(f"estimator forwards {warm_launches}/{launches} for "
                             f"{CART_LOOP_WARMUP}/{n_steps} control steps of T={ecfg.T}")
    for name, lg, n in (("warm-up", warm, CART_LOOP_WARMUP), ("timed", log, CART_LOOP_TIMED)):
        states, actions, times = lg.arrays()
        if states.shape != (n, 4) or actions.shape != (n, 1) or times.shape != (n,):
            raise AssertionError(f"cartpole loop {name}: {states.shape} {actions.shape}")
        if not (np.isfinite(states).all() and np.isfinite(actions).all()):
            raise AssertionError(f"cartpole loop {name}: non-finite rows")
    states, actions, _ = log.arrays()
    ms, plant = runner.start(**start)
    plan_ms, plant_ms, step_ms = [], [], []
    with torch.no_grad():
        for _ in range(CART_LOOP_SPLIT):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            h = time.perf_counter()
            ev[0].record()
            action, ms, _ = runner.plan(ms, runner.extract(plant))
            ev[1].record()
            plant = runner.plant_dyn(plant, action)
            ev[2].record()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - h) * 1e3)
            plan_ms.append(ev[0].elapsed_time(ev[1]))
            plant_ms.append(ev[1].elapsed_time(ev[2]))
    n0 = ek.launches
    prof = device_profile(lambda: runner.control_step(ms, plant))
    if ek.launches - n0 != ecfg.T:
        raise AssertionError(f"{ek.launches - n0} estimator forwards in a control step "
                             f"(T={ecfg.T})")
    k1 = dict(ek.kernel_launches)
    with torch.no_grad():
        plan_launches = device_launches(lambda: runner.plan(ms, runner.extract(plant)))
    plan_est = sum(ek.kernel_launches[kk] - k1[kk] for kk in ek.KINDS)
    q = lambda v: [float(x) for x in np.percentile(v, [25, 75])]
    theta = np.mod(states[:, 1] + np.pi, 2 * np.pi) - np.pi
    emit({"phase": "main_cartpole_pipeline", "collect": {
              "task": "cartpole_collect", "K": collector.cfg.K, "T": collector.cfg.T,
              "episodes": CART_EPISODES, "steps": CART_EPISODE_STEPS,
              "launches": collect_launches, "seconds": collect_s},
          "train": {"preset": "cartpole", "epochs": CART_TRAIN_EPOCHS, "cut": "10 of 50 epochs",
                    "n_pairs": out["n_pairs"], "train_loss": train_l, "eval_loss": eval_l,
                    "seconds": train_s},
          "loop": {"K": ecfg.K, "T": ecfg.T, "dtype": "bfloat16 surrogate, float32 plant",
                   "update_mode": ecfg.update_mode, "sigma": ecfg.sigma,
                   "steps": n_steps, "timed_steps": CART_LOOP_TIMED,
                   "control_step_ms_mean_timed_run": wall / CART_LOOP_TIMED * 1e3,
                   "split_steps": CART_LOOP_SPLIT,
                   "control_step_host_ms_median": statistics.median(step_ms),
                   "control_step_host_ms_q1_q3": q(step_ms),
                   "plan_ms_median": statistics.median(plan_ms), "plan_ms_q1_q3": q(plan_ms),
                   "plant_ms_median": statistics.median(plant_ms),
                   "plant_ms_q1_q3": q(plant_ms),
                   "estimator_forwards_per_control_step": launches / n_steps,
                   "profiled_control_step": {k: prof[k] for k in (
                       "wall_ms", "device_busy_ms", "device_busy_share")},
                   "replan_device_launches": plan_launches,
                   "replan_estimator_kernels": plan_est,
                   "replan_launches_outside_estimator_kernel":
                       None if plan_launches["kernels"] is None
                       else plan_launches["kernels"] - plan_est,
                   "mean_abs_theta_last_20": float(np.abs(theta[-20:]).mean()),
                   "final_cart_x": float(states[-1, 0]), "seconds": time.perf_counter() - t2},
          "seconds": time.perf_counter() - t0})
    return {"collect_launches": collect_launches, "loop_launches": launches,
            "loop_control_steps": n_steps, "forward": forward,
            "max_abs_err_bf16_B2048": errs["bfloat16/B=2048"]["max_abs"],
            "control_step_ms_median": statistics.median(step_ms)}


def small_robot_phases() -> dict:
    """check_cartpole, check_hopper, main_cartpole, main_hopper and
    main_cartpole_pipeline (slice 9); returns the numbers they add to the
    `kernels` line."""
    errs = small_robot_checks()
    cart = cartpole_phase()
    hop = hopper_phase()
    pipe = cartpole_pipeline_phase()
    f32 = lambda e, key: max(v[key] for k, v in e.items() if "float32" in k)
    robot = lambda r, e: {"ms": r["kernel"]["kernel_ms"], "plain_ms": r["kernel"]["plain_ms"],
                          "bound_ms": r["kernel"]["bound_ms"],
                          "bound_by": r["kernel"]["bound_by"],
                          "at": {"K": r["kernel"]["K"], "T": r["kernel"]["T"]},
                          "replan_ms_median": r["replan_ms_median"],
                          "plant_ms_median": r["plant_ms_median"],
                          "max_abs_err": f32(e, "cost_max_abs"),
                          "cost_rel_median_f32": f32(e, "cost_rel_median")}
    return {"rollout": {
                "paths": {"cartpole swing-up": {"launches": cart["launches"],
                                                "control_steps": cart["control_steps"]},
                          "hopper": {"launches": hop["launches"],
                                     "control_steps": hop["control_steps"]},
                          "cartpole_collect": {"launches": pipe["collect_launches"],
                                               "control_steps": CART_EPISODES
                                               * CART_EPISODE_STEPS}},
                "cartpole": robot(cart, errs["cartpole"]),
                "hopper": robot(hop, errs["hopper"])},
            "estimator": {
                "paths": {"cartpole estimator closed loop": {
                    "launches": pipe["loop_launches"],
                    "control_steps": pipe["loop_control_steps"]}},
                "cartpole": {"forward_B2048": pipe["forward"],
                             "max_abs_err_bf16_B2048": pipe["max_abs_err_bf16_B2048"],
                             "closed_loop_control_step_ms": pipe["control_step_ms_median"]}}}


# ---------------------------------------------------------------------------
# slice 10: the humanoid's remaining tasks and the array planner
# ---------------------------------------------------------------------------

# the reference scripts' operating points (envs/tasks): humanoid K=50,
# T=100 (src/Humanoid_mppi.jl), humanoid_hard K=30, T=75
# (src/Humanoid_datacollection.py); control steps of each run
# control steps of each task, cut for the run time (100 and 50, 50 and
# 25, then 25 and 15 before; 3 split steps, 5 before)
HUM_TASK_STEPS = {"humanoid": 12, "humanoid_hard": 8}
HUM_TASK_SPLIT_STEPS = 3
# humanoid_v1's step periods checked: 4 (both sides inside an 8-step
# rollout) and the task's 100
V1_PERIODS = (4, 100)
V1_CHECK_T = 8
NEW_COST_K, NEW_COST_T = 8192, 64   # each cost's kernel time (humanoid_bench's shape)
# the new costs' plain version is timed at T=8 (host-bound: its time grows
# with T, not with K), beside the kernel at the same shape
NEW_COST_PLAIN_T = 8
# the array planner: humanoid_collect (K=50, T=100, f32), as EpisodeRunner's
# default (use_kernel=False) runs it
# 1 warm-up and 1 timed array replan (2 and 3, then 1 and 2 before), cut
# for the run time
ARRAY_TASK, ARRAY_WARMUP, ARRAY_TIMED = "humanoid_collect", 1, 1
ARRAY_CHECK_K, ARRAY_CHECK_T = 256, 16
V2PY_STEPS = 3   # 5 before, cut for the run time (the check reads row 2)
# humanoid_hard's -1000 x swing-foot-velocity term makes its values cross
# zero, so the f32 check holds the 0.99 quantile of the relative error below
# 1e-2 in place of its max (check_rollout)
HARD_F32_QUANTILE = 0.99
# humanoid_hard_inputs' pose classes (k % 5): qpos index -> angle
HARD_POSES = (("stand", {}), ("lift_left", {18: -1.0, 19: -2.2}),
              ("lift_right", {12: -1.0, 13: -2.2}), ("spread", {10: -0.35, 16: -0.35}),
              ("crossed", {10: 0.25, 16: 0.25}))


def humanoid_hard_inputs(model, K, T, dtype, seed=0, device="cuda"):
    """seeded_inputs with sample k in pose HARD_POSES[k % 5], so that every
    branch of the hard-penalty cost is taken and left somewhere: a lifted
    leg brings its foot above its knee band, spread and crossed legs put the
    feet and knees outside the [0.15, 0.21] lateral dead zone."""
    qpos, qvel, t0, U, noise = seeded_inputs(model, K, T, torch.float64, seed, device="cpu")
    qpos = qpos.numpy()
    for k in range(K):
        for i, v in HARD_POSES[k % len(HARD_POSES)][1].items():
            qpos[i, k] = v
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return as_t(qpos), qvel.to(device, dtype), t0.to(device, dtype), U.to(device, dtype), \
        noise.to(device, dtype)


def hard_cost_branches(model, qpos, qvel) -> dict:
    """Samples on each side of each branch of the hard-penalty cost
    (ops/kernel_costs.humanoid_hard) at states qpos (nq, K), qvel (nv, K),
    through the engine's kinematics on their device."""
    from humanoid_mppi_rl_tpu_torch.costs.base import body_com_linvel
    from humanoid_mppi_rl_tpu_torch.physics.engine import Engine

    eng = Engine(model, qpos.device, qpos.dtype)
    st = eng.forward(qpos.T.contiguous(), qvel.T.contiguous())
    ids = {n: model.body_id(n) for n in ("shin_left", "shin_right", "foot_left", "foot_right")}
    x = st.xpos
    left = (body_com_linvel(st, eng, ids["shin_left"])[:, 0]
            > body_com_linvel(st, eng, ids["shin_right"])[:, 0])
    pick = lambda a, b: torch.where(left, x[:, ids[a], 2], x[:, ids[b], 2])
    swing_z, stance_z = pick("foot_left", "foot_right"), pick("foot_right", "foot_left")
    knee_z = pick("shin_left", "shin_right")
    leg = (x[:, ids["foot_left"], 1] - x[:, ids["foot_right"], 1]).abs()
    knee = (x[:, ids["shin_left"], 1] - x[:, ids["shin_right"], 1]).abs()
    conds = {"left_swing": left, "swing_foot_above_knee_band": swing_z >= knee_z - 0.3,
             "clearance_below_0.005": swing_z - stance_z < 0.005,
             "feet_outside_dead_zone": (leg <= 0.15) | (leg >= 0.21),
             "knees_outside_dead_zone": (knee <= 0.15) | (knee >= 0.21)}
    return {k: [int(v.sum()), int((~v).sum())] for k, v in conds.items()}


def kernel_cost_on_states(model, cost_factory, cost_kwargs, horizon: int):
    """(running, terminal) over (K,)-batched PhysicsStates that evaluate a
    rollout kernel cost (ops/kernel_costs) on the array engine's kinematics
    (xpos, xquat, body velocities), for rollout_costs_batched: the array
    planner with the kernel's own cost, so that the two planners' costs
    differ only by their physics. Zero runtime parameters."""
    import inspect
    from humanoid_mppi_rl_tpu_torch.ops.scalar_physics import StepContext

    kw = dict(cost_kwargs)
    if "horizon" in inspect.signature(cost_factory).parameters:
        kw.setdefault("horizon", horizon)
    run_k, term_k = cost_factory(model, **kw)

    def ctx(state, u):
        c = StepContext()
        col = lambda a, n: [a[:, i] for i in range(n)]
        c.qpos, c.qvel = col(state.qpos, model.nq), col(state.qvel, model.nv)
        c.ctrl = col(u, model.nu) if u is not None else [0.0] * model.nu
        c.time = state.time
        c.xpos = {b: tuple(state.xpos[:, b, i] for i in range(3)) for b in range(model.nbody)}
        c.xquat = {b: tuple(state.xquat[:, b, i] for i in range(4)) for b in range(model.nbody)}
        c.body_vel = {b: tuple(state.body_vel[:, b, i] for i in range(6))
                      for b in range(model.nbody)}
        c.params = [torch.zeros_like(state.time)] * 16
        return c

    return (lambda state, u, t: run_k(ctx(state, u), t),
            lambda state, t: term_k(ctx(state, None)))


def array_vs_kernel(model, cost_factory, cost_kwargs, K: int, T: int) -> dict:
    """On the card in f64: rollout_costs_batched over the penalty engine
    (the array planner's rollouts) with the kernel's cost on the engine's
    states, against the rollout kernel's costs on the same noise, from one
    perturbed state with the feet in the floor. rtol 1e-8."""
    from humanoid_mppi_rl_tpu_torch.dynamics.physics import make_physics_dynamics
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIConfig, rollout_costs_batched

    dt = torch.float64
    qpos, qvel, _, U, noise = seeded_inputs(model, K, T, dt, seed=3)
    q0, v0 = qpos[:, 0].contiguous(), qvel[:, 0].contiguous()
    dyn = make_physics_dynamics(model, solver="penalty", dtype=dt)
    x0 = dyn.engine.forward(q0, v0, torch.zeros((), dtype=dt, device="cuda"))
    running, terminal = kernel_cost_on_states(model, cost_factory, cost_kwargs, T)
    cfg = MPPIConfig(n_samples=K, horizon=T, clamp_rollout_ctrl=False)
    a = rollout_costs_batched(dyn, running, terminal, cfg, x0, U, noise.permute(2, 0, 1))
    ro = rk.build_rollout_kernel(model, cost_factory, T, cost_kwargs=cost_kwargs)
    b, _, _ = ro(q0[:, None].expand(-1, K).contiguous(), v0[:, None].expand(-1, K).contiguous(),
                 torch.zeros(1, K, dtype=dt, device="cuda"), U, noise)
    rel = ((a - b).abs() / b.abs()).max()
    torch.testing.assert_close(a, b, rtol=1e-8, atol=0.0)
    return {"K": K, "T": T, "cost_rel_max": float(rel),
            "cost_max_abs": float((a - b).abs().max())}


def humanoid_cost_checks() -> dict:
    """check_humanoid_costs: the rollout kernel with humanoid_v1 (step
    periods 4 and 100) and humanoid_hard against its plain version at the
    gates of `check`; the swing sides and hard-cost branches taken; the
    array planner's rollouts against the kernel's costs (array_vs_kernel)."""
    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as kc
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    out = {}
    spec, model, *_ = load_task("humanoid", dtype=torch.float64)
    for period in V1_PERIODS:
        t0 = time.perf_counter()
        kw = dict(spec.cost_kwargs, step_period=period)
        errs, geometry = check_rollout(model, kc.humanoid_v1, kw, T=V1_CHECK_T)
        # the gait clock: running steps 0..T-1, the terminal at t = T
        sides = ["left" if (t // period) % 2 == 0 else "right" for t in range(V1_CHECK_T + 1)]
        steps = {side: sides.count(side) for side in ("left", "right")}
        if period < V1_CHECK_T and min(steps.values()) == 0:
            raise AssertionError(f"humanoid_v1 step_period {period}: sides {steps}")
        emit({"phase": "check_humanoid_costs", "kernel": "rollout",
              "cost": f"humanoid_v1, step_period {period}", "K": list(CHECK_KS),
              "T": V1_CHECK_T, "inputs": "seeded_inputs (feet 0.25 m in the floor)",
              "gait_clock_steps_by_swing_side": steps,
              "sample_steps_by_swing_side": {k: v * CHECK_KS[0] for k, v in steps.items()},
              "tolerance": {"float64": "rtol=atol=1e-9",
                            "float32": "cost rel median<1e-3, max<1e-2",
                            "repeat": "two launches bit-identical"},
              "geometry": {str(d).replace("torch.", ""): g for d, g in geometry.items()},
              "errors": errs, "seconds": time.perf_counter() - t0})
        out[f"humanoid_v1/step_period={period}"] = errs
    t0 = time.perf_counter()
    spec, model, *_ = load_task("humanoid_hard", dtype=torch.float64)
    errs, geometry = check_rollout(model, kc.humanoid_hard, spec.cost_kwargs,
                                   inputs=humanoid_hard_inputs, f32_quantile=HARD_F32_QUANTILE)
    x = humanoid_hard_inputs(model, CHECK_KS[0], CHECK_T, torch.float64, seed=1)
    ro = rk.build_rollout_kernel(model, kc.humanoid_hard, CHECK_T, cost_kwargs=spec.cost_kwargs)
    c64, qT, vT = ro.plain(*x)
    # the plain version's own f32 error against its f64 result on these
    # inputs: the per-sample relative error of an f32 evaluation of this
    # signed cost is not bounded by 1e-2 either
    c32 = ro.plain(*humanoid_hard_inputs(model, CHECK_KS[0], CHECK_T, torch.float32,
                                         seed=1))[0].double()
    plain_rel = (c32 - c64).abs() / c64.abs()
    plain_f32 = {"cost_rel_max": float(plain_rel.max()),
                 f"cost_rel_q{HARD_F32_QUANTILE:g}": float(torch.quantile(plain_rel,
                                                                          HARD_F32_QUANTILE)),
                 "cost_abs_min_f64": float(c64.abs().min()),
                 "cost_abs_median_f64": float(c64.abs().median())}
    branches = {"initial": hard_cost_branches(model, x[0], x[1]),
                "final": hard_cost_branches(model, qT, vT)}
    for when, br in branches.items():
        if min(min(v) for v in br.values()) == 0:
            raise AssertionError(f"hard-cost branches at the {when} states: {br}")
    emit({"phase": "check_humanoid_costs", "kernel": "rollout", "cost": "humanoid_hard",
          "K": list(CHECK_KS), "T": CHECK_T,
          "inputs": "humanoid_hard_inputs: poses " + ", ".join(p[0] for p in HARD_POSES),
          "samples_taking_and_not_taking_each_branch": branches,
          "tolerance": {"float64": "rtol=atol=1e-9",
                        "float32": f"cost rel median<1e-3, {HARD_F32_QUANTILE:g} quantile<1e-2 "
                                   "(a signed cost: values cross zero)",
                        "repeat": "two launches bit-identical"},
          "plain_f32_vs_plain_f64_K256": plain_f32,
          "geometry": {str(d).replace("torch.", ""): g for d, g in geometry.items()},
          "errors": errs, "seconds": time.perf_counter() - t0})
    out["humanoid_hard"] = errs

    t0 = time.perf_counter()
    cases = {}
    for task in ("humanoid_collect", "humanoid", "humanoid_hard"):
        spec, model, *_ = load_task(task, dtype=torch.float64)
        cases[task] = array_vs_kernel(model, spec.kernel_cost_factory, spec.cost_kwargs,
                                      ARRAY_CHECK_K, ARRAY_CHECK_T)
    emit({"phase": "check_humanoid_costs", "kernel": "rollout",
          "check": "the array planner's rollouts (rollout_costs_batched over the penalty "
                   "engine, the kernel's cost on the engine's states) against the kernel's "
                   "costs, same noise, f64", "tolerance": "rtol 1e-8",
          "cases": cases, "seconds": time.perf_counter() - t0})
    out["array_vs_kernel"] = cases
    return out


def humanoid_task_phase() -> dict:
    """main_humanoid: the tasks humanoid and humanoid_hard through
    EpisodeRunner(use_kernel=True) at their operating points, f32, from
    qpos0; then each humanoid cost's kernel time at K=8192, T=64."""
    from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as kc
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    out = {"paths": {}}
    for task, steps in HUM_TASK_STEPS.items():
        t0 = time.perf_counter()
        runner = EpisodeRunner(task, use_kernel=True)
        rk.launches = 0
        h0 = time.perf_counter()
        res = runner.run(max_steps=steps, chunk=steps)   # a chunk runs whole: one chunk
        torch.cuda.synchronize()
        wall = time.perf_counter() - h0
        launches = rk.launches
        if launches != steps:
            raise AssertionError(f"{task}: {launches} kernel launches for {steps} steps")
        states, actions, _ = res.logger.arrays()
        if states.shape != (steps, 55) or not (np.isfinite(states).all()
                                               and np.isfinite(actions).all()):
            raise AssertionError(f"{task} rows: {states.shape}, finite "
                                 f"{np.isfinite(states).all()}")
        split = split_control_steps(runner, HUM_TASK_SPLIT_STEPS)
        cfg = runner.cfg
        emit({"phase": "main_humanoid", "task": task, "K": cfg.K, "T": cfg.T, "dtype": "float32",
              "cost": runner.spec.kernel_cost, "control_steps": steps, "launches": launches,
              "control_step_ms_mean": wall / steps * 1e3,
              "root_z_min": float(states[:, 2].min()), "root_z_final": float(states[-1, 2]),
              "x_progress_m": float(states[-1, 0] - states[0, 0]),
              **split, "seconds": time.perf_counter() - t0})
        out["paths"][f"{task} episode"] = {"launches": launches, "control_steps": steps}
        out[task] = {"replan_ms_median": split["replan_ms_median"],
                     "plant_ms_median": split["plant_ms_median"]}
    t0 = time.perf_counter()
    spec, model, *_ = load_task("humanoid_bench")
    costs = {}
    for name, factory, kw, inputs in (
            ("humanoid", kc.humanoid, spec.cost_kwargs, seeded_inputs),
            ("humanoid_v1", kc.humanoid_v1, {}, seeded_inputs),
            ("humanoid_hard", kc.humanoid_hard, {}, humanoid_hard_inputs)):
        ro = rk.build_rollout_kernel(model, factory, NEW_COST_T, cost_kwargs=kw)
        costs[name] = kernel_alone(ro, model, factory, kw, NEW_COST_K, NEW_COST_T, inputs,
                                   plain=False)
        if name != "humanoid":   # the humanoid cost's plain time is the `time` phase's
            ro = rk.build_rollout_kernel(model, factory, NEW_COST_PLAIN_T, cost_kwargs=kw)
            costs[name]["beside_plain"] = kernel_alone(ro, model, factory, kw, NEW_COST_K,
                                                       NEW_COST_PLAIN_T, inputs)
    emit({"phase": "main_humanoid", "kernel": "rollout", "K": NEW_COST_K, "T": NEW_COST_T,
          "dtype": "float32", "kernel_alone_by_cost": costs,
          "seconds": time.perf_counter() - t0})
    out["kernel_by_cost"] = costs
    return out


def kernel_profile(fn, top: int) -> dict:
    """device_profile and device_launches for a call of ~10^5 launches:
    one call of fn under torch.profiler tracing the device only (the
    host-side op events of such a call take minutes to aggregate), one
    aggregation. Its own `seconds` is the whole measurement's."""
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(ev.self_device_time_total for ev in events
                  if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    if not busy_ms:
        raise AssertionError("the device-only trace recorded no device time")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "device_launches": launch_counts(prof, top, events),
            "seconds": time.perf_counter() - t_all}


def count_dispatches(fn) -> int:
    """PyTorch operator dispatches of one call of fn (TorchDispatchMode):
    the same count on the CPU and on the card, an upper bound of its
    device launches (views launch nothing)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def array_planner_phase() -> dict:
    """main_array_planner: EpisodeRunner(ARRAY_TASK, use_kernel=False), the
    JAX package's default planner (make_mppi over the penalty engine,
    batched over K), at K=50, T=100, f32 on the card."""
    from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    t0 = time.perf_counter()
    runner = EpisodeRunner(ARRAY_TASK)
    rk.launches = 0
    ms = runner.fresh_controller(0)
    plant = runner.init_state
    plan_ms, plant_ms, host_ms = [], [], []
    for i in range(ARRAY_WARMUP + ARRAY_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        h = time.perf_counter()
        ev[0].record()
        action, ms, diag = runner.plan(ms, plant)
        ev[1].record()
        plant = runner.plant_dyn(plant, action, 0)
        ev[2].record()
        torch.cuda.synchronize()
        if i >= ARRAY_WARMUP:
            host_ms.append((time.perf_counter() - h) * 1e3)
            plan_ms.append(ev[0].elapsed_time(ev[1]))
            plant_ms.append(ev[1].elapsed_time(ev[2]))
    for name, v in (("action", action), ("U", ms.U), ("qpos", plant.qpos), ("beta", diag.beta)):
        if not torch.isfinite(v).all():
            raise AssertionError(f"array planner: non-finite {name}")
    prof = kernel_profile(lambda: runner.plan(ms, plant), top=8)
    dispatches = count_dispatches(lambda: runner.plan(ms, plant))
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.plan(ms, plant)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if rk.launches:
        raise AssertionError(f"the array planner launched the rollout kernel {rk.launches} times")
    cfg = runner.cfg
    emit({"phase": "main_array_planner", "task": ARRAY_TASK, "K": cfg.K, "T": cfg.T,
          "dtype": "float32", "planner": "make_mppi over the penalty engine (use_kernel=False)",
          "warmup_steps": ARRAY_WARMUP, "timed_steps": ARRAY_TIMED,
          "replan_ms": plan_ms, "replan_ms_median": statistics.median(plan_ms),
          "plant_ms": plant_ms, "control_step_host_ms": host_ms,
          "launches_per_replan": prof["device_launches"],
          "pytorch_dispatches_per_replan": dispatches,
          "profiled_replan": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                   "device_busy_share")},
          "profiled_replan_seconds": prof["seconds"],
          "sync_free_replan": True, "rollout_kernel_launches": rk.launches,
          "root_z": float(plant.qpos[2]), "seconds": time.perf_counter() - t0})
    return {"replan_ms_median": statistics.median(plan_ms),
            "launches_per_replan": prof["device_launches"]["kernels"],
            "device_busy_share": prof["device_busy_share"]}


def v2py_phase() -> dict:
    """main_v2py: collect_humanoid_v2py at the task's width (K=30, T=75, two
    replans a control step, the array planner) for V2PY_STEPS steps, saved
    into a temporary directory and read back."""
    from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner, collect_humanoid_v2py
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv

    t0 = time.perf_counter()
    runner = EpisodeRunner("humanoid_collect_v2py")
    ms = runner.fresh_controller(0)
    runner.plan(ms, runner.init_state)
    dispatches = count_dispatches(lambda: runner.plan(ms, runner.init_state))
    with tempfile.TemporaryDirectory() as out_dir:
        rk.launches = 0
        h0 = time.perf_counter()
        out = collect_humanoid_v2py(out_dir=out_dir, max_steps=V2PY_STEPS, chunk=V2PY_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - h0
        if out != [(0, V2PY_STEPS)]:
            raise AssertionError(f"collect_humanoid_v2py: {out}")
        (run,) = os.listdir(out_dir)
        arrays = {k: read_csv(os.path.join(out_dir, run, f"{k}.csv")).reshape(V2PY_STEPS, -1)
                  for k in ("states", "actions", "times")}
    shapes = {k: v.shape[1] for k, v in arrays.items()}
    if shapes != {"states": 56, "actions": 21, "times": 1}:
        raise AssertionError(f"v2py columns: {shapes}")
    st = arrays["states"]
    if not (np.isfinite(st).all() and np.isfinite(arrays["actions"]).all()):
        raise AssertionError("v2py rows are not finite")
    if np.abs(st[0, 28:]).max() != 0.0:
        raise AssertionError("v2py: the first row's FD velocity is not zero")
    fd_err = float(np.abs(st[2, 28:] - (st[2, :28] - st[1, :28]) / 0.005).max())
    emit({"phase": "main_v2py", "task": "humanoid_collect_v2py", "K": 30, "T": 75,
          "replans_per_step": 2, "dtype": "float32", "control_steps": V2PY_STEPS,
          "control_step_ms_mean": wall / V2PY_STEPS * 1e3, "columns": shapes,
          "pytorch_dispatches_per_control_step_plan": dispatches,
          "fd_velocity_row2_max_abs_err": fd_err, "rollout_kernel_launches": rk.launches,
          "root_z_min": float(st[:, 2].min()), "seconds": time.perf_counter() - t0})
    return {"control_step_ms_mean": wall / V2PY_STEPS * 1e3}


def humanoid_task_phases() -> dict:
    """check_humanoid_costs, main_humanoid, main_array_planner and
    main_v2py (slice 10); returns the numbers they add to the `kernels`
    line."""
    errs = humanoid_cost_checks()
    tasks = humanoid_task_phase()
    array = array_planner_phase()
    v2py = v2py_phase()
    f32 = lambda e, key: max(v[key] for k, v in e.items() if "float32" in k)
    f64 = lambda e, key: max(v[key] for k, v in e.items() if "float64" in k)
    by_cost = {}
    for name, e in (("humanoid_v1", {**errs["humanoid_v1/step_period=4"],
                                     **{k + "/p100": v for k, v in
                                        errs["humanoid_v1/step_period=100"].items()}}),
                    ("humanoid_hard", errs["humanoid_hard"])):
        k = tasks["kernel_by_cost"][name]
        p = k["beside_plain"]
        by_cost[name] = {"ms": k["kernel_ms"], "bound_ms": k["bound_ms"],
                         "bound_by": k["bound_by"], "at": {"K": k["K"], "T": k["T"]},
                         "plain_ms": p["plain_ms"], "ms_beside_plain": p["kernel_ms"],
                         "plain_at": {"K": p["K"], "T": p["T"]},
                         "ops_per_rollout": k["ops_per_rollout"],
                         "max_abs_err": f32(e, "cost_max_abs"),
                         "max_abs_err_f64": f64(e, "cost_max_abs"),
                         "cost_rel_median_f32": f32(e, "cost_rel_median")}
    hum = tasks["kernel_by_cost"]["humanoid"]
    return {"paths": tasks["paths"], "humanoid_costs": by_cost,
            "humanoid_cost_ms_beside": {"ms": hum["kernel_ms"], "bound_ms": hum["bound_ms"],
                                        "at": {"K": hum["K"], "T": hum["T"]}},
            "humanoid_tasks": {t: tasks[t] for t in HUM_TASK_STEPS},
            "array_vs_kernel": errs["array_vs_kernel"],
            "array_planner": array, "v2py": v2py}


# ---------------------------------------------------------------------------
# slice 11: arm5 (ball joints, multi-dof/site/tendon motors, plane-vs-mesh)
# ---------------------------------------------------------------------------

# arm5 poses for the rollout checks, one per sample class (k % 5): "air"
# the crate high above the floor; "limit" the shoulder turned 1.3-1.6 rad
# about a random axis (past its 70 deg = 1.2217 rad limit); "rest" the
# crate at z = 0.097 (tests/test_kernel.py's pose: a few vertices in the
# floor); "deep" the crate face down with its centre at z = 0.015 (six
# vertices in the floor: more than the array tiers' 4 rows); "springs" both
# balls turned 0.6-0.8 rad and the elbow past its upper limit
ARM5_POSES = ("air", "limit", "rest", "deep", "springs")
ARM5_LIMIT = 70 * np.pi / 180
# 12 control steps on the kernel planner (100, then 25 before), 1 warm-up
# and 1 timed array replan (2 and 3, then 1 and 2 before), cut for the run
# time
ARM5_TASK_STEPS, ARM5_SPLIT_STEPS = 12, 5
ARM5_TIME_K, ARM5_T = (64, 8192), 40   # the task's K and the sweep's, T = the task's
ARM5_ARRAY_WARMUP, ARM5_ARRAY_TIMED = 1, 1
# the transmission test models (tests/test_engine_generality.py's
# SITE_ACT_XML and TENDON_ACT_XML), checked with the cartpole cost
TRANSMISSION_MODELS = ("site_act_plant", "tendon_act_plant")


def _axis_angle_quat(v) -> np.ndarray:
    a = float(np.linalg.norm(v))
    return np.concatenate([[np.cos(a / 2)], np.asarray(v) / max(a, 1e-12) * np.sin(a / 2)])


def _quat_mat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def arm5_face_down(model) -> np.ndarray:
    """The crate's quaternion that turns the face of its mesh at vertex 0
    and its two nearest neighbours down onto the floor."""
    g = next(g for g in model.geoms if g.bodyid == model.body_id("crate"))
    v = np.asarray(g.mesh_verts)
    j, k = np.argsort(np.linalg.norm(v - v[0], axis=1))[1:3]
    n = v[0] + v[j] + v[k]
    n = n / np.linalg.norm(n)
    a = np.cross(n, [0.0, 0.0, -1.0])
    return _axis_angle_quat(a / np.linalg.norm(a) * np.arccos(np.clip(-n[2], -1.0, 1.0)))


def arm5_states(model, K: int, seed: int = 0):
    """qpos (nq, K), qvel (nv, K) numpy arrays: sample k in pose
    ARM5_POSES[k % 5] with small random ball rotations, elbow angles and
    crate tilts, velocities N(0, 0.3)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(model.qpos0, dtype=np.float64)[:, None], (1, K))
    qvel = rng.normal(0, 0.3, (model.nv, K))
    down = arm5_face_down(model)
    small = lambda mag: _axis_angle_quat(rng.normal(size=3) * mag)
    for k in range(K):
        pose = ARM5_POSES[k % len(ARM5_POSES)]
        qpos[0:4, k] = small(0.2)
        qpos[4, k] = rng.uniform(-0.8, 0.0)
        qpos[5:9, k] = small(0.3)
        qpos[9:11, k] = (0.6, 0.3) + rng.normal(0, 0.02, 2)
        qpos[11, k] = 1.0 + rng.uniform(0, 0.3)
        qpos[12:16, k] = small(0.1)
        if pose == "limit":
            ax = rng.normal(size=3)
            qpos[0:4, k] = _axis_angle_quat(ax / np.linalg.norm(ax) * rng.uniform(1.3, 1.6))
        elif pose == "rest":
            qpos[11, k] = 0.097
        elif pose == "deep":
            qpos[11, k] = 0.015
            qpos[12:16, k] = down
        elif pose == "springs":
            qpos[0:4, k] = _axis_angle_quat(rng.normal(size=3) * 0.35)
            qpos[5:9, k] = _axis_angle_quat(rng.normal(size=3) * 0.45)
            qpos[4, k] = 0.3
    return qpos, qvel


def arm5_inputs(model, K, T, dtype, seed=0, device="cuda"):
    """Rollout inputs on the poses of arm5_states: a plan N(0, 1) and noise
    N(0, 2) that drive every motor (each into its ctrlrange somewhere),
    start times in [0, 5] s."""
    qpos, qvel = arm5_states(model, K, seed)
    rng = np.random.default_rng(seed + 1)
    U = rng.normal(0, 1.0, (T, model.nu))
    noise = rng.normal(0, 2.0, (T, model.nu, K))
    t0 = rng.uniform(0, 5.0, (1, K))
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return tuple(as_t(a) for a in (qpos, qvel, t0, U, noise))


def arm5_terms(model, qpos: np.ndarray) -> dict:
    """Per sample, on the CPU: the shoulder's rotation angle past its limit,
    each ball's spring rotation, and the crate's and the hand's mesh
    vertices below the floor (the candidates of the contact tables)."""
    from humanoid_mppi_rl_tpu_torch.physics import contact as pcontact
    from humanoid_mppi_rl_tpu_torch.physics.engine import Engine

    eng = Engine(model, device="cpu", dtype=torch.float64)
    st = eng.forward(torch.tensor(qpos.T), torch.zeros(qpos.shape[1], model.nv,
                                                       dtype=torch.float64))
    _, phi = pcontact._candidates(eng.contact, *pcontact.geom_world(eng.contact, st))
    ang = lambda q: 2 * np.arctan2(np.linalg.norm(q[1:4], axis=0), np.abs(q[0]))
    per_pair = [(phi[:, a:a + n] < 0).sum(-1).numpy() for a, n, _, _ in eng.contact.segments]
    return {"shoulder_past_limit": ang(qpos[0:4]) > ARM5_LIMIT,
            "shoulder_angle": ang(qpos[0:4]), "wrist_angle": ang(qpos[5:9]),
            "hand_vertices_in": per_pair[0], "crate_vertices_in": per_pair[1]}


def transmission_inputs(model, K, T, dtype, seed=0, device="cuda"):
    """Inputs for the transmission models: qpos0 perturbed by N(0, 0.1)
    (the free joint's quaternion normalised), velocities N(0, 0.5), a plan
    N(0, 1) and noise N(0, 3)."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(model.qpos0)[:, None], (1, K)) + rng.normal(0, 0.1, (model.nq, K))
    for j in model.joints:
        if j.jtype == 0:
            q = qpos[j.qposadr + 3:j.qposadr + 7]
            qpos[j.qposadr + 3:j.qposadr + 7] = q / np.linalg.norm(q, axis=0)
    qvel = rng.normal(0, 0.5, (model.nv, K))
    U = rng.normal(0, 1.0, (T, model.nu))
    noise = rng.normal(0, 3.0, (T, model.nu, K))
    as_t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    return tuple(as_t(a) for a in (qpos, qvel, np.zeros((1, K)), U, noise))


def hand_distance(model, qpos, target) -> float:
    """|hand - target| at qpos (the port's kinematics on the CPU)."""
    from humanoid_mppi_rl_tpu_torch.physics.engine import Engine

    f64 = torch.float64
    st = Engine(model, device="cpu", dtype=f64).forward(
        torch.tensor(np.asarray(qpos), dtype=f64), torch.zeros(model.nv, dtype=f64))
    return float(np.linalg.norm(st.xpos[model.body_id("hand")].numpy() - np.asarray(target)))


def arm5_phase(builds: dict) -> dict:
    """main_arm5: the rollout kernel against its plain version on arm5 and
    on the transmission models, the arm5 kernel alone, arm5_reach through
    EpisodeRunner on the kernel planner and on the array planner. Returns
    the numbers for the `kernels` line."""
    from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.ops import kernel_costs
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.physics.model import load_model

    t0 = time.perf_counter()
    spec, model, *_, cfg = load_task("arm5_reach", dtype=torch.float64)
    errs, geometry = check_rollout(model, spec.kernel_cost_factory, spec.cost_kwargs,
                                   inputs=arm5_inputs)
    x = arm5_inputs(model, CHECK_KS[0], CHECK_T, torch.float64, seed=1, device="cpu")
    terms = arm5_terms(model, x[0].numpy())
    lo, hi = model.ctrl_range()
    u = (x[3][:, :, None] + x[4]).numpy()
    on = {"shoulder_past_limit": int(terms["shoulder_past_limit"].sum()),
          "crate_vertices_in_floor": int((terms["crate_vertices_in"] > 0).sum()),
          "crate_more_than_4_in_floor": int((terms["crate_vertices_in"] > 4).sum()),
          "springs_loaded": int(((terms["shoulder_angle"] > 0.3)
                                 & (terms["wrist_angle"] > 0.3)).sum()),
          "motors_driven": [int((u[:, i] != 0).sum()) for i in range(model.nu)],
          "motors_past_ctrlrange": [int(((u[:, i] < lo[i]) | (u[:, i] > hi[i])).sum())
                                    for i in range(model.nu)]}
    if (min(v for k, v in on.items() if not k.startswith("motors")) == 0
            or min(on["motors_driven"]) == 0 or not sum(on["motors_past_ctrlrange"])):
        raise AssertionError(f"arm5 check inputs leave a term off: {on}")
    trn = {}
    for name in TRANSMISSION_MODELS:
        m = load_model(name)
        e, _ = check_rollout(m, kernel_costs.cartpole, {}, inputs=transmission_inputs)
        trn[name] = {"actuators": [("site" if a.site_bodyid >= 0 else "tendon")
                                   for a in m.actuators], "errors": e}
    emit({"phase": "check_arm5", "kernel": "rollout", "K": list(CHECK_KS), "T": CHECK_T,
          "cost": "arm5", "inputs": "arm5_inputs: poses " + ", ".join(ARM5_POSES)
                                    + "; plan N(0, 1), noise N(0, 2)",
          "samples_with_term_on": on,
          "tolerance": {"float64": "rtol=atol=1e-9", "float32": "cost rel median<1e-3, max<1e-2",
                        "repeat": "two launches bit-identical"},
          "geometry": {str(dt).replace("torch.", ""): geo for dt, geo in geometry.items()},
          "errors": errs, "transmission_models": trn, "seconds": time.perf_counter() - t0})

    t1 = time.perf_counter()
    spec, model, *_, cfg = load_task("arm5_reach")
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, ARM5_T,
                                 cost_kwargs=spec.cost_kwargs)
    alone = {K: kernel_alone(ro, model, spec.kernel_cost_factory, spec.cost_kwargs, K, ARM5_T,
                             arm5_inputs) for K in ARM5_TIME_K}
    ptxas = {k: v for k, v in ptxas_stats(builds["rollout_kernel.cu"]["log"]).items()
             if "rollout" in k}
    emit({"phase": "time_arm5", "kernel": "rollout", "cost": "arm5", "T": ARM5_T,
          "kernel_alone": {str(K): a for K, a in alone.items()},
          "geometry": ro.geometry.get(torch.float32), "ptxas": ptxas,
          "diagnostics": rollout_diagnostics(model, ro, ARM5_T, arm5_inputs),
          "seconds": time.perf_counter() - t1})

    t1 = time.perf_counter()
    runner = EpisodeRunner("arm5_reach", use_kernel=True)
    target = runner.spec.cost_kwargs.get("target", (0.35, 0.15, 0.55))
    rk.launches = 0
    res = runner.run(max_steps=ARM5_TASK_STEPS, chunk=ARM5_TASK_STEPS)
    torch.cuda.synchronize()
    launches = rk.launches
    if launches != ARM5_TASK_STEPS:
        raise AssertionError(f"arm5_reach: {launches} launches for {ARM5_TASK_STEPS} steps")
    states, actions, _ = res.logger.arrays()
    if states.shape != (ARM5_TASK_STEPS, model.nq + model.nv) or not (
            np.isfinite(states).all() and np.isfinite(actions).all()):
        raise AssertionError(f"arm5_reach rows: {states.shape}, finite {np.isfinite(states).all()}")
    d0 = hand_distance(runner.plant_model, states[0, :model.nq], target)
    d1 = hand_distance(runner.plant_model, res.final_qpos, target)
    split = split_control_steps(runner, ARM5_SPLIT_STEPS)
    plant = runner.init_state
    action = torch.zeros(model.nu, device="cuda")
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.plant_dyn(plant, action, 0)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    emit({"phase": "main_arm5", "task": "arm5_reach", "K": runner.cfg.K, "T": runner.cfg.T,
          "dtype": "float32", "control_steps": ARM5_TASK_STEPS, "launches": launches,
          "hand_to_target_m": {"start": d0, "end": d1}, "sync_free_plant_step": True,
          **split, "seconds": time.perf_counter() - t1})

    t1 = time.perf_counter()
    arr = EpisodeRunner("arm5_reach")
    rk.launches = 0
    ms = arr.fresh_controller(0)
    plant = arr.init_state
    plan_ms = []
    for i in range(ARM5_ARRAY_WARMUP + ARM5_ARRAY_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        action, ms, diag = arr.plan(ms, plant)
        ev[1].record()
        plant = arr.plant_dyn(plant, action, 0)
        torch.cuda.synchronize()
        if i >= ARM5_ARRAY_WARMUP:
            plan_ms.append(ev[0].elapsed_time(ev[1]))
    for name, v in (("action", action), ("U", ms.U), ("qpos", plant.qpos)):
        if not torch.isfinite(v).all():
            raise AssertionError(f"arm5 array planner: non-finite {name}")
    prof = kernel_profile(lambda: arr.plan(ms, plant), top=8)
    torch.cuda.set_sync_debug_mode("error")
    try:
        arr.plan(ms, plant)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if rk.launches:
        raise AssertionError(f"the array planner launched the rollout kernel {rk.launches} times")
    emit({"phase": "main_arm5_array", "task": "arm5_reach", "K": arr.cfg.K, "T": arr.cfg.T,
          "dtype": "float32", "planner": "make_mppi over the penalty engine (use_kernel=False)",
          "warmup_steps": ARM5_ARRAY_WARMUP, "timed_steps": ARM5_ARRAY_TIMED,
          "replan_ms": plan_ms, "replan_ms_median": statistics.median(plan_ms),
          "launches_per_replan": prof["device_launches"],
          "profiled_replan": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                   "device_busy_share")},
          "sync_free_replan": True, "seconds": time.perf_counter() - t1})
    f32 = lambda key: max(v[key] for k, v in errs.items() if "float32" in k)
    a64 = alone[ARM5_TIME_K[0]]
    return {"launches": launches, "control_steps": ARM5_TASK_STEPS,
            "ms": a64["kernel_ms"], "plain_ms": a64["plain_ms"], "bound_ms": a64["bound_ms"],
            "bound_by": a64["bound_by"], "at": {"K": a64["K"], "T": a64["T"]},
            "ms_K8192": alone[ARM5_TIME_K[1]]["kernel_ms"],
            "bound_ms_K8192": alone[ARM5_TIME_K[1]]["bound_ms"],
            "plain_ms_K8192": alone[ARM5_TIME_K[1]]["plain_ms"],
            "replan_ms_median": split["replan_ms_median"],
            "plant_ms_median": split["plant_ms_median"],
            "array_replan_ms_median": statistics.median(plan_ms),
            "max_abs_err": f32("cost_max_abs"), "cost_rel_median_f32": f32("cost_rel_median")}


# main_cli: the command line in process (cli.main), at the commands'
# defaults except the depths below
CLI_STEPS = 20             # run / collect --steps (EpisodeRunner runs whole chunks)
# the cartpole run plans on the array planner, the CLI's default: one chunk,
# and the estimates are cut to make room for it (PERF.md section 4 gives the
# array replan's time, which keeps 200 steps out)
CLI_CART_STEPS, CLI_CART_EPOCHS = 50, 2
CLI_EST_STEPS, CLI_QUAD_EST_STEPS = 5, 1


def cli_call(argv: list) -> tuple:
    """cli.main(argv) in process: (its stdout lines, seconds to its end on
    the card). A command that fails raises."""
    from humanoid_mppi_rl_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit code {rc}")
    return buf.getvalue().strip().splitlines(), seconds


def csv_rows(path: str, cols: int) -> np.ndarray:
    """A CSV the CLI wrote, held finite with `cols` columns."""
    from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv

    a = read_csv(path)
    if a.shape[1:] != (cols,) or not np.isfinite(a).all():
        raise AssertionError(f"{path}: shape {a.shape}, expected (n, {cols}), finite")
    return a


def cli_phase(main_replan_ms: float) -> dict:
    """main_cli: the port's command line through cli.main on the card: tasks;
    run humanoid_bench --kernel (K=8192, H=64, f32) with one rollout-kernel
    launch per control step; collect humanoid_walk --kernel; profile
    humanoid_bench --kernel beside the main phase's replan; the cartpole
    chain run (the default, array planner) -> train -> estimate on its
    own checkpoint; estimate
    quadruped; replay of the humanoid run; warm; bench, which refuses.
    One line per command; returns the rollout kernel's launches by
    command for the `kernels` line."""
    from humanoid_mppi_rl_tpu_torch import cli
    from humanoid_mppi_rl_tpu_torch.collect.runner import CHUNK
    from humanoid_mppi_rl_tpu_torch.envs.tasks import TASKS
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.physics.model import load_model

    t_phase = time.perf_counter()
    paths, record = {}, {}

    def call(name, argv, launches=None):
        rk.launches = 0
        lines, secs = cli_call(argv)
        out = json.loads(lines[-1]) if name != "tasks" else {"lines": len(lines)}
        if launches is not None:
            if rk.launches != launches:
                raise AssertionError(f"cli {name}: {rk.launches} rollout-kernel launches, "
                                     f"expected {launches}")
            if launches:
                paths[f"cli {name}"] = {"launches": rk.launches}
        emit({"phase": "main_cli", "command": name, "argv": argv, "out": out,
              "rollout_launches": rk.launches, "seconds": secs})
        return lines, out, secs

    executed = -(-CLI_STEPS // CHUNK) * CHUNK   # a chunk runs whole
    with tempfile.TemporaryDirectory() as root:
        d = lambda *p: os.path.join(root, *p)
        lines, _, _ = call("tasks", ["tasks"])
        if [ln.split()[0] for ln in lines] != list(TASKS):
            raise AssertionError(f"cli tasks: {lines}")

        _, out, secs = call("run humanoid_bench", [
            "run", "--task", "humanoid_bench", "--kernel", "--steps", str(CLI_STEPS),
            "--out", d("run"), "--metrics", d("run.jsonl")], launches=executed)
        hum = load_model("humanoid")
        states = csv_rows(d("run", "states.csv"), hum.nq + hum.nv)
        csv_rows(d("run", "actions.csv"), hum.nu)
        csv_rows(d("run", "times.csv"), 1)
        if out["steps"] != CLI_STEPS or len(states) != CLI_STEPS:
            raise AssertionError(f"cli run: {out}, {len(states)} rows")
        with open(d("run.jsonl")) as f:
            chunks = [e for e in map(json.loads, f) if e["kind"] == "chunk"]
        record["run_control_step_ms"] = sum(c["wall_s"] for c in chunks) / executed * 1e3
        record["run_launches_per_control_step"] = paths["cli run humanoid_bench"]["launches"] \
            / executed

        _, out, _ = call("collect humanoid_walk", [
            "collect", "--robot", "humanoid", "--task", "humanoid_walk", "--kernel",
            "--episodes", "1", "--steps", str(CLI_STEPS), "--out", d("collect")],
            launches=executed)
        if [r["steps_saved"] for r in out["results"]] != [CLI_STEPS]:
            raise AssertionError(f"cli collect: {out}")

        _, out, _ = call("profile humanoid_bench", [
            "profile", "--task", "humanoid_bench", "--kernel", "--iters", "20",
            "--out", d("profile")], launches=21)
        if not (out["kernel"] and os.path.exists(d("profile", "trace.json"))):
            raise AssertionError(f"cli profile: {out}")
        record["profile_replan_ms"] = out["replan_ms"]
        record["main_replan_ms_median"] = main_replan_ms

        call("run cartpole_collect", [
            "run", "--task", "cartpole_collect", "--steps", str(CLI_CART_STEPS),
            "--out", d("cart"), "--metrics", d("cart.jsonl")], launches=0)
        with open(d("cart.jsonl")) as f:
            chunks = [e for e in map(json.loads, f) if e["kind"] == "chunk"]
        record["run_cartpole_array_control_step_ms"] = \
            sum(c["wall_s"] for c in chunks) / (-(-CLI_CART_STEPS // CHUNK) * CHUNK) * 1e3
        for kind in ("states", "actions"):
            os.makedirs(d("data", kind))
            shutil.copy(d("cart", f"{kind}.csv"), d("data", kind, f"{kind}_0.csv"))
        csv_rows(d("cart", "states.csv"), 4)
        _, out, _ = call("train cartpole", [
            "train", "--preset", "cartpole", "--states", d("data", "states"),
            "--actions", d("data", "actions"), "--epochs", str(CLI_CART_EPOCHS),
            "--ckpt-dir", d("ckpt")])
        if out["epochs"] != CLI_CART_EPOCHS or not np.isfinite(out["final_train_loss"]):
            raise AssertionError(f"cli train: {out}")
        _, out, secs = call("estimate cartpole", [
            "estimate", "--preset", "cartpole", "--checkpoint", out["final_checkpoint"],
            "--steps", str(CLI_EST_STEPS), "--out", d("est")], launches=0)
        if len(csv_rows(d("est", "states.csv"), 4)) != CLI_EST_STEPS:
            raise AssertionError(f"cli estimate cartpole: {out}")
        record["estimate_cartpole_step_ms_with_setup"] = secs / CLI_EST_STEPS * 1e3

        _, out, secs = call("estimate quadruped", [
            "estimate", "--preset", "quadruped", "--steps", str(CLI_QUAD_EST_STEPS),
            "--out", d("est_quad")], launches=0)
        if len(csv_rows(d("est_quad", "states.csv"), 37)) != CLI_QUAD_EST_STEPS:
            raise AssertionError(f"cli estimate quadruped: {out}")
        record["estimate_quadruped_step_ms_with_setup"] = secs / CLI_QUAD_EST_STEPS * 1e3

        _, out, _ = call("replay humanoid", [
            "replay", "--states", d("run", "states.csv"), "--asset", "humanoid.xml"])
        if (out["frames"], out["nbody"]) != (CLI_STEPS, hum.nbody) \
                or not np.isfinite(out["root_travel"]):
            raise AssertionError(f"cli replay: {out}")

        _, out, _ = call("warm humanoid_collect", ["warm", "--task", "humanoid_collect"],
                         launches=1)
        if not all(out["cached"].values()):
            raise AssertionError(f"cli warm rebuilt a kernel the build phase built: {out}")

    try:
        with contextlib.redirect_stdout(sys.stderr):
            cli.main(["bench"])
    except SystemExit as e:
        refused = e.code not in (0, None)
        message = str(e.code)
    else:
        refused, message = False, None
    if not refused or "bench" in sys.modules:
        raise AssertionError("cli bench did not refuse, or imported bench.py")
    seconds = time.perf_counter() - t_phase
    emit({"phase": "main_cli", "command": "summary", "bench_refused": message,
          **record, "seconds": seconds})
    return {"paths": paths, **record}


# ---------------------------------------------------------------------------
# slice 13: LQR and the K-sharded planners
# ---------------------------------------------------------------------------

# tests/test_lqr.py's cartpole and one-leg stand, with their gates
CART_LQR_Q, CART_LQR_R = np.diag([10.0, 100.0, 1.0, 1.0]), 0.1 * np.eye(1)
CART_LQR_START, CART_LQR_STEPS = (0.1, 0.15), 400
STAND_STEPS, STAND_HEIGHTS = 200, 2001
# the gated loops end each Newton solve at convergence (Engine.step's
# early_exit: the same bits as the card's default 25 masked iterations, a
# flag read back an iteration), for the run time; LQR_MASKED_STEPS more
# steps on the default path time a controlled step as a caller gets it (10
# before main_coupled came)
LQR_MASKED_STEPS = 4
# the sharded planners: the kernel planner at humanoid_bench's shapes, the
# array planner at humanoid_collect's K=50 with its horizon cut from 100,
# the blocked field in blocks of NOISE_BLOCK
SHARD_ARRAY_T, NOISE_BLOCK = 8, 1024


def controlled_loop(eng, ctrl, st, n: int) -> dict:
    """n controlled coupled steps from st with the Newton loop's early
    exit, then LQR_MASKED_STEPS on from there on the default path (all 25
    masked iterations on the card): the n-th state (gated) and the ms of a
    step each way."""
    torch.cuda.synchronize()
    ts = time.perf_counter()
    for _ in range(n):
        st = eng.step(st, ctrl(st), early_exit=True)
    torch.cuda.synchronize()
    out = {"state": st, "controlled_step_ms_early_exit": (time.perf_counter() - ts) / n * 1e3}
    ts = time.perf_counter()
    for _ in range(LQR_MASKED_STEPS):
        st = eng.step(st, ctrl(st))
    torch.cuda.synchronize()
    if not torch.isfinite(st.qpos).all():
        raise AssertionError("non-finite state after the masked steps")
    out["controlled_step_ms"] = (time.perf_counter() - ts) / LQR_MASKED_STEPS * 1e3
    out["masked_steps"] = LQR_MASKED_STEPS
    return out


def lqr_phase() -> dict:
    """main_lqr: solver/lqr on the card in float64 (the Engine's dtype for
    the linearization, the Riccati iteration, the controller and the plant):
    the cartpole from (0.1, 0.15) for 400 coupled steps (|theta| < 0.02,
    |x| < 0.1), then make_humanoid_lqr's full 2,001-height sweep and 200
    controlled coupled steps of the one-leg stand (|z - z0| < 0.08, max
    |qvel| < 0.5, spectral radius open > 1.01 and closed < 1.001); the
    gated steps end each Newton solve at convergence (controlled_loop)."""
    from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
    from humanoid_mppi_rl_tpu_torch.physics.model import load_model
    from humanoid_mppi_rl_tpu_torch.solver.lqr import make_humanoid_lqr, make_lqr_controller

    t0 = time.perf_counter()
    f64, dev = torch.float64, torch.device("cuda")
    eng = Engine(load_model("cartpole_plant"), dev, f64)
    cart_seconds = {}
    ctrl, (A, B, K) = make_lqr_controller(eng, np.zeros(2), Q=CART_LQR_Q, R=CART_LQR_R,
                                          seconds=cart_seconds)
    st = eng.forward(torch.tensor(CART_LQR_START, dtype=f64, device=dev),
                     torch.zeros(2, dtype=f64, device=dev))
    cart_ms = controlled_loop(eng, ctrl, st, CART_LQR_STEPS)
    st = cart_ms.pop("state")
    theta, x = float(st.qpos[1]), float(st.qpos[0])
    if not (torch.isfinite(K).all() and abs(theta) < 0.02 and abs(x) < 0.1):
        raise AssertionError(f"cartpole LQR: theta {theta}, x {x} after {CART_LQR_STEPS} steps")

    heng = Engine(load_model("humanoid"), dev, f64)
    controller, d = make_humanoid_lqr(heng, n_heights=STAND_HEIGHTS)
    A, B, K = d["mats"]
    An, Bn, Kn = (m.cpu().numpy() for m in (A, B, K))
    sr_open = float(np.abs(np.linalg.eigvals(An)).max())
    sr_closed = float(np.abs(np.linalg.eigvals(An - Bn @ Kn)).max())
    if not (np.isfinite(An).all() and np.isfinite(Kn).all() and sr_open > 1.01
            and sr_closed < 1.001):
        raise AssertionError(f"humanoid LQR: spectral radius open {sr_open}, closed {sr_closed}")
    z0 = float(d["qpos0"][2])
    st = heng.forward(torch.tensor(d["qpos0"], dtype=f64, device=dev),
                      torch.zeros(heng.model.nv, dtype=f64, device=dev))
    stand_ms = controlled_loop(heng, controller, st, STAND_STEPS)
    st = stand_ms.pop("state")
    dz, vmax = abs(float(st.qpos[2]) - z0), float(st.qvel.abs().max())
    if not (dz < 0.08 and vmax < 0.5):
        raise AssertionError(f"one-leg stand: |z - z0| {dz}, max |qvel| {vmax}")
    out = {"phase": "main_lqr", "dtype": "float64",
           "cartpole": {"steps": CART_LQR_STEPS, "theta": theta, "x": x,
                        "seconds": cart_seconds, **cart_ms},
           "humanoid": {"n_heights": STAND_HEIGHTS, "height": d["info"]["height"],
                        "u_vert_min_abs": float(np.abs(d["info"]["u_vert"]).min()),
                        "residual_actuated_max": float(np.abs(d["info"]["residual"][6:]).max()),
                        "spectral_radius_open": sr_open, "spectral_radius_closed": sr_closed,
                        "steps": STAND_STEPS, "z_drift": dz, "qvel_max_abs": vmax,
                        "seconds": d["seconds"], **stand_ms},
           "gates": {"cartpole": "|theta| < 0.02, |x| < 0.1",
                     "humanoid": "|z - z0| < 0.08, max|qvel| < 0.5, open > 1.01, closed < 1.001"},
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _max_diff(a: dict, b: dict) -> dict:
    return {k: float((torch.as_tensor(a[k]).double() - torch.as_tensor(b[k]).double())
                     .abs().max()) for k in a}


def _plan_outputs(action, state, diag) -> dict:
    return {"action": action, "U": state.U, **dataclasses.asdict(diag)}


def sharded_phase(main_replan_ms: float) -> dict:
    """check_sharded: parallel/mesh in a one-rank NCCL group. The sharded
    kernel planner at humanoid_bench (K=8192, H=64, f32) against
    make_kernel_mppi on the same injected noise, and both with
    noise_block=NOISE_BLOCK drawing their own (bit-identical expected:
    the same kernel on the same samples, all_reduce over one rank the
    identity); the sharded array planner (humanoid_collect at K=50, T=8)
    against make_mppi on the same noise (bit-identical expected; gate rel
    1e-6); sample_noise_blocked's field drawn whole and in four slices at
    their offsets on the device (equal); then chained sharded replans
    (one rollout launch each) timed in turns with unsharded ones."""
    import torch.distributed as dist

    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.parallel.mesh import (make_mesh, make_sharded_kernel_mppi,
                                                          make_sharded_mppi)
    from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
    from humanoid_mppi_rl_tpu_torch.solver.mppi import (MPPIState, make_mppi, replan_seed,
                                                        sample_noise_blocked)

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        spec, model, _, _, _, init, cfg = load_task("humanoid_bench")
        gen = torch.Generator(device="cuda").manual_seed(5)
        noise = cfg.sigma * torch.randn((cfg.T, model.nu, cfg.K), generator=gen, device="cuda")
        plan_1 = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, spec.cost_kwargs)
        plan_s = make_sharded_kernel_mppi(model, spec.kernel_cost_factory, cfg, mesh,
                                          spec.cost_kwargs)
        seeded = lambda: MPPIState.seeded(0, cfg.T, model.nu)
        diffs = {"injected": _max_diff(_plan_outputs(*plan_s(seeded(), init, noise=noise)),
                                       _plan_outputs(*plan_1(seeded(), init, noise=noise)))}
        bcfg = dataclasses.replace(cfg, noise_block=NOISE_BLOCK)
        pb_1 = make_kernel_mppi(model, spec.kernel_cost_factory, bcfg, spec.cost_kwargs)
        pb_s = make_sharded_kernel_mppi(model, spec.kernel_cost_factory, bcfg, mesh,
                                        spec.cost_kwargs)
        diffs["noise_block"] = _max_diff(_plan_outputs(*pb_s(seeded(), init)),
                                         _plan_outputs(*pb_1(seeded(), init)))
        bad = {k: v for k, v in diffs.items() if any(x != 0.0 for x in v.values())}
        if bad:
            raise AssertionError(f"sharded kernel replan differs from make_kernel_mppi: {bad}")

        seed = replan_seed(torch.Generator(device="cuda").manual_seed(9))
        whole = sample_noise_blocked(seed, cfg.T, model.nu, cfg.K, NOISE_BLOCK, 0,
                                     torch.float32, "cuda")
        kl = cfg.K // 4
        parts = torch.cat([sample_noise_blocked(seed, cfg.T, model.nu, kl, NOISE_BLOCK,
                                                r * kl // NOISE_BLOCK, torch.float32, "cuda")
                           for r in range(4)], -1)
        if not torch.equal(whole, parts):
            raise AssertionError("blocked noise depends on the split")

        aspec, amodel, dyn, running, terminal, ainit, acfg = load_task("humanoid_collect")
        acfg = dataclasses.replace(acfg, horizon=SHARD_ARRAY_T)
        anoise = acfg.sigma * torch.randn((acfg.K, acfg.T, amodel.nu), generator=gen,
                                          device="cuda")
        aseeded = lambda: MPPIState.seeded(0, acfg.T, amodel.nu)
        got = _plan_outputs(*make_sharded_mppi(dyn, running, acfg, mesh, terminal_fn=terminal)(
            aseeded(), ainit, noise=anoise))
        want = _plan_outputs(*make_mppi(dyn, running, acfg, terminal_fn=terminal)(
            aseeded(), ainit, noise=anoise))
        diffs["array"] = _max_diff(got, want)
        rel = max(diffs["array"][k] / max(float(torch.as_tensor(want[k]).abs().max()), 1e-30)
                  for k in want)
        if not rel <= 1e-6:
            raise AssertionError(f"sharded array replan differs from make_mppi: {diffs['array']}")

        # chained replans in turns (sharded, unsharded, unsharded, sharded),
        # the rollout launches counted over each sharded block alone
        states = {"sharded": seeded(), "unsharded": seeded()}
        plans = {"sharded": plan_s, "unsharded": plan_1}
        for name in plans:
            for _ in range(WARMUP):
                _, states[name], _ = plans[name](states[name], init)
        times, launches = {"sharded": [], "unsharded": []}, 0
        for name in ("sharded", "unsharded", "unsharded", "sharded"):
            torch.cuda.synchronize()
            rk.launches = 0
            for _ in range(TIMED // 2):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                action, states[name], diag = plans[name](states[name], init)
                b.record()
                torch.cuda.synchronize()
                times[name].append(a.elapsed_time(b))
            if name == "sharded":
                launches += rk.launches
        if launches != TIMED:
            raise AssertionError(f"{launches} rollout launches in {TIMED} sharded replans")
        if not (torch.isfinite(action).all() and torch.isfinite(states["sharded"].U).all()):
            raise AssertionError("non-finite sharded replan")
    finally:
        dist.destroy_process_group()
    out = {"phase": "check_sharded", "ranks": 1, "backend": "nccl", "K": cfg.K, "H": cfg.T,
           "noise_block": NOISE_BLOCK, "array_K": acfg.K, "array_T": acfg.T,
           "max_abs_diff": diffs,
           "tolerance": {"kernel planner": "bit-identical (max |diff| == 0)",
                         "array planner": "max |diff| <= 1e-6 x max |value|, bit-identical "
                                          "expected", "blocked field": "equal"},
           "launches_per_replan": launches / TIMED, "replans": TIMED, "launches": launches,
           "sharded_replan_ms_median": statistics.median(times["sharded"]),
           "unsharded_replan_ms_median": statistics.median(times["unsharded"]),
           "main_replan_ms_median": main_replan_ms,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out




# main_coupled: planning on the coupled tier (EpisodeRunner(planner_solver=
# "coupled")), the mesh pairs and coupled_pgs. The f64 checks hold the card
# against the CPU with the Newton loop's early exit (the masked loop's
# bits); the timing runs the default masked path in f32 at
# scripts/dev_hopper.py's K=4096, H=50 and the cartpole's preset K=30,
# T=100 (the reference's, src/cartpole_mppi.py:12-15)
COUPLED_HOPPER = ("hopper", 4096, 50)
COUPLED_CART = ("cartpole", 30, 100)
COUPLED_GO1 = ("go1", 8, 5)
# the checked cartpole replan starts with the cart half-way to its slider
# limit (as tests/test_torch_port_coupled_planner's oracle test does) and
# moving toward it at 1 m/s, so that samples reach it within the horizon
# (at rest there, none of the K=30 does on the first replan): its Newton
# loop must take iterations
COUPLED_CART_START = ([0.5, np.pi], [1.0, 0.0])
COUPLED_WARMUP, COUPLED_TIMED = 1, 2
MESH_SNAPSHOTS = ("mesh_on_box_plant", "box_on_mesh_plant", "mesh_on_mesh_plant",
                  "two_dyn_stack_plant", "box_on_dyn_mesh_plant", "mesh_on_sphere_plant",
                  "mesh_on_capsule_plant", "clustered_cube_plant")
MESH_STEPS, MESH_K = 5, 256
PGS_PLANTS, PGS_STEPS, PGS_K = ("cartpole_plant", "hopper_plant", "humanoid_plant"), 3, 64


def mesh_states(model, K: int, seed: int = 0):
    """qpos (nq, K), qvel (nv, K) numpy arrays of a mesh-pair model: qpos0
    with each free body lowered 5 to 9 cm (into its contact: the models
    rest 5 cm above it), tilted by N(0, 0.05) on its quaternion, and
    velocities N(0, 0.3)."""
    from humanoid_mppi_rl_tpu_torch.physics.model import FREE

    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(model.qpos0, dtype=np.float64)[:, None], (1, K))
    qvel = rng.normal(0, 0.3, (model.nv, K))
    for j in model.joints:
        if j.jtype == FREE:
            a = j.qposadr
            qpos[a + 2] -= 0.05 + rng.uniform(0.0, 0.04, K)
            q = qpos[a + 3:a + 7] + rng.normal(0, 0.05, (4, K))
            qpos[a + 3:a + 7] = q / np.linalg.norm(q, axis=0)
    return qpos, qvel


def _early_exit_dynamics(engine, record: Optional[list] = None):
    """dynamics(state, ctrl, t) stepping `engine` with the Newton loop's
    early exit (the masked loop's bits, a flag read back an iteration);
    `record` gathers each step's largest iteration count over K (device)."""
    def dyn(state, ctrl, t=None, info=None):
        d = {} if record is not None else None
        out = engine.step(state, ctrl, solver="coupled", early_exit=True, info=d)
        if record is not None and "iterations" in d:
            record.append(d["iterations"].amax())
        return out
    return dyn


def _coupled_replan(task: str, K: int, T: int, device, dtype, seed: int = 0,
                    start: Optional[tuple] = None) -> dict:
    """One replan of `task` on the coupled planner (make_mppi over the
    coupled step with the early exit) from `start` = (qpos, qvel) (the
    task's initial state if None), with a plan and noise from `seed`: the action,
    the shifted plan and the largest Newton iteration count over K of each
    rollout step."""
    from humanoid_mppi_rl_tpu_torch.dynamics.physics import make_physics_dynamics
    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState, make_mppi

    spec, model, _, running, terminal, init, cfg = load_task(task, device=device, dtype=dtype)
    cfg = dataclasses.replace(cfg, n_samples=K, horizon=T)
    eng = make_physics_dynamics(model, solver="coupled", device=device, dtype=dtype).engine
    if start is not None:
        init = eng.forward(*(torch.tensor(x, dtype=dtype, device=device) for x in start))
    record = []
    plan = make_mppi(_early_exit_dynamics(eng, record), running, cfg, terminal_fn=terminal)
    rng = np.random.default_rng(seed)
    U = torch.tensor(rng.normal(0, 0.3, (T, model.nu)), dtype=dtype, device=device)
    noise = torch.tensor(rng.normal(0, float(cfg.sigma), (K, T, model.nu)), dtype=dtype,
                         device=device)
    ms = MPPIState.seeded(seed, T, model.nu, device=device, dtype=dtype)
    action, ms, _ = plan(MPPIState(U=U, generator=ms.generator), init, noise)
    return {"action": action, "U": ms.U, "newton_iterations": torch.stack(record)}


def _card_vs_cpu(fn, card: Optional[dict] = None) -> dict:
    """fn(device) -> dict of tensors, on the card and the CPU: max |diff|
    of each. `card`, if given, receives the card's outputs."""
    a, b = fn(torch.device("cuda")), fn(torch.device("cpu"))
    if card is not None:
        card.update(a)
    return {k: float((a[k].cpu() - b[k]).abs().max()) for k in a}


def coupled_checks() -> dict:
    """main_coupled's f64 card-vs-CPU checks: one cartpole replan at K=30,
    T=100 from COUPLED_CART_START, where samples reach the slider's limit
    (it fails if no rollout step took a Newton iteration on the card), and
    one Go1 replan at K=8, H=5 on the coupled planner; 5 coupled steps of
    each mesh snapshot from a contact state and one penalty step over K=256
    of each; 3 coupled_pgs steps of the cartpole, hopper and humanoid
    plants and one over K=64. `card_replans` counts the replans run on the
    card."""
    from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
    from humanoid_mppi_rl_tpu_torch.physics.model import load_model

    f64 = torch.float64
    out = {"card_replans": 0}
    for (task, K, T), start in ((COUPLED_CART, COUPLED_CART_START), (COUPLED_GO1, None)):
        card = {}
        d = _card_vs_cpu(lambda dev: _coupled_replan(task, K, T, dev, f64, start=start), card)
        out["card_replans"] += 1
        iters = card["newton_iterations"]
        d["newton_iterations_max_card"] = int(iters.max())
        d["limit_or_contact_steps_card"] = int((iters > 0).sum())
        out[f"{task}_replan_K{K}_T{T}"] = d
        if not d["action"] < 1e-9:
            raise AssertionError(f"coupled {task} replan, card vs CPU: {d}")
        if d["newton_iterations_max_card"] == 0:
            raise AssertionError(f"coupled {task} replan: no rollout step took a Newton "
                                 "iteration, so no constraint row was checked")

    def steps(name, solver, n, qpos, qvel, ctrl):
        def run(dev):
            eng = Engine(load_model(name), dev, f64)
            tt = lambda a: torch.tensor(a, dtype=f64, device=dev)
            lead = qpos.shape[:-1]
            st = eng.forward(tt(qpos), tt(qvel), torch.zeros(lead, dtype=f64, device=dev))
            for _ in range(n):
                st = eng.step(st, tt(ctrl), solver=solver, early_exit=True)
            return {"qpos": st.qpos, "qvel": st.qvel}
        d = _card_vs_cpu(run)
        if not (d["qpos"] < 1e-10 and d["qvel"] < 1e-8):
            raise AssertionError(f"{name} {solver} x{n}, card vs CPU: {d}")
        return d

    for name in MESH_SNAPSHOTS:
        m = load_model(name)
        qpos, qvel = mesh_states(m, MESH_K, seed=1)
        out[name] = {"coupled_steps": steps(name, "coupled", MESH_STEPS, qpos[:, 0], qvel[:, 0],
                                            np.zeros(m.nu)),
                     "penalty_K256": steps(name, "penalty", 1, qpos.T.copy(), qvel.T.copy(),
                                           np.zeros((MESH_K, m.nu)))}
    for name in PGS_PLANTS:
        m = load_model(name)
        if name == "humanoid_plant":
            qpos, qvel, ctrl = plant_state(m, "sunk", seed=1)
        else:
            qs, vs = (hopper_states(m, PGS_K, seed=1) if name == "hopper_plant"
                      else (x.cpu().numpy() for x in
                            cartpole_inputs(m, PGS_K, 1, f64, seed=1, device="cpu")[:2]))
            qpos, qvel, ctrl = qs[:, 0], vs[:, 0], np.full(m.nu, 0.3)
        out[f"{name}_coupled_pgs"] = steps(name, "coupled_pgs", PGS_STEPS, qpos, qvel, ctrl)
    m = load_model("hopper_plant")
    qs, vs = hopper_states(m, PGS_K, seed=2)
    ctrl = np.random.default_rng(2).normal(0, 0.5, (PGS_K, m.nu))
    out["hopper_plant_coupled_pgs_K64"] = steps("hopper_plant", "coupled_pgs", 1, qs.T.copy(),
                                                vs.T.copy(), ctrl)
    return out


def coupled_timing(task: str, K: int, T: int, warmup: int, timed: int) -> dict:
    """EpisodeRunner(task, planner_solver="coupled") at K, T in f32 on the
    card, the default masked Newton loop: warmup + timed control steps
    (replan and plant ms by CUDA events); one rollout step of the planner's
    dynamics over K under the profiler (device launches, busy share) and
    under set_sync_debug_mode("error"); then one replan with the early
    exit through the same costs, for the record (its ms, and the Newton
    iterations each rollout step took, the largest over K: the masked
    loop's too, which takes the same iterates)."""
    from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
    from humanoid_mppi_rl_tpu_torch.dynamics.physics import make_physics_dynamics
    from humanoid_mppi_rl_tpu_torch.solver.mppi import broadcast_state, make_mppi

    t0 = time.perf_counter()
    runner = EpisodeRunner(task, planner_solver="coupled",
                           mppi_override=dict(n_samples=K, horizon=T))
    ms, plant = runner.fresh_controller(0), runner.init_state
    plan_ms, plant_ms = [], []
    for i in range(warmup + timed):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        action, ms, diag = runner.plan(ms, plant)
        ev[1].record()
        plant = runner.plant_dyn(plant, action, 0)
        ev[2].record()
        torch.cuda.synchronize()
        if i >= warmup:
            plan_ms.append(ev[0].elapsed_time(ev[1]))
            plant_ms.append(ev[1].elapsed_time(ev[2]))
    for name, v in (("action", action), ("U", ms.U), ("qpos", plant.qpos), ("beta", diag.beta)):
        if not torch.isfinite(v).all():
            raise AssertionError(f"coupled {task} planner: non-finite {name}")
    spec, model = runner.spec, runner.model
    dyn = make_physics_dynamics(model, solver="coupled")
    eng = dyn.engine
    x = broadcast_state(plant, K)
    u = torch.zeros(K, model.nu, device=x.qpos.device) + action
    running, terminal = spec.cost_factory(model, **spec.cost_kwargs)

    def rollout_step():
        s = dyn(x, u, 0)
        return running(s, u, 0)

    rollout_step()
    prof = kernel_profile(rollout_step, top=6)
    torch.cuda.set_sync_debug_mode("error")
    try:
        rollout_step()
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    record = []
    eplan = make_mppi(_early_exit_dynamics(eng, record=record), running, runner.cfg,
                      terminal_fn=terminal)
    torch.cuda.synchronize()
    te = time.perf_counter()
    ea, _, _ = eplan(ms, plant)
    torch.cuda.synchronize()
    early_ms = (time.perf_counter() - te) * 1e3
    iters = [int(r) for r in record]
    per_step = prof["device_launches"]["kernels"]
    return {"task": task, "K": K, "T": T, "dtype": "float32", "warmup_steps": warmup,
            "timed_steps": timed, "card_replans": warmup + timed + 1, "replan_ms": plan_ms, "replan_ms_median": statistics.median(plan_ms),
            "plant_ms": plant_ms, "newton_loop": "25 masked iterations (the default)",
            "rollout_step": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                   "device_busy_share")},
            "launches_per_rollout_step": prof["device_launches"],
            "launches_per_replan_from_steps": None if per_step is None else per_step * T,
            "sync_free_rollout_step": True,
            "early_exit_replan_ms": early_ms,
            "newton_iterations_per_rollout_step": iters,
            "newton_iterations_max": max(iters), "newton_iterations_mean": statistics.mean(iters),
            "early_exit_action_finite": bool(torch.isfinite(ea).all()),
            "seconds": time.perf_counter() - t0}


def coupled_phase() -> dict:
    """main_coupled: the f64 checks (coupled_checks), then the hopper's and
    the cartpole's coupled planners timed (coupled_timing). No kernel runs
    on this path: the rollout kernel's count must stay 0."""
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

    t0 = time.perf_counter()
    rk.launches = 0
    checks = coupled_checks()
    t_checks = time.perf_counter() - t0
    hopper = coupled_timing(*COUPLED_HOPPER, COUPLED_WARMUP, COUPLED_TIMED)
    cart = coupled_timing(*COUPLED_CART, 0, 1)
    if rk.launches:
        raise AssertionError(f"the coupled planners launched the rollout kernel {rk.launches} times")
    out = {"phase": "main_coupled", "checks": checks, "checks_seconds": t_checks,
           "gates": {"replans": "action max|diff| < 1e-9 (f64, card vs CPU)",
                     "steps": "qpos 1e-10, qvel 1e-8 (f64, card vs CPU)"},
           "hopper": hopper, "cartpole": cart, "rollout_kernel_launches": rk.launches,
           "card_replans": checks["card_replans"] + hopper["card_replans"] + cart["card_replans"],
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.ops import _build
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
    from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
    from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState

    # float32 products on the card in full precision (the PyTorch default,
    # stated: the weighting's noise @ w is a product)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        builds = dict(zip(_build.SOURCES, pool.map(_build.build, _build.SOURCES)))
    hgmma_of = {}
    for source, built in builds.items():
        ptxas = [ln.strip() for ln in built["log"].splitlines()
                 if any(s in ln for s in ("Function properties for", "stack frame", "registers"))]
        hgmma = sass_count(built["path"], "HGMMA")
        if source == "estimator_kernel.cu" and hgmma == 0:
            raise AssertionError("no HGMMA instruction in the estimator library: bf16 GEMMs "
                                 "are not on wgmma")
        hgmma_of[source] = "not available" if hgmma is None else hgmma
        emit({"phase": "build", "source": source, "cached": built["cached"],
              "nvcc_seconds": built["seconds"], "ptxas": ptxas,
              "sass_hgmma": hgmma_of[source],
              "seconds": time.perf_counter() - t0})

    # ---- check: kernel against its plain version on the card -------------
    t0 = time.perf_counter()
    spec, model, *_, cfg = load_task("humanoid_bench", dtype=torch.float64)
    errs, geometry = check_rollout(model, spec.kernel_cost_factory, spec.cost_kwargs)
    trig = sincos_check()
    emit({"phase": "check", "kernel": "rollout", "K": list(CHECK_KS), "T": CHECK_T,
          "tolerance": {"float64": "rtol=atol=1e-9",
                        "float32": "cost rel median<1e-3, max<1e-2",
                        "repeat": "two launches bit-identical"},
          "geometry": {str(dt).replace("torch.", ""): geo for dt, geo in geometry.items()},
          "errors": errs, "sincos_f32": trig, "seconds": time.perf_counter() - t0})

    # ---- main path at full width -------------------------------------------
    t0 = time.perf_counter()
    spec, model, _, _, _, init, cfg = load_task("humanoid_bench")
    plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, spec.cost_kwargs)
    ms = MPPIState.seeded(0, cfg.T, model.nu)
    rk.launches = 0
    times = []
    for i in range(WARMUP + TIMED):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        action, ms, diag = plan(ms, init)
        b.record()
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append(a.elapsed_time(b))
    main_launches = rk.launches
    if main_launches != WARMUP + TIMED:
        raise AssertionError(f"{main_launches} kernel launches for {WARMUP + TIMED} replans")
    outs = {"action": action, "U": ms.U, **dataclasses.asdict(diag)}
    for name, v in outs.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite {name}")
    if tuple(action.shape) != (model.nu,) or tuple(ms.U.shape) != (cfg.T, model.nu):
        raise AssertionError("unexpected output shapes")
    q1, q3 = np.percentile(times, [25, 75])
    med = statistics.median(times)
    # one more replan under the profiler, after the launch count was read
    prof = device_profile(lambda: plan(ms, init))
    emit({"phase": "main", "task": "humanoid_bench", "K": cfg.K, "H": cfg.T,
          "dtype": "float32", "replans": TIMED, "launches": main_launches,
          "replan_ms_median": med, "replan_ms_q1": float(q1), "replan_ms_q3": float(q3),
          "replan_ms_min": min(times), "replan_ms_max": max(times),
          "rollouts_per_s": cfg.K / (med / 1e3),
          "beta": float(diag.beta), "ess": float(diag.ess),
          "profiled_replan": prof, "seconds": time.perf_counter() - t0})

    # ---- each kernel alone at the main path's shapes -----------------------
    t0 = time.perf_counter()
    x = seeded_inputs(model, cfg.K, cfg.T, torch.float32, seed=2)
    ro = plan.rollouts
    kernel_ms = cuda_ms(lambda: ro(*x), 5)
    out = {}
    plain_ms = cuda_ms(lambda: out.setdefault("plain", ro.plain(*x)), 1)
    # the same full-shape inputs through both: 64 f32 steps let rounding
    # reach contact switching in a few samples, so only the median is held
    ck, cp = ro(*x)[0].double(), out["plain"][0].double()
    rel = (ck - cp).abs() / cp.abs()
    full = {"cost_rel_median": float(rel.median()), "cost_rel_max": float(rel.max()),
            "cost_max_abs": float((ck - cp).abs().max())}
    if not (torch.isfinite(ck).all() and full["cost_rel_median"] < 1e-3):
        raise AssertionError(f"full-shape f32 kernel vs plain: {full}")
    n_ops = cfg.K * ops_per_rollout(model, spec.kernel_cost_factory, spec.cost_kwargs, cfg.T)
    n_bytes = 4 * (cfg.K * (2 * model.nq + 2 * model.nv + 1)
                   + cfg.T * model.nu * (cfg.K + 1) + rk.NP)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_F32_OPS_PER_S * 1e3
    del x, out
    sweep = {}
    for K in SWEEP_K:
        xs = seeded_inputs(model, K, cfg.T, torch.float32, seed=2)
        ro(*xs)
        sweep[K] = cuda_ms(lambda: ro(*xs), 3)
        del xs
    torch.cuda.empty_cache()
    ptxas = {k: v for k, v in ptxas_stats(builds["rollout_kernel.cu"]["log"]).items()
             if "rollout" in k}
    rdiag = rollout_diagnostics(model, ro, cfg.T)
    emit({"phase": "time", "kernel": "rollout", "K": cfg.K, "T": cfg.T,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms, "ops": n_ops, "bytes": n_bytes,
          "kernel_vs_plain": full, "tolerance": "cost rel median<1e-3",
          "sweep_ms_by_K": sweep, "geometry": ro.geometry.get(torch.float32), "ptxas": ptxas,
          "diagnostics": rdiag,
          "seconds": time.perf_counter() - t0})

    collect = collect_phase()
    go1 = go1_phases()

    collected = go1.pop("collected_rows")
    est = estimator_phases()
    est["sass_hgmma"] = hgmma_of["estimator_kernel.cu"]
    loop = learning_phases(collected)
    small = small_robot_phases()
    humanoid = humanoid_task_phases()
    arm5 = arm5_phase(builds)
    cli = cli_phase(med)
    lqr_phase()
    sharded = sharded_phase(med)
    coupled = coupled_phase()
    est["paths"] = {"estimator replan": {"launches": est["launches"],
                                         "replans": EST_WARMUP + EST_TIMED},
                    **loop.pop("paths"), **small["estimator"].pop("paths")}
    est["trained_weights"] = loop
    est.update(small["estimator"])

    emit({"kernels": [{
        "name": "rollout",
        "route": "cuda",
        "source": "humanoid_mppi_rl_tpu_torch/ops/csrc/rollout_kernel.cu",
        "replaces": "humanoid_mppi_rl_tpu/ops/rollout_kernel.py:86",
        "launches": main_launches,
        "robots": {"humanoid": ["humanoid", "humanoid_v1", "humanoid_hard"],
                   "go1": ["quadruped", "quadruped_jl"],
                   "cartpole": ["cartpole"], "hopper": ["hopper"], "arm5": ["arm5"]},
        "paths": {"humanoid_bench replan": {"launches": main_launches,
                                            "replans": WARMUP + TIMED},
                  "humanoid_walk collect": {"launches": collect["launches_collect"],
                                            "control_steps": collect["control_steps"]},
                  **go1.pop("paths"), **small["rollout"].pop("paths"),
                  **humanoid.pop("paths"),
                  "arm5_reach": {"launches": arm5["launches"],
                                 "control_steps": arm5["control_steps"]},
                  **cli.pop("paths"),
                  "humanoid_bench sharded replan (one-rank NCCL group)": {
                      "launches": sharded["launches"], "replans": sharded["replans"]},
                  "coupled planners (hopper K=4096 H=50, cartpole K=30 T=100)": {
                      "launches": coupled["rollout_kernel_launches"],
                      "replans": coupled["card_replans"]}},
        **humanoid,
        "collect_control_step_ms": collect["collect_control_step_ms"],
        "go1": go1,
        **small["rollout"],
        "arm5": arm5,
        "cli": cli,
        "sharded": {k: sharded[k] for k in ("sharded_replan_ms_median",
                                            "unsharded_replan_ms_median", "launches_per_replan")},
        "max_abs_err": max(e["cost_max_abs"] for k, e in errs.items() if "float32" in k),
        "max_abs_err_f64": max(e["cost_max_abs"] for k, e in errs.items() if "float64" in k),
        "cost_rel_median_f32": max(e["cost_rel_median"] for k, e in errs.items()
                                   if "float32" in k),
        "full_shape_cost_rel_median_f32": full["cost_rel_median"],
        "full_shape_cost_rel_max_f32": full["cost_rel_max"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None,
    }, est]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
