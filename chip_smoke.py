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
then a `kernels` line, the nvidia-smi line, and the final status line.
Any failed check raises, and the script exits non-zero without the status
line. It imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

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


def device_profile(fn) -> dict:
    """One call of fn under torch.profiler: device time by kernel, its sum,
    the call's wall time and the device's busy share (the profiler's own
    launch overhead lengthens the wall time a little)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            name = ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            by_kernel[name] = by_kernel.get(name, 0.0) + ev.self_device_time_total / 1e3
    busy_ms = sum(by_kernel.values())
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "device_ms_by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


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


def ops_per_rollout(spec, model, T) -> int:
    """Scalar operations one sample's rollout needs: the plain version's
    arithmetic ops (0/1 constants already folded away), counted on the CPU
    at T=1 and T=2 and extended linearly to T."""
    from torch.utils._python_dispatch import TorchDispatchMode

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
        ro = build_rollout_kernel(model, spec.cost_factory, t,
                                  cost_kwargs=spec.cost_kwargs, device="cpu")
        x = seeded_inputs(model, k, t, torch.float64, device="cpu")
        Count.n = 0
        with Count():
            ro(*x)
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
    qpos0, qvel0, _, U, noise = x
    nq, K = qpos0.shape
    geo = ro.geometry[qpos0.dtype]
    params = torch.zeros(16, dtype=qpos0.dtype, device="cuda")
    outs = (torch.empty(K, dtype=qpos0.dtype, device="cuda"), torch.empty_like(qpos0),
            torch.empty_like(qvel0))
    fn = lib.hmr_rollout_f64 if qpos0.dtype == torch.float64 else lib.hmr_rollout_f32
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 9 + [cint, cint, ptr, cint, cint]
    rc = fn(ro.tables[qpos0.dtype].data_ptr(),
            *[a.data_ptr() for a in (qpos0, qvel0, U, noise, params, *outs)], K, U.shape[0],
            torch.cuda.current_stream().cuda_stream,
            samples_per_block or geo["samples_per_block"], smem_bytes or geo["smem_bytes"])
    if rc:
        raise RuntimeError(f"rollout launch failed: cudaError {rc}")
    return outs


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


def rollout_diagnostics(model, ro, T) -> dict:
    """(1) Occupancy sweep: one block of S samples per SM (the shared memory
    request forced to the largest block's), K = SMs * S, so each SM runs S
    warps: flat times mean each warp's own latency bounds the kernel,
    times growing with S mean the SM's instruction throughput does. (2) The kernel's
    time split by phase at the main path's K, from the profiling build."""
    import ctypes
    from humanoid_mppi_rl_tpu_torch.ops import _build
    from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk

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
        x = seeded_inputs(model, sms * S, T, torch.float32, seed=2)
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

    cycles = phase_cycles(seeded_inputs(model, 8192, T, torch.float32, seed=2))
    # the same with one sample per SM: each phase's own latency
    alone = phase_cycles(seeded_inputs(model, sms, T, torch.float32, seed=2), 1, smem)
    total = sum(cycles.values())
    return {"one_block_per_sm_ms_by_S": sweep, "sms": sms,
            "phase_cycles_per_sample_step": cycles,
            "phase_share": {k: v / total for k, v in cycles.items()},
            "phase_cycles_one_sample_per_sm": alone}


def estimator_phases() -> dict:
    """check_estimator, main_estimator and time_estimator; returns the
    estimator kernel's entry of the `kernels` line."""
    from humanoid_mppi_rl_tpu_torch.collect.estimator import (
        ESTIMATOR_CONFIGS, quadruped_estimator_costs)
    from humanoid_mppi_rl_tpu_torch.dynamics.learned import make_learned_dynamics
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
    apply = ek.make_flash_feature_attention(module)
    library = library_forward(module)
    timed = {}
    for B in EST_TIME_B:
        t0 = time.perf_counter()
        x = x_on_card(B, module.input_dim, seed=3)
        reps = 5 if B <= 8192 else 2
        apply(x)
        kernel_ms = cuda_ms(lambda: apply(x), reps)
        got = apply(x)
        parts = []

        def plain():
            parts[:] = [apply.plain(x[i:i + EST_PLAIN_CHUNK])
                        for i in range(0, B, EST_PLAIN_CHUNK)]

        if B <= EST_PLAIN_CHUNK:
            plain()     # first use of the library's products outside the timing
        plain_ms = cuda_ms(plain, 1)
        want = torch.cat(parts)
        del parts[:]
        e = bf16_errors(got, want)
        if not (e["within"] and torch.isfinite(got).all()):
            raise AssertionError(f"B={B} kernel vs plain: {e}")
        library(x)
        library_ms = cuda_ms(lambda: library(x), reps)
        lib_e = bf16_errors(library(x), want)
        n_ops = estimator_ops(module, B)
        n_bytes = estimator_bytes(module, B, esize=2)
        stages = stage_times(module, B) if B == ESTIMATOR_CONFIGS["quadruped"].K else None
        t_ops = n_ops / PEAK_BF16_OPS_PER_S * 1e3
        t_bytes = n_bytes["function"] / PEAK_BYTES_PER_S * 1e3
        timed[B] = {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "bytes" if t_bytes > t_ops else "operations",
                    "max_abs_err": e["max_abs"]}
        emit({"phase": "time_estimator", "model": "quadruped_attention", "dtype": "bfloat16",
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
              "stages": stages, "seconds": time.perf_counter() - t0})
        del x, got, want
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
    }


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
    spec, model, cfg, _ = load_task("humanoid_bench", dtype=torch.float64)
    ro = rk.build_rollout_kernel(model, spec.cost_factory, CHECK_T,
                                 cost_kwargs=spec.cost_kwargs)
    errs = {}
    for K, dtype in ((K, dt) for K in CHECK_KS for dt in (torch.float64, torch.float32)):
        x = seeded_inputs(model, K, CHECK_T, dtype, seed=1)
        n0 = rk.launches
        ck, qk, vk = ro(*x)
        torch.cuda.synchronize()
        if rk.launches != n0 + 1:
            raise AssertionError("rollout kernel launch was not counted")
        again = ro(*x)
        if not all(torch.equal(a, b) for a, b in zip((ck, qk, vk), again)):
            raise AssertionError(f"K={K} {dtype}: two launches on the same inputs differ")
        cp, qp, vp = ro.plain(*x)
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
        elif not (e["cost_rel_median"] < 1e-3 and e["cost_rel_max"] < 1e-2):
            raise AssertionError(f"K={K} f32 kernel vs plain: {e}")
        e["repeat_bit_identical"] = True
        errs[f"{str(dtype).replace('torch.', '')}/K={K}"] = e
    trig = sincos_check()
    emit({"phase": "check", "kernel": "rollout", "K": list(CHECK_KS), "T": CHECK_T,
          "tolerance": {"float64": "rtol=atol=1e-9",
                        "float32": "cost rel median<1e-3, max<1e-2",
                        "repeat": "two launches bit-identical"},
          "geometry": {str(dt).replace("torch.", ""): geo for dt, geo in ro.geometry.items()},
          "errors": errs, "sincos_f32": trig, "seconds": time.perf_counter() - t0})

    # ---- main path at full width -------------------------------------------
    t0 = time.perf_counter()
    spec, model, cfg, init = load_task("humanoid_bench")
    plan = make_kernel_mppi(model, spec.cost_factory, cfg, spec.cost_kwargs)
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
    n_ops = cfg.K * ops_per_rollout(spec, model, cfg.T)
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

    est = estimator_phases()
    est["sass_hgmma"] = hgmma_of["estimator_kernel.cu"]

    emit({"kernels": [{
        "name": "rollout",
        "route": "cuda",
        "source": "humanoid_mppi_rl_tpu_torch/ops/csrc/rollout_kernel.cu",
        "replaces": "humanoid_mppi_rl_tpu/ops/rollout_kernel.py:86",
        "launches": main_launches,
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
