"""FeatureAttention surrogate forward: the CUDA kernel and its plain PyTorch
version (ops/estimator_kernel.py counterpart).

`make_flash_feature_attention(module, compute_dtype, device)` packs the
module's weights once, in the kernel's layout and compute type, and returns
apply(x (..., F) f32) -> (..., state_dim) f32. Dispatch is by the input's
device: a CUDA tensor launches csrc/estimator_kernel.cu (built by nvcc,
loaded with ctypes) or raises; a CPU tensor runs `apply.plain`. There is no
fallback from one to the other.

Both compute the TPU kernel's function with its roundings: products take
compute-type operands and accumulate in f32, then round to the compute
type; bias adds and the residual stream stay in the compute type; LayerNorm
(eps 1e-6) and softmax are f32; the head sums in f32. The output keeps
only the state_dim tokens, so past the last layer's attention both run on
those rows alone (the kernel compacts them to (B*state_dim, H)).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .._device import resolve_device
from ..models.predictors import LN_EPS
from . import _build

# forward calls that launched the CUDA kernels since import (callers that
# count reset it to 0), and the kernels those calls launched, by kind
launches = 0
KINDS = ("rowwise", "gemm", "attention", "head")
kernel_launches = dict.fromkeys(KINDS, 0)


def pack_weights(module, compute_dtype, device) -> list:
    """The module's weights as the kernel reads them, in this order:
    enc (5,H) = [w_enc, b_enc, ln0_scale, ln0_bias, w_head], pos (F,H), then
    per layer ln1 (2,H), w_qkv (3H,H), b_qkv (3H,), w_o (H,H), b_o (H,),
    ln2 (2,H), w1 (4H,H), b1 (4H,), w2 (H,4H), b2 (H,). Matrices are
    (out, in), row-major, as nn.Linear keeps them: both operands of the
    kernel's products are then contiguous along the summed axis."""
    sd = {k: v.detach().float() for k, v in module.state_dict().items()}

    def put(t):
        return t.to(device=device, dtype=compute_dtype).contiguous()

    w = [put(torch.stack([sd["feature_encoding.0.weight"][:, 0],
                          sd["feature_encoding.0.bias"],
                          sd["feature_encoding.1.weight"],
                          sd["feature_encoding.1.bias"],
                          sd["output_layer.weight"][0]])),
         put(sd["pos_embedding"][0])]
    for i in range(module.attn_layers):
        p = f"layers.{i}."
        w += [put(torch.stack([sd[p + "norm1.weight"], sd[p + "norm1.bias"]])),
              put(sd[p + "attention.in_proj_weight"]),
              put(sd[p + "attention.in_proj_bias"]),
              put(sd[p + "attention.out_proj.weight"]),
              put(sd[p + "attention.out_proj.bias"]),
              put(torch.stack([sd[p + "norm2.weight"], sd[p + "norm2.bias"]])),
              put(sd[p + "ffn.0.weight"]), put(sd[p + "ffn.0.bias"]),
              put(sd[p + "ffn.3.weight"]), put(sd[p + "ffn.3.bias"])]
    return w


# ---- the kernel's stages, each as a plain PyTorch function ---------------
# forward_plain composes them; chip_smoke.py holds each CUDA kernel alone
# against its stage (STAGES below). Activations are (B, F, H) in the
# compute type of the weights. The last layer keeps only the state_dim
# tokens past its attention (the output needs no others): its attention
# takes n_query=state_dim and the stages after it run on (B, state_dim, H).

def layer_norm_plain(h, ln):
    """LayerNorm of each H row with ln (2, H) = [scale; bias]: f32 mean and
    variance, eps 1e-6, rounded to the compute type, then scale and bias."""
    hf = h.float()
    mu = hf.mean(-1, keepdim=True)
    var = (hf - mu).square().mean(-1, keepdim=True)
    y = ((hf - mu) * torch.rsqrt(var + LN_EPS)).to(h.dtype)
    return y * ln[0] + ln[1]


def encode_plain(x, enc, pos):
    """x (B, F) f32 -> h (B, F, H): relu(LN0(round(x) * w_enc + b_enc)) + pos."""
    h = x.to(enc.dtype)[..., None] * enc[0] + enc[1]
    return torch.relu(layer_norm_plain(h, enc[2:4])) + pos


def gemm_plain(a, w, b, res=None, relu=False):
    """round(a @ w^T), w (N, K), with compute-type operands and f32 sums;
    then res + ., then + b, then relu: the TPU kernel's `mm(a, w) + b` and
    `h + mm(a, w) + b`. res (B, F, N) may hold more rows per sample than a
    (B, Fq, K): the first Fq of each sample are added."""
    # compute-type operands are exact in f32: f32 products, f32 sums, one rounding
    c = (a.float() @ w.float().T).to(w.dtype)
    if res is not None:
        c = res[..., :a.shape[-2], :] + c
    c = c + b
    return torch.relu(c) if relu else c


def attention_plain(qkv, num_heads, scale, n_query=None):
    """qkv (B, F, 3H) = [q | k | v] -> (B, n_query, H): per sample and head,
    the first n_query tokens (all F by default) attend to all F: f32 scores
    (q k^T) * scale, f32 softmax rounded to the compute type, then the
    weighted values with f32 sums; heads in head-major columns."""
    B, F, H3 = qkv.shape
    H = H3 // 3
    Fq = F if n_query is None else n_query
    q, k, v = (a.reshape(B, F, num_heads, H // num_heads).transpose(1, 2)
               for a in qkv.split(H, dim=-1))                     # (B, nh, F, hd)
    s = (q[:, :, :Fq].float() @ k.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(qkv.dtype)
    return (p.float() @ v.float()).to(qkv.dtype).transpose(1, 2).reshape(B, Fq, H)


def head_plain(h, w_head, b_out, state_dim):
    """(B, F, H) -> (B, state_dim) f32: f32 sum of round(h * w_head) over the
    first state_dim rows of each sample, + b_out."""
    return (h[:, :state_dim] * w_head).float().sum(-1) + b_out


def forward_plain(w: list, x: torch.Tensor, num_heads: int, state_dim: int,
                  b_out: float) -> torch.Tensor:
    """The kernel's function in PyTorch, in the TPU kernel's op order:
    x (B, F) f32 -> (B, state_dim) f32, weights as pack_weights gives them.
    Past the last layer's attention only the state_dim rows are computed;
    every stage is per row (and every query sees all keys), so this equals
    the forward over all F rows cut to state_dim at the end."""
    H = w[0].shape[1]
    scale = 1.0 / (H // num_heads) ** 0.5
    h = encode_plain(x, w[0], w[1])
    for i in range(2, len(w), 10):
        ln1, w_qkv, b_qkv, w_o, b_o, ln2, w1, b1, w2, b2 = w[i:i + 10]
        n_query = state_dim if i == len(w) - 10 else None
        a = attention_plain(gemm_plain(layer_norm_plain(h, ln1), w_qkv, b_qkv), num_heads, scale,
                            n_query)
        h = gemm_plain(a, w_o, b_o, res=h)
        f = gemm_plain(layer_norm_plain(h, ln2), w1, b1, relu=True)
        h = gemm_plain(f, w2, b2, res=h)
    return head_plain(h, w[0][4], b_out, state_dim)


def attention_rows(F: int, head_dim: int) -> int:
    """Token rows of one (sample, head) in the bf16 attention kernel: F
    padded to a multiple of 16 (the tensor-core tile). That kernel holds a
    query tile's scores in registers, so it takes F <= 64 (every preset
    has F <= 51) and head widths that are multiples of 8 up to 128 (padded
    with zeros to 16, 32, 64 or 128); raises otherwise."""
    if not 1 <= F <= 64 or head_dim % 8 or not 8 <= head_dim <= 128:
        raise ValueError(f"bf16 attention kernel takes 1 <= F <= 64 tokens and a head width "
                         f"that is a multiple of 8 up to 128; got F={F}, head width {head_dim}")
    return 16 * -(-F // 16)


def scratch_rows(B: int, F: int, state_dim: int) -> dict:
    """Rows of the forward's scratch buffers: h holds the residual stream
    (B*F rows of H) and after it the last layer's state rows, compacted
    (B*state_dim); y holds B*F rows of H and big B*F rows of 4H."""
    return {"h": B * (F + state_dim), "y": B * F, "big": B * F}


def make_flash_feature_attention(module, compute_dtype=torch.bfloat16, device="cuda"):
    """apply(x (..., F) f32) -> (..., state_dim) f32 through the kernel;
    `apply.plain` is the plain version on whatever device its input is."""
    dev = resolve_device(device)
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype {compute_dtype}: the kernel takes bfloat16 or float32")
    H, nh, L = module.hidden_dim, module.num_heads, module.attn_layers
    F, Sd = module.state_dim + module.action_dim, module.state_dim
    if H % 8 or H % nh:
        raise ValueError(f"hidden_dim {H} must be a multiple of 8 and of num_heads {nh}")
    if compute_dtype == torch.bfloat16 and dev.type == "cuda":
        attention_rows(F, H // nh)
    w = pack_weights(module, compute_dtype, dev)
    ptrs = (ctypes.c_void_p * len(w))(*[t.data_ptr() for t in w])
    b_out = float(module.output_layer.bias.detach().float()[0])
    # the kernel and the plain version both round the scale to f32
    scale = 1.0 / (H // nh) ** 0.5

    def plain(x):
        x = x.float()
        return forward_plain(w, x.reshape(-1, F), nh, Sd, b_out).reshape(*x.shape[:-1], Sd)

    def launch(x2):
        global launches
        if x2.device != dev:
            raise ValueError(f"flash FeatureAttention built for {dev}; got a tensor on {x2.device}")
        B = x2.shape[0]
        out = torch.empty(B, Sd, dtype=torch.float32, device=dev)
        if B == 0:
            return out
        x2 = x2.contiguous()
        rows = scratch_rows(B, F, Sd)
        h = torch.empty(rows["h"] * H, dtype=compute_dtype, device=dev)
        y = torch.empty(rows["y"] * H, dtype=compute_dtype, device=dev)
        big = torch.empty(rows["big"] * 4 * H, dtype=compute_dtype, device=dev)
        lib = _estimator_lib()
        counts = (ctypes.c_int * len(KINDS))()
        rc = lib.hmr_estimator_forward(
            int(compute_dtype == torch.bfloat16), x2.data_ptr(), out.data_ptr(), ptrs,
            len(w), h.data_ptr(), y.data_ptr(), big.data_ptr(), B, F, Sd, H, nh, L,
            b_out, scale, torch.cuda.current_stream(dev).cuda_stream, counts)
        for kind, n in zip(KINDS, counts):
            kernel_launches[kind] += n
        if rc != 0:
            raise RuntimeError(f"estimator kernel launch failed: cudaError {rc}")
        launches += 1
        return out

    def apply(x):
        x = x.float()
        if x.shape[-1] != F:
            raise ValueError(f"x: last dim {x.shape[-1]}, expected {F}")
        if x.device.type == "cuda":
            return launch(x.reshape(-1, F)).reshape(*x.shape[:-1], Sd)
        if x.device.type == "cpu":
            return plain(x)
        raise ValueError(f"no estimator path for device {x.device}")

    apply.plain = plain
    return apply


@functools.lru_cache(maxsize=None)
def _estimator_lib() -> ctypes.CDLL:
    lib = _build.load_library("estimator_kernel.cu")
    ptr = ctypes.c_void_p
    fn = lib.hmr_estimator_forward
    fn.argtypes = ([ctypes.c_int, ptr, ptr, ctypes.POINTER(ptr), ctypes.c_int, ptr, ptr, ptr]
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ptr,
                                           ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    i, f = ctypes.c_int, ctypes.c_float
    stages = {"hmr_estimator_rowwise": [i, i, ptr, ptr, ptr, ptr, ptr, i, i, i, ptr],
              "hmr_estimator_gemm": [i, ptr, ptr, ptr, ptr, ptr, i, i, i, i, i, i, ptr],
              "hmr_estimator_attention": [i, ptr, ptr, i, i, i, i, i, f, ptr],
              "hmr_estimator_head": [i, ptr, ptr, f, ptr, i, i, i, i, ptr]}
    for name, argtypes in stages.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.hmr_estimator_kinds.restype = ctypes.c_int
    if lib.hmr_estimator_kinds() != len(KINDS):
        raise RuntimeError("kernel kinds differ between Python and CUDA")
    return lib


# ---- each kernel alone, on CUDA tensors (the stage checks) ----------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc, kind):
    if rc != 0:
        raise RuntimeError(f"estimator {kind} kernel launch failed: cudaError {rc}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def encode_cuda(x, enc, pos):
    B, F = x.shape
    H = enc.shape[1]
    out = torch.empty(B, F, H, dtype=enc.dtype, device=x.device)
    _raise_on(_estimator_lib().hmr_estimator_rowwise(
        int(enc.dtype == torch.bfloat16), 1, _ptr(x.contiguous()), None, _ptr(enc), _ptr(pos),
        _ptr(out), B * F, F, H, _stream(x)), "rowwise")
    return out


def layer_norm_cuda(h, ln):
    B, F, H = h.shape
    out = torch.empty_like(h)
    _raise_on(_estimator_lib().hmr_estimator_rowwise(
        int(h.dtype == torch.bfloat16), 0, None, _ptr(h.contiguous()), _ptr(ln), None,
        _ptr(out), B * F, F, H, _stream(h)), "rowwise")
    return out


def gemm_cuda(a, w, b, res=None, relu=False):
    N, K = w.shape
    B, Fq = a.shape[:-1]
    out = torch.empty(B, Fq, N, dtype=w.dtype, device=a.device)
    rf = Fq if res is None else res.shape[-2]
    _raise_on(_estimator_lib().hmr_estimator_gemm(
        int(w.dtype == torch.bfloat16), _ptr(a.contiguous()), _ptr(w), _ptr(b),
        _ptr(None if res is None else res.contiguous()), _ptr(out), B * Fq, N, K, int(relu),
        Fq, rf, _stream(a)), "gemm")
    return out


def attention_cuda(qkv, num_heads, scale, n_query=None):
    B, F, H3 = qkv.shape
    Fq = F if n_query is None else n_query
    out = torch.empty(B, Fq, H3 // 3, dtype=qkv.dtype, device=qkv.device)
    _raise_on(_estimator_lib().hmr_estimator_attention(
        int(qkv.dtype == torch.bfloat16), _ptr(qkv.contiguous()), _ptr(out), B, F, Fq,
        H3 // 3, num_heads, scale, _stream(qkv)), "attention")
    return out


def head_cuda(h, w_head, b_out, state_dim):
    B, F, H = h.shape
    out = torch.empty(B, state_dim, dtype=torch.float32, device=h.device)
    _raise_on(_estimator_lib().hmr_estimator_head(
        int(h.dtype == torch.bfloat16), _ptr(h.contiguous()), _ptr(w_head), b_out, _ptr(out),
        B, F, state_dim, H, _stream(h)), "head")
    return out


# each stage's kernel launcher beside its plain version (same arguments)
STAGES = {"encode": (encode_cuda, encode_plain),
          "layer_norm": (layer_norm_cuda, layer_norm_plain),
          "gemm": (gemm_cuda, gemm_plain),
          "attention": (attention_cuda, attention_plain),
          "head": (head_cuda, head_plain)}
