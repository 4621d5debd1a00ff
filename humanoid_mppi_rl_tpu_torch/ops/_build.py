"""Build the CUDA kernels with nvcc and load them with ctypes.

One `nvcc -gencode arch=compute_90a,code=sm_90a -shared` per source in
csrc/, into humanoid_mppi_rl_tpu_torch/_build/, with a plain C interface:
no PyTorch headers, so a build takes seconds, not minutes. A build is keyed
by a hash of its source, the headers it includes and the flags, and is
redone only when they change. Nothing is built at import: the first caller builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# each source in csrc/ with the headers of csrc/ it includes
SOURCES = {"rollout_kernel.cu": ("rollout_body.cuh",),
           "rollout_profile.cu": ("rollout_kernel.cu", "rollout_body.cuh"),
           "estimator_kernel.cu": ()}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for name in (source,) + SOURCES[source]:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(source: str) -> dict:
    """Compile csrc/<source> into a shared library unless an identical
    build exists. Returns {"path", "log" (nvcc/ptxas output), "seconds",
    "cached"}."""
    stem = Path(source).stem
    out = BUILD_DIR / f"lib{stem}_{_digest(source)}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and log_path.exists():
        return {"path": out, "log": log_path.read_text(), "seconds": 0.0,
                "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return {"path": out, "log": log, "seconds": seconds, "cached": False}


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """The built library of csrc/<source>, loaded once per process."""
    return ctypes.CDLL(str(build(source)["path"]))
