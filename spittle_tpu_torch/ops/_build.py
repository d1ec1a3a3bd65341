"""Build and load the port's CUDA kernels (spittle_tpu_torch/csrc/*.cu).

The sources are compiled on first use with nvcc for sm_90a into ONE
shared library with a plain C interface, loaded with ctypes. No PyTorch
headers are involved, so a build takes seconds: every .cu compiles in its
own nvcc process, all started together, then one link.

- The library lands in build/spittle_tpu_torch/ at the root of the
  checkout (ignored by git), named by a hash of the sources and flags, so
  an edited source rebuilds and an unchanged one loads the cached .so.
- Never --use_fast_math: the W8A8 and int8-attention kernels' true
  divisions and rintf round-half-even must match the reference's
  quantization byte for byte.
- Every C entry returns cudaGetLastError(); `check` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "spittle_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry -> argtypes (pointers and the stream as c_void_p).
SIGNATURES = {
    "spt_fullkv_attention": [_P, _P, _P, _P] + [_I] * 6 + [_L] * 12 + [_P],
    "spt_fullkv_attention_lse": [_P] * 5 + [_I] * 6 + [_L] * 12 + [_P],
    "spt_flash_attention": [_P, _P, _P, _P] + [_I] * 6 + [_L] * 12 + [_P],
    "spt_fullkv_attention_bwd": [_P] * 10 + [_I] * 6 + [_L] * 24 + [_P],
    "spt_fullkv_attention_packed": [_P] * 4 + [_I] * 6 + [_P],
    "spt_fullkv_attention_packed_pair": [_P] * 4 + [_I] * 6 + [_P],
    "spt_fullkv_attention_pipe": [_P] * 4 + [_I] * 6 + [_L] * 12 + [_P],
    "spt_fullkv_q8_quantize": [_P, _L, _L, _L] + [_I] * 4 + [_P, _P, _I, _P],
    "spt_fullkv_attention_q8": [_P] * 7 + [_I] * 9 + [_L] * 3 + [_P],
    "spt_w8a8_quantize_rows": [_P, _P, _P, _I, _I, _I, _P],
    "spt_w8a8_gemm": [_P] * 6 + [_I] * 8 + [_F, _P],
    "spt_decode_cross_attention": [_P] * 5 + [_I] * 7 + [_L] * 7 + [_P],
    "spt_decode_cross_attention_q8": [_P] * 7 + [_I] * 7 + [_L] * 7 + [_P],
    "spt_decode_cross_attention_q4": [_P] * 7 + [_I] * 7 + [_L] * 7 + [_P],
    "spt_decode_cross_attention_w8a8": [_P] * 6 + [_I] * 12 + [_L] * 9 + [_P],
    "spt_w8a8_smem_bytes": [_I] * 6,
    "spt_cache_col_write": [_P, _P, _P, _L, _I, _P],
    "spt_cache_col_write_rows": [_P, _P, _P, _L, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process (None: cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    cus, _ = _sources()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        errors = []
        for cmd, _obj, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"$ {' '.join(cmd)}\n{out}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / target.name
        link = [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in procs),
                "-o", str(tmp_so)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, target)  # atomic: a reader never sees half a file


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libspittle_kernels_{source_hash()}.so"
        if not target.exists():
            t0 = time.perf_counter()
            _build(target)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
