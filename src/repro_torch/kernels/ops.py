"""Wrappers around the three Hopper kernels of the dense SQL path.

Each wrapper takes the JAX package's natural shapes (``repro/kernels/ops.py``
signatures): q ``(B, S, H, D)``, caches ``(B, L, KV, D)``.  For tensors on
the CPU it runs the kernel's plain PyTorch version (``kernels/ref.py``); for
CUDA tensors it launches the hand-written kernel (``kernels/csrc/*.cu``) or
raises — there is no fallback.  Each wrapper counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.

The kernels are compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into shared libraries with a plain C interface, loaded with ``ctypes``.  They
are built at first use from the sources in the checkout, all in parallel,
into ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``); a build is keyed by a hash of the sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import ref

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: kernel name → (source file, exported C function, ctypes argument types)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "flash_attention": ("flash_attention.cu", "repro_flash_attention",
                        [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _I, _I, _I, _P]),
    "decode_attention": ("decode_attention.cu", "repro_decode_attention",
                         [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                          _P]),
    "constrained_sample": ("constrained_sample.cu", "repro_constrained_sample",
                           [_I, _P, _P, _P, _P, _I, _I, _F, _P]),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the Hopper kernels "
                           "are built from source at first use")
    return found


def build(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Compile every kernel source that has no up-to-date library yet — one
    nvcc process per source, all started together — and load them.
    Idempotent; returns {kernel name: library}."""
    with _build_lock:
        if len(_libs) == len(KERNELS):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        header = (CSRC / "common.cuh").read_bytes()
        jobs = {}
        for name, (src, _, _) in KERNELS.items():
            digest = hashlib.sha256(header + (CSRC / src).read_bytes())
            lib = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
            if not lib.exists():
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "-o", str(tmp), str(CSRC / src)]
                jobs[name] = (lib, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            else:
                jobs[name] = (lib, None, None)
        failed = []
        for name, (lib, tmp, proc) in jobs.items():
            if proc is None:
                continue
            log, _ = proc.communicate()
            if verbose:
                print(f"[nvcc {name}]\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name, (lib, _, _) in jobs.items():
            handle = ctypes.CDLL(str(lib))
            fn = getattr(handle, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            _libs[name] = handle
        return _libs


def _fn(name: str):
    return getattr(build()[name], KERNELS[name][1])


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_attention_inputs(name, q, k, v, *ints):
    for t in (q, k, v):
        _require(t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{name}: q/k/v must be contiguous, 16-byte aligned CUDA "
                 "tensors")
    _require(q.dtype in _DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
             f"{name}: q/k/v must share one of {list(_DTYPES)}")
    for t in ints:
        _require(t.is_cuda and t.dtype == torch.int32 and t.is_contiguous(),
                 f"{name}: positions must be contiguous int32 CUDA tensors")
    D = q.shape[-1]
    _require(D % 8 == 0 and D <= 256, f"{name}: head_dim {D} unsupported "
             "(multiple of 8, at most 256)")


# ------------------------------ flash attention -------------------------------
def flash_attention(q, k, v, q_positions, kv_positions, *, causal=True,
                    window=0, prefix_len=0):
    """Prefill attention.  q (B, Sq, H, D); k, v (B, Skv, KV, D); positions
    (B, S) int32, -1 = padding.  Returns (B, Sq, H, D) in q.dtype."""
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, q_positions, kv_positions,
                                       causal=causal, window=window,
                                       prefix_len=prefix_len)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    _check_attention_inputs("flash_attention", q, k, v, q_positions,
                            kv_positions)
    _require(H % KV == 0 and k.shape == v.shape == (B, Skv, KV, D)
             and q_positions.shape == (B, Sq)
             and kv_positions.shape == (B, Skv),
             "flash_attention: shape mismatch")
    out = torch.empty_like(q)
    err = _fn("flash_attention")(
        _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(q_positions),
        _ptr(kv_positions), _ptr(out), B, Sq, Skv, H, KV, D,
        1.0 / math.sqrt(D), int(causal), int(window), int(prefix_len),
        _stream())
    _check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ------------------------------ decode attention ------------------------------
def decode_attention(q, k_cache, v_cache, slot_positions, q_position):
    """One query token per row against the dense ring cache.  q (B, H, D);
    caches (B, L, KV, D); slot_positions (B, L) int32 (-1 = empty);
    q_position (B,) int32.  Returns (B, H, D) in q.dtype."""
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k_cache, v_cache, slot_positions,
                                        q_position)
    B, H, D = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    _check_attention_inputs("decode_attention", q, k_cache, v_cache,
                            slot_positions, q_position)
    _require(H % KV == 0 and k_cache.shape == v_cache.shape == (B, L, KV, D)
             and slot_positions.shape == (B, L)
             and q_position.shape == (B,),
             "decode_attention: shape mismatch")
    out = torch.empty_like(q)
    err = _fn("decode_attention")(
        _DTYPES[q.dtype], _ptr(q), _ptr(k_cache), _ptr(v_cache),
        _ptr(slot_positions), _ptr(q_position), _ptr(out), B, H, KV, L, D,
        1.0 / math.sqrt(D), _stream())
    _check("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# --------------------------- constrained sampling -----------------------------
def constrained_sample(logits, mask, noise=None, *, temperature=1.0):
    """argmax(mask ? logits/T + noise : -1e30) per row, lowest index on
    ties; the numpy sampler's arithmetic (see ref.constrained_sample_ref).
    logits (B, V) float32/bfloat16; mask (B, V) int8; noise (B, V) float64
    Gumbel noise or None (greedy).  Returns (B,) int32."""
    if not logits.is_cuda:
        return ref.constrained_sample_ref(logits, mask, noise,
                                          temperature=temperature)
    B, V = logits.shape
    _require(logits.dtype in (torch.float32, torch.bfloat16)
             and logits.is_contiguous(),
             "constrained_sample: logits must be contiguous float32/bfloat16")
    _require(mask.is_cuda and mask.dtype == torch.int8 and mask.is_contiguous()
             and mask.shape == (B, V),
             "constrained_sample: mask must be a contiguous (B, V) int8 "
             "CUDA tensor")
    if noise is not None:
        _require(noise.is_cuda and noise.dtype == torch.float64
                 and noise.is_contiguous() and noise.shape == (B, V),
                 "constrained_sample: noise must be a contiguous (B, V) "
                 "float64 CUDA tensor")
    out = torch.empty(B, dtype=torch.int32, device=logits.device)
    err = _fn("constrained_sample")(
        _DTYPES[logits.dtype], _ptr(logits), _ptr(mask),
        None if noise is None else _ptr(noise), _ptr(out), B, V,
        float(temperature), _stream())
    _check("constrained_sample", err)
    constrained_sample.launches += 1
    return out


constrained_sample.launches = 0

#: every kernel wrapper of the dense path, by kernel name
WRAPPERS = {"flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "constrained_sample": constrained_sample}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0
