"""Wrappers around the Hopper kernels of the SQL and training paths.

Each wrapper takes the JAX package's natural shapes (``repro/kernels/ops.py``
signatures): q ``(B, S, H, D)``, caches ``(B, L, KV, D)``, page pools
``(KV, P, ps, D)`` (without the TPU's lane pad of D), the grouped matmul's
``(T, M) x (E, M, N)``, the selective scan's ``(Bz, S, Di)`` sequences.  For tensors on the
CPU it runs the kernel's plain PyTorch version (``kernels/ref.py``); for
CUDA tensors it launches the hand-written kernel (``kernels/csrc/*.cu``) or
raises — there is no fallback.  Each wrapper counts its kernel launches in a
plain integer attribute, ``<wrapper>.launches``.

The kernels are compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into shared libraries with a plain C interface, one per source file, loaded
with ``ctypes``.  They are built at first use from the sources in the
checkout, all in parallel, into ``build/repro_torch_kernels/`` at the
repository root (listed in ``.gitignore``); a build is keyed by a hash of
the sources.
"""
from __future__ import annotations

import ctypes
import functools
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
                        [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _F, _I, _I, _I, _I, _P]),
    "flash_attention_bwd": ("flash_attention_bwd.cu",
                            "repro_flash_attention_bwd",
                            [_I] + [_P] * 12 + [_I] * 6 + [_F] + [_I] * 3
                            + [_P]),
    "flash_attention_prefix": (
        "flash_attention.cu", "repro_flash_attention_prefix",
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    "decode_attention": ("decode_attention.cu", "repro_decode_attention",
                         [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                          _P, _P, _P]),
    # kernel 2 writing each head's lse (kernel (a)): the same entry point
    "decode_attention_lse": ("decode_attention.cu", "repro_decode_attention",
                             [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _F, _P, _P, _P]),
    # kernel (b): decode attention over a head_dim slice, two launches
    "decode_attention_hd_scores": (
        "decode_attention.cu", "repro_decode_attention_hd_scores",
        [_I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "decode_attention_hd_out": (
        "decode_attention.cu", "repro_decode_attention_hd_out",
        [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]),
    "decode_attention_paged": (
        "decode_attention_paged.cu", "repro_decode_attention_paged",
        [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    "decode_attention_paged_quant": (
        "decode_attention_paged.cu", "repro_decode_attention_paged_quant",
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    "constrained_sample": ("constrained_sample.cu", "repro_constrained_sample",
                           [_I, _P, _P, _P, _P, _I, _I, _F, _P]),
    "gmm": ("gmm.cu", "repro_gmm", [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "gmm_bwd": ("gmm.cu", "repro_gmm_bwd",
                [_I] + [_P] * 6 + [_I] * 4 + [_P]),
    "selective_scan": ("selective_scan.cu", "repro_selective_scan",
                       [_I] + [_P] * 10 + [_I] * 6 + [_P]),
    "selective_scan_bwd": ("selective_scan_bwd.cu", "repro_selective_scan_bwd",
                           [_I] + [_P] * 15 + [_I] * 6 + [_P]),
}
#: the C queries beside the kernels: name → (source, symbol, argument
#: types, result type)
QUERIES = {
    "decode_attention_workspace": ("decode_attention.cu",
                                   "repro_decode_attention_workspace",
                                   [_I] * 7, ctypes.c_longlong),
    "selective_scan_chunks": ("selective_scan.cu",
                              "repro_selective_scan_chunks", [_I] * 4, _I),
    "selective_scan_train_chunks": ("selective_scan.cu",
                                    "repro_selective_scan_train_chunks",
                                    [_I] * 4, _I),
    "selective_scan_bwd_workspace": (
        "selective_scan_bwd.cu", "repro_selective_scan_bwd_workspace",
        [_I] * 5, ctypes.c_longlong),
    "selective_scan_bwd_max_chunk": (
        "selective_scan_bwd.cu", "repro_selective_scan_bwd_max_chunk", [_I],
        _I),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: a layer's int8 page tensors, in the order the kernels take them
_QUANT_KEYS = ("kq", "vq", "kscale", "vscale", "flags")

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
    Idempotent; returns {source file: library}."""
    sources = sorted({src for src, _, _ in KERNELS.values()})
    with _build_lock:
        if len(_libs) == len(sources):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        header = (CSRC / "common.cuh").read_bytes()
        jobs = {}
        for src in sources:
            digest = hashlib.sha256(header + (CSRC / src).read_bytes())
            lib = BUILD_DIR / f"{Path(src).stem}-{digest.hexdigest()[:16]}.so"
            if not lib.exists():
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                       "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "-o", str(tmp), str(CSRC / src)]
                jobs[src] = (lib, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            else:
                jobs[src] = (lib, None, None)
        failed = []
        for src, (lib, tmp, proc) in jobs.items():
            if proc is None:
                continue
            log, _ = proc.communicate()
            if verbose:
                print(f"[nvcc {src}]\n{log}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            else:
                lib.with_suffix(".log").write_text(log)
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        libs = {src: ctypes.CDLL(str(lib)) for src, (lib, _, _) in jobs.items()}
        for src, sym, argtypes in KERNELS.values():
            fn = getattr(libs[src], sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for src, sym, argtypes, restype in QUERIES.values():
            fn = getattr(libs[src], sym)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs.update(libs)
        return _libs


def build_log(src: str) -> str:
    """The output of the nvcc run that built `src`'s library (``-Xptxas
    -v``: each kernel's registers, shared memory and spills)."""
    return Path(build()[src]._name).with_suffix(".log").read_text()


_fns: Dict[str, object] = {}


def _fn(name: str):
    """The kernel's (or query's) C entry point, built and resolved at its
    first call."""
    fn = _fns.get(name)
    if fn is None:
        src, sym = (KERNELS.get(name) or QUERIES[name])[:2]
        fn = _fns[name] = getattr(build()[src], sym)
    return fn


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream() -> int:
    """The handle of PyTorch's current stream on the current device, by the
    raw accessor: building a torch.cuda.Stream object costs the SQL path's
    wrappers several microseconds of host time a call."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


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
                    window=0, prefix_len=0, kv_block=ref.FLASH_KV_BLOCK):
    """Prefill attention.  q (B, Sq, H, D); k, v (B, Skv, KV, D); positions
    (B, S) int32, -1 = padding.  A row with no visible key is the sum of V
    over the Skv keys divided by Skv rounded up to `kv_block` (see
    ref.flash_attention_ref).  Returns (B, Sq, H, D) in q.dtype.

    With grad enabled and q, k or v requiring it (the training path), the
    call is differentiable: the forward keeps each row's log-sum-exp and
    the backward is flash_attention_bwd (on the CPU, the plain versions:
    ref.flash_attention_grad_ref).  Otherwise (the serving path) it is the
    forward alone, with no lse written."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if not q.is_cuda:
            return ref.flash_attention_grad_ref(
                q, k, v, q_positions, kv_positions, causal=causal,
                window=window, prefix_len=prefix_len, kv_block=kv_block)
        return _FlashAttention.apply(q, k, v, q_positions, kv_positions,
                                     causal, window, prefix_len, kv_block)
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, q_positions, kv_positions,
                                       causal=causal, window=window,
                                       prefix_len=prefix_len,
                                       kv_block=kv_block)
    return _flash_forward(q, k, v, q_positions, kv_positions, causal, window,
                          prefix_len, kv_block, None)


def _flash_forward(q, k, v, q_positions, kv_positions, causal, window,
                   prefix_len, kv_block, lse):
    """Launch kernel 1; `lse` (B, Sq, H) float32 receives each row's
    log-sum-exp, or is None (the serving launch, which writes none)."""
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
        _ptr(kv_positions), _ptr(out), None if lse is None else _ptr(lse), B,
        Sq, Skv, H, KV, D, 1.0 / math.sqrt(D), int(causal), int(window),
        int(prefix_len), ref.empty_row_divisor(Skv, kv_block), _stream())
    _check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _flash_forward_lse(q, k, v, q_positions, kv_positions, *, causal,
                       window, prefix_len, kv_block):
    """Kernel 1's training launch: the output and each row's lse."""
    B, Sq, H, _ = q.shape
    lse = torch.empty(B, Sq, H, dtype=torch.float32, device=q.device)
    return _flash_forward(q, k, v, q_positions, kv_positions, causal, window,
                          prefix_len, kv_block, lse), lse


def flash_attention_bwd(q, k, v, q_positions, kv_positions, out, lse, g, *,
                        causal=True, window=0, prefix_len=0):
    """The gradient of flash_attention (ref.flash_attention_bwd_ref, the
    JAX package's ``_flash_bwd``): q, out, g (B, Sq, H, D); k, v (B, Skv,
    KV, D); positions as in flash_attention; lse (B, Sq, H) float32 from
    the forward.  Returns (dq, dk, dv) in q's dtype.  One entry point:
    two launches in bf16 with D % 16 == 0 (dQ, which also computes delta,
    then dK/dV, on wgmma), three otherwise (delta, dK/dV, dQ on the CUDA
    cores); the result is the same to the bit from run to run (no float
    atomics)."""
    if not q.is_cuda:
        return ref.flash_attention_bwd_ref(
            q, k, v, q_positions, kv_positions, out, lse, g, causal=causal,
            window=window, prefix_len=prefix_len)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    _check_attention_inputs("flash_attention_bwd", q, k, v, q_positions,
                            kv_positions)
    out, g = out.contiguous(), g.contiguous()
    for t in (out, g):
        _require(t.is_cuda and t.is_contiguous() and t.dtype == q.dtype
                 and t.shape == q.shape and t.data_ptr() % 16 == 0,
                 "flash_attention_bwd: out and g must be contiguous CUDA "
                 "tensors of q's shape and dtype")
    _require(lse.is_cuda and lse.dtype == torch.float32 and lse.is_contiguous()
             and lse.shape == (B, Sq, H),
             "flash_attention_bwd: lse must be a contiguous (B, Sq, H) "
             "float32 CUDA tensor")
    _require(H % KV == 0 and k.shape == v.shape == (B, Skv, KV, D)
             and q_positions.shape == (B, Sq)
             and kv_positions.shape == (B, Skv),
             "flash_attention_bwd: shape mismatch")
    delta = torch.empty(B, Sq, H, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _fn("flash_attention_bwd")(
        _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(q_positions),
        _ptr(kv_positions), _ptr(out), _ptr(g), _ptr(lse), _ptr(delta),
        _ptr(dq), _ptr(dk), _ptr(dv), B, Sq, Skv, H, KV, D,
        1.0 / math.sqrt(D), int(causal), int(window), int(prefix_len),
        _stream())
    _check("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0

#: kernel 1 with its lse, differentiated by flash_attention_bwd
_FlashAttention = ref.differentiable_attention(_flash_forward_lse,
                                               flash_attention_bwd)


def _differentiated(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _forward_only(name: str, *tensors) -> None:
    """Refuse a differentiated call of a wrapper whose kernel has no
    backward: its result would carry no gradient.  These kernels are
    reached only by the serving path."""
    if _differentiated(*tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel; it is reached only by the serving "
            "path")


# ------------------------------ decode attention ------------------------------
def decode_attention(q, k_cache, v_cache, slot_positions, q_position):
    """One query token per row against the dense ring cache.  q (B, H, D);
    caches (B, L, KV, D); slot_positions (B, L) int32 (-1 = empty);
    q_position (B,) int32.  Returns (B, H, D) in q.dtype."""
    _forward_only("decode_attention", q, k_cache, v_cache)
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k_cache, v_cache, slot_positions,
                                        q_position)
    return _decode(q, k_cache, v_cache, slot_positions, q_position, None)


decode_attention.launches = 0


def _decode(q, k_cache, v_cache, slot_positions, q_position, lse):
    """Launch kernel 2 (`lse` None) or kernel (a) (`lse` (B, H) float32)."""
    name = "decode_attention" if lse is None else "decode_attention_lse"
    B, H, D = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    _check_attention_inputs(name, q, k_cache, v_cache, slot_positions,
                            q_position)
    _require(H % KV == 0 and k_cache.shape == v_cache.shape == (B, L, KV, D)
             and slot_positions.shape == (B, L)
             and q_position.shape == (B,), f"{name}: shape mismatch")
    out = torch.empty_like(q)
    ws = _decode_workspace(q, 0, B, H, KV, L, D)
    err = _fn(name)(
        _DTYPES[q.dtype], _ptr(q), _ptr(k_cache), _ptr(v_cache),
        _ptr(slot_positions), _ptr(q_position), _ptr(out), B, H, KV, L, D,
        1.0 / math.sqrt(D), None if lse is None else _ptr(lse),
        None if ws is None else _ptr(ws), _stream())
    _check(name, err)
    WRAPPERS[name].launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _workspace_floats(dtype: int, hd_out: int, B, H, KV, L, D, device: int):
    n = _fn("decode_attention_workspace")(dtype, hd_out, B, H, KV, L, D)
    if n < 0:
        raise RuntimeError("decode_attention: the launch shape query failed")
    return n


def _decode_workspace(t, hd_out, B, H, KV, L, D):
    """The float32 workspace of kernel 2's launch at these shapes: the
    chunk records of a launch that splits each row over several clusters
    (bf16 with D > 128, where B x KV leaves the card empty), else None."""
    if t.dtype != torch.bfloat16 or D <= 128:
        return None
    n = _workspace_floats(1, hd_out, B, H, KV, L, D, t.device.index or 0)
    return torch.empty(n, dtype=torch.float32, device=t.device) if n else None


def decode_attention_lse(q, k_cache, v_cache, slot_positions, q_position):
    """Kernel (a): kernel 2 that also returns each (row, head)'s
    log-sum-exp of its scaled scores over the valid slots, (B, H) float32,
    -inf where the row has none (its output is then the mean of V over the
    cache's slots, as kernel 2's).  For a cache split over its length: each
    rank attends over its slot range, and ``combine_slot_splits`` merges
    the ranks' (out, lse).  Returns (out, lse)."""
    _forward_only("decode_attention_lse", q, k_cache, v_cache)
    if not q.is_cuda:
        return ref.decode_attention_lse_ref(q, k_cache, v_cache,
                                            slot_positions, q_position)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return _decode(q, k_cache, v_cache, slot_positions, q_position, lse), lse


decode_attention_lse.launches = 0


def decode_attention_hd_scores(q, k_cache, scale):
    """Kernel (b), launch 1: q (B, H, D) and k_cache (B, L, KV, D) hold a
    rank's D-column slice of head_dim; returns the partial scores scale *
    q . k over those columns, (B, H, L) float32, which the caller sums over
    the ranks before ``decode_attention_hd_out``."""
    _forward_only("decode_attention_hd_scores", q, k_cache)
    if not q.is_cuda:
        return ref.decode_attention_hd_scores_ref(q, k_cache, scale)
    B, H, D = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    _check_attention_inputs("decode_attention_hd_scores", q, k_cache, k_cache)
    _require(H % KV == 0 and k_cache.shape == (B, L, KV, D),
             "decode_attention_hd_scores: shape mismatch")
    scores = torch.empty(B, H, L, dtype=torch.float32, device=q.device)
    err = _fn("decode_attention_hd_scores")(
        _DTYPES[q.dtype], _ptr(q), _ptr(k_cache), _ptr(scores), B, H, KV, L,
        D, float(scale), _stream())
    _check("decode_attention_hd_scores", err)
    decode_attention_hd_scores.launches += 1
    return scores


decode_attention_hd_scores.launches = 0


def decode_attention_hd_out(scores, v_cache, slot_positions, q_position):
    """Kernel (b), launch 2: the softmax of the summed scores (B, H, L)
    float32 over the slots with 0 <= slot position <= q_position (every
    slot alike where none is valid), times the rank's D columns of
    v_cache (B, L, KV, D), and each (row, head)'s log-sum-exp of its
    scores over the valid slots, (B, H) float32, -inf where the row has
    none.  For a cache split over its slots and head_dim each rank's
    softmax covers its slot range, and the ranks' (out, lse) are merged
    over the slot axes (``models.model._combine_slot_splits``).  Returns
    (out (B, H, D) in v_cache's dtype, lse)."""
    _forward_only("decode_attention_hd_out", v_cache)
    if not v_cache.is_cuda:
        return ref.decode_attention_hd_out_ref(scores, v_cache,
                                               slot_positions, q_position)
    B, H, L = scores.shape
    KV, D = v_cache.shape[2], v_cache.shape[3]
    _check_attention_inputs("decode_attention_hd_out", v_cache, v_cache,
                            v_cache, slot_positions, q_position)
    _require(scores.is_cuda and scores.dtype == torch.float32
             and scores.is_contiguous() and H % KV == 0
             and v_cache.shape == (B, L, KV, D)
             and slot_positions.shape == (B, L)
             and q_position.shape == (B,),
             "decode_attention_hd_out: shape mismatch")
    out = torch.empty(B, H, D, dtype=v_cache.dtype, device=v_cache.device)
    lse = torch.empty(B, H, dtype=torch.float32, device=v_cache.device)
    ws = _decode_workspace(v_cache, 1, B, H, KV, L, D)
    err = _fn("decode_attention_hd_out")(
        _DTYPES[v_cache.dtype], _ptr(scores), _ptr(v_cache),
        _ptr(slot_positions), _ptr(q_position), _ptr(out), _ptr(lse), B, H,
        KV, L, D, None if ws is None else _ptr(ws), _stream())
    _check("decode_attention_hd_out", err)
    decode_attention_hd_out.launches += 1
    return out, lse


decode_attention_hd_out.launches = 0


# --------------------------- paged decode attention ---------------------------
def _check_pool(name, k_pool, v_pool, D, quant):
    """Pools (KV, P, ps, D) of q's dtype, contiguous, on the card, and the
    int8 shadows, scales and flags when `quant` is given."""
    for t in (k_pool, v_pool):
        _require(t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{name}: pools must be contiguous, 16-byte aligned CUDA "
                 "tensors")
    KV, P, ps, Dk = k_pool.shape
    _require(k_pool.shape == v_pool.shape and Dk == D and 0 < ps <= 128,
             f"{name}: pools must be (KV, P, ps <= 128, D)")
    if quant is None:
        return
    _require(D % 16 == 0, f"{name}: int8 pages need head_dim % 16 == 0")
    for kk, dt, shape in (("kq", torch.int8, k_pool.shape),
                          ("vq", torch.int8, k_pool.shape),
                          ("kscale", torch.float32, (KV, P)),
                          ("vscale", torch.float32, (KV, P)),
                          ("flags", torch.int8, (P,))):
        t = quant[kk]
        _require(t.is_cuda and t.dtype == dt and t.is_contiguous()
                 and tuple(t.shape) == tuple(shape)
                 and t.data_ptr() % 16 == 0,
                 f"{name}: quant[{kk!r}] must be a contiguous {dt} CUDA "
                 f"tensor of shape {tuple(shape)}")


def _paged_decode(name, q, k_pool, v_pool, block_tables, q_position, quant):
    B, H, D = q.shape
    _check_attention_inputs(name, q, k_pool, v_pool, block_tables,
                            q_position)
    _check_pool(name, k_pool, v_pool, D, quant)
    KV, P, ps, _ = k_pool.shape
    NB = block_tables.shape[1]
    _require(H % KV == 0 and block_tables.shape == (B, NB)
             and q_position.shape == (B,), f"{name}: shape mismatch")
    out = torch.empty_like(q)
    qargs = () if quant is None else tuple(_ptr(quant[kk])
                                           for kk in _QUANT_KEYS)
    err = _fn(name)(
        _DTYPES[q.dtype], _ptr(q), _ptr(k_pool), _ptr(v_pool), *qargs,
        _ptr(block_tables), _ptr(q_position), _ptr(out), B, H, KV, P, ps, NB,
        D, 1.0 / math.sqrt(D), _stream())
    _check(name, err)
    return out


def decode_attention_paged(q, k_pool, v_pool, block_tables, q_position):
    """One query token per row against the global page pool.  q (B, H, D);
    pools (KV, P, ps, D); block_tables (B, NB) int32 page ids (-1 = none);
    q_position (B,) int32.  Token t of block j is valid when the block has
    a page and j * ps + t <= qpos.  Returns (B, H, D) in q.dtype."""
    _forward_only("decode_attention_paged", q, k_pool, v_pool)
    if not q.is_cuda:
        return ref.decode_attention_paged_ref(q, k_pool, v_pool, block_tables,
                                              q_position)
    out = _paged_decode("decode_attention_paged", q, k_pool, v_pool,
                        block_tables, q_position, None)
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0


def decode_attention_paged_quant(q, k_pool, v_pool, block_tables, q_position,
                                 quant):
    """decode_attention_paged over a pool with int8 frozen pages: quant
    holds the layer's kq/vq (KV, P, ps, D) int8, kscale/vscale (KV, P)
    float32 and flags (P,) int8; a page with flags > 0 is read as
    int8 * scale rounded to the pool dtype."""
    _forward_only("decode_attention_paged_quant", q, k_pool, v_pool)
    if not q.is_cuda:
        return ref.decode_attention_paged_ref(q, k_pool, v_pool,
                                              block_tables, q_position, quant)
    out = _paged_decode("decode_attention_paged_quant", q, k_pool, v_pool,
                        block_tables, q_position, quant)
    decode_attention_paged_quant.launches += 1
    return out


decode_attention_paged_quant.launches = 0


# ------------------------ shared-prefix prefill attention ---------------------
def flash_attention_prefix(q, k, v, positions, k_pool, v_pool, prefix_table,
                           prefix_len: int, quant=None):
    """Paged prefill attention (``layers.prefix_suffix_attention``): the
    suffix's q (B, S, H, D), k/v (B, S, KV, D) and positions (B, S) (-1 =
    pad), plus a shared prefix read in place from pool pages prefix_table
    (npre,) int32, of which the first prefix_len tokens are visible to every
    non-pad query.  quant as in decode_attention_paged_quant.  Returns
    (B, S, H, D) in q.dtype; a pad row is the mean of V over the table's
    npre * ps prefix slots and the S suffix keys, as in the reference."""
    _forward_only("flash_attention_prefix", q, k, v, k_pool, v_pool)
    if not q.is_cuda:
        return ref.flash_attention_prefix_ref(q, k, v, positions, k_pool,
                                              v_pool, prefix_table,
                                              prefix_len, quant)
    B, S, H, D = q.shape
    KV = k.shape[2]
    _check_attention_inputs("flash_attention_prefix", q, k, v, positions,
                            prefix_table)
    _check_pool("flash_attention_prefix", k_pool, v_pool, D, quant)
    KVp, P, ps, _ = k_pool.shape
    npre = prefix_table.shape[0]
    _require(H % KV == 0 and KVp == KV and k.shape == v.shape == (B, S, KV, D)
             and positions.shape == (B, S) and prefix_table.dim() == 1
             and 0 <= prefix_len <= npre * ps,
             "flash_attention_prefix: shape mismatch")
    qargs = (None,) * 5 if quant is None else tuple(_ptr(quant[kk])
                                                    for kk in _QUANT_KEYS)
    out = torch.empty_like(q)
    err = _fn("flash_attention_prefix")(
        _DTYPES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(positions),
        _ptr(k_pool), _ptr(v_pool), *qargs,
        _ptr(prefix_table), _ptr(out), B, S, H, KV, D, P, ps, npre,
        int(prefix_len), 1.0 / math.sqrt(D), _stream())
    _check("flash_attention_prefix", err)
    flash_attention_prefix.launches += 1
    return out


flash_attention_prefix.launches = 0


# --------------------------- constrained sampling -----------------------------
def constrained_sample(logits, mask, noise=None, *, temperature=1.0):
    """argmax(mask ? logits/T + noise : -1e30) per row, lowest index on
    ties; the numpy sampler's arithmetic (see ref.constrained_sample_ref).
    logits (B, V) float32/bfloat16; mask (B, V) int8; noise (B, V) float64
    Gumbel noise or None (greedy).  Returns (B,) int32."""
    _forward_only("constrained_sample", logits)
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


# ------------------------------- grouped matmul -------------------------------
def gmm(x, w, group_sizes):
    """The MoE expert products: x (T, M) rows sorted by expert, w (E, M, N),
    group_sizes (E,) int32 with sum <= T (read on the device: no host
    sync).  Rows [start_e, start_e + gs_e) of x times w[e], accumulated in
    fp32; rows past the sum are 0.  Returns (T, N) in x.dtype.

    With grad enabled and x or w requiring it (the training path), the call
    is differentiable by gmm_bwd (on the CPU, the plain pair:
    ref.gmm_grad_ref)."""
    if _differentiated(x, w):
        if not x.is_cuda:
            return ref.gmm_grad_ref(x, w, group_sizes)
        return _Gmm.apply(x, w, group_sizes)
    if not x.is_cuda:
        return ref.gmm_ref(x, w, group_sizes)
    return _gmm_forward(x, w, group_sizes)


def _check_gmm(name, x, w, group_sizes):
    T, M = x.shape
    _require(w.dim() == 3 and w.shape[1] == M,
             f"{name}: w must be (E, M, N) with M = x.shape[1]")
    E, _, N = w.shape
    for t in (x, w):
        _require(t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0,
                 f"{name}: x and w must be contiguous, 16-byte aligned CUDA "
                 "tensors")
    _require(x.dtype in _DTYPES and w.dtype == x.dtype,
             f"{name}: x and w must share one of {list(_DTYPES)}")
    _require(group_sizes.is_cuda and group_sizes.dtype == torch.int32
             and group_sizes.is_contiguous()
             and tuple(group_sizes.shape) == (E,),
             f"{name}: group_sizes must be a contiguous (E,) int32 CUDA "
             "tensor")
    _require(M % 8 == 0 and N % 8 == 0 and 1 <= E <= 1024,
             f"{name}: M and N must be multiples of 8, E in [1, 1024]")
    return T, M, N, E


def _gmm_forward(x, w, group_sizes):
    """Launch kernel 6."""
    T, M, N, E = _check_gmm("gmm", x, w, group_sizes)
    out = torch.empty(T, N, dtype=x.dtype, device=x.device)
    err = _fn("gmm")(_DTYPES[x.dtype], _ptr(x), _ptr(w), _ptr(group_sizes),
                     _ptr(out), T, M, N, E, _stream())
    _check("gmm", err)
    gmm.launches += 1
    return out


gmm.launches = 0


def gmm_bwd(x, w, group_sizes, dy):
    """The gradient of gmm (ref.gmm_bwd_ref) for dy (T, N) of x's dtype:
    dx (T, M), rows past sum(group_sizes) 0, and dw (E, M, N), dw[e] =
    x_e^T dy_e over expert e's rows (0 for an empty expert).  Two launches,
    both reading w and x in place (no transposed copies) with no float
    atomics -- the same bits from call to call: in bf16 each on wgmma, one
    owner block a 128 x 256 tile (float32: on the CUDA cores)."""
    if not x.is_cuda:
        return ref.gmm_bwd_ref(x, w, group_sizes, dy)
    T, M, N, E = _check_gmm("gmm_bwd", x, w, group_sizes)
    dy = dy.contiguous()
    _require(dy.is_cuda and dy.dtype == x.dtype and dy.shape == (T, N)
             and dy.data_ptr() % 16 == 0,
             "gmm_bwd: dy must be a (T, N) CUDA tensor of x's dtype")
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    err = _fn("gmm_bwd")(_DTYPES[x.dtype], _ptr(x), _ptr(w),
                         _ptr(group_sizes), _ptr(dy), _ptr(dx), _ptr(dw), T,
                         M, N, E, _stream())
    _check("gmm_bwd", err)
    gmm_bwd.launches += 1
    return dx, dw


gmm_bwd.launches = 0

#: kernel 6 differentiated by gmm_bwd
_Gmm = ref.differentiable_gmm(_gmm_forward, gmm_bwd)

# ------------------------------- selective scan -------------------------------
def selective_scan(u, dt, A, B, C, D, h0=None, h_out=None):
    """The Mamba-1 selective scan (ref.selective_scan_ref): u (Bz, S, Di)
    float32/bfloat16; dt (Bz, S, Di) float32; A (Di, N) float32; B, C (Bz,
    S, N) of u's dtype, contiguous along N and over (batch, time) with one
    row stride (slices of one (Bz, S, R + 2N) projection are taken as they
    are); D (Di,) float32; h0 (Bz, Di, N) float32 or None (zeros).  The
    final state is written to `h_out` (Bz, Di, N) float32, which may be h0,
    or to a new tensor.  Returns (y (Bz, S, Di) float32, the final
    state).

    The SQL path calls it once per mixer layer and decode tick, so its
    checks are written for host time: each condition is tested in place and
    its message formatted only when it fails.

    With grad enabled and u, dt, A, B, C or D requiring it (the training
    path), the call is differentiable: the forward also writes the state
    entering each of its time chunks, and the backward is
    selective_scan_bwd (on the CPU, the plain pair:
    ref.selective_scan_grad_ref).  Then h0 must not require grad and h_out
    must be None; the final state carries no gradient."""
    if _differentiated(u, dt, A, B, C, D):
        if not u.is_cuda:
            return ref.selective_scan_grad_ref(u, dt, A, B, C, D, h0, h_out)
        if h_out is not None or (h0 is not None and h0.requires_grad):
            raise ValueError("selective_scan: a differentiated scan takes no "
                             "h_out and no h0 that requires grad")
        return _Scan.apply(u, dt, A, B, C, D, h0)
    if not u.is_cuda:
        return ref.selective_scan_ref(u, dt, A, B, C, D, h0, h_out)
    return _scan_forward(u, dt, A, B, C, D, h0, h_out, False)[:2]


def _check_scan(name, u, dt, A, B, C, D, h0=None, h_out=None):
    """The scan's input checks; returns the B/C row stride."""
    Bz, S, Di = u.shape
    N = A.shape[-1]
    dtype, f32 = u.dtype, torch.float32
    if not (dtype in _DTYPES and B.dtype is dtype and C.dtype is dtype):
        raise ValueError(f"{name}: u, B and C must share one of "
                         f"{list(_DTYPES)}")
    if not (dt.dtype is f32 and dt.is_cuda and dt.shape == u.shape
            and u.is_contiguous() and dt.is_contiguous()):
        raise ValueError(f"{name}: u and dt must be contiguous (Bz, S, Di) "
                         "CUDA tensors, dt float32")
    for what, x, shape in (("A", A, (Di, N)), ("D", D, (Di,)),
                           ("h0", h0, (Bz, Di, N)),
                           ("h_out", h_out, (Bz, Di, N))):
        if x is not None and not (
                x.dtype is f32 and x.is_cuda and x.is_contiguous()
                and x.shape == shape):
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"float32 CUDA tensor of shape {shape}")
    ld = B.stride(0) // S             # row t of batch b at (b * S + t) * ld
    for x in (B, C):
        st = x.stride()
        if not (x.is_cuda and x.shape == (Bz, S, N) and st[0] == S * ld
                and st[2] == 1 and (S == 1 or st[1] == ld)):
            raise ValueError(f"{name}: B and C must be (Bz, S, N) CUDA "
                             "tensors with unit stride along N and one row "
                             "stride")
    if N not in (4, 8, 16, 32):
        raise ValueError(f"{name}: state size {N} unsupported (4, 8, 16 or "
                         "32)")
    return ld


def _scan_forward(u, dt, A, B, C, D, h0, h_out, with_carries: bool):
    """Launch kernel 7; `with_carries` (the training launch) also writes
    the state entering each of the backward's time chunks (~64 steps:
    repro_selective_scan_train_chunks).  Returns (y, the final state,
    carries (Bz, J, Di, N) float32 or None)."""
    ld = _check_scan("selective_scan", u, dt, A, B, C, D, h0, h_out)
    Bz, S, Di = u.shape
    N = A.shape[-1]
    y = torch.empty(Bz, S, Di, dtype=torch.float32, device=u.device)
    if h_out is None:
        h_out = torch.empty(Bz, Di, N, dtype=torch.float32, device=u.device)
    chunks, carries = 0, None
    if with_carries:
        chunks = _fn("selective_scan_train_chunks")(Bz, S, Di, N)
        carries = torch.empty(Bz, chunks, Di, N, dtype=torch.float32,
                              device=u.device)
    err = _fn("selective_scan")(
        _DTYPES[u.dtype], u.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), D.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_out.data_ptr(), None if carries is None else carries.data_ptr(), Bz, S,
        Di, N, ld, chunks, _stream())
    _check("selective_scan", err)
    selective_scan.launches += 1
    return y, h_out, carries


selective_scan.launches = 0


def selective_scan_bwd(u, dt, A, B, C, D, carries, dy):
    """The gradient of the selective scan's y (ref.selective_scan_bwd_ref)
    for dy (Bz, S, Di) float32, from the training forward's carries (Bz,
    J, Di, N) float32 (the state entering each of J chunks of ceil(S / J)
    steps; on the card at most repro_selective_scan_bwd_max_chunk(N) steps,
    whose B/C rows the kernels stage in shared memory):
    (du, ddt, dA, dB, dC, dD) in the dtypes of u, dt, A, B, C, D,
    dB and dC contiguous.  Four launches (each chunk's forward sweep, the
    adjoints' combine across chunks, each chunk's reverse steps, then
    fixed-order sums of the partials; no atomics: the same bits from call
    to call)."""
    if not u.is_cuda:
        return ref.selective_scan_bwd_ref(u, dt, A, B, C, D, carries, dy)
    ld = _check_scan("selective_scan_bwd", u, dt, A, B, C, D)
    Bz, S, Di = u.shape
    N = A.shape[-1]
    dy = dy.contiguous()
    _require(dy.is_cuda and dy.dtype == torch.float32 and dy.shape == u.shape,
             "selective_scan_bwd: dy must be a (Bz, S, Di) float32 CUDA "
             "tensor")
    _require(carries.is_cuda and carries.dtype == torch.float32
             and carries.is_contiguous() and carries.dim() == 4
             and carries.shape[0] == Bz and carries.shape[2:] == (Di, N)
             and carries.shape[1] >= 1,
             "selective_scan_bwd: carries must be a contiguous (Bz, T, Di, "
             "N) float32 CUDA tensor")
    Tf = carries.shape[1]
    most = _fn("selective_scan_bwd_max_chunk")(N)
    _require(-(-S // Tf) <= most,
             f"selective_scan_bwd: carries of {Tf} chunks make chunks of "
             f"{-(-S // Tf)} steps; the kernels stage a chunk's B/C rows in "
             f"shared memory and take at most {most} steps at N {N}: write "
             f"the carries at {-(-S // max(most, 1))} chunks or more "
             "(selective_scan_train_chunks)")
    ws = torch.empty(_fn("selective_scan_bwd_workspace")(Bz, S, Di, N, Tf),
                     dtype=torch.uint8, device=u.device)
    du = torch.empty_like(u)
    ddt = torch.empty_like(dt)
    dA = torch.empty_like(A)
    dB = torch.empty(Bz, S, N, dtype=B.dtype, device=u.device)
    dC = torch.empty(Bz, S, N, dtype=C.dtype, device=u.device)
    dD = torch.empty_like(D)
    err = _fn("selective_scan_bwd")(
        _DTYPES[u.dtype], u.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), D.data_ptr(), carries.data_ptr(),
        dy.data_ptr(), du.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dD.data_ptr(), ws.data_ptr(), Bz, S,
        Di, N, ld, Tf, _stream())
    _check("selective_scan_bwd", err)
    selective_scan_bwd.launches += 1
    return du, ddt, dA, dB, dC, dD


selective_scan_bwd.launches = 0

#: kernel 7's training launch (with its carries), differentiated by
#: selective_scan_bwd
_Scan = ref.differentiable_scan(
    lambda *a: _scan_forward(*a, None, True), selective_scan_bwd)

#: every kernel wrapper of the SQL and training paths, by kernel name
WRAPPERS = {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "flash_attention_prefix": flash_attention_prefix,
            "decode_attention": decode_attention,
            "decode_attention_lse": decode_attention_lse,
            "decode_attention_hd_scores": decode_attention_hd_scores,
            "decode_attention_hd_out": decode_attention_hd_out,
            "decode_attention_paged": decode_attention_paged,
            "decode_attention_paged_quant": decode_attention_paged_quant,
            "constrained_sample": constrained_sample,
            "gmm": gmm,
            "gmm_bwd": gmm_bwd,
            "selective_scan": selective_scan,
            "selective_scan_bwd": selective_scan_bwd}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0
