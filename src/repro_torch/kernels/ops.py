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
                          _P]),
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
    "selective_scan": ("selective_scan.cu", "repro_selective_scan",
                       [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _P]),
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
        _libs.update(libs)
        return _libs


def build_log(src: str) -> str:
    """The output of the nvcc run that built `src`'s library (``-Xptxas
    -v``: each kernel's registers, shared memory and spills)."""
    return Path(build()[src]._name).with_suffix(".log").read_text()


_fns: Dict[str, object] = {}


def _fn(name: str):
    """The kernel's C entry point, built and resolved at its first call."""
    fn = _fns.get(name)
    if fn is None:
        src, sym, _ = KERNELS[name]
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


def _forward_only(name: str, *tensors) -> None:
    """Refuse a differentiated call of a wrapper whose kernel has no
    backward: its result would carry no gradient (ROADMAP queue 1)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: no backward kernel; it is reached only by the serving "
            "path (training these paths is ROADMAP queue 1)")


# ------------------------------ decode attention ------------------------------
def decode_attention(q, k_cache, v_cache, slot_positions, q_position):
    """One query token per row against the dense ring cache.  q (B, H, D);
    caches (B, L, KV, D); slot_positions (B, L) int32 (-1 = empty);
    q_position (B,) int32.  Returns (B, H, D) in q.dtype."""
    _forward_only("decode_attention", q, k_cache, v_cache)
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
    fp32; rows past the sum are 0.  Returns (T, N) in x.dtype."""
    _forward_only("gmm", x, w)
    if not x.is_cuda:
        return ref.gmm_ref(x, w, group_sizes)
    T, M = x.shape
    _require(w.dim() == 3 and w.shape[1] == M,
             "gmm: w must be (E, M, N) with M = x.shape[1]")
    E, _, N = w.shape
    for t in (x, w):
        _require(t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "gmm: x and w must be contiguous, 16-byte aligned CUDA "
                 "tensors")
    _require(x.dtype in _DTYPES and w.dtype == x.dtype,
             f"gmm: x and w must share one of {list(_DTYPES)}")
    _require(group_sizes.is_cuda and group_sizes.dtype == torch.int32
             and group_sizes.is_contiguous()
             and tuple(group_sizes.shape) == (E,),
             "gmm: group_sizes must be a contiguous (E,) int32 CUDA tensor")
    _require(M % 8 == 0 and N % 8 == 0 and 1 <= E <= 1024,
             "gmm: M and N must be multiples of 8, E in [1, 1024]")
    out = torch.empty(T, N, dtype=x.dtype, device=x.device)
    err = _fn("gmm")(_DTYPES[x.dtype], _ptr(x), _ptr(w), _ptr(group_sizes),
                     _ptr(out), T, M, N, E, _stream())
    _check("gmm", err)
    gmm.launches += 1
    return out


gmm.launches = 0

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
    its message formatted only when it fails."""
    _forward_only("selective_scan", u, dt, A, B, C, D, h0)
    if not u.is_cuda:
        return ref.selective_scan_ref(u, dt, A, B, C, D, h0, h_out)
    Bz, S, Di = u.shape
    N = A.shape[-1]
    dtype, f32 = u.dtype, torch.float32
    if not (dtype in _DTYPES and B.dtype is dtype and C.dtype is dtype):
        raise ValueError("selective_scan: u, B and C must share one of "
                         f"{list(_DTYPES)}")
    if not (dt.dtype is f32 and dt.is_cuda and dt.shape == u.shape
            and u.is_contiguous() and dt.is_contiguous()):
        raise ValueError("selective_scan: u and dt must be contiguous (Bz, "
                         "S, Di) CUDA tensors, dt float32")
    for name, x, shape in (("A", A, (Di, N)), ("D", D, (Di,)),
                           ("h0", h0, (Bz, Di, N)),
                           ("h_out", h_out, (Bz, Di, N))):
        if x is not None and not (
                x.dtype is f32 and x.is_cuda and x.is_contiguous()
                and x.shape == shape):
            raise ValueError(f"selective_scan: {name} must be a contiguous "
                             f"float32 CUDA tensor of shape {shape}")
    ld = B.stride(0) // S             # row t of batch b at (b * S + t) * ld
    for x in (B, C):
        st = x.stride()
        if not (x.is_cuda and x.shape == (Bz, S, N) and st[0] == S * ld
                and st[2] == 1 and (S == 1 or st[1] == ld)):
            raise ValueError("selective_scan: B and C must be (Bz, S, N) CUDA "
                             "tensors with unit stride along N and one row "
                             "stride")
    if N not in (4, 8, 16, 32):
        raise ValueError(f"selective_scan: state size {N} unsupported (4, 8, "
                         "16 or 32)")
    y = torch.empty(Bz, S, Di, dtype=f32, device=u.device)
    if h_out is None:
        h_out = torch.empty(Bz, Di, N, dtype=f32, device=u.device)
    err = _fn("selective_scan")(
        _DTYPES[dtype], u.data_ptr(), dt.data_ptr(), A.data_ptr(),
        B.data_ptr(), C.data_ptr(), D.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_out.data_ptr(), Bz, S, Di, N, ld, _stream())
    _check("selective_scan", err)
    selective_scan.launches += 1
    return y, h_out


selective_scan.launches = 0

#: every kernel wrapper of the SQL and training paths, by kernel name
WRAPPERS = {"flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "flash_attention_prefix": flash_attention_prefix,
            "decode_attention": decode_attention,
            "decode_attention_paged": decode_attention_paged,
            "decode_attention_paged_quant": decode_attention_paged_quant,
            "constrained_sample": constrained_sample,
            "gmm": gmm,
            "selective_scan": selective_scan}


def reset_launches() -> None:
    for w in WRAPPERS.values():
        w.launches = 0
