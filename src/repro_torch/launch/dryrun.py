"""Dry run of every (arch x shape) cell on the production meshes, from the
sharding rules alone (port of what has a torch meaning in
``repro/launch/dryrun.py``): nothing is allocated and no rank runs.

For every runnable cell of ``configs.cells()`` on the single-pod (16 x 16)
and multi-pod (2 x 16 x 16) mesh:
  * ``bytes_per_device``: a training cell's train state (fp32 master
    weights and the two fp32 AdamW moments, laid out by
    ``steps.train_state_pspecs``), a serving cell's weights in the port's
    serving dtypes (``params._dtype``: the compute dtype, fp32 where the
    model reads fp32) plus its decode cache (decode and prefill cells of
    models that decode), each leaf's local shard as ``mesh.local_shape``
    gives it, in the layout of the serving variant (JAX's flags): a
    prefill's weights by ``param_pspecs(fsdp=not --no-fsdp)`` or, with
    ``--seq-parallel``, ``param_pspecs_zero3``, its cache in the hd
    layout; a decode's by ``param_pspecs`` in the attention mode that
    ``--cache-shard`` picks (``steps.decode_attn_mode``), resident with
    ``--resident-weights``, its cache by ``cache_pspecs(shard_mode=
    --cache-shard)`` with ``row_idx`` under ``--per-row-write``.
    ``--serve-bf16`` (JAX: bf16 weights in place of fp32) and
    ``--banded`` change no byte here: the port serves its weights in the
    compute dtype already, and the band is a kernel's choice;
  * ``model_flops``: 6 N D (train) or 2 N D (inference), N the active
    parameters (the JAX dry-run's definition, copied);
  * for a training cell, ``state_and_grad_bytes`` (16 bytes a parameter:
    the master weight, two moments and the fp32 gradient) and
    ``min_h100s``, the least number of 80 GB cards that hold them: a lower
    bound that counts no activation, no workspace and no allocator slack.

The constants are an NVIDIA H100 SXM's (data sheet: 80 GB of HBM3 at 3.35
TB/s, 989 TFLOP/s dense bf16), not measurements.  The collective bytes of
a real step come from ``dist.Mesh.bytes``, read after a step on whatever
mesh ran it (``chip_smoke.py``'s dist phase).

Not applicable to the port, so not ported: the XLA lowering and compile of
each cell, ``cost_analysis`` / ``memory_analysis``, the HLO collective
parsing, and the L in {2, 4} cost-calibration compiles (the port has no
compiler that lowers a whole step).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--mesh both]
        [--arch A --shape S] [--cache-shard lc --per-row-write ...]
"""
from __future__ import annotations

import argparse
from typing import Iterable, List

import numpy as np

import repro_torch.configs as C
from repro_torch.launch import mesh as MS
from repro_torch.launch import steps as ST
from repro_torch.models import model as MDL
from repro_torch.models import params as PRM
from repro_torch.models.config import SHAPES_BY_NAME
from repro_torch.training import optim as OPT

#: NVIDIA H100 SXM (data sheet), per card
H100_HBM_BYTES = 80 * 10 ** 9
H100_HBM_BW = 3.35e12            # B/s
H100_PEAK_BF16 = 989e12          # FLOP/s, dense tensor core


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch       # decode: 1 token/sequence


def _nbytes(spec, pspec, mesh) -> int:
    shape, dtype = spec
    return int(np.prod(MS.local_shape(shape, pspec, mesh))) * dtype.itemsize


#: JAX's serving variant flags (``repro/launch/dryrun.py``) and defaults
VARIANT = dict(cache_shard="hd", per_row_write=False, resident=False,
               seq_parallel=False, no_fsdp=False, serve_bf16=False,
               banded=False)


def serving_pspecs(cfg, shape, mesh, variant=None) -> tuple:
    """(weight specs, cache specs or None, the cache's (shape, dtype)
    specs) of a serving cell under `variant` (``VARIANT``'s keys), as the
    step builders lay them out."""
    v = dict(VARIANT, **(variant or {}))
    prw = shape.kind == "decode" and v["per_row_write"]
    if shape.kind == "prefill":
        pspecs = MS.param_pspecs_zero3(cfg, mesh) if v["seq_parallel"] \
            else MS.param_pspecs(cfg, mesh, fsdp=not v["no_fsdp"])
        mode = "hd"
    else:
        mode = v["cache_shard"]
        pspecs = MS.param_pspecs(
            cfg, mesh, fsdp=not v["resident"],
            attn_mode=ST.decode_attn_mode(cfg, mode), resident=v["resident"])
    if not cfg.supports_decode:
        return pspecs, None, None
    cache = MDL.cache_specs(cfg, shape.global_batch, shape.seq_len,
                            include_row_idx=prw)
    return pspecs, MS.cache_pspecs(cfg, mesh, cache, shard_mode=mode), cache


def serving_leaves(cfg, shape, mesh, variant=None) -> list:
    """[((shape, dtype), spec)] of a serving cell's weights and cache."""
    pspecs, cspecs, cache = serving_pspecs(cfg, shape, mesh, variant)
    masters = PRM.param_specs(cfg)
    specs = {k: (v[0], PRM._dtype(cfg, k)) for k, v in masters.items()
             if k != "layers"}
    specs["layers"] = {k: (s, PRM._dtype(cfg, k))
                       for k, (s, _) in masters["layers"].items()}
    out = list(zip(OPT.leaves(specs), OPT.leaves(pspecs)))
    if cspecs is not None:
        out += [(cache[k], cspecs[k]) for k in sorted(cache)]
    return out


def cell(arch: str, shape_name: str, mesh, variant=None) -> dict:
    cfg = C.get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    rec = {"arch": arch, "shape": shape_name, "kind": shape.kind,
           "mesh": dict(mesh.shape),
           "devices": int(np.prod(list(mesh.shape.values()))),
           "model_flops": model_flops(cfg, shape)}
    if shape.kind == "train":
        state = ST.train_state_specs(cfg)
        specs = ST.train_state_pspecs(cfg, mesh)
        leaves = [(s, p) for s, p in zip(OPT.leaves(state),
                                         OPT.leaves(specs)) if s is not int]
        rec["bytes_per_device"] = sum(_nbytes(s, p, mesh) for s, p in leaves)
        total = sum(int(np.prod(s[0])) * (s[1].itemsize + 12)
                    for s in OPT.leaves(state["params"]))
        rec["state_and_grad_bytes"] = total
        rec["min_h100s"] = -(-total // H100_HBM_BYTES)
    else:
        rec["bytes_per_device"] = sum(_nbytes(s, p, mesh) for s, p in
                                      serving_leaves(cfg, shape, mesh,
                                                     variant))
        if variant:
            rec["variant"] = dict(VARIANT, **variant)
    return rec


def sweep(mesh_kinds: Iterable[str] = ("single", "multi"), *, arch=None,
          shape=None, variant=None) -> List[dict]:
    """Every runnable cell (or those of `arch` / `shape`) on each mesh;
    `variant` lays out the serving cells."""
    out = []
    for kind in mesh_kinds:
        mesh = MS.make_production_mesh(multi_pod=kind == "multi")
        for a, shp, _, _ in C.cells():
            if arch not in (None, a) or shape not in (None, shp.name):
                continue
            out.append(dict(cell(a, shp.name, mesh, variant),
                            mesh_kind=kind))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    # JAX's serving variant flags
    ap.add_argument("--banded", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--cache-shard", default="hd",
                    choices=["hd", "lc", "kv", "none"])
    ap.add_argument("--per-row-write", action="store_true")
    ap.add_argument("--serve-bf16", action="store_true")
    ap.add_argument("--resident-weights", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    args = ap.parse_args(argv)
    kinds = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    variant = dict(banded=args.banded, seq_parallel=args.seq_parallel,
                   cache_shard=args.cache_shard,
                   per_row_write=args.per_row_write,
                   serve_bf16=args.serve_bf16,
                   resident=args.resident_weights, no_fsdp=args.no_fsdp)
    print(f"per-device bytes from the sharding rules; constants: NVIDIA "
          f"H100 SXM, {H100_HBM_BYTES / 1e9:.0f} GB HBM3 "
          f"({H100_HBM_BW / 1e12} TB/s, {H100_PEAK_BF16 / 1e12:.0f} "
          f"TFLOP/s bf16 dense)")
    for rec in sweep(kinds, arch=args.arch, shape=args.shape,
                     variant=variant):
        extra = "" if rec["kind"] != "train" else (
            f"  state+grad {rec['state_and_grad_bytes'] / 1e9:8.1f} GB "
            f"-> at least {rec['min_h100s']} H100s")
        print(f"{rec['mesh_kind']:6s} {rec['arch']:18s} {rec['shape']:11s} "
              f"{rec['bytes_per_device'] / 2**30:9.3f} GiB/device  "
              f"model {rec['model_flops']:.3e} FLOP{extra}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
