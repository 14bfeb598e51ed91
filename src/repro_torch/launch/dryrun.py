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
    models that decode: ``cache_pspecs`` with head_dim over `model`), each
    leaf's local shard as ``mesh.local_shape`` gives it;
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


def serving_leaves(cfg, shape, mesh) -> list:
    """[((shape, dtype), spec)] of a serving cell's weights and cache."""
    head_dim_tp = shape.kind == "decode" and cfg.head_dim % 16 == 0
    pspecs = MS.param_pspecs(cfg, mesh, fsdp=True,
                             attn_mode="hd" if head_dim_tp else "heads")
    masters = PRM.param_specs(cfg)
    specs = {k: (v[0], PRM._dtype(cfg, k)) for k, v in masters.items()
             if k != "layers"}
    specs["layers"] = {k: (s, PRM._dtype(cfg, k))
                       for k, (s, _) in masters["layers"].items()}
    out = list(zip(OPT.leaves(specs), OPT.leaves(pspecs)))
    if cfg.supports_decode:
        cache = MDL.cache_specs(cfg, shape.global_batch, shape.seq_len)
        cspecs = MS.cache_pspecs(cfg, mesh, cache, shard_mode="hd")
        out += [(cache[k], cspecs[k]) for k in sorted(cache)]
    return out


def cell(arch: str, shape_name: str, mesh) -> dict:
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
                                      serving_leaves(cfg, shape, mesh))
    return rec


def sweep(mesh_kinds: Iterable[str] = ("single", "multi")) -> List[dict]:
    out = []
    for kind in mesh_kinds:
        mesh = MS.make_production_mesh(multi_pod=kind == "multi")
        for arch, shape, _, _ in C.cells():
            out.append(dict(cell(arch, shape.name, mesh), mesh_kind=kind))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    args = ap.parse_args(argv)
    kinds = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    print(f"per-device bytes from the sharding rules; constants: NVIDIA "
          f"H100 SXM, {H100_HBM_BYTES / 1e9:.0f} GB HBM3 "
          f"({H100_HBM_BW / 1e12} TB/s, {H100_PEAK_BF16 / 1e12:.0f} "
          f"TFLOP/s bf16 dense)")
    for rec in sweep(kinds):
        extra = "" if rec["kind"] != "train" else (
            f"  state+grad {rec['state_and_grad_bytes'] / 1e9:8.1f} GB "
            f"-> at least {rec['min_h100s']} H100s")
        print(f"{rec['mesh_kind']:6s} {rec['arch']:18s} {rec['shape']:11s} "
              f"{rec['bytes_per_device'] / 2**30:9.3f} GiB/device  "
              f"model {rec['model_flops']:.3e} FLOP{extra}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
