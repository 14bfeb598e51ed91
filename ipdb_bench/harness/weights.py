"""Model configurations and weights, made from the configuration's file and
the run's seed.

The weights follow the initialiser of the port (``repro_torch/models/
params.py::init_params``): ``ssm.A_log`` is log(1..N) in every channel,
``ssm.D`` ones, other 1-D leaves ones (scales) or zeros (biases), every
other leaf normal with std 1/sqrt(fan_in).  A configuration's ``init``
may set ``embed_std``, which draws the embedding with that std: a deep
random stack drawn by the port's rule alone can be chaotic
(falcon-mamba-7b's 64 layers give bfloat16 logits no closer to the float32
reference's than an unrelated draw, so that no comparison could tell a
sound bfloat16 program from a broken one; PERF.md).  They are drawn on
the device by one ``torch.Generator`` seeded with the run's seed, one call
a leaf over all its layers, straight in the dtype each leaf is served in.
The same seed gives the same weights; the program and the reference are
both handed these tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

#: the generator's seed range: `--seed` may be any whole number
SEED_MOD = 2**63 - 1


def model_config(cfg_file: dict, **override):
    """The port's ``ModelConfig`` from the file's ``model`` section (the
    sizes as they are run), with `override` applied (the CPU tests' small
    sizes)."""
    from repro_torch.models.config import ModelConfig
    fields = dict(cfg_file["model"])
    fields.update(override)
    return ModelConfig(**fields)


def leaf_shapes(cfg) -> Dict[str, tuple]:
    """name -> (shape, serving dtype, stacked) of every leaf of the serving
    tree, as the port lays it out."""
    from repro_torch.models import params as P
    out = {}
    for k, s in P._layer_shapes(cfg).items():
        out[k] = ((cfg.num_layers,) + tuple(s), P._dtype(cfg, k), True)
    for k, s in P._top_shapes(cfg).items():
        out[k] = (tuple(s), P._dtype(cfg, k), False)
    return out


def _fan_in(name: str, shape: tuple) -> int:
    if name == "attn.wo":
        return shape[0] * shape[1]
    if name.startswith("attn.w"):
        return shape[0]
    return shape[-2]


def make_weights(cfg, seed: int, device, init: Optional[dict] = None
                 ) -> dict:
    """The serving tree ``{"layers": {name: (L, ...)}, name: ...}`` drawn
    from `seed` on `device`, by the rule above and the configuration's
    `init`."""
    init = init or {}
    gen = torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)
    layers, top = {}, {}
    for name, (shape, dt, stacked) in leaf_shapes(cfg).items():
        one = shape[1:] if stacked else shape
        if name == "ssm.A_log":
            t = torch.log(torch.arange(1, one[-1] + 1, dtype=dt,
                                       device=device)).expand(shape).clone()
        elif name == "ssm.D" or len(one) == 1:
            fill = 1.0 if name == "ssm.D" or name.endswith("scale") else 0.0
            t = torch.full(shape, fill, dtype=dt, device=device)
        else:
            std = 1.0 / math.sqrt(max(1, _fan_in(name, one)))
            if name == "embed" and init.get("embed_std"):
                std = float(init["embed_std"])
            t = torch.randn(shape, generator=gen, dtype=dt,
                            device=device).mul_(std)
        (layers if stacked else top)[name] = t
    return {"layers": layers, **top}


def matmul_params(params: dict, tie_embeddings: bool) -> int:
    """Parameters a token multiplies by: every leaf but the embedding, which
    is a gather, and with the embedding again where it is the LM head."""
    n = sum(t.numel() for t in params["layers"].values())
    n += sum(v.numel() for k, v in params.items()
             if k not in ("layers", "embed"))
    if tie_embeddings:
        n += params["embed"].numel()
    return n
