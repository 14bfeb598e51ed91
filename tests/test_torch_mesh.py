"""The port's sharding rules (repro_torch.launch.mesh) against the JAX
package's (repro.launch.mesh), with no device and no process group: one
stand-in mesh (axis sizes only) serves both.

* for every arch and both production meshes, every layout -- param specs
  for attn_mode heads / hd / replicated with fsdp on and off, resident,
  ZeRO-3; batch specs of train_4k and prefill_32k; cache specs of
  decode_32k and long_500k for every shard_mode -- equals JAX's tree leaf
  by leaf, by name;
* the divisibility checks of tests/test_sharding.py on the port's own
  param, batch and cache specs (``local_shape`` raises where a dim does not
  divide);
* ``cells()`` equals JAX's;
* the dry-run's per-device bytes equal the sum over leaves of the local
  shard shapes, and ``local_shard`` / ``put_shard`` round-trip a tensor.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import repro.configs as JC
import repro_torch.configs as TC
from repro.configs import common as JCC
from repro.launch import mesh as JMS
from repro.launch import steps as JST
from repro.models import model as JMDL
from repro_torch.configs import common as TCC
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as MS
from repro_torch.launch import steps as ST
from repro_torch.models import model as MDL
from repro_torch.models import params as PRM
from repro_torch.models.config import SHAPES_BY_NAME, shape_applicable
from repro_torch.training import checkpoint as CKPT

MESH_SHAPES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}
PARAM_LAYOUTS = [dict(fsdp=f, attn_mode=a) for f in (True, False)
                 for a in ("heads", "hd", "replicated")] + [
    dict(fsdp=False, attn_mode="hd", resident=True)]


class FakeMesh:
    """Duck-typed stand-in for a mesh (axis sizes only), as
    tests/test_sharding.py's."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _jax_flat(pspecs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        pspecs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _port_flat(specs) -> dict:
    return dict(CKPT._flatten(specs))


def _check_divides(specs, pspecs, mesh):
    shapes = {n: (tuple(s.shape) if hasattr(s, "shape") else tuple(s[0]))
              for n, s in CKPT._flatten(specs)}
    for name, spec in _port_flat(pspecs).items():
        MS.local_shape(shapes[name], spec, mesh)      # raises if not


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_param_specs_equal_jax(arch, mesh_kind):
    mesh = FakeMesh(MESH_SHAPES[mesh_kind])
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for kw in PARAM_LAYOUTS:
        mine = _port_flat(MS.param_pspecs(tcfg, mesh, **kw))
        assert mine == _jax_flat(JMS.param_pspecs(jcfg, mesh, **kw)), kw
        if kw.get("fsdp") or kw.get("resident"):
            _check_divides(PRM.param_specs(tcfg),
                           MS.param_pspecs(tcfg, mesh, **kw), mesh)
    assert _port_flat(MS.param_pspecs_zero3(tcfg, mesh)) == \
        _jax_flat(JMS.param_pspecs_zero3(jcfg, mesh))
    _check_divides(PRM.param_specs(tcfg), MS.param_pspecs_zero3(tcfg, mesh),
                   mesh)
    assert _port_flat(ST.train_state_pspecs(tcfg, mesh)) == _jax_flat(
        JST.train_state_pspecs(jcfg, mesh))


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_batch_specs_equal_jax_and_divide(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for mesh_kind, shape in MESH_SHAPES.items():
        mesh = FakeMesh(shape)
        for name in ("train_4k", "prefill_32k"):
            s = SHAPES_BY_NAME[name]
            mk = (TCC.train_batch_specs, JCC.train_batch_specs) \
                if s.kind == "train" else \
                (TCC.prefill_batch_specs, JCC.prefill_batch_specs)
            tb = mk[0](tcfg, s.global_batch, s.seq_len)
            jb = mk[1](jcfg, s.global_batch, s.seq_len)
            assert {k: (tuple(v[0]), str(v[1])[6:]) for k, v in tb.items()} \
                == {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
            mine = MS.batch_pspecs(tcfg, mesh, tb)
            assert {k: tuple(v) for k, v in mine.items()} == \
                {k: tuple(v) for k, v in
                 JMS.batch_pspecs(jcfg, mesh, jb).items()}
            _check_divides(tb, mine, mesh)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_cache_specs_equal_jax_and_divide(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        s = SHAPES_BY_NAME[name]
        if not shape_applicable(tcfg, s)[0]:
            continue
        tc = MDL.cache_specs(tcfg, s.global_batch, s.seq_len)
        jc = JMDL.cache_specs(jcfg, s.global_batch, s.seq_len)
        # the port's write cursor is a host int, not a cache tensor
        assert set(jc) - set(tc) == {"idx"}
        for mesh_kind, shape in MESH_SHAPES.items():
            mesh = FakeMesh(shape)
            for mode in ("hd", "lc", "kv", "none"):
                mine = MS.cache_pspecs(tcfg, mesh, tc, shard_mode=mode)
                _check_divides(tc, mine, mesh)
                try:
                    theirs = JMS.cache_pspecs(jcfg, mesh, jc, shard_mode=mode)
                except ValueError as e:
                    # batch 1 with the length over data and model: JAX's
                    # rule nests the data tuple, which PartitionSpec
                    # refuses; the port's spec is the flattened tuple
                    assert "nested tuple" in str(e)
                    assert mode == "lc" and s.global_batch == 1
                    da = MS.data_axes(mesh)
                    assert mine["k"][2] == mine["v"][2] == (*da, "model")
                    continue
                assert {k: tuple(v) for k, v in mine.items()} == \
                    {k: tuple(theirs[k]) for k in tc}, (name, mode)


def test_cells_equal_jax():
    mine = [(a, s.name, ok, why) for a, s, ok, why in
            TC.cells(include_skipped=True)]
    theirs = [(a, s.name, ok, why) for a, s, ok, why in
              JC.cells(include_skipped=True)]
    assert mine == theirs
    assert len(mine) == 40 and sum(c[2] for c in mine) == 32
    spec = TC.input_specs("olmo-1b", "decode_32k")
    assert set(spec) == {"batch", "cache"}


def test_local_shape_refuses_a_dim_that_does_not_divide():
    mesh = FakeMesh({"data": 2, "model": 4})
    assert MS.local_shape((8, 6), (("data",), None), mesh) == (4, 6)
    with pytest.raises(ValueError, match="does not divide"):
        MS.local_shape((8, 6), (None, "model"), mesh)


def test_local_shards_tile_the_tensor():
    mesh = FakeMesh({"pod": 2, "data": 2, "model": 2})
    full = torch.arange(8 * 4 * 6).reshape(8, 4, 6)
    spec = (("pod", "data"), None, "model")
    out = torch.zeros_like(full)
    for p in range(2):
        for d in range(2):
            for m in range(2):
                coords = {"pod": p, "data": d, "model": m}
                shard = MS.local_shard(full, spec, mesh, coords)
                assert shard.shape == (2, 4, 3)
                # the compound axis is row-major: pod major, data minor
                assert int(shard[0, 0, 0]) == int(full[(2 * p + d) * 2, 0,
                                                       3 * m])
                MS.put_shard(out, shard, spec, mesh, coords)
    assert torch.equal(out, full)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_dryrun_bytes_are_the_local_shards(mesh_kind):
    mesh = MS.make_production_mesh(multi_pod=mesh_kind == "multi")
    for arch, shape, _, _ in TC.cells():
        rec = DRY.cell(arch, shape.name, mesh)
        cfg = TC.get_config(arch)
        want = 0
        if shape.kind == "train":
            specs = ST.train_state_pspecs(cfg, mesh)
            like = ST.train_state_specs(cfg)
            for name, spec in CKPT._flatten(specs):
                if name == "['step']":
                    continue
                shp, dt = dict(CKPT._flatten(like))[name]
                local = torch.empty(shp, dtype=dt, device="meta")
                local = MS.local_shard(local, spec, mesh,
                                       {a: 0 for a in mesh.axis_names})
                want += local.numel() * local.element_size()
        else:
            want = sum(int(np.prod(MS.local_shape(s[0], sp, mesh)))
                       * s[1].itemsize for s, sp in DRY.serving_leaves(
                           cfg, shape, mesh))
        assert rec["bytes_per_device"] == want, (arch, shape.name)
        assert rec["model_flops"] == DRY.model_flops(cfg, shape)


def test_dryrun_h100_counts():
    mesh = MS.make_production_mesh()
    rec = DRY.cell("falcon-mamba-7b", "train_4k", mesh)
    n = TC.get_config("falcon-mamba-7b").param_count(padded=True)
    # fp32 master weights, two fp32 moments, fp32 gradients: 16 B each
    assert rec["state_and_grad_bytes"] == 16 * n
    assert rec["min_h100s"] == -(-16 * n // DRY.H100_HBM_BYTES)
    assert all(r["min_h100s"] >= 1 for r in DRY.sweep(("single",))
               if r["kind"] == "train")
