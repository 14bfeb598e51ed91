"""Sharded checkpoints in the JAX package's on-disk format (port of
``repro/training/checkpoint.py``), so a checkpoint written by either package
restores in the other.

Layout: <dir>/step_<N>/
    manifest.json            — leaf names, keys, shapes, dtypes, step
    shard_<i>_of_<k>.npz     — flat leaves, each leaf split on axis 0 into
                               k shards where it divides (else in shard 0)

* The leaves are named as ``jax.tree_util.keystr`` names the JAX train
  state's (``['params']['layers']['attn.wq']``, ``['step']``), in the same
  order (dict keys sorted).
* The manifest is written LAST, and the step directory appears by one
  rename of a temporary one: a crash mid-write never leaves a readable but
  corrupt checkpoint (restore trusts manifested steps only).
* ``save_async`` snapshots the state to host numpy first, then writes on a
  background thread while training goes on.
* ``restore`` reassembles each leaf from any k and puts it on the device it
  is asked for, or (``shardings``: ``launch.steps.train_state_shardings``
  of the current mesh) places this rank's shard of it there: the JAX
  package's elastic restore, so a state saved on one mesh continues on
  another (2 x 2 -> one device -> 4 x 1).
* ``save`` of a sharded state (``shardings`` of the mesh it lies on)
  gathers each leaf over the mesh, one at a time, and rank 0 writes the
  full logical leaves in the same format; every rank returns after the
  write.  Either package restores the result.
* Retention: keep_last N.
* bfloat16 leaves are written as float32 (exact), which both packages
  restore into a bfloat16 leaf.  A manifest written by the JAX package may
  hold ``bfloat16`` leaves (``ml_dtypes``); those are read as their raw
  16-bit patterns, without ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> list:
    """[(keystr name, leaf)] in jax.tree_util's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def _unflatten_like(like, values: Dict[str, object], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, values, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    return values[prefix]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, int):                  # the step: int32, as in JAX
        return np.asarray(x, np.int32)
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, state, *, num_shards: int = 1,
         keep_last: int = 3, shardings=None) -> Path:
    """Synchronous sharded save of a tree of tensors, numpy arrays and ints.
    Returns the checkpoint path.  With `shardings` (a tree like `state` of
    ``mesh.NamedSharding``, None for the step) `state` holds this rank's
    shards: every rank calls save, rank 0 writes the gathered leaves."""
    if shardings is not None:
        import torch.distributed as dist
        full = _unflatten_like(state, {
            name: v if sh is None else sh.gather(v).cpu()
            for (name, v), (_, sh) in zip(_flatten(state),
                                          _flatten(shardings))})
        path = Path(ckpt_dir) / f"step_{step:08d}"
        if dist.get_rank() == 0:
            path = save(ckpt_dir, step, full, num_shards=num_shards,
                        keep_last=keep_last)
        dist.barrier()
        return path
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=str(root)))

    manifest = {"step": step, "num_shards": num_shards, "leaves": []}
    shard_payloads: List[Dict[str, np.ndarray]] = [
        dict() for _ in range(num_shards)]
    for idx, (name, v) in enumerate(_flatten(state)):
        a = _to_numpy(v)
        key = f"leaf_{idx}"
        sharded = bool(a.ndim > 0 and a.shape[0] % num_shards == 0
                       and num_shards > 1)
        manifest["leaves"].append({
            "name": name, "key": key, "shape": list(a.shape),
            "dtype": str(a.dtype), "sharded": sharded})
        if sharded:
            for s, part in enumerate(np.split(a, num_shards, axis=0)):
                shard_payloads[s][key] = part
        else:
            shard_payloads[0][key] = a
    for s, payload in enumerate(shard_payloads):
        np.savez(tmp / f"shard_{s}_of_{num_shards}.npz", **payload)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    steps = sorted(p for p in root.glob("step_*")
                   if (p / "manifest.json").exists())
    for old in steps[:-keep_last]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return _to_numpy(tree)


def save_async(ckpt_dir: str, step: int, state, **kw) -> threading.Thread:
    """Snapshot to host numpy now, then write on a background thread."""
    th = threading.Thread(target=save, args=(ckpt_dir, step, _host(state)),
                          kwargs=kw, daemon=True)
    th.start()
    return th


def latest_step(ckpt_dir: str) -> Optional[int]:
    root = Path(ckpt_dir)
    if not root.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in root.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


#: the dtypes a train state holds (param dtypes, fp32 moments, the step)
_TORCH = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "int32": torch.int32}


def _read_leaf(a: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its manifest dtype.  bfloat16
    (written by the JAX package through ml_dtypes) is read as its raw
    16-bit patterns, whatever numpy type the file gives them."""
    if dtype == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {a.dtype}")
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    if dtype not in _TORCH:
        raise ValueError(f"checkpoint leaf dtype {dtype} is not supported")
    return torch.from_numpy(np.array(a, dtype=np.dtype(dtype)))


def restore(ckpt_dir: str, step: int, like, *, device="cpu",
            shardings=None):
    """Restore into the structure of `like`: a tree whose leaves are
    tensors, ``(shape, dtype)`` specs, or ints or the type ``int`` (the
    step, which comes back as an int).  Each tensor leaf is checked against
    its shape, cast to its dtype and put on `device`; or, with `shardings`
    (a tree like `like` of ``mesh.NamedSharding``, None for the step), this
    rank's shard of it is put on its mesh's device."""
    placing = {} if shardings is None else dict(_flatten(shardings))
    path = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    k = manifest["num_shards"]
    shards = [np.load(path / f"shard_{s}_of_{k}.npz", allow_pickle=False)
              for s in range(k)]
    stored = {leaf["name"]: leaf for leaf in manifest["leaves"]}

    values = {}
    for name, spec in _flatten(like):
        if name not in stored:
            raise KeyError(f"checkpoint missing leaf {name}")
        leaf = stored[name]
        if leaf["sharded"]:
            a = np.concatenate([shards[s][leaf["key"]] for s in range(k)],
                               axis=0)
        else:
            a = shards[0][leaf["key"]]
        x = _read_leaf(a, leaf["dtype"])
        if spec is int or isinstance(spec, int):
            values[name] = int(x)
            continue
        shape, dtype = ((tuple(spec.shape), spec.dtype)
                        if isinstance(spec, torch.Tensor) else spec)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(x.shape)} vs {tuple(shape)}")
        x = x.to(dtype=dtype)
        sh = placing.get(name)
        values[name] = x.to(device) if sh is None else sh.place(x)
    return _unflatten_like(like, values)
