"""Running on a mesh of ranks: process groups named as the JAX package's mesh
axes, the collectives of the sharded train step, their byte counter, and a
launcher of rank processes.

JAX states a layout as PartitionSpecs and lets GSPMD insert the
collectives.  The port keeps the layout as data (``launch/mesh.py``) and
runs the step on each rank's local shards, with the collectives written out
here.  Each is a ``torch.autograd.Function`` where the step differentiates
through it:

  gather_cast   a parameter shard cast to the compute dtype and all-gathered
                along one dim (FSDP); the backward reduce-scatters the
                gradient in float32 back onto the shard;
  copy_to       identity forward, all-reduce of the gradient backward (an
                activation or weight that is replicated over an axis and
                then used in a computation split over it);
  reduce_from   all-reduce forward, identity backward (the partial sums of
                a computation split over an axis, read by every rank).

Every kernel then runs unchanged on its rank's shard.  The other
collectives (the gradients of replicated leaves, the loss, the global norm,
gathering a state) carry no gradient.

``Mesh`` builds the groups of a ``torch.distributed.device_mesh`` mesh of
the current process group, one per axis and one per set of axes (the
compound data axis ``("pod", "data")``, the sets a gradient norm sums
over); a collective over axes of total size 1 is skipped, so a 1 x 1 mesh
runs the one-device arithmetic.  ``Mesh.bytes`` counts, per kind of
collective, the bytes each rank moves under the ring model (all-gather:
the output's (n-1)/n; reduce-scatter: the input's (n-1)/n; all-reduce:
twice the tensor's (n-1)/n), as ``kernels.ops`` counts launches.

CUDA with NCCL unless the caller asks for ``device_type="cpu"`` (gloo);
without a GPU the CUDA default raises.  ``backend="gloo"`` with CUDA runs
the ranks' collectives over gloo through the host (each collective copies
its tensor to the CPU and back): ranks that share one card, which NCCL
refuses, e.g. a two-rank mesh on a one-card machine.
"""
from __future__ import annotations

import collections
import datetime
import itertools
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import local_shard

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# torch >= 2.10 names the tensor forms *_single; older ones *_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def device_type_of(device_type: Optional[str]) -> str:
    """None means CUDA; CUDA without a GPU raises (the port never falls
    back to the CPU on its own)."""
    dt = device_type or "cuda"
    if dt not in BACKENDS:
        raise ValueError(f"device_type {dt!r}: 'cuda' or 'cpu'")
    if dt == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA and no GPU is available; "
                           "pass device_type='cpu' to run on the CPU (gloo)")
    return dt


def init_world(rank: int, world_size: int, store_path: str, *,
               device_type: Optional[str] = None,
               timeout_s: float = 600.0, backend: Optional[str] = None) -> None:
    """The default process group of `world_size` ranks over a FileStore at
    `store_path` (NCCL on CUDA, rank r on card r % cards; gloo on the CPU;
    `backend` "gloo" on CUDA: see the module docstring), whose collectives
    give up after `timeout_s`."""
    dt = device_type_of(device_type)
    if dt == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend or BACKENDS[dt], store=dist.FileStore(store_path, world_size),
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


class Mesh:
    """A named mesh over the ranks of the current process group (every
    rank builds it, in the same order as every other mesh): ``shape``
    {axis: size} and ``axis_names`` as the rules read them, this rank's
    ``coords``, its ``device``, the process groups, and the byte counter
    ``bytes`` (kind of collective -> bytes this rank moved)."""

    def __init__(self, shape: Dict[str, int], *,
                 device_type: Optional[str] = None):
        from torch.distributed.device_mesh import init_device_mesh
        self.device_type = device_type_of(device_type)
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        world = dist.get_world_size()
        if int(np.prod(list(self.shape.values()))) != world:
            raise ValueError(f"mesh {self.shape} does not cover the "
                             f"{world} ranks of the process group")
        self.device_mesh = init_device_mesh(
            self.device_type, tuple(self.shape.values()),
            mesh_dim_names=self.axis_names)
        self.coords = {a: self.device_mesh.get_local_rank(a)
                       for a in self.axis_names}
        self.device = torch.device(self.device_type,
                                   torch.cuda.current_device()) \
            if self.device_type == "cuda" else torch.device("cpu")
        self.bytes = collections.Counter()
        # gloo on CUDA tensors: every collective goes through the host
        self.staged = self.device_type == "cuda" and \
            dist.get_backend() == "gloo"
        layout = np.arange(world).reshape(tuple(self.shape.values()))
        me = dist.get_rank()
        self._groups = {(a,): self.device_mesh.get_group(a)
                        for a in self.axis_names}
        # the sets of two or more axes: one group per fiber, created by
        # every rank in the same order; ranks in a fiber increase in mesh
        # order, so a group's rank i is compound index i
        for k in range(2, len(self.axis_names) + 1):
            for axes in itertools.combinations(range(len(self.axis_names)),
                                               k):
                rest = [i for i in range(layout.ndim) if i not in axes]
                fibers = layout.transpose(rest + list(axes)).reshape(
                    -1, int(np.prod([layout.shape[i] for i in axes])))
                for ranks in fibers:
                    g = dist.new_group([int(r) for r in ranks])
                    if me in ranks:
                        self._groups[tuple(self.axis_names[i]
                                           for i in axes)] = g

    # -- axes -------------------------------------------------------------
    def axes(self, entry) -> Tuple[str, ...]:
        """A spec entry (None, an axis name or a tuple of names) as a tuple
        of names in mesh order."""
        if entry is None:
            return ()
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        order = sorted(names, key=self.axis_names.index)
        if list(names) != order:
            raise ValueError(f"axes {names} are not in mesh order "
                             f"{self.axis_names}")
        return names

    def size(self, entry) -> int:
        return int(np.prod([self.shape[a] for a in self.axes(entry)]))

    def index(self, entry) -> int:
        """This rank's index along `entry` (row-major over its axes)."""
        i = 0
        for a in self.axes(entry):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, entry):
        axes = tuple(a for a in self.axes(entry) if self.shape[a] > 1)
        return self._groups[axes] if axes else None

    def _count(self, kind: str, nbytes: int, n: int) -> None:
        factor = 2 if kind == "all_reduce" else 1
        self.bytes[kind] += factor * nbytes * (n - 1) // n

    def _run(self, collective, out: torch.Tensor, *inputs: torch.Tensor,
             **kw) -> torch.Tensor:
        """collective(out, *inputs, **kw), through host copies where the
        ranks' collectives are gloo over CUDA tensors; returns out.  With
        no `inputs` the collective works on `out` in place.  The host
        copies live in pinned memory (PyTorch's caching host allocator: no
        page faults for a buffer of a size seen before), the output is
        copied from the device only where the collective reads it, and it
        goes back to the device on the stream without waiting."""
        if not self.staged:
            collective(out, *inputs, **kw)
            return out

        def pinned(t, copy):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return h.copy_(t) if copy else h
        host = pinned(out, not inputs)
        collective(host, *(pinned(t, True) for t in inputs), **kw)
        return out.copy_(host, non_blocking=True)

    # -- collectives without gradient -------------------------------------
    def all_reduce_(self, t: torch.Tensor, entry,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place over `entry`'s ranks (a no-op where they are one)."""
        g = self.group(entry)
        if g is not None:
            self._count("all_reduce", t.numel() * t.element_size(),
                        self.size(entry))
            self._run(lambda x: dist.all_reduce(x, op=op, group=g), t)
        return t

    def all_gather(self, t: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """The shards of `entry`'s ranks concatenated along `dim`."""
        g, n = self.group(entry), self.size(entry)
        if g is None:
            return t
        t = t.contiguous()
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        self._run(_ALL_GATHER, out, t, group=g)
        self._count("all_gather", out.numel() * out.element_size(), n)
        out = out.view((n,) + tuple(t.shape)).movedim(0, dim)
        shape = list(t.shape)
        shape[dim] *= n
        return out.reshape(shape)

    def reduce_scatter(self, t: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """The sum over `entry`'s ranks of `t`, of which this rank keeps its
        chunk along `dim`."""
        g, n = self.group(entry), self.size(entry)
        if g is None:
            return t
        shape = list(t.shape)
        shape[dim] //= n
        chunks = t.reshape(shape[:dim] + [n, shape[dim]] + shape[dim + 1:])
        chunks = chunks.movedim(dim, 0).reshape([n * shape[0]] + shape[1:])
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        self._run(_REDUCE_SCATTER, out, chunks, group=g)
        self._count("reduce_scatter", chunks.numel() * chunks.element_size(),
                    n)
        return out

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int,
                   entry) -> torch.Tensor:
        """`t` cut into `entry`'s n ranks' chunks along `split_dim`, chunk
        i sent to rank i, and the chunks each rank receives concatenated
        along `concat_dim` in rank order: a dim split over `entry` moves
        from `concat_dim` to `split_dim` (a cache from head_dim over
        `model` to its length over `model`)."""
        g, n = self.group(entry), self.size(entry)
        if g is None:
            return t
        x = t.movedim(split_dim, 0)
        x = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])).contiguous()
        out = self._run(dist.all_to_all_single, torch.empty_like(x), x,
                        group=g)
        self._count("all_to_all", x.numel() * x.element_size(), n)
        # out[i] is rank i's chunk: back to t's dims, then rank-major along
        # concat_dim
        out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
        shape = list(out.shape)
        shape[concat_dim:concat_dim + 2] = [shape[concat_dim]
                                            * shape[concat_dim + 1]]
        return out.reshape(shape)

    # -- collectives with gradient ----------------------------------------
    def gather_cast(self, shard: torch.Tensor, dtype, dim: int, entry
                    ) -> torch.Tensor:
        """`shard` cast to `dtype`, all-gathered along `dim` over `entry`;
        its gradient reduce-scattered in float32 onto the shard.  A plain
        cast where `entry`'s ranks are one."""
        if self.group(entry) is None:
            return shard.to(dtype)
        return _GatherCast.apply(shard, dtype, dim, self, entry)

    def copy_to(self, x: torch.Tensor, entry) -> torch.Tensor:
        """Identity forward; the gradient all-reduced over `entry`."""
        if self.group(entry) is None:
            return x
        return _CopyTo.apply(x, self, entry)

    def reduce_from(self, x: torch.Tensor, entry) -> torch.Tensor:
        """The sum over `entry`'s ranks; the gradient passes unchanged."""
        if self.group(entry) is None:
            return x
        return _ReduceFrom.apply(x, self, entry)

    # -- whole tensors ------------------------------------------------------
    def local(self, full: torch.Tensor, spec) -> torch.Tensor:
        """This rank's shard of `full` under `spec` (a copy on this mesh's
        device)."""
        return local_shard(full, spec, self, self.coords).to(
            self.device, memory_format=torch.contiguous_format, copy=True)

    def full(self, shard: torch.Tensor, spec) -> torch.Tensor:
        """The tensor whose shard under `spec` this rank holds (every rank
        gets it)."""
        for dim, entry in enumerate(spec):
            shard = self.all_gather(shard, dim, entry)
        return shard


class _GatherCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dtype, dim, mesh, entry):
        ctx.meta = (shard.dtype, dim, mesh, entry)
        return mesh.all_gather(shard.to(dtype), dim, entry)

    @staticmethod
    def backward(ctx, g):
        dtype, dim, mesh, entry = ctx.meta
        return (mesh.reduce_scatter(g.float(), dim, entry).to(dtype), None,
                None, None, None)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, entry):
        ctx.meta = (mesh, entry)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, entry = ctx.meta
        return mesh.all_reduce_(g.contiguous().clone(), entry), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, entry):
        return mesh.all_reduce_(x.contiguous().clone(), entry)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# ------------------------------ rank processes --------------------------------
def _rank_main(rank: int, fn: Callable, world_size: int, device_type: str,
               workdir: str, timeout_s: float, args: tuple,
               backend: Optional[str] = None) -> None:
    if device_type == "cpu":
        torch.set_num_threads(1)
    init_world(rank, world_size, os.path.join(workdir, "store"),
               device_type=device_type, timeout_s=timeout_s, backend=backend)
    try:
        out = fn(rank, world_size, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # no destroy_process_group here: with NCCL it waits for the peers'
        # collectives, which wait for this rank, until their timeout
        err = Path(workdir, f"rank{rank}.err")
        err.with_suffix(".tmp").write_text(traceback.format_exc())
        err.with_suffix(".tmp").rename(err)
        raise
    dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args,
              device_type: Optional[str] = None, timeout_s: float = 600.0,
              workdir: Optional[str] = None,
              backend: Optional[str] = None) -> list:
    """Run ``fn(rank, world_size, *args)`` in `world_size` spawned
    processes, each in a process group of them all (``init_world``), and
    return their results by rank.  `fn` must be importable by name
    (spawned processes start from a fresh import).  A rank that raises
    fails the run at once: the others are stopped, and the error carries
    its traceback.  The run fails after `timeout_s` seconds whatever the
    ranks are doing; their collectives give up at the same limit.
    `backend` as ``init_world``'s."""
    import torch.multiprocessing as mp
    dt = device_type_of(device_type)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, dt, tmp, timeout_s, args,
                              backend),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s

        def errors() -> str:
            return "\n".join(p.read_text()
                             for p in sorted(Path(tmp).glob("rank*.err")))
        try:
            try:
                # a rank's error file ends the wait: the rank itself may
                # still be stuck behind its peers' collectives
                while not ctx.join(timeout=0.5) and not errors():
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size} ranks of {fn.__name__} still "
                            f"running after {timeout_s} s")
            except (mp.ProcessRaisedException,
                    mp.ProcessExitedException) as e:
                raise RuntimeError(f"a rank of {fn.__name__} failed:\n"
                                   f"{errors() or e}") from None
            if errors():
                raise RuntimeError(f"a rank of {fn.__name__} failed:\n"
                                   f"{errors()}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
