"""Device meshes for the sharded paths: the port's counterpart of the JAX
package's `jax.sharding.Mesh` and `shard_map`.

A mesh has the named axes ("channel", "time"), either of size 1. A
per-shard body is written once, against `Axis`, the collectives along one
mesh axis (`index`, `size`, `all_gather`, `psum`, `pmax`, `ppermute`).
Sharded data reach the body with the shards this process holds on a
leading axis (`Mesh.stage`, then `Mesh.local`):

* `LocalMesh` holds every shard in one process on one device, so the body
  sees all D shards of an axis at once and the collectives are plain
  tensor operations over the leading axis (the counterpart of the JAX
  tests' 8-device fake CPU mesh). On the card the shards become one batch.
* `DistMesh` holds one shard a rank of `torch.distributed` (NCCL across
  cards, gloo on the CPU), with a process sub-group for each row and each
  column of the mesh; the body sees one shard.

`psum` and `pmax` reduce in shard order on both meshes (a DistMesh gathers
the shards and reduces them in the same order), so a DistMesh reproduces a
LocalMesh of the same shape bit for bit wherever the per-shard arithmetic
does not depend on how many shards a process holds. `ppermute` leaves
zeros where no shard sends, as `jax.lax.ppermute` does at the mesh edge.
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from ..utils.device import as_float, resolve_device

class Axis(abc.ABC):
    """The collectives along one mesh axis of `size` shards, of which this
    process holds `local` (all of them, or one). Inputs and outputs carry
    the local shards on their leading axis, except where a result is the
    same on every shard (`all_gather`, `psum`, `pmax`), which drops it."""

    size: int
    local: int

    @abc.abstractmethod
    def index(self) -> torch.Tensor:
        """(local,) int64: each local shard's position on the axis."""

    @abc.abstractmethod
    def all_gather(self, x):
        """(local, ...) -> (size, ...): every shard's value, in order."""

    def psum(self, x):
        """(local, ...) -> (...): the sum over every shard, in shard order."""
        g = self.all_gather(x)
        out = g[0]
        for i in range(1, g.shape[0]):
            out = out + g[i]
        return out

    def pmax(self, x):
        """(local, ...) -> (...): the elementwise maximum over every shard."""
        return torch.amax(self.all_gather(x), dim=0)

    @abc.abstractmethod
    def ppermute(self, x, shift: int):
        """(local, ...) -> (local, ...): shard i receives shard i - shift's
        value (shift +1: from the left neighbour; -1: from the right);
        zeros where that shard does not exist."""


class LocalAxis(Axis):
    """Every shard of the axis in this process, on the leading axis."""

    def __init__(self, size: int, device):
        self.size = self.local = size
        self.device = device

    def index(self):
        return torch.arange(self.size, device=self.device)

    def all_gather(self, x):
        return x

    def ppermute(self, x, shift: int):
        out = torch.zeros_like(x)
        if shift > 0:
            out[shift:] = x[:-shift]
        elif shift < 0:
            out[:shift] = x[-shift:]
        else:
            out.copy_(x)
        return out


class DistAxis(Axis):
    """One shard of the axis in this process: position `pos` in `ranks`
    (the global ranks along the axis, in shard order), over `group`."""

    def __init__(self, ranks, pos: int, group, device):
        self.size, self.local = len(ranks), 1
        self.ranks, self.pos, self.group = list(ranks), pos, group
        self.device = device

    def index(self):
        return torch.full((1,), self.pos, dtype=torch.long,
                          device=self.device)

    def all_gather(self, x):
        import torch.distributed as dist

        x = x.contiguous()
        if self.size == 1:
            return x
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x, group=self.group)
        return torch.cat(out)

    def ppermute(self, x, shift: int):
        import torch.distributed as dist

        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        dst, src = self.pos + shift, self.pos - shift
        if 0 <= dst < self.size:
            ops.append(dist.P2POp(dist.isend, x, self.ranks[dst], self.group))
        if 0 <= src < self.size:
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[src],
                                  self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out


class Mesh(abc.ABC):
    """A (channel, time) mesh of shards on `device`."""

    shape: dict
    device: torch.device

    @abc.abstractmethod
    def axis(self, name: str) -> Axis:
        """The collectives along the axis `name`."""

    @abc.abstractmethod
    def stage(self, x, dtype):
        """Host data or a tensor x, made ready for `local`: where the cut
        is made. `as_float(local(...), dtype, device)` then holds this
        process's shards as `dtype` on the mesh's device."""

    def local(self, x, name: str, dim: int = 0):
        """The shards this process holds of x, cut into `shape[name]` equal
        contiguous parts along `dim`, on a new leading axis."""
        ax = self.axis(name)
        n = x.shape[dim]
        if n % ax.size:
            raise ValueError(f"{n} is not a multiple of the {name} axis's "
                             f"{ax.size} shards")
        parts = torch.chunk(x, ax.size, dim=dim)
        if ax.local == ax.size:
            return torch.stack(parts)
        return parts[ax.pos].unsqueeze(0)

    def gather(self, x, name: str, dim: int = 0):
        """The inverse of `local`: (local, ...) shards -> the whole tensor
        on every process, the shards joined along `dim`."""
        return torch.cat(list(self.axis(name).all_gather(x)), dim=dim)


class LocalMesh(Mesh):
    """Every shard in this process on one device (default CUDA)."""

    def __init__(self, channel: int = 1, time: int = 1, *, device=None):
        if channel < 1 or time < 1:
            raise ValueError("mesh axes need at least one shard")
        self.shape = {"channel": channel, "time": time}
        self.device = resolve_device(device)
        self._axes = {name: LocalAxis(n, self.device)
                      for name, n in self.shape.items()}

    def axis(self, name):
        return self._axes[name]

    def stage(self, x, dtype):
        """x whole as `dtype` on the device, where every shard lives."""
        return as_float(x, dtype, self.device)

    def __repr__(self):
        return f"LocalMesh({self.shape}, device={self.device})"


class DistMesh(Mesh):
    """One shard a rank of the initialised default process group: rank r
    sits at (channel, time) = divmod(r, time), the JAX mesh's row-major
    device layout. Every rank must construct it, with the same shape: each
    row and each column of the mesh gets its own sub-group, created in the
    same order on all ranks. `device` is this rank's card (NCCL) or the
    CPU (gloo)."""

    def __init__(self, channel: int = 1, time: int = 1, *, device=None):
        import torch.distributed as dist

        world, rank = dist.get_world_size(), dist.get_rank()
        if channel * time != world:
            raise ValueError(f"{channel} x {time} != {world} ranks")
        self.shape = {"channel": channel, "time": time}
        self.device = resolve_device(device)
        self.rank = rank
        c, t = divmod(rank, time)
        rows = [[i * time + j for j in range(time)] for i in range(channel)]
        cols = [[i * time + j for i in range(channel)] for j in range(time)]
        row_groups = [dist.new_group(r) for r in rows]
        col_groups = [dist.new_group(r) for r in cols]
        self._axes = {
            "time": DistAxis(rows[c], t, row_groups[c], self.device),
            "channel": DistAxis(cols[t], c, col_groups[t], self.device)}

    def axis(self, name):
        return self._axes[name]

    def stage(self, x, dtype):
        """x left where it is (host data as a host tensor, no copy), so
        that only this rank's shard is copied to its device."""
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))

    def __repr__(self):
        return f"DistMesh({self.shape}, rank={self.rank}, device={self.device})"
