"""Device meshes: read batches and observation rows split over several
devices, their integer partial sums added back together.

Port of graphtyper_tpu/parallel/mesh.py. `Mesh` stands in for
jax.sharding.Mesh: a grid of torch devices with named axes (`("data",)` or
`("host", "data")`) and, where the first axis spans processes, the
torch.distributed process group that joins them. Work is split over the
mesh's entries in row-major order, one contiguous shard an entry; a process
runs the entries of its own host row (all of them without a group), adds
their results on its first device, and `host_sum` adds the hosts' sums over
the group (gloo, on a CPU copy). Every partial is an integer count or an
integer-valued float below 2^24, so the sums are exact in any order.

The same device may stand in several entries: one card, or the CPU, then
plays a mesh of n, as JAX's virtual CPU devices do in its tests.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from graphtyper_tpu_torch.ops.genotype_step import genotype_forward

__all__ = ["Mesh", "make_mesh", "shard_reads", "sharded_genotype_step"]


class Mesh:
    """A grid of torch devices with one name an axis; `group`, where set, is
    the process group over the first axis (row h is process h's devices)."""

    def __init__(self, devices, axis_names: tuple[str, ...], group=None):
        given = np.array(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes {axis_names}")
        if group is not None and grid.shape[0] != dist.get_world_size(group):
            raise ValueError(f"host axis of {grid.shape[0]} for a group of {dist.get_world_size(group)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.group = group

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_entries(self) -> list[tuple[int, torch.device]]:
        """(shard index, device) of every entry this process runs."""
        if self.group is None:
            return list(enumerate(self.devices.flat))
        per_host = self.size // self.devices.shape[0]
        lo = dist.get_rank(self.group) * per_host
        return [(lo + j, d) for j, d in enumerate(self.devices[dist.get_rank(self.group)].flat)]

    def host_sum(self, t: torch.Tensor) -> torch.Tensor:
        """`t` summed over the processes of the host axis; `t` itself when
        one process runs the whole mesh."""
        if self.group is None:
            return t
        buf = t.to("cpu", copy=True)
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)


def make_mesh(n_devices: int | None = None, axis: str = "data", devices=None) -> Mesh:
    """1-d mesh over `devices`, by default the first `n_devices` CUDA devices
    (all of them when None); raises where there is none."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] for another device")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


def shard_reads(mesh: Mesh, read_codes: np.ndarray, eps: np.ndarray):
    """Host read arrays padded to a multiple of the mesh size (reads of pad
    code 5, eps 0) and split into one contiguous shard a mesh entry; returns
    ([R_shard, L] uint8 tensors, [R_shard] eps tensors), each on its entry's
    device, for the entries this process runs (graphtyper_tpu/parallel/mesh.py:54)."""
    n = mesh.size
    pad = (-read_codes.shape[0]) % n
    if pad:
        read_codes = np.concatenate([read_codes, np.full((pad, read_codes.shape[1]), 5, dtype=read_codes.dtype)])
        eps = np.concatenate([eps, np.zeros(pad, dtype=eps.dtype)])
    reads_t = torch.tensor_split(torch.from_numpy(np.ascontiguousarray(read_codes)), n)
    eps_t = torch.tensor_split(torch.from_numpy(np.ascontiguousarray(eps)), n)
    entries = mesh.local_entries()
    return [reads_t[i].to(d) for i, d in entries], [eps_t[i].to(d) for i, d in entries]


def sharded_genotype_step(mesh: Mesh, max_mismatches: int = 10):
    """The genotyping step over the mesh: each entry runs `genotype_forward`
    on its read shard against the replicated haplotype bank, and the score
    deltas and per-allele depths are summed over the mesh. The returned
    step takes `shard_reads`' two lists and host arrays or tensors of the
    bank; it returns (delta [A, A], depth [A]) on this process's first
    device (graphtyper_tpu/parallel/mesh.py:32)."""

    def step(read_shards, hap_codes, hap_allele, eps_shards):
        delta = depth = None
        for reads, eps in zip(read_shards, eps_shards):
            dev = reads.device
            d, B = genotype_forward(reads, torch.as_tensor(hap_codes, device=dev),
                                    torch.as_tensor(hap_allele, device=dev), eps, max_mismatches)
            if delta is None:
                delta, depth = d, B.sum(dim=0)
            else:
                delta = delta + d.to(delta.device)
                depth = depth + B.sum(dim=0).to(depth.device)
        return mesh.host_sum(delta), mesh.host_sum(depth)

    return step
