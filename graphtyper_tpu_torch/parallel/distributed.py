"""Multi-process orchestration over torch.distributed: regions sharded over
hosts, and one region's samples sharded over hosts.

Port of graphtyper_tpu/parallel/distributed.py. The process group is gloo:
every payload that crosses processes here is host bytes (pickled partials,
batched pool VCFs, phasing maps), and gloo also lets two ranks share one
GPU, which NCCL refuses. `initialize` brings the group up with a finite
timeout, so that a missing peer raises instead of hanging. Without a group
(one process) `num_hosts()` is 1 and `host_id()` 0, and every collective is
the identity. Meshes over the local devices and over the hosts come from
`host_mesh` and `global_mesh` (parallel/mesh.py's `Mesh`).

- `assign_regions` / `genotype_regions_distributed`: each host genotypes a
  contiguous share of the regions; the union of the hosts' region-structured
  outputs is the whole result (the reference's per-process region ranges,
  main.cpp:30-58).
- `genotype_distributed`: one region, the samples sharded over hosts; the
  per-iteration pool results gather over the group and merge through the
  same code as the in-process multi-pool path, so host 0's VCF is the
  single-process VCF byte for byte.
"""

from __future__ import annotations

import os
import pickle
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from graphtyper_tpu_torch.parallel.mesh import Mesh, make_mesh

#: seconds a collective waits for a peer before it raises
TIMEOUT_S = 300


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the gloo process group of `num_processes` processes at
    `coordinator_address` (host:port; rank 0 listens there), as rank
    `process_id`. A no-op for one process. Without an address the group
    reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK from the environment
    (graphtyper_tpu/parallel/distributed.py:30)."""
    if num_processes is not None and num_processes <= 1:
        return
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=timedelta(seconds=TIMEOUT_S),
    )


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if _group_up():
        dist.destroy_process_group()


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def num_hosts() -> int:
    return dist.get_world_size() if _group_up() else 1


def host_id() -> int:
    return dist.get_rank() if _group_up() else 0


def assign_regions(regions: list, n_hosts: int | None = None, host: int | None = None) -> list:
    """Deterministic contiguous split of the region list for this host.

    Contiguous (not round-robin) so each host touches a minimal span of the
    reference and BAM files — locality mirrors the reference's per-process
    region ranges (main.cpp:30-58)."""
    n_hosts = n_hosts if n_hosts is not None else num_hosts()
    host = host if host is not None else host_id()
    if n_hosts <= 1:
        return list(regions)
    if not (0 <= host < n_hosts):
        raise ValueError(f"host {host} not in [0, {n_hosts})")
    bounds = np.linspace(0, len(regions), n_hosts + 1).astype(int)
    return list(regions[bounds[host] : bounds[host + 1]])


def host_mesh(axis: str = "data", devices=None) -> Mesh:
    """Mesh over this process's devices (all CUDA devices by default)."""
    return make_mesh(axis=axis, devices=devices)


def global_mesh(host_axis: str = "host", data_axis: str = "data", devices=None) -> Mesh:
    """(host, data) mesh: one row a process of the group, each row this
    process's devices (all CUDA devices by default). Reductions over the
    host axis go through the group; with one process the host axis has
    size 1."""
    local = list(make_mesh(devices=devices).devices)
    n = num_hosts()
    return Mesh([local] * n, (host_axis, data_axis), group=dist.group.WORLD if n > 1 else None)


def genotype_regions_distributed(
    ref_path: str,
    sams: list[str],
    regions: list[str],
    output_path: str,
    device: torch.device | str,
    n_hosts: int | None = None,
    host: int | None = None,
    **kw,
) -> list[str]:
    """Genotype this host's share of the regions on `device` (the cross-host
    form of genotype_regions). The host comes from the process group when
    one is up; pass n_hosts/host to run reference-style independent
    processes without one. All hosts write into the same region-structured
    output tree (graphtyper_tpu/parallel/distributed.py:84)."""
    from graphtyper_tpu_torch.pipeline.genotype import genotype_regions

    outs: list[str] = []
    for region in assign_regions(regions, n_hosts, host):
        outs.extend(genotype_regions(ref_path, sams, region, output_path, device, **kw))
    return outs


# ---------------------------------------------------------------------------
# Cross-host cohort genotyping: samples sharded over hosts, one region
# ---------------------------------------------------------------------------


def _allgather_bytes(payload: bytes) -> list[bytes]:
    """One byte string from every process, in rank order: the sizes first,
    then the payloads padded to the longest as uint8 tensors."""
    if num_hosts() <= 1:
        return [payload]
    n = num_hosts()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(sizes, torch.tensor([len(payload)], dtype=torch.int64))
    m = max(1, max(int(s) for s in sizes))
    buf = torch.zeros(m, dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    gathered = [torch.empty(m, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(gathered, buf)
    return [g[: int(s)].numpy().tobytes() for g, s in zip(gathered, sizes)]


class DiscoveryDist:
    """Distribution hooks for streamlined_discovery: contiguous file
    ownership per host, partials allgather, and sequential realignment
    state rounds (see typer/discovery.py)."""

    def __init__(self, n_files: int, n_hosts: int | None = None, host: int | None = None):
        self.n_hosts = n_hosts if n_hosts is not None else num_hosts()
        self.host = host if host is not None else host_id()
        bounds = np.linspace(0, n_files, self.n_hosts + 1).astype(int)
        self.lo = int(bounds[self.host])
        self.hi = int(bounds[self.host + 1])

    def owns(self, file_i: int) -> bool:
        return self.lo <= file_i < self.hi

    def allgather(self, obj):
        return [pickle.loads(b) for b in _allgather_bytes(pickle.dumps(obj))]

    def sync_state(self, file_i: int, state):
        """One realignment round: the owner contributes the post-realign
        event state; everyone receives it."""
        payload = pickle.dumps(state) if state is not None else b""
        parts = [b for b in _allgather_bytes(payload) if b]
        if state is not None:
            return state
        return pickle.loads(parts[0])


def genotype_distributed(
    ref_path: str,
    sams: list[str],
    region_str: str,
    output_path: str,
    device: torch.device | str,
    avg_cov_by_readlen: list[float] | None = None,
    is_extra_call_only_iteration: bool = False,
    output_all_variants: bool = False,
) -> str | None:
    """The discovery and call iterations of one region on `device` with the
    SAMPLES sharded over the process group's hosts — the cross-host form of
    the reference's pool-file merge (src/typer/vcf_operations.cpp:20-142).
    Each host bamshrinks and calls only its sample shard. In the non-last
    call iterations the hosts allgather their VarStats partials and fold
    them, so every host computes the same sites list; in the last, host 0
    merges the hosts' batched pool VCFs and phasing maps and writes the
    outputs, byte-identical to a single-process `genotype`. Host 0 returns
    the output path, the other hosts None. GT_REP_SHARD=1 splits the align
    work of each call iteration over the hosts (parallel/rep_shard.py).
    Fork of graphtyper_tpu/parallel/distributed.py:164."""
    import shutil
    import tempfile

    from graphtyper_tpu_torch.config import current_options
    from graphtyper_tpu_torch.graph.build import construct_graph
    from graphtyper_tpu_torch.graph.coords import AbsolutePosition, GenomicRegion
    from graphtyper_tpu_torch.index.build import index_graph
    from graphtyper_tpu_torch.io.fasta import FastaFile
    from graphtyper_tpu_torch.pipeline.caller import call_pools
    from graphtyper_tpu_torch.pipeline.vcf_operations import (
        merge_ph_maps,
        vcf_merge_and_break,
        vcf_merge_and_filter,
        vcf_merge_streamed,
    )
    from graphtyper_tpu_torch.typer.discovery import streamlined_discovery
    from graphtyper_tpu_torch.typer.vcf_out import VcfOutput

    device = torch.device(device)
    n_hosts = num_hosts()
    host = host_id()

    bounds = np.linspace(0, len(sams), n_hosts + 1).astype(int)
    lo, hi = int(bounds[host]), int(bounds[host + 1])
    my_sams = list(sams[lo:hi])
    my_cov = avg_cov_by_readlen[lo:hi] if avg_cov_by_readlen is not None else None

    region = GenomicRegion.parse(region_str)
    fasta = FastaFile(ref_path)
    if fasta.has_contig(region.chr):
        region.end = min(region.end, fasta.contig_length(region.chr))
    padded = GenomicRegion(region.chr, region.begin, region.end)
    padded.pad(1000)
    if fasta.has_contig(region.chr):
        padded.end = min(padded.end, fasta.contig_length(region.chr))
    contigs = list(fasta.contigs)
    abs_pos = AbsolutePosition(contigs)
    fasta.close()

    tmp = tempfile.mkdtemp(prefix=f"gt_dist_h{host}_")
    if host == 0:
        os.makedirs(output_path, exist_ok=True)
        os.makedirs(os.path.join(output_path, region.chr), exist_ok=True)
        os.makedirs(os.path.join(output_path, "input_sites", region.chr), exist_ok=True)

    if not current_options().no_bamshrink:
        from graphtyper_tpu_torch.pipeline.bamshrink import run_bamshrink

        my_sams = run_bamshrink(my_sams, padded, tmp, my_cov, current_options())

    # global path list: only owned entries are real paths on this host
    global_paths = [""] * len(sams)
    for i, p in enumerate(my_sams):
        global_paths[lo + i] = p

    # ---- iteration 1: distributed discovery --------------------------------
    dist_hooks = DiscoveryDist(len(sams))
    sample_names: list[str] = []
    sites_vcf = streamlined_discovery(
        global_paths, ref_path, padded.to_string(), sample_names, device, dist=dist_hooks
    )
    it1_final = os.path.join(tmp, "it1_final.vcf.gz")
    sites_vcf.write(it1_final, contigs, abs_pos, filter_zero_qual=False, is_dropping_genotypes=True)

    def gather_merge(result):
        """Pool results of all hosts -> (merged VcfOutput, merged ph) on
        host 0; (None, None) elsewhere. Every host contributes its shard's
        batched pool bytes and pickled ph map; only host 0 merges."""
        local = os.path.join(tmp, "pool_local.vcfb")
        result.vcf.save_batched(local)
        with open(local, "rb") as f:
            payload = f.read()
        vcfb_all = _allgather_bytes(payload)
        ph_all = [pickle.loads(b) for b in _allgather_bytes(pickle.dumps(result.ph))]
        if host != 0:
            return None, None
        paths = []
        for i, b in enumerate(vcfb_all):
            p = os.path.join(tmp, f"pool_h{i}.vcfb")
            with open(p, "wb") as f:
                f.write(b)
            paths.append(p)
        names, variants = vcf_merge_streamed(paths)
        merged = VcfOutput(sample_names=names, variants=list(variants))
        return merged, merge_ph_maps(ph_all)

    def gather_stats_reduce(result):
        """Non-last-iteration reduction: the iteration handoff
        (vcf_merge_and_filter) consumes only per-variant cohort aggregates,
        the VarStats accumulators (an order-free sum/max per sample,
        variant.cpp:230-330) and the phasing map. Each host scans its own
        sample shard; the collective ships O(variants) stats partials, and
        every host folds them in host order into the same sites list."""
        from graphtyper_tpu_torch.typer.native_finisher import scan_variants

        variants = result.vcf.variants
        unhandled = scan_variants(variants, len(result.vcf.sample_names))
        for v in unhandled:
            v.scan_calls()
        payload = pickle.dumps([v.stats for v in variants])
        stats_all = [pickle.loads(b) for b in _allgather_bytes(payload)]
        ph_all = [pickle.loads(b) for b in _allgather_bytes(pickle.dumps(result.ph))]
        for h, stats_list in enumerate(stats_all):
            if h == host:
                continue
            if len(stats_list) != len(variants):
                raise RuntimeError("cross-host variant skeletons diverged")
            for v, st in zip(variants, stats_list):
                v.stats.add_stats(st)
        for v in variants:
            v.calls = []  # stats carry everything the handoff needs
        result.vcf.sample_names = list(sample_names)
        return result.vcf, merge_ph_maps(ph_all)

    FIRST, LAST = 2, 3 + (1 if is_extra_call_only_iteration else 0)
    prev_vcf = it1_final
    out_vcf_path = os.path.join(tmp, "graphtyper.vcf.gz")
    prev_index = None
    for i in range(FIRST, LAST + 1):
        is_last = i == LAST
        graph = construct_graph(
            ref_path, prev_vcf, padded.to_string(), is_sv_graph=False, use_index=True,
            add_all_variants=True,
        )
        # successive iterations share the reference-backbone k-mers, so the
        # seed filter carries over additively (the donor chain of genotype())
        index = index_graph(graph, seed_filter_donor=prev_index)
        prev_index = index
        # rep-sharded align exchange (GT_REP_SHARD=1, parallel/rep_shard.py):
        # hosts split the cohort's deduplicated oriented-sequence space
        rep_oracle = None
        if os.environ.get("GT_REP_SHARD", "") == "1" and n_hosts > 1:
            from graphtyper_tpu_torch.parallel import rep_shard
            from graphtyper_tpu_torch.pipeline.caller import SAM_FLAG_FILTER, split_pools

            union_key = (padded.to_string(), tuple(my_sams))
            if rep_shard._LOCAL_CACHE.get(union_key) is None:
                my_seqs = rep_shard.local_row_seqs(
                    split_pools(my_sams), padded, SAM_FLAG_FILTER, ref_path=ref_path
                )
            else:  # reads are iteration-invariant: partition cached
                my_seqs = np.zeros((0, 0), dtype=np.uint8)
            rep_oracle = rep_shard.build_oracle(
                graph, index, my_seqs, _allgather_bytes, n_hosts, host, union_key=union_key,
            )
        result = call_pools(
            graph, index, my_sams, device,
            region=padded,
            avg_cov_by_readlen=my_cov,
            is_writing_calls_vcf=is_last,
            is_writing_hap=not is_last,
            ref_path=ref_path,
            rep_oracle=rep_oracle,
        )
        if not is_last:
            merged_vcf, merged_ph = gather_stats_reduce(result)
            next_vcf = os.path.join(tmp, f"it{i}_final.vcf.gz")
            vcf_merge_and_filter([merged_vcf], next_vcf, merged_ph, graph)
            prev_vcf = next_vcf
            continue
        merged_vcf, merged_ph = gather_merge(result)
        if host == 0:
            # only host 0 emits output: the final merge/decompose is sink work
            vcf_merge_and_break(
                [merged_vcf], out_vcf_path, region.to_string(), graph,
                filter_zero_qual=output_all_variants,
            )

    dst = None
    if host == 0:
        sites_dst = os.path.join(output_path, "input_sites", region.to_file_string() + ".vcf.gz")
        shutil.copyfile(prev_vcf, sites_dst)
        final_name = f"{region.begin + 1:09d}-{region.end:09d}.vcf.gz"
        dst = os.path.join(output_path, region.chr, final_name)
        shutil.copyfile(out_vcf_path, dst)
        for ext in (".tbi", ".csi"):
            if os.path.exists(out_vcf_path + ext):
                shutil.copyfile(out_vcf_path + ext, dst + ext)
    shutil.rmtree(tmp, ignore_errors=True)
    return dst
