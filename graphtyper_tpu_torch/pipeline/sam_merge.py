"""Merge coordinate-sorted SAM/BAM files into one multi-sample BAM.

Port of the reference's sam_merge (hts_parallel_reader.cpp:1224-1253) and the
chunked merging policy run_samtools_merge (genotype.cpp:174-260): with very
large cohorts (>= 200 samples per worker), bamshrunk per-sample files are
merged in chunks of <= 10 so downstream pool readers open far fewer file
handles. Sample identity survives the merge through @RG lines (one per
sample, reads tagged with their RG), which pipeline/caller.read_pool_records
resolves back to per-sample indices.
"""

from __future__ import annotations

import heapq
import os

from graphtyper_tpu_torch.io.bam import BamHeader, read_alignments
from graphtyper_tpu_torch.io.bam_writer import write_bam
from graphtyper_tpu_torch.utils.log import get_logger


def sam_merge(output_bam: str, input_paths: list[str], remove_inputs: bool = False) -> None:
    """Heap-merge coordinate-sorted inputs into output_bam with a combined
    header (hts_parallel_reader.cpp:1224). The reference always unlinks its
    inputs (they are its own temp files); here deletion is opt-in."""
    assert input_paths
    inputs = []
    ref_names: list[str] | None = None
    ref_lengths: list[int] | None = None
    rg_lines: list[str] = []
    for i, path in enumerate(input_paths):
        header, reads = read_alignments(path, parse_tags=True)
        if ref_names is None:
            ref_names, ref_lengths = header.ref_names, header.ref_lengths
        elif header.ref_names != ref_names:
            raise ValueError(f"sam_merge: reference dictionaries differ: {path}")
        if header.sample_names:
            sample = header.sample_names[0]
        else:
            sample = path.rsplit("/", 1)[-1].split(".")[0]
        rg_id = f"rg{i}"
        rg_lines.append(f"@RG\tID:{rg_id}\tSM:{sample}")
        for r in reads:
            r.tags["RG"] = rg_id
        inputs.append(reads)
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "\n".join(rg_lines) + "\n"
    header = BamHeader(text=text, ref_names=ref_names or [], ref_lengths=ref_lengths or [])
    header.parse_read_groups()
    merged = list(
        heapq.merge(*inputs, key=lambda r: (r.ref_id if r.ref_id >= 0 else 1 << 30, r.pos))
    )
    write_bam(output_bam, header, merged)
    if remove_inputs:
        for path in input_paths:
            try:
                os.unlink(path)
            except OSError:
                get_logger().warning("sam_merge: unable to remove %s", path)


def run_sam_merge(
    shrinked_sams: list[str], tmp: str, options, remove_inputs: bool = False
) -> list[str]:
    """Chunked merge policy (genotype.cpp:174-260): merge when sam merging is
    allowed, all files fit under max_files_open, and there are >= 200 samples
    per thread. Chunk size is min(10, n/threads/100). Returns the (possibly
    new) list of input files."""
    n = len(shrinked_sams)
    threads = max(1, getattr(options, "threads", 1))
    if not (
        getattr(options, "is_sam_merging_allowed", True)
        and getattr(options, "max_files_open", 864) > n
        and n // threads >= 200
    ):
        return shrinked_sams
    chunk = min(10, n // threads // 100)
    if chunk <= 1:
        return shrinked_sams
    get_logger().info("Merging input files.")
    os.makedirs(os.path.join(tmp, "bams"), exist_ok=True)
    out: list[str] = []
    for i in range(0, n, chunk):
        group = shrinked_sams[i : i + chunk]
        if len(group) == 1:
            out.append(group[0])
        else:
            path = os.path.join(tmp, "bams", f"merged{i // chunk:05d}.bam")
            # only delete inputs when they are this run's own temp copies
            # (the reference merges its bamshrunk temp files,
            # genotype.cpp:174); caller-owned paths are never removed
            sam_merge(path, group, remove_inputs=remove_inputs)
            out.append(path)
    get_logger().info("Finished merging into %d files.", len(out))
    return out
