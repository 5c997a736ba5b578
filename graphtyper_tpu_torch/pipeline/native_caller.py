"""The native pooled caller feeding the port's device scorer.

Forks of the two entries of graphtyper_tpu/pipeline/native_caller.py that
construct a SiteScorer: `run_native_call_pool_bam` (:443) and
`run_native_call_pool_stream` (:981). The C++ engine, the prepared-pool
cache and the result marshalling are the JAX package's, imported. The
device seeding and device alignment hooks (default off there, :373-391)
are not ported yet: turning either on raises NotImplementedError. Neither
is the rep-sharded oracle nor the mesh key.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from graphtyper_tpu.io.native import get_lib, native_thread_count
from graphtyper_tpu.pipeline.native_caller import (
    _bam_header_streaming,
    _consume_call_result,
    _device_seed_enabled,
    _feed_obs,
    _get_prep,
    _setup_lib,
    _setup_stream,
    device_align_mode,
)
from graphtyper_tpu_torch.typer.scoring import SiteScorer


def _refuse_device_hooks(opts, is_sv: bool) -> None:
    """The JAX package runs these hooks on non-SV pools only."""
    if is_sv:
        return
    if _device_seed_enabled(opts):
        raise NotImplementedError("device_seed is not ported to the torch package yet")
    if device_align_mode(opts) in ("on", "verify"):
        raise NotImplementedError("device_align is not ported to the torch package yet")


def _graph_site_arrays(graph, scorer):
    sites = scorer.sites
    return (
        np.array([s.gt.id for s in sites], dtype=np.int64),
        np.array([s.gt.num for s in sites], dtype=np.int64),
        np.array([1 if graph.is_snp(s.gt) else 0 for s in sites], dtype=np.uint8),
    )


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def run_native_call_pool_bam(
    graph,
    index,
    hts_paths: list[str],
    region,
    device: torch.device | str,
    sam_flag_filter: int = 3840,
    force_both: bool = False,
    hq_reads: bool = False,
    n_threads: int = 0,
    avg_cov: list | None = None,
    ref_path: str | None = None,
):
    """Fork of graphtyper_tpu/pipeline/native_caller.py:443: BAM bytes
    straight into the C++ pooled loop, observation rows into the port's
    scorer on `device`. Returns (sample_names, scorer, num_records,
    num_duplicated, reference_depth) or None when the pool needs the object
    path (non-BAM input, multi-sample files, no region)."""
    if region is None or not all(p.endswith((".bam", ".cram")) for p in hts_paths):
        return None
    lib = get_lib()
    if lib is None:
        return None
    _setup_lib(lib)

    from graphtyper_tpu.config import current_options

    is_sv = graph.is_sv_graph
    _refuse_device_hooks(current_options(), is_sv)

    # SV pools read only the region's overlaps (the reference's iterator
    # semantics); SNP pools run on bamshrink output that is already sliced
    entry = _get_prep(
        lib, hts_paths, region, sam_flag_filter, force_both,
        position_filter=is_sv, ref_path=ref_path,
    )
    if entry is None:
        return None
    sample_names = entry.sample_names
    scorer = SiteScorer(graph, sample_names, device, hq_reads=hq_reads)

    from graphtyper_tpu.typer.native_align import NativeAligner, seed_filter_handle

    na = NativeAligner(graph, index)
    site_order, site_cnum, site_is_snp = _graph_site_arrays(graph, scorer)
    if n_threads <= 0:
        n_threads = native_thread_count()

    n_obs = ctypes.c_int64()
    n_xvals = ctypes.c_int64()
    n_conn = ctypes.c_int64()
    n_counts = ctypes.c_int64()
    n_touched = ctypes.c_int64()
    ptr = _ptr
    graph_site_index_args = (
        ptr(na.ref_order), ptr(na.ref_dna_start), ptr(na.ref_dna_len),
        ptr(na.ref_var_first), len(na.ref_order), ptr(na.ref_arena),
        ptr(na.var_order), ptr(na.var_dna_start), ptr(na.var_dna_len),
        ptr(na.var_out_ref), len(na.var_order), ptr(na.var_arena),
        ptr(na.sp_ref_reach), ptr(na.sp_actual), len(na.sp_ref_reach),
        ptr(site_order), ptr(site_cnum), ptr(site_is_snp), len(site_order),
        ptr(na.keys), len(na.keys), ptr(na.offsets),
        ptr(na.lab_start), ptr(na.lab_end), ptr(na.lab_var),
    )
    outs = (
        ctypes.byref(n_obs), ctypes.byref(n_xvals), ctypes.byref(n_conn),
        ctypes.byref(n_counts), ctypes.byref(n_touched),
    )
    reference_depth = None
    if is_sv:
        if avg_cov is not None and len(avg_cov) != len(sample_names):
            return None  # per-file list vs sample count mismatch: object path
        from graphtyper_tpu.pipeline.caller import ReferenceDepth

        reference_depth = ReferenceDepth(graph, len(sample_names))
        avg_arr = (
            np.ascontiguousarray(avg_cov, dtype=np.float64) if avg_cov is not None else None
        )
        handle = lib.gt_call_finish_sv(
            entry.handle,
            *graph_site_index_args,
            len(sample_names), 1 if hq_reads else 0, n_threads,
            seed_filter_handle(index, lib, n_threads),
            ptr(avg_arr) if avg_arr is not None else None,
            ptr(reference_depth.depths), reference_depth.depths.shape[1],
            int(reference_depth.reference_offset),
            *outs,
        )
    else:
        handle = lib.gt_call_finish(
            entry.handle,
            *graph_site_index_args,
            None, 0,  # no device seed candidates
            None, 0,  # no device verdict rows
            *([None] * 12),  # no rep-sharded results
            len(sample_names), 1 if hq_reads else 0, n_threads,
            seed_filter_handle(index, lib, n_threads),
            *outs,
        )
    stats = _consume_call_result(
        lib, handle, scorer, len(sample_names), n_obs, n_xvals, n_conn, n_counts, n_touched
    )
    if stats is None:
        return None
    return sample_names, scorer, stats[0], stats[1], reference_depth


def run_native_call_pool_stream(
    graph,
    index,
    hts_paths: list[str],
    region,
    device: torch.device | str,
    sam_flag_filter: int = 3840,
    force_both: bool = False,
    hq_reads: bool = False,
    n_threads: int = 0,
    batch_records: int = 1 << 18,
    avg_cov: list | None = None,
    stream_spill: str | None = None,
):
    """Fork of graphtyper_tpu/pipeline/native_caller.py:981: the
    bounded-memory pooled call (BGZF stream + heap merge, fixed-size batches)
    with every batch's observation rows drained into the port's scorer on
    `device`. Same spill/replay protocol and return value as the JAX
    package's; None to fall back to the in-memory path."""
    if region is None or not all(p.endswith(".bam") for p in hts_paths):
        return None
    lib = get_lib()
    if lib is None:
        return None
    _setup_lib(lib)
    _setup_stream(lib)

    sample_names: list[str] = []
    for path in hts_paths:
        meta = _bam_header_streaming(path)
        if meta is None:
            return None
        _ref_names, samples = meta
        if not samples:
            samples = [path.rsplit("/", 1)[-1].split(".")[0]]
        if len(samples) > 1:
            return None
        sample_names.append(samples[0])

    is_sv = bool(graph.is_sv_graph)
    if is_sv and avg_cov is not None and len(avg_cov) != len(sample_names):
        return None  # per-file coverage list vs sample count mismatch

    from graphtyper_tpu.config import current_options
    from graphtyper_tpu.typer.native_align import NativeAligner, seed_filter_handle

    _refuse_device_hooks(current_options(), is_sv)
    scorer = SiteScorer(graph, sample_names, device, hq_reads=hq_reads)
    na = NativeAligner(graph, index)
    site_order, site_cnum, site_is_snp = _graph_site_arrays(graph, scorer)
    if n_threads <= 0:
        n_threads = native_thread_count()

    path_bytes = [p.encode() for p in hts_paths]
    path_arr = (ctypes.c_char_p * len(path_bytes))(*path_bytes)
    sample_idx = np.arange(len(hts_paths), dtype=np.int32)
    ptr = _ptr

    reference_depth = None
    avg_arr = None
    if is_sv:
        from graphtyper_tpu.pipeline.caller import ReferenceDepth

        reference_depth = ReferenceDepth(graph, len(sample_names))
        if avg_cov is not None:
            avg_arr = np.ascontiguousarray(avg_cov, dtype=np.float64)
    handle = lib.gt_stream_open(
        ctypes.cast(path_arr, ctypes.c_void_p), ptr(sample_idx), len(hts_paths),
        region.chr.encode(),
        len(sample_names), sam_flag_filter, 1 if force_both else 0, 1 if hq_reads else 0,
        n_threads, batch_records, len(scorer.sites),
        int(region.begin) if is_sv else -1, int(region.end) if is_sv else -1,
        1 if is_sv else 0,
        ptr(avg_arr) if avg_arr is not None else None,
        ptr(reference_depth.depths) if reference_depth is not None else None,
        reference_depth.depths.shape[1] if reference_depth is not None else 0,
        int(reference_depth.reference_offset) if reference_depth is not None else 0,
    )
    if not handle:
        return None

    if stream_spill and hasattr(lib, "gt_stream_spill"):
        import json as _json
        import os as _os

        key = {
            "v": 1,
            "paths": [
                [_os.path.abspath(p), _os.stat(p).st_mtime_ns, _os.stat(p).st_size]
                for p in hts_paths
            ],
            "chr": region.chr,
            "sv_filter": [int(region.begin), int(region.end)] if is_sv else None,
        }
        keyfile = stream_spill + ".key"
        valid = False
        if _os.path.exists(stream_spill) and _os.path.exists(keyfile):
            try:
                with open(keyfile) as f:
                    valid = _json.load(f) == key
            except (OSError, ValueError):
                valid = False
        mode = 2 if valid else 1
        if mode == 1:
            # spill ≈ decompressed record bytes ≈ 4x the BGZF input; only
            # write when it fits comfortably (the stream works without it)
            try:
                st = _os.statvfs(_os.path.dirname(stream_spill) or ".")
                free = st.f_bavail * st.f_frsize
            except OSError:
                free = 0
            if 4 * sum(k[2] for k in key["paths"]) > free // 2:
                mode = 0
        if mode and lib.gt_stream_spill(handle, stream_spill.encode(), mode) and mode == 1:
            with open(keyfile, "w") as f:
                _json.dump(key, f)

    n_obs = ctypes.c_int64()
    n_xvals = ctypes.c_int64()
    gargs = (
        ptr(na.ref_order), ptr(na.ref_dna_start), ptr(na.ref_dna_len),
        ptr(na.ref_var_first), len(na.ref_order), ptr(na.ref_arena),
        ptr(na.var_order), ptr(na.var_dna_start), ptr(na.var_dna_len),
        ptr(na.var_out_ref), len(na.var_order), ptr(na.var_arena),
        ptr(na.sp_ref_reach), ptr(na.sp_actual), len(na.sp_ref_reach),
        ptr(site_order), ptr(site_cnum), ptr(site_is_snp), len(site_order),
        ptr(na.keys), len(na.keys), ptr(na.offsets),
        ptr(na.lab_start), ptr(na.lab_end), ptr(na.lab_var),
        seed_filter_handle(index, lib, n_threads),
    )
    try:
        while True:
            rc = lib.gt_stream_step(
                handle, *gargs, None, 0, ctypes.byref(n_obs), ctypes.byref(n_xvals),
            )
            if rc == 0:
                break
            if rc < 0:  # spill replay inconsistency: discard and re-stream
                # (the enclosing finally frees this handle)
                import os as _os

                for junk in (stream_spill, stream_spill + ".key"):
                    try:
                        _os.remove(junk)
                    except OSError:
                        pass
                return run_native_call_pool_stream(
                    graph, index, hts_paths, region, device,
                    sam_flag_filter=sam_flag_filter, force_both=force_both,
                    hq_reads=hq_reads, n_threads=n_threads,
                    batch_records=batch_records, avg_cov=avg_cov,
                    stream_spill=None,
                )
            N = n_obs.value
            o_site = np.zeros(N, dtype=np.int32)
            o_sample = np.zeros(N, dtype=np.int32)
            o_eps = np.zeros(N, dtype=np.int32)
            o_apply = np.zeros(N, dtype=np.uint8)
            o_bits_lo = np.zeros(N, dtype=np.uint32)
            o_bits_hi = np.zeros(N, dtype=np.uint32)
            o_cov = np.zeros(N, dtype=np.int32)
            o_clip_scaled = np.zeros(N, dtype=np.int32)
            o_clip_flag = np.zeros(N, dtype=np.uint8)
            o_mapq_sq = np.zeros(N, dtype=np.int32)
            o_mm_scaled = np.zeros(N, dtype=np.int32)
            o_sdiff = np.zeros(N, dtype=np.int32)
            o_strand = np.zeros(N, dtype=np.uint8)
            o_proper = np.zeros(N, dtype=np.uint8)
            o_big = np.zeros(N, dtype=np.uint8)
            x_count = np.zeros(N, dtype=np.int32)
            x_vals = np.zeros(n_xvals.value, dtype=np.uint16)
            lib.gt_stream_fetch_obs(
                handle,
                ptr(o_site), ptr(o_sample), ptr(o_eps), ptr(o_apply),
                ptr(o_bits_lo), ptr(o_bits_hi), ptr(o_cov),
                ptr(o_clip_scaled), ptr(o_clip_flag), ptr(o_mapq_sq), ptr(o_mm_scaled),
                ptr(o_sdiff), ptr(o_strand), ptr(o_proper), ptr(o_big),
                ptr(x_count), ptr(x_vals),
            )
            _feed_obs(
                scorer, site_cnum,
                o_site, o_sample, o_eps, o_apply, o_bits_lo, o_bits_hi, o_cov,
                o_clip_scaled, o_clip_flag, o_mapq_sq, o_mm_scaled, o_sdiff,
                o_strand, o_proper, o_big, x_count, x_vals,
            )
            scorer.batcher.maybe_flush()
        n_conn = ctypes.c_int64()
        n_counts = ctypes.c_int64()
        n_touched = ctypes.c_int64()
        res = lib.gt_stream_finish(
            handle,
            ptr(na.ref_order), ptr(na.ref_dna_start), ptr(na.ref_dna_len),
            ptr(na.ref_var_first), len(na.ref_order), ptr(na.ref_arena),
            ptr(na.var_order), ptr(na.var_dna_start), ptr(na.var_dna_len),
            ptr(na.var_out_ref), len(na.var_order), ptr(na.var_arena),
            ptr(na.sp_ref_reach), ptr(na.sp_actual), len(na.sp_ref_reach),
            ptr(site_order), ptr(site_cnum), ptr(site_is_snp), len(site_order),
            ctypes.byref(n_obs), ctypes.byref(n_xvals), ctypes.byref(n_conn),
            ctypes.byref(n_counts), ctypes.byref(n_touched),
        )
    finally:
        lib.gt_stream_free(handle)
    stats = _consume_call_result(
        lib, res, scorer, len(sample_names), n_obs, n_xvals, n_conn, n_counts, n_touched
    )
    if stats is None:
        return None
    return sample_names, scorer, stats[0], stats[1], reference_depth
