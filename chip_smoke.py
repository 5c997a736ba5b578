"""Smoke run of the torch port on one NVIDIA GPU: python3 chip_smoke.py

Phases, one line each, none of them caught:
  1. card     nvidia-smi name and power limit, torch's CUDA version
  2. kernels  build the CUDA kernels from graphtyper_tpu_torch/csrc
     engine   build the C++ engine from native/*.cpp (io/native.py)
     empty    CUDA-event time of a one-element torch op (an empty launch)
  3. kernel   sw_align_rot (the wavefront CUDA kernel) against sw_align_plain
              on the card, exactly, at 4096 pairs x 192 x 512, at the main
              path's batch of 6 pairs, on the tie, length-edge, empty and
              E-scan tie batches, on a 576-column window with a 30 bp
              insertion and on queries of two 256-row bands; CUDA-event
              times of both
     row      sw_align_pallas (the row-scan CUDA kernel) against
              sw_align_plain on the card, exactly, at 4096 x 192 x 512, at
              the bench tool's 4096 x 152 x 256, at 1, 6, 40 and 4096 pairs
              x 151 x 506, and on the tie, length-edge, empty and E-scan tie
              batches (strip widths 1 to 16); sw_align_rot on all of those
              and on the two long batches; CUDA-event times of both kernels
              and the plain version, the bound, and sw_rot's latency floor
              modelled from assumed latencies (printed on this line only)
     rows     sw_align_rot at R = 5 rows a lane (M = 151) against R = 8 (the
              same queries padded to one band) on CUDA events, and the
              wrapper's host time, at 1 and 40 pairs x 151 x 506
     realign  ops/sw.py align_batch whole (copies in, kernel, copy out) on a
              host timer at 1, 6 and 40 pairs, beside the kernel's time
     bench    python -m graphtyper_tpu_torch.tools.bench_sw --row, then
              --rot, each in a subprocess: parity with the C++ engine's
              host DP and Gcell/s; the --row run is the row kernel's path
  4. slice    `genotype` through the port's CLI on the card, then the same
              CLI with --device cpu (the plain PyTorch versions) on the same
              input in a subprocess: equal md5 of the uncompressed VCFs.
              Two cohorts: 200 kb, 30x, 4 samples, error rate 0.01 (one CLI
              region loop of four 50 kb units over 4 region workers), and
              50 kb, 10x, 4 samples, error rate 0.02, whose VCF changes when
              the SW results are discarded, so a wrong kernel result shows
     capture  the 200 kb cohort's scoring flushes: genotype with the CLI's
              options at --threads 4, its region units in this process,
              flush_rows wrapped (tools/bench_scoring.capture_flushes); its
              launches are not counted as a main path's
     pools    more call pools at once than the prepared-pool cache holds:
              `genotype` on 8 single-sample files at --threads 8 (8 pools in
              8 threads), the SAM paths given positionally after the
              options; on cuda with the verdicts off and on, then on
              --device cpu with them on: one md5
  5. align    the call iterations' device-resident align stage on bench.py's
              shape (200 kb, 30x, 4 samples, error rate 0.001): the CLI on
              cuda with GT_DEVICE_ALIGN=on, off, and on with device_seed on,
              and on --device cpu with on in a subprocess (one md5); then in
              process on the region as one pool: call_pool in verify mode (0
              divergences, the clean share), the streaming caller in batches
              of 2^16 records in verify and on (its host run's state), and
              the warm call-iteration wall off, on, on, off; the kernels
              launched, no plain version on the card's runs
  6. sv       the other subcommands, each through the port's CLI on cuda in
     camou    this process, then with --device cpu in a subprocess: equal
     hla      md5 of the uncompressed VCFs, scoring (pileup for discover)
     discover rows on the card and no plain version. sv: genotype_sv on
              bench.py's SV workload (tools/bench_sv.py's 300 kb, 4-sample
              30x cohort, built by graphtyper_tpu_torch/tools/bench_sv.py)
              with --avg_cov_by_readlen, GT_DEVICE_ALIGN=on (SV pools skip
              the verdicts: 0 launches), in memory and in the streaming
              caller. camou: genotype_camou over two 25 kb intervals of a
              60 kb cohort at error rate 0.02, verdicts off and on (sw_rot
              launched; device_align launched in the on run). hla:
              genotype_hla --segment_fasta on the 120-allele IMGT-shaped
              panel of tests/pipeline/test_hla_imgt.py and its 12 truth
              samples (12/12 truth pairs called). discover: the discover
              subcommand on the sw cohort (sw_rot launched)
  7. verdict  device_align.cu against verdicts_plain, exactly, and seed
     seed     seed_probe.cu against probe_bits_plain, on the tests'
              adversarial batch, the align pool's rows and 2^19 rows drawn
              from them (and the verdicts on the arena-edge batch); CUDA-
              event times of both, the bound, and the random loads each
              kernel issues (the probes; verdict_gathers)
     gather   the card's rate of random 4-byte loads (csrc/gather.cu) from a
              table the size of the seed bitset and of the packed verdict
              tables: the measured gather ceiling, and each kernel's loads
              over it
     scoring  csrc/site_scoring.cu (apply_tier) against apply_tier_plain and
     pileup   csrc/discovery_pileup.cu (segment_counters) against
              segment_counters_plain on the card, exactly, on the
              adversarial rows of tests/test_torch_scoring_batches.py at
              every allele tier, at tools/bench_flush's four flush shapes
              (65,536 to 4,194,304 rows) at A 2 and A 64, the largest at A 2
              also sorted by segment and in one segment, at three pileup
              shapes, the largest also sorted and in one event, and at every
              captured flush (their rows histogram and tiers; the kernel's
              summed and median time); CUDA-event ms of kernel, plain
              version and the flush matrix's copy from pageable and from
              pinned memory, the byte bound, each call's device operations
              (torch.profiler) and its device time (a CUDA graph of
              back-to-back calls). The main paths' launches of both kernels (the
              slices, pools, align, the subcommands, mesh, dist, indep, fuzz
              and soak) must be above 0, with no plain version on the card
  8. mesh     graphtyper_tpu_torch.entry.dryrun_multichip(4): the whole
              genotype pipeline on an 8-sample 50 kb cohort with every call
              iteration's scoring over a 2 x 2 mesh of the card taken four
              times, against the single-device run (equal records); the
              scoring rows of each shard
     dist     two child processes joined by a gloo process group at
              127.0.0.1, both on the card with GT_DEVICE_ALIGN=on:
              genotype_distributed (samples sharded over the two) plain and
              with GT_REP_SHARD=1, host 0's VCF md5 equal to this process's
              single-process run; then the CLI's genotype --num_hosts 2
              --host_id 0|1 --coordinator on two 50 kb regions, the union of
              outputs equal to the single-process CLI; each child's sw_rot,
              device_align, apply_tier and segment_counters launches above
              0, and each run's sw_rot launches beside the run's work (its
              sample shard, or its region)
  9. forward  genotype_forward (ops/genotype_step.py) on the card against the
              same function on the CPU, exactly, at entry()'s 256 x 160 x 64
              x 8 and bench.py's 8192 x 160 x 512 x 16; CUDA-event ms a
              step, reads/s, mismatch_matrix and torch._int_mm alone, the
              bound, the CUDA kernels a step launches (torch.profiler)
     prefetch parallel/prefetch.py on the card: prefetch_to_device stages
              six batches of genotype_forward inputs through pinned memory
              on a side stream, and pipelined_map decodes six more on
              threads; each batch on cuda, in order, and genotype_forward
              on it at once equal to the CPU's on the same arrays
 10. indep    (after dist) CRAM input: two cohorts of utils/simulate_indep.py,
              bench.py's independent workload (120 kb, 30x, seed 9) and
              tests/pipeline/test_indep_workload.py's (40 kb, 28x, seed 11),
              each through the port's CLI on cuda in process and on
              --device cpu in a subprocess: one md5, no plain version on
              the card, sw_rot launched on the second (the first realigns
              nothing); write_crai on the first CRAM, read_crai, and
              crai_query over 40-80 kb returning every container with a
              record there
     fuzz     graphtyper_tpu_torch/tools/fuzz_diff.py's seed 1 on cuda: every
              leg (the Python caller and aligner, streaming, threads 1 and
              4, the host SW, BAI, CRAM, Python rANS, SAM, pooled regions,
              --vcf mode, popVCF, the SV axis, --device cpu,
              GT_DEVICE_ALIGN=on, device_seed on) equal to the seed's cuda
              run; each leg's wall
     soak     graphtyper_tpu_torch/tools/soak_population.py at 16 samples x
              120 kb x 10x with 4 region workers, in a subprocess on cuda
              with GT_SCORING_STATS set and on --device cpu: one md5, the
              peak tree RSS (this process's and the workers' apart),
              reads/s, and the telemetry's device_rows, device_wall_s and
              h2d_bytes
     benchtools  three measurement tools of graphtyper_tpu_torch/tools,
              each in a subprocess on cuda at a reduced size, all at once
              (their walls are not measurements): bench_flush at 262,144
              rows (the card's totals equal the CPU's), bench_lr --kb 50,
              and bench_distributed on 4 samples x 50 kb (two ranks' VCF
              equal to one process's, both modes); each must exit 0; one
              line a tool
The SW batches come from tests/test_torch_sw_batches.py, the verdict and
seed batches from tests/test_torch_device_align_batches.py, the HLA panel
from tests/test_torch_subcommand_data.py. VCF md5s are taken with the
##fileDate header line masked, so they compare across days. The tests
hold the port's CPU
path to the JAX package byte for byte (tests/test_torch_slice.py,
tests/test_torch_sw.py, tests/test_torch_device_align.py,
tests/test_torch_seed_probe.py, tests/test_torch_sv.py,
tests/test_torch_camou_hla.py, tests/test_torch_cli_tools.py,
tests/test_torch_forward.py, tests/test_torch_parallel*.py).
Then one JSON line of the kernels (launches on their paths, the new
subcommands' included, error, times,
bound; for sw_rot also its times and bounds per shape, the empty launch,
the align_batch times and the R = 5 / R = 8 times; for device_align and
seed_probe the times at 2^19 rows and per input, the measured gather
ceiling and the time it gives the kernel's loads; for apply_tier and
segment_counters the times at their largest shape and per shape, the
device operations and device time a call, and for apply_tier the
captured main-path flushes), and the
last line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero without a GPU, and outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import gzip
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SLICES = (  # (name, simulated cohort)
    ("200kb", dict(region_length=200_000, coverage=30.0, n_samples=4, read_length=151,
                   error_rate=0.01, seed=1, out_format="bam")),
    ("sw", dict(region_length=50_000, coverage=10.0, n_samples=4, read_length=151,
                error_rate=0.02, seed=2, out_format="bam")),
)
THREADS = 4
# more single-sample pools than the prepared-pool cache's 4, all at once
POOLS = dict(region_length=50_000, coverage=10.0, n_samples=8, read_length=151, error_rate=0.01, seed=6,
             out_format="bam")
POOL_THREADS = 8
KERNEL_SHAPE = (4096, 192, 512)  # pairs, query width (151 bp reads padded), window width
SMALL_BATCH = 6  # pairs in a typical realignment batch of the main path
PATH_SHAPE = (151, 506)  # a 151 bp read against a realignment window of the main path
PATH_BATCHES = (1, 6, 40, 4096)  # the main path sends 1-40 pairs a call
# int32 operations of one DP cell of the recurrence, counted from
# graphtyper_tpu/ops/sw_pallas.py:119-157 for a cell (i, j) with i <= qlen
# and j < dlen, the only cells whose values reach the output. Terms that
# depend on the row alone or the column alone (qb, d >= 4, d_valid,
# (j + 1) * ge, go + j * ge) are computed once, not per cell, and the masks
# row_active and d_valid are all true on these cells, so their selects
# (:122, :147-149), the or of :121 (qb >= 4 holds for a whole row) and the
# ands of :152 and :154 are choices made per row.
# Per cell: :120 compare, select (2); :121 select (1); :128 (1);
# :129-130 (2); :131 (1); :133 sub, sub, max (3); :134 (1); :135-136 (2);
# :138 add (1); :139 one step of a running max with its argument: compare,
# two selects (3); :142 sub (1); :143 (1); :144-145 (2); :153 sub (1);
# :154 compare (1); :155-157 (3)
SW_OPS_PER_CELL = 26
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# A model of the wavefront kernel's latency floor (csrc/sw_rot.cu), not a
# measurement: the longest warp's steps (per band of 32 * R rows,
# min(dlen, N) + busy lanes - 1) times the dependent cycles of one step: one
# __shfl_up_sync round, then R cells whose final H feeds the row below
# through 4 dependent int32 operations (tH - go, the F max, M against F, E
# against H_tmp), at the SM's maximum clock, plus the measured empty launch.
# The two latencies are guesses, not measured on the card and not taken
# from a cited source: 4 cycles a dependent integer operation and 30 cycles
# a shuffle round. The "rows" phase measures what a step and a cell cost.
DEP_OPS_PER_CELL = 4
DEP_OP_CYCLES = 4
SHFL_CYCLES = 30
REALIGN_BATCHES = (1, 6, 40)  # align_batch timed whole at the main path's batch sizes
# bench.py's SV workload (bench.py:234-253 -> tools/bench_sv.py:108-146):
# 300 kb, 11 SVs, 4 samples at 30x, 288,000 reads of 125 bp
SV = dict(kb=300, samples=4, coverage=30.0)
# a 60 kb noisy cohort and two 25 kb BED intervals (camou ploidy 4); at
# error rate 0.02 discovery reaches realignment
CAMOU = (dict(region_length=60_000, coverage=30.0, n_samples=4, read_length=151, error_rate=0.02, seed=4,
              out_format="bam"), ((2_000, 27_000), (32_000, 57_000)))
HLA_REGION = "chr6:1-12000"  # the IMGT-shaped panel's contig
HLA_PAIRS = 1100  # read pairs a sample, as in tests/pipeline/test_hla_imgt.py
STREAM_BATCH = 1 << 16  # records a streaming batch: three or more batches on the align cohort
# bench.py's shape and error rate: at 0.001 most rows are clean (every
# 32-mer exact), so the verdict kernel decides most of the call iterations
ALIGN_COHORT = dict(region_length=200_000, coverage=30.0, n_samples=4, read_length=151, error_rate=0.001,
                    seed=3, out_format="bam")
KERNEL_ROWS = 1 << 19  # a streaming batch stages up to 2 * 2^18 + 16 rows, padded to 2^19
# int32 operations of the verdict function on its inputs, counted from
# graphtyper_tpu/ops/device_align.py:107-258 for the work a row's data
# needs: per row, nk_r, the tail length, the verdict's ands and the meta
# pack (:136-137, :181-182, :228-248); per kmer the read has (at least
# kmer 0, whose label gives the start): the bucket index, the found test,
# the span bounds, okcap, kmer_ok and the chain link (:142, :146-151,
# :168-177); per halving of a search: the midpoint, its clamp, the 64-bit
# compare (three ops) and two selects (:96-103); per label gathered
# (min(size, 6)): the span compare, the variant test and the slot pack
# (:154-166, :216-226); per row with a tail: the node clamp, offset,
# in-node and fit tests and the budget (:193-213); per tail base: the
# index add, the mismatch test (four ops) and the tag test (:199-206)
VERDICT_OPS = dict(row=25, kmer=20, step=7, label=8, node=12, tail_base=6)
# per probe of a valid kmer (graphtyper_tpu/ops/seed_probe.py:104-110):
# two xors, two multiplies and an add for the hash, the shift to the index,
# the word index and bit shift, the bit's and, and its pack into the word
SEED_OPS_PER_PROBE = 10
# the fused genotyping step (ops/genotype_step.py) at entry()'s shape and
# bench.py's kernel_secondary shape (bench.py:266), reads x length x
# haplotype windows x alleles
FORWARD_SHAPES = (("entry", (256, 160, 64, 8)), ("bench", (8192, 160, 512, 16)))
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# tests/parallel/test_distributed_e2e.py's cohort, sample-sharded over two
# processes; and a 100 kb cohort of two 50 kb regions for the CLI's
# --num_hosts region sharding (error rate 0.01: both regions realign)
DIST_E2E = dict(region_length=50_000, coverage=14.0, n_samples=4, seed=31, out_format="bam")
DIST_CLI = dict(region_length=100_000, coverage=8.0, n_samples=2, seed=33, error_rate=0.01, out_format="bam")
DIST_TIMEOUT_S = 300
SCORING_ROWS = (65_536, 262_144, 1_048_576, 4_194_304)  # tools/bench_flush's four flush shapes
SCORING_TIERS = ((2, 512), (64, 64))  # (A, sites) at 50 samples: bench_flush's tier, and A = 64
SCORING_SAMPLES = 50
# (rows, events) of the pileup: a 200 kb region's first pass (7,530-19,188
# rows in the dist phase's runs), then cohort sizes
PILEUP_SHAPES = ((20_000, 2_500), (1_048_576, 131_072), (4_194_304, 524_288))
CAPTURED_REPS = 100  # calls timed at each captured main-path flush
# CRAM cohorts of utils/simulate_indep.py (a Markov reference with
# indel-rich clustered sites, adapter soft clips and ramped quals, one
# sample): bench.py's independent workload (bench.py:181-191), 120 kb at 30x,
# seed 9, where every indel has the read support that spares it
# realignment, so discovery launches no SW; and the recipe of
# tests/pipeline/test_indep_workload.py, 40 kb at 28x, seed 11, whose
# discovery realigns
INDEP = (("bench", dict(region_length=120_000, coverage=30.0, seed=9)),
         ("recall", dict(region_length=40_000, coverage=28.0, seed=11)))
INDEP_CRAI_WINDOW = (40_000, 80_000)  # 0-based half-open window of the crai query
FUZZ_SEED = 1  # a 2-sample BAM cohort: the BAI, CRAM, Python-rANS and SAM legs run
# tests/pipeline/test_population_soak.py:19-20's small recipe
SOAK = ["--samples", "16", "--kb", "120", "--coverage", "10", "--processes", "4"]
SOAK_TIMEOUT_S = 600
# the measurement tools at reduced sizes: argv after `python -m
# graphtyper_tpu_torch.tools.`, the tool's name first
BENCHTOOLS = (  # the longest first
    ["bench_distributed", "4", "50", "--reps", "1"],
    ["bench_flush", "--rows", "262144", "--samples", "50"],
    ["bench_lr", "--kb", "50"],
)
BENCHTOOLS_TIMEOUT_S = 400


def _md5(paths):
    """md5 of the concatenated uncompressed VCFs, in path order, each with
    its ##fileDate line masked."""
    h = hashlib.md5()
    for p in sorted(paths):
        with gzip.open(p, "rb") as f:
            for line in f:
                h.update(b"##fileDate=\n" if line.startswith(b"##fileDate=") else line)
    return h.hexdigest()


def _kernel_batches(np):
    """(name, (Q, qlens, D, dlens)) batches; inputs made with numpy from seeds."""
    from test_torch_sw_batches import e_tie_batch, insertion_batch, planted_batch, two_band_batch

    batches = [("main", planted_batch(2024, *KERNEL_SHAPE))]

    # tests/ops/test_sw_rot.py: adversarial ties and gaps
    rng = np.random.default_rng(99)
    B2, Mx, Nx = 32, 20, 48
    Q2 = rng.integers(0, 2, (B2, Mx)).astype(np.uint8)
    D2 = rng.integers(0, 2, (B2, Nx)).astype(np.uint8)
    Q2[0] = 0
    D2[0] = 0
    Q2[1, :10] = D2[1, 5:15]
    Q2[1, 10:] = 3
    Q2[2] = D2[2, :Mx][::-1]
    D2[3, :24] = rng.integers(0, 4, 24)
    Q2[3, :10] = D2[3, :10]
    Q2[3, 10:20] = D2[3, 16:26]
    batches.append(("ties", (Q2, np.full(B2, Mx, np.int32), D2, np.full(B2, Nx, np.int32))))

    # tests/ops/test_sw_rot.py: length edges and IUPAC codes
    rng = np.random.default_rng(7)
    Q3 = rng.integers(0, 4, (8, 16)).astype(np.uint8)
    D3 = rng.integers(0, 4, (8, 32)).astype(np.uint8)
    Q3[4, 2:9] = 4
    D3[6, ::3] = 4
    Q3[7] = D3[7, 10:26]
    batches.append(("edges", (Q3, np.array([16, 1, 6, 16, 16, 3, 16, 16], np.int32), D3,
                              np.array([32, 32, 32, 8, 32, 3, 32, 32], np.int32))))

    # qlen = 0 / dlen = 0 sentinels
    Q4 = rng.integers(0, 4, (6, 12)).astype(np.uint8)
    D4 = rng.integers(0, 4, (6, 30)).astype(np.uint8)
    batches.append(("empty", (Q4, np.array([0, 12, 0, 5, 12, 1], np.int32), D4,
                              np.array([30, 0, 0, 0, 30, 1], np.int32))))

    # E-scan ties at the row kernel's strip widths 1, 4, 8 and 16
    for M, N in ((12, 32), (24, 128), (40, 256), (151, 506), (192, 512)):
        batches.append((f"e_ties_{M}x{N}", e_tie_batch(N, B=64, M=M, N=N)))

    # sw_rot.cu only (sw_row.cu takes N <= 512): a window widened by a 30 bp
    # insertion, and queries of two 256-row bands through the band scratch
    batches.append(("insertion_N576", insertion_batch(11, 512)))
    batches.append(("two_bands_300x640", two_band_batch(11, 256)))
    return batches


def _time_ms(fn, reps=None):
    """CUDA-event ms of one call (bench_sw.time_ms: warm-up, then `reps`
    calls, by default as many as fill about 200 ms)."""
    from graphtyper_tpu_torch.tools.bench_sw import time_ms

    return time_ms(fn, reps)[0]


def _to_dev(torch, np, arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _max_diff(np, got, want):
    return max(int(np.abs(g.cpu().numpy().astype(np.int64) - w.cpu().numpy().astype(np.int64)).max(
        initial=0)) for g, w in zip(got, want))


def sw_bound(np, qlens, dlens, N, B, M, sm_clock_mhz, n_sm):
    """(ms, bound_by): the least time the card could take for one SW call on
    these inputs, the larger of SW_OPS_PER_CELL int32 operations per cell of
    the active rows and valid columns (sum of qlen x min(dlen, N)) on
    n_sm x 64 int32 lanes at the SM's maximum clock, and the bytes moved
    once (codes and lengths in, three int32 out per pair) at the HBM rate."""
    cols = np.minimum(np.asarray(dlens, np.int64), N)
    ops = SW_OPS_PER_CELL * int((np.asarray(qlens, np.int64) * cols).sum())
    ops_ms = ops / (n_sm * INT32_LANES_PER_SM * sm_clock_mhz * 1e6) * 1e3
    bytes_ms = (B * (M + N) + B * 8 + B * 12) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rot_floor(qlens, dlens, M, N, band_rows, sm_clock_mhz, empty_ms):
    """The wavefront kernel's modelled latency floor in ms (DEP_OPS_PER_CELL
    above); band_rows is the kernel's (gt_sw_rot_band_rows)."""
    R = max(1, -(-min(M, band_rows) // 32))
    longest = 0
    for ql, dl in zip(qlens.tolist(), dlens.tolist()):
        rows, cols = min(ql, M), max(0, min(dl, N))
        steps = sum(cols + min(32, -(-(rows - base) // R)) - 1 for base in range(0, rows, 32 * R))
        longest = max(longest, steps)
    cycles = longest * (SHFL_CYCLES + R * DEP_OPS_PER_CELL * DEP_OP_CYCLES)
    return cycles / (sm_clock_mhz * 1e3) + empty_ms


def kernel_phase(torch, np, dev):
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_plain, sw_align_rot

    batches = _kernel_batches(np)
    Q, ql, D, dl = batches[0][1]
    # the main path's realignment batches hold 1-40 pairs
    batches.insert(1, ("few", tuple(a[:SMALL_BATCH] for a in (Q, ql, D, dl))))
    max_err = 0
    tensors = {}
    for name, arrays in batches:
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        got = [x.cpu().numpy().astype(np.int64) for x in sw_align_rot(*t)]
        want = [x.cpu().numpy().astype(np.int64) for x in sw_align_plain(*t)]
        for g, w in zip(got, want):
            max_err = max(max_err, int(np.abs(g - w).max()))
        tensors[name] = t
    if max_err != 0:
        raise AssertionError(f"sw_align_rot disagrees with sw_align_plain: max |diff| {max_err}")
    main_t, few = tensors["main"], tensors["few"]
    cells = int(ql.astype(np.int64).sum()) * D.shape[1]
    ms = _time_ms(lambda: sw_align_rot(*main_t))
    plain_ms = _time_ms(lambda: sw_align_plain(*main_t), 3)
    few_ms = _time_ms(lambda: sw_align_rot(*few))
    few_plain_ms = _time_ms(lambda: sw_align_plain(*few), 3)
    B, M, N = KERNEL_SHAPE
    print(f"kernel: sw_align_rot == sw_align_plain on {B}x{M}x{N}, {SMALL_BATCH} pairs and"
          " ties/edges/empty/E-scan ties;"
          f" kernel {ms:.3f} ms ({cells / ms / 1e6:.3f} Gcell/s), plain {plain_ms:.3f} ms"
          f" ({cells / plain_ms / 1e6:.3f} Gcell/s), cells = sum(qlen) x N = {cells};"
          f" {SMALL_BATCH} pairs: kernel {few_ms:.3f} ms, plain {few_plain_ms:.3f} ms", flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def row_phase(torch, np, dev, rot_err, bound, floor):
    """sw_align_pallas (csrc/sw_row.cu) against sw_align_plain, exactly, on
    every batch; sw_align_rot is held to the plain version on the new
    shapes too. Times of both kernels and the plain version per shape."""
    from graphtyper_tpu_torch.ops.sw_pallas import MAX_M, MAX_N, sw_align_pallas, sw_align_plain
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_rot
    from graphtyper_tpu_torch.tools.bench_sw import make_batch
    from test_torch_sw_batches import planted_batch

    M, N = PATH_SHAPE
    wide = planted_batch(2025, PATH_BATCHES[-1], M, N)
    batches = _kernel_batches(np)
    batches.insert(1, ("bench_sw", make_batch()))
    for B in PATH_BATCHES:
        batches.insert(2, (f"{B}x{M}x{N}", tuple(a[:B] for a in wide)))
    row_err = 0
    times = {}
    for name, arrays in batches:
        t = _to_dev(torch, np, arrays, dev)
        want = sw_align_plain(*t)
        if arrays[2].shape[1] <= MAX_N and arrays[0].shape[1] <= MAX_M:
            row_err = max(row_err, _max_diff(np, sw_align_pallas(*t), want))
        rot_err = max(rot_err, _max_diff(np, sw_align_rot(*t), want))
        if row_err or rot_err:
            raise AssertionError(f"{name}: a SW kernel disagrees with sw_align_plain: max |diff| "
                                 f"sw_row {row_err}, sw_rot {rot_err}")
        if name in ("main", "bench_sw") or name.endswith(f"x{M}x{N}"):
            times[name] = dict(
                row_ms=_time_ms(lambda: sw_align_pallas(*t)),
                rot_ms=_time_ms(lambda: sw_align_rot(*t)),
                plain_ms=_time_ms(lambda: sw_align_plain(*t), 3),
                cells=int(arrays[1].astype(np.int64).sum()) * arrays[2].shape[1],
                bound=bound(arrays),
                floor=floor(arrays),
            )
    print("row: sw_align_pallas == sw_align_plain (and sw_align_rot == sw_align_plain) on "
          + ", ".join(n for n, _ in batches) + "; CUDA-event ms per call (Gcell/s):", flush=True)
    for name, tm in times.items():
        print(f"row:   {name}: sw_row {tm['row_ms']:.4f} ({tm['cells'] / tm['row_ms'] / 1e6:.3f}),"
              f" sw_rot {tm['rot_ms']:.4f} ({tm['cells'] / tm['rot_ms'] / 1e6:.3f}),"
              f" plain {tm['plain_ms']:.3f} ({tm['cells'] / tm['plain_ms'] / 1e6:.3f});"
              f" bound {tm['bound'][0]:.4f} ({tm['bound'][1]}); sw_rot latency floor modelled"
              f" from assumed latencies, not measured, {tm['floor']:.4f}", flush=True)
    return dict(max_abs_err=row_err, rot_err=rot_err, times=times)


def rows_phase(torch, np, dev, band_rows):
    """Where sw_rot.cu's time goes at the main path's batch sizes: CUDA-event
    times of sw_align_rot on 1 and 40 pairs x 151 x 506 at R = 5 rows a lane
    (M = 151) and at R = 8 (the same queries padded to one band of
    band_rows, so fewer steps of more rows), and the host time of one call
    of the wrapper (20 calls issued without waiting)."""
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_rot
    from test_torch_sw_batches import planted_batch

    M, N = PATH_SHAPE
    wide = planted_batch(2025, 40, M, N)
    out = {}
    for B in (1, 40):
        Q, ql, D, dl = (a[:B] for a in wide)
        padded = np.full((B, band_rows), 5, np.uint8)
        padded[:, :M] = Q
        res = {}
        for R, q in ((5, Q), (8, padded)):
            t = _to_dev(torch, np, (q, ql, D, dl), dev)
            res[f"R{R}_ms"] = _time_ms(lambda: sw_align_rot(*t))
        t = _to_dev(torch, np, (Q, ql, D, dl), dev)
        sw_align_rot(*t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            sw_align_rot(*t)
        res["wrapper_host_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        out[B] = res
    print("rows: sw_align_rot (CUDA events) at " + ", ".join(
        f"{B} pairs x {M} x {N}: R=5 {v['R5_ms']:.4f} ms, R=8 {v['R8_ms']:.4f} ms, wrapper host"
        f" {v['wrapper_host_ms']:.4f} ms a call" for B, v in out.items()), flush=True)
    return out


def realign_phase(torch, np, dev):
    """The whole ops/sw.py align_batch call on a host timer (four copies
    from pageable numpy to the card, the kernel, the stack and the copy
    back, which waits for the card) at the main path's batch sizes, beside
    the kernel's CUDA-event time on the same pairs."""
    from graphtyper_tpu_torch.ops.sw import align_batch
    from graphtyper_tpu_torch.ops.sw_rot import sw_align_plain, sw_align_rot
    from test_torch_sw_batches import planted_batch

    M, N = PATH_SHAPE
    wide = planted_batch(2026, max(REALIGN_BATCHES), M, N)
    out = {}
    for B in REALIGN_BATCHES:
        arrays = tuple(a[:B] for a in wide)
        got = align_batch(*arrays, device=dev)
        want = [x.numpy() for x in sw_align_plain(*_to_dev(torch, np, arrays, "cpu"))]
        if any((g != w).any() for g, w in zip((got.score, got.database_begin, got.database_end), want)):
            raise AssertionError(f"align_batch on {B} pairs differs from sw_align_plain on the CPU")
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            align_batch(*arrays, device=dev)
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        t = _to_dev(torch, np, arrays, dev)
        out[B] = dict(host_ms=host_ms, kernel_ms=_time_ms(lambda: sw_align_rot(*t)))
    print("realign: align_batch (host timer, mean of 200 calls) against its kernel (CUDA events) at "
          + ", ".join(f"{B} pairs {v['host_ms']:.4f} ms vs {v['kernel_ms']:.4f} ms"
                      for B, v in out.items()), flush=True)
    return out


def bench_phase(kernel_flag):
    """python -m graphtyper_tpu_torch.tools.bench_sw <flag> in a subprocess;
    its last line (parity, time, launch counts) as a dict."""
    cmd = [sys.executable, "-m", "graphtyper_tpu_torch.tools.bench_sw", kernel_flag]
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    got = json.loads(lines[-1])
    if not got.get("parity") or got.get("device") != "cuda":
        raise AssertionError(f"{' '.join(cmd[1:])}: {lines[-1]}")
    print(f"bench {kernel_flag}: " + " | ".join(lines[:-1]) + f"; launches {got['launches']}",
          flush=True)
    return got


def _genotype_argv(sim, cfg, out, device):
    argv = ["genotype", sim.fasta, "--region", f"{cfg.chrom}:1-{cfg.region_length}", "-O", out,
            "--threads", str(THREADS), "--device", device]
    for s in sim.sams:
        argv += ["--sam", s]
    return argv


def slice_phase(work, name, sim_kw):
    """One cohort through the port's CLI on the card, then through the same
    CLI on the CPU in a subprocess; returns the card run's counters."""
    from graphtyper_tpu_torch import cli, counters
    from graphtyper_tpu_torch.pipeline.genotype import shutdown_region_pool
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort

    cfg = SimConfig(**sim_kw)
    sim = simulate_cohort(os.path.join(work, name, "sim"), cfg)

    printed = io.StringIO()  # the CLI prints one output path per region unit
    counters.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(_genotype_argv(sim, cfg, os.path.join(work, name, "cuda"), "cuda"))
    wall = time.perf_counter() - t0
    seen = counters.totals()
    shutdown_region_pool()
    if rc != 0:
        raise RuntimeError(f"port genotype on cuda exited {rc}")
    if min(seen.get(k, 0) for k in ("sw_rot", "scoring_rows", "apply_tier", "segment_counters")) <= 0:
        raise AssertionError(f"main path did not run on the kernels: {seen}")
    _no_plain(seen, f"slice {name}")
    outs = printed.getvalue().split()
    n_records = 0
    for p in outs:
        with gzip.open(p, "rt") as f:
            n_records += sum(1 for line in f if not line.startswith("#"))

    # the plain PyTorch versions on the CPU, nothing on the card
    argv = _genotype_argv(sim, cfg, os.path.join(work, name, "cpu"), "cpu")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "graphtyper_tpu_torch.cli", *argv], cwd=HERE,
                          capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"port genotype on cpu exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    ref_outs = proc.stdout.split()
    md5, ref_md5 = _md5(outs), _md5(ref_outs)
    if len(outs) != len(ref_outs) or md5 != ref_md5 or n_records == 0:
        raise AssertionError(
            f"{name}: the card's VCF differs from the CPU device's: {len(outs)} files md5 {md5} "
            f"vs {len(ref_outs)} files md5 {ref_md5}, {n_records} records"
        )
    print(f"slice {name}: genotype {cfg.chrom}:1-{cfg.region_length}, {sim.n_reads} reads of"
          f" {cfg.n_samples} samples (error rate {cfg.error_rate}, seed {cfg.seed}) on cuda in"
          f" {wall:.3f} s = {sim.n_reads / wall:.1f} reads/s ({len(outs)} region units,"
          f" --threads {THREADS}); counters {json.dumps(seen, sort_keys=True)}; {n_records} VCF"
          f" records, md5 {md5} == --device cpu", flush=True)
    return seen, sim, cfg


def _state_md5(sites):
    """md5 of a scorer's site state (the fields tests/test_torch_site_scoring.py
    _site_state compares)."""
    h = hashlib.md5()
    for s in sites:
        vs = s.var_stats
        h.update(repr((
            s.log_scores.tolist(), s.gt_coverages.tolist(), vs.clipped_reads, vs.mapq_squared,
            [(p.clipped_bp, p.mapq_squared, p.mismatches, p.score_diff) for p in vs.per_allele],
            [(r.r1_forward, r.r2_forward, r.r1_reverse, r.r2_reverse) for r in vs.read_strand],
            [(x.max_log_score, x.ambiguous_depth, x.ambiguous_depth_alt, x.alt_proper_pair_depth)
             for x in s.hap_samples],
        )).encode())
    return h.hexdigest()


def _cli_in_process(argv, device_align, **opts):
    """The port's CLI in this process, with GT_DEVICE_ALIGN=device_align in
    the environment (and of the region workers it spawns) and `opts` set on
    the options it parses; returns (sorted output paths, counters, wall s)."""
    from dataclasses import replace

    from graphtyper_tpu_torch import cli, counters
    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options
    from graphtyper_tpu_torch.pipeline.genotype import shutdown_region_pool

    args = cli.parse_args(argv)
    set_options(replace(cli._options_from_args(args), **opts))
    os.environ["GT_DEVICE_ALIGN"] = device_align
    printed = io.StringIO()
    counters.reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            rc = args.fn(args)
        wall = time.perf_counter() - t0
        seen = counters.totals()
    finally:
        shutdown_region_pool()  # the next run's workers see its environment
        os.environ.pop("GT_DEVICE_ALIGN")
        set_options(DEFAULT_OPTIONS)
    if rc != 0:
        raise RuntimeError(f"port {argv[0]} {argv[-1]} device_align={device_align} exited {rc}")
    return sorted(printed.getvalue().split()), seen, wall


def _no_plain(seen, where):
    plain = {k: v for k, v in seen.items() if k.endswith("_plain")}
    if plain:
        raise AssertionError(f"{where}: plain versions ran on the card's path: {plain}")


def align_phase(torch, np, work, dev):
    """The call iterations' device-resident align stage on the align cohort:
    the CLI on cuda with GT_DEVICE_ALIGN=on and off and on --device cpu with
    on (equal md5), with device_seed on as well, then in process on the
    whole region as one pool: call_pool in verify mode (0 divergences),
    the streaming caller in verify and on against its host run, and the
    warm call-iteration wall off, on, on, off. Returns the path's kernel
    launches and the cohort's graph, index and pool rows for the kernel
    phases."""
    from dataclasses import replace

    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.config import DEFAULT_OPTIONS, set_options
    from graphtyper_tpu_torch.graph.build import construct_graph
    from graphtyper_tpu_torch.graph.coords import GenomicRegion
    from graphtyper_tpu_torch.index.build import index_graph
    from graphtyper_tpu_torch.io.native import get_lib
    from graphtyper_tpu_torch.pipeline import native_caller
    from graphtyper_tpu_torch.pipeline.caller import call_pool
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort
    from graphtyper_tpu_torch.typer.native_align import NativeAligner

    name = "align"
    cfg = SimConfig(**ALIGN_COHORT)
    sim = simulate_cohort(os.path.join(work, name, "sim"), cfg)
    spec = f"{cfg.chrom}:1-{cfg.region_length}"
    launches = {"device_align": 0, "seed_probe": 0, "apply_tier": 0, "segment_counters": 0}

    # 1. the CLI: on, off, --device cpu with on; and device_seed on
    md5s, walls = {}, {}
    for run, mode, seed in (("cuda on", "on", "auto"), ("cuda off", "off", "auto"),
                            ("cuda on + device_seed", "on", "on")):
        outs, seen, walls[run] = _cli_in_process(
            _genotype_argv(sim, cfg, os.path.join(work, name, run.replace(" ", "_")), dev.type), mode,
            device_seed=seed)
        md5s[run] = _md5(outs)
        _no_plain(seen, run)
        if mode == "on" and seen.get("device_align", 0) <= 0:
            raise AssertionError(f"{run}: the verdict kernel was not launched: {seen}")
        if seed == "on" and seen.get("seed_probe", 0) <= 0:
            raise AssertionError(f"{run}: the seed-probe kernel was not launched: {seen}")
        for k in launches:
            launches[k] += seen.get(k, 0)
        print(f"align: CLI {run}: {sim.n_reads} reads in {walls[run]:.3f} s, md5 {md5s[run]},"
              f" counters {json.dumps(seen, sort_keys=True)}", flush=True)
    argv = _genotype_argv(sim, cfg, os.path.join(work, name, "cpu_on"), "cpu")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", GT_DEVICE_ALIGN="on")
    proc = subprocess.run([sys.executable, "-m", "graphtyper_tpu_torch.cli", *argv], cwd=HERE,
                          capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"port genotype on cpu exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    md5s["cpu on"] = _md5(proc.stdout.split())
    if len(set(md5s.values())) != 1:
        raise AssertionError(f"align: the VCFs differ: {md5s}")

    # 2. in process, the whole region as one pool
    graph = construct_graph(sim.fasta, sim.vcf, spec, use_index=True)
    index = index_graph(graph)
    region = GenomicRegion.parse(spec)

    def pooled(mode, stream=False):
        set_options(replace(DEFAULT_OPTIONS, device_align=mode))
        native_caller.device_align_stats()  # reset the engine's counts
        before = counters.COUNTS["device_align"]
        t0 = time.perf_counter()
        if stream:
            _, scorer, *_ = native_caller.run_native_call_pool_stream(
                graph, index, sim.sams, region, dev, batch_records=STREAM_BATCH)
            scorer.finalize()
        else:
            scorer = call_pool(graph, index, sim.sams, dev, region=region, is_writing_hap=True).scorer
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        set_options(DEFAULT_OPTIONS)
        return (_state_md5(scorer.sites), native_caller.device_align_stats(),
                counters.COUNTS["device_align"] - before, wall)

    counters.reset()
    off = pooled("off")  # also warms the prepared pool
    verify = pooled("verify")
    clean, fallback, diverged = verify[1]
    if diverged or clean <= 0 or verify[0] != off[0]:
        raise AssertionError(f"align: verify mode: (clean, fallback, divergences) {verify[1]}, "
                             f"state {verify[0]} vs off {off[0]}")
    stream = {mode: pooled(mode, stream=True) for mode in ("off", "verify", "on")}
    for mode in ("verify", "on"):
        st, (s_clean, _, s_div), n, _ = stream[mode]
        if st != stream["off"][0] or s_div or s_clean <= 0 or n < 3:
            raise AssertionError(f"align: streaming {mode}: state {st} vs {stream['off'][0]}, stats "
                                 f"{stream[mode][1]}, {n} launches")
    wall = {}
    for mode in ("off", "on", "on", "off"):
        st, _, _, w = pooled(mode)
        if st != off[0]:
            raise AssertionError(f"align: call_pool {mode}: state {st} vs off {off[0]}")
        wall.setdefault(mode, []).append(w)
    seen = counters.totals()
    _no_plain(seen, "in-process pools")
    for k in ("device_align", "apply_tier"):
        launches[k] += seen.get(k, 0)
    print(f"align: call_pool verify: clean {clean}, fallback {fallback}, divergences {diverged},"
          f" clean share {clean / (clean + fallback):.4f}; streaming (batches of {STREAM_BATCH}"
          f" records) " + ", ".join(f"{m}: stats {v[1]}, {v[2]} launches" for m, v in stream.items())
          + f", state == host stream; warm call-iteration wall (call_pool, one 200 kb pool) off"
          f" {wall['off'][0]:.4f} s, on {wall['on'][0]:.4f} s, on {wall['on'][1]:.4f} s, off"
          f" {wall['off'][1]:.4f} s; counters {json.dumps(seen, sort_keys=True)}", flush=True)

    lib = get_lib()
    entry = native_caller._get_prep(lib, sim.sams, region, 3840, False)
    try:
        rows = (*entry.fetch_kmers(lib), *entry.fetch_tails(lib))
    finally:
        entry.release(lib)
    return dict(launches=launches, na=NativeAligner(graph, index), keys=np.asarray(index.keys, np.uint64),
                rows=rows, md5=md5s["cuda on"], clean_share=clean / (clean + fallback), walls=wall,
                cli_walls=walls)


def _sam_flags(paths):
    return [a for p in paths for a in ("--sam", p)]


def _vcfs(out_dir):
    import glob

    return sorted(glob.glob(os.path.join(out_dir, "**", "*.vcf.gz"), recursive=True))


def card_and_cpu(work, name, argv_of, card_runs, cpu_align="", need="scoring_rows"):
    """One subcommand through the port's CLI: each (label, GT_DEVICE_ALIGN,
    options) of card_runs on cuda in this process, then on --device cpu in a
    subprocess with CUDA_VISIBLE_DEVICES="" and GT_DEVICE_ALIGN=cpu_align.
    Every run writes the same VCFs (md5 of the uncompressed files), every
    card run counts `need` rows and no plain version. argv_of(out, device)
    gives the arguments. Returns ({label: (counters, wall s)}, md5, files)."""
    md5s, runs = {}, {}
    for label, mode, opts in card_runs:
        out = os.path.join(work, name, label.replace(" ", "_"))
        _, seen, wall = _cli_in_process(argv_of(out, "cuda"), mode, **opts)
        _no_plain(seen, f"{name} {label}")
        if seen.get(need, 0) <= 0:
            raise AssertionError(f"{name} {label}: no {need} on the card: {seen}")
        md5s[label], runs[label] = _md5(_vcfs(out)), (seen, wall)
    out = os.path.join(work, name, "cpu")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", GT_DEVICE_ALIGN=cpu_align)
    proc = subprocess.run([sys.executable, "-m", "graphtyper_tpu_torch.cli", *argv_of(out, "cpu")], cwd=HERE,
                          capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"port {name} on cpu exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    files = _vcfs(out)
    md5s["cpu"] = _md5(files)
    if not files or len(set(md5s.values())) != 1:
        raise AssertionError(f"{name}: the VCFs differ: {md5s}")
    return runs, md5s["cpu"], files


def _records(files):
    n = 0
    for p in files:
        with gzip.open(p, "rt") as f:
            n += sum(1 for line in f if not line.startswith("#"))
    return n


def _phase_line(name, what, runs, n_reads, md5, files):
    print(f"{name}: {what}; " + "; ".join(
        f"{label} {wall:.3f} s" + (f" = {n_reads / wall:.1f} reads/s" if n_reads else "")
        + f", counters {json.dumps(seen, sort_keys=True)}" for label, (seen, wall) in runs.items())
        + f"; {len(files)} VCFs, {_records(files)} records, md5 {md5} == --device cpu", flush=True)


def sv_phase(work):
    """bench.py's SV workload (tools/bench_sv.py's cohort, built by the
    port's graphtyper_tpu_torch/tools/bench_sv.py): genotype_sv over the
    300 kb region with --avg_cov_by_readlen, on the card with
    GT_DEVICE_ALIGN=on (SV pools skip the verdicts, so none may launch),
    then in the streaming caller, then on --device cpu."""
    from graphtyper_tpu_torch.tools.bench_sv import build_cohort

    t0 = time.perf_counter()
    sv = build_cohort(os.path.join(work, "sv", "sim"), **SV)
    built = time.perf_counter() - t0
    avg = os.path.join(work, "sv", "avg_cov_by_readlen.txt")
    with open(avg, "w") as f:
        f.writelines(f"{c}\n" for c in sv.avg_cov_by_readlen)

    def argv(out, device):
        return ["genotype_sv", sv.fasta, sv.sv_vcf, "--region", sv.region, "-O", out,
                "--avg_cov_by_readlen", avg, "--device", device, *_sam_flags(sv.bams)]

    runs, md5, files = card_and_cpu(work, "sv", argv, [("cuda", "on", {}),
                                                        ("cuda streaming", "on", dict(streaming_caller="on"))])
    for label, (seen, _) in runs.items():
        if seen.get("device_align", 0) or seen.get("device_align_rows", 0):
            raise AssertionError(f"sv {label}: an SV pool launched the verdict kernel: {seen}")
    _phase_line("sv", f"genotype_sv {sv.region}, {sv.n_svs} SVs, {sv.n_reads} reads of {SV['samples']} samples"
                f" (cohort built in {built:.3f} s)", runs, sv.n_reads, md5, files)
    return runs


def camou_phase(work):
    """genotype_camou over two 25 kb intervals (ploidy 4) of a noisy 60 kb
    cohort whose discovery reaches realignment: on the card with the
    verdicts off and on, then on --device cpu with them on."""
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort

    sim_kw, intervals = CAMOU
    cfg = SimConfig(**sim_kw)
    sim = simulate_cohort(os.path.join(work, "camou", "sim"), cfg)
    bed = os.path.join(work, "camou", "intervals.bed")
    with open(bed, "w") as f:
        f.writelines(f"{cfg.chrom}\t{lo}\t{hi}\n" for lo, hi in intervals)

    def argv(out, device):
        return ["genotype_camou", sim.fasta, bed, "-O", out, "--threads", str(THREADS), "--device", device,
                *_sam_flags(sim.sams)]

    runs, md5, files = card_and_cpu(work, "camou", argv, [("cuda", "", {}), ("cuda on", "on", {})], "on")
    for label, (seen, _) in runs.items():
        if seen.get("sw_rot", 0) <= 0:
            raise AssertionError(f"camou {label}: realignment did not launch sw_rot: {seen}")
    if runs["cuda on"][0].get("device_align", 0) <= 0:
        raise AssertionError(f"camou: GT_DEVICE_ALIGN=on did not launch the verdict kernel: {runs['cuda on'][0]}")
    _phase_line("camou", f"genotype_camou {len(intervals)} intervals of {cfg.chrom}:1-{cfg.region_length},"
                f" {sim.n_reads} reads of {cfg.n_samples} samples (error rate {cfg.error_rate}, seed {cfg.seed})",
                runs, sim.n_reads, md5, files)
    return runs


def hla_phase(work):
    """genotype_hla with --segment_fasta on tests/pipeline/test_hla_imgt.py's
    IMGT-shaped panel (120 alleles) and its 12 truth samples (the numpy-only
    copy in tests/test_torch_subcommand_data.py): card against --device
    cpu, and the correct allele-pair rate of the segment record, which that
    test holds at 1.0."""
    from test_torch_subcommand_data import build_imgt_panel, imgt_truth_pairs, write_pair_sam

    panel = build_imgt_panel(os.path.join(work, "hla", "panel"))
    truth = imgt_truth_pairs(sorted(panel["carried"]))
    sams = [write_pair_sam(os.path.join(work, "hla", f"s{k}.sam"), f"s{k}", panel["haps"][a], panel["haps"][b],
                           1000 + k, HLA_PAIRS) for k, (a, b) in enumerate(truth)]
    n_reads = 2 * HLA_PAIRS * len(sams)

    def argv(out, device):
        return ["genotype_hla", panel["fasta"], panel["hla_vcf"], "--region", HLA_REGION, "--segment_fasta",
                panel["panel"], "-O", out, "--device", device, *_sam_flags(sams)]

    runs, md5, files = card_and_cpu(work, "hla", argv, [("cuda", "", {})])
    seg = [p for p in files if p.endswith(".segments.vcf.gz")]
    if len(files) != 2 or len(seg) != 1:
        raise AssertionError(f"hla: expected a .hla and a .segments VCF: {files}")
    with gzip.open(seg[0], "rt") as f:
        rec = next(line for line in f if not line.startswith("#")).rstrip("\n").split("\t")
    names = rec[7].split("SEGMENT_ALLELES=")[1].split(";")[0].split(",")
    correct = 0
    for k, col in enumerate(rec[9:]):
        a, b = sorted(int(x) for x in col.split(":")[0].replace("|", "/").split("/"))
        correct += {names[a], names[b]} == set(truth[k])
    if correct != len(truth):
        raise AssertionError(f"hla: {correct} of {len(truth)} samples called their truth pair")
    _phase_line("hla", f"genotype_hla --segment_fasta, {len(panel['carried'])} alleles, {len(sams)} samples;"
                f" correct allele-pair rate {correct}/{len(truth)}", runs, n_reads, md5, files)
    return runs


def discover_phase(work, sim, cfg):
    """The discover subcommand on the sw cohort (realignment reaches the VCF
    there): card against --device cpu."""

    def argv(out, device):
        return ["discover", sim.fasta, "--region", f"{cfg.chrom}:1-{cfg.region_length}", "-O", out,
                "--threads", str(THREADS), "--device", device, *_sam_flags(sim.sams)]

    runs, md5, files = card_and_cpu(work, "discover", argv, [("cuda", "", {})], need="pileup_rows")
    if runs["cuda"][0].get("sw_rot", 0) <= 0:
        raise AssertionError(f"discover: realignment did not launch sw_rot: {runs['cuda'][0]}")
    _phase_line("discover", f"discover {cfg.chrom}:1-{cfg.region_length} on the sw cohort", runs, sim.n_reads,
                md5, files)
    return runs


def kernel_inputs(align):
    """(name, aligner tables, index keys, rows) inputs of the verdict and
    seed-probe phases: the tests' adversarial batch against its synthetic
    index, the align cohort's pool rows against its index, and KERNEL_ROWS
    rows drawn from those."""
    import types

    from test_torch_device_align_batches import sample_rows, synthetic_index, synthetic_rows

    idx = synthetic_index(0)
    rows = align["rows"]
    return [("adversarial", types.SimpleNamespace(**idx), idx["keys"], synthetic_rows(idx, 4, seed=4)),
            ("align_pool", align["na"], align["keys"], rows),
            (f"{KERNEL_ROWS}_rows", align["na"], align["keys"], sample_rows(rows, KERNEL_ROWS))]


def pools_phase(work):
    """More call pools at once than the prepared-pool cache holds (4): the
    POOLS cohort's 8 single-sample files at --threads 8, so call_pools runs
    8 pools in 8 threads in each call iteration, each staging its rows on
    the card with the verdicts on. The SAM paths stand positionally after
    the options, so the card machine's own Python parses that form. On cuda
    with the verdicts off and on, then on --device cpu with them on."""
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort

    cfg = SimConfig(**POOLS)
    sim = simulate_cohort(os.path.join(work, "pools", "sim"), cfg)

    def argv(out, device):
        return ["genotype", sim.fasta, "--region", f"{cfg.chrom}:1-{cfg.region_length}", "-O", out,
                "--threads", str(POOL_THREADS), "--device", device, *sim.sams]

    runs, md5, files = card_and_cpu(work, "pools", argv, [("cuda", "", {}), ("cuda on", "on", {})], "on")
    if runs["cuda on"][0].get("device_align", 0) < 2 * cfg.n_samples:
        raise AssertionError(f"pools: fewer verdict launches than 8 pools in 2 call iterations: {runs['cuda on'][0]}")
    _phase_line("pools", f"genotype {cfg.chrom}:1-{cfg.region_length} on {cfg.n_samples} single-sample BAMs"
                f" given positionally, --threads {POOL_THREADS} ({cfg.n_samples} pools at once)", runs,
                sim.n_reads, md5, files)
    return runs


def verdict_bound(np, na, dal, rows, S, sm_clock_mhz, n_sm):
    """(ms, bound_by) of the verdict function on these rows (S of them after
    padding): the bytes (each row input and the tables read once, 36 bytes a
    row out) at the HBM rate, against VERDICT_OPS on the int32 lanes."""
    hi, lo, valid, tails, lens = rows
    n, nk = hi.shape
    pad = S - n  # padded rows: length 0, one kmer of key 0
    nk_r = np.minimum(np.where(lens >= 32, 1 + (lens.astype(np.int64) - 32) // 31, 0), nk)
    tail = np.maximum(lens.astype(np.int64) - 1 - 31 * nk_r, 0)
    keys = np.asarray(na.keys, np.uint64)
    offsets = np.asarray(na.offsets, np.int64)
    q = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    size = np.where(keys[pos] == q, offsets[pos + 1] - offsets[pos], 0)
    kmers = np.arange(nk)[None, :] < np.maximum(nk_r, 1)[:, None]
    c = VERDICT_OPS
    ops = (S * c["row"] + (int(kmers.sum()) + pad) * (c["kmer"] + c["step"] * dal.key_steps)
           + int((np.minimum(size, 6) * kmers).sum()) * c["label"]
           + int((tail > 0).sum()) * (c["node"] + c["step"] * dal.ref_steps) + int(tail.sum()) * c["tail_base"])
    ops_ms = ops / (n_sm * INT32_LANES_PER_SM * sm_clock_mhz * 1e6) * 1e3
    bytes_ms = (S * (9 * nk + 32 + 4 + 36) + dal.table_bytes()) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def seed_bound(np, valid, S, prow, bitset_bytes, sm_clock_mhz, n_sm):
    """(ms, bound_by) of the seed-probe function: SEED_OPS_PER_PROBE on each
    of the 97 probes of every valid kmer, against the bytes (rows in, words
    out, the bitset read once)."""
    nk = valid.shape[1]
    ops = SEED_OPS_PER_PROBE * 97 * int((valid != 0).sum())
    ops_ms = ops / (n_sm * INT32_LANES_PER_SM * sm_clock_mhz * 1e6) * 1e3
    bytes_ms = (S * (9 * nk + 4 * prow) + bitset_bytes) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _exact(np, name, got, want):
    g, w = got.cpu().numpy().astype(np.int64), want.cpu().numpy().astype(np.int64)
    err = int(np.abs(g - w).max(initial=0))
    if g.shape != w.shape or err:
        raise AssertionError(f"{name}: the kernel disagrees with its plain version: max |diff| {err}")
    return err


def verdict_phase(torch, np, dev, inputs, sm_clock, n_sm):
    """device_align.cu against verdicts_plain on the card, exactly, and
    CUDA-event times of both, with the bound and the kernel's random loads
    (verdict_gathers), on each input; then exactly on the arena-edge batch
    at nk 2, 4 and 8."""
    import types

    from graphtyper_tpu_torch.ops.device_align import DeviceAligner, stage_tails, verdicts_plain
    from graphtyper_tpu_torch.ops.seed_probe import stage_kmers
    from graphtyper_tpu_torch.tools.bench_align import verdict_gathers
    from test_torch_device_align_batches import arena_edge_index, arena_edge_rows

    edge = arena_edge_index(0)
    edges = [(f"arena_edge_nk{nk}", types.SimpleNamespace(**edge), None, arena_edge_rows(edge, nk, seed=nk))
             for nk in (2, 4, 8)]
    out = {}
    for name, na, _, rows in [*inputs, *edges]:
        dal = DeviceAligner(na, dev)
        kmers = stage_kmers(*rows[:3], dev)
        tails = stage_tails(*rows[3:], dev)
        nk, S = rows[0].shape[1], kmers[0].shape[0]
        steps = dict(key_steps=dal.key_steps, ref_steps=dal.ref_steps)
        got = dal.launch(kmers, *tails, nk)
        want = verdicts_plain(*kmers, *tails, *dal.tables, **steps)
        err = _exact(np, f"device_align on {name}", got, want)
        if name.startswith("arena_edge"):
            continue
        out[name] = dict(rows=len(rows[-1]), S=S, nk=nk, max_abs_err=err,
                         ms=_time_ms(lambda: dal.launch(kmers, *tails, nk)),
                         plain_ms=_time_ms(lambda: verdicts_plain(*kmers, *tails, *dal.tables, **steps), 3),
                         bound=verdict_bound(np, na, dal, rows, S, sm_clock, n_sm),
                         key_steps=dal.key_steps, ref_steps=dal.ref_steps,
                         clean=float((got[: len(rows[-1]), 0] & 1).float().mean()),
                         gathers=verdict_gathers(dal, rows, want.cpu().numpy(), S),
                         table_bytes=sum(t.numel() * t.element_size() for t in dal.packed))
    print("verdict: device_align == verdicts_plain (max |diff| 0, also on the arena-edge batch at nk 2, 4"
          " and 8); CUDA-event ms: " + "; ".join(
              f"{n}: {v['rows']} rows (S {v['S']}, nk {v['nk']}, key_steps {v['key_steps']}, ref_steps"
              f" {v['ref_steps']}, clean {v['clean']:.4f}, {v['gathers']} random loads) kernel {v['ms']:.4f},"
              f" plain {v['plain_ms']:.3f}, bound {v['bound'][0]:.4f} ({v['bound'][1]})"
              for n, v in out.items()), flush=True)
    return out


def seed_phase(torch, np, dev, inputs, sm_clock, n_sm):
    """seed_probe.cu against probe_bits_plain on the card, exactly, and
    CUDA-event times of both, with the bound, on each input (the bitset of
    each input's index at the pipeline's size)."""
    from graphtyper_tpu_torch.ops.seed_probe import DeviceSeeder, prow_for, probe_bits, probe_bits_plain, stage_kmers

    out = {}
    for name, _, keys, rows in inputs:
        seeder = DeviceSeeder(keys, dev)
        hi, lo, valid = stage_kmers(*rows[:3], dev)
        args = (hi, lo, valid, seeder.bitset, seeder.bits)
        S, nk = hi.shape
        err = _exact(np, f"seed_probe on {name}", probe_bits(*args), probe_bits_plain(*args))
        bitset_bytes = seeder.bitset.numel() * 4
        out[name] = dict(rows=len(rows[0]), S=S, nk=nk, bits=seeder.bits, max_abs_err=err,
                         ms=_time_ms(lambda: probe_bits(*args)),
                         plain_ms=_time_ms(lambda: probe_bits_plain(*args), 3),
                         bound=seed_bound(np, rows[2], S, prow_for(nk), bitset_bytes, sm_clock, n_sm),
                         gathers=97 * int((rows[2] != 0).sum()), table_bytes=bitset_bytes)
    print("seed: seed_probe == probe_bits_plain (max |diff| 0); CUDA-event ms: " + "; ".join(
        f"{n}: {v['rows']} rows (S {v['S']}, nk {v['nk']}, {v['bits']} bits) kernel {v['ms']:.4f},"
        f" plain {v['plain_ms']:.3f}, bound {v['bound'][0]:.4f} ({v['bound'][1]})"
        for n, v in out.items()), flush=True)
    return out


def gather_phase(dev, verdict, seed):
    """The measured gather ceiling: csrc/gather.cu's random 4-byte loads at
    full occupancy from a table the size of each kernel's at 2^19 rows (the
    seed bitset, the packed verdict tables), and the time that rate gives
    each kernel's own random loads on every input."""
    from graphtyper_tpu_torch.tools.bench_align import gather_rate

    big = f"{KERNEL_ROWS}_rows"
    rates = {}
    for kernel, times in (("device_align", verdict), ("seed_probe", seed)):
        rate = gather_rate(times[big]["table_bytes"], dev)
        rates[kernel] = rate
        for v in times.values():
            v["gather_ms"] = v["gathers"] / rate["gloads_per_s"] / 1e6
    print("gather: random 4-byte loads at full occupancy (csrc/gather.cu, CUDA events): " + "; ".join(
        f"{k} table of {r['table_bytes']} bytes {r['gloads_per_s']:.3f} G loads/s; its loads at {big}:"
        f" {times[big]['gathers']} in {times[big]['ms']:.4f} ms = "
        f"{times[big]['gathers'] / times[big]['ms'] / 1e6:.3f} G/s, {times[big]['gather_ms']:.4f} ms at the"
        f" ceiling" for (k, r), times in zip(rates.items(), (verdict, seed))), flush=True)
    return rates


def scoring_phase(torch, np, dev, captured):
    """csrc/site_scoring.cu (apply_tier) against apply_tier_plain and
    csrc/discovery_pileup.cu (segment_counters) against
    segment_counters_plain on the card, exactly: on the adversarial rows of
    tests/test_torch_scoring_batches.py at every allele tier, at
    tools/bench_flush's four flush shapes at A 2 (512 sites) and A 64 (64
    sites) with 50 samples, the largest at A 2 also sorted by (site,
    sample) and with every row in one segment, at PILEUP_SHAPES, the
    largest also sorted and in one event, and at every scoring flush of the
    200 kb cohort (`captured`, tools/bench_scoring.capture_flushes).
    CUDA-event ms of kernel and plain version, the flush matrix's copy from
    pageable memory and from pinned memory (as ObsBatcher writes it), the
    byte bound (the rows read once and the output written once over 3.35
    TB/s), and each kernel's device operations in one call
    (torch.profiler) and its device time a call (a CUDA graph of
    back-to-back calls, bench_scoring.graph_us)."""
    from graphtyper_tpu_torch.ops.discovery_pileup import segment_counters, segment_counters_plain
    from graphtyper_tpu_torch.ops.site_scoring import ALLELE_TIERS, apply_tier, apply_tier_plain
    from graphtyper_tpu_torch.tools.bench_scoring import device_ops, graph_us, rows_histogram
    from test_torch_scoring_batches import (SCORING_SHAPE, flush_matrix, pileup_order, pileup_rows, scoring_order,
                                            scoring_rows)

    for A in ALLELE_TIERS:
        mat = torch.from_numpy(scoring_rows(A, 7)).to(dev)
        _exact(np, f"apply_tier on the adversarial rows at A {A}", apply_tier(mat, A, *SCORING_SHAPE),
               apply_tier_plain(mat, A, *SCORING_SHAPE))
    for seed, n, n_events in ((0, 5000, 300), (3, 200_000, 7)):
        mat = torch.from_numpy(pileup_rows(seed, n, n_events)).to(dev)
        _exact(np, f"segment_counters on the adversarial rows ({n} rows, {n_events} events)",
               segment_counters(mat, n_events), segment_counters_plain(mat, n_events))
    flush = {}

    def time_flush(name, host, A, n_sites):
        pinned = host.pin_memory()
        mat = pinned.to(dev, non_blocking=True)
        args = (A, n_sites, SCORING_SAMPLES)
        got = apply_tier(mat, *args)
        err = _exact(np, f"apply_tier at {name}", got, apply_tier_plain(mat, *args))
        nbytes = host.numel() * host.element_size() + got.numel() * got.element_size()
        flush[name] = dict(
            rows=host.shape[1], A=A, sites=n_sites, max_abs_err=err, ms=_time_ms(lambda: apply_tier(mat, *args)),
            plain_ms=_time_ms(lambda: apply_tier_plain(mat, *args), 2),
            pageable_copy_ms=_time_ms(lambda: host.to(dev), 3),
            pinned_copy_ms=_time_ms(lambda: pinned.to(dev, non_blocking=True), 3),
            bound=(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), device_ops=device_ops(lambda: apply_tier(mat, *args))[0],
            device_us=graph_us(lambda: apply_tier(mat, *args)))

    for A, n_sites in SCORING_TIERS:
        for rows in SCORING_ROWS:
            time_flush(f"A{A}_{rows}", torch.from_numpy(flush_matrix(rows, A, n_sites, SCORING_SAMPLES, seed=rows)),
                       A, n_sites)
    A, n_sites = SCORING_TIERS[0]
    big = flush_matrix(SCORING_ROWS[-1], A, n_sites, SCORING_SAMPLES, seed=SCORING_ROWS[-1])
    for order in ("sorted", "one_segment"):
        time_flush(f"A{A}_{SCORING_ROWS[-1]}_{order}",
                   torch.from_numpy(scoring_order(big, order, (n_sites, SCORING_SAMPLES))), A, n_sites)

    main_ms, main_us, main_err = [], [], 0
    for i, (host, A, n_sites, n_samples) in enumerate(captured):
        mat = host.to(dev)
        args = (A, n_sites, n_samples)
        main_err = max(main_err, _exact(np, f"apply_tier at captured flush {i} ({host.shape[1]} rows, A {A})",
                                        apply_tier(mat, *args), apply_tier_plain(mat, *args)))
        main_ms.append(_time_ms(lambda: apply_tier(mat, *args), CAPTURED_REPS))
        main_us.append(graph_us(lambda: apply_tier(mat, *args)))
    main = dict(rows_histogram(captured), max_abs_err=main_err, sum_ms=sum(main_ms),
                median_ms=float(np.median(main_ms)), max_ms=max(main_ms), sum_device_us=sum(main_us),
                median_device_us=float(np.median(main_us)))

    pileup = {}

    def time_pileup(name, mat, n_events):
        err = _exact(np, f"segment_counters at {name}", segment_counters(mat, n_events),
                     segment_counters_plain(mat, n_events))
        pileup[name] = dict(
            rows=mat.shape[1], events=n_events, max_abs_err=err, ms=_time_ms(lambda: segment_counters(mat, n_events)),
            plain_ms=_time_ms(lambda: segment_counters_plain(mat, n_events), 3),
            bound=((48 * mat.shape[1] + 64 * n_events) / HBM_BYTES_PER_S * 1e3, "bytes"),
            device_ops=device_ops(lambda: segment_counters(mat, n_events))[0],
            device_us=graph_us(lambda: segment_counters(mat, n_events)))

    for rows, n_events in PILEUP_SHAPES:
        time_pileup(f"{rows}_rows", torch.from_numpy(pileup_rows(rows, rows, n_events, n_overflow=0)).to(dev),
                    n_events)
    rows, n_events = PILEUP_SHAPES[-1]
    big = pileup_rows(rows, rows, n_events, n_overflow=0)
    for order in ("sorted", "one_event"):
        time_pileup(f"{rows}_rows_{order}", torch.from_numpy(pileup_order(big, order, n_events)).to(dev), n_events)

    def ops(v):
        count = "not measured (the profiler recorded none)" if v["device_ops"] is None else f"{v['device_ops']:g}"
        return f"{count} ops, {v['device_us']:.1f} us"

    print("scoring: apply_tier (csrc/site_scoring.cu) == apply_tier_plain and segment_counters"
          " (csrc/discovery_pileup.cu) == segment_counters_plain, max |diff| 0, on the adversarial rows at"
          f" A {', '.join(map(str, ALLELE_TIERS))} and at every shape below; CUDA-event ms, {SCORING_SAMPLES}"
          " samples; device operations a call (torch.profiler) and device us a call (a CUDA graph): " + "; ".join(
              f"{k} ({v['sites']} sites): kernel {v['ms']:.4f}, plain {v['plain_ms']:.3f}, bound"
              f" {v['bound'][0]:.4f} ({v['bound'][1]}), copy pageable {v['pageable_copy_ms']:.3f} / pinned"
              f" {v['pinned_copy_ms']:.3f}, {ops(v)}"
              for k, v in flush.items()), flush=True)
    print(f"scoring, main path: the {main['flushes']} flushes of the 200kb cohort (the CLI's options at --threads"
          f" {THREADS}, its units in this process):"
          f" {main['rows']} rows, median {main['median_rows']:.0f} a flush, rows histogram"
          f" {json.dumps(main['rows_histogram'])}, tiers {json.dumps(main['tiers'])}; each == apply_tier_plain;"
          f" kernel CUDA-event ms summed {main['sum_ms']:.4f}, median {main['median_ms']:.4f},"
          f" max {main['max_ms']:.4f}; device us a call summed {main['sum_device_us']:.1f}, median"
          f" {main['median_device_us']:.2f}", flush=True)
    print("pileup: CUDA-event ms; device operations a call and device us a call: " + "; ".join(
        f"{k}, {v['events']} events: kernel {v['ms']:.4f}, plain {v['plain_ms']:.3f}, bound"
        f" {v['bound'][0]:.4f} ({v['bound'][1]}), {ops(v)}"
        for k, v in pileup.items()), flush=True)
    return dict(apply_tier=flush, segment_counters=pileup, main_path=main)


def forward_inputs(np, name, R, L, H, A):
    """entry()'s inputs, or bench.py's kernel_secondary inputs (bench.py:265-271)."""
    from graphtyper_tpu_torch.entry import example_inputs

    if name == "entry":
        return example_inputs(R, L, H, A)
    rng = np.random.default_rng(0)
    haps = rng.integers(0, 4, size=(H, L)).astype(np.uint8)
    reads = haps[rng.integers(0, H, size=R)].copy()
    hap_allele = np.zeros((H, A), dtype=np.float32)
    hap_allele[np.arange(H), rng.integers(0, A, size=H)] = 1.0
    eps = rng.integers(4, 9, size=R).astype(np.float32)
    return reads, haps, hap_allele, eps


def forward_bound(R, L, H, A, sm_clock_mhz, n_sm):
    """(ms, bound_by) of one genotype_forward step: the larger of the bytes
    (inputs read once, delta and B written once) at the HBM rate and the
    slowest of its operation kinds at that kind's peak: the two int8
    products (2 R H 4L and 2 R H L) on the tensor cores, the R x H int32
    work (the subtraction, the row minimum, two compares, the and) on the
    int32 lanes, and the float32 products (2 R H A, 2 R A A, 2 R A) on the
    float32 lanes."""
    byte_ms = (R * L + H * L + H * A * 4 + R * 4 + A * A * 4 + R * A * 4) / HBM_BYTES_PER_S * 1e3
    op_ms = max(2 * R * H * 5 * L / INT8_OPS_PER_S * 1e3,
                5 * R * H / (n_sm * INT32_LANES_PER_SM * sm_clock_mhz * 1e6) * 1e3,
                (2 * R * H * A + 2 * R * A * A + 2 * R * A) / FP32_OPS_PER_S * 1e3)
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def _cuda_kernels_per_call(torch, fn):
    """CUDA kernels one call of fn launches, by torch.profiler (None when the
    profiler records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def forward_phase(torch, np, dev, sm_clock, n_sm):
    """genotype_forward on the card against the same function on the CPU,
    exactly (integer eps), at entry()'s shape and bench.py's; CUDA-event ms
    a step, reads/s, mismatch_matrix alone and the int8 product alone
    (torch._int_mm on the padded one-hot operands), the bound, and the CUDA
    kernels a step launches (torch.profiler)."""
    from graphtyper_tpu_torch.ops import hamming
    from graphtyper_tpu_torch.ops.genotype_step import genotype_forward

    out = {}
    for name, (R, L, H, A) in FORWARD_SHAPES:
        arrays = forward_inputs(np, name, R, L, H, A)
        cpu = [torch.from_numpy(a) for a in arrays]
        card = [t.to(dev) for t in cpu]
        want, got = genotype_forward(*cpu), genotype_forward(*card)
        for w, g, what in zip(want, got, ("delta", "B")):
            if g.device.type != "cuda" or not torch.equal(g.cpu(), w):
                raise AssertionError(f"forward {name}: {what} on the card differs from the CPU's")
        if float(got[1].sum()) <= 0:
            raise AssertionError(f"forward {name}: no read explains an allele")
        step_ms = _time_ms(lambda: genotype_forward(*card))
        mm_ms = _time_ms(lambda: hamming.mismatch_matrix(card[0], card[1]))
        a, b = hamming.int_mm_operands(hamming.one_hot_acgt(card[0]).reshape(R, -1),
                                       hamming.one_hot_acgt(card[1]).reshape(H, -1))
        lib_ms = _time_ms(lambda: torch._int_mm(a, b))
        bound_ms, bound_by = forward_bound(R, L, H, A, sm_clock, n_sm)
        kernels = _cuda_kernels_per_call(torch, lambda: genotype_forward(*card))
        out[name] = dict(shape=(R, L, H, A), ms=step_ms, reads_per_s=R / step_ms * 1e3, mismatch_ms=mm_ms,
                         int_mm_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by, kernels_per_step=kernels)
        print(f"forward {name}: genotype_forward {R} reads x {L} x {H} windows x {A} alleles on cuda equals the"
              f" CPU exactly; {step_ms:.4f} ms a step (CUDA events) = {R / step_ms * 1e3:.1f} reads/s,"
              f" mismatch_matrix {mm_ms:.4f} ms, torch._int_mm alone {lib_ms:.4f} ms; bound {bound_ms:.6f} ms"
              f" ({bound_by}); {kernels if kernels is not None else 'not measured'} CUDA kernels a step"
              f" (torch.profiler)", flush=True)
    return out


PREFETCH_BATCHES = 6


def prefetch_phase(torch, np, dev):
    """parallel/prefetch.py on the card: each staged batch is read by
    genotype_forward as soon as it is handed out (so a copy that had not
    finished, or memory given out again too early, shows as a wrong delta);
    the batches' order, device and results against the CPU, exactly."""
    from graphtyper_tpu_torch.entry import example_inputs
    from graphtyper_tpu_torch.ops.genotype_step import genotype_forward
    from graphtyper_tpu_torch.parallel.prefetch import pipelined_map, prefetch_to_device

    def batch(i):
        return {"i": np.array([i], dtype=np.int64),
                "args": example_inputs(R=4096, L=160, H=512, A=16, seed=100 + i)}

    want = [genotype_forward(*(torch.from_numpy(a) for a in batch(i)["args"])) for i in range(2 * PREFETCH_BATCHES)]

    def check(i, staged_i, args, got, where):
        if int(staged_i) != i or not all(t.device.type == "cuda" for t in (*args, *got)):
            raise AssertionError(f"prefetch: {where} batch {i} out of order or not on the card")
        for w, g, what in zip(want[i], got, ("delta", "B")):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"prefetch: {where} batch {i}: {what} differs from the CPU's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = []
    for staged in prefetch_to_device((batch(i) for i in range(PREFETCH_BATCHES)), size=2, device=dev):
        results.append((staged["i"], staged["args"], genotype_forward(*staged["args"])))
    torch.cuda.synchronize()
    staged_ms = (time.perf_counter() - t0) * 1e3
    for i, (staged_i, args, got) in enumerate(results):
        check(i, staged_i, args, got, "prefetch_to_device")
    if len(results) != PREFETCH_BATCHES:
        raise AssertionError(f"prefetch: {len(results)} of {PREFETCH_BATCHES} batches")

    def on_card(i, args):
        card = [torch.from_numpy(a).to(dev) for a in args]
        return torch.from_numpy(i).to(dev), card, genotype_forward(*card)

    piped = pipelined_map(lambda k: tuple(batch(PREFETCH_BATCHES + k).values()), on_card, n_batches=PREFETCH_BATCHES)
    for k, (staged_i, args, got) in enumerate(piped):
        check(PREFETCH_BATCHES + k, staged_i, args, got, "pipelined_map")
    print(f"prefetch: prefetch_to_device staged {PREFETCH_BATCHES} batches of 4096 x 160 reads on {dev} (pinned,"
          f" side stream) in order, {staged_ms:.3f} ms with their genotype_forward steps (host clock);"
          f" pipelined_map {PREFETCH_BATCHES} more; every step equal to the CPU's", flush=True)
    return dict(ms=staged_ms)


def mesh_phase(dev):
    """entry.dryrun_multichip(4): the whole genotype pipeline with every call
    iteration's scoring over a 2 x 2 mesh of `dev` taken four times, against
    the single-device run (equal record lines and discovery sites), then the
    fused step over the mesh against the unsharded step."""
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.entry import dryrun_multichip

    counters.reset()
    t0 = time.perf_counter()
    out = dryrun_multichip(4, device=dev)
    wall = time.perf_counter() - t0
    seen = counters.totals()
    if dev.type == "cuda":
        _no_plain(seen, "mesh")
    print(f"mesh: dryrun_multichip(4) on {dev} in {wall:.3f} s: {out['n_records']} records equal, scoring rows"
          f" per shard {out['shard_rows']}; counters {json.dumps(seen, sort_keys=True)}", flush=True)
    return dict(wall=wall, counters=seen, **out)


DIST_CHILD = r"""
import contextlib, io, json, os, sys, time
rank, device, port1, port2, meta = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
sys.path.insert(0, meta["repo"])
from graphtyper_tpu_torch import cli, counters
from graphtyper_tpu_torch.parallel import distributed
runs = {}
distributed.initialize(f"127.0.0.1:{port1}", 2, rank)
n = len(meta["sams"])
for rep in ("0", "1"):
    os.environ["GT_REP_SHARD"] = rep
    counters.reset()
    t0 = time.perf_counter()
    out = distributed.genotype_distributed(meta["fasta"], meta["sams"], meta["region"], meta[f"out{rep}"], device)
    runs[f"rep_shard={rep}"] = dict(out=out, wall=time.perf_counter() - t0, counters=counters.totals(),
                                    work=f"samples {n * rank // 2}-{n * (rank + 1) // 2 - 1} of {n}")
distributed.shutdown()
os.environ.pop("GT_REP_SHARD")
counters.reset()
printed = io.StringIO()
t0 = time.perf_counter()
with contextlib.redirect_stdout(printed):
    rc = cli.main(["genotype", meta["cli_fasta"], "--region_file", meta["region_file"], "-O", meta["cli_out"],
                   "--device", device, "--threads", "4", "--num_hosts", "2", "--host_id", str(rank),
                   "--coordinator", f"127.0.0.1:{port2}", *meta["cli_sams"]])
with open(meta["region_file"]) as f:
    regions = [line.strip() for line in f if line.strip()]
runs["cli"] = dict(out=printed.getvalue().split(), wall=time.perf_counter() - t0, counters=counters.totals(),
                   work="region " + ", ".join(distributed.assign_regions(regions, 2, rank)))
assert rc == 0, rc
print("DIST_CHILD " + json.dumps(runs))
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_phase(work, dev):
    """Two child processes joined by a gloo process group at 127.0.0.1, both
    on `dev` with GT_DEVICE_ALIGN=on: genotype_distributed on DIST_E2E's
    cohort, plain and with GT_REP_SHARD=1, whose host-0 VCF must equal this
    process's single-process run on `dev`; then the CLI's genotype
    --num_hosts 2 --host_id 0|1 --coordinator on DIST_CLI's two regions,
    whose union must equal this process's single-process CLI. Each child's
    sw_rot and device_align launches (on the card) must be above 0."""
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.pipeline.genotype import genotype
    from graphtyper_tpu_torch.simulate import SimConfig, simulate_cohort

    root = os.path.join(work, "dist")
    e2e, two = SimConfig(**DIST_E2E), SimConfig(**DIST_CLI)
    sim = simulate_cohort(os.path.join(root, "e2e"), e2e)
    sim2 = simulate_cohort(os.path.join(root, "two"), two)
    region = f"{e2e.chrom}:1-{e2e.region_length}"
    region_file = os.path.join(root, "regions.txt")
    with open(region_file, "w") as f:
        f.write(f"{two.chrom}:1-50000\n{two.chrom}:50001-100000\n")

    t0 = time.perf_counter()
    os.environ["GT_DEVICE_ALIGN"] = "on"
    try:
        counters.reset()
        single = _md5([genotype(sim.fasta, sim.sams, region, os.path.join(root, "single"), dev)])
        single_seen = counters.totals()
    finally:
        os.environ.pop("GT_DEVICE_ALIGN")
    single_cli, cli_seen, _ = _cli_in_process(
        ["genotype", sim2.fasta, "--region_file", region_file, "-O", os.path.join(root, "single_cli"),
         "--device", str(dev), "--threads", "4", *sim2.sams], "on")
    single_wall = time.perf_counter() - t0

    meta = dict(repo=HERE, fasta=sim.fasta, sams=sim.sams, region=region, cli_fasta=sim2.fasta,
                cli_sams=sim2.sams, region_file=region_file, cli_out=os.path.join(root, "cli"),
                out0=os.path.join(root, "dist0"), out1=os.path.join(root, "dist1"))
    env = dict(os.environ, GT_DEVICE_ALIGN="on", GLOO_SOCKET_IFNAME="lo")
    ports = [str(_free_port()), str(_free_port())]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", DIST_CHILD, str(r), str(dev), *ports, json.dumps(meta)],
                              cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=DIST_TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    children = []
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        lines = [line for line in stdout.splitlines() if line.startswith("DIST_CHILD ")]
        if p.returncode != 0 or not lines:
            raise RuntimeError(f"dist: child {r} exited {p.returncode}:\n{stdout[-2000:]}\n{stderr[-4000:]}")
        children.append(json.loads(lines[-1][len("DIST_CHILD "):]))
    for rep in ("0", "1"):
        runs = [c[f"rep_shard={rep}"] for c in children]
        if runs[1]["out"] is not None or runs[0]["out"] is None or _md5([runs[0]["out"]]) != single:
            raise AssertionError(f"dist: genotype_distributed (GT_REP_SHARD={rep}) differs from the single run:"
                                 f" {runs[0]['out']}")
    cli_files = sorted(p for c in children for p in c["cli"]["out"])
    if [os.path.relpath(p, meta["cli_out"]) for p in cli_files] != [
            os.path.relpath(p, os.path.join(root, "single_cli")) for p in single_cli] or _md5(cli_files) != _md5(single_cli):
        raise AssertionError(f"dist: the CLI's --num_hosts 2 outputs differ from the single run: {cli_files}")
    launches = []
    for r, c in enumerate(children):
        total = {k: sum(run["counters"].get(k, 0) for run in c.values())
                 for k in ("sw_rot", "device_align", "apply_tier", "segment_counters")}
        launches.append(total)
        if dev.type == "cuda":
            for run in c.values():
                _no_plain(run["counters"], f"dist child {r}")
            if min(total.values()) <= 0:
                raise AssertionError(f"dist: child {r} launched no sw_rot, device_align, apply_tier or"
                                     f" segment_counters: {total}")
    print(f"dist: two processes (gloo, 127.0.0.1) on {dev} with GT_DEVICE_ALIGN=on in {wall:.3f} s (single-process"
          f" runs {single_wall:.3f} s): genotype_distributed on {e2e.region_length // 1000} kb, {e2e.n_samples} samples,"
          f" {sim.n_reads} reads, plain and GT_REP_SHARD=1, host 0's md5 {single} == single process; CLI --num_hosts 2"
          f" on two 50 kb regions: {len(cli_files)} VCFs, md5 {_md5(cli_files)} == single process; per child"
          f" launches {launches}; sw_rot launches by child and run, with the run's work: " + json.dumps(
              [{k: f"{v['counters'].get('sw_rot', 0)} ({v['work']})" for k, v in c.items()} for c in children])
          + "; walls " + json.dumps(
              [{k: round(v["wall"], 3) for k, v in c.items()} for c in children])
          + f"; single run counters {json.dumps(single_seen, sort_keys=True)}, CLI {json.dumps(cli_seen, sort_keys=True)}",
          flush=True)
    return dict(wall=wall, launches=launches, children=children)


def _cram_containers(path):
    """(file offset, records) of each data container of a CRAM, read from
    the container headers, in file order."""
    from graphtyper_tpu_torch.io.cram import ByteReader, read_container_header

    with open(path, "rb") as f:
        data = f.read()
    major = data[4]
    br = ByteReader(data, 26)
    hdr = read_container_header(br, major)  # the SAM header's container
    br.pos += hdr.length
    out = []
    while not br.eof():
        off = br.pos
        hdr = read_container_header(br, major)
        br.pos += hdr.length
        if hdr.n_records:
            out.append((off, hdr.n_records))
    return out


def indep_phase(work):
    """The INDEP CRAM cohorts, built by the port's utils/simulate_indep.py:
    each through the port's CLI on cuda in process, then on --device cpu in
    a subprocess (one md5, no plain version on the card; sw_rot launched on
    the recall cohort). Then write_crai on the bench cohort's CRAM, read_crai
    back, and crai_query over INDEP_CRAI_WINDOW, which must return every
    container that holds a record overlapping the window (the containers'
    records counted from their headers, the records decoded in file order).
    Returns {cohort: (counters, wall s)}."""
    from graphtyper_tpu_torch.simulate import IndepConfig, simulate_indep

    out = {}
    for name, kw in INDEP:
        cfg = IndepConfig(**kw)
        t0 = time.perf_counter()
        sim = simulate_indep(os.path.join(work, "indep", name, "sim"), cfg)
        built = time.perf_counter() - t0

        def argv(out_dir, device):
            return ["genotype", sim.fasta, "--region", f"{cfg.chrom}:1-{cfg.region_length}", "-O", out_dir,
                    "--threads", str(THREADS), "--device", device, *_sam_flags(sim.sams)]

        runs, md5, files = card_and_cpu(os.path.join(work, "indep"), name, argv, [("cuda", "", {})])
        out[name] = runs["cuda"]
        what = (f"{name}: genotype {cfg.chrom}:1-{cfg.region_length}, {cfg.coverage:g}x, seed {cfg.seed}, "
                f"{sim.n_reads} reads of 1 sample as CRAM (built in {built:.3f} s)")
        if name == "recall" and runs["cuda"][0].get("sw_rot", 0) <= 0:
            raise AssertionError(f"indep {what}: discovery did not launch sw_rot: {runs['cuda'][0]}")
        if name == "bench":
            what += "; crai: " + _crai_check(sim.sams[0], os.path.join(work, "indep", "bench.cram.crai"))
        _phase_line("indep", what, runs, sim.n_reads, md5, files)
    return out


def _crai_check(cram, crai_path):
    """write_crai, read_crai and crai_query over INDEP_CRAI_WINDOW against
    the containers that hold records there; returns the phase line's text."""
    from graphtyper_tpu_torch.io.crai import crai_query, read_crai, write_crai
    from graphtyper_tpu_torch.io.cram import read_cram

    entries = read_crai(write_crai(cram, crai_path))
    beg, end = INDEP_CRAI_WINDOW
    got = {e.container_offset for e in crai_query(entries, 0, beg, end)}
    _, reads = read_cram(cram)
    containers = _cram_containers(cram)
    if sum(n for _, n in containers) != len(reads):
        raise AssertionError(f"indep: the container headers count {sum(n for _, n in containers)} records, "
                             f"the decode {len(reads)}")
    want, i = set(), 0
    for off, n in containers:
        if any(r.ref_id == 0 and r.pos < end and r.pos + max(1, r.reference_length()) > beg
               for r in reads[i : i + n]):
            want.add(off)
        i += n
    if not want or not want <= got:
        raise AssertionError(f"indep: crai_query over [{beg}, {end}) gave containers {sorted(got)}, "
                             f"the records need {sorted(want)}")
    return (f"{len(entries)} slices in {len(containers)} containers; the query over [{beg}, {end}) gives "
            f"{len(got)}, every one of the {len(want)} with records there among them")


def fuzz_phase(work):
    """tools/fuzz_diff.py's legs for FUZZ_SEED on cuda, against the port's
    own cuda run of the seed: 0 failures, each leg's wall."""
    from graphtyper_tpu_torch import counters
    from graphtyper_tpu_torch.tools.fuzz_diff import fuzz_seed

    counters.reset()
    t0 = time.perf_counter()
    res = fuzz_seed(FUZZ_SEED, os.path.join(work, "fuzz"), "cuda")
    wall = time.perf_counter() - t0
    seen = counters.totals()
    if res.fails:
        raise AssertionError(f"fuzz seed {FUZZ_SEED}: {len(res.fails)} failures: {res.fails}")
    for leg in ("bai", "cram", "cram_pyrans", "sam", "cpu", "device_align", "device_seed"):
        if leg not in res.walls:
            raise AssertionError(f"fuzz seed {FUZZ_SEED}: the {leg} leg did not run")
    print(f"fuzz: tools/fuzz_diff seed {FUZZ_SEED} on cuda ({len(res.sim.sams)} samples, {res.region}, "
          f"{res.sim.n_reads} reads), {len(res.walls) - 1} legs against the reference run, 0 failures, in "
          f"{wall:.3f} s; leg walls (s) {json.dumps({k: round(v, 3) for k, v in res.walls.items()})}; "
          f"counters {json.dumps(seen, sort_keys=True)}", flush=True)
    return dict(wall=wall, counters=seen)


def soak_phase(work):
    """tools/soak_population.py at tests/pipeline/test_population_soak.py's
    small recipe with 4 region workers, on cuda (GT_SCORING_STATS set) and
    on --device cpu, each in a subprocess on one cached cohort: one md5,
    the peak tree RSS (and the orchestrator's and the workers' apart),
    reads/s, and the summed device_rows, device_wall_s and h2d_bytes of the
    card run's telemetry lines."""
    cache = os.path.join(work, "soak")
    stats = os.path.join(work, "soak_stats.jsonl")
    out = {}
    for device in ("cuda", "cpu"):
        env = dict(os.environ)
        if device == "cuda":
            env["GT_SCORING_STATS"] = stats
        else:
            env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.run([sys.executable, "-m", "graphtyper_tpu_torch.tools.soak_population", *SOAK,
                               "--device", device, "--cache", cache], cwd=HERE, capture_output=True, text=True,
                              env=env, timeout=SOAK_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"soak on {device} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        lines = proc.stdout.strip().splitlines()
        if not lines[-2].startswith("rss: ") or not lines[-3].startswith("counters: "):
            raise AssertionError(f"soak on {device}: unexpected output {lines[-3:]}")
        out[device] = dict(result=json.loads(lines[-1]), rss=lines[-2],
                           counters=json.loads(lines[-3][len("counters: "):]))
    card, host = out["cuda"]["result"], out["cpu"]["result"]
    if card["md5"] != host["md5"] or card["n_records"] != host["n_records"] or card["n_records"] <= 0:
        raise AssertionError(f"soak: the card's records differ from the CPU device's: {card} vs {host}")
    seen = out["cuda"]["counters"]
    _no_plain(seen, "soak")
    if seen.get("scoring_rows", 0) <= 0:
        raise AssertionError(f"soak: no scoring rows on the card: {seen}")
    tel = {"device_rows": 0, "device_wall_s": 0.0, "h2d_bytes": 0, "host_rows": 0}
    with open(stats) as f:
        n_lines = 0
        for line in f:
            d = json.loads(line)
            n_lines += 1
            for k in tel:
                tel[k] += d[k]
    if tel["device_rows"] != seen["scoring_rows"] or tel["host_rows"] or tel["h2d_bytes"] <= 0:
        raise AssertionError(f"soak: GT_SCORING_STATS {tel} against the counters {seen}")
    print(f"soak: tools/soak_population {' '.join(SOAK)}: {card['n_reads']} reads; cuda {card['wall_s']:.3f} s ="
          f" {card['reads_per_sec']:.1f} reads/s, peak tree RSS {card['peak_tree_rss_mb']:.1f} MB"
          f" ({out['cuda']['rss']}); cpu {host['wall_s']:.3f} s = {host['reads_per_sec']:.1f} reads/s, peak"
          f" tree RSS {host['peak_tree_rss_mb']:.1f} MB; GT_SCORING_STATS of the card run: {n_lines} lines,"
          f" device_rows {tel['device_rows']}, device_wall_s {tel['device_wall_s']:.4f}, h2d_bytes"
          f" {tel['h2d_bytes']}; counters {json.dumps(seen, sort_keys=True)}; {card['n_records']} records,"
          f" md5 {card['md5']} == --device cpu", flush=True)
    return dict(counters=seen, **out)


def benchtools_phase(work):
    """BENCHTOOLS, each in a subprocess, all at once; each must exit 0, and
    its md5 agree where it has one."""
    from concurrent.futures import ThreadPoolExecutor

    def run(argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"graphtyper_tpu_torch.tools.{argv[0]}", *argv[1:]], cwd=HERE,
                              capture_output=True, text=True, timeout=BENCHTOOLS_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"benchtools: {argv[0]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        return argv[0], time.perf_counter() - t0, proc.stdout.strip().splitlines()

    with ThreadPoolExecutor(len(BENCHTOOLS)) as ex:
        done = {name: (wall, lines) for name, wall, lines in ex.map(run, BENCHTOOLS)}

    def last(name):
        return json.loads(done[name][1][-1])

    dist = last("bench_distributed")
    for mode in ("sample_sharded", "region_sharded"):
        if dist[mode]["md5_single"] != dist[mode]["md5_two_host"]:
            raise AssertionError(f"benchtools: bench_distributed {mode} {dist}")
    flush = last("bench_flush")
    lr = dict(kv.split("=") for kv in done["bench_lr"][1][-1].split())
    lines = {
        "bench_flush": f"{flush['rows']} rows x {flush['samples']} samples: steady {flush['device_ms_steady']:.3f}"
                       f" ms, first {flush['device_ms_first']:.3f} ms, compute {flush['device_compute_ms']:.3f} ms,"
                       f" cpu {flush['host_ms']:.3f} ms, {flush['cuda_kernels_per_flush']} CUDA kernels; totals"
                       f" equal to the CPU's",
        "bench_lr": f"--kb 50: {lr['records']} records, {lr['snps']} SNPs, {lr['wall']} (host only)",
        "bench_distributed": f"4 x 50 kb: sample-sharded t1 {dist['t1_s']:.3f} s, t2 {dist['t2_s']:.3f} s;"
                             f" region-sharded t1 {dist['region_sharded']['t1_single_host_s']:.3f} s, t2"
                             f" {dist['region_sharded']['t2_two_host_s']:.3f} s; two ranks' md5 == one process's"
                             f" ({dist['sample_sharded']['md5_single']})",
    }
    for tool, text in lines.items():
        print(f"benchtools: {tool}: {text}; wall {done[tool][0]:.3f} s", flush=True)
    return done


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "graphtyper_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.append(os.path.join(HERE, "tests"))  # test_torch_sw_batches
    import numpy as np

    def smi(query):
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    print(smi("name,power.limit"))
    walls, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        walls[name] = now - last[0]
        last[0] = now
    sm_clock = float(smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: torch {torch.__version__}, torch.version.cuda {torch.version.cuda},"
          f" {n_sm} SMs, max SM clock {sm_clock:.0f} MHz; Python {sys.version.split()[0]}", flush=True)

    from graphtyper_tpu_torch import kernels
    from graphtyper_tpu_torch.io.native import engine_path
    from graphtyper_tpu_torch.tools.bench_scoring import capture_flushes

    t0 = time.perf_counter()
    lib = kernels.library_path()
    band_rows = kernels.load().gt_sw_rot_band_rows()
    built = time.perf_counter() - t0
    print(f"kernels: built {os.path.relpath(lib, HERE)} in {built:.3f} s", flush=True)
    t0 = time.perf_counter()
    engine = engine_path()
    print(f"engine: built {os.path.relpath(engine, HERE)} in {time.perf_counter() - t0:.3f} s",
          flush=True)
    lap("build")

    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    empty_ms = _time_ms(lambda: one.add_(1))
    print(f"empty launch: a one-element torch op takes {empty_ms:.4f} ms (CUDA events)", flush=True)

    def bound(arrays):
        Q, ql, D, dl = arrays
        return sw_bound(np, ql, dl, D.shape[1], len(ql), Q.shape[1], sm_clock, n_sm)

    def floor(arrays):
        Q, ql, D, dl = arrays
        return rot_floor(ql, dl, Q.shape[1], D.shape[1], band_rows, sm_clock, empty_ms)

    rot = kernel_phase(torch, np, dev)
    row = row_phase(torch, np, dev, rot["max_abs_err"], bound, floor)
    rows = rows_phase(torch, np, dev, band_rows)
    realign = realign_phase(torch, np, dev)
    lap("kernel, row, rows, realign")
    row_launches = bench_phase("--row")["launches"].get("sw_row", 0)
    bench_phase("--rot")
    lap("bench")
    rot_launches = 0
    scored = {"apply_tier": 0, "segment_counters": 0}  # the two scoring kernels' launches on the paths

    def count(seen):
        for k in scored:
            scored[k] += seen.get(k, 0)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        sims = {}
        for name, sim_kw in SLICES:
            seen, *sims[name] = slice_phase(work, name, sim_kw)
            rot_launches += seen["sw_rot"]
            count(seen)
            lap(f"slice {name}")
        # the 200kb slice's scoring flushes, for the scoring phase; its launches are not counted
        captured = capture_flushes(*sims["200kb"], os.path.join(work, "capture"), threads=THREADS)
        lap("capture")
        pools = pools_phase(work)
        lap("pools")
        align = align_phase(torch, np, work, dev)
        lap("align")
        sv = sv_phase(work)
        lap("sv")
        camou = camou_phase(work)
        lap("camou")
        hla = hla_phase(work)
        lap("hla")
        discover = discover_phase(work, *sims["sw"])
        lap("discover")
        mesh = mesh_phase(dev)
        lap("mesh")
        dist = dist_phase(work, dev)
        lap("dist")
        indep = indep_phase(work)
        lap("indep")
        fuzz = fuzz_phase(work)
        lap("fuzz")
        soak = soak_phase(work)
        lap("soak")
        benchtools_phase(work)
        lap("benchtools")
    for runs in (pools, camou, discover, indep):
        rot_launches += sum(seen.get("sw_rot", 0) for seen, _ in runs.values())
    for runs in (pools, sv, camou, hla, discover, indep):
        for seen, _ in runs.values():
            count(seen)
    count(align["launches"])
    for seen in (mesh["counters"], fuzz["counters"], soak["counters"], *dist["launches"]):
        count(seen)
    for seen in (fuzz["counters"], soak["counters"]):
        rot_launches += seen.get("sw_rot", 0)
        for k in ("device_align", "seed_probe"):
            align["launches"][k] += seen.get(k, 0)
    for runs in (pools, camou):
        align["launches"]["device_align"] += sum(seen.get("device_align", 0) for seen, _ in runs.values())
    rot_launches += mesh["counters"].get("sw_rot", 0)
    for child in dist["launches"]:
        rot_launches += child["sw_rot"]
        align["launches"]["device_align"] += child["device_align"]
    if row_launches <= 0:
        raise AssertionError("tools.bench_sw --row did not launch the row kernel")
    inputs = kernel_inputs(align)
    verdict = verdict_phase(torch, np, dev, inputs, sm_clock, n_sm)
    seed = seed_phase(torch, np, dev, inputs, sm_clock, n_sm)
    gather = gather_phase(dev, verdict, seed)
    lap("verdict, seed, gather")
    scoring = scoring_phase(torch, np, dev, captured)
    lap("scoring")
    forward_phase(torch, np, dev, sm_clock, n_sm)
    lap("forward")
    prefetch_phase(torch, np, dev)
    lap("prefetch")
    print("walls: each phase's seconds, host clock: " + json.dumps({k: round(v, 3) for k, v in walls.items()})
          + f"; total {sum(walls.values()):.3f} s", flush=True)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "graphtyper_tpu"))
    if loaded:
        raise AssertionError(f"the port imported jax or the JAX package: {loaded[:10]}")

    def gather_entry(name, source, replaces, times):
        """A kernels-line entry timed at KERNEL_ROWS rows, with every input's
        time, bound and gather-ceiling time under `shapes`."""
        big = times[f"{KERNEL_ROWS}_rows"]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=align["launches"][name],
                    max_abs_err=max(v["max_abs_err"] for v in times.values()), ms=big["ms"],
                    plain_ms=big["plain_ms"], bound_ms=big["bound"][0], bound_by=big["bound"][1],
                    library_ms=None, gather_gloads_per_s=gather[name]["gloads_per_s"],
                    gathers=big["gathers"], gather_ms=big["gather_ms"],
                    shapes=[dict(shape=f"{n}: {v['rows']} rows, S {v['S']}, nk {v['nk']}", ms=v["ms"],
                                 plain_ms=v["plain_ms"], bound_ms=v["bound"][0], bound_by=v["bound"][1],
                                 gathers=v["gathers"], gather_ms=v["gather_ms"])
                            for n, v in times.items()])

    def scoring_entry(name, source, replaces, top):
        """A kernels-line entry timed at the shape `top`, with every shape's
        times, bound, device operations and device time under `shapes`."""
        times = scoring[name]
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=scored[name],
                    max_abs_err=max(v["max_abs_err"] for v in times.values()), ms=times[top]["ms"],
                    plain_ms=times[top]["plain_ms"], bound_ms=times[top]["bound"][0],
                    bound_by=times[top]["bound"][1], library_ms=None, device_ops=times[top]["device_ops"],
                    device_us=times[top]["device_us"],
                    shapes=[dict(shape=k, ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
                                 device_ops=v["device_ops"], device_us=v["device_us"],
                                 **{c: v[c] for c in ("pageable_copy_ms", "pinned_copy_ms") if c in v})
                            for k, v in times.items()])

    for k, n in scored.items():
        if n <= 0:
            raise AssertionError(f"the main paths launched no {k}")
    main = row["times"]["main"]
    bound_ms, bound_by = main["bound"]
    common = dict(route="cuda", bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print(json.dumps({"kernels": [
        dict(name="sw_rot", source="graphtyper_tpu_torch/csrc/sw_rot.cu",
             replaces="graphtyper_tpu/ops/sw_rot.py:282", launches=rot_launches,
             max_abs_err=row["rot_err"], ms=rot["ms"], plain_ms=rot["plain_ms"], **common,
             shapes=[dict(shape=name, ms=tm["rot_ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound"][0])
                     for name, tm in row["times"].items()],
             empty_launch_ms=empty_ms,
             align_batch_ms={str(B): v["host_ms"] for B, v in realign.items()},
             rows_ms={str(B): v for B, v in rows.items()}),
        dict(name="sw_row", source="graphtyper_tpu_torch/csrc/sw_row.cu",
             replaces="graphtyper_tpu/ops/sw_pallas.py:257", launches=row_launches,
             max_abs_err=row["max_abs_err"], ms=main["row_ms"], plain_ms=main["plain_ms"], **common),
        gather_entry("device_align", "graphtyper_tpu_torch/csrc/device_align.cu",
                     "graphtyper_tpu/ops/device_align.py:107", verdict),
        gather_entry("seed_probe", "graphtyper_tpu_torch/csrc/seed_probe.cu",
                     "graphtyper_tpu/ops/seed_probe.py:92", seed),
        dict(scoring_entry("apply_tier", "graphtyper_tpu_torch/csrc/site_scoring.cu",
                           "graphtyper_tpu/ops/site_scoring.py:141", f"A2_{SCORING_ROWS[-1]}"),
             main_path_flushes=scoring["main_path"]),
        scoring_entry("segment_counters", "graphtyper_tpu_torch/csrc/discovery_pileup.cu",
                      "graphtyper_tpu/ops/discovery_pileup.py:85", f"{PILEUP_SHAPES[-1][0]}_rows"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
