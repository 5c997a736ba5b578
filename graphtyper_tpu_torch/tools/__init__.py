"""Command-line tools of the port (python -m graphtyper_tpu_torch.tools.<name>):

    bench_sw, bench_sv, bench_align   kernel and workload benchmarks
    fuzz_diff                         cross-path differential fuzzing
    soak_population                   a population cohort's wall and RSS
    stage_ledger                      per-stage walls of one genotype run
"""
