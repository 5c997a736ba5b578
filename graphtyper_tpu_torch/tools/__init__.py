"""Command-line tools of the port (python -m graphtyper_tpu_torch.tools.<name>):

    bench_sw, bench_sv, bench_align   kernel and workload benchmarks
    fuzz_diff                         cross-path differential fuzzing
    soak_population                   a population cohort's wall and RSS
    stage_ledger                      per-stage walls of one genotype run
    bench                             the headline bench (bench.py): one JSON line
    bench_flush, bench_ab,            a scoring flush; device variants A/B;
    bench_configs, bench_lr,          BASELINE configs 1, 2, 4; genotype_lr;
    bench_distributed                 two processes against one (config 5)
"""
