"""Command-line tools of the port (python -m graphtyper_tpu_torch.tools.<name>).
The port is measured by `python3 -m benchmark.run` and its spans; these
tools serve kernel work and correctness checks:

    bench_sw, bench_align             the SW kernels; the gather ceiling
    bench_scoring, bench_flush        the scoring and pileup kernels; a flush
    bench_sv                          the SV cohort (build_cohort) and one run
    bench_lr                          the long-read simulator and genotype_lr
    bench_distributed                 two processes against one
    fuzz_diff                         cross-path differential fuzzing
    soak_population                   a population cohort's wall and RSS
"""
