"""The warm-up job's wall, inside set-up: where the job has more than one
unit, it starts the region workers, each of which imports torch and opens
its CUDA context."""


def read(run):
    return run.warmup_s
