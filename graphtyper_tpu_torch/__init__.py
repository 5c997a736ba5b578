"""PyTorch + CUDA port of graphtyper_tpu for one NVIDIA H100.

The port stands alone: it imports nothing of `graphtyper_tpu`. Its
backend-free host layer (io/, graph/, index/, models/, most of typer/ and
utils/) is a copy of the JAX package's, with only the import lines
rewritten. It builds the C++ engine itself from the repository's
native/*.cpp into kernel_build/ (io/native.py). What touches a device is its
own: ops/, the seam modules of typer/ and pipeline/ that call them, and the
hand-written CUDA kernels under csrc/. It never imports jax.

Entry points:
    python -m graphtyper_tpu_torch.cli genotype ref.fa --sam ... -O out
    python -m graphtyper_tpu_torch.tools.bench_sw [--row|--rot]

Device options of `graphtyper_tpu_torch.config.Options`, as the port reads
them: `device_sw` and `device_discovery` take "auto" and "on" as one value,
the work always going to the device it is given, whatever its size; "off"
keeps the host path. `device_scoring="off"` is refused: the port scores on
its device only. `device_seed` and `device_align` raise
NotImplementedError when turned on (not ported yet).

Importing the package makes sure the C++ engine's runtime can load
(host.py).
"""

from graphtyper_tpu_torch.host import ensure_native_runtime as _ensure_native_runtime

_ensure_native_runtime()
