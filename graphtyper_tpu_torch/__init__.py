"""PyTorch + CUDA port of graphtyper_tpu for one NVIDIA H100.

The port imports the backend-free host layer (io/, graph/, index/, models/,
the C++ engine) from `graphtyper_tpu` and owns only what touches a device:
its ops/, the seam functions of typer/ and pipeline/ that call them, and the
hand-written CUDA kernels under csrc/. It never imports jax.

Entry point: python -m graphtyper_tpu_torch.cli genotype ref.fa --sam ... -O out

Device options of `graphtyper_tpu.config.Options`, as the port reads them:
`device_sw` and `device_discovery` take "auto" and "on" as one value, the
work always going to the device it is given, whatever its size; "off"
keeps the shared host path. `device_scoring="off"` is refused: the port
scores on its device only. `device_seed` and `device_align` raise
NotImplementedError when turned on (not ported yet).

Importing the package makes sure the shared C++ engine can load (host.py).
"""

from graphtyper_tpu_torch.host import ensure_native_runtime as _ensure_native_runtime

_ensure_native_runtime()
