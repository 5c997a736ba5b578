"""Per-read scoring with device-applied observations.

Port of graphtyper_tpu/typer/scoring.py:58 SiteScorer: the JAX package's
scorer built without its batcher, then given the port's `ObsBatcher` on
the device it is handed. Extraction, connections and the >64-allele host
path are inherited unchanged. `Options.device_scoring="off"`, which picks
that host loop for every site in the JAX package, is refused.
"""

from __future__ import annotations

import torch

from graphtyper_tpu.config import current_options
from graphtyper_tpu.typer import scoring as _ref
from graphtyper_tpu_torch.ops.site_scoring import ObsBatcher, tier_for


class SiteScorer(_ref.SiteScorer):
    def __init__(self, graph, sample_names: list[str], device: torch.device | str,
                 hq_reads: bool = False):
        if current_options().device_scoring == "off":
            raise ValueError("device_scoring='off' selects the JAX package's host scoring loop; "
                             "the torch port scores on its device only")
        super().__init__(graph, sample_names, hq_reads=hq_reads, device_scoring=False)
        self.batcher = ObsBatcher(self.sites, len(sample_names), device)
        self._tier_for = tier_for
