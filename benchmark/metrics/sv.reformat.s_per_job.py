"""Self seconds of the port's `sv.reformat` spans (`reformat_sv_vcf_records`
in an SV call pool: each SV's BREAKPOINT records combined into its
AGGREGATED record) in the window, summed over every process and thread, a
job of the window; nothing where the run recorded no such span."""

from benchmark.spans import clip, self_pieces

NAMES = ("sv.reformat",)


def read(run):
    inside = clip(run.spans, run.window)
    if not run.jobs or not any(s.name in NAMES for s in inside):
        return None
    return sum(b - a for a, b, name in self_pieces(inside) if name in NAMES) / 1e9 / len(run.jobs)
