"""Share (%) of the GA's generations (the program's ``ga.generation``
spans) that replayed captured CUDA graphs (the ``ga.graph_replay`` spans
nested in them) in the traced slice.  ``None`` where the slice has no
generation, or where the program has no captured generations (a tree
older than ``repro_torch.core.ga.GRAPH_CACHE_KEYS``)."""
import sys

from bench.harness import program_spans


def read(run):
    ga = sys.modules.get("repro_torch.core.ga")
    if getattr(ga, "GRAPH_CACHE_KEYS", None) is None:
        return None
    s = program_spans.sums(run) or {}
    gens = s.get("ga.generation", (0, 0.0))[0]
    if not gens:
        return None
    return 100.0 * s.get("ga.graph_replay", (0, 0.0))[0] / gens
