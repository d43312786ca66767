"""Host ms finalizing launches' results (the program's ``engine.finalize``
spans) in the traced slice, per engine launch."""
from bench.harness import program_spans


def read(run):
    return program_spans.per_launch(run, "engine.finalize")
