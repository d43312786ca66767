"""Host ms blocked on staged device-to-host copies (the program's
``engine.sync`` spans) in the traced slice, per engine launch."""
from bench.harness import program_spans


def read(run):
    return program_spans.per_launch(run, "engine.sync")
