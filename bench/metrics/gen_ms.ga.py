"""Mean host ms of one GA generation (the program's ``ga.generation`` spans:
the host's enqueue of the generation, its operator calls included) in the
traced slice."""
from bench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, "ga.generation")
