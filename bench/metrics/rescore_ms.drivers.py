"""Mean host ms of one dense re-score (the program's ``search.rescore``
spans, their host read included) in the traced slice."""
from bench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, "search.rescore")
