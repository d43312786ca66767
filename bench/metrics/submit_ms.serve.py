"""Mean host ms of one service submit (the program's ``serve.submit``
spans: validation, cache lookup, the ingest table prefill) in the traced
slice."""
from bench.harness import program_spans


def read(run):
    return program_spans.mean_ms(run, "serve.submit")
