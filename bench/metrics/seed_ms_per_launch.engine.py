"""Host ms seeding a plan (the program's ``engine.seed`` spans: the
rejection rounds with their host reads, or the direct seeder) in the traced
slice, per engine launch."""
from bench.harness import program_spans


def read(run):
    return program_spans.per_launch(run, "engine.seed")
