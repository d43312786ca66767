"""Rejection-seeder rounds (the program's ``engine.seed_round`` spans, one
host read each) in the traced slice, per engine launch."""
from bench.harness import program_spans


def read(run):
    return program_spans.per_launch(run, "engine.seed_round", count=True)
