"""Seconds the engine's construction took: the model built with its seeded
init, the weights and constraints loaded (the engine's ``load_seconds``,
which covers the whole construction)."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.counter(run, "load_seconds")
