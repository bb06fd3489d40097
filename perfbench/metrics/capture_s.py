"""Seconds of set-up the engine spent on its CUDA graphs: each graph's
warm-up calls and its capture (the engine's ``capture_seconds`` counter)."""

from perfbench.harness import program_spans


def read(run):
    return program_spans.counter(run, "capture_seconds")
