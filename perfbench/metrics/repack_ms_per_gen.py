"""Milliseconds a GA generation spends in NFD repacks, its mutation
operator (the program's span ``nfd.repack`` over its ``ga.selection``
spans, one a generation), in the half without the profiler."""
from perfbench import program

SPANS = program.SPANS
program.arm()


def read(run):
    program.report(run)
    return program.per(run, ("nfd.repack",), "ga.selection", 1e3)
