"""Milliseconds a full NFD pass spends assigning RAM kinds against the
inventory (the program's span ``nfd.kinds`` over its ``nfd.scratch``
spans), in the half without the profiler."""
from perfbench import program

SPANS = program.SPANS
program.arm()


def read(run):
    program.report(run)
    return program.per(run, ("nfd.kinds",), "nfd.scratch", 1e3)
