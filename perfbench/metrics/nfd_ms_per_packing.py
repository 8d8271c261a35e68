"""Milliseconds of one full NFD pass, the engines' start packing (the
program's span ``nfd.scratch``, its kind assignment included), mean over
the half without the profiler."""
from perfbench import program

SPANS = program.SPANS
program.arm()


def read(run):
    program.report(run)
    return program.per(run, ("nfd.scratch",), "nfd.scratch", 1e3)
