"""Host microseconds of an SA fleet step's proposal: its draws and moves
(the program's span ``sa.propose``, mean), in the half without the
profiler."""
from perfbench import program

SPANS = program.SPANS
program.arm()


def read(run):
    program.report(run)
    return program.per(run, ("sa.propose",), "sa.propose", 1e6)
