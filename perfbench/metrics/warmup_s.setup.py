"""Seconds of the set-up spent in the cell's warm-up call (the program's
entry spans that ended before the first half: kernel load or nvcc build,
the card's first use, the first pinned buffers); its split is printed
(``[program] setup``)."""
from perfbench import program

SPANS = program.SPANS
program.arm()


def read(run):
    program.report(run)
    return program.entry_seconds(program.setup(run)) or None
