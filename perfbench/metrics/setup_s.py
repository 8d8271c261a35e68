"""Set-up seconds: from the harness's first line to the window's start
(interpreter, torch and the card, the port's import, the kernels' load or
build, the cell's problems and its warm-up)."""


def read(run):
    return run.setup_s
