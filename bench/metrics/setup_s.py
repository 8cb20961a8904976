"""setup_s (s, host clock): from the process's start to the window's start:
imports, the kernels' build or load, the weights' draw, the engine, the
warm-up and the fill or ramp the cell's traffic needs."""


def read(run):
    return run.setup_s
