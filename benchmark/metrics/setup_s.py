"""setup_s: seconds from the process's start to the end of set-up
(imports, CUDA start, kernel builds or loads, the cell's mesh and problem,
its warm request); host clock."""

UNIT = "s"


def read(run):
    return run.setup_s
