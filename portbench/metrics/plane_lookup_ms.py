"""Storage plane: host milliseconds per profiled step in the plane's
cache walk over every layer (`plane.lookup`, phase 1 of
`StoragePlane.step`; the program's span)."""
from portbench.progtrace import per_step_ms


def read(run):
    return per_step_ms(run, "plane.lookup")
