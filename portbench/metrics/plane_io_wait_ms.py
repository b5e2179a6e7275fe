"""Storage plane: host milliseconds per profiled step blocked on the
plane's I/O thread, one wait a layer (`plane.io_wait`, each
`futures.pop(l).result()` of phase 2; the program's span)."""
from portbench.progtrace import per_step_ms


def read(run):
    return per_step_ms(run, "plane.io_wait")
