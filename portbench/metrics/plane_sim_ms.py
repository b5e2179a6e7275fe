"""Storage plane: host milliseconds per profiled step in the cluster
pipeline simulation and the shards' stats (`plane.simulate`; the
program's span)."""
from portbench.progtrace import per_step_ms


def read(run):
    return per_step_ms(run, "plane.simulate")
