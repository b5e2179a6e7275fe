"""Engine and decoder: host milliseconds per profiled step in the
admissions' dense prefills (`engine.prefill`, each `dense.prefill` call
of `ServeEngine._admit` with its prompt copy; the program's span)."""
from portbench.progtrace import per_step_ms


def read(run):
    return per_step_ms(run, "engine.prefill")
