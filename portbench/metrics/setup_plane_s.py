"""Entry: seconds the run's engine spent building its storage plane
(`setup.plane`: `StoragePlane.__init__`, with the host copy of every
FFN bundle, the cold store and the pre-warmed neuron cache; the
program's span, recorded whether or not recording is on)."""
from portbench.progtrace import setup_plane_ns


def read(run):
    ns = setup_plane_ns(run)
    return None if ns is None else ns * 1e-9
