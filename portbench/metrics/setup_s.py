"""Process start to the window's opening: imports, weights, plan,
storage plane, KV arena, graph capture and the warm-up traffic; in a
checkout's first run also nvcc's build of the kernels (host clock)."""


def read(run):
    return run.setup_s
