"""Engine and decoder: the window's milliseconds per engine step (each
step admits and prefills, samples, replays the bucket's graph, reads
the tokens and trace back, prices the step)."""


def read(run):
    steps = run.window_steps()
    return 1e3 * run.window_s / len(steps) if steps else None
