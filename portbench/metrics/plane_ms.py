"""Storage plane: host milliseconds per step in `engine.storage.step`
(pricing the step's cluster trace), over the window's steps."""


def read(run):
    steps = run.window_steps()
    return 1e3 * sum(s.plane_s for s in steps) / len(steps) if steps \
        else None
