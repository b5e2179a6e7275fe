"""Scheduler: mean live requests per engine step in the window."""


def read(run):
    steps = run.window_steps()
    return sum(len(s.uids) for s in steps) / len(steps) if steps else None
