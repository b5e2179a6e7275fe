"""Output tokens that came out of the engine's steps inside the window,
over the window's seconds (host clock)."""


def read(run):
    return sum(len(s.uids) for s in run.window_steps()) / run.window_s
