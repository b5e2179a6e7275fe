"""Device: the share of the traced sub-window in which no kernel or copy
ran on the card (torch.profiler), in %."""


def read(run):
    prof = run.profile or {}
    if not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
