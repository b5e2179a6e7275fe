"""Clean fixture: a real violation carrying an inline ignore, which
proves `# repro: ignore[rule]` suppression end to end."""
import time


def observe():
    # an observability stat, not the modeled clock
    return time.perf_counter()  # repro: ignore[wall-clock]
