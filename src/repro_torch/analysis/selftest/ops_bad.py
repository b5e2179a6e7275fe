"""Seeded kernel-registry-drift: exports a kernel wrapper the registry
fixture (registry.py) has no entry for. Fixture only."""

__all__ = ["dense_ffn", "unregistered_kernel", "launch_counts"]


def dense_ffn():
    pass


def unregistered_kernel():           # exported, never registered
    pass


def launch_counts():
    return {}
