"""Seeded violations: protocol-method (missing override, arity drift,
dropped @property). Fixture only."""


class WorkerHandle:
    def submit(self, prompt, max_new, arrival_time):
        raise NotImplementedError

    def step(self):
        raise NotImplementedError

    @property
    def load(self):
        raise NotImplementedError

    def close(self):
        return None


class DriftedBackend(WorkerHandle):
    def submit(self, prompt):        # the protocol passes 3 positional args
        return 0

    def load(self):                  # the protocol makes this a @property
        return 0.0
