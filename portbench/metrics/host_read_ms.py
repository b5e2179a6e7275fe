"""Engine and decoder: host milliseconds per profiled step blocked in
the step's two reads from the card, the sampled tokens' `.cpu()`
(`engine.read_tokens`) and the logits' copy-out with the cluster
trace's `.cpu()` (`engine.read_trace`): the part of a step the card
paces (the program's spans)."""
from portbench.progtrace import per_step_ms


def read(run):
    return per_step_ms(run, "engine.read_tokens", "engine.read_trace")
