"""Model: the FLOPs the window's work needs (every admission's dense
prefill and every decode token, as `flops.py` counts them) over the
window's seconds and the card's bf16 peak, in %."""
from portbench import flops


def read(run):
    if run.peaks is None:
        return None
    m, total = run.model, 0
    for s in run.window_steps():
        n_hot, kc, cs, groups = s.plan
        for uid in s.uids:
            r = run.requests[uid]
            j = r.token_steps.index(s.index)        # its j-th token (0-based)
            if j == 0:
                total += flops.prefill_flops(m, r.prompt_len)
            total += flops.decode_flops(m, r.prompt_len + j,
                                        n_hot + groups * kc * cs)
    return 100.0 * total / run.window_s / run.peaks["bf16_flops"]
