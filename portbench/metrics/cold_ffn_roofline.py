"""Kernel: fused_cold_ffn's share of its roofline, in %: the least time
its calls in the traced sub-window could take (each call's bytes and
operations, `flops.cold_ffn_cost`, at the card's memory rate and bf16
peak) over the profiler's device time in its four kernels (hidden,
score, gate_up, down)."""
from portbench import flops
from portbench.weights import ffn_rows


def read(run):
    prof = run.profile or {}
    if run.peaks is None or not prof.get("cold_s"):
        return None
    m = run.model
    D, N = m["d_model"], m["d_ff"]
    r, R = m["sparse_ffn"]["predictor_rank"], ffn_rows(m["activation"])
    least = 0.0
    for i in prof["steps"]:
        s = run.steps[i]
        n_hot, kc, cs, G = s.plan
        B = s.rows
        nbytes, ops = flops.cold_ffn_cost(B, D, r, N - n_hot, G * kc * cs,
                                          R, G, kc)
        least += s.launches * flops.least_seconds(nbytes, ops, run.peaks)
    return 100.0 * least / prof["cold_s"]
