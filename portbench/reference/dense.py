"""Plain reference of the dense family's served model, in float32.

A decoder-only transformer (PowerInfer-2 §4.1; Bamboo-7B's layers):
embed; per layer an RMS norm, grouped-query causal attention with
half-split rotary embeddings, the residual, an RMS norm and the FFN of
neuron bundles (gate, up, down; act(x gate) * (x up) @ down), the
residual; a final RMS norm and the LM head. Norm weights are zero (the
(1 + w) scale is the identity), as the benchmark makes them.

The FFN follows the served program: the prefill runs every neuron; a
decode step runs the plan's hot prefix and the cold clusters the step
picked. The reference cannot pick those clusters for one request alone,
since the pick is a union over the whole batch, so it follows the step's
recorded picks (the program's state) and checks the picking on its own
(`union_picks`): at sampled steps it recomputes every live row's
predictor scores and the batch union's top clusters itself.

Everything runs in float32 with TF32 off, layer by layer over all the
replayed requests, each over its whole sequence (prompt and served
tokens) at once. With `fp8` it is the control: every weight and every
matmul input rounded to float8 e4m3 (per output channel / per row
scales), the lower precision a later change might be tempted by."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`
    (its absolute maximum maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (P, h, dh) rotated by positions pos (P,), half-split pairs."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = pos.float()[:, None] * inv                   # (P, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, chunk: int = 512) -> torch.Tensor:
    """q (P, H, dh), k / v (P, KV, dh) -> (P, H * dh), softmax in fp32."""
    P, H, dh = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)   # (H, P, dh)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((P, H, dh), dtype=torch.float32, device=q.device)
    keys = torch.arange(P, device=q.device)
    for i in range(0, P, chunk):
        qi = q[i:i + chunk].transpose(0, 1)              # (H, c, dh)
        s = qi @ k.transpose(1, 2) * dh ** -0.5          # (H, c, P)
        mask = keys[None, :] > (i + torch.arange(qi.shape[1],
                                                 device=q.device))[:, None]
        s = s.masked_fill(mask, float("-inf"))
        out[i:i + chunk] = (torch.softmax(s, dim=-1) @ v).transpose(0, 1)
    return out.reshape(P, H * dh)


@dataclass
class Replayed:
    """One request to replay: its prompt, the tokens it was served and the
    engine step that fed each to the model."""
    prompt: np.ndarray
    tokens: list
    steps: list
    logits: torch.Tensor = None        # (n, V): the logits each token was
    #                                    picked from (position S-2+j)
    ffn_in: dict = field(default_factory=dict)   # step -> (L, D) float32


class DenseReference:
    """The reference over stacked weights `w` (the benchmark's draw:
    bf16, upcast a layer at a time), the plan's hot-first `order` (L, N)
    and the recorded steps: step -> (trace (L, G, kc), BucketPlan)."""

    def __init__(self, m: dict, w: dict, order: np.ndarray, steps: dict,
                 fp8: bool = False):
        self.m, self.w, self.steps, self.fp8 = m, w, steps, fp8
        self.order = torch.from_numpy(np.asarray(order, np.int64)).to(
            w["embed"].device)

    # ------------------------------------------------------ helpers ----
    def _weight(self, t: torch.Tensor, out_dim: int) -> torch.Tensor:
        t = t.float()
        return fp8_round(t, dim=1 - out_dim) if self.fp8 else t

    def _mm(self, x, wt):
        """x (P, in) @ wt (in, out); the control rounds x per row."""
        return (fp8_round(x, dim=-1) if self.fp8 else x) @ wt

    def neurons(self, l: int, step: int) -> torch.Tensor:
        """Original neuron ids a decode step computes in layer l: the
        plan's hot prefix and the picked cold clusters."""
        trace, p = self.steps[step]
        N = self.m["d_ff"]
        nc_g = (N - p.n_hot) // p.cs // p.groups
        tr = torch.as_tensor(np.asarray(trace[l]).reshape(p.groups, -1),
                             dtype=torch.int64, device=self.order.device)
        glob = (tr + torch.arange(p.groups, device=tr.device)[:, None]
                * nc_g).reshape(-1)
        cold = p.n_hot + (glob[:, None] * p.cs
                          + torch.arange(p.cs, device=tr.device)).reshape(-1)
        perm = torch.cat([torch.arange(p.n_hot, device=tr.device), cold])
        return self.order[l, perm]

    # ------------------------------------------------------ forward ----
    @torch.no_grad()
    def run(self, reqs: list, keep_steps=frozenset()):
        """Fill each request's `logits` and, for the steps in
        `keep_steps`, its FFN inputs at the position that step fed."""
        m, w = self.m, self.w
        dev = w["embed"].device
        L, D, N = m["num_layers"], m["d_model"], m["d_ff"]
        H, KV, dh = m["num_heads"], m["num_kv_heads"], m["d_head"]
        eps, theta = m["norm_eps"], m["rope_theta"]
        R = w["ffn"].shape[2]
        act = {"relu2": lambda g: torch.relu(g).square(),
               "silu": torch.nn.functional.silu}[m["activation"]]
        embed = self._weight(w["embed"], out_dim=0)
        xs, pos, sel, keep = [], [], [], []
        picked = {s: torch.stack([self.neurons(l, s) for l in range(L)])
                  for s in {s for r in reqs for s in r.steps}}
        for r in reqs:
            ids = np.concatenate([r.prompt, np.asarray(r.tokens, np.int64)])
            ids_t = torch.as_tensor(ids, dtype=torch.int64, device=dev)
            xs.append(embed[ids_t])
            pos.append(torch.arange(len(ids), device=dev))
            S = len(r.prompt)
            keep.append([(s, S + j) for j, s in enumerate(r.steps)
                         if s in keep_steps])
            # (L, n, neurons): what each decode position's step ran
            sel.append(torch.stack([picked[s] for s in r.steps], dim=1)
                       if r.steps else None)
        del embed
        for l in range(L):
            wq = self._weight(w["wq"][l], 1)
            wk = self._weight(w["wk"][l], 1)
            wv = self._weight(w["wv"][l], 1)
            wo = self._weight(w["wo"][l], 1)
            bundle = w["ffn"][l].float()                   # (N, R, D)
            if self.fp8:
                bundle = fp8_round(bundle, dim=-1)
            gate, down = bundle[:, 0].T, bundle[:, R - 1]
            up = bundle[:, 1].T if R == 3 else None
            for i, r in enumerate(reqs):
                x = xs[i]
                P, S = x.shape[0], len(r.prompt)
                h = rms(x, eps)
                q = rope(self._mm(h, wq).reshape(P, H, dh), pos[i], theta)
                k = rope(self._mm(h, wk).reshape(P, KV, dh), pos[i], theta)
                v = self._mm(h, wv).reshape(P, KV, dh)
                x = x + self._mm(causal_attention(q, k, v), wo)
                h = rms(x, eps)
                for s, p in keep[i]:
                    r.ffn_in.setdefault(s, torch.empty((L, D), device=dev))
                    r.ffn_in[s][l] = h[p]
                a = act(self._mm(h, gate))
                if up is not None:
                    a = a * self._mm(h, up)
                # decode positions run only the neurons their step ran
                if sel[i] is not None:
                    mask = torch.zeros((P - S, N), dtype=torch.bool,
                                       device=dev)
                    a[S:] = a[S:] * mask.scatter_(1, sel[i][l], True)
                xs[i] = x + self._mm(a, down)
            del wq, wk, wv, wo, bundle, gate, up, down
        head = self._weight(w["lm_head"][:, :m["vocab_size"]], out_dim=1)
        for i, r in enumerate(reqs):
            S = len(r.prompt)
            last = rms(xs[i][S - 1:S - 1 + len(r.tokens)], eps)
            r.logits = self._mm(last, head)
        return reqs

    @torch.no_grad()
    def union_picks(self, l: int, rows: torch.Tensor, p) -> tuple:
        """The batch union's cluster scores (G, nc_g) of the live rows'
        FFN inputs rows (B, D) in layer l under bucket plan p, and the
        clusters a plain top-kc keeps per group (G, kc)."""
        w = self.w
        A = self._weight(w["pred_A"][l], 1)
        B = self._weight(w["pred_B"][l], 1)
        score = self._mm(self._mm(rows, A), B)             # (B, N)
        cold = self.order[l, p.n_hot:]
        u = score[:, cold].amax(dim=0).reshape(p.groups, -1, p.cs).amax(-1)
        return u, torch.topk(u, p.kc, dim=-1).indices


# ------------------------------------------------------------ readings ----

def sample(run, rng) -> tuple:
    """What the comparison replays, drawn from the seed: a block of
    `check.steps` consecutive window steps (their live rows are the
    batch unions the picks are checked on), `check.requests` finished
    requests and the finished request with the most served tokens.
    Returns (block steps, the requests to replay)."""
    chk = run.cell["traffic"]["check"]
    win = run.window_steps()
    k = min(chk["steps"], len(win))
    first = win[int(rng.integers(0, len(win) - k + 1))].index
    block = list(range(first, first + k))
    uids = {u for s in block for u in run.steps[s].uids}
    done = sorted((r for r in run.requests.values() if r.done is not None),
                  key=lambda r: r.index)
    if done:
        uids.add(max(done, key=lambda r: (len(r.tokens), -r.index)).uid)
        pick = rng.permutation(len(done))[:chk["requests"]]
        uids.update(done[i].uid for i in pick)
    reqs = sorted((run.requests[u] for u in uids), key=lambda r: r.index)
    return block, reqs


def _logit_gaps(ref_logits, tokens) -> torch.Tensor:
    """Per served token: how far its logit lies below the best, in
    standard deviations of that position's logits."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens[:, None])[:, 0]
    return (best - got) / ref_logits.std(dim=-1)


def _pick_gap(u, picked, kc) -> float:
    """How far the union score of the weakest picked cluster lies below
    the kc-th best, in standard deviations of the group's scores (0 when
    the picks are the top kc); a pick out of range or twice is infinite."""
    worst = 0.0
    for g in range(u.shape[0]):
        ids = picked[g]
        if len(set(ids.tolist())) != kc or ids.min() < 0 \
                or ids.max() >= u.shape[1]:
            return float("inf")
        kth = torch.topk(u[g], kc).values[-1]
        low = u[g][torch.as_tensor(ids, device=u.device)].min()
        worst = max(worst, float((kth - low).clamp_min(0) / u[g].std()))
    return worst


def readings(run, device, control: bool = False) -> dict:
    """The numbers `correct` is decided on, for the served program; with
    `control`, the fp8 control's readings of the two that precision
    moves, beside the program's."""
    from portbench.reference import plan as planmod
    from portbench.reference.plane import FIELDS, PlaneReplay
    from portbench.traffic import seed_seq
    from portbench.weights import ffn_rows, make_weights
    m, sv = run.model, run.cell["config"]["serving"]
    rows = ffn_rows(m["activation"])
    hw = planmod.HARDWARE[sv["hardware"]]
    order, plans = planmod.dense_plan(m, rows, hw)
    out = {}

    # the storage plane's pricing, every step from the plane's creation
    plane = PlaneReplay(m, rows, plans[1], hw, sv["offload_ratio"])
    served = {u: 0 for u in run.requests}
    off = 0
    # the engine serves the one bucket that holds every client
    p = plans[planmod.bucket_of(run.cell["traffic"]["clients"])]
    for s in run.steps:
        reqs = [run.requests[u] for u in s.uids]
        ctx = float(np.mean([r.prompt_len + served[r.uid] for r in reqs]))
        for r in reqs:
            served[r.uid] += 1
        mine = plane.step(s.trace, p, len(s.uids), ctx) \
            if s.trace.shape == (m["num_layers"], p.groups, p.kc) else None
        same = mine is not None and s.plan == (p.n_hot, p.kc, p.cs,
                                               p.groups)
        for f in FIELDS if same else ():
            a, b = s.stats[f], mine[f]
            same &= a == b if f in ("n_miss", "batch") \
                else abs(a - b) <= 1e-9 * max(abs(b), 1e-30)
        off += not same
    out["stats_off"] = float(off)

    # the served tokens and the picks, against the float32 reference
    rng = np.random.default_rng(seed_seq(run.seed))
    block, sample_reqs = sample(run, rng)
    steps = {s.index: (s.trace, p) for s in run.steps}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = make_weights(m, run.seed, device)

    def replay(fp8):
        ref = DenseReference(m, w, order, steps, fp8=fp8)
        reps = [Replayed(r.prompt, r.tokens, r.token_steps)
                for r in sample_reqs]
        ref.run(reps, keep_steps=frozenset(block))
        picks = {}
        by_uid = {r.uid: rep for r, rep in zip(sample_reqs, reps)}
        for s in block:
            p = steps[s][1]
            for l in range(m["num_layers"]):
                x = torch.stack([by_uid[u].ffn_in[s][l]
                                 for u in run.steps[s].uids])
                picks[s, l] = ref.union_picks(l, x, p)
        return reps, picks

    ref_reps, ref_picks = replay(False)
    served_tok = [torch.as_tensor(r.tokens, device=device)
                  for r in sample_reqs]
    gaps = torch.cat([_logit_gaps(rep.logits, t)
                      for rep, t in zip(ref_reps, served_tok)])
    out["logit_gap"] = float(gaps.max())
    out["pick_gap"] = max(
        _pick_gap(u, np.asarray(run.steps[s].trace[l]).reshape(u.shape[0], -1),
                  steps[s][1].kc)
        for (s, l), (u, _) in ref_picks.items())
    out["served_tokens"] = float(gaps.numel())
    if control:
        ctl_reps, ctl_picks = replay(True)
        gaps = torch.cat([_logit_gaps(rep.logits,
                                      ctl.logits.argmax(dim=-1))
                          for rep, ctl in zip(ref_reps, ctl_reps)])
        out["control_logit_gap"] = float(gaps.max())
        out["control_pick_gap"] = max(
            _pick_gap(u, ctl_picks[key][1].cpu().numpy(), steps[key[0]][1].kc)
            for key, (u, _) in ref_picks.items())
    return out
