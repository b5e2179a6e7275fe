"""Offline execution planner (paper §5): profile -> classify -> plan.

Counterpart of `repro/core/planner.py`.

1. `profile_activations` runs the model over a profiling corpus (the
   seeded synthetic pipeline, `data/pipeline.py`) and counts per-neuron
   activations: |h| above `_act_threshold(mode)` at each layer's FFN
   input. `profile_ffn_inputs` keeps those inputs and indicators, and
   `calibrate_predictor` fits each layer's low-rank predictor to them
   (ridge regression on ±1 targets, then the rank-r truncation, in
   fp64); `predictor_quality` is the layer-0 recall of its top-k.
   Profiling runs on the model's device under `torch.inference_mode()`.
2. `classify_neurons` sorts neurons by frequency into a hot-first
   permutation and sizes the hot prefix per batch-size bucket (the
   batch-b activation probability of a neuron with per-token frequency
   f is 1-(1-f)^b, the Fig 2 union effect), capped by I/O-aware sizing.
3. `build_plan` emits an ExecutionPlan. Plans save and load in the
   reference's JSON, so a plan the JAX package saved loads here.

The MoE family's plan is `build_moe_plan` (experts as clusters, or the
two-level intra-expert plan), with `moe_synthetic_frequencies` and
`permute_moe_params` its counterparts of the dense pieces; moe models
are not profiled (the router is their predictor), as in the reference.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, asdict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clusters import HybridPlan, make_plan, round_down
from repro_torch.core.predictor import predict_scores
from repro_torch.models.modules import activation_fn, rms_norm


@dataclass(frozen=True)
class HardwareProfile:
    """Target-device characteristics consumed by the planner. No
    defaults: every profile names its device."""
    name: str
    seq_bw: float                  # bytes/s sequential (slow-tier read)
    rand_bw: float                 # bytes/s random
    attn_time_s: float             # per-layer attention time (prefetch window)
    dense_engine_flops: float      # dense (NPU) engine
    sparse_engine_flops: float     # gathered (CPU) path effective


# The paper's device (OnePlus 12, Snapdragon 8 Gen 3 + UFS 4.0).
# NPU ~11 TFLOP/s effective (§2.3.1: 770 tok/s prefill on a 7B ~ 2*7G*770);
# 6 CPU cores ~60 GFLOP/s fp16 NEON (12 tok/s in-memory decode on ~3B
# active params).
PHONE = HardwareProfile(
    name="snapdragon-8gen3",
    seq_bw=4e9, rand_bw=1e9, attn_time_s=2e-3,
    dense_engine_flops=11e12, sparse_engine_flops=60e9)


@dataclass
class ExecutionPlan:
    arch: str
    n_neurons: int
    cluster_size: int
    # hot-first neuron permutation per layer, (L, N) int32
    neuron_order: np.ndarray
    # per-token activation frequency per layer, (L, N) float32 (permuted)
    frequencies: np.ndarray
    # batch-bucket -> HybridPlan
    plans: dict
    hardware: HardwareProfile

    def plan_for_batch(self, batch: int) -> HybridPlan:
        buckets = sorted(self.plans)
        for b in buckets:
            if batch <= b:
                return self.plans[b]
        return self.plans[buckets[-1]]

    def save(self, path):
        obj = {
            "arch": self.arch, "n_neurons": self.n_neurons,
            "cluster_size": self.cluster_size,
            "neuron_order": self.neuron_order.tolist(),
            "frequencies": self.frequencies.tolist(),
            "plans": {str(b): asdict(p) for b, p in self.plans.items()},
            "hardware": asdict(self.hardware),
        }
        with open(path, "w") as f:
            json.dump(obj, f)

    @staticmethod
    def load(path) -> "ExecutionPlan":
        with open(path) as f:
            obj = json.load(f)
        return ExecutionPlan(
            arch=obj["arch"], n_neurons=obj["n_neurons"],
            cluster_size=obj["cluster_size"],
            neuron_order=np.asarray(obj["neuron_order"], np.int32),
            frequencies=np.asarray(obj["frequencies"], np.float32),
            plans={int(b): HybridPlan(**p) for b, p in obj["plans"].items()},
            hardware=HardwareProfile(**obj["hardware"]),
        )


def _act_threshold(mode: str) -> float:
    """|h| above which a neuron counts as active: relu-family
    activations give exact zeros, CATS treats |h| <= 0.1 as nothing."""
    return 0.0 if mode == "relu" else 0.1


# ------------------------------------------------------------ profiling ----

def _active(w, x, activation: str, mode: str):
    """x (..., D) -> (..., N) bool: |h| > _act_threshold(mode), h the
    bundle's activation (times its up projection when R = 3)."""
    h = activation_fn(activation)(x @ w[:, 0].T)
    if w.shape[1] == 3:
        h = h * (x @ w[:, 1].T)
    return h.abs() > _act_threshold(mode)


def ffn_activation_counts(w, x, activation: str, mode: str):
    """x (B, S, D) -> per-neuron activation counts (N,) int64 over the
    B*S tokens."""
    return _active(w, x, activation, mode).sum(dim=(0, 1))


def _ffn_inputs(model, cfg: ModelConfig, tokens):
    """The dense-family profiling walk over tokens (B, S) (numpy or a
    tensor): embed, then per layer causal attention with 1-D RoPE over
    arange(S) (the vlm backbone too, as the reference profiles it) and
    its residual, then yields the FFN input after ln2, (B, S, D) in the
    compute dtype, before adding the layer's dense FFN."""
    from repro_torch.core.sparse_ffn import ffn_dense
    from repro_torch.models import blocks
    from repro_torch.models.attention import rope_angles
    from repro_torch.models.dense import embed_tokens
    x = embed_tokens(model, torch.as_tensor(tokens).to(model.device))
    pos = torch.arange(x.shape[1], device=x.device)
    angles = rope_angles(pos, cfg.d_head // 2, cfg.rope_theta)
    for layer in model.layers:
        a, _ = blocks.attn_full(layer.attn,
                                rms_norm(x, layer.ln1, cfg.norm_eps), cfg,
                                angles, causal=True,
                                window=cfg.sliding_window)
        x = x + a
        xin = rms_norm(x, layer.ln2, cfg.norm_eps)
        yield xin
        x = x + ffn_dense(layer.ffn.w, xin, cfg.activation)


@torch.inference_mode()
def profile_activations(model, cfg: ModelConfig, token_batches):
    """Dense-family profiling forward: (counts (L, N) int64 numpy,
    n_tokens). Works for any model whose layers are {ln1, attn, ln2,
    ffn} (dense, vlm backbone); counts are summed on the model's device
    and read back once per batch."""
    mode = cfg.sparse_ffn.mode
    total = np.zeros((cfg.num_layers, cfg.d_ff), np.int64)
    n_tokens = 0
    for tokens in token_batches:
        counts = torch.stack([
            ffn_activation_counts(layer.ffn.w, xin, cfg.activation, mode)
            for layer, xin in zip(model.layers,
                                  _ffn_inputs(model, cfg, tokens))])
        total += counts.cpu().numpy()
        n_tokens += tokens.shape[0] * tokens.shape[1]
    return total, n_tokens


@torch.inference_mode()
def profile_ffn_inputs(model, cfg: ModelConfig, token_batches):
    """Per-layer FFN inputs and activation indicators over all profiling
    tokens, the training set of predictor calibration (PowerInfer trains
    its online predictors offline; §3.2). Returns tensors on the model's
    device: X (L, T, D) in the compute dtype and H (L, T, N) bool."""
    mode = cfg.sparse_ffn.mode
    Xs, Hs = [], []
    for tokens in token_batches:
        xs = list(_ffn_inputs(model, cfg, tokens))
        Xs.append(torch.stack([x.reshape(-1, cfg.d_model) for x in xs]))
        Hs.append(torch.stack([
            _active(layer.ffn.w, x, cfg.activation, mode).reshape(
                -1, cfg.d_ff) for layer, x in zip(model.layers, xs)]))
    return torch.cat(Xs, 1), torch.cat(Hs, 1)


def _truncate(W, r: int):
    """The rank-r truncation U_r S_r V_r^T of W (D, N), from the
    eigendecomposition of its smaller Gram matrix: the same truncation
    as an SVD's (the reference's), at a tenth of its time for a
    (4096, 14336) fp64 W on the card. Returns (U_r, S_r, V_r^T); a zero
    singular value gets a zero row of V_r^T."""
    wide = W.shape[0] <= W.shape[1]
    M = W if wide else W.T
    lam, E = torch.linalg.eigh(M @ M.T)                 # ascending
    E = E.flip(1)[:, :r]
    S = lam.flip(0)[:r].clamp_min(0).sqrt()
    F = (E.T @ M) / torch.where(S > 0, S, 1.0)[:, None]
    return (E, S, F) if wide else (F.T, S, E.T)


def _ridge_low_rank(X, H, ridge: float, rank: int):
    """fp64 ridge regression of the ±1 targets 2H-1 on X (T, D), then
    the rank-r truncation of the (D, N) solution, split symmetrically:
    A = U_r sqrt(S_r), B = sqrt(S_r) V_r^T."""
    X = X.double()
    T, D = X.shape
    Y = H.double() * 2.0 - 1.0
    G = X.T @ X + ridge * T * torch.eye(D, dtype=X.dtype, device=X.device)
    W = torch.linalg.solve(G, X.T @ Y)                       # (D, N)
    U, S, Vt = _truncate(W, min(rank, *W.shape))
    s = S.sqrt()
    return U * s, s[:, None] * Vt


@torch.no_grad()
def calibrate_predictor(model, cfg: ModelConfig, token_batches,
                        ridge: float = 1e-2):
    """Fit each layer's low-rank activation predictor by ridge regression
    on real (FFN input, activation indicator) pairs, then truncate to
    rank `predictor_rank` (zero-padded when min(D, N) is smaller), on
    the model's device in fp64. Writes `pred_A` / `pred_B` in place
    (the reference returns new params), so views and captured CUDA
    graphs of the predictor stay valid; returns the model."""
    X, H = profile_ffn_inputs(model, cfg, token_batches)
    for l, layer in enumerate(model.layers):
        A, B = _ridge_low_rank(X[l], H[l], ridge,
                               cfg.sparse_ffn.predictor_rank)
        pa, pb = layer.ffn.pred_A, layer.ffn.pred_B
        r = A.shape[1]
        pa[:, :r].copy_(A)
        pa[:, r:].zero_()
        pb[:r].copy_(B)
        pb[r:].zero_()
    return model


def predictor_quality(model, cfg: ModelConfig, token_batches) -> float:
    """Recall of the predictor's top-k against the true active neurons
    (layer 0, the first 64 profiling tokens; k = each token's active
    count). The ranking runs on the host with numpy's argsort, the
    reference's tie order."""
    X, H = profile_ffn_inputs(model, cfg, token_batches)
    ffn = model.layers[0].ffn
    with torch.no_grad():
        scores = predict_scores(ffn.pred_A, ffn.pred_B, X[0]).cpu().numpy()
    h0 = H[0].cpu().numpy()
    recalls = []
    for t in range(min(64, X.shape[1])):
        k = max(int(h0[t].sum()), 1)
        top = np.argsort(-scores[t])[:k]
        recalls.append(h0[t][top].mean())
    return float(np.mean(recalls))


def synthetic_frequencies(cfg: ModelConfig, seed: int = 0,
                          zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-shaped activation frequencies (the paper's Fig 2 skew: <1% of
    neurons are hot at batch 1, hot spots dominate)."""
    rng = np.random.default_rng(seed)
    L, N = cfg.num_layers, max(cfg.d_ff, 1)
    rank = np.arange(1, N + 1, dtype=np.float64)
    base = 1.0 / rank ** zipf_a
    base = base / base.max() * 0.95
    freqs = np.stack([rng.permutation(base) for _ in range(L)])
    return freqs.astype(np.float32)


def classify_neurons(freqs: np.ndarray, cfg: ModelConfig,
                     hw: HardwareProfile,
                     batch_buckets=(1, 2, 4, 8, 16, 32),
                     groups: int = 1, backend: str = "jnp",
                     storage_dtype: str = "fp16"):
    """freqs (L, N) per-token activation frequency -> (order, plans).

    Hot threshold: union activation probability at the bucket's batch
    size exceeds 0.5. I/O cap: the hot prefix must be prefetchable
    within one attention block at sequential bandwidth.
    """
    L, N = freqs.shape
    # numpy's default (unstable) argsort, as the reference: the same
    # routine gives the same neuron_order, ties included
    order = np.argsort(-freqs, axis=1).astype(np.int32)     # hot-first
    sorted_f = np.take_along_axis(freqs, order, axis=1)
    mean_f = sorted_f.mean(axis=0)                          # (N,) layer-avg

    sc = cfg.sparse_ffn
    io_cap = hot_io_cap(cfg, hw, storage_dtype)

    plans = {}
    for b in batch_buckets:
        union = 1.0 - (1.0 - mean_f) ** b
        n_hot = int((union > 0.5).sum())
        n_hot = min(n_hot, io_cap, N)
        hot_ratio = n_hot / N
        # cold budget: expected active cold fraction at this batch size
        cold_union = union[n_hot:] if n_hot < N else np.array([0.0])
        cold_ratio = float(np.clip(cold_union.mean() * 2.0, 0.02, 1.0))
        plans[b] = make_plan(N, hot_ratio, cold_ratio, sc.cluster_size,
                             groups=groups, backend=backend,
                             storage_dtype=storage_dtype)
    return order, np.ascontiguousarray(sorted_f), plans


def _bundle_bytes(cfg: ModelConfig, storage_dtype: str = "fp16") -> int:
    from repro_torch.core.sparse_ffn import ffn_rows
    from repro_torch.quant.quantize import bundle_nbytes
    R = ffn_rows(cfg.activation)
    itemsize = 2 if cfg.param_dtype == "bfloat16" else 4
    return bundle_nbytes(cfg.d_model, storage_dtype, rows=R,
                         itemsize=itemsize)


def hot_io_cap(cfg: ModelConfig, hw: HardwareProfile,
               storage_dtype: str = "fp16") -> int:
    """I/O-aware hot-prefix cap (§5 "carefully balances"): the pinned
    hot region must be prefetchable within one attention block at
    sequential bandwidth."""
    return int(hw.seq_bw * hw.attn_time_s
               / max(_bundle_bytes(cfg, storage_dtype), 1))


@torch.no_grad()
def permute_ffn_params(model, order: np.ndarray):
    """Reorder each layer's FFN bundle rows (and predictor columns)
    hot-first, matching the plan. Updates `model`'s parameters in place
    (no second copy of the FFN weights) and returns the model."""
    for l, layer in enumerate(model.layers):
        ffn = layer.ffn
        idx = torch.from_numpy(np.asarray(order[l], np.int64)).to(
            ffn.w.device)
        ffn.w.copy_(ffn.w.index_select(0, idx))
        if ffn.pred_B is not None:
            ffn.pred_B.copy_(ffn.pred_B.index_select(1, idx))
    return model


def build_plan(cfg: ModelConfig, freqs: np.ndarray = None, *,
               hw: HardwareProfile, groups: int = 1,
               backend: str = "jnp",
               storage_dtype: str = "fp16") -> ExecutionPlan:
    if freqs is None:
        freqs = synthetic_frequencies(cfg)
    order, sorted_f, plans = classify_neurons(freqs, cfg, hw,
                                              groups=groups, backend=backend,
                                              storage_dtype=storage_dtype)
    return ExecutionPlan(
        arch=cfg.name, n_neurons=freqs.shape[1],
        cluster_size=cfg.sparse_ffn.cluster_size,
        neuron_order=order, frequencies=sorted_f, plans=plans, hardware=hw)


# ------------------------------------------------------------------ MoE ----

def moe_synthetic_frequencies(cfg: ModelConfig, seed: int = 0,
                              zipf_a: float = 1.2) -> np.ndarray:
    """Within-expert per-token activation frequencies (L, E*f),
    conditional on the expert being routed: a hot band of
    ~1.5*hot_ratio*f neurons ramping 0.95 -> 0.3, then a zipf cold tail,
    each expert's rows in a random order."""
    rng = np.random.default_rng(seed)
    L, E, f = cfg.num_layers, cfg.num_experts, max(cfg.d_ff, 1)
    band = int(np.clip(round(1.5 * cfg.sparse_ffn.hot_ratio * f), 1, f))
    hot = np.linspace(0.95, 0.3, band)
    rank = np.arange(1, f - band + 1, dtype=np.float64)
    tail = 0.25 / rank ** zipf_a
    base = np.concatenate([hot, tail])
    freqs = np.stack([np.concatenate([rng.permutation(base)
                                      for _ in range(E)])
                      for _ in range(L)])
    return freqs.astype(np.float32)


@torch.no_grad()
def permute_moe_params(model, order: np.ndarray):
    """Per-expert hot-first reorder of each layer's routed experts
    (E, f, R, D), in place, one expert at a time (no second copy of a
    layer's experts). The shared experts keep the identity prefix of
    the flat order and the router is per expert, so layer outputs are
    unchanged up to fp reassociation. Returns the model."""
    for l, layer in enumerate(model.layers):
        ex = layer.moe.experts
        E, f = ex.shape[:2]
        S = order.shape[1] - E * f
        ro = (np.asarray(order[l, S:], np.int64).reshape(E, f) - S
              - (np.arange(E, dtype=np.int64) * f)[:, None])
        for e in range(E):
            idx = torch.from_numpy(ro[e]).to(ex.device)
            ex[e].copy_(ex[e].index_select(0, idx))
    return model


def build_moe_plan(cfg: ModelConfig, freqs: np.ndarray = None, *,
                   hw: HardwareProfile,
                   batch_buckets=(1, 2, 4, 8, 16, 32),
                   storage_dtype: str = "fp16") -> ExecutionPlan:
    """Execution plan of the MoE family.

    Whole-expert mode (`cfg.moe_intra_expert=False`): the flat neuron
    space is [shared experts | routed experts], one cluster per routed
    expert (cluster_size = d_ff). Per bucket the cold budget is the
    expected batch union of routed experts, 1-(1-k/E)^b per expert,
    clamped to [k, E] experts; the order is the identity.

    Two-level mode (the TurboSparse-Mixtral case): each routed expert's
    d_ff rows are permuted hot-first by `freqs` (L, E*f) (synthetic when
    None). Per bucket the expert union picks n_act experts, the
    per-expert hot prefix is sized by the union math at
    b_e = ceil(b*k / n_act) tokens per active expert and capped by
    `hot_io_cap`; hot compute is priced per activated expert
    (n_hot = S + n_act*n_hot_e) and every expert's hot prefix is pinned
    (n_pinned = S + E*n_hot_e)."""
    f, E, k = cfg.d_ff, cfg.num_experts, cfg.experts_per_token
    if not E or not k:
        raise ValueError(f"{cfg.name} is not a MoE config "
                         f"(num_experts={E}, experts_per_token={k})")
    S = cfg.num_shared_experts * f
    N = cfg.moe_flat_neurons
    L = cfg.num_layers

    def expert_union(b):
        union = 1.0 - (1.0 - k / E) ** b
        return min(max(int(round(E * union)), min(k, E)), E)

    if not cfg.moe_intra_expert:
        plans = {b: HybridPlan(n_hot=S, k_cold=expert_union(b) * f,
                               groups=1, cluster_size=f,
                               storage_dtype=storage_dtype)
                 for b in batch_buckets}
        # shared experts always fire; each routed expert at rate ~k/E
        fr = np.concatenate([np.ones((S,), np.float32),
                             np.full((E * f,), k / E, np.float32)])
        fr = np.tile(fr, (L, 1))
        order = np.tile(np.arange(N, dtype=np.int32), (L, 1))
        return ExecutionPlan(
            arch=cfg.name, n_neurons=N, cluster_size=f,
            neuron_order=order, frequencies=fr, plans=plans, hardware=hw)

    cs = cfg.sparse_ffn.cluster_size
    if f % cs:
        raise ValueError(
            f"{cfg.name}: d_ff={f} must be a multiple of the "
            f"intra-expert cluster size {cs}")
    if freqs is None:
        freqs = moe_synthetic_frequencies(cfg)
    freqs = np.asarray(freqs, np.float32)
    if freqs.shape != (L, E * f):
        raise ValueError(
            f"two-level MoE frequencies must be (L, E*f) = "
            f"({L}, {E * f}); got {freqs.shape}")
    per_exp = freqs.reshape(L, E, f)
    order_e = np.argsort(-per_exp, axis=2).astype(np.int32)  # hot-first
    sorted_f = np.take_along_axis(per_exp, order_e, axis=2)
    mean_f = sorted_f.mean(axis=(0, 1))         # (f,) layer+expert profile
    cap_e = max((hot_io_cap(cfg, hw, storage_dtype) - S) // E, 0)

    plans = {}
    for b in batch_buckets:
        n_act = expert_union(b)
        b_e = max(int(np.ceil(b * k / n_act)), 1)  # tokens/active expert
        union = 1.0 - (1.0 - mean_f) ** b_e
        n_hot_e = int((union > 0.5).sum())
        n_hot_e = max(min(round_down(n_hot_e, cs),
                          round_down(cap_e, cs), f - cs), 0)
        cold_union = union[n_hot_e:]
        cold_ratio = float(np.clip(cold_union.mean() * 2.0, 0.02, 1.0))
        k_cold_e = max(round_down(int((f - n_hot_e) * cold_ratio), cs), cs)
        plans[b] = HybridPlan(
            n_hot=S + n_act * n_hot_e, k_cold=n_act * k_cold_e,
            groups=1, cluster_size=cs,
            n_expert_hot=n_hot_e, n_pinned=S + E * n_hot_e,
            storage_dtype=storage_dtype)

    # flat order: the identity shared prefix, then each expert's rows
    # hot-first within its contiguous block (permute_moe_params applies
    # it, so flat id == physical row)
    routed = (order_e + (np.arange(E, dtype=np.int32) * f)[None, :, None]
              + S).reshape(L, E * f)
    shared = np.tile(np.arange(S, dtype=np.int32), (L, 1))
    order = np.concatenate([shared, routed], axis=1).astype(np.int32)
    fr = np.concatenate([np.ones((L, S), np.float32),
                         sorted_f.reshape(L, E * f)], axis=1)
    return ExecutionPlan(
        arch=cfg.name, n_neurons=N, cluster_size=cs,
        neuron_order=order, frequencies=fr, plans=plans, hardware=hw)
