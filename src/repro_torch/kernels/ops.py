"""Public wrappers of the port's hand-written CUDA kernels.

A wrapper runs its kernel's plain version (`kernels/ref.py`) when the
tensors lie on the CPU. For CUDA tensors it checks devices, dtypes,
shapes and strides, allocates outputs and scratch with `torch.empty`,
launches on the current stream and raises if the launch fails: it never
falls back to the plain version. Each wrapper keeps a plain integer
`launches` count, raised by one per call that launches its kernel;
`launch_counts` / `set_launch_counts` read and write all of them.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels.ref import (
    cluster_gather_ffn_ref, dense_ffn_ref, fused_cold_ffn_ref)

_ACT_CODES = {"silu": 0, "relu2": 1, "gelu": 2, "geglu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# fused_cold_ffn's weight modes: fp bundles, int8 codes, int8 codes plus
# an fp16 outlier sidecar (int4-mixed)
_MODE_FP, _MODE_INT8, _MODE_MIXED = 0, 1, 2
# rows of A per block of fused_cold_ffn's hidden kernel (kHidD): h is
# scratch of ceil(D / 64) fp32 partial products per (row, column)
_HIDDEN_SPLIT = 64
# the largest runtime sizes fused_cold_ffn takes (its shape check below;
# the analysis gate's smem-budget rule bounds the kernels' dynamic shared
# memory over them)
FUSED_DIM_BOUNDS = {"r": 1024, "cs": 1024, "nc_g": 12288}


# the wrappers that count their launches (`_counts_launches`)
_COUNTED = []


def _counts_launches(fn):
    """Give wrapper `fn` a `launches` count, starting at 0."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


def launch_counts() -> dict:
    """Every counted wrapper's `launches`, by name."""
    return {fn.__name__: fn.launches for fn in _COUNTED}


def set_launch_counts(counts: dict):
    """Set every count from `counts`, as `launch_counts` gives them."""
    for fn in _COUNTED:
        fn.launches = counts[fn.__name__]


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _check_activation(activation: str) -> int:
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}; expected one "
                         f"of {sorted(_ACT_CODES)}")
    return _ACT_CODES[activation]


def _check_on(x, name: str, **tensors):
    """x lies on the CPU (-> False: run the plain version) or on CUDA
    with every tensor beside it (-> True: launch)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    for n, t in tensors.items():
        if t is not None and t.device != x.device:
            raise ValueError(f"{n} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    return True


def _raise_on_error(lib, rc: int, name: str, source: str):
    if rc != 0:
        text = getattr(lib, f"{source}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({text})")


def _quant_mode(wc, wq, wsc, wout) -> int:
    """Check the quantized containers against wc's shape and return the
    weight mode the kernel takes."""
    if wq is None:
        if wsc is not None or wout is not None:
            raise ValueError("wsc/wout given without the int8 codes wq")
        return _MODE_FP
    if wsc is None:
        raise ValueError("int8 codes wq need their per-row scales wsc")
    for name, t, dt, shape in (("wq", wq, torch.int8, wc.shape),
                               ("wsc", wsc, torch.float32, wc.shape[:-1]),
                               ("wout", wout, torch.float16, wc.shape)):
        if t is None:
            continue
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, expected {dt}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)} (wc {tuple(wc.shape)})")
    return _MODE_INT8 if wout is None else _MODE_MIXED


@_counts_launches
def fused_cold_ffn(x, wc, A, Bp, *, activation: str, mode: str = "relu",
                   kc: int, active_mask=None, wq=None, wsc=None, wout=None):
    """Fused cold path: predictor score -> batch-union top-k -> cluster
    gather -> gated FFN (replaces `repro.kernels.ops.fused_cold_ffn`).

    x (B, D); wc (G, nc_g, cs, R, D) cold clusters per group; A (D, r)
    and Bp (r, G*nc_g*cs) the predictor's cold slice (Bp may be a column
    slice: its rows need only unit stride); kc clusters kept per group.
    `mode == "cats"` gates each token by its own score; `active_mask` (B,)
    bool keeps dead KV-arena lanes out of the batch union.

    Quantized storage (§7.6): wq (int8 codes, wc's shape), wsc
    ((G, nc_g, cs, R) fp32 scales) and, for int4-mixed, wout (fp16
    outliers, wc's shape). The kernel then reads the codes instead of wc
    and dequantizes each picked weight as q * sc (+ out) in fp32, cast to
    x's dtype, before the dots. Returns (y (B, D) fp32, idx (G, kc)
    int32).
    """
    act = _check_activation(activation)
    if mode not in ("relu", "cats"):
        raise ValueError(f"unknown sparse mode {mode!r}")
    wmode = _quant_mode(wc, wq, wsc, wout)
    G, nc_g, cs, R, D = wc.shape
    B = x.shape[0]
    if active_mask is None:
        mask = torch.ones((B,), dtype=torch.float32, device=x.device)
    else:
        mask = active_mask.to(device=x.device, dtype=torch.float32).reshape(B)
    cats = mode == "cats"
    if not _check_on(x, "fused_cold_ffn", wc=wc, A=A, Bp=Bp, wq=wq, wsc=wsc,
                     wout=wout):
        return fused_cold_ffn_ref(x, wc, A, Bp, mask, activation=activation,
                                  cats=cats, kc=kc, wq=wq, wsc=wsc, wout=wout)
    r = A.shape[1]
    Nc = G * nc_g * cs
    for name, t in (("wc", wc), ("A", A), ("Bp", Bp)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}: the "
                            f"kernel takes one dtype for all four")
    if x.dim() != 2 or x.shape[1] != D or A.shape != (D, r) \
            or Bp.dim() != 2 or Bp.shape[0] != r or Bp.shape[1] < Nc:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, wc "
                         f"{tuple(wc.shape)}, A {tuple(A.shape)}, Bp "
                         f"{tuple(Bp.shape)}")
    bound = FUSED_DIM_BOUNDS
    if not (B >= 1 and R in (2, 3) and 1 <= kc <= nc_g and cs <= bound["cs"]
            and 1 <= r <= bound["r"] and nc_g <= bound["nc_g"]):
        raise ValueError(f"unsupported shape: B={B} (>= 1), R={R} (2|3), "
                         f"kc={kc} (1..nc_g={nc_g}), cs={cs} "
                         f"(<={bound['cs']}), r={r} (<={bound['r']}), "
                         f"nc_g={nc_g} (<={bound['nc_g']})")
    if not (x.is_contiguous() and wc.is_contiguous() and A.is_contiguous()
            and Bp.stride(1) == 1
            and all(t is None or t.is_contiguous() for t in (wq, wsc, wout))):
        raise ValueError("x, wc, A, wq, wsc and wout must be contiguous and "
                         "Bp's rows unit-stride")
    from repro_torch.kernels.build import library   # builds at first use
    lib = library("fused_cold_ffn")
    dev = x.device
    f32 = torch.float32
    y = torch.empty((B, D), dtype=f32, device=dev)
    idx = torch.empty((G, kc), dtype=torch.int32, device=dev)
    h = torch.empty((-(-D // _HIDDEN_SPLIT), B, r), dtype=f32, device=dev)
    scores = torch.empty((B, Nc), dtype=f32, device=dev)
    tile_max = torch.empty(((B + 7) // 8, G * nc_g), dtype=f32, device=dev)
    H = torch.empty((B, G * kc * cs), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.fused_cold_ffn_launch(
            _ptr(x), _ptr(wc), _ptr(wq), _ptr(wsc), _ptr(wout), _ptr(A),
            _ptr(Bp), Bp.stride(0), _ptr(mask), _ptr(y), _ptr(idx), _ptr(h),
            _ptr(scores), _ptr(tile_max), _ptr(H), B, D, r, G, nc_g, cs, R,
            kc, act, int(cats), _DTYPE_CODES[x.dtype], wmode,
            ctypes.c_void_p(stream))
    _raise_on_error(lib, rc, "fused_cold_ffn", "fused_cold_ffn")
    fused_cold_ffn.launches += 1
    return y, idx



# cluster_gather_ffn.cu's tiling (gather_plan): blocks to keep in flight
# (two per SM of the H100's 132), the dynamic shared memory cap of a block
# (kMaxSmem in the source), down's splits at most one portable cluster
# (kMaxSplits), the neurons down stages at once, rows of x per gate_up row
# group (the weights are staged once per group; 128 measured best at
# B = 300) and the gate_up blocks that share x by a multicast past 16 rows
_GATHER_BLOCKS = 264
_GATHER_SMEM = 120 * 1024
_GATHER_SPLITS = 8
_DOWN_CHUNK = {2: 256, 4: 128}
_GATHER_GROUP_ROWS = 128
_X_CLUSTER = 4
_DOWN_COLS = 64          # kDownCols in the source


@dataclass(frozen=True)
class GatherPlan:
    """How `cluster_gather_ffn.cu` tiles one call (B rows, D columns, K
    selected neurons, es bytes an element).

    gate_up: blocks of `neurons_per_block` neurons (n_tiles 8-row tiles of
    weight rows: 4 neurons' gate and up rows each at R = 3, 8 gate rows
    otherwise), stages of 16 * m_tiles rows of x, D staged `chunk`
    columns at a time, `gate_groups` row groups (the weights are staged
    once per group), `x_cluster` neighbouring blocks sharing each stage
    of x by a multicast (the kernel falls back to 1 where rows of x are
    not whole 16-byte runs). down: row tiles of 16 * down_m_tiles rows,
    64-column tiles, the K neurons cut into `splits` runs of `split` (the
    last may be shorter), staged `down_chunk` at a time; the splits of a
    column tile are one thread-block cluster that adds their fp32 tiles in
    rank order through distributed shared memory, so no scratch beyond H
    is needed."""
    B: int
    D: int
    K: int
    es: int
    n_tiles: int
    m_tiles: int
    chunk: int
    gate_groups: int
    x_cluster: int
    gate_smem: int
    neurons_per_block: int
    down_m_tiles: int
    down_chunk: int
    down_smem: int
    split: int
    splits: int

    @property
    def gate_blocks(self) -> int:
        return -(-self.K // self.neurons_per_block)

    @property
    def down_blocks(self) -> int:
        row_tiles = -(-self.B // (16 * self.down_m_tiles))
        return -(-self.D // _DOWN_COLS) * self.splits * min(row_tiles, 65535)

    @property
    def ldh(self) -> int:
        """H's row stride: K rounded up to 8, so rows start 16-byte aligned."""
        return -(-self.K // 8) * 8

    @property
    def scratch_bytes(self) -> int:
        """Device scratch of the call: H (B, ldh) in x's dtype; down's split
        partials live in its clusters' shared memory."""
        return self.B * self.ldh * self.es

    def split_ranges(self):
        """The neuron runs [start, stop) of the down splits, in order."""
        return [(s * self.split, min(self.K, (s + 1) * self.split))
                for s in range(self.splits)]


def gather_plan(B: int, D: int, K: int, R: int, es: int) -> GatherPlan:
    """Tile one call of the gathered FFN for the H100 (see GatherPlan):
    small row stages and k-split warps at decode batch, wider neuron
    tiles past 64 rows; D chunked to the shared memory cap; down split
    over the neurons until about 264 blocks are in flight, at most 8
    splits (one cluster)."""
    m_tiles = 1 if B <= 16 else 2 if B <= 32 else 4
    n_tiles = 1 if B <= 64 else 2
    pad = 16 // es
    rows = 8 * n_tiles + 16 * m_tiles
    red = 4 * n_tiles * 128 * 4
    chunk = min(-(-D // 16) * 16,
                ((_GATHER_SMEM - red) // (rows * es) - pad) // 16 * 16)
    down_m_tiles = min(4, -(-B // 16))
    row_tiles = min(-(-B // (16 * down_m_tiles)), 65535)
    base = -(-D // _DOWN_COLS) * row_tiles
    splits = min(-(-_GATHER_BLOCKS // base), _GATHER_SPLITS, -(-K // 16))
    split = -(-(-(-K // splits)) // 16) * 16     # ceil(K / splits), to 16
    kc = min(split, _DOWN_CHUNK[es])
    trows = 16 * down_m_tiles
    return GatherPlan(
        B=B, D=D, K=K, es=es, n_tiles=n_tiles, m_tiles=m_tiles, chunk=chunk,
        gate_groups=min(65535, -(-B // _GATHER_GROUP_ROWS)),
        x_cluster=1 if B <= 16 else _X_CLUSTER,
        gate_smem=rows * (chunk + pad) * es + red,
        neurons_per_block=n_tiles * (4 if R == 3 else 8),
        down_m_tiles=down_m_tiles, down_chunk=kc,
        down_smem=(trows * (kc + pad) + kc * (_DOWN_COLS + pad)) * es
        + trows * _DOWN_COLS * 4,
        split=split, splits=-(-K // split))


def _gather_ffn(x, w, cluster_idx, cluster_size: int, activation: str,
                name: str):
    """Launch the gathered bundled FFN over the clusters `cluster_idx`
    (None: every neuron in order). Returns (B, D) in x's dtype."""
    act = _check_activation(activation)
    B, D = x.shape
    N, R, Dw = w.shape
    if w.dtype != x.dtype or Dw != D:
        raise ValueError(f"{name}: w {tuple(w.shape)} {w.dtype} does not "
                         f"match x {tuple(x.shape)} {x.dtype}")
    K = N if cluster_idx is None else cluster_idx.shape[0] * cluster_size
    if B < 1 or K < 1 or R < 1:
        raise ValueError(f"{name}: needs B >= 1 rows and at least one "
                         f"neuron, got B={B}, {K} neurons, R={R}")
    if cluster_idx is not None and (cluster_idx.dtype != torch.int32
                                    or not cluster_idx.is_contiguous()):
        raise TypeError(f"{name}: cluster ids must be contiguous int32")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    from repro_torch.kernels.build import library   # builds at first use
    lib = library("cluster_gather_ffn")
    p = gather_plan(B, D, K, R, x.element_size())
    dev = x.device
    y = torch.empty((B, D), dtype=x.dtype, device=dev)
    H = torch.empty((B, p.ldh), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.cluster_gather_ffn_launch(
            _ptr(x), _ptr(w), _ptr(cluster_idx), _ptr(H), _ptr(y), B, D, R, K,
            cluster_size, act, _DTYPE_CODES[x.dtype], p.ldh, p.n_tiles,
            p.m_tiles, p.chunk, p.gate_groups, p.x_cluster, p.down_m_tiles,
            p.down_chunk, p.split, p.splits, ctypes.c_void_p(stream))
    _raise_on_error(lib, rc, name, "cluster_gather_ffn")
    return y


@_counts_launches
def cluster_gather_ffn(x, w, cluster_idx, *, activation: str,
                       cluster_size: int):
    """Sum of the bundled FFN over caller-given clusters (replaces
    `repro.kernels.cluster_gather_ffn.cluster_gather_ffn`).

    x (B, D); w (N, R, D) bundled neuron weights; cluster_idx (K,) int32
    ids of clusters of `cluster_size` consecutive neurons, each in
    [0, N / cluster_size). Gate/up dots and the down product accumulate
    in fp32; returns (B, D) in x's dtype.
    """
    _check_activation(activation)
    N = w.shape[0]
    if N % cluster_size:
        raise ValueError(f"N={N} is not a multiple of cluster_size="
                         f"{cluster_size}")
    if not _check_on(x, "cluster_gather_ffn", w=w, cluster_idx=cluster_idx):
        return cluster_gather_ffn_ref(x, w, cluster_idx,
                                      activation=activation,
                                      cluster_size=cluster_size)
    y = _gather_ffn(x, w, cluster_idx, cluster_size, activation,
                    "cluster_gather_ffn")
    cluster_gather_ffn.launches += 1
    return y



def cluster_gather_ffn_grouped(x, wc, cidx, *, activation: str):
    """Grouped form: x (B, D); wc (G, nc_g, cs, R, D) cold clusters per
    group; cidx (G, kc) cluster ids per group. Each id gets its global
    cluster id g * nc_g + id, and one `cluster_gather_ffn` call sums all
    groups' clusters (replaces `repro.kernels.ops.
    cluster_gather_ffn_grouped`)."""
    G, nc_g, cs, R, D = wc.shape
    w_flat = wc.reshape(G * nc_g * cs, R, D)
    gidx = (cidx + torch.arange(G, dtype=cidx.dtype,
                                device=cidx.device)[:, None] * nc_g)
    return cluster_gather_ffn(x, w_flat, gidx.reshape(-1).contiguous(),
                              activation=activation, cluster_size=cs)


@_counts_launches
def dense_ffn(x, w, *, activation: str, block_n: int = 512):
    """Full dense bundled FFN over w (N, R, D) (replaces
    `repro.kernels.dense_ffn.dense_ffn`). x (B, D) -> (B, D) in x's
    dtype, fp32 accumulation. `block_n` is the reference's tile size; it
    is accepted and does not constrain N, which may be any size."""
    _check_activation(activation)
    if block_n < 1:
        raise ValueError(f"block_n must be positive, got {block_n}")
    if not _check_on(x, "dense_ffn", w=w):
        return dense_ffn_ref(x, w, activation=activation)
    y = _gather_ffn(x, w, None, 1, activation, "dense_ffn")
    dense_ffn.launches += 1
    return y


__all__ = ["cluster_gather_ffn", "cluster_gather_ffn_grouped",
           "fused_cold_ffn", "dense_ffn", "launch_counts",
           "set_launch_counts"]
