"""The dispatch tier: each served decode step run once under a
TorchDispatchMode that sees every aten op it issues.

The port's counterpart of `repro/analysis/jaxpr_rules.py` and
`semantic.py`: where the reference traced each entry to a jaxpr and
walked its equations, the port runs each entry of `entries.py` once and
walks the aten ops it dispatches (`torch.utils._python_dispatch.
TorchDispatchMode`). Rules, each a Finding at path
"dispatch/<cpu|cuda>/<entry>" (the card sees what the CPU cannot, so the
two key their allowlist entries apart):

* dispatch-host-read        - an op that reads a device value on the
                              host (`aten._local_scalar_dense` behind
                              .item() / int() / bool() and `if` on a
                              tensor, `is_nonzero`, the data-dependent
                              shapes of `nonzero`, `masked_select` and
                              `unique`); on the card also every sync
                              torch.cuda's sync debug mode reports (it
                              raises in a graphed entry, warns in an
                              eager one), which is where `.cpu()` and
                              `.tolist()` of a device tensor show.
* dispatch-f64              - an op on a float64 / complex128 tensor.
* dispatch-collective-count - `ShardGroup.calls` after the step differs
                              from the entry's declared count (either
                              way). The fp32 casts of the reductions are
                              the static tier's collective-fp32.
* dispatch-error            - the entry failed to build or to run.
* dispatch-h2d              - a host-to-device copy inside the step (a
                              `_to_copy` / `copy_` from a CPU tensor to
                              a CUDA one, or a CUDA op given a CPU tensor
                              that is not a 0-dim scalar): a capture
                              would replay the copy's first contents. On
                              CPU tensors it cannot be seen; phase
                              analyze of chip_smoke.py checks it.

The reference's jaxpr-callback is dispatch-host-read here, its
jaxpr-const-capture dispatch-h2d; jaxpr-collective-fp32 is the static
collective-fp32 with the cast inside ShardGroup.
"""
from __future__ import annotations

import traceback
import warnings

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.framework import Finding

__all__ = ["DISPATCH_RULES", "OpRecorder", "run_entry", "run_entries",
           "dispatch_findings"]

DISPATCH_RULES = ("dispatch-host-read", "dispatch-f64",
                  "dispatch-collective-count", "dispatch-error",
                  "dispatch-h2d")
HOST_READ_OPS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero",
                 "masked_select", "unique", "_unique", "_unique2",
                 "unique_consecutive", "unique_dim"}
_F64 = (torch.float64, torch.complex128)
_COPIES = {"_to_copy", "copy_"}


def _where() -> str:
    """file:line of the innermost frame of the port outside this tier."""
    for fr in reversed(traceback.extract_stack()):
        f = fr.filename.replace("\\", "/")
        if "repro_torch/" in f and "repro_torch/analysis/" not in f:
            return f"{f.split('src/')[-1]}:{fr.lineno}"
    return "?"


class OpRecorder(TorchDispatchMode):
    """Records the ops of interest that run inside the `with`."""

    def __init__(self):
        super().__init__()
        self.host_reads, self.f64, self.h2d = [], [], []
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.n_ops += 1
        name = func.overloadpacket.__name__
        if name in HOST_READ_OPS:
            self.host_reads.append(f"aten.{name} at {_where()}")
        out = func(*args, **kwargs)
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if any(t.dtype in _F64 for t in ins + outs):
            self.f64.append(f"aten.{name} at {_where()}")
        if any(t.device.type == "cuda" for t in outs) and any(
                t.device.type == "cpu" and (t.dim() > 0 or name in _COPIES)
                for t in ins):
            self.h2d.append(f"aten.{name} at {_where()}")
        return out


def _first(items, k=3) -> str:
    more = f" (+{len(items) - k} more)" if len(items) > k else ""
    return "; ".join(items[:k]) + more


def run_entry(entry, device: str = "cpu", shard=None,
              raise_errors: bool = False) -> list:
    """Build and run one entry; its findings. With `raise_errors` (ranks
    in lockstep), a failure raises instead of becoming a finding, so
    that the peers are not left waiting in a collective."""
    path = entry.path(device)
    try:
        step = entry.build(device, shard)
    except Exception as e:                 # surfaced as a finding
        if raise_errors:
            raise
        return [Finding("dispatch-error", path, 1,
                        f"build failed: {type(e).__name__}: {e}")]
    cuda = torch.device(device).type == "cuda"
    # one eager warm-up pass first, as GraphedStep runs before a capture:
    # lazy set-up (a library's first load, cuBLAS's workspace) is no step's
    try:
        with torch.no_grad():
            step()
    except Exception as e:                 # surfaced as a finding
        if raise_errors:
            raise
        return [Finding("dispatch-error", path, 1,
                        f"warm-up step failed: {type(e).__name__}: {e}")]
    calls0 = shard.calls if shard is not None else 0
    rec, syncs, errors = OpRecorder(), [], []
    if cuda:
        torch.cuda.synchronize()
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error" if entry.graphed else "warn")
    try:
        with warnings.catch_warnings(record=True) as caught, rec, \
                torch.no_grad():
            warnings.simplefilter("always")
            try:
                step()
            except RuntimeError as e:
                if cuda and "synchroniz" in str(e):
                    syncs.append(f"{str(e).splitlines()[0]} at {_where()}")
                elif raise_errors:
                    raise
                else:
                    errors.append(f"{type(e).__name__}: {e}")
        syncs += [str(w.message).splitlines()[0] for w in caught
                  if "synchroniz" in str(w.message)]
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(before)
            torch.cuda.synchronize()
    out = [Finding("dispatch-error", path, 1, f"step failed: {m}")
           for m in errors]
    if rec.host_reads or syncs:
        out.append(Finding(
            "dispatch-host-read", path, 1,
            f"{len(rec.host_reads)} host read(s) and {len(syncs)} sync(s) "
            f"in one step ({'captured in a CUDA graph' if entry.graphed else 'eager'}"
            f"): {_first(rec.host_reads + syncs)}"))
    if rec.f64:
        out.append(Finding("dispatch-f64", path, 1,
                           f"{len(rec.f64)} f64 op(s): {_first(rec.f64)}"))
    if rec.h2d:
        out.append(Finding("dispatch-h2d", path, 1,
                           f"{len(rec.h2d)} host-to-device copies: "
                           f"{_first(rec.h2d)}"))
    n = (shard.calls if shard is not None else 0) - calls0
    if not errors and n != entry.collectives:
        out.append(Finding(
            "dispatch-collective-count", path, 1,
            f"{n} collectives in one step over {entry.world} rank(s), "
            f"declared {entry.collectives}"))
    return out


def _rank(shard, names, device):
    """One gloo rank's run of the named entries, in lockstep."""
    from repro_torch.analysis.entries import entries
    by_name = {e.name: e for e in entries(shard.size)}
    out = []
    for name in names:
        out += run_entry(by_name[name], device, shard, raise_errors=True)
    return out


def run_entries(entries, device: str = "cpu") -> list:
    """Findings of every entry: one-rank entries in this process, the
    others in one spawn of gloo ranks per world size (sharing `device`).
    A rank that fails makes every entry of its spawn a dispatch-error."""
    from repro_torch.parallel import spawn
    out = []
    for e in entries:
        if e.world == 1:
            out += run_entry(e, device)
    worlds = sorted({e.world for e in entries if e.world > 1})
    for n in worlds:
        names = [e.name for e in entries if e.world == n]
        try:
            ranks = spawn(_rank, n, names, device, device=device,
                          timeout=600)
        except (RuntimeError, TimeoutError) as err:
            msg = str(err).strip().splitlines()[-1]
            out += [Finding("dispatch-error", e.path(device), 1,
                            f"ranks failed: {msg}")
                    for e in entries if e.world == n]
            continue
        out += sorted({f for r in ranks for f in r},
                      key=lambda f: (f.path, f.rule))
    return sorted(out, key=lambda f: (f.path, f.rule))


def dispatch_findings(device: str = "cpu") -> list:
    """The dispatch tier over every entry of entries.py."""
    from repro_torch.analysis.entries import entries
    return run_entries(entries(), device)
