"""The port's hand-written kernels, one entry per kernel the wrappers of
`kernels/ops.py` launch (the counterpart of the reference's
`analysis/trace_registry.py`, and of `analysis/drift.py`'s
trace-registry-drift rule, which `tests/test_torch_registry.py` plays
here).

Each entry names the wrapper, its CUDA source (built by `build.SOURCES`
under the source's stem), its plain PyTorch version in `kernels/ref.py`,
the reference function it replaces (`file:line` where that function's
`def` starts), and its CPU parity test and its card test (marked `gpu`)
by pytest node id. `fused_cold_ffn` has two entries, its fp mode and its
quant mode (int8 / int4-mixed codes, the reference kernel body's quant
branch). `row` marks the entries chip_smoke.py reports a `kernels` row
for; the grouped form launches `cluster_gather_ffn` and counts its
launches there. chip_smoke.py takes each row's name, route, source and
`replaces` from `row()`.
"""
from __future__ import annotations

from dataclasses import dataclass

CSRC = "src/repro_torch/kernels/csrc/"
REF = "src/repro/kernels/"


@dataclass(frozen=True)
class Kernel:
    name: str         # the entry's name (a chip_smoke.py row's name)
    wrapper: str      # the wrapper in kernels/ops.py
    source: str       # the CUDA source, a path in the repo
    plain: str        # its plain version, a function of kernels/ref.py
    replaces: str     # file:line where the reference function starts
    function: str     # that reference function's name
    cpu_test: str     # its CPU parity test, by node id
    gpu_test: str     # its card test, by node id
    route: str = "cuda"
    row: bool = True  # chip_smoke.py reports a kernels row for it

    @property
    def build_name(self) -> str:
        """The name `build.SOURCES` builds the source under."""
        return self.source.rsplit("/", 1)[-1].removesuffix(".cu")


KERNELS = (
    Kernel("fused_cold_ffn", "fused_cold_ffn", CSRC + "fused_cold_ffn.cu",
           "fused_cold_ffn_ref", REF + "cluster_gather_ffn.py:275",
           "fused_cold_ffn",
           "tests/test_torch_kernels.py::test_fused_cold_ffn_matches_jax",
           "tests/test_torch_gpu.py::test_fused_cold_ffn_matches_plain"),
    Kernel("fused_cold_ffn (quant mode)", "fused_cold_ffn",
           CSRC + "fused_cold_ffn.cu", "fused_cold_ffn_ref",
           REF + "cluster_gather_ffn.py:129", "_fused_kernel",
           "tests/test_torch_quant.py::test_fused_cold_ffn_quant_matches_jax",
           "tests/test_torch_gpu.py::test_fused_cold_ffn_quant_matches_plain"),
    Kernel("cluster_gather_ffn", "cluster_gather_ffn",
           CSRC + "cluster_gather_ffn.cu", "cluster_gather_ffn_ref",
           REF + "cluster_gather_ffn.py:80", "cluster_gather_ffn",
           "tests/test_torch_gather_kernels.py::"
           "test_cluster_gather_ffn_matches_jax",
           "tests/test_torch_gpu.py::test_gather_and_dense_match_plain"),
    Kernel("cluster_gather_ffn_grouped", "cluster_gather_ffn_grouped",
           CSRC + "cluster_gather_ffn.cu", "cluster_gather_ffn_grouped_ref",
           REF + "ops.py:20", "cluster_gather_ffn_grouped",
           "tests/test_torch_gather_kernels.py::"
           "test_cluster_gather_ffn_grouped_matches_jax",
           "tests/test_torch_gpu.py::test_gather_grouped_and_repeat",
           row=False),
    Kernel("dense_ffn", "dense_ffn", CSRC + "cluster_gather_ffn.cu",
           "dense_ffn_ref", REF + "dense_ffn.py:22", "dense_ffn",
           "tests/test_torch_gather_kernels.py::test_dense_ffn_matches_jax",
           "tests/test_torch_gpu.py::test_gather_and_dense_match_plain"),
)

BY_NAME = {k.name: k for k in KERNELS}


def row(name: str) -> dict:
    """The fixed fields of chip_smoke.py's `kernels` row for entry
    `name`: its name, route, source and the TPU kernel it replaces."""
    k = BY_NAME[name]
    if not k.row:
        raise KeyError(f"{name} has no kernels row of its own")
    return {"name": k.name, "route": k.route, "source": k.source,
            "replaces": k.replaces}
