"""The exchange and kernel benches of the port (``mxnet_tpu_torch/tools/
bench_{comm,overlap,kernels}.py``) at ``--smoke --cpu``, each in a process
of its own, against what ``tests/test_bench_entry.py`` holds of the JAX
package's ``bench.py`` modes, and their deterministic fields against the
JAX package called in this process on the same shapes: the closed-form
``allreduce_plan`` and ``plan_overlap`` bytes at the MLPs' leaf shapes, and
the kernel registry's operation and byte models at the kernel bench's
shapes.

Held on the card only (``tests/test_torch_bench_subsystems_card.py``,
``chip_smoke.py`` phase ``bench_subsystems``): the stale-sync speedup over
1.0 and its efficiency (timed), the telemetry share under 2%, and the
kernel path's zero slab-sized quantize passes (on the CPU the kernels'
plain versions are torch operations, and the profiler counts them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu.comm as jcomm
import mxnet_tpu.ops.pallas  # noqa: F401  (registers the JAX kernels)
from mxnet_tpu.ops.pallas import registry as jreg
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.tools import bench_comm, bench_kernels, bench_overlap
from torch_bench_util import contract, run_benches  # noqa: F401

NAMES = ("comm", "overlap", "kernels")
MODES = ("none", "bf16", "int8", "twobit")


@pytest.fixture(scope="module")
def bench(run_benches):  # noqa: F811
    return run_benches(*NAMES)


def test_comm_smoke_contract(bench):
    """``tests/test_bench_entry.py:16-40``: four modes measured, int8 moving
    fewer bytes than f32, its recorded wire equal to the plan."""
    blob = bench("comm")
    contract(blob, "comm", "comm_bench_int8_wire_reduction_vs_fp32",
             ("value", "vs_baseline", "modes"))
    assert blob["value"] > 1.0
    assert set(blob["modes"]) == set(MODES)
    for mode, row in blob["modes"].items():
        assert row["hlo_wire_bytes_per_step"] > 0, mode
        assert row["step_ms"] > 0, mode
    assert blob["modes"]["int8"]["hlo_wire_bytes_per_step"] == pytest.approx(
        blob["modes"]["int8"]["plan_wire_bytes_per_step"], rel=0.02)
    bench_comm.check(blob)


@pytest.mark.parametrize("mode", MODES)
def test_comm_plan_is_the_jax_packages(bench, mode):
    """The plan of each mode at the MLP's leaf shapes is the JAX package's
    ``allreduce_plan``, and the exchange's recorded wire bytes equal it
    (every mode: the recorded table keeps each payload's own dtype)."""
    dim, hidden, classes, _, _ = bench_comm.shapes(True)
    params = bench_comm.mlp_params(dim, hidden, classes,
                                   np.random.RandomState(0))
    n = sum(v.size for v in params.values())
    blob = bench("comm")
    assert blob["param_elements"] == n
    want = jcomm.allreduce_plan(n, 8, None if mode == "none" else mode)
    row = blob["modes"][mode]
    assert row["plan_wire_bytes_per_step"] == round(want["wire_bytes"], 1)
    assert row["plan_ratio_vs_fp32"] == round(want["ratio"], 2)
    assert row["hlo_wire_bytes_per_step"] == round(want["wire_bytes"], 1)
    assert row["wire_matches_plan"] is True


def test_overlap_smoke_contract(bench):
    """``tests/test_bench_entry.py:181-208``'s structure: at least two
    independent pair groups in the recorded table, bucket plans summing to
    the fused plan, the two schedules' losses equal."""
    blob = bench("overlap")
    contract(blob, "overlap", "overlap_bench_stale_sync_speedup",
             ("value", "vs_baseline", "mesh", "stale_sync",
              "overlap_efficiency", "telemetry_overhead_pct", "bounds"))
    bench_overlap.check(blob)
    sync = blob["stale_sync"]
    assert sync["emulated_rtt_ms"] == 40.0
    assert sync["step_ms_serial"] > 0 and sync["step_ms_pipelined"] > 0
    assert len(sync["step_ms_serial_runs"]) == 2 and sync["max_speedup"] > 1
    flag = blob["bounds"]["value"]
    assert flag["met"] is None or flag["resolvable"], flag
    assert blob["telemetry_overhead_pct"] >= 0


def test_overlap_plan_is_the_jax_packages(bench):
    """The bucket plan at the mesh part's leaf shapes and cap is the JAX
    package's ``plan_overlap``: buckets, wire bytes, the fused plan's."""
    layers, dim, _, _ = bench_overlap.mesh_shapes(True)
    shapes = {}
    for i in range(layers):
        shapes[f"w{i:02d}"] = (dim, dim)
        shapes[f"b{i:02d}"] = (dim,)
    n = sum(int(np.prod(s)) for s in shapes.values())
    plan = jcomm.plan_overlap(shapes, jcomm.CompressionSpec.resolve("int8"),
                              8, max_bytes=max(n * 4 // 3, 1 << 14))
    want = plan.wire_plan()
    mesh = bench("overlap")["mesh"]
    assert mesh["num_buckets"] == plan.num_buckets
    assert mesh["plan_wire_bytes"] == round(want["wire_bytes"], 1)
    assert mesh["fused_wire_bytes"] == round(want["fused_wire_bytes"], 1)
    assert mesh["plan_matches_fused"] is want["matches_fused"] is True


def test_kernels_smoke_contract(bench):
    """``tests/test_bench_entry.py:310-357``'s structure: a roofline row a
    kernel (here each of the eleven, by its own name), the codec path's
    full-slab quantize passes, identical wire bytes, fused Adam bitwise."""
    blob = bench("kernels")
    contract(blob, "kernels",
             "kernel_bench_full_slab_quantize_passes_removed",
             ("value", "vs_baseline", "kernels", "hlo_fused_vs_unfused",
              "wire_bytes_identical", "fused_adam", "int8_matmul_rel_error",
              "catalog"))
    bench_kernels.check(blob)
    hlo = blob["hlo_fused_vs_unfused"]
    assert blob["value"] == (hlo["codec"]["full_slab_quantize_passes"]
                             - hlo["kernels"]["full_slab_quantize_passes"])
    assert blob["vs_baseline"] == hlo["codec"]["full_slab_quantize_passes"]
    assert [r["kernel"] for r in blob["kernels"]] == \
        list(bench_kernels.KERNELS)
    for row in blob["kernels"]:
        assert row["model_flops"] > 0 and row["model_bytes"] > 0, row
        assert row["ms"] > 0 and row["achieved_gflops_s"] > 0, row
        assert row["kernels_in_program"] == [row["kernel"]], row
        assert row["bound_by"] in ("bytes", "operations")
    assert blob["fused_adam"]["fused_ms"] > 0
    assert blob["fused_adam"]["per_leaf_ms"] > 0
    assert 0 < blob["int8_matmul_rel_error"] < 0.02, blob
    assert {c["kernel"] for c in blob["catalog"]} == set(
        bench_kernels.KERNELS)


def _avals(tensors, flat_heads=False):
    out = []
    for t in tensors:
        if isinstance(t, list):
            out.extend(_avals(t, flat_heads))
            continue
        shape = tuple(t.shape)
        if flat_heads and t.dim() >= 3:
            shape = (shape[0] * shape[1], *shape[2:])
        dtype = {torch.float32: jnp.float32, torch.int8: jnp.int8,
                 torch.uint8: jnp.uint8}[t.dtype]
        out.append(jax.ShapeDtypeStruct(shape, dtype))
    return out


@pytest.mark.parametrize("name", bench_kernels.KERNELS)
def test_kernel_models_are_the_jax_registrys(bench, name):
    """Each row's model at the bench's smoke shapes is the JAX registry's
    on the same operands (flash's ``(batch * heads, seq, d)`` layout;
    fused Adam's leaves as the slab they fill). One difference, held
    here as ``tests/test_torch_flash_attention.py`` holds it: the port's
    flash models count the score entries the causal mask keeps, the JAX
    models every entry."""
    sh = bench_kernels.shapes(True)
    calls, _ = bench_kernels.operands(sh, torch.device("cpu"),
                                      np.random.RandomState(0))
    _, ins, outs, static = calls[name]
    cost = registry.get_kernel(name).cost(ins, outs, **static)
    row = next(r for r in bench("kernels")["kernels"] if r["kernel"] == name)
    assert row["model_flops"] == cost.flops
    assert row["model_bytes"] == cost.bytes
    if name == "fused_adam":
        n = sum(t.numel() for t in ins[0])
        slab = jax.ShapeDtypeStruct((n,), jnp.float32)
        want = jreg.kernel_cost(name, [slab] * 4, [slab] * 3)
    else:
        want = jreg.kernel_cost(name, _avals(ins, name.startswith("flash")),
                                _avals(outs, name.startswith("flash")))
    assert cost.bytes == want.bytes
    if name.startswith("flash"):
        b, h, s, _ = ins[0].shape
        kept = tfa.attention_entries(s, s, True) / (s * s)
        assert cost.flops == pytest.approx(want.flops * kept, rel=1e-12)
    else:
        assert cost.flops == want.flops
