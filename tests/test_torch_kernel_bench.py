"""``kernel_bench``'s yardsticks and bounds, on the CPU: the library calls
compute the kernels' functions, and the bounds count what the docs say.

Tolerances: f32 rtol 1e-5 and atol 1e-5 (sums and dots in other orders);
the cuDNN-style RNN also adds its identity input product, exact in f32.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch import kernel_bench
from deeprecsys_tpu_torch.experiments import int8_sweep, k3b_sweep, k5_sweep, k6_sweep
from deeprecsys_tpu_torch.kernel_bench import (
    F32_FLOP_PER_S, HBM_BYTES_PER_S, K3B_SHAPES, cold_starts_bound, g_rows, int8_instance_ptxas,
    k1_bound, k1_int8_bound, k1_library, k3_bound, k3_library, k3b_bound, k3b_error, k3b_inputs,
    k3b_library, k4_bound, k5_bound, k5_library, k6_bound, k10_bound, k10_library,
    kernel_instance, launch_sum_ms, main_kernel_ms, ptxas_summary, random_int8_tables)
from deeprecsys_tpu_torch.models.base import table_offsets
from deeprecsys_tpu_torch.ops import (
    embedding_bag_reference, optimizer_update_reference, rnn_scan_backward,
    rnn_scan_backward_reference, rnn_scan_reference, sparse_adagrad_step_reference)
from deeprecsys_tpu_torch.ops.embedding import (
    K1Plan, k1_launch_plan, k4_launch_plan, k6_launch_plan)
from deeprecsys_tpu_torch.ops.sparse_adagrad import K5_THREADS, K5_VEC_BYTES, k5_launch_plan


@pytest.mark.parametrize("name", ["rm1", "din", "ncf"])
def test_k1_library_computes_the_pooled_lookup(name):
    cfg = zoo.get_config(name, table_scale=2000)
    g = torch.Generator().manual_seed(0)
    table = torch.randn((cfg.total_rows, cfg.sparse_feature_size), generator=g)
    offsets = table_offsets(cfg, "cpu")
    idx = torch.from_numpy(RecDataGenerator(cfg, seed=1).generate_batch(6).indices)
    got = k1_library(table, offsets)(idx).view(6, cfg.num_tables, -1)
    torch.testing.assert_close(got, embedding_bag_reference(table, offsets, idx),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,B", [(1, 3), (40, 6)])
def test_k3_library_computes_the_recurrence(T, B):
    g = torch.Generator().manual_seed(T)
    xproj = torch.randn((T, B, 64), generator=g)
    w = torch.randn((64, 64), generator=g) / 8
    b = torch.randn(64, generator=g) * 0.1
    got, last = k3_library(w, b)(xproj)
    want, want_last = rnn_scan_reference(xproj, w, b, torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(last[0], want_last, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B", [(1, 3), (40, 6)])
def test_k3b_bench_inputs_check_and_library_on_the_cpu(T, B, w_dt):
    """``bench_k3b``'s pieces where no card is needed: its inputs (lengths
    in [0, T], row 0 frozen throughout), its check (the wrapper's plain
    loop on the CPU: no error; a wrong delta raises), and its library
    yardstick, cuDNN's backward-data pass through ``torch.nn.RNN``, which
    computes K3b's delta: the gradient of xproj for the gradient gh of
    every state (f32; bf16 weights run the RNN in bf16, so only shapes)."""
    inp = k3b_inputs(T, B, w_dt, "cpu", seed=T + B)
    assert inp["y"].shape == inp["gh"].shape == (T, B, 64) and inp["w"].dtype == w_dt
    assert int(inp["lens"][0]) == 0 and bool(((inp["lens"] >= 0) & (inp["lens"] <= T)).all())
    for lens in (None, inp["lens"]):
        assert k3b_error(rnn_scan_backward, inp, lens) == 0.0

    def off(y, gh, w, lens):
        delta, dh0 = rnn_scan_backward_reference(y, gh, w, lens)
        return delta * (1 + 1e-4), dh0
    with pytest.raises(AssertionError, match="disagrees"):
        k3b_error(off, inp, None)
    (dx,) = k3b_library(inp["w"], inp["b"], inp["xproj"])(inp["gh"].to(w_dt))
    assert dx.shape == (T, B, 64)
    if w_dt == torch.float32:
        want, _ = rnn_scan_backward_reference(inp["y"], inp["gh"], inp["w"])
        torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-5)


def test_k3b_bench_is_an_only_option_at_the_trainers_shapes():
    """``--only k3b`` runs ``bench_k3b`` (without a card the CLI exits 1
    before any bench) at T = 40, B = 128 and 512; its bound counts y, gh
    and delta once, W and dh0 once, and the reverse dot's operations."""
    assert K3B_SHAPES == ((40, 128), (40, 512))
    assert kernel_bench.BENCHES["k3b"] is kernel_bench.bench_k3b
    if not torch.cuda.is_available():
        assert kernel_bench.main(["--only", "k3b"]) == 1
    got = k3b_bound(40, 128, 64)
    assert got["bytes"] == 3 * 40 * 128 * 64 * 4 + 64 * 64 * 4 + 128 * 64 * 4
    assert got["flops"] == 2 * 40 * 128 * 64 * 64 + 4 * 40 * 128 * 64
    assert got["bound_by"] == "bytes"


def test_k3b_sweep_holds_every_instance_once():
    """The K3b sweep's instances hold the shipped one and its entry point
    dispatches each (weight type, threads a unit, units a thread, chains,
    steps a chunk, chunks in the ring) exactly once; a thread's share of
    the dot is whole chains."""
    src = (Path(kernel_bench.__file__).parent / "ops" / "csrc" / "rnn_scan_backward.cu").read_text()
    shipped = tuple(int(re.search(rf"static constexpr int {k} = (\d+);", src).group(1))
                    for k in ("KS", "NU", "kChains", "kChunk", "kRing"))
    assert shipped in k3b_sweep.instances()
    assert all((16 // ks) % c == 0 and (nu == 1 or ks == 1) and r >= 2
               for ks, nu, c, _, r in k3b_sweep.instances())
    keys = k3b_sweep.keys()
    body = k3b_sweep._source(Path("rnn_scan_backward.cu"), keys)
    cases = [line.split(": ", 1)[1] for line in body.splitlines()
             if line.strip().startswith("case ")]
    assert len(cases) == len(set(cases)) == len(keys) == 2 * len(k3b_sweep.instances())


def test_k1_bound_counts_distinct_rows_ids_and_output():
    table = torch.zeros((100, 32), dtype=torch.bfloat16)
    offsets = torch.tensor([0, 50], dtype=torch.int32)
    idx = torch.tensor([[[1, 2, 2], [1, 3, 4]]], dtype=torch.int32)  # row 2 twice; 1 and 51
    got = k1_bound(table, offsets, idx, torch.float32)
    nbytes = 5 * 32 * 2 + 6 * 4 + 2 * 32 * 4
    assert got["bytes"] == nbytes and got["flops"] == 6 * 32
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(nbytes / HBM_BYTES_PER_S * 1e3)


def test_int8_bounds_count_distinct_rows_ids_scales_and_output():
    """K1's accounting at int8 rows: d bytes a row (K1-int8, plus the (T,)
    f32 scales), d + 4 bytes (K4)."""
    q = torch.zeros((100, 32), dtype=torch.int8)
    qrows = torch.zeros((100, 36), dtype=torch.int8)
    offsets = torch.tensor([0, 50], dtype=torch.int32)
    idx = torch.tensor([[[1, 2, 2], [1, 3, 4]]], dtype=torch.int32)  # 5 distinct rows
    got = k1_int8_bound(q, offsets, idx, torch.bfloat16)
    assert got["bytes"] == 5 * 32 + 6 * 4 + 2 * 4 + 2 * 32 * 2
    assert got["flops"] == 6 * 32 + 2 * 32 and got["bound_by"] == "bytes"
    got = k4_bound(qrows, offsets, idx, torch.float32)
    assert got["bytes"] == 5 * 36 + 6 * 4 + 2 * 32 * 4 and got["flops"] == 2 * 6 * 32
    assert got["bound_ms"] == pytest.approx(got["bytes"] / HBM_BYTES_PER_S * 1e3)


def test_random_int8_tables_share_values_and_carry_their_scales():
    cfg = zoo.get_config("wnd", table_scale=2000)
    t = random_int8_tables(cfg, torch.Generator().manual_seed(0), "cpu")
    R, d = cfg.total_rows, cfg.sparse_feature_size
    assert t["q"].shape == (R, d) and t["qrows"].shape == (R, d + 4)
    assert t["scale"].shape == (cfg.num_tables,) and bool((t["scale"] > 0).all())
    assert torch.equal(t["q"], t["qrows"][:, :d])
    row_scale = t["qrows"][:, d:].contiguous().view(torch.float32)
    assert bool((row_scale > 0).all() & (row_scale < 0.011).all())


def test_k3_bound_at_dien_shape_is_its_operations():
    got = k3_bound(40, 512, 64, torch.bfloat16)
    assert got["flops"] == 2 * 40 * 512 * 64 * 64
    assert got["bytes"] == 40 * 512 * 64 * 6 + (64 * 64 + 64) * 4
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(got["flops"] / F32_FLOP_PER_S * 1e3)
    assert np.isclose(got["bound_ms"] * 1e3, 2.504, atol=1e-3)  # µs


def test_main_kernel_ms_is_the_median_of_the_busiest_kernel():
    """A call of a 15 µs kernel and a 1 µs zero-fill: the median over all
    events would be their midpoint, 8 µs; the kernel's own median is 15."""
    durations = {"fill": [0.9, 1.0] * 50, "k3b": [15.0, 14.9, 15.1] * 33 + [15.0]}
    assert main_kernel_ms(durations) == pytest.approx(15.0e-3)
    assert float(np.median(durations["fill"] + durations["k3b"])) == pytest.approx(8.0, abs=0.1)
    assert main_kernel_ms({"k1": [13.8]}) == pytest.approx(13.8e-3)


def test_launch_sum_ms_adds_each_launchs_median():
    """K6's two launches a call (a 1.8 µs cold_start build, a 7.5 µs pool)
    over 100 calls, with 30 of the pool's trace events dropped: the sum of
    medians stays 9.3 µs where the summed events over the calls fall to 7.05;
    a kernel launched twice a call counts twice."""
    durations = {"cold_starts": [1.8] * 100, "pool": [7.4, 7.5, 7.6] * 23 + [7.5]}
    assert launch_sum_ms(durations, 100) == pytest.approx(9.3e-3)
    assert sum(sum(us) for us in durations.values()) / 100 == pytest.approx(7.05)
    assert launch_sum_ms({"k5": [10.0] * 200}, 100) == pytest.approx(20.0e-3)


# ptxas -v's lines for two K1-int8 instances (this source's and the
# parent design's template arguments) and one of K1.
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125embedding_bag_int8_kernelI13__nv_bfloat16Li32ELi2ELi1ELi2ELb0EEEvPKaPKfPKiS7_PKhPT_lii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125embedding_bag_int8_kernelI13__nv_bfloat16Li32ELi2ELi1ELi2ELb0EEEvPKaPKfPKiS7_PKhPT_lii
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125embedding_bag_int8_kernelIfLi64ELi1ELi4EEEvPKaPKfPKiS5_PKhPT_lii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120embedding_bag_kernelI13__nv_bfloat16S1_Li32ELi8ELi1EEEvPKT_PKiS6_PKhPT0_lii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
"""


def test_ptxas_summary_names_each_instance_with_its_registers_and_spills():
    mangled = "_ZN12_GLOBAL__N_133embedding_bag_int8_rowwise_kernelIfLi64ELi4ELi1ELi2ELb1EEEvPKa"
    assert kernel_instance(mangled) == "embedding_bag_int8_rowwise_kernel<f32, 64, 4, 1, 2, 1>"
    assert ptxas_summary(PTXAS_LOG) == [
        "embedding_bag_int8_kernel<bf16, 32, 2, 1, 2, 0>: 56 regs, 8 B spilled",
        "embedding_bag_int8_kernel<f32, 64, 1, 4>: 40 regs, 0 B spilled",
        "embedding_bag_kernel<bf16, S, 32, 8, 1>: 30 regs, 0 B spilled"]


def test_int8_instance_ptxas_finds_the_instance_a_plan_launches():
    lines = ptxas_summary(PTXAS_LOG)
    rm1 = k1_launch_plan(512 * 8, 80, 32, torch.int8)
    assert (rm1.row_slots, rm1.bags_per_warp, rm1.rows_per_lane) == (16, 1, 2)
    assert int8_instance_ptxas(lines, "K1-int8", 32, rm1) == "56 regs, 8 B spilled"
    assert int8_instance_ptxas(lines, "K4", 32, k4_launch_plan(512 * 8, 80, 32)) == "not found"
    # An earlier design's names, <TC, D, G, U>, are found by (G, U).
    old = K1Plan(bags_per_warp=1, rows_per_lane=4, row_slots=8, tasks=1, grid=1)
    assert int8_instance_ptxas([lines[1].replace("f32", "bf16")], "K1-int8", 64, old) == \
        "40 regs, 0 B spilled"


@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_int8_sweep_builds_every_shipped_mapping_once(name):
    """The sweep's instances hold the mapping each plan ships at every zoo
    shape, and its entry point dispatches each instance exactly once."""
    cfg = zoo.get_config(name)
    d, L = cfg.sparse_feature_size, cfg.num_indices_per_lookup
    for kernel, plan in (("K1-int8", k1_launch_plan(512 * cfg.num_tables, L, d, torch.int8)),
                         ("K4", k4_launch_plan(512 * cfg.num_tables, L, d))):
        found = {(lpr, g, u) for lpr, g, u, *_ in int8_sweep.instances(kernel, d, L <= 8)}
        assert (32 // plan.row_slots, plan.bags_per_warp, plan.rows_per_lane) in found
        src = int8_sweep._source(kernel, d, Path("embedding_bag_int8.cu"))
        cases = [line for line in src.splitlines() if line.strip().startswith("if (lpr")]
        assert len(cases) == len(set(cases)) == len(
            set(int8_sweep.instances(kernel, d, True) + int8_sweep.instances(kernel, d, False)))


def test_k6_bound_counts_both_launches():
    """K6's bound: distinct hot and cold rows, the split's arrays and the
    output, not the cold_start scratch of its design; its first launch's
    own bound: cold_seg read and cold_start written once."""
    table = torch.zeros((100, 32), dtype=torch.bfloat16)
    hot = torch.zeros((10, 32), dtype=torch.bfloat16)
    split = {"hot_sel": torch.tensor([[[0, 3, 3], [0, 0, 1]]], dtype=torch.int32),
             "hot_mask": torch.tensor([[[1, 1, 1], [0, 0, 1]]], dtype=torch.bool),
             "cold_ids": torch.tensor([7, 7, 0, 0], dtype=torch.int32),
             "cold_seg": torch.tensor([1, 1, 2, 2], dtype=torch.int32)}  # 2 real, 2 pads
    got = k6_bound(hot, table, split, torch.float32)
    rows = 3 + 1  # hot 0, 3, 1; cold 7
    nbytes = rows * 64 + 6 * 5 + 4 * 8 + 2 * 32 * 4
    assert got["bytes"] == nbytes and got["flops"] == (4 + 2) * 32
    got8 = k6_bound(hot.to(torch.int8), table.to(torch.int8), split, torch.bfloat16, "int8")
    assert got8["bytes"] == rows * 32 + 6 * 5 + 4 * 8 + 2 * 32 * 2 + 2 * 4
    assert got8["flops"] == 6 * 32 + 2 * 32
    starts = cold_starts_bound(split)
    assert starts["bytes"] == 4 * 4 + 3 * 4 and starts["flops"] == 0
    assert starts["bound_by"] == "bytes"


@pytest.mark.parametrize("name", k6_sweep.MODELS + ("rm3", "wnd"))
def test_k6_sweep_holds_every_shipped_mapping_once(name):
    """The K6 sweep's instances at rm1's, rm2's and din's shapes (and rm3's
    and wnd's, which the int8 sweep adds) hold the mapping each layout ships
    (``k6_launch_plan``) with the same plan, and its entry point dispatches
    each instance exactly once; per-table int8 sweeps K1-int8's mappings
    and the parent design's (a warp a bag, 32 slots a step, every short
    bag's rows at once, no hint) among G x U x hint x window."""
    cfg = zoo.get_config(name)
    d, L = cfg.sparse_feature_size, cfg.num_indices_per_lookup
    for layout, mode in (("none", "float"), ("int8_rowwise", "int8_rowwise"), ("int8", "int8")):
        plan = k6_launch_plan(512 * cfg.num_tables, L, mode, d, 2 if layout == "none" else 1)
        inst = k6_sweep._shipped_inst(layout, L, d, 512 * cfg.num_tables)
        key = k6_sweep._key(layout, d, L, inst)
        assert key in {k6_sweep._key(layout, d, L, i)
                       for i in k6_sweep.instances(layout, d, L <= 8)}
        geo = plan.geometry
        assert key == (layout, d, plan.rows_per_slot, plan.ids_per_lane, geo.values_per_lane,
                       geo.bags_per_warp if L > 8 else 1, geo.rows_per_slot, geo.hint)
        ub, ni, grid, _ = k6_sweep._plan(512 * cfg.num_tables, L, d, inst)
        assert (ub, ni, grid) == (plan.rows_per_slot, plan.ids_per_lane, plan.grid)
    parent = (16, 1, 2 if d == 32 else 4, 0, 4) if L > 8 else (16, 1, 8, 0, 4)
    assert parent in k6_sweep.instances("int8", d, L <= 8)
    keys = k6_sweep.sweep_keys([name])
    assert set(k6_sweep.shipped_keys([name])) <= set(keys)
    src = k6_sweep._source(Path("embedding_bag_hotcold.cu"), keys)
    cases = [line.split(": ", 1)[1] for line in src.splitlines()
             if line.strip().startswith("case ")]
    assert len(cases) == len(set(cases)) == len(keys)


def test_k5_and_k10_benches_are_only_options():
    """``--only k5,k10`` run ``bench_k5`` and ``bench_k10`` (without a card
    the CLI exits 1 before any bench) at the sparse steps' shapes and over
    rm1's dense params."""
    assert kernel_bench.BENCHES["k5"] is kernel_bench.bench_k5
    assert kernel_bench.BENCHES["k10"] is kernel_bench.bench_k10
    assert kernel_bench.K5_MODELS == ("rm1", "dien") and kernel_bench.K10_MODEL == "rm1"
    if not torch.cuda.is_available():
        assert kernel_bench.main(["--only", "k5,k10"]) == 1


def test_k10_bound_counts_each_pass_and_operation():
    """sgd reads p and g and writes p (3 passes), adagrad also reads and
    writes its accumulator (5), adam its two moments (7); at rm1's 32 M x
    32 f32 table adagrad moves 20.48 GB, 6.11 ms at 3.35 TB/s."""
    leaves = [torch.zeros((7, 3)), torch.zeros(5, dtype=torch.bfloat16)]
    for name, passes, ops in (("sgd", 3, 2), ("adagrad", 5, 7), ("adam", 7, 14)):
        got = k10_bound(leaves, name)
        assert got["bytes"] == (21 * 4 + 5 * 2) * passes and got["flops"] == 26 * ops
        assert got["bound_by"] == "bytes"
    table = torch.empty((32_000_000, 32), device="meta")
    got = k10_bound([table], "adagrad")
    assert got["bytes"] == 32_000_000 * 32 * 4 * 5
    assert got["bound_ms"] == pytest.approx(6.1134, abs=1e-3)


@pytest.mark.parametrize("name", ["sgd", "adagrad", "adam"])
def test_k10_library_computes_the_update(name):
    """The yardsticks compute K10's function (other roundings): sgd's
    ``_foreach_add_`` and torch's fused Adam over two steps within 1e-5 of
    the plain version; adagrad has none (torch's divides by sqrt(acc) +
    eps)."""
    lib = k10_library(name, 0.05)
    if name == "adagrad":
        assert lib is None
        return
    g = torch.Generator().manual_seed(4)
    params = [torch.randn((9, 5), generator=g), torch.randn(7, generator=g)]
    grads = [torch.randn(p.shape, generator=g) * 1e-2 for p in params]
    want = [p.clone() for p in params]
    states = [[torch.zeros_like(p) for p in params] for _ in range(2 if name == "adam" else 0)]
    plain_states = [[t.clone() for t in s] for s in states]
    for count in (1, 2):
        lib(params, grads, states)
        optimizer_update_reference(name, want, grads, plain_states, 0.05,
                                   torch.tensor(count, dtype=torch.int32))
    for a, b in zip(params, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_k5_library_computes_the_step_from_g_rows():
    """``k5_library`` on ``g_rows``' broadcast rows, mean squares and fused
    rows is the step's plain version (the same ops, so equal within f32
    rounding)."""
    cfg = zoo.get_config("rm1", table_scale=2000)
    g = torch.Generator().manual_seed(6)
    offsets = table_offsets(cfg, "cpu")
    idx = torch.from_numpy(RecDataGenerator(cfg, seed=2).generate_batch(16).indices)
    grad = torch.randn((16, cfg.num_tables, 32), generator=g) * 1e-2
    table = torch.randn((cfg.total_rows, 32), generator=g) * 0.05
    acc = torch.rand((cfg.total_rows,), generator=g) * 1e-4
    got_t, got_a, want_t, want_a = table.clone(), acc.clone(), table.clone(), acc.clone()
    k5_library(got_t, got_a, 0.1)(*g_rows(grad, offsets, idx))
    sparse_adagrad_step_reference(want_t, want_a, offsets, idx, grad, 0.1)
    torch.testing.assert_close(got_a, want_a, rtol=1e-6, atol=0)
    torch.testing.assert_close(got_t, want_t, rtol=1e-5, atol=1e-7)
    got = k5_bound(table, grad, offsets, idx)
    B, T, L = idx.shape
    touched = torch.unique(idx.long() + offsets.long()[None, :, None]).numel()
    assert got["bytes"] == touched * (32 * 4 + 4) * 2 + grad.numel() * 4 + idx.numel() * 4
    assert got["flops"] == B * T * 2 * 32 + B * T * L * (3 * 32 + 2)


@pytest.mark.parametrize("L", [1, 2, 3, 5, 17, 32, 33, 80, 200])
@pytest.mark.parametrize("d,table_dt,g_dt", [
    (32, torch.float32, torch.float32), (64, torch.float32, torch.float32),
    (32, torch.bfloat16, torch.bfloat16), (64, torch.bfloat16, torch.float32)])
def test_k5_launch_plan_covers_every_slot_and_chunk_once(L, d, table_dt, g_dt):
    """K5's two launches as ``csrc/sparse_adagrad.cu`` maps them, simulated:
    launch 1 (S lanes a window of S slots) adds every slot once, a task has
    a lane for each 16-byte chunk of the bag's gradient row, and its
    halving shuffles pair lanes inside the task; launch 2 (a group of lanes
    a slot, one 16-byte add a lane) covers every element of every slot's
    row once. Bag counts that are no multiple of the bags a warp hold."""
    n_bags = 37
    plan = k5_launch_plan(n_bags, L, d, table_dt, g_dt)
    S, chunks = plan.lanes_per_bag, d * g_dt.itemsize // 16
    assert S in (1, 2, 4, 8, 16, 32) and chunks <= S <= 32 and (S >= L or S == 32)
    windows = -(-L // S)
    slots = {}
    for t in range(plan.accumulate_blocks * K5_THREADS):
        task, j = divmod(t, S)
        bag, w = divmod(task, windows)
        if bag >= n_bags:
            continue
        l = w * S + j
        if l < L:
            slots[(bag, l)] = slots.get((bag, l), 0) + 1
    assert slots == {(b, l): 1 for b in range(n_bags) for l in range(L)}
    lane = np.arange(32)
    for off in [o for o in (16, 8, 4, 2, 1) if o < chunks]:
        assert np.all((lane ^ off) // S == lane // S)  # the shuffle stays in the task
    P = d * table_dt.itemsize // K5_VEC_BYTES
    assert plan.lanes_per_slot == min(32, P)
    E = K5_VEC_BYTES // table_dt.itemsize
    seen = np.zeros((n_bags * L, d), dtype=int)
    for t in range(plan.apply_blocks * K5_THREADS):
        slot, j = divmod(t, plan.lanes_per_slot)
        if slot >= n_bags * L:
            continue
        for k in range(P // plan.lanes_per_slot):
            seen[slot, (j + k * plan.lanes_per_slot) * E:(j + k * plan.lanes_per_slot + 1) * E] += 1
    assert np.all(seen == 1)


def test_k5_sweep_holds_every_instance_once():
    """The K5 sweep's instances hold the shipped one (``Shipped`` in the
    source: 16-byte adds, a group of lanes a slot, no prefetch, PDL), its
    variants the plan's lanes a bag, and its entry point dispatches each
    (table dtype, add width, mapping, prefetch) exactly once."""
    src = (Path(kernel_bench.__file__).parent / "ops" / "csrc" / "sparse_adagrad.cu").read_text()
    assert re.search(rf"kVecBytes = {K5_VEC_BYTES};", src)
    assert re.search(rf"kPrefetch = {k5_sweep.SHIPPED_PREFETCH};", src)
    assert re.search(r"kPdl = true;", src) and k5_sweep.SHIPPED_MAPPING == "flat"
    assert "apply_window_kernel" not in src  # the sweep's other mapping is its own
    keys = k5_sweep.keys()
    for tt in k5_sweep.T_TYPES:
        assert (tt, K5_VEC_BYTES, k5_sweep.SHIPPED_MAPPING, k5_sweep.SHIPPED_PREFETCH) in keys
    for L in (1, 80):
        plan = k5_launch_plan(1, L, k5_sweep.D, torch.float32).lanes_per_bag
        assert (plan, True) in k5_sweep.variants(L, keys[0])
    body = k5_sweep._source(Path("sparse_adagrad.cu"), keys)
    cases = [line.split(": ", 1)[1] for line in body.splitlines()
             if line.strip().startswith("case ") and "(a, lanes_per_bag, pdl)" in line]
    assert len(cases) == len(set(cases)) == len(keys)


def test_k5_sweep_mean_orders_are_sums_of_the_row():
    """Each candidate order of ``torch.mean``'s adds sums the whole row (on
    integers, exact in any order)."""
    x = torch.arange(64, dtype=torch.float32).reshape(2, 32)
    for fn in k5_sweep.MEAN_ORDERS.values():
        torch.testing.assert_close(fn(x), x.sum(-1), rtol=0, atol=0)


def test_window_bounds_and_yardsticks_cover_the_shard():
    """The training windows' bounds: the whole table as one window is the
    direct kernel's bound; shards split its row bytes and operations. Their
    yardsticks' owned rows, index_add_-ed, give the window's plain gradient."""
    from deeprecsys_tpu_torch.kernel_bench import (
        k1b_bound, k1b_window_bound, k5_bound, k5_window_bound, window_g_rows)
    from deeprecsys_tpu_torch.ops import embedding_bag_backward_reference

    cfg = zoo.get_config("rm1", table_scale=2000)
    R, d = cfg.total_rows, cfg.sparse_feature_size
    offsets = table_offsets(cfg, "cpu")
    ids = torch.as_tensor(RecDataGenerator(cfg, seed=3).generate_batch(16).indices)
    g = torch.randn((16, cfg.num_tables, d), generator=torch.Generator().manual_seed(0))
    table = torch.zeros((R, d))
    assert k1b_window_bound(g, offsets, ids, 0, R) == k1b_bound(g, offsets, ids)
    assert k5_window_bound(table, g, offsets, ids, 0) == k5_bound(table, g, offsets, ids)
    rps = R // 4
    flops = [k1b_window_bound(g, offsets, ids, m * rps, rps)["flops"] for m in range(4)]
    assert sum(flops) == k1b_bound(g, offsets, ids)["flops"]
    rows, g2, local = window_g_rows(g, offsets, ids, rps, rps)
    got = torch.zeros((rps, d)).index_add_(0, local, rows)
    want = embedding_bag_backward_reference(g, offsets, ids, rps, window=(rps, 2 * rps))
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(g2, (rows * rows).mean(-1))


@pytest.mark.parametrize("name", kernel_bench.K1W_MODELS)
@pytest.mark.parametrize("M,B", kernel_bench.K1W_CELLS)
def test_k1w_bench_inputs_check_bound_and_library_on_the_cpu(name, M, B):
    """``--only k1w``'s pieces where no card is needed, at table_scale 2000:
    shard 1 of M and its ids; the check passes the window's plain version;
    the windowed ``F.embedding_bag`` computes the shard's partial; the
    bound reads only the owned distinct rows, the ids of the tables that
    meet the shard and the f32 partial.
    Without a card the CLI exits 1 before any bench."""
    from deeprecsys_tpu_torch.kernel_bench import (
        _k1w_check, k1w_inputs, window_bound, window_library)

    inp = k1w_inputs(name, M, B // 64, "cpu", n_batches=1, table_scale=2000)
    shard, lo, offsets, idx = inp["shard"], inp["row_lo"], inp["offsets"], inp["ids"][0]
    R = inp["cfg"].total_rows
    assert shard.shape == (R // M, inp["cfg"].sparse_feature_size) and lo == R // M
    assert idx.shape == (B // 64, inp["cfg"].num_tables, inp["cfg"].num_indices_per_lookup)
    w = (lo, lo + shard.shape[0])
    want = embedding_bag_reference(shard, offsets, idx, window=w)
    _k1w_check(want, inp, idx, "plain")
    lib = window_library(shard, lo, offsets)(idx).view(want.shape)
    torch.testing.assert_close(lib.float(), want, rtol=2 ** -7, atol=2 ** -7)
    flat = (idx.long() + offsets.long()[None, :, None]).reshape(-1)
    owned = flat[(flat >= lo) & (flat < lo + shard.shape[0])]
    b = window_bound(shard, lo, offsets, idx, shard.shape[1])
    meet = idx[:, 2:4] if (name, M) == ("rm1", 4) else kernel_bench.meeting_ids(
        offsets, idx, lo, shard.shape[0])
    assert b["bytes"] == (torch.unique(owned).numel() * shard.shape[1] * 2 + meet.numel() * 4
                          + want.numel() * 4)
    assert kernel_bench.BENCHES["k1w"] is kernel_bench.bench_k1w
    if not torch.cuda.is_available():
        assert kernel_bench.main(["--only", "k1w"]) == 1


def test_k1w_sweep_unit_launches_every_design_from_the_shipped_source():
    """The sweep's translation unit (``experiments/k1w_sweep.py``) includes
    the shipped K1 source and launches each (design, U) of K1W_SWEEP at d
    32 and 64 once, by the kernel templates the source defines, and its
    floor kernel once a width; ``kernel_bench`` keeps only the shipped
    kernels' benches. Without a card the CLI exits 1."""
    from deeprecsys_tpu_torch.experiments import k1w_sweep
    from deeprecsys_tpu_torch.ops import _build

    src = _build.CSRC / "embedding_bag.cu"
    unit = k1w_sweep.unit(src)
    assert unit.startswith(f'#include "{src}"')
    text = src.read_text()
    assert "embedding_bag_compact_kernel(" in text and "embedding_bag_kernel(" in text
    assert "kCompactIds" in text and "k1w_floor_kernel" not in text
    for design, u in k1w_sweep.K1W_SWEEP:
        for d in k1w_sweep.WIDTHS:
            case = f"if (design == {k1w_sweep.DESIGNS[design]} && U == {u} && d == {d})"
            assert unit.count(case) == 1, case
    for d in k1w_sweep.WIDTHS:
        assert unit.count(f"k1w_floor_kernel<{d}><<<") == 1
    assert "k1w_sweep" not in kernel_bench.BENCHES
    if not torch.cuda.is_available():
        assert k1w_sweep.main([]) == 1
