"""Plain versions of kernels 3-4 (hmmspikesorter_torch/ops/viterbi_ovn_mb.py)
in float32 against the JAX package's vmapped ring_viterbi_ovn in float32 —
which the Pallas kernels they replace bit-match
(tests/test_pallas_ovn_mb.py) — plus the packing, the wrappers' CPU
routing and the shared-memory gate. The kernels themselves are held
against these plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.ops import ring_viterbi_ovn as trvo
from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
from hmmspikesorter_tpu.data.synthetic import (create_signal,
                                               create_spike_template)
from hmmspikesorter_tpu.ops.ring_viterbi_ovn import ring_viterbi_ovn
from tests.torch_port import ovn_windows

W = 96


def _jax_f32(y_win, lp, temps, sil):
    one = jax.vmap(lambda yy, s0: ring_viterbi_ovn(
        yy, jnp.asarray(lp, jnp.float32), jnp.asarray(temps, jnp.float32),
        np.float32(0.3), silent_start=s0, with_ll=False)[0])
    return np.asarray(one(jnp.asarray(y_win, jnp.float32), jnp.asarray(sil)))


def _plain_f32(y_win, lp, temps, sil):
    c = vomb.ovn_consts(lp, temps, np.float32(0.3), dtype=torch.float32,
                        device="cpu")
    y = torch.as_tensor(y_win, dtype=torch.float32)
    out = vomb.ovn_forward_mb_plain(y, torch.as_tensor(sil), c)
    return c, y, out, vomb.ovn_backtrace_mb_plain(*out, c)


@pytest.mark.parametrize("N,K,seed", [(2, 12, 12), (3, 9, 5), (4, 7, 11)])
@pytest.mark.parametrize("mask", ["none", "all", "mixed"])
def test_plain_kernels_f32_match_jax(N, K, seed, mask):
    B = 4
    y_win, temps, lp = ovn_windows(N, K, B, W, seed, extra_noise=0.1)
    sil = {"none": np.zeros(B, bool), "all": np.ones(B, bool),
           "mixed": np.array([True, False, False, True])}[mask]
    c, _, _, labels = _plain_f32(y_win, lp, temps, sil)
    assert labels.dtype == torch.int16 and labels.shape == (B, W)
    ref = _jax_f32(y_win, lp, temps, sil)
    np.testing.assert_array_equal(labels.numpy(), ref)
    assert (ref >= c.tab.PB).any()               # pair states exercised


@pytest.mark.parametrize("N", [3, 4])
def test_packing_and_ranges(N):
    B, K = 3, 8
    y_win, temps, lp = ovn_windows(N, K, B, W, seed=N)
    c, _, (flags, rings, rowcol, xT), _ = _plain_f32(
        y_win, lp, temps, np.arange(B) == 0)
    P = N * (N - 1) // 2
    assert flags.shape == (B, W, 1 + N + P) and flags.dtype == torch.uint8
    assert rings.shape == (B, W, N, K - 1) and rings.dtype == torch.uint8
    assert rowcol.shape == (B, W, 2 * P, K - 1)
    assert xT.shape == (B,) and xT.dtype == torch.int32
    # t = 0, ring slot 0 and edge index 0 are never written
    assert not flags[:, 0].any() and not rings[:, 0].any()
    assert not rowcol[:, 0].any()
    assert not rings[..., 0].any() and not rowcol[..., 0].any()
    # each choice indexes its candidate list
    assert flags.max() <= N + P and rings.max() <= N - 1
    assert rowcol.max() <= N - 2
    assert int(rings.max()) > 0 and int(rowcol.max()) > 0
    # the onset of n never comes from n itself or a pair containing n;
    # a corner never from a member or an overlapping pair
    f = flags[:, 1:].long()
    for n in range(N):
        assert not (f[:, :, 1 + n] == 1 + n).any()
    for q, (i, j) in enumerate(trvo._pairs(N)):
        src = f[:, :, 1 + N + q]
        assert not ((src == 1 + i) | (src == 1 + j)).any()


def test_xT_is_first_argmax_of_final_flat_state():
    N, K, B = 3, 8, 4
    y_win, temps, lp = ovn_windows(N, K, B, W, seed=9)
    sil = np.arange(B) == 0
    c, y, (_, _, _, xT), labels = _plain_f32(y_win, lp, temps, sil)
    v = trvo.ovn_init(y[:, 0], torch.as_tensor(sil), c)
    for t in range(1, W):
        v = trvo.maxplus_step(v, y[:, t], c)
    assert v.shape == (B, c.S)
    first = torch.tensor([int(torch.nonzero(r == r.max())[0]) for r in v],
                         dtype=torch.int32)
    assert torch.equal(xT, first)
    assert torch.equal(labels[:, -1].to(torch.int32), xT)
    np.testing.assert_array_equal(
        xT.numpy(), _jax_f32(y_win, lp, temps, sil)[:, -1])


def test_tied_candidates_take_the_first():
    # equal templates and rates make the neurons' candidates tie exactly;
    # the first of the equal candidates must win, as in the JAX engine
    N, K, B = 3, 7, 2
    temps = np.repeat(np.stack([create_spike_template(K, 3.0, 0.8, 0.2)],
                               axis=1), N, axis=1)
    lp = np.log(np.full(N, 0.02))
    rng = np.random.default_rng(3)
    y_win = np.stack([create_signal(W, 0.3, np.full(N, 0.02), temps,
                                    rng=rng)[0] for _ in range(B)])
    sil = np.ones(B, bool)
    c, _, (flags, _, _, _), labels = _plain_f32(y_win, lp, temps, sil)
    np.testing.assert_array_equal(labels.numpy(),
                                  _jax_f32(y_win, lp, temps, sil))
    # the silent state's ring-end candidates tie: the lowest neuron wins
    assert not ((flags[..., 0] >= 2) & (flags[..., 0] <= N)).any()
    assert (labels > 0).any()


def test_wrappers_route_cpu_tensors_to_plain():
    N, K, B = 3, 8, 3
    y_win, temps, lp = ovn_windows(N, K, B, W, seed=4)
    sil = np.arange(B) == 0
    c, y, plain, labels = _plain_f32(y_win, lp, temps, sil)
    n_fwd = vomb.ovn_forward_mb.launches
    n_bt = vomb.ovn_backtrace_mb.launches
    got = vomb.ovn_forward_mb(y, torch.as_tensor(sil), c)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert torch.equal(vomb.ovn_backtrace_mb(*got, c), labels)
    assert torch.equal(vomb.ovn_decode_mb(y, torch.as_tensor(sil), c), labels)
    assert vomb.ovn_forward_mb.launches == n_fwd
    assert vomb.ovn_backtrace_mb.launches == n_bt


def test_consts_pack_the_plain_versions_values():
    N, K = 4, 6
    _, temps, lp = ovn_windows(N, K, 1, W, seed=0)
    c = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float32, device="cpu")
    P = N * (N - 1) // 2
    f = c.fpack
    assert f.dtype == torch.float32 and c.ipack.dtype == torch.int32
    assert torch.equal(f[:3], torch.stack([c.em.silent_mean, c.em.econst,
                                           c.em.inv_2s2]))
    assert torch.equal(f[3:8], c.mlpz)
    assert torch.equal(f[8 + N + 2 * P:8 + N + 2 * P + N * (K - 1)],
                       c.em.sgl_mean.reshape(-1))
    # the kernel's pair means (a_i + a_j) + c_q are the plain version's
    q, a, b = 5, 2, 4                       # pair (2, 3)
    i, j = trvo._pairs(N)[q]
    assert (c.em.a[i, a] + c.em.a[j, b]) + c.em.cq[q] == c.em.pair_mean[q, a,
                                                                         b]
    assert c.ipack.numel() == 2 * P + N * (N - 1) + 2 * P * (N - 2)


def test_float64_plain_matches_jax_float64():
    N, K, B = 3, 9, 3
    y_win, temps, lp = ovn_windows(N, K, B, W, seed=6)
    sil = np.arange(B) == 0
    c = vomb.ovn_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    labels = vomb.ovn_decode_mb_plain(torch.as_tensor(y_win),
                                      torch.as_tensor(sil), c)
    one = jax.vmap(lambda yy, s0: ring_viterbi_ovn(
        yy, jnp.asarray(lp), jnp.asarray(temps), 0.3, silent_start=s0,
        with_ll=False)[0])
    ref = np.asarray(one(jnp.asarray(y_win), jnp.asarray(sil)))
    np.testing.assert_array_equal(labels.numpy(), ref)


def test_shared_memory_gate():
    # the production K=60 (and every K <= 65) passes for N=3 and N=4; K-1
    # past 64 lanes and N=5 pair grids at K=60 do not
    for N in (3, 4):
        for K in (2, 60, 65):
            assert vomb.ovn_kernel_ok(N, K)
    assert vomb.ovn_smem_bytes(3, 60) < 96 * 1024
    assert vomb.ovn_smem_bytes(4, 60) < 176 * 1024
    assert not vomb.ovn_kernel_ok(3, 66)
    assert vomb.ovn_kernel_ok(5, 54) and not vomb.ovn_kernel_ok(5, 55)
    assert not vomb.ovn_kernel_ok(1, 60)


# --------------------------------------------------------------------------
# kernel 3's block shape and cell map (csrc/ovn_cells.cuh), held here on the
# CPU; the kernel itself is held against the plain version on the card
# --------------------------------------------------------------------------

# (N, K) of the cell-map tests: every N the cell map takes, K at one and two
# ring slots, a small grid, the production K and the largest K-1 (64) that
# fits (N=5: K=54, the largest its shared memory takes)
CELL_CASES = [(N, K) for N in (2, 3, 4) for K in (2, 3, 9, 60, 65)] + [
    (5, K) for K in (2, 3, 9, 54)]


def _gate_at_parent(N, K):
    """The shared-memory gate kernels 3-4 had before the cell map: the
    double-buffered state, the float constants and the int tables in one
    CTA's 227 KB (less the argmax scratch)."""
    Km1, P = K - 1, N * (N - 1) // 2
    S = 1 + N * Km1 + P * Km1 * Km1
    n_f = 8 + N + 2 * P + 2 * N * Km1
    n_i = 2 * P + N * (N - 1) + 2 * P * (N - 2)
    return 1 <= Km1 <= 64 and 4 * (2 * S + n_f + n_i) <= 232448 - 256


@pytest.mark.parametrize("N", [2, 3, 4, 5, 6, 8])
def test_kernel_gate_admits_every_earlier_topology(N):
    # never narrower than before: N=2-4 for every K <= 65, N=5 to K=54
    for K in range(2, 70):
        if _gate_at_parent(N, K):
            assert vomb.ovn_kernel_ok(N, K), (N, K)
            plan = vomb.ovn_launch_plan(N, K - 1)
            assert plan.smem_bytes <= vomb.SMEM_LIMIT, (N, K)
    if N <= 4:
        assert all(vomb.ovn_kernel_ok(N, K) for K in range(2, 66))
    if N == 5:
        assert vomb.ovn_kernel_ok(5, 54)


def _mc_gate_at_parent(N, K):
    """The shared-memory gate kernel 11 had before the cell map: the
    double-buffered state, the float constants (the dynamics' and c1), the
    int tables and two staged stream rows in one CTA, and kernel 4's gate."""
    Km1, P = K - 1, N * (N - 1) // 2
    S = 1 + N * Km1 + P * Km1 * Km1
    n_f = 5 + N + P + N * Km1
    n_i = 2 * P + N * (N - 1) + 2 * P * (N - 2)
    mc = 4 * (2 * S + n_f + n_i + 2 * (1 + N * Km1))
    return _gate_at_parent(N, K) and mc <= 232448 - 256


@pytest.mark.parametrize("N", [2, 3, 4, 5, 6, 7, 8])
def test_mc_kernel_gate_admits_every_earlier_topology(N):
    # never narrower than before: N=2-4 for every K <= 65, N=5 to K=54
    admitted = 0
    for K in range(2, 70):
        if _mc_gate_at_parent(N, K):
            admitted += 1
            assert vomb.ovn_mc_kernel_ok(N, K), (N, K)
            plan = vomb.ovn_mc_launch_plan(N, K - 1)
            assert plan.smem_bytes <= vomb.SMEM_LIMIT, (N, K)
            assert plan.design == ("cells" if N <= 5 else "general")
    assert admitted > 0
    if N <= 4:
        assert all(vomb.ovn_mc_kernel_ok(N, K) for K in range(2, 66))
    if N == 5:
        assert vomb.ovn_mc_kernel_ok(5, 54)


@pytest.mark.parametrize("N,K,threads,cells,interior", [
    (2, 60, 512, 9, "diagonal"), (3, 60, 512, 29, "diagonal"),
    (4, 60, 512, 51, "stride"), (5, 54, 1024, 31, "stride")])
def test_mc_launch_plan_production_shapes(N, K, threads, cells, interior):
    Km1, P = K - 1, N * (N - 1) // 2
    plan = vomb.ovn_mc_launch_plan(N, Km1)
    assert (plan.design, plan.interior, plan.threads, plan.cells_per_thread,
            plan.ctas_per_sm) == ("cells", interior, threads, cells, 1)
    assert vomb.ovn_launch_plan(N, Km1).threads == threads
    built = next(iter(vomb.MC_SHAPES[N].values()))
    assert cells == built[0]
    S = 1 + N * Km1 + P * Km1 * Km1
    T = threads - vomb.FIXED
    G = P * Km1 * Km1
    floats = plan.smem_bytes // 4
    # [state | state | the staged rows, which also take the stride
    # interior's last loads past the second buffer]
    rows = 2 * vomb.ovn_mc_stage_floats(N, Km1)
    if interior == "diagonal":
        assert floats == 2 * S + rows and plan.c2_floats == G
        # every wrapped diagonal of every grid has its pieces, one a thread
        assert P * -(-(Km1 - 1) // cells) * (Km1 - 1) <= T
        # and the larger piece would not be needed
        assert vomb.ovn_mc_launch_plan(N, 64).cells_per_thread == built[1]
    else:
        assert floats == 2 * S + max(rows, cells * T - G)
        assert S + 1 + N * Km1 + cells * T <= floats
        # the last slot's c2 (at M + 1 + u + c*T) lies in the padded c2
        assert plan.c2_floats == max(G, Km1 + 1 + cells * T)
        need = vomb.cells_per_thread(N, Km1, threads)
        assert cells == min(c for c in built if c >= need)
    assert plan.smem_bytes <= vomb.SMEM_LIMIT
    # windows beyond the SMs: N=2 takes its two-CTA shape, the rest one
    wide = vomb.ovn_mc_launch_plan(N, Km1, B=256, sm_count=132)
    assert wide.ctas_per_sm == (2 if N == 2 else 1)
    assert vomb.ovn_mc_launch_plan(N, Km1, B=132, sm_count=132) == plan
    assert wide.smem_bytes == plan.smem_bytes
    with pytest.raises(ValueError):
        vomb.ovn_mc_launch_plan(N, Km1, shape=(512, 3))
    # every shape built for N takes its production K
    for shape in vomb.MC_SHAPES[N]:
        forced = vomb.ovn_mc_launch_plan(N, Km1, shape=shape)
        assert (forced.threads, forced.ctas_per_sm) == shape
        assert forced.smem_bytes <= vomb.SMEM_LIMIT


@pytest.mark.parametrize("N,K", [(2, 2), (2, 3), (2, 12), (2, 60), (2, 65),
                                 (3, 3), (3, 9), (3, 33), (3, 60), (3, 61),
                                 (3, 65)])
def test_mc_diagonal_pieces_close_the_recursion(N, K):
    # the diagonal interior's dataflow: the pieces hold every interior cell
    # once; each cell's predecessor (a-1, b-1) is the cell before it in its
    # piece, or a state read from shared memory that an edge lane or a
    # piece writes every step; and every interior cell the edges and heads
    # read (the last row and column) is written there every step
    Km1 = K - 1
    M, P = Km1, N * (N - 1) // 2
    PB, G2 = 1 + N * M, M * M
    plan = vomb.ovn_mc_launch_plan(N, Km1)
    pieces = vomb.ovn_mc_pieces(plan, N, Km1)
    assert len(pieces) == plan.threads
    assert not any(pieces[:vomb.FIXED])

    def grid(x):
        q, g = divmod(x - PB, G2)
        return q, g // M, g % M

    interior = [PB + q * G2 + a * M + b for q in range(P)
                for a in range(1, M) for b in range(1, M)]
    held = [x for pc in pieces if pc for x in pc["cells"]]
    assert sorted(held) == sorted(interior)
    written = set()
    for pc in pieces:
        if pc is None:
            continue
        assert 1 <= len(pc["cells"]) <= plan.cells_per_thread
        written |= {pc["st_w"], pc["st_last"]}
        for p, x in enumerate(pc["cells"]):
            q, a, b = grid(x)
            pred = PB + q * G2 + (a - 1) * M + (b - 1)
            if p == 0:
                assert pc["pred0"] == pred
            elif p == pc["w"]:
                assert pc["predw"] == pred and b == 1
            else:
                assert pc["cells"][p - 1] == pred
            if b == M - 1 and p < len(pc["cells"]) - 1:
                assert pc["st_w"] == x and pc["w"] == p + 1
        assert pc["st_last"] == pc["cells"][-1]
    edge = {PB + q * G2 + e for q in range(P) for e in range(M)} | {
        PB + q * G2 + e * M for q in range(P) for e in range(M)}
    for pc in pieces:
        if pc is not None:
            for x in (pc["pred0"], pc["predw"]):
                assert x in edge or x in written
    last = {x for x in interior
            if grid(x)[1] == M - 1 or grid(x)[2] == M - 1}
    assert last <= written
    # a warp's lanes hold neighbouring diagonals of one piece index: their
    # A reads one word, their d reads consecutive words
    for w0 in range(vomb.FIXED, plan.threads, 32):
        lanes = [pc for pc in pieces[w0:w0 + 32] if pc is not None]
        runs = {}
        for pc in lanes:
            runs.setdefault((pc["q"], pc["lo"]), []).append(pc["hi"])
        for his in runs.values():
            assert his == list(range(his[0], his[0] + len(his)))


def test_mc_launch_plan_general():
    plan = vomb.ovn_mc_launch_plan(6, 7, B=256)
    assert (plan.design, plan.threads, plan.cells_per_thread,
            plan.ctas_per_sm) == ("general", 1024, 0, 1)
    assert plan.smem_bytes == vomb.ovn_mc_smem_bytes(6, 8)
    assert plan.c2_floats == 15 * 49
    with pytest.raises(ValueError):
        vomb.ovn_mc_cell_map(plan, 6, 7)
    with pytest.raises(ValueError):
        vomb.ovn_mc_launch_plan(3, 65)


MC_CELL_CASES = [(2, 2), (2, 12), (2, 60), (3, 3), (3, 9), (3, 60), (3, 65),
                 (4, 2), (4, 9), (4, 60), (5, 3), (5, 9), (5, 54)]


@pytest.mark.parametrize("N,K", MC_CELL_CASES)
def test_mc_cell_map_emission_is_the_plain_emission(N, K):
    # the kernel's per-state data (row offsets, c1 / c2 index), through the
    # staged row it writes, gives OvnMCEmission's emission bit for bit, for
    # every state, in float32
    Km1, B = K - 1, 3
    P = N * (N - 1) // 2
    plan = vomb.ovn_mc_launch_plan(N, Km1)
    cmap = vomb.ovn_mc_cell_map(plan, N, Km1)
    assert len(cmap) == plan.threads
    rng = np.random.default_rng(N * 100 + K)
    f32 = torch.float32
    es = torch.as_tensor(rng.normal(-3.0, 2.0, B), dtype=f32)
    d = torch.as_tensor(rng.normal(0.0, 3.0, (B, N, Km1)), dtype=f32)
    c1 = torch.as_tensor(rng.normal(1.0, 2.0, (N, Km1)), dtype=f32)
    c2 = torch.as_tensor(rng.normal(2.0, 2.0, (P, Km1, Km1)), dtype=f32)
    es[0] = -0.0                      # the silent state's es - 0 keeps -0
    em = trvo.mc_em_ovn(c1, c2)
    e_s, e_b, e_p = em(es, d)
    want = torch.cat([e_s[:, None], e_b.reshape(B, -1),
                      e_p.reshape(B, -1)], dim=1)
    row = vomb.ovn_mc_stage_row(es, d)
    assert row.shape == (B, vomb.ovn_mc_stage_floats(N, Km1))
    PB = 1 + N * Km1
    states, got = [], []
    for cells in cmap:
        for x, lo, hi, c in cells:
            assert 0 <= lo < row.shape[1] and 0 <= hi < row.shape[1]
            # the byte offsets fit the kernel's 16-bit halves
            assert 4 * lo < 1 << 16 and 4 * hi < 1 << 16
            s = row[:, lo] + row[:, hi] if hi else row[:, lo]
            if c is None:
                cv = torch.zeros((), dtype=f32)
            else:
                kind, idx = c
                assert kind == ("c1" if x < PB else "c2")
                if kind == "c2":
                    # an interior cell's c2 (a stride slot's offset, a
                    # piece's register) is its state's
                    assert idx == x - PB
                cv = (c1 if kind == "c1" else c2).reshape(-1)[idx]
            states.append(x)
            got.append(s - cv)
    assert sorted(states) == list(range(1 + N * Km1 + P * Km1 * Km1))
    got = torch.stack(got, dim=1)[:, torch.as_tensor(states).argsort()]
    assert got.dtype == f32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the heads and edges (and the stride interior) are kernel 3's, thread
    # by thread
    k3 = vomb.ovn_cell_map(vomb.ovn_launch_plan(N, Km1), N, Km1)
    upto = vomb.FIXED if plan.interior == "diagonal" else plan.threads
    assert [[x for x, *_ in cells] for cells in cmap[:upto]] == [
        [x for x, _ in cells] for cells in k3[:upto]]


@pytest.mark.parametrize("N,K", CELL_CASES)
def test_launch_plan(N, K):
    Km1 = K - 1
    plan = vomb.ovn_launch_plan(N, Km1)
    assert plan.design == "cells"
    assert plan.threads == (512 if N <= 4 else 1024)
    P = N * (N - 1) // 2
    S = 1 + N * Km1 + P * Km1 * Km1
    PB = 1 + N * Km1
    T = plan.threads - vomb.FIXED
    need = vomb.cells_per_thread(N, Km1, plan.threads)
    assert need * T >= vomb.interior_span(N, Km1)
    assert plan.cells_per_thread in vomb.CELL_SHAPES[N][1]
    assert need <= plan.cells_per_thread <= 64
    # the last interior load (PB + slots*T - 1 past the second buffer) stays
    # inside the dynamic shared memory
    assert S + PB + plan.cells_per_thread * T <= plan.smem_bytes // 4
    assert plan.smem_bytes <= vomb.SMEM_LIMIT
    with pytest.raises(ValueError):
        vomb.ovn_launch_plan(N, 65)


def test_launch_plan_production_shapes():
    # the main path's K = 60 runs the slot counts built for it exactly
    assert vomb.ovn_launch_plan(3, 59).cells_per_thread == 25
    assert vomb.ovn_launch_plan(4, 59).cells_per_thread == 51
    assert vomb.ovn_launch_plan(5, 53).threads == 1024
    general = vomb.ovn_launch_plan(6, 7)
    assert general.design == "general" and general.threads == 1024
    assert general.smem_bytes == vomb.ovn_smem_bytes(6, 8)
    with pytest.raises(ValueError):
        vomb.ovn_cell_map(general, 6, 7)


def _expected_candidates(tab, x):
    """The candidate sources of flat state x in ring_viterbi_ovn's
    maxplus_step order, from the plain version's tables."""
    N, M, P, PB = tab.N, tab.Km1, tab.P, tab.PB
    G2 = M * M
    src = tab.src.tolist()

    def hb(r, is_i, p):
        return (PB + r * G2 + p * M + M - 1 if is_i
                else PB + r * G2 + (M - 1) * M + p)

    def allowed(mask_row):
        return [i for i, v in enumerate(mask_row.tolist()) if v == 0]

    if x == 0:
        return [0] + src[1:]
    if x < PB:
        n, k = divmod(x - 1, M)
        if k == 0:
            return ([0] + [src[1 + m] for m in allowed(tab.mask_diag[n])]
                    + [src[1 + N + r] for r in allowed(tab.mask_inpair[n])])
        return [x - 1] + [hb(int(q), bool(i), k - 1) for q, i in
                          zip(tab.ring_q[n], tab.ring_i[n])]
    q, g = divmod(x - PB, G2)
    a, b = divmod(g, M)
    if a == 0 and b == 0:
        return ([0] + [src[1 + m] for m in allowed(tab.mask_member[q])]
                + [src[1 + N + r] for r in allowed(tab.mask_nondis[q])])
    if a == 0:
        return [1 + int(tab.pj[q]) * M + b - 1] + [
            hb(int(r), bool(i), b - 1)
            for r, i in zip(tab.row_q[q], tab.row_i[q])]
    if b == 0:
        return [1 + int(tab.pi[q]) * M + a - 1] + [
            hb(int(r), bool(i), a - 1)
            for r, i in zip(tab.col_q[q], tab.col_i[q])]
    return [x - M - 1]


@pytest.mark.parametrize("N,K", CELL_CASES)
def test_cell_map_writes_every_state_once_from_the_plain_candidates(N, K):
    Km1 = K - 1
    tab = trvo.ovn_tables(N, Km1, dtype=torch.float64, device="cpu")
    plan = vomb.ovn_launch_plan(N, Km1)
    cmap = vomb.ovn_cell_map(plan, N, Km1)
    assert len(cmap) == plan.threads
    written = [x for cells in cmap for x, _ in cells]
    assert sorted(written) == list(range(tab.S))
    for tid, cells in enumerate(cmap):
        for x, cands in cells:
            assert cands == _expected_candidates(tab, x), (tid, x)
    # the roles: heads on warp 0, edges on warps 1-2, interior after
    P = N * (N - 1) // 2
    assert [x for x, _ in sum(cmap[:1 + N + P], [])] == (
        [0] + [1 + n * Km1 for n in range(N)]
        + [tab.PB + q * Km1 * Km1 for q in range(P)])
    assert not any(cmap[1 + N + P:32])
    for tid in range(32, vomb.FIXED):
        k = tid - 32
        assert len(cmap[tid]) == (N + 2 * P if 1 <= k < Km1 else 0)
    for tid in range(vomb.FIXED, plan.threads):
        assert len(cmap[tid]) <= plan.cells_per_thread
        assert all(len(c) == 1 for _, c in cmap[tid])


def test_cell_map_topology_is_the_plain_tables():
    # the kernel's compile-time topology (its Python mirror) against the
    # tables the plain version reads
    for N in range(2, 6):
        pairs, qn, row_tab, col_tab = trvo._tables(N)
        for q, (i, j) in enumerate(pairs):
            assert vomb._pair_ij(N, q) == (i, j)
            assert vomb._pair_of(N, i, j) == q
            thirds = [vomb._third(i, j, c) for c in range(N - 2)]
            assert [(vomb._pair_of(N, min(j, m), max(j, m)), j < m)
                    for m in thirds] == row_tab[q]
            assert [(vomb._pair_of(N, min(i, m), max(i, m)), i < m)
                    for m in thirds] == col_tab[q]
        for n in range(N):
            assert [vomb._ring_src(N, n, c) for c in range(N - 1)] == qn[n]
