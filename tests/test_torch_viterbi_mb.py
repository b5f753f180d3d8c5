"""Plain versions of the two CUDA kernels (hmmspikesorter_torch/ops/
viterbi_mb.py) in float32 against the JAX package's vmapped
ring_viterbi_ov2 in float32 — which the Pallas kernels they replace
bit-match (tests/test_pallas_mb.py) — plus the wrappers' CPU routing and
the block-engine gates. The kernels themselves are held against these
plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmmspikesorter_torch.ops import viterbi_mb as vmb
from hmmspikesorter_torch.ops.ring_viterbi import ring_block_decoder
from hmmspikesorter_torch.parallel.overlap_save import resolve_block_engine
from hmmspikesorter_tpu.ops.ring_viterbi import ring_viterbi_ov2
from tests.torch_port import signal, templates

W = 128


def _windows(K, B, seed):
    ys = [signal(W, K, seed=seed * 100 + b, pp=(0.02, 0.012))[0]
          for b in range(B)]
    return np.stack(ys), templates(K), np.log([0.02, 0.012])


def _jax_f32(y_win, lp, temps, sil):
    one = jax.vmap(lambda yy, s0: ring_viterbi_ov2(
        yy, jnp.asarray(lp, jnp.float32), jnp.asarray(temps, jnp.float32),
        np.float32(0.3), silent_start=s0, with_ll=False)[0])
    return np.asarray(one(jnp.asarray(y_win, jnp.float32), jnp.asarray(sil)))


def _plain_f32(y_win, lp, temps, sil):
    c = vmb.ov2_consts(lp, temps, np.float32(0.3), dtype=torch.float32,
                       device="cpu")
    y = torch.as_tensor(y_win, dtype=torch.float32)
    flags, rings, xT = vmb.ov2_forward_mb_plain(y, torch.as_tensor(sil), c)
    return c, y, (flags, rings, xT), vmb.ov2_backtrace_mb_plain(
        flags, rings, xT, c.Km1)


@pytest.mark.parametrize("K", [12, 20])
def test_plain_kernels_f32_match_jax(K):
    y_win, temps, lp = _windows(K, 5, seed=K)
    sil = np.arange(5) == 0
    _, _, (flags, rings, xT), labels = _plain_f32(y_win, lp, temps, sil)
    assert labels.dtype == torch.int16 and labels.shape == (5, W)
    np.testing.assert_array_equal(labels.numpy(),
                                  _jax_f32(y_win, lp, temps, sil))
    # packing: t = 0 and ring slot 0 are never written
    assert not flags[:, 0].any() and not rings[:, 0].any()
    assert not rings[:, :, 0].any()
    assert flags.max() < 16 and rings.max() < 4


@pytest.mark.parametrize("mask", ["none", "all", "mixed"])
def test_silent_start_mask_per_window(mask):
    K, B = 14, 5
    y_win, temps, lp = _windows(K, B, seed=3)
    # a first sample far from every silent mean, so that the forced
    # silent start decides where each window's path begins
    y_win[:, 0] = 6.0
    sil = {"none": np.zeros(B, bool), "all": np.ones(B, bool),
           "mixed": np.array([True, False, False, True, False])}[mask]
    _, _, _, labels = _plain_f32(y_win, lp, temps, sil)
    ref = _jax_f32(y_win, lp, temps, sil)
    np.testing.assert_array_equal(labels.numpy(), ref)
    assert (ref[sil, 0] == 0).all() and (ref[~sil, 0] != 0).all()


def test_xT_is_argmax_of_final_flat_state():
    K, B = 12, 4
    y_win, temps, lp = _windows(K, B, seed=9)
    sil = np.arange(B) == 0
    c, y, (_, _, xT), labels = _plain_f32(y_win, lp, temps, sil)
    v = vmb._ov2_init(y[:, 0], torch.as_tensor(sil), c)
    for t in range(1, W):
        v = vmb._ov2_step(v, y[:, t], c)
    assert v.shape == (B, c.S)
    assert torch.equal(xT, torch.argmax(v, dim=1).to(torch.int32))
    assert torch.equal(labels[:, -1].to(torch.int32), xT)
    np.testing.assert_array_equal(
        xT.numpy(), _jax_f32(y_win, lp, temps, sil)[:, -1])


def test_wrappers_route_cpu_tensors_to_plain():
    K, B = 12, 3
    y_win, temps, lp = _windows(K, B, seed=4)
    sil = np.arange(B) == 0
    c, y, plain, labels = _plain_f32(y_win, lp, temps, sil)
    n_fwd = vmb.ov2_forward_mb.launches
    n_bt = vmb.ov2_backtrace_mb.launches
    got = vmb.ov2_forward_mb(y, torch.as_tensor(sil), c)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert torch.equal(vmb.ov2_backtrace_mb(*got, c.Km1), labels)
    assert torch.equal(vmb.ov2_decode_mb(y, torch.as_tensor(sil), c), labels)
    assert vmb.ov2_forward_mb.launches == n_fwd
    assert vmb.ov2_backtrace_mb.launches == n_bt


def test_float64_plain_matches_jax_float64():
    K, B = 16, 3
    y_win, temps, lp = _windows(K, B, seed=6)
    sil = np.arange(B) == 0
    c = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float64, device="cpu")
    labels = vmb.ov2_decode_mb_plain(torch.as_tensor(y_win),
                                     torch.as_tensor(sil), c)
    one = jax.vmap(lambda yy, s0: ring_viterbi_ov2(
        yy, jnp.asarray(lp), jnp.asarray(temps), 0.3, silent_start=s0,
        with_ll=False)[0])
    ref = np.asarray(one(jnp.asarray(y_win), jnp.asarray(sil)))
    np.testing.assert_array_equal(labels.numpy(), ref)


def test_block_engine_gates_on_cpu():
    assert resolve_block_engine("auto", True, 60, 2, "cpu") == "ring"
    assert resolve_block_engine("ring", True, 60, 2, "cpu") == "ring"
    with pytest.raises(ValueError):
        resolve_block_engine("cuda", True, 60, 2, "cpu")
    with pytest.raises(ValueError):
        resolve_block_engine("pallas", True, 60, 2, "cpu")
    # N >= 3: the general-N kernels need a CUDA device; "auto" takes the
    # plain engine on the CPU, an explicit "cuda_ovn" raises
    assert resolve_block_engine("auto", True, 12, 3, "cpu") == "ring"
    assert resolve_block_engine("auto", True, 60, 4, "cpu") == "ring"
    for n in (2, 3, 4):
        with pytest.raises(ValueError):
            resolve_block_engine("cuda_ovn", True, 60, n, "cpu")
    with pytest.raises(ValueError):
        resolve_block_engine("cuda", True, 60, 3, "cpu")
    with pytest.raises(ValueError):
        resolve_block_engine("cuda_ovn", False, 60, 3, "cpu")
    with pytest.raises(ValueError):
        ring_block_decoder(np.log([0.01, 0.01]), templates(12), 0.3,
                           overlaps=True, block_engine="cuda", device="cpu",
                           dtype=torch.float32)
    with pytest.raises(ValueError):
        ring_block_decoder(np.log([0.01, 0.01, 0.01]), templates(12, 3), 0.3,
                           overlaps=True, block_engine="cuda_ovn",
                           device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError):
        ring_block_decoder(np.log([0.01, 0.01, 0.01]), templates(12, 3), 0.3,
                           overlaps=True, block_engine="cuda", device="cpu",
                           dtype=torch.float32)


def test_per_window_parameters_not_ported_yet():
    """Per-window parameters are kernel 16's (the drift-tracked decode);
    ov2_consts takes them with one row per window and refuses mixed
    shapes."""
    with pytest.raises(ValueError, match="B, K, 2"):
        vmb.ov2_consts(np.log(np.full((3, 2), 0.01)), templates(12), 0.3,
                       dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="per-window"):
        vmb.ov2_consts(np.log(np.full((3, 2), 0.01)),
                       np.stack([templates(12)] * 3), np.full(2, 0.3),
                       dtype=torch.float32, device="cpu")
    c = vmb.ov2_consts(np.log(np.full((3, 2), 0.01)),
                       np.stack([templates(12)] * 3), np.full(3, 0.3),
                       dtype=torch.float32, device="cpu")
    assert c.per_window and c.means.shape == (3, c.S)
    assert c.pack().shape == (3, 6)


def _drifting_params(K, B, seed):
    """Per-window (lp (B, 2), mu (B, K, 2), sigma (B,)): the templates
    scaled by a per-window gain, the rates and noise jittered."""
    rng = np.random.default_rng(seed)
    gain = np.linspace(1.0, 1.8, B)
    mu = np.stack([templates(K) * g for g in gain])
    lp = np.log(np.array([0.02, 0.012]) * rng.uniform(0.7, 1.3, (B, 2)))
    return lp, mu, 0.3 * rng.uniform(0.9, 1.1, B)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_per_window_plain_matches_vmapped_jax(dtype):
    """The plain version of kernel 16 (per-window constants) gives the
    labels of the JAX package's vmapped ring_viterbi_ov2 under the same
    per-window parameters (tests/test_pallas_mb.py's reference for the
    per-lane kernel), bit for bit."""
    K, B = 14, 5
    y_win, _, _ = _windows(K, B, seed=11)
    lp, mu, sg = _drifting_params(K, B, seed=2)
    y_win = y_win * np.linspace(1.0, 1.8, B)[:, None]
    sil = np.arange(B) == 0
    c = vmb.ov2_consts(lp, mu, sg, dtype=dtype, device="cpu")
    labels = vmb.ov2_decode_mb_plain(torch.as_tensor(y_win).to(dtype),
                                     torch.as_tensor(sil), c)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    one = jax.vmap(lambda yy, s0, l_, m_, s_: ring_viterbi_ov2(
        yy, l_, m_, s_, silent_start=s0, with_ll=False)[0])
    ref = np.asarray(one(jnp.asarray(y_win, jd), jnp.asarray(sil),
                         jnp.asarray(lp, jd), jnp.asarray(mu, jd),
                         jnp.asarray(sg, jd)))
    np.testing.assert_array_equal(labels.numpy(), ref)
    assert (labels.numpy() >= 1 + 2 * (K - 1)).any()     # pair states seen


def test_per_window_constant_rows_equal_shared():
    """Kernel 16's plain version with every row the same model is kernel
    1's plain version bit for bit: the packed choices, xT and the labels;
    and the wrappers route per-window constants on the CPU to the plain
    version without counting a launch."""
    K, B = 12, 4
    y_win, temps, lp = _windows(K, B, seed=5)
    sil = torch.as_tensor(np.arange(B) == 0)
    y = torch.as_tensor(y_win, dtype=torch.float32)
    c1 = vmb.ov2_consts(lp, temps, 0.3, dtype=torch.float32, device="cpu")
    cB = vmb.ov2_consts(np.tile(lp, (B, 1)), np.stack([temps] * B),
                        np.full(B, 0.3), dtype=torch.float32, device="cpu")
    assert torch.equal(cB.pack(), c1.pack()[None].expand(B, 6))
    assert torch.equal(cB.means, c1.means[None].expand(B, -1))
    shared = vmb.ov2_forward_mb_plain(y, sil, c1)
    n16 = vmb.ov2_forward_mb_tracked.launches
    n1 = vmb.ov2_forward_mb.launches
    for got in (vmb.ov2_forward_mb_plain(y, sil, cB),
                vmb.ov2_forward_mb(y, sil, cB),
                vmb.ov2_forward_mb_tracked(y, sil, cB)):
        for a, b in zip(got, shared):
            assert torch.equal(a, b)
    assert torch.equal(vmb.ov2_decode_mb(y, sil, cB),
                       vmb.ov2_decode_mb_plain(y, sil, c1))
    assert vmb.ov2_forward_mb_tracked.launches == n16
    assert vmb.ov2_forward_mb.launches == n1


def _pair_coords(i, Km1):
    """(a, q) of pair state i: k1 = a + 1, k2 = q + 1."""
    p = i - (1 + 2 * Km1)
    return p // Km1, p % Km1


@pytest.mark.parametrize("shape", [(512, 1), (512, 2)])
@pytest.mark.parametrize("K", [2, 3, 33, 34, 35, 60, 65])
def test_cell_map_owns_every_state_once(K, shape):
    """Kernel 1's cell map: every state index is written by exactly one
    thread each step; every interior pair cell (a >= 1, q >= 1) reads
    i - K, the cell (a - 1, q - 1); the irregular items read what the plain
    transition reads."""
    Km1 = K - 1
    S = 1 + 2 * Km1 + Km1 * Km1
    P = 1 + 2 * Km1
    plan = vmb.ov2_launch_plan(1, Km1, 132, shape)
    owned = [i for cells in vmb.ov2_cell_map(plan, Km1) for i, _ in cells]
    assert sorted(owned) == list(range(S))
    n_irr = 32 * plan.irregular_warps
    for tid, cells in enumerate(vmb.ov2_cell_map(plan, Km1)):
        for i, src in cells:
            if i >= P:
                a, q = _pair_coords(i, Km1)
                if a >= 1 and q >= 1:
                    assert tid >= n_irr and src == [i - Km1 - 1]
                    assert _pair_coords(src[0], Km1) == (a - 1, q - 1)
                    continue
                assert tid < n_irr
                # injections: (0, q) from v1[q-1], (a, 0) from v0[a-1]
                assert src == ([0] if a == q == 0 else
                               [Km1 + q] if a == 0 else [a])
            elif i == 0:
                assert src == [0, Km1, 2 * Km1, S - 1]
            else:
                assert tid < n_irr
                n, k = divmod(i - 1, Km1)
                if k == 0:                      # onset: silent, other's end
                    assert src == [0, (2 - n) * Km1]
                else:                           # ring: same ring, pair exit
                    exit_ = (P + (k - 1) * Km1 + Km1 - 1 if n == 0
                             else P + (Km1 - 1) * Km1 + k - 1)
                    assert src == [1 + n * Km1 + k - 1, exit_]
    # thread 0 takes the silent item, thread k ring slot k; interior
    # threads at most cells_per_thread cells
    cmap = vmb.ov2_cell_map(plan, Km1)
    assert [i for i, _ in cmap[0]] == [0, 1, 1 + Km1, P]
    assert all(cmap[k][0][0] == 1 + k for k in range(1, Km1))
    assert all(len(c) <= plan.cells_per_thread for c in cmap[n_irr:])


@pytest.mark.parametrize("B,ctas", [(1, 1), (64, 1), (132, 1), (133, 2),
                                    (256, 2)])
def test_launch_plan_from_grid(B, ctas):
    """One CTA of 512 threads per window: alone on its SM while every
    window has an SM of its own, two to an SM once windows outnumber SMs;
    at every K <= 65 the cells per thread are the fewest that cover the
    interior, within the kernel's instantiations (at most 9), and the
    shared memory of the CTAs on an SM fits the 227 KB a block can use."""
    for Km1 in range(1, vmb.KP + 1):
        plan = vmb.ov2_launch_plan(B, Km1, 132)
        assert (plan.threads, plan.ctas_per_sm) == (512, ctas)
        assert plan.windows_per_cta == 1
        assert plan.irregular_warps == -(-Km1 // 32)
        ni = plan.threads - 32 * plan.irregular_warps
        n_int = (Km1 - 1) ** 2
        assert plan.cells_per_thread * ni >= n_int
        assert plan.cells_per_thread == 1 or (
            (plan.cells_per_thread - 1) * ni < n_int)
        assert plan.cells_per_thread <= 9
        assert plan.smem_bytes % 16 == 0
        assert plan.ctas_per_sm * plan.smem_bytes <= 232448
    with pytest.raises(ValueError):
        vmb.ov2_launch_plan(B, vmb.KP + 1, 132)
    with pytest.raises(ValueError):
        vmb.ov2_launch_plan(B, 59, 132, (1024, 1))
