#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hmmspikesorter_torch) on one NVIDIA
GPU: builds the kernels from this checkout, holds each against its plain
PyTorch version, drives the decode paths end to end and checks their
output.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line:
  platform     torch and CUDA versions, the card (nvidia-smi)
  build        nvcc of hmmspikesorter_torch/csrc/*.cu (kernels 1-15), all
               sources at once
  kernels      at the N=2 main path's shapes (B=256 windows of W=8672,
               K=60, float32): kernel 1 vs ov2_forward_mb_plain (flags,
               rings, xT exactly equal), kernel 2 vs ov2_backtrace_mb_plain
               (labels exactly equal); CUDA-event times and the card's bound
  kernels_ovn  kernels 3-4 vs ovn_forward_mb_plain / ovn_backtrace_mb_plain
               (flags, rings, rowcol, xT and labels exactly equal) at the
               N=3 main path's shapes (B=128 windows of W=8704, K=60) and
               at N=4, K=60 (32 windows of W=8704); times and bounds
  reference    small decodes through the kernels (N=2, N=3, N=4 at K=60)
               vs the generic gather Viterbi (core/viterbi.py) in float64
  main_path    api.fit_spiking_model_fast on the bench.py problem (N=2,
               K=60, overlaps on, S=3600, T=2^21, L=8192, default H),
               one-shot and streaming, each with the launch counts set to
               0 just before and read just after; labels vs the float64
               plain-twin decode on the card; onset counts vs the
               generator's truth
  main_path_n3 the same at the repository's N=3 configuration
               (BASELINE.json config 2, benchmarks/suite.py config2: K=60,
               S=10,621, sigma=0.3, pp=(0.003, 0.002, 0.001), T=2^20,
               L=8192, H=256, seed 1234), through kernels 3-4
  kernels_em   kernels 5-6 (the EM E-step) vs em_forward_mb_plain /
               em_backward_mb_plain at both training shapes (B=256 windows
               of W=2528, K=60): N=2 on the first 2^19 samples of the
               bench.py signal with its templates, N=7 with
               init_templates(60, 7, std(y), default_rng(1)); checkpoints
               and la exactly equal, the summed statistics within 1e-5
               relative; times and bounds
  reference_em one EM step through kernels 5-6 (float32) vs
               em_step(fb_mode="gather") in float64 on the card (N=2,
               K=16, T=6000, L=1024, H=64), at tests/test_pallas_fb.py's
               tolerances
  train_em     bench.py's EM problem (N=2, K=60, T=2^19, L=2048, 10
               iterations): em_chain(fb_mode="overlap_cuda") after one
               warm-up, iterations/s, launch counts (10 each), the first
               iteration vs one float64 step of the plain overlap engine
               (the ll within 3x the error of the plain float32 overlap
               engine in the same run, at least 1e-5, at most
               f32_ll_rtol: the float32 recursion's own rounding at 256
               windows), ll non-decreasing
  train_path   api.fit_template_model(y[:2^19], 7, 60, nsteps=10) through
               kernels 5-6 (10 + 5 EM iterations), then decode with the
               learned templates and overlaps on through kernels 1-2:
               exactly 2 templates, each within 1% of a generator
               template's energy, onset counts within 2% of the truth
  kernels_gamma  kernels 7-10 (the chained onset posteriors) vs their plain
               versions at bench.py's posterior shapes (T=2^19 of the
               bench.py signal, L=4096, B=128, K=60): kernels 9-10 (N=2
               overlaps, S=3600) on the first 32 windows, kernels 7-8
               (non-overlap, N=2 and N=7 with the kernels_em templates) on
               all 128; checkpoints, first-position betas and posteriors
               exactly equal; times and bounds of the forward, the chaining
               sweep and the gamma pass
  posterior_bench  bench.py's posterior problem (bench.py:216-241):
               core/posterior.onset_posteriors_chained on the N=2 overlap
               model, T=2^19, float32, after one warm-up (kernels 9-10);
               samples/s; within 1e-4 of the float64 plain chained run on
               the card; beside it the float32 plain chained engines' error
               on the same input (the float32 floor of a 4096-step window);
               expected onset counts within 1e-3 of main_path's decoded
               counts
  posterior_path  the --confidence --qc composition on main_path's decoded
               model (T=2^21, 512 windows): model_posteriors,
               confidence_from_posteriors, core/qc.unit_qc(posteriors=p),
               qc_arrays; launches of kernels 9-10 exactly 2 + 2, median
               confidence above 0.9, isi_invariant_violations 0
  posterior_path_nov  the same for a non-overlap N=2 decode of the same
               signal, through kernels 7-8
  kernels_mc   the multichannel configuration (BASELINE.json config 6,
               benchmarks/suite.py config6: N=3, C=4, K=60, S=10,621,
               T=2^19, per-channel gains 0.3 + U, sigma_c = 0.25 + 0.1 U,
               pp=(0.01, 0.005, 0.008)): kernel 11 vs ovn_mc_forward_mb_plain
               on the streams of its decode windows (B=64 of W=8704, L=8192,
               H=256; the plain version on the first 16) at N=3 and at N=2
               (the first two templates; B=256 windows of L=2048, H=256),
               and kernel 4 on kernel 11's output vs its plain version:
               exactly equal; times, bounds and the channel projection's
               time
  main_path_mc models/multichannel.fit_spiking_model_mc_fast on config 6,
               one-shot and streaming (16 windows a call), launches of
               kernels 11 and 4 counted in each run; labels vs the float64
               plain twin, ll, onset counts vs the generator's truth
  kernels_em_mc  kernels 12-13 vs em_forward_mb_mc_plain /
               em_backward_mb_mc_plain at config 6's training shapes (B=256
               windows of W=2528, S=178, C=4): checkpoints and la exactly
               equal, the summed statistics within 1e-5 relative
  train_em_mc  5 chained em_chain_mc(fb_mode="overlap_cuda") iterations on
               config 6 from its templates after one warm-up: iterations/s,
               launches 5 + 5, the first iteration vs one float64 step of the
               plain overlap engine (train_em's tolerances), ll non-decreasing
               up to the float32 ll's rounding (train_em's ll bound)
  train_path_mc  train/em_mc.train_model_mc(yc, 3, 60, nsteps=10) from random
               templates (default_rng(1)), then the overlap decode with the
               learned model through kernels 11 and 4: per-channel sigma
               within 2% of the generator's, ll non-decreasing in each EM
               phase (the same bound), each learned template within 1% of a
               generator template's energy
  kernels_gamma_mc  kernels 14-15 (the multichannel chained onset
               posteriors, reading the emission stream) vs
               gamma_fwd_mb_mc_plain / gamma_bwd_mb_mc_plain at config 6 with
               overlaps off (S=178, T=2^19, B=128 windows of L=4096; the
               plain versions on the first 16): checkpoints, first-position
               betas and posteriors exactly equal; times and bounds
  posterior_bench_mc  core/posterior.onset_posteriors_chained_mc on config 6
               with overlaps off, T=2^19, float32, after one warm-up
               (kernels 14-15, launches 2 + 2); samples/s; within 1e-4 of
               the float64 plain chained run on the card, or of the float32
               plain engines' own error where that is larger (at most 1e-3);
               expected onset counts within 1e-3 of a non-overlap decode's
  posterior_path_mc  the --confidence --qc composition (posterior_path's) on
               that non-overlap multichannel decode, through kernels 14-15
  cli_path     the CLI's body on arrays (cli._sort_loaded, everything after
               the HDF5 loaders; the MAT file written with scipy.io.savemat
               under build/cli_path/ and read back): --engine fast
               --confidence --qc on bench.py's problem at T=2^21 (kernels 1-2,
               9-10; labels equal main_path's); a 4-window recording whose
               seams find no common silence (seams repaired, labels equal
               the float64 plain twin's); --multichannel --engine fast
               --confidence --qc on config 6 with overlaps on at T=2^14
               (kernels 11 + 4, then the plain chained ovn MC posteriors at
               S=10,621; labels equal the library decode's; the float32
               posteriors' error against a float64 run on the card)
About 8-12 minutes on an H100.
Then one {"kernels": [...]} line, the nvidia-smi name/power-limit line and,
last, {"ok": true, "device": {...}}. Any failed check raises: the script
then exits non-zero and prints no result. Without CUDA it exits 1 first.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# exp, log and log1p issue on the special function units: 16 a clock on
# each SM against 256 float32 operations (128 FMA lanes), a sixteenth of
# the float32 rate (NVIDIA's table of arithmetic instruction throughput
# for compute capability 9.0)
SFU_OPS_PER_S = FP32_OPS_PER_S / 16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# template shapes of BASELINE.json config 2 (benchmarks/suite.py's first
# three) and the fourth of that list for N=4
OVN_SHAPES = ((3.0, 0.8, 0.2), (4.0, 0.3, 0.2), (2.5, 0.6, 0.3),
              (2.0, 0.5, 0.25))


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def max_abs_err(pairs):
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def fwd_ops(B, W, Km1):
    """f32 operations of the forward at these shapes: per window step ~5
    per pair cell (4 for the emission, 1 add), 7 per ring slot, ~35 for the
    silent state and the two onsets, 2 per row/column injection; plus the
    init emission and the final argmax."""
    S = 1 + 2 * Km1 + Km1 * Km1
    per_step = 5 * Km1 * Km1 + 2 * Km1 + 14 * (Km1 - 1) + 35
    return B * ((W - 1) * per_step + 5 * S)


def ovn_fwd_ops(B, W, N, Km1, streams=False):
    """f32 operations of the general-N forward at these shapes: per window
    step 4 per state for the emission (the means are per window, not per
    step) and 1 to add it; per candidate the adds of its transition
    weight (1, or 2 where an onset log-prob joins) and one compare per
    candidate past the first; plus the init emission and the argmax.
    streams: kernel 11's emission from the streams instead, 0 operations
    for the silent state, 2 for a single (es + d - c1) and 3 for a pair
    cell, plus the add."""
    P = N * (N - 1) // 2
    S = 1 + N * Km1 + P * Km1 * Km1
    disjoint = (N - 2) * (N - 3) // 2            # pairs disjoint from a pair

    def cands(n_cells, n_cand, adds):
        return n_cells * (n_cand * adds + n_cand - 1)

    emission = (1 + 3 * N * Km1 + 4 * P * Km1 * Km1) if streams else 5 * S
    per_step = (emission
                + cands(1, 1 + N + P, 1)                          # silent
                + cands(N, 1 + (N - 1) + (P - (N - 1)), 2)        # onsets
                + cands(N * (Km1 - 1), N, 1)                      # ring slots
                + cands(P, 1 + (N - 2) + disjoint, 2)             # corners
                + cands(2 * P * (Km1 - 1), N - 1, 2)              # rows, cols
                + P * (Km1 - 1) ** 2)                             # diagonal
    return B * ((W - 1) * per_step + 6 * S)


def ovn_bt_bytes(labels, xT, Km1, N):
    """Bytes kernel 4 must move for these labels: one choice byte per step
    t >= 1 unless the state at t is inside a pair grid (its predecessor is
    the diagonal cell, no choice read), the xT words in, the int16 labels
    out."""
    lab = labels[:, 1:].long()
    PB = 1 + N * Km1
    g = (lab - PB).clamp(min=0) % (Km1 * Km1)
    interior = (lab >= PB) & (g >= Km1) & (g % Km1 != 0)
    return int((~interior).sum()) + xT.numel() * 4 + labels.numel() * 2


def em_fwd_ops(B, W, N, S, la_steps=None, emit=4):
    """(f32, transcendental) operations of kernel 5 at these shapes. A step
    t >= 1: each state's emission (4) and its add (1), the ring shift's
    add; the silent state's logsumexp over the N ring ends (N exp, 1 log)
    and logaddexp (exp, log1p); each onset slot's logsumexp over the other
    N-1 ends and logaddexp (N > 1). Step 0 is the emission. The logsumexp
    over the S states (S exp, 1 log; max, subtract and add per state) is
    counted at `la_steps` steps of a window: all W for the kernel's
    interface, 2 for what the telescoped ll reads of `la`. Kernel 12 reads
    its emissions (emit=0)."""
    la_steps = W if la_steps is None else la_steps
    onset = N * (N + 2) if N > 1 else 0
    sfu = (W - 1) * ((N + 3) + onset) + la_steps * (S + 1)
    f32 = ((W - 1) * ((emit + 1) * S + N * (3 * N + 8) + 10) + emit * S
           + la_steps * 3 * S)
    return B * f32, B * sfu


def em_bwd_ops(B, W, N, S, emit=4, moments=6):
    """(f32, transcendental) operations of kernel 6: the remat repeats
    kernel 5's alpha steps (without its logsumexp); a beta step costs the
    silent state's logsumexp over the N onsets and logaddexp, each ring
    end's logsumexp over the other onsets and logaddexp (N > 1), the block
    logsumexp of alpha + beta (S exp, 1 log), gamma (S exp) and the N xi
    terms (N exp); plus adds, the masks and the three moment updates
    (about 14 f32 operations per state). Kernels 12-13 read their
    emissions (emit=0) and update 1 + 5C moments (moments) a state."""
    onset = N * (N + 2) if N > 1 else 0
    remat_sfu = (W - 1) * ((N + 3) + onset)
    walk_sfu = W * ((N + 3) + onset + 2 * S + 1 + N)
    f32 = ((W - 1) * ((emit + 1) * S + N * (3 * N + 8))
           + W * ((4 + emit + moments) * S + N * (3 * N + 10)))
    return B * f32, B * (remat_sfu + walk_sfu)


def ops_ms(f32, sfu):
    """The least time for these operations: float32 and transcendentals run
    on different units, so the slower of the two."""
    return max(f32 / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S) * 1e3


def em_kernels(fb_mb, y_win, bounds, c, fwd_reps, bwd_reps, yc_win=None):
    """Kernels 5-6 vs their plain versions on (y_win, bounds): checkpoints
    and la exactly equal, the per-window partials and their sums over the
    windows compared (sums within 1e-5 relative), CUDA-event times and the
    bounds, as one row of the kernels_em line. With yc_win (B, W, C),
    kernels 12-13 instead, y_win then the (B, W, S) stream emission
    windows."""
    B, W = y_win.shape[:2]
    ch = fb_mb.em_chunk(c.S)
    mc = yc_win is not None
    names = ("12", "13") if mc else ("5", "6")
    if mc:
        fwd_k, fwd_p = fb_mb.em_forward_mb_mc, fb_mb.em_forward_mb_mc_plain
        bwd_k = lambda cp_: fb_mb.em_backward_mb_mc(             # noqa
            y_win, yc_win, cp_, bounds, c, ch)
        bwd_p = lambda cp_: fb_mb.em_backward_mb_mc_plain(       # noqa
            y_win, yc_win, cp_, bounds, c, ch)
    else:
        fwd_k, fwd_p = fb_mb.em_forward_mb, fb_mb.em_forward_mb_plain
        bwd_k = lambda cp_: fb_mb.em_backward_mb(                # noqa
            y_win, cp_, bounds, c, ch)
        bwd_p = lambda cp_: fb_mb.em_backward_mb_plain(          # noqa
            y_win, cp_, bounds, c, ch)
    fwd = lambda: fwd_k(y_win, c, ch)                         # noqa: E731
    fwd()                                                     # warm-up
    fwd_ms, (cp, la) = cuda_ms(fwd, reps=fwd_reps)
    fwd_plain_ms, (pcp, pla) = cuda_ms(lambda: fwd_p(y_win, c, ch), reps=1)
    fwd_err = max_abs_err([(cp, pcp), (la, pla)])
    check(torch.equal(cp, pcp) and torch.equal(la, pla),
          f"kernel {names[0]} differs from its plain version at N={c.N}")
    bwd = lambda: bwd_k(pcp)                                  # noqa: E731
    bwd()
    bwd_ms, got = cuda_ms(bwd, reps=bwd_reps)
    bwd_plain_ms, ref = cuda_ms(lambda: bwd_p(pcp), reps=1)
    bwd_err = max_abs_err(list(zip(got, ref)))
    # the statistics as the wrapper hands them on: summed over windows,
    # window 0's beta, and the telescoped ll from la
    def rel(a, b):
        a, b = a.double(), b.double()
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    names = ("G1", "Gy", "Gy2", "X", "Xd")
    sums_rel = {n: rel(a.sum(0), b.sum(0)) for n, a, b in zip(names, got, ref)}
    sums_rel["beta0"] = rel(got[5][0], ref[5][0])
    lo, hi = bounds[:, 0].long(), bounds[:, 1].long()
    (ek, pk), (ep, pp_) = (fb_mb._edge_reads(x, lo, hi) for x in (la, pla))
    sums_rel["ll"] = rel(ek[0] + (ek[1:] - pk[1:]).sum(),
                         ep[0] + (ep[1:] - pp_[1:]).sum())
    check(max(sums_rel.values()) <= 1e-5,
          f"kernel {names[1]} differs from its plain version at N={c.N}: "
          f"{sums_rel}")
    fwd_bytes = (y_win.numel() * 4 + c.fpack.numel() * 4 + cp.numel() * 4
                 + la.numel() * 4)
    bwd_bytes = (y_win.numel() * 4 + cp.numel() * 4 + bounds.numel() * 4
                 + c.fpack.numel() * 4 + sum(g.numel() * 4 for g in got)
                 + (yc_win.numel() * 4 if mc else 0))
    emit_ops = 0 if mc else 4
    moments = 1 + 5 * yc_win.shape[2] if mc else 6
    f_f32, f_sfu = em_fwd_ops(B, W, c.N, c.S, emit=emit_ops)
    # what the ll consumes of la: two steps a window, two floats out
    r_f32, r_sfu = em_fwd_ops(B, W, c.N, c.S, la_steps=2, emit=emit_ops)
    r_bytes = fwd_bytes - (la.numel() - 2 * B) * 4
    b_f32, b_sfu = em_bwd_ops(B, W, c.N, c.S, emit=emit_ops,
                              moments=moments)
    return {"N": c.N, "K": c.Km1 + 1, "S": c.S, "B": B, "W": W, "ch": ch,
            "forward": {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                        "f32_ops": f_f32, "sfu_ops": f_sfu,
                        "bound_ops_ms": ops_ms(f_f32, f_sfu),
                        "bound_bytes_ms": fwd_bytes / HBM_BYTES_PER_S * 1e3,
                        "bound_ll_reads_ms": max(
                            ops_ms(r_f32, r_sfu),
                            r_bytes / HBM_BYTES_PER_S * 1e3),
                        "max_abs_err": fwd_err, "match": True},
            "backward": {"ms": bwd_ms, "plain_ms": bwd_plain_ms,
                         "f32_ops": b_f32, "sfu_ops": b_sfu,
                         "bound_ops_ms": ops_ms(b_f32, b_sfu),
                         "bound_bytes_ms": bwd_bytes / HBM_BYTES_PER_S * 1e3,
                         "max_abs_err": bwd_err,
                         "partials_bit_equal": all(
                             torch.equal(a, b) for a, b in zip(got, ref)),
                         "sums_rel_err": sums_rel, "match": True}}


def bound_of(row):
    """(bound_ms, bound_by) of one kernel row."""
    ops, byt = row["bound_ops_ms"], row["bound_bytes_ms"]
    return max(ops, byt), ("operations" if ops >= byt else "bytes")


def f32_ll_rtol(L, H):
    """Upper reading of a float32 telescoped ll's relative error against
    float64 (the cap of train_em's ll gate): the larger of
    tests/test_pallas_fb.py's 1e-5 and the worst case of the unnormalised
    float32 log-alpha recursion. In a window of W = L + 2H
    steps |la| grows to about W |l| (l the per-sample ll), each of the W
    adds rounds by up to half an ulp of it, so a window's endc - pre is off
    by up to W^2 |l| 2^-24, and the B windows' sum, relative to
    |ll| = B L |l|, by W^2 / L 2^-24: 7.6e-5 at L=1024, H=64 and 1.9e-4 at
    L=2048, H=240."""
    W = L + 2 * H
    return max(1e-5, W * W / L * 2.0 ** -24)


def em_update_close(got, ref, what, ll_rtol=1e-5):
    """tests/test_pallas_fb.py's tolerances for one EM update (lp, pi, mu,
    sigma, ll): lp/mu/sigma rtol 2e-4 atol 1e-5, ll `ll_rtol` relative
    (1e-5 there), pi 1e-3 where the reference is above -50. Returns the
    worst errors."""
    errs = {}
    for name, a, b in zip(("lp", "pi", "mu", "sigma", "ll"), got, ref):
        a = a.double().cpu().numpy()
        b = b.double().cpu().numpy()
        if name == "ll":
            errs[name] = float(abs(a - b) / abs(b))
            ok = errs[name] <= ll_rtol
        elif name == "pi":
            m = b > -50
            errs[name] = float(np.abs(a[m] - b[m]).max())
            ok = np.allclose(a[m], b[m], rtol=1e-3, atol=1e-3)
        else:
            errs[name] = float(np.abs(a - b).max())
            ok = np.allclose(a, b, rtol=2e-4, atol=1e-5)
        check(ok, f"{what}: {name} outside tolerance ({errs[name]})")
    return errs


def force_overlaps(y, temps, every):
    """Add, every `every` samples, spikes of two neurons (cycling through
    the pairs) starting 7 samples apart: the generator plays one template
    at a time, and the overlap states need overlapping spikes."""
    K, N = temps.shape
    pairs = [(i, j) for i in range(N - 1) for j in range(i + 1, N)]
    for s, t in enumerate(range(every, len(y) - K - 8, every)):
        i, j = pairs[s % len(pairs)]
        y[t:t + K - 1] += temps[1:, i]
        y[t + 7:t + 7 + K - 1] += temps[1:, j]


def ovn_kernels(vomb, y_win, sil, c, fwd_reps, bt_reps):
    """Kernels 3-4 vs their plain versions on (y_win, sil): exact
    equality of every packed output and of the labels, CUDA-event times
    and the bounds, as one row of the kernels_ovn line."""
    B, W = y_win.shape
    fwd = lambda: vomb.ovn_forward_mb(y_win, sil, c)         # noqa: E731
    fwd()                                                     # warm-up
    fwd_ms, got = cuda_ms(fwd, reps=fwd_reps)
    fwd_plain_ms, plain = cuda_ms(
        lambda: vomb.ovn_forward_mb_plain(y_win, sil, c), reps=1)
    fwd_err = max_abs_err(list(zip(got, plain)))
    check(all(torch.equal(a, b) for a, b in zip(got, plain)),
          f"kernel 3 differs from its plain version at N={c.N}")
    del got
    bt = lambda: vomb.ovn_backtrace_mb(*plain, c)             # noqa: E731
    bt()
    bt_ms, labels = cuda_ms(bt, reps=bt_reps)
    bt_plain_ms, plain_labels = cuda_ms(
        lambda: vomb.ovn_backtrace_mb_plain(*plain, c), reps=1)
    bt_err = max_abs_err([(labels, plain_labels)])
    check(torch.equal(labels, plain_labels.to(torch.int16)),
          f"kernel 4 differs from its plain version at N={c.N}")
    flags, rings, rowcol, xT = plain
    fwd_bytes = (y_win.numel() * 4 + B + c.fpack.numel() * 4
                 + c.ipack.numel() * 4 + flags.numel() + rings.numel()
                 + rowcol.numel() + B * 4)
    return {"N": c.N, "B": B, "W": W, "K": c.Km1 + 1, "S": c.S,
            "forward": {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                        "bound_ops_ms": ovn_fwd_ops(B, W, c.N, c.Km1)
                        / FP32_OPS_PER_S * 1e3,
                        "bound_bytes_ms": fwd_bytes / HBM_BYTES_PER_S * 1e3,
                        "max_abs_err": fwd_err, "match": True},
            "backtrace": {"ms": bt_ms, "plain_ms": bt_plain_ms,
                          "bound_bytes_ms": ovn_bt_bytes(labels, xT, c.Km1,
                                                         c.N)
                          / HBM_BYTES_PER_S * 1e3,
                          "max_abs_err": bt_err, "match": True}}


def ovn_mc_kernels(vomb, es_win, d_win, sil, c, fwd_reps, bt_reps, P):
    """Kernel 11 vs its plain version on the first P windows of (es_win,
    d_win, sil), and kernel 4 on kernel 11's output vs its plain version
    there: exact equality of every packed output and label; CUDA-event
    times of the kernels on all windows and of the plain versions on P."""
    B, W = es_win.shape
    fwd = lambda: vomb.ovn_mc_forward_mb(es_win, d_win, sil, c)  # noqa
    fwd()                                                     # warm-up
    fwd_ms, got = cuda_ms(fwd, reps=fwd_reps)
    fwd_plain_ms, plain = cuda_ms(lambda: vomb.ovn_mc_forward_mb_plain(
        es_win[:P], d_win[:P], sil[:P], c), reps=1)
    fwd_err = max_abs_err([(a[:P], b) for a, b in zip(got, plain)])
    check(all(torch.equal(a[:P], b) for a, b in zip(got, plain)),
          f"kernel 11 differs from its plain version at N={c.N}")
    bt = lambda: vomb.ovn_backtrace_mb(*got, c)               # noqa: E731
    bt()
    bt_ms, labels = cuda_ms(bt, reps=bt_reps)
    bt_plain_ms, plain_labels = cuda_ms(
        lambda: vomb.ovn_backtrace_mb_plain(*plain, c), reps=1)
    bt_err = max_abs_err([(labels[:P], plain_labels)])
    check(torch.equal(labels[:P], plain_labels.to(torch.int16)),
          f"kernel 4 differs from its plain version on kernel 11's output "
          f"at N={c.N}")
    flags, rings, rowcol, xT = got
    fwd_bytes = (es_win.numel() * 4 + d_win.numel() * 4 + B
                 + c.fpack.numel() * 4 + c.ipack.numel() * 4
                 + c.em.c2.numel() * 4 + flags.numel() + rings.numel()
                 + rowcol.numel() + B * 4)
    row = {"N": c.N, "B": B, "W": W, "K": c.Km1 + 1, "S": c.S,
           "plain_windows": P,
           "forward": {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                       "bound_ops_ms": ovn_fwd_ops(B, W, c.N, c.Km1,
                                                   streams=True)
                       / FP32_OPS_PER_S * 1e3,
                       "bound_bytes_ms": fwd_bytes / HBM_BYTES_PER_S * 1e3,
                       "max_abs_err": fwd_err, "match": True},
           "backtrace": {"ms": bt_ms, "plain_ms": bt_plain_ms,
                         "bound_bytes_ms": ovn_bt_bytes(labels, xT, c.Km1,
                                                        c.N)
                         / HBM_BYTES_PER_S * 1e3,
                         "max_abs_err": bt_err, "match": True}}
    row["forward"]["bound_ms"], row["forward"]["bound_by"] = bound_of(
        row["forward"])
    return row


def config6(T, create_signal, create_spike_template):
    """BASELINE.json config 6 (benchmarks/suite.py config6): N=3 templates
    of benchmarks/suite.py's first three shapes at K=60 seen on C=4
    channels with gains 0.3 + U (default_rng(7)), noise sigma_c = 0.25 +
    0.1 U, onset probabilities (0.01, 0.005, 0.008); the spike train is the
    generator's (default_rng(1234)). Returns (yc (T, C) float32, truth
    (N, T), mu (K, N, C), sigmas (C,), lp (N,))."""
    K, N, C = 60, 3, 4
    pp = np.array([0.01, 0.005, 0.008])
    temps = np.stack([create_spike_template(K, *p) for p in OVN_SHAPES[:3]],
                     axis=1)
    _, truth = create_signal(T, 0.0, pp, temps,
                             rng=np.random.default_rng(1234))
    rng = np.random.default_rng(7)
    mu = (temps[:, :, None] * (0.3 + rng.random((N, C)))).astype(np.float32)
    sg = (0.25 + 0.1 * rng.random(C)).astype(np.float32)
    yc = (sg * rng.standard_normal((T, C))).astype(np.float32)
    for n in range(N):
        k = truth[n]
        m = k > 0
        yc[m] += mu[k[m] - 1, n]
    return yc, truth, mu.astype(np.float64), sg.astype(np.float64), np.log(pp)


def match_mc(learned, true):
    """Nearest generator template of each learned (K, C) template: the
    squared difference summed over channels at the alignment of the best
    summed cross-correlation (train/em_mc._best_overlap_mc). Returns
    (indices, costs)."""
    from hmmspikesorter_torch.train.em_mc import _best_overlap_mc

    mm, cc = [], []
    for i in range(learned.shape[1]):
        costs = []
        for j in range(true.shape[1]):
            (i1, i2), _ = _best_overlap_mc(learned[:, i], true[:, j])
            costs.append(float(((learned[i1, i] - true[i2, j]) ** 2).sum()))
        mm.append(int(np.argmin(costs)))
        cc.append(min(costs))
    return mm, cc


def mc_phases(dev, card, T6=1 << 19, L6=8192, H6=256, plain_windows=16,
              block=2048):
    """The multichannel phases (kernels_mc, main_path_mc, kernels_em_mc,
    train_em_mc, train_path_mc) on BASELINE.json config 6: N=3, C=4, K=60,
    T=2^19, decode windows L=8192, H=256, EM block 2048. Returns the rows
    and launch counts of kernels 11-13 for the kernels line."""
    # ---- multichannel: BASELINE.json config 6 (N=3, C=4, K=60, T=2^19) --
    from hmmspikesorter_torch.core.emission_mc import (MCTables,
                                                       full_float32_matmul,
                                                       mc_streams)
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.data.synthetic import (create_signal,
                                                     create_spike_template)
    from hmmspikesorter_torch.io.extraction import unroll_mlseq
    from hmmspikesorter_torch.models import multichannel as mcm
    from hmmspikesorter_torch.ops import fb_mb
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
    from hmmspikesorter_torch.ops.ring_viterbi_mc import c2_stack
    from hmmspikesorter_torch.parallel.overlap_save import _build_windows
    from hmmspikesorter_torch.train import em as tem
    from hmmspikesorter_torch.train import em_mc as tmc

    f32 = torch.float32

    W6, B6 = L6 + 2 * H6, -(-T6 // L6)
    yc6, truth6, mu6, sg6, lp6 = config6(T6, create_signal,
                                         create_spike_template)
    K6, N6, C6 = mu6.shape
    yc6_d = torch.as_tensor(yc6, device=dev)
    tab6 = MCTables(mu6, sg6)
    # the channel projection d = z @ delta alone, in full float32
    z6 = yc6_d * torch.as_tensor(tab6.zscale, dtype=f32, device=dev)
    delta6 = torch.as_tensor(tab6.delta, dtype=f32, device=dev)
    with full_float32_matmul():
        z6 @ delta6
        proj_ms, _ = cuda_ms(lambda: z6 @ delta6, reps=20)
    proj_bytes = 4 * (z6.numel() + delta6.numel() + T6 * delta6.shape[1])
    proj = {"ms": proj_ms, "shape": [T6, C6, delta6.shape[1]],
            "bytes": proj_bytes,
            "bound_bytes_ms": proj_bytes / HBM_BYTES_PER_S * 1e3,
            "f32_ops": 2 * T6 * C6 * delta6.shape[1]}
    del z6, delta6

    def mc_windows(tab, L_w):
        B_w, W_w = -(-T6 // L_w), L_w + 2 * H6
        es, d = mc_streams(yc6_d, tab)
        es_w, _ = _build_windows(es, T=T6, L=L_w, H=H6, B=B_w, W=W_w)
        d_w, _ = _build_windows(d.reshape(T6, -1), T=T6, L=L_w, H=H6,
                                B=B_w, W=W_w)
        c = vomb.ovn_mc_consts(lp6[:tab.N], tab.c1, c2_stack(tab),
                               dtype=f32, device=dev)
        return (es_w.contiguous(), d_w.reshape(B_w, W_w, tab.N, K6 - 1)
                .contiguous(), torch.arange(B_w, device=dev) == 0, c)

    # N=3 at the decode's windows; N=2 (the first two templates) at windows
    # of L/4, so its plain versions (a step at a time) take a quarter as long
    mc_rows = {}
    for n_m, L_w in ((3, L6), (2, L6 // 4)):
        es_w, d_w, sil_w, c11 = mc_windows(
            tab6 if n_m == 3 else MCTables(mu6[:, :2], sg6), L_w)
        mc_rows[f"n{n_m}"] = ovn_mc_kernels(vomb, es_w, d_w, sil_w, c11,
                                            fwd_reps=3, bt_reps=10,
                                            P=plain_windows)
        del es_w, d_w
    emit({"phase": "kernels_mc", "dtype": "float32", "card": card, "T": T6,
          "L": L6, "H": H6, "C": C6, "projection": proj, **mc_rows})

    # ---- main_path_mc: fit_spiking_model_mc_fast on config 6 -----------
    tm6 = mcm.HMMTemplateModelMC(mu=mu6, sigmas=sg6, lp=lp6,
                                 allow_overlaps=True)
    mc_wr = (vomb.ovn_mc_forward_mb, vomb.ovn_backtrace_mb)

    def drive_mc(tm_m, **kw):
        for w in mc_wr:
            w.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = mcm.fit_spiking_model_mc_fast(tm_m, yc6, L=L6, H=H6,
                                          device=dev, **kw)
        torch.cuda.synchronize()
        return (m, time.perf_counter() - t,
                {w.__name__: w.launches for w in mc_wr})

    drive_mc(tm6)                                      # warm-up
    one6, one6_s, one6_launches = drive_mc(tm6)
    stream_batch = max(B6 // 4, 1)                 # 4 calls in flight
    str6, str6_s, str6_launches = drive_mc(tm6, streaming=True,
                                           blocks_per_call=stream_batch)
    f64_6, f64_6_s, _ = drive_mc(tm6, block_engine="ring",
                                 dtype=torch.float64)
    agree6 = float((one6.ml_seq == f64_6.ml_seq).mean())
    ll6_rel = abs(one6.ll - f64_6.ll) / abs(f64_6.ll)
    pos6 = unroll_mlseq(one6.ml_seq, tm6.state_space.states)
    dec6 = (pos6 == 1).sum(axis=1)
    true6 = (truth6 == 1).sum(axis=1)
    onset6_rel = np.abs(dec6 - true6) / true6
    emit({"phase": "main_path_mc", "N": N6, "C": C6, "K": K6,
          "S": tm6.state_space.nstates, "T": T6, "L": L6, "H": H6, "W": W6,
          "B": B6, "card": card,
          "oneshot": {"seconds": one6_s,
                      "mc_decode_samples_per_s": T6 / one6_s,
                      "launches": one6_launches,
                      "seams_repaired": one6.seams_repaired},
          "streaming": {"seconds": str6_s,
                        "mc_decode_samples_per_s": T6 / str6_s,
                        "launches": str6_launches,
                        "blocks_per_call": stream_batch},
          "kernel_share_of_oneshot": (mc_rows["n3"]["forward"]["ms"]
                                      + mc_rows["n3"]["backtrace"]["ms"]
                                      + proj_ms) / 1e3 / one6_s,
          "f64_plain_twin_seconds": f64_6_s, "agreement_vs_f64": agree6,
          "ll": one6.ll, "ll_f64": f64_6.ll, "ll_rel_err": ll6_rel,
          "onsets_decoded": dec6.tolist(), "onsets_true": true6.tolist()})
    check(all(one6_launches.values()) and all(str6_launches.values()),
          f"main_path_mc: a kernel did not run: {one6_launches} "
          f"{str6_launches}")
    check(str6_launches["ovn_mc_forward_mb"] >= 2,
          "main_path_mc: streaming made fewer than 2 calls")
    check(one6.ml_seq.shape == (T6,) and np.isfinite(one6.ll),
          "main_path_mc: output malformed")
    check(bool(one6.seam_ok.all()) and bool(str6.seam_ok.all()),
          "main_path_mc: seams not ok")
    check(np.array_equal(one6.ml_seq, str6.ml_seq),
          "main_path_mc: one-shot and streaming labels differ")
    check(agree6 >= 0.9999, f"main_path_mc: f32 vs f64 agreement {agree6}")
    check(ll6_rel <= 1e-6, f"main_path_mc: ll relative error {ll6_rel}")
    check(bool((onset6_rel <= 0.01).all()),
          f"main_path_mc: onset counts off by > 1%: {onset6_rel}")

    # ---- kernels_em_mc: kernels 12-13 at config 6's training shapes ----
    Le6, He6 = tem.cuda_em_geometry(K6, block)
    f32d = dict(dtype=f32, device=dev)
    es_s, body_s = tmc._mc_streams_dense(
        yc6_d, torch.as_tensor(mu6, **f32d), torch.as_tensor(sg6, **f32d))
    e6_win, ycw6, bnd6 = fb_mb.mc_em_windows(
        es_s, body_s.reshape(T6, N6, K6 - 1), yc6_d, L=Le6, H=He6)
    bounds6 = torch.as_tensor(np.stack(bnd6, 1), dtype=torch.int32,
                              device=dev).contiguous()
    ce6 = fb_mb.em_consts_mc(lp6, K6, **f32d)
    emmc = em_kernels(fb_mb, e6_win, bounds6, ce6, fwd_reps=10, bwd_reps=10,
                      yc_win=ycw6)
    del e6_win, ycw6, es_s, body_s
    emit({"phase": "kernels_em_mc", "dtype": "float32", "card": card,
          "L": Le6, "H": He6, "C": C6, "n3": emmc})

    # ---- train_em_mc: 5 chained kernel EM iterations on config 6 --------
    tab_e6 = tem.EMTables.build(build_state_space(N6, K6, False), dev)

    def mc_args(dt):
        return [torch.as_tensor(np.asarray(v, np.float64), device=dev).to(dt)
                for v in (yc6, lp6, mu6, sg6)]

    a6 = mc_args(f32)
    n_it6 = 5
    em_mc_wr = (fb_mb.em_forward_mb_mc, fb_mb.em_backward_mb_mc)

    def chain6():
        return tmc.em_chain_mc(*a6, tab_e6, K=K6, n_iters=n_it6,
                               fb_mode="overlap_cuda", block=block)

    chain6()                                         # warm-up
    for w in em_mc_wr:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    lp_c6, _, mu_c6, sg_c6, lls_c6 = chain6()
    out6 = (lp_c6.cpu().numpy(), mu_c6.cpu().numpy(), sg_c6.cpu().numpy())
    torch.cuda.synchronize()
    chain6_s = time.perf_counter() - t
    em6_launches = {w.__name__: w.launches for w in em_mc_wr}
    lls6 = lls_c6.double().cpu().numpy()
    check(all(v == n_it6 for v in em6_launches.values()),
          f"train_em_mc: launches {em6_launches}, expected {n_it6} each")
    check(np.all(np.isfinite(lls6)) and np.all(np.isfinite(out6[1])),
          "train_em_mc: non-finite output")
    first6 = tmc.em_step_mc(*a6, tab_e6, K=K6, fb_mode="overlap_cuda",
                            block=block)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref6 = tmc.em_step_mc(*mc_args(torch.float64), tab_e6, K=K6,
                          fb_mode="overlap", block=block)
    torch.cuda.synchronize()
    f64_step6_s = time.perf_counter() - t
    # the float32 ll witness, as in train_em: the plain float32 overlap
    # engine on the same input
    plain6 = tmc.em_step_mc(*a6, tab_e6, K=K6, fb_mode="overlap",
                            block=block)
    plain6_ll_rel = float(abs(plain6[4].double() - ref6[4]) / abs(ref6[4]))
    del plain6
    ll6_rtol = min(f32_ll_rtol(Le6, He6), max(1e-5, 3 * plain6_ll_rel))
    first6_errs = em_update_close(first6, ref6, "train_em_mc", ll6_rtol)

    def non_decreasing(lls):
        """Up to the float32 ll's own rounding (ll6_rtol relative): a
        converged EM's float32 lls wander by that much."""
        return bool(np.all(lls[1:] >= lls[:-1] - ll6_rtol * np.abs(lls[:-1])))

    check(non_decreasing(lls6), f"train_em_mc: ll decreased: {lls6.tolist()}")
    kern6_ms = emmc["forward"]["ms"] + emmc["backward"]["ms"]
    emit({"phase": "train_em_mc", "N": N6, "C": C6, "K": K6, "T": T6,
          "L": Le6, "H": He6, "W": Le6 + 2 * He6, "B": -(-T6 // Le6),
          "card": card, "iterations": n_it6, "seconds": chain6_s,
          "mc_bw_iter_per_s": n_it6 / chain6_s, "launches": em6_launches,
          "lls": lls6.tolist(), "kernel_ms_per_iteration": kern6_ms,
          "other_ms_per_iteration": chain6_s / n_it6 * 1e3 - kern6_ms,
          "first_iteration_err_vs_overlap_f64": first6_errs,
          "ll_rtol": ll6_rtol, "ll_non_decreasing": non_decreasing(lls6),
          "plain_overlap_f32_ll_rel_err_vs_f64": plain6_ll_rel,
          "f64_plain_overlap_step_seconds": f64_step6_s,
          "sigmas": out6[2].tolist()})

    # ---- train_path_mc: --multichannel --train's defaults, then decode --
    for w in em_mc_wr:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    tm_l6, _, lls_l6 = tmc.train_model_mc(yc6, 3, K6, 10,
                                          rng=np.random.default_rng(1),
                                          block=block, device=dev)
    torch.cuda.synchronize()
    train6_s = time.perf_counter() - t
    train6_launches = {w.__name__: w.launches for w in em_mc_wr}
    n_l6 = tm_l6.n_neurons
    mm6, cc6 = match_mc(tm_l6.mu, mu6)
    E6 = (mu6 ** 2).sum(axis=(0, 2))
    fits6 = [bool(cc6[i] < 0.01 * E6[mm6[i]]) for i in range(n_l6)]
    sig6_rel = np.abs(tm_l6.sigmas - sg6) / sg6
    lls_l6 = np.asarray(lls_l6)
    phases6 = [lls_l6[:10], lls_l6[10:]]
    mono6 = [non_decreasing(ph) for ph in phases6]
    tm_l6.allow_overlaps = True
    dec_l6, dec_l6_s, dec_l6_launches = drive_mc(tm_l6)
    pos_l6 = unroll_mlseq(dec_l6.ml_seq, tm_l6.state_space.states)
    on_l6 = (pos_l6 == 1).sum(axis=1)
    emit({"phase": "train_path_mc", "T": T6, "K": K6, "C": C6, "n_init": 3,
          "card": card, "train_seconds": train6_s,
          "train_launches": train6_launches, "n_templates": n_l6,
          "matched_to": mm6, "match_cost": cc6, "energies": E6.tolist(),
          "within_1pct": fits6, "sigmas": tm_l6.sigmas.tolist(),
          "sigmas_true": sg6.tolist(), "sigma_rel_err": sig6_rel.tolist(),
          "lp": tm_l6.lp.tolist(), "lls": lls_l6.tolist(),
          "ll_non_decreasing_per_phase": mono6,
          "decode_seconds": dec_l6_s, "decode_launches": dec_l6_launches,
          "onsets_decoded": on_l6.tolist(),
          "onsets_true": [int(true6[j]) for j in mm6],
          "seam_ok": bool(dec_l6.seam_ok.all())})
    check(all(v >= 10 for v in train6_launches.values()),
          f"train_path_mc: EM kernels did not run: {train6_launches}")
    check(bool((sig6_rel <= 0.02).all()),
          f"train_path_mc: sigmas off by > 2%: {sig6_rel.tolist()}")
    check(all(mono6), f"train_path_mc: ll decreased in a phase: "
          f"{lls_l6.tolist()}")
    check(n_l6 >= 1 and all(fits6),
          f"train_path_mc: learned {n_l6} templates {mm6} costs {cc6}")
    check(all(dec_l6_launches.values()),
          f"train_path_mc: kernels 11 and 4 did not run: {dec_l6_launches}")

    return {"fwd": mc_rows["n3"]["forward"], "one_launches": one6_launches,
            "em": emmc, "em_launches": em6_launches,
            "config6": (yc6, truth6, mu6, sg6, lp6)}


def mc_posterior_phases(dev, card, config6_, Lg=4096, plain_windows=16):
    """The multichannel posterior phases on BASELINE.json config 6 with
    overlaps off (S=178, the kernel path): kernels_gamma_mc,
    posterior_bench_mc, posterior_path_mc. Returns the kernel rows and the
    launch counts of kernels 14-15 for the kernels line."""
    from hmmspikesorter_torch.core import events as tevents
    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.models import multichannel as mcm
    from hmmspikesorter_torch.ops import fb_mb, gamma_mb
    from hmmspikesorter_torch.train import em_mc as tmc

    yc6, _, mu6, sg6, lp6 = config6_
    T6, C6 = yc6.shape
    K6, N6 = mu6.shape[:2]
    f32 = dict(dtype=torch.float32, device=dev)

    # ---- kernels_gamma_mc: kernels 14-15 vs their plain versions ---------
    Bg = -(-T6 // Lg)
    ch = gamma_mb.gamma_chunk(N6, K6)
    yc_pad = torch.zeros((Bg * Lg + 1, C6), **f32)
    yc_pad[:T6] = torch.as_tensor(yc6, **f32)
    es, body = tmc._mc_streams_dense(yc_pad, torch.as_tensor(mu6, **f32),
                                     torch.as_tensor(sg6, **f32))
    e6 = torch.cat([es[:, None], body], dim=1).contiguous()
    del yc_pad, es, body
    c14 = fb_mb.em_consts_mc(lp6, K6, **f32)
    term, lastw, chained = gamma_mb.chain_geometry(T6, Lg, dev)
    parts = gamma_kernels(
        lambda e, en, hi: gamma_mb.gamma_fwd_mb_mc(e, en, hi, c14, ch, Lg),
        lambda e, cp, en, hi, ex, tr, _yb, lw, em_: gamma_mb.gamma_bwd_mb_mc(
            e, cp, en, hi, ex, tr, lw, c14, ch, Lg, em_),
        lambda e, en, hi: gamma_mb.gamma_fwd_mb_mc_plain(e, en, hi, c14, ch,
                                                         Lg),
        lambda e, cp, en, hi, ex, tr, _yb, lw, em_:
            gamma_mb.gamma_bwd_mb_mc_plain(e, cp, en, hi, ex, tr, lw, c14,
                                           ch, Lg, em_),
        e6, None, term, lastw, chained, lambda ex: ex, c14, c14.S,
        plain_windows, reps=5, L=Lg)
    rows = {part: gamma_row("mc_" + part, *v, Bg, Lg, N6, K6 - 1, ch,
                            plain_windows)
            for part, v in parts.items()}
    del e6
    emit({"phase": "kernels_gamma_mc", "dtype": "float32", "card": card,
          "N": N6, "K": K6, "C": C6, "S": c14.S, "T": T6, "L": Lg, "B": Bg,
          "ch": ch, "stream_bytes": 4 * (Bg * Lg + 1) * c14.S, **rows})

    # ---- a non-overlap decode of config 6 (the plain nov MC engine) ------
    tm_nov = mcm.HMMTemplateModelMC(mu=mu6, sigmas=sg6, lp=lp6,
                                    allow_overlaps=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dec_nov = mcm.fit_spiking_model_mc_fast(tm_nov, yc6, device=dev)
    dec_nov_s = time.perf_counter() - t

    # ---- posterior_bench_mc: onset_posteriors_chained_mc, T=2^19, f32 ---
    pair = (gamma_mb.gamma_fwd_mb_mc, gamma_mb.gamma_bwd_mb_mc)
    tpost.onset_posteriors_chained_mc(tm_nov, yc6, L=Lg)     # warm-up
    for w in pair:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    p_po = tpost.onset_posteriors_chained_mc(tm_nov, yc6, L=Lg)
    post_s = time.perf_counter() - t
    bench_launches = {w.__name__: w.launches for w in pair}
    t = time.perf_counter()
    p_64 = tpost.onset_posteriors_chained_mc(tm_nov, yc6, L=Lg,
                                             dtype=torch.float64)
    torch.cuda.synchronize()
    p64_s = time.perf_counter() - t
    # witness of the float32 floor: the plain chained engines in float32
    # (an explicit projection keeps them off the kernels)
    p_32 = tpost.onset_posteriors_chained_mc(
        tm_nov, yc6, L=Lg,
        proj=tpost.onset_projection(tm_nov.state_space.states))
    plain32_err = float(np.abs(p_32 - p_64).max())
    del p_32
    dec_on = tevents._onsets_dense(dec_nov.ml_seq, N=N6, K=K6,
                                   overlaps=False)
    dec_c = np.array([len(o) for o in dec_on], float)
    exp_c = p_po.sum(axis=0)
    count_rel = float(np.max(np.abs(exp_c - dec_c) / np.maximum(dec_c, 1.0)))
    post_err = float(np.abs(p_po - p_64).max())
    # tests/test_pallas_gamma.py's 1e-4, or the float32 floor where the
    # plain float32 engines (the JAX association) show one above it: at
    # T=2^19 an onset split 0.99988 / 0.00012 between two samples rounds
    # to 1.0 in both at alpha + beta magnitudes of ~1e4 (float32 ulp 1e-3)
    post_tol = min(1e-3, max(1e-4, plain32_err))
    emit({"phase": "posterior_bench_mc", "N": N6, "K": K6, "C": C6,
          "S": c14.S, "T": T6, "L": Lg, "card": card, "seconds": post_s,
          "posterior_exact_mc_samples_per_s": T6 / post_s,
          "launches": bench_launches,
          "posterior_count_rel_err": count_rel,
          "expected_onsets": exp_c.tolist(), "decoded_onsets": dec_c.tolist(),
          "max_abs_err_vs_f64_plain_chained": post_err,
          "plain_f32_chained_max_abs_err_vs_f64": plain32_err,
          "tolerance": post_tol,
          "f64_plain_chained_seconds": p64_s,
          "nov_decode_seconds": dec_nov_s})
    check(p_po.shape == (T6, N6) and np.isfinite(p_po).all(),
          "posterior_bench_mc: output malformed")
    check(list(bench_launches.values()) == [2, 2],
          f"posterior_bench_mc: launches {bench_launches}, expected 2 + 2")
    check(post_err <= post_tol, f"posterior_bench_mc: {post_err} from the "
          f"float64 plain chained run (> {post_tol})")
    check(count_rel <= 1e-3, f"posterior_bench_mc: count error {count_rel}")
    del p_64, p_po

    # ---- posterior_path_mc: --confidence --qc on the nov MC decode ------
    path_launches = posterior_path("posterior_path_mc", dec_nov, pair, card)
    return {"rows": rows, "launches": path_launches}


def gamma_ops(kind, B, L, N, Km1):
    """(f32, transcendental) operations of kernels 7-10 at these shapes, per
    window step:
      nov forward (kernel 7): kernel 5's step without its logsumexp over the
        states (em_fwd_ops with no `la` steps);
      nov beta (kernel 8): each state's emission, the beta + emission add
        and the ring shift's add (6 S); the silent state's and each ring
        end's logsumexp over the onsets and logaddexp;
      ov2 forward (kernel 9): 5 S for the emissions; per ring slot a
        logaddexp (max, min, subtract, add; exp, log1p) and an add; per onset
        three adds and a logaddexp; the silent state's four-term logsumexp
        (14 f32, 4 exp, 1 log); one add per pair edge;
      ov2 beta (kernel 10): 5 S; per ring slot two adds and a logaddexp;
        the silent state's logsumexp (17 f32, 5 transcendentals);
      gamma (the emit_gamma variants): the remat repeats the forward; z_t
        costs alpha + beta, max, subtract and sum over the states (4 S) and
        S exp plus a log; each onset row an exp and an add per term.
      mc (kernels 14-15): the nov kernels with each state's emission read
        from the stream, not computed (4 f32 operations a state fewer in
        each forward, remat and beta step).
    kind: "nov_fwd", "nov_chain", "nov_gamma", "ov2_fwd", "ov2_chain",
    "ov2_gamma", "mc_fwd", "mc_chain", "mc_gamma"."""
    if kind.startswith(("nov", "mc")):
        S = 1 + N * Km1
        emit = 0 if kind.startswith("mc") else 4
        onset = N * (N + 2) if N > 1 else 0
        f_f32, f_sfu = em_fwd_ops(B, L, N, S, la_steps=0, emit=emit)
        b_f32, b_sfu = (2 + emit) * S + N * (3 * N + 10), (N + 3) + onset
        g_f32, g_sfu = 4 * S + 2 * N, S + 1 + N
    else:
        S = 1 + 2 * Km1 + Km1 * Km1
        ring = 2 * (Km1 - 1)
        f_f32 = B * L * (5 * S + 5 * ring + 14 + 14 + ring + 2)
        f_sfu = B * L * (2 * ring + 4 + 5)
        b_f32, b_sfu = 5 * S + 6 * 2 * Km1 + 17, 2 * 2 * Km1 + 5
        g_f32, g_sfu = 4 * S + 1 + 4 * (Km1 + 1), S + 1 + 2 * (Km1 + 1)
    if kind.endswith("fwd"):
        return f_f32, f_sfu
    if kind.endswith("chain"):
        return B * L * b_f32, B * L * b_sfu
    return (f_f32 + B * L * (b_f32 + g_f32), f_sfu + B * L * (b_sfu + g_sfu))


def gamma_bytes(kind, B, L, N, S, ch):
    """Bytes kernels 7-10 must move: each input read once, each output
    written once (windows, entry/exit/terminal states, checkpoints, per-window
    integers, posteriors, first-position betas). The mc kinds read the
    stream's S floats a step in place of a sample, and its boundary rows
    in place of the boundary samples."""
    cps = B * (L // ch) * S
    win = B * L * S if kind.startswith("mc") else B * L
    bnd = B * S if kind.startswith("mc") else B
    if kind.endswith("fwd"):
        return 4 * (win + B * S + cps + B)
    if kind.endswith("chain"):
        return 4 * (win + bnd + 2 * B * S + 3 * B)
    return 4 * (win + bnd + cps + 3 * B * S + 4 * B + B * L * N)


def gamma_row(kind, ms, plain_ms, err, B, L, N, Km1, ch, plain_windows):
    """One kernel row of the kernels_gamma line, with its bound."""
    S = (1 + 2 * Km1 + Km1 * Km1) if kind.startswith("ov2") else (1 + N * Km1)
    f32, sfu = gamma_ops(kind, B, L, N, Km1)
    byt = gamma_bytes(kind, B, L, N, S, ch)
    row = {"ms": ms, "plain_ms": plain_ms, "plain_windows": plain_windows,
           "f32_ops": f32, "sfu_ops": sfu, "bytes": byt,
           "bound_ops_ms": ops_ms(f32, sfu),
           "bound_bytes_ms": byt / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err, "match": True}
    row["bound_ms"], row["bound_by"] = bound_of(row)
    return row


def gamma_kernels(fwd, bwd, fwd_plain, bwd_plain, y_win, ybnd, term, lastw,
                  chained, tmx_of, c, S, P, reps, L=None):
    """One chained posterior pass at these windows through a kernel pair
    (fwd, bwd) and against its plain versions on the first P windows:
    checkpoints, first-position betas and onset posteriors must be bit for
    bit equal. `bwd(..., exits_or_terminal, emit)` takes the per-window
    beta input (exit betas for kernel 8, terminal betas from `tmx_of` for
    kernel 10). With L, y_win is the (B*L+1, S) emission stream of kernels
    14-15 and its first P windows are its first P*L+1 rows. Returns
    {part: (ms, plain_ms, max_abs_err)}."""
    B = chained.shape[0]
    head = (lambda x: x[:P]) if L is None else (lambda x: x[:P * L + 1])
    zero = torch.zeros((B, S), dtype=torch.float32, device=y_win.device)
    no_init = torch.zeros_like(chained)
    from hmmspikesorter_torch.core.posterior import (_recenter, _shift_down,
                                                     _shift_up)

    entry = _shift_down(_recenter(fwd(y_win, zero, no_init)[:, -1]))
    run_f = lambda: fwd(y_win, entry, chained)                # noqa: E731
    run_f()
    f_ms, cp = cuda_ms(run_f, reps=reps)
    f_pms, pcp = cuda_ms(lambda: fwd_plain(head(y_win), entry[:P],
                                           chained[:P]), reps=1)
    f_err = max_abs_err([(cp[:P], pcp)])
    check(torch.equal(cp[:P], pcp), f"{fwd.__name__} differs from its "
          "plain version")
    out = {"fwd": (f_ms, f_pms, f_err)}
    bx = tmx_of(zero)
    for part, emit in (("chain", False), ("gamma", True)):
        run_b = lambda: bwd(y_win, cp, entry, chained, bx, term,  # noqa
                            ybnd, lastw, emit)
        run_b()
        b_ms, (gam, b0) = cuda_ms(run_b, reps=reps)
        b_pms, (pgam, pb0) = cuda_ms(lambda: bwd_plain(
            head(y_win), cp[:P], entry[:P], chained[:P], bx[:P], term[:P],
            None if ybnd is None else ybnd[:P], lastw[:P], emit), reps=1)
        pairs = [(b0[:P], pb0)] + ([(gam[:P], pgam)] if emit else [])
        b_err = max_abs_err(pairs)
        check(all(torch.equal(a, b) for a, b in pairs),
              f"{bwd.__name__} ({part}) differs from its plain version")
        out[part] = (b_ms, b_pms, b_err)
        if not emit:
            bx = tmx_of(_shift_up(_recenter(b0)))
    return out


def posterior_path(phase, model, pair, card):
    """The --confidence --qc composition on a decoded model, with the
    launch counts of the kernel `pair` set to 0 just before and read just
    after: model_posteriors, confidence_from_posteriors,
    core/qc.unit_qc(posteriors=p), qc_arrays. Gates: 2 + 2 launches, median
    confidence above 0.9, isi_invariant_violations 0. Returns the launch
    counts."""
    from hmmspikesorter_torch.core import events as tevents
    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.core import qc as tqc

    for w in pair:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    p = tpost.model_posteriors(model)
    tm_m = model.template_model
    onsets = tevents._onsets_dense(model.ml_seq, N=tm_m.n_neurons,
                                   K=tm_m.K, overlaps=tm_m.allow_overlaps)
    conf = tpost.confidence_from_posteriors(p, onsets,
                                            half_width=(tm_m.K - 1) // 2)
    qcs = tqc.unit_qc(model, posteriors=p)
    qa = tqc.qc_arrays(qcs)
    wall = time.perf_counter() - t
    launches = {w.__name__: w.launches for w in pair}
    # the posteriors alone, again: the rest of the wall is the host QC
    torch.cuda.synchronize()
    t = time.perf_counter()
    tpost.model_posteriors(model)
    post_only = time.perf_counter() - t
    emit({"phase": phase, "N": tm_m.n_neurons, "K": tm_m.K,
          "S": tm_m.state_space.nstates, "T": len(model.ml_seq),
          "L": 4096, "B": -(-len(model.ml_seq) // 4096), "card": card,
          "seconds": wall,
          "samples_per_s": len(model.ml_seq) / wall,
          "posteriors_seconds": post_only,
          "launches": launches,
          "median_confidence": [float(np.median(cf)) for cf in conf],
          "n_spikes": qa["n_spikes"].tolist(),
          "expected_onsets": p.sum(axis=0).tolist(),
          "missing_mass": qa["missing_mass"].tolist(),
          "isi_invariant_violations":
              qa["isi_invariant_violations"].tolist(),
          "conf_median_qc": qa["conf_median"].tolist()})
    check(p.shape == (len(model.ml_seq), tm_m.n_neurons)
          and np.isfinite(p).all() and p.min() >= -1e-6
          and p.max() <= 1 + 1e-4, f"{phase}: posteriors malformed")
    check(list(launches.values()) == [2, 2],
          f"{phase}: kernel launches {launches}, expected 2 + 2")
    check(all(v == 0 for v in qa["isi_invariant_violations"]),
          f"{phase}: ISI invariant violated")
    check(all(np.median(cf) > 0.9 for cf in conf),
          f"{phase}: median confidence below 0.9")
    return launches


def dense_seams(y, temps, L, halfwidth):
    """Back-to-back spikes of the first two neurons, staggered by K//2,
    over [s - halfwidth, s + halfwidth) around every seam s = L, 2L, ...
    (tests/test_seam_repair.py's recipe, which tests/test_torch_overlap_save.py
    reuses): the combined state is never silent there, so no seam finds a
    common silence and every one goes to seam repair."""
    K = temps.shape[0]
    for seam in range(L, len(y) - halfwidth, L):
        for n, phase in ((0, 0), (1, K // 2)):
            t = seam - halfwidth + phase
            while t < seam + halfwidth:
                end = min(t + K - 1, len(y))
                y[t:end] += temps[1:1 + (end - t), n]
                t += K


def cli_path(dev, card, sc, config6_, T_mc=1 << 14, L=8192):
    """The CLI's body on arrays (hmmspikesorter_torch.cli._sort_loaded, all
    of sort_data after the HDF5 loaders), writing the MAT file with
    scipy.io.savemat under build/cli_path/ and reading it back:
      (a) the single-channel production run, --engine fast --confidence
          --qc, on bench.py's problem at T=2^21 (kernels 1-2 and 9-10);
          labels equal main_path's library decode;
      (a') a recording of 4 windows whose seams find no common silence
          (dense_seams): the library decode repairs them (seams_repaired >
          0) and the CLI's labels equal the float64 plain twin's;
      (b) --multichannel --engine fast --confidence --qc on config 6 with
          overlaps on (kernels 11 + 4, then the plain chained ovn MC
          posteriors at S=10,621), cut to T_mc samples; labels equal the
          library decode's; the error of the float32 posteriors the CLI
          computed against a float64 run on the card."""
    import pathlib

    import scipy.io

    from hmmspikesorter_torch import cli
    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.io.extraction import unroll_mlseq
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.models import multichannel as mcm
    from hmmspikesorter_torch.ops import gamma_ov2
    from hmmspikesorter_torch.ops import viterbi_mb as vmb
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb

    tm, y, decoded, temps = sc
    out_dir = pathlib.Path(__file__).resolve().parent / "build" / "cli_path"
    out_dir.mkdir(parents=True, exist_ok=True)
    keys = {"mlseq", "ll", "waveforms", "lp", "sigma", "confidence", "qc"}

    def run(tm_r, data, name, o, wrappers):
        for w in wrappers:
            w.launches = 0
        path = str(out_dir / f"{name}.mat")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = cli._sort_loaded(tm_r, data, path, o, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        back = scipy.io.loadmat(path, squeeze_me=True)
        check(np.array_equal(back["mlseq"], out["mlseq"]),
              f"cli_path {name}: the MAT file's mlseq differs")
        return out, wall, {w.__name__: w.launches for w in wrappers}

    def conf_ok(out, n_spikes):
        return all(len(c) == n for c, n in zip(out["confidence"], n_spikes))

    full = cli._options(engine="fast", confidence=True, qc=True)
    # ---- (a) the single-channel production run ---------------------------
    out_a, wall_a, la_a = run(
        tm, y, "sc", full, (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb,
                            gamma_ov2.gamma_ov2_fwd, gamma_ov2.gamma_ov2_bwd))
    ref_a = unroll_mlseq(decoded.ml_seq, tm.state_space.states) + 1
    qc_a = out_a.get("qc", {})
    # ---- (a') forced seam repair ------------------------------------------
    y_s = np.array(y[:4 * L])
    dense_seams(y_s, temps, L, 600)
    lib_s = api.fit_spiking_model_fast(tm, y_s, streaming=True, L=L)
    f64_s = api.fit_spiking_model_fast(tm, y_s, L=L, block_engine="ring",
                                       dtype=torch.float64)
    out_s, wall_s, _ = run(tm, y_s, "seams", cli._options(engine="fast"),
                           ())
    ref_s = unroll_mlseq(f64_s.ml_seq, tm.state_space.states) + 1
    # ---- (b) the multichannel run on config 6, overlaps on --------------
    yc6, _, mu6, sg6, lp6 = config6_
    yc_b = np.asarray(yc6[:T_mc], np.float64)
    tm6 = mcm.HMMTemplateModelMC(mu=mu6, sigmas=sg6, lp=lp6,
                                 allow_overlaps=True)
    # keep the float32 posteriors the CLI computes, for their error
    captured, real = [], tpost.model_posteriors

    def keep(*a, **k):
        captured.append(real(*a, **k))
        return captured[-1]

    tpost.model_posteriors = keep
    try:
        out_b, wall_b, la_b = run(
            tm6, yc_b.T, "mc", cli._options(engine="fast", confidence=True,
                                            qc=True, multichannel=True),
            (vomb.ovn_mc_forward_mb, vomb.ovn_backtrace_mb))
    finally:
        tpost.model_posteriors = real
    lib_b = mcm.fit_spiking_model_mc_fast(tm6, yc_b, L=L)
    ref_b = unroll_mlseq(lib_b.ml_seq, tm6.state_space.states) + 1
    torch.cuda.synchronize()
    t = time.perf_counter()
    p64 = tpost.model_posteriors(lib_b, dtype=torch.float64)
    torch.cuda.synchronize()
    p64_s = time.perf_counter() - t
    p32 = captured[0]
    p_err = float(np.abs(p32 - p64).max())
    emit({"phase": "cli_path", "card": card,
          "sc": {"T": len(y), "seconds": wall_a,
                 "samples_per_s": len(y) / wall_a, "launches": la_a,
                 "keys": sorted(out_a),
                 "n_spikes": np.asarray(qc_a.get("n_spikes", [])).tolist(),
                 "median_confidence": [float(np.median(c))
                                       for c in out_a["confidence"]]},
          "seams": {"T": len(y_s), "seconds": wall_s,
                    "seams_repaired": lib_s.seams_repaired,
                    "seams_repaired_f64": f64_s.seams_repaired,
                    "agreement_vs_f64": float((out_s["mlseq"]
                                               == ref_s).mean())},
          "mc": {"T": T_mc, "N": tm6.n_neurons, "C": tm6.n_channels,
                 "S": tm6.state_space.nstates, "seconds": wall_b,
                 "samples_per_s": T_mc / wall_b, "launches": la_b,
                 "keys": sorted(out_b),
                 "median_confidence": [float(np.median(c))
                                       for c in out_b["confidence"]],
                 "posteriors_f64_seconds": p64_s,
                 "posteriors_f32_max_abs_err_vs_f64": p_err,
                 "expected_onsets": p32.sum(axis=0).tolist()}})
    for name, out, ref, tm_r, T_r in (("sc", out_a, ref_a, tm, len(y)),
                                      ("mc", out_b, ref_b, tm6, T_mc)):
        check(set(out) == keys, f"cli_path {name}: keys {sorted(out)}")
        check(out["mlseq"].shape == (tm_r.n_neurons, T_r)
              and np.isfinite(out["ll"]),
              f"cli_path {name}: output malformed")
        check(np.array_equal(out["mlseq"], ref),
              f"cli_path {name}: labels differ from the library decode")
        check(conf_ok(out, out["qc"]["n_spikes"])
              and all(v == 0 for v in out["qc"]["isi_invariant_violations"]),
              f"cli_path {name}: confidence or qc malformed")
    check(all(la_a.values()) and all(la_b.values()),
          f"cli_path: a kernel did not run: {la_a} {la_b}")
    check(lib_s.seams_repaired > 0,
          f"cli_path: no seam was repaired ({lib_s.seams_repaired})")
    check(np.array_equal(out_s["mlseq"], ref_s),
          "cli_path: repaired labels differ from the float64 plain twin's")
    check(np.isfinite(p32).all() and p_err <= 1e-2,
          f"cli_path mc: float32 posteriors {p_err} from float64")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from hmmspikesorter_torch.core import events as tevents
    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.core.path_score import path_cumulative_ll
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.core.viterbi import viterbi_decode
    from hmmspikesorter_torch.core.emission import state_means
    from hmmspikesorter_torch.data.synthetic import (create_signal,
                                                     create_signal_fast,
                                                     create_spike_template)
    from hmmspikesorter_torch.io.extraction import unroll_mlseq
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.ops import _build
    from hmmspikesorter_torch.ops import fb_mb, gamma_mb, gamma_ov2
    from hmmspikesorter_torch.ops import viterbi_mb as vmb
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
    from hmmspikesorter_torch.parallel.overlap_save import (_build_windows,
                                                            ring_overlap_save)
    from hmmspikesorter_torch.train import em as tem
    from hmmspikesorter_torch.train import template_ops
    from hmmspikesorter_torch.utils.device import platform_report

    dev = torch.device("cuda")
    card = card_line()
    emit({"phase": "platform", **platform_report(), "card": card})

    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: v["path"] for k, v in built.items()},
          "ptxas": {k: [ln for ln in v["ptxas"].splitlines()
                        if "Used" in ln or "spill" in ln]
                    for k, v in built.items()}})

    # ---- the bench.py problem (N=2, K=60, sigma=0.3, T=2^21) ----------
    N, K, sigma, T, L = 2, 60, 0.3, 1 << 21, 8192
    H = max(4 * K, 64)                           # the api's default halo
    W = L + 2 * H
    temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                      create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    pp = np.array([0.003, 0.001])
    lp = np.log(pp)
    y, truth = create_signal_fast(T, sigma, pp, temps,
                                  rng=np.random.default_rng(1234))
    tm = api.HMMTemplateModel(mu=temps, sigma=sigma, lp=lp,
                              allow_overlaps=True)

    # ---- kernels vs plain versions at the main path's shapes ----------
    B = -(-T // L)
    c = vmb.ov2_consts(lp, temps, sigma, dtype=torch.float32, device=dev)
    y_win, _ = _build_windows(torch.as_tensor(y, dtype=torch.float32,
                                              device=dev),
                              T=T, L=L, H=H, B=B, W=W)
    sil = torch.arange(B, device=dev) == 0
    fwd = lambda: vmb.ov2_forward_mb(y_win, sil, c)          # noqa: E731
    fwd()                                                     # warm-up
    fwd_ms, (flags, rings, xT) = cuda_ms(fwd, reps=5)
    fwd_plain_ms, (pf, pr, px) = cuda_ms(
        lambda: vmb.ov2_forward_mb_plain(y_win, sil, c), reps=1)
    fwd_err = max_abs_err([(flags, pf), (rings, pr), (xT, px)])
    check(torch.equal(flags, pf) and torch.equal(rings, pr)
          and torch.equal(xT, px), "kernel 1 differs from its plain version")
    bt = lambda: vmb.ov2_backtrace_mb(pf, pr, px, c.Km1)     # noqa: E731
    bt()
    bt_ms, labels = cuda_ms(bt, reps=20)
    bt_plain_ms, plain_labels = cuda_ms(
        lambda: vmb.ov2_backtrace_mb_plain(pf, pr, px, c.Km1), reps=1)
    bt_err = max_abs_err([(labels, plain_labels)])
    check(torch.equal(labels, plain_labels),
          "kernel 2 differs from its plain version")
    # bounds from this run's inputs: kernel 1 moves the windows in and the
    # choices out and is bound by its f32 operations; kernel 2 needs the
    # flag byte of every step, one ring byte where the label is a ring slot
    # k >= 1 (data-dependent: counted from these labels), and writes int16
    # labels
    Km1 = c.Km1
    fwd_bytes = (y_win.numel() * 4 + B + c.means.numel() * 4 + flags.numel()
                 + rings.numel() + B * 4)
    fwd_bound_ops = fwd_ops(B, W, Km1) / FP32_OPS_PER_S * 1e3
    fwd_bound_bytes = fwd_bytes / HBM_BYTES_PER_S * 1e3
    lab = labels[:, 1:].long()
    ring_reads = int((((lab >= 2) & (lab <= Km1))
                      | ((lab >= Km1 + 2) & (lab <= 2 * Km1))).sum())
    bt_bytes = B * 4 + flags.numel() + ring_reads + labels.numel() * 2
    bt_bound = bt_bytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "kernels", "B": B, "W": W, "K": K, "dtype": "float32",
          "ov2_forward_mb": {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                             "bound_ops_ms": fwd_bound_ops,
                             "bound_bytes_ms": fwd_bound_bytes,
                             "match": True},
          "ov2_backtrace_mb": {"ms": bt_ms, "plain_ms": bt_plain_ms,
                               "bound_bytes_ms": bt_bound,
                               "ring_bytes_read": ring_reads,
                               "match": True}})
    del flags, rings, xT, pf, pr, px, labels, plain_labels, y_win

    # ---- the repository's N=3 configuration (BASELINE.json config 2) ---
    T3, H3 = 1 << 20, 256
    W3 = L + 2 * H3
    B3 = -(-T3 // L)
    pp3 = np.array([0.003, 0.002, 0.001])
    lp3 = np.log(pp3)
    temps3 = np.stack([create_spike_template(K, *p) for p in OVN_SHAPES[:3]],
                      axis=1)
    y3, truth3 = create_signal(T3, sigma, pp3, temps3,
                               rng=np.random.default_rng(1234))
    tm3 = api.HMMTemplateModel(mu=temps3, sigma=sigma, lp=lp3,
                               allow_overlaps=True)

    # ---- kernels 3-4 vs plain versions: N=3 at its main path's shapes,
    # N=4 at 32 windows of the same width -------------------------------
    c3 = vomb.ovn_consts(lp3, temps3, sigma, dtype=torch.float32, device=dev)
    y3_win, _ = _build_windows(torch.as_tensor(y3, dtype=torch.float32,
                                               device=dev),
                               T=T3, L=L, H=H3, B=B3, W=W3)
    ovn3 = ovn_kernels(vomb, y3_win, torch.arange(B3, device=dev) == 0, c3,
                       fwd_reps=3, bt_reps=10)
    del y3_win
    B4 = 32
    pp4 = np.array([0.003, 0.002, 0.001, 0.001])
    temps4 = np.stack([create_spike_template(K, *p) for p in OVN_SHAPES],
                      axis=1)
    y4, _ = create_signal_fast(B4 * L, sigma, pp4, temps4,
                               rng=np.random.default_rng(4))
    force_overlaps(y4, temps4, every=3000)
    c4 = vomb.ovn_consts(np.log(pp4), temps4, sigma, dtype=torch.float32,
                         device=dev)
    y4_win, _ = _build_windows(torch.as_tensor(y4, dtype=torch.float32,
                                               device=dev),
                               T=B4 * L, L=L, H=H3, B=B4, W=W3)
    ovn4 = ovn_kernels(vomb, y4_win, torch.arange(B4, device=dev) == 0, c4,
                       fwd_reps=2, bt_reps=5)
    del y4_win
    emit({"phase": "kernels_ovn", "dtype": "float32", "card": card,
          "n3": ovn3, "n4": ovn4})

    # ---- small decodes vs the generic gather Viterbi in float64 --------
    Ts, Ls, Hs = 6000, 1024, H
    ys, _ = create_signal_fast(Ts, sigma, (0.01, 0.006), temps,
                               rng=np.random.default_rng(7))
    small = api.fit_spiking_model_fast(tm, ys, L=Ls, H=Hs)
    ss = build_state_space(N, K, True)
    in_idx, in_w = ss.in_table(lp)
    mu64 = torch.as_tensor(temps, dtype=torch.float64, device=dev)
    x_ref, _ = viterbi_decode(ys, in_idx, in_w,
                              state_means(ss.states, mu64), sigma)
    ref_agree = float((small.ml_seq == x_ref.cpu().numpy()).mean())
    # N=3 and N=4 at K=60 through kernels 3-4 ("auto" on the card), with
    # overlapping spikes added; 20,000 samples, so that one near-tie flip
    # between float32 and float64 stays above the 0.9999 line
    ref_ovn = []
    for n_r, pp_r in ((3, (0.01, 0.006, 0.004)),
                      (4, (0.01, 0.006, 0.004, 0.003))):
        t_r = temps4[:, :n_r]
        tm_r = api.HMMTemplateModel(mu=t_r, sigma=sigma, lp=np.log(pp_r),
                                    allow_overlaps=True)
        y_r, _ = create_signal_fast(20000, sigma, pp_r, t_r,
                                    rng=np.random.default_rng(n_r))
        force_overlaps(y_r, t_r, every=1500)
        vomb.ovn_forward_mb.launches = 0
        vomb.ovn_backtrace_mb.launches = 0
        m_r = api.fit_spiking_model_fast(tm_r, y_r, L=Ls, H=256)
        launches = [vomb.ovn_forward_mb.launches,
                    vomb.ovn_backtrace_mb.launches]
        ss_r = build_state_space(n_r, K, True)
        in_idx, in_w = ss_r.in_table(tm_r.lp)
        x_r, _ = viterbi_decode(
            y_r, in_idx, in_w,
            state_means(ss_r.states, torch.as_tensor(t_r, device=dev)),
            sigma)
        x_r = x_r.cpu().numpy()
        ref_ovn.append({
            "N": n_r, "T": len(y_r), "L": Ls, "H": 256, "S": ss_r.nstates,
            "launches": launches,
            "agreement_vs_gather_f64": float((m_r.ml_seq == x_r).mean()),
            "pair_states": int((x_r >= 1 + n_r * (K - 1)).sum()),
            "seam_ok": bool(m_r.seam_ok.all())})
        del x_r, in_idx, in_w
    emit({"phase": "reference", "T": Ts, "L": Ls, "H": Hs,
          "agreement_vs_gather_f64": ref_agree,
          "seam_ok": bool(small.seam_ok.all()),
          "seams_repaired": small.seams_repaired, "ovn": ref_ovn})
    check(ref_agree >= 0.9999, "small decode disagrees with the oracle")
    for r in ref_ovn:
        check(all(r["launches"]), f"N={r['N']}: kernels 3-4 did not run")
        check(r["agreement_vs_gather_f64"] >= 0.9999,
              f"N={r['N']}: small decode disagrees with the oracle")
        check(r["pair_states"] > 0, f"N={r['N']}: no overlap decoded")

    # ---- main paths -----------------------------------------------------
    def main_path(phase, tm_p, y_p, truth_p, wrappers, kernel_ms, H_p,
                  stream_kw):
        """Drive api.fit_spiking_model_fast one-shot and streaming with the
        launch counts of `wrappers` set to 0 just before each call and
        read just after, against the float64 plain twin; check and emit.
        Returns the one-shot run's launch counts and decoded model."""
        T_p = len(y_p)

        def drive(**kw):
            for w in wrappers:
                w.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = api.fit_spiking_model_fast(tm_p, y_p, L=L, H=H_p, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            return m, wall, {w.__name__: w.launches for w in wrappers}

        drive()                              # warm-up: allocator, streams
        one, one_s, one_launches = drive()
        stream, stream_s, stream_launches = drive(streaming=True,
                                                  **stream_kw)
        f64, f64_s, _ = drive(block_engine="ring", dtype=torch.float64)
        check(all(one_launches.values()) and all(stream_launches.values()),
              f"{phase}: a kernel did not run on the main path: "
              f"{one_launches} {stream_launches}")
        check(one.ml_seq.shape == (T_p,) and np.isfinite(one.ll),
              f"{phase}: output malformed")
        check(bool(one.seam_ok.all()) and bool(stream.seam_ok.all()),
              f"{phase}: seams not ok")
        check(np.array_equal(one.ml_seq, stream.ml_seq),
              f"{phase}: one-shot and streaming labels differ")
        agree = float((one.ml_seq == f64.ml_seq).mean())
        ll_rel = abs(one.ll - f64.ll) / abs(f64.ll)
        pos = unroll_mlseq(one.ml_seq, tm_p.state_space.states)
        decoded_onsets = (pos == 1).sum(axis=1)
        true_onsets = (truth_p == 1).sum(axis=1)
        onset_rel = np.abs(decoded_onsets - true_onsets) / true_onsets
        output = {"mlseq": pos + 1, "ll": one.ll, "waveforms": tm_p.mu,
                  "lp": tm_p.lp, "sigma": tm_p.sigma}
        check(output["mlseq"].shape == (tm_p.n_neurons, T_p)
              and output["mlseq"].min() >= 1
              and output["mlseq"].max() <= tm_p.K - 1 + 1,
              f"{phase}: mlseq output malformed")
        # device-side share of the one-shot run: the decode up to the
        # labels on the host, without the host-side ll and repair
        torch.cuda.synchronize()
        t = time.perf_counter()
        x_dev, _ = ring_overlap_save(y_p, tm_p.lp, tm_p.mu, tm_p.sigma, L=L,
                                     H=H_p, overlaps=True, device=dev,
                                     dtype=torch.float32)
        x_host = x_dev.cpu().numpy()
        decode_s = time.perf_counter() - t
        t = time.perf_counter()
        path_cumulative_ll(y_p, x_host, tm_p.state_space.states, tm_p.mu,
                           tm_p.sigma, tm_p.lp)
        host_ll_s = time.perf_counter() - t
        emit({"phase": phase, "N": tm_p.n_neurons, "K": tm_p.K,
              "S": tm_p.state_space.nstates, "T": T_p, "L": L, "H": H_p,
              "W": L + 2 * H_p, "B": -(-T_p // L), "card": card,
              "oneshot": {"seconds": one_s, "samples_per_s": T_p / one_s,
                          "launches": one_launches,
                          "seams_repaired": one.seams_repaired},
              "streaming": {"seconds": stream_s,
                            "samples_per_s": T_p / stream_s,
                            "launches": stream_launches, **stream_kw},
              "oneshot_decode_to_host_seconds": decode_s,
              "host_ll_seconds": host_ll_s,
              # kernel time (CUDA events, kernels phases) over one-shot
              # wall time: an upper bound on the device's busy share
              "kernel_share_of_oneshot": kernel_ms / 1e3 / one_s,
              "f64_plain_twin_seconds": f64_s,
              "agreement_vs_f64": agree, "ll": one.ll, "ll_f64": f64.ll,
              "ll_rel_err": ll_rel,
              "onsets_decoded": decoded_onsets.tolist(),
              "onsets_true": true_onsets.tolist()})
        check(agree >= 0.9999, f"{phase}: f32 vs f64 agreement {agree} "
              "< 0.9999")
        check(ll_rel <= 1e-6, f"{phase}: ll relative error {ll_rel} > 1e-6")
        check(bool((onset_rel <= 0.01).all()),
              f"{phase}: onset counts off by > 1%")
        return one_launches, one

    one_launches, decoded_n2 = main_path(
        "main_path", tm, y, truth, (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb),
        fwd_ms + bt_ms, H, {})
    # streaming in batches of 64 windows (two calls in flight), not one
    # batch padded to the default 256
    one3_launches, _ = main_path(
        "main_path_n3", tm3, y3, truth3,
        (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb),
        ovn3["forward"]["ms"] + ovn3["backtrace"]["ms"], H3,
        {"blocks_per_call": 64})

    # ---- training: bench.py's EM problem (N=2, K=60, non-overlap, f32,
    # T=2^19, block 2048 -> L=2048, H=240, W=2528, B=256) ----------------
    Te = 1 << 19
    ye = y[:Te]
    Le, He = tem.cuda_em_geometry(K, 2048)
    We, Be = Le + 2 * He, -(-Te // Le)
    _, edge, lo_e, hi_e, xh_e = fb_mb._em_window_geom(Te, Le, He, Be, We)
    bounds_e = torch.as_tensor(np.stack([lo_e, hi_e, xh_e], 1),
                               dtype=torch.int32, device=dev).contiguous()
    ye_win = fb_mb._em_window_1d(
        torch.as_tensor(ye, dtype=torch.float32, device=dev), T=Te, L=Le,
        H=He, B=Be, W=We, edge=edge).contiguous()
    sig7 = float(np.std(ye))
    mu7 = tem.init_templates(K, 7, sig7, np.random.default_rng(1))
    lp7 = np.log(np.full(7, 2.0 ** (-3.0 * K / 2.0)))
    ce2 = fb_mb.em_consts(lp, temps, sigma, dtype=torch.float32, device=dev)
    ce7 = fb_mb.em_consts(lp7, mu7, sig7, dtype=torch.float32, device=dev)
    em2 = em_kernels(fb_mb, ye_win, bounds_e, ce2, fwd_reps=10, bwd_reps=10)
    em7 = em_kernels(fb_mb, ye_win, bounds_e, ce7, fwd_reps=5, bwd_reps=5)
    del ye_win
    emit({"phase": "kernels_em", "dtype": "float32", "card": card,
          "L": Le, "H": He, "n2": em2, "n7": em7})

    # ---- one kernel EM step vs the float64 gather engine -----------------
    Ks, Ts = 16, 6000
    temps_s = np.stack([create_spike_template(Ks, 3.0, 0.8, 0.2),
                        create_spike_template(Ks, 4.0, 0.3, 0.2)], axis=1)
    pp_s = np.array([0.004, 0.002])
    ys_e, _ = create_signal(Ts, sigma, pp_s, temps_s,
                            rng=np.random.default_rng(0))

    def em_args(yy, lp_, mu_, sg, dtype):
        return (torch.as_tensor(yy, dtype=dtype, device=dev),
                torch.as_tensor(lp_, dtype=dtype, device=dev),
                torch.as_tensor(mu_, dtype=dtype, device=dev),
                torch.tensor(sg, dtype=dtype, device=dev))

    tab_s = tem.EMTables.build(build_state_space(2, Ks, False), dev)
    for w in (fb_mb.em_forward_mb, fb_mb.em_backward_mb):
        w.launches = 0
    got_s = tem.em_step(*em_args(ys_e, np.log(pp_s), temps_s, sigma,
                                 torch.float32), tab_s, K=Ks,
                        fb_mode="overlap_cuda", block=1024)
    ref_launches = [fb_mb.em_forward_mb.launches,
                    fb_mb.em_backward_mb.launches]
    ref_s = tem.em_step(*em_args(ys_e, np.log(pp_s), temps_s, sigma,
                                 torch.float64), tab_s, K=Ks,
                        fb_mode="gather")
    ref_errs = em_update_close(got_s, ref_s, "reference_em")
    check(ref_launches == [1, 1], f"reference_em: launches {ref_launches}")
    emit({"phase": "reference_em", "N": 2, "K": Ks, "T": Ts,
          "L_H": list(tem.cuda_em_geometry(Ks, 1024)),
          "launches": ref_launches, "max_err_vs_gather_f64": ref_errs})

    # ---- train_em: 10 chained kernel EM iterations ----------------------
    tab_e = tem.EMTables.build(build_state_space(2, K, False), dev)
    a32 = em_args(ye, lp, temps, sigma, torch.float32)
    n_it = 10

    def chain():
        return tem.em_chain(*a32, tab_e, K=K, n_iters=n_it,
                            fb_mode="overlap_cuda", block=2048)

    chain()                                          # warm-up
    for w in (fb_mb.em_forward_mb, fb_mb.em_backward_mb):
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    lp_c, _, mu_c, sg_c, lls_c = chain()
    out_host = (lp_c.cpu().numpy(), mu_c.cpu().numpy(), float(sg_c))
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t
    em_launches = {"em_forward_mb": fb_mb.em_forward_mb.launches,
                   "em_backward_mb": fb_mb.em_backward_mb.launches}
    lls = lls_c.double().cpu().numpy()
    check(all(v == n_it for v in em_launches.values()),
          f"train_em: launches {em_launches}, expected {n_it} each")
    check(np.all(np.isfinite(lls)) and np.all(np.isfinite(out_host[1])),
          "train_em: non-finite output")
    check(bool(np.all(lls[1:] >= lls[:-1] - 1e-6 * np.abs(lls[:-1]))),
          f"train_em: ll decreased: {lls.tolist()}")
    # the first iteration vs one float64 step of the plain overlap engine
    first = tem.em_step(*a32, tab_e, K=K, fb_mode="overlap_cuda", block=2048)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref_first = tem.em_step(*em_args(ye, lp, temps, sigma, torch.float64),
                            tab_e, K=K, fb_mode="overlap", block=2048)
    torch.cuda.synchronize()
    f64_step_s = time.perf_counter() - t
    # ll: at 256 windows of 2528 steps the float32 telescoped ll carries
    # the recursion's own rounding. The plain float32 overlap engine, in the
    # JAX association, is the witness of its size in this run: the kernels'
    # ll may be off by 3x the witness's error (at least 1e-5), capped by
    # the recursion's worst case f32_ll_rtol; one dropped window is ~4e-3
    plain32 = tem.em_step(*a32, tab_e, K=K, fb_mode="overlap", block=2048)
    plain32_ll_rel = float(abs(plain32[4].double() - ref_first[4])
                           / abs(ref_first[4]))
    del plain32
    ll_rtol = min(f32_ll_rtol(Le, He), max(1e-5, 3 * plain32_ll_rel))
    first_errs = em_update_close(first, ref_first, "train_em", ll_rtol)
    kern_it_ms = em2["forward"]["ms"] + em2["backward"]["ms"]
    emit({"phase": "train_em", "N": 2, "K": K, "T": Te, "L": Le, "H": He,
          "W": We, "B": Be, "card": card, "iterations": n_it,
          "seconds": chain_s, "iterations_per_s": n_it / chain_s,
          "launches": em_launches, "lls": lls.tolist(),
          "kernel_ms_per_iteration": kern_it_ms,
          "other_ms_per_iteration": chain_s / n_it * 1e3 - kern_it_ms,
          "first_iteration_err_vs_overlap_f64": first_errs,
          "ll_rtol": ll_rtol,
          "plain_overlap_f32_ll_rel_err_vs_f64": plain32_ll_rel,
          "f64_plain_overlap_step_seconds": f64_step_s,
          "sigma": out_host[2]})

    # ---- train_path: the user's flow, train then sort -------------------
    for w in (fb_mb.em_forward_mb, fb_mb.em_backward_mb,
              vmb.ov2_forward_mb, vmb.ov2_backtrace_mb):
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    tm_l = api.fit_template_model(ye, 7, K, nsteps=10,
                                  rng=np.random.default_rng(1))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    train_launches = {"em_forward_mb": fb_mb.em_forward_mb.launches,
                      "em_backward_mb": fb_mb.em_backward_mb.launches}
    mm, cc = template_ops.match_templates(tm_l.mu, temps)
    energies = (temps ** 2).sum(axis=0)
    n_learned = tm_l.n_neurons
    fits = [bool(cc[i] < 0.01 * energies[mm[i]]) for i in range(n_learned)]
    tm_l.allow_overlaps = True
    t = time.perf_counter()
    dec = api.fit_spiking_model_fast(tm_l, ye)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    decode_launches = {"ov2_forward_mb": vmb.ov2_forward_mb.launches,
                       "ov2_backtrace_mb": vmb.ov2_backtrace_mb.launches}
    pos = unroll_mlseq(dec.ml_seq, tm_l.state_space.states)
    decoded = (pos == 1).sum(axis=1)
    true_onsets = (truth[:, :Te] == 1).sum(axis=1)
    onset_rel = [float(abs(decoded[i] - true_onsets[mm[i]])
                       / true_onsets[mm[i]]) for i in range(n_learned)]
    emit({"phase": "train_path", "T": Te, "K": K, "n_init": 7,
          "card": card, "train_seconds": train_s,
          "train_launches": train_launches, "n_templates": n_learned,
          "matched_to": mm.tolist(), "match_cost": cc.tolist(),
          "energies": energies.tolist(), "within_1pct": fits,
          "sigma": tm_l.sigma, "lp": tm_l.lp.tolist(),
          "decode_seconds": decode_s, "decode_launches": decode_launches,
          "onsets_decoded": decoded.tolist(),
          "onsets_true": [int(true_onsets[i]) for i in mm],
          "onset_rel_err": onset_rel,
          "seam_ok": bool(dec.seam_ok.all())})
    check(all(v >= n_it for v in train_launches.values()),
          f"train_path: EM kernels did not run: {train_launches}")
    if n_learned != 2 or sorted(mm.tolist()) != [0, 1] or not all(fits):
        # the gate is about to fail: show where the float64 plain engine
        # lands from the same seed before it does
        tm64 = api.fit_template_model(ye, 7, K, nsteps=10,
                                      rng=np.random.default_rng(1),
                                      dtype=torch.float64, fb_mode="overlap")
        mm64, cc64 = template_ops.match_templates(tm64.mu, temps)
        emit({"phase": "train_path_f64_plain", "n_templates": tm64.n_neurons,
              "matched_to": mm64.tolist(), "match_cost": cc64.tolist()})
    check(n_learned == 2 and sorted(mm.tolist()) == [0, 1] and all(fits),
          f"train_path: learned {n_learned} templates {mm.tolist()} "
          f"costs {cc.tolist()}")
    check(all(decode_launches.values()),
          f"train_path: kernels 1-2 did not run: {decode_launches}")
    check(bool(dec.seam_ok.all()), "train_path: seams not ok")
    check(max(onset_rel) <= 0.02,
          f"train_path: onset counts off by > 2%: {onset_rel}")

    # ---- kernels 7-10 (the chained onset posteriors) vs plain versions at
    # bench.py's posterior shapes: T=2^19, L=4096, B=128, K=60 -----------
    Tg, Lg = 1 << 19, 4096
    f32 = torch.float32
    yg, ybnd, term, lastw, chained = gamma_mb.chain_inputs(
        y[:Tg], Tg, Lg, f32, dev)
    Bg = yg.shape[0]
    c9 = vmb.ov2_consts(lp, temps, sigma, dtype=f32, device=dev)
    lp_d, mu_d, sg_d = (torch.as_tensor(np.asarray(v, np.float64)).to(
        device=dev, dtype=f32) for v in (lp, temps, sigma))
    ov2_parts = gamma_kernels(
        lambda yw, en, hi: gamma_ov2.gamma_ov2_fwd(yw, en, hi, c9),
        lambda yw, cp, en, hi, tx, tr, _yb, _lw, e: gamma_ov2.gamma_ov2_bwd(
            yw, cp, en, hi, tx, tr, c9, e),
        lambda yw, en, hi: gamma_ov2.gamma_ov2_fwd_plain(yw, en, hi, c9),
        lambda yw, cp, en, hi, tx, tr, _yb, _lw, e:
            gamma_ov2.gamma_ov2_bwd_plain(yw, cp, en, hi, tx, tr, c9, e),
        yg, ybnd, term, lastw, chained,
        lambda ex: gamma_ov2.terminal_exits(ex, ybnd, lastw, lp_d, mu_d,
                                            sg_d),
        c9, c9.S, 32, reps=3)
    g_rows = {"ov2": {part: gamma_row(
        {"fwd": "ov2_fwd", "chain": "ov2_chain", "gamma": "ov2_gamma"}[part],
        *v, Bg, Lg, 2, K - 1, gamma_ov2.CH2, 32)
        for part, v in ov2_parts.items()}}
    for n_g, (lp_g, mu_g, sg_g) in ((2, (lp, temps, sigma)),
                                    (7, (lp7, mu7, sig7))):
        cg = fb_mb.em_consts(lp_g, mu_g, sg_g, dtype=f32, device=dev)
        chg = gamma_mb.gamma_chunk(n_g, K)
        parts = gamma_kernels(
            lambda yw, en, hi: gamma_mb.gamma_fwd_mb(yw, en, hi, cg, chg),
            lambda yw, cp, en, hi, ex, tr, yb, lw, e: gamma_mb.gamma_bwd_mb(
                yw, cp, en, hi, ex, tr, yb, lw, cg, chg, e),
            lambda yw, en, hi: gamma_mb.gamma_fwd_mb_plain(yw, en, hi, cg,
                                                           chg),
            lambda yw, cp, en, hi, ex, tr, yb, lw, e:
                gamma_mb.gamma_bwd_mb_plain(yw, cp, en, hi, ex, tr, yb, lw,
                                            cg, chg, e),
            yg, ybnd, term, lastw, chained, lambda ex: ex, cg, cg.S, Bg,
            reps=5)
        g_rows[f"nov_n{n_g}"] = {part: gamma_row(
            {"fwd": "nov_fwd", "chain": "nov_chain",
             "gamma": "nov_gamma"}[part], *v, Bg, Lg, n_g, K - 1, chg, Bg)
            for part, v in parts.items()}
    del yg
    emit({"phase": "kernels_gamma", "dtype": "float32", "card": card,
          "T": Tg, "L": Lg, "B": Bg, "K": K, "ch_ov2": gamma_ov2.CH2,
          "ch_nov": {"n2": gamma_mb.gamma_chunk(2, K),
                     "n7": gamma_mb.gamma_chunk(7, K)},
          **g_rows})

    # ---- posterior_bench: bench.py's posterior problem (bench.py:216-241):
    # onset_posteriors_chained on the N=2 overlap model, T=2^19, float32,
    # after one warm-up; vs the float64 plain chained run on the card ------
    tpost.onset_posteriors_chained(tm, y[:Tg])               # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    p_po = tpost.onset_posteriors_chained(tm, y[:Tg])
    post_s = time.perf_counter() - t
    t = time.perf_counter()
    p_64 = tpost.onset_posteriors_chained(tm, y[:Tg], dtype=torch.float64,
                                          batch_windows=32)
    torch.cuda.synchronize()
    p64_s = time.perf_counter() - t
    # witness of the float32 floor: the plain chained engines in float32
    # (the JAX association; an explicit projection keeps them off the
    # kernels) on the same input
    p_32 = tpost.onset_posteriors_chained(
        tm, y[:Tg], proj=tpost.onset_projection(tm.state_space.states),
        batch_windows=32)
    plain32_err = float(np.abs(p_32 - p_64).max())
    del p_32
    dec_on = tevents._onsets_dense(decoded_n2.ml_seq[:Tg], N=N, K=K,
                                   overlaps=True)
    dec_c = np.array([len(o) for o in dec_on], float)
    exp_c = p_po.sum(axis=0)
    count_rel = float(np.max(np.abs(exp_c - dec_c) / np.maximum(dec_c, 1.0)))
    post_err = float(np.abs(p_po - p_64).max())
    emit({"phase": "posterior_bench", "N": N, "K": K, "S": c9.S, "T": Tg,
          "L": Lg, "card": card, "seconds": post_s,
          "posterior_exact_samples_per_s": Tg / post_s,
          "posterior_count_rel_err": count_rel,
          "expected_onsets": exp_c.tolist(), "decoded_onsets": dec_c.tolist(),
          "max_abs_err_vs_f64_plain_chained": post_err,
          "plain_f32_chained_max_abs_err_vs_f64": plain32_err,
          "f64_plain_chained_seconds": p64_s})
    check(p_po.shape == (Tg, N) and np.isfinite(p_po).all(),
          "posterior_bench: output malformed")
    check(post_err <= 1e-4, f"posterior_bench: {post_err} from the float64 "
          "plain chained run (> 1e-4)")
    check(count_rel <= 1e-3, f"posterior_bench: count error {count_rel}")
    del p_64

    # ---- the --confidence --qc composition on a decoded model: the N=2
    # overlap decode of main_path (kernels 9-10), and a non-overlap N=2
    # decode of the same signal (kernels 7-8), T=2^21 -------------------
    post_launches = posterior_path(
        "posterior_path", decoded_n2,
        (gamma_ov2.gamma_ov2_fwd, gamma_ov2.gamma_ov2_bwd), card)
    tm_nov = api.HMMTemplateModel(mu=temps, sigma=sigma, lp=lp,
                                  allow_overlaps=False)
    dec_nov = api.fit_spiking_model_fast(tm_nov, y, L=L)
    nov_launches = posterior_path(
        "posterior_path_nov", dec_nov,
        (gamma_mb.gamma_fwd_mb, gamma_mb.gamma_bwd_mb), card)

    mc = mc_phases(dev, card)
    mcp = mc_posterior_phases(dev, card, mc["config6"])
    cli_path(dev, card, (tm, y, decoded_n2, temps), mc["config6"])

    def gamma_entry(name, source, line, launches, row):
        """One kernel's entry of the kernels line from its row."""
        return {"name": name, "route": "cuda",
                "source": f"hmmspikesorter_torch/csrc/{source}",
                "replaces": f"hmmspikesorter_tpu/ops/{line}",
                "launches": launches, "max_abs_err": row["max_abs_err"],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None}

    emit({"kernels": [
        {"name": "ov2_forward_mb", "route": "cuda",
         "source": "hmmspikesorter_torch/csrc/viterbi_ov2_fwd.cu",
         "replaces": "hmmspikesorter_tpu/ops/pallas_viterbi_mb.py:66",
         "launches": one_launches["ov2_forward_mb"],
         "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
         "bound_ms": max(fwd_bound_ops, fwd_bound_bytes),
         "bound_by": ("operations" if fwd_bound_ops >= fwd_bound_bytes
                      else "bytes"),
         "library_ms": None},
        {"name": "ov2_backtrace_mb", "route": "cuda",
         "source": "hmmspikesorter_torch/csrc/viterbi_ov2_bt.cu",
         "replaces": "hmmspikesorter_tpu/ops/pallas_viterbi_mb.py:433",
         "launches": one_launches["ov2_backtrace_mb"],
         "max_abs_err": bt_err, "ms": bt_ms, "plain_ms": bt_plain_ms,
         "bound_ms": bt_bound, "bound_by": "bytes", "library_ms": None},
        {"name": "ovn_forward_mb", "route": "cuda",
         "source": "hmmspikesorter_torch/csrc/viterbi_ovn_fwd.cu",
         "replaces": "hmmspikesorter_tpu/ops/pallas_viterbi_ovn_mb.py:169",
         "launches": one3_launches["ovn_forward_mb"],
         "max_abs_err": ovn3["forward"]["max_abs_err"],
         "ms": ovn3["forward"]["ms"], "plain_ms": ovn3["forward"]["plain_ms"],
         "bound_ms": max(ovn3["forward"]["bound_ops_ms"],
                         ovn3["forward"]["bound_bytes_ms"]),
         "bound_by": ("operations" if ovn3["forward"]["bound_ops_ms"]
                      >= ovn3["forward"]["bound_bytes_ms"] else "bytes"),
         "library_ms": None},
        {"name": "ovn_backtrace_mb", "route": "cuda",
         "source": "hmmspikesorter_torch/csrc/viterbi_ovn_bt.cu",
         "replaces": "hmmspikesorter_tpu/ops/pallas_viterbi_ovn_mb.py:523",
         "launches": one3_launches["ovn_backtrace_mb"],
         "max_abs_err": ovn3["backtrace"]["max_abs_err"],
         "ms": ovn3["backtrace"]["ms"],
         "plain_ms": ovn3["backtrace"]["plain_ms"],
         "bound_ms": ovn3["backtrace"]["bound_bytes_ms"], "bound_by": "bytes",
         "library_ms": None},
        {"name": "em_forward_mb", "route": "cuda",
         "source": "hmmspikesorter_torch/csrc/em_fwd.cu",
         "replaces": "hmmspikesorter_tpu/ops/pallas_fb_mb.py:125",
         "launches": em_launches["em_forward_mb"],
         "max_abs_err": em2["forward"]["max_abs_err"],
         "ms": em2["forward"]["ms"], "plain_ms": em2["forward"]["plain_ms"],
         "bound_ms": bound_of(em2["forward"])[0],
         "bound_by": bound_of(em2["forward"])[1], "library_ms": None},
        {"name": "em_backward_mb", "route": "cuda",
         "source": "hmmspikesorter_torch/csrc/em_bwd.cu",
         "replaces": "hmmspikesorter_tpu/ops/pallas_fb_mb.py:209",
         "launches": em_launches["em_backward_mb"],
         "max_abs_err": em2["backward"]["max_abs_err"],
         "ms": em2["backward"]["ms"], "plain_ms": em2["backward"]["plain_ms"],
         "bound_ms": bound_of(em2["backward"])[0],
         "bound_by": bound_of(em2["backward"])[1], "library_ms": None},
        gamma_entry("gamma_fwd_mb", "gamma_fwd.cu", "pallas_gamma_mb.py:53",
                    nov_launches["gamma_fwd_mb"], g_rows["nov_n2"]["fwd"]),
        gamma_entry("gamma_bwd_mb", "gamma_bwd.cu", "pallas_gamma_mb.py:130",
                    nov_launches["gamma_bwd_mb"], g_rows["nov_n2"]["gamma"]),
        gamma_entry("gamma_ov2_fwd", "gamma_ov2_fwd.cu",
                    "pallas_gamma_ov2.py:170",
                    post_launches["gamma_ov2_fwd"], g_rows["ov2"]["fwd"]),
        gamma_entry("gamma_ov2_bwd", "gamma_ov2_bwd.cu",
                    "pallas_gamma_ov2.py:237",
                    post_launches["gamma_ov2_bwd"], g_rows["ov2"]["gamma"]),
        gamma_entry("ovn_mc_forward_mb", "viterbi_ovn_mc_fwd.cu",
                    "pallas_viterbi_ovn_mb.py:739",
                    mc["one_launches"]["ovn_mc_forward_mb"], mc["fwd"]),
        gamma_entry("em_forward_mb_mc", "em_mc_fwd.cu", "pallas_fb_mb.py:797",
                    mc["em_launches"]["em_forward_mb_mc"],
                    dict(mc["em"]["forward"], **dict(zip(
                        ("bound_ms", "bound_by"),
                        bound_of(mc["em"]["forward"]))))),
        gamma_entry("em_backward_mb_mc", "em_mc_bwd.cu",
                    "pallas_fb_mb.py:858",
                    mc["em_launches"]["em_backward_mb_mc"],
                    dict(mc["em"]["backward"], **dict(zip(
                        ("bound_ms", "bound_by"),
                        bound_of(mc["em"]["backward"]))))),
        gamma_entry("gamma_fwd_mb_mc", "gamma_mc_fwd.cu",
                    "pallas_gamma_mb.py:649",
                    mcp["launches"]["gamma_fwd_mb_mc"], mcp["rows"]["fwd"]),
        gamma_entry("gamma_bwd_mb_mc", "gamma_mc_bwd.cu",
                    "pallas_gamma_mb.py:719",
                    mcp["launches"]["gamma_bwd_mb_mc"], mcp["rows"]["gamma"]),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
