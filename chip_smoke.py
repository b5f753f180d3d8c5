#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hmmspikesorter_torch) on one NVIDIA
GPU: builds the kernels from this checkout, holds each against its plain
PyTorch version, drives the decode paths end to end and checks their
output.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line:
  platform     torch and CUDA versions, the card (nvidia-smi)
  build        nvcc of hmmspikesorter_torch/csrc/*.cu (kernels 1-4), all
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
Then one {"kernels": [...]} line, the nvidia-smi name/power-limit line and,
last, {"ok": true, "device": {...}}. Any failed check raises: the script
then exits non-zero and prints no result. Without CUDA it exits 1 first.
About 2 minutes on an H100.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
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


def ovn_fwd_ops(B, W, N, Km1):
    """f32 operations of the general-N forward at these shapes: per window
    step 4 per state for the emission (the means are per window, not per
    step) and 1 to add it; per candidate the adds of its transition
    weight (1, or 2 where an onset log-prob joins) and one compare per
    candidate past the first; plus the init emission and the argmax."""
    P = N * (N - 1) // 2
    S = 1 + N * Km1 + P * Km1 * Km1
    disjoint = (N - 2) * (N - 3) // 2            # pairs disjoint from a pair

    def cands(n_cells, n_cand, adds):
        return n_cells * (n_cand * adds + n_cand - 1)

    per_step = (5 * S
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
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
    from hmmspikesorter_torch.ops import viterbi_mb as vmb
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
    from hmmspikesorter_torch.parallel.overlap_save import (_build_windows,
                                                            ring_overlap_save)
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
        Returns the one-shot run's launch counts."""
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
        return one_launches

    one_launches = main_path(
        "main_path", tm, y, truth, (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb),
        fwd_ms + bt_ms, H, {})
    # streaming in batches of 64 windows (two calls in flight), not one
    # batch padded to the default 256
    one3_launches = main_path(
        "main_path_n3", tm3, y3, truth3,
        (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb),
        ovn3["forward"]["ms"] + ovn3["backtrace"]["ms"], H3,
        {"blocks_per_call": 64})

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
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
