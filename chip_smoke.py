#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hmmspikesorter_torch) on one NVIDIA
GPU: builds the kernels from this checkout, holds each against its plain
PyTorch version, drives the decode paths end to end and checks their
output.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing one JSON line with its own wall (`phase_seconds`,
since the previous phase line):
  platform     torch and CUDA versions, the card (nvidia-smi)
  build        nvcc of hmmspikesorter_torch/csrc/*.cu (kernels 1-19), all
               sources at once
  card_paths_prep  card_paths' recordings and two drift tracks (kernels 5-6
               and 12-13), its float64 references handed to the CPU
               worker (seconds_by_part)
  kernels      at the N=2 main path's shapes (B=256 windows of W=8672,
               K=60, float32): kernel 1 vs ov2_forward_mb_plain (flags,
               rings, xT exactly equal), kernel 2 vs ov2_backtrace_mb_plain
               (labels exactly equal); CUDA-event times and the card's bound;
               for kernel 1 (and kernels 16 and 19 below) the block shape
               ops/viterbi_mb.ov2_launch_plan chose (threads, windows and
               CTAs an SM is to hold, dynamic shared memory), the CTAs the
               card holds on an SM at once and the time of a window step;
               for kernels 1 and 16 their time at each block shape; for
               kernel 2 (and kernel 4 in kernels_ovn and kernels_mc, kernel
               2 again in drift_path) the design
               ops/bt_segments.bt_launch_plan chose (`design`: segments a
               window, threads, shared memory, tile steps, resident CTAs an
               SM, registers and spill bytes a thread, the time of a window
               step, the fix-up passes and re-chased steps a window) and
               `ms_by_shape`: every segment count forced, each exactly
               equal to the plan's labels; `launch_ms`: each of the timed
               launches' own device time (first, median, max) and the
               share of the timed span between launches; `ms_again`: the
               plan's launch timed again after the forced ones
  kernels_ov2_r1  kernel 19 (the round-1 N=2 forward in the JAX
               ov2_forward_pallas layout: kernel 1's source with its final
               state written out) on 16 of those windows: every output
               exactly equal to its plain version's; its labels equal
               kernels 1 + 2's and the plain decode's; the kernel timed
               alone, and the whole wrapper (constants, launch, layout)
  kernels_ovn  kernels 3-4 vs ovn_forward_mb_plain / ovn_backtrace_mb_plain
               (flags, rings, rowcol, xT and labels exactly equal) at the
               N=3 main path's shapes (B=128 windows of W=8704, K=60) and
               at N=4, K=60 (32 windows of W=8704); times and bounds; for
               kernel 3 the block shape ops/viterbi_ovn_mb.ovn_launch_plan
               chose (`design`: threads, interior slots, shared memory,
               resident CTAs an SM, registers and spill bytes a thread, the
               time of a window step; `ms_by_shape`: one shape per N)
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
               L=8192, H=256, seed 1234), through kernels 3-4; kernel 3's
               time (kernels_ovn) and its share of the one-shot wall
  kernels_em   kernels 5-6 (the EM E-step) vs em_forward_mb_plain /
               em_backward_mb_plain at both training shapes (B=256 windows
               of W=2528, K=60): N=2 on the first 2^19 samples of the
               bench.py signal with its templates, N=7 with
               init_templates(60, 7, std(y), default_rng(1)); and at the
               drift tracking's shape (N=2, B=16 windows of W=2528, one
               32768-sample chunk), the plain versions on the first 4
               windows; checkpoints and la exactly equal, the summed
               statistics within 1e-5 relative; times and bounds,
               the block shape ops/fb_mb.em_launch_plan chose and the time
               of a window step
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
  native_parity  float32 on the card against the native reference engine
               (hmmspikesorter_torch/native: single-thread C++, float64,
               built by g++ and run in the CPU worker while the card works)
               on the first 2^17 samples of the bench.py signal (N=2, K=60,
               sigma=0.3): api.fit_spiking_model_fast (kernels 1-2,
               L=8192) against native.viterbi (labels >= 0.9999 equal,
               their disagreements counted, the ll within 1e-6 relative);
               one em_step(fb_mode="overlap_cuda") on the non-overlap space
               (kernels 5-6, block 2048) against native.em_step (lp <= 1e-4
               and mu <= 2e-3 absolute, sigma <= 1e-4 and ll <= 2e-4
               relative: the overlap-save ll telescopes over halos, the
               native one is the whole forward pass's); each part's seconds
  kernels_gamma  kernels 7-10 (the chained onset posteriors) vs their plain
               versions: kernels 9-10 (N=2 overlaps, S=3600) at
               posterior_path's shapes (T=2^21 of the bench.py signal,
               L=4096, B=512, K=60, two CTAs an SM) and kernels 7-8
               (non-overlap, N=2 and N=7 with the kernels_em templates) at
               bench.py's posterior shapes (T=2^19, B=128), the plain
               versions on the first 4 windows; checkpoints, first-position
               betas and posteriors exactly equal; times and bounds of the
               forward, the chaining sweep and the gamma pass; for kernels
               9-10 the block shapes gamma_ov2_launch_plan chose, the CTAs
               resident on an SM, the time of a window step and
               `ms_by_shape`: both kernels forced to every block shape,
               each exactly equal to the plan's on all 512 windows; kernels
               9-10 again at the 128 windows, timed alone, their shape one
               of those; for kernels 7-8 (`design`) the
               shapes gamma_mb.gamma_launch_plan chose for kernel 7
               (`fwd`) and each pass of kernel 8, shared bytes, resident
               CTAs, registers, spill bytes and the time of a window step,
               and `ms_by_shape`: kernel 7 forced to every states-a-thread
               it takes and both passes of kernel 8 to every shape kernel 8
               takes, each exactly equal to the plan's on all 128 windows;
               `seconds_by_row`: each row's wall and the part of it its
               plain runs took
  posterior_bench  bench.py's posterior problem (bench.py:216-241):
               core/posterior.onset_posteriors_chained on the N=2 overlap
               model, T=2^19, float32, after one warm-up (kernels 9-10);
               samples/s; within 1e-4 of the float64 plain chained run on
               the card (where it is not, beside it the float32 plain
               chained engines' error on the same input, the float32 floor
               of a 4096-step window); expected onset counts within 1e-3 of
               main_path's decoded counts
  posterior_path  the --confidence --qc composition on main_path's decoded
               model (T=2^21, 512 windows): model_posteriors,
               confidence_from_posteriors, core/qc.unit_qc(posteriors=p),
               qc_arrays; launches of kernels 9-10 exactly 2 + 2, median
               confidence above 0.9, isi_invariant_violations 0
  posterior_path_nov  the same for a non-overlap N=2 decode of the same
               signal, through kernels 7-8; their kernel time at its 512
               windows (timed alone just before, no plain run:
               `kernels7_8_512` with kernels 7-8's design there, each of
               their shapes one that kernels_gamma checked) and its share
               of model_posteriors
  drift_path   the drift-adaptive path: bench.py's topology (N=2, K=60,
               sigma=0.3) on create_drifting_signal (T=2^21, scale 1.0 ->
               2.0, default_rng(1234)); api.fit_spiking_model_adaptive at
               the CLI defaults (chunk 32768, forget 0.3): tracking through
               kernels 5-6, decode through kernels 16 + 2 (launches 1 + 1),
               the tracking, decode and host ll walls; onset errors of the
               tracked and of a stationary decode against the truth (the
               tracked below the stationary); labels >= 0.9999 equal to the
               float64 plain twin (on the CPU, in the worker process, while
               the card runs on); kernel 16 vs its plain version on 4
               windows at full width (W=33,248) and kernel 2 on its output
               (`kernel2`: its plain version on the same 4 windows on the
               CPU, in the worker; its design and every design forced),
               kernel 2 on one window of 100,003 steps of main_path's
               signal, across three shared-memory tiles, at every segment
               count (`kernel2_tiles`: launched after the kernels phase,
               exactly equal to its plain version on the CPU, in the
               worker; passes and re-chased steps), kernels
               17-18 vs theirs on 4 of model_posteriors' 512 windows of
               4096, exactly equal,
               and forced to every block shape, each exactly equal to the
               plan's; timed with their block shapes there and at T=2^19
               (128 windows, their shape one of those); `seconds_by_part`;
               then model_posteriors (kernels 17-18, 2 + 2), confidence and
               unit_qc: within 1e-4 of the float64 plain chained piecewise
               run (or of the plain float32 chain's own error where larger,
               at most 1e-3), median confidence above 0.9; and
               `tracked_n3`: a single-channel N=3 tracked decode (K=60, 3
               windows of a 512-sample chunk) through kernels 3 and 4,
               one launch each a window, labels exactly equal to the same
               decode through their plain versions
  kernels_mc   the multichannel configuration (BASELINE.json config 6,
               benchmarks/suite.py config6: N=3, C=4, K=60, S=10,621,
               T=2^19, per-channel gains 0.3 + U, sigma_c = 0.25 + 0.1 U,
               pp=(0.01, 0.005, 0.008)): kernel 11 vs ovn_mc_forward_mb_plain
               on the streams of its decode windows (B=64 of W=8704, L=8192,
               H=256; the plain version on the first 16) at N=3 and at N=2
               (the first two templates; B=256 windows of L=2048, H=256),
               and kernel 4 on kernel 11's output vs its plain version:
               exactly equal; times, bounds and the channel projection's
               time; kernel 11's block shape from
               ops/viterbi_ovn_mb.ovn_mc_launch_plan (`design`: the
               interior's kind, threads, interior cells a thread, CTAs an
               SM, shared memory, resident CTAs an SM, registers and spill
               bytes a thread, the time of a window step; `ms_by_shape`:
               each shape it has for that N, forced, exactly equal)
  main_path_mc models/multichannel.fit_spiking_model_mc_fast on config 6,
               one-shot and streaming (16 windows a call), launches of
               kernels 11 and 4 counted in each run; labels vs the float64
               plain twin, ll, onset counts vs the generator's truth
  kernels_em_mc  kernels 12-13 vs em_forward_mb_mc_plain /
               em_backward_mb_mc_plain at config 6's training shapes (B=256
               windows of W=2528, S=178, C=4; the plain versions on the
               first 4): checkpoints, la and kernel 13's per-window
               partials exactly equal, the summed statistics within 1e-5
               relative; the block shapes from
               ops/fb_mb.em_mc_launch_plan (`design`: each kernel's body,
               window, or step for kernel 13, states a thread, threads,
               kernel 13's split, shared memory, resident CTAs an SM,
               registers and spill bytes a thread, the time of a window
               step; `ms_by_shape`:
               both kernels at each shape they take, forced, exactly
               equal to the plan's outputs; the same and the plan on as
               many windows as the card has SMs)
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
               plain versions on the first 4): checkpoints, first-position
               betas and posteriors exactly equal; times and bounds;
               kernels 14-15's `design` (gamma_mb.gamma_mc_launch_plan's
               shapes; `ms_by_shape` as kernels 7-8's)
  posterior_bench_mc  core/posterior.onset_posteriors_chained_mc on config 6
               with overlaps off, T=2^19, float32, after one warm-up
               (kernels 14-15, launches 2 + 2); samples/s; within 1e-4 of
               the float64 plain chained run on the card, or of the float32
               plain engines' own error where that is larger (at most 1e-3);
               expected onset counts within 1e-3 of a non-overlap decode's
  posterior_path_mc  the --confidence --qc composition (posterior_path's) on
               that non-overlap multichannel decode, through kernels 14-15;
               their kernel time (from kernels_gamma_mc, the same 128
               windows) and its share of model_posteriors
  drift_path_mc  the multichannel drift-adaptive path: config 6 with a
               linear 1x -> 2x amplitude ramp over T=2^20;
               models/multichannel.fit_spiking_model_adaptive_mc at the CLI
               defaults (chunk 32768, forget 0.3): tracking through kernels
               12-13 on every chunk, decode through kernel 11's per-window
               mode and kernel 4 (one launch each; 32 windows of W=33,248),
               the tracking, decode and host ll walls; onset errors of the
               tracked and of a stationary decode against the truth (the
               tracked below); kernel 11's per-window mode timed at that
               shape, exactly equal to 32 one-window shared launches under
               each window's constants (packed outputs and kernel 4's
               labels) and, on 4 windows cut to 1200 steps, to its batched
               plain version; a constant track's labels equal to the
               stationary kernel-11 decode's; the tracked posteriors with
               overlaps off (S=178) on the first two chunks against a
               float64 run on the CPU (in the worker), within 1e-3
  events_path  the events transfer and the channel-batched decode on inputs
               and dense labels the earlier phases checked (no plain
               version runs): the N=2 one-shot events decode on main_path's
               recording equals its dense labels bit for bit (every seam
               ok, the events branch, kernels 1 and 2 once a call), timed
               as bench.py:97-110 times it (one warm-up, 6 calls two deep,
               the oldest call's blob copied to pinned memory behind its
               decode and rebuilt on the host while the card works) beside
               the dense one-shot timed the same way; the blob's and the
               dense labels' bytes, the device-to-host seconds of each and
               the host rebuild's; the streaming events decode; N=3 on
               main_path_n3's recording (kernels 3 and 4), config 6 (kernels
               11 and 4) and drift_path's track (kernels 16 and 2), each
               equal to its dense labels; 4 channels x 2^19 samples of the
               bench.py signal through fit_spiking_models_fast_batched (256
               windows, one launch each of kernels 1 and 2), equal to each
               channel's own decode, dense and events
  cli_path     the CLI's body on arrays (cli._sort_loaded, everything after
               the HDF5 loaders; the MAT file written with scipy.io.savemat
               under build/cli_path/ and read back): --engine fast
               --confidence --qc on bench.py's problem at T=2^21 (kernels 1-2,
               9-10; labels equal main_path's); a 4-window recording whose
               seams find no common silence (seams repaired, labels equal
               the float64 plain twin's, run on the CPU); --multichannel
               --engine fast --confidence --qc on config 6 with overlaps on
               at T=2^14 (kernels 11 + 4, then the plain chained ovn MC
               posteriors at S=10,621; labels equal the library decode's;
               the float32 posteriors' error against a float64 run on the
               CPU);
               --adaptive --confidence --qc on drift_path's recording
               (labels equal the library's); --transfer events on the
               production run's recording (the dense run's MAT dict);
               --channels all --engine fast on 2 rows of 2^19 samples (one
               launch each of kernels 1 and 2, the library decodes' labels
               and ll); --multichannel --adaptive on drift_path_mc's
               recording (the library's labels and ll); `seconds_by_part`
  sharded_path the multi-device slice (parallel/) on this card through
               LocalMeshes, every shard in this process: sharded_em_step(
               fb_mode="overlap_cuda") at the JAX runner's defaults (C=8,
               T=2^20, N=2, K=60, S=119, L=4096, H=240, W=4576) on a channel
               2 x time 4 mesh, two iterations (kernels 5-6 once each a
               channel over all four shards' 256 windows, launches counted
               as in train_em), each held channel by channel to the
               single-device em_step(fb_mode="overlap_cuda", block=4096)
               from the same inputs at tests/test_sharded_em.py:180-184's
               float32 tolerances; kernels 5-6 on channel 0's sharded
               windows timed, their plain versions on the four shard-edge
               windows, every per-window output exactly equal; the step's
               wall; sharded_blocked_viterbi on a time-4 mesh (T=2^20, N=2,
               K=60 non-overlap, L=256): float64 labels exactly the
               single-device blocked_viterbi's, the float32 labels'
               agreement with them; sharded_onset_posteriors on a time-4
               mesh (T=2^18, L=4096, N=2 overlaps on, float32, the plain
               structural engines) within 9.04e-5 of the single-device
               chained posteriors (kernels 9-10); one sharded_em_step on a
               DistMesh of a
               one-rank NCCL group (a FileStore in a temporary directory;
               its axes hold one shard, so no collective crosses a card)
               bit-equal to a LocalMesh of one shard; runner.main
               ["--channels", "2", "--samples", "65536"] and its JSON line;
               `seconds_by_part`
  card_paths   (after cli_path) five paths held against float64 references
               computed on the CPU (card_paths_prep), one line each
               (`part`): a_n4_cli, N=4 (OVN_SHAPES, K=60, S=21,123,
               T=2^20) through cli._sort_loaded --engine fast (kernels 3
               and 4 once each on 128 windows; mlseq equal to the library
               decode's, ll within 1e-6 of a float64 path score, onset
               errors; the first 2^15 samples' labels equal the native
               float64 engine's); b_seam_repair, every seam of 4 windows
               forced (forced_seam_recordings) on config 2's N=3 templates
               (streaming, kernels 3-4) and config 6 (kernels 11 + 4): 3
               seams repaired, labels equal the float64 plain decode's
               (vs_f64: where they differ, the float32 plain engines on the
               CPU differ alike), each seam's rounds and seconds;
               c_tracked_mc_repair, the first 3 chunks of drift_path_mc's
               recording under its track (the same track), both seams
               forced, decode_tracked_mc: 2 seams repaired, labels equal
               the float64 decode's (vs_f64); d_tracked_n3,
               fit_spiking_model_adaptive at N=3 on a 1x -> 2x ramp over
               T=2^21 (kernels 5-6, then 64 launches each of kernels 3 and
               4, each timed), onset errors below a stationary decode's,
               the first 4 chunks' labels equal the float64
               _tracked_overlap_save's (vs_f64); e_tracked_mc_posteriors,
               onset_posteriors_tracked_mc with overlaps on (config 6,
               S=10,621, 2 chunks of 2048, the plain engines) within the
               float32 floor of the float64 run
  trace_path   one warm fit_spiking_model_fast at main_path's shape (T=2^21)
               and one train_em step under torch.profiler (CPU and CUDA
               activities): every profile_trace span of the decode and the
               EM step and kernels 1, 2, 5 and 6 by name in the trace; the
               device-busy share of the decode's window from the trace (the
               union of its kernels' intervals, and with copies) beside
               main_path's event-time estimate; the top five device
               operations by time; the Chrome trace under
               chiprun_out/trace_path/ (git-ignored); a tiny kernel's
               launch cost on the host before and after the profiler
               session. Last of the phases
The plain versions' step loops are launch-bound on the host and set most
of the wall: nvcc builds the kernels while kernels 1-4's plain versions
run, and two spawned worker processes compute the float64 references
and two plain backtraces on the CPU (drift_path's twin and its kernel 2
checks, cli_path's seam twin and multichannel posteriors, card_paths')
while the card runs on.
About 10 minutes on an H100 (the
wall phase prints it; each phase line carries its own phase_seconds).
Then one {"kernels": [...]} line, the script's own wall ({"phase": "wall"},
from the platform phase on, against its 1200 s limit), the nvidia-smi
name/power-limit line and, last, {"ok": true, "device": {...}}. Any failed check raises: the script
then exits non-zero and prints no result. Without CUDA it exits 1 first.
"""

import concurrent.futures
import contextlib
import json
import multiprocessing
import multiprocessing.resource_tracker
import pathlib
import subprocess
import sys
import threading
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
# windows held against the plain versions where the plain version's time
# grows with the windows (the E-step and posterior checks): window 0 starts
# the recording (or the chain), the others do not. The decode checks'
# plain versions take a launch-bound step at any window count and hold
# every window (kernels 1-4) or 16 (kernels 11 + 4).
PLAIN_WINDOWS = 4
# launches a backtrace is timed over: at ~0.1 ms a launch, ten spanned
# about 1 ms, and a host hiccup there doubled a reading
BT_REPS = 100
# template shapes of BASELINE.json config 2 (benchmarks/suite.py's first
# three) and the fourth of that list for N=4
OVN_SHAPES = ((3.0, 0.8, 0.2), (4.0, 0.3, 0.2), (2.5, 0.6, 0.3),
              (2.0, 0.5, 0.25))


_PHASE_T = [time.perf_counter()]


# threads a float64 reference takes in the CPU worker (CpuWorker); the
# card's plain loops keep one core busy, the kernel build all of them
CPU_THREADS = 3
# the worker's processes: the phases' references, and card_paths' (about
# 5-9 minutes of one core, card_paths_prep) beside them
CPU_WORKERS = 2


class CpuWorker:
    """CPU_WORKERS spawned processes that compute float64 references on the
    host's CPU while this process drives the card: submit(fn, *args)
    returns a future, the jobs taken in the order submitted; close() waits
    for the processes to end."""

    def __init__(self):
        self._pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=CPU_WORKERS,
            mp_context=multiprocessing.get_context("spawn"))

    def submit(self, fn, *args):
        return self._pool.submit(fn, *args)

    def close(self):
        self._pool.shutdown(wait=True)
        # the spawn context's resource tracker would outlive the pool until
        # this process exits; end and reap it here
        multiprocessing.resource_tracker._resource_tracker._stop()


def cpu_decode_twin(mu, sigma, lp, y, L, H, dtype=torch.float64):
    """fit_spiking_model_fast of an N-template model with overlaps on y
    (windows of L, halo H; None: the api's) through the plain ring engine
    in float64 (or `dtype`) on the CPU: cli_path's seam case's twin. Returns
    (labels, ll, seams repaired, seconds)."""
    from hmmspikesorter_torch.models import api

    torch.set_num_threads(CPU_THREADS)
    tm = api.HMMTemplateModel(mu=mu, sigma=sigma, lp=lp, allow_overlaps=True)
    t = time.perf_counter()
    with torch.inference_mode():
        m = api.fit_spiking_model_fast(tm, y, L=L, H=H, block_engine="ring",
                                       device="cpu", dtype=dtype)
    return m.ml_seq, m.ll, m.seams_repaired, time.perf_counter() - t


def cpu_tracked_twin(track, y, dtype=torch.float64):
    """drift_path's float64 twin on the CPU: decode_tracked of y under the
    track through the plain versions (a multichannel track and (T, C)
    samples: decode_tracked_mc, card_paths' tracked seam repair), in
    float64 or `dtype`. Returns (labels, ll, seams repaired, seconds)."""
    from hmmspikesorter_torch.train import adaptive as tad

    torch.set_num_threads(CPU_THREADS)
    t = time.perf_counter()
    with torch.inference_mode():
        m = tad.decode_tracked(track, y, device="cpu", dtype=dtype)
    return m.ml_seq, m.ll, m.seams_repaired, time.perf_counter() - t


def cpu_mc_decode_twin(mu, sigmas, lp, yc, L, H, dtype=torch.float64):
    """fit_spiking_model_mc_fast of a multichannel model with overlaps on
    (T, C) samples through the plain engines in float64 (or `dtype`) on the
    CPU (card_paths' multichannel seam repair). Returns (labels, ll, seams
    repaired, seconds)."""
    from hmmspikesorter_torch.models import multichannel as mcm

    torch.set_num_threads(1)
    tm = mcm.HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                                allow_overlaps=True)
    t = time.perf_counter()
    with torch.inference_mode():
        m = mcm.fit_spiking_model_mc_fast(tm, yc, L=L, H=H,
                                          block_engine="ring", device="cpu",
                                          dtype=dtype)
    return m.ml_seq, m.ll, m.seams_repaired, time.perf_counter() - t


def cpu_tracked_overlap_save(y, lp, mu, sigma, L, H, dtype=torch.float64):
    """train/adaptive._tracked_overlap_save of y under per-window
    parameters (one row a window) through the plain versions in float64
    (or `dtype`) on the CPU (card_paths' tracked N=3 cut). Returns (labels,
    seam flags, seconds)."""
    from hmmspikesorter_torch.train import adaptive as tad

    torch.set_num_threads(1)
    t = time.perf_counter()
    with torch.inference_mode():
        x, ok = tad._tracked_overlap_save(y, lp, mu, sigma, L=L, H=H,
                                          overlaps=True, device="cpu",
                                          dtype=dtype)
    return x.numpy(), ok.numpy(), time.perf_counter() - t


def cpu_ov2_backtrace(flags, rings, xT, Km1):
    """Kernel 2's plain version on the CPU, for drift_path's check of
    kernel 2 on kernel 16's output. Returns (labels, seconds)."""
    from hmmspikesorter_torch.ops import viterbi_mb as vmb

    torch.set_num_threads(1)
    t = time.perf_counter()
    with torch.inference_mode():
        labels = vmb.ov2_backtrace_mb_plain(flags, rings, xT, Km1)
    return labels, time.perf_counter() - t


def cpu_mc_posteriors(mu, sigmas, lp, yc):
    """model_posteriors of a multichannel model with overlaps on (T, C)
    samples in float64 on the CPU: the plain chained engine from 8192
    samples (cli_path's reference). Returns (posteriors, seconds)."""
    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.models import multichannel as mcm

    torch.set_num_threads(CPU_THREADS)
    tm = mcm.HMMTemplateModelMC(mu=mu, sigmas=sigmas, lp=lp,
                                allow_overlaps=True)
    t = time.perf_counter()
    with torch.inference_mode():
        p = tpost.onset_posteriors_chained_mc(tm, yc, device="cpu",
                                              dtype=torch.float64)
    return p, time.perf_counter() - t


def cpu_tracked_mc_posteriors(track, yc, dtype=torch.float64):
    """onset_posteriors_tracked_mc of (T, C) samples under a multichannel
    track on the CPU, in float64 (drift_path_mc's and card_paths'
    reference) or, as the float32 floor's witness, in float32. Returns
    (posteriors, seconds)."""
    from hmmspikesorter_torch.core import posterior as tpost

    torch.set_num_threads(CPU_THREADS)
    t = time.perf_counter()
    with torch.inference_mode():
        p = tpost.onset_posteriors_tracked_mc(track, yc, device="cpu",
                                              dtype=dtype)
    return p, time.perf_counter() - t


def cpu_native_decode(mu, sigma, lp, y):
    """native_parity's float64 decode on the CPU: the native reference
    engine's Viterbi of y under the model with overlaps (its library built
    by g++ first). Returns (labels, ll, {part: seconds})."""
    from hmmspikesorter_torch import native
    from hmmspikesorter_torch.core.state_space import build_state_space

    t = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t
    ss = build_state_space(mu.shape[1], mu.shape[0], True)
    t = time.perf_counter()
    x, ll = native.viterbi(y, ss, lp, mu, sigma)
    return x, ll, {"native_build": build_s,
                   "native_viterbi": time.perf_counter() - t}


def cpu_native_em(mu, sigma, lp, y):
    """native_parity's float64 EM step on the CPU: one Baum-Welch iteration
    of the native reference engine on the non-overlap space. Returns
    ((lp, mu, sigma, ll), seconds)."""
    from hmmspikesorter_torch import native
    from hmmspikesorter_torch.core.state_space import build_state_space

    ss = build_state_space(mu.shape[1], mu.shape[0], False)
    t = time.perf_counter()
    out = native.em_step(y, ss, lp, mu, sigma)
    return out, time.perf_counter() - t


class Background:
    """fn() on a thread of its own, started at once; result() joins it and
    returns (fn's value, its seconds), or raises what fn raised."""

    def __init__(self, fn):
        self._out = {}

        def run():
            t = time.perf_counter()
            try:
                self._out["value"] = fn()
            except BaseException as e:          # re-raised by result()
                self._out["error"] = e
            self._out["seconds"] = time.perf_counter() - t

        # not a daemon: the interpreter waits for it (and its nvcc
        # processes) before it exits, also after a failed check
        self._thread = threading.Thread(target=run)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"], self._out["seconds"]


def emit(obj):
    """Print one JSON line; a phase line gets `phase_seconds`, the wall
    since the previous phase line (or since the script started)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "phase_seconds": now - _PHASE_T[0]}
        _PHASE_T[0] = now
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


def cuda_ms_launches(fn, reps):
    """cuda_ms, with an event pair around each launch as well: (mean ms
    over the span from the first launch's start to the last one's end, the
    last output, {each launch's own device time: first, mean of the first
    10, median, max; the share of the span between launches})."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        start.record()
        out = fn()
        end.record()
    torch.cuda.synchronize()
    each = sorted(s.elapsed_time(e) for s, e in ev)
    first = [s.elapsed_time(e) for s, e in ev[:10]]
    span = ev[0][0].elapsed_time(ev[-1][1])
    return span / reps, out, {
        "first_ms": first[0], "first10_mean_ms": sum(first) / len(first),
        "median_ms": each[len(each) // 2], "max_ms": each[-1],
        "between_launches_share": 1.0 - sum(each) / span}


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


def ov2_bt_bytes(labels, xT, flags, Km1):
    """Bytes kernel 2 must move for these labels: the flag byte of every
    step, one ring byte where the label is a ring slot k >= 1
    (data-dependent: counted from the labels), the xT words in, the int16
    labels out. Returns (bytes, ring bytes read)."""
    lab = labels[:, 1:].long()
    ring_reads = int((((lab >= 2) & (lab <= Km1))
                      | ((lab >= Km1 + 2) & (lab <= 2 * Km1))).sum())
    return (xT.numel() * 4 + flags.numel() + ring_reads
            + labels.numel() * 2), ring_reads


def bt_row(launch, design_of, labels, W, ms, reps):
    """Kernel 2 or 4's design on one input (csrc/bt_chase.cuh), as the
    plan chose it (ops/bt_segments.bt_launch_plan): `design_of(G)`
    (segments, threads, shared bytes, tile steps, resident CTAs an SM,
    registers and spill bytes a thread), the time of a window step, the
    fix-up passes and re-chased steps a window (mean, max); `ms_by_shape`:
    every segment count G forced, each exactly equal to the plan's
    `labels`; `ms_again`: the plan's launch timed again after them.
    launch(G, stats) is the private launcher (G None: the plan's)."""
    from hmmspikesorter_torch.ops import bt_segments as bts

    by_shape = {}
    for G in bts.SEGMENTS:
        run = lambda: launch(G, False)                      # noqa: E731
        run()
        by_shape[str(G)], got = cuda_ms(run, reps)
        check(torch.equal(got, labels),
              f"a backtrace design (G={G}) differs from the plan's labels")
    ms_again, _ = cuda_ms(lambda: launch(None, False), reps)
    B = labels.shape[0]
    G = bts.bt_launch_plan(B, W, torch.cuda.get_device_properties(
        labels.device).multi_processor_count)
    plan_labels, st = launch(None, True)
    check(torch.equal(plan_labels, labels),
          "the backtrace's statistics run differs from its labels")
    passes, fixed = st[:, 0].double(), st[:, 1].double()
    return {"design": {**design_of(G), "us_per_window_step": ms * 1e3 / W,
                       "fixup_passes_mean": float(passes.mean()),
                       "fixup_passes_max": int(passes.max()),
                       "rechased_steps_mean": float(fixed.mean()),
                       "rechased_steps_max": int(fixed.max())},
            "ms_by_shape": by_shape, "ms_again": ms_again}


def kernel2_tiles_start(vmb, cpu, y, c):
    """Kernel 2 across shared-memory tiles: kernel 1's choices on one
    window of y of two whole tiles and a ragged third, kernel 2 forced to
    every segment count; its plain version on the CPU, in the worker, while
    the card runs on. Returns what kernel2_tiles_check reads."""
    from hmmspikesorter_torch.ops import bt_segments as bts

    dev = c.means.device
    W = 2 * bts.TILE_MAX + 1699
    f, r, x = vmb._forward_launch(
        "ov2_forward_mb", torch.as_tensor(y[None, :W], dtype=torch.float32,
                                          device=dev),
        torch.ones(1, dtype=torch.bool, device=dev), c)
    plain = cpu.submit(cpu_ov2_backtrace, f.cpu(), r.cpu(), x.cpu(), c.Km1)
    labels, stats = {}, {}
    for G in bts.SEGMENTS:
        lab, st = vmb._bt_launch(f, r, x, c.Km1, segments=G, stats=True)
        labels[G] = lab.cpu()
        stats[str(G)] = [int(v) for v in st[0]]
    return W, plain, labels, stats


def kernel2_tiles_check(tiles):
    """drift_path's `kernel2_tiles`: every segment count's labels exactly
    the plain version's, and at least one fix-up pass a tile."""
    from hmmspikesorter_torch.ops import bt_segments as bts

    W, plain, labels, stats = tiles
    ref, secs = plain.result()
    n = -(-W // bts.TILE_MAX)
    for G, lab in labels.items():
        check(torch.equal(lab, ref.to(torch.int16)),
              f"kernel 2 across {n} tiles (G={G}) differs from its plain "
              "version")
        check(stats[str(G)][0] >= n,
              f"kernel 2 ran fewer passes than tiles (G={G})")
    return {"B": 1, "W": W, "tiles": n, "match": True,
            "plain_seconds": secs, "plain_device": "cpu",
            "passes_rechased_by_segments": stats}


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


def em_kernels(fb_mb, y_win, bounds, c, fwd_reps, bwd_reps, yc_win=None,
               P=PLAIN_WINDOWS):
    """Kernels 5-6 on (y_win, bounds) vs their plain versions on the first P
    windows: checkpoints and la exactly equal, the per-window partials and
    their sums over those windows compared (sums within 1e-5 relative),
    CUDA-event times and the bounds, as one row of the kernels_em line.
    With yc_win (B, W, C), kernels 12-13 instead, y_win then the (B, W, S)
    stream emission windows."""
    B, W = y_win.shape[:2]
    P = min(P, B)
    mc = yc_win is not None
    ch = fb_mb.em_chunk(c.S)
    kn = ("12", "13") if mc else ("5", "6")
    if mc:
        fwd_k, fwd_p = fb_mb.em_forward_mb_mc, fb_mb.em_forward_mb_mc_plain
        bwd_k = lambda cp_: fb_mb.em_backward_mb_mc(             # noqa
            y_win, yc_win, cp_, bounds, c, ch)
        bwd_p = lambda cp_: fb_mb.em_backward_mb_mc_plain(       # noqa
            y_win[:P], yc_win[:P], cp_, bounds[:P], c, ch)
    else:
        fwd_k, fwd_p = fb_mb.em_forward_mb, fb_mb.em_forward_mb_plain
        bwd_k = lambda cp_: fb_mb.em_backward_mb(                # noqa
            y_win, cp_, bounds, c, ch)
        bwd_p = lambda cp_: fb_mb.em_backward_mb_plain(          # noqa
            y_win[:P], cp_, bounds[:P], c, ch)
    fwd = lambda: fwd_k(y_win, c, ch)                         # noqa: E731
    fwd()                                                     # warm-up
    fwd_ms, (cp, la) = cuda_ms(fwd, reps=fwd_reps)
    fwd_plain_ms, (pcp, pla) = cuda_ms(lambda: fwd_p(y_win[:P], c, ch),
                                       reps=1)
    fwd_err = max_abs_err([(cp[:P], pcp), (la[:P], pla)])
    check(torch.equal(cp[:P], pcp) and torch.equal(la[:P], pla),
          f"kernel {kn[0]} differs from its plain version at N={c.N}")
    bwd = lambda: bwd_k(cp)                                   # noqa: E731
    bwd()
    bwd_ms, got = cuda_ms(bwd, reps=bwd_reps)
    bwd_plain_ms, ref = cuda_ms(lambda: bwd_p(pcp), reps=1)
    got_p = [g[:P] for g in got]
    bwd_err = max_abs_err(list(zip(got_p, ref)))
    partials_equal = all(torch.equal(a, b) for a, b in zip(got_p, ref))
    if mc:
        check(partials_equal, f"kernel 13's per-window partials differ from "
              f"its plain version at N={c.N}")
    # the statistics as the wrapper hands them on: summed over windows,
    # window 0's beta, and the telescoped ll from la
    def rel(a, b):
        a, b = a.double(), b.double()
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    names = ("G1", "Gy", "Gy2", "X", "Xd")
    sums_rel = {n: rel(a.sum(0), b.sum(0))
                for n, a, b in zip(names, got_p, ref)}
    sums_rel["beta0"] = rel(got[5][0], ref[5][0])
    lo, hi = bounds[:P, 0].long(), bounds[:P, 1].long()
    (ek, pk), (ep, pp_) = (fb_mb._edge_reads(x, lo, hi)
                           for x in (la[:P], pla))
    sums_rel["ll"] = rel(ek[0] + (ek[1:] - pk[1:]).sum(),
                         ep[0] + (ep[1:] - pp_[1:]).sum())
    check(max(sums_rel.values()) <= 1e-5,
          f"kernel {kn[1]} differs from its plain version at N={c.N}: "
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
    design = {}
    if mc:
        design = em_mc_design(fb_mb, y_win, yc_win, bounds, c, ch, fwd_ms,
                              bwd_ms, (cp, la, *got), reps=fwd_reps)
    else:
        plan = fb_mb.em_plan_for(B, c.N, c.Km1 + 1, y_win.device)
        design = {"design": {
            "ctas": B,
            "forward": {"states_per_thread": plan.fwd_spt,
                        "threads": plan.fwd_threads},
            "backward": {"states_per_thread": plan.spt,
                         "threads": plan.cta_threads,
                         "remat_and_walk_split": plan.split},
            "dynamic_smem_bytes": {"forward": plan.fwd_smem_bytes,
                                   "backward": plan.bwd_smem_bytes},
            "us_per_window_step": {"forward": fwd_ms * 1e3 / W,
                                   "backward": bwd_ms * 1e3 / W}}}
    return {"N": c.N, "K": c.Km1 + 1, "S": c.S, "B": B, "W": W, "ch": ch,
            "plain_windows": P,
            **design,
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
                         "partials_bit_equal": partials_equal,
                         "sums_rel_err": sums_rel, "match": True}}


def em_mc_design(fb_mb, e_win, yc_win, bounds, c, ch, fwd_ms, bwd_ms, ref,
                 reps):
    """Kernels 12-13's block shapes: the plan's (ops/fb_mb.em_mc_launch_plan
    on this card) with what the card made of it (the body, resident CTAs an
    SM, registers and spill bytes a thread) and the time of a window step;
    `ms_by_shape` both kernels' times at every shape they take here ("step"
    kernel 13's step body beside kernel 12's window body at the plan's spt,
    else states a thread and kernel 13's split), each forced
    and every output exactly equal to the plan's, `ref`; the same on as
    many windows as the card has SMs, with the plan there."""
    B, W = e_win.shape[:2]
    C, K = yc_win.shape[2], c.Km1 + 1
    plan = fb_mb.em_mc_plan_for(B, c.N, K, C, e_win.device, ch=ch)
    attrs = fb_mb.em_mc_design(plan, c.N, K, C, ch)
    sms = torch.cuda.get_device_properties(e_win.device).multi_processor_count

    def by_shape(n):
        """Both kernels at every shape on the first n windows."""
        out = {}
        for shape in fb_mb.EM_MC_SHAPES:
            if not fb_mb.em_mc_shape_ok(c.N, K, C, shape, ch):
                continue
            fwd = lambda: fb_mb.em_forward_mb_mc(            # noqa: E731
                e_win[:n], c, ch, shape=shape)
            fwd()
            f_ms, (cp, la) = cuda_ms(fwd, reps)
            bwd = lambda: fb_mb.em_backward_mb_mc(           # noqa: E731
                e_win[:n], yc_win[:n], cp, bounds[:n], c, ch, shape=shape)
            bwd()
            b_ms, got = cuda_ms(bwd, reps)
            check(all(torch.equal(a, b[:n])
                      for a, b in zip((cp, la, *got), ref)),
                  f"kernels 12-13 differ between block shapes at {shape}")
            key = ("step" if shape == fb_mb.EM_MC_STEP else
                   f"spt{shape[0]}{'_split' if shape[1] else ''}")
            out[key] = {"forward": f_ms, "backward": b_ms}
        return out

    # as many windows as SMs, where the plan splits kernel 13 (one CTA an
    # SM); more, where it takes two CTAs an SM unsplit
    at_sms = min(B, sms)
    plan_sms = fb_mb.em_mc_plan_for(at_sms, c.N, K, C, e_win.device, ch=ch)
    return {"design": {
        "ctas": B, "sm_count": sms,
        "forward": {**attrs["forward"], "states_per_thread": plan.fwd_spt,
                    "threads": plan.fwd_threads,
                    "dynamic_smem_bytes": plan.fwd_smem_bytes,
                    "us_per_window_step": fwd_ms * 1e3 / W},
        "backward": {**attrs["backward"], "states_per_thread": plan.spt,
                     "threads": plan.cta_threads,
                     "remat_and_walk_split": plan.split,
                     "dynamic_smem_bytes": plan.bwd_smem_bytes,
                     "us_per_window_step": bwd_ms * 1e3 / W}},
        "ms_by_shape": by_shape(B),
        f"ms_by_shape_at_{at_sms}_windows": by_shape(at_sms),
        f"plan_at_{at_sms}_windows": {"states_per_thread": plan_sms.spt,
                                      "split": plan_sms.split}}


def bound_of(row):
    """(bound_ms, bound_by) of one kernel row."""
    ops, byt = row["bound_ops_ms"], row["bound_bytes_ms"]
    return max(ops, byt), ("operations" if ops >= byt else "bytes")


def ov2_design(vmb, B, W, Km1, dev, ms, launch=None):
    """The block shape csrc/viterbi_ov2_fwd.cu ran with for B windows of W
    (ops/viterbi_mb.ov2_launch_plan on this card), the CTAs of it that the
    card holds on an SM at once and the time of one window step; with
    `launch(shape)`, the kernel's time at each block shape it has."""
    plan = vmb.ov2_plan_for(B, Km1, dev)
    out = {"threads": plan.threads, "windows_per_cta": plan.windows_per_cta,
           "ctas_per_sm_asked": plan.ctas_per_sm,
           "resident_ctas_per_sm": vmb.ov2_occupancy(plan, Km1),
           "dynamic_smem_bytes": plan.smem_bytes,
           "irregular_warps": plan.irregular_warps,
           "cells_per_thread": plan.cells_per_thread,
           "sm_count": vmb.sm_count(dev), "us_per_step": ms * 1e3 / W}
    if launch is not None:
        out["ms_by_shape"] = {f"{t}x{n}": cuda_ms(lambda: launch((t, n)),
                                                  reps=3)[0]
                              for t, n in vmb.SHAPES}
    return out


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


def ovn_design(vomb, W, N, Km1, dev, ms):
    """The block shape csrc/viterbi_ovn_fwd.cu ran with
    (ops/viterbi_ovn_mb.ovn_launch_plan), what the card made of it
    (resident CTAs an SM, registers and spill bytes a thread) and the time
    of one window step; `ms_by_shape` the forward's time at each block
    shape the plan has for this N (one: the plan's)."""
    plan = vomb.ovn_launch_plan(N, Km1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return {"design": {"kind": plan.design, "threads": plan.threads,
                       "interior_slots_per_thread": plan.cells_per_thread,
                       "dynamic_smem_bytes": plan.smem_bytes,
                       **vomb.ovn_design(plan, N, Km1), "sm_count": sms,
                       "us_per_window_step": ms * 1e3 / W},
            "ms_by_shape": {f"{plan.threads}x1": ms}}


def ovn_plain(vomb, y_win, sil, c):
    """The plain versions of kernels 3-4 on (y_win, sil), timed by CUDA
    events: {"fwd_ms", "fwd", "bt_ms", "labels"}, for ovn_kernels."""
    fwd_ms, fwd = cuda_ms(lambda: vomb.ovn_forward_mb_plain(y_win, sil, c),
                          reps=1)
    bt_ms, labels = cuda_ms(lambda: vomb.ovn_backtrace_mb_plain(*fwd, c),
                            reps=1)
    return {"fwd_ms": fwd_ms, "fwd": fwd, "bt_ms": bt_ms, "labels": labels}


def ovn_kernels(vomb, y_win, sil, c, ref, fwd_reps, bt_reps):
    """Kernels 3-4 vs their plain versions on (y_win, sil) (`ref`, from
    ovn_plain on the same inputs): exact equality of every packed output
    and of the labels, CUDA-event times, kernel 3's block shape and the
    bounds, as one row of the kernels_ovn line."""
    B, W = y_win.shape
    fwd = lambda: vomb.ovn_forward_mb(y_win, sil, c)         # noqa: E731
    fwd()                                                     # warm-up
    fwd_ms, got = cuda_ms(fwd, reps=fwd_reps)
    fwd_plain_ms, plain = ref["fwd_ms"], ref["fwd"]
    fwd_err = max_abs_err(list(zip(got, plain)))
    check(all(torch.equal(a, b) for a, b in zip(got, plain)),
          f"kernel 3 differs from its plain version at N={c.N}")
    del got
    bt = lambda: vomb.ovn_backtrace_mb(*plain, c)             # noqa: E731
    bt()
    bt_ms, labels, bt_each = cuda_ms_launches(bt, reps=bt_reps)
    bt_plain_ms, plain_labels = ref["bt_ms"], ref["labels"]
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
                        "max_abs_err": fwd_err, "match": True,
                        **ovn_design(vomb, W, c.N, c.Km1, y_win.device,
                                     fwd_ms)},
            "backtrace": {"ms": bt_ms, "plain_ms": bt_plain_ms,
                          "bound_bytes_ms": ovn_bt_bytes(labels, xT, c.Km1,
                                                         c.N)
                          / HBM_BYTES_PER_S * 1e3,
                          "max_abs_err": bt_err, "match": True,
                          "launch_ms": bt_each,
                          **ovn_bt_row(vomb, plain, labels, c, bt_ms,
                                          bt_reps)}}


def ovn_bt_row(vomb, packed, labels, c, ms, reps):
    """`bt_row` of kernel 4 on the packed choices `packed`."""
    return bt_row(
        lambda G, st: vomb._bt_launch(*packed, c, segments=G, stats=st),
        lambda G: vomb.ovn_bt_design(labels.shape[1], c, G), labels,
        labels.shape[1], ms, reps)


def ovn_mc_design(vomb, es_win, d_win, sil, c, ms, reps):
    """The block shape csrc/viterbi_ovn_mc_fwd.cu ran with
    (ops/viterbi_ovn_mb.ovn_mc_launch_plan), what the card made of it
    (resident CTAs an SM, registers and spill bytes a thread) and the time
    of one window step; `ms_by_shape` the forward's time at each block shape
    built for this N (threads x CTAs an SM), each forced, exactly equal to
    the plan's output."""
    B, W = es_win.shape
    dev = es_win.device
    plan = vomb.ovn_mc_plan_for(B, c.N, c.Km1, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_shape = {}
    ref = vomb._mc_forward_launch(es_win, d_win, sil, c)
    for shape in vomb.MC_SHAPES[c.N]:
        key = f"{shape[0]}x{shape[1]}"
        if shape == (plan.threads, plan.ctas_per_sm):
            by_shape[key] = ms
            continue
        run = lambda: vomb._mc_forward_launch(           # noqa: E731
            es_win, d_win, sil, c, shape=shape)
        run()
        by_shape[key], got = cuda_ms(run, reps)
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"kernel 11 differs between its block shapes at N={c.N}")
    return {"design": {"kind": plan.design, "interior": plan.interior,
                       "threads": plan.threads,
                       "interior_cells_per_thread": plan.cells_per_thread,
                       "ctas_per_sm": plan.ctas_per_sm,
                       "dynamic_smem_bytes": plan.smem_bytes,
                       **vomb.ovn_mc_design(plan, c.N, c.Km1),
                       "sm_count": sms, "us_per_window_step": ms * 1e3 / W},
            "ms_by_shape": by_shape}


def ovn_mc_kernels(vomb, es_win, d_win, sil, c, fwd_reps, bt_reps, P):
    """Kernel 11 vs its plain version on the first P windows of (es_win,
    d_win, sil), and kernel 4 on kernel 11's output vs its plain version
    there: exact equality of every packed output and label; CUDA-event
    times of the kernels on all windows and of the plain versions on P;
    kernel 11's block shape (`ovn_mc_design`)."""
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
    bt_ms, labels, bt_each = cuda_ms_launches(bt, reps=bt_reps)
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
                       "max_abs_err": fwd_err, "match": True,
                       **ovn_mc_design(vomb, es_win, d_win, sil, c, fwd_ms,
                                       fwd_reps)},
           "backtrace": {"ms": bt_ms, "plain_ms": bt_plain_ms,
                         "bound_bytes_ms": ovn_bt_bytes(labels, xT, c.Km1,
                                                        c.N)
                         / HBM_BYTES_PER_S * 1e3,
                         "max_abs_err": bt_err, "match": True,
                         "launch_ms": bt_each,
                         **ovn_bt_row(vomb, got, labels, c, bt_ms,
                                         bt_reps)}}
    row["forward"]["bound_ms"], row["forward"]["bound_by"] = bound_of(
        row["forward"])
    return row


def drop_spikes(truth, spans, K):
    """Zero in the generator's (N, T) ring positions every spike with a
    sample in a (lo, hi) span, all K samples of its playback
    (data/synthetic.create_signal plays rows 0..K-1 from its onset)."""
    for lo, hi in spans:
        a = max(lo - K, 0)
        for n, t0 in zip(*np.nonzero(truth[:, a:hi] == 1)):
            truth[n, a + t0:a + t0 + K] = 0


def config6(T, create_signal, create_spike_template, scale_end=None, K=60,
            quiet=()):
    """BASELINE.json config 6 (benchmarks/suite.py config6): N=3 templates
    of benchmarks/suite.py's first three shapes at K=60 (or K) seen on C=4
    channels with gains 0.3 + U (default_rng(7)), noise sigma_c = 0.25 +
    0.1 U, onset probabilities (0.01, 0.005, 0.008); the spike train is the
    generator's (default_rng(1234)). scale_end: a drifting recording, each
    sample of a spike scaled by 1 + (scale_end - 1) t / T (a linear
    amplitude ramp from 1x to scale_end x). quiet: (lo, hi) spans where the
    generator's train plays no spike (every spike with a sample there is
    dropped whole; the noise is unchanged). Returns (yc (T, C) float32,
    truth (N, T), mu (K, N, C), sigmas (C,), lp (N,)): mu the templates at
    the start."""
    N, C = 3, 4
    pp = np.array([0.01, 0.005, 0.008])
    temps = np.stack([create_spike_template(K, *p) for p in OVN_SHAPES[:3]],
                     axis=1)
    _, truth = create_signal(T, 0.0, pp, temps,
                             rng=np.random.default_rng(1234))
    drop_spikes(truth, quiet, K)
    rng = np.random.default_rng(7)
    mu = (temps[:, :, None] * (0.3 + rng.random((N, C)))).astype(np.float32)
    sg = (0.25 + 0.1 * rng.random(C)).astype(np.float32)
    yc = (sg * rng.standard_normal((T, C))).astype(np.float32)
    ramp = (None if scale_end is None else
            (1.0 + (scale_end - 1.0) * np.arange(T) / T).astype(np.float32))
    for n in range(N):
        k = truth[n]
        m = k > 0
        if ramp is None:
            yc[m] += mu[k[m] - 1, n]
        else:
            yc[m] += ramp[m, None] * mu[k[m] - 1, n]
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
                                            fwd_reps=3, bt_reps=BT_REPS,
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
          "L": Le6, "H": He6, "C": C6,
          "bodies": {k: emmc["design"][k]["body"]
                     for k in ("forward", "backward")}, "n3": emmc})

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
            "config6": (yc6, truth6, mu6, sg6, lp6), "decoded": one6}


def mc_posterior_phases(dev, card, config6_, Lg=4096,
                        plain_windows=PLAIN_WINDOWS):
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
        lambda e, en, hi, shape=None: gamma_mb.gamma_fwd_mb_mc(
            e, en, hi, c14, ch, Lg, shape=shape),
        lambda e, cp, en, hi, ex, tr, _yb, lw, em_, shape=None:
            gamma_mb.gamma_bwd_mb_mc(e, cp, en, hi, ex, tr, lw, c14, ch, Lg,
                                     em_, shape=shape),
        lambda e, en, hi: gamma_mb.gamma_fwd_mb_mc_plain(e, en, hi, c14, ch,
                                                         Lg),
        lambda e, cp, en, hi, ex, tr, _yb, lw, em_:
            gamma_mb.gamma_bwd_mb_mc_plain(e, cp, en, hi, ex, tr, lw, c14,
                                           ch, Lg, em_),
        e6, None, term, lastw, chained, lambda ex: ex, c14, c14.S,
        plain_windows, reps=5, L=Lg,
        shapes=gamma_shapes(gamma_mb, N6, K6, ch, mc=True),
        fwd_shapes=gamma_fwd_shapes(gamma_mb, N6, K6, ch, mc=True))
    by_shape = parts.pop("ms_by_shape")
    rows = {part: gamma_row("mc_" + part, *v, Bg, Lg, N6, K6 - 1, ch,
                            plain_windows)
            for part, v in parts.items()}
    rows["design"] = gamma_design(gamma_mb, Bg, Lg, N6, K6, ch, dev,
                                  {part: v[0] for part, v in parts.items()},
                                  mc=True)
    rows["design"]["ms_by_shape"] = by_shape
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
    # kernels 14-15 of one model_posteriors at these 128 windows, from
    # kernels_gamma_mc's times
    path_launches = posterior_path(
        "posterior_path_mc", dec_nov, pair, card,
        2 * rows["fwd"]["ms"] + rows["chain"]["ms"] + rows["gamma"]["ms"])
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
           "max_abs_err": err, "match": True if plain_windows else None}
    row["bound_ms"], row["bound_by"] = bound_of(row)
    return row


def gamma_kernels(fwd, bwd, fwd_plain, bwd_plain, y_win, ybnd, term, lastw,
                  chained, tmx_of, c, S, P, reps, L=None, shapes=None,
                  fwd_shapes=None):
    """One chained posterior pass at these windows through a kernel pair
    (fwd, bwd) and against its plain versions on the first P windows:
    checkpoints, first-position betas and onset posteriors must be bit for
    bit equal. `bwd(..., exits_or_terminal, emit)` takes the per-window
    beta input (exit betas for kernel 8, terminal betas from `tmx_of` for
    kernel 10). With L, y_win is the (B*L+1, S) emission stream of kernels
    14-15 and its first P windows are its first P*L+1 rows. With `shapes`
    ({key: block shape}, kernels 8 and 15), bwd takes `shape=` and each
    pass runs again forced to every one of them, its outputs on every
    window bit for bit equal to the plan's (which the plain versions
    held), so a shape the plan picks at another window count is tied to
    the plain versions too; no plain run is added. With `fwd_shapes`
    ({key: states a thread}, kernels 7 and 14) fwd takes `shape=` and runs
    again forced to each, its checkpoints on every window bit for bit the
    plan's. Returns {part: (ms, plain_ms, max_abs_err)}, and with `shapes`
    or `fwd_shapes` {key: {part: ms}} under "ms_by_shape"."""
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
    for key, spt in (fwd_shapes or {}).items():
        run_s = lambda: fwd(y_win, entry, chained, shape=spt)  # noqa: E731
        run_s()
        s_ms, s_cp = cuda_ms(run_s, reps=reps)
        check(torch.equal(s_cp, cp), f"{fwd.__name__} differs between its "
              f"plan's block shape and {spt} states a thread")
        out.setdefault("ms_by_shape", {}).setdefault(key, {})["fwd"] = s_ms
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
        for key, shape in (shapes or {}).items():
            run_s = lambda: bwd(y_win, cp, entry, chained, bx,  # noqa: E731
                                term, ybnd, lastw, emit, shape=shape)
            run_s()
            s_ms, (s_gam, s_b0) = cuda_ms(run_s, reps=reps)
            check(torch.equal(s_b0, b0)
                  and (not emit or torch.equal(s_gam, gam)),
                  f"{bwd.__name__} ({part}) differs between its plan's "
                  f"block shape and {shape}")
            out.setdefault("ms_by_shape", {}).setdefault(key, {})[part] = s_ms
        if not emit:
            bx = tmx_of(_shift_up(_recenter(b0)))
    return out


def row_seconds(t0, parts):
    """The wall of one kernel row of kernels_gamma since t0, and the part
    of it its plain versions' runs took (gamma_kernels' plain_ms; none in a
    row timed alone)."""
    return {"seconds": time.perf_counter() - t0,
            "plain_seconds": sum(v[1] or 0.0 for v in parts.values()) / 1e3}


def gamma_shapes(gamma_mb, N, K, ch, mc=False):
    """{key: (spt, split)} of every block shape kernel 8 (kernel 15 with
    mc) takes at this topology ("step": kernel 15's step body)."""
    shapes, ok = ((gamma_mb.GAMMA_MC_SHAPES, gamma_mb.gamma_mc_shape_ok)
                  if mc else (gamma_mb.GAMMA_SHAPES, gamma_mb.gamma_shape_ok))
    return {("step" if spt == 0 else
             f"spt{spt}{'_split' if split else ''}"): (spt, split)
            for spt, split in shapes if ok(N, K, (spt, split), ch)}


def gamma_fwd_shapes(gamma_mb, N, K, ch, mc=False):
    """{key: states a thread} of every block shape kernel 7 (kernel 14 with
    mc) takes at this topology; the keys name kernel 8's unsplit shapes at
    the same states a thread."""
    return {f"spt{spt}": spt for spt in gamma_mb.GAMMA_FWD_SHAPES
            if gamma_mb.gamma_fwd_shape_ok(N, K, spt, ch, mc)}


def gamma_design(gamma_mb, B, L, N, K, ch, dev, ms, mc=False):
    """The block shapes kernels 7-8 (kernels 14-15 with mc) ran with for B
    windows of L (ops/gamma_mb.gamma_launch_plan on this card): for the
    forward, the chaining sweep and the gamma pass, the body, states a
    thread, split, threads, shared bytes, resident CTAs an SM, registers
    and spill bytes a thread, and the time of one window step (ms: {part:
    ms})."""
    plan = gamma_mb.gamma_plan_for(B, N, K, dev, ch=ch, mc=mc)
    out = gamma_mb.gamma_design(plan, N, K, ch, mc=mc)
    for part in ("fwd", "chain", "gamma"):
        out[part]["us_per_window_step"] = ms[part] * 1e3 / L
    return {"sm_count": torch.cuda.get_device_properties(
        dev).multi_processor_count, **out}


def gamma_path_ms(fwd, bwd, y_win, chained, S, reps=3, tmx_of=None):
    """Kernel time of one chained posterior call through a kernel pair at
    these windows, the kernels alone (no plain version): the forward twice
    (cold sweep, final), the chaining sweep and the gamma pass once, each
    timed by CUDA events. fwd(y_win, entry, has_init) -> cp; bwd(y_win, cp,
    entry, has_init, exits, emit) -> (gam, beta0); tmx_of, where given, maps
    the exit betas to what bwd takes (gamma_kernels' `tmx_of`)."""
    from hmmspikesorter_torch.core.posterior import (_recenter, _shift_down,
                                                     _shift_up)

    tmx_of = tmx_of or (lambda ex: ex)
    B = chained.shape[0]
    zero = torch.zeros((B, S), dtype=torch.float32, device=y_win.device)
    no_init = torch.zeros_like(chained)
    entry = _shift_down(_recenter(fwd(y_win, zero, no_init)[:, -1]))
    f_ms, cp = cuda_ms(lambda: fwd(y_win, entry, chained), reps)
    bx = tmx_of(zero)
    c_ms, (_, b0) = cuda_ms(
        lambda: bwd(y_win, cp, entry, chained, bx, False), reps)
    exits = tmx_of(_shift_up(_recenter(b0)))
    g_ms, _ = cuda_ms(
        lambda: bwd(y_win, cp, entry, chained, exits, True), reps)
    return {"fwd": f_ms, "chain": c_ms, "gamma": g_ms,
            "path": 2 * f_ms + c_ms + g_ms}


def ov2g_design(gamma_ov2, B, L, Km1, dev, ms):
    """The block shapes kernels 9-10 (17-18) ran with for B windows of L
    (ops/gamma_ov2.gamma_ov2_launch_plan on this card), the CTAs of each
    resident on an SM at once and the time of one window step of each part
    (ms: {part: ms})."""
    plan = gamma_ov2.gamma_ov2_plan_for(B, Km1, dev)
    return {"fwd_threads": gamma_ov2.NT,
            "gamma_threads": plan.gamma_threads, "gamma_split": plan.split,
            "ctas_per_sm_asked": plan.ctas_per_sm,
            "resident_ctas_per_sm": gamma_ov2.gamma_ov2_occupancy(plan, Km1),
            "irregular_warps": plan.irregular_warps,
            "cells_per_thread": plan.cells_per_thread,
            "fwd_smem_bytes": plan.fwd_smem_bytes,
            "gamma_smem_bytes": plan.gamma_smem_bytes,
            "sm_count": torch.cuda.get_device_properties(
                dev).multi_processor_count,
            "us_per_window_step": {part: v * 1e3 / L
                                   for part, v in ms.items()}}


def ov2g_rows(gamma_ov2, parts, B, L, Km1, P, dev, S=None):
    """The rows of kernels 9-10 (17-18 with S: the per-window constant
    pack's bytes in the bound) from gamma_kernels' parts at B windows of L,
    P of them held against the plain versions, with the design they ran
    with."""
    rows = {}
    for part, v in parts.items():
        row = gamma_row(f"ov2_{part}", *v, B, L, 2, Km1, gamma_ov2.CH2, P)
        rows[part] = row if S is None else with_pack_bytes(row, B, S)
    rows["design"] = ov2g_design(gamma_ov2, B, L, Km1, dev,
                                 {part: v[0] for part, v in parts.items()})
    return {"B": B, "L": L, **rows}


def ov2g_path_ms(rows):
    """Kernel time of one chained N=2 overlap posterior call from its
    rows: the forward twice (cold sweep, final), the chaining sweep and
    the gamma pass once."""
    return 2 * rows["fwd"]["ms"] + rows["chain"]["ms"] + rows["gamma"]["ms"]


def ov2g_shapes(gamma_ov2, Km1):
    """{key: (threads, CTAs an SM)} of every block shape kernels 9-10
    (17-18) take at K-1 = Km1 (gamma_ov2.GAMMA_SHAPES whose gamma pass fits
    in shared memory); kernel 9 and the chaining sweep take its CTAs an
    SM."""
    return {f"{t}x{n}": (t, n) for t, n in gamma_ov2.GAMMA_SHAPES
            if gamma_ov2.ov2_smem_bytes(Km1, gamma_ov2.CH2,
                                        t == 2 * gamma_ov2.NT)
            <= gamma_ov2.SMEM_LIMIT}


def ov2g_timed(gamma_ov2, fwd, bwd, y_win, chained, tmx_of, S, Km1, checked,
               what):
    """Kernels 9-10 (17-18) at these windows timed alone (gamma_path_ms
    after one warm-up call, no plain run), as gamma_kernels' parts with no
    plain time or error; the
    block shape their plan takes here must be one of `checked` (the
    ms_by_shape of a row that held them against the plain versions and
    forced every shape, each exactly equal to the plan's)."""
    B = chained.shape[0]
    plan = gamma_ov2.gamma_ov2_plan_for(B, Km1, y_win.device)
    key = f"{plan.gamma_threads}x{plan.ctas_per_sm}"
    check(key in checked, f"{what}: shape {key} at {B} windows was not "
          "checked against the plain versions")
    gamma_path_ms(fwd, bwd, y_win, chained, S, reps=1, tmx_of=tmx_of)
    ms = gamma_path_ms(fwd, bwd, y_win, chained, S, tmx_of=tmx_of)
    return {part: (ms[part], None, None) for part in ("fwd", "chain", "gamma")}


def posterior_path(phase, model, pair, card, kernel_ms=None, extra=None):
    """The --confidence --qc composition on a decoded model, with the
    launch counts of the kernel `pair` set to 0 just before and read just
    after: model_posteriors, confidence_from_posteriors,
    core/qc.unit_qc(posteriors=p), qc_arrays. Gates: 2 + 2 launches, median
    confidence above 0.9, isi_invariant_violations 0. kernel_ms: the pair's
    kernel time of one model_posteriors, timed apart at its windows, set
    beside the posteriors' wall; extra: more fields of its line. Returns
    the launch counts."""
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
          "kernels_ms": kernel_ms,
          "kernels_share_of_posteriors":
              None if kernel_ms is None else kernel_ms / 1e3 / post_only,
          "launches": launches,
          "median_confidence": [float(np.median(cf)) for cf in conf],
          "n_spikes": qa["n_spikes"].tolist(),
          "expected_onsets": p.sum(axis=0).tolist(),
          "missing_mass": qa["missing_mass"].tolist(),
          "isi_invariant_violations":
              qa["isi_invariant_violations"].tolist(),
          "conf_median_qc": qa["conf_median"].tolist(), **(extra or {})})
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


def kernels_ov2_r1(vmb, y16, lp, temps, sigma, labels12, card):
    """Kernel 19 (the round-1 N=2 forward in the JAX ov2_forward_pallas
    layout) on 16 of the main path's windows: every output bit for bit
    against its plain version; its decode (kernel 19, then kernel 2 on the
    repacked choices) equal to kernels 1 + 2's labels and to the plain
    backtrace of the plain outputs. Returns the kernels-line row."""
    from hmmspikesorter_torch.ops import viterbi_ov2 as vo

    B, W = y16.shape
    Km1 = temps.shape[0] - 1
    S = 1 + 2 * Km1 + Km1 * Km1
    # the kernel alone, as kernel 1 is timed: the wrapper's host-side
    # constants (pageable copies) and its torch layout pass leave the card
    # idle between launches, and their time follows the host's load
    dev = y16.device
    c = vmb.ov2_consts(lp, temps, sigma, dtype=torch.float32, device=dev)
    sil = torch.arange(B, device=dev) == 0
    vT = torch.empty((B, S), dtype=torch.float32, device=dev)
    kern = lambda: vmb._forward_launch(                        # noqa: E731
        "ov2_forward_cuda", y16, sil, c, vT=vT)
    kern()
    ms, _ = cuda_ms(kern, reps=5)
    run = lambda: vo.ov2_forward_cuda(y16, lp, temps, sigma)  # noqa: E731
    run()
    wrapper_ms, outs = cuda_ms(run, reps=5)
    plain_ms, pouts = cuda_ms(
        lambda: vo.ov2_forward_plain(y16, lp, temps, sigma), reps=1)
    err = max_abs_err(list(zip(outs, pouts)))
    check(all(a.dtype == b.dtype and torch.equal(a, b)
              for a, b in zip(outs, pouts)),
          "kernel 19 differs from its plain version")
    vo.ov2_forward_cuda.launches = 0
    lab = vo.ov2_decode_cuda(y16, lp, temps, sigma)
    launches = vo.ov2_forward_cuda.launches
    plain_lab = vo.ov2_decode_from_kernel(tuple(o.cpu() for o in pouts),
                                          Km1, W)
    check(launches == 1, f"kernels_ov2_r1: launches {launches}")
    check(torch.equal(lab, labels12),
          "kernel 19's labels differ from kernels 1 + 2's")
    check(torch.equal(lab.cpu(), plain_lab),
          "kernel 19's labels differ from the plain decode's")
    byt = (y16.numel() * 4 + 6 * 4 + S * 4 + B * W * (1 + Km1) + B * 4
           + B * S * 4)
    row = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "max_abs_err": err,
           "bound_ops_ms": fwd_ops(B, W, Km1) / FP32_OPS_PER_S * 1e3,
           "bound_bytes_ms": byt / HBM_BYTES_PER_S * 1e3,
           "launches": launches,
           **ov2_design(vmb, B, W, Km1, dev, ms)}
    row["bound_ms"], row["bound_by"] = bound_of(row)
    emit({"phase": "kernels_ov2_r1", "B": B, "W": W, "K": Km1 + 1,
          "dtype": "float32", "card": card, "ov2_forward_cuda": row,
          "labels_equal_kernels_1_2": True, "labels_equal_plain": True})
    return row


def onset_errors(onsets, truth, tol=2):
    """False plus missed onsets under a one-to-one greedy matching of
    decoded to true onsets within +-tol samples (tests/test_adaptive.py's
    count)."""
    tot = 0
    for n in range(truth.shape[0]):
        to = np.sort(np.nonzero(truth[n] == 1)[0])
        dec = np.sort(np.asarray(onsets[n], np.int64))
        i = j = hit = 0
        while i < len(dec) and j < len(to):
            if abs(int(dec[i]) - int(to[j])) <= tol:
                hit += 1
                i += 1
                j += 1
            elif dec[i] < to[j] - tol:
                i += 1
            else:
                j += 1
        tot += (len(dec) - hit) + (len(to) - hit)
    return tot


def with_pack_bytes(row, B, S):
    """A kernels 17-18 row with the (B, 6 + S) per-window constant pack
    added to the bytes its bound counts."""
    row = dict(row, bytes=row["bytes"] + 4 * B * (6 + S))
    row["bound_bytes_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    row["bound_ms"], row["bound_by"] = bound_of(row)
    return row


def tracked_n3(dev, K=60, chunk=512, B=3):
    """A short single-channel N=3 tracked decode on the card (config 2's
    templates, ROADMAP's main_path_n3 shapes, a gain ramp of 15% a chunk,
    B chunks of `chunk` samples, overlapping spikes forced): launches of
    kernels 3 and 4 (one each a window, each window under its own
    constants) and the labels, exactly equal to the same decode through
    their plain versions on the card (ovn_kernel_ok held false for it).
    Returns the row."""
    from hmmspikesorter_torch.data.synthetic import (create_signal_fast,
                                                     create_spike_template)
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
    from hmmspikesorter_torch.train import adaptive as tad

    temps = np.stack([create_spike_template(K, *p) for p in OVN_SHAPES[:3]],
                     axis=1)
    lp = np.log([0.01, 0.006, 0.004])
    y, _ = create_signal_fast(B * chunk - 100, 0.3, np.exp(lp), temps,
                              rng=np.random.default_rng(3))
    force_overlaps(y, temps, every=400)
    T = len(y)
    g = 1.0 + 0.15 * np.arange(B)
    tr = dict(lp_all=np.tile(lp, (B, 1)), mu_all=temps[None] * g[:, None,
                                                                 None],
              sg_all=np.full(B, 0.3))
    kw = dict(L=chunk, H=max(4 * K, 64), overlaps=True, device=dev,
              dtype=torch.float32)
    wr = (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb)
    for w in wr:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    x, _ = tad._tracked_overlap_save(y, **tr, **kw)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t
    launches = {w.__name__: w.launches for w in wr}
    ok = vomb.ovn_kernel_ok
    vomb.ovn_kernel_ok = lambda *a: False
    try:
        t = time.perf_counter()
        x_plain, _ = tad._tracked_overlap_save(y, **tr, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
    finally:
        vomb.ovn_kernel_ok = ok
    equal = bool(torch.equal(x, x_plain))
    check(launches == {"ovn_forward_mb": B, "ovn_backtrace_mb": B},
          f"drift_path: the N=3 tracked decode's launches {launches}")
    check(equal, "drift_path: the N=3 tracked decode through kernels 3-4 "
          "differs from the plain versions'")
    return {"N": 3, "K": K, "T": T, "chunk": chunk, "windows": B,
            "launches": launches, "seconds": kernel_s,
            "plain_seconds": plain_s, "labels_equal_plain": equal}


def drift_path(dev, card, cpu, temps, lp, sigma, tiles, T=1 << 21,
               Tg=1 << 19, Lg=4096, P16=4, P17=PLAIN_WINDOWS):
    """The drift-adaptive path at full width: bench.py's N=2, K=60,
    sigma=0.3 topology on a drifting recording (create_drifting_signal,
    T=2^21, template scale 1.0 -> 2.0, default_rng(1234)).
    api.fit_spiking_model_adaptive at the CLI defaults (chunk 32768, forget
    0.3) with the launch counts of kernels 5-6 (tracking) and 16 + 2
    (decode) set to 0 just before and read just after; the tracking, the
    decode and its host ll timed apart; onset errors of the tracked and of
    a stationary fit_spiking_model_fast decode against the truth; the f32
    labels against decode_tracked through the plain versions in float64
    (on the CPU, in the worker `cpu`, while the card runs the rest);
    kernel 16 against its plain version on P16 windows at full width;
    kernel 2 after it, and `tiles` (kernel2_tiles_start) checked;
    kernels 17-18 against theirs on P17 windows at T, L=Lg, and forced to
    every block shape there, then timed alone at T=Tg; then the
    --confidence --qc composition (model_posteriors through kernels 17-18,
    confidence_from_posteriors, unit_qc) and its posteriors against the
    float64 plain chained piecewise run on the card. Returns the kernel
    rows, the launches and (model template, signal, decoded model) for
    cli_path."""
    from hmmspikesorter_torch.core import events as tevents
    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.core import qc as tqc
    from hmmspikesorter_torch.data.synthetic import create_drifting_signal
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.ops import fb_mb, gamma_mb, gamma_ov2
    from hmmspikesorter_torch.ops import viterbi_mb as vmb
    from hmmspikesorter_torch.parallel.overlap_save import _build_windows
    from hmmspikesorter_torch.train import adaptive as tad

    f32, f64 = torch.float32, torch.float64
    K = temps.shape[0]
    pp = np.exp(lp)
    secs, t_part = {}, time.perf_counter()
    y, truth, _ = create_drifting_signal(T, sigma, pp, temps,
                                         scale_start=1.0, scale_end=2.0,
                                         rng=np.random.default_rng(1234))
    tm0 = api.HMMTemplateModel(mu=temps, sigma=sigma, lp=lp,
                               allow_overlaps=True)
    wr_fit = (fb_mb.em_forward_mb, fb_mb.em_backward_mb,
              vmb.ov2_forward_mb_tracked, vmb.ov2_backtrace_mb)
    api.fit_spiking_model_adaptive(tm0, y)                   # warm-up
    for w in wr_fit:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    m = api.fit_spiking_model_adaptive(tm0, y)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    fit_launches = {w.__name__: w.launches for w in wr_fit}
    tr = m.track
    twin = cpu.submit(cpu_tracked_twin, tr, y)
    # the parts apart: tracking, decode (ll included), the host ll alone
    t = time.perf_counter()
    tr2 = tad.track_drift(tm0, y)
    track_s = time.perf_counter() - t
    t = time.perf_counter()
    m2 = tad.decode_tracked(tr2, y)
    decode_s = time.perf_counter() - t
    t = time.perf_counter()
    tad._piecewise_path_ll(y, m2.ml_seq, tr2, tm0.state_space)
    host_ll_s = time.perf_counter() - t
    check(np.array_equal(m2.ml_seq, m.ml_seq) and np.array_equal(tr2.mu,
                                                                  tr.mu),
          "drift_path: a second run gave another track or other labels")
    m_static = api.fit_spiking_model_fast(tm0, y)
    e_tracked = onset_errors(m.spike_onsets, truth)
    e_static = onset_errors(tevents._onsets_dense(m_static.ml_seq, N=2, K=K,
                                                  overlaps=True), truth)
    secs["signal_fits_and_decodes"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # ---- kernel 16 vs its plain version at full width ------------------
    L, H = tr.chunk, max(4 * K, 64)
    W, B = L + 2 * H, -(-T // tr.chunk)
    y_win, _ = _build_windows(torch.as_tensor(y, dtype=f32, device=dev),
                              T=T, L=L, H=H, B=B, W=W)
    y_win = y_win.contiguous()
    sil = torch.arange(B, device=dev) == 0
    c16 = vmb.ov2_consts(tr.lp, tr.mu, tr.sigma, dtype=f32, device=dev)
    run16 = lambda: vmb.ov2_forward_mb_tracked(y_win, sil, c16)  # noqa
    run16()
    k16_ms, (f16, r16, x16) = cuda_ms(run16, reps=3)
    sub = np.linspace(0, B - 1, P16).round().astype(int)
    sub_d = torch.as_tensor(sub, device=dev)
    c_sub = vmb.ov2_consts(tr.lp[sub], tr.mu[sub], tr.sigma[sub], dtype=f32,
                           device=dev)
    p16_ms, (pf, pr, px) = cuda_ms(lambda: vmb.ov2_forward_mb_plain(
        y_win[sub_d], sil[sub_d], c_sub), reps=1)
    k16_pairs = [(f16[sub_d], pf), (r16[sub_d], pr), (x16[sub_d], px)]
    k16_err = max_abs_err(k16_pairs)
    check(all(torch.equal(a, b) for a, b in k16_pairs),
          "kernel 16 differs from its plain version")
    S = c16.S
    k16_bytes = (y_win.numel() * 4 + B + B * (6 + S) * 4 + f16.numel()
                 + r16.numel() + B * 4)
    row16 = {"ms": k16_ms, "plain_ms": p16_ms, "plain_windows": P16,
             "max_abs_err": k16_err,
             "bound_ops_ms": fwd_ops(B, W, K - 1) / FP32_OPS_PER_S * 1e3,
             "bound_bytes_ms": k16_bytes / HBM_BYTES_PER_S * 1e3,
             **ov2_design(vmb, B, W, K - 1, dev, k16_ms,
                          lambda shape: vmb._forward_launch(
                              "ov2_forward_mb_tracked", y_win, sil, c16,
                              shape=shape))}
    row16["bound_ms"], row16["bound_by"] = bound_of(row16)
    # kernel 2 on kernel 16's output, every design forced; its plain
    # version on the same P16 windows on the CPU, in the worker (submitted
    # after the timed launches, so that handing the worker its inputs does
    # not stall them)
    run2 = lambda: vmb.ov2_backtrace_mb(f16, r16, x16, K - 1)  # noqa
    run2()
    k2_ms, lab2, k2_each = cuda_ms_launches(run2, reps=BT_REPS)
    k2_bytes, _ = ov2_bt_bytes(lab2, x16, f16, K - 1)
    row2 = {"ms": k2_ms, "launch_ms": k2_each, "plain_windows": P16,
            "plain_device": "cpu",
            "bound_ms": k2_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            **bt_row(lambda G, st: vmb._bt_launch(
                f16, r16, x16, K - 1, segments=G, stats=st),
                lambda G: vmb.ov2_bt_design(W, K - 1, G), lab2, W, k2_ms,
                reps=BT_REPS)}
    bt2_plain = cpu.submit(cpu_ov2_backtrace,
                           *(t[sub_d].cpu() for t in (f16, r16, x16)), K - 1)
    lab2_sub = lab2[sub_d].cpu()
    del y_win, f16, r16, x16, pf, pr, lab2
    secs["kernels16_2"] = time.perf_counter() - t_part

    # ---- kernels 17-18 at model_posteriors' T=2^21 (512 windows, two CTAs
    # an SM) vs their plain versions on the first P17 windows and forced to
    # every block shape; at T=2^19 (128 windows of 4096, the gamma pass
    # split) timed alone, their shape one of those checked --------------
    rows17 = {}
    for key, Tk in (("w512", T), ("t19", Tg)):
        t_part = time.perf_counter()
        yk, ybk, tmk, lwk, chk = gamma_mb.chain_inputs(y[:Tk], Tk, Lg, f32,
                                                       dev)
        own = tpost._window_owner(yk.shape[0], Lg, tr)
        pw = (tr.lp[own], tr.mu[own], tr.sigma[own])
        ck = vmb.ov2_consts(*pw, dtype=f32, device=dev)
        pw_d = tuple(torch.as_tensor(v, dtype=f32, device=dev) for v in pw)
        tmx_of = lambda ex: gamma_ov2.terminal_exits(   # noqa: E731
            ex, ybk, lwk, *pw_d)
        if key == "w512":
            ckp = vmb.ov2_consts(*(v[:P17] for v in pw), dtype=f32,
                                 device=dev)
            parts = gamma_kernels(
                lambda yw, en, hi, shape=None: gamma_ov2._fwd_launch(
                    "gamma_ov2_fwd_tracked", yw, en, hi, ck, gamma_ov2.CH2,
                    shape=shape),
                lambda yw, cp, en, hi, tx, tm_, _yb, _lw, e, shape=None:
                    gamma_ov2._bwd_launch(
                        "gamma_ov2_bwd_tracked", yw, cp, en, hi, tx, tm_, ck,
                        e, gamma_ov2.CH2, shape=shape),
                lambda yw, en, hi: gamma_ov2.gamma_ov2_fwd_plain(yw, en, hi,
                                                                 ckp),
                lambda yw, cp, en, hi, tx, tm_, _yb, _lw, e:
                    gamma_ov2.gamma_ov2_bwd_plain(yw, cp, en, hi, tx, tm_,
                                                  ckp, e),
                yk, ybk, tmk, lwk, chk, tmx_of, ck, S, P17, reps=3,
                shapes=ov2g_shapes(gamma_ov2, K - 1),
                fwd_shapes=ov2g_shapes(gamma_ov2, K - 1))
            by_shape = parts.pop("ms_by_shape")
            rows17[key] = ov2g_rows(gamma_ov2, parts, yk.shape[0], Lg, K - 1,
                                    P17, dev, S)
            rows17[key]["design"]["ms_by_shape"] = by_shape
        else:
            parts = ov2g_timed(
                gamma_ov2,
                lambda yw, en, hi: gamma_ov2.gamma_ov2_fwd_tracked(yw, en, hi,
                                                                   ck),
                lambda yw, cp, en, hi, tx, e: gamma_ov2.gamma_ov2_bwd_tracked(
                    yw, cp, en, hi, tx, tmk, ck, e),
                yk, chk, tmx_of, S, K - 1, by_shape,
                "drift_path: kernels 17-18")
            rows17[key] = ov2g_rows(gamma_ov2, parts, yk.shape[0], Lg, K - 1,
                                    0, dev, S)
        secs[f"kernels17_18_{key}"] = time.perf_counter() - t_part
        del yk, ck, parts

    # ---- --confidence --qc on the tracked decode (kernels 17-18) --------
    t_part = time.perf_counter()
    wr_post = (gamma_ov2.gamma_ov2_fwd_tracked,
               gamma_ov2.gamma_ov2_bwd_tracked)
    for w in wr_post:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    p = tpost.model_posteriors(m)
    conf = tpost.confidence_from_posteriors(p, m.spike_onsets,
                                            half_width=(K - 1) // 2)
    qa = tqc.qc_arrays(tqc.unit_qc(m, posteriors=p))
    conf_qc_s = time.perf_counter() - t
    post_launches = {w.__name__: w.launches for w in wr_post}
    torch.cuda.synchronize()
    t = time.perf_counter()
    tpost.model_posteriors(m)
    post_s = time.perf_counter() - t
    own_t = tpost._window_owner(-(-T // Lg), Lg, tr)
    args = (y, tr.lp[own_t], tr.mu[own_t], tr.sigma[own_t])
    t = time.perf_counter()
    p64 = gamma_ov2.onset_gammas_cuda_ov2_tracked(*args, L=Lg, dtype=f64,
                                                  plain=True)
    p64_s = time.perf_counter() - t
    post_err = float(np.abs(p - p64).max())
    # the float32 floor's witness (the plain float32 chain), only where the
    # kernels are above tests/test_pallas_gamma.py's 1e-4
    plain32_err = None
    if post_err > 1e-4:
        p32 = gamma_ov2.onset_gammas_cuda_ov2_tracked(*args, L=Lg,
                                                      dtype=f32, plain=True)
        plain32_err = float(np.abs(p32 - p64).max())
        del p32
    post_tol = min(1e-3, max(1e-4, plain32_err or 0.0))
    secs["posteriors_and_f64_piecewise"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    row_n3 = tracked_n3(dev)
    secs["tracked_n3"] = time.perf_counter() - t_part
    t = time.perf_counter()
    labels64, ll64, _, twin_s = twin.result()
    plab2, row2["plain_seconds"] = bt2_plain.result()
    row_tiles = kernel2_tiles_check(tiles)
    secs["cpu_worker_wait"] = time.perf_counter() - t
    row2["max_abs_err"] = max_abs_err([(lab2_sub, plab2)])
    check(torch.equal(lab2_sub, plab2),
          "kernel 2 differs from its plain version on kernel 16's output")
    agree = float((m.ml_seq == labels64).mean())
    emit({"phase": "drift_path", "N": 2, "K": K, "S": S, "T": T,
          "chunk": tr.chunk, "forget": tr.forget, "B": B, "W": W,
          "card": card,
          "fit_seconds": fit_s, "samples_per_s": T / fit_s,
          "track_seconds": track_s, "decode_seconds": decode_s,
          "decode_host_ll_seconds": host_ll_s,
          "fit_launches": fit_launches,
          "onset_errors_tracked": e_tracked,
          "onset_errors_stationary": e_static,
          "onsets_true": [int((truth[n] == 1).sum()) for n in range(2)],
          "seams": B - 1, "seams_repaired": m.seams_repaired,
          "f64_plain_twin_seconds": twin_s, "f64_plain_twin_device": "cpu",
          "agreement_vs_f64": agree, "ll": m.ll, "ll_f64": ll64,
          "amplitude_first_last": [float(np.abs(tr.mu[0]).max()),
                                   float(np.abs(tr.mu[-1]).max())],
          "kernel16": row16, "kernel2": row2, "kernel2_tiles": row_tiles,
          "tracked_n3": row_n3,
          "kernels17_18": {"T": Tg, **rows17["t19"]},
          "kernels17_18_512": rows17["w512"],
          # model_posteriors launches the forward twice, the backward once
          # each way
          "kernels17_18_ms_per_posteriors": ov2g_path_ms(rows17["w512"]),
          "kernels17_18_share_of_posteriors":
              ov2g_path_ms(rows17["w512"]) / 1e3 / post_s,
          "posterior_launches": post_launches,
          "conf_qc_seconds": conf_qc_s, "posteriors_seconds": post_s,
          "posterior_samples_per_s": T / post_s,
          "f64_plain_piecewise_seconds": p64_s,
          "max_abs_err_vs_f64_plain_piecewise": post_err,
          "plain_f32_piecewise_max_abs_err_vs_f64": plain32_err,
          "tolerance": post_tol,
          "median_confidence": [float(np.median(c)) for c in conf],
          "n_spikes": qa["n_spikes"].tolist(),
          "expected_onsets": p.sum(axis=0).tolist(),
          "isi_invariant_violations":
              qa["isi_invariant_violations"].tolist(),
          "seconds_by_part": secs})
    check(m.ml_seq.shape == (T,) and np.isfinite(m.ll),
          "drift_path: output malformed")
    check(fit_launches["ov2_forward_mb_tracked"] == 1
          and fit_launches["ov2_backtrace_mb"] == 1,
          f"drift_path: kernels 16 + 2 launches {fit_launches}")
    check(fit_launches["em_forward_mb"] >= T // tr.chunk
          and fit_launches["em_backward_mb"] >= T // tr.chunk,
          f"drift_path: the tracking did not run kernels 5-6 {fit_launches}")
    check(agree >= 0.9999, f"drift_path: f32 vs f64 agreement {agree}")
    check(e_tracked < e_static, f"drift_path: tracked onset errors "
          f"{e_tracked} not below the stationary decode's {e_static}")
    check(list(post_launches.values()) == [2, 2],
          f"drift_path: posterior launches {post_launches}, expected 2 + 2")
    check(p.shape == (T, 2) and np.isfinite(p).all(),
          "drift_path: posteriors malformed")
    check(post_err <= post_tol, f"drift_path: {post_err} from the float64 "
          f"plain chained piecewise run (> {post_tol})")
    check(all(np.median(c) > 0.9 for c in conf),
          "drift_path: median confidence below 0.9")
    check(all(v == 0 for v in qa["isi_invariant_violations"]),
          "drift_path: ISI invariant violated")
    return {"row16": row16, "rows17": rows17, "fit_launches": fit_launches,
            "post_launches": post_launches, "cli": (tm0, y, m)}


def drift_path_mc(dev, card, cpu, T=1 << 20, chunk=32768, P11=4,
                  W11=1200, post_chunks=2):
    """The multichannel drift-adaptive path at config 6's full width: N=3,
    K=60, C=4 (config6 with a linear 1x -> 2x amplitude ramp over T=2^20).
    models/multichannel.fit_spiking_model_adaptive_mc at the CLI defaults
    (chunk 32768, forget 0.3: 32 chunks, decode windows of W=33,248 at
    H=240) with the launch counts of kernels 12-13 (tracking) and kernel 11's
    per-window mode + kernel 4 (decode) set to 0 just before and read just
    after; the tracking, decode and host ll timed apart; onset errors of the
    tracked and of a stationary fit_spiking_model_mc_fast decode against
    the truth. Kernel 11's per-window mode on the decode's own inputs (each
    window's streams and constants from train/adaptive._mc_win_streams):
    timed, and exactly equal to B one-window shared launches under each
    window's constants (flags, rings, rowcol, xT, and kernel 4's labels on
    each); on the first P11 windows cut to W11 steps (pairwise different
    constants) exactly equal to its batched plain version. A constant
    track's labels equal the stationary kernel-11 decode's at the same
    windows. The tracked posteriors with overlaps off (S=178) on the first
    `post_chunks` chunks (float32 plain engines on the card) against a
    float64 run on the CPU (in the worker `cpu`). Returns the kernel row,
    the launches and (model template, signal, decoded model) for
    cli_path."""
    import dataclasses

    from hmmspikesorter_torch.core import events as tevents
    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.data.synthetic import (create_signal,
                                                     create_spike_template)
    from hmmspikesorter_torch.models import multichannel as mcm
    from hmmspikesorter_torch.ops import fb_mb
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
    from hmmspikesorter_torch.parallel.overlap_save import _build_windows
    from hmmspikesorter_torch.train import adaptive as tad

    f32 = torch.float32
    secs, t_part = {}, time.perf_counter()
    yc, truth, mu, sg, lp = config6(T, create_signal, create_spike_template,
                                    scale_end=2.0)
    K, N, C = mu.shape
    tm0 = mcm.HMMTemplateModelMC(mu=mu, sigmas=sg, lp=lp,
                                 allow_overlaps=True)
    wr_fit = (fb_mb.em_forward_mb_mc, fb_mb.em_backward_mb_mc,
              vomb.ovn_mc_forward_mb_tracked, vomb.ovn_backtrace_mb)
    mcm.fit_spiking_model_adaptive_mc(tm0, yc, chunk=chunk)   # warm-up
    for w in wr_fit:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    m = mcm.fit_spiking_model_adaptive_mc(tm0, yc, chunk=chunk)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    fit_launches = {w.__name__: w.launches for w in wr_fit}
    tr = m.track
    # the posterior reference on the CPU meanwhile: overlaps off, the first
    # post_chunks chunks
    Tp = post_chunks * chunk
    tr_p = dataclasses.replace(
        tr, lp=tr.lp[:post_chunks], mu=tr.mu[:post_chunks],
        sigma=tr.sigma[:post_chunks], lls=tr.lls[:post_chunks],
        bounds=tr.bounds[:post_chunks], allow_overlaps=False)
    ref_p = cpu.submit(cpu_tracked_mc_posteriors, tr_p, yc[:Tp])
    t = time.perf_counter()
    tr2 = tad.track_drift_mc(tm0, yc, chunk=chunk)
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t
    t = time.perf_counter()
    m2 = tad.decode_tracked_mc(tr2, yc)
    decode_s = time.perf_counter() - t
    t = time.perf_counter()
    tad._piecewise_path_ll_mc(yc, m2.ml_seq, tr2, tm0.state_space)
    host_ll_s = time.perf_counter() - t
    check(np.array_equal(m2.ml_seq, m.ml_seq) and np.array_equal(tr2.mu,
                                                                  tr.mu),
          "drift_path_mc: a second run gave another track or other labels")
    m_static = mcm.fit_spiking_model_mc_fast(tm0, yc)
    e_tracked = onset_errors(m.spike_onsets, truth)
    e_static = onset_errors(tevents._onsets_dense(m_static.ml_seq, N=N, K=K,
                                                  overlaps=True), truth)
    secs["fits_and_decodes"] = time.perf_counter() - t_part

    # ---- kernel 11's per-window mode on the decode's own inputs ---------
    t_part = time.perf_counter()
    L, H = tr.chunk, max(4 * K, 64)
    W, B = L + 2 * H, -(-T // L)
    y_win, _ = _build_windows(torch.as_tensor(yc, dtype=f32, device=dev),
                              T=T, L=L, H=H, B=B, W=W)
    es, d, tb, lp_t = tad._mc_win_streams(y_win, tr.lp, tr.mu, tr.sigma,
                                          device=dev, dtype=f32)
    del y_win
    sil = torch.arange(B, device=dev) == 0
    c11 = vomb.ovn_mc_consts_batched(lp_t, tb.c1, tb.c2_stack, dtype=f32,
                                     device=dev)
    run11 = lambda: vomb.ovn_mc_forward_mb_tracked(es, d, sil, c11)  # noqa
    run11()
    k11_ms, got = cuda_ms(run11, reps=3)
    labels = vomb.ovn_backtrace_mb(*got, c11)
    for b in range(B):
        one = vomb.ovn_mc_forward_mb(es[b:b + 1], d[b:b + 1], sil[b:b + 1],
                                     c11.windows[b])
        lab1 = vomb.ovn_backtrace_mb(*one, c11.windows[b])
        check(all(torch.equal(a[b:b + 1], r) for a, r in zip(got, one))
              and torch.equal(labels[b:b + 1], lab1),
              f"drift_path_mc: kernel 11's window {b} differs from a "
              "one-window shared launch under its constants")
    one_ms, _ = cuda_ms(lambda: vomb.ovn_mc_forward_mb(
        es[:1], d[:1], sil[:1], c11.windows[0]), reps=3)
    secs["kernel11_vs_one_window_launches"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    sub = slice(0, P11)
    es_p, d_p = es[sub, :W11].contiguous(), d[sub, :W11].contiguous()
    cp = vomb.OvnMCConstsBatched(windows=c11.windows[sub],
                                 fpack=c11.fpack[sub].contiguous(),
                                 c2=c11.c2[sub].contiguous())
    check(len({tuple(w.fpack.tolist()) for w in cp.windows}) == P11,
          "drift_path_mc: the plain-checked windows share constants")
    got_p = vomb.ovn_mc_forward_mb_tracked(es_p, d_p, sil[sub], cp)
    p11_ms, plain = cuda_ms(lambda: vomb.ovn_mc_forward_mb_plain(
        es_p, d_p, sil[sub], cp), reps=1)
    k11_pairs = list(zip(got_p, plain))
    k11_err = max_abs_err(k11_pairs)
    check(all(torch.equal(a, b) for a, b in k11_pairs),
          "drift_path_mc: kernel 11's per-window mode differs from its "
          "plain version")
    lab_p = vomb.ovn_backtrace_mb(*got_p, cp)
    check(torch.equal(lab_p, vomb.ovn_backtrace_mb_plain(*plain, cp).to(
        torch.int16)), "drift_path_mc: kernel 4 differs from its plain "
          "version on the per-window output")
    secs["kernel11_vs_plain"] = time.perf_counter() - t_part
    flags, rings, rowcol, xT = got
    k11_bytes = (es.numel() * 4 + d.numel() * 4 + B
                 + c11.fpack.numel() * 4 + c11.ipack.numel() * 4
                 + c11.c2.numel() * 4 + flags.numel() + rings.numel()
                 + rowcol.numel() + B * 4)
    row11 = {"N": N, "B": B, "W": W, "K": K, "S": c11.S,
             "ms": k11_ms, "plain_ms": p11_ms, "plain_windows": P11,
             "plain_steps": W11, "max_abs_err": k11_err,
             "one_window_shared_ms": one_ms,
             "us_per_window_step": k11_ms * 1e3 / W,
             "bound_ops_ms": ovn_fwd_ops(B, W, N, K - 1, streams=True)
             / FP32_OPS_PER_S * 1e3,
             "bound_bytes_ms": k11_bytes / HBM_BYTES_PER_S * 1e3}
    row11["bound_ms"], row11["bound_by"] = bound_of(row11)
    del es, d, got, flags, rings, rowcol, labels, plain, got_p

    # ---- a constant track decodes as the stationary kernel-11 decode ---
    t_part = time.perf_counter()
    const = dataclasses.replace(
        tr, lp=np.tile(lp, (B, 1)), mu=np.tile(mu, (B, 1, 1, 1)),
        sigma=np.tile(sg, (B, 1)))
    m_const = tad.decode_tracked_mc(const, yc)
    m_stat_w = mcm.fit_spiking_model_mc_fast(tm0, yc, L=L, H=H)
    const_equal = bool(np.array_equal(m_const.ml_seq, m_stat_w.ml_seq))
    const_agree = float((m_const.ml_seq == m_stat_w.ml_seq).mean())
    secs["constant_track"] = time.perf_counter() - t_part

    # ---- the tracked posteriors, overlaps off (S=178) ------------------
    t_part = time.perf_counter()
    t = time.perf_counter()
    p32 = tpost.onset_posteriors_tracked_mc(tr_p, yc[:Tp])
    post_s = time.perf_counter() - t
    t = time.perf_counter()
    p64, p64_s = ref_p.result()
    secs["cpu_worker_wait"] = time.perf_counter() - t
    post_err = float(np.abs(p32 - p64).max())
    secs["posteriors"] = time.perf_counter() - t_part
    n_chunks = T // chunk
    emit({"phase": "drift_path_mc", "N": N, "K": K, "C": C, "S": c11.S,
          "T": T, "chunk": tr.chunk, "forget": tr.forget, "B": B, "W": W,
          "card": card, "fit_seconds": fit_s, "samples_per_s": T / fit_s,
          "track_seconds": track_s, "decode_seconds": decode_s,
          "decode_host_ll_seconds": host_ll_s,
          "fit_launches": fit_launches,
          "onset_errors_tracked": e_tracked,
          "onset_errors_stationary": e_static,
          "onsets_true": [int((truth[n] == 1).sum()) for n in range(N)],
          "seams": B - 1, "seams_repaired": m.seams_repaired,
          "ll": m.ll,
          "amplitude_first_last": [float(np.abs(tr.mu[0]).max()),
                                   float(np.abs(tr.mu[-1]).max())],
          "kernel11_per_window": row11,
          "constant_track_labels_equal_stationary": const_equal,
          "constant_track_agreement": const_agree,
          "posteriors": {"T": Tp, "S": tr_p.model_at(0).state_space.nstates,
                         "seconds": post_s, "f64_seconds": p64_s,
                         "f64_device": "cpu",
                         "max_abs_err_vs_f64": post_err,
                         "expected_onsets": p32.sum(axis=0).tolist()},
          "seconds_by_part": secs})
    check(m.ml_seq.shape == (T,) and np.isfinite(m.ll),
          "drift_path_mc: output malformed")
    check(fit_launches["ovn_mc_forward_mb_tracked"] == 1
          and fit_launches["ovn_backtrace_mb"] == 1,
          f"drift_path_mc: kernel 11 + 4 launches {fit_launches}")
    check(fit_launches["em_forward_mb_mc"] >= n_chunks
          and fit_launches["em_backward_mb_mc"] >= n_chunks,
          f"drift_path_mc: the tracking did not run kernels 12-13 on every "
          f"chunk {fit_launches}")
    check(e_tracked < e_static, f"drift_path_mc: tracked onset errors "
          f"{e_tracked} not below the stationary decode's {e_static}")
    check(const_equal, "drift_path_mc: a constant track's labels differ from "
          f"the stationary kernel-11 decode's ({const_agree})")
    check(p32.shape == (Tp, N) and np.isfinite(p32).all(),
          "drift_path_mc: posteriors malformed")
    # the float32 floor (ROADMAP §3): the run is the plain float32 engines
    # themselves, so their own error is the witness, capped at 1e-3
    check(post_err <= 1e-3, f"drift_path_mc: posteriors {post_err} from the "
          "float64 run (> 1e-3)")
    return {"row11": row11, "fit_launches": fit_launches,
            "cli": (tm0, yc, m)}


def events_path(dev, card, sc, n3, mc6, drift, L=8192, H6=256, R=6,
                Tb=1 << 19, Cb=4):
    """The events transfer (core/events.py) and the channel-batched decode
    on the card, on inputs and dense labels that earlier phases already
    held to the plain versions and the float64 twin (no plain version runs
    here):
      - N=2 one-shot on the bench.py problem (main_path's recording, T=2^21,
        L=8192): decode_events_overlap_save's labels equal main_path's dense
        labels bit for bit (bench.py:94's assert), every seam ok, the events
        branch taken, kernels 1 and 2 once a call; timed as bench.py:97-110
        times it (one warm-up, then R calls two deep, the oldest call's
        blob copied to pinned memory behind its decode and its labels
        rebuilt on the host while the card works), and the dense one-shot
        timed the same way; the blob's and the dense labels' bytes, the
        device-to-host seconds of each and the host rebuild's;
      - streaming: fit_spiking_model_fast(streaming=True, transfer="events")
        gives the same labels;
      - N=3 (main_path_n3's recording): the one-shot events labels equal the
        dense ones, kernels 3 and 4 launched;
      - multichannel (config 6): the one-shot events decode (kernels 11 and
        4) equals main_path_mc's dense labels;
      - tracked: drift_path's track decoded with transfer="events" (kernels
        16 and 2) equals its dense tracked labels;
      - batched: Cb channels of Tb samples of the bench.py signal (Cb*Tb/L
        windows, main_path's B) through fit_spiking_models_fast_batched:
        one launch each of kernels 1 and 2, labels and seam flags equal to
        each channel's own fit_spiking_model_fast; the batched events labels
        equal the batched dense ones.
    Returns the per-channel library decodes of the first two channels for
    cli_path."""
    from hmmspikesorter_torch.core import events as tev
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.models import multichannel as mcm
    from hmmspikesorter_torch.ops import viterbi_mb as vmb
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
    from hmmspikesorter_torch.parallel.overlap_save import (
        resolve_block_engine, ring_overlap_save)
    from hmmspikesorter_torch.train import adaptive as tad

    f32 = torch.float32
    tm, y, decoded = sc
    K, N = tm.mu.shape
    T = len(y)
    H = max(4 * K, 64)
    B = -(-T // L)
    wr2 = (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb)
    out, secs, t_part = {}, {}, time.perf_counter()

    def branch(dense_model):
        """The branch an events decode takes where the dense decode of the
        same recording repaired no seam (events) or some (dense)."""
        ev = dense_model.seams_repaired == 0
        return {"events": int(ev), "dense": int(not ev)}

    def counted(wrappers, fn):
        for w in wrappers:
            w.launches = 0
        tev.BRANCHES.update(events=0, dense=0)
        res = fn()
        torch.cuda.synchronize()
        return res, {w.__name__: w.launches for w in wrappers}, dict(
            tev.BRANCHES)

    # ---- N=2 one-shot on the bench problem ------------------------------
    y_d = torch.as_tensor(y, dtype=f32, device=dev)
    be = resolve_block_engine("auto", True, K, N, dev)
    kw = dict(L=L, H=H, overlaps=True, device=dev, dtype=f32)
    tev.decode_events_overlap_save(y_d, tm.lp, tm.mu, tm.sigma,
                                   **kw)                   # warm-up
    (on2, x2, ok2), l2, br2 = counted(wr2, lambda: (
        tev.decode_events_overlap_save(y_d, tm.lp, tm.mu, tm.sigma, **kw)))
    check(np.array_equal(x2, decoded.ml_seq),
          "events_path: N=2 events labels differ from main_path's dense "
          "labels")
    check(ok2.all() and br2 == {"events": 1, "dense": 0},
          f"events_path: N=2 took {br2}, seams ok {bool(ok2.all())}")
    check(l2 == {"ov2_forward_mb": 1, "ov2_backtrace_mb": 1},
          f"events_path: N=2 launches {l2}")

    def decode_on_card(dense):
        """The dense labels or the event blob of one call, on the card."""
        if dense:
            return ring_overlap_save(y_d, tm.lp, tm.mu, tm.sigma,
                                     block_engine=be, **kw)[0]
        return tev._ring_overlap_save_events_impl(
            y_d, tm.lp, tm.mu, tm.sigma, block_engine=be, **kw)[0]

    def run_async(dense, host):
        """One call with its result's copy into the pinned buffer `host`
        queued behind it; (host, event) without waiting."""
        host.copy_(decode_on_card(dense), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def labels_of(item, dense):
        host, done = item
        done.synchronize()
        if dense:
            return host.numpy().astype(np.int32)
        pk, cn, x0, ok = tev._parse_event_blob(host.numpy(), T=T, N=N, K=K,
                                               B=B)
        return tev.labels_from_onsets(tev.onsets_from_packed(pk, cn, K=K),
                                      x0, T=T, N=N, K=K, overlaps=True)

    def pipelined(dense):
        """bench.py:97-110: R calls two deep, the oldest rebuilt while the
        card works; three pinned buffers, allocated before the timed loop,
        taken in turn. Returns (samples/s, launches, the last labels, host
        seconds: enqueueing the calls, and waiting for and rebuilding the
        labels)."""
        res = decode_on_card(dense)                           # warm-up
        ring = [torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
                for _ in range(3)]
        check(np.array_equal(labels_of(run_async(dense, ring[0]), dense),
                             decoded.ml_seq),
              f"events_path: pipelined {'dense' if dense else 'events'} "
              "labels differ")
        del res
        for w in wr2:
            w.launches = 0
        host = {"enqueue": 0.0, "wait_and_labels": 0.0}

        def timed(part, fn, *a):
            t = time.perf_counter()
            res = fn(*a)
            host[part] += time.perf_counter() - t
            return res

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = [timed("enqueue", run_async, dense, ring[0]),
             timed("enqueue", run_async, dense, ring[1])]
        for i in range(2, R):
            q.append(timed("enqueue", run_async, dense, ring[i % 3]))
            timed("wait_and_labels", labels_of, q.pop(0), dense)
        for item in q:
            last = timed("wait_and_labels", labels_of, item, dense)
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in wr2}
        check(np.array_equal(last, decoded.ml_seq)
              and all(v == R for v in launches.values()),
              f"events_path: pipelined {'dense' if dense else 'events'}: "
              f"labels differ or launches {launches}, expected {R}")
        return R * T / wall, {"wall": wall, **host}

    # in turns, events, dense, dense, events: two readings of each
    turns = [pipelined(dense) for dense in (False, True, True, False)]
    ev_runs, de_runs = [turns[0], turns[3]], [turns[1], turns[2]]
    # the transfers apart: each copy after a synchronize, and the rebuild
    blob, x_dense = tev._ring_overlap_save_events_impl(
        y_d, tm.lp, tm.mu, tm.sigma, block_engine=be, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    blob_h = blob.cpu().numpy()
    blob_s = time.perf_counter() - t
    t = time.perf_counter()
    dense_h = x_dense.cpu().numpy()
    dense_s = time.perf_counter() - t
    t = time.perf_counter()
    pk, cn, x0, _ = tev._parse_event_blob(blob_h, T=T, N=N, K=K, B=B)
    x_rb = tev.labels_from_onsets(tev.onsets_from_packed(pk, cn, K=K), x0,
                                  T=T, N=N, K=K, overlaps=True)
    rebuild_s = time.perf_counter() - t
    check(np.array_equal(x_rb, dense_h), "events_path: rebuild differs")
    out["n2"] = {"T": T, "L": L, "H": H, "B": B, "launches": l2,
                 "branches": br2, "seams_ok": bool(ok2.all()),
                 "onsets": [len(o) for o in on2],
                 "pipelined_calls": R, "pipelined_order":
                 "events, dense, dense, events",
                 "events_samples_per_s": [r[0] for r in ev_runs],
                 "dense_samples_per_s": [r[0] for r in de_runs],
                 "events_host_seconds": [r[1] for r in ev_runs],
                 "dense_host_seconds": [r[1] for r in de_runs],
                 "blob_bytes": int(blob.numel()),
                 "dense_bytes": int(x_dense.numel()
                                    * x_dense.element_size()),
                 "blob_d2h_seconds": blob_s, "dense_d2h_seconds": dense_s,
                 "host_rebuild_seconds": rebuild_s}
    del blob, x_dense, y_d
    secs["n2_oneshot"] = time.perf_counter() - t_part

    # ---- streaming with the event blob as each call's copy --------------
    t_part = time.perf_counter()
    st, l_st, br_st = counted(wr2, lambda: api.fit_spiking_model_fast(
        tm, y, L=L, streaming=True, transfer="events"))
    check(np.array_equal(st.ml_seq, decoded.ml_seq) and st.seam_ok.all(),
          "events_path: streaming events labels differ")
    check(all(l_st.values()), f"events_path: streaming launches {l_st}")
    out["streaming"] = {"launches": l_st,
                        "onsets": [len(o) for o in st.spike_onsets]}
    secs["streaming"] = time.perf_counter() - t_part

    # ---- N=3: main_path_n3's recording ---------------------------------
    t_part = time.perf_counter()
    tm3, y3, dec3, H3 = n3
    wr3 = (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb)
    m3, l3, br3 = counted(wr3, lambda: api.fit_spiking_model_fast(
        tm3, y3, L=L, H=H3, transfer="events"))
    check(np.array_equal(m3.ml_seq, dec3.ml_seq),
          "events_path: N=3 events labels differ from the dense ones")
    check(all(v == 1 for v in l3.values()) and br3 == branch(dec3),
          f"events_path: N=3 launches {l3}, branches {br3}")
    out["n3"] = {"T": len(y3), "launches": l3, "branches": br3}
    secs["n3"] = time.perf_counter() - t_part

    # ---- multichannel: config 6 (kernels 11 and 4) ----------------------
    t_part = time.perf_counter()
    (yc6, _, mu6, sg6, lp6), dec6 = mc6
    tm6 = mcm.HMMTemplateModelMC(mu=mu6, sigmas=sg6, lp=lp6,
                                 allow_overlaps=True)
    wr11 = (vomb.ovn_mc_forward_mb, vomb.ovn_backtrace_mb)
    m6, l6, br6 = counted(wr11, lambda: mcm.fit_spiking_model_mc_fast(
        tm6, yc6, L=L, H=H6, transfer="events"))
    check(np.array_equal(m6.ml_seq, dec6.ml_seq),
          "events_path: MC events labels differ from main_path_mc's")
    check(all(v == 1 for v in l6.values()) and br6 == branch(dec6),
          f"events_path: MC launches {l6}, branches {br6}")
    out["mc"] = {"T": len(yc6), "launches": l6, "branches": br6}
    secs["mc"] = time.perf_counter() - t_part

    # ---- tracked: drift_path's track (kernels 16 and 2) ----------------
    t_part = time.perf_counter()
    _, y_dr, dec_dr = drift
    wr16 = (vmb.ov2_forward_mb_tracked, vmb.ov2_backtrace_mb)
    md, ld, brd = counted(wr16, lambda: tad.decode_tracked(
        dec_dr.track, y_dr, transfer="events"))
    check(np.array_equal(md.ml_seq, dec_dr.ml_seq),
          "events_path: tracked events labels differ from the dense ones")
    check(all(v == 1 for v in ld.values()) and brd == branch(dec_dr),
          f"events_path: tracked launches {ld}, branches {brd}")
    out["tracked"] = {"T": len(y_dr), "launches": ld, "branches": brd}
    secs["tracked"] = time.perf_counter() - t_part

    # ---- batched: Cb channels of the bench signal -----------------------
    t_part = time.perf_counter()
    ys = np.asarray(y[:Cb * Tb]).reshape(Cb, Tb)
    per = [api.fit_spiking_model_fast(tm, row, L=L) for row in ys]
    mb, lb, _ = counted(wr2, lambda: api.fit_spiking_models_fast_batched(
        tm, ys, L=L))
    mbe, lbe, bre = counted(wr2, lambda: api.fit_spiking_models_fast_batched(
        tm, ys, L=L, transfer="events"))
    check(lb == lbe == {"ov2_forward_mb": 1, "ov2_backtrace_mb": 1},
          f"events_path: batched launches {lb} {lbe}, expected one each")
    check(all(np.array_equal(a.ml_seq, b.ml_seq)
              and np.array_equal(a.seam_ok, b.seam_ok)
              for a, b in zip(mb, per)),
          "events_path: batched labels differ from the per-channel decodes")
    check(all(np.array_equal(a.ml_seq, b.ml_seq) for a, b in zip(mbe, mb))
          and bre["events"] == sum(m.seams_repaired == 0 for m in mb),
          f"events_path: batched events differ from dense ({bre})")
    out["batched"] = {"channels": Cb, "T": Tb, "windows": Cb * (Tb // L),
                      "launches": lb, "events_launches": lbe,
                      "branches": bre,
                      "seams_ok": [bool(m.seam_ok.all()) for m in mb]}
    secs["batched"] = time.perf_counter() - t_part
    emit({"phase": "events_path", "card": card, "seconds_by_part": secs,
          **out})
    return ys[:2], per[:2]


def dense_seams(y, temps, L, halfwidth):
    """Back-to-back spikes of the first two neurons, staggered by K//2,
    over [s - halfwidth, s + halfwidth) around every seam s = L, 2L, ...
    (tests/test_seam_repair.py's recipe, which tests/test_torch_overlap_save.py
    reuses): the combined state is never silent there, so no seam finds a
    common silence and every one goes to seam repair. y (T,) with temps
    (K, N), or (T, C) with (K, N, C): the spikes on every channel."""
    K = temps.shape[0]
    for seam in range(L, len(y) - halfwidth, L):
        for n, phase in ((0, 0), (1, K // 2)):
            t = seam - halfwidth + phase
            while t < seam + halfwidth:
                end = min(t + K - 1, len(y))
                y[t:end] += temps[1:1 + (end - t), n]
                t += K


def cli_path(dev, card, cpu, sc, config6_, drift, rows2, mc_drift,
             T_mc=1 << 14, L=8192):
    """The CLI's body on arrays (hmmspikesorter_torch.cli._sort_loaded, all
    of sort_data after the HDF5 loaders), writing the MAT file with
    scipy.io.savemat under build/cli_path/ and reading it back:
      (a) the single-channel production run, --engine fast --confidence
          --qc, on bench.py's problem at T=2^21 (kernels 1-2 and 9-10);
          labels equal main_path's library decode;
      (a') a recording of 4 windows whose seams find no common silence
          (dense_seams): the library decode repairs them (seams_repaired >
          0) and the CLI's labels equal the float64 plain twin's (on the
          CPU, in the worker `cpu`);
      (b) --multichannel --engine fast --confidence --qc on config 6 with
          overlaps on (kernels 11 + 4, then the plain ovn MC posteriors at
          S=10,621: exact two-pass below 8192 samples, chained from 8192),
          cut to T_mc samples; labels equal the library decode's; the error
          of the float32 posteriors the CLI computed against a float64 run
          on the CPU (in the worker `cpu`, beside (a') and (b));
      (c) --adaptive --confidence --qc on drift_path's drifting recording
          (T=2^21; kernels 5-6, 16 + 2 and 17-18); labels equal the
          library's fit_spiking_model_adaptive decode;
      (d) --engine fast --transfer events on (a)'s recording: the MAT
          dict's mlseq, ll, waveforms, lp and sigma equal (a)'s;
      (e) --channels all --engine fast on a 2-row recording (`rows2`: the
          rows and their per-channel library decodes from events_path):
          one launch each of kernels 1 and 2, mlseq and ll equal the
          library decodes';
      (f) --multichannel --adaptive on drift_path_mc's drifting config-6
          recording (`mc_drift`; T=2^20; kernels 12-13, kernel 11's
          per-window mode + kernel 4): mlseq and ll equal the library's
          fit_spiking_model_adaptive_mc decode."""
    import pathlib

    import scipy.io

    from hmmspikesorter_torch import cli
    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.io.extraction import unroll_mlseq
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.models import multichannel as mcm
    from hmmspikesorter_torch.ops import fb_mb, gamma_ov2
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
    secs = {}
    yc6, _, mu6, sg6, lp6 = config6_
    yc_b = np.asarray(yc6[:T_mc], np.float64)
    t_part = time.perf_counter()
    # ---- (a) the single-channel production run ---------------------------
    out_a, wall_a, la_a = run(
        tm, y, "sc", full, (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb,
                            gamma_ov2.gamma_ov2_fwd, gamma_ov2.gamma_ov2_bwd))
    ref_a = unroll_mlseq(decoded.ml_seq, tm.state_space.states) + 1
    qc_a = out_a.get("qc", {})
    secs["sc"] = time.perf_counter() - t_part
    # ---- (a') forced seam repair ------------------------------------------
    t_part = time.perf_counter()
    y_s = np.array(y[:4 * L])
    dense_seams(y_s, temps, L, 600)
    # the worker's queue: this twin, then (b)'s float64 posteriors
    twin_s = cpu.submit(cpu_decode_twin, tm.mu, tm.sigma, tm.lp, y_s, L,
                        None)
    ref_b64 = cpu.submit(cpu_mc_posteriors, mu6, sg6, lp6, yc_b)
    lib_s = api.fit_spiking_model_fast(tm, y_s, streaming=True, L=L)
    secs["seams_library"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    out_s, wall_s, _ = run(tm, y_s, "seams", cli._options(engine="fast"),
                           ())
    secs["seams_cli"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    labels_s64, _, seams_s64, twin_s_s = twin_s.result()
    ref_s = unroll_mlseq(labels_s64, tm.state_space.states) + 1
    secs["seams_f64_twin_wait"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    # ---- (b) the multichannel run on config 6, overlaps on --------------
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
    secs["mc_cli"] = time.perf_counter() - t_part
    # ---- (c) the drift-adaptive run ---------------------------------------
    t_part = time.perf_counter()
    tm_d, y_d, lib_d = drift
    out_d, wall_d, la_d = run(
        tm_d, y_d, "adaptive", cli._options(adaptive=True, confidence=True,
                                            qc=True),
        (vmb.ov2_forward_mb_tracked, vmb.ov2_backtrace_mb,
         gamma_ov2.gamma_ov2_fwd_tracked, gamma_ov2.gamma_ov2_bwd_tracked))
    ref_d = unroll_mlseq(lib_d.ml_seq, tm_d.state_space.states) + 1
    secs["adaptive_cli"] = time.perf_counter() - t_part
    # ---- (d) the events transfer, (e) the batched channels -------------
    t_part = time.perf_counter()
    out_e, wall_e, la_e = run(tm, y, "events",
                              cli._options(engine="fast", transfer="events"),
                              (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb))
    secs["events_cli"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    ys2, lib2 = rows2
    out_f, wall_f, la_f = run(tm, ys2, "channels_all",
                              cli._options(engine="fast", channels="all"),
                              (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb))
    ref_f = np.stack([unroll_mlseq(m.ml_seq, tm.state_space.states) + 1
                      for m in lib2])
    secs["channels_all_cli"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    tm_g, yc_g, lib_g = mc_drift
    out_g, wall_g, la_g = run(
        tm_g, np.ascontiguousarray(yc_g.T), "adaptive_mc",
        cli._options(adaptive=True, multichannel=True),
        (fb_mb.em_forward_mb_mc, fb_mb.em_backward_mb_mc,
         vomb.ovn_mc_forward_mb_tracked, vomb.ovn_backtrace_mb))
    ref_g = unroll_mlseq(lib_g.ml_seq, tm_g.state_space.states) + 1
    secs["adaptive_mc_cli"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    lib_b = mcm.fit_spiking_model_mc_fast(tm6, yc_b, L=L)
    ref_b = unroll_mlseq(lib_b.ml_seq, tm6.state_space.states) + 1
    t = time.perf_counter()
    p64, p64_s = ref_b64.result()
    secs["mc_f64_posteriors_wait"] = time.perf_counter() - t
    p32 = captured[0]
    p_err = float(np.abs(p32 - p64).max())
    secs["mc_library"] = time.perf_counter() - t_part - secs[
        "mc_f64_posteriors_wait"]
    emit({"phase": "cli_path", "card": card, "seconds_by_part": secs,
          "sc": {"T": len(y), "seconds": wall_a,
                 "samples_per_s": len(y) / wall_a, "launches": la_a,
                 "keys": sorted(out_a),
                 "n_spikes": np.asarray(qc_a.get("n_spikes", [])).tolist(),
                 "median_confidence": [float(np.median(c))
                                       for c in out_a["confidence"]]},
          "seams": {"T": len(y_s), "seconds": wall_s,
                    "seams_repaired": lib_s.seams_repaired,
                    "seams_repaired_f64": seams_s64,
                    "f64_twin_seconds": twin_s_s, "f64_twin_device": "cpu",
                    "agreement_vs_f64": float((out_s["mlseq"]
                                               == ref_s).mean())},
          "events": {"T": len(y), "seconds": wall_e,
                     "samples_per_s": len(y) / wall_e, "launches": la_e},
          "channels_all": {"channels": len(ys2), "T": ys2.shape[1],
                           "seconds": wall_f, "launches": la_f},
          "adaptive_mc": {"T": len(yc_g), "seconds": wall_g,
                          "samples_per_s": len(yc_g) / wall_g,
                          "launches": la_g, "keys": sorted(out_g)},
          "adaptive": {"T": len(y_d), "seconds": wall_d,
                       "samples_per_s": len(y_d) / wall_d,
                       "launches": la_d, "keys": sorted(out_d),
                       "median_confidence": [float(np.median(c))
                                             for c in out_d["confidence"]]},
          "mc": {"T": T_mc, "N": tm6.n_neurons, "C": tm6.n_channels,
                 "S": tm6.state_space.nstates, "seconds": wall_b,
                 "samples_per_s": T_mc / wall_b, "launches": la_b,
                 "keys": sorted(out_b),
                 "median_confidence": [float(np.median(c))
                                       for c in out_b["confidence"]],
                 "posteriors_f64_seconds": p64_s,
                 "posteriors_f64_device": "cpu",
                 "posteriors_f32_max_abs_err_vs_f64": p_err,
                 "expected_onsets": p32.sum(axis=0).tolist()}})
    for name, out, ref, tm_r, T_r in (("sc", out_a, ref_a, tm, len(y)),
                                      ("adaptive", out_d, ref_d, tm_d,
                                       len(y_d)),
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
    check(all(la_a.values()) and all(la_b.values()) and all(la_d.values())
          and all(la_e.values()),
          f"cli_path: a kernel did not run: {la_a} {la_b} {la_d} {la_e}")
    check(set(out_e) == keys - {"confidence", "qc"}
          and all(np.array_equal(out_e[k], out_a[k])
                  for k in ("mlseq", "ll", "waveforms", "lp", "sigma")),
          "cli_path events: the MAT dict differs from the dense run's")
    check(np.array_equal(out_f["mlseq"], ref_f)
          and np.array_equal(out_f["ll"], [m.ll for m in lib2]),
          "cli_path channels_all: labels or ll differ from the library "
          "decodes")
    check(la_f == {"ov2_forward_mb": 1, "ov2_backtrace_mb": 1},
          f"cli_path channels_all: launches {la_f}, expected one each")
    check(set(out_g) == keys - {"confidence", "qc"}
          and np.array_equal(out_g["mlseq"], ref_g)
          and out_g["ll"] == lib_g.ll,
          "cli_path adaptive_mc: labels or ll differ from the library "
          "decode")
    check(la_g["ovn_mc_forward_mb_tracked"] == 1
          and la_g["ovn_backtrace_mb"] == 1 and la_g["em_forward_mb_mc"] > 0,
          f"cli_path adaptive_mc: launches {la_g}")
    check(lib_s.seams_repaired > 0,
          f"cli_path: no seam was repaired ({lib_s.seams_repaired})")
    check(np.array_equal(out_s["mlseq"], ref_s),
          "cli_path: repaired labels differ from the float64 plain twin's")
    check(np.isfinite(p32).all() and p_err <= 1e-2,
          f"cli_path mc: float32 posteriors {p_err} from float64")


def native_parity(dev, card, tm, y, jobs, L=8192, block=2048):
    """native_parity: the card's float32 decode (kernels 1-2) and EM step
    (kernels 5-6) of y against the native engine's float64 results, which
    `jobs` (cpu_native_decode, cpu_native_em futures) computed on the CPU
    worker from the same samples."""
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.ops import fb_mb
    from hmmspikesorter_torch.ops import viterbi_mb as vmb
    from hmmspikesorter_torch.train import em as tem

    secs = {}
    dec_w = (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb)
    for w in dec_w:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    m = api.fit_spiking_model_fast(tm, y, L=L)
    secs["card_decode"] = time.perf_counter() - t
    dec_launches = {w.__name__: w.launches for w in dec_w}

    K, N = tm.mu.shape
    tab = tem.EMTables.build(build_state_space(N, K, False), dev)
    em_w = (fb_mb.em_forward_mb, fb_mb.em_backward_mb)
    for w in em_w:
        w.launches = 0
    args = [torch.as_tensor(np.asarray(v, np.float64)).to(
        device=dev, dtype=torch.float32) for v in (y, tm.lp, tm.mu, tm.sigma)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = tem.em_step(*args, tab, K=K, fb_mode="overlap_cuda", block=block)
    got = [g.double().cpu().numpy() for g in got]
    secs["card_em_step"] = time.perf_counter() - t
    em_launches = {w.__name__: w.launches for w in em_w}

    t = time.perf_counter()
    x_n, ll_n, native_s = jobs[0].result()
    (lp_n, mu_n, sg_n, ll_em_n), secs["native_em_step"] = jobs[1].result()
    secs["wait_for_cpu_worker"] = time.perf_counter() - t
    secs.update(native_s)

    agree = float((m.ml_seq == x_n).mean())
    ll_rel = abs(m.ll - ll_n) / abs(ll_n)
    em_errs = {"lp_max_abs": float(np.abs(got[0] - lp_n).max()),
               "mu_max_abs": float(np.abs(got[2] - mu_n).max()),
               "sigma_rel": float(abs(got[3] - sg_n) / sg_n),
               "ll_rel": float(abs(got[4] - ll_em_n) / abs(ll_em_n))}
    em_gates = {"lp_max_abs": 1e-4, "mu_max_abs": 2e-3, "sigma_rel": 1e-4,
                "ll_rel": 2e-4}
    emit({"phase": "native_parity", "T": len(y), "N": N, "K": K,
          "S": tm.state_space.nstates, "L": L, "card": card,
          "decode": {"launches": dec_launches, "agreement_vs_native": agree,
                     "disagreements": int((m.ml_seq != x_n).sum()),
                     "ll": m.ll, "ll_native": ll_n, "ll_rel_err": ll_rel,
                     "seam_ok": bool(m.seam_ok.all()),
                     "seams_repaired": m.seams_repaired},
          "em_step": {"S": tab.states.shape[1], "block": block,
                      "L_H": list(tem.cuda_em_geometry(K, block)),
                      "launches": em_launches, "errors": em_errs,
                      "gates": em_gates, "ll": float(got[4]),
                      "ll_native": ll_em_n, "sigma": float(got[3]),
                      "sigma_native": sg_n},
          "seconds_by_part": secs,
          "native_samples_per_s": len(y) / secs["native_viterbi"]})
    check(all(dec_launches.values()),
          f"native_parity: kernels 1-2 did not run: {dec_launches}")
    check(all(v == 1 for v in em_launches.values()),
          f"native_parity: kernels 5-6 launches {em_launches}")
    check(m.ml_seq.shape == x_n.shape and np.isfinite(m.ll),
          "native_parity: output malformed")
    check(agree >= 0.9999, f"native_parity: agreement {agree} with the "
          "native engine < 0.9999")
    check(ll_rel <= 1e-6, f"native_parity: ll relative error {ll_rel} "
          "> 1e-6")
    for k, lim in em_gates.items():
        check(em_errs[k] <= lim,
              f"native_parity: EM {k} {em_errs[k]} > {lim}")


def seam_spans(T, L, halfwidth):
    """The spans dense_seams fills: [s - halfwidth, s + halfwidth) around
    every seam s = L, 2L, ... of T samples."""
    return [(s - halfwidth, s + halfwidth)
            for s in range(L, T - halfwidth, L)]


def forced_seam_recordings(create_signal, create_spike_template, K=60,
                           L=8192, halfwidth=600):
    """card_paths (b)'s recordings: 4 windows of L samples whose seams all
    find no common silence (dense_seams over +-halfwidth), at template
    length K, each where the generator's own train is quiet
    (drop_spikes over seam_spans): a third spike over the two forced trains
    is more than the pair state space holds, and the decode then finds a
    silent sample in some seams (config 6's onset rates keep a cell playing
    most of the time). One channel: config 2's N=3 templates (its onset
    probabilities, the train of default_rng(1234), noise sigma 0.3 of
    default_rng(7), as config6 builds it); multichannel: config 6 (config6:
    N=3 on C=4 channels), the spikes added on every channel. Returns ((y,
    temps, lp, sigma), (yc, mu, sigmas, lp))."""
    T = 4 * L
    spans = seam_spans(T, L, halfwidth)
    temps = np.stack([create_spike_template(K, *p) for p in OVN_SHAPES[:3]],
                     axis=1)
    pp = np.array([0.003, 0.002, 0.001])
    _, truth = create_signal(T, 0.0, pp, temps,
                             rng=np.random.default_rng(1234))
    drop_spikes(truth, spans, K)
    y = 0.3 * np.random.default_rng(7).standard_normal(T)
    for n in range(len(pp)):
        m = truth[n] > 0
        y[m] += temps[truth[n][m] - 1, n]
    dense_seams(y, temps, L, halfwidth)
    yc, _, mu, sg, lp6 = config6(T, create_signal, create_spike_template,
                                 K=K, quiet=spans)
    dense_seams(yc, mu, L, halfwidth)
    return (y, temps, np.log(pp), 0.3), (yc, mu, sg, lp6)


@contextlib.contextmanager
def repair_log():
    """While active, every seam-repair window decode appends (window steps,
    seconds) to the yielded list: the factories the repairs take their
    decoders from (parallel/seam_repair.make_window_decoder, also as
    models/api holds it, and models/multichannel._mc_repair_decoder) are
    wrapped, and put back on exit."""
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.models import multichannel as mcm
    from hmmspikesorter_torch.parallel import seam_repair

    calls = []

    def logged(factory):
        def make(*args, **kwargs):
            decode = factory(*args, **kwargs)

            def timed(y_win, silent_start):
                t = time.perf_counter()
                x = decode(y_win, silent_start)      # labels on the host
                calls.append((len(y_win), time.perf_counter() - t))
                return x
            return timed
        return make

    sites = [(api, "make_window_decoder"),
             (seam_repair, "make_window_decoder"),
             (mcm, "_mc_repair_decoder")]
    saved = [getattr(m, name) for m, name in sites]
    for (m, name), factory in zip(sites, saved):
        setattr(m, name, logged(factory))
    try:
        yield calls
    finally:
        for (m, name), factory in zip(sites, saved):
            setattr(m, name, factory)


def repair_rounds(calls):
    """repair_log's decodes by seam: a seam's rounds widen its window, so a
    window no wider than the one before starts the next seam. Returns
    [{"rounds", "seconds", "window_steps"}] in seam order."""
    seams = []
    for steps, seconds in calls:
        if not seams or steps <= seams[-1]["window_steps"][-1]:
            seams.append({"rounds": 0, "seconds": 0.0, "window_steps": []})
        seams[-1]["rounds"] += 1
        seams[-1]["seconds"] += seconds
        seams[-1]["window_steps"].append(steps)
    return seams


@contextlib.contextmanager
def decode_times(vomb, name, forward):
    """While active, the decode vomb.<name> (ops/viterbi_ovn_mb:
    ovn_decode_mb, ovn_mc_decode_mb or ovn_mc_decode_mb_tracked: the forward
    wrapper `forward`, then kernel 4 on its output) runs with a CUDA event
    pair around each of the two wrappers, which stay in place and count
    their own launches. Yields {wrapper name: [(start, end), ...]}; read
    them after a synchronize (event_ms)."""
    pairs = {forward.__name__: [], "ovn_backtrace_mb": []}
    saved = getattr(vomb, name)

    def timed(fn, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        pairs[fn.__name__].append((start, end))
        return out

    def decode(*args):
        packed = timed(forward, *args)
        return timed(vomb.ovn_backtrace_mb, *packed, args[-1])

    setattr(vomb, name, decode)
    try:
        yield pairs
    finally:
        setattr(vomb, name, saved)


def event_ms(pairs):
    """{name: {"launches", "ms_total", "ms_mean", "ms_max"}} of
    decode_times' pairs (synchronized)."""
    out = {}
    for name, ev in pairs.items():
        ms = [s.elapsed_time(e) for s, e in ev]
        out[name] = {"launches": len(ms), "ms_total": sum(ms),
                     "ms_mean": sum(ms) / max(len(ms), 1),
                     "ms_max": max(ms, default=0.0)}
    return out


def vs_f64(x, x64, x32=None):
    """The card's float32 labels x against the float64 labels x64 of the
    same decode on the CPU, and x32 of the plain engines in float32 there
    (the JAX package's association: the float32 floor's witness; None where
    it was not computed). `ok`: x equals x64, or agrees >= 0.9999 with it
    and has the witness's label at every sample where they differ, a
    near-tie that float32 cannot order (ROADMAP §3), not the card's own.
    Returns the row."""
    x, x64 = np.asarray(x), np.asarray(x64)
    diff = x != x64
    agree = float(1.0 - diff.mean())
    row = {"agreement_vs_f64": agree, "disagreements": int(diff.sum()),
           "disagree_at": np.nonzero(diff)[0][:8].tolist(),
           "labels_equal_f64": not diff.any(),
           "labels_equal_f32_witness": None,
           "witness_shares_disagreements": None}
    if x32 is not None:
        x32 = np.asarray(x32)
        row["labels_equal_f32_witness"] = bool(np.array_equal(x, x32))
        row["witness_shares_disagreements"] = bool(
            np.array_equal(x[diff], x32[diff]))
    row["ok"] = not diff.any() or bool(
        row["witness_shares_disagreements"] and agree >= 0.9999)
    return row


def witness(prep, key, x, x64):
    """card_paths_prep's deferred float32 witness `key` (its job's result,
    computed now by the CPU worker) where the card's labels x differ from
    the float64 labels x64; else None."""
    if np.array_equal(x, x64):
        return None
    fn, *args = prep["later"][key]
    return prep["cpu"].submit(fn, *args).result()


def run_counted(wrappers, fn):
    """fn() with the launch counts of `wrappers` set to 0 just before and
    read just after (the card synchronized on both sides). Returns (fn's
    value, seconds, {wrapper name: launches})."""
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t,
            {w.__name__: w.launches for w in wrappers})


def card_paths_prep(dev, card, cpu, K=60, sigma=0.3, T4=1 << 20, L=8192,
                    n4_prefix=1 << 15, H6=256, halfwidth=600,
                    T_mc=1 << 20, cut_mc=3, T3=1 << 21, cut_n3=4,
                    chunk=32768, chunk_e=2048):
    """card_paths' inputs and float64 references, prepared once the kernels
    are built so that the CPU worker `cpu` computes the references while the
    card runs the phases in between:
      (a) N=4 (OVN_SHAPES at K, pp=(0.003, 0.002, 0.001, 0.001), T4
          samples, default_rng(1234)); the native engine's Viterbi of its
          first n4_prefix samples (12 bytes a sample and state: 8.3 GB at
          S=21,123 and 2^15);
      (b) forced_seam_recordings (4 windows of L, +-halfwidth): the float64
          plain decodes of both (cpu_decode_twin, cpu_mc_decode_twin, halo
          H6);
      (c) drift_path_mc's recording (config 6, 1x -> 2x over T_mc) and its
          track (track_drift_mc at chunk, kernels 12-13: drift_path_mc's
          fit tracks the same, and card_paths checks they agree), cut to
          its first cut_mc chunks with dense_seams at their seams (the
          track's middle-chunk templates) where config 6's train is quiet
          (forced_seam_recordings): its float64 decode_tracked_mc;
      (d) config 2's N=3 templates on create_drifting_signal (1x -> 2x over
          T3, default_rng(1234)) and their track (track_drift, kernels
          5-6); the float64 _tracked_overlap_save of the first cut_n3
          chunks under it;
      (e) config 6 ramped 1x -> 2x over 2 chunks of chunk_e under a track
          of each chunk's mean gain (1.25x, 1.75x): its tracked posteriors
          (overlaps on, S=10,621) in float64 and, the float32 floor's
          witness, in float32.
    Emits the card_paths_prep line. Returns a dict for card_paths."""
    import dataclasses

    from hmmspikesorter_torch.data.synthetic import (create_drifting_signal,
                                                     create_signal,
                                                     create_signal_fast,
                                                     create_spike_template)
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.models import multichannel as mcm
    from hmmspikesorter_torch.train import adaptive as tad

    secs, t = {}, time.perf_counter()
    temps4 = np.stack([create_spike_template(K, *p) for p in OVN_SHAPES],
                      axis=1)
    pp4 = np.array([0.003, 0.002, 0.001, 0.001])
    y4, truth4 = create_signal_fast(T4, sigma, pp4, temps4,
                                    rng=np.random.default_rng(1234))
    tm4 = api.HMMTemplateModel(mu=temps4, sigma=sigma, lp=np.log(pp4),
                               allow_overlaps=True)
    (y_s, temps3, lp3, _), (yc_s, mu6, sg6, lp6) = forced_seam_recordings(
        create_signal, create_spike_template, K=K, L=L,
        halfwidth=halfwidth)
    yc_e, truth_e, mu_e, sg_e, lp_e = config6(
        2 * chunk_e, create_signal, create_spike_template, scale_end=2.0,
        K=K)
    gain = np.array([1.25, 1.75])
    tr_e = tad.DriftTrack(lp=np.tile(lp_e, (2, 1)),
                          mu=mu_e[None] * gain[:, None, None, None],
                          sigma=np.tile(sg_e, (2, 1)), lls=np.zeros(2),
                          bounds=[(0, chunk_e), (chunk_e, 2 * chunk_e)],
                          chunk=chunk_e, forget=0.3, allow_overlaps=True)
    yc_d, _, mu_d, sg_d, lp_d = config6(T_mc, create_signal,
                                        create_spike_template, scale_end=2.0,
                                        K=K)
    # (c)'s cut: the same recording with config 6's train quiet over the
    # forced spans (forced_seam_recordings), then dense_seams there
    Tc = cut_mc * chunk
    yc_c = np.array(config6(T_mc, create_signal, create_spike_template,
                            scale_end=2.0, K=K,
                            quiet=seam_spans(Tc, chunk, halfwidth))[0][:Tc])
    y3, truth3, _ = create_drifting_signal(T3, sigma, np.exp(lp3),
                                           temps3, scale_start=1.0,
                                           scale_end=2.0,
                                           rng=np.random.default_rng(1234))
    secs["signals"] = time.perf_counter() - t
    t = time.perf_counter()
    tm_d = mcm.HMMTemplateModelMC(mu=mu_d, sigmas=sg_d, lp=lp_d,
                                  allow_overlaps=True)
    tr_mc = tad.track_drift_mc(tm_d, yc_d, chunk=chunk)
    tm3 = api.HMMTemplateModel(mu=temps3, sigma=sigma, lp=lp3,
                               allow_overlaps=True)
    tr3 = tad.track_drift(tm3, y3, chunk=chunk)
    torch.cuda.synchronize()
    secs["tracks"] = time.perf_counter() - t
    tr_c = dataclasses.replace(tr_mc, lp=tr_mc.lp[:cut_mc],
                               mu=tr_mc.mu[:cut_mc],
                               sigma=tr_mc.sigma[:cut_mc],
                               lls=tr_mc.lls[:cut_mc],
                               bounds=tr_mc.bounds[:cut_mc])
    dense_seams(yc_c, tr_mc.mu[1], chunk, halfwidth)
    H = max(4 * K, 64)
    Tc = cut_n3 * chunk
    # each label reference in float64 and, the float32 floor's witness
    # (vs_f64), in float32: (b)'s beside it, (c)'s and (d)'s (three minutes
    # of a core each) only where the card's labels differ from float64
    # (witness); the longest first: the workers take the jobs in this order
    f32 = torch.float32
    d_args = (y3[:Tc], tr3.lp[:cut_n3], tr3.mu[:cut_n3], tr3.sigma[:cut_n3],
              chunk, H)
    jobs = {"d": cpu.submit(cpu_tracked_overlap_save, *d_args),
            "c": cpu.submit(cpu_tracked_twin, tr_c, yc_c)}
    later = {"d32": (cpu_tracked_overlap_save, *d_args, f32),
             "c32": (cpu_tracked_twin, tr_c, yc_c, f32)}
    for dt, tag in ((torch.float64, ""), (f32, "32")):
        jobs["b_sc" + tag] = cpu.submit(cpu_decode_twin, temps3, sigma, lp3,
                                        y_s, L, H6, dt)
        jobs["b_mc" + tag] = cpu.submit(cpu_mc_decode_twin, mu6, sg6, lp6,
                                        yc_s, L, H6, dt)
    jobs.update({
        "e64": cpu.submit(cpu_tracked_mc_posteriors, tr_e, yc_e),
        "e32": cpu.submit(cpu_tracked_mc_posteriors, tr_e, yc_e, f32),
        "a": cpu.submit(cpu_native_decode, temps4, sigma, np.log(pp4),
                        y4[:n4_prefix])})
    emit({"phase": "card_paths_prep", "card": card, "seconds_by_part": secs,
          "references_on_cpu": list(jobs)})
    return {"jobs": jobs, "later": later, "cpu": cpu, "L": L, "H6": H6,
            "halfwidth": halfwidth, "chunk": chunk, "cut_n3": cut_n3,
            "n4": (tm4, y4, truth4, n4_prefix),
            "seams": ((y_s, temps3, lp3, sigma), (yc_s, mu6, sg6, lp6)),
            "tracked_mc": (tr_mc, tr_c, yc_c),
            "tracked_n3": (tm3, y3, truth3, tr3),
            "posteriors_mc": (tr_e, yc_e)}


def card_n4_cli(dev, card, prep):
    """card_paths (a): N=4 end to end through the CLI's body
    (cli._sort_loaded, --engine fast: kernels 3 and 4 once each on 128
    windows of W=8672, S=21,123, int16 labels), its MAT file read back:
    mlseq equal to unroll_mlseq of the library decode
    (api.fit_spiking_model_fast), the ll within 1e-6 relative of a float64
    path_cumulative_ll of those labels, onset errors against the truth
    printed; the float32 library decode of the first n4_prefix samples
    against the native float64 engine's Viterbi: no label differs."""
    import scipy.io

    from hmmspikesorter_torch import cli
    from hmmspikesorter_torch.core import events as tevents
    from hmmspikesorter_torch.core.path_score import path_cumulative_ll
    from hmmspikesorter_torch.io.extraction import unroll_mlseq
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb

    tm, y, truth, n_pre = prep["n4"]
    K, N = tm.mu.shape
    states = tm.state_space.states
    secs = {}
    out_dir = pathlib.Path(__file__).resolve().parent / "build" / "cli_path"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / "card_paths_n4.mat")
    wr = (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb)
    with decode_times(vomb, "ovn_decode_mb", vomb.ovn_forward_mb) as ev:
        out, secs["cli"], launches = run_counted(
            wr, lambda: cli._sort_loaded(tm, y, path,
                                         cli._options(engine="fast"),
                                         device=dev))
    kernels = event_ms(ev)
    back = scipy.io.loadmat(path, squeeze_me=True)
    lib, secs["library"], lib_launches = run_counted(
        wr, lambda: api.fit_spiking_model_fast(tm, y))
    ref = unroll_mlseq(lib.ml_seq, states) + 1
    t = time.perf_counter()
    ll64 = path_cumulative_ll(np.asarray(y, np.float64), lib.ml_seq, states,
                              tm.mu, tm.sigma, tm.lp)
    secs["f64_path_ll"] = time.perf_counter() - t
    ll_rel = abs(out["ll"] - ll64) / abs(ll64)
    errors = onset_errors(tevents._onsets_dense(lib.ml_seq, N=N, K=K,
                                                overlaps=True), truth)
    pre, secs["prefix_decode"], _ = run_counted(
        wr, lambda: api.fit_spiking_model_fast(tm, y[:n_pre]))
    t = time.perf_counter()
    x_n, ll_n, native_s = prep["jobs"]["a"].result()
    secs["cpu_worker_wait"] = time.perf_counter() - t
    secs.update(native_s)
    disagree = int((pre.ml_seq != x_n).sum())
    T = len(y)
    emit({"phase": "card_paths", "part": "a_n4_cli", "card": card, "N": N,
          "K": K, "S": tm.state_space.nstates, "T": T, "L": 8192,
          "H": max(4 * K, 64), "B": -(-T // 8192), "launches": launches,
          "kernels3_4": kernels,
          "library_launches": lib_launches,
          "labels_dtype": str(lib.ml_seq.dtype),
          "mat_mlseq_equals_library": bool(np.array_equal(back["mlseq"],
                                                           ref)),
          "seams_repaired": lib.seams_repaired,
          "ll": float(out["ll"]), "ll_f64_path": ll64, "ll_rel_err": ll_rel,
          "onset_errors": errors,
          "onsets_true": [int((truth[n] == 1).sum()) for n in range(N)],
          "samples_per_s_cli": T / secs["cli"],
          "native_prefix": {"T": n_pre, "agreement": 1.0 - disagree / n_pre,
                            "disagreements": disagree, "ll": pre.ll,
                            "ll_native": ll_n,
                            "ll_rel_err": abs(pre.ll - ll_n) / abs(ll_n),
                            "seams_repaired": pre.seams_repaired,
                            "native_device": "cpu"},
          "seconds_by_part": secs})
    check(launches == {"ovn_forward_mb": 1, "ovn_backtrace_mb": 1},
          f"card_paths n4: the CLI's launches {launches}, expected one each")
    check(set(out) == {"mlseq", "ll", "waveforms", "lp", "sigma"}
          and out["mlseq"].shape == (N, T) and np.isfinite(out["ll"]),
          "card_paths n4: the CLI's output malformed")
    check(lib.ml_seq.dtype == np.int16, "card_paths n4: labels not int16")
    check(np.array_equal(back["mlseq"], ref)
          and np.array_equal(out["mlseq"], ref),
          "card_paths n4: the MAT file's mlseq differs from the library "
          "decode's")
    check(ll_rel <= 1e-6, f"card_paths n4: ll {ll_rel} from the float64 "
          "path score (> 1e-6)")
    check(pre.ml_seq.shape == x_n.shape and disagree == 0,
          f"card_paths n4: {disagree} labels of the first {n_pre} samples "
          "differ from the native float64 engine's")


def card_seam_repair(dev, card, prep):
    """card_paths (b): seam repair after kernels 3-4 and after kernels 11 +
    4 on forced_seam_recordings (4 windows of L=8192, H=256): the single
    channel through fit_spiking_model_fast(streaming=True), config 6
    through fit_spiking_model_mc_fast; each repairs all 3 seams with its
    plain ring engine in float32 on the card, and its labels equal the
    float64 plain decode's on the CPU (vs_f64). Each seam's rounds and
    seconds (repair_log)."""
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.models import multichannel as mcm
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb

    L, H = prep["L"], prep["H6"]
    (y, temps, lp, sigma), (yc, mu6, sg6, lp6) = prep["seams"]
    tm3 = api.HMMTemplateModel(mu=temps, sigma=sigma, lp=lp,
                               allow_overlaps=True)
    tm6 = mcm.HMMTemplateModelMC(mu=mu6, sigmas=sg6, lp=lp6,
                                 allow_overlaps=True)
    runs = (("n3", "ovn_decode_mb", vomb.ovn_forward_mb, "b_sc",
             lambda: api.fit_spiking_model_fast(tm3, y, streaming=True, L=L,
                                                H=H)),
            ("mc", "ovn_mc_decode_mb", vomb.ovn_mc_forward_mb, "b_mc",
             lambda: mcm.fit_spiking_model_mc_fast(tm6, yc, L=L, H=H)))
    rows, fails = {}, []
    for name, decode, forward, job, fn in runs:
        wr = (forward, vomb.ovn_backtrace_mb)
        with repair_log() as calls, decode_times(vomb, decode,
                                                 forward) as ev:
            m, seconds, launches = run_counted(wr, fn)
        t = time.perf_counter()
        x64, ll64, rep64, s64 = prep["jobs"][job].result()
        x32, _, _, s32 = prep["jobs"][job + "32"].result()
        wait = time.perf_counter() - t
        vs = vs_f64(m.ml_seq, x64, x32)
        rows[name] = {"T": len(m.ml_seq), "S": m.template_model.state_space
                      .nstates, "seconds": seconds, "launches": launches,
                      "kernels": event_ms(ev),
                      "seams": len(m.seam_ok), "seams_repaired":
                      m.seams_repaired, "seams_repaired_f64": rep64,
                      "repairs": repair_rounds(calls), **vs,
                      "ll": m.ll, "ll_f64": ll64, "f64_seconds": s64,
                      "f32_witness_seconds": s32, "f64_device": "cpu",
                      "cpu_worker_wait": wait}
        if set(launches.values()) != {1}:
            fails.append(f"{name}: launches {launches}, expected one each")
        if m.seams_repaired != 3 or rep64 != 3:
            fails.append(f"{name}: seams repaired {m.seams_repaired} "
                         f"(float64 {rep64}), expected 3")
        if not vs["ok"]:
            fails.append(f"{name}: repaired labels differ from the float64 "
                         "plain decode's beyond the float32 witness's")
    emit({"phase": "card_paths", "part": "b_seam_repair", "card": card,
          "L": L, "H": H, "halfwidth": prep["halfwidth"], **rows})
    check(not fails, "card_paths seam repair: " + "; ".join(fails))


def card_tracked_mc_repair(dev, card, prep, mc_track):
    """card_paths (c): the first 3 chunks of drift_path_mc's recording under
    its track, both seams forced (card_paths_prep), through
    decode_tracked_mc with repair on (kernel 11's per-window mode and kernel
    4 once each, then each seam re-decoded with its left chunk's model by
    the plain MC ring engine in float32): 2 seams repaired, the labels
    equal to the same cut's float64 decode on the CPU (vs_f64); the track
    equal to the one drift_path_mc fitted."""
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
    from hmmspikesorter_torch.train import adaptive as tad

    tr_full, tr, yc = prep["tracked_mc"]
    same_track = all(np.array_equal(getattr(tr_full, f), getattr(mc_track, f))
                     for f in ("lp", "mu", "sigma"))
    wr = (vomb.ovn_mc_forward_mb_tracked, vomb.ovn_backtrace_mb)
    with repair_log() as calls, decode_times(
            vomb, "ovn_mc_decode_mb_tracked", wr[0]) as ev:
        m, seconds, launches = run_counted(
            wr, lambda: tad.decode_tracked_mc(tr, yc))
    t = time.perf_counter()
    x64, ll64, rep64, s64 = prep["jobs"]["c"].result()
    w32 = witness(prep, "c32", m.ml_seq, x64)
    wait = time.perf_counter() - t
    vs = vs_f64(m.ml_seq, x64, w32 and w32[0])
    emit({"phase": "card_paths", "part": "c_tracked_mc_repair", "card": card,
          "T": len(yc), "chunk": tr.chunk, "windows": tr.n_chunks,
          "S": m.template_model.state_space.nstates, "seconds": seconds,
          "launches": launches, "kernels": event_ms(ev),
          "seams_repaired": m.seams_repaired,
          "seams_repaired_f64": rep64, "repairs": repair_rounds(calls),
          **vs, "ll": m.ll, "ll_f64": ll64, "f64_seconds": s64,
          "f32_witness_seconds": w32 and w32[-1], "f64_device": "cpu",
          "cpu_worker_wait": wait,
          "track_equals_drift_path_mc": same_track})
    check(same_track, "card_paths tracked MC: the track differs from "
          "drift_path_mc's")
    check(launches == {"ovn_mc_forward_mb_tracked": 1,
                       "ovn_backtrace_mb": 1},
          f"card_paths tracked MC: launches {launches}")
    check(m.seams_repaired == 2 and rep64 == 2,
          f"card_paths tracked MC: seams repaired {m.seams_repaired} "
          f"(float64 {rep64}), expected 2")
    check(vs["ok"], "card_paths tracked MC: repaired labels differ from the "
          "float64 decode's beyond the float32 witness's")


def card_tracked_n3(dev, card, prep):
    """card_paths (d): fit_spiking_model_adaptive of config 2's N=3
    templates on the 1x -> 2x drifting recording (T=2^21, chunk 32768):
    kernels 5-6 in the tracking (the track equal to card_paths_prep's), then
    kernels 3 and 4 once each a window (64 windows of W=33,248), each
    launch timed by CUDA events; the decode and the host piecewise ll timed
    apart; onset errors of the tracked and of a stationary decode (the
    tracked below); the first cut_n3 chunks decoded again on the card at
    that length, their labels equal to the float64 _tracked_overlap_save
    of the same cut on the CPU (vs_f64)."""
    from hmmspikesorter_torch.core import events as tevents
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.ops import fb_mb
    from hmmspikesorter_torch.ops import viterbi_ovn_mb as vomb
    from hmmspikesorter_torch.train import adaptive as tad

    tm, y, truth, tr0 = prep["tracked_n3"]
    K, N = tm.mu.shape
    chunk, n_cut = prep["chunk"], prep["cut_n3"]
    H = max(4 * K, 64)
    secs = {}
    wr = (fb_mb.em_forward_mb, fb_mb.em_backward_mb, vomb.ovn_forward_mb,
          vomb.ovn_backtrace_mb)
    with decode_times(vomb, "ovn_decode_mb", vomb.ovn_forward_mb) as ev:
        m, secs["fit"], launches = run_counted(
            wr, lambda: api.fit_spiking_model_adaptive(tm, y, chunk=chunk))
    kernels = event_ms(ev)
    tr = m.track
    same_track = all(np.array_equal(getattr(tr, f), getattr(tr0, f))
                     for f in ("lp", "mu", "sigma"))
    m2, secs["decode"], _ = run_counted((), lambda: tad.decode_tracked(tr, y))
    t = time.perf_counter()
    tad._piecewise_path_ll(y, m2.ml_seq, tr, tm.state_space)
    secs["host_ll"] = time.perf_counter() - t
    stat = api.fit_spiking_model_fast(tm, y)
    e_tracked = onset_errors(m.spike_onsets, truth)
    e_static = onset_errors(tevents._onsets_dense(stat.ml_seq, N=N, K=K,
                                                  overlaps=True), truth)
    Tc = n_cut * chunk
    (x_cut, _), secs["cut_decode"], cut_launches = run_counted(
        wr[2:], lambda: tad._tracked_overlap_save(
            y[:Tc], tr.lp[:n_cut], tr.mu[:n_cut], tr.sigma[:n_cut], L=chunk,
            H=H, overlaps=True, device=dev, dtype=torch.float32))
    x_cut = x_cut.cpu().numpy()
    t = time.perf_counter()
    x64, ok64, s64 = prep["jobs"]["d"].result()
    w32 = witness(prep, "d32", x_cut, x64)
    secs["cpu_worker_wait"] = time.perf_counter() - t
    vs = vs_f64(x_cut, x64, w32 and w32[0])
    B = tr.n_chunks
    emit({"phase": "card_paths", "part": "d_tracked_n3", "card": card,
          "N": N, "K": K, "S": tm.state_space.nstates, "T": len(y),
          "chunk": chunk, "B": B, "W": chunk + 2 * H,
          "fit_launches": launches, "kernels3_4": kernels,
          "decode_seconds": secs["decode"],
          "decode_host_ll_seconds": secs["host_ll"],
          "samples_per_s": len(y) / secs["fit"],
          "track_equals_prep": same_track,
          "onset_errors_tracked": e_tracked,
          "onset_errors_stationary": e_static,
          "onsets_true": [int((truth[n] == 1).sum()) for n in range(N)],
          "seams_repaired": m.seams_repaired, "ll": m.ll,
          "amplitude_first_last": [float(np.abs(tr.mu[0]).max()),
                                   float(np.abs(tr.mu[-1]).max())],
          "cut": {"T": Tc, "windows": n_cut, "launches": cut_launches,
                  **vs, "seams_ok_f64": ok64.tolist(), "f64_seconds": s64,
                  "f32_witness_seconds": w32 and w32[-1],
                  "f64_device": "cpu"},
          "seconds_by_part": secs})
    check(m.ml_seq.shape == (len(y),) and np.isfinite(m.ll),
          "card_paths tracked N=3: output malformed")
    check(same_track, "card_paths tracked N=3: the fit's track differs from "
          "the same tracking run before")
    check(launches["ovn_forward_mb"] == B
          and launches["ovn_backtrace_mb"] == B
          and kernels["ovn_forward_mb"]["launches"] == B,
          f"card_paths tracked N=3: launches {launches}, expected {B} of "
          "kernels 3 and 4")
    check(launches["em_forward_mb"] >= B and launches["em_backward_mb"] >= B,
          f"card_paths tracked N=3: the tracking did not run kernels 5-6 "
          f"on every chunk {launches}")
    check(e_tracked < e_static, f"card_paths tracked N=3: tracked onset "
          f"errors {e_tracked} not below the stationary decode's {e_static}")
    check(cut_launches == {"ovn_forward_mb": n_cut,
                           "ovn_backtrace_mb": n_cut},
          f"card_paths tracked N=3: the cut's launches {cut_launches}")
    check(vs["ok"], f"card_paths tracked N=3: the cut's labels differ from "
          f"the float64 decode's beyond the float32 witness's {vs}")


def card_tracked_mc_posteriors(dev, card, prep):
    """card_paths (e): onset_posteriors_tracked_mc of config 6 with overlaps
    on (S=10,621) over 2 owner chunks of 2048 (L=2048, W=2528, H=240) under
    a drifting track: the plain engines in float32 on the card, within the
    float32 floor of the float64 run on the CPU (3x the plain float32
    engines' own error there, the witness, at least 1e-4, at most 1e-3);
    the seconds a step (a forward and a backward step over each window)."""
    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.ops import gamma_mb

    tr, yc = prep["posteriors_mc"]
    wr = (gamma_mb.gamma_fwd_mb_mc, gamma_mb.gamma_bwd_mb_mc)
    p32, seconds, launches = run_counted(
        wr, lambda: tpost.onset_posteriors_tracked_mc(tr, yc))
    t = time.perf_counter()
    p64, s64 = prep["jobs"]["e64"].result()
    w32, w32_s = prep["jobs"]["e32"].result()
    wait = time.perf_counter() - t
    err = float(np.abs(p32 - p64).max())
    witness = float(np.abs(w32 - p64).max())
    tol = min(1e-3, max(1e-4, 3 * witness))
    K = tr.mu.shape[1]
    H = max(4 * K, 64)
    W = tr.chunk + 2 * H
    steps = 2 * W * tr.n_chunks
    emit({"phase": "card_paths", "part": "e_tracked_mc_posteriors",
          "card": card, "T": len(yc), "chunk": tr.chunk, "L": tr.chunk,
          "H": H, "W": W, "windows": tr.n_chunks,
          "S": tr.model_at(0).state_space.nstates, "launches": launches,
          "seconds": seconds, "steps": steps,
          "seconds_per_step": seconds / steps,
          "max_abs_err_vs_f64": err,
          "plain_f32_cpu_max_abs_err_vs_f64": witness, "tolerance": tol,
          "expected_onsets": p32.sum(axis=0).tolist(),
          "f64_seconds": s64, "f32_witness_seconds": w32_s,
          "f64_device": "cpu", "cpu_worker_wait": wait})
    check(p32.shape == p64.shape and np.isfinite(p32).all(),
          "card_paths tracked MC posteriors: output malformed")
    check(err <= tol, f"card_paths tracked MC posteriors: {err} from the "
          f"float64 run (> {tol})")


def card_paths(dev, card, prep, mc_track):
    """The card_paths phase: parts (a)-(e) on card_paths_prep's inputs,
    each printing its own line (`part`) with its checks."""
    card_n4_cli(dev, card, prep)
    card_seam_repair(dev, card, prep)
    card_tracked_mc_repair(dev, card, prep, mc_track)
    card_tracked_n3(dev, card, prep)
    card_tracked_mc_posteriors(dev, card, prep)


def union_share(events, t0, t1):
    """Share of [t0, t1) (microseconds) covered by the union of the
    events' [ts, ts + dur) intervals."""
    spans = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in events)
    covered, end = 0.0, t0
    for a, b in spans:
        a = max(a, end)
        if b > a:
            covered += b - a
            end = b
    return covered / (t1 - t0)


DECODE_SPANS = ("decode.upload", "decode.windows", "decode.stitch",
                "decode.download", "decode.ll")
EM_SPANS = ("em.e_step", "em.m_step")


def launch_us(n=5000):
    """Host microseconds a launch of a one-element in-place add, over n
    launches ended by a synchronise: the unit cost of a launch-bound
    loop."""
    a = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        a.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def trace_path(card, tm, y, L, em_once, main_share,
               out_dir=pathlib.Path("chiprun_out") / "trace_path"):
    """trace_path: one warm decode of y and one EM step (em_once) under
    torch.profiler with CPU and CUDA activities; the spans, the kernels by
    name and the device-busy share of the decode from the Chrome trace,
    beside main_path's event-time estimate `main_share`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.ops import fb_mb
    from hmmspikesorter_torch.ops import viterbi_mb as vmb

    wrappers = (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb, fb_mb.em_forward_mb,
                fb_mb.em_backward_mb)
    api.fit_spiking_model_fast(tm, y, L=L)                   # warm-up
    torch.cuda.synchronize()
    us_before = launch_us()
    for w in wrappers:
        w.launches = 0
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("trace_path.decode"):
            t_dec = time.perf_counter()
            m = api.fit_spiking_model_fast(tm, y, L=L)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t_dec
        with record_function("trace_path.em"):
            em_once()
            torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t
    us_after = launch_us()
    launches = {w.__name__: w.launches for w in wrappers}
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    t = time.perf_counter()
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    read_s = time.perf_counter() - t

    spans = {}
    for e in ev:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], e)
    win = spans.get("trace_path.decode")
    dev_ops = [e for e in ev
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in dev_ops if e["cat"] == "kernel"]
    names = sorted({e["name"] for e in kernels})
    # the port's kernels by their CUDA function names (kernel 2 is the
    # chase machine's segments_kernel with the N=2 step decoder)
    seen = {k: [n for n in names if key in n] for k, key in (
        ("kernel1", "ov2_forward_kernel"), ("kernel2", "segments_kernel"),
        ("kernel5", "em_forward_kernel"), ("kernel6", "em_backward_kernel"))}
    has = {k: bool(v) for k, v in seen.items()}
    out = {"phase": "trace_path", "T": len(y), "L": L, "card": card,
           "trace": str(path), "trace_events": len(ev),
           "device_events": len(dev_ops), "launches": launches,
           "spans_seen": {s: s in spans for s in DECODE_SPANS + EM_SPANS},
           "kernels_seen": seen, "distinct_kernels": len(names),
           "decode_seconds_profiled": decode_s,
           "launch_us_before": us_before, "launch_us_after": us_after,
           "profiled_seconds": profiled_s, "trace_read_seconds": read_s,
           "main_path_event_time_share": main_share}
    if win is not None and kernels:
        t0, t1 = win["ts"], win["ts"] + win["dur"]
        inside = [e for e in dev_ops if e["ts"] < t1 and e["ts"] + e["dur"]
                  > t0]
        by_name = {}
        for e in inside:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        out.update({
            "decode_window_ms": win["dur"] / 1e3,
            "device_busy_share": union_share(
                [e for e in inside if e["cat"] == "kernel"], t0, t1),
            "device_busy_share_with_copies": union_share(inside, t0, t1),
            "top5_device_ops_ms": [[n, d / 1e3] for n, d in top],
            "spans_ms": {s: spans[s]["dur"] / 1e3 for s in DECODE_SPANS
                         if s in spans}})
    emit(out)
    check(all(out["spans_seen"].values()),
          f"trace_path: spans missing: {out['spans_seen']}")
    check(all(has.values()), f"trace_path: kernels missing from the "
          f"trace: {has} {names}")
    check(all(launches.values()), f"trace_path: launches {launches}")
    check(win is not None and "device_busy_share" in out,
          "trace_path: no decode window or no device time in the trace")
    check(m.ml_seq.shape == (len(y),) and np.isfinite(m.ll),
          "trace_path: output malformed")


def em_update_errs(got, ref):
    """tests/test_sharded_em.py:180-184's float32 tolerances for one EM
    update (lp, pi, mu, sigma, ll): lp rtol 2e-5, pi atol 1e-4, mu atol
    2e-5, sigma and ll 2e-6 relative. Returns ({name: worst error in the
    tolerance's own measure}, all within)."""
    tol = {"lp": ("rel", 2e-5), "pi": ("abs", 1e-4), "mu": ("abs", 2e-5),
           "sigma": ("rel", 2e-6), "ll": ("rel", 2e-6)}
    errs = {}
    for name, a, b in zip(("lp", "pi", "mu", "sigma", "ll"), got, ref):
        d = (a.double() - b.double()).abs()
        if tol[name][0] == "rel":
            d = d / b.double().abs()
        errs[name] = float(d.max())
    return errs, all(errs[n] <= tol[n][1] for n in tol)


def sharded_path(dev, card, C=8, T=1 << 20, K=60, L=4096, Tp=1 << 18,
                 Lp=4096):
    """The multi-device slice on one card: LocalMeshes (every shard in this
    process, the shards' windows one batch) and a one-rank DistMesh (NCCL;
    gloo where `dev` is the CPU, for a rehearsal at small sizes). Returns
    the sharded EM's launch counts of kernels 5-6."""
    import contextlib
    import io
    import os
    import tempfile

    import torch.distributed as dist

    from hmmspikesorter_torch.core import posterior as tpost
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.data.synthetic import (create_signal_fast,
                                                     create_spike_template)
    from hmmspikesorter_torch.models import api
    from hmmspikesorter_torch.ops import fb_mb
    from hmmspikesorter_torch.parallel import runner
    from hmmspikesorter_torch.parallel import sharded_em as sem
    from hmmspikesorter_torch.parallel.block_viterbi import blocked_viterbi
    from hmmspikesorter_torch.parallel.mesh import DistMesh, LocalMesh
    from hmmspikesorter_torch.parallel.sharded import sharded_blocked_viterbi
    from hmmspikesorter_torch.parallel.sharded_posterior import \
        sharded_onset_posteriors
    from hmmspikesorter_torch.train import em as tem

    f32, f64 = torch.float32, torch.float64
    secs = {}
    t_part = time.perf_counter()
    # ---- sharded EM at the JAX runner's defaults (parallel/runner.py):
    # C=8 channels of T=2^20, N=2, K=60 non-overlap (S=119), L=4096,
    # H=240, W=4576, on a channel 2 x time 4 mesh ------------------------
    N = 2
    H = max(4 * K, 64)
    sigma = 0.3
    temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                      create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    pp = np.array([0.003, 0.001])
    rng = np.random.default_rng(0)
    ys = np.stack([create_signal_fast(T, sigma, pp, temps, rng=rng)[0]
                   for _ in range(C)]).astype(np.float32)
    y_d = torch.as_tensor(ys, device=dev)
    tables = tem.EMTables.build(build_state_space(N, K, False), dev)
    mesh = LocalMesh(2, 4, device=dev)
    wrappers = (fb_mb.em_forward_mb, fb_mb.em_backward_mb)
    state = [torch.as_tensor(v, dtype=f32, device=dev) for v in
             (np.stack([np.log(pp)] * C), np.stack([temps] * C),
              np.full(C, sigma))]
    launches = {w.__name__: 0 for w in wrappers}
    walls, errs = [], []
    for _ in range(2):
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sem.sharded_em_step(y_d, *state, tables, mesh, K=K, L=L, H=H,
                                  fb_mode="overlap_cuda", dtype=f32)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        for w in wrappers:
            launches[w.__name__] += w.launches
        # the single-device route from the same inputs, channel by channel
        for c in range(C):
            ref = tem.em_step(y_d[c], *(v[c] for v in state), tables, K=K,
                              fb_mode="overlap_cuda", block=L)
            e, ok = em_update_errs([v[c] for v in out], ref)
            errs.append(e)
            check(ok, f"sharded_path: sharded EM channel {c} differs from "
                  f"the single-device route: {e}")
        state = [out[0], out[2], out[3]]
    check(launches == {"em_forward_mb": 2 * C, "em_backward_mb": 2 * C},
          f"sharded_path: kernels 5-6 launches {launches}")
    check(all(bool(torch.isfinite(v).all()) for v in out),
          "sharded_path: non-finite EM update")
    secs["em"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    # kernels 5-6 on channel 0's sharded windows (the halos exchanged, the
    # mesh-edge rows clamped): timed on all 256, their plain versions on the
    # four windows at shard edges (shard 0's first, shard 0's last and
    # shard 1's first, whose halos crossed a shard boundary, and the last
    # shard's last): checkpoints, la and per-window partials bit-equal
    ax = mesh.axis("time")
    y_loc = mesh.local(y_d[0], "time")
    win, lo, hi, xh = sem._cuda_windows(
        y_loc, ax.ppermute(y_loc[:, -H:], 1), ax.ppermute(y_loc[:, :H], -1),
        L=L, H=H, axis=ax)
    B = win.shape[0]
    first = [0, B // 4 - 1, B // 4, B - 1]
    order = torch.as_tensor(first + [b for b in range(B) if b not in first],
                            device=dev)
    ce = fb_mb.em_consts(np.log(pp), temps, sigma, dtype=f32, device=dev)
    row = em_kernels(fb_mb, win[order].contiguous(),
                     torch.stack([lo, hi, xh], dim=1)[order].contiguous(), ce,
                     fwd_reps=5, bwd_reps=5)
    check(row["backward"]["partials_bit_equal"],
          "sharded_path: kernel 6's per-window partials differ from its "
          "plain version on the sharded windows")
    row["plain_windows_checked"] = first
    del win, y_loc
    secs["kernels"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # ---- sharded decode: time 4, T=2^20, N=2, K=60 non-overlap, L=256 ---
    ss = build_state_space(N, K, False)
    in_idx, in_w = ss.in_table(np.log(pp))
    smu = temps[ss.states, np.arange(N)[:, None]].sum(axis=0)
    mesh4 = LocalMesh(time=4, device=dev)
    dec_args = (ys[0], in_idx, in_w, smu, sigma)
    torch.cuda.synchronize()
    t = time.perf_counter()
    x64, ll64 = sharded_blocked_viterbi(*dec_args, mesh4, L=256, dtype=f64)
    torch.cuda.synchronize()
    sh64_s = time.perf_counter() - t
    xb64, llb64 = blocked_viterbi(*dec_args, L=256, device=dev, dtype=f64)
    check(torch.equal(x64, xb64), "sharded_path: float64 sharded labels "
          "differ from the single-device blocked decode's")
    del xb64
    torch.cuda.synchronize()
    t = time.perf_counter()
    x32, ll32 = sharded_blocked_viterbi(*dec_args, mesh4, L=256, dtype=f32)
    torch.cuda.synchronize()
    sh32_s = time.perf_counter() - t
    agree32 = float((x32 == x64).double().mean())
    decode = {"mesh": mesh4.shape, "T": T, "N": N, "K": K, "S": ss.nstates,
              "L": 256, "f64_labels_equal_single_device": True,
              "ll_f64": float(ll64), "ll_f64_single_device": float(llb64),
              "f32_agreement_vs_f64": agree32,
              "f32_ll_rel_err": float(abs(ll32.double() - ll64) / abs(ll64)),
              "seconds_f64": sh64_s, "seconds_f32": sh32_s}
    del x64, x32
    secs["decode"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # ---- sharded posteriors: time 4, T=2^18, L=4096, N=2 overlaps on,
    # float32 (the structural plain engines, as in the JAX package) -----
    tm = api.HMMTemplateModel(mu=temps, sigma=sigma, lp=np.log(pp),
                              allow_overlaps=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    p_sh = sharded_onset_posteriors(tm, ys[0][:Tp], mesh4, L=Lp,
                                    gamma_batch=64)
    post_s = time.perf_counter() - t
    # the single-device chained posteriors: kernels 9-10 on the card
    p_one = tpost.onset_posteriors_chained(tm, ys[0][:Tp], L=Lp, device=dev)
    post_err = float(np.abs(p_sh - p_one).max())
    posteriors = {"mesh": mesh4.shape, "T": Tp, "L": Lp, "N": N, "K": K,
                  "S": tm.state_space.nstates, "dtype": "float32",
                  "seconds": post_s, "floor": 9.04e-5,
                  "max_abs_err_vs_single_device_chained": post_err}
    check(p_sh.shape == (Tp, N) and np.isfinite(p_sh).all(),
          "sharded_path: posteriors malformed")
    check(post_err <= 9.04e-5, f"sharded_path: sharded posteriors {post_err}"
          " from the single-device chained ones (> 9.04e-5)")
    del p_sh, p_one
    secs["posteriors"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # ---- DistMesh wiring: an NCCL group of one rank through a FileStore;
    # its axes have one shard, so no collective crosses a card --------
    em_args = (y_d[:1], *(v[:1] for v in state), tables)
    em_kw = dict(K=K, L=L, H=H, fb_mode="overlap_cuda", dtype=f32)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            got = sem.sharded_em_step(*em_args, DistMesh(1, 1, device=dev),
                                      **em_kw)
        finally:
            dist.destroy_process_group()
    ref = sem.sharded_em_step(*em_args, LocalMesh(1, 1, device=dev), **em_kw)
    dist_equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    check(dist_equal, "sharded_path: DistMesh differs from LocalMesh")
    secs["dist_mesh"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # ---- the launcher (its own JSON line, printed as it comes) ----------
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = runner.main(["--channels", "2", "--samples", "65536"],
                         device=dev)
    print(buf.getvalue(), end="", flush=True)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and rec["phase"] == "sharded_em"
          and rec["em_iter_per_s"] > 0, f"sharded_path: runner {rec}")
    secs["runner"] = time.perf_counter() - t_part

    emit({"phase": "sharded_path", "card": card,
          "em": {"mesh": mesh.shape, "C": C, "T": T, "N": N, "K": K,
                 "S": ce.S, "L": L, "H": H, "W": L + 2 * H,
                 "windows_a_launch": B, "iterations": 2,
                 "launches": launches, "step_seconds": walls,
                 "kernels": row,
                 "err_vs_single_device": {
                     k: max(e[k] for e in errs) for k in errs[0]}},
          "decode": decode, "posteriors": posteriors,
          "dist_mesh": {"backend": backend, "ranks": 1,
                        "bit_equal_local_mesh": dist_equal},
          "runner": rec, "seconds_by_part": secs})
    return launches


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
    t_start = time.perf_counter()
    emit({"phase": "platform", **platform_report(), "card": card})

    # nvcc builds every source in its own process while this one runs the
    # plain versions of kernels 1-4 (pure PyTorch, no kernel loaded), whose
    # launch-bound step loops take about as long
    build = Background(_build.build)
    cpu = CpuWorker()

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
    # native_parity's float64 references: the native engine on the CPU
    # worker, while the card runs the phases before it
    Tn = 1 << 17
    native_jobs = (cpu.submit(cpu_native_decode, temps, sigma, lp, y[:Tn]),
                   cpu.submit(cpu_native_em, temps, sigma, lp, y[:Tn]))

    # ---- kernels vs plain versions at the main path's shapes ----------
    B = -(-T // L)
    c = vmb.ov2_consts(lp, temps, sigma, dtype=torch.float32, device=dev)
    y_win, _ = _build_windows(torch.as_tensor(y, dtype=torch.float32,
                                              device=dev),
                              T=T, L=L, H=H, B=B, W=W)
    sil = torch.arange(B, device=dev) == 0
    fwd_plain_ms, (pf, pr, px) = cuda_ms(
        lambda: vmb.ov2_forward_mb_plain(y_win, sil, c), reps=1)
    bt_plain_ms, plain_labels = cuda_ms(
        lambda: vmb.ov2_backtrace_mb_plain(pf, pr, px, c.Km1), reps=1)

    # ---- the repository's N=3 configuration (BASELINE.json config 2), and
    # N=4 on 32 windows of the same width: kernels 3-4's plain versions ---
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
    c3 = vomb.ovn_consts(lp3, temps3, sigma, dtype=torch.float32, device=dev)
    y3_win, _ = _build_windows(torch.as_tensor(y3, dtype=torch.float32,
                                               device=dev),
                               T=T3, L=L, H=H3, B=B3, W=W3)
    sil3 = torch.arange(B3, device=dev) == 0
    ovn3_plain = ovn_plain(vomb, y3_win, sil3, c3)
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
    sil4 = torch.arange(B4, device=dev) == 0
    ovn4_plain = ovn_plain(vomb, y4_win, sil4, c4)

    built, build_s = build.result()
    emit({"phase": "build", "seconds": build_s,
          "overlapped_with": "the plain versions of kernels 1-4",
          "libraries": {k: v["path"] for k, v in built.items()},
          "ptxas": {k: [ln for ln in v["ptxas"].splitlines()
                        if "Used" in ln or "spill" in ln]
                    for k, v in built.items()}})
    # card_paths' inputs and tracks (kernels 5-6 and 12-13), its float64
    # references handed to the CPU worker now: they are ready by the phase
    paths = card_paths_prep(dev, card, cpu)

    # ---- kernels 1-2 vs their plain versions at the main path's shapes --
    fwd = lambda: vmb.ov2_forward_mb(y_win, sil, c)          # noqa: E731
    fwd()                                                     # warm-up
    fwd_ms, (flags, rings, xT) = cuda_ms(fwd, reps=5)
    fwd_err = max_abs_err([(flags, pf), (rings, pr), (xT, px)])
    check(torch.equal(flags, pf) and torch.equal(rings, pr)
          and torch.equal(xT, px), "kernel 1 differs from its plain version")
    bt = lambda: vmb.ov2_backtrace_mb(pf, pr, px, c.Km1)     # noqa: E731
    bt()
    bt_ms, labels, bt_each = cuda_ms_launches(bt, reps=BT_REPS)
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
    bt_bytes, ring_reads = ov2_bt_bytes(labels, px, flags, Km1)
    bt_bound = bt_bytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "kernels", "B": B, "W": W, "K": K, "dtype": "float32",
          "ov2_forward_mb": {"ms": fwd_ms, "plain_ms": fwd_plain_ms,
                             "bound_ops_ms": fwd_bound_ops,
                             "bound_bytes_ms": fwd_bound_bytes,
                             "match": True,
                             **ov2_design(
                                 vmb, B, W, Km1, dev, fwd_ms,
                                 lambda shape: vmb._forward_launch(
                                     "ov2_forward_mb", y_win, sil, c,
                                     shape=shape))},
          "ov2_backtrace_mb": {"ms": bt_ms, "plain_ms": bt_plain_ms,
                               "bound_bytes_ms": bt_bound,
                               "ring_bytes_read": ring_reads,
                               "match": True, "launch_ms": bt_each,
                               **bt_row(
                                   lambda G, st: vmb._bt_launch(
                                       pf, pr, px, Km1, segments=G,
                                       stats=st),
                                   lambda G: vmb.ov2_bt_design(W, Km1, G),
                                   labels, W, bt_ms, reps=BT_REPS)}})
    r1 = kernels_ov2_r1(vmb, y_win[:16].contiguous(), lp, temps, sigma,
                        labels[:16], card)
    del flags, rings, xT, pf, pr, px, labels, plain_labels, y_win
    tiles = kernel2_tiles_start(vmb, cpu, y, c)

    # ---- kernels 3-4 vs plain versions: N=3 at its main path's shapes,
    # N=4 at 32 windows of the same width -------------------------------
    ovn3 = ovn_kernels(vomb, y3_win, sil3, c3, ovn3_plain, fwd_reps=3,
                       bt_reps=BT_REPS)
    ovn4 = ovn_kernels(vomb, y4_win, sil4, c4, ovn4_plain, fwd_reps=2,
                       bt_reps=BT_REPS)
    del y3_win, y4_win, ovn3_plain, ovn4_plain
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
                  stream_kw, fwd_ms_p):
        """Drive api.fit_spiking_model_fast one-shot and streaming with the
        launch counts of `wrappers` set to 0 just before each call and
        read just after, against the float64 plain twin; check and emit
        (with the forward kernel's time, `fwd_ms_p`, against the one-shot
        wall). Returns the one-shot run's launch counts and decoded
        model."""
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
              "forward_kernel_ms": fwd_ms_p,
              "forward_kernel_share_of_oneshot": fwd_ms_p / 1e3 / one_s,
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
        return one_launches, one, kernel_ms / 1e3 / one_s

    one_launches, decoded_n2, main_share = main_path(
        "main_path", tm, y, truth, (vmb.ov2_forward_mb, vmb.ov2_backtrace_mb),
        fwd_ms + bt_ms, H, {}, fwd_ms)
    # streaming in batches of 64 windows (two calls in flight), not one
    # batch padded to the default 256
    one3_launches, decoded_n3, _ = main_path(
        "main_path_n3", tm3, y3, truth3,
        (vomb.ovn_forward_mb, vomb.ovn_backtrace_mb),
        ovn3["forward"]["ms"] + ovn3["backtrace"]["ms"], H3,
        {"blocks_per_call": 64}, ovn3["forward"]["ms"])

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
    # the drift tracking's shape: one 32768-sample chunk, 16 windows
    Bd = 16
    _, edge_d, lo_d, hi_d, xh_d = fb_mb._em_window_geom(Bd * Le, Le, He, Bd,
                                                        We)
    bounds_d = torch.as_tensor(np.stack([lo_d, hi_d, xh_d], 1),
                               dtype=torch.int32, device=dev).contiguous()
    yd_win = fb_mb._em_window_1d(
        torch.as_tensor(ye[:Bd * Le], dtype=torch.float32, device=dev),
        T=Bd * Le, L=Le, H=He, B=Bd, W=We, edge=edge_d).contiguous()
    em2d = em_kernels(fb_mb, yd_win, bounds_d, ce2, fwd_reps=10,
                      bwd_reps=10)
    del ye_win, yd_win
    emit({"phase": "kernels_em", "dtype": "float32", "card": card,
          "L": Le, "H": He, "n2": em2, "n7": em7, "n2_drift": em2d})

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

    # ---- the card against the native float64 engine, and a profiler trace
    # of the main path --------------------------------------------------
    native_parity(dev, card, tm, y[:Tn], native_jobs)

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
    # kernels 9-10 at posterior_path's 512 windows (T=2^21: two CTAs an SM)
    # held against the plain versions on the first PLAIN_WINDOWS windows and
    # forced to every block shape; at these 128 windows (one CTA an SM, the
    # gamma pass split) timed alone, their shape one of those checked
    g_rows, g_secs = {}, {}
    t_row = time.perf_counter()
    yk, ybk, tmk, lwk, chk = gamma_mb.chain_inputs(y, T, Lg, f32, dev)
    parts = gamma_kernels(
        lambda yw, en, hi, shape=None: gamma_ov2._fwd_launch(
            "gamma_ov2_fwd", yw, en, hi, c9, gamma_ov2.CH2, shape=shape),
        lambda yw, cp, en, hi, tx, tr, _yb, _lw, e, shape=None:
            gamma_ov2._bwd_launch("gamma_ov2_bwd", yw, cp, en, hi, tx, tr,
                                  c9, e, gamma_ov2.CH2, shape=shape),
        lambda yw, en, hi: gamma_ov2.gamma_ov2_fwd_plain(yw, en, hi, c9),
        lambda yw, cp, en, hi, tx, tr, _yb, _lw, e:
            gamma_ov2.gamma_ov2_bwd_plain(yw, cp, en, hi, tx, tr, c9, e),
        yk, ybk, tmk, lwk, chk,
        lambda ex: gamma_ov2.terminal_exits(ex, ybk, lwk, lp_d, mu_d, sg_d),
        c9, c9.S, PLAIN_WINDOWS, reps=3, shapes=ov2g_shapes(gamma_ov2, K - 1),
        fwd_shapes=ov2g_shapes(gamma_ov2, K - 1))
    by_shape = parts.pop("ms_by_shape")
    g_rows["ov2_512"] = ov2g_rows(gamma_ov2, parts, yk.shape[0], Lg, K - 1,
                                  PLAIN_WINDOWS, dev)
    g_rows["ov2_512"]["design"]["ms_by_shape"] = by_shape
    g_secs["ov2_512"] = row_seconds(t_row, parts)
    del yk, parts
    t_row = time.perf_counter()
    parts = ov2g_timed(
        gamma_ov2, lambda yw, en, hi: gamma_ov2.gamma_ov2_fwd(yw, en, hi, c9),
        lambda yw, cp, en, hi, tx, e: gamma_ov2.gamma_ov2_bwd(
            yw, cp, en, hi, tx, term, c9, e),
        yg, chained,
        lambda ex: gamma_ov2.terminal_exits(ex, ybnd, lastw, lp_d, mu_d,
                                            sg_d),
        c9.S, K - 1, by_shape, "kernels_gamma: kernels 9-10")
    g_rows["ov2"] = ov2g_rows(gamma_ov2, parts, Bg, Lg, K - 1, 0, dev)
    g_secs["ov2"] = row_seconds(t_row, parts)
    for n_g, (lp_g, mu_g, sg_g) in ((2, (lp, temps, sigma)),
                                    (7, (lp7, mu7, sig7))):
        t_row = time.perf_counter()
        cg = fb_mb.em_consts(lp_g, mu_g, sg_g, dtype=f32, device=dev)
        chg = gamma_mb.gamma_chunk(n_g, K)
        parts = gamma_kernels(
            lambda yw, en, hi, shape=None: gamma_mb.gamma_fwd_mb(
                yw, en, hi, cg, chg, shape=shape),
            lambda yw, cp, en, hi, ex, tr, yb, lw, e, shape=None:
                gamma_mb.gamma_bwd_mb(yw, cp, en, hi, ex, tr, yb, lw, cg,
                                      chg, e, shape=shape),
            lambda yw, en, hi: gamma_mb.gamma_fwd_mb_plain(yw, en, hi, cg,
                                                           chg),
            lambda yw, cp, en, hi, ex, tr, yb, lw, e:
                gamma_mb.gamma_bwd_mb_plain(yw, cp, en, hi, ex, tr, yb, lw,
                                            cg, chg, e),
            yg, ybnd, term, lastw, chained, lambda ex: ex, cg, cg.S,
            PLAIN_WINDOWS, reps=5,
            shapes=gamma_shapes(gamma_mb, n_g, K, chg),
            fwd_shapes=gamma_fwd_shapes(gamma_mb, n_g, K, chg))
        by_shape = parts.pop("ms_by_shape")
        g_rows[f"nov_n{n_g}"] = {part: gamma_row(
            {"fwd": "nov_fwd", "chain": "nov_chain",
             "gamma": "nov_gamma"}[part], *v, Bg, Lg, n_g, K - 1, chg,
            PLAIN_WINDOWS)
            for part, v in parts.items()}
        g_rows[f"nov_n{n_g}"]["design"] = gamma_design(
            gamma_mb, Bg, Lg, n_g, K, chg, dev,
            {part: v[0] for part, v in parts.items()})
        g_rows[f"nov_n{n_g}"]["design"]["ms_by_shape"] = by_shape
        g_secs[f"nov_n{n_g}"] = row_seconds(t_row, parts)
    del yg
    emit({"phase": "kernels_gamma", "dtype": "float32", "card": card,
          "T": Tg, "L": Lg, "B": Bg, "K": K, "ch_ov2": gamma_ov2.CH2,
          "ch_nov": {"n2": gamma_mb.gamma_chunk(2, K),
                     "n7": gamma_mb.gamma_chunk(7, K)},
          "seconds_by_row": g_secs, **g_rows})

    # ---- posterior_bench: bench.py's posterior problem (bench.py:216-241):
    # onset_posteriors_chained on the N=2 overlap model, T=2^19, float32,
    # after one warm-up; vs the float64 plain chained run on the card ------
    tpost.onset_posteriors_chained(tm, y[:Tg])               # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    p_po = tpost.onset_posteriors_chained(tm, y[:Tg])
    post_s = time.perf_counter() - t
    t = time.perf_counter()
    # the gamma pass in two batches of windows (about 15 GB in float64)
    p_64 = tpost.onset_posteriors_chained(tm, y[:Tg], dtype=torch.float64,
                                          batch_windows=64)
    torch.cuda.synchronize()
    p64_s = time.perf_counter() - t
    post_err = float(np.abs(p_po - p_64).max())
    # witness of the float32 floor, only where the gate is about to fail:
    # the plain chained engines in float32 (the JAX association; an
    # explicit projection keeps them off the kernels) on the same input
    plain32_err = None
    if post_err > 1e-4:
        p_32 = tpost.onset_posteriors_chained(
            tm, y[:Tg], proj=tpost.onset_projection(tm.state_space.states),
            batch_windows=64)
        plain32_err = float(np.abs(p_32 - p_64).max())
        del p_32
    dec_on = tevents._onsets_dense(decoded_n2.ml_seq[:Tg], N=N, K=K,
                                   overlaps=True)
    dec_c = np.array([len(o) for o in dec_on], float)
    exp_c = p_po.sum(axis=0)
    count_rel = float(np.max(np.abs(exp_c - dec_c) / np.maximum(dec_c, 1.0)))
    emit({"phase": "posterior_bench", "N": N, "K": K, "S": c9.S, "T": Tg,
          "L": Lg, "card": card, "seconds": post_s,
          "posterior_exact_samples_per_s": Tg / post_s,
          "posterior_count_rel_err": count_rel,
          "expected_onsets": exp_c.tolist(), "decoded_onsets": dec_c.tolist(),
          "max_abs_err_vs_f64_plain_chained": post_err,
          "kernels9_10_ms": ov2g_path_ms(g_rows["ov2"]),
          "kernels9_10_share": ov2g_path_ms(g_rows["ov2"]) / 1e3 / post_s,
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
        (gamma_ov2.gamma_ov2_fwd, gamma_ov2.gamma_ov2_bwd), card,
        ov2g_path_ms(g_rows["ov2_512"]))
    tm_nov = api.HMMTemplateModel(mu=temps, sigma=sigma, lp=lp,
                                  allow_overlaps=False)
    dec_nov = api.fit_spiking_model_fast(tm_nov, y, L=L)
    # kernels 7-8 alone at model_posteriors' 512 windows of 4096 (the
    # 128-window check above held them against their plain versions)
    c_nov = fb_mb.em_consts(lp, temps, sigma, dtype=f32, device=dev)
    ch_nov = gamma_mb.gamma_chunk(N, K)
    yn, ybn, tmn, lwn, chn = gamma_mb.chain_inputs(y, T, Lg, f32, dev)
    nov_ms = gamma_path_ms(
        lambda yw, en, hi: gamma_mb.gamma_fwd_mb(yw, en, hi, c_nov, ch_nov),
        lambda yw, cp, en, hi, ex, e: gamma_mb.gamma_bwd_mb(
            yw, cp, en, hi, ex, tmn, ybn, lwn, c_nov, ch_nov, e),
        yn, chn, c_nov.S)
    nov_ms["design"] = gamma_design(gamma_mb, yn.shape[0], Lg, N, K, ch_nov,
                                    dev, nov_ms)
    del yn
    # the shapes kernels 7-8 take here were each held bit for bit against
    # the plan's at 128 windows (kernels_gamma's ms_by_shape), and so
    # against the plain versions
    checked = g_rows["nov_n2"]["design"]["ms_by_shape"]
    for part in ("fwd", "chain", "gamma"):
        d = nov_ms["design"][part]
        key = f"spt{d['spt']}{'_split' if d['split'] else ''}"
        seen = ("fwd" in checked.get(key, {}) if part == "fwd" else
                any(k.startswith(key) if part == "chain" else k == key
                    for k in checked))
        check(seen, f"posterior_path_nov: kernel {7 if part == 'fwd' else 8}"
              f"'s {part} shape {key} at {len(chn)} windows was not checked "
              "in kernels_gamma")
    nov_launches = posterior_path(
        "posterior_path_nov", dec_nov,
        (gamma_mb.gamma_fwd_mb, gamma_mb.gamma_bwd_mb), card,
        nov_ms["path"], {"kernels7_8_512": nov_ms})

    drift = drift_path(dev, card, cpu, temps, lp, sigma, tiles)
    mc = mc_phases(dev, card)
    mcp = mc_posterior_phases(dev, card, mc["config6"])
    mc_drift = drift_path_mc(dev, card, cpu)
    rows2 = events_path(dev, card, (tm, y, decoded_n2),
                        (tm3, y3, decoded_n3, H3),
                        (mc["config6"], mc["decoded"]), drift["cli"])
    cli_path(dev, card, cpu, (tm, y, decoded_n2, temps), mc["config6"],
             drift["cli"], rows2, mc_drift["cli"])
    card_paths(dev, card, paths, mc_drift["cli"][2].track)
    cpu.close()
    sharded_launches = sharded_path(dev, card)
    # last of the phases: a profiler session may leave the host's launches
    # slower after it (trace_path prints a tiny kernel's launch cost before
    # and after), and the plain versions' loops before it are launch-bound
    trace_path(card, tm, y, L,
               lambda: tem.em_step(*a32, tab_e, K=K, fb_mode="overlap_cuda",
                                   block=2048), main_share)

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
         "launches": (em_launches["em_forward_mb"]
                      + sharded_launches["em_forward_mb"]),
         "max_abs_err": em2["forward"]["max_abs_err"],
         "ms": em2["forward"]["ms"], "plain_ms": em2["forward"]["plain_ms"],
         "bound_ms": bound_of(em2["forward"])[0],
         "bound_by": bound_of(em2["forward"])[1], "library_ms": None},
        {"name": "em_backward_mb", "route": "cuda",
         "source": "hmmspikesorter_torch/csrc/em_bwd.cu",
         "replaces": "hmmspikesorter_tpu/ops/pallas_fb_mb.py:209",
         "launches": (em_launches["em_backward_mb"]
                      + sharded_launches["em_backward_mb"]),
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
                    post_launches["gamma_ov2_fwd"], g_rows["ov2_512"]["fwd"]),
        gamma_entry("gamma_ov2_bwd", "gamma_ov2_bwd.cu",
                    "pallas_gamma_ov2.py:237",
                    post_launches["gamma_ov2_bwd"],
                    g_rows["ov2_512"]["gamma"]),
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
        gamma_entry("ov2_forward_mb_tracked", "viterbi_ov2_fwd.cu",
                    "pallas_viterbi_mb.py:66",
                    drift["fit_launches"]["ov2_forward_mb_tracked"],
                    drift["row16"]),
        gamma_entry("gamma_ov2_fwd_tracked", "gamma_ov2_fwd.cu",
                    "pallas_gamma_ov2.py:170",
                    drift["post_launches"]["gamma_ov2_fwd_tracked"],
                    drift["rows17"]["w512"]["fwd"]),
        gamma_entry("gamma_ov2_bwd_tracked", "gamma_ov2_bwd.cu",
                    "pallas_gamma_ov2.py:237",
                    drift["post_launches"]["gamma_ov2_bwd_tracked"],
                    drift["rows17"]["w512"]["gamma"]),
        gamma_entry("ov2_forward_cuda", "viterbi_ov2_fwd.cu",
                    "pallas_viterbi.py:55", r1["launches"], r1),
        gamma_entry("ovn_mc_forward_mb_tracked", "viterbi_ovn_mc_fwd.cu",
                    "pallas_viterbi_ovn_mb.py:739",
                    mc_drift["fit_launches"]["ovn_mc_forward_mb_tracked"],
                    mc_drift["row11"]),
    ]})
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start,
          "limit_seconds": 1200})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    # nothing in the port takes a gradient: inference mode drops autograd's
    # bookkeeping from every operation, most of all from the plain versions'
    # step loops, whose launches set most of the wall
    with torch.inference_mode():
        sys.exit(main())
