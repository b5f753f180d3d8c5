"""Multi-process entry point (counterpart of the JAX package's
parallel/runner.py): initialise torch.distributed where asked, build the
(channel, time) mesh, and run the sharded EM step.

The reference has no distributed story (SURVEY.md §5.8); this is the
launcher for BASELINE config 5 (64 channels x 10M samples, time-block
sharded with boundary collectives).

One process on one device (a LocalMesh of the given shard counts):

    python -m hmmspikesorter_torch.parallel.runner --channels 8 \\
        --samples 1048576 --time-shards 4 --channel-shards 2

One process a card (a DistMesh over NCCL; every process gets the same
flags and its own --process-id):

    python -m hmmspikesorter_torch.parallel.runner --channels 64 \\
        --samples 10000000 --time-shards 4 --coordinator host:port \\
        --num-processes 4 --process-id 0

Emits one JSON line of results (every process prints its own).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..utils.device import default_dtype, resolve_device


def make_mesh(time_shards: int | None = None,
              channel_shards: int | None = None, *, config=None,
              device=None):
    """Build a (channel, time) mesh on `device` (default CUDA).

    Counts not passed explicitly come from a config.Config's mesh section
    (SURVEY.md §5.6). With an initialised default process group the mesh
    is a DistMesh over its ranks, and a count still missing is inferred
    from the world size (all of it on the time axis when neither is
    given); the counts must multiply to it. Otherwise it is a LocalMesh of
    the counts, each defaulting to 1."""
    import torch.distributed as dist

    from ..config import UNSET, _section
    from .mesh import DistMesh, LocalMesh

    mc = _section(config, "mesh")
    if time_shards is None and mc("time_shards") not in (UNSET, None):
        time_shards = mc("time_shards")
    if channel_shards is None and mc("channel_shards") not in (UNSET, None):
        channel_shards = mc("channel_shards")

    if not (dist.is_available() and dist.is_initialized()):
        return LocalMesh(1 if channel_shards is None else channel_shards,
                         1 if time_shards is None else time_shards,
                         device=device)
    n = dist.get_world_size()
    if time_shards is None:
        time_shards = n if channel_shards is None else n // channel_shards
    if channel_shards is None:
        channel_shards = n // time_shards
    if time_shards * channel_shards != n:
        raise ValueError(f"{time_shards} x {channel_shards} != {n} devices")
    return DistMesh(channel_shards, time_shards, device=device)


def main(argv=None, *, device=None) -> int:
    """The launcher (flags as the JAX runner's). `device` is this
    process's device (default CUDA; under --coordinator, card process-id
    modulo the cards visible)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--samples", type=int, default=1 << 20)
    ap.add_argument("--time-shards", type=int, default=None)
    ap.add_argument("--channel-shards", type=int, default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 for "
                         "torch.distributed.init_process_group "
                         "(multi-process runs)")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--em-iters", type=int, default=2)
    ap.add_argument("--K", type=int, default=60)
    ap.add_argument("--block", type=int, default=4096)
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    if not args.coordinator:
        return _run(args, dev)
    import torch.distributed as dist

    if dev.type == "cuda":
        dev = torch.device("cuda", args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{args.coordinator}",
        world_size=args.num_processes, rank=args.process_id)
    try:
        return _run(args, dev)
    finally:
        dist.destroy_process_group()


def _run(args, dev) -> int:
    """main's body on `dev`: the mesh, the signals and the timed EM."""
    from ..core.state_space import build_state_space
    from ..data.synthetic import create_signal, create_spike_template
    from ..train.em import EMTables
    from .sharded_em import sharded_em_step

    mesh = make_mesh(args.time_shards, args.channel_shards, device=dev)
    K = args.K
    N = 2
    sigma = 0.3
    tdev = mesh.shape["time"]
    L = args.block
    T = -(-args.samples // (tdev * L)) * (tdev * L)
    C = max(args.channels, mesh.shape["channel"])

    temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                      create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
    pp = np.array([0.003, 0.001])
    rng = np.random.default_rng(0)
    ys = np.stack([create_signal(T, sigma, pp, temps, rng=rng)[0]
                   for _ in range(C)]).astype(np.float32)

    tables = EMTables.build(build_state_space(N, K, False), mesh.device)
    lp = np.log(pp)
    lps = np.stack([lp] * C)
    mus = np.stack([temps] * C)
    sigmas = np.full(C, sigma)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    # a LocalMesh holds the batch on its device from here on; a DistMesh
    # keeps it on the host, and each step copies only the rank's shard
    ys = mesh.stage(ys, default_dtype(mesh.device))

    # warm + timed EM steps (channel x time sharded)
    out = sharded_em_step(ys, lps, mus, sigmas, tables, mesh, K=K, L=L)
    sync()
    t0 = time.time()
    for _ in range(args.em_iters):
        out = sharded_em_step(ys, out[0], out[2], out[3], tables, mesh, K=K,
                              L=L)
        sync()
    elapsed = time.time() - t0
    print(json.dumps({
        "phase": "sharded_em",
        "mesh": dict(mesh.shape),
        "channels": C, "samples": T,
        "em_iter_per_s": round(args.em_iters / elapsed, 4),
        "samples_per_s": round(args.em_iters * C * T / elapsed, 1),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
