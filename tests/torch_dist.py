"""The sharded paths of hmmspikesorter_torch on one mesh, for the test that
holds a DistMesh (a gloo group of spawned processes, one shard each) to a
LocalMesh of the same shape (tests/test_torch_sharded.py). Imports torch
and the port only: a spawned rank stays free of JAX."""

import numpy as np
import torch


def inputs():
    """Seeded numpy inputs of every sharded path `run` drives."""
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.data.synthetic import (create_signal,
                                                     create_spike_template)

    out = {}
    for K in (8, 12):
        temps = np.stack([create_spike_template(K, 3.0, 0.8, 0.2),
                          create_spike_template(K, 4.0, 0.3, 0.2)], axis=1)
        out[f"temps{K}"] = temps
    pp = np.array([0.008, 0.005])
    out["lp"] = np.log(pp)
    ss = build_state_space(2, 12, False)
    out["in_idx"], out["in_w"] = ss.in_table(out["lp"])
    out["smu"] = (out["temps12"][ss.states, np.arange(2)[:, None]]).sum(0)
    rng = np.random.default_rng(3)
    out["y"] = np.stack([create_signal(4096, 0.3, pp, out["temps12"],
                                       rng=rng)[0] for _ in range(2)])
    out["y8"] = create_signal(1024, 0.3, pp, out["temps8"], rng=rng)[0]
    return out


def run(mesh_of, d):
    """Every sharded path on meshes `mesh_of(channel, time)` (a (1, 2) mesh
    and a (2, 1) mesh) with the inputs `d`; returns a dict of tensors."""
    from hmmspikesorter_torch.convert import template_model_from_numpy
    from hmmspikesorter_torch.core.state_space import build_state_space
    from hmmspikesorter_torch.parallel.sharded import sharded_blocked_viterbi
    from hmmspikesorter_torch.parallel.sharded_em import sharded_em_step
    from hmmspikesorter_torch.parallel.sharded_posterior import \
        sharded_onset_posteriors
    from hmmspikesorter_torch.train.em import EMTables

    out = {}
    time2 = mesh_of(1, 2)
    out["x"], out["ll"] = sharded_blocked_viterbi(
        d["y"][0, :2000], d["in_idx"], d["in_w"], d["smu"], 0.3, time2, L=128)
    tables = EMTables.build(build_state_space(2, 12, False), "cpu")
    args = (d["y"], np.stack([d["lp"]] * 2), np.stack([d["temps12"]] * 2),
            np.full(2, 0.3), tables)
    for name, mesh, mode in (("blocked", time2, "blocked"),
                             ("overlap", time2, "overlap"),
                             ("overlap_cuda", time2, "overlap_cuda"),
                             ("blocked_channel", mesh_of(2, 1), "blocked")):
        res = sharded_em_step(*args, mesh, K=12, L=256 if mode == "blocked"
                              else 512, fb_mode=mode, H=64)
        for i, v in enumerate(res):
            out[f"{name}{i}"] = v
    tm = template_model_from_numpy(d["temps8"], 0.3, d["lp"], True)
    out["posteriors"] = torch.as_tensor(
        sharded_onset_posteriors(tm, d["y8"], time2, L=256))
    return out


def make_mesh_shapes():
    """What runner.make_mesh infers in a process group: the shapes of
    make_mesh() and make_mesh(channel_shards=2), and the error of
    make_mesh(time_shards=3)."""
    from hmmspikesorter_torch.parallel import runner

    out = [runner.make_mesh(device="cpu").shape,
           runner.make_mesh(channel_shards=2, device="cpu").shape]
    try:
        runner.make_mesh(time_shards=3, device="cpu")
        out.append(None)
    except ValueError as e:
        out.append(type(e).__name__)
    return out


def rank_main(rank, world, store_path, in_path, out_path):
    """One rank of a gloo group over a FileStore: `run` on DistMeshes and
    `make_mesh_shapes`, the results saved to out_path."""
    import torch.distributed as dist

    from hmmspikesorter_torch.parallel.mesh import DistMesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        with np.load(in_path) as f:
            d = dict(f)
        out = run(lambda c, t: DistMesh(c, t, device="cpu"), d)
        torch.save({"run": out, "make_mesh": make_mesh_shapes()}, out_path)
    finally:
        dist.destroy_process_group()
