"""Multi-device decode: time-axis sharding over a mesh (counterpart of the
JAX package's parallel/sharded.py; parallel/mesh.py stands for
`jax.sharding.Mesh` and `shard_map`).

The reference has no distributed story at all (SURVEY.md §5.8); this
module maps its one scale mechanism (chunked decode) onto a device mesh:

* **time axis**: each shard owns a contiguous span of the signal and runs
  the exact blocked Viterbi (parallel/block_viterbi.py) on its local
  blocks. Cross-shard coupling is tiny:
    - boundary score vectors: each shard composes its local block
      operators into one shard-level max-plus operator (S x S),
      all-gathers the per-shard operators (D * S^2), and computes its
      prefix boundary vector redundantly;
    - path stitching: per-block entry maps (B, S) and the shards' final
      scores are all-gathered and the end-state chain is computed
      redundantly on every shard; each shard then emits its label span,
      and one psum adds the shards' ll.
  The result is the single-device blocked decode's (the operator algebra
  is associative; only the grouping changes) and matches the sequential
  engine exactly in float64 in the tests.

* **channel axis**: independent recordings are data-parallel; no
  collectives.
"""

from __future__ import annotations

import torch

from ..core.emission import emission_logprob
from ..core.viterbi import viterbi_decode_batched
from ..utils.device import as_float, default_dtype
from .block_fb import _logplus_eye
from .block_viterbi import _block_operator, _block_redecode, _gather_path


def _maxplus_compose(M1, M2):
    """(M1 then M2) max-plus composition: out[i,j] = max_k M1[i,k]+M2[k,j]
    (leading batch axes broadcast)."""
    return torch.amax(M1[..., :, :, None] + M2[..., None, :, :], dim=-2)


def _local_blocked_decode(v0_global, em_steps_local, mask_local, in_idx,
                          in_w, *, L, axis):
    """Per-shard body of the time-sharded exact Viterbi.

    em_steps_local: (Dl, Tl, S), the local shards' transition-step
    emissions (global steps t=1..T-1, evenly split); mask_local (Dl, Tl)
    marks real steps. Returns the local labels (Dl, Tl), the global ll and
    the global first-sample state.
    """
    Dl, Tl, S = em_steps_local.shape
    B = Tl // L
    em_blocks = em_steps_local.reshape(Dl * B, L, S)
    mask_blocks = mask_local.reshape(Dl * B, L)

    # phase 1: local block operators, then one shard-level operator
    ops = _block_operator(em_blocks, mask_blocks, in_idx, in_w).reshape(
        Dl, B, S, S)
    dev_op = _logplus_eye(S, ops.dtype, ops.device).expand(Dl, S, S)
    for b in range(B):
        dev_op = _maxplus_compose(dev_op, ops[:, b])

    # shard-prefix boundary vector (redundant compute, tiny data)
    all_ops = axis.all_gather(dev_op)                    # (D, S, S)
    didx = axis.index()
    v = v0_global.expand(Dl, S)
    for i in range(axis.size):
        nxt = torch.amax(v[:, :, None] + all_ops[i], dim=1)
        v = torch.where((i < didx)[:, None], nxt, v)     # prefix: ops < didx

    # phase 2: local boundary chain + the blocks' re-decode in one batch
    alpha0s = []
    for b in range(B):
        alpha0s.append(v)
        v = torch.amax(v[:, :, None] + ops[:, b], dim=1)
    scores, paths, entries, finals = _block_redecode(
        torch.stack(alpha0s, dim=1).reshape(Dl * B, S), em_blocks,
        mask_blocks, in_idx, in_w)

    # phase 3: global stitch over every shard's entries (D*B, S)
    all_entries = axis.all_gather(entries.reshape(Dl, B, S)).reshape(-1, S)
    all_final = axis.all_gather(finals.reshape(Dl, B, S)[:, -1])   # (D, S)
    end = torch.argmax(all_final[-1])                    # first max
    all_ends = [None] * all_entries.shape[0]
    for k in range(all_entries.shape[0] - 1, -1, -1):
        all_ends[k] = end
        end = all_entries[k, end]
    ends = torch.stack(all_ends).reshape(axis.size, B)[didx]       # (Dl, B)

    x_loc, ll_loc = _gather_path(scores.reshape(Dl, B, L, S),
                                 paths.reshape(Dl, B, L, S), ends,
                                 mask_local.reshape(Dl, B, L))
    return x_loc, axis.psum(ll_loc), end


def sharded_blocked_viterbi(y, in_idx, in_w, state_mu, sigma, mesh, *,
                            L: int = 256, axis: str = "time", dtype=None):
    """Exact Viterbi decode of one sequence, time-sharded over
    `mesh`'s axis `axis`, on the mesh's device (dtype float32 on CUDA,
    float64 on the CPU unless given).

    Returns (x (T,) int64, ll 0-d tensor), identical to blocked_viterbi /
    the sequential engine, on every process of the mesh. The T-1
    transition steps are padded to a multiple of D * L; y itself may be
    any length.
    """
    dev = mesh.device
    dtype = default_dtype(dev) if dtype is None else dtype
    ax = mesh.axis(axis)
    state_mu = as_float(state_mu, dtype, dev)
    in_idx = torch.as_tensor(in_idx, device=dev).long()
    in_w = as_float(in_w, dtype, dev)
    sigma = as_float(sigma, dtype, dev)
    y = mesh.stage(y, dtype)
    T = y.shape[0]
    v0 = emission_logprob(as_float(y[0], dtype, dev), state_mu,
                          sigma).clone()
    v0[0] = 0.0                                      # forced silent start

    # pad the steps to a multiple of D*L; each shard takes the emissions of
    # its own span only
    Tm1 = T - 1
    n = -(-Tm1 // (ax.size * L)) * ax.size * L
    y_steps = torch.nn.functional.pad(y[1:], (0, n - Tm1))
    mask = torch.arange(n, device=dev) < Tm1
    y_loc = as_float(mesh.local(y_steps, axis), dtype, dev)  # (Dl, n / D)
    em_loc = emission_logprob(y_loc, state_mu, sigma)
    x_loc, ll, x0 = _local_blocked_decode(
        v0, em_loc, mesh.local(mask, axis), in_idx, in_w, L=L, axis=ax)
    x_steps = mesh.gather(x_loc, axis)
    return torch.cat([x0[None], x_steps[:Tm1]]), ll


def batched_decode_sharded(y_batch, in_idx, in_w, state_mu, sigma, mesh, *,
                           axis: str = "channel", dtype=None):
    """Channel-parallel decode: a (C, T) batch sharded over `mesh`'s axis
    `axis` (data parallelism, no collectives inside), each row decoded by
    core/viterbi.viterbi_decode on the mesh's device. Returns (x (C, T)
    int64, ll (C,)) on every process of the mesh."""
    dev = mesh.device
    dtype = default_dtype(dev) if dtype is None else dtype
    state_mu = as_float(state_mu, dtype, dev)
    y_loc = as_float(mesh.local(mesh.stage(y_batch, dtype), axis), dtype,
                     dev)                                # (Dl, C/D, T)
    Dl, Cl, T = y_loc.shape
    x, ll = viterbi_decode_batched(y_loc.reshape(Dl * Cl, T), in_idx, in_w,
                                   state_mu, sigma)
    return (mesh.gather(x.reshape(Dl, Cl, T), axis),
            mesh.gather(ll.reshape(Dl, Cl), axis))
