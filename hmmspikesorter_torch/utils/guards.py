"""NaN/-inf guard machinery (counterpart of the JAX package's
utils/guards.py).

The reference has no sanitizers; its failure mode is silent NaN
propagation through log-space recursions (sigma collapsing to 0, exp
overflow in a logsumexp). The port's hot paths are plain functions, so
guarding is a wrapper concern:

* `checked(fn)` — wraps a function so that NaN in any floating-point
  output (or, with check_inputs, argument) raises FloatingPointError
  naming the leaf, instead of propagating silently. A debug wrapper for
  tests and debug runs; no production path applies it.
* `assert_finite_tree(tree)` — host-side eager validation of a nested
  structure (dicts, lists, tuples) of numpy arrays and torch tensors:
  raises ValueError naming the leaf. -inf is permitted (log-space padding
  is -inf by design); NaN is not.
* `guard_inputs(y, sigma)` — the input-validation bail the CLI applies
  before decoding (the reference's input checks, hmmsort.jl:40-53, extended
  to data sanity); a copy of the JAX function, pure numpy.

Leaves are numbered in the JAX tree order: dict keys sorted, lists and
tuples in order, None no leaf, anything else one leaf.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _is_float(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    if isinstance(leaf, float):
        return True
    return (isinstance(leaf, (np.ndarray, np.generic))
            and leaf.dtype.kind == "f")


def _first_nan(tree):
    """Index (in the JAX leaf order) of the first floating-point leaf that
    holds a NaN, or None. The tensors' tests are gathered per device and
    read in one copy each, so a CUDA tree synchronises once."""
    flags = {}                        # device -> [(leaf index, flag)]
    for i, leaf in enumerate(_leaves(tree)):
        if not _is_float(leaf):
            continue
        if isinstance(leaf, torch.Tensor):
            flags.setdefault(leaf.device, []).append(
                (i, torch.isnan(leaf.detach()).any()))
        elif np.isnan(leaf).any():
            flags.setdefault(None, []).append((i, True))
    hits = []
    for dev, pairs in flags.items():
        if dev is None:
            hits += [i for i, _ in pairs]
        else:
            seen = torch.stack([f for _, f in pairs]).cpu().tolist()
            hits += [i for (i, _), hit in zip(pairs, seen) if hit]
    return min(hits, default=None)


def checked(fn, *, check_inputs: bool = False):
    """Wrap `fn` so NaNs in its floating-point outputs (and, with
    check_inputs, its arguments, checked before the call) raise
    FloatingPointError("NaN in output leaf {i}" / "NaN in input leaf {i}")
    instead of propagating. -inf passes. `fn` runs eagerly; the check
    reads each device's flags in one copy after the call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if check_inputs:
            i = _first_nan((args, kwargs))
            if i is not None:
                raise FloatingPointError(f"NaN in input leaf {i}")
        out = fn(*args, **kwargs)
        i = _first_nan(out)
        if i is not None:
            raise FloatingPointError(f"NaN in output leaf {i}")
        return out

    return wrapper


def assert_finite_tree(tree, *, name: str = "tree") -> None:
    """Raise ValueError if any array leaf contains NaN (-inf is allowed:
    log-space padding uses it by design). Leaves are visited in the JAX
    tree order (dict keys sorted)."""
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and np.isnan(arr).any():
            raise ValueError(f"{name}: NaN in leaf {i} "
                             f"(shape {arr.shape}, dtype {arr.dtype})")


def guard_inputs(y, sigma) -> None:
    """Validate decode inputs before touching the device (CLI bail path).

    y: a (T,) trace or a (C, T) channel batch. sigma: a scalar or a (C,)
    per-channel vector (every entry is checked — a single bad channel
    NaN-poisons the joint MC decode as surely as a bad scalar)."""
    y = np.asarray(y)
    if y.ndim not in (1, 2) or y.size == 0:
        raise ValueError(f"signal must be a non-empty 1-D trace or 2-D "
                         f"channel batch, got {y.shape}")
    if (not np.issubdtype(y.dtype, np.integer)
            and not np.isfinite(y).all()):
        # inf is as fatal as NaN here: an inf sample makes the emission
        # -inf and 0 * -inf turns into NaN inside the one-hot selection
        # matmuls of the table-driven engines. (Integer data cannot hold
        # either — the check is skipped so raw int16 recordings don't pay
        # a full float materialization.)
        raise ValueError("signal contains NaN or infinite samples")
    sigma = np.asarray(sigma, np.float64)
    if not np.isfinite(sigma).all() or (sigma <= 0).any():
        raise ValueError(f"noise sigma must be finite and positive, "
                         f"got {sigma}")
