"""ctypes bindings for the native CPU engine (ref_engine.cpp).

A single-thread C++ engine with the reference's loop semantics: the CPU
baseline a benchmark reports the card against, and a float64 oracle that
shares no code with the port's engines or kernels. `ref_engine.cpp` is a
byte-for-byte copy of the JAX package's source (a test compares the
bytes); this loader takes the port's `core/state_space` objects and
returns numpy arrays, as the JAX package's loader does.

The library is built on first use with `g++ -O3 -shared -fPIC` into
`build/native/lib_ref_engine-<sha16>.so` under the repository root
(git-ignored), keyed on a hash of the source, so a stale or foreign binary
is never loaded. Portable flags only (no -march=native): the baseline must
run on any x86-64 host. The compiler writes to a name of its own in the
same directory and the result is renamed into place, so processes that
build at once never load a partial file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "ref_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int32)

_lib = None


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib_ref_engine-{h}.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, path)          # atomic: no reader sees a partial .so
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> ctypes.CDLL:
    """The loaded engine, built first if its library is missing or does
    not load (e.g. a file truncated by an interrupted build)."""
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if not path.exists():
        _build(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        _build(path)
        lib = ctypes.CDLL(str(path))
    i64, f64 = ctypes.c_int64, ctypes.c_double
    lib.hmmss_viterbi.argtypes = [_DP, i64, _IP, _IP, _DP, i64, _DP, i64,
                                  f64, _IP, _DP]
    lib.hmmss_forward.argtypes = [_DP, i64, _IP, _IP, _DP, i64, _DP, i64,
                                  f64, _DP]
    lib.hmmss_backward.argtypes = lib.hmmss_forward.argtypes
    lib.hmmss_em_step.argtypes = [_DP, i64, _IP, _IP, _DP, i64, _DP, i64,
                                  i64, i64, f64, _DP, _DP, _DP, _DP]
    for fn in (lib.hmmss_viterbi, lib.hmmss_forward, lib.hmmss_backward,
               lib.hmmss_em_step):
        fn.restype = None
    _lib = lib
    return lib


def _as(arr, dtype):
    return np.ascontiguousarray(np.asarray(arr), dtype=dtype)


def _model_args(ss, lp, mu):
    """Edge lists, edge weights and per-state means (summed in mu's own
    dtype, as the JAX loader sums them) as the engine takes them:
    contiguous int32 / float64."""
    efrom = _as(ss.edges_from, np.int32)
    eto = _as(ss.edges_to, np.int32)
    ew = _as(ss.edge_weights(lp), np.float64)
    smu = _as(np.asarray(mu)[ss.states, np.arange(ss.n_neurons)[:, None]]
              .sum(axis=0), np.float64)
    return efrom, eto, ew, smu


def viterbi(y, ss, lp, mu, sigma):
    """Reference-semantics Viterbi (native). Returns (x int32, ll)."""
    lib = get_lib()
    y = _as(y, np.float64)
    efrom, eto, ew, smu = _model_args(ss, lp, mu)
    x = np.empty(len(y), np.int32)
    ll = ctypes.c_double()
    lib.hmmss_viterbi(
        y.ctypes.data_as(_DP), len(y), efrom.ctypes.data_as(_IP),
        eto.ctypes.data_as(_IP), ew.ctypes.data_as(_DP), len(ew),
        smu.ctypes.data_as(_DP), ss.nstates, float(sigma),
        x.ctypes.data_as(_IP), ctypes.byref(ll))
    return x, ll.value


def _fb(fn_name, y, ss, lp, mu, sigma):
    lib = get_lib()
    y = _as(y, np.float64)
    efrom, eto, ew, smu = _model_args(ss, lp, mu)
    out = np.empty((len(y), ss.nstates), np.float64)
    getattr(lib, fn_name)(
        y.ctypes.data_as(_DP), len(y), efrom.ctypes.data_as(_IP),
        eto.ctypes.data_as(_IP), ew.ctypes.data_as(_DP), len(ew),
        smu.ctypes.data_as(_DP), ss.nstates, float(sigma),
        out.ctypes.data_as(_DP))
    return out


def forward(y, ss, lp, mu, sigma):
    """(T, S) alpha — reference src/baumwelch.jl:25-51 semantics (native)."""
    return _fb("hmmss_forward", y, ss, lp, mu, sigma)


def backward(y, ss, lp, mu, sigma):
    """(T, S) beta — reference src/baumwelch.jl:73-98 semantics (native)."""
    return _fb("hmmss_backward", y, ss, lp, mu, sigma)


def em_step(y, ss, lp, mu, sigma):
    """One reference-semantics Baum-Welch iteration (src/baumwelch.jl:
    205-309), single thread — the measured EM iterations/s CPU baseline.

    Returns (new_lp (N,), new_mu (K, N), new_sigma, ll)."""
    lib = get_lib()
    y = _as(y, np.float64)
    mu = _as(mu, np.float64)
    efrom, eto, ew, smu = _model_args(ss, lp, mu)
    K, N = mu.shape
    new_lp = np.empty(N, np.float64)
    new_mu = np.empty((K, N), np.float64)
    new_sigma = ctypes.c_double()
    ll = ctypes.c_double()
    lib.hmmss_em_step(
        y.ctypes.data_as(_DP), len(y), efrom.ctypes.data_as(_IP),
        eto.ctypes.data_as(_IP), ew.ctypes.data_as(_DP), len(ew),
        smu.ctypes.data_as(_DP), ss.nstates, N, K, float(sigma),
        new_lp.ctypes.data_as(_DP), new_mu.ctypes.data_as(_DP),
        ctypes.byref(new_sigma), ctypes.byref(ll))
    return new_lp, new_mu, new_sigma.value, ll.value
