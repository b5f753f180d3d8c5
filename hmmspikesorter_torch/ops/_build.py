"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and becomes its own
shared library, `build/kernels/lib<name>-<hash>.so` under the repository
root (git-ignored). The hash covers the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source, header or flag builds
anew and a stale library is never loaded. Sources are
compiled at first use, one nvcc process per source, all started together.

Flags: `sm_90a` (Hopper), `-O3`, and `--fmad=false`: the plain PyTorch
versions round every multiply and add separately, and a fused multiply-add
in the kernel would move scores by an ulp and flip near-tie choices. The
kernels also spell their arithmetic with `__fadd_rn`/`__fmul_rn`, which
nvcc never contracts; the flag guards everything else. `-Xptxas -v` keeps
the register and spill report, returned by `build()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

from ..utils.device import nvcc_path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("viterbi_ov2_fwd", "viterbi_ov2_bt", "viterbi_ovn_fwd",
           "viterbi_ovn_bt", "em_fwd", "em_bwd", "gamma_fwd", "gamma_bwd",
           "gamma_ov2_fwd", "gamma_ov2_bwd", "viterbi_ovn_mc_fwd",
           "em_mc_fwd", "em_mc_bwd", "gamma_mc_fwd", "gamma_mc_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source whose library is missing, in parallel.

    Returns {name: {"path", "built", "seconds", "ptxas"}}; raises with
    nvcc's output if any compile fails."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        out[name] = {"path": str(target), "built": False, "seconds": 0.0,
                     "ptxas": ""}
        if target.exists():
            continue
        if nvcc is None:
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                               "built on this host")
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)         # atomic: no reader sees a partial .so
        out[name].update(built=True, ptxas=log,
                         seconds=time.perf_counter() - t0)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
