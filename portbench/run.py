"""The benchmark of hmmspikesorter_torch: one cell, one process, one card.

    python portbench/run.py --workload n2.sort --seed 7 --seconds 30 --trace 0

run from the root of a checkout. The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration (`portbench/configs/<name>.json`) and a
traffic mix (`portbench/traffic/<name>.json`), whose `entry` names the
driver of the program's call (`portbench/entries/<entry>.py`). Set-up makes
a pool of recordings from the seed and warms the call; the window then
calls the program in a closed loop for `--seconds`, one recording after
the last returned (one client). After the window the answers kept from it
are judged against the plain reference (`portbench/reference/`), each
number beside its limit (`portbench/limits/<cell>.json`).

With `--trace 0` the result line carries the cell's end-to-end metrics
(`portbench/e2e/<name>.py`); with `--trace 1` a part of the window runs
under torch.profiler and the line carries its per-layer metrics
(`portbench/layers/<name>.py`, or the file of the name before its first
dot). The last line of standard output is the result; the compared
numbers are the last lines of standard error.
"""

from __future__ import annotations

import time

T_MODULE = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "hmmspikesorter_tpu")
WARM_CALLS = 2      # calls in set-up, on recordings 0 and 1
KEEP = 2            # answers kept of each recording for the comparison


def process_start() -> float:
    """The wall time this process started (Linux), else this module's."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_MODULE


class Fail(Exception):
    """A run that prints no result: the message goes to standard error."""


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(kind: str, name: str) -> Path:
    """The reader of metric `name`: portbench/<kind>/<name>.py, else the
    file of the name before its first dot, which metrics that differ only
    in the cells that report them share (device_idle_pct.sort and
    device_idle_pct.train read portbench/layers/device_idle_pct.py)."""
    path = BENCH / kind / f"{name}.py"
    return path if path.is_file() else BENCH / kind / f"{name.split('.')[0]}.py"


def load_json(path: Path):
    if not path.is_file():
        raise Fail(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def cell_spec(bench, workload):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Fail(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT / cfgs[w["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    return w, cfg, traffic, limits


def reports(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(bench, workload, trace):
    e2e = [m for m in bench["end_to_end"] if reports(m, workload)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_loaded():
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(FORBIDDEN))


def nvidia_smi():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


class Window:
    """What the closed loop measured."""

    def __init__(self):
        self.t0 = self.t1 = None
        self.latencies = []
        self.samples = 0
        self.attempted = 0
        self.failed = 0
        self.setup_s = None

    @property
    def seconds(self):
        return self.t1 - self.t0


def run_window(entry, n_pool, seconds, keep, rng, tracer=None,
               trace_calls=0, trace_from=0.2):
    """Calls the program in a closed loop for `seconds`, recording i % n_pool
    at call i. Keeps up to `keep` answers of each recording, a uniform sample
    drawn from `rng` (reservoir). With a tracer, `trace_calls` calls from
    `trace_from` of the window on run under the profiler. Returns (Window,
    kept {i: [answer]}, metas of the traced calls, errors)."""
    import torch

    w = Window()
    kept = {i: [] for i in range(n_pool)}
    seen = [0] * n_pool
    metas, errors = [], []
    tracing = done = False
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (
        lambda: None)
    sync()
    w.t0 = time.perf_counter()
    end = w.t0 + seconds
    i = 0
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if tracer is not None:
            if not tracing and not done and now >= w.t0 + trace_from * seconds:
                tracer.start()
                tracing = True
            elif tracing and len(metas) >= trace_calls:
                tracer.stop()
                tracing, done = False, True
        r = i % n_pool
        w.attempted += 1
        t0 = time.perf_counter()
        try:
            if tracing:
                with tracer.call():
                    ans, n = entry.call(r)
            else:
                ans, n = entry.call(r)
        except Exception as e:  # noqa: BLE001 - a failed request is counted
            w.failed += 1
            errors.append(f"call {i} (recording {r}): {type(e).__name__}: {e}")
            i += 1
            continue
        t1 = time.perf_counter()
        w.latencies.append(t1 - t0)
        w.samples += n
        w.t1 = t1
        if tracing:
            metas.append(entry.meta(ans))
        seen[r] += 1
        if len(kept[r]) < keep:
            kept[r].append(ans)
        else:
            j = int(rng.integers(0, seen[r]))
            if j < keep:
                kept[r][j] = ans
        i += 1
    if tracing:
        tracer.stop()
    if w.t1 is None:
        w.t1 = time.perf_counter()
    return w, kept, metas, errors


def main(argv=None, *, device=None, overrides=None) -> int:
    """Runs one cell; returns the exit code. `device` and `overrides`
    (dicts merged into the configuration, traffic and limits, and `bench`,
    a BENCHMARK.json of the caller's own) serve the tests, which run the
    harness on the CPU at small sizes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    try:
        result, checks, info = run_cell(args, t_start, device, overrides or {})
    except Fail as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    for line in info:
        print(line, file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(args, t_start, device, overrides):
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    bench = overrides.get("bench") or load_json(ROOT / "BENCHMARK.json")
    w_spec, cfg, traffic, limits = cell_spec(bench, args.workload)
    cfg.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    limits.update(overrides.get("limits", {}))
    metrics = cell_metrics(bench, args.workload, args.trace)

    import numpy as np
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise Fail("no CUDA device: this benchmark measures the card")
        if torch.cuda.device_count() < w_spec["chips"]:
            raise Fail(f"{args.workload} needs {w_spec['chips']} cards, "
                       f"{torch.cuda.device_count()} present")
        device = "cuda"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    try:
        import hmmspikesorter_torch  # noqa: F401
    except ImportError as e:
        raise Fail(f"the program is not in this checkout: {e}") from e
    from portbench.compare import judge
    from portbench.gen.pool import make_pool

    seed = args.seed % (1 << 63)
    marks = [("imports", time.time())]
    if device == "cuda":
        torch.zeros(1, device=device)
        marks.append(("cuda context", time.time()))
    entry_mod = load_module(BENCH / "entries" / f"{traffic['entry']}.py")
    entry = entry_mod.Entry(cfg, traffic, device)
    marks.append(("entry", time.time()))
    pool = make_pool(cfg, traffic["pool"], entry.samples, seed)
    marks.append(("recordings", time.time()))
    entry.setup(pool, seed)
    marks.append(("entry set-up", time.time()))
    for r in range(min(WARM_CALLS, len(pool))):
        entry.call(r)
    if device == "cuda":
        torch.cuda.synchronize()
    marks.append(("warm calls", time.time()))
    tracer = None
    if args.trace:
        from portbench.trace import Tracer

        tracer = Tracer()
        tracer.start()              # the profiler's first session is slow
        entry.call(0)
        tracer.stop()
        marks.append(("profiler warm-up", time.time()))
    rng = np.random.default_rng([seed, 1 << 40])
    setup_s = time.time() - t_start
    win, kept, metas, errors = run_window(
        entry, len(pool), args.seconds, KEEP, rng, tracer,
        traffic["trace_calls"])
    win.setup_s = setup_s
    if device == "cuda":
        torch.cuda.synchronize()
        mem_peak = int(torch.cuda.max_memory_allocated())
    else:
        mem_peak = 0
    trace = None
    if args.trace:
        if not metas:
            raise Fail("the traced part of the window holds no call")
        trace = tracer.read(metas)

    values = {}
    for m in metrics:
        kind = "layers" if args.trace else "e2e"
        v = load_module(reader_path(kind, m["name"])).read(
            trace if args.trace else win)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs
    entry.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    answered = [r for r in kept if kept[r]]
    n_check = min(traffic["check_recordings"], len(answered))
    pick = sorted(np.random.default_rng([seed, 1 << 41]).choice(
        answered, size=n_check, replace=False).tolist()) if n_check else []
    checks = judge(entry, {r: kept[r] for r in pick}, pool, limits)
    info = [f"info {line}" for line in entry.info(kept, pool)]
    info += [f"error {e}" for e in errors[:20]]
    prev = t_start
    steps = []
    for name, t in marks:
        steps.append(f"{name} {t - prev:.3f}")
        prev = t
    info.append("info set-up seconds: " + ", ".join(steps))
    if win.latencies:
        q = np.percentile(win.latencies, [5, 25, 50, 75, 95])
        info.append("info call seconds p5/p25/p50/p75/p95: "
                    + " ".join(f"{v:.4f}" for v in q))
    info.append(f"info checked recordings {pick} of {len(pool)}; calls "
                f"{win.attempted}, failed {win.failed}; window "
                f"{win.seconds:.3f} s; set-up {setup_s:.3f} s")
    smi = nvidia_smi() if device == "cuda" else ""
    if smi:
        info.append(f"info card {smi}")
    correct = (bool(pick) and win.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": w_spec["chips"], "memory_peak_bytes": mem_peak}
    if smi:
        dev["power_limit"] = smi.split(",")[-1].strip()
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": values, "device": dev}
    if args.trace:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window[1] - trace.window[0]
        result["breakdown"] = trace.breakdown()
    bad = forbidden_loaded()
    if bad:
        raise Fail(f"the run loaded {', '.join(bad)}: the port must run "
                   "without the JAX package")
    result["checks"] = checks
    for c in checks.values():
        if isinstance(c["value"], float) and not math.isfinite(c["value"]):
            c["value"] = 1e300
    return result, checks, info


if __name__ == "__main__":
    sys.exit(main())
