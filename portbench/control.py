"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision below the configuration's
(bfloat16 for its float32), judged by the cell's own comparison against
the float64 reference, on the cell's own recordings at its own size.

    python portbench/control.py --workload n2.sort --seeds 11 12 13

prints one JSON line a seed: each compared number beside its limit. The
control has to come out not correct. `--fault` reads a fault planted in
the reference put in the program's place instead: `half` (each
Baum-Welch iteration's statistics from half of the recording's windows,
the update taken over them) or `unchanged` (each iteration returns its
state unchanged). The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.compare import worst  # noqa: E402
from portbench.gen.pool import make_pool  # noqa: E402
from portbench.reference import hmm, train  # noqa: E402
from portbench.run import BENCH, cell_spec, load_json, load_module  # noqa: E402


def planted(fault):
    """Context that plants a fault in the reference's Baum-Welch step."""
    if fault == "half":
        fb = hmm.forward_backward

        def half(y, *a, **k):
            for grp in fb(y, *a, **k):
                keep = grp["core"] < len(y) // 2
                yield {**grp, "alpha": grp["alpha"][:, keep],
                       "beta": grp["beta"][:, keep], "y": grp["y"][:, keep],
                       "starts": grp["starts"][keep], "core": grp["core"][keep]}

        return {"target": hmm, "name": "forward_backward", "value": half}
    if fault == "unchanged":
        return {"target": train, "name": "em_step",
                "value": lambda y, lp, mu, sigma, **k: (lp, mu, sigma)}
    return None


def main(argv=None, *, device=None, overrides=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--fault", choices=("half", "unchanged"), default=None)
    args = ap.parse_args(argv)
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    overrides = overrides or {}
    bench = overrides.get("bench") or load_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic, limits = cell_spec(bench, args.workload)
    cfg.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    entry = load_module(BENCH / "entries" / f"{traffic['entry']}.py").Entry(
        cfg, traffic, device)
    dtype = torch.float64 if args.fault else getattr(torch, args.dtype)
    out = []
    for seed in args.seeds:
        pool = make_pool(cfg, 1, entry.samples, seed)
        entry.setup(pool, seed)
        y = pool[0][0]
        ref = entry.reference(0, y)
        plant = planted(args.fault)
        if plant:
            saved = getattr(plant["target"], plant["name"])
            setattr(plant["target"], plant["name"], plant["value"])
        try:
            ctl = entry.control(0, y, dtype)
        finally:
            if plant:
                setattr(plant["target"], plant["name"], saved)
        nums = entry.compare(y, ctl, ref)
        line = {"workload": args.workload, "seed": seed,
                "control": args.fault or args.dtype,
                "numbers": worst([nums], limits),
                "fails": not all(v <= limits[k] for k, v in nums.items())}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
