"""Readings that the limits of ``portbench/limits/`` are set from.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 3

For each seed, in one process: the cell's weights and pool, then

- ``program``: the program as the configuration states, driven by the
  cell's loop for ``--seconds`` at the cell's load, its sampled answers
  held against the reference (``off2_ratio``, what a run compares);
- ``control``: the configuration's ``control`` put in the program's place
  and held against the same references: the program with its
  lower-precision path switched on (``kind: program``), or the reference
  itself in bfloat16 with its convs but the heads rounded to ``bits`` bits,
  calibrated by absmax times ``margin`` on the batch the program calibrates
  on, the pool's first (``kind: reference``), on the same sampled pool
  pairs.

Prints one JSON line a seed (with each side's worst ``off2_pct`` beside)
and a summary: the largest program reading (the lower reading of the limit)
and the smallest control reading (the upper).
The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import frames, judge, run, spec, weights


def _answers(w, pool, path, parts, seed, seconds, device):
    interp, step, loop = run.serve(w, pool, path, parts, device)
    sampler = judge.Sampler(parts["traffic"]["check_answers"], seed)
    loop.drive(step, pool, parts["traffic"], seconds=seconds, sampler=sampler)
    answers = [(i, j, t.numpy()) for i, j, t in sampler.kept]
    del interp, step, sampler
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return answers


def readings(parts: dict, seed: int, seconds: float, device: torch.device,
             which=("program", "control")) -> dict:
    """``off2_ratio`` of the program and of the control on one seed."""
    config, traffic = parts["config"], parts["traffic"]
    seed %= 2 ** 63
    pool = frames.pool(seed, traffic, device)
    w = weights.make(seed, config["model"], config["weights"], pool[0][:1], device)
    ctl = config["control"]
    got = {"program": _answers(w, pool, config["path"], parts, seed, seconds, device)}
    if "control" in which and ctl["kind"] == "program":
        got["control"] = _answers(w, pool, ctl["path"], parts, seed, seconds, device)
    elif "control" in which:
        idx = [j for _, j, _ in got["program"]]
        q = judge.references(w, pool, idx, config, traffic, device,
                             {"bits": ctl["bits"], "margin": ctl["margin"]})
        got["control"] = [(i, j, q[j]) for i, j, _ in got["program"]]
    idx = [j for answers in got.values() for _, j, _ in answers]
    want = judge.references(w, pool, idx, config, traffic, device)
    stated = judge.references(w, pool, idx, config, traffic, device, config["stated"])
    out = {"seed": seed}
    for k in which:
        r = judge.compare(got[k], want, stated)
        out[k] = r["off2_ratio"]
        out[f"{k}_off2_pct"] = r["off2_pct"]
        out[f"{k}_off2_values"] = r["off2_values"]
        out[f"{k}_stated_values"] = r["off2_values_stated"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--which", default="program,control")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    parts = spec.cell(args.workload)
    rows = []
    for s in args.seeds.split(","):
        r = readings(parts, int(s), args.seconds, torch.device("cuda", 0),
                     tuple(args.which.split(",")))
        rows.append(r)
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows)}
    if all("program" in r for r in rows):
        summary["lower"] = max(r["program"] for r in rows)
    if all("control" in r for r in rows):
        summary["upper"] = min(r["control"] for r in rows)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
