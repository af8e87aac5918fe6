"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA card. The run

1. sets up (``setup_s``, from the process's start to the first timed step):
   loads the program's kernels (a checkout's first run compiles them),
   makes a pool of frame pairs in pageable host memory (``portbench.frames``)
   and the weights on the card from the seed, each head sized on the pool's
   first pair (``portbench.weights``), builds
   ``rrin_tpu_torch.pipeline.Interpolator`` as the configuration says and
   serves a few warm steps (the first prepares the packed weights and, in
   int8, calibrates);
2. with ``--trace 0`` drives ``Interpolator.step`` by the traffic's loop for
   ``--seconds`` and reports the end-to-end metrics; with ``--trace 1``
   traces a window of ``trace_seconds`` (a second one where the first lost
   launches; none more) and reports the per-layer metrics;
3. once the window has closed and the program's state is freed, holds a
   sample of the window's answers against the plain reference, in float32
   and in the configuration's stated precision (``portbench.judge``);
4. prints each number compared beside its limit as the last lines of
   standard error, and the result as the last line of standard output.

It exits with another code than 0, and prints no result, without a card,
when a trace lost launches twice, or when JAX or the JAX package was
imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
# Kernel caches at fixed paths inside the checkout (the program's own nvcc
# cache, rrin_tpu_torch/_build/, already lies there).
os.environ["TRITON_CACHE_DIR"] = str(_ROOT / ".portbench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_ROOT / ".portbench_cache" / "torch_extensions")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import frames, judge, roofline, spec, trace, weights  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rrin_tpu")


class TraceLostLaunches(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``rrin_tpu_torch`` is not ``rrin_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model_config(model: dict):
    from rrin_tpu_torch.config import ModelConfig

    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})


def _traced(loop, step, pool, traffic, seed, totals, plain, device):
    """Trace a window; a second where the first lost launches. Returns the
    complete Reading and its sampler."""
    from torch.profiler import ProfilerActivity, profile

    from rrin_tpu_torch import _build

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    for attempt in (1, 2):
        sampler = judge.Sampler(traffic["check_answers"], seed)
        _sync(device)
        before = _build.launch_counts()
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW_SPAN):
                win = loop.drive(step, pool, traffic, seconds=traffic["trace_seconds"],
                                 sampler=sampler, spans=True)
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        r = trace.read(prof, launches, win.steps, win.enqueue_s, totals, plain)
        if r.complete:
            return r, sampler
        print(f"trace {attempt} lost launches (bucket: counted, traced): {r.lost}",
              file=sys.stderr)
    raise TraceLostLaunches("both traced windows lost launches: no device share is reported")


def serve(w: dict, pool: list, path: dict, parts: dict, device: torch.device, wrap_step=None):
    """The program as ``path`` configures it, on the weights ``w``, warmed up
    on ``pool`` by the traffic's loop: (Interpolator, its step, the loop)."""
    from rrin_tpu_torch.pipeline import Interpolator

    traffic = parts["traffic"]
    interp = Interpolator(w, _model_config(parts["config"]["model"]), exp=traffic["exp"],
                          mode=traffic["mode"], device=device, **path)
    step = interp.step if wrap_step is None else wrap_step(interp.step)
    loop = importlib.import_module(f"portbench.loops.{traffic['loop']}")
    loop.drive(step, pool, traffic, steps=traffic["warm_steps"])
    _sync(device)
    return interp, step, loop


def run(name: str, seed: int, seconds: float, traced: bool, device: torch.device,
        bench: dict = None, parts: dict = None, wrap_step=None) -> dict:
    """One run of cell ``name`` on ``device``; returns the result object.
    ``parts`` (tests) replaces what ``spec.cell`` finds for the cell, and
    ``wrap_step`` wraps ``Interpolator.step``."""
    from rrin_tpu_torch import _build

    seed %= 2 ** 63
    bench = bench or spec.benchmark()
    c = parts or spec.cell(name, bench)
    config, traffic = c["config"], c["traffic"]
    model = config["model"]
    marks = {"imports": time.perf_counter() - T0}
    if device.type == "cuda":
        _build.build_all()
        torch.cuda.init()
    marks["kernels"] = time.perf_counter() - T0
    pool = frames.pool(seed, traffic, device)
    w = weights.make(seed, model, config["weights"], pool[0][:1], device)
    if device.type == "cuda":  # the peak reported is the program's, with the weights
        torch.cuda.reset_peak_memory_stats(device)
    marks["inputs"] = time.perf_counter() - T0
    interp, step, loop = serve(w, pool, config["path"], c, device, wrap_step)
    setup_s = time.perf_counter() - T0
    marks["warm"] = setup_s

    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": {}}
    if traced:
        totals = roofline.step_totals(config, traffic)
        plain = config["path"].get("packed") is False
        reading, sampler = _traced(loop, step, pool, traffic, seed, totals, plain, device)
        out["attempted"] = reading.steps
        for m in spec.metrics(bench, "per_layer", name):
            v = spec.reader(m["name"])(reading)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        out["device"].update(busy_s=reading.busy_s, window_s=reading.window_s)
        out["breakdown"] = trace.breakdown(reading)
        diag = {"steps": reading.steps, "window_s": reading.window_s}
    else:
        sampler = judge.Sampler(traffic["check_answers"], seed)
        win = loop.drive(step, pool, traffic, seconds=seconds, sampler=sampler)
        out["attempted"] = win.steps
        e2e = {"frames_per_s": win.frames / win.seconds,
               "step_ms_p95": float(np.percentile(win.latency_s, 95)) * 1e3,
               "setup_s": setup_s}
        for m in spec.metrics(bench, "end_to_end", name):
            out["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        thirds = np.array_split(np.asarray(win.latency_s) * 1e3, 3)
        diag = {"steps": win.steps, "window_s": win.seconds, "setup_marks_s": marks,
                "step_ms_p50": float(np.percentile(win.latency_s, 50)) * 1e3,
                "step_ms_p50_by_third": [float(np.median(t)) for t in thirds]}
    cuda = device.type == "cuda"
    out["device"] = {"platform": "gpu" if cuda else device.type,
                     "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                     "count": c["cell"]["chips"],
                     "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
                     **out["device"]}

    # the program's state goes before the reference runs
    answers = [(i, j, t.numpy()) for i, j, t in sampler.kept]
    del interp, step, sampler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    idx = [j for _, j, _ in answers]
    want = judge.references(w, pool, idx, config, traffic, device)
    stated = judge.references(w, pool, idx, config, traffic, device, config["stated"])
    numbers = judge.compare(answers, want, stated)
    out["correct"], out["checks"] = judge.verdict(numbers, c["limits"])
    diag.update(numbers, reference_s=time.perf_counter() - t_ref)
    print(json.dumps({"run": diag}), file=sys.stderr)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = spec.benchmark()
    chips = spec.cell(args.workload, bench)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), bench)
    except TraceLostLaunches as e:
        print(str(e), file=sys.stderr)
        return 4
    bad = forbidden_modules()
    if bad:
        print(f"modules the benchmark may not load were loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    out["checks"] = out.pop("checks")  # last key of the result
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
