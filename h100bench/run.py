"""The H100 benchmark of ``neutronstarlite_torch``: one run of one cell.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``workloads/<cell>.json``) names
its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``) and its limits; ``BENCHMARK.json`` names its
metrics. The run makes every input from the seed, builds the program,
drives its first training steps (the checked steps, which also warm up
every shape), then measures ``--seconds`` of back-to-back epochs. With
``--trace 1`` it then profiles a few more epochs and reports the per-layer
metrics (``metrics/<name>.py``) instead of the end-to-end ones. Once the
window has closed and the program is freed, the plain reference
(``reference/``) repeats the checked steps, and ``check.py`` decides
``correct``. The last line of standard output is the result.
"""

import time

T_START = time.perf_counter()  # set-up is timed from the process's first line

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = "BENCHMARK.json"  # at the root of the checkout, the working directory
FORBIDDEN = ("jax", "jaxlib", "flax", "neutronstarlite_tpu")
GIB = float(1 << 30)


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def load_cell(name: str, bench_path: str):
    """(BENCHMARK.json, the cell's file, its configuration, its traffic)."""
    with open(bench_path) as fh:
        bench = json.load(fh)
    if name not in {w["name"] for w in bench["workloads"]}:
        raise SystemExit(f"no workload {name!r} in {bench_path}")
    cell = load_json("workloads", f"{name}.json")
    cfg = load_json("configs", f"{cell['config']}.json")
    traffic = load_json("traffic", f"{cell['traffic']}.json")
    return bench, cell, cfg, traffic


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{metric}", os.path.join(HERE, "metrics", f"{metric}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, name: str, kind: str):
    return [m for m in bench[kind] if name in m.get("workloads", [w["name"] for w in
                                                                  bench["workloads"]])]


def epoch_counts(cfg: dict, v: int, e: int) -> dict:
    from h100bench import counts

    terms = importlib.import_module(f"h100bench.counts.{cfg['family']}").epoch_terms(cfg, v, e)
    out = {"least_ms": counts.least_ms(terms)}
    for kind in sorted({t["kind"] for t in terms}):
        out[f"{kind}_ms"] = counts.least_ms(terms, [kind])
    return out


def measure(trainer, seconds: float, device) -> dict:
    """Back-to-back epochs for ``seconds``, each ended by its loss's fetch;
    the window ends in a synchronise."""
    from h100bench import program

    c0 = program.counters(trainer)
    dispatch, failed, epochs = [], 0, 0
    program.sync(device)
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        loss, _ = trainer.train_step()
        dispatch.append(time.perf_counter() - a)
        failed += not math.isfinite(float(loss))
        epochs += 1
        if time.perf_counter() - t0 >= seconds:
            break
    program.sync(device)
    wall = time.perf_counter() - t0
    c1 = program.counters(trainer)
    return {"epochs": epochs, "failed": failed, "wall_s": wall, "epoch_ms": 1e3 * wall / epochs,
            "dispatch_s": dispatch, "counters": {k: c1[k] - c0.get(k, 0.0) for k in c1}}


def traced(trainer, seconds: float, device) -> dict:
    from h100bench import profile_window

    def epochs():
        n, t0 = 0, time.perf_counter()
        while n < 2 or time.perf_counter() - t0 < seconds:
            loss, _ = trainer.train_step()
            float(loss)
            n += 1
        return n

    return profile_window.record(epochs, device)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             bench_path: str, t_start: float, cfg_over=None) -> dict:
    """One run; returns the result line's fields, ``check`` last."""
    import torch

    from h100bench import check, inputs, program
    from h100bench.reference import drive

    bench, cell, cfg, traffic = load_cell(name, bench_path)
    cfg = dict(cfg, **(cfg_over or {}))
    steps = int(traffic["checked_steps"])
    cuda = torch.device(device).type == "cuda"
    spans = {}
    inp = inputs.make_inputs(cfg, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    trainer = program.build(cfg, inp, seed, device, spans)
    prog = program.checked_steps(trainer, steps, float(cfg["adam"]["beta1"]))
    setup_s = time.perf_counter() - t_start
    win = measure(trainer, seconds, device)
    rec = {"spans": spans, "epochs": win["epochs"], "epoch_ms": win["epoch_ms"],
           "dispatch_s": win["dispatch_s"], "counters": win["counters"],
           "counts": epoch_counts(cfg, inp.v, len(inp.src)), "trace": None}
    if trace:
        rec["trace"] = traced(trainer, float(traffic["trace_seconds"]), device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = drive.run(cfg, inp, seed, steps, device)
    print(f"reference: {steps} steps in {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    nums = check.numbers(prog, ref)
    limits = cell["limits"]
    correct = check.judge(nums, limits) and win["failed"] == 0
    if trace:
        from h100bench import profile_window

        metrics = {}
        for m in cell_metrics(bench, name, "per_layer"):
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "epoch_ms": win["epoch_ms"], "peak_mem_gib": peak / GIB}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell_metrics(bench, name, "end_to_end")}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": win["epochs"], "failed": win["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = profile_window.busy_s(rec["trace"])
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = profile_window.breakdown(rec["trace"])
    out["check"] = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    _, cell, _, _ = load_cell(args.workload, BENCH)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    if int(cell["chips"]) != 1:
        print("this harness runs one-chip cells only", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                   BENCH, T_START)
    out["device"]["power_limit"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
