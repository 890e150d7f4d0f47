"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. BENCHMARK.json names the cell's configuration
and traffic; the harness finds every file by those names:

- benchmark/configs/<config>.json: the model configuration as it is run;
- benchmark/traffic/<traffic>.json: the traffic's parameters and the window
  driver it uses (benchmark/drivers/<driver>.py, whose run(ctx) sets up,
  warms, measures and checks);
- benchmark/limits/<cell>.json: the limits of the numbers that decide
  `correct`, with the readings they were set from;
- benchmark/metrics/<metric>.py: one reader per per-layer metric,
  read(ctx) -> value or None.

The run makes its inputs and weights from --seed, warms the cell's shapes,
measures for --seconds, checks what the timed path produced against the
plain reference and prints one JSON line last: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics (one short slice
profiled) and a breakdown. Without a CUDA card (or with fewer than the
cell asks for) it exits non-zero and prints no result, as it does when
jax, jaxlib, flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "efficientvlm_tpu")


def process_start() -> float:
    """The process's start on the host clock (time.time), from /proc; the
    import of this module where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


START = process_start()


def quiet_environment() -> None:
    """Fixed cache directories inside the checkout, and no JAX behind
    libraries that would load it by themselves."""
    cache = os.path.join(ROOT, "build", "bench-cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    for key in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[key] = "0"


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and its metrics (the
    end-to-end and per-layer entries that apply to it)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    applies = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    return {"cell": cell, "config_entry": config,
            "config": read_json(os.path.join(ROOT, config["file"])),
            "traffic": read_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json")),
            "limits": read_json(os.path.join(HERE, "limits", workload + ".json")),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


class Context:
    """What a window driver gets: the run's arguments, the cell's files,
    spans and counters, and the hooks that mark the window and profile a
    slice. Drivers fill `e2e`, `checks` and `layer`."""

    def __init__(self, args, spec: dict, device: str):
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.workload = args.workload
        self.config, self.traffic, self.limits = spec["config"], spec["traffic"], spec["limits"]
        self.device = device
        self.window_start = None
        self.spans: dict = {}        # name -> [seconds] of synchronised spans (traced runs)
        self.e2e: dict = {}          # end-to-end metric -> value
        self.checks: list = []       # (name, value, limit)
        self.layer: dict = {}        # what the per-layer readers read
        self.attempted = self.failed = 0
        self.memory_peak = 0
        self.trace_data = None
        self.phases: list = []       # (set-up phase, seconds since the process started)
        self.card: dict = {}         # the card's clocks as the window closed

    def mark(self, phase: str) -> None:
        """The end of a set-up phase, on the host clock since the process
        started (printed on standard error: where set-up time goes)."""
        self.phases.append((phase, time.time() - START))

    def sub_seed(self, tag: str) -> int:
        """A seed of its own for each thing drawn from the run's seed."""
        import numpy as np

        words = [int(x) for x in tag.encode()]
        return int(np.random.SeedSequence([self.seed % 2 ** 63, *words]).generate_state(
            1, np.uint64)[0] % 2 ** 63)

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def start_window(self) -> float:
        self.sync()
        self.spans.clear()  # spans of the warm-up are not the window's
        self.window_start = time.time()
        return self.window_start

    def window_closed(self) -> None:
        """Read the card's clocks, temperature and power as the window
        closes (nvidia-smi; nothing on the CPU)."""
        if self.device != "cpu":
            self.card = card_state()

    @contextlib.contextmanager
    def span(self, name: str):
        """A benchmark span around a call into the port: in a traced run it
        synchronises at both ends and records its seconds (and shows in the
        profiler as a range); otherwise it costs nothing."""
        if not self.trace:
            yield
            return
        import torch

        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.sync()
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def profiled(self):
        """Profile the enclosed slice (CPU and CUDA activity); the parsed
        Trace lands in self.trace_data."""
        import torch

        from . import trace as T

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.sync()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(T.WINDOW_SPAN):
                yield
                self.sync()
        self.trace_data = T.from_profiler(prof)

    @contextlib.contextmanager
    def device_slice(self):
        """Profile the enclosed slice with the device's activity alone, so
        that no recording of host ops slows the host and reads as idle: the
        slice lies between two marker kernels, and its busy_s and window_s
        land in self.layer["device_slice"]. Nothing on the CPU."""
        if self.device == "cpu":
            yield
            return
        import torch

        from . import trace as T

        mark = torch.zeros(1, device=self.device)
        self.sync()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            mark.add_(1)
            yield
            mark.add_(1)
            self.sync()
        self.layer["device_slice"] = T.device_window(prof)


CARD_FIELDS = ("power.limit", "clocks.sm", "clocks.max.sm", "temperature.gpu", "power.draw")


def card_state() -> dict:
    """The first card's nvidia-smi readings of CARD_FIELDS (None where it
    cannot say)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=" + ",".join(CARD_FIELDS),
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    except (OSError, IndexError, subprocess.SubprocessError):
        vals = []
    state = {}
    for i, key in enumerate(CARD_FIELDS):
        try:
            state[key] = float(vals[i])
        except (IndexError, ValueError):
            state[key] = None
    return state


def device_info(device: str) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "power_limit_w": card_state()["power.limit"]}


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among loaded modules (or `names`),
    each compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv=None, *, device: str = "cuda", spec: dict | None = None) -> tuple:
    """One run. Returns (exit code, result dict or None). `device` "cpu" and
    a given `spec` serve the tests, which run tiny cells on the CPU."""
    args = parse(argv)
    quiet_environment()
    spec = spec or cell_spec(read_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    import torch

    ctx_phases = [("import torch", time.time() - START)]
    if device != "cpu":
        need = int(spec["cell"].get("chips", 1))
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"benchmark: needs {need} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2, None
        torch.cuda.reset_peak_memory_stats()
    try:
        driver = load_file(os.path.join(HERE, "drivers", spec["traffic"]["driver"] + ".py"),
                           "benchmark_driver_" + spec["traffic"]["driver"])
    except ImportError as e:  # the port is not beside the benchmark
        print(f"benchmark: cannot load the program: {e}", file=sys.stderr)
        return 2, None
    ctx = Context(args, spec, device)
    ctx.phases = ctx_phases
    driver.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3, None
    dev = device_info(device)
    dev["memory_peak_bytes"] = int(ctx.memory_peak)
    result = {"correct": None, "attempted": int(ctx.attempted), "failed": int(ctx.failed)}
    metrics = {}
    if args.trace:
        for m in spec["per_layer"]:
            reader = load_file(os.path.join(HERE, "metrics", m["name"] + ".py"),
                               "benchmark_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        summ = ctx.layer.get("trace_summary")
        if summ:
            result["breakdown"] = summ["breakdown"]
        busy = ctx.layer.get("device_slice") or summ
        if busy:
            dev["busy_s"], dev["window_s"] = busy["busy_s"], busy["window_s"]
    else:
        values = dict(ctx.e2e, setup_s=ctx.window_start - START)
        for m in spec["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    ok = ctx.failed == 0 and bool(ctx.checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in ctx.checks)
    if ctx.card:
        dev["card_at_window_end"] = ctx.card
    result.update(correct=ok, metrics=metrics, device=dev)
    result["setup_phases"] = [[p, t] for p, t in ctx.phases]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in ctx.checks}
    return 0, result


def main(argv=None) -> int:
    code, result = run(argv)
    if result is None:
        return code or 1
    print("set-up phases (s since the process started): " + ", ".join(
        f"{p} {t:.3f}" for p, t in result["setup_phases"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
