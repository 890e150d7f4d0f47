"""Gloo ranks on the CPU for the port's distribution tests: spawn_check
starts `n` processes of efficientvlm_tpu_torch.parallel.parallel_check under
torchrun's environment variables (one torch thread each, SIGTERM's default
action, killed at the timeout) and load reads a part's dump of one rank."""

import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_check(n: int, out: str, parts, *, init: str = "", inputs: str = "",
                timeout: float = 120) -> list:
    """Run parallel_check --width tiny --device cpu over n gloo ranks into
    `out`; returns the ranks' logs (asserting every rank exited 0)."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(n),
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "efficientvlm_tpu_torch.parallel.parallel_check", "--parts",
           ",".join(parts), "--width", "tiny", "--device", "cpu", "--out", out]
    if init:
        cmd += ["--init", init]
    if inputs:
        cmd += ["--inputs", inputs]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              preexec_fn=lambda: signal.signal(signal.SIGTERM, signal.SIG_DFL))
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return logs


def load(out: str, part: str, rank: int) -> dict:
    """A rank's dump of a part, its "report" parsed."""
    with np.load(os.path.join(out, f"{part}.rank{rank}.npz")) as z:
        dump = {k: z[k] for k in z.files}
    dump["report"] = json.loads(str(dump["report"]))
    return dump
