"""Start a world of ranks on this machine, one process each.

`run_world` starts `n` processes of one command, each told its rank and a
free localhost port for the rendezvous, waits for all of them with one
deadline, and ends the others as soon as one fails or the deadline
passes: no rank carries on after a peer failed.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class WorldFailed(RuntimeError):
    """A rank of a world exited non-zero or outlived the deadline."""

    def __init__(self, what: str, outputs: List[str]):
        super().__init__(what + "".join(f"\n--- rank {r} ---\n{o[-4000:]}"
                                        for r, o in enumerate(outputs)))
        self.outputs = outputs


def run_world(argv_for_rank: Callable[[int, str], Sequence[str]], n: int, timeout: float,
              cwd: str | None = None, env: dict | None = None) -> List[str]:
    """Run `argv_for_rank(rank, coordinator)` for ranks 0..n-1 at once
    (`coordinator` 'localhost:<port>'); returns each rank's combined
    stdout and stderr. Raises WorldFailed when a rank exits non-zero or
    the world outlives `timeout` seconds, after stopping every rank."""
    coordinator = f"localhost:{free_port()}"
    # The ranks import this checkout's package wherever they start.
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    env = {**os.environ, "PYTHONPATH": path, **(env or {})}
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(n)]
    procs = [subprocess.Popen(list(argv_for_rank(r, coordinator)), stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=cwd, text=True, env=env)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the world of {n} outlived {timeout} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outputs = []
    for f in logs:
        f.seek(0)
        outputs.append(f.read())
        f.close()
    if failed is not None:
        raise WorldFailed(failed, outputs)
    return outputs


def python_module(module: str, *args: str) -> List[str]:
    """The argv that runs `module` with this interpreter."""
    return [sys.executable, "-m", module, *args]
