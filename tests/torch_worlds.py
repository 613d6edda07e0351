"""Spawned CPU worlds of the port under one shared deadline.

A test module starts every world it needs at once (each rank a process
running a script of the module) and waits on each world when a test
asks for it. All of them share one deadline, measured from when the
first started: a world that misses it costs the remaining time once,
not a timeout per rank, and the failure names the ranks of that world
that did not finish, with their threads' stacks. Each rank's stdout and stderr go to a file of its
own (a full pipe would block a rank while the test waits on another),
every child is killed on every path out, the controller ports stay
reserved by this process until the worlds are done, so that no other
socket of the run is handed one of them in between, and no HOROVOD*
variable of the test process reaches a rank unless the test sets it.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def child_env(**extra) -> dict:
    """The environment of a rank: this process's without its HOROVOD*
    variables (a test earlier in the run may have left one in
    ``os.environ``: tests/test_launcher.py leaves HOROVOD_SECRET_KEY),
    then ``extra``, the repo on the path, gloo on the loopback, one
    intra-op thread a rank (the worlds run together on a few cores) and
    the fault handler, which prints every thread's stack to the rank's
    log when the deadline's SIGABRT ends it."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD")}
    env.update(GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONFAULTHANDLER="1",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update({k: str(v) for k, v in extra.items()})
    return env


class Worlds:
    """``start`` each world, then ``wait`` on it; ``close`` at the end."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self._t0 = None
        self._started = {}
        self._done = {}
        self._holds = []

    def reserve_port(self) -> int:
        """A free port that stays bound here (SO_REUSEADDR, never
        listening) until ``close``: the rank that listens on it binds
        with SO_REUSEADDR too, and no ephemeral bind gets it meanwhile."""
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        self._holds.append(s)
        return s.getsockname()[1]

    def start(self, kind: str, out: pathlib.Path, argvs, envs) -> None:
        """One world: rank r runs ``argvs[r]`` with ``envs[r]``; its log
        is ``out/rank<r>.log``, its result ``out/result<r>.json`` and its
        flight dump, if it aborts, in ``out`` too."""
        if self._t0 is None:
            self._t0 = time.monotonic()
        procs, logs = [], []
        for r, (argv, env) in enumerate(zip(argvs, envs)):
            # An aborting rank's flight dump goes to the world's directory
            # unless the test names another (never into the checkout).
            env = dict(env)
            env.setdefault("HOROVOD_TPU_FLIGHT_DIR", str(out))
            log = open(out / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable] + [str(a) for a in argv], env=env,
                stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT))
        self._started[kind] = (out, procs, logs)

    def out(self, kind: str) -> pathlib.Path:
        """The directory of one world's logs and results."""
        return self._started[kind][0]

    def wait(self, kind: str):
        """(return codes, result dicts or None, each rank's log) of one
        world; raises AssertionError naming the ranks that had not
        finished when the shared deadline passed (they are killed)."""
        if kind not in self._done:
            self._done[kind] = self._collect(kind)
        got = self._done[kind]
        if isinstance(got, AssertionError):
            raise got
        return got

    def _collect(self, kind: str):
        out, procs, logs = self._started[kind]
        late = []
        for r, p in enumerate(procs):
            left = self._t0 + self.deadline_s - time.monotonic()
            try:
                p.wait(timeout=max(left, 0.0))
            except subprocess.TimeoutExpired:
                late.append(r)
        for p in procs:
            if p.poll() is None:
                # Where a late rank is stuck: its threads' stacks, from
                # the fault handler, into its log; then it is killed.
                p.send_signal(signal.SIGABRT)
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        for log in logs:
            log.close()
        logs = [f"--- rank {r} ---\n" + (out / f"rank{r}.log").read_text(
            errors="replace") for r in range(len(procs))]
        if late:
            return AssertionError(
                f"world {kind}: ranks {late} of {len(procs)} had not "
                f"finished when the {self.deadline_s:g} s shared by every "
                f"world ran out (killed)\n" + "\n".join(logs))
        results = [json.loads(f.read_text()) if f.exists() else None
                   for f in (out / f"result{r}.json"
                             for r in range(len(procs)))]
        return [p.returncode for p in procs], results, logs

    def close(self) -> None:
        for _, procs, logs in self._started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        for s in self._holds:
            s.close()
        self._holds = []
