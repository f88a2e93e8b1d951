"""Start N ranks of one command on this host.

    python -m opensplat_tpu_torch.parallel.launch -n 2 [--backend gloo] \\
        [--timeout 3600] -- python -m opensplat_tpu_torch.cli <project> \\
        --distributed --data-parallel -1

Each rank gets OPENSPLAT_COORDINATOR (a file:// store in a fresh
temporary directory, so concurrent launches never race for a port),
OPENSPLAT_NUM_PROCESSES, OPENSPLAT_PROCESS_ID and OPENSPLAT_BACKEND
(parallel/distributed.py reads them), and OMP_NUM_THREADS, unless set,
shares the host's cores among the ranks. Every rank has a hard time limit,
and when one rank fails the others are stopped at once, so a rank left
waiting in a collective never outlives the run. Ranks on one card must
use gloo; NCCL wants a card a rank.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class RankFailure(RuntimeError):
    """A rank exited non-zero or ran past the time limit."""


def run_ranks(command: Sequence[str], world: int, *, backend: str = "gloo",
              timeout: float = 600.0, env: Optional[dict] = None,
              cwd: Optional[str] = None, capture: bool = True) -> List[str]:
    """Run `command` as ranks 0..world-1 and wait for all of them.
    Returns each rank's output (stdout and stderr together; empty
    strings when capture is False). Raises RankFailure, with the failing
    rank's output, when a rank exits non-zero or the time limit passes;
    every rank still running is then killed."""
    base = dict(os.environ if env is None else env)
    # the host's cores shared among the ranks, unless the caller says
    base.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1)
                                               // world)))
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, base.get("PYTHONPATH", "")) if p)
    with tempfile.TemporaryDirectory(prefix="osplat_ranks_") as tmp:
        procs, logs = [], []
        try:
            for rank in range(world):
                e = dict(base, OPENSPLAT_COORDINATOR=f"file://{tmp}/store",
                         OPENSPLAT_NUM_PROCESSES=str(world),
                         OPENSPLAT_PROCESS_ID=str(rank),
                         OPENSPLAT_BACKEND=backend)
                log = open(os.path.join(tmp, f"rank{rank}.log"), "w+") \
                    if capture else None
                logs.append(log)
                procs.append(subprocess.Popen(
                    list(command), env=e, cwd=cwd, stdout=log,
                    stderr=subprocess.STDOUT if capture else None,
                    stdin=subprocess.DEVNULL))
            failed = _wait(procs, timeout)
            outs = []
            for log in logs:
                if log is None:
                    outs.append("")
                else:
                    log.seek(0)
                    outs.append(log.read())
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                if log is not None:
                    log.close()
    if failed is not None:
        rank, why = failed
        raise RankFailure(f"rank {rank} of {world} {why}:\n"
                          + outs[rank][-8000:])
    return outs


def _wait(procs, timeout: float):
    """None when every rank exited 0, else (rank, reason) of the first
    failure; kills the rest at a failure or at the deadline."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        for rank, code in enumerate(codes):
            if code not in (None, 0):
                return rank, f"exited with {code}"
        if all(c == 0 for c in codes):
            return None
        if time.monotonic() > deadline:
            rank = codes.index(None)
            return rank, f"ran past the {timeout:.0f} s limit"
        time.sleep(0.05)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="opensplat_tpu_torch.parallel.launch",
        description="Run N ranks of a command on this host")
    p.add_argument("-n", "--nproc", type=int, required=True)
    p.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    p.add_argument("--timeout", type=float, default=24 * 3600.0,
                   help="Seconds before every rank is stopped")
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cmd = args.command[1:] if args.command[:1] == ["--"] else args.command
    if not cmd or args.nproc < 1:
        p.error("give -n N and a command after --")
    try:
        run_ranks(cmd, args.nproc, backend=args.backend,
                  timeout=args.timeout, capture=False)
    except RankFailure as e:
        print(str(e).splitlines()[0], file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
