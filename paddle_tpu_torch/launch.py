"""Distributed job launcher (``paddle_tpu/launch.py``, fluid's
``distributed/launch.py``): spawn one worker process per slot with the
job's environment, stream or file their logs, and tear the job down on
the first failure, or with ``--elastic`` supervise it with
:class:`~paddle_tpu_torch.fleet.ElasticCoordinator` (gang restarts, the
workers resuming from their checkpoints).

Workers join through :func:`paddle_tpu_torch.fleet.init`, which reads
``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT`` (the
``PADDLE_TRAINER_*`` names are set too). Usage::

    python -m paddle_tpu_torch.launch --nproc 2 [--elastic
        --max-restarts 2] train.py --your --args
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_env(rank: int, nproc: int, coordinator: str,
               base_env=None) -> dict:
    """One worker's environment (the contract of
    ``fleet.RoleMaker.from_env``): ``coordinator`` is ``host:port`` of
    the TCP store rank 0 opens."""
    env = dict(base_env if base_env is not None else os.environ)
    host, port = coordinator.rsplit(":", 1)
    env["RANK"] = env["LOCAL_RANK"] = str(rank)
    env["WORLD_SIZE"] = env["LOCAL_WORLD_SIZE"] = str(nproc)
    env["MASTER_ADDR"] = host
    env["MASTER_PORT"] = port
    # PaddleCloud-style names for scripts written against the reference
    env["PADDLE_TRAINER_ID"] = str(rank)
    env["PADDLE_TRAINERS_NUM"] = str(nproc)
    env["PADDLE_COORDINATOR"] = coordinator
    return env


def make_spawn(cmd, nproc: int, *, coordinator=None, log_dir=None):
    """``spawn(rank, attempt) -> Popen`` of ``cmd`` with
    :func:`worker_env` and ``PADDLE_LAUNCH_ATTEMPT``: one coordinator
    address per gang attempt (a respawned gang must not bind the port its
    killed predecessor held, unless ``coordinator`` pins it), each rank's
    output in ``log_dir/rank{r}.a{attempt}.{out,err}`` when given."""
    coords = {}

    def coordinator_for(attempt):
        if coordinator:
            return coordinator
        if attempt not in coords:
            coords[attempt] = f"localhost:{_free_port()}"
        return coords[attempt]

    def spawn(rank: int, attempt: int) -> subprocess.Popen:
        env = worker_env(rank, nproc, coordinator_for(attempt))
        env["PADDLE_LAUNCH_ATTEMPT"] = str(attempt)
        stdout = stderr = None
        if log_dir:
            stdout = open(os.path.join(
                log_dir, f"rank{rank}.a{attempt}.out"), "w")
            stderr = open(os.path.join(
                log_dir, f"rank{rank}.a{attempt}.err"), "w")
        try:
            return subprocess.Popen(cmd, env=env, stdout=stdout,
                                    stderr=stderr)
        finally:
            # the child holds its own descriptors now
            for f in (stdout, stderr):
                if f is not None:
                    f.close()

    return spawn


def run_fail_fast(spawn, nproc: int) -> int:
    """Run ``nproc`` workers; the first failure terminates the rest.
    Returns the job's exit code (0, or the first failure's)."""
    procs = [spawn(r, 0) for r in range(nproc)]
    rc = 0
    try:
        pending = set(range(nproc))
        while pending:
            for r in sorted(pending):
                prc = procs[r].poll()
                if prc is None:
                    continue
                pending.discard(r)
                if prc != 0:
                    rc = prc
                    for q in pending:
                        procs[q].terminate()
                    pending.clear()
                    break
            else:
                time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch.launch")
    ap.add_argument("--nproc", type=int, default=1,
                    help="worker processes on this host")
    ap.add_argument("--coordinator", default=None,
                    help="host:port (default: localhost:<free port>)")
    ap.add_argument("--log-dir", default=None,
                    help="write per-rank stdout/stderr here instead of "
                         "inheriting the terminal")
    ap.add_argument("--elastic", action="store_true",
                    help="supervise with gang restarts instead of "
                         "fail-fast")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="elastic supervision deadline (default: none)")
    ap.add_argument("script")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    spawn = make_spawn([sys.executable, args.script] + args.script_args,
                       args.nproc, coordinator=args.coordinator,
                       log_dir=args.log_dir)
    if args.elastic:
        from paddle_tpu_torch.fleet import ElasticCoordinator
        coord = ElasticCoordinator(spawn, args.nproc,
                                   max_restarts=args.max_restarts)
        ok = coord.run(timeout_s=args.timeout_s
                       if args.timeout_s is not None else float("inf"))
        sys.exit(0 if ok else 1)
    sys.exit(run_fail_fast(spawn, args.nproc))


if __name__ == "__main__":
    main()
