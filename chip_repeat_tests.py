#!/usr/bin/env python3
"""Run one test file whole in many separate processes on one NVIDIA GPU.

    python3 chip_repeat_tests.py [--tree DIR] [--processes 12]
        [--parallel 4] [--deadline-s 3000] [--out build/repeat_tests/process]
        [--file tests/test_torch_cuda.py] [--marker cuda]

Each process is ``python -m pytest FILE -q -m MARKER`` started inside
``--tree`` (a checkout of the repo, such as an unpacked ``git archive``),
``--parallel`` of them at a time; the kernels are built once first, so
the processes only load them. A process's whole output goes to
``OUT_<i>.txt``. Prints one line per process (its exit code, seconds,
pytest's summary line and the first failures), then the totals and the
card's ``nvidia-smi`` name and power limit. A process still running at
the deadline is killed and counts as failed. Exits non-zero without a
card or when any process failed.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".")
    ap.add_argument("--processes", type=int, default=12)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--deadline-s", type=float, default=3000.0)
    ap.add_argument("--out", default="build/repeat_tests/process")
    ap.add_argument("--file", default="tests/test_torch_cuda.py")
    ap.add_argument("--marker", default="cuda")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    out = Path(args.out).resolve()
    out.parent.mkdir(parents=True, exist_ok=True)
    t_start = time.monotonic()
    subprocess.run([sys.executable, "-c", "from paddle_tpu_torch.kernels "
                    "import build; build.build_all()"], cwd=tree, check=True)
    print(f"kernels built in {time.monotonic() - t_start:.1f} s", flush=True)
    cmd = [sys.executable, "-m", "pytest", args.file, "-q", "-m",
           args.marker, "-p", "no:cacheprovider"]
    pending = list(range(1, args.processes + 1))
    running = {}
    results = {}
    deadline = t_start + args.deadline_s
    while pending or running:
        while pending and len(running) < args.parallel:
            i = pending.pop(0)
            log = open(f"{out}_{i}.txt", "w")
            running[i] = (subprocess.Popen(cmd, cwd=tree, stdout=log,
                                           stderr=subprocess.STDOUT),
                          log, time.monotonic())
        time.sleep(1.0)
        for i, (proc, log, t0) in list(running.items()):
            if proc.poll() is None and time.monotonic() < deadline:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            secs = time.monotonic() - t0
            text = Path(f"{out}_{i}.txt").read_text(errors="replace")
            lines = [ln for ln in text.splitlines() if ln.strip()]
            failed = [ln for ln in lines if ln.startswith("FAILED")
                      or "invalid argument" in ln]
            results[i] = proc.returncode
            print(f"process {i} rc={proc.returncode} {secs:.0f} s: "
                  f"{lines[-1] if lines else ''}", flush=True)
            for ln in failed[:5]:
                print(f"  {ln[:300]}", flush=True)
            del running[i]
        if time.monotonic() >= deadline:
            for i in pending:
                results[i] = None
            pending = []
    clean = sum(1 for rc in results.values() if rc == 0)
    print(f"{clean} of {args.processes} processes clean in "
          f"{time.monotonic() - t_start:.0f} s, {args.parallel} at a time")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0 if clean == args.processes else 1


if __name__ == "__main__":
    sys.exit(main())
