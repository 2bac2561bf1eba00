"""Fleet: multi-process training bootstrap and role management
(``paddle_tpu/fleet.py``; fluid's ``Fleet`` facade, ``role_maker.py``).

Every process is a worker of one program: :func:`init` joins the default
``torch.distributed`` process group over a TCP store at the
coordinator's ``host:port`` (rank 0 holds it). The backend is gloo: on
the CPU, and on the one card too, where NCCL refuses two ranks on one GPU
(NCCL across cards is ROADMAP's "NCCL across cards"). :func:`barrier`,
:func:`agree_on_resume_step`, :class:`HeartbeatMonitor`,
:class:`ElasticCoordinator` (a supervisor of worker processes with gang
restarts) and :func:`local_shard` follow the reference.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from paddle_tpu_torch.observability import registry as _registry


@dataclasses.dataclass
class RoleMaker:
    """A process's place in the job (role_maker.py, without pserver
    roles)."""

    worker_index: int = 0
    worker_num: int = 1
    coordinator: Optional[str] = None

    def is_first_worker(self) -> bool:
        return self.worker_index == 0

    @classmethod
    def from_env(cls, environ=None) -> "RoleMaker":
        """From the environment ``launch.worker_env`` writes: ``RANK``,
        ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``, or the
        PaddleCloud names ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``
        and ``PADDLE_COORDINATOR`` (``host:port``)."""
        env = os.environ if environ is None else environ
        idx = int(env.get("RANK", env.get("PADDLE_TRAINER_ID", "0")))
        num = int(env.get("WORLD_SIZE", env.get("PADDLE_TRAINERS_NUM",
                                                "1")))
        coord = env.get("PADDLE_COORDINATOR")
        if coord is None and "MASTER_ADDR" in env:
            coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', 29500)}"
        return cls(idx, num, coord)


def init(role: Optional[RoleMaker] = None) -> RoleMaker:
    """Join the job (``Fleet.init``): with more than one worker, the
    default gloo process group over ``tcp://<coordinator>``; one worker
    joins nothing. Sets the ``fleet_worker_index``/``fleet_worker_num``
    gauges."""
    role = role or RoleMaker.from_env()
    if role.worker_num > 1 and not dist.is_initialized():
        if role.coordinator is None:
            raise ValueError("a job of more than one worker needs the "
                             "coordinator's host:port")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{role.coordinator}",
            rank=role.worker_index, world_size=role.worker_num)
    reg = _registry.default()
    reg.gauge("fleet_worker_index").set(role.worker_index)
    reg.gauge("fleet_worker_num").set(role.worker_num)
    return role


def worker_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def worker_num() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_first_worker() -> bool:
    return worker_index() == 0


def barrier(name: str = "fleet"):
    """Every worker waits for the others (fleet_util's barrier); one
    worker returns at once."""
    del name
    if worker_num() > 1:
        dist.barrier()


def agree_on_resume_step(step: Optional[int]) -> Optional[int]:
    """Every worker reports the newest valid snapshot step it sees (None:
    nothing to restore) and all adopt the smallest: the newest step the
    whole job can restore (a worker that committed just before a crash
    drops back with the others; if any worker has none, all start from
    scratch, None). It is also the restore-time barrier: the all-gather
    waits for every worker."""
    local = -1 if step is None else int(step)
    if worker_num() == 1:
        agreed = local
    else:
        steps = [torch.zeros((), dtype=torch.int64)
                 for _ in range(worker_num())]
        dist.all_gather(steps, torch.tensor(local, dtype=torch.int64))
        values = [int(s) for s in steps]
        agreed = min(values)
        if max(values) != agreed:
            _registry.default().counter(
                "resilience_resume_step_disagreements_total",
                "restores where workers saw different latest snapshots"
            ).inc()
            print(f"[fleet] resume-step disagreement across workers "
                  f"(min={agreed} max={max(values)}); all workers resume "
                  f"from {agreed}")
    return None if agreed < 0 else agreed


class HeartbeatMonitor:
    """Training-stall watchdog (``heart_beat_monitor.h``'s
    ``LostWorkerMonitor``): a thread checks every ``check_every_s`` that
    a step beat arrived within ``timeout_s`` and calls ``on_stall(step,
    idle_s)`` when none did."""

    def __init__(self, timeout_s: float = 300.0, *,
                 check_every_s: float = 10.0, on_stall=None, log_fn=print):
        self.timeout_s = timeout_s
        self._last = time.monotonic()
        self._step = -1
        self._stop = threading.Event()
        self._on_stall = on_stall
        self._log = log_fn
        reg = _registry.default()
        self._idle = reg.gauge("fleet_heartbeat_idle_seconds",
                               "seconds since the last step beat")
        self._stalls = reg.counter("fleet_heartbeat_stalls_total")
        self._last_step = reg.gauge("fleet_last_step",
                                    "latest step a beat reported")

        def watch():
            while not self._stop.wait(check_every_s):
                idle = time.monotonic() - self._last
                self._idle.set(idle)
                if idle > self.timeout_s:
                    self._log(f"[heartbeat] no progress for {idle:.0f}s "
                              f"(last step {self._step})")
                    self._stalls.inc()
                    if self._on_stall is not None:
                        self._on_stall(self._step, idle)

        self._thread = threading.Thread(target=watch, daemon=True,
                                        name="fleet-heartbeat")
        self._thread.start()

    def beat(self, step: int):
        self._last = time.monotonic()
        self._step = step
        self._last_step.set(step)

    def stop(self):
        """Stop the watch thread and wait for it (it wakes at once)."""
        self._stop.set()
        self._thread.join(timeout=5.0)


class ElasticCoordinator:
    """Supervisor of worker processes: spawn ``num_workers`` ranks, watch
    their exits, respawn failed ones until every rank succeeds or the
    restart budget is spent (the restart-policy half of fluid's fault
    tolerance; workers resume from their newest checkpoint).

    ``spawn_fn(rank, attempt) -> subprocess.Popen``; exits in
    ``success_rc`` are done; exits in ``preempt_rc`` (default
    ``resilience.EXIT_PREEMPTED``) respawn without charging the budget;
    exits in ``drain_rc`` (default ``resilience.EXIT_DRAINED``, a
    voluntary scale-in) retire the rank as done (``drained_exits``
    counts them); any other exit is a failure. ``gang=True``: a failure
    kills and respawns every live rank at ``attempt + 1`` (a process
    group cannot admit a lone rejoining rank); ``gang=False`` restarts
    ranks one by one."""

    def __init__(self, spawn_fn, num_workers: int, *,
                 max_restarts: int = 2, poll_s: float = 0.2,
                 success_rc: tuple = (0,), gang: bool = True,
                 preempt_rc: Optional[tuple] = None,
                 drain_rc: Optional[tuple] = None, log_fn=print):
        from paddle_tpu_torch.resilience.preempt import (EXIT_DRAINED,
                                                         EXIT_PREEMPTED)
        self.spawn_fn = spawn_fn
        self.num_workers = num_workers
        self.max_restarts = max_restarts
        self.poll_s = poll_s
        self.success_rc = tuple(success_rc)
        self.preempt_rc = tuple(preempt_rc if preempt_rc is not None
                                else (EXIT_PREEMPTED,))
        self.drain_rc = tuple(drain_rc if drain_rc is not None
                              else (EXIT_DRAINED,))
        self.gang = gang
        self.restarts = 0                       # gang restarts
        self.rank_restarts = [0] * num_workers
        self.preemption_restarts = 0            # respawns off the budget
        self.drained_exits = 0
        self._log = log_fn

    def run(self, timeout_s: float = 600.0) -> bool:
        """Supervise until every rank succeeds (True), or the restart
        budget or the deadline runs out (False; the survivors killed)."""
        procs = [self.spawn_fn(r, 0) for r in range(self.num_workers)]
        done = [False] * self.num_workers
        # drained ranks stay retired: a gang respawn must not revive them
        drained = [False] * self.num_workers
        deadline = time.monotonic() + timeout_s
        try:
            while not all(done):
                if time.monotonic() > deadline:
                    self._log("[elastic] deadline exceeded")
                    return False
                failed = None
                # record every exit of this poll before acting on a
                # failure, so a rank that drained is not respawned
                for r, p in enumerate(procs):
                    if done[r] or p.poll() is None:
                        continue
                    rc = p.returncode
                    if rc in self.success_rc:
                        done[r] = True
                    elif rc in self.drain_rc:
                        self.drained_exits += 1
                        self._log(f"[elastic] rank {r} drained rc={rc}; "
                                  "retired (no respawn, no restart budget "
                                  "consumed)")
                        done[r] = drained[r] = True
                    elif failed is None:
                        failed = (r, rc)
                if failed is None:
                    time.sleep(self.poll_s)
                    continue
                r, rc = failed
                preempted = rc in self.preempt_rc
                if self.gang:
                    if preempted:
                        self.preemption_restarts += 1
                        self._log(f"[elastic] rank {r} preempted rc={rc}; "
                                  f"gang respawn (preemption "
                                  f"{self.preemption_restarts}, no restart "
                                  "budget consumed)")
                    else:
                        if self.restarts >= self.max_restarts:
                            self._log(f"[elastic] rank {r} failed rc={rc}; "
                                      "gang restart budget exhausted")
                            return False
                        self.restarts += 1
                        self._log(f"[elastic] rank {r} failed rc={rc}; gang "
                                  f"restart {self.restarts}/"
                                  f"{self.max_restarts} (kill + respawn all, "
                                  "resume from checkpoint)")
                    for p in procs:
                        if p.poll() is None:
                            p.kill()
                    for p in procs:
                        p.wait()
                    attempt = self.restarts + self.preemption_restarts
                    procs = [procs[i] if drained[i]
                             else self.spawn_fn(i, attempt)
                             for i in range(self.num_workers)]
                    done = list(drained)
                elif preempted:
                    self.preemption_restarts += 1
                    self._log(f"[elastic] rank {r} preempted rc={rc}; "
                              "respawn (no restart budget consumed)")
                    procs[r] = self.spawn_fn(
                        r, self.rank_restarts[r] + self.preemption_restarts)
                else:
                    if self.rank_restarts[r] >= self.max_restarts:
                        self._log(f"[elastic] rank {r} failed rc={rc}, "
                                  "restart budget exhausted")
                        return False
                    self.rank_restarts[r] += 1
                    self._log(f"[elastic] rank {r} failed rc={rc}; "
                              f"restart {self.rank_restarts[r]}/"
                              f"{self.max_restarts}")
                    procs[r] = self.spawn_fn(r, self.rank_restarts[r])
            return True
        finally:
            for r, p in enumerate(procs):
                if not done[r] and p.poll() is None:
                    p.kill()
            for r, p in enumerate(procs):
                if not done[r]:
                    p.wait()      # reap: no zombies in the supervisor


def local_shard(batch, *, index: Optional[int] = None,
                num: Optional[int] = None):
    """This worker's contiguous block of a global host batch along dim 0
    (a dict, list or tuple of tensors or numpy arrays); the batch dim must
    divide by the worker count."""
    index = worker_index() if index is None else index
    num = worker_num() if num is None else num

    def shard(x):
        n = x.shape[0]
        if n % num:
            raise ValueError(
                f"batch dim {n} not divisible by {num} workers — pad or "
                f"drop the remainder explicitly before sharding")
        per = n // num
        return x[index * per:(index + 1) * per]

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return shard(tree)

    return walk(batch)


__all__ = ["ElasticCoordinator", "HeartbeatMonitor", "RoleMaker",
           "agree_on_resume_step", "barrier", "init", "is_first_worker",
           "local_shard", "worker_index", "worker_num"]
