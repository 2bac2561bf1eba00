"""Elastic autoscaling: the BurnRateMonitor becomes the scale signal.

Each replica already runs a multi-window SLO burn-rate monitor over its
TTFT histogram; the autoscaler reads that burn straight out of
``health()["slo"]`` and turns sustained deadline pressure into capacity:

- **Scale out**: any replica's burn over ``scale_out_burn`` on BOTH
  windows (the page-severity shape — a spike alone never scales) for
  ``sustain_s`` seconds → ``spawn_replica()`` builds a fresh replica,
  the autoscaler runs its full ``warmup()`` (every decode/prefill/
  migration bucket captured, one CUDA graph each on the card —
  ``warmup_plan`` discipline) BEFORE the router sees it, so a scale-out
  never injects captures into the serving path.
- **Scale in**: the whole fleet idle-ish (occupancy under
  ``idle_occupancy`` and no queue) for ``idle_s`` seconds with more
  than ``min_replicas`` running → the least-loaded replica is drained
  through :meth:`FleetRouter.drain_replica` — queued requests
  re-routed, in-flight requests **live-migrated** (snapshot → verified
  restore → resume), never killed.

A ``cooldown_s`` gate after either action stops flapping, and an
injected ``clock`` makes every threshold unit-testable without
sleeping. Replicas that exit as OS processes on scale-in should use
:data:`~paddle_tpu_torch.resilience.preempt.EXIT_DRAINED`, so a launcher
can tell a drain from a crash.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


class FleetAutoscaler:
    """Burn-rate-driven elastic sizing for a :class:`FleetRouter`.

    ``spawn_replica(index) -> ReplicaHandle`` builds (but need not
    warm) a new replica; the autoscaler warms it before attaching.
    ``tick()`` is called once per fleet step (the router does this
    automatically when constructed with ``autoscaler=``); it returns
    ``"scale_out"`` / ``"scale_in"`` / ``"replace"`` / ``None`` for
    observability and tests. ``"replace"`` restores
    capacity lost *involuntarily*: when ejections and open circuit
    breakers drop the ROUTABLE replica count below ``min_replicas``,
    a warmed replacement spawns (cooldown-gated) — the autoscaler
    treats an open breaker exactly as lost capacity, while voluntary
    drains shrink the fleet on purpose and are never replaced.
    """

    def __init__(self, spawn_replica: Callable[[int], object], *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 scale_out_burn: float = 6.0, sustain_s: float = 2.0,
                 idle_occupancy: float = 0.1, idle_s: float = 5.0,
                 cooldown_s: float = 5.0, headroom_floor: float = 0.0,
                 tiers: Optional[Dict[str, Dict]] = None,
                 registry=None, clock=time.monotonic):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas < min_replicas")
        self.spawn_replica = spawn_replica
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_out_burn = float(scale_out_burn)
        self.sustain_s = float(sustain_s)
        self.idle_occupancy = float(idle_occupancy)
        self.idle_s = float(idle_s)
        self.cooldown_s = float(cooldown_s)
        self.headroom_floor = float(headroom_floor)
        self._clock = clock
        from paddle_tpu_torch import observability as obs
        self._reg = registry or obs.default()
        self.router = None
        self._spawned = 0
        self._hot_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._cooldown_until = float("-inf")
        self.scale_outs = 0
        self.scale_ins = 0
        self.events: List[Dict] = []
        # disaggregated fleets scale each tier on ITS
        # binding resource: the prefill tier is flops-bound (queue wait
        # and compute headroom), the decode tier is KV-capacity-bound
        # (page/slot headroom). Each tier gets its own spawn factory,
        # min/max, sustain/idle windows (shared durations) and
        # cooldown. ``tiers=None`` keeps the single-pool behavior for
        # colocated fleets bit-for-bit.
        self.tiers: Optional[Dict[str, Dict]] = None
        if tiers:
            self.tiers = {}
            for tname, tcfg in tiers.items():
                if tname not in ("prefill", "decode"):
                    raise ValueError(
                        f"unknown tier {tname!r} (prefill/decode)")
                if not callable(tcfg.get("spawn")):
                    raise ValueError(
                        f"tier {tname!r} needs a spawn callable")
                tmin = int(tcfg.get("min", 1))
                tmax = int(tcfg.get("max", max_replicas))
                if tmin < 1 or tmax < tmin:
                    raise ValueError(
                        f"tier {tname!r}: bad min/max ({tmin}/{tmax})")
                self.tiers[tname] = {
                    "spawn": tcfg["spawn"], "min": tmin, "max": tmax,
                    "queue_hot": int(tcfg.get("queue_hot", 4)),
                    "headroom_floor": float(
                        tcfg.get("headroom_floor", 0.25)),
                }
            self._tier_hot: Dict[str, Optional[float]] = {
                t: None for t in self.tiers}
            self._tier_idle: Dict[str, Optional[float]] = {
                t: None for t in self.tiers}
            self._tier_cooldown: Dict[str, float] = {
                t: float("-inf") for t in self.tiers}

    def bind(self, router):
        self.router = router
        self._spawned = len(router.replicas)

    # -- signal reads ------------------------------------------------------

    def _routable(self):
        """Replicas new work can land on — open breakers and ejected
        replicas are LOST capacity, invisible to the burn/idle signals
        and replaced by :meth:`_replace`."""
        router = self.router
        if hasattr(router, "is_routable"):
            return [r for r in router.replicas if router.is_routable(r)]
        return list(router.replicas)

    def _pressure(self) -> float:
        """Hottest routable replica's burn, counted only when BOTH
        windows breach (the alerting shape — one latency spike never
        scales)."""
        worst = 0.0
        for rep in self._routable():
            try:
                slo = rep.health().get("slo") or {}
            except NotImplementedError:
                raise
            except Exception:
                continue            # dying replica: the detector's job
            bf = float(slo.get("burn_fast", 0.0))
            bs = float(slo.get("burn_slow", 0.0))
            if bf >= self.scale_out_burn and bs >= self.scale_out_burn:
                worst = max(worst, bf)
        return worst

    def _fleet_idle(self) -> bool:
        h = self.router.health()
        if (h["queue_depth_total"] != 0
                or h["slot_occupancy_mean"] > self.idle_occupancy):
            return False
        # headroom cross-check, opt-in via headroom_floor>0:
        # occupancy can read idle between decode bursts while KV pages
        # are still pinned — a replica below the page/slot/HBM headroom
        # floor is holding live state, and draining it would migrate
        # all of it for nothing. The default floor of 0.0 disables the
        # veto so an operator who tuned idle_occupancy alone keeps the
        # scale-in timing they asked for; replicas without a headroom
        # plane pass regardless.
        for rh in h["per_replica"].values():
            head = rh.get("headroom") or {}
            # "spill" joins the veto: a replica whose host
            # pool is full of spilled prefix pages is the fleet's cold
            # prefix store — scaling it in would destroy pages peers
            # still fetch (spill reads 1.0 when the tier is off)
            for res in ("pages", "slots", "hbm", "spill"):
                if float(head.get(res, 1.0)) < self.headroom_floor:
                    return False
        return True

    # -- the periodic decision ---------------------------------------------

    def tick(self) -> Optional[str]:
        if self.router is None:
            raise RuntimeError("autoscaler not bound to a router")
        now = self._clock()
        if self.tiers:
            return self._tick_tiered(now)
        if now < self._cooldown_until:
            return None
        n = len(self.router.replicas)
        n_routable = len(self._routable())
        # lost capacity first: a crash ejection or an open breaker has
        # dropped the ROUTABLE fleet below the floor — spawn a warmed
        # replacement (the crashed/drained distinction:
        # drains shrink the fleet on purpose and do not replace)
        if n_routable < self.min_replicas and n < self.max_replicas:
            return self._replace(n_routable)
        burn = self._pressure()
        if burn > 0.0 and n < self.max_replicas:
            self._idle_since = None
            if self._hot_since is None:
                self._hot_since = now
            if now - self._hot_since >= self.sustain_s:
                return self._scale_out(burn)
            return None
        self._hot_since = None
        if n > self.min_replicas and self._fleet_idle():
            if self._idle_since is None:
                self._idle_since = now
            if now - self._idle_since >= self.idle_s:
                return self._scale_in()
            return None
        self._idle_since = None
        return None

    def _replace(self, n_routable: int) -> str:
        """Spawn a warmed replacement for capacity lost involuntarily
        (ejected replica / open breaker) — same full-warmup-before-
        traffic discipline as scale-out, its own counter so crash
        churn is distinguishable from demand growth."""
        rep = self.spawn_replica(self._spawned)
        self._spawned += 1
        rep.warmup()
        self.router.add_replica(rep)
        self._cooldown_until = self._clock() + self.cooldown_s
        self._reg.counter(
            "fleet_replace_spawn_total",
            "replicas spawned to replace lost capacity").inc()
        self.events.append({"action": "replace",
                            "routable": n_routable,
                            "replicas": len(self.router.replicas),
                            "replica": rep.name})
        if self.router.tracer.enabled:
            self.router.tracer.record_span(
                "fleet.replace", duration_s=0.0, routable=n_routable,
                replicas=len(self.router.replicas), replica=rep.name)
        return "replace"

    def _scale_out(self, burn: float) -> str:
        rep = self.spawn_replica(self._spawned)
        self._spawned += 1
        rep.warmup()        # every bucket captured BEFORE first traffic
        self.router.add_replica(rep)
        self.scale_outs += 1
        self._hot_since = None
        self._cooldown_until = self._clock() + self.cooldown_s
        self._reg.counter("fleet_scale_out_total",
                          "replicas added by the autoscaler").inc()
        self.events.append({"action": "scale_out", "burn": burn,
                            "replicas": len(self.router.replicas),
                            "replica": rep.name})
        if self.router.tracer.enabled:
            self.router.tracer.record_span(
                "fleet.scale_out", duration_s=0.0, burn=round(burn, 3),
                replicas=len(self.router.replicas), replica=rep.name)
        return "scale_out"

    def _scale_in(self) -> Optional[str]:
        from paddle_tpu_torch.serving.engine import SlotMigrationError
        # victims come from the ROUTABLE set: draining a breaker-open
        # replica would try to live-migrate through the very transport
        # that is failing. A fleet with no routable victim (fleet-wide
        # breaker flap) simply cannot shrink right now — never crash
        # the serve loop over it.
        cands = [r for r in self._routable()
                 if not getattr(r, "draining", False)]
        if not cands:
            self._idle_since = None
            return None
        victim = min(
            cands,
            key=lambda r: float(
                r.health().get("requests_in_flight", 0)))
        try:
            migrated = self.router.drain_replica(victim)
        except SlotMigrationError:
            # peers had no capacity for the victim's in-flight work —
            # the drain restored everything back and lost nothing, but
            # the fleet cannot shrink right now. Back off a cooldown
            # instead of re-raising into the serve loop (which would
            # retry-and-crash every step while the condition holds).
            self._idle_since = None
            self._cooldown_until = self._clock() + self.cooldown_s
            self._reg.counter(
                "fleet_scale_in_aborted_total",
                "scale-in drains aborted for lack of peer capacity"
            ).inc()
            self.events.append({"action": "scale_in_aborted",
                                "replica": victim.name,
                                "replicas": len(self.router.replicas)})
            return None
        self.scale_ins += 1
        self._idle_since = None
        self._cooldown_until = self._clock() + self.cooldown_s
        self._reg.counter("fleet_scale_in_total",
                          "replicas drained by the autoscaler").inc()
        self.events.append({"action": "scale_in", "migrated": migrated,
                            "replicas": len(self.router.replicas),
                            "replica": victim.name})
        if self.router.tracer.enabled:
            self.router.tracer.record_span(
                "fleet.scale_in", duration_s=0.0, migrated=migrated,
                replicas=len(self.router.replicas), replica=victim.name)
        return "scale_in"

    # -- per-tier scaling ---------------------------------------

    def _tick_tiered(self, now: float) -> Optional[str]:
        """One decision pass over each configured tier. Tiers are
        independent — a hot prefill tier scales out while an idle
        decode tier scales in, each behind its own cooldown."""
        router = self.router
        action = None
        for tname, cfg in self.tiers.items():
            if now < self._tier_cooldown[tname]:
                continue
            members = [r for r in router.replicas
                       if router.replica_tier(r) == tname]
            routable = [r for r in members if router.is_routable(r)]
            # lost capacity first, same rule as the single pool
            if len(routable) < cfg["min"] and len(members) < cfg["max"]:
                action = self._tier_spawn(tname, cfg, "replace",
                                          routable=len(routable))
                continue
            if (self._tier_pressure(tname, cfg, routable)
                    and len(members) < cfg["max"]):
                self._tier_idle[tname] = None
                if self._tier_hot[tname] is None:
                    self._tier_hot[tname] = now
                if now - self._tier_hot[tname] >= self.sustain_s:
                    action = self._tier_spawn(tname, cfg, "scale_out")
                continue
            self._tier_hot[tname] = None
            if (len(members) > cfg["min"]
                    and self._tier_is_idle(routable)):
                if self._tier_idle[tname] is None:
                    self._tier_idle[tname] = now
                if now - self._tier_idle[tname] >= self.idle_s:
                    action = self._tier_scale_in(
                        tname, routable) or action
                continue
            self._tier_idle[tname] = None
        return action

    def _tier_pressure(self, tname: str, cfg: Dict, routable) -> bool:
        """Tier-specific saturation: prefill is flops-bound (compute
        headroom under the floor, or queued prompts piling up); decode
        is KV-bound (page/slot headroom under the floor)."""
        floor = cfg["headroom_floor"]
        for rep in routable:
            try:
                h = rep.health()
            except NotImplementedError:
                raise
            except Exception:
                continue            # dying replica: the detector's job
            head = h.get("headroom") or {}
            if tname == "prefill":
                if int(h.get("queue_depth", 0) or 0) >= cfg["queue_hot"]:
                    return True
                if float(head.get("flops", 1.0)) < floor:
                    return True
            else:
                if min(float(head.get("pages", 1.0)),
                       float(head.get("slots", 1.0))) < floor:
                    return True
        return False

    def _tier_is_idle(self, members) -> bool:
        for rep in members:
            try:
                h = rep.health()
            except NotImplementedError:
                raise
            except Exception:
                return False
            if (int(h.get("queue_depth", 0) or 0) != 0
                    or float(h.get("slot_occupancy", 0.0))
                    > self.idle_occupancy):
                return False
        return bool(members)

    def _tier_spawn(self, tname: str, cfg: Dict, action: str,
                    routable: Optional[int] = None) -> str:
        rep = cfg["spawn"](self._spawned)
        self._spawned += 1
        rep.warmup()        # every bucket captured BEFORE first traffic
        self.router.add_replica(rep)
        self._tier_hot[tname] = None
        self._tier_cooldown[tname] = self._clock() + self.cooldown_s
        if action == "scale_out":
            self.scale_outs += 1
            self._reg.counter(
                "fleet_scale_out_total",
                "replicas added by the autoscaler").inc(tier=tname)
        else:
            self._reg.counter(
                "fleet_replace_spawn_total",
                "replicas spawned to replace lost capacity").inc(
                    tier=tname)
        ev = {"action": action, "tier": tname,
              "replicas": len(self.router.replicas),
              "replica": rep.name}
        if routable is not None:
            ev["routable"] = routable
        self.events.append(ev)
        if self.router.tracer.enabled:
            self.router.tracer.record_span(
                f"fleet.{action}", duration_s=0.0, tier=tname,
                replicas=len(self.router.replicas), replica=rep.name)
        return f"{action}:{tname}"

    def _tier_scale_in(self, tname: str, routable) -> Optional[str]:
        from paddle_tpu_torch.serving.engine import SlotMigrationError
        cands = [r for r in routable
                 if not getattr(r, "draining", False)]
        if not cands:
            self._tier_idle[tname] = None
            return None
        victim = min(
            cands,
            key=lambda r: float(
                r.health().get("requests_in_flight", 0)))
        try:
            migrated = self.router.drain_replica(victim)
        except SlotMigrationError:
            self._tier_idle[tname] = None
            self._tier_cooldown[tname] = self._clock() + self.cooldown_s
            self._reg.counter(
                "fleet_scale_in_aborted_total",
                "scale-in drains aborted for lack of peer capacity"
            ).inc(tier=tname)
            self.events.append({"action": "scale_in_aborted",
                                "tier": tname, "replica": victim.name,
                                "replicas": len(self.router.replicas)})
            return None
        self.scale_ins += 1
        self._tier_idle[tname] = None
        self._tier_cooldown[tname] = self._clock() + self.cooldown_s
        self._reg.counter(
            "fleet_scale_in_total",
            "replicas drained by the autoscaler").inc(tier=tname)
        self.events.append({"action": "scale_in", "tier": tname,
                            "migrated": migrated,
                            "replicas": len(self.router.replicas),
                            "replica": victim.name})
        if self.router.tracer.enabled:
            self.router.tracer.record_span(
                "fleet.scale_in", duration_s=0.0, tier=tname,
                migrated=migrated,
                replicas=len(self.router.replicas),
                replica=victim.name)
        return f"scale_in:{tname}"
