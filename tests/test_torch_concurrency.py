"""The port's concurrency tier and conformance lints on the CPU
(``paddle_tpu_torch/analysis/{concurrency,conformance,findings}.py``)
against the JAX package's, and ``inference.make_net_serving_fleet``.

- The reference's fire and clean-twin pairs
  (``tests/test_concurrency_lint.py``) as one parametrised test: each
  case runs the port's lint and the reference's on the same source and
  asserts the same rule ids and locations (and that it fires or stays
  clean as the reference's test says).
- The port's committed ``lock_order.json`` is fresh; the port's graph is
  acyclic with no double-acquire; the port's package findings are all
  triaged by its committed suppressions.
- The sanitizer raises on a same-thread double-acquire, leaves locks made
  outside it alone, and sees the real nested edge in a threaded CPU
  fleet run, which the committed manifest blesses.
- ``lint_interfaces`` and ``lint_reject_vocab`` are clean on the port,
  and the port's ``REJECT_REASONS`` are the reference's.
- ``make_net_serving_fleet`` over two replica servers gives the fp32
  tokens of the in-process ``make_serving_fleet`` on the same weights.
"""

import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.analysis import concurrency as ref_conc
from paddle_tpu.analysis import findings as ref_findings
from paddle_tpu.serving import scheduler as ref_scheduler
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.analysis import concurrency as conc
from paddle_tpu_torch.analysis import conformance, findings
from paddle_tpu_torch.inference import (make_net_serving_fleet,
                                        make_serving_engine,
                                        make_serving_fleet)
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.fleet import net
from paddle_tpu_torch.serving.scheduler import REJECT_REASONS

torch.set_num_threads(2)

DIMS = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
            ffn_size=32, max_position=64)
GEOM = dict(num_slots=4, page_size=4, max_tokens_per_slot=32,
            prefill_chunk=4)


@pytest.fixture(scope="module")
def model():
    return GPT(GPTConfig.tiny(**DIMS), device="cpu", seed=0)


def _engine(model, **kw):
    return make_serving_engine(model, device="cpu",
                               registry=obs.MetricsRegistry(),
                               **{**GEOM, **kw})


def _sig(found):
    return sorted((f.rule, f.location) for f in found)


# ---------------------------------------------------------------------------
# the reference's fire / clean-twin pairs, run through both lints

_HDR = """
import threading
from paddle_tpu.analysis.concurrency import guarded_by

@guarded_by("_lk", "_x")
class C:
    def __init__(self):
        self._lk = threading.Lock()
        self._x = 0
"""

_CYCLE = """
import threading

class A:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
    def fwd(self):
        with self._a:
            with self._b:
                pass
    def rev(self):
        with self._b:
            with self._a:
                pass
"""
_ACYCLIC = _CYCLE.replace("""    def rev(self):
        with self._b:
            with self._a:
                pass
""", "")
_REENTRY = """
import threading

class D:
    def __init__(self):
        self._m = threading.{kind}()
    def _inner(self):
        with self._m:
            pass
    def outer(self):
        with self._m:
            self._inner()
"""

#: (case, pass, source, fires): ``locks`` runs ``lint_locks``, ``graph``
#: ``extract_lock_graph(...).findings()``, ``drift`` ``lock_order_diff``
#: of the acyclic graph against a manifest edited by the source's name
CASES = [
    ("unguarded_read", "locks", _HDR + """
    def peek(self):
        return self._x
""", True),
    ("guarded_read_twin", "locks", _HDR + """
    def peek(self):
        with self._lk:
            return self._x
""", False),
    ("unguarded_write_via_helper", "locks", _HDR + """
    def _bump(self):
        self._x += 1
    def locked_path(self):
        with self._lk:
            self._bump()
    def sneak(self):
        self._bump()
""", True),
    ("helper_with_all_callers_holding_twin", "locks", _HDR + """
    def _bump(self):
        self._x += 1
    def a(self):
        with self._lk:
            self._bump()
    def b(self):
        with self._lk:
            self._bump()
""", False),
    ("public_method_never_excused", "locks", _HDR + """
    def bump(self):
        self._x += 1
    def locked_path(self):
        with self._lk:
            self.bump()
""", True),
    ("init_exempt_twin", "locks", _HDR, False),
    ("with_inside_except_handler", "locks", _HDR + """
    def ok(self):
        try:
            pass
        except Exception as e:
            with self._lk:
                self._x = 1
    def bad(self):
        try:
            pass
        except Exception as e:
            self._x = 1
""", True),
    ("nested_def_runs_unlocked", "locks", _HDR + """
    def spawn(self):
        with self._lk:
            def worker():
                return self._x
            return worker
""", True),
    ("cycle", "graph", _CYCLE, True),
    ("acyclic_twin", "graph", _ACYCLIC, False),
    ("double_acquire_via_helper", "graph", _REENTRY.format(kind="Lock"),
     True),
    ("rlock_reacquire_twin", "graph", _REENTRY.format(kind="RLock"), False),
    ("manifest_round_trip_twin", "drift", "same", False),
    ("missing_manifest", "drift", "none", True),
    ("new_edge_and_stale_lock", "drift", "edited", True),
]


def _run(mod, kind, src):
    if kind == "locks":
        return mod.lint_locks(src, filename="t.py")
    if kind == "graph":
        return mod.extract_lock_graph({"a.py": src}).findings()
    graph = mod.extract_lock_graph({"a.py": _ACYCLIC})
    manifest = None if src == "none" else mod.lock_order_manifest(graph)
    if src == "edited":
        manifest["edges"] = []                     # an edge goes missing
        manifest["locks"]["Ghost._lock"] = "lock"  # a lock goes stale
    return mod.lock_order_diff(graph, manifest, path="lock_order.json")


@pytest.mark.parametrize("case,kind,src,fires", CASES,
                         ids=[c[0] for c in CASES])
def test_fire_and_clean_twins_match_the_reference(case, kind, src, fires):
    got, want = _run(conc, kind, src), _run(ref_conc, kind, src)
    assert _sig(got) == _sig(want)
    assert [f.message for f in got] == [f.message for f in want]
    assert bool(got) == fires, [f.message for f in got]


def test_rules_keep_the_references_ids_and_severities():
    assert set(findings.RULES) == {
        "kernel-contract", "kernel-registry-bypass", "unguarded-access",
        "lock-order-cycle", "double-acquire", "lock-order-drift",
        "sanitizer-violation", "interface-drift", "reject-vocab-drift",
        # the analysis tiers' rules
        "host-callback", "debug-callback", "f64-promotion",
        "undonated-buffer", "prng-key-reuse", "replicated-large",
        "ast-host-sync", "ast-tracer-branch", "unexpected-collective",
        "resharding-churn", "peak-hbm-budget", "bucket-coverage",
        "cost-regression"}
    for rule, (severity, _) in findings.RULES.items():
        assert severity == ref_findings.RULES[rule][0]


def test_guarded_by_merges_stacks_and_annotates_the_fleet():
    @conc.guarded_by("_cv", "_a", "_b")
    @conc.guarded_by("_vlock", "_c")
    class C:
        pass
    assert C.__guarded_by__ == {"_a": "_cv", "_b": "_cv", "_c": "_vlock"}
    from paddle_tpu_torch.resilience.snapshot import SnapshotEngine
    from paddle_tpu_torch.serving.fleet.net.frontdoor import FrontDoor
    assert fleet.LocalReplica.__guarded_by__["engine"] == "_lock"
    assert fleet.FleetRouter.__guarded_by__["_postmortems"] == "_view_lock"
    assert SnapshotEngine.__guarded_by__["_error"] == "_err_lock"
    assert FrontDoor.__guarded_by__ == {"_netlog": "_netlog_lock",
                                        "_frame": "_netlog_lock"}


# ---------------------------------------------------------------------------
# the port's package and its committed manifest


def test_the_committed_lock_order_is_fresh():
    graph = conc.extract_lock_graph(conc.package_sources())
    out = conc.lock_order_diff(graph, conc.load_lock_order(
        conc.LOCK_ORDER_PATH))
    assert out == [], "\n".join(f.message for f in out)


def test_the_ports_graph_is_acyclic_with_the_nested_edge():
    graph = conc.extract_lock_graph(conc.package_sources())
    assert graph.acyclic() and not graph.double_acquires
    assert ("LocalReplica._lock", "ServingEngine._health_lock") in graph.edges


def test_the_ports_findings_are_all_triaged():
    sup = findings.Suppressions.load(findings.SUPPRESSIONS_PATH)
    report = conc.lint_concurrency(lock_order=conc.LOCK_ORDER_PATH,
                                   suppressions=sup, registry=False)
    assert report.findings == [], report.render_text()
    assert {f.rule for f in report.suppressed} == {"unguarded-access"}
    assert sup.stale() == []


def test_the_cli_lints_clean_and_rewrites_the_same_manifest(tmp_path,
                                                            capsys):
    assert conc.main([]) == 0
    out = tmp_path / "lock_order.json"
    assert conc.main(["--update-lock-order", "--lock-order", str(out)]) == 0
    assert out.read_text() == open(conc.LOCK_ORDER_PATH).read()


# ---------------------------------------------------------------------------
# the runtime sanitizer


def test_a_same_thread_double_acquire_raises():
    with conc.sanitize(register_metrics=False) as mon:
        lk = threading.Lock()
        lk.acquire()
        with pytest.raises(conc.DoubleAcquireError):
            lk.acquire()
        lk.release()
        rl = threading.RLock()
        with rl:
            with rl:
                pass
    assert mon.double_acquires == ["<anonymous>"]
    assert [f.rule for f in mon.check({"edges": []})] == ["double-acquire"]


def test_locks_made_outside_the_sanitizer_are_untouched():
    before = threading.Lock()
    with conc.sanitize(register_metrics=False):
        inside = threading.Lock()
    after = threading.Lock()
    assert isinstance(inside, conc._SanitizedLock)
    assert not isinstance(before, conc._SanitizedLock)
    assert not isinstance(after, conc._SanitizedLock)


def test_the_sanitizer_names_the_nested_edge_and_exports_metrics(model):
    with conc.sanitize(register_metrics=False) as mon:
        rep = fleet.LocalReplica(_engine(model), name="san0")
        rep.step()
    edge = ("LocalReplica._lock", "ServingEngine._health_lock")
    assert edge in mon.observed_edges()
    assert mon.check(conc.load_lock_order(conc.LOCK_ORDER_PATH)) == []
    inverted = {"edges": [[edge[1], edge[0], "x"]]}
    assert [f.rule for f in mon.check(inverted)] == ["sanitizer-violation"]
    reg = obs.MetricsRegistry()
    mon.export_metrics(reg)
    text = reg.render_prometheus()
    assert "concurrency_lock_acquisitions_total" in text
    assert "concurrency_lock_order_edges_total" in text


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, int(k)).astype(np.int32)
            for k in rng.integers(3, 12, n)]


def test_a_threaded_fleet_under_the_sanitizer_keeps_the_committed_order(
        model):
    """Two replicas stepping on their own threads behind a router, with a
    reader polling health, all built and run under ``sanitize()``: no
    double-acquire, the nested edge observed, every observed edge
    between ordered locks blessed by the committed manifest, and the
    tokens of an unthreaded run."""
    prompts = _prompts(8)
    want = _engine(model).generate_many(prompts, 6)
    with conc.sanitize(register_metrics=False) as mon:
        reps = [fleet.LocalReplica(_engine(model), name=f"th{i}")
                for i in range(2)]
        router = fleet.FleetRouter(reps, registry=obs.MetricsRegistry(),
                                   tracer=obs.Tracer(enabled=False))
        for rep in reps:
            rep.start()
        stop, polls = threading.Event(), []

        def reader():
            while not stop.is_set():
                polls.append(reps[0].health())
                time.sleep(0.001)
        poller = threading.Thread(target=reader)
        poller.start()
        try:
            where = [router.submit(p, 6) for p in prompts]
            got, deadline = {}, time.monotonic() + 120
            while len(got) < len(where) and time.monotonic() < deadline:
                for frid in where:
                    if frid not in got:
                        rep, lrid = router._where[frid][:2]
                        toks = rep.result(lrid)
                        if toks is not None:
                            got[frid] = toks
                time.sleep(0.002)
        finally:
            stop.set()
            poller.join(timeout=10)
            for rep in reps:
                rep.stop()
    assert not poller.is_alive()
    assert len(got) == len(where) and polls
    for frid, w in zip(where, want):
        np.testing.assert_array_equal(got[frid], w)
    assert not mon.double_acquires
    assert ("LocalReplica._lock", "ServingEngine._health_lock") in \
        mon.observed_edges()
    assert mon.check(conc.load_lock_order(conc.LOCK_ORDER_PATH)) == []


# ---------------------------------------------------------------------------
# conformance


def test_interfaces_and_reject_vocabulary_are_clean_on_the_port():
    assert conformance.lint_interfaces() == []
    assert conformance.lint_reject_vocab() == []
    assert REJECT_REASONS == ref_scheduler.REJECT_REASONS


def test_reject_vocab_fires_on_an_unregistered_and_a_dead_reason(tmp_path):
    (tmp_path / "shed.py").write_text(
        "from paddle_tpu_torch.serving.scheduler import Reject\n"
        "def f(n):\n"
        "    return Reject('queue_full', 'default', n, 0.0, 0.1) "
        "if n else Reject('made_up', 'default', n, 0.0, 0.1)\n")
    out = conformance.lint_reject_vocab(str(tmp_path))
    made_up = [f for f in out if "'made_up'" in f.message]
    assert [f.rule for f in made_up] == ["reject-vocab-drift"]
    dead = {f.message.split("'")[1] for f in out
            if "constructed nowhere" in f.message}
    assert dead == set(REJECT_REASONS) - {"queue_full"}


def test_dispatch_ops_are_read_from_the_server_source():
    import inspect
    from paddle_tpu_torch.serving.fleet.net import replica_server
    ops, hello = conformance._dispatch_ops(
        inspect.getsource(replica_server), "replica_server.py")
    assert {"hello", "submit", "step", "shutdown"} <= ops
    assert "page_size" in hello


# ---------------------------------------------------------------------------
# make_net_serving_fleet


class _Server:
    """A replica server of the port served from a plain thread."""

    def __init__(self, engine):
        self.srv = net.ReplicaServer(engine)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self.srv.serve_step(0.02)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        self.srv.close()


def _drive(router, prompts, new):
    frids = [router.submit(p, new) for p in prompts]
    done = router.run_until_idle(max_steps=100_000)
    return [done[f] for f in frids]


def test_net_serving_fleet_tokens_equal_the_in_process_fleet(model):
    prompts = _prompts(10, seed=3)
    want = _drive(make_serving_fleet(model, num_replicas=2, device="cpu",
                                     warmup=False, **GEOM), prompts, 8)
    servers = [_Server(_engine(model)) for _ in range(2)]
    try:
        router = make_net_serving_fleet(
            [s.srv.address for s in servers],
            registry=obs.MetricsRegistry(), call_timeout_s=60.0)
        assert [type(r).__name__ for r in router.replicas] == \
            ["NetReplica", "NetReplica"]
        got = _drive(router, prompts, 8)
        served = {r.name: r.calls_total for r in router.replicas}
        for rep in router.replicas:
            rep.close()
    finally:
        for s in servers:
            s.stop()
    assert all(n > 0 for n in served.values()), served
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
