"""The port's telemetry file tier held against the JAX package's on the
CPU: one sequence of counter, gauge and histogram operations with labels
goes into both registries, and the Prometheus text, the snapshots,
``percentiles``, ``count_over`` and ``count_le`` agree; span JSONL,
anatomy JSONL and postmortem bundles written by either package pass the
other's validators, and corrupt copies fail both; ``chrome_trace_from_jsonl``
of one file gives the same JSON in both; and the port's two tools
(``python -m paddle_tpu_torch.tools.check_metrics_log`` and
``.postmortem``) exit 0 on a good file and 1 on a corrupt one in every
mode, as the reference's ``tools/`` scripts do on the same files."""

import importlib.util
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from paddle_tpu import observability as jax_obs
from paddle_tpu.observability import anatomy as jax_anatomy
from paddle_tpu.observability import flight as jax_flight
from paddle_tpu.observability import registry as jax_registry
from paddle_tpu.observability import tracing as jax_tracing
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import anatomy, flight, registry, tracing
from paddle_tpu_torch.serving.fleet.net import frontdoor
from paddle_tpu_torch.tools import check_metrics_log, postmortem

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {"jax": (jax_obs, jax_registry, jax_tracing, jax_anatomy,
                jax_flight),
        "port": (obs, registry, tracing, anatomy, flight)}
BUCKETS = (0.001, 0.01, 0.05, 0.1, 0.5, 1.0)


def _ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_CHECK = _ref_tool("check_metrics_log")
REF_POSTMORTEM = _ref_tool("postmortem")


def _drive(reg_mod):
    """One seeded sequence of metric operations into a fresh registry."""
    rng = np.random.default_rng(0)
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("req_total", "requests served")
    g = reg.gauge("queue_depth", "queued requests")
    h = reg.histogram("ttft_seconds", "time to first token",
                      buckets=BUCKETS)
    bound = h.child(route="b")
    for i in range(200):
        route = "ab"[i % 2]
        c.inc(1 + i % 3, route=route, code="200" if i % 7 else "503")
        g.set(float(rng.integers(0, 16)), replica=f"r{i % 3}")
        g.inc(0.5, replica="r0")
        v = float(rng.lognormal(-3.0, 1.2))
        if route == "a":
            h.observe(v, route="a")
        else:
            bound.observe(v)
    reg.gauge("doomed").set(3.0)
    reg.unregister("doomed")
    return reg, h


def test_registries_render_and_read_back_the_same_numbers():
    jreg, jh = _drive(jax_registry)
    preg, ph = _drive(registry)
    assert obs.render_prometheus(preg) == jax_obs.render_prometheus(jreg)
    assert obs.snapshot(preg) == jax_obs.snapshot(jreg)
    assert "doomed" not in obs.render_prometheus(preg)
    for route in "ab":
        want = jh.percentiles(0.5, 0.9, 0.99, route=route)
        got = ph.percentiles(0.5, 0.9, 0.99, route=route)
        assert set(got) == set(want) == {"p50", "p90", "p99"}
        for k in want:
            assert math.isclose(got[k], want[k], rel_tol=0, abs_tol=1e-12)
        assert got["p50"] == ph.quantile(0.5, route=route)
        for v in (0.0, 0.003, 0.01, 0.07, 0.5, 2.0, 1e3):
            assert math.isclose(ph.count_le(v, route=route),
                                jh.count_le(v, route=route),
                                rel_tol=0, abs_tol=1e-12)
            assert ph.count_over(v, route=route) == \
                jh.count_over(v, route=route) == \
                ph.count_and_over(v, route=route)[1]


def test_module_level_metrics_land_in_the_default_registry():
    name = "telemetry_files_module_level_total"
    try:
        registry.counter(name).inc(2)
        registry.gauge(name + "_g").inc(1.5)
        registry.histogram(name + "_h", buckets=(1.0,)).observe(0.5)
        snap = obs.snapshot()
        assert snap[name] == 2.0 and snap[name + "_g"] == 1.5
        assert snap[name + "_h_count"] == 1
        assert f"{name} 2" in obs.render_prometheus()
    finally:
        for n in (name, name + "_g", name + "_h"):
            registry.default().unregister(n)
    assert name not in obs.snapshot()


# -- files written by one package, read by the other ----------------------

def _trace_file(pkg, path):
    _, _, trc, _, _ = PKGS[pkg]
    tr = trc.Tracer(capacity=64)
    with tr.span("request", rid=1):
        with tr.span("prefill", tokens=7) as sp:
            sp.add_event("admitted", slot=0)
        with tr.span("decode", tokens=3):
            pass
    h = tr.start_span("router.handoff", src="r0", dst="r1")
    h.finish()
    assert tr.export_jsonl(path) == 4
    return tr


def _anatomy_file(pkg, path):
    _, _, trc, ana, _ = PKGS[pkg]
    a = ana.StepAnatomy(tracer=trc.Tracer(enabled=False))
    for i in range(3):
        a.begin_step(i + 1)
        t = a.now()
        sum(range(1000))
        a.add_phase("decode", t, a.now())
        a.end_step(tokens=2)
    assert a.export_jsonl(path) == 3
    return a


def _bundle_file(pkg, path):
    _, reg, trc, ana, fl = PKGS[pkg]
    tr = trc.Tracer(capacity=16)
    a = ana.StepAnatomy(registry=reg.MetricsRegistry(), tracer=tr)
    a.begin_step(1)
    a.end_step(tokens=1)
    with tr.span("decode"):
        pass
    rec = fl.FlightRecorder("r0", anatomy=a, registry=reg.MetricsRegistry(),
                            tracer=tr, snapshot_every=1)
    rec.note({"queue_depth": 2, "headroom": {"slots": 0.5}})
    b = rec.dump("eject", trace_ids=[3, 7], extra={"cause": "test"})
    fl.write_bundle(b, path)
    return b


def _corrupt_last_record(path, edit):
    lines = pathlib.Path(path).read_text().splitlines()
    rec = json.loads(lines[-1])
    edit(rec)
    lines[-1] = json.dumps(rec)
    pathlib.Path(path).write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_span_jsonl_validates_in_both_packages(writer, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    _trace_file(writer, path)
    assert tracing.validate_trace_log(path, require_spans=4) == 4
    assert jax_tracing.validate_trace_log(path, require_spans=4) == 4
    for trc in (tracing, jax_tracing):
        with pytest.raises(ValueError, match="< required"):
            trc.validate_trace_log(path, require_spans=5)
    bad = str(tmp_path / "bad.jsonl")
    shutil.copy(path, bad)
    _corrupt_last_record(bad, lambda r: r.update(dur_s=-1.0))
    for trc in (tracing, jax_tracing):
        with pytest.raises(ValueError, match="negative dur_s"):
            trc.validate_trace_log(bad)
    for rec in (dict(kind="span", trace_id=1, span_id=2, parent_id=2,
                     name="x", ts=0.0, dur_s=0.0),
                dict(kind="span", trace_id=1, span_id=2, parent_id=0,
                     name="router.handoff", ts=0.0, dur_s=0.0,
                     attrs={"src": "r0"}),
                dict(kind="nope")):
        msgs = []
        for trc in (tracing, jax_tracing):
            with pytest.raises(ValueError) as e:
                trc.validate_trace_record(rec, index=3)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_chrome_trace_from_jsonl_is_the_same_json(writer, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    _trace_file(writer, path)
    outs = []
    for name, trc in (("port", tracing), ("jax", jax_tracing)):
        out = str(tmp_path / f"{name}.chrome.json")
        assert trc.chrome_trace_from_jsonl(path, out) == out
        outs.append(json.loads(pathlib.Path(out).read_text()))
    assert outs[0] == outs[1]
    assert tracing.chrome_trace_valid(outs[0], require_events=5) == 5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_anatomy_jsonl_validates_in_both_packages(writer, tmp_path):
    path = str(tmp_path / "anatomy.jsonl")
    _anatomy_file(writer, path)
    for ana in (anatomy, jax_anatomy):
        assert ana.validate_anatomy_log(path, require_steps=3) == 3
        with pytest.raises(ValueError, match="< required"):
            ana.validate_anatomy_log(path, require_steps=4)
    for edit, msg in ((lambda r: r.update(step=1), "not monotonic"),
                      (lambda r: r.update(phases={"decode": 1e3}),
                       "exceeds wall")):
        bad = str(tmp_path / "bad.jsonl")
        shutil.copy(path, bad)
        _corrupt_last_record(bad, edit)
        for ana in (anatomy, jax_anatomy):
            with pytest.raises(ValueError, match=msg):
                ana.validate_anatomy_log(bad)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_postmortem_bundle_validates_in_both_packages(writer, tmp_path):
    path = str(tmp_path / "pm.json")
    b = _bundle_file(writer, path)
    for fl in (flight, jax_flight):
        got = fl.validate_postmortem_file(path)
        assert got["trace_ids"] == [3, 7] and got["reason"] == "eject"
        assert fl.read_bundle(path) == json.loads(json.dumps(b))
    bad = str(tmp_path / "bad.json")
    flight.write_bundle(dict(b, trace_ids=[-1]), bad)
    for fl in (flight, jax_flight):
        with pytest.raises(ValueError, match="trace_ids"):
            fl.validate_postmortem_file(bad)


# -- the two tools --------------------------------------------------------

def _good_and_bad(mode, tmp_path):
    """(good file, corrupt copy, extra args) for one log mode."""
    good = str(tmp_path / f"{mode}.good")
    bad = str(tmp_path / f"{mode}.bad")
    if mode == "run":
        with obs.RunLogWriter(good, meta={"run": "t"}) as w:
            for i in range(3):
                w.write({"step": i, "step_time_s": 0.01, "examples_per_sec": 400.0,
                         "loss": 1.0 / (i + 1)})
        shutil.copy(good, bad)
        _corrupt_last_record(bad, lambda r: r.update(step=-1))
        return good, bad, ["--require-steps", "3"]
    if mode == "trace":
        _trace_file("port", good)
        shutil.copy(good, bad)
        _corrupt_last_record(bad, lambda r: r.pop("span_id"))
        return good, bad, ["--trace", "--require-spans", "4"]
    if mode == "anatomy":
        _anatomy_file("port", good)
        shutil.copy(good, bad)
        _corrupt_last_record(bad, lambda r: r.update(step=0))
        return good, bad, ["--anatomy", "--require-steps", "3"]
    if mode == "postmortem":
        b = _bundle_file("port", good)
        flight.write_bundle(dict(b, reason=""), bad)
        return good, bad, ["--postmortem"]
    # netlog: the reference's committed front-door log, and a copy whose
    # last terminal record is gone (an accepted request left dangling)
    shutil.copy(ROOT / "BENCH_NET.netlog.jsonl", good)
    lines = pathlib.Path(good).read_text().splitlines()
    last = max(i for i, ln in enumerate(lines)
               if json.loads(ln)["event"] in frontdoor.NETLOG_TERMINALS)
    pathlib.Path(bad).write_text(
        "\n".join(lines[:last] + lines[last + 1:]) + "\n")
    return good, bad, ["--netlog", "--require-requests", "1"]


@pytest.mark.parametrize("mode", ["run", "trace", "anatomy", "postmortem",
                                  "netlog"])
def test_check_metrics_log_modes_exit_as_the_reference(mode, tmp_path,
                                                       capsys):
    good, bad, args = _good_and_bad(mode, tmp_path)
    for main in (check_metrics_log.main, REF_CHECK.main):
        assert main([good] + args) == 0
        assert main([bad] + args) == 1
    out = capsys.readouterr()
    port_ok, ref_ok = [ln for ln in out.out.splitlines()
                       if ln.startswith("check_metrics_log: OK")]
    assert port_ok == ref_ok
    port_fail, ref_fail = [ln for ln in out.err.splitlines()
                           if ln.startswith("check_metrics_log: FAIL")]
    assert port_fail == ref_fail


def test_check_metrics_log_refuses_mixed_modes(tmp_path):
    good, _, _ = _good_and_bad("postmortem", tmp_path)
    for argv in ([good, "--postmortem", "--anatomy"],
                 [good, "--postmortem", "--require-steps", "1"],
                 [good, "--require-spans", "1"],
                 [good, "--trace", "--require-steps", "1"],
                 [good, "--require-requests", "1"]):
        with pytest.raises(SystemExit):
            check_metrics_log.main(argv)


def test_postmortem_renders_as_the_reference(tmp_path, capsys):
    path = str(tmp_path / "pm.json")
    _bundle_file("port", path)
    outs = {}
    for name, main in (("port", postmortem.main),
                       ("jax", REF_POSTMORTEM.main)):
        trace_out = str(tmp_path / f"{name}.trace.out")
        assert main([path, "--trace-out", trace_out]) == 0
        outs[name] = capsys.readouterr().out.replace(trace_out, "T")
        chrome = json.loads(pathlib.Path(trace_out).read_text())
        assert tracing.chrome_trace_valid(chrome, require_events=1) >= 1
    assert outs["port"] == outs["jax"]
    assert "reason=eject" in outs["port"] and "trace ids [3, 7]" in \
        outs["port"]
    # a directory of the reference's own bundles, then one corrupt bundle
    pm_dir = str(ROOT / "BENCH_ROUTER.postmortems")
    assert postmortem.main([pm_dir, "--tail", "2"]) == 0
    assert REF_POSTMORTEM.main([pm_dir, "--tail", "2"]) == 0
    dump = tmp_path / "dump"
    dump.mkdir()
    flight.write_bundle(dict(flight.read_bundle(path), schema="nope"),
                        str(dump / "postmortem_0001.json"))
    assert postmortem.main([str(dump)]) == 1
    assert REF_POSTMORTEM.main([str(dump)]) == 1
    assert postmortem.main([str(tmp_path / "empty_dir_missing")]) == 1
    with pytest.raises(SystemExit):
        postmortem.main([pm_dir, "--trace-out", str(tmp_path / "x")])


def test_tools_run_as_modules(tmp_path):
    good, bad, args = _good_and_bad("anatomy", tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for path, rc in ((good, 0), (bad, 1)):
        p = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.check_metrics_log",
             path] + args, cwd=str(tmp_path), env=env, capture_output=True,
            text=True, timeout=120)
        assert p.returncode == rc, p.stderr
    pm, _, _ = _good_and_bad("postmortem", tmp_path)
    p = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.postmortem", pm],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert p.returncode == 0 and "bundle(s) validated" in p.stdout, p.stderr
