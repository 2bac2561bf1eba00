"""The port's tools (``paddle_tpu_torch.{testing,debug,profiler,version}``,
``observability.report``) against the JAX package's on the same numpy
inputs from seeds:

- ``testing``: ``check_output`` and ``check_grad`` pass and fail where
  the reference's do (a right and a wrong gradient), ``numeric_grad`` is
  the reference's function (equal arrays), ``assert_trees_close``,
  ``subprocess_env``;
- ``debug``: the NaN trap raises ``FloatingPointError`` where the
  reference's does and not elsewhere; ``check_numerics`` and
  ``checked``; ``finite_or_zero``; ``op_frequency`` of elementwise
  programs equals the reference's primitive counts; ``print_program``,
  ``program_to_dot`` and ``estimate_memory``'s byte counts;
- ``profiler``: the host table of ``record_event`` regions, its summary
  and its Chrome trace (the reference's event fields), the
  ``torch.profiler`` trace written by ``profiler(output_dir)`` holding
  the region, ``step_marker``;
- ``observability.report``: the reference's section lines for the same
  counters, gauges, histograms and spans.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import debug as jdebug
from paddle_tpu import profiler as jprofiler
from paddle_tpu import testing as jtesting
from paddle_tpu import version as jversion
from paddle_tpu import observability as jobs
from paddle_tpu.observability import registry as jregistry
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu.observability.report import report as jreport
from paddle_tpu_torch import debug, profiler, testing, version
from paddle_tpu_torch.observability import registry, tracing
from paddle_tpu_torch.observability.report import observe_span, report

torch.set_num_threads(2)


def _x(shape=(3, 4), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_check_output_and_grad_agree_with_the_reference():
    x, y = _x(), _x(seed=1)
    testing.check_output(lambda a, b: torch.tanh(a) * b,
                         lambda a, b: np.tanh(a) * b, [x, y])
    jtesting.check_output(lambda a, b: jnp.tanh(a) * b,
                          lambda a, b: np.tanh(a) * b, [x, y])
    testing.check_grad(lambda a, b: torch.tanh(a) * b, [x, y], wrt=(0, 1))
    jtesting.check_grad(lambda a, b: jnp.tanh(a) * b, [x, y], wrt=(0, 1))

    class Wrong(torch.autograd.Function):        # a wrong backward
        @staticmethod
        def forward(ctx, a):
            return torch.sin(a)

        @staticmethod
        def backward(ctx, g):
            return g

    with pytest.raises(AssertionError, match="grad mismatch"):
        testing.check_grad(lambda a: Wrong.apply(a), [x])
    with pytest.raises(AssertionError):
        testing.check_output(lambda a: a + 1e-3, lambda a: a, [x])
    f = lambda a: np.sin(a) * 2
    np.testing.assert_array_equal(testing.numeric_grad(f, [x]),
                                  jtesting.numeric_grad(f, [x]))
    testing.assert_trees_close({"a": [torch.ones(2)]}, {"a": [np.ones(2)]})
    env = testing.subprocess_env()
    assert env["PYTHONPATH"].split(":")[0] == \
        jtesting.subprocess_env()["PYTHONPATH"].split(":")[0]
    assert version.__version__.count(".") == jversion.__version__.count(".")


def test_nan_trap_raises_where_the_reference_does():
    x = _x()
    with debug.nan_checks():
        torch.tanh(torch.from_numpy(x))             # clean
        with pytest.raises(FloatingPointError, match="nan"):
            torch.log(torch.from_numpy(x))         # log of negatives
        with debug.nan_checks(False):
            assert torch.isnan(torch.log(torch.from_numpy(x))).any()
    with jdebug.nan_checks():
        with pytest.raises(FloatingPointError):
            jax.jit(jnp.log)(jnp.asarray(x)).block_until_ready()
    assert torch.isnan(torch.log(torch.from_numpy(x))).any()   # trap off
    debug.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError):
            torch.sqrt(torch.from_numpy(x))
    finally:
        debug.enable_nan_checks(False)
    torch.sqrt(torch.from_numpy(x))


def test_check_numerics_and_checked():
    good = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    assert debug.check_numerics(good) is good
    bad = {"a": torch.tensor([1.0, float("inf")])}
    with pytest.raises(FloatingPointError, match=r"grads\['a'\]"):
        debug.check_numerics(bad, "grads")
    err, out = debug.checked(lambda t: debug.check_numerics(t, "x") * 2)(
        torch.tensor([1.0, float("nan")]))
    assert err.get() == "non-finite values in x"
    with pytest.raises(FloatingPointError):
        err.throw()
    err, _ = debug.checked(lambda t: debug.check_numerics(t))(torch.ones(2))
    assert err.get() is None
    err.throw()
    x = np.array([1.0, np.inf, -np.nan, 2.0], np.float32)
    np.testing.assert_array_equal(
        debug.finite_or_zero(torch.from_numpy(x)).numpy(),
        np.asarray(jdebug.finite_or_zero(jnp.asarray(x))))


PROGRAMS = [
    (lambda a, b: torch.sin(a) + torch.sin(a) * b,
     lambda a, b: jnp.sin(a) + jnp.sin(a) * b),
    (lambda a, b: torch.exp(a - b) * torch.exp(b) - a,
     lambda a, b: jnp.exp(a - b) * jnp.exp(b) - a),
]


@pytest.mark.parametrize("i", range(len(PROGRAMS)))
def test_op_frequency_counts_the_reference_primitives(i):
    port, ref = PROGRAMS[i]
    x, y = _x(), _x(seed=1)
    got = debug.op_frequency(port, torch.from_numpy(x), torch.from_numpy(y))
    want = jdebug.op_frequency(ref, x, y)
    assert got == want


def test_program_text_dot_and_memory():
    x = torch.from_numpy(_x((64, 32)))
    w = torch.from_numpy(_x((32, 16), seed=2))
    fn = lambda a, b: torch.relu(a @ b).sum(0)
    text = debug.print_program(fn, x, w)
    assert "aten.mm" in text and "aten.relu" in text
    assert "aten.relu" in debug.print_program(fn, x, w, stage="export")
    with pytest.raises(ValueError):
        debug.print_program(fn, x, w, stage="hlo")
    dot = debug.program_to_dot(fn, x, w)
    assert dot.startswith("digraph program {") and "op0 -> op1;" in dot
    assert "more ops" in debug.program_to_dot(fn, x, w, max_nodes=1)
    mem = debug.estimate_memory(fn, x, w)
    assert mem["argument_bytes"] == (64 * 32 + 32 * 16) * 4
    assert mem["output_bytes"] == 16 * 4
    assert mem["temp_bytes"] == 2 * 64 * 16 * 4     # mm and relu live
    assert mem["total_bytes"] == sum(mem[k] for k in (
        "argument_bytes", "output_bytes", "temp_bytes"))


def _regions(prof_mod, n=3):
    for i in range(n):
        with prof_mod.record_event("step"):
            with prof_mod.record_event("inner"):
                pass
        with prof_mod.step_marker(i):
            pass


def test_profiler_tables_and_traces(tmp_path, capsys):
    with profiler.profile_to_chrome_trace(str(tmp_path / "port.json")):
        _regions(profiler)
    with jprofiler.profile_to_chrome_trace(str(tmp_path / "ref.json")):
        _regions(jprofiler)
    port = json.loads((tmp_path / "port.json").read_text())["traceEvents"]
    ref = json.loads((tmp_path / "ref.json").read_text())["traceEvents"]
    assert [e["name"] for e in port] == [e["name"] for e in ref]
    assert [sorted(e) for e in port] == [sorted(e) for e in ref]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in port)
    with profiler.profiler(str(tmp_path / "dev")) as prof:
        _regions(profiler)
    table = capsys.readouterr().out
    assert table.splitlines()[0].split() == \
        ["Event", "Calls", "Total(s)", "Avg(ms)", "Ratio"]
    assert [ln.split()[:2] for ln in table.splitlines()[1:]] in (
        [["step", "3"], ["inner", "3"]], [["inner", "3"], ["step", "3"]])
    names = {e.get("name") for e in json.loads(
        (tmp_path / "dev" / profiler.TRACE_FILE).read_text())["traceEvents"]}
    assert {"step", "inner", "ProfilerStep#2"} <= names
    assert prof is not None and profiler.trace_kernel_names(
        str(tmp_path / "dev" / profiler.TRACE_FILE)) == []   # the CPU
    with profiler.profiler(summary=False) as none:
        assert none is None


def _feed(reg_mod, tracing_mod, observe):
    reg = reg_mod.MetricsRegistry()
    reg.counter("requests_total", "requests").inc(3, route="a")
    reg.gauge("queue_depth").set(7)
    h = reg.histogram("latency_seconds", "latency")
    for v in (0.1, 0.2, 0.4):
        h.observe(v)
    tr = tracing_mod.Tracer(capacity=8)
    for _ in range(3):
        tr.record_span("decode", duration_s=0.5)
    observe("record_me", 0.25, reg=reg)
    return reg, tr


def test_report_lines_equal_the_reference():
    reg, tr = _feed(registry, tracing, observe_span)
    jreg, jtr = _feed(jregistry, jtracing, jobs.observe_span)
    got = report(reg, tr).splitlines()
    want = jreport(jreg, jtr).splitlines()
    assert got[0] == "== paddle_tpu_torch observability report =="
    assert got[1:] == want[1:]
    empty = report(registry.MetricsRegistry(), tracing.Tracer())
    assert empty.splitlines()[1] == "(no metrics recorded)"
