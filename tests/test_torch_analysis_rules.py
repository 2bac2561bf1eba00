"""The port's AST and graph tiers (``paddle_tpu_torch.analysis``):
the AST tier against the reference's on shared framework-neutral step
sources (the same (rule, severity, line) set), the torch idioms it adds,
and every graph rule on one program where it fires and one where it
stays silent -- the ports of the reference's ``TestHostCallbackRule`` ..
``TestRematRecursion`` cases, ``torch.utils.checkpoint`` included."""

import textwrap

import numpy as np
import pytest
import torch
from torch.utils import checkpoint

from paddle_tpu.analysis import ast_lint as ref_ast
from paddle_tpu_torch.analysis import api, ast_lint, fx_lint, lint_fn
from paddle_tpu_torch.parallel import plan as plan_lib


def _rules(report):
    return sorted({f.rule for f in report})


def _lint(fn, *args, **kw):
    kw.setdefault("registry", False)
    kw.setdefault("ast", False)
    return lint_fn(fn, *args, **kw)


# ---------------------------------------------------------------------------
# AST tier: parity with the reference on shared sources
# ---------------------------------------------------------------------------

SHARED_SOURCES = {
    "reference_bad_step": '''
        def step(state, x):
            import random
            import time
            y = x * 2
            if y.sum() > 0:
                y = y + 1
            while y.mean() < 1:
                y = y + 1
            v = y.item()
            a = np.asarray(y)
            t = time.time()
            r = random.random()
            f = float(y[0])
            return state, {"v": v, "a": a, "t": t, "r": r, "f": f}
        ''',
    "reference_clean_step": '''
        def step(state, x, training=False, key=None):
            if training:
                x = x * 2
            if key is None:
                x = x + 1
            y = where(x > 0, x, 0.0)
            return state, {"y": y.sum()}
        ''',
    "tolist_and_int": '''
        def step(state, x, steps=3):
            ids = x.argmax(-1).tolist()
            n = int(x.shape[0] + x.sum())
            for _ in range(steps):
                x = x + 1
            return state, {"ids": ids, "n": n}
        ''',
    "for_loop_propagation": '''
        def step(state, rows):
            out = 0
            for row in rows:
                if row.max() > 0:
                    out = out + row
            return state, out
        ''',
    "augassign_propagation": '''
        def step(state, x, scale=1.0):
            acc = 0.0
            acc += x.mean()
            if scale > 1:
                acc = acc * scale
            while acc > 10:
                acc = acc / 2
            return state, acc
        ''',
    "kwonly_and_static_defaults": '''
        def step(state, *, x, mode="train", weight=None, clip=5.0):
            if mode == "train":
                x = x * 2
            if weight is not None:
                x = x * weight
            if x.any():
                x = x.clamp(-clip, clip)
            return state, bool(x.all())
        ''',
    "varargs_and_kwargs": '''
        def step(*xs, **feeds):
            while xs[0].sum() > 0:
                break
            v = feeds["a"].item()
            return xs, v
        ''',
    "timers_random_and_sync": '''
        def step(state, x):
            import random
            import time
            t0 = time.perf_counter()
            k = random.choice([1, 2])
            y = (x * k).block_until_ready()
            t1 = time.monotonic()
            return state, {"y": y, "dt": t1 - t0}
        ''',
    "numpy_module_spellings": '''
        def step(state, x):
            a = numpy.array([1, 2, 3])
            b = np.copy(a)
            c = np.zeros(3)
            if x is not None:
                x = x + c.sum()
            if x == None:
                return state, None
            return state, {"x": x, "b": b}
        ''',
    "nested_defs_first_wins": '''
        def outer(state, x):
            def inner(y):
                return y.item()
            if x.sum() > 0:
                x = -x
            return state, inner(x)
        ''',
}


def _triples(findings):
    return sorted((f.rule, f.severity, f.location.rsplit(":", 1)[-1])
                  for f in findings)


@pytest.mark.parametrize("name", sorted(SHARED_SOURCES))
def test_ast_tier_equals_the_reference_on_shared_sources(name):
    """Exact: the same (rule, severity, line) set, line offsets kept."""
    src = textwrap.dedent(SHARED_SOURCES[name])
    want = ref_ast.lint_source(src, filename="s.py", line_offset=7)
    got = ast_lint.lint_source(src, filename="s.py", line_offset=7)
    assert _triples(got) == _triples(want)
    if name != "reference_clean_step":
        assert got, name


def test_ast_reference_bad_step_counts():
    src = textwrap.dedent(SHARED_SOURCES["reference_bad_step"])
    got = ast_lint.lint_source(src)
    assert sum(f.rule == "ast-tracer-branch" for f in got) == 2
    assert sum(f.rule == "ast-host-sync" for f in got) == 5


def _torch_sync_step(state, x, device="cuda"):
    y = x.cpu()
    z = x.numpy()
    w = x.to("cpu")
    u = x.to(device=torch.device("cpu"))
    torch.cuda.synchronize()
    ok = x.to(device)                      # a device, not the host
    return state, (y, z, w, u, ok)


def _torch_clean_step(state, x, device="cuda"):
    y = torch.where(x > 0, x, torch.zeros_like(x))
    return state, y.to(device)


def test_ast_torch_host_syncs():
    got = ast_lint.lint_callable(_torch_sync_step)
    assert [f.rule for f in got] == ["ast-host-sync"] * 5
    assert all("test_torch_analysis_rules.py" in f.location for f in got)
    assert ast_lint.lint_callable(_torch_clean_step) == []
    assert ast_lint.lint_callable(torch.sum) == []


def test_ast_branch_message_names_graph_capture():
    f, = ast_lint.lint_source("def s(x):\n    if x.sum() > 0:\n"
                              "        x = x + 1\n    return x\n")
    assert f.rule == "ast-tracer-branch" and f.severity == "error"
    assert "CUDA-graphed" in f.message and "frozen" in f.message


# ---------------------------------------------------------------------------
# graph tier: one firing and one silent program per rule
# ---------------------------------------------------------------------------

X = torch.ones(4, 8)


class TestHostCallback:
    def test_item_fires(self):
        def step(x):
            s = x.sum().item()
            return x * (1.0 + 0.0 * s)
        rep = _lint(step, X)
        assert _rules(rep) == ["host-callback"]
        assert rep.errors and "_local_scalar_dense" in rep.findings[0].location

    def test_data_dependent_shapes_fire(self):
        def nz(x):
            return torch.nonzero(x > 0).float().sum()

        def masked(x):
            return x[x > 0].sum()
        for fn in (nz, masked):
            assert _rules(_lint(fn, X)) == ["host-callback"], fn.__name__

    def test_decision_on_a_device_value_stops_the_trace(self):
        def step(x):
            if x.sum().item() > 0:
                return x + 1
            return x
        rep = _lint(step, X, cost=True)
        assert _rules(rep) == ["host-callback"] and rep.cost is None
        assert "stopped" in rep.findings[0].message

    def test_silent_on_device_step(self):
        def step(x):
            return torch.where(x > 0, x, 0.0).sum()
        assert _rules(_lint(step, X)) == []


class TestDebugCallback:
    def test_assert_fires_as_warning(self):
        def step(x):
            torch._assert_async((x > -1).all())
            return x * 2
        rep = _lint(step, X)
        assert _rules(rep) == ["debug-callback"]
        assert not rep.errors and rep.warnings

    def test_silent(self):
        assert _rules(_lint(lambda x: x * 2, X)) == []


class TestF64:
    def test_fires(self):
        def step(x):
            return (x.double() * np.float64(2.0)).float()
        rep = _lint(step, X)
        assert _rules(rep) == ["f64-promotion"]
        assert rep.findings[0].severity == "warning"

    def test_silent_on_f32(self):
        assert _rules(_lint(lambda x: x * 2.0, X)) == []


class TestUndonatedBuffer:
    S = torch.zeros(512, 512)

    def test_fires_on_a_new_state_tensor(self):
        def step(s, x):
            return s + x.sum()
        rep = _lint(step, self.S, X)
        assert _rules(rep) == ["undonated-buffer"]
        assert "args[0]" in rep.findings[0].message

    def test_silent_when_written_in_place(self):
        def step(s, x):
            s.add_(x.sum())
            return s
        assert _rules(_lint(step, self.S, X)) == []

    def test_silent_without_state(self):
        def step(s, x):
            return s + x.sum()
        assert _rules(_lint(step, self.S, X, state_argnum=None)) == []

    def test_small_buffers_ignored(self):
        def step(s, x):
            return s + x.sum()
        assert _rules(_lint(step, torch.zeros(8, 8), X)) == []

    def test_train_state_updated_in_place_is_silent(self):
        from paddle_tpu_torch.optimizer import Adam
        from paddle_tpu_torch.train import build_train_step, make_train_state
        model = torch.nn.Linear(256, 256)
        opt = Adam(model.parameters(), learning_rate=1e-3)
        step = build_train_step(lambda m, x: m(x).square().mean(), opt)
        rep = api.lint_train_step(step, make_train_state(model, opt),
                                  {"x": torch.ones(4, 256)}, registry=False)
        assert _rules(rep) == []


class TestGeneratorReuse:
    def test_generator_created_in_the_body_fires(self):
        def step(x):
            g = torch.Generator().manual_seed(0)
            return x * torch.rand(x.shape, generator=g)
        rep = _lint(step, X)
        assert _rules(rep) == ["prng-key-reuse"]
        assert "creates inside its body" in rep.findings[0].message

    def test_reseeding_the_default_generator_fires_and_is_undone(self):
        torch.manual_seed(1234)
        state = torch.get_rng_state()

        def step(x):
            torch.manual_seed(0)
            return torch.nn.functional.dropout(x, 0.5)
        rep = _lint(step, X)
        assert _rules(rep) == ["prng-key-reuse"]
        assert "re-seeds" in rep.findings[0].message
        assert torch.initial_seed() == 1234
        assert torch.equal(torch.get_rng_state(), state)

    def test_held_and_default_generators_are_silent(self):
        g = torch.Generator().manual_seed(3)

        def held(x, gen):
            return x * torch.rand(x.shape, generator=gen)

        def default(x):
            return torch.nn.functional.dropout(x, 0.5)
        assert _rules(_lint(held, X, g)) == []
        assert _rules(_lint(default, X)) == []

    def test_convgroup_dropout_surface_is_clean(self):
        from paddle_tpu_torch.analysis import graph_lint
        assert _rules(graph_lint.lint_convgroup(None)) == []


class TestReplicatedLarge:
    def _state(self):
        model = torch.nn.Sequential(torch.nn.Linear(1024, 512),
                                    torch.nn.Linear(512, 8))
        from paddle_tpu_torch.optimizer import SGD
        from paddle_tpu_torch.train import make_train_state
        return make_train_state(model, SGD(model.parameters(), 0.1))

    def test_fires_under_a_replicated_plan(self):
        st = self._state()
        rep = _lint(lambda s: s["step"] + 1, st,
                    plan=plan_lib.replicated_plan(), state_argnum=0)
        assert _rules(rep) == ["replicated-large"]
        assert "0/weight" in rep.findings[0].location

    def test_silent_under_fsdp_and_without_plan(self):
        st = self._state()
        assert _rules(_lint(lambda s: s["step"] + 1, st,
                            plan=plan_lib.fsdp_plan())) == []
        assert _rules(_lint(lambda s: s["step"] + 1, st)) == []


class TestRecursion:
    """Rules see inside ``torch.utils.checkpoint`` (traced inline, its
    recompute included) and inside higher-order subgraphs."""

    def test_host_read_inside_checkpoint_fires(self):
        def inner(x):
            return x * x.sum().item()
        rep = _lint(lambda x: checkpoint.checkpoint(
            inner, x, use_reentrant=False).sum(), X.requires_grad_())
        assert "host-callback" in _rules(rep)

    def test_generator_inside_checkpoint_fires(self):
        def inner(x):
            g = torch.Generator().manual_seed(0)
            return x * torch.rand(x.shape, generator=g)

        def step(x):
            y = checkpoint.checkpoint(inner, x, use_reentrant=False)
            y.sum().backward()
            return x.grad
        rep = _lint(step, torch.ones(4, 8, requires_grad=True))
        assert _rules(rep) == ["prng-key-reuse"]

    def test_clean_checkpoint_is_silent(self):
        def step(x):
            y = checkpoint.checkpoint(lambda t: t.tanh() * 2, x,
                                      use_reentrant=False)
            y.sum().backward()
            return x.grad
        assert _rules(_lint(step, torch.ones(4, 8, requires_grad=True))) \
            == []

    def test_f64_inside_a_cond_branch_fires(self):
        def step(x):
            return torch.cond(x.sum() > 0,
                              lambda t: (t.double() * 2).float(),
                              lambda t: t * 3, (x,))
        tr = api.trace(step, (X,))
        assert any(name for name, _ in fx_lint.walk_graphs(tr.gm))
        assert "f64-promotion" in _rules(_lint(step, X))
        assert _rules(_lint(lambda x: torch.cond(
            x.sum() > 0, lambda t: t * 2, lambda t: t * 3, (x,)), X)) == []


def test_lint_leaves_real_tensors_and_generators_untouched():
    x = torch.ones(4, 8)
    s = torch.zeros(512, 512)
    g = torch.Generator().manual_seed(5)
    gstate = g.get_state()

    def step(s, x, g):
        s.add_(x.sum())
        g.manual_seed(9)
        return s * torch.rand(s.shape, generator=g)
    rep = _lint(step, s, x, g)
    assert "prng-key-reuse" in _rules(rep)
    assert torch.equal(s, torch.zeros(512, 512))
    assert torch.equal(g.get_state(), gstate) and g.initial_seed() == 5
