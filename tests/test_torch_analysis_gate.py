"""The lint gate of ``Trainer.fit(lint=, lint_cost=)`` and
``Executor(lint=, lint_cost=)`` (ports of the reference's
``TestTrainerGate``, ``TestExecutorGate`` and ``TestTrainerCostGate``),
the graph-lint CLI (``python -m paddle_tpu_torch.analysis.graph_lint``)
against the committed budgets and suppressions, and a lint that moves
nothing of a ResNet-18 train state (parameters, BatchNorm statistics and
optimizer slots bit for bit)."""

import json
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch import analysis, executor
from paddle_tpu_torch.analysis import LintError, graph_lint
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.train import build_train_step, make_train_state
from paddle_tpu_torch.trainer import Trainer


def _mlp():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.Tanh(),
                               torch.nn.Linear(128, 4))


def _clean_loss(m, x, y):
    return torch.nn.functional.cross_entropy(m(x), y)


def _host_read_loss(m, x, y):
    loss = torch.nn.functional.cross_entropy(m(x), y)
    seen = loss.detach().item()
    return loss * (1.0 + 0.0 * seen)


def _f64_loss(m, x, y):
    loss = torch.nn.functional.cross_entropy(m(x), y)
    return (loss.double() * 1.0).float()


def _parts(loss_fn):
    model = _mlp()
    opt = Adam(model.parameters(), learning_rate=1e-2)
    return make_train_state(model, opt), build_train_step(loss_fn, opt)


def _batches(n=4):
    rng = np.random.default_rng(0)
    return [{"x": torch.from_numpy(rng.standard_normal((8, 64)).astype(
        np.float32)),
        "y": torch.from_numpy(rng.integers(0, 4, 8))} for _ in range(n)]


def _snapshot(state):
    return [t.detach().clone() for _lab, t in
            analysis.api.tensor_leaves(state)]


def _same(state, snap):
    return all(torch.equal(a, b) for (_l, a), b in
               zip(analysis.api.tensor_leaves(state), snap))


class TestTrainerGate:
    def test_error_mode_passes_on_a_clean_step(self):
        state, step = _parts(_clean_loss)
        metrics = Trainer(step, state, log_fn=lambda s: None).fit(
            _batches(), lint="error")
        assert np.isfinite(metrics["loss"]) and int(state["step"]) == 4

    def test_error_mode_raises_before_any_state_moves(self):
        state, step = _parts(_host_read_loss)
        snap = _snapshot(state)
        with pytest.raises(LintError) as e:
            Trainer(step, state, log_fn=lambda s: None).fit(
                _batches(), lint="error")
        rules = {f.rule for f in e.value.report}
        assert {"host-callback", "ast-host-sync"} <= rules
        assert int(state["step"]) == 0 and _same(state, snap)

    def test_warn_mode_logs_once_and_trains(self):
        state, step = _parts(_f64_loss)
        logged = []
        data = _batches()
        Trainer(step, state, log_fn=logged.append).fit(
            data, epochs=2, make_iter=lambda: iter(data), lint="warn")
        reports = [s for s in logged if s.startswith("graph lint")]
        assert len(reports) == 1 and "f64-promotion" in reports[0]
        assert int(state["step"]) == 8

    def test_off_is_the_default_and_silent(self):
        state, step = _parts(_host_read_loss)
        logged = []
        Trainer(step, state, log_fn=logged.append).fit(_batches(2))
        assert not any("graph lint" in s for s in logged)
        with pytest.raises(ValueError):
            Trainer(step, state).fit(_batches(1), lint="loud")


class TestTrainerCostGate:
    def test_budget_enforced(self):
        state, step = _parts(_clean_loss)
        with pytest.raises(LintError) as e:
            Trainer(step, state, log_fn=lambda s: None).fit(
                _batches(), lint="error", lint_cost={"hbm_budget_bytes": 1024})
        assert "peak-hbm-budget" in str(e.value)
        assert int(state["step"]) == 0

    def test_flops_budget_and_clean_cost_run(self):
        state, step = _parts(_clean_loss)
        with pytest.raises(LintError, match="cost-regression"):
            Trainer(step, state, log_fn=lambda s: None).fit(
                _batches(), lint="error", lint_cost={"flops_budget": 10})
        metrics = Trainer(step, state, log_fn=lambda s: None).fit(
            _batches(), lint="error",
            lint_cost={"hbm_budget_bytes": 1 << 30,
                       "collective_allowlist": []})
        assert "loss" in metrics and int(state["step"]) == 4


def _program(loss_fn):
    state, step = _parts(loss_fn)
    return state, executor.Program(step, name="toy", donate_state=True)


class TestExecutorGate:
    def test_error_mode_raises_at_the_first_run(self):
        state, prog = _program(_host_read_loss)
        exe = executor.Executor(lint="error")
        with pytest.raises(LintError):
            exe.run(prog, state, feed=_batches(1)[0])
        assert int(state["step"]) == 0

    def test_error_gate_stays_armed_after_a_caught_error(self):
        state, prog = _program(_host_read_loss)
        exe = executor.Executor(lint="error")
        for _ in range(2):
            with pytest.raises(LintError):
                exe.run(prog, state, feed=_batches(1)[0])
        assert exe._linted == set() and int(state["step"]) == 0

    def test_warn_mode_runs_and_warns_once(self):
        state, prog = _program(_f64_loss)
        exe = executor.Executor(lint="warn")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for b in _batches(3):
                exe.run(prog, state, feed=b)
        lint_warnings = [x for x in w if "graph lint" in str(x.message)]
        assert len(lint_warnings) == 1
        assert int(state["step"]) == 3 and exe._linted == {id(prog)}

    def test_cost_gate_and_off_default(self):
        state, prog = _program(_clean_loss)
        exe = executor.Executor(lint="error",
                                lint_cost={"hbm_budget_bytes": 1024})
        with pytest.raises(LintError, match="peak-hbm-budget"):
            exe.run(prog, state, feed=_batches(1)[0])
        _, fetches = executor.Executor().run(prog, state,
                                             feed=_batches(1)[0])
        assert np.isfinite(fetches["loss"]) and int(state["step"]) == 1
        with pytest.raises(ValueError):
            executor.Executor(lint="loud")


def test_resnet18_lint_moves_nothing():
    """A narrow ResNet-18 in training mode (BatchNorm statistics through
    the state tape), Adam: linting its train step with the cost tier
    leaves every parameter, statistic, slot and the step bit for bit."""
    from paddle_tpu_torch.models.resnet import ResNet
    model = ResNet(depth=18, num_classes=10, width=16, in_ch=3,
                   device="cpu")
    opt = Adam(model.parameters(), learning_rate=1e-3)
    state = make_train_state(model, opt)
    step = build_train_step(graph_lint._ce_loss, opt)
    batch = {"image": torch.randn(2, 32, 32, 3),
             "label": torch.zeros((2, 1), dtype=torch.int64)}
    snap = _snapshot(state)
    n_buffers = sum(1 for _ in model.buffers())
    rep = analysis.lint_train_step(step, state, batch, cost=True,
                                   registry=False)
    assert rep.ok() and rep.cost.flops_by_class["conv"] > 0
    assert n_buffers > 0 and _same(state, snap)
    assert int(state["step"]) == 0 and step.builds == 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_list_rules(capsys):
    assert graph_lint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("host-callback", "prng-key-reuse", "bucket-coverage",
                 "cost-regression", "ast-tracer-branch"):
        assert rule in out


def test_cli_framework_preset_with_cost_diff_green(capsys):
    """The whole preset (every surface linted, the suppressions' stale
    gate) with the cost tier on top: every surface's budgets, the
    bucket-coverage report and the diff against the committed
    ``analysis/cost_budgets.json``."""
    assert graph_lint.main(["--preset", "framework", "--cost",
                            "--cost-diff"]) == 0
    out = capsys.readouterr().out
    assert "graph lint: serving_decode_tp — 0 findings" in out
    assert "graph lint: bucket_coverage — 0 findings" in out
    assert "REGRESSION" not in out


#: cheap surfaces for the failure legs of the CLI
SMALL = [graph_lint.lint_gpt_decode, graph_lint.lint_convgroup,
         graph_lint.lint_embedding_install]


def _small_budgets(tmp_path):
    with open(graph_lint.DEFAULT_BUDGETS) as f:
        budgets = json.load(f)
    budgets["surfaces"] = {k: v for k, v in budgets["surfaces"].items()
                           if k in ("gpt_decode", "vgg_convgroup",
                                    "embedding_cache_install")}
    return budgets


def test_cli_injected_regression_fails(tmp_path, monkeypatch):
    monkeypatch.setitem(graph_lint.PRESETS, "framework", SMALL)
    budgets = _small_budgets(tmp_path)
    path = tmp_path / "budgets.json"
    path.write_text(json.dumps(budgets))
    assert graph_lint.main(["--cost-diff", "--budgets", str(path)]) == 0
    budgets["surfaces"]["gpt_decode"]["flops"] = int(
        budgets["surfaces"]["gpt_decode"]["flops"] / 1.5)
    path.write_text(json.dumps(budgets))
    assert graph_lint.main(["--cost-diff", "--budgets", str(path)]) == 1
    del budgets["surfaces"]["gpt_decode"]
    path.write_text(json.dumps(budgets))
    assert graph_lint.main(["--cost-diff", "--budgets", str(path)]) == 1


def test_cli_stale_suppression_fails(tmp_path, monkeypatch):
    monkeypatch.setitem(graph_lint.PRESETS, "framework", SMALL)
    sup = tmp_path / "sup.txt"
    sup.write_text("# a finding no surface makes\n"
                   "host-callback  no-such-site\n")
    assert graph_lint.main(["--suppressions", str(sup)]) == 1
    sup.write_text("# entries of a tier that did not run are not judged\n"
                   "bucket-coverage  serving_pow2\n")
    assert graph_lint.main(["--suppressions", str(sup)]) == 0
