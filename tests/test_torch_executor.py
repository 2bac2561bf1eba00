"""The port's Program/Executor, config, fleet and launch
(``paddle_tpu_torch.{executor,config,fleet,launch}``) against the JAX
package's on the same numpy weights and batches from seeds:

- ``Executor.run`` of a train ``Program`` (three SGD-momentum steps of a
  two-layer MLP): losses within 1e-5 relative and parameters within 1e-5
  of the reference's ``Executor``; ``fetch_list`` and numpy fetches; an
  inference program; the lint gate's refusal naming the analysis tiers;
  a ``Program`` under a dp=2 mesh on gloo ranks equal to one process;
- ``train_from_dataset`` over a reader creator with ``feed_builder``:
  the per-step losses of the reference's; checkpoints every 3 steps and a
  second run resumed from step 3 that ends bit for bit on the
  uninterrupted run's state; ``infer_from_dataset``;
- ``config.set_flags`` and the ``PADDLE_TPU_*`` bootstrap give the
  reference's trees;
- ``fleet`` on gloo ranks: ranks, ``barrier``, ``agree_on_resume_step``
  (the minimum, None when a rank has nothing), ``local_shard``; the
  reference's ``RoleMaker.from_env`` reads ``launch.worker_env`` as the
  port's does; ``HeartbeatMonitor`` calls ``on_stall``;
- ``ElasticCoordinator`` against the reference's on the same scripted
  workers (a failure, a preemption, a drain), and ``launch`` end to end:
  two workers join one gloo group through ``fleet.init``, and
  ``--elastic`` restarts a failed gang.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu import config as jconfig
from paddle_tpu import executor as jexec
from paddle_tpu import fleet as jfleet
from paddle_tpu import optimizer as jopt
from paddle_tpu import train as jtrain
from paddle_tpu_torch import config, executor, fleet, launch
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.train import build_train_step, make_train_state
from torch_tp_pool import TpPool

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"fc1": {"weight": rng.standard_normal((8, 16), np.float32),
                    "bias": np.zeros(16, np.float32)},
            "fc2": {"weight": rng.standard_normal((16, 4), np.float32),
                    "bias": np.zeros(4, np.float32)}}


def _batches(n, seed=1, b=8):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((b, 8), np.float32),
             "y": rng.standard_normal((b, 4), np.float32)}
            for _ in range(n)]


class MLP(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.fc1 = Linear(8, 16, device="cpu")
        self.fc2 = Linear(16, 4, device="cpu")
        with torch.no_grad():
            for name in ("fc1", "fc2"):
                for k, v in w[name].items():
                    getattr(self, name)._parameters[k].copy_(
                        torch.from_numpy(v))

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _port_loss(m, x, y):
    return torch.mean((m(x) - y) ** 2), {"out_mean": m(x).mean()}


def _jax_loss(p, x, y):
    h = jax.nn.relu(x @ p["fc1"]["weight"] + p["fc1"]["bias"])
    out = h @ p["fc2"]["weight"] + p["fc2"]["bias"]
    return jnp.mean((out - y) ** 2), {"out_mean": out.mean()}


def _port_state(w=None):
    model = MLP(w or _weights())
    opt = popt.Momentum(model.parameters(), learning_rate=0.05,
                        momentum=0.9)
    return build_train_step(_port_loss, opt), make_train_state(model, opt)


def _jax_state():
    optimizer = jopt.Momentum(learning_rate=0.05, momentum=0.9)
    params = jax.tree_util.tree_map(jnp.asarray, _weights())
    state = {"params": params, "opt": optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    return jtrain.build_train_step(_jax_loss, optimizer), state


def _params(model):
    return {k: v.detach().numpy() for k, v in model.named_parameters()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(v)})
    return out


def test_run_equals_the_reference_executor():
    jstep, jstate = _jax_state()
    step, state = _port_state()
    jprog = jexec.Program(jstep, name="mlp", donate_state=True)
    prog = executor.Program(step, name="mlp", donate_state=True)
    jexe, exe = jexec.Executor(), executor.Executor()
    for batch in _batches(3):
        jstate, jf = jexe.run(jprog, jstate, feed=batch)
        state, f = exe.run(prog, state, feed=batch,
                           fetch_list=["loss", "out_mean"])
        assert set(f) == {"loss", "out_mean"}
        assert isinstance(f["loss"], np.ndarray)
        for k in f:
            assert float(f[k]) == pytest.approx(float(jf[k]), rel=1e-5)
    want = _flat(jax.device_get(jstate["params"]))
    for k, v in _params(state["model"]).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6)
    assert int(state["step"]) == 3
    _, f = exe.run(prog, state, feed=_batches(1)[0], return_numpy=False)
    assert isinstance(f["loss"], torch.Tensor)


def test_inference_program_and_the_lint_refusal():
    model = MLP(_weights())
    prog = executor.Program(lambda m, x: {"out": m(x)}, name="infer")
    x = _batches(1)[0]["x"]
    with torch.no_grad():
        _, f = executor.Executor().run(prog, model, feed={"x": x})
    want = jexec.Executor().run(
        jexec.Program(lambda p, x: {"out": _jax_loss(p, x, 0.0)[1][
            "out_mean"]}),
        _weights(), feed={"x": x})[1]
    assert f["out"].shape == (8, 4)
    assert float(f["out"].mean()) == pytest.approx(float(want["out"]),
                                                   rel=1e-5)
    # the lint gate: an inference program lints clean once, before its
    # first dispatch, and runs as the ungated executor does
    for kw in ({"lint": "error"}, {"lint": "warn", "lint_cost": {}}):
        exe = executor.Executor(**kw)
        with torch.no_grad():
            _, g = exe.run(prog, model, feed={"x": x})
        assert exe._linted == {id(prog)}
        np.testing.assert_array_equal(g["out"], f["out"])


def _reader(batches):
    def creator():
        for b in batches:
            for i in range(b["x"].shape[0]):
                yield b["x"][i], b["y"][i]
    return creator


def _feed_builder(samples):
    return {"x": np.stack([s[0] for s in samples]),
            "y": np.stack([s[1] for s in samples])}


def test_train_from_dataset_checkpoints_and_resumes(tmp_path):
    batches = _batches(6)
    reader = _reader(batches)
    jstep, jstate = _jax_state()
    jlosses = []
    jexec.Executor().train_from_dataset(
        jexec.Program(jstep, donate_state=True), reader, jstate,
        batch_size=8, feed_builder=_feed_builder,
        fetch_handler=lambda i, f: jlosses.append(float(f["loss"])))

    def train(directory, reader, resume=False, log=None):
        step, state = _port_state()
        losses = []
        state, _ = executor.Executor().train_from_dataset(
            executor.Program(step, donate_state=True), reader, state,
            batch_size=8, feed_builder=_feed_builder,
            fetch_handler=lambda i, f: losses.append((i, float(f["loss"]))),
            checkpoint_dir=str(directory), checkpoint_every=3,
            resume=resume, run_log=log)
        return state, losses

    whole, losses = train(tmp_path / "a", reader,
                          log=str(tmp_path / "run.jsonl"))
    assert [i for i, _ in losses] == list(range(6))
    np.testing.assert_allclose([v for _, v in losses], jlosses, rtol=1e-5)
    assert (tmp_path / "run.jsonl").exists()
    # a first run stopped after 3 steps, then a fresh process resumed
    train(tmp_path / "b", _reader(batches[:3]))
    resumed, losses = train(tmp_path / "b", reader, resume=True)
    assert [i for i, _ in losses] == [3, 4, 5]
    assert int(resumed["step"]) == int(whole["step"]) == 6
    for k, v in whole["model"].state_dict().items():
        assert torch.equal(resumed["model"].state_dict()[k], v), k
    for a, b in zip(whole["opt"].state_tensors(),
                    resumed["opt"].state_tensors()):
        assert torch.equal(a, b)
    outs = executor.Executor().infer_from_dataset(
        executor.Program(lambda m, x, y: {"out": m(x)}), reader,
        whole["model"], batch_size=16, feed_builder=_feed_builder)
    assert [o["out"].shape for o in outs] == [(16, 4)] * 3
    with pytest.raises(ValueError, match="feed_builder"):
        list(executor._dataset_batches(reader, 8, None))


def test_config_flags_and_env_match_the_reference(monkeypatch):
    env = {"PADDLE_TPU_CHECK_NAN_INF": "true", "PADDLE_TPU_SEED": "7",
           "PADDLE_TPU_AMP_POLICY": "bf16", "PADDLE_TPU_GRAD_ACCUM_STEPS":
           "4", "PADDLE_TPU_NOT_A_FLAG": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(config, "_GLOBAL", config.Config())
    monkeypatch.setattr(jconfig, "_GLOBAL", jconfig.Config())
    config._bootstrap_from_env()
    jconfig._bootstrap_from_env()
    config.set_flags(remat=True, process_id=2)
    jconfig.set_flags(remat=True, process_id=2)
    got, want = config.global_config(), jconfig.global_config()
    assert got.seed == want.seed == 7
    for section in ("execution", "build"):
        assert vars(getattr(got, section)) == vars(getattr(want, section))
    assert vars(got.distributed.mesh) == vars(want.distributed.mesh)
    assert got.distributed.process_id == want.distributed.process_id == 2
    for mod in (config, jconfig):
        with pytest.raises(ValueError):
            mod.set_flags(dp=1)


@pytest.fixture(scope="module")
def pools():
    ps = {2: TpPool(2), 4: TpPool(4)}
    yield ps
    for p in ps.values():
        p.close()


def test_program_under_a_mesh_equals_one_process(pools):
    batches = _batches(3)
    got = pools[2].run("executor_mesh", timeout_s=60, weights=_weights(),
                       batches=batches)
    step, state = _port_state()
    prog = executor.Program(step, donate_state=True)
    exe = executor.Executor()
    want = [float(exe.run(prog, state, feed=b)[1]["loss"])
            for b in batches]
    for res in got:
        np.testing.assert_allclose(res["losses"], want, rtol=1e-5)
        for k, v in _params(state["model"]).items():
            np.testing.assert_allclose(res["params"][k], v, rtol=1e-5,
                                       atol=1e-6)


def test_fleet_on_gloo_ranks(pools):
    batch = {"x": np.arange(24).reshape(12, 2), "y": np.arange(12)}
    got = pools[4].run("fleet_ops", timeout_s=60, steps=[9, 6, 12, 6],
                       batch=batch)
    for r, res in enumerate(got):
        assert res["rank"] == r and res["num"] == 4
        assert res["first"] == (r == 0)
        assert res["agreed"] == 6 and res["with_none"] is None
        np.testing.assert_array_equal(res["shard"]["x"],
                                      batch["x"][3 * r:3 * r + 3])
        np.testing.assert_array_equal(
            res["shard"]["y"], jfleet.local_shard(batch, index=r,
                                                  num=4)["y"])
    with pytest.raises(ValueError, match="not divisible"):
        fleet.local_shard({"x": np.zeros(5)}, index=0, num=2)


def test_role_from_the_launch_environment(monkeypatch):
    env = launch.worker_env(1, 3, "localhost:29611", base_env={})
    role = fleet.RoleMaker.from_env(env)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for k in ("JAX_PROCESS_INDEX", "JAX_PROCESS_COUNT",
              "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    want = jfleet.RoleMaker.from_env()
    assert (role.worker_index, role.worker_num, role.coordinator) == \
        (want.worker_index, want.worker_num, want.coordinator) == \
        (1, 3, "localhost:29611")
    assert not role.is_first_worker()
    assert fleet.RoleMaker.from_env({}) == fleet.RoleMaker(0, 1, None)
    assert fleet.init(fleet.RoleMaker()) == fleet.RoleMaker()


def test_heartbeat_calls_on_stall():
    stalls = []
    mon = fleet.HeartbeatMonitor(0.05, check_every_s=0.02,
                                 on_stall=lambda s, idle: stalls.append(s),
                                 log_fn=lambda msg: None)
    mon.beat(4)
    deadline = time.monotonic() + 10
    while not stalls and time.monotonic() < deadline:
        time.sleep(0.02)
    mon.stop()
    assert stalls and stalls[0] == 4
    assert not mon._thread.is_alive()


def _scripted(table):
    """``spawn(rank, attempt)``: a Python process that sleeps and exits as
    ``table[(rank, attempt)] = (rc, seconds)`` says (default: 0 at once);
    a long sleep is a worker the supervisor kills."""
    def spawn(rank, attempt):
        rc, secs = table.get((rank, attempt), (0, 0.0))
        return subprocess.Popen([sys.executable, "-c",
                                 f"import sys, time; time.sleep({secs}); "
                                 f"sys.exit({rc})"])
    return spawn


def _tables():
    from paddle_tpu_torch.resilience.preempt import (EXIT_DRAINED,
                                                     EXIT_PREEMPTED)
    gang = {(1, 0): (1, 0.0), (0, 0): (0, 30.0), (2, 0): (0, 30.0),
            (0, 1): (EXIT_PREEMPTED, 0.0), (1, 1): (0, 30.0),
            (2, 1): (0, 30.0), (2, 2): (EXIT_DRAINED, 0.0),
            (0, 2): (0, 0.5), (1, 2): (0, 0.5)}
    ranks = {(0, 0): (EXIT_PREEMPTED, 0.0), (1, 0): (1, 0.2),
             (2, 0): (EXIT_DRAINED, 0.0)}
    # (ok, gang restarts, rank restarts, preemption restarts, drains)
    return {True: (gang, (True, 1, [0, 0, 0], 1, 1)),
            False: (ranks, (True, 0, [0, 1, 0], 1, 1))}


@pytest.mark.parametrize("gang", [True, False])
def test_elastic_coordinator_equals_the_reference(gang):
    table, want = _tables()[gang]
    for cls in (fleet.ElasticCoordinator, jfleet.ElasticCoordinator):
        c = cls(_scripted(table), 3, max_restarts=2, poll_s=0.05,
                gang=gang, log_fn=lambda msg: None)
        ok = c.run(timeout_s=60)
        assert (ok, c.restarts, c.rank_restarts, c.preemption_restarts,
                c.drained_exits) == want, cls
    c = fleet.ElasticCoordinator(
        _scripted({(0, a): (1, 0.0) for a in range(5)}), 1,
        max_restarts=1, poll_s=0.05, log_fn=lambda msg: None)
    assert not c.run(timeout_s=60) and c.restarts == 1


WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
import torch.distributed as dist
from paddle_tpu_torch import fleet
role = fleet.init()
fleet.barrier()
step = fleet.agree_on_resume_step(10 + role.worker_index)
attempt = int(os.environ["PADDLE_LAUNCH_ATTEMPT"])
with open(os.path.join({out!r}, f"rank{{role.worker_index}}.a{{attempt}}"),
          "w") as f:
    f.write(f"{{role.worker_num}} {{step}}")
dist.destroy_process_group()
if {fail_first} and attempt == 0 and role.worker_index == 1:
    sys.exit(3)
"""


@pytest.mark.parametrize("elastic", [False, True])
def test_launch_end_to_end(tmp_path, elastic):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, out=str(tmp_path),
                                    fail_first=elastic))
    args = [sys.executable, "-m", "paddle_tpu_torch.launch", "--nproc", "2",
            "--log-dir", str(tmp_path / "logs")]
    if elastic:
        args += ["--elastic", "--max-restarts", "1", "--timeout-s", "120"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(args + [str(script)], env=env, timeout=240,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = 1 if elastic else 0
    for r in range(2):
        assert (tmp_path / f"rank{r}.a{last}").read_text() == "2 10"
    assert sorted(os.listdir(tmp_path / "logs")) == sorted(
        f"rank{r}.a{a}.{s}" for r in range(2) for a in range(last + 1)
        for s in ("out", "err"))
