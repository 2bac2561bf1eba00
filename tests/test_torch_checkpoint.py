"""Checkpointing in the port, against the JAX package on the CPU.

The snapshot engine (subsets of ``test_resilience.py``): round trips with
empty nodes and bf16 leaves, immutable committed steps, refusal of
non-dict containers, gc, a torn save that stays invisible while the
previous one restores, a corrupted shard refused with fallback past it,
the two-phase commit of two processes, retry over a flaky filesystem.
``io`` (subsets of ``test_checkpoint.py``): ``save_params`` /
``load_params`` and ``CheckpointManager``. Files cross the two packages
both ways (float32 trees; bf16 leaves are the port's own). The Trainer:
kill and resume bit-identical to an unbroken run (preemption exit 83),
resume past a corrupted newest snapshot, a run log the reference's
validator accepts, and a tiny-BERT checkpoint written by either
package's ``Trainer`` resumed by the other's, which trains on to the
writer's unbroken run: parameters within 1e-5 (the key third of the QKV
bias held to its drift bound, as in ``test_torch_train.py``)."""

import glob
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from paddle_tpu import io as jio
from paddle_tpu import optimizer as jopt
from paddle_tpu import train as jtrain
from paddle_tpu import trainer as jtrainer
from paddle_tpu.core import dtypes as jdtypes
from paddle_tpu.observability import runlog as jrunlog
from paddle_tpu.resilience import snapshot as jsnapshot
from paddle_tpu_torch import fs as fs_lib
from paddle_tpu_torch import io
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.models import state_from_jax
from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining
from paddle_tpu_torch.observability import runlog
from paddle_tpu_torch.resilience import (EXIT_PREEMPTED, FaultInjected,
                                         FlakyFS, HostDead, PreemptionGuard,
                                         RetryPolicy, SnapshotCorruptionError,
                                         SnapshotEngine, TornWriteFS,
                                         corrupt_file, simulate_preemption)
from paddle_tpu_torch.train import build_train_step, make_train_state
from paddle_tpu_torch.trainer import Trainer, state_tree

from test_torch_bert import jax_bert, make_batch, torch_batch

torch.set_num_threads(2)


def _state(step=3):
    return {"params": {"w": torch.arange(8.0), "b": torch.ones(2, 2)},
            "opt": {"slots": {}},        # empty node: structure must survive
            "step": torch.tensor(step, dtype=torch.int32)}


def _shard_files(directory, step):
    return sorted(glob.glob(os.path.join(
        directory, f"step_{step:010d}", "shards_*.pkl")))


# -- the snapshot engine ------------------------------------------------------

def test_roundtrip_with_empty_nodes_and_bf16_leaves(tmp_path):
    eng = SnapshotEngine(str(tmp_path), max_to_keep=2)
    state = _state()
    state["params"]["h"] = torch.linspace(-3, 3, 7).to(torch.bfloat16)
    eng.save(3, state, wait=True)
    assert eng.latest_step() == 3
    back = eng.restore(target=state)
    assert torch.equal(back["params"]["w"], torch.arange(8.0))
    assert back["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["h"], state["params"]["h"])
    assert back["opt"]["slots"] == {}
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 3
    assert eng.latest_valid_manifest()["tree"]["params/h"]["dtype"] == \
        "bfloat16"
    eng.close()


def test_resave_of_committed_step_is_noop(tmp_path):
    eng = SnapshotEngine(str(tmp_path))
    eng.save(3, _state(3), wait=True)
    before = open(_shard_files(str(tmp_path), 3)[0], "rb").read()
    eng.save(3, {"params": {"w": torch.zeros(8)}, "opt": {"slots": {}},
                 "step": torch.tensor(3)}, wait=True)
    assert open(_shard_files(str(tmp_path), 3)[0], "rb").read() == before
    assert torch.equal(eng.restore(3)["params"]["w"], torch.arange(8.0))
    eng.close()


def test_non_dict_containers_refused_loudly(tmp_path):
    eng = SnapshotEngine(str(tmp_path))
    with pytest.raises(TypeError, match="container"):
        eng.save(1, {"opt": (torch.ones(2), torch.ones(2))}, wait=True)
    with pytest.raises(TypeError, match="str"):
        eng.save(1, {"layers": {0: torch.ones(2)}}, wait=True)
    # the sharded restore is ported: with nothing saved it finds nothing
    assert eng.restore(shardings={}) is None
    # hdfs:// routes to the ported HDFSClient (the hadoop command line)
    fs, path = fs_lib.get_fs("hdfs://cluster/ckpt")
    assert isinstance(fs, fs_lib.HDFSClient) and path == "hdfs://cluster/ckpt"
    eng.close()


def test_gc_keeps_newest(tmp_path):
    eng = SnapshotEngine(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        eng.save(s, _state(s), wait=True)
    assert eng.all_steps() == [2, 3]
    eng.close()


def test_torn_save_invisible_previous_restorable(tmp_path):
    d = str(tmp_path)
    eng = SnapshotEngine(d)
    eng.save(1, _state(1), wait=True)
    good = eng.restore(1)
    torn_fs = TornWriteFS(fs_lib.LocalFS(), kill_after_bytes=150)
    eng2 = SnapshotEngine(d, fs=torn_fs, retry=RetryPolicy(max_attempts=1))
    with pytest.raises(FaultInjected):
        eng2.save(2, _state(2), wait=True)
    assert torn_fs.dead
    with pytest.raises(HostDead):
        torn_fs.open_write(os.path.join(d, "x"))
    eng3 = SnapshotEngine(d)
    m = eng3.latest_valid_manifest()
    assert m is not None and m["step"] == 1
    assert eng3.all_steps() == [1]
    back = eng3.restore()
    assert int(back["step"]) == 1
    assert torch.equal(back["params"]["w"], good["params"]["w"])
    eng.close(), eng3.close()


def test_restore_refuses_corrupted_shard(tmp_path):
    d = str(tmp_path)
    eng = SnapshotEngine(d, max_to_keep=3)
    eng.save(1, _state(1), wait=True)
    eng.save(2, _state(2), wait=True)
    corrupt_file(_shard_files(d, 2)[0])
    with pytest.raises(SnapshotCorruptionError):
        eng.restore(2)
    assert eng.latest_step() == 1
    assert int(eng.restore()["step"]) == 1
    eng.close()


def test_two_phase_commit_merges_both_processes(tmp_path):
    d = str(tmp_path)
    p1 = SnapshotEngine(d, process_index=1, process_count=2)
    p1.save(1, _state(1), wait=True)     # shards + commit, no manifest
    assert SnapshotEngine(d).latest_valid_manifest() is None
    p0 = SnapshotEngine(d, process_index=0, process_count=2)
    p0.save(1, _state(1), wait=True)
    m = p0.latest_valid_manifest()
    assert m["step"] == 1 and len(m["files"]) == 2
    assert torch.equal(p0.restore(1)["params"]["w"], torch.arange(8.0))
    p0.close(), p1.close()
    p0 = SnapshotEngine(str(tmp_path / "lone"), process_index=0,
                        process_count=2, manifest_wait_s=0.2)
    with pytest.raises(IOError):
        p0.save(1, _state(1), wait=True)  # process 1 never shows up
    assert p0.latest_valid_manifest() is None
    p0.close()


def test_snapshot_survives_flaky_fs(tmp_path):
    flaky = FlakyFS(fs_lib.LocalFS(), fail_times=2)
    eng = SnapshotEngine(str(tmp_path), fs=flaky,
                         retry=RetryPolicy(max_attempts=5,
                                           base_delay_s=0.001))
    eng.save(1, _state(1), wait=True)
    assert flaky.failures_injected == 2
    assert eng.latest_step() == 1
    eng.close()


def test_snapshots_cross_the_two_packages(tmp_path):
    """A float32 tree (with an empty node) written by either engine
    restores in the other, leaf for leaf."""
    rng = np.random.default_rng(0)
    tree = {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "opt": {"slots": {}, "step": np.int32(5)}}
    j = jsnapshot.SnapshotEngine(str(tmp_path / "j"), process_index=0,
                                 process_count=1)
    j.save(5, tree, wait=True)
    back = SnapshotEngine(str(tmp_path / "j")).restore()
    np.testing.assert_array_equal(back["params"]["w"].numpy(),
                                  tree["params"]["w"])
    assert back["opt"]["slots"] == {} and int(back["opt"]["step"]) == 5
    t = SnapshotEngine(str(tmp_path / "t"))
    t.save(5, {"params": {"w": torch.from_numpy(tree["params"]["w"])},
               "opt": {"slots": {},
                       "step": torch.tensor(5, dtype=torch.int32)}},
           wait=True)
    jback = jsnapshot.SnapshotEngine(str(tmp_path / "t"), process_index=0,
                                     process_count=1).restore(target=tree)
    np.testing.assert_array_equal(jback["params"]["w"], tree["params"]["w"])
    assert jback["opt"]["slots"] == {} and int(jback["opt"]["step"]) == 5
    j.close(), t.close()


# -- io ----------------------------------------------------------------------

def test_save_load_params_keeps_structure_and_bf16(tmp_path):
    state = {"params": {"w": torch.ones(2),
                        "h": torch.full((3,), 1.5, dtype=torch.bfloat16)},
             "opt": {"slots": {}, "step": torch.zeros((), dtype=torch.int32)}}
    p = str(tmp_path / "s.pkl")
    io.save_params(state, p)
    back = io.load_params(p, target=state)
    assert back["opt"]["slots"] == {}
    assert back["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["h"], state["params"]["h"])
    with pytest.raises(ValueError):
        io.load_params(p, target={"params": {"w": torch.ones(2)}})
    # float32 files cross the two packages both ways
    jio.save_params({"a": {"b": np.arange(4, dtype=np.float32)}, "e": {}},
                    str(tmp_path / "j.pkl"))
    got = io.load_params(str(tmp_path / "j.pkl"))
    assert torch.equal(got["a"]["b"], torch.arange(4.0)) and got["e"] == {}
    io.save_params({"a": {"b": torch.arange(4.0)}, "e": {}},
                   str(tmp_path / "t.pkl"))
    got = jio.load_params(str(tmp_path / "t.pkl"))
    np.testing.assert_array_equal(got["a"]["b"], np.arange(4.0))


def test_checkpoint_manager_interval_gating_and_gc(tmp_path):
    mgr = io.CheckpointManager(str(tmp_path / "c"), max_to_keep=2,
                               save_interval_steps=2)
    assert mgr.save(1, _state(1), wait=True)
    assert not mgr.save(2, _state(2), wait=True)     # inside the interval
    assert mgr.save(2, _state(2), wait=True, force=True)
    assert mgr.save(4, _state(4), wait=True)
    mgr.wait()
    assert mgr.manager.all_steps() == [2, 4]
    assert mgr.latest_step() == 4 and mgr.last_saved_step == 4
    assert int(io.CheckpointManager(str(tmp_path / "c")).restore()["step"]) \
        == 4
    mgr.close()


# -- the Trainer --------------------------------------------------------------

class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.full((4, 2), 0.5))
        self.b = nn.Parameter(torch.zeros(2))


def _toy_loss(m, x, y):
    return torch.mean((x @ m.w + m.b - y) ** 2)


def _toy_parts():
    model = _Toy()
    state = make_train_state(model, opt.Adam(model.parameters(), 0.1))
    return state, build_train_step(_toy_loss, state["opt"])


def _toy_batches(n=10):
    rng = np.random.default_rng(0)
    return [{"x": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
             "y": torch.from_numpy(rng.normal(size=(8, 2)).astype(np.float32))}
            for _ in range(n)]


QUIET = dict(telemetry=False, log_fn=lambda s: None)


def test_sigterm_sets_the_guard():
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard()
    try:
        simulate_preemption(real_signal=True)
        assert guard.triggered
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_trainer_kill_and_resume_bit_identical(tmp_path):
    batches = _toy_batches(10)
    state, step = _toy_parts()
    ref = Trainer(step, state, checkpoint_dir=str(tmp_path / "a"),
                  checkpoint_every=4, **QUIET)
    ref.fit(batches)
    assert ref.step_count == 10

    state_b, step_b = _toy_parts()
    guard = PreemptionGuard(install=False)
    pre = Trainer(step_b, state_b, checkpoint_dir=str(tmp_path / "b"),
                  checkpoint_every=4, preemption_guard=guard,
                  hooks=[lambda tr, n, m: simulate_preemption(guard)
                         if n == 6 else None], **QUIET)
    with pytest.raises(SystemExit) as ei:
        pre.fit(batches)
    assert ei.value.code == EXIT_PREEMPTED == 83

    state_c, step_c = _toy_parts()
    res = Trainer(step_c, state_c, checkpoint_dir=str(tmp_path / "b"),
                  checkpoint_every=4, **QUIET)
    assert res.restore() == 6
    assert res.state["opt"].num_steps == 6
    res.fit(batches[6:])
    assert res.step_count == 10
    for a, b in zip(ref.state["model"].parameters(),
                    res.state["model"].parameters()):
        assert torch.equal(a, b)
    for p, q in zip(ref.state["opt"].params(), res.state["opt"].params()):
        for s in ("m", "v"):
            assert torch.equal(ref.state["opt"].state[p][s],
                               res.state["opt"].state[q][s])


def test_trainer_resume_skips_corrupt_newest(tmp_path):
    state, step = _toy_parts()
    tr = Trainer(step, state, checkpoint_dir=str(tmp_path),
                 checkpoint_every=4, **QUIET)
    tr.fit(_toy_batches(8))                  # snapshots at 4 and 8
    corrupt_file(_shard_files(str(tmp_path), 8)[0])
    state2, step2 = _toy_parts()
    tr2 = Trainer(step2, state2, checkpoint_dir=str(tmp_path),
                  checkpoint_every=4, **QUIET)
    assert tr2.restore() == 4
    assert int(tr2.state["step"]) == 4


def test_run_log_passes_the_reference_validator(tmp_path):
    state, step = _toy_parts()
    path = str(tmp_path / "run.jsonl")
    tr = Trainer(step, state, run_log=path, log_every=2,
                 log_fn=lambda s: None)
    tr.fit(_toy_batches(5))
    assert jrunlog.validate_run_log(path, require_steps=5) == 5
    assert runlog.validate_run_log(path, require_steps=5) == 5
    recs = runlog.read_run_log(path)
    kinds = [r["kind"] for r in recs]
    assert kinds[0] == "run_meta" and kinds[-1] == "summary"
    steps = [r for r in recs if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [1, 2, 3, 4, 5]
    assert all(r["recompiles"] == 0 for r in steps)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        tr.fit(_toy_batches(1), lint="warn")


def test_single_process_aggregate_matches_the_reference():
    from paddle_tpu.observability.aggregate import aggregate as jagg
    from paddle_tpu.observability.aggregate import format_aggregate as jfmt
    from paddle_tpu_torch.observability.aggregate import (aggregate,
                                                          format_aggregate)
    values = {"step_time_s": 0.25, "examples_per_sec": 190.5,
              "data_wait_s": 0.0}
    assert aggregate(values) == jagg(values)
    assert format_aggregate(aggregate(values)) == jfmt(jagg(values))


def test_state_tree_is_the_reference_tree():
    """The port's checkpoint tree of a tiny BERT under AdamW has the
    reference Trainer's keys, shapes and dtypes."""
    jcfg, jmodel, params = jax_bert(seed=2)
    joptim = jopt.AdamW(1e-3)
    jstate = {"params": params, "opt": joptim.init(params),
              "step": jnp.zeros((), jnp.int32)}
    model = BertForPretraining(BertConfig.tiny(dropout=0.0, attn_dropout=0.0),
                               device="cpu")
    tree = state_tree(make_train_state(model,
                                       opt.AdamW(model.parameters(), 1e-3)))
    got = {k: (tuple(v.shape), str(v.dtype)[6:])
           for k, v in jsnapshot.flatten_tree(tree).items()
           if isinstance(v, torch.Tensor)}
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jsnapshot.flatten_tree(jax.device_get(jstate)).items()
            if not k.endswith("\x00empty")}
    assert got == want
    assert set(jsnapshot.flatten_tree(tree)) == set(
        jsnapshot.flatten_tree(jax.device_get(jstate)))


def _jax_trainer(jmodel, params, directory):
    optimizer = jopt.AdamW(1e-3)
    state = {"params": params, "opt": optimizer.init(params),
             "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jtrain.build_train_step(
        lambda p, **b: jmodel.loss(p, **b), optimizer,
        policy=jdtypes.get_policy("full")))
    return jtrainer.Trainer(step, state, checkpoint_dir=directory,
                            checkpoint_every=2, **QUIET)


def _port_trainer(params, directory, seed=0):
    model = BertForPretraining(BertConfig.tiny(dropout=0.0, attn_dropout=0.0),
                               device="cpu", seed=seed)
    if params is not None:
        model.load_state_dict(state_from_jax(jax.device_get(params)))
    state = make_train_state(model, opt.AdamW(model.parameters(), 1e-3))
    step = build_train_step(lambda m, **b: m.loss(**b), state["opt"])
    return Trainer(step, state, checkpoint_dir=directory, checkpoint_every=2,
                   **QUIET)


def _held(got, want, steps, lr=1e-3):
    """Within 1e-5; the key third of each QKV bias (zero gradient in exact
    arithmetic, so Adam steps on rounding noise) within its drift."""
    for name, g in got.items():
        g, w = g.detach().numpy().copy(), want[name].numpy().copy()
        if name.endswith("attn.qkv_proj.bias"):
            d = g.shape[0] // 3
            assert np.abs(g[d:2 * d] - w[d:2 * d]).max() <= 2 * steps * lr
            g[d:2 * d] = w[d:2 * d]
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=name)


def test_jax_checkpoint_resumes_in_the_port_and_the_other_way(tmp_path):
    jcfg, jmodel, params = jax_bert(seed=11)
    batches = [make_batch(jcfg, 2, 16, seed=40 + i) for i in range(4)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    tb = [torch_batch(b) for b in batches]

    # JAX writes at step 2; the port resumes and trains to step 4
    jt = _jax_trainer(jmodel, params, str(tmp_path / "j"))
    jt.fit(jb[:2])
    jt.fit(jb[2:])                                  # the unbroken JAX run
    j_final = state_from_jax(jax.device_get(jt.state["params"]))
    jt.manager.close()
    shutil.rmtree(str(tmp_path / "j" / "step_0000000004"))  # resume at 2
    pt = _port_trainer(None, str(tmp_path / "j"), seed=99)
    assert pt.restore() == 2 and pt.state["opt"].num_steps == 2
    pt.fit(tb[2:])
    assert pt.step_count == 4
    _held(dict(pt.state["model"].named_parameters()), j_final, steps=2)

    # the port writes at step 2; JAX resumes and trains to step 4
    pt2 = _port_trainer(params, str(tmp_path / "t"))
    pt2.fit(tb[:2])
    pt2.fit(tb[2:])                                 # the unbroken port run
    t_final = {n: p.detach() for n, p in
               pt2.state["model"].named_parameters()}
    pt2.manager.close()
    shutil.rmtree(str(tmp_path / "t" / "step_0000000004"))
    _, _, other = jax_bert(seed=12)
    jt2 = _jax_trainer(jmodel, other, str(tmp_path / "t"))
    assert jt2.restore() == 2
    jt2.fit(jb[2:])
    assert int(jt2.state["step"]) == 4
    _held({n: torch.from_numpy(np.asarray(v)) for n, v in state_from_jax(
        jax.device_get(jt2.state["params"])).items()}, t_final, steps=2)
