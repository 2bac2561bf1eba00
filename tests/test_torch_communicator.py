"""The port's communicators (``paddle_tpu_torch.parallel.communicator``)
against the reference's: ``AsyncCommunicator`` merges and applies every
push (and surfaces a worker's error), ``geo_sgd_sync`` at full and
partial participation on gloo ranks, ``GeoSgdCommunicator`` and
``FLCommunicator``'s weighted aggregate, each on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jax_opt
from paddle_tpu.core.mesh import MeshConfig, make_mesh, mesh_context
from paddle_tpu.parallel import communicator as jc
from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.parallel import communicator as pc
from torch_tp_pool import TpPool


@pytest.fixture(scope="module")
def pool():
    p = TpPool(4)
    yield p
    p.close()


def _tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"fc": {"weight": rng.normal(size=lead + (3, 4)).astype(np.float32),
                   "bias": rng.normal(size=lead + (4,)).astype(np.float32)},
            "scale": [rng.normal(size=lead + (2,)).astype(np.float32)]}


def _to_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _close(got, want, **kw):
    g = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, got))
    w = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, **kw)


@pytest.mark.parametrize("max_merge", [1, 4])
def test_async_communicator_equals_the_reference_sequence(max_merge):
    """Pushes drained one at a time (flush after each) apply one SGD step
    each: the port's master copy follows the reference's."""
    params = _tree(0)
    comm = pc.AsyncCommunicator(lambda ps: opt.SGD(ps, 0.1),
                                _to_torch(params), max_merge=max_merge)
    jcomm = jc.AsyncCommunicator(jax_opt.SGD(learning_rate=0.1),
                                 jax.tree_util.tree_map(jnp.asarray, params),
                                 max_merge=max_merge)
    for i in range(4):
        g = _tree(10 + i)
        comm.push(_to_torch(g))
        jcomm.push(jax.tree_util.tree_map(jnp.asarray, g))
        comm.flush()
        jcomm.flush()
    _close(comm.pull(), jcomm.pull(), rtol=1e-6, atol=1e-7)
    assert comm.pushed == jcomm.pushed == 4
    comm.stop()
    jcomm.stop()


def test_async_communicator_merges_everything_and_pull_copies():
    params = _to_torch(_tree(0))
    comm = pc.AsyncCommunicator(lambda ps: opt.SGD(ps, 0.0), params,
                                max_merge=4)
    for _ in range(10):
        comm.push(_to_torch(_tree(1)))
    comm.flush()
    assert comm.pushed == 10 and 3 <= comm.merged_updates <= 10
    _close(comm.pull(), params)          # lr 0: unchanged
    pulled = comm.pull()
    pulled["fc"]["bias"].add_(1.0)
    _close(comm.pull(), params)          # a copy, not the master
    comm.stop()


def test_a_bad_push_surfaces_instead_of_hanging():
    comm = pc.AsyncCommunicator(lambda ps: opt.SGD(ps, 0.1),
                                _to_torch(_tree(0)))
    comm.push({"wrong": torch.ones(2)})
    with pytest.raises(RuntimeError, match="worker failed"):
        comm.flush()
    comm.stop()


@pytest.mark.parametrize("mask", [None, [True, False, True, False]])
def test_geo_sgd_sync_on_ranks_equals_the_reference(pool, mask):
    n = 4
    stacked = _tree(3, lead=(n,))
    anchor = _tree(4)
    jmesh = make_mesh(MeshConfig(dp=4, tp=2))
    jstacked = jax.tree_util.tree_map(jnp.asarray, stacked)
    jmask = None if mask is None else jnp.asarray(mask)
    with mesh_context(jmesh):
        want_s, want_a = jax.jit(lambda p, a, m: jc.geo_sgd_sync(
            p, a, participants=m, mesh=jmesh))(
            jstacked, jax.tree_util.tree_map(jnp.asarray, anchor), jmask)
    got = pool.run("geo_sgd", timeout_s=60, stacked=stacked,
                       anchor=anchor, mask=mask)
    for rank, (local, new_anchor) in enumerate(got):
        _close(new_anchor, want_a, rtol=1e-6, atol=1e-6)
        _close(local, jax.tree_util.tree_map(
            lambda x: np.asarray(x)[rank:rank + 1], want_s),
            rtol=1e-6, atol=1e-6)


def test_geo_sgd_sync_refuses_without_a_mesh():
    with pytest.raises(ValueError, match="mesh"):
        pc.geo_sgd_sync({"w": torch.zeros(1, 2)}, {"w": torch.zeros(2)})


@pytest.mark.parametrize("mask", [None, [True, False, True]])
def test_geo_sgd_communicator_equals_the_reference(mask):
    stacked, anchor = _tree(5, lead=(3,)), _tree(6)
    comm, jcomm = pc.GeoSgdCommunicator(2), jc.GeoSgdCommunicator(2)
    got = comm.sync(_to_torch(stacked), _to_torch(anchor), mask)
    want = jcomm.sync(jax.tree_util.tree_map(jnp.asarray, stacked),
                      jax.tree_util.tree_map(jnp.asarray, anchor),
                      None if mask is None else jnp.asarray(mask))
    _close(got, want, rtol=1e-6, atol=1e-6)
    _close(comm.init_anchor(_to_torch(stacked)),
           jcomm.init_anchor(stacked))


def test_geo_sgd_cadence_per_replica():
    comm = pc.GeoSgdCommunicator([1, 2])
    jcomm = jc.GeoSgdCommunicator([1, 2])
    stacked = {"w": np.array([[1.0, 1.0], [9.0, 9.0]], np.float32)}
    anchor = {"w": np.zeros((2,), np.float32)}
    s, a = _to_torch(stacked), _to_torch(anchor)
    js, ja = stacked, anchor
    for step in range(3):
        s, a = comm.maybe_sync(s, a, step)
        js, ja = jcomm.maybe_sync(js, ja, step)
        _close((s, a), (js, ja), rtol=1e-6)
    same, _ = pc.GeoSgdCommunicator(3).maybe_sync(s, a, step=0)
    assert same is s


@pytest.mark.parametrize("mask,fanin", [(None, 1),
                                        ([True, True, False], 2)])
def test_fl_aggregate_equals_the_reference(mask, fanin):
    stacked = _tree(7, lead=(3,))
    stacked["steps"] = np.array([[2], [4], [100]], np.int32)
    counts = np.array([1.0, 1.0, 2.0], np.float32)
    fl, jfl = pc.FLCommunicator(fanin), jc.FLCommunicator(fanin)
    got = fl.aggregate(_to_torch(stacked), num_examples=counts,
                       participants=mask)
    want = jfl.aggregate(jax.tree_util.tree_map(jnp.asarray, stacked),
                         num_examples=jnp.asarray(counts),
                         participants=None if mask is None
                         else jnp.asarray(mask))
    _close(got, want, rtol=1e-6, atol=1e-6)
    assert got["steps"].dtype == torch.int32 and fl.rounds == 1
    b = fl.broadcast(got, 3)
    assert b["fc"]["weight"].shape == (3, 3, 4)
    with pytest.raises(ValueError, match="fanin"):
        pc.FLCommunicator(2).aggregate(_to_torch(stacked),
                                       num_examples=counts,
                                       participants=[True, False, False])
    with pytest.raises(ValueError, match="0 examples"):
        fl.aggregate(_to_torch(stacked), num_examples=np.zeros(3))
