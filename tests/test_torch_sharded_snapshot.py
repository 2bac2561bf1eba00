"""The port's sharded snapshots (``paddle_tpu_torch/resilience/snapshot.py``:
``Shard`` leaves, ``restore(shardings=)``) in a gloo pool of CPU ranks,
against the reference's ``tests/test_resilience.py`` cases and the JAX
package's own restore:

- one copy per unique block: a dp-split leaf has one block in each
  process's file, a replicated one is written once, by process 0;
- ``restore(shardings=)`` gives each rank its own block (and allocates
  one block, not the whole leaf); a partial ``shardings`` falls back to
  whole host tensors; a round trip through ``CheckpointManager``;
- the files cross: the port's sharded save restores in the JAX package
  (whole, and onto a JAX mesh's shardings), and a JAX save sharded over
  eight devices restores in the port, per rank and whole, bit for bit.
"""

import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from paddle_tpu.core.mesh import MeshConfig, make_mesh
from paddle_tpu.resilience.snapshot import SnapshotEngine as JaxEngine
from paddle_tpu_torch.resilience.snapshot import SnapshotEngine
from torch_tp_pool import TpPool


@pytest.fixture(scope="module")
def pools():
    ps = {2: TpPool(2), 4: TpPool(4)}
    yield ps
    for p in ps.values():
        p.close()


def _leaves():
    return {"params/w": np.arange(8 * 6, dtype=np.float32).reshape(8, 6),
            "params/b": np.ones((2, 2), np.float32),
            "x": np.arange(16, dtype=np.float32),
            "step": np.asarray(3, np.int32)}


SPECS = {"params/w": ("dp", None), "params/b": (), "x": ("dp",),
         "step": None}


def _files(directory, step):
    return sorted(glob.glob(os.path.join(directory, f"step_{step:010d}",
                                         "shards_*.pkl")))


def _save(pool, n, directory, step=1, leaves=None, specs=SPECS):
    pool.run("snapshot_save", timeout_s=60, directory=str(directory),
             step=step, leaves=leaves or _leaves(), specs=specs,
             sizes={"dp": n})


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_leaves_one_copy_per_unique_shard(pools, tmp_path, n):
    _save(pools[n], n, tmp_path)
    files = _files(str(tmp_path), 1)
    assert len(files) == n
    parts = [pickle.load(open(f, "rb")) for f in files]
    # dp-split leaves: one block per process; replicated ones (spec ()):
    # written once, by the first rank that holds them
    assert [len(p["leaves"]["x"]["shards"]) for p in parts] == [1] * n
    assert [len(p["leaves"]["params/b"]["shards"]) for p in parts] == \
        [1] + [0] * (n - 1)
    idx = sorted(p["leaves"]["x"]["shards"][0][0] for p in parts)
    assert idx == [((16 // n * r, 16 // n * (r + 1)),) for r in range(n)]
    eng = SnapshotEngine(str(tmp_path))
    back = eng.restore(1)
    eng.close()
    for key, a in _leaves().items():
        node = back
        for part in key.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node.numpy(), a)


@pytest.mark.parametrize("n", [2, 4])
def test_restore_with_shardings_reads_each_ranks_block(pools, tmp_path, n):
    _save(pools[n], n, tmp_path)
    got = pools[n].run("snapshot_restore", timeout_s=60,
                       directory=str(tmp_path), step=1, specs=SPECS,
                       sizes={"dp": n})
    leaves = _leaves()
    for rank, (back, max_region) in enumerate(got):
        kind, index, block, shape = back["params/w"]
        rows = 8 // n
        assert kind == "shard" and shape == (8, 6)
        assert index == ((rank * rows, (rank + 1) * rows), (0, 6))
        np.testing.assert_array_equal(
            block, leaves["params/w"][rank * rows:(rank + 1) * rows])
        assert back["params/b"][0] == "shard"
        np.testing.assert_array_equal(back["params/b"][2], leaves["params/b"])
        assert back["step"] == ("whole", leaves["step"])
        # the largest buffer is a block (or the small replicated leaf)
        assert max_region <= leaves["params/w"].nbytes // n


def test_partial_shardings_fall_back_to_host_arrays(pools, tmp_path):
    _save(pools[2], 2, tmp_path, step=3)
    specs = {"params/w": ("dp", None), "params/b": None, "x": None,
             "step": None}
    got = pools[2].run("snapshot_restore", timeout_s=60,
                       directory=str(tmp_path), step=3, specs=specs,
                       sizes={"dp": 2})
    for back, _ in got:
        assert back["params/w"][0] == "shard"
        for key in ("params/b", "x", "step"):
            assert back[key][0] == "whole"
            np.testing.assert_array_equal(back[key][1], _leaves()[key])


def test_sharded_roundtrip_through_checkpoint_manager(pools, tmp_path):
    _save(pools[2], 2, tmp_path, step=5)
    got = pools[2].run("snapshot_restore", timeout_s=60,
                       directory=str(tmp_path), step=5, specs=SPECS,
                       sizes={"dp": 2}, manager=True)
    for rank, (back, _) in enumerate(got):
        np.testing.assert_array_equal(back["x"][2],
                                      _leaves()["x"][8 * rank:8 * (rank + 1)])


def _tree(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_port_sharded_files_restore_in_the_reference(pools, tmp_path):
    """Four processes' files (dp=4 blocks, one copy of each replicated
    leaf) restore in the JAX engine whole, and onto an 8-device mesh's
    shardings, bit for bit."""
    _save(pools[4], 4, tmp_path, step=2)
    eng = JaxEngine(str(tmp_path))
    whole = eng.restore(2)
    mesh = make_mesh(MeshConfig(dp=8))
    sh = NamedSharding(mesh, JP("dp"))
    onto = eng.restore(2, shardings={"params": {"w": sh, "b": None},
                                     "x": sh, "step": None})
    eng.close()
    for key, a in _leaves().items():
        w = whole
        o = onto
        for part in key.split("/"):
            w, o = w[part], o[part]
        np.testing.assert_array_equal(np.asarray(w), a)
        np.testing.assert_array_equal(np.asarray(o), a)
    assert onto["x"].sharding == sh


def test_reference_sharded_files_restore_in_the_port(pools, tmp_path):
    """A JAX save of leaves sharded over eight devices (one process, a
    block per device, the replicated leaf once) restores per rank with
    ``shardings=`` (dp=2 blocks stitched from four stored blocks each)
    and whole, bit for bit."""
    mesh = make_mesh(MeshConfig(dp=8))
    sh, repl = NamedSharding(mesh, JP("dp")), NamedSharding(mesh, JP())
    leaves = _leaves()
    state = _tree({"params/w": jax.device_put(leaves["params/w"], sh),
                   "params/b": jax.device_put(leaves["params/b"], repl),
                   "x": jax.device_put(leaves["x"], sh),
                   "step": jnp.asarray(leaves["step"])})
    eng = JaxEngine(str(tmp_path))
    eng.save(4, state, wait=True)
    eng.close()
    got = pools[2].run("snapshot_restore", timeout_s=60,
                       directory=str(tmp_path), step=4, specs=SPECS,
                       sizes={"dp": 2})
    for rank, (back, _) in enumerate(got):
        np.testing.assert_array_equal(back["x"][2],
                                      leaves["x"][8 * rank:8 * (rank + 1)])
        np.testing.assert_array_equal(back["params/w"][2],
                                      leaves["params/w"][4 * rank:
                                                         4 * (rank + 1)])
    port = SnapshotEngine(str(tmp_path))
    whole = port.restore(4)
    port.close()
    np.testing.assert_array_equal(whole["params"]["w"].numpy(),
                                  leaves["params/w"])
    np.testing.assert_array_equal(whole["x"].numpy(), leaves["x"])
