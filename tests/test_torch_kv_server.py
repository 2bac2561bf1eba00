"""The port's pserver (``paddle_tpu_torch.parallel.kv_server`` over its own
``native/kv_server.cc``): an in-process server equals a local store
exactly, the wire is the reference's (a JAX-side ``RemoteKVStore`` on a
port server and the other way round), stop with a live client does not
hang, a server process serves ``python -m`` clients, and ``PSMonitor``
detects a killed server."""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest

from paddle_tpu.parallel import kv_server as jax_srv
from paddle_tpu.parallel.host_kv import HostKVStore as JaxStore
from paddle_tpu_torch.parallel import kv_server as srv_lib
from paddle_tpu_torch.parallel.host_kv import HostKVEmbedding, HostKVStore
from paddle_tpu_torch.parallel.kv_server import (KVServer, PSMonitor,
                                                 RemoteKVStore)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _ops(store, rng, dim, rounds=5):
    for _ in range(rounds):
        ids = np.unique(rng.integers(0, 50, size=(8,))).astype(np.int64)
        g = rng.normal(size=(ids.size, dim)).astype(np.float32)
        store.push(ids, g, lr=0.1)
        store.push(ids, g, lr=0.1, wait=False)
        store.flush()
    store.set_rows(np.array([3], np.int64), np.full((1, dim), 2.5,
                                                    np.float32))


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_in_process_server_matches_a_local_store_exactly(optimizer):
    srv = KVServer(3, optimizer=optimizer, init_scale=0.05, seed=7)
    remote = RemoteKVStore("localhost", srv.port)
    local = HostKVStore(3, optimizer=optimizer, init_scale=0.05, seed=7)
    assert remote.dim == 3
    for store in (remote, local):
        _ops(store, np.random.default_rng(0), 3)
    every = np.arange(50, dtype=np.int64)
    np.testing.assert_array_equal(remote.pull(every), local.pull(every))
    assert len(remote) == len(local)
    out = np.zeros((64, 3), np.float32)
    assert remote.pull_async(every, out=out).wait() is out
    np.testing.assert_array_equal(out[:50], local.pull(every))
    rows = remote.pull(np.array([5, 6], np.int64))
    rows[0, 0] = 42.0                   # writable, as a local pull's
    remote.close()
    srv.stop()


@pytest.mark.parametrize("server", ["port", "reference"])
def test_a_client_of_one_package_serves_from_the_others_server(
        server, tmp_path):
    """The wire is the reference's: pulls, pushes, set_rows, size, dim,
    save and load across the packages, the bits of a local store."""
    dim = 4
    if server == "port":
        srv = KVServer(dim, optimizer="adagrad", init_scale=0.05, seed=2)
        client = jax_srv.RemoteKVStore("localhost", srv.port)
    else:
        srv = jax_srv.KVServer(dim, optimizer="adagrad", init_scale=0.05,
                               seed=2)
        client = RemoteKVStore("localhost", srv.port)
    local = JaxStore(dim, optimizer="adagrad", init_scale=0.05, seed=2)
    assert client.dim == dim
    for store in (client, local):
        _ops(store, np.random.default_rng(1), dim)
    every = np.arange(50, dtype=np.int64)
    np.testing.assert_array_equal(client.pull(every), local.pull(every))
    path = str(tmp_path / "remote.kv")
    client.save(path)
    fresh = HostKVStore(dim, optimizer="adagrad", seed=99)
    fresh.load(path)
    np.testing.assert_array_equal(fresh.pull(every), local.pull(every))
    client.load(path)
    assert len(client) == len(local)
    client.close()
    srv.stop()


def test_engine_and_training_run_against_a_remote_store():
    from paddle_tpu_torch import embedding_serving as es
    from paddle_tpu_torch import observability as obs
    srv = KVServer(3, optimizer="sgd", init_scale=0.1, seed=0)
    remote = RemoteKVStore("localhost", srv.port)
    local = HostKVStore(3, optimizer="sgd", init_scale=0.1, seed=0)
    ids = np.random.default_rng(2).integers(0, 30, size=(4, 6))
    outs = [es.EmbeddingServingEngine(s, capacity=32, min_bucket=8,
                                      registry=obs.MetricsRegistry(),
                                      device="cpu").serve(ids)
            for s in (remote, local)]
    np.testing.assert_array_equal(outs[0], outs[1])
    emb = HostKVEmbedding(remote, lr=0.5, min_bucket=8)
    sb = emb.prefetch_batch(ids).wait()
    emb.apply_grads(sb, np.ones_like(sb.rows), wait=False)
    emb.flush()
    np.testing.assert_allclose(remote.pull(np.unique(ids)),
                               local.pull(np.unique(ids)) - 0.5, rtol=1e-6)
    remote.close()
    srv.stop()


def test_stop_with_a_live_client_does_not_hang():
    srv = KVServer(2, optimizer="sgd")
    c = RemoteKVStore("localhost", srv.port)
    c.pull(np.array([1], np.int64))     # connection alive and idle
    done = threading.Event()
    t = threading.Thread(target=lambda: (srv.stop(), done.set()))
    t.start()
    assert done.wait(timeout=20), "server stop hung with a live client"
    t.join(timeout=5)
    assert not t.is_alive()
    srv.stop()                          # idempotent
    c.close()


def test_stop_is_safe_when_the_library_fails_to_load(monkeypatch):
    def boom():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(srv_lib, "_lib", boom)
    with pytest.raises(RuntimeError, match="no compiler"):
        KVServer(4)
    obj = KVServer.__new__(KVServer)
    obj.stop()
    obj.__del__()


def _spawn_pserver(dim):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.parallel.kv_server",
         "--dim", str(dim), "--port", "0", "--optimizer", "sgd",
         "--init-scale", "0.0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    line = proc.stdout.readline().strip()
    assert line.startswith("PORT "), line
    return proc, int(line.split()[1])


def test_a_server_process_serves_clients_and_a_monitor_sees_it_die():
    proc, port = _spawn_pserver(2)
    lost = threading.Event()
    try:
        for i in range(3):              # client churn
            c = RemoteKVStore("localhost", port)
            c.push(np.array([i], np.int64), np.ones((1, 2), np.float32),
                   lr=1.0)
            c.close()
        store = RemoteKVStore("localhost", port)
        assert len(store) == 3
        np.testing.assert_array_equal(store.pull(np.arange(3)), -1.0)
        monitor = PSMonitor(store, check_every_s=0.2, misses=2,
                            on_lost=lost.set, log_fn=lambda *_: None)
        assert store.ping() and not monitor.lost.is_set()
        proc.kill()
        proc.wait(timeout=30)
        assert monitor.lost.wait(timeout=10), "the monitor missed the death"
        assert lost.is_set() and not store.ping(timeout=0.5)
        monitor.stop()
        with pytest.raises(OSError):
            store.pull(np.arange(3))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
