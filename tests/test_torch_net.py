"""The port's network serving tier (PTNW v1, ``paddle_tpu_torch.serving.
fleet.net``) held against the JAX package's on the CPU: the two encoders
write the same bytes for the same payloads under both codecs; each
package's ``MessageDecoder`` reads the other's frames, and corrupt frames
raise ``WireError``; an in-thread port ``ReplicaServer`` driven by the
JAX ``NetReplica``, and a JAX server driven by the port's, over fp32 and
int8 pools, serve the tokens of an undisturbed engine through submit,
step, progress, result, snapshot and restore, with errors rebuilt as the
client package's own types; the ``FrontDoor`` streams partial deliveries
and sheds a slow reader with a typed reject. The subprocess legs (a real
``kill -9`` and a SIGTERM drain) are marked ``slow``, as the reference
marks its own."""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from paddle_tpu.serving import LoadShedError as JaxLoadShedError
from paddle_tpu.serving.fleet import net as jax_net
from paddle_tpu.serving.fleet.net import wire as jax_wire
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.resilience.preempt import EXIT_DRAINED
from paddle_tpu_torch.resilience.retry import RetryPolicy
from paddle_tpu_torch.serving import LoadShedError, Reject
from paddle_tpu_torch.serving import fleet
from paddle_tpu_torch.serving.fleet import net
from paddle_tpu_torch.serving.fleet.net import wire
from paddle_tpu_torch.serving.fleet.router import TRANSPORT_ERRORS
from torch_fleet_pairs import DIMS, PACKAGES, VOCAB, Pair

CODECS = ["json"] + (["msgpack"] if wire.msgpack is not None else [])
NET_GEOM = dict(num_slots=2, page_size=4, max_tokens_per_slot=48,
                prefill_chunk=4, decode_block=2)
WIRES = {"jax": jax_wire, "port": wire}
NETS = {"jax": jax_net, "port": net}
FAST_RETRY = RetryPolicy(max_attempts=2, base_delay_s=0.02,
                         max_delay_s=0.1, deadline_s=2.0,
                         retry_on=(OSError, TimeoutError))
JAX_FAST_RETRY = JaxRetryPolicy(max_attempts=2, base_delay_s=0.02,
                                max_delay_s=0.1, deadline_s=2.0,
                                retry_on=(OSError, TimeoutError))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def payload(pkg):
    return {
        "arr": np.arange(6, dtype=np.float32).reshape(2, 3),
        "ids": np.array([3, 1, 4], dtype=np.int32),
        "q8": (np.arange(-4, 4, dtype=np.int8).reshape(2, 4),
               np.ones((2,), np.float32)),
        "bits": np.array([0x3F80, 0xBF80], dtype=np.uint16),
        "blob": b"\x00\xff\x10page",
        "tup": (1, "a", (2.5, None)),
        "intmap": {3: [1, 2], 7: []},
        "reserved": {"__buf__like": 1},
        "aset": {3, 1, 2},
        "replay": PACKAGES[pkg][1].FullReplay([5, 6, 7]),
        "none": None, "flag": True, "f": 1.5,
    }


@pytest.mark.parametrize("codec", CODECS)
def test_encoders_write_the_reference_bytes(codec):
    want = jax_wire.encode_message(payload("jax"), codec=codec)
    assert wire.encode_message(payload("port"), codec=codec) == want
    rej = Reject("slow_reader", "batch", 3, 1.0, 0.5)
    assert wire.encode_message(wire.error_to_wire(LoadShedError(rej)),
                               codec=codec) == jax_wire.encode_message(
        jax_wire.error_to_wire(JaxLoadShedError(
            jax_wire.reject_from_wire(wire.reject_to_wire(rej)))),
        codec=codec)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_each_decoder_reads_the_other_packages_frames(codec, src, dst):
    data = WIRES[src].encode_message(payload(src), codec=codec)
    dec = WIRES[dst].MessageDecoder()
    out = []
    for i in range(0, len(data), 7):          # torn reads
        out.extend(dec.feed(data[i:i + 7]))
    [got] = out
    want = payload(dst)
    for k in ("arr", "ids", "bits"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    assert isinstance(got["q8"], tuple)
    np.testing.assert_array_equal(got["q8"][0], want["q8"][0])
    assert got["tup"] == want["tup"] and isinstance(got["tup"], tuple)
    assert got["intmap"] == want["intmap"] and set(got["intmap"]) == {3, 7}
    assert got["aset"] == frozenset({1, 2, 3})
    assert isinstance(got["replay"], PACKAGES[dst][1].FullReplay)
    assert list(got["replay"]) == [5, 6, 7]
    assert {k: got[k] for k in ("blob", "reserved", "none", "flag", "f")} \
        == {k: want[k] for k in ("blob", "reserved", "none", "flag", "f")}


def _corrupt_checksum():
    msg = bytearray(wire.encode_message(
        {"snap": np.arange(32, dtype=np.float32)}))
    msg[-1] ^= 0xFF
    return bytes(msg), {}, "checksum"


def _bad_magic():
    return b"HTTP/1.1 200 OK\r\n\r\n", {}, "magic"


def _oversized():
    return (wire.encode_message({"big": "x" * 1024}),
            {"max_frame_bytes": 64}, "exceeds")


def _binary_first():
    msg = wire.encode_message({"x": np.ones(4, np.int32)})
    head = wire._HEADER.unpack_from(msg)
    return msg[wire.HEADER_BYTES + head[3]:], {}, "no envelope"


def _bad_version():
    msg = bytearray(wire.encode_message({"n": 1}))
    msg[4] = 2
    return bytes(msg), {}, "version"


@pytest.mark.parametrize("case", [_corrupt_checksum, _bad_magic,
                                  _oversized, _binary_first, _bad_version],
                         ids=["checksum", "magic", "bound", "no_envelope",
                              "version"])
def test_corrupt_frames_raise_wire_error(case):
    data, kw, match = case()
    for w in (wire, jax_wire):
        with pytest.raises(w.WireError, match=match):
            w.MessageDecoder(**kw).feed(data)
    assert issubclass(wire.WireError, ConnectionError)
    assert issubclass(wire.WireError, TRANSPORT_ERRORS)


def test_errors_cross_as_the_receiving_packages_types():
    rej = Reject("queue_full", "interactive", 7, 0.25, 1.5)
    err = jax_wire.error_from_wire(wire.error_to_wire(LoadShedError(rej)))
    assert isinstance(err, JaxLoadShedError) and err.reject.reason == \
        "queue_full"
    from paddle_tpu_torch.serving.fleet import ReplicaCrashed
    from paddle_tpu_torch.serving.engine import SlotMigrationError
    from paddle_tpu.serving.fleet import ReplicaCrashed as JaxCrashed
    for exc, want in ((JaxCrashed("gone"), ReplicaCrashed),
                      (jax_wire.SlotMigrationError("full"),
                       SlotMigrationError),
                      (JaxLoadShedError(jax_wire.reject_from_wire(
                          wire.reject_to_wire(rej))), LoadShedError)):
        got = wire.error_from_wire(jax_wire.error_to_wire(exc))
        assert type(got) is want


class ServerHarness:
    """A ReplicaServer of either package served from a plain thread."""

    def __init__(self, pkg, engine, **kw):
        self.srv = NETS[pkg].ReplicaServer(engine, **kw)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self.srv.serve_step(0.02)

    @property
    def address(self):
        return self.srv.address

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        self.srv.close()


def _net_prompts(n, seed=0, lens=(3, 5, 7)):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, int(k)).astype(np.int32)
            for k in rng.choice(lens, n)]


def _pool(pkg, dtype):
    if dtype == "fp32":
        return {}
    return {"cache_dtype": torch.int8 if pkg == "port" else np.int8}


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("server,client", [("port", "jax"),
                                           ("jax", "port")])
def test_a_client_of_one_package_drives_a_server_of_the_other(
        pair, server, client, dtype):
    ps = _net_prompts(3, seed=1)
    ref = pair.port_engine(**NET_GEOM, **_pool("port", dtype))
    want = ref.generate_many(ps, 8)
    eng = pair.engine(server, **NET_GEOM, **_pool(server, dtype))
    harness = ServerHarness(server, eng, name=f"{server}srv")
    retry = FAST_RETRY if client == "port" else JAX_FAST_RETRY
    rep = NETS[client].NetReplica(harness.address, retry=retry)
    try:
        assert rep.page_size() == 4 and rep.name == f"{server}srv"
        rep.warmup()
        rids = [rep.submit(p, 8) for p in ps]
        done = {}
        for _ in range(300):           # until a request is mid-decode
            done.update(rep.step())
            prog = rep.progress()
            if any(0 < len(v) < 8 for v in prog.values()):
                break
        assert prog and all(isinstance(k, int) for k in prog)
        # the progress cursor: only the tail past ``since`` comes back
        since = {r: len(v) for r, v in prog.items()}
        # migrate every live slot out and back in through the socket
        snaps = rep.snapshot_inflight()
        assert snaps and all(s["trace_id"] == 0 for _, s in snaps)
        back = {rep.restore(snap): old for old, snap in snaps}
        tail = rep.progress({new: since.get(old, 0)
                             for new, old in back.items()})
        assert all(len(v) == 0 for v in tail.values())
        for _ in range(300):
            for r, toks in rep.step().items():
                done[back.get(r, r)] = toks
            if all(r in done for r in rids):
                break
        got = [np.asarray(done[r]) for r in rids]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert rep.result(rids[0]) is None        # consumed by step()
        stats = rep.request_stats(rids[-1])
        assert stats is None or stats["tokens"] == 8.0
        # a remote shed arrives as the client package's own type
        rep.submit(ps[0], 40)
        with pytest.raises(ValueError):
            rep.submit(ps[0], 60)                 # past the slot's cap
    finally:
        rep.close()
        harness.stop()


def _door(pair, **kw):
    eng = pair.port_engine(**NET_GEOM)
    eng.warmup()
    rep = fleet.LocalReplica(eng, name="doorrep")
    return net.FrontDoor(fleet.FleetRouter(
        [rep], registry=obs.MetricsRegistry()), **kw)


def test_front_door_streams_partials_and_its_netlog_validates(pair,
                                                              tmp_path):
    log = str(tmp_path / "door.netlog.jsonl")
    door = _door(pair, netlog_path=log).start()
    try:
        results = []
        for i in range(2):
            cli = net.FrontDoorClient(door.address)
            try:
                results.append(cli.generate(
                    _net_prompts(1, seed=10 + i)[0], 24, tag=f"t{i}",
                    timeout_s=60.0))
            finally:
                cli.close()
    finally:
        door.close()
    for r in results:
        assert r["reject"] is None and len(r["tokens"]) == 24
        assert r["partials"] >= 2, "buffered, not streamed"
        assert r["streamed"] == r["tokens"][:len(r["streamed"])]
        assert r["ttft_s"] is not None
    for n in (net, jax_net):
        summary = n.validate_netlog_file(log, require_requests=2)
        assert summary["accepted_requests"] == summary["finished"] == 2
        assert summary["stream"] >= 4 and summary["shed"] == 0


def test_front_door_sheds_a_slow_reader_with_a_typed_reject(pair,
                                                            tmp_path):
    log = str(tmp_path / "slow.netlog.jsonl")
    door = _door(pair, netlog_path=log, max_buffer_frames=2)
    cli = net.FrontDoorClient(door.address)
    try:
        cli.send_generate(_net_prompts(1, seed=20)[0], 24)
        for _ in range(200):
            door.pump()
            if door.accepted_total == 1:
                break
        assert door.accepted_total == 1
        conn = next(iter(door._conns.values()))
        real_sock = conn.sock

        class PluggedPipe:
            """A reader that stopped draining: every send blocks."""

            def send(self, _buf):
                raise BlockingIOError

            def __getattr__(self, item):
                return getattr(real_sock, item)

        conn.sock = PluggedPipe()
        for _ in range(500):
            door.pump()
            if door.shed_total >= 1:
                break
        assert door.shed_total >= 1 and conn.closing
        conn.sock = real_sock
        for _ in range(50):
            door.pump()
            if conn.sock not in door._conns:
                break
        ev = cli.next_event(timeout=5.0)
        while ev.get("event") != "reject":
            ev = cli.next_event(timeout=5.0)
        assert ev["reason"] == "slow_reader"
        rej = wire.reject_from_wire(ev["reject"])
        assert rej.reason == "slow_reader" and rej.retry_after_s > 0
        # the JAX package reads the same verdict
        assert jax_wire.reject_from_wire(ev["reject"]).reason == \
            "slow_reader"
    finally:
        cli.close()
        door.close()
    assert net.validate_netlog_file(log, require_requests=1)["shed"] == 1


SUBPROC_CONFIG = dict(DIMS)
SUBPROC_ENGINE = dict(NET_GEOM)


@pytest.mark.slow
def test_kill9_ejects_and_redrives_bit_identical():
    spawned = [net.spawn_replica_server(
        config=SUBPROC_CONFIG, engine=SUBPROC_ENGINE, seed=0,
        name=f"proc{i}", warmup=False, device="cpu") for i in range(2)]
    procs = [p for p, _ in spawned]
    try:
        reps = [net.NetReplica(addr, name=f"proc{i}", retry=FAST_RETRY)
                for i, (_p, addr) in enumerate(spawned)]
        # the two processes built the same weights from the same seed
        assert reps[0].remote_weights == reps[1].remote_weights
        from paddle_tpu_torch.models.gpt import GPT, GPTConfig
        local = GPT(GPTConfig.tiny(**SUBPROC_CONFIG), device="cpu", seed=0)
        assert reps[0].remote_weights == \
            net.replica_server.weights_digest(local)
        fpol = fleet.FaultPolicy(max_consecutive_failures=3,
                                 probe_timeout_s=120.0, breaker_threshold=2,
                                 breaker_cooldown_s=0.2, max_redrives=3)
        router = fleet.FleetRouter(reps, seed=11, faults=fpol,
                                   registry=obs.MetricsRegistry())
        ps = _net_prompts(6, seed=4)
        clean_frids = [router.submit(p, 8) for p in ps]
        clean = router.run_until_idle(max_steps=5000)
        ref = [np.asarray(clean[f]) for f in clean_frids]
        frids = [router.submit(p, 8) for p in ps]
        victim = reps[0]
        if not any(router._where[f][0] is victim for f in frids):
            victim = reps[1]
        victim_frids = [f for f in frids if router._where[f][0] is victim]
        done = {}
        for _ in range(200):
            done.update(router.step())
            if any(router.progress(f) for f in victim_frids
                   if f not in done):
                break
        vproc = procs[reps.index(victim)]
        os.kill(vproc.pid, signal.SIGKILL)
        vproc.wait(timeout=30)
        done.update(router.run_until_idle(max_steps=10_000))
        assert [f for f in frids if f not in done] == []
        assert router.ejected_total >= 1 and router.redrives_total >= 1
        for f, r in zip(frids, ref):
            np.testing.assert_array_equal(np.asarray(done[f]), r)
        for rep in reps:
            rep.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.slow
def test_sigterm_drains_to_exit_drained():
    proc, addr = net.spawn_replica_server(
        config=SUBPROC_CONFIG, engine=SUBPROC_ENGINE, seed=0,
        name="drainer", warmup=False, device="cpu")
    try:
        rep = net.NetReplica(addr, name="drainer")
        rid = rep.submit(np.array([1, 2, 3, 4], np.int32), 6)
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 60
        while not rep.draining and time.monotonic() < deadline:
            rep.health()
            time.sleep(0.02)
        assert rep.draining
        with pytest.raises(fleet.ReplicaUnavailable):
            rep.submit(np.array([5, 6], np.int32), 4)
        done = {}
        while rid not in done and time.monotonic() < deadline:
            done.update(rep.step())
        assert len(done[rid]) == 6
        rep.close()
        proc.wait(timeout=60)
        assert proc.returncode == EXIT_DRAINED
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
