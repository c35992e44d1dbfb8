"""The port's network front door against the JAX package's, mirroring
tests/test_serve_net.py: the NDJSON encoding byte for byte, a JAX client
against the port's endpoint and the port's client against JAX's on the same
converted weights, NetConfig and the net scenarios field for field, and the
front door's robustness contracts over real loopback sockets on a tiny
handle on the CPU — wire conservation, the bad request, slow-loris reaping,
the quiet idle close, kill-endpoint with and without the supervisor, and
the zero-failed hot swap.

Every wire count is read through ``scenarios.settled_wire_delta``: a
handler records a request's outcome a moment after its client has read
the reply, so a count read at once can be one short."""

import dataclasses
import json
import socket
import socketserver
import threading
import time

import jax
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.config import NetConfig as JaxNetConfig
from parallel_cnn_tpu.config import ServeConfig as JaxServeConfig
from parallel_cnn_tpu.resilience import retry as jax_retry
from parallel_cnn_tpu.serve import loadgen as jax_loadgen
from parallel_cnn_tpu.serve import net as jax_net
from parallel_cnn_tpu.serve import registry as jax_registry
from parallel_cnn_tpu.serve import scenarios as jax_scenarios
from parallel_cnn_tpu.serve import serve_stack as jax_serve_stack
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.config import NetConfig, ObsConfig, ServeConfig
from parallel_cnn_tpu_torch.nn import Dense, Flatten, Sequential
from parallel_cnn_tpu_torch.obs.registry import MetricsRegistry
from parallel_cnn_tpu_torch.resilience import retry
from parallel_cnn_tpu_torch.resilience.chaos import ChaosMonkey
from parallel_cnn_tpu_torch.resilience.retry import RetryPolicy
from parallel_cnn_tpu_torch.serve import (
    NET_SCENARIOS,
    ModelHandle,
    NetServer,
    ReplicaPool,
    Supervisor,
    WireStats,
    armed_factory,
    get,
    hot_swap,
    load_or_init,
    scenarios,
    serve_stack,
)
from parallel_cnn_tpu_torch.serve.loadgen import (
    NetClient,
    NetTransportError,
    run_closed_loop_net,
)
from parallel_cnn_tpu_torch.serve import net as port_net
from parallel_cnn_tpu_torch.serve.net import encode_request

pytestmark = pytest.mark.serve_net

IN_SHAPE = (4, 3)


def _tiny_build(generator):
    return Sequential(Flatten(), Dense(12, 8, generator=generator)).eval()


TINY = ModelHandle("tiny", IN_SHAPE, 8, _tiny_build)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(**kw):
    return ServeConfig(**{"max_batch": 8, "queue_depth": 64, "max_wait_ms": 2.0,
                          "precompile": False, **kw})


@pytest.fixture
def stack():
    """A started (pool, batcher) on the CPU, closed at teardown."""
    pool, batcher = serve_stack(TINY, _cfg(), device="cpu")
    yield pool, batcher
    batcher.close()


def _server(batcher, **kw):
    kw.setdefault("conn_deadline_ms", 1000.0)
    return NetServer(batcher, **kw).start()


def _settled(wire):
    """The wire's counts once they balance (within the helper's deadline)."""
    delta, balanced = scenarios.settled_wire_delta(wire, {})
    assert balanced, delta
    return delta


# ---------------------------------------------------------------------------
# the protocol, the config and the specs against JAX's


@pytest.mark.parametrize("deadline_ms,priority", [
    (None, None), (250.0, None), (None, "best-effort"), (12.5, "guaranteed")])
def test_encode_request_equals_jax(deadline_ms, priority):
    rng = np.random.default_rng(3)
    for rid, shape in enumerate([IN_SHAPE, (28, 28), (32, 32, 3)]):
        x = rng.standard_normal(shape).astype(np.float32)
        line = encode_request(rid, x, deadline_ms, priority)
        assert line == jax_net.encode_request(rid, x, deadline_ms, priority)
        req = json.loads(line)
        assert np.asarray(req["x"], np.float32).view(np.uint32).tobytes() \
            == x.view(np.uint32).tobytes()


def test_json_round_trip_of_x_is_bit_exact():
    """x.tolist() → JSON → np.asarray(float32) keeps every bit, at the
    edges of float32 too (subnormals, the largest finite, -0.0)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 3072, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    x = np.where(np.isfinite(x), x, np.float32(1.5))
    x[:6] = [np.finfo(np.float32).max, np.finfo(np.float32).smallest_subnormal,
             -0.0, np.finfo(np.float32).tiny, -np.finfo(np.float32).eps, 1 / 3]
    back = np.asarray(json.loads(encode_request(7, x))["x"], np.float32)
    assert back.view(np.uint32).tobytes() == x.view(np.uint32).tobytes()


NET_ENV = {"PCNN_SERVE_LISTEN": "1", "PCNN_SERVE_HOST": "0.0.0.0",
           "PCNN_SERVE_PORT": "8123", "PCNN_SERVE_CONN_DEADLINE_MS": "750",
           "PCNN_SERVE_AOT_CACHE_DIR": "/tmp/x", "PCNN_SERVE_SUPERVISE": "true",
           "PCNN_SERVE_RESPAWN_ATTEMPTS": "7",
           "PCNN_SERVE_RESPAWN_BASE_DELAY_S": "0.2",
           "PCNN_SERVE_RESPAWN_MAX_DELAY_S": "3"}


@pytest.mark.parametrize("names", [(), ("PCNN_SERVE_PORT", "PCNN_SERVE_SUPERVISE"),
                                   tuple(NET_ENV)])
def test_net_config_env_layering_equals_jax(monkeypatch, names):
    for k in names:
        monkeypatch.setenv(k, NET_ENV[k])
    port, ref = NetConfig.from_env(), JaxNetConfig.from_env()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(NetConfig)] == [
        f.name for f in dataclasses.fields(JaxNetConfig)]


@pytest.mark.parametrize("bad", [
    {"port": 70000}, {"port": -1}, {"conn_deadline_ms": 0.0},
    {"respawn_attempts": 0}, {"respawn_base_delay_s": -0.1},
    {"respawn_max_delay_s": -1.0}])
def test_net_config_validation_equals_jax(bad):
    with pytest.raises(ValueError) as port:
        NetConfig(**bad)
    with pytest.raises(ValueError) as ref:
        JaxNetConfig(**bad)
    assert str(port.value) == str(ref.value)


def test_net_scenarios_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in NET_SCENARIOS.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_scenarios.NET_SCENARIOS.items()}
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    for spec in NET_SCENARIOS.values():
        if spec.phases:
            assert scenarios._phase_offsets(spec.phases, rng_a) == \
                jax_scenarios._phase_offsets(spec.phases, rng_b)


@pytest.mark.parametrize("seed,rank", [(0, 0), (0, 3), (11, 5)])
def test_decorrelated_retry_equals_jax(seed, rank):
    kw = dict(attempts=6, base_delay=0.01, max_delay=0.5, seed=seed)
    port = RetryPolicy(**kw).decorrelated(rank)
    ref = jax_retry.RetryPolicy(**kw).decorrelated(rank)
    assert list(port.delays()) == list(ref.delays())
    slept = {"port": [], "ref": []}
    for key, mod in (("port", retry), ("ref", jax_retry)):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("refused")
            return len(calls)

        assert mod.retry_call(flaky, policy=mod.RetryPolicy(**kw), retry_on=(OSError,),
                              sleep=slept[key].append) == 3
    assert slept["port"] == slept["ref"]
    with pytest.raises(ValueError):
        RetryPolicy().decorrelated(-1)


# ---------------------------------------------------------------------------
# a JAX client against the port's endpoint, and the port's against JAX's


@pytest.fixture(scope="module")
def lenet_pair(tmp_path_factory):
    """lenet_ref served by both packages from one JAX-written checkpoint
    (the port reads it through convert.py): (port batcher, JAX batcher)."""
    handle = jax_registry.get("lenet_ref")
    params = jax.tree_util.tree_map(np.asarray, handle.init(jax.random.key(0))[0])
    path = str(tmp_path_factory.mktemp("lenet") / "lenet.npz")
    jax_checkpoint.save(path, params)
    _, port = serve_stack(get("lenet_ref"), _cfg(model="lenet_ref", checkpoint=path,
                                                max_batch=4), device="cpu")
    _, ref = jax_serve_stack(
        handle, JaxServeConfig(model="lenet_ref", checkpoint=path, max_batch=4,
                               precompile=False),
        devices=jax.devices()[:1])
    yield port, ref
    port.close()
    ref.close()


@pytest.mark.parametrize("direction", ["jax client, port server",
                                       "port client, jax server"])
def test_cross_framework_wire_round_trip(lenet_pair, direction):
    port_batcher, jax_batcher = lenet_pair
    xs = np.random.default_rng(5).uniform(0, 1, (6, 28, 28)).astype(np.float32)
    port_first = direction.startswith("jax")
    server_cls = NetServer if port_first else jax_net.NetServer
    client_cls = jax_loadgen.NetClient if port_first else NetClient
    batcher = port_batcher if port_first else jax_batcher
    wire = (WireStats if port_first else jax_net.WireStats)()
    with server_cls(batcher, conn_deadline_ms=5000.0, wire=wire).start() as srv:
        with client_cls(srv.address, timeout_s=30.0) as nc:
            got = np.stack([nc.request(x, deadline_ms=5000.0 if i % 2 else None)
                            for i, x in enumerate(xs)])
        delta, balanced = scenarios.settled_wire_delta(wire, {})
    assert balanced and delta["completed"] == 6
    # The other package's server on the same rows, in process.
    other = jax_batcher if port_first else port_batcher
    want = np.stack([other.submit(x).result(timeout=30) for x in xs])
    assert got.shape == (6, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# the front door's contracts (tests/test_serve_net.py on the port)


def test_round_trip_and_wire_conservation(stack):
    _, batcher = stack
    wire = WireStats()
    registry = MetricsRegistry()
    wire.attach_registry(registry)
    with _server(batcher, wire=wire) as srv:
        with NetClient(srv.address, timeout_s=10.0) as nc:
            y = nc.request(np.zeros(IN_SHAPE, np.float32))
            assert y.shape == (8,)
            # An explicit deadline rides the guaranteed class; without one
            # best-effort — both resolve as completed.
            nc.request(np.ones(IN_SHAPE, np.float32), deadline_ms=2000.0)
        snap = _settled(wire)
    assert snap["submitted"] == 2 == snap["completed"]
    assert snap["conn_opened"] == 1
    assert registry.json_snapshot()["collected"]["wire"] == wire.snapshot()


def test_wire_journal_balances_with_net_prefix(stack, tmp_path):
    _, batcher = stack
    bundle = obs_lib.from_config(ObsConfig(trace=True, dir=str(tmp_path)), run="net")
    wire = WireStats()
    with _server(batcher, wire=wire, obs=bundle) as srv:
        run_closed_loop_net(srv.address, np.zeros((4, *IN_SHAPE), np.float32),
                            n_requests=12, concurrency=3, seed=0)
        _settled(wire)
    counts = bundle.journal.counts()
    bundle.finish()
    assert counts["net_submit"] == counts["net_complete"] == 12
    assert obs_lib.conservation(counts, prefix="net_") is None
    assert counts["conn_open"] == 3


def test_bad_request_is_failed_not_crash(stack):
    _, batcher = stack
    wire = WireStats()
    with _server(batcher, wire=wire) as srv:
        s = socket.create_connection(srv.address, timeout=5.0)
        try:
            f = s.makefile()
            for bad in (b'{"id": 1, "nope": true}\n', b"not json\n",
                        b'{"id": 3, "x": [1.0, 2.0]}\n'):
                s.sendall(bad)
                reply = json.loads(f.readline())
                assert reply["ok"] is False and reply["error"] == "BadRequest"
            # The connection survives a bad request; a good one follows.
            s.sendall(encode_request(2, np.zeros(IN_SHAPE, np.float32)))
            reply = json.loads(f.readline())
            assert reply["ok"] is True and reply["id"] == 2
        finally:
            s.close()
        snap = _settled(wire)
    assert snap["failed"] == 3 and snap["completed"] == 1


def test_closed_loop_net_conservation(stack):
    _, batcher = stack
    wire = WireStats()
    with _server(batcher, wire=wire) as srv:
        rep = run_closed_loop_net(
            srv.address, np.zeros((4, *IN_SHAPE), np.float32),
            n_requests=32, concurrency=4, seed=0,
        )
        snap = _settled(wire)
    assert rep.completed == 32 and rep.errors == 0
    assert rep.latency.summary()["count"] == 32
    assert snap["submitted"] == 32


def test_slow_loris_reaped_as_expired(stack):
    _, batcher = stack
    wire = WireStats()
    with _server(batcher, wire=wire, conn_deadline_ms=150.0) as srv:
        chaos = ChaosMonkey.from_spec("slow-loris@3:400")
        rep = run_closed_loop_net(
            srv.address, np.zeros((2, *IN_SHAPE), np.float32),
            n_requests=16, concurrency=2, seed=0, chaos=chaos,
        )
        assert chaos.slow_loris_fired
        assert rep.expired == 1          # the loris victim, client view
        assert rep.completed == 15
        snap = _settled(wire)
        assert snap["reaped"] == 1 == snap["expired"]
        # Not hung: the endpoint still answers promptly after the reap.
        with NetClient(srv.address, timeout_s=5.0) as nc:
            t0 = time.monotonic()
            nc.request(np.zeros(IN_SHAPE, np.float32))
            assert time.monotonic() - t0 < 5.0


def test_idle_connection_closes_quietly(stack):
    """An idle keep-alive gap is not an attack: a timeout with an empty
    buffer closes the connection without touching the conservation sum."""
    _, batcher = stack
    wire = WireStats()
    with _server(batcher, wire=wire, conn_deadline_ms=100.0) as srv:
        s = socket.create_connection(srv.address, timeout=5.0)
        try:
            assert s.recv(1) == b""      # the server closed on the idle timeout
        finally:
            s.close()
        deadline = time.monotonic() + 5.0
        while wire.snapshot()["conn_closed"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        snap = wire.snapshot()
    assert snap["submitted"] == 0 and snap["reaped"] == 0


def test_listener_holds_a_burst_of_connects_before_it_accepts():
    """32 clients connect at once while nothing accepts (as when the
    accepting thread waits on the interpreter lock): the listen backlog
    holds them all, so none waits out a 1 s SYN retransmit. At
    socketserver's default backlog of 5 the 7th connect times out."""
    tcp = port_net._TcpServer(("127.0.0.1", 0), socketserver.BaseRequestHandler)
    socks = []
    try:
        for _ in range(32):
            socks.append(socket.create_connection(tcp.server_address, timeout=0.5))
    finally:
        for s in socks:
            s.close()
        tcp.server_close()
    assert len(socks) == 32


def test_kill_endpoint_conservation_across_respawn(stack, tmp_path):
    _, batcher = stack
    wire = WireStats()
    bundle = obs_lib.from_config(ObsConfig(trace=True, dir=str(tmp_path)), run="kill")
    sup = Supervisor(
        armed_factory(batcher, wire, ChaosMonkey.from_spec("kill-endpoint@12"),
                      conn_deadline_ms=1000.0, obs=bundle),
        policy=RetryPolicy(attempts=6, base_delay=0.02, max_delay=0.2, seed=0),
        obs=bundle,
    ).start()
    port = sup.address[1]
    try:
        rep = scenarios.run_net(
            "net-kill-endpoint", batcher, wire=wire, supervisor=sup,
            retry=RetryPolicy(attempts=8, base_delay=0.05, max_delay=0.5, seed=1),
        )
        assert rep.passed, rep.to_dict()
        assert rep.errors == 0           # retries rode through the respawn
        assert sup.respawns == 1 and not sup.gave_up
        assert rep.wire["endpoint_deaths"] == 1
        assert rep.wire["submitted"] == (
            rep.wire["completed"] + rep.wire["shed"]
            + rep.wire["expired"] + rep.wire["failed"])
        assert sup.address[1] == port    # the same port across incarnations
    finally:
        sup.close()
    counts = bundle.journal.counts()
    bundle.finish()
    assert counts["endpoint_killed"] == counts["endpoint_respawned"] == 1
    assert counts.get("net_failed", 0) == rep.wire["failed"] >= 1
    assert obs_lib.conservation(counts, prefix="net_") is None


def test_unsupervised_kill_trips_the_gate(stack):
    """The control arm: the same fault, supervision off — clients exhaust
    their retries and the scenario must FAIL."""
    _, batcher = stack
    wire = WireStats()
    sup = Supervisor(armed_factory(batcher, wire, ChaosMonkey.from_spec("kill-endpoint@12"),
                                   conn_deadline_ms=1000.0),
                     enabled=False).start()
    try:
        rep = scenarios.run_net(
            "net-kill-endpoint", batcher, wire=wire, supervisor=sup,
            retry=RetryPolicy(attempts=3, base_delay=0.01, max_delay=0.05, seed=1),
        )
        assert not rep.passed
        assert rep.errors > 0 and not rep.gates()["conservation"]
        assert rep.wire_ok               # even the failure is accounted
        assert sup.respawns == 0
    finally:
        sup.close()


def test_killed_endpoint_fails_inflight_and_drops_clients(tmp_path):
    """A request held in flight (the batcher's worker paused) when the
    endpoint dies is journaled net_failed; its client sees a dropped
    connection, and the next request finds nothing listening."""
    pool, batcher = serve_stack(TINY, _cfg(), device="cpu", start=False)
    bundle = obs_lib.from_config(ObsConfig(trace=True, dir=str(tmp_path)), run="kill")
    wire = WireStats()
    outcome = {}
    try:
        with _server(batcher, wire=wire, obs=bundle) as srv:
            nc = NetClient(srv.address, timeout_s=5.0)

            def call():
                try:
                    nc.request(np.zeros(IN_SHAPE, np.float32))
                except NetTransportError as e:
                    outcome["error"] = e

            t = threading.Thread(target=call)
            t.start()
            deadline = time.monotonic() + 5.0
            while wire.snapshot()["submitted"] < 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            srv.kill(reason="test")
            t.join(timeout=10)
            assert not t.is_alive() and "error" in outcome
            with pytest.raises(NetTransportError):
                nc.request(np.zeros(IN_SHAPE, np.float32))
            nc.close()
            assert not srv.alive and srv.killed
        snap = _settled(wire)
    finally:
        batcher.start()
        batcher.close()
    assert snap["submitted"] == snap["failed"] == 1
    assert snap["endpoint_deaths"] == 1
    counts = bundle.journal.counts()
    bundle.finish()
    assert counts["net_failed"] == 1 and counts["endpoint_killed"] == 1
    assert obs_lib.conservation(counts, prefix="net_") is None


def test_hot_swap_zero_failed_under_live_traffic(stack):
    pool, batcher = stack
    wire = WireStats()
    with _server(batcher, wire=wire, conn_deadline_ms=3000.0) as srv:
        rep = scenarios.run_net(
            "net-hot-swap-diurnal", batcher, wire=wire, server=srv,
            swap_model=load_or_init(pool.handle, seed=7),
        )
    assert rep.passed, rep.to_dict()
    assert rep.swap["failed_delta"] == 0 and rep.swap["stuck"] == []
    assert rep.swap["swapped"] == [0] and rep.swap["grown"] == [1]
    assert pool.routable() == [1] and pool.engines[0].model is None
    assert rep.wire_ok and rep.conservation_ok


def test_hot_swap_needs_its_weights_and_net_names_stay_out_of_run(stack):
    _, batcher = stack
    with _server(batcher) as srv:
        with pytest.raises(ValueError, match="swap_model"):
            scenarios.run_net("net-hot-swap-diurnal", batcher, wire=srv.wire,
                              server=srv)
        with pytest.raises(ValueError, match="kill-endpoint"):
            scenarios.run_net("net-kill-endpoint", batcher, wire=srv.wire, server=srv)
        with pytest.raises(ValueError, match="slow-loris"):
            scenarios.run_net("net-slow-loris", batcher, wire=srv.wire, server=srv)
    with pytest.raises(ValueError, match="unknown scenario"):
        scenarios.run("net-steady", batcher)


def test_hot_swap_replicas_serve_new_weights():
    """After the roll, predictions come from the NEW weights: bit-equal to
    a fresh pool built from them, and not equal to the old ones."""
    pool, batcher = serve_stack(TINY, _cfg(), device="cpu")
    try:
        x = np.ones((1, *IN_SHAPE), np.float32)
        y_old = pool.engines[pool.next_replica()].predict(x)
        report = hot_swap(pool, batcher, load_or_init(pool.handle, seed=7))
        assert report["failed_delta"] == 0 and not report["stuck"]
        fresh = ReplicaPool(TINY, max_batch=8, device="cpu", seed=7)
        y_ref = fresh.engines[0].predict(x)
        y_new = pool.engines[pool.next_replica()].predict(x)
        np.testing.assert_array_equal(y_new, y_ref)
        assert not np.allclose(y_new, y_old)
        served = batcher.submit(x[0]).result(timeout=10)
        np.testing.assert_array_equal(served, y_ref[0])
    finally:
        batcher.close()
