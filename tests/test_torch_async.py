"""Asynchronous data parallelism of the port (``train/async_dp.py``,
``config.AsyncConfig``, the chaos ``slow-worker@`` hook, the CLI's
``--async-mode``) against the JAX package on the CPU, mirroring
tests/test_async_dp.py.

- The staleness ledger, stale-0 against mode ``off`` bit for bit.
- Stale, sync and EASGD runs against JAX's ``run_async`` on the same
  params (JAX's LeNet-ref init carried across) and data: the virtual-clock
  schedule (virtual_ms, microbatches, steps, stragglers, drops, rounds,
  the ledger) exactly JAX's, the per-apply losses and final params within
  1e-5; clean, under a 400 ms straggler, and with a NaN dropped (stale)
  or reset from the center (easgd) by the sentinel; the journal's counts
  JAX's.
- ``easgd_round_sharded`` in a gloo world of 4 against JAX's on 4 host
  devices.
- AsyncConfig and the slow-worker grammar with JAX's texts; the CLI's
  summary line JAX's, and its fence on a zoo model with JAX's text."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_async_ranks as ranks
from parallel_cnn_tpu import cli as jax_cli
from parallel_cnn_tpu import obs as jax_obs
from parallel_cnn_tpu.config import AsyncConfig as JaxAsyncConfig
from parallel_cnn_tpu.config import MeshConfig as JaxMeshConfig
from parallel_cnn_tpu.config import ObsConfig as JaxObsConfig
from parallel_cnn_tpu.models import lenet_ref as jax_lenet
from parallel_cnn_tpu.parallel import mesh as jax_mesh
from parallel_cnn_tpu.resilience import chaos as jax_chaos
from parallel_cnn_tpu.resilience.sentinel import Sentinel as JaxSentinel
from parallel_cnn_tpu.train import async_dp as jax_async
from parallel_cnn_tpu_torch import cli, convert
from parallel_cnn_tpu_torch import obs as obs_lib
from parallel_cnn_tpu_torch.config import AsyncConfig, ObsConfig
from parallel_cnn_tpu_torch.parallel import distributed
from parallel_cnn_tpu_torch.resilience import chaos as port_chaos
from parallel_cnn_tpu_torch.resilience.chaos import SPEC_KINDS, ChaosMonkey
from parallel_cnn_tpu_torch.resilience.sentinel import Sentinel
from parallel_cnn_tpu_torch.train import async_dp

W, B = 4, 8
DT, STEP_MS, HORIZON = 0.05, 100.0, 1600.0
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    xs = rng.uniform(0, 1, (W, B, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, (W, B)).astype(np.int32)
    jparams = jax_lenet.init(jax.random.key(7))
    tparams = convert.lenet_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return dict(xs=xs, ys=ys, jparams=jparams, tparams=tparams)


def _port(setup, cfg, **kw):
    kw.setdefault("dt", DT)
    kw.setdefault("step_ms", STEP_MS)
    return async_dp.run_async(setup["tparams"], torch.from_numpy(setup["xs"]),
                              torch.from_numpy(setup["ys"]).long(), cfg=cfg, **kw)


def _jax(setup, cfg, **kw):
    kw.setdefault("dt", DT)
    kw.setdefault("step_ms", STEP_MS)
    return jax_async.run_async(setup["jparams"], jnp.asarray(setup["xs"]),
                               jnp.asarray(setup["ys"]), cfg=cfg, **kw)


def _schedule(res):
    return (res.virtual_ms, res.microbatches, res.server_steps, res.stragglers,
            res.dropped, res.easgd_rounds, res.ledger.entries, len(res.losses))


def _params_diff(port_params, jax_params):
    want = convert.lenet_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    return max(float((port_params[layer][k] - want[layer][k]).abs().max())
               for layer in want for k in want[layer])


# ---------------------------------------------------------------------------
# The ledger and the config
# ---------------------------------------------------------------------------

def test_ledger_equals_jax():
    for mod in (async_dp, jax_async):
        led = mod.StalenessLedger(workers=2, bound=2)
        led.record(0, 0)
        led.record(0, 2)
        led.record(1, 1)
        assert led.max_staleness() == 2 and led.total_applied() == 3
        assert led.entries == [[0, 2], [1]]
    for bad in (2, -1):
        with pytest.raises(RuntimeError) as want:
            jax_async.StalenessLedger(1, 1).record(0, bad)
        with pytest.raises(RuntimeError, match=re.escape(str(want.value))):
            async_dp.StalenessLedger(1, 1).record(0, bad)


@pytest.mark.parametrize("kw", [dict(mode="bogus"), dict(staleness_bound=-1),
                                dict(easgd_period=0), dict(easgd_rho=0.0),
                                dict(easgd_rho=1.5), dict(workers=0),
                                dict(straggler_factor=1.0)])
def test_async_config_errors_are_jax_s(kw):
    with pytest.raises(ValueError) as want:
        JaxAsyncConfig(**kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        AsyncConfig(**kw)


def test_async_config_from_env_equals_jax(monkeypatch):
    names = ("PCNN_ASYNC_MODE", "PCNN_ASYNC_STALENESS", "PCNN_ASYNC_EASGD_PERIOD",
             "PCNN_ASYNC_EASGD_RHO", "PCNN_ASYNC_WORKERS")
    for v in names:
        monkeypatch.delenv(v, raising=False)
    assert AsyncConfig.from_env() is None is JaxAsyncConfig.from_env()
    for k, v in zip(names, ("easgd", "5", "7", "0.25", "6")):
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(AsyncConfig.from_env()) == \
        dataclasses.asdict(JaxAsyncConfig.from_env())
    assert AsyncConfig().enabled and not AsyncConfig(mode="off").enabled


# ---------------------------------------------------------------------------
# Runs against JAX's
# ---------------------------------------------------------------------------

CASES = {
    "off-3": (dict(mode="off"), dict(max_server_steps=3), None),
    "stale-horizon": (dict(mode="stale", staleness_bound=2), dict(horizon_ms=HORIZON), None),
    "stale-straggler": (dict(mode="stale", staleness_bound=2), dict(horizon_ms=HORIZON),
                        "slow-worker@2:400"),
    "stale-3-straggler": (dict(mode="stale", staleness_bound=2),
                          dict(max_server_steps=3), "slow-worker@3:400"),
    "easgd-horizon": (dict(mode="easgd", easgd_period=4, easgd_rho=0.5),
                      dict(horizon_ms=HORIZON), None),
    "easgd-straggler": (dict(mode="easgd", easgd_period=4, easgd_rho=0.5),
                        dict(horizon_ms=HORIZON), "slow-worker@2:400"),
    "easgd-period1": (dict(mode="easgd", easgd_period=1, easgd_rho=0.9),
                      dict(max_server_steps=6), None),
    "stale-nan": (dict(mode="stale", staleness_bound=2), dict(max_server_steps=3), 1),
    "easgd-nan": (dict(mode="easgd", easgd_period=2, easgd_rho=0.5),
                  dict(max_server_steps=4), 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_run_equals_jax(setup, name):
    """The schedule JAX's exactly; the losses and params within 1e-5."""
    cfg_kw, run_kw, fault = CASES[name]

    def monkey(mod):
        if fault is None:
            return None
        if isinstance(fault, int):
            return mod.ChaosMonkey(nan_step=fault)
        return mod.ChaosMonkey.from_spec(fault)

    nan = isinstance(fault, int)
    got = _port(setup, AsyncConfig(workers=W, **cfg_kw), chaos=monkey(port_chaos),
                sentinel=Sentinel() if nan else None, **run_kw)
    want = _jax(setup, JaxAsyncConfig(workers=W, **cfg_kw), chaos=monkey(jax_chaos),
                sentinel=JaxSentinel() if nan else None, **run_kw)
    assert _schedule(got) == _schedule(want)
    assert np.max(np.abs(np.subtract(got.losses, want.losses)), initial=0.0) <= TOL
    assert _params_diff(got.params, want.params) <= TOL
    if nan:
        assert got.dropped == 1
        assert all(bool(torch.isfinite(t).all()) for layer in got.params.values()
                   for t in layer.values())
    if name == "stale-straggler":
        assert got.ledger.max_staleness() > 0  # the run went async
        assert all(0 <= s <= 2 for e in got.ledger.entries for s in e)


def test_stale0_is_bit_exact_with_sync(setup):
    sync = _port(setup, AsyncConfig(mode="off", workers=W), max_server_steps=3)
    s0 = _port(setup, AsyncConfig(mode="stale", staleness_bound=0, workers=W),
               max_server_steps=3)
    assert sync.losses == s0.losses
    for layer in sync.params:
        for k in sync.params[layer]:
            assert torch.equal(sync.params[layer][k], s0.params[layer][k])


def test_nan_without_sentinel_poisons(setup):
    res = _port(setup, AsyncConfig(mode="stale", staleness_bound=2, workers=W),
                max_server_steps=3, chaos=ChaosMonkey(nan_step=1))
    assert res.dropped == 0
    assert not all(bool(torch.isfinite(t).all()) for layer in res.params.values()
                   for t in layer.values())


def test_easgd_center_learns(setup):
    xs = torch.from_numpy(setup["xs"]).reshape(W * B, 28, 28)
    ys = torch.from_numpy(setup["ys"]).long().reshape(W * B)
    res = _port(setup, AsyncConfig(mode="easgd", easgd_period=1, easgd_rho=0.9,
                                   workers=W), max_server_steps=6)
    before = float(async_dp.eval_err(setup["tparams"], xs, ys))
    after = float(async_dp.eval_err(res.params, xs, ys))
    assert after < before
    assert res.easgd_rounds == 6 * W
    want = float(jax_async.eval_err(setup["jparams"], jnp.asarray(setup["xs"]).reshape(
        W * B, 28, 28), jnp.asarray(setup["ys"]).reshape(W * B)))
    assert abs(before - want) <= TOL


@pytest.mark.parametrize("case", ["stale", "easgd", "drop"])
def test_journal_counts_equal_jax(setup, tmp_path, case):
    cfgs = {"stale": (dict(mode="stale", staleness_bound=2), dict(horizon_ms=HORIZON),
                      "slow-worker@2:400"),
            "easgd": (dict(mode="easgd", easgd_period=2, easgd_rho=0.5),
                      dict(max_server_steps=4), None),
            "drop": (dict(mode="stale", staleness_bound=2), dict(max_server_steps=3), 1)}
    cfg_kw, run_kw, fault = cfgs[case]
    port_b = obs_lib.from_config(ObsConfig(trace=True, dir=str(tmp_path / "p")), run=case)
    jax_b = jax_obs.from_config(JaxObsConfig(trace=True, dir=str(tmp_path / "j"),
                                             jax_annotations=False), run=case)
    counts = []
    for bundle, run, m, cfg_cls, sentinel in (
            (port_b, _port, port_chaos, AsyncConfig, Sentinel),
            (jax_b, _jax, jax_chaos, JaxAsyncConfig, JaxSentinel)):
        monkey = (None if fault is None else m.ChaosMonkey(nan_step=fault)
                  if isinstance(fault, int) else m.ChaosMonkey.from_spec(fault))
        res = run(setup, cfg_cls(workers=W, **cfg_kw), chaos=monkey, obs=bundle,
                  sentinel=sentinel() if isinstance(fault, int) else None, **run_kw)
        spans = [e for e in bundle.tracer.events() if e.get("name") == "train.easgd_round"]
        counts.append((bundle.journal.counts(), len(spans), res.easgd_rounds))
        bundle.finish()
    assert counts[0] == counts[1]
    if case == "easgd":
        assert counts[0][1] == counts[0][2] == 2 * W


def test_easgd_round_sharded_equals_jax(host_devices):
    """The ring round in a gloo world of 4 against JAX's shard_map round on
    4 host devices, and against the host math."""
    n, shard_len, rho = 4, 16, 0.5
    rng = np.random.default_rng(3)
    wf = rng.normal(size=(n, n * shard_len)).astype(np.float32)
    cs = rng.normal(size=(n, shard_len)).astype(np.float32)
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=n, model=1), devices=host_devices[:n])

    def body(w, c):
        nw, nc = jax_async.easgd_round_sharded(w[0], c[0], jnp.float32(rho),
                                               axis_name="data", axis_size=n)
        return nw[None], nc[None]

    f = jax.jit(jax_mesh.shard_map(body, mesh=mesh,
                                   in_specs=(P("data", None), P("data", None)),
                                   out_specs=(P("data", None), P("data", None)),
                                   check_vma=False))
    jw, jc = map(np.asarray, f(jnp.asarray(wf), jnp.asarray(cs)))
    got = distributed.run(ranks.easgd_round_case, n, device="cpu",
                          args=(dict(worker=wf, center=cs, rho=rho),), timeout=120)
    for r in range(n):
        np.testing.assert_allclose(got[r][0], jw[r], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[r][1], jc[r], rtol=TOL, atol=TOL)
    delta = rho * (wf - cs.reshape(-1)[None, :])
    np.testing.assert_allclose(np.stack([g[1] for g in got]).reshape(-1),
                               cs.reshape(-1) + np.mean(delta, axis=0), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# Chaos grammar and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["slow-worker@2", "slow-worker@2:", "slow-worker@2:0",
                                  "slow-worker@2:-5", "slow-worker@x:100",
                                  "definitely-not-a-spec"])
def test_slow_worker_grammar_is_jax_s(spec):
    with pytest.raises(ValueError) as want:
        jax_chaos.ChaosMonkey.from_spec(spec)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        ChaosMonkey.from_spec(spec)
    assert SPEC_KINDS == jax_chaos.SPEC_KINDS


def test_slow_worker_hook_equals_jax():
    for mod in (jax_chaos, port_chaos):
        m = mod.ChaosMonkey.from_spec("slow-worker@3:250")
        assert m.slow_worker == (3, 250.0)
        assert [m.slow_worker_at(s) for s in (0, 2, 5, 3)] == [None, None, 250.0, None]


def test_cli_async_on_a_zoo_model_is_jax_s_fence():
    with pytest.raises(SystemExit) as want:
        jax_cli.main(["--model", "cifar_cnn", "--async-mode", "stale"])
    with pytest.raises(SystemExit, match=re.escape(str(want.value.code))):
        cli.main(["--device", "cpu", "--model", "cifar_cnn", "--async-mode", "stale"])


@pytest.mark.parametrize("mode", [["--async-mode", "stale", "--chaos", "slow-worker@3:400"],
                                  ["--async-mode", "easgd", "--easgd-period", "2"]])
def test_cli_async_summary_equals_jax(capsys, mode):
    """JAX's summary line field for field (the schedule does not depend on
    the init, which differs between the CLIs), then the test error."""
    argv = ["--batch-size", "8", "--epochs", "3", "--synthetic-train-count", "64",
            "--synthetic-test-count", "32", *mode]
    assert jax_cli.main(argv) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("async mode=")]
    assert cli.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out.splitlines()
    got = [ln for ln in out if ln.startswith("async mode=")]
    assert got == want and len(got) == 1
    assert any(ln.startswith("async test error rate: ") for ln in out)
