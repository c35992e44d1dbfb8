"""The port's plan autotuner against the JAX package's (parallel_cnn_tpu/
analysis/autotune.py), on the CPU.

The model profiles, the plan space, the scores, the search with its
prune and budget, the order gate, the report files, the ExecutionPlan
view, the Config pieces, ``--autotune``'s layering in ``config_from_args``
and ``plan show``, and the ``tune`` subcommand's table, report and
embedded plan: each equal to JAX's. Where a search or a score is compared
under a hardware row that only the JAX package carries (its TPU rows),
the port's ``HwProfile`` is built from ``dataclasses.asdict`` of JAX's
row, so no such number is written in the port.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest

from parallel_cnn_tpu import cli as jax_cli
from parallel_cnn_tpu import config as jax_config
from parallel_cnn_tpu import plan as jplan
from parallel_cnn_tpu.analysis import autotune as jat
from parallel_cnn_tpu.analysis import cost_model as jcm
from parallel_cnn_tpu.analysis import hw_profiles as jhw
from parallel_cnn_tpu.nn import cifar as jcifar
from parallel_cnn_tpu.nn import resnet as jresnet
from parallel_cnn_tpu.nn import vgg as jvgg
from parallel_cnn_tpu_torch import cli
from parallel_cnn_tpu_torch import plan as pplan
from parallel_cnn_tpu_torch.analysis import autotune as pat
from parallel_cnn_tpu_torch.analysis import cost_model as pcm
from parallel_cnn_tpu_torch.analysis import hw_profiles as phw
from parallel_cnn_tpu_torch.config import AutotuneConfig
from parallel_cnn_tpu_torch.nn import cifar, resnet, vgg

pytestmark = pytest.mark.autotune

ZOO = ("cifar_cnn", "resnet18", "resnet34", "resnet50", "vgg16")
PORT_MODELS = {
    "cifar_cnn": lambda: cifar.cifar_cnn(device="meta"),
    "resnet18": lambda: resnet.resnet18(10, device="meta"),
    "resnet34": lambda: resnet.resnet34(10, device="meta"),
    "resnet50": lambda: resnet.resnet50(10, cifar_stem=True, device="meta"),
    "vgg16": lambda: vgg.vgg16(10, device="meta"),
}
JAX_MODELS = {
    "cifar_cnn": lambda: jcifar.cifar_cnn(),
    "resnet18": lambda: jresnet.resnet18(10, cifar_stem=True),
    "resnet34": lambda: jresnet.resnet34(10, cifar_stem=True),
    "resnet50": lambda: jresnet.resnet50(10, cifar_stem=True),
    "vgg16": lambda: jvgg.vgg16(10),
}
AUTOTUNE_ENV = ("PCNN_AUTOTUNE", "PCNN_AUTOTUNE_REPORT", "PCNN_AUTOTUNE_TOPK",
                "PCNN_AUTOTUNE_HBM_BUDGET", "PCNN_HW_PROFILE", "PCNN_PLAN",
                "PCNN_COMM_IMPL", "PCNN_COMM_BUCKET_BYTES", "PCNN_COMM_WIRE_DTYPE",
                "PCNN_COMM_OVERLAP", "PCNN_COMM_HOSTS", "PCNN_FUSED_STEP",
                "PCNN_ACT_DTYPE", "PCNN_ZERO_LEVEL", "PCNN_PIPELINE_STAGES",
                "PCNN_PIPELINE_SPLIT", "PCNN_PIPELINE_WIRE_DTYPE",
                "PCNN_PIPELINE_ACT_DTYPE")
# (n_dev, n_host, global batch)
SHAPES = [(8, 1, 128), (4, 2, 128), (1, 1, 128), (4, 1, 64)]
ROWS = ("v5e-8", "cpu-emu")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for name in AUTOTUNE_ENV:
        monkeypatch.delenv(name, raising=False)


@functools.lru_cache(maxsize=None)
def jax_profile(name):
    return jat.profile_module(JAX_MODELS[name](), jcifar.IN_SHAPE, name=name)


@functools.lru_cache(maxsize=None)
def port_profile(name):
    return pat.profile_module(PORT_MODELS[name](), cifar.IN_SHAPE, name=name)


def port_row(name):
    """The port's HwProfile carrying JAX's row's numbers."""
    return phw.HwProfile(**dataclasses.asdict(jhw.get_profile(name)))


def jax_mp(mp):
    return jat.ModelProfile(**dataclasses.asdict(mp))


def _plans(mod, n_dev, n_host, batch):
    return list(mod.enumerate_plans(n_dev=n_dev, n_host=n_host, global_batch=batch))


def _port_plan_of(p):
    return pat.Plan(**dataclasses.asdict(p))


# ---------------------------------------------------------------------------
# the model profile, the plan space, the scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_profile_module_equals_jax(name):
    got, want = port_profile(name), jax_profile(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("n_dev,n_host,batch", SHAPES)
def test_enumerate_plans_equals_jax(n_dev, n_host, batch):
    got = _plans(pat, n_dev, n_host, batch)
    want = _plans(jat, n_dev, n_host, batch)
    assert [dataclasses.asdict(p) for p in got] == [dataclasses.asdict(p) for p in want]
    assert [p.label() for p in got] == [p.label() for p in want]
    assert [p.key() for p in got] == [p.key() for p in want]
    assert [p.flags(n_host) for p in got] == [p.flags(n_host) for p in want]
    assert len(got) > 0


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("n_dev,n_host,batch", SHAPES)
def test_score_plan_equals_jax(row, n_dev, n_host, batch):
    mp = port_profile("resnet18")
    kw = dict(global_batch=batch, n_dev=n_dev, n_host=n_host)
    for p in _plans(jat, n_dev, n_host, batch):
        want = jat.score_plan(p, jax_mp(mp), jhw.get_profile(row), **kw)
        got = pat.score_plan(_port_plan_of(p), mp, port_row(row), **kw)
        for field in ("img_s", "t_compute_s", "t_comm_s"):
            a, b = getattr(got, field), getattr(want, field)
            assert a == pytest.approx(b, rel=1e-12, abs=0.0), (p.label(), field)
        assert (got.bytes_ici, got.bytes_dcn, got.peak_hbm) == \
            (want.bytes_ici, want.bytes_dcn, want.peak_hbm), p.label()


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _search_pair(name="resnet18", row="v5e-8", **kw):
    mp = port_profile(name)
    return (pat.search(mp, hw=port_row(row), **kw),
            jat.search(jax_mp(mp), hw=jhw.get_profile(row), **kw))


def _same_result(got, want):
    assert [s.plan.label() for s in got.ranked] == [s.plan.label() for s in want.ranked]
    assert dataclasses.asdict(got.chosen.plan) == dataclasses.asdict(want.chosen.plan)
    for a, b in zip(got.ranked, want.ranked):
        assert a.img_s == pytest.approx(b.img_s, rel=1e-12, abs=0.0)
    assert (got.n_enumerated, got.n_feasible, got.hbm_budget, got.hw_profile,
            got.model) == (want.n_enumerated, want.n_feasible, want.hbm_budget,
                           want.hw_profile, want.model)
    assert [(p.label(), peak) for p, peak in got.excluded_hbm] == \
        [(p.label(), peak) for p, peak in want.excluded_hbm]
    assert pat.format_table(got) == jat.format_table(want)
    assert json.dumps(pat.build_section(got), sort_keys=True) == \
        json.dumps(jat.build_section(want), sort_keys=True)


@pytest.mark.parametrize("row", ROWS)
@pytest.mark.parametrize("n_dev,n_host,batch", SHAPES)
def test_search_equals_jax_and_brute_force(row, n_dev, n_host, batch):
    kw = dict(global_batch=batch, n_dev=n_dev, n_host=n_host, top_k=8)
    got, want = _search_pair(row=row, **kw)
    _same_result(got, want)
    brute, _ = _search_pair(row=row, prune=False, **kw)
    assert [s.plan for s in brute.ranked] == [s.plan for s in got.ranked]
    assert [s.img_s for s in brute.ranked] == [s.img_s for s in got.ranked]


def test_search_budget_exclusions_and_errors_equal_jax():
    kw = dict(global_batch=128, n_dev=8, n_host=1)
    full, _ = _search_pair(prune=False, top_k=10_000, **kw)
    peaks = sorted(s.peak_hbm for s in full.ranked)
    budget = peaks[len(peaks) // 2]
    got, want = _search_pair(hbm_budget=budget, top_k=10_000, **kw)
    _same_result(got, want)
    assert len(got.excluded_hbm) > 0
    for mod, mp, hw in ((pat, port_profile("resnet18"), port_row("v5e-8")),
                        (jat, jax_profile("resnet18"), jhw.get_profile("v5e-8"))):
        with pytest.raises(mod.NoFeasiblePlan) as info:
            mod.search(mp, hw=hw, hbm_budget=1, **kw)
        assert "no legal plan fits the 1 B HBM budget" in str(info.value)
        plan = mod.search(mp, hw=hw, **kw).chosen.plan
        assert mod.assert_within_budget(plan, mp, hw=hw, **kw) > 0
        with pytest.raises(mod.BudgetExceeded, match="predicts peak HBM"):
            mod.assert_within_budget(plan, mp, hbm_budget=1024, hw=hw, **kw)
    # At world 1 every plan ties (no communication): Plan.key chooses psum, k2.
    one, _ = _search_pair(global_batch=128, n_dev=1, n_host=1)
    assert one.chosen.plan.label() == "psum-f32-k2"


# ---------------------------------------------------------------------------
# the order gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_order_gate_equals_jax(seed):
    rng = np.random.default_rng(seed)
    pred = list(rng.uniform(10.0, 1000.0, size=6))
    meas = [p * rng.uniform(0.8, 1.25) for p in pred]
    for p, m in ((pred, meas), ([1.0 / v for v in pred], meas)):
        assert pat.order_gate(p, m) == jat.order_gate(p, m)
        assert pat.pairwise_agreement(p, m) == jat.pairwise_agreement(p, m)
    assert pat.order_gate(pred, [p * 1.01 for p in pred])[0]
    # The doctored table (reciprocals) keeps the separations but inverts
    # every ordering: it fails.
    assert not pat.order_gate([1.0 / v for v in pred], pred)[0]
    with pytest.raises(ValueError):
        pat.pairwise_agreement([1.0], [1.0, 2.0])


# ---------------------------------------------------------------------------
# the report files
# ---------------------------------------------------------------------------

def test_reports_cross_load_and_schema_errors(monkeypatch, tmp_path):
    # The report's constants are the active profile's: one both carry.
    monkeypatch.setenv("PCNN_HW_PROFILE", "cpu-emu")
    got, want = _search_pair(global_batch=128, n_dev=4, n_host=2, top_k=4)
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    pat.write_section(mine, pat.build_section(got))
    jat.write_section(theirs, jat.build_section(want))
    assert mine.read_text() == theirs.read_text()
    for path in (mine, theirs):
        (pp, ps), (jp, js) = pat.load_chosen_plan(path), jat.load_chosen_plan(path)
        assert dataclasses.asdict(pp) == dataclasses.asdict(jp) == \
            dataclasses.asdict(got.chosen.plan)
        assert ps == js
    # Traced entries survive a section rewrite in both.
    jcm.write_cost_report(theirs, {"zoo.step": {"ici": 1}})
    pat.write_section(theirs, pat.build_section(got))
    assert pcm.load_cost_report(theirs)["entries"] == {"zoo.step": {"ici": 1}}
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 0, "entries": {}}))
    for cm, at in ((pcm, pat), (jcm, jat)):
        with pytest.raises(cm.CostSchemaError, match="schema version 0 != 1"):
            cm.load_cost_report(stale)
        with pytest.raises(cm.CostSchemaError):
            at.load_chosen_plan(stale)
        with pytest.raises(at.NoFeasiblePlan, match="no cost report"):
            at.load_chosen_plan(tmp_path / "absent.json")
    assert pcm.COST_SCHEMA_VERSION == jcm.COST_SCHEMA_VERSION


def test_shipped_report_is_the_port_s_own():
    plan, section = pat.load_chosen_plan()
    data = pcm.load_cost_report(pcm.DEFAULT_COST_REPORT)
    assert section["model"] == "cifar_cnn" and section["n_dev"] == 4
    assert section["hw_profile"] == data["constants"]["hw_profile"] == "h100-sxm"
    eplan = pplan.load_plan(pcm.DEFAULT_COST_REPORT)
    assert eplan == plan.to_execution_plan(n_host=1, n_dev=4)


# ---------------------------------------------------------------------------
# the ExecutionPlan view and the Config pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_host", [1, 2])
def test_to_execution_plan_equals_jax(n_host):
    space = [(p, n_dev) for n_dev in (1, 4, 8)
             for p in _plans(jat, n_dev, n_host, 128)]
    assert space
    for p, n_dev in space:
        for dev in (None, n_dev):
            got = _port_plan_of(p).to_execution_plan(n_host=n_host, n_dev=dev)
            want = p.to_execution_plan(n_host=n_host, n_dev=dev)
            assert got.fingerprint() == want.fingerprint(), p.label()
            assert got.provenance == want.provenance
            assert dataclasses.asdict(pat.Plan.from_execution_plan(got)) == \
                dataclasses.asdict(jat.Plan.from_execution_plan(want))


def test_plan_to_configs_equals_jax():
    for p in _plans(jat, 4, 2, 128) + _plans(jat, 8, 1, 128):
        for n_host in (1, 2):
            got = pat.plan_to_configs(_port_plan_of(p), n_host=n_host)
            want = jat.plan_to_configs(p, n_host=n_host)
            for a, b in zip(got[:3], want[:3]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert dataclasses.asdict(a) == dataclasses.asdict(b), p.label()
            assert got[3] == want[3]


def test_autotune_config_env_layering(monkeypatch, tmp_path):
    """JAX's test_autotune_config_env_layering, on the port's config."""
    assert AutotuneConfig.from_env() is None  # absent ≠ disabled
    monkeypatch.setenv("PCNN_AUTOTUNE", "1")
    monkeypatch.setenv("PCNN_AUTOTUNE_TOPK", "3")
    at = AutotuneConfig.from_env()
    assert at.enabled and at.top_k == 3
    assert at.report is None
    other = str(tmp_path / "other.json")
    monkeypatch.setenv("PCNN_AUTOTUNE_REPORT", other)
    assert AutotuneConfig.from_env().report == other
    monkeypatch.delenv("PCNN_AUTOTUNE_REPORT")
    monkeypatch.setenv("PCNN_AUTOTUNE", "0")
    assert not AutotuneConfig.from_env().enabled
    assert dataclasses.asdict(AutotuneConfig.from_env()) == \
        dataclasses.asdict(jax_config.AutotuneConfig.from_env())
    with pytest.raises(ValueError):
        AutotuneConfig(top_k=0)
    with pytest.raises(ValueError):
        AutotuneConfig(hw="not-a-profile")
    # The port's menu has no TPU rows: the JAX package's default is unknown.
    with pytest.raises(ValueError, match="known: cpu-emu, h100-sxm, pcie-gpu"):
        AutotuneConfig(hw="v5e-8")


def test_hw_profiles_registry(monkeypatch):
    default = phw.get_profile()
    assert default.name == phw.DEFAULT_PROFILE == "h100-sxm"
    assert default.peak_flops == 989e12
    assert default.ici_bytes_per_s == 4.5e11
    assert default.dcn_bytes_per_s == 5.0e10
    assert (default.ici_hop_s, default.dcn_hop_s) == (1.0e-6, 25.0e-6)
    for name in ("cpu-emu", "pcie-gpu"):
        assert dataclasses.asdict(phw.get_profile(name)) == \
            dataclasses.asdict(jhw.get_profile(name))
    monkeypatch.setenv("PCNN_HW_PROFILE", "cpu-emu")
    assert phw.active_profile().name == "cpu-emu"
    monkeypatch.setenv("PCNN_HW_PROFILE", "v5e-8")
    with pytest.raises(ValueError, match="unknown hardware profile 'v5e-8'"):
        phw.active_profile()
    with pytest.raises(ValueError, match="must be positive"):
        phw.HwProfile(name="x", description="", peak_flops=0,
                      ici_bytes_per_s=1, dcn_bytes_per_s=1, hbm_bytes=1)


# ---------------------------------------------------------------------------
# --autotune in config_from_args and plan show
# ---------------------------------------------------------------------------

#: JAX's own test profile (tests/test_autotune.py MP): compute-heavy enough
#: that a flat overlapped ring wins over 8 devices.
TOY = jat.ModelProfile(
    name="toy", param_elems=1_048_576, param_bytes=4 * 1_048_576,
    mstate_bytes=8_192, flops_per_image=3_000_000_000,
    act_bytes_per_image=2_000_000, wire_numel=4_096,
    layer_fwd_flops=(500_000_000, 500_000_000))


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Reports JAX's tuner writes: a flat ring over 8 devices, psum at
    world 1, ResNet-18's pipeline over 8 and a plan over 2 × 4 hosts."""
    root = tmp_path_factory.mktemp("reports")
    out = {}
    for label, mp, n_dev, n_host in (
            ("ring8", TOY, 8, 1), ("one", TOY, 1, 1),
            ("pipe8", jax_profile("resnet18"), 8, 1),
            ("hier", jax_profile("resnet18"), 4, 2)):
        res = jat.search(mp, hw=jhw.get_profile("v5e-8"),
                         global_batch=128, n_dev=n_dev, n_host=n_host)
        path = root / f"{label}.json"
        jat.write_section(path, jat.build_section(res))
        out[label] = str(path)
    return out


def _config(mod, argv):
    args = mod.build_parser().parse_args(argv)
    try:
        cfg = mod.config_from_args(args)
    except SystemExit as exc:
        return ("exit", str(exc)), args
    return cfg, args


def _section(obj):
    return None if obj is None else dataclasses.asdict(obj)


CFG_CASES = [(model, extra) for model in ("cifar_cnn", "resnet18", "lenet_ref")
             for extra in ([], ["--mesh-data", "4"], ["--comm-impl", "psum"])]


@pytest.mark.parametrize("report", ["ring8", "one", "pipe8", "hier"])
@pytest.mark.parametrize("model,extra", CFG_CASES,
                         ids=[f"{m}{''.join(e)}" for m, e in CFG_CASES])
def test_config_from_args_autotune_equals_jax(reports, capsys, report, model, extra):
    argv = ["--model", model, "--autotune-report", reports[report], *extra]
    (got, gargs), (want, wargs) = _config(cli, argv), _config(jax_cli, argv)
    if isinstance(want, tuple):
        assert got == want
        return
    for name in ("comm", "fused", "pipeline", "autotune"):
        assert _section(getattr(got, name)) == _section(getattr(want, name)), name
    assert (got.mesh.data, got.mesh.model) == (want.mesh.data, want.mesh.model)
    assert gargs.accum_steps == wargs.accum_steps
    assert gargs._autotune_filled == wargs._autotune_filled
    gp = pplan.build_plan(cli._zoo_fallback(got)[0], gargs)
    wp = jplan.build_plan(want, wargs)
    assert gp.fingerprint() == wp.fingerprint()
    assert gp.provenance == wp.provenance
    shown = []
    for main in (cli.main, jax_cli.main):
        rc = main(["plan", "show", *argv])
        shown.append((rc, capsys.readouterr().out))
    assert shown[0] == shown[1]
    if report == "ring8" and not extra and model != "lenet_ref":
        assert "[autotune]" in shown[0][1] and got.mesh.data == 8


def test_autotune_flag_reads_the_env_report(monkeypatch, reports):
    monkeypatch.setenv("PCNN_AUTOTUNE_REPORT", reports["ring8"])
    argv = ["--model", "cifar_cnn", "--autotune"]
    got, _ = _config(cli, argv)
    want, _ = _config(jax_cli, argv)
    assert _section(got.comm) == _section(want.comm)
    assert got.mesh.data == want.mesh.data == 8
    monkeypatch.setenv("PCNN_AUTOTUNE_REPORT", reports["ring8"] + ".absent")
    got, _ = _config(cli, argv)
    assert got[0] == "exit" and got[1].startswith("--autotune: ")


# ---------------------------------------------------------------------------
# the tune subcommand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 2])
def test_tune_cli_equals_jax(monkeypatch, tmp_path, capsys, hosts):
    monkeypatch.setenv("PCNN_HW_PROFILE", "cpu-emu")
    outs, docs = [], []
    for tag, main in (("port", cli.main), ("jax", jax_cli.main)):
        path = tmp_path / f"{tag}.json"
        rc = main(["tune", "--model", "resnet18", "--devices", "8", "--hw",
                   "cpu-emu", "--hosts", str(hosts), "--report", str(path)])
        assert rc == 0
        outs.append(capsys.readouterr().out.replace(str(path), "REPORT"))
        docs.append(json.loads(path.read_text()))
    assert outs[0] == outs[1]
    assert docs[0] == docs[1]
    fps = [pplan.load_plan(tmp_path / "port.json").fingerprint(),
           jplan.load_plan(tmp_path / "jax.json").fingerprint()]
    assert fps[0] == fps[1] and f"(plan {fps[0]};" in outs[0]
    assert docs[0]["plan"]["version"] == pplan.PLAN_SCHEMA_VERSION


def test_tune_without_a_card_needs_devices(monkeypatch, capsys, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert cli.main(["tune", "--report", str(tmp_path / "r.json")]) == 2
    assert "--devices" in capsys.readouterr().out
    assert not (tmp_path / "r.json").exists()
    # An impossible budget: JAX's exit 1 and its line.
    rc = cli.main(["tune", "--devices", "2", "--hbm-budget-mb", "0.001",
                   "--report", str(tmp_path / "r.json")])
    assert rc == 1 and capsys.readouterr().out.startswith("tune: no legal plan fits")
    assert os.path.exists(pcm.DEFAULT_COST_REPORT)
