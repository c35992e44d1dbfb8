"""The port's ExecutionPlan (``parallel_cnn_tpu_torch/plan``), its CLI
(``--plan``/``PCNN_PLAN``, ``--replan``, ``plan show|diff``), plan-stamped
checkpoints and the elastic step cache, held against the JAX package's
``parallel_cnn_tpu.plan`` on the same inputs, on the CPU.

- (i) A grid of argv × env resolved by both CLIs: fields, provenance,
  fingerprint, JSON bytes, ``format_plan`` text, ``plan show`` output and
  the ``validate`` verdict equal; the two recorded departures apart.
- (ii) ``ExecutionPlan(**fields).validate()`` over a knob product.
- (iii) ``derive_resized``, ``cost_table_key``, ``diff_plans``,
  ``serve_plan``; files written by either package load in the other; the
  schema, unknown-field and tamper errors; embedded ``tune --report``.
- (iv) Checkpoints stamped by one package refused by the other under
  another plan, ``replan`` and unstamped files load.
- (v) The CLI on ``--device cpu``: a run by ``--plan`` bit-identical to
  the run by the flags (a gloo world of 2 each), the mismatch refusal and
  ``--replan``, ``plan diff``'s exit codes; LeNet-ref's fused step on a
  mesh refused with JAX's text.
- (vi) One gloo world of 4: the elastic lap 4 → 2 → 4 journals one miss
  and one hit with JAX's ``derive_resized`` fingerprints.
- (vii) The port's mesh constructors are called only under parallel/
  and plan/."""

import ast
import contextlib
import dataclasses
import io
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_plan_ranks as ranks
import _torch_elastic_ranks as eranks
from parallel_cnn_tpu import cli as jax_cli
from parallel_cnn_tpu import plan as jplan
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu_torch import cli
from parallel_cnn_tpu_torch import plan as pplan
from parallel_cnn_tpu_torch.config import CommConfig, FusedStepConfig, PipelineConfig
from parallel_cnn_tpu_torch.parallel import distributed
from parallel_cnn_tpu_torch.train import checkpoint

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "parallel_cnn_tpu_torch"
WORLD_TIMEOUT_S = 300

#: Every environment name either CLI reads for a plan knob or a plan file.
PLAN_ENV = ("PCNN_COMM_IMPL", "PCNN_COMM_BUCKET_BYTES", "PCNN_COMM_WIRE_DTYPE",
            "PCNN_COMM_OVERLAP", "PCNN_COMM_HOSTS", "PCNN_FUSED_STEP",
            "PCNN_ACT_DTYPE", "PCNN_ZERO_LEVEL", "PCNN_PIPELINE_STAGES",
            "PCNN_PIPELINE_SPLIT", "PCNN_PIPELINE_WIRE_DTYPE",
            "PCNN_PIPELINE_ACT_DTYPE", "PCNN_SERVE_PRECOMPILE",
            "PCNN_SERVE_AOT_CACHE_DIR", "PCNN_PLAN", "PCNN_AUTOTUNE",
            "PCNN_AUTOTUNE_REPORT", "PCNN_ELASTIC", "PCNN_ELASTIC_SCHEDULE",
            "PCNN_ASYNC_MODE", "PCNN_OBS_TRACE", "PCNN_OBS_DIR")

Z3 = {"PCNN_FUSED_STEP": "1", "PCNN_ZERO_LEVEL": "3"}

# (argv, env): flags both parsers take.
GRID = [
    ([], {}),
    (["--mesh-data", "2"], {}),
    (["--mesh-data", "2", "--mesh-model", "2"], {}),
    (["--mesh-data", "2", "--comm-impl", "ring"], {}),
    (["--mesh-data", "2", "--comm-impl", "psum"], {}),
    (["--mesh-data", "2", "--comm-impl", "ring", "--comm-bucket-mb", "0.5"], {}),
    (["--mesh-data", "2", "--comm-impl", "ring", "--fused-step"], {}),
    (["--mesh-data", "2", "--comm-impl", "ring", "--fused-step"],
     {"PCNN_ZERO_LEVEL": "3"}),
    (["--mesh-data", "2", "--comm-impl", "ring", "--fused-step",
      "--act-dtype", "float32"], Z3),
    (["--model", "resnet18", "--mesh-data", "1", "--comm-impl", "ring",
      "--fused-step", "--act-dtype", "float32"], Z3),
    (["--model", "resnet18", "--mesh-data", "1", "--comm-impl", "ring",
      "--fused-step", "--act-dtype", "float32"], {"PCNN_ZERO_LEVEL": "3"}),
    (["--comm-impl", "hierarchical", "--comm-hosts", "2", "--fused-step"], Z3),
    (["--comm-impl", "hierarchical", "--comm-hosts", "1"], {}),
    (["--comm-impl", "hierarchical", "--fused-step"], {}),
    (["--pipeline-stages", "2", "--accum-steps", "2"], {}),
    (["--pipeline-stages", "2", "--accum-steps", "2", "--pipeline-split", "3"], {}),
    (["--pipeline-stages", "2", "--comm-impl", "ring", "--fused-step"], {}),
    (["--pipeline-stages", "2", "--mesh-data", "2"], {}),
    (["--pipeline-stages", "2", "--comm-impl", "hierarchical"], {}),
    (["--pipeline-stages", "2", "--comm-impl", "ring", "--fused-step"], Z3),
    (["--mesh-data", "2", "--mesh-model", "2", "--comm-impl", "ring"], {}),
    (["--comm-impl", "ring"], {}),
    (["--mesh-data", "2", "--comm-impl", "psum", "--fused-step"], Z3),
    (["--mesh-data", "2"], {"PCNN_COMM_IMPL": "ring"}),
    (["--mesh-data", "2", "--accum-steps", "3", "--comm-impl", "ring"],
     {"PCNN_COMM_BUCKET_BYTES": "65536", "PCNN_COMM_WIRE_DTYPE": "bfloat16"}),
]


def _ids(grid):
    return [" ".join(a) + "".join(f" {k}={v}" for k, v in e.items()) or "defaults"
            for a, e in grid]


@pytest.fixture
def env(monkeypatch):
    for name in PLAN_ENV:
        monkeypatch.delenv(name, raising=False)

    def set_env(values):
        for k, v in values.items():
            monkeypatch.setenv(k, v)
    return set_env


def _argv(argv):
    return argv if "--model" in argv else ["--model", "cifar_cnn", *argv]


def _jax_plan(argv):
    args = jax_cli.build_parser().parse_args(_argv(argv))
    return jplan.build_plan(jax_cli.config_from_args(args), args)


def _port_plan(argv):
    args = cli.build_parser().parse_args(_argv(argv))
    cfg, _ = cli._zoo_fallback(cli.config_from_args(args))
    return pplan.build_plan(cfg, args)


def _verdict(plan):
    try:
        plan.validate()
    except Exception as exc:  # noqa: BLE001 - the verdict is the exception
        return type(exc).__name__, str(exc)
    return None


def _show(main, argv, capsys):
    rc = main(["plan", "show", *_argv(argv)])
    return rc, capsys.readouterr().out


def _assert_same_plan(got, want):
    assert got.fields() == want.fields()
    assert got.provenance == want.provenance
    assert got.fingerprint() == want.fingerprint()
    assert got.to_json() == want.to_json()
    assert pplan.format_plan(got, title="t") == jplan.format_plan(want, title="t")
    assert got.cost_table_key() == want.cost_table_key()


# ---------------------------------------------------------------------------
# (i) the resolution grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,extra", GRID, ids=_ids(GRID))
def test_resolved_plan_equals_jax(env, capsys, argv, extra):
    env(extra)
    got, want = _port_plan(argv), _jax_plan(argv)
    _assert_same_plan(got, want)
    assert _verdict(got) == _verdict(want)
    assert _show(cli.main, argv, capsys) == _show(jax_cli.main, argv, capsys)


@pytest.mark.parametrize("argv", [
    ["--fused-step", "--act-dtype", "float32"],
    ["--mesh-data", "2", "--fused-step"],
    ["--mesh-data", "2", "--comm-impl", "psum", "--fused-step"],
], ids=["one-device", "gspmd", "psum"])
def test_departure_b_zero2_without_a_ring_falls_back(env, capsys, argv):
    """JAX's CLI refuses a zoo ZeRO-2 fused step with no ring; the port
    applies zoo.train's fallback before the plan: the fused tail only."""
    want = _jax_plan(argv)
    assert _verdict(want) == ("PlanLegalityError",
                              "ZeRO-2 update-on-arrival rides the flat ring; use "
                              "--comm-impl ring (or zero=3 on a hierarchical mesh)")
    got = _port_plan(argv)
    assert _verdict(got) is None
    assert (got.fused, got.fused_update, got.zero, got.opt_sharding) == \
        (True, False, 0, "replicated")
    assert dict(want.fields(), fused_update=False, zero=0,
                opt_sharding="replicated") == got.fields()
    rc, out = _show(cli.main, argv, capsys)
    assert rc == 0 and "ILLEGAL" not in out and got.fingerprint() in out


def test_zero_level_counts_only_beside_the_fused_env(env):
    """As in JAX, PCNN_ZERO_LEVEL refines the fused step of
    PCNN_FUSED_STEP=1 and not the one --fused-step alone makes: alone it
    leaves ZeRO-2 (JAX still labels the knob "env"), beside
    PCNN_FUSED_STEP=1 it makes ZeRO-3."""
    argv = ["--mesh-data", "2", "--comm-impl", "ring", "--fused-step"]
    env({"PCNN_ZERO_LEVEL": "3"})
    got, want = _port_plan(argv), _jax_plan(argv)
    assert (got.zero, want.zero) == (2, 2)
    assert got.provenance_of("zero") == want.provenance_of("zero") == "env"
    assert got.fingerprint() == want.fingerprint()
    env({"PCNN_FUSED_STEP": "1"})
    got, want = _port_plan(argv), _jax_plan(argv)
    assert (got.zero, got.param_sharding) == (want.zero, want.param_sharding) \
        == (3, "zero3")
    assert got.fingerprint() == want.fingerprint()


def test_plan_show_imports_no_torch(env):
    """``plan show`` and ``plan diff`` run where there is no GPU: the CLI
    resolves, validates and prints without importing torch at all."""
    code = ("import sys; from parallel_cnn_tpu_torch import cli; "
            "rc = cli.main(['plan', 'show', '--model', 'resnet18', '--mesh-data', "
            "'2', '--comm-impl', 'ring', '--fused-step']); "
            "print(rc, 'torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "resolved plan (resnet18)" and lines[-1] == "0 False"


# ---------------------------------------------------------------------------
# (ii) the legality matrix
# ---------------------------------------------------------------------------

KNOBS = dict(
    comm_impl=(None, "psum", "ring", "hierarchical", "nccl"),
    zero=(0, 2, 3, 1),
    fused=(False, True),
    fused_update=(False, True),
    data=(None, 2),
    model=(1, 2),
    stages=(1, 2),
    pipelined=(False, True),
    hosts=(None, 1, 2),
    elastic=(False, True),
)


def test_legality_matrix_equals_jax():
    names = list(KNOBS)
    n = 0
    for values in itertools.product(*KNOBS.values()):
        fields = dict(zip(names, values))
        got = _verdict(pplan.ExecutionPlan(**fields))
        assert got == _verdict(jplan.ExecutionPlan(**fields)), fields
        n += got is None
    assert n > 0
    for fields in (dict(accum=0), dict(accum=-1), dict(param_sharding="bogus"),
                   dict(param_sharding="model"),
                   dict(param_sharding="model", data=2, model=2),
                   dict(param_sharding="zero3")):
        assert _verdict(pplan.ExecutionPlan(**fields)) == \
            _verdict(jplan.ExecutionPlan(**fields)), fields


# ---------------------------------------------------------------------------
# (iii) derivation, keys, diffs, serve plans and files
# ---------------------------------------------------------------------------

def _ring_zero3(mod, **kw):
    base = dict(data=4, comm_impl="ring", bucket_bytes=2048, overlap=True, zero=3,
                fused=True, fused_update=True, act_dtype="float32", accum=2,
                param_sharding="zero3", opt_sharding="zero3",
                provenance=(("comm_impl", "flag"), ("zero", "env")))
    base.update(kw)
    return mod.ExecutionPlan(**base)


BASES = {
    "ring": {},
    "hier": dict(comm_impl="hierarchical", hosts=2, data=None),
    "default": None,
}


@pytest.mark.parametrize("base", list(BASES))
def test_derive_resized_equals_jax(base):
    mk = (lambda mod: mod.ExecutionPlan()) if BASES[base] is None else \
        (lambda mod: _ring_zero3(mod, **BASES[base]))
    for world in range(0, 9):
        for n_hosts in (None, 1, 2, 4):
            outcome = []
            for mod in (pplan, jplan):
                try:
                    d = mod.derive_resized(mk(mod), world, n_hosts=n_hosts)
                    outcome.append((d.fields(), d.provenance, d.fingerprint(),
                                    d.world(), _verdict(d)))
                except Exception as exc:  # noqa: BLE001
                    outcome.append((type(exc).__name__, str(exc)))
            assert outcome[0] == outcome[1], (world, n_hosts)
    # An equal topology derives an equal plan: the step cache's key.
    p = mk(pplan)
    assert pplan.derive_resized(p, 4) == pplan.derive_resized(
        pplan.derive_resized(p, 2), 4)


@pytest.mark.parametrize("argv,extra", GRID, ids=_ids(GRID))
def test_cost_table_key_and_configs_equal_jax(env, argv, extra):
    env(extra)
    got, want = _port_plan(argv), _jax_plan(argv)
    assert got.cost_table_key() == want.cost_table_key()
    for view in ("comm_config", "fused_config", "pipeline_config"):
        a, b = getattr(got, view)(), getattr(want, view)()
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert type(got.comm_config() or CommConfig()) is CommConfig
    assert type(got.fused_config() or FusedStepConfig()) is FusedStepConfig
    assert type(got.pipeline_config() or PipelineConfig()) is PipelineConfig


def test_diff_and_serve_plans_equal_jax():
    a, b = _ring_zero3(pplan), _ring_zero3(pplan, data=2, accum=1)
    ja, jb = _ring_zero3(jplan), _ring_zero3(jplan, data=2, accum=1)
    assert pplan.diff_plans(a, b) == jplan.diff_plans(ja, jb)
    assert pplan.diff_plans(a, b).startswith("plans differ (")
    assert pplan.diff_plans(a, a) == "" == jplan.diff_plans(ja, ja)

    class Serve:
        precompile = True

    class Net:
        aot_cache_dir = "/tmp/aot"

    for args, kw in (((Serve(),), {}), ((Serve(), Net()), {}),
                     ((Serve(),), dict(cache_dir="d")), ((object(),), {})):
        _assert_same_plan(pplan.serve_plan(*args, **kw), jplan.serve_plan(*args, **kw))


def test_plan_files_cross_load(tmp_path):
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    pplan.save_plan(mine, _ring_zero3(pplan))
    jplan.save_plan(theirs, _ring_zero3(jplan))
    assert mine.read_bytes() == theirs.read_bytes()
    _assert_same_plan(pplan.load_plan(theirs), jplan.load_plan(mine))
    assert pplan.load_plan(theirs) == _ring_zero3(pplan)
    # A `tune --report` document embedding the plan loads in both.
    report = tmp_path / "report.json"
    report.write_text(json.dumps({"autotune": {"n_dev": 4},
                                  "plan": _ring_zero3(jplan).to_json_dict()}))
    _assert_same_plan(pplan.load_plan(report), jplan.load_plan(report))


def _schema_docs(tmp_path):
    good = _ring_zero3(jplan).to_json_dict()
    docs = {
        "version": dict(good, version=2),
        "no-plan": {"version": 1},
        "unknown": dict(good, plan=dict(good["plan"], warp=9)),
        "tamper": dict(good, plan=dict(good["plan"], accum=4)),
        "provenance": dict(good, provenance=[1]),
        "array": [1, 2],
    }
    out = {}
    for name, doc in docs.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(doc))
        out[name] = path
    out["not-json"] = tmp_path / "nj.json"
    out["not-json"].write_text("{")
    out["missing"] = tmp_path / "absent.json"
    return out


def test_plan_file_errors_equal_jax(tmp_path):
    for name, path in _schema_docs(tmp_path).items():
        errs = []
        for mod in (pplan, jplan):
            with pytest.raises(mod.PlanError) as info:
                mod.load_plan(path)
            errs.append((type(info.value).__name__, str(info.value)))
        assert errs[0] == errs[1], name


def test_bare_tune_report_loads_as_jax_does(tmp_path):
    """A `tune --report` artifact without an embedded plan converts its
    chosen autotune plan in both packages, to the same fingerprint."""
    from parallel_cnn_tpu.analysis import autotune as jat
    from parallel_cnn_tpu.analysis import hw_profiles as jhw

    mp = jat.ModelProfile(
        name="toy", param_elems=1 << 20, param_bytes=4 << 20, mstate_bytes=8192,
        flops_per_image=3_000_000_000, act_bytes_per_image=2_000_000,
        wire_numel=4096, layer_fwd_flops=(1, 1))
    for n_dev, n_host in ((8, 1), (4, 2), (1, 1)):
        path = tmp_path / f"report{n_dev}x{n_host}.json"
        res = jat.search(mp, hw=jhw.get_profile("v5e-8"), global_batch=128,
                         n_dev=n_dev, n_host=n_host)
        jat.write_section(path, jat.build_section(res))
        assert "plan" not in json.loads(path.read_text())
        got, want = pplan.load_plan(path), jplan.load_plan(path)
        _assert_same_plan(got, want)
        assert set(dict(got.provenance).values()) == {"autotune"}


# ---------------------------------------------------------------------------
# (iv) plan-stamped checkpoints
# ---------------------------------------------------------------------------

FP_A, FP_B = _ring_zero3(jplan).fingerprint(), _ring_zero3(jplan, data=2).fingerprint()


def _tree():
    return {"c1": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "b": np.zeros(3, np.float32)}}


def _torch_like():
    return {k: {n: torch.from_numpy(v.copy()) for n, v in leaves.items()}
            for k, leaves in _tree().items()}


def test_port_stamp_refused_by_jax(tmp_path):
    flat, sharded = str(tmp_path / "a.npz"), str(tmp_path / "s.npz")
    checkpoint.save(flat, _torch_like(), plan_fingerprint=FP_A)
    checkpoint.save_sharded(sharded, _torch_like(), world_size=2, bucket_bytes=2048,
                            plan_fingerprint=FP_A)
    for read, path in ((jax_checkpoint.restore, flat),
                       (jax_checkpoint.load_params, flat),
                       (jax_checkpoint.restore_sharded, sharded)):
        with pytest.raises(jplan.PlanMismatchError) as info:
            read(path, _tree(), plan_fingerprint=FP_B)
        assert (info.value.stored, info.value.live) == (FP_A, FP_B)
        read(path, _tree(), plan_fingerprint=FP_B, replan=True)
        read(path, _tree(), plan_fingerprint=FP_A)


def test_jax_stamp_refused_by_the_port(tmp_path):
    flat, sharded, bare = (str(tmp_path / n) for n in ("a.npz", "s.npz", "u.npz"))
    jax_checkpoint.save(flat, _tree(), plan_fingerprint=FP_A)
    jax_checkpoint.save_sharded(sharded, _tree(), world_size=2, bucket_bytes=2048,
                                plan_fingerprint=FP_A)
    jax_checkpoint.save(bare, _tree())
    want = str(jplan.PlanMismatchError(stored=FP_A, live=FP_B, path=flat))
    for read, path in ((checkpoint.restore, flat), (checkpoint.load_params, flat),
                       (checkpoint.restore_sharded, sharded)):
        with pytest.raises(pplan.PlanMismatchError) as info:
            read(path, _torch_like(), plan_fingerprint=FP_B)
        text = str(info.value)
        assert FP_A in text and FP_B in text and "--replan" in text
        if path == flat:
            assert text == want
        read(path, _torch_like(), plan_fingerprint=FP_B, replan=True)
    # Unstamped files load under any plan; the stamp is JAX's meta key.
    checkpoint.restore(bare, _torch_like(), plan_fingerprint=FP_B)
    checkpoint.save(bare, _torch_like())
    assert "plan" not in checkpoint._read_arrays(bare)[1]
    assert checkpoint._read_arrays(flat)[1]["plan"] == FP_A


# ---------------------------------------------------------------------------
# (v) the CLI on the CPU
# ---------------------------------------------------------------------------

RUN = ["--device", "cpu", "--model", "cifar_cnn", "--batch-size", "16",
       "--synthetic-train-count", "64", "--synthetic-test-count", "32",
       "--lr", "0.01"]
DP = ["--mesh-data", "2", "--comm-impl", "ring", "--fused-step", "--act-dtype",
      "float32"]


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def _ckpt(path):
    arrays, meta = checkpoint._read_arrays(str(path))
    return arrays, meta


def test_cli_plan_file_run_is_the_flag_run(env, tmp_path, capsys):
    plan_file = tmp_path / "p.json"
    rc, out = _show(cli.main, DP + ["--save", str(plan_file)], capsys)
    assert rc == 0 and f"plan written to {plan_file}" in out
    want_fp = _jax_plan(DP).fingerprint()
    assert pplan.load_plan(plan_file).fingerprint() == want_fp
    rc, by_flags = _main(RUN + DP + ["--epochs", "1", "--checkpoint-dir",
                                     str(tmp_path / "a")])
    assert rc == 0 and "mesh: {'data': 2, 'model': 1}" in by_flags
    rc, by_plan = _main(RUN + ["--plan", str(plan_file), "--epochs", "1",
                               "--checkpoint-dir", str(tmp_path / "b")])
    assert rc == 0 and "mesh: {'data': 2, 'model': 1}" in by_plan
    (a, ma), (b, mb) = _ckpt(tmp_path / "a/ckpt_1.npz"), _ckpt(tmp_path / "b/ckpt_1.npz")
    assert sorted(a) == sorted(b) and any(k.startswith(".opt_state/.mom") for k in a)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert ma["plan"] == mb["plan"] == want_fp
    assert ma["epoch_errors"] == mb["epoch_errors"]


def test_cli_resume_under_another_plan_needs_replan(env, tmp_path, capsys):
    """One device (the fused tail): a file written under one plan, resumed
    with --accum-steps 2, is refused with both fingerprints; --replan
    resumes. PCNN_PLAN is --plan's environment twin."""
    ck = str(tmp_path / "ck")
    base = RUN + ["--fused-step", "--act-dtype", "float32", "--checkpoint-dir", ck]
    plan_file = tmp_path / "p.json"
    assert _show(cli.main, base + ["--save", str(plan_file)], capsys)[0] == 0
    env({"PCNN_PLAN": str(plan_file)})
    rc, out = _main(RUN + ["--checkpoint-dir", ck, "--epochs", "1"])
    assert rc == 0 and "epoch 1:" in out
    stored = pplan.load_plan(plan_file).fingerprint()
    assert _ckpt(Path(ck) / "ckpt_1.npz")[1]["plan"] == stored
    changed = base + ["--epochs", "2", "--resume", "--accum-steps", "2"]
    live = _port_plan(changed).fingerprint()
    with pytest.raises(pplan.PlanMismatchError) as info:
        _main(changed)
    assert str(info.value) == str(jplan.PlanMismatchError(
        stored=stored, live=live, path=str(Path(ck) / "ckpt_1.npz")))
    rc, out = _main(changed + ["--replan"])
    assert rc == 0 and "resumed from" in out and "epoch 2:" in out
    assert _ckpt(Path(ck) / "ckpt_2.npz")[1]["plan"] == live


def test_cli_plan_diff_exit_codes_equal_jax(tmp_path, capsys):
    a, b, c = (tmp_path / n for n in ("a.json", "b.json", "c.json"))
    pplan.save_plan(a, _ring_zero3(pplan))
    pplan.save_plan(b, _ring_zero3(pplan, provenance=()))
    pplan.save_plan(c, _ring_zero3(pplan, data=2))
    for argv in (["diff", str(a), str(b)], ["diff", str(a), str(c)],
                 ["diff", str(a)], ["diff", str(a), str(tmp_path / "none.json")],
                 [], ["bogus"]):
        got = (cli.main(["plan", *argv]), capsys.readouterr().out)
        want = (jax_cli.main(["plan", *argv]), capsys.readouterr().out)
        assert got[0] == want[0], argv
        assert got[1] == want[1].replace("parallel_cnn_tpu ", "parallel_cnn_tpu_torch "), argv
    assert [cli.main(["plan", "diff", str(a), str(x)]) for x in (b, c)] == [0, 1]
    capsys.readouterr()


def test_lenet_fused_step_on_a_mesh_is_jax_s_plan_error(env):
    """LeNet-ref's mesh validates the plan, as JAX's trainer does: a fused
    step asks for update-on-arrival, which rides the ring."""
    with pytest.raises(SystemExit) as info:
        cli.main(["--device", "cpu", "--mesh-data", "1", "--fused-step",
                  "--batch-size", "16", "--synthetic-train-count", "64",
                  "--loader", "synthetic"])
    want = _verdict(jplan.build_plan(jax_cli.config_from_args(
        jax_cli.build_parser().parse_args(["--mesh-data", "1", "--fused-step"]))))
    assert want[0] == "PlanLegalityError"
    assert info.value.code == want[1]
    assert "ZeRO-2 update-on-arrival rides the flat ring" in want[1]


# ---------------------------------------------------------------------------
# (vi) the elastic step cache in a gloo world of 4
# ---------------------------------------------------------------------------

def test_elastic_lap_journals_one_miss_then_one_hit(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64,) + eranks.TINY_SHAPE).astype(np.float32)
    y = rng.integers(0, 10, (64,)).astype(np.int32)
    torch.manual_seed(0)
    sd0 = {k: v.numpy().copy() for k, v in eranks.nobn_model().state_dict().items()}
    eplan = _ring_zero3(pplan)
    spec = dict(x=x, y=y, sd0=sd0, plan=eplan, obs_dir=str(tmp_path))
    out = distributed.run(ranks.elastic_step_cache, eranks.WORLD, device="cpu",
                          args=(spec,), plan=eplan, timeout=WORLD_TIMEOUT_S)
    assert {o["mesh"] for o in out} == {"DataMesh"}
    assert all(np.isfinite(out[0]["losses"])) and len(out[0]["losses"]) == 2
    # The step reused at the hit trains exactly as a rebuilt one.
    assert out[0]["losses"] == out[0]["rebuilt"]
    assert out[0]["resizes"] == [(4, 2), (2, 4)]
    cache = [(r["world"], r["hit"], r["plan"]) for r in out[0]["cache"]]
    jp = _ring_zero3(jplan)
    assert cache == [(2, False, jplan.derive_resized(jp, 2).fingerprint()),
                     (4, True, jplan.derive_resized(jp, 4).fingerprint())]


# ---------------------------------------------------------------------------
# (vii) the single mesh site
# ---------------------------------------------------------------------------

MESH_CONSTRUCTORS = {"make_mesh_2d", "make_pipeline_mesh", "make_hier_mesh",
                     "make_elastic_mesh"}


def test_mesh_constructors_are_called_only_in_parallel_and_plan():
    calls = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
                if name in MESH_CONSTRUCTORS:
                    calls.append((path.relative_to(PKG).parts[0], name))
    assert calls, "the scan found no constructor call at all"
    assert {where for where, _ in calls} <= {"parallel", "plan"}, calls
    assert {name for where, name in calls if where == "plan"} == MESH_CONSTRUCTORS
