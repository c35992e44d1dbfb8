"""Differential tests of the port's Mosaic probes
(``parallel_cnn_tpu_torch/ops/mosaic_probe.py`` and its entry point
``parallel_cnn_tpu_torch/benches/mosaic_probe.py``; B14–B21) against the
Pallas kernels of the JAX package's ``benches/mosaic_probe.py``.

That script is no package: it is loaded by path, and its ``pl`` is swapped
for a shim whose ``pallas_call`` records each kernel and runs it in
interpret mode on the CPU. Calling a JAX probe once gives its output on
ones and captures its kernel, closures included; the captured kernel then
runs on seeded inputs. On a CPU tensor every port wrapper runs its plain
twin; the kernels are held against the twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, relative to max(1, |ref|): the copies bit for bit; B18 1e-6
(each op rounded on both sides; XLA may contract a multiply-add); the
products 1e-5 (f32 sums of up to 128 products in other orders).
"""

import importlib.util
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from parallel_cnn_tpu_torch.benches import checkout_ab, kernel_mutants, lenet_sweep
from parallel_cnn_tpu_torch.benches import mosaic_probe as probe_bench
from parallel_cnn_tpu_torch.ops import _cuda_build, mosaic_probe
from parallel_cnn_tpu_torch.utils.backend import NoGpuError

from chip_smoke import DOT_KERNELS, PROBE_EXACT, probe_operands

REPO = Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "benches" / "mosaic_probe.py"
COPIES = ("lane_merge", "lane_split")
RTOL = {"vpu_conv": 1e-6}
PRODUCT_RTOL = 1e-5
# Each kernel's probe function: the same name in the JAX script and the port.
PROBE_FN = {
    "rank3_dot": "probe_rank3_dot",
    "lane_merge": "probe_lane_merge",
    "lane_split": "probe_lane_split",
    "mxu_conv_L": "probe_mxu_conv_L",
    "vpu_conv": "probe_vpu_conv_baseline",
    "mxu_conv_3d": "probe_mxu_conv_3d",
    "pair_dot": "probe_pair_dot_laneslice",
    "two_dot": "probe_two_dot_baseline",
}
# Row counts off the 64-row warpgroup tile of the card's dots (B20, B21).
DOT_RAGGED_ROWS = (1, 37, 63, 65, 1000)
LINE = re.compile(r"^\[([A-Za-z0-9-]+)\] RAN cpu first=\d+\.\dms steady=\d+us$")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: keep PyTorch's
    CPU kernels to two threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_probes():
    """name → (the JAX probe's output on ones, its kernel, its pallas_call
    keywords), every probe run once in interpret mode through the shim."""
    spec = importlib.util.spec_from_file_location("_jax_mosaic_probe", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []

    def pallas_call(kernel, **kw):
        calls.append((kernel, kw))
        return pl.pallas_call(kernel, interpret=True, **kw)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "pl", types.SimpleNamespace(pallas_call=pallas_call))
        for name, fn in PROBE_FN.items():
            ones = np.asarray(getattr(mod, fn)())
            kernel, kw = calls[-1]
            out[name] = (ones, kernel, kw, mod)
    return out


def numpy_draw(seed):
    """Seeded normals from numpy; bf16 ones rounded from f32 normals."""
    rng = np.random.default_rng(seed)

    def draw(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    return draw


def to_jax(t: torch.Tensor):
    """A port operand as JAX's: bf16 crosses as f32, exactly."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def reference_f64(name, args):
    """What each kernel computes, in float64 numpy."""
    t = [a.double().numpy() if isinstance(a, torch.Tensor) else a for a in args]
    if name == "rank3_dot":
        return np.einsum("bmk,bkn->bmn", t[0], t[1])
    if name == "lane_merge":
        return t[0].reshape(t[0].shape[0], -1)
    if name == "lane_split":
        return t[0].reshape(t[1], -1)
    if name in ("mxu_conv_L", "vpu_conv", "mxu_conv_3d"):
        return np.tensordot(t[0], t[1], axes=(1, 0))
    return t[0] @ t[1][:, :64] + t[0] @ t[1][:, 64:]


def assert_close(name, got: np.ndarray, ref: np.ndarray):
    assert got.shape == ref.shape and got.dtype == np.float32
    if name in COPIES:
        np.testing.assert_array_equal(got, ref)
        return
    tol = RTOL.get(name, PRODUCT_RTOL) * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got - ref).max()) <= tol


def run_port(name, args):
    """The wrapper on CPU tensors: its plain twin, with no launch counted."""
    counter = mosaic_probe.launches[name]
    before = counter.count
    out = getattr(mosaic_probe, name)(*args)
    assert counter.count == before
    return out.numpy()


@pytest.mark.parametrize("name", mosaic_probe.KERNELS)
def test_plain_twin_matches_jax_kernel(jax_probes, name):
    """Seeded inputs at the probe's shapes through JAX's own kernel in
    interpret mode and through the port's wrapper on the CPU."""
    _, kernel, kw, mod = jax_probes[name]
    jax_name = mosaic_probe.REPLACES[name][0]
    if "." not in jax_name:  # a module-level kernel: the shim caught that one
        assert kernel is getattr(mod, jax_name)
    args = probe_operands(name, False, numpy_draw(14))
    ref = np.asarray(pl.pallas_call(kernel, interpret=True, **kw)(
        *[to_jax(a) for a in args if isinstance(a, torch.Tensor)]))
    assert_close(name, run_port(name, args), ref)


@pytest.mark.parametrize("odd", [False, True], ids=["probe-shape", "odd-shape"])
@pytest.mark.parametrize("name", mosaic_probe.KERNELS)
def test_wrapper_matches_float64(name, odd):
    """The shapes the card tests use, odd ones with tails in every grid
    dimension included, against float64; the twins of the exact kernels
    equal a float32 evaluation in their own order."""
    args = probe_operands(name, odd, numpy_draw(21 + odd))
    got = run_port(name, args)
    assert_close(name, got, reference_f64(name, args).astype(np.float32)
                 if name in COPIES else reference_f64(name, args))
    if name in PROBE_EXACT and name not in COPIES:
        w, x = (a.float().numpy() for a in args)
        want = np.zeros((6,) + x.shape[1:], np.float32)
        for m in range(6):
            for t in range(25):
                want[m] = want[m] + w[m, t] * x[t]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(25, 7, 576), (25, 1, 1003)], ids=["odd", "one-row-1003"])
def test_vpu_conv_plain_is_the_per_filter_rounded_order(shape):
    """B18's order on the host: per filter, t ascending from a zero sum,
    each multiply and each add rounded to float32 by numpy. The card's
    kernel is held bit for bit to this twin."""
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal((6, 25)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()
    xf = x.float().numpy()
    want = np.empty((6,) + shape[1:], np.float32)
    for m in range(6):
        acc = np.zeros(shape[1:], np.float32)
        for t in range(25):
            prod = np.multiply(w[m, t], xf[t], dtype=np.float32)
            acc = np.add(acc, prod, dtype=np.float32)
        want[m] = acc
    np.testing.assert_array_equal(run_port("vpu_conv", (torch.from_numpy(w), x)), want)


@pytest.mark.parametrize("name", mosaic_probe.KERNELS)
def test_probe_on_ones_equals_jax(jax_probes, name):
    port = getattr(probe_bench, PROBE_FN[name])(torch.device("cpu"))
    np.testing.assert_array_equal(port.numpy(), jax_probes[name][0])


def test_main_on_cpu_prints_the_eight_probes_in_jax_order(capsys):
    assert probe_bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    names = [LINE.match(line).group(1) for line in lines]
    assert names == ["rank3-dot", "lane-merge", "lane-split", "vpu-conv-baseline",
                     "mxu-conv-L", "mxu-conv-3d", "pair-dot-laneslice",
                     "two-dot-baseline"]


def test_main_without_a_card_raises_no_gpu_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoGpuError):
        probe_bench.main([])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("argv,ok", [(["--device", "cpu"], True), ([], False)],
                         ids=["cpu", "default-cuda"])
def test_module_runs_as_a_script(argv, ok):
    """``python -m`` exits 0 on the CPU and non-zero with NoGpuError where
    the default (cuda) finds no card."""
    if not ok and torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    proc = subprocess.run(
        [sys.executable, "-m", "parallel_cnn_tpu_torch.benches.mosaic_probe", *argv],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    if ok:
        assert proc.returncode == 0, proc.stderr
        assert len([line for line in proc.stdout.splitlines() if LINE.match(line)]) == 8
    else:
        assert proc.returncode != 0 and "NoGpuError" in proc.stderr
        assert "RAN" not in proc.stdout


def _non_contiguous(t):
    return t.transpose(0, -1).contiguous().transpose(0, -1)


@pytest.mark.parametrize(
    "name,mutate,err",
    [
        ("rank3_dot", lambda a, b: (_non_contiguous(a), b), ValueError),
        ("rank3_dot", lambda a, b: (a.double(), b), TypeError),
        ("rank3_dot", lambda a, b: (a, b[:, :-1]), ValueError),
        ("lane_merge", lambda x: (_non_contiguous(x),), ValueError),
        ("lane_merge", lambda x: (x.to(torch.bfloat16),), TypeError),
        ("lane_split", lambda x, rows: (x, rows + 1), ValueError),
        ("lane_split", lambda x, rows: (x.reshape(rows, -1), 13), ValueError),
        ("mxu_conv_L", lambda w, x: (w, x.float()), TypeError),
        ("mxu_conv_L", lambda w, x: (w.double(), x), TypeError),
        ("vpu_conv", lambda w, x: (w, _non_contiguous(x)), ValueError),
        ("vpu_conv", lambda w, x: (w[:, :24].contiguous(), x), ValueError),
        ("mxu_conv_3d", lambda w, x: (w, x[:, :0]), ValueError),
        ("pair_dot", lambda x, w: (x.float(), w), TypeError),
        ("pair_dot", lambda x, w: (x, _non_contiguous(w)), ValueError),
        ("two_dot", lambda x, w: (x[:, :32].contiguous(), w), ValueError),
        ("two_dot", lambda x, w: (x, w.float()), TypeError),
    ],
    ids=["rank3-non-contiguous", "rank3-float64", "rank3-k-mismatch",
         "merge-non-contiguous", "merge-bf16", "split-rows-not-dividing",
         "split-not-one-row", "L-x-float32", "L-w-float64", "vpu-non-contiguous",
         "vpu-24-taps", "3d-empty", "pair-x-float32", "pair-w-non-contiguous",
         "two-depth-32", "two-w-float32"],
)
def test_wrappers_raise_on_bad_operands(name, mutate, err):
    """Checked on whatever device the operands lie: never a silent copy."""
    args = probe_operands(name, True, numpy_draw(3))
    with pytest.raises(err):
        getattr(mosaic_probe, name)(*mutate(*args))


@pytest.mark.parametrize("name", mosaic_probe.KERNELS)
def test_source_names_the_tpu_kernel_it_replaces(name):
    """REPLACES (which chip_smoke's records quote) points at the kernel's
    line in the JAX script, and the CUDA source's header names both."""
    fn, line = mosaic_probe.REPLACES[name]
    lines = JAX_SCRIPT.read_text().splitlines()
    outer, _, inner = fn.rpartition(".")
    assert re.match(rf"\s*def {inner}\(", lines[line - 1])
    if outer:  # a closure: the nearest enclosing def is its probe
        enclosing = [s for s in lines[:line - 1] if s.startswith("def ")][-1]
        assert enclosing.startswith(f"def {outer}(")
    header = (_cuda_build.CSRC / "mosaic_probe.cu").read_text().split("#include")[0]
    assert re.search(rf":{line}\s+{re.escape(fn)} ", header)


@pytest.mark.parametrize("rows", DOT_RAGGED_ROWS)
@pytest.mark.parametrize("name", DOT_KERNELS)
def test_dot_twins_match_jax_kernels_at_ragged_rows(jax_probes, name, rows):
    """B20's and B21's plain twins against JAX's ``_pair_dot_kernel`` and
    ``_two_dot_kernel`` in interpret mode, on numpy normals, at row counts
    that leave the card's last 64-row tile ragged."""
    _, kernel, kw, _ = jax_probes[name]
    x, w = probe_operands(name, False, numpy_draw(40 + rows), rows=rows)
    call = pl.pallas_call(kernel, interpret=True, **dict(
        kw, out_shape=jax.ShapeDtypeStruct((rows, mosaic_probe.PAIR_N), jnp.float32)))
    ref = np.asarray(call(to_jax(x), to_jax(w)))
    assert_close(name, run_port(name, (x, w)), ref)


@pytest.mark.parametrize("offset,aligned", [(0, True), (1, False), (4, False), (8, True)],
                         ids=["base", "one-element", "8-bytes", "16-bytes"])
def test_tma_alignment_helper_on_cpu_views(offset, aligned):
    """``check_tma_aligned`` passes a view whose first element lies on a
    16-byte boundary and raises ValueError for one that does not."""
    buf = torch.zeros(offset + 37 * 64, dtype=torch.bfloat16)
    assert buf.data_ptr() % mosaic_probe.TMA_ALIGN == 0
    view = buf[offset:].view(37, 64)
    if aligned:
        mosaic_probe.check_tma_aligned("x", view)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            mosaic_probe.check_tma_aligned("x", view)


@pytest.mark.parametrize("name", DOT_KERNELS)
def test_dot_wrapper_on_a_misaligned_cpu_view_runs_the_twin(name):
    """Alignment is the card's rule only: on the CPU a view one element
    off runs the plain twin and equals the aligned operand's result."""
    x, w = probe_operands(name, True, numpy_draw(9))
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    np.testing.assert_array_equal(run_port(name, (view, w)), run_port(name, (x, w)))


@pytest.mark.parametrize("name", kernel_mutants.MUTANTS)
def test_kernel_mutant_edits_one_place_of_the_current_source(tmp_path, name):
    """Each mutant of ``benches/kernel_mutants.py`` still finds its text,
    once, in the kernel source it edits, and changes only that."""
    rel, old, new = kernel_mutants.MUTANTS[name]
    text = (REPO / rel).read_text()
    (tmp_path / rel).parent.mkdir(parents=True)
    (tmp_path / rel).write_text(text)
    kernel_mutants.mutate(tmp_path, name)
    assert (tmp_path / rel).read_text() == text.replace(old, new) != text


@pytest.mark.parametrize("sweep", lenet_sweep.SWEEPS)
def test_every_sweep_variant_edits_the_current_source(tmp_path, sweep):
    """Each variant of ``benches/lenet_sweep.py`` finds each constant it
    sets, and each span its candidate design replaces, exactly once in the
    current source (``variant`` raises otherwise); a design changes the
    text (a constant may be set to the value it has)."""
    spec = lenet_sweep.SWEEPS[sweep]
    module = importlib.import_module(f"parallel_cnn_tpu_torch.ops.{spec.module}")
    for i, consts in enumerate(spec.variants):
        root = tmp_path / str(i)
        root.mkdir()
        lib = lenet_sweep.variant(root, module, consts)
        changed = lib.source.read_text() != module._library.source.read_text()
        assert changed or "design" not in consts, consts


def test_kernel_mutants_without_a_card_raises_no_gpu_error(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoGpuError):
        kernel_mutants.main()
    assert capsys.readouterr().out == ""


def test_checkout_ab_without_a_card_raises_no_gpu_error(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoGpuError):
        checkout_ab.main([str(tmp_path)])
    assert capsys.readouterr().out == ""
