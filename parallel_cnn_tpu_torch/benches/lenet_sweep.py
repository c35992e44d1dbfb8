"""Sweeps of the LeNet kernels' build constants:

- ``b1``: B1's warps a conv map, ``WARPS_PER_MAP`` in ``csrc/lenet_fused.cu``
  (a lane's block of its map's outputs is 6 / WARPS_PER_MAP rows by 3
  columns; an image's block has 6 x WARPS_PER_MAP warps);
- ``conv_fwd``: B3's maps a block and rows a thread, ``CONV_MAPS`` and
  ``CONV_ROWS`` in ``csrc/lenet_staged.cu`` (a block is one image and
  CONV_MAPS maps; a thread CONV_ROWS rows x 4 columns of one map);
- ``fc_fwd``: B5's warps a block, ``FC_FWD_WARPS`` in the same file.

    python -m parallel_cnn_tpu_torch.benches.lenet_sweep [b1] [conv_fwd] [fc_fwd]

(all three without an argument). Each variant is built from a copy of the
source in a temporary directory whose only change is its ``constexpr int``
lines, so the source keeps one choice and no switch. Each runs through the
user-facing wrapper (``lenet_fused.fused_value_and_ref_grads``,
``lenet_staged.conv_fwd``, ``lenet_staged.fc_fwd``) with that library
swapped in, at batch 64, 128 and 1000 on ``chip_smoke``'s seeded LeNet
inputs (B3 and B5 at the staged path's own inputs, ``chip_smoke.
stage_cases``): B1 against its plain version (``chip_smoke.LENET_RTOL``), B3
bit for bit against its plain twin, B5 bit for bit against
``lenet_staged.fc_fwd_order``, and a relaunch bit for bit; then device
times in two rounds, the variants in order and then reversed. Prints one
line per variant and batch. Exits non-zero where a variant disagrees or
differs on a relaunch. Needs the card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import re
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Tuple
from unittest import mock

import torch

BATCHES = (64, 128, 1000)
REPS = 200


class Sweep(NamedTuple):
    """One kernel's sweep: its wrapper module's name, its kernels' names
    (for their ptxas lines), the constants of each variant, ``inputs(n)``
    -> the wrapper's arguments, ``run(args)`` -> its outputs as a list,
    ``check(args, outs)`` -> (max |Δ| against the reference, whether that
    is within the contract)."""

    module: str
    kernels: Tuple[str, ...]
    variants: Tuple[Dict[str, int], ...]
    inputs: Callable
    run: Callable
    check: Callable


def _b1_inputs(n):
    import chip_smoke as cs

    return cs.lenet_inputs(n, 100 + n)


def _b1_run(args):
    from parallel_cnn_tpu_torch.ops import lenet_fused
    from parallel_cnn_tpu_torch.utils.tree import tree_leaves

    err, grads = lenet_fused.fused_value_and_ref_grads(*args)
    return [err] + tree_leaves(grads)


def _b1_check(args, outs):
    import chip_smoke as cs
    from parallel_cnn_tpu_torch.ops import lenet_fused
    from parallel_cnn_tpu_torch.utils.tree import tree_leaves

    with cs.plain_reference():
        ref_err, ref = lenet_fused.fused_value_and_ref_grads_plain(*args)
    want = [ref_err] + tree_leaves(ref)
    worst = max(float((g - w).abs().max()) for g, w in zip(outs, want))
    ok = all(float((g - w).abs().max()) <= cs.LENET_RTOL * max(1.0, float(w.abs().max()))
             for g, w in zip(outs, want))
    return worst, ok


def _stage_inputs(case):
    def inputs(n):
        import chip_smoke as cs

        params, xs, ys = cs.lenet_inputs(n, 100 + n)
        return cs.stage_cases(params, xs, ys)[case][2]
    return inputs


def _staged_run(name):
    def run(args):
        from parallel_cnn_tpu_torch.ops import lenet_staged

        return list(getattr(lenet_staged, name)(*args))
    return run


def _conv_check(args, outs):
    from parallel_cnn_tpu_torch.ops import lenet_staged

    want = lenet_staged.conv_fwd_plain(*args)
    worst = max(float((g - w).abs().max()) for g, w in zip(outs, want))
    return worst, all(torch.equal(g, w) for g, w in zip(outs, want))


def _fc_check(args, outs):
    from parallel_cnn_tpu_torch.ops import lenet_staged

    order = torch.from_numpy(lenet_staged.fc_fwd_order(*(a.cpu().numpy() for a in args)))
    want = [order.to(outs[0].device)]
    want.append(torch.sigmoid(want[0]))
    worst = max(float((g - w).abs().max()) for g, w in zip(outs, want))
    return worst, all(torch.equal(g, w) for g, w in zip(outs, want))


SWEEPS = {
    "b1": Sweep("lenet_fused", ("lenet_step_image", "lenet_step_finish"),
                tuple({"WARPS_PER_MAP": k} for k in (1, 2, 3)),
                _b1_inputs, _b1_run, _b1_check),
    "conv_fwd": Sweep("lenet_staged", ("conv_fwd_kernel",),
                      tuple({"CONV_MAPS": m, "CONV_ROWS": r} for r in (1, 2, 3, 4, 6, 8)
                            for m in (1, 2, 3, 6)),
                      _stage_inputs("conv_fwd"), _staged_run("conv_fwd"), _conv_check),
    "fc_fwd": Sweep("lenet_staged", ("fc_fwd_kernel",),
                    tuple({"FC_FWD_WARPS": k} for k in (1, 2, 4, 8)),
                    _stage_inputs("fc_fwd"), _staged_run("fc_fwd"), _fc_check),
}


def label(consts: Dict[str, int]) -> str:
    return " ".join(f"{k}={v}" for k, v in consts.items())


def variant(root: Path, module, consts: Dict[str, int]):
    """A Library of ``module``'s source with each ``constexpr int NAME``
    line of ``consts`` set to its value, the source (and the headers it
    includes) copied under ``root``."""
    from parallel_cnn_tpu_torch.ops import _cuda_build

    lib = module._library
    d = root / re.sub(r"\W+", "_", f"{lib.source.stem} {label(consts)}")
    d.mkdir()
    text = lib.source.read_text()
    for name, value in consts.items():
        text, count = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if count != 1:
            raise ValueError(f"{lib.source.name} has {count} lines constexpr int {name} = ...")
    (d / lib.source.name).write_text(text)
    for h in lib.headers:
        shutil.copy(h, d / h.name)
    return _cuda_build.Library(str(d / lib.source.name), lib.symbols, lib.flags[len(
        _cuda_build.NVCC_FLAGS):], headers=tuple(str(d / h.name) for h in lib.headers))


@contextlib.contextmanager
def swapped(module, lib):
    """``module``'s kernels from ``lib`` for the duration (its ``_lib``
    loader too, where the module caches the loaded library)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(module, "_library", lib))
        if hasattr(module, "_lib"):
            stack.enter_context(mock.patch.object(module, "_lib", lib.get))
        yield


def run_sweep(name: str, sweep: Sweep, tmp: Path) -> list:
    """Build, check and time one sweep's variants; returns the failures."""
    import importlib

    import chip_smoke as cs

    module = importlib.import_module(f"parallel_cnn_tpu_torch.ops.{sweep.module}")
    libs = [variant(tmp, module, c) for c in sweep.variants]
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.get(), libs))
    for consts, lib in zip(sweep.variants, libs):
        kernel = ""
        for line in lib.compiler_output.splitlines():
            if "Function properties for" in line:
                kernel = next((k for k in sweep.kernels if k in line), "")
            elif kernel and ("registers" in line or "spill" in line):
                print(f"[sweep] {name} {label(consts)} {kernel} ptxas: {line.strip()}",
                      flush=True)
    bad = []
    for n in BATCHES:
        args = sweep.inputs(n)
        for consts, lib in zip(sweep.variants, libs):
            with swapped(module, lib):
                got, again = sweep.run(args), sweep.run(args)
            worst, ok = sweep.check(args, got)
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            print(f"[sweep] {name} {label(consts)} b{n}: max |Δ| vs its reference "
                  f"{worst:.3e}, relaunch {'bit-identical' if same else 'DIFFERS'} "
                  f"{'ok' if ok and same else 'FAIL'}", flush=True)
            if not (ok and same):
                bad.append((name, label(consts), n))
        times = {i: [] for i in range(len(libs))}
        for order in (range(len(libs)), reversed(range(len(libs)))):
            for i in order:
                with swapped(module, libs[i]):
                    times[i].append(cs.cuda_ms(lambda: sweep.run(args), reps=REPS))
        for i, consts in enumerate(sweep.variants):
            t = times[i]
            print(f"[sweep] time {name} {label(consts)} b{n}: {sum(t) / len(t) * 1e3:.3f} us "
                  f"(rounds {', '.join(f'{v * 1e3:.3f}' for v in t)})", flush=True)
    return bad


def main(argv=None) -> int:
    from parallel_cnn_tpu_torch.utils.backend import resolve_device

    names = (sys.argv[1:] if argv is None else argv) or list(SWEEPS)
    unknown = [n for n in names if n not in SWEEPS]
    if unknown:
        print(f"unknown sweeps {unknown}; choose from {list(SWEEPS)}", file=sys.stderr)
        return 2
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bad = []
    with tempfile.TemporaryDirectory(prefix="lenet_sweep_") as tmp:
        for name in names:
            bad += run_sweep(name, SWEEPS[name], Path(tmp))
    if bad:
        print(f"[sweep] FAIL: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
