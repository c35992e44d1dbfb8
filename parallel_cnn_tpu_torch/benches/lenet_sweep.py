"""Sweep of B1's warps a conv map: ``WARPS_PER_MAP`` in
``csrc/lenet_fused.cu`` (a lane's block of its map's outputs is 6 /
WARPS_PER_MAP rows by 3 columns; an image's block has 6 x WARPS_PER_MAP
warps).

    python -m parallel_cnn_tpu_torch.benches.lenet_sweep

Each width is built from a copy of the source in a temporary directory
whose only change is the ``constexpr int WARPS_PER_MAP`` line, so the
source keeps one width and no switch. Each runs through the user-facing wrapper
(``lenet_fused.fused_value_and_ref_grads``) with that library swapped in, at
batch 64, 128 and 1000 on inputs from ``chip_smoke.lenet_inputs``: against
the plain version (``chip_smoke.LENET_RTOL``), a relaunch bit for bit, then
device times in two rounds, the widths in order and then reversed. Prints
one line per width and batch. Exits non-zero where a width disagrees or
differs on a relaunch. Needs the card.
"""

from __future__ import annotations

import concurrent.futures
import shutil
import sys
import tempfile
from pathlib import Path
from unittest import mock

WIDTHS = (1, 2, 3)
BATCHES = (64, 128, 1000)
REPS = 200
LINE = "constexpr int WARPS_PER_MAP = "


def variant(root: Path, width: int):
    """A Library of csrc/lenet_fused.cu at WARPS_PER_MAP = width, its
    source (and the header it includes) copied under ``root``."""
    from parallel_cnn_tpu_torch.ops import _cuda_build, lenet_fused

    d = root / f"width{width}"
    d.mkdir()
    text = (_cuda_build.CSRC / "lenet_fused.cu").read_text()
    head, rest = text.split(LINE, 1)
    (d / "lenet_fused.cu").write_text(f"{head}{LINE}{width};{rest.split(';', 1)[1]}")
    for h in lenet_fused._library.headers:
        shutil.copy(h, d / h.name)
    return _cuda_build.Library(str(d / "lenet_fused.cu"), lenet_fused._library.symbols,
                               headers=tuple(str(d / h.name) for h in
                                             lenet_fused._library.headers))


def main() -> int:
    import torch

    import chip_smoke as cs
    from parallel_cnn_tpu_torch.ops import lenet_fused
    from parallel_cnn_tpu_torch.utils.backend import resolve_device
    from parallel_cnn_tpu_torch.utils.tree import tree_leaves

    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    bad = []
    with tempfile.TemporaryDirectory(prefix="lenet_sweep_") as tmp:
        libs = {k: variant(Path(tmp), k) for k in WIDTHS}
        with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:
            list(ex.map(lambda lib: lib.get(), libs.values()))
        for k, lib in libs.items():
            for line in lib.compiler_output.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[sweep] WARPS_PER_MAP={k} ptxas: {line.strip()}", flush=True)

        def swapped(k):
            return mock.patch.object(lenet_fused, "_library", libs[k])

        for n in BATCHES:
            params, xs, ys = cs.lenet_inputs(n, 100 + n)
            with cs.plain_reference():
                ref_err, ref = lenet_fused.fused_value_and_ref_grads_plain(params, xs, ys)
            want = [ref_err] + tree_leaves(ref)
            times = {k: [] for k in WIDTHS}
            for k in WIDTHS:
                with swapped(k):
                    e1, g1 = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
                    e2, g2 = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
                got, again = [e1] + tree_leaves(g1), [e2] + tree_leaves(g2)
                worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
                ok = all(float((g - w).abs().max()) <= cs.LENET_RTOL * max(
                    1.0, float(w.abs().max())) for g, w in zip(got, want))
                same = all(torch.equal(g, a) for g, a in zip(got, again))
                print(f"[sweep] WARPS_PER_MAP={k} b{n}: max |Δ| vs plain {worst:.3e}, "
                      f"relaunch {'bit-identical' if same else 'DIFFERS'} "
                      f"{'ok' if ok and same else 'FAIL'}", flush=True)
                if not (ok and same):
                    bad.append((k, n))
            for order in (WIDTHS, WIDTHS[::-1]):
                for k in order:
                    with swapped(k):
                        times[k].append(cs.cuda_ms(lambda: lenet_fused.fused_value_and_ref_grads(
                            params, xs, ys), reps=REPS))
            for k in WIDTHS:
                t = times[k]
                print(f"[sweep] time WARPS_PER_MAP={k} b{n}: {sum(t) / len(t) * 1e3:.3f} us "
                      f"(rounds {', '.join(f'{v * 1e3:.3f}' for v in t)})", flush=True)
    if bad:
        print(f"[sweep] FAIL: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
