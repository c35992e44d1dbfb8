"""Mutation check of the redesigned kernels: the tensor-core dots (B20
``pair_dot``, B21 ``two_dot``; ``csrc/mosaic_probe.cu`` and
``csrc/wgmma_tile.cuh``), the probes' copy (B15/B16, ``copy_kernel`` in
``csrc/mosaic_probe.cu``), the list form of the SGD-momentum update (B13,
``csrc/sgd_update.cu``), the FC backward (B6, ``csrc/lenet_staged.cu``),
the conv forward (B10, ``tap_conv_kernel`` in ``csrc/tap_conv.cu``), the
bf16 dgrad on the tensor cores (``tap_dgrad_wgmma_kernel``, same file), the
LeNet step kernel (B1, ``csrc/lenet_fused.cu``), B9's contraction
(``accum_matmul_kernel`` in ``csrc/lenet_staged.cu``), the staged
conv and FC forwards (B3 ``conv_fwd_kernel``, B5 ``fc_fwd_kernel``, same
file), the staged pool forward and backward (B4 ``pool_fwd_kernel``,
B7 ``pool_bwd_kernel``, same file), the staged σ′ kernel (B8
``sigma_prime_kernel``, same file), the leaf list of the fused SGD (B2
``sgd_leaves_kernel``, ``csrc/sgd_update.cu``), the fused loss tail (B12's
per-image ``tail_ce_kernel`` and its tiled form's ``tail_gap_pass``,
``tail_fc_kernel`` and ``tail_finish_kernel``, ``csrc/tail_ce.cu``), the
probes' contraction (B17/B19 and B18, ``conv_contract_kernel``,
``csrc/mosaic_probe.cu``) and batched matmul (B14
``batched_matmul_kernel``, same file).

    python -m parallel_cnn_tpu_torch.benches.kernel_mutants [WORD ...]

With words, only the mutants whose names hold one of them run (beside the
unmutated copy), e.g. ``B12 B17``.

Each mutant is one edit to a kernel source. It is applied to a copy of the
checkout (the port's package, ``chip_smoke.py``, ``tests/test_torch_cuda.py``
and ``pyproject.toml``) in a temporary directory, never to the checkout
itself; the copy builds its own kernels and runs the card tests selected by ``-k`` SELECT in a pytest process of its own, so a
mutant that faults the
card's context takes only its own copy down. JOBS copies run at once; the
lines come in MUTANTS' order, the unmutated copy first.
One line per copy, ``[mutant] <name>: <failed> of <selected> card tests
failed``, then the names of the failed tests. Exits non-zero where the
unmutated copy fails a test or a mutant fails none. Needs the card: the card
tests skip without one, so the default device raises ``NoGpuError`` first.
"""

from __future__ import annotations

import concurrent.futures
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from parallel_cnn_tpu_torch.utils.backend import resolve_device

ROOT = Path(__file__).resolve().parents[2]
CSRC = "parallel_cnn_tpu_torch/csrc"
COPIED = ("parallel_cnn_tpu_torch", "chip_smoke.py", "tests/test_torch_cuda.py",
          "pyproject.toml")
#: The card tests each copy runs (pytest -k): the probes', B13's, B6's, the
#: forward's (against its plain twin at every tile, across batch positions
#: at every ResNet-18 conv), B1's, B9's, B3's, B5's, B4's, B7's, B8's, B2's,
#: B12's and the tensor-core dgrad's.
SELECT = ("probe or momentum or fc_bwd or forward_every_tile or batch_position "
          "or test_kernel_matches_plain or lenet_fused or accum or conv_fwd or fc_fwd "
          "or pool_fwd or pool_bwd or sigma_prime or sgd_update or tree_sgd or tail "
          "or wgmma_dgrad")
#: Copies built and tested at once (each its own pytest process).
JOBS = 3

#: name -> (file under the root, the text replaced, its replacement); each
#: text occurs exactly once in its file.
MUTANTS = {
    "halves off by one n8 tile": (
        f"{CSRC}/wgmma_tile.cuh", "return i + N / 4;", "return i + N / 4 - 4;"),
    "descriptor swizzle 64B": (
        f"{CSRC}/wgmma_tile.cuh", "static_cast<uint64_t>(1) << 62;",
        "static_cast<uint64_t>(2) << 62;"),
    "stride between w's atoms halved": (
        f"{CSRC}/wgmma_tile.cuh",
        "sw128_desc(box + K_STEP * ROW_BYTES * s, atom_stride, ATOM_BYTES)",
        "sw128_desc(box + K_STEP * ROW_BYTES * s, atom_stride / 2, ATOM_BYTES)"),
    "stride between w's k groups doubled": (
        f"{CSRC}/wgmma_tile.cuh",
        "sw128_desc(box + K_STEP * ROW_BYTES * s, atom_stride, ATOM_BYTES)",
        "sw128_desc(box + K_STEP * ROW_BYTES * s, atom_stride, 2 * ATOM_BYTES)"),
    "ragged tile's store unmasked": (
        f"{CSRC}/mosaic_probe.cu", "    if (r < rows) {\n      *reinterpret_cast<float2*>",
        "    if (true) {\n      *reinterpret_cast<float2*>"),
    "B13 entry lookup off by one block": (
        f"{CSRC}/sgd_update.cu", "blk >= list.first_block[e + 1]",
        "blk > list.first_block[e + 1]"),
    "B13 non-final entry's ragged tail skipped": (
        f"{CSRC}/sgd_update.cu", "const long long quads = (n + 3) >> 2;",
        "const long long quads = e + 1 < list.count ? n >> 2 : (n + 3) >> 2;"),
    "B6 last batch shard dropped": (
        f"{CSRC}/lenet_staged.cu", "const int hi = min(lo + sh, nr);",
        "const int hi = lo + sh <= nr ? lo + sh : lo;"),
    "B6 s slab's column offset off by one": (
        f"{CSRC}/lenet_staged.cu", "const float* sg = s + c0;",
        "const float* sg = s + c0 + 1;"),
    "B6 unaligned s staged with odd columns dropped": (
        f"{CSRC}/lenet_staged.cu", "LANES + (i - r * FC_SLAB),",
        "LANES + ((i - r * FC_SLAB) & ~1),"),
    "B15/B16 copy's scalar tail skipped": (
        f"{CSRC}/mosaic_probe.cu", "if (t < n - tail) dst[tail + t] = src[tail + t];", ""),
    "B15/B16 copy's misaligned head read as aligned": (
        f"{CSRC}/mosaic_probe.cu",
        "const int head = vec ? static_cast<int>(lead < n ? lead : n) : 0;",
        "const int head = 0;"),
    "forward gather off by one row at stride 2": (
        f"{CSRC}/tap_conv.cu", "a_iy[c] = oy * geo.stride - geo.pad_top;",
        "a_iy[c] = oy * geo.stride - geo.pad_top + (geo.stride == 2);"),
    "forward last depth stage skipped": (
        f"{CSRC}/tap_conv.cu",
        "const int K = geo.k * geo.k * geo.cin;\n  const int stages = (K + BK - 1) / BK;",
        "const int K = geo.k * geo.k * geo.cin;\n  const int stages = (K + BK - 1) / BK - 1;"),
    "forward residual dropped": (
        f"{CSRC}/tap_conv.cu", "if (residual != nullptr) z[q] += res[q];", ""),
    "dgrad phase's column parity dropped from the store": (
        f"{CSRC}/tap_conv.cu", "i * p.stride + plan.px[ph];", "i * p.stride;"),
    "dgrad's K-major w box read as MN-major": (
        f"{CSRC}/tap_conv.cu", ": wgtile::k_major_desc(a + BOX_BYTES, kk);",
        ": wgtile::mn_major_desc(a + BOX_BYTES, kk, BOX_BYTES);"),
    "B1 last warp's FC partial left out": (
        f"{CSRC}/lenet_fused.cu", "for (int w = 1; w < IMG_WARPS; ++w) z += fc_part[w][lane];",
        "for (int w = 1; w < IMG_WARPS - 1; ++w) z += fc_part[w][lane];"),
    "B1 pass 2 drops the last image from g_w_f": (
        f"{CSRC}/lenet_fused.cu", "for (int r = shard; r < nr; r += FW_SHARDS) {",
        "for (int r = shard; r < nr - (ch + 1 == chunks); r += FW_SHARDS) {"),
    "B1 last pool window dropped": (
        f"{CSRC}/lenet_fused.cu", "has[k] = w < WINDOWS;", "has[k] = w < WINDOWS - 1;"),
    "B1 unaligned image staged short": (
        f"{CSRC}/lenet_fused.cu", "for (int i = tid; i < 784; i += IMG_THREADS) {",
        "for (int i = tid; i < 780; i += IMG_THREADS) {"),
    "B9 last row shard skipped": (
        f"{CSRC}/lenet_staged.cu", "const int nrows = min(shard, rows - r0);",
        "const int nrows = blockIdx.x + 1 == gridDim.x ? 0 : min(shard, rows - r0);"),
    "B9 finish's last shard level dropped": (
        f"{CSRC}/lenet_staged.cu", "for (int s = 1; s < shards; ++s) sum += red[s * outs + tid];",
        "for (int s = 1; s < shards - 1; ++s) sum += red[s * outs + tid];"),
    "B9 finish skips block 1's partial": (
        f"{CSRC}/lenet_staged.cu", "for (int g = 1; g < static_cast<int>(gridDim.x); ++g)",
        "for (int g = 2; g < static_cast<int>(gridDim.x); ++g)"),
    "B9 ticket not wrapped to 0": (
        f"{CSRC}/lenet_staged.cu", "atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1",
        "atomicInc(ticket, gridDim.x) == gridDim.x - 1"),
    "B3 strip's last column written from the third": (
        f"{CSRC}/lenet_staged.cu", "make_float4(acc[0], acc[1], acc[2], acc[3])",
        "make_float4(acc[0], acc[1], acc[2], acc[2])"),
    "B3 unaligned image staged one value short": (
        f"{CSRC}/lenet_staged.cu",
        "for (int i = tid; i < IMG; i += CONV_THREADS) ftile::cp_async4(",
        "for (int i = tid; i < IMG - 1; i += CONV_THREADS) ftile::cp_async4("),
    "B5 last lane's k slice dropped": (
        f"{CSRC}/lenet_staged.cu", "const bool live = lane < FC_FWD_LANES;",
        "const bool live = lane < FC_FWD_LANES - 1;"),
    "B5 butterfly's last level skipped": (
        f"{CSRC}/lenet_staged.cu", "for (int off = 16; off > 0; off >>= 1)",
        "for (int off = 16; off > 1; off >>= 1)"),
    "B5 every class takes class 0's bias": (
        f"{CSRC}/lenet_staged.cu", "__ldg(bias + (lane < CLASSES ? lane : 0))", "__ldg(bias)"),
    "B4 last tap dropped": (
        f"{CSRC}/lenet_staged.cu",
        "for (int t = 0; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], xi[t * LANES]));",
        "for (int t = 0; t < TAPS - 1; ++t) acc = __fadd_rn(acc, __fmul_rn(w[t], xi[t * LANES]));"),
    "B4 bias read from the first tap": (
        f"{CSRC}/lenet_staged.cu", "float acc = bias[0];", "float acc = w[0];"),
    "B4 grid's last output skipped": (
        f"{CSRC}/lenet_staged.cu",
        "if (idx >= total) return;\n  const long long img = idx / LANES;",
        "if (idx >= total - 1) return;\n  const long long img = idx / LANES;"),
    "B7 last tap row not stored": (
        f"{CSRC}/lenet_staged.cu", "for (int t = 0; t < ROWS; ++t) {",
        "for (int t = 0; t < ROWS - 1; ++t) {"),
    "B7 last image of a ragged block skipped": (
        f"{CSRC}/lenet_staged.cu", "if (g >= threads) return;",
        "if (g >= threads || (threads % POOL_BWD_THREADS != 0 &&\n"
        "                       g >= threads - POOL_BWD_SPLIT * POOL_BWD_GROUPS)) return;"),
    "B7 4-byte path reads a group's last lane one value early": (
        f"{CSRC}/lenet_staged.cu", "for (int k = 0; k < V; ++k) v[k] = __ldg(p + k);",
        "for (int k = 0; k < V; ++k) v[k] = __ldg(p + k - (k == V - 1));"),
    "B8 last quad of a thread not stored": (
        f"{CSRC}/lenet_staged.cu", "if (q < quads) store_vec<4>(out + 4 * q, o);",
        "if (q < quads && u + 1 < SIGMA_VEC) store_vec<4>(out + 4 * q, o);"),
    "B8 4-byte path one element short": (
        f"{CSRC}/lenet_staged.cu", "v[2] = __ldg(p + 2), v[3] = __ldg(p + 3);",
        "v[2] = __ldg(p + 2), v[3] = __ldg(p + 2);"),
    "B8 strided grid skips the last block's later passes": (
        f"{CSRC}/lenet_staged.cu", "q0 < quads; q0 += gridDim.x * SPAN) {",
        "q0 < quads && (q0 < gridDim.x * SPAN || blockIdx.x + 1 < gridDim.x);"
        " q0 += gridDim.x * SPAN) {"),
    "B2 last leaf skipped": (
        f"{CSRC}/sgd_update.cu", "sgd_leaves_kernel<<<static_cast<int>(blocks), SGD_THREADS",
        "sgd_leaves_kernel<<<list.first_block[count - 1], SGD_THREADS"),
    "B2 leaf offset one element early": (
        f"{CSRC}/sgd_update.cu", "x.off = static_cast<int>(off);",
        "x.off = static_cast<int>(off) - (i > 0);"),
    "B2 ragged access's last float dropped": (
        f"{CSRC}/sgd_update.cu", "if (i + j < n) out[x.off + i + j] = o[j];",
        "if (i + j + 1 < n) out[x.off + i + j] = o[j];"),
    "B12 gap's second half of positions dropped": (
        f"{CSRC}/tail_ce.cu", "if (p + q < positions) {", "if (2 * (p + q) < positions) {"),
    "B12 last row group's partial left out of the logit": (
        f"{CSRC}/tail_ce.cu", "for (int r = 1; r < rows; ++r) s += part[r * kc + j];",
        "for (int r = 1; r < rows - 1; ++r) s += part[r * kc + j];"),
    "B12 one-hot subtracted at the wrong class": (
        f"{CSRC}/tail_ce.cu", "dln[j] = logits[j] / se - (j == y ? 1.0f : 0.0f);",
        "dln[j] = logits[j] / se - (j == y + 1 ? 1.0f : 0.0f);"),
    "B12 tiled gap pass's last position range left out": (
        f"{CSRC}/tail_ce.cu", "for (int r = 1; r < groups; ++r) {",
        "for (int r = 1; r < groups - 1; ++r) {"),
    "B12 tiled FC's last ring slot of a chunk skipped": (
        f"{CSRC}/tail_ce.cu", "const int stages = (f_end - f_begin + STAGE_F - 1) / STAGE_F;",
        "const int stages = (f_end - f_begin - 1) / STAGE_F;"),
    "B12 tiled finish's last chunk partial left out": (
        f"{CSRC}/tail_ce.cu", "if (c0 + i < chunks) s += v[i];",
        "if (c0 + i < chunks - 1) s += v[i];"),
    "B12 tiled one-hot subtracted at the wrong class": (
        f"{CSRC}/tail_ce.cu", "dln[j] = z[j] / se - (j == y ? 1.0f : 0.0f);",
        "dln[j] = z[j] / se - (j == y + 1 ? 1.0f : 0.0f);"),
    "B17/B19 wide body's last tap dropped": (
        f"{CSRC}/mosaic_probe.cu",
        "for (int t = 0; t < TAPS; ++t) {\n      float xv[CONTRACT_COLS];\n      widen(",
        "for (int t = 0; t < TAPS - 1; ++t) {\n      float xv[CONTRACT_COLS];\n      widen("),
    "B17/B19 misaligned x read by the wide body": (
        f"{CSRC}/mosaic_probe.cu",
        "(reinterpret_cast<std::uintptr_t>(x) & (CONTRACT_COLS * 2 - 1)) == 0;", "true;"),
    "B17/B19 narrow body's last column not stored": (
        f"{CSRC}/mosaic_probe.cu", "if (q < cols) out[m * l + c0 + q] = acc[m][q];",
        "if (q + 1 < cols) out[m * l + c0 + q] = acc[m][q];"),
    # B18 shares the contraction's text: its mutants edit it for ROUNDED only.
    "B18 wide body's last tap dropped": (
        f"{CSRC}/mosaic_probe.cu",
        "for (int t = 0; t < TAPS; ++t) {\n      float xv[CONTRACT_COLS];\n      widen(",
        "for (int t = 0; t < TAPS - ROUNDED; ++t) {\n      float xv[CONTRACT_COLS];\n      widen("),
    "B18 last filter not stored": (
        f"{CSRC}/mosaic_probe.cu",
        "for (int m = 0; m < FILTERS; ++m)\n#pragma unroll\n      for (int q = 0; q < CONTRACT_COLS; q += 4)",
        "for (int m = 0; m < FILTERS - ROUNDED; ++m)\n#pragma unroll\n"
        "      for (int q = 0; q < CONTRACT_COLS; q += 4)"),
    "B18 narrow body's last column not stored": (
        f"{CSRC}/mosaic_probe.cu", "if (q < cols) out[m * l + c0 + q] = acc[m][q];",
        "if (q + ROUNDED < cols) out[m * l + c0 + q] = acc[m][q];"),
    "B14 last K chunk dropped": (
        f"{CSRC}/mosaic_probe.cu", "for (int k0 = 0; k0 < k; k0 += RANK3_KC) {",
        "for (int k0 = 0; k0 == 0 || k0 + RANK3_KC < k; k0 += RANK3_KC) {"),
    "B14 ragged tile's store unmasked": (
        f"{CSRC}/mosaic_probe.cu", "if (col0 + c + o < n) orow[o] = acc[o];", "orow[o] = acc[o];"),
    "B14 second K partial left out of the sum": (
        f"{CSRC}/mosaic_probe.cu", "for (int s = 1; s < RANK3_KSPLIT; ++s)",
        "for (int s = 1; s < RANK3_KSPLIT - 1; ++s)"),
}


def mutate(root: Path, name: str) -> None:
    """Apply mutant ``name`` to the copy at ``root``."""
    rel, old, new = MUTANTS[name]
    path = root / rel
    text = path.read_text()
    if text.count(old) != 1:
        raise ValueError(f"mutant {name!r}: its text occurs {text.count(old)} times in {rel}")
    path.write_text(text.replace(old, new))


def copy_checkout(dst: Path) -> None:
    ignore = shutil.ignore_patterns("_build", "__pycache__")
    for rel in COPIED:
        src, out = ROOT / rel, dst / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        if src.is_dir():
            shutil.copytree(src, out, ignore=ignore)
        else:
            shutil.copy2(src, out)


def run_card_tests(root: Path) -> tuple:
    """(failed or erroring test names, tests selected) of the card tests in
    ``root``."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
         "-rfE", "tests/test_torch_cuda.py", "-k", SELECT],
        cwd=root, capture_output=True, text=True, timeout=900)
    failed = [line.split()[1].split("::", 1)[1] for line in proc.stdout.splitlines()
              if line.startswith(("FAILED ", "ERROR "))]
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    counts = {k: int(n) for n, k in re.findall(r"(\d+) (passed|failed|error|skipped)",
                                                summary)}
    if not counts:
        raise RuntimeError(f"pytest ran nothing in {root}:\n{proc.stdout}\n{proc.stderr}")
    return failed, sum(counts.values())


def run_copy(name: str) -> tuple:
    """(failed tests, tests selected) of a fresh copy with mutant ``name``
    applied ("none": unmutated)."""
    with tempfile.TemporaryDirectory(prefix="kernel_mutant_") as tmp:
        root = Path(tmp)
        copy_checkout(root)
        if name != "none":
            mutate(root, name)
        return run_card_tests(root)


def main(argv=None) -> int:
    words = sys.argv[1:] if argv is None else argv
    resolve_device("cuda")
    bad = []
    names = ("none", *(m for m in MUTANTS if not words or any(w in m for w in words)))
    with concurrent.futures.ThreadPoolExecutor(JOBS) as ex:
        for name, (failed, selected) in zip(names, ex.map(run_copy, names)):
            print(f"[mutant] {name}: {len(failed)} of {selected} card tests failed",
                  flush=True)
            for test in failed:
                print(f"[mutant]   {test}", flush=True)
            if (name == "none") == bool(failed):
                bad.append(name)
    if bad:
        print(f"[mutant] FAIL: {', '.join(bad)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
