"""Sweeps of the LeNet kernels' build constants:

- ``b1``: B1's warps a conv map, ``WARPS_PER_MAP`` in ``csrc/lenet_fused.cu``
  (a lane's block of its map's outputs is 6 / WARPS_PER_MAP rows by 3
  columns; an image's block has 6 x WARPS_PER_MAP warps);
- ``conv_fwd``: B3's maps a block and rows a thread, ``CONV_MAPS`` and
  ``CONV_ROWS`` in ``csrc/lenet_staged.cu`` (a block is one image and
  CONV_MAPS maps; a thread CONV_ROWS rows x 4 columns of one map);
- ``fc_fwd``: B5's warps a block, ``FC_FWD_WARPS`` in the same file;
- ``pool_fwd``: B4's source kernel (one thread an output) against
  candidate designs (``CANDIDATES``): a thread ``POOL_FWD_VEC`` lanes in
  blocks of ``POOL_FWD_THREADS``, a block's rows staged in shared memory by
  ``cp.async``, and a block an image whose 13,824-byte window block one
  bulk copy (``cp.async.bulk``) brings in on an mbarrier;
- ``pool_bwd``: B7's lanes a thread, threads a block and threads a lane
  group, ``POOL_BWD_VEC``, ``POOL_BWD_THREADS`` and ``POOL_BWD_SPLIT`` in
  the same file, against the parent's kernel (one thread an output) and
  two candidates: a block's rows built in shared memory and stored as
  float4s, and a block an image written by one bulk store;
- ``sigma_prime``: B8's float4 quads a thread, threads a block and grid
  cap, ``SIGMA_VEC``, ``SIGMA_THREADS`` and ``SIGMA_WAVE`` in the same file
  (one pass, or one resident wave that strides), against the parent's
  kernel (one thread an element) and a candidate whose loads stream
  (``__ldcs``);
- ``sgd_update``: B2's leaf list, ``SGD_THREADS``, ``SGD_UNITS`` and
  ``MAX_LEAVES`` in ``csrc/sgd_update.cu`` (whole blocks a leaf), against a
  candidate that gives a thread four elements of the packed bucket and
  finds each one's leaf by compares; at LeNet's 2,343 values and at 2^20,
  both as LeNet's 6 leaves, views of one buffer at their offsets, as the
  ``--fused-step`` path gives them after a step;
- ``tail_ce``: B12's threads a block and w values a thread loads first,
  per pool mode (``TAIL_GAP_*``; ``TAIL_MAX2_*`` for max2 and none), and
  max2's windows a thread (``TAIL_UNROLL``) in ``csrc/tail_ce.cu``, at
  ResNet-18's gap tail and the CIFAR CNN's max2 tail at batch 128
  (``chip_smoke.tail_inputs``);
- ``conv_contract``: B17/B19's columns a thread and threads a block,
  ``CONTRACT_COLS`` and ``CONTRACT_THREADS`` in ``csrc/mosaic_probe.cu``,
  against its first kernel (one thread a column), through both entry
  points at the probes' shapes;
- ``rank3_dot``: B14's output tile, columns a thread and depth slices,
  ``RANK3_TM`` x ``RANK3_TN``, ``RANK3_OUTS`` and ``RANK3_KSPLIT`` in the
  same file, against its first kernel (a 16x16 block, one output a thread,
  8 K stages), at the probe's and the odd shape;
- ``vpu_conv``: B18's columns a thread and threads a block, the same
  ``CONTRACT_COLS`` and ``CONTRACT_THREADS`` (B18 shares the contraction's
  kernel), against its first kernel (a grid row a filter, one thread a
  column), at the probe's and the odd shape.

    python -m parallel_cnn_tpu_torch.benches.lenet_sweep [b1] [conv_fwd] [fc_fwd] [pool_fwd] [pool_bwd] [sigma_prime] [sgd_update] [tail_ce] [conv_contract] [rank3_dot] [vpu_conv]

(all of them without an argument). Each variant is built from a copy of
the source in a temporary directory whose only change is its ``constexpr
int`` lines (and, for a candidate design, the spans ``CANDIDATES``
replaces), so the source keeps one choice and no switch. Each runs
through the user-facing wrapper (``lenet_fused.fused_value_and_ref_grads``,
``lenet_staged.conv_fwd``, ``fc_fwd``, ``pool_fwd``, ``pool_bwd``,
``conv_bwd_dpre``, ``sgd_update.fused_sgd_leaves``, ``tail.tail_forward``,
``mosaic_probe.mxu_conv_L``, ``mxu_conv_3d``, ``rank3_dot`` and
``vpu_conv``) with that library swapped in, at batch 64, 128 and 1000 on ``chip_smoke``'s seeded LeNet
inputs (the staged kernels at the path's own inputs,
``chip_smoke.stage_cases``; B2, B12, B14, B17–B19 at their own sizes): B1
and B12 against their plain versions (``chip_smoke.LENET_RTOL`` of the
output's scale), B14 and B17/B19 against theirs (``chip_smoke.PROBE_RTOL``),
B3, B4, B7, B8, B2 and B18 bit for bit against their plain twins, B5 bit for bit
against ``lenet_staged.fc_fwd_order``, and a relaunch bit for bit; then
device times in two rounds, the variants in order and then reversed. Prints one line per variant and batch. Exits
non-zero where a variant disagrees or differs on a relaunch. Needs the
card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import re
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Tuple, Union
from unittest import mock

import torch

BATCHES = (64, 128, 1000)
REPS = 200


class Sweep(NamedTuple):
    """One kernel's sweep: its wrapper module's name, its kernels' names
    (for their ptxas lines), the constants of each variant (and a
    ``design``, a key of CANDIDATES, for a candidate), ``inputs(n)``
    -> the wrapper's arguments, ``run(args)`` -> its outputs as a list,
    ``check(args, outs)`` -> (max |Δ| against the reference, whether that
    is within the contract), and the sizes n it runs at (batches, or B2's
    values) with their label's prefix."""

    module: str
    kernels: Tuple[str, ...]
    variants: Tuple[Dict[str, Union[int, str]], ...]
    inputs: Callable
    run: Callable
    check: Callable
    sizes: Tuple[Union[int, str], ...] = BATCHES
    prefix: str = "b"


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


def _as_list(r):
    return list(r) if isinstance(r, tuple) else [r]


def _staged_run(name):
    def run(args):
        from parallel_cnn_tpu_torch.ops import lenet_staged

        return _as_list(getattr(lenet_staged, name)(*args))
    return run


def _plain_check(name):
    """Bit for bit against the staged function's plain twin."""
    def check(args, outs):
        from parallel_cnn_tpu_torch.ops import lenet_staged

        want = _as_list(getattr(lenet_staged, f"{name}_plain")(*args))
        worst = max(float((g - w).abs().max()) for g, w in zip(outs, want))
        return worst, all(torch.equal(g, w) for g, w in zip(outs, want))
    return check


SGD_LR, SGD_SCALE = -0.1, 1.0 / 64


def _sgd_inputs(n):
    """LeNet's 6 leaves scaled to n values, views of one buffer at their
    offsets, and fresh grads (chip_smoke.sgd_leaf_operands)."""
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(n)
    return cs.sgd_leaf_operands(n, 1, gen)[0][:2]


def _sgd_run(args):
    from parallel_cnn_tpu_torch.ops import sgd_update

    return [sgd_update.fused_sgd_leaves(*args, lr=SGD_LR, scale=SGD_SCALE)]


def _sgd_check(args, outs):
    """Bit for bit against the plain update of the packed buffers."""
    from parallel_cnn_tpu_torch.ops import sgd_update

    ps, gs = args
    want = sgd_update.fused_sgd_plain(torch.cat(ps), torch.cat(gs), SGD_LR, SGD_SCALE)
    return float((outs[0] - want).abs().max()), torch.equal(outs[0], want)


def _tail_inputs(pool):
    """A zoo tail at batch 128 (chip_smoke.tail_inputs), and its pool."""
    import chip_smoke as cs

    return (*cs.tail_inputs(pool, torch.Generator(device="cuda").manual_seed(len(pool))), pool)


def _tail_run(args):
    from parallel_cnn_tpu_torch.ops import tail

    return list(tail.tail_forward(*args))


def _within(outs, want, rtol):
    """(max |Δ|, whether each output is within rtol of its scale)."""
    worst = max(float((g - w).abs().max()) for g, w in zip(outs, want))
    return worst, all(float((g - w).abs().max()) <= rtol * max(1.0, float(w.abs().max()))
                      for g, w in zip(outs, want))


def _tail_check(args, outs):
    import chip_smoke as cs
    from parallel_cnn_tpu_torch.ops import tail

    return _within(outs, tail.tail_forward_plain(*args), cs.LENET_RTOL)


def _contract_inputs(name):
    """The probe's operands of B17 or B19 (chip_smoke.probe_operands), and
    the entry point's name."""
    import chip_smoke as cs

    gen = torch.Generator(device="cuda").manual_seed(17)
    return (*cs.probe_operands(name, False, cs.card_draw(gen)), name)


def _contract_run(args):
    from parallel_cnn_tpu_torch.ops import mosaic_probe

    return [getattr(mosaic_probe, args[2])(*args[:2])]


def _contract_check(args, outs):
    import chip_smoke as cs
    from parallel_cnn_tpu_torch.ops import mosaic_probe

    return _within(outs, [mosaic_probe.mxu_conv_L_plain(*args[:2])], cs.PROBE_RTOL)


def _probe_inputs(name):
    """Probe kernel ``name``'s operands at the probe's or the odd shape
    (chip_smoke.probe_operands)."""
    def inputs(shape):
        import chip_smoke as cs

        gen = torch.Generator(device="cuda").manual_seed(14)
        return cs.probe_operands(name, shape == "odd", cs.card_draw(gen))
    return inputs


def _probe_run(name):
    def run(args):
        from parallel_cnn_tpu_torch.ops import mosaic_probe

        return [getattr(mosaic_probe, name)(*args)]
    return run


def _rank3_check(args, outs):
    import chip_smoke as cs
    from parallel_cnn_tpu_torch.ops import mosaic_probe

    return _within(outs, [mosaic_probe.rank3_dot_plain(*args)], cs.PROBE_RTOL)


def _vpu_check(args, outs):
    """Bit for bit against the plain twin."""
    from parallel_cnn_tpu_torch.ops import mosaic_probe

    want = mosaic_probe.vpu_conv_plain(*args)
    return float((outs[0] - want).abs().max()), torch.equal(outs[0], want)


# B14's output tiles; a block holds at most 1,024 threads.
_RANK3_TILES = ((16, 16), (32, 16), (16, 32), (32, 32), (8, 16), (16, 8), (8, 8), (4, 16))

# B8's one pass (a grid of any size) and, per block size, one resident wave
# of an H100 (132 SMs x 2048 threads) that strides.
_ONE_PASS = 2**30


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
                      _stage_inputs("conv_fwd"), _staged_run("conv_fwd"),
                      _plain_check("conv_fwd")),
    "fc_fwd": Sweep("lenet_staged", ("fc_fwd_kernel",),
                    tuple({"FC_FWD_WARPS": k} for k in (1, 2, 4, 8)),
                    _stage_inputs("fc_fwd"), _staged_run("fc_fwd"), _fc_check),
    "pool_fwd": Sweep("lenet_staged", ("pool_fwd_kernel",),
                      ({},)
                      + tuple({"design": "vec_fwd", "POOL_FWD_VEC": v, "POOL_FWD_THREADS": t}
                              for v in (1, 2, 4) for t in (32, 64, 128, 256))
                      + tuple({"design": "stage_fwd", "POOL_FWD_VEC": 1, "POOL_FWD_THREADS": t}
                              for t in (216, 72))
                      + ({"design": "bulk_fwd", "POOL_FWD_VEC": 4, "POOL_FWD_THREADS": 54},),
                      _stage_inputs("pool_fwd"), _staged_run("pool_fwd"),
                      _plain_check("pool_fwd")),
    "pool_bwd": Sweep("lenet_staged", ("pool_bwd_kernel",),
                      ({"design": "parent_bwd", "POOL_BWD_VEC": 1, "POOL_BWD_THREADS": 256,
                        "POOL_BWD_SPLIT": 1},)
                      + tuple({"POOL_BWD_VEC": v, "POOL_BWD_THREADS": t, "POOL_BWD_SPLIT": p}
                              for v in (1, 2, 4) for t in (32, 64, 128, 256) for p in (1, 2))
                      + tuple({"design": "stage_bwd", "POOL_BWD_VEC": 1, "POOL_BWD_THREADS": t,
                               "POOL_BWD_SPLIT": 1} for t in (216, 36))
                      + ({"design": "bulk_bwd", "POOL_BWD_VEC": 4, "POOL_BWD_THREADS": 54,
                          "POOL_BWD_SPLIT": 1},),
                      _stage_inputs("pool_bwd"), _staged_run("pool_bwd"),
                      _plain_check("pool_bwd")),
    "sigma_prime": Sweep("lenet_staged", ("sigma_prime_kernel",),
                         ({"design": "parent_sigma", "SIGMA_THREADS": 256},)
                         + tuple({"SIGMA_VEC": v, "SIGMA_THREADS": t, "SIGMA_WAVE": w}
                                 for v in (1, 2, 4) for t in (64, 128, 256)
                                 for w in (_ONE_PASS, 132 * 2048 // t))
                         + tuple({"design": "stream_sigma", "SIGMA_VEC": v, "SIGMA_THREADS": 128,
                                  "SIGMA_WAVE": w} for v in (2, 4) for w in (_ONE_PASS, 2112)),
                         _stage_inputs("sigma_prime"), _staged_run("conv_bwd_dpre"),
                         _plain_check("conv_bwd_dpre")),
    "sgd_update": Sweep("sgd_update", ("sgd_leaves_kernel",),
                        tuple({"SGD_THREADS": t, "SGD_UNITS": u} for t in (64, 128, 256)
                              for u in (1, 2, 4))
                        + tuple({"MAX_LEAVES": m} for m in (8, 32))
                        + tuple({"design": "lookup_sgd", "SGD_THREADS": t} for t in (64, 128, 256)),
                        _sgd_inputs, _sgd_run, _sgd_check, sizes=(2343, 2**20), prefix="n"),
    "tail_ce": Sweep("tail", ("tail_ce_kernel",),
                     tuple({"TAIL_GAP_THREADS": t, "TAIL_GAP_WREG": r}
                           for t in (64, 128, 256) for r in (32, 48, 96))
                     + tuple({"TAIL_MAX2_THREADS": t, "TAIL_MAX2_WREG": r}
                             for t in (256, 512) for r in (48, 96))
                     + tuple({"TAIL_UNROLL": v} for v in (1, 4)),
                     _tail_inputs, _tail_run, _tail_check, sizes=("gap", "max2"), prefix=""),
    "conv_contract": Sweep("mosaic_probe", ("conv_contract_kernel",),
                           ({"design": "parent_contract"},)
                           + tuple({"CONTRACT_COLS": c, "CONTRACT_THREADS": t}
                                   for c in (2, 4, 8) for t in (32, 64, 128, 256)),
                           _contract_inputs, _contract_run, _contract_check,
                           sizes=("mxu_conv_L", "mxu_conv_3d"), prefix=""),
    "rank3_dot": Sweep("mosaic_probe", ("batched_matmul_kernel",),
                       ({"design": "parent_rank3"},)
                       + tuple({"RANK3_TM": tm, "RANK3_TN": tn, "RANK3_OUTS": o, "RANK3_KSPLIT": k}
                               for tm, tn in _RANK3_TILES for o in (1, 2, 4) for k in (1, 2, 4)
                               if tm * tn // o * k <= 1024),
                       _probe_inputs("rank3_dot"), _probe_run("rank3_dot"), _rank3_check,
                       sizes=("probe", "odd"), prefix=""),
    "vpu_conv": Sweep("mosaic_probe", ("conv_contract_kernel", "per_filter_conv_kernel"),
                      ({"design": "parent_vpu"},)
                      + tuple({"CONTRACT_COLS": c, "CONTRACT_THREADS": t}
                              for c in (2, 4, 8) for t in (32, 64, 128, 256)),
                      _probe_inputs("vpu_conv"), _probe_run("vpu_conv"), _vpu_check,
                      sizes=("probe", "odd"), prefix=""),
}


# Candidate designs. Each is a list of (pattern, text): the one span of
# the source each pattern matches is replaced by its text, before the
# variant's constants are set. Each keeps its kernel's signature.
#
# B4's candidates replace the source's kernel (one thread an output) and
# its C entry by a grid of POOL_FWD_GROUPS = 216 / POOL_FWD_VEC lane groups
# an image in blocks of POOL_FWD_THREADS, which refuses a pre or out off
# the 16-byte boundary.
_FWD_KERNEL = r"__global__ void __launch_bounds__\(THREADS\)\npool_fwd_kernel\(.*?\n}\n"
_FWD_ENTRY = r'extern "C" int lenet_pool_fwd\(.*?\n}\n'
_FWD_GRID = r"""constexpr int POOL_FWD_VEC = 4;
constexpr int POOL_FWD_THREADS = 64;
constexpr int POOL_FWD_GROUPS = LANES / POOL_FWD_VEC;
static_assert(LANES % POOL_FWD_VEC == 0, "whole lane groups");

"""
_FWD_GRID_ENTRY = r"""extern "C" int lenet_pool_fwd(const float* xw, const float* w, const float* b,
                              float* pre, float* out, int n, void* stream) {
  const long long groups = static_cast<long long>(n) * POOL_FWD_GROUPS;
  const long long blocks = (groups + POOL_FWD_THREADS - 1) / POOL_FWD_THREADS;
  if (n <= 0 || blocks > INT_MAX || !aligned16(pre) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  pool_fwd_kernel<<<static_cast<int>(blocks), POOL_FWD_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(xw, w, b, pre, out, groups);
  return launched();
}
"""
# A thread POOL_FWD_VEC neighbouring lanes of one image: its taps first,
# then its 16 rows as float4 (float2, float) loads, each lane the bias and
# the taps in t order.
_VEC_FWD = r"""__global__ void __launch_bounds__(POOL_FWD_THREADS)
pool_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ pre,
                float* __restrict__ out, long long groups) {
  constexpr int V = POOL_FWD_VEC;
  const long long g = static_cast<long long>(blockIdx.x) * POOL_FWD_THREADS + threadIdx.x;
  if (g >= groups) return;
  const long long img = g / POOL_FWD_GROUPS;
  const int l0 = static_cast<int>(g - img * POOL_FWD_GROUPS) * V;
  const float* xi = xw + img * (TAPS * LANES) + l0;
  float wr[TAPS];
  load_taps<TAPS>(wr, w);
  const float b = __ldg(bias);
  float x[TAPS][V];
  if (aligned_vec<V>(xw)) {
#pragma unroll
    for (int t = 0; t < TAPS; ++t) load_vec<V>(x[t], xi + t * LANES);
  } else {
#pragma unroll
    for (int t = 0; t < TAPS; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) x[t][k] = __ldg(xi + t * LANES + k);
  }
  float acc[V], s[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = b;
#pragma unroll
  for (int t = 0; t < TAPS; ++t)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wr[t], x[t][k]));
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = sigmoid(acc[k]);
  store_vec<V>(pre + g * V, acc);
  store_vec<V>(out + g * V, s);
}
"""
_STAGE_FWD = r"""__global__ void __launch_bounds__(POOL_FWD_THREADS)
pool_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ pre,
                float* __restrict__ out, long long groups) {
  constexpr int SEG = POOL_FWD_THREADS;
  static_assert(POOL_FWD_VEC == 1 && LANES % SEG == 0 && SEG % 4 == 0, "whole float4s");
  __shared__ __align__(16) float xs[TAPS * SEG];
  const int tid = threadIdx.x;
  const long long g0 = static_cast<long long>(blockIdx.x) * SEG;
  const long long img = g0 / LANES;
  const float* xi = xw + img * (TAPS * LANES) + (g0 - img * LANES);
  if (aligned16(xw)) {
    for (int i = tid; i < TAPS * SEG / 4; i += SEG) {
      const int t = i / (SEG / 4);
      const int q = i - t * (SEG / 4);
      ftile::cp_async16(xs + t * SEG + 4 * q, xi + t * LANES + 4 * q, true);
    }
  } else {
    for (int i = tid; i < TAPS * SEG; i += SEG) {
      const int t = i / SEG;
      ftile::cp_async4(xs + i, xi + t * LANES + (i - t * SEG), true);
    }
  }
  ftile::cp_async_commit();
  float wr[TAPS];
#pragma unroll
  for (int t = 0; t < TAPS; ++t) wr[t] = __ldg(w + t);
  float acc = __ldg(bias);
  ftile::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int t = 0; t < TAPS; ++t) acc = __fadd_rn(acc, __fmul_rn(wr[t], xs[t * SEG + tid]));
  pre[g0 + tid] = acc;
  out[g0 + tid] = sigmoid(acc);
}
"""
# A block an image (54 threads of 4 lanes), its 13,824-byte window block
# brought into shared memory by one bulk copy on an mbarrier.
_BULK_FWD = r"""__global__ void __launch_bounds__(POOL_FWD_THREADS)
pool_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ pre,
                float* __restrict__ out, long long groups) {
  static_assert(POOL_FWD_VEC == 4 && POOL_FWD_THREADS == POOL_FWD_GROUPS, "a block an image");
  constexpr unsigned BYTES = TAPS * LANES * 4;
  __shared__ __align__(128) float xs[TAPS * LANES];
  __shared__ __align__(8) unsigned long long bar;
  const int tid = threadIdx.x;
  const long long img = blockIdx.x;
  const float* xi = xw + img * (TAPS * LANES);
  const bool bulk = aligned16(xw);
  const unsigned b = ftile::smem_u32(&bar);
  if (bulk) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(b), "r"(1u) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
                   "r"(BYTES) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(ftile::smem_u32(xs)), "l"(xi), "r"(BYTES), "r"(b) : "memory");
    }
  }
  float x[TAPS][4];
  if (bulk) {
    asm volatile(
        "{\n.reg .pred P1;\nWAIT:\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(b), "r"(0u) : "memory");
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(xs + t * LANES + 4 * tid);
      x[t][0] = a.x, x[t][1] = a.y, x[t][2] = a.z, x[t][3] = a.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < TAPS; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) x[t][k] = __ldg(xi + t * LANES + 4 * tid + k);
  }
  const float bv = __ldg(bias);
  float acc[4], s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = bv;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const float wt = __ldg(w + t);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wt, x[t][k]));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = sigmoid(acc[k]);
  const long long o = img * LANES + 4 * tid;
  store_vec<4>(pre + o, acc);
  store_vec<4>(out + o, s);
}
"""

# B7's candidates replace its kernel, with the source's grid: the parent's
# kernel (one thread an output, built with POOL_BWD_VEC 1, POOL_BWD_THREADS
# 256 and POOL_BWD_SPLIT 1), a block a segment of lanes whose rows are
# built in shared memory and stored as float4s, and a block an image whose
# rows are written by one bulk store.
_BWD_KERNEL = r"__global__ void __launch_bounds__\(POOL_BWD_THREADS\)\npool_bwd_kernel\(.*?\n}\n"
_PARENT_BWD = r"""__global__ void __launch_bounds__(POOL_BWD_THREADS)
pool_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ pre,
                const float* __restrict__ w, float* __restrict__ dpre,
                float* __restrict__ dxw, long long total) {
  const long long idx = global_index();
  if (idx >= total) return;
  const long long img = idx / LANES;
  const int lane = static_cast<int>(idx - img * LANES);
  const float s = sigmoid(pre[idx]);
  const float dp = dout[idx] * s * (1.0f - s);
  dpre[idx] = dp;
  float* di = dxw + img * (TAPS * LANES) + lane;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) di[t * LANES] = w[t] * dp;
}
"""
_STAGE_BWD = r"""__global__ void __launch_bounds__(POOL_BWD_THREADS)
pool_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ pre,
                const float* __restrict__ w, float* __restrict__ dpre,
                float* __restrict__ dxw, long long threads) {
  constexpr int SEG = POOL_BWD_THREADS;
  static_assert(POOL_BWD_VEC == 1 && POOL_BWD_SPLIT == 1 && LANES % SEG == 0 && SEG % 4 == 0,
                "whole float4s");
  __shared__ __align__(16) float ds[TAPS * SEG];
  const int tid = threadIdx.x;
  const long long g0 = static_cast<long long>(blockIdx.x) * SEG;
  const long long img = g0 / LANES;
  const float s = sigmoid(__ldg(pre + g0 + tid));
  const float dp = __ldg(dout + g0 + tid) * s * (1.0f - s);
  dpre[g0 + tid] = dp;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) ds[t * SEG + tid] = __ldg(w + t) * dp;
  __syncthreads();
  float* di = dxw + img * (TAPS * LANES) + (g0 - img * LANES);
  for (int i = tid; i < TAPS * SEG / 4; i += SEG) {
    const int t = i / (SEG / 4);
    const int q = i - t * (SEG / 4);
    *reinterpret_cast<float4*>(di + t * LANES + 4 * q) =
        *reinterpret_cast<const float4*>(ds + t * SEG + 4 * q);
  }
}
"""
_BULK_BWD = r"""__global__ void __launch_bounds__(POOL_BWD_THREADS)
pool_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ pre,
                const float* __restrict__ w, float* __restrict__ dpre,
                float* __restrict__ dxw, long long threads) {
  static_assert(POOL_BWD_VEC == 4 && POOL_BWD_SPLIT == 1 && POOL_BWD_THREADS == POOL_BWD_GROUPS,
                "a block an image");
  constexpr unsigned BYTES = TAPS * LANES * 4;
  __shared__ __align__(128) float ds[TAPS * LANES];
  const int tid = threadIdx.x;
  const long long img = blockIdx.x;
  const long long o = img * LANES + 4 * tid;
  float d[4], p[4], dp[4];
  load_lanes<4>(d, dout + o);
  load_lanes<4>(p, pre + o);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float s = sigmoid(p[k]);
    dp[k] = d[k] * s * (1.0f - s);
  }
  store_vec<4>(dpre + o, dp);
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const float wt = __ldg(w + t);
    *reinterpret_cast<float4*>(ds + t * LANES + 4 * tid) =
        make_float4(wt * dp[0], wt * dp[1], wt * dp[2], wt * dp[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     dxw + img * (TAPS * LANES)), "r"(ftile::smem_u32(ds)), "r"(BYTES)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}
"""

# B8's parent: one thread an element, a 4-byte load of d and pre and a
# 4-byte store each, blocks of SIGMA_THREADS.
_SIGMA_KERNEL = r"__global__ void __launch_bounds__\(SIGMA_THREADS\)\nsigma_prime_kernel\(.*?\n}\n"
_SIGMA_ENTRY = r'extern "C" int lenet_sigma_prime\(.*?\n}\n'
_SIGMA_LOAD = r"__device__ __forceinline__ void load_quad\(.*?\n}\n"
_PARENT_SIGMA = r"""__global__ void __launch_bounds__(SIGMA_THREADS)
sigma_prime_kernel(const float* __restrict__ d, const float* __restrict__ pre,
                   float* __restrict__ out, long long quads) {
  const long long idx = static_cast<long long>(blockIdx.x) * SIGMA_THREADS + threadIdx.x;
  if (idx >= 4 * quads) return;
  const float s = sigmoid(pre[idx]);
  out[idx] = d[idx] * s * (1.0f - s);
}
"""
_PARENT_SIGMA_ENTRY = r"""extern "C" int lenet_sigma_prime(const float* d, const float* pre, float* out,
                                 int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long quads = static_cast<long long>(n) * CONV_QUADS;
  sigma_prime_kernel<<<static_cast<int>((4 * quads + SIGMA_THREADS - 1) / SIGMA_THREADS),
                       SIGMA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(d, pre, out,
                                                                              quads);
  return launched();
}
"""
# B8's loads as streaming loads (evict first: each input is read once).
_STREAM_SIGMA_LOAD = r"""__device__ __forceinline__ void load_quad(float (&v)[4], const float* __restrict__ p,
                                          bool vec) {
  if (vec) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
    v[0] = __ldcs(p), v[1] = __ldcs(p + 1), v[2] = __ldcs(p + 2), v[3] = __ldcs(p + 3);
  }
}
"""
# B2 with a thread four neighbouring elements of the packed output span,
# each element's leaf found by compares against the prefix offsets (from
# the previous element's), 4-byte loads, a float4 store where the span
# lies on the 16-byte boundary; the grid from the span's length.
_SGD_KERNEL = (r"__global__ void __launch_bounds__\(SGD_THREADS\)\n"
               r"sgd_leaves_kernel\(.*?\n}\n")
_SGD_LAUNCH = r"sgd_leaves_kernel<<<static_cast<int>\(blocks\), SGD_THREADS"
_LOOKUP_SGD = r"""__global__ void __launch_bounds__(SGD_THREADS)
sgd_leaves_kernel(const __grid_constant__ SgdLeafList list, float* __restrict__ out,
                  float lr, float scale) {
  const SgdLeaf& last = list.e[list.count - 1];
  const long long total = last.off + last.n;
  const long long i0 = (static_cast<long long>(blockIdx.x) * SGD_THREADS + threadIdx.x) * 4;
  if (i0 >= total) return;
  int e = 0;
  float o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long i = i0 + j;
    while (e + 1 < list.count && i >= list.e[e + 1].off) ++e;
    const SgdLeaf& x = list.e[e];
    o[j] = i < total ? sgd(__ldg(x.p + (i - x.off)), __ldg(x.g + (i - x.off)), lr, scale)
                     : 0.0f;
  }
  if (i0 + 4 <= total && (reinterpret_cast<std::uintptr_t>(out) & 15u) == 0) {
    *reinterpret_cast<float4*>(out + i0) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (i0 + j < total) out[i0 + j] = o[j];
    }
  }
}
"""
_LOOKUP_SGD_LAUNCH = ("sgd_leaves_kernel<<<static_cast<int>(((off + 3) / 4 + SGD_THREADS - 1) "
                      "/ SGD_THREADS), SGD_THREADS")

# B17/B19's first kernel, one thread a column in blocks of 256, for the
# conv_contract sweep (B18, which shares the contraction, runs it with its
# rounding in this variant; the sweep runs only B17/B19).
_CONTRACT_KERNEL = (r"template <bool WIDE, bool ROUNDED>\n"
                    r"__global__ void __launch_bounds__\(CONTRACT_THREADS\)\n"
                    r"conv_contract_kernel\(.*?\n}\n")
_CONTRACT_ENTRY = r"template <bool ROUNDED>\nint launch_contract\(.*?\n}\n"
_PARENT_CONTRACT = r"""constexpr int CONV_THREADS = 256;

template <bool ROUNDED>
__global__ void __launch_bounds__(CONV_THREADS)
conv_contract_kernel(const float* __restrict__ w,
                     const __nv_bfloat16* __restrict__ x,
                     float* __restrict__ out, long long l) {
  __shared__ float ws[FILTERS * TAPS];
  for (int i = threadIdx.x; i < FILTERS * TAPS; i += CONV_THREADS) ws[i] = w[i];
  __syncthreads();
  const long long col =
      static_cast<long long>(blockIdx.x) * CONV_THREADS + threadIdx.x;
  if (col >= l) return;
  float acc[FILTERS];
#pragma unroll
  for (int m = 0; m < FILTERS; ++m) acc[m] = 0.f;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    const float xv = __bfloat162float(x[t * l + col]);
#pragma unroll
    for (int m = 0; m < FILTERS; ++m) acc[m] = madd<ROUNDED>(ws[m * TAPS + t], xv, acc[m]);
  }
#pragma unroll
  for (int m = 0; m < FILTERS; ++m) out[m * l + col] = acc[m];
}
"""
_PARENT_CONTRACT_ENTRY = r"""template <bool ROUNDED>
int launch_contract(const float* w, const void* x, float* out, long long l,
                    void* stream) {
  const long long blocks = (l + CONV_THREADS - 1) / CONV_THREADS;
  if (l <= 0 || blocks > 0x7fffffffLL) return invalid();
  conv_contract_kernel<ROUNDED><<<static_cast<unsigned>(blocks), CONV_THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const __nv_bfloat16*>(x), out, l);
  return status();
}
"""

# B18's first kernel: a grid row a filter, one thread a column in
# blocks of 256, w's row staged behind a barrier before x's loads, x read
# once a filter. It replaces the entry, which then launches it instead of
# the contraction.
_VPU_ENTRY = r'extern "C" int probe_vpu_conv\(.*?\n}\n'
_PARENT_VPU = r"""constexpr int CONV_THREADS = 256;

__global__ void __launch_bounds__(CONV_THREADS)
per_filter_conv_kernel(const float* __restrict__ w,
                       const __nv_bfloat16* __restrict__ x,
                       float* __restrict__ out, long long l) {
  __shared__ float ws[TAPS];
  const int m = blockIdx.y;
  if (threadIdx.x < TAPS) ws[threadIdx.x] = w[m * TAPS + threadIdx.x];
  __syncthreads();
  const long long col =
      static_cast<long long>(blockIdx.x) * CONV_THREADS + threadIdx.x;
  if (col >= l) return;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < TAPS; ++t) {
    acc = __fadd_rn(acc, __fmul_rn(ws[t], __bfloat162float(x[t * l + col])));
  }
  out[m * l + col] = acc;
}

extern "C" int probe_vpu_conv(const float* w, const void* x, float* out,
                              long long l, void* stream) {
  const long long blocks = (l + CONV_THREADS - 1) / CONV_THREADS;
  if (l <= 0 || blocks > 0x7fffffffLL) return invalid();
  per_filter_conv_kernel<<<dim3(static_cast<unsigned>(blocks), FILTERS),
                           CONV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<const __nv_bfloat16*>(x), out, l);
  return status();
}
"""

# B14's first kernel: a 16x16 block of one output a thread, K in
# stages of 16 staged through shared memory, two barriers a stage, and its
# entry (a grid of (column tiles, row tiles, batch)).
_RANK3_KERNEL = (r"__global__ void __launch_bounds__\(RANK3_THREADS\)\n"
                 r"batched_matmul_kernel\(.*?\n}\n")
_RANK3_ENTRY = r'extern "C" int probe_rank3_dot\(.*?\n}\n'
_PARENT_RANK3 = r"""constexpr int TILE = 16;

__global__ void __launch_bounds__(TILE * TILE)
batched_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, int m, int k, int n) {
  __shared__ float as[TILE][TILE + 1];
  __shared__ float bs[TILE][TILE + 1];
  const long long batch = blockIdx.z;
  const int row = blockIdx.y * TILE + threadIdx.y;
  const int col = blockIdx.x * TILE + threadIdx.x;
  const float* ab = a + batch * m * k;
  const float* bb = b + batch * k * n;
  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += TILE) {
    const int ka = k0 + threadIdx.x;
    const int kb = k0 + threadIdx.y;
    as[threadIdx.y][threadIdx.x] =
        (row < m && ka < k) ? ab[static_cast<long long>(row) * k + ka] : 0.f;
    bs[threadIdx.y][threadIdx.x] =
        (kb < k && col < n) ? bb[static_cast<long long>(kb) * n + col] : 0.f;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      acc = fmaf(as[threadIdx.y][j], bs[j][threadIdx.x], acc);
    }
    __syncthreads();
  }
  if (row < m && col < n) {
    out[(batch * m + row) * n + col] = acc;
  }
}
"""
_PARENT_RANK3_ENTRY = r"""extern "C" int probe_rank3_dot(const float* a, const float* b, float* out,
                               int batch, int m, int k, int n, void* stream) {
  if (batch <= 0 || batch > 65535 || m <= 0 || k <= 0 || n <= 0) return invalid();
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  if (grid.y > 65535) return invalid();
  batched_matmul_kernel<<<grid, dim3(TILE, TILE), 0,
                          static_cast<cudaStream_t>(stream)>>>(a, b, out, m, k, n);
  return status();
}
"""

#: design name -> [(pattern, text), ...].
CANDIDATES = {
    "vec_fwd": [(_FWD_KERNEL, _FWD_GRID + _VEC_FWD), (_FWD_ENTRY, _FWD_GRID_ENTRY)],
    "stage_fwd": [(_FWD_KERNEL, _FWD_GRID + _STAGE_FWD), (_FWD_ENTRY, _FWD_GRID_ENTRY)],
    "bulk_fwd": [(_FWD_KERNEL, _FWD_GRID + _BULK_FWD), (_FWD_ENTRY, _FWD_GRID_ENTRY)],
    "parent_bwd": [(_BWD_KERNEL, _PARENT_BWD)],
    "stage_bwd": [(_BWD_KERNEL, _STAGE_BWD)],
    "bulk_bwd": [(_BWD_KERNEL, _BULK_BWD)],
    "parent_sigma": [(_SIGMA_KERNEL, _PARENT_SIGMA), (_SIGMA_ENTRY, _PARENT_SIGMA_ENTRY)],
    "stream_sigma": [(_SIGMA_LOAD, _STREAM_SIGMA_LOAD)],
    "lookup_sgd": [(_SGD_KERNEL, _LOOKUP_SGD), (_SGD_LAUNCH, _LOOKUP_SGD_LAUNCH)],
    "parent_contract": [(_CONTRACT_KERNEL, _PARENT_CONTRACT),
                        (_CONTRACT_ENTRY, _PARENT_CONTRACT_ENTRY)],
    "parent_vpu": [(_VPU_ENTRY, _PARENT_VPU)],
    "parent_rank3": [(_RANK3_KERNEL, _PARENT_RANK3), (_RANK3_ENTRY, _PARENT_RANK3_ENTRY)],
}


def label(consts: Dict[str, Union[int, str]]) -> str:
    return " ".join(f"{k}={v}" for k, v in consts.items()) or "source"


def variant(root: Path, module, consts: Dict[str, Union[int, str]]):
    """A Library of ``module``'s source with each ``constexpr int NAME``
    line of ``consts`` set to its value (and a ``design``'s kernel
    replaced by its CANDIDATES text), the source (and the headers it
    includes) copied under ``root``."""
    from parallel_cnn_tpu_torch.ops import _cuda_build

    lib = module._library
    d = root / re.sub(r"\W+", "_", f"{lib.source.stem} {label(consts)}")
    d.mkdir()
    text = lib.source.read_text()
    for name, value in consts.items():
        if name == "design":
            for pattern, replacement in CANDIDATES[value]:
                text, count = re.subn(pattern, lambda _: replacement, text, flags=re.S)
                if count != 1:
                    raise ValueError(f"{lib.source.name} has {count} spans matching {value}'s")
            continue
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
    root = tmp / name  # sweeps of one source may set the same constants
    root.mkdir()
    libs = [variant(root, module, c) for c in sweep.variants]
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
    for n in sweep.sizes:
        args = sweep.inputs(n)
        for consts, lib in zip(sweep.variants, libs):
            with swapped(module, lib):
                got, again = sweep.run(args), sweep.run(args)
            worst, ok = sweep.check(args, got)
            same = all(torch.equal(g, a) for g, a in zip(got, again))
            print(f"[sweep] {name} {label(consts)} {sweep.prefix}{n}: max |Δ| vs its reference "
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
            print(f"[sweep] time {name} {label(consts)} {sweep.prefix}{n}: "
                  f"{sum(t) / len(t) * 1e3:.3f} us "
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
