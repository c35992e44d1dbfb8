"""Differential tests of the staged LeNet-ref kernel library
(``parallel_cnn_tpu_torch/ops/lenet_staged.py``, the port of the per-op tier
of ``parallel_cnn_tpu/ops/pallas.py``: B3–B9) against the JAX package's
functions of the same names, which run their Pallas kernels in interpret
mode on the CPU.

The same numpy inputs from a seed go to both; params cross with
``convert.lenet_from_jax``. On a CPU tensor every wrapper runs its plain
twin; the kernels themselves are held against the plain twins on the card
(tests/test_torch_cuda.py, chip_smoke.py). Tolerances are JAX's own for
this tier (tests/test_ops_pallas.py): 1e-5 absolute and relative, 1e-6 on
the mean error.
"""

import functools
import re
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from parallel_cnn_tpu.models import lenet_ref as jlenet
from parallel_cnn_tpu.ops import pallas as jpallas
from parallel_cnn_tpu_torch import convert
from parallel_cnn_tpu_torch.ops import _cuda_build, lenet_fused, lenet_staged
from parallel_cnn_tpu_torch.ops import reference as tref
from parallel_cnn_tpu_torch.utils.tree import tree_leaves

from chip_smoke import stage_cases

ATOL = RTOL = 1e-5
ERR_ATOL = 1e-6
SIZES = [1, 5, 8]
# 37 is no multiple of JAX's CONV_BLOCK (32): JAX pads it to 64 and masks
# the pad rows out of the error; the port runs exactly 37 rows.
PATH_SIZES = SIZES + [37]
SOURCE = _cuda_build.CSRC / "lenet_staged.cu"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: keep PyTorch's
    CPU kernels to two threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jlenet.init(jax.random.key(7)))


def port_params():
    return convert.lenet_from_jax(jax_params())


@functools.lru_cache(maxsize=None)
def arrays(n):
    """Every stage's inputs at batch n, f32 numpy arrays from the seed n."""
    rng = np.random.default_rng(100 + n)

    def f32(a):
        return np.asarray(a, dtype=np.float32)

    return {
        "xs": f32(rng.uniform(0, 1, (n, 28, 28))),
        "ys": rng.integers(0, 10, (n,)).astype(np.int32),
        "c1": f32(rng.uniform(0, 1, (n, 6, 24, 24))),
        "xw": f32(rng.uniform(0, 1, (n, 16, 216))),
        "s1": f32(rng.uniform(0, 1, (n, 216))),
        "pre_s1": f32(rng.normal(0, 2, (n, 216))),
        "pre_c1": f32(rng.normal(0, 2, (n, 6, 24, 24))),
        "d_f": f32(rng.uniform(-1, 1, (n, 10))),
        "d_s1": f32(rng.normal(0, 0.5, (n, 216))),
        "d_c1": f32(rng.normal(0, 0.5, (n, 6, 24, 24))),
    }


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close(got, want, atol=ATOL, rtol=RTOL, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=name)


# ---------------------------------------------------------------------------
# Each kernel function's plain twin against JAX's Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_conv_fwd_matches_jax(n):
    a, jp = arrays(n), jax_params()
    want = jpallas.conv_fwd(a["xs"], jp["c1"]["w"], jp["c1"]["b"])
    tp = port_params()
    got = lenet_staged.conv_fwd(t(a["xs"]), tp["c1"]["w"], tp["c1"]["b"])
    for g, w, name in zip(got, want, ("pre_c1", "out_c1")):
        close(g, w, name=name)


@pytest.mark.parametrize("n", SIZES)
def test_pool_fwd_matches_jax(n):
    a, jp, tp = arrays(n), jax_params(), port_params()
    want = jpallas.pool_fwd(a["xw"], jp["s1"]["w"], jp["s1"]["b"])
    got = lenet_staged.pool_fwd(t(a["xw"]), tp["s1"]["w"], tp["s1"]["b"])
    for g, w, name in zip(got, want, ("pre_s1", "out_s1")):
        close(g, w, name=name)


@pytest.mark.parametrize("n", SIZES)
def test_fc_fwd_matches_jax(n):
    a, jp, tp = arrays(n), jax_params(), port_params()
    want = jpallas.fc_fwd(a["s1"], jp["f"]["w"], jp["f"]["b"])
    got = lenet_staged.fc_fwd(t(a["s1"]), tp["f"]["w"], tp["f"]["b"])
    for g, w, name in zip(got, want, ("pre_f", "out_f")):
        close(g, w, name=name)


@pytest.mark.parametrize("n", SIZES)
def test_fc_fwd_order_matches_plain_and_jax(n):
    """lenet_staged.fc_fwd_order (B5's fixed summation order in f32 numpy,
    which the card's pre_f equals bit for bit) against the plain twin and
    JAX's fc_fwd in interpret mode, within the file's tolerance."""
    a, jp, tp = arrays(n), jax_params(), port_params()
    got = lenet_staged.fc_fwd_order(a["s1"], tp["f"]["w"].numpy(), tp["f"]["b"].numpy())
    assert got.dtype == np.float32 and got.shape == (n, 10)
    close(got, lenet_staged.fc_fwd_plain(t(a["s1"]), tp["f"]["w"], tp["f"]["b"])[0], name="plain")
    close(got, jpallas.fc_fwd(a["s1"], jp["f"]["w"], jp["f"]["b"])[0], name="jax")


def test_fc_fwd_order_sums_k_upward_then_the_butterfly():
    """Within a lane k runs upward, one fma a term: 1e8, then + 1 (lost to
    rounding), then − 1e8 gives 0. Across lanes the xor butterfly pairs
    lane 0 with 16 first and with 1 last: 1e8 in lane 0, 1 in lane 16 and
    −1e8 in lane 8 give 0, while the 1 moved to lane 1 survives."""
    w, b = np.zeros((10, 216), np.float32), np.zeros(10, np.float32)
    w[0] = 1.0
    x = np.zeros((1, 216), np.float32)
    x[0, :3] = 1e8, 1.0, -1e8
    assert lenet_staged.fc_fwd_order(x, w, b)[0, 0] == 0.0
    k = lenet_staged.FC_K
    x[0, :3] = 0.0
    x[0, 0], x[0, 16 * k], x[0, 8 * k] = 1e8, 1.0, -1e8
    assert lenet_staged.fc_fwd_order(x, w, b)[0, 0] == 0.0
    x[0, 16 * k], x[0, k] = 0.0, 1.0
    assert lenet_staged.fc_fwd_order(x, w, b)[0, 0] == 1.0


def test_fc_fwd_order_is_the_same_for_every_image_and_batch():
    """An image's pre_f depends on its own row alone: the order is the
    layout's, not the batch's."""
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (37, 216)).astype(np.float32)
    w = (rng.standard_normal((10, 216)) * 0.1).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    whole = lenet_staged.fc_fwd_order(x, w, b)
    for i in (0, 17, 36):
        np.testing.assert_array_equal(whole[i], lenet_staged.fc_fwd_order(x[i:i + 1], w, b)[0])
    np.testing.assert_array_equal(whole[5:9], lenet_staged.fc_fwd_order(x[5:9], w, b))


def _source_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


def test_conv_fwd_partition_covers_every_output_once():
    """B3's partition from csrc/lenet_staged.cu's constants: a block an
    (image, CONV_MAPS maps), a thread CONV_ROWS rows x 4 columns of one
    map. Over one image's blocks every (map, row, column) is written once;
    each thread's 5 x 8 window of x lies inside the 28 x 28 image, its
    float4 reads and stores land on 16-byte boundaries, and the staged
    image fits in the 48 KB of static shared memory."""
    maps, rows, strips = (_source_const(k) for k in ("CONV_MAPS", "CONV_ROWS", "CONV_STRIPS"))
    assert strips * 4 == 24 and 6 % maps == 0 and 24 % rows == 0
    threads = maps * strips * (24 // rows)
    assert threads <= 1024 and 784 * 4 <= 48 * 1024
    written = np.zeros((6, 24, 24), np.int64)
    for group in range(6 // maps):
        for tid in range(threads):
            m = group * maps + tid // (strips * (24 // rows))
            t_ = tid % (strips * (24 // rows))
            r0, c0 = (t_ // strips) * rows, (t_ % strips) * 4
            assert r0 + rows - 1 + 4 <= 27 and c0 + 7 <= 27
            for r in range(r0, r0 + rows):
                assert ((r + 4) * 28 + c0) % 4 == 0 and ((m * 24 + r) * 24 + c0) % 4 == 0
                written[m, r, c0:c0 + 4] += 1
    assert (written == 1).all()


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 200_000))
def test_fc_fwd_grid_covers_every_image_once(n):
    """B5's grid from csrc/lenet_staged.cu's constants: ceil(min(n, WAVE) /
    FC_FWD_WARPS) blocks, warp v taking images v, v + warps, ...: every
    image once, at most FC_FWD_WAVE warps, and 27 lanes of FC_K covering
    the 216 features."""
    warps_a_block, wave = _source_const("FC_FWD_WARPS"), _source_const("FC_FWD_WAVE")
    assert _source_const("FC_K") == lenet_staged.FC_K and 216 % lenet_staged.FC_K == 0
    assert 216 // lenet_staged.FC_K <= 32
    blocks = -(-min(n, wave) // warps_a_block)
    warps = blocks * warps_a_block
    assert warps <= wave + warps_a_block - 1 and blocks * warps_a_block * 32 <= 2**31 - 1
    seen = np.concatenate([np.arange(v, n, warps) for v in range(min(warps, n))])
    assert len(seen) == n and (np.sort(seen) == np.arange(n)).all()


def _kernel_text(name):
    """The definition of ``__global__`` kernel ``name`` in the source."""
    return re.search(rf"\n{name}\(.*?\n}}\n", SOURCE.read_text(), re.S).group(0)


def _pool_grid(n, vec, threads_a_block, split=1):
    """B4's or B7's grid over n images: (threads, blocks), checked to cover
    every thread with no block past the last one."""
    assert 216 % vec == 0 and vec in (1, 2, 4) and 16 % split == 0
    threads = n * split * (216 // vec)
    blocks = -(-threads // threads_a_block)
    assert (blocks - 1) * threads_a_block < threads <= blocks * threads_a_block
    assert blocks <= 2**31 - 1 and threads_a_block <= 1024
    return threads, blocks


def _sample_images(n):
    return sorted({0, 1, n // 2, n - 2, n - 1} & set(range(n)))


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 200_000))
def test_pool_fwd_grid_covers_every_lane_once(n):
    """B4's grid from csrc/lenet_staged.cu's constants: one thread an
    output, n · 216 threads in blocks of THREADS, thread g owning lane
    g mod 216 of image g // 216 (pre and out at g). Over each sampled
    image's threads every lane is written once, its 16 taps read from
    that image's window block. The kernel stages nothing in shared
    memory."""
    tpb = _source_const("THREADS")
    threads, _ = _pool_grid(n, 1, tpb)
    assert "__shared__" not in _kernel_text("pool_fwd_kernel")
    for img in _sample_images(n):
        g = np.arange(img * 216, (img + 1) * 216)
        assert (g < threads).all() and (g // 216 == img).all()
        assert (np.sort(g % 216) == np.arange(216)).all()
        taps = img * 3456 + np.arange(16)[:, None] * 216 + g % 216
        assert taps.min() >= img * 3456 and taps.max() < (img + 1) * 3456
        assert len(np.unique(taps)) == 3456


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 200_000))
def test_pool_bwd_grid_covers_every_row_once(n):
    """B7's grid from the same constants: n · POOL_BWD_SPLIT · 216 /
    POOL_BWD_VEC threads, thread g owning lanes l0 onward of image
    g // (SPLIT · groups) and rows part · 16 / SPLIT onward of its dxw
    (part 0 also dpre). Over each sampled image's threads every (tap row,
    lane) of dxw and every lane of dpre is written once, and every access
    lies a whole number of VEC-float accesses from its base. The kernel
    stages nothing in shared memory."""
    vec, tpb, split = (_source_const(k) for k in
                       ("POOL_BWD_VEC", "POOL_BWD_THREADS", "POOL_BWD_SPLIT"))
    groups, rows = 216 // vec, 16 // split
    threads, _ = _pool_grid(n, vec, tpb, split)
    assert "__shared__" not in _kernel_text("pool_bwd_kernel")
    for img in _sample_images(n):
        g = np.arange(img * split * groups, (img + 1) * split * groups)
        assert (g < threads).all()
        row = g // groups
        assert (row // split == img).all()
        part, l0 = row % split, (g % groups) * vec
        dxw = np.zeros((16, 216), np.int64)
        dpre = np.zeros(216, np.int64)
        for p, l in zip(part, l0):
            assert (img * 3456 + p * rows * 216 + l) % vec == 0 and (img * 216 + l) % vec == 0
            dxw[p * rows:(p + 1) * rows, l:l + vec] += 1
            dpre[l:l + vec] += p == 0
        assert (dxw == 1).all() and (dpre == 1).all()


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 200_000))
def test_sigma_prime_grid_covers_every_element_once(n):
    """B8's grid from csrc/lenet_staged.cu's constants: n · 864 float4
    quads, min(⌈quads / SPAN⌉, SIGMA_WAVE) blocks of SIGMA_THREADS (SPAN =
    SIGMA_THREADS · SIGMA_VEC), pass k of block b covering quads
    (b + k · blocks) · SPAN onward, thread t holding t + u · SIGMA_THREADS
    of them. Each sampled image's quads belong to exactly one (block,
    pass, thread, slot) inside the grid, every element once; every quad
    lies a whole float4 from the base, so it is aligned where the base is.
    The kernel loads all it reads before its first σ and stages nothing in
    shared memory."""
    vec, tpb, wave = (_source_const(k) for k in ("SIGMA_VEC", "SIGMA_THREADS", "SIGMA_WAVE"))
    assert vec in (1, 2, 4) and tpb % 32 == 0 and tpb <= 1024 and 1 <= wave <= 2**31 - 1
    span, quads = tpb * vec, n * 3456 // 4
    blocks = min(-(-quads // span), wave)
    passes = -(-quads // (blocks * span))
    for img in _sample_images(n):
        q = np.arange(img * 864, (img + 1) * 864)
        chunk, r = q // span, q % span
        b, k, u, t = chunk % blocks, chunk // blocks, r // tpb, r % tpb
        assert (b < blocks).all() and (k < passes).all() and (u < vec).all()
        # The thread's loop reaches pass k (its first quad there lies below
        # quads) and its slot u holds q again: a bijection.
        first = (b + k * blocks) * span + t
        assert (first <= q).all() and (first < quads).all()
        assert ((b + k * blocks) * span + t + u * tpb == q).all()
        elems = (4 * q[:, None] + np.arange(4)).ravel()
        assert (np.sort(elems) == np.arange(img * 3456, (img + 1) * 3456)).all()
        assert ((4 * q * 4) % 16 == 0).all()
    body = _kernel_text("sigma_prime_kernel")
    assert "__shared__" not in body
    assert body.rindex("load_quad(") < body.index("sigmoid(")


@pytest.mark.parametrize("n", SIZES)
def test_fc_bwd_matches_jax(n):
    a, jp, tp = arrays(n), jax_params(), port_params()
    want = jpallas.fc_bwd(a["d_f"], a["s1"], jp["f"]["w"])
    got = lenet_staged.fc_bwd(t(a["d_f"]), t(a["s1"]), tp["f"]["w"])
    for g, w, name in zip(got, want, ("g_w_f", "g_b_f", "d_out_s1")):
        close(g, w, name=name)


@pytest.mark.parametrize("n", SIZES)
def test_pool_bwd_matches_jax(n):
    a, jp, tp = arrays(n), jax_params(), port_params()
    want = jpallas.pool_bwd(a["d_s1"], a["pre_s1"], jp["s1"]["w"])
    got = lenet_staged.pool_bwd(t(a["d_s1"]), t(a["pre_s1"]), tp["s1"]["w"])
    for g, w, name in zip(got, want, ("d_pre_s1", "d_xw")):
        close(g, w, name=name)


@pytest.mark.parametrize("n", SIZES)
def test_pool_wgrad_matches_jax(n):
    a = arrays(n)
    want = jpallas.pool_wgrad(a["xw"], a["d_s1"])
    close(lenet_staged.pool_wgrad(t(a["xw"]), t(a["d_s1"])), want)


@pytest.mark.parametrize("n", SIZES)
def test_conv_bwd_dpre_matches_jax(n):
    a = arrays(n)
    want = jpallas.conv_bwd_dpre(a["d_c1"], a["pre_c1"])
    close(lenet_staged.conv_bwd_dpre(t(a["d_c1"]), t(a["pre_c1"])), want)


@pytest.mark.parametrize("n", SIZES)
def test_conv_wgrad_matches_jax(n):
    a = arrays(n)
    want = jpallas.conv_wgrad(a["xs"], a["d_c1"])
    close(lenet_staged.conv_wgrad(t(a["xs"]), t(a["d_c1"])), want)


@pytest.mark.parametrize("rows,ka,kb,row_block", [
    (216 * 3, 16, 1, 216), (576 * 2 + 5, 6, 25, 577), (300, 1, 7, 100),
])
def test_accum_matmul_matches_jax(rows, ka, kb, row_block):
    rng = np.random.default_rng(rows + ka)
    a = rng.normal(size=(rows, ka)).astype(np.float32)
    b = rng.normal(size=(rows, kb)).astype(np.float32)
    want = jpallas._accum_matmul(a, b, row_block)
    close(lenet_staged._accum_matmul(t(a), t(b)), want)


# B9's shapes: both call sites at n 1 and 5, one row, a row count no block
# or stage divides, and outputs at the limits (ka*kb 256, ka + kb 48, 14
# tiles).
ACCUM_SHAPES = [(216, 16, 1), (216 * 5, 16, 1), (576, 6, 25), (576 * 5, 6, 25),
                (1, 6, 25), (1, 16, 1), (36_864 + 37, 6, 25), (5003, 16, 16),
                (3001, 1, 47), (2999, 47, 1), (777, 9, 28)]


@pytest.mark.parametrize("rows,ka,kb", ACCUM_SHAPES)
def test_accum_matmul_order_matches_plain(rows, ka, kb):
    """lenet_staged.accum_matmul_order (B9's fixed summation order in f32
    numpy, which the card's result equals bit for bit) against the plain
    twin aᵀ·b, within 1e-5 of the output's scale."""
    rng = np.random.default_rng(rows * 7 + ka)
    a = rng.normal(size=(rows, ka)).astype(np.float32)
    b = rng.normal(size=(rows, kb)).astype(np.float32)
    got = lenet_staged.accum_matmul_order(a, b)
    want = lenet_staged._accum_matmul_plain(t(a).double(), t(b).double()).numpy()
    assert got.dtype == np.float32 and got.shape == (ka, kb)
    np.testing.assert_allclose(got, want, atol=RTOL * max(1.0, np.abs(want).max()), rtol=0)


def test_accum_matmul_order_sums_in_the_plans_order():
    """One row a block's lane: with shard 32 rows and one tile, each lane
    sums one row, the butterfly pairs lanes (0,16), (0,8), ...; so a row of
    1e8 and rows of 1.0 in lanes 0 and 16 lose the 1.0s exactly as the tree
    does, and a reordering would not."""
    rows = 32
    a = np.ones((rows, 1), np.float32)
    b = np.zeros((rows, 1), np.float32)
    b[0], b[16], b[8] = 1e8, 1.0, -1e8
    # (1e8 + 1) rounds to 1e8 at level 16; level 8 adds -1e8: exactly 0.
    assert lenet_staged.accum_matmul_order(a, b)[0, 0] == 0.0
    b[16], b[1] = 0.0, 1.0  # lane 1 joins lane 0 last: 1e8 - 1e8 + 1
    assert lenet_staged.accum_matmul_order(a, b)[0, 0] == 1.0


@settings(max_examples=200, deadline=None)
@given(rows=st.integers(1, 2**31 - 1), ka=st.integers(1, 47), kb=st.integers(1, 47))
def test_accum_plan_covers_every_row_once_within_shared_memory(rows, ka, kb):
    if ka * kb > 256 or ka + kb > 48:
        return
    plan = lenet_staged.accum_plan(rows, ka, kb)
    assert plan.shard % lenet_staged.ACCUM_ROW_ALIGN == 0
    assert plan.shard >= lenet_staged.ACCUM_ROWS
    assert 1 <= plan.blocks <= lenet_staged.ACCUM_BLOCKS
    # Block g owns rows [g*shard, min((g+1)*shard, rows)): every row once.
    assert (plan.blocks - 1) * plan.shard < rows <= plan.blocks * plan.shard
    assert plan.stage_rows % 32 == 0 and plan.stage_rows >= 128
    assert 2 * plan.stage_rows * (ka + kb) * 4 <= 48 * 1024
    tiles = -(-ka // lenet_staged.ACCUM_TA) * -(-kb // lenet_staged.ACCUM_TB)
    assert plan.threads == 32 * tiles <= 512
    assert plan.threads >= ka * kb  # the finish has a thread an output
    assert plan == lenet_staged.accum_plan(rows, ka, kb)


def test_accum_plan_at_the_path_shapes():
    """Both call sites at batch 64 fill one block an SM; at batch 1 the
    conv site is 18 blocks of 32 rows (a row a lane)."""
    plan = lenet_staged.accum_plan
    assert plan(576 * 64, 6, 25) == lenet_staged.AccumPlan(280, 132, 192, 224)
    assert plan(216 * 64, 16, 1) == lenet_staged.AccumPlan(108, 128, 352, 64)
    assert plan(576, 6, 25) == lenet_staged.AccumPlan(32, 18, 192, 224)
    assert plan(576 * 1000, 6, 25).blocks == 132


@pytest.mark.parametrize("n", SIZES)
def test_pool_window_layout_is_jax_bit_for_bit(n):
    """The lane order m·36 + x·6 + y and the tap order 4i+j, pinned
    against JAX's arrays (a swap of x and y still trains)."""
    a = arrays(n)
    packed = lenet_staged.pack_pool_windows(t(a["c1"]))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jpallas.pack_pool_windows(a["c1"])))
    unpacked = lenet_staged.unpack_pool_windows(t(a["xw"]))
    np.testing.assert_array_equal(unpacked.numpy(),
                                  np.asarray(jpallas.unpack_pool_windows(a["xw"])))
    assert torch.equal(lenet_staged.unpack_pool_windows(packed), t(a["c1"]))
    assert packed.is_contiguous() and unpacked.is_contiguous()


# ---------------------------------------------------------------------------
# The path's entry points: forward, predict, staged_value_and_ref_grads
# ---------------------------------------------------------------------------


# The JAX functions the entry points reach through pallas.py's globals.
JAX_STAGES = ("conv_fwd", "pool_fwd", "fc_fwd", "fc_bwd", "pool_bwd",
              "pool_wgrad", "conv_bwd_dpre", "conv_wgrad")


@functools.lru_cache(maxsize=None)
def jitted_stages():
    return {name: jax.jit(getattr(jpallas, name)) for name in JAX_STAGES}


@functools.lru_cache(maxsize=None)
def jax_path(n):
    """JAX's ``forward``, ``predict`` and ``staged_value_and_ref_grads`` at
    batch n, as numpy. Called eagerly, an interpret-mode kernel function
    traces its kernel anew on every call (``conv_fwd``'s 150 unrolled taps
    take about 2 s on the CPU), so here each stage runs under ``jax.jit``:
    the batch JAX pads to 32 (n = 1, 5, 8) compiles once for the three
    entry points and the three sizes. The stages are the same functions;
    the eager calls are held against the port one by one above."""
    a, jp = arrays(n), jax_params()
    with mock.patch.multiple(jpallas, **jitted_stages()):
        acts = jpallas.forward(jp, a["xs"])
        pred = jpallas.predict(jp, a["xs"])
        err, grads = jpallas.staged_value_and_ref_grads(jp, a["xs"], a["ys"])
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return to_np(tuple(acts)), np.asarray(pred), float(err), to_np(grads)


@pytest.mark.parametrize("n", PATH_SIZES)
def test_forward_matches_jax(n):
    want, _, _, _ = jax_path(n)
    got = lenet_staged.forward(port_params(), t(arrays(n)["xs"]))
    assert got._fields == tref.Activations._fields
    for g, w, name in zip(got, want, got._fields):
        close(g, w, name=name)


@pytest.mark.parametrize("n", PATH_SIZES)
def test_predict_matches_jax(n):
    _, want, _, _ = jax_path(n)
    got = lenet_staged.predict(port_params(), t(arrays(n)["xs"]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", PATH_SIZES)
def test_staged_grads_match_jax(n):
    _, _, want_e, want_g = jax_path(n)
    a = arrays(n)
    got_e, got_g = lenet_staged.staged_value_and_ref_grads(
        port_params(), t(a["xs"]), t(a["ys"]).long())
    assert got_e.shape == ()
    np.testing.assert_allclose(float(got_e), want_e, atol=ERR_ATOL)
    for layer in want_g:
        for k in want_g[layer]:
            close(got_g[layer][k], want_g[layer][k], name=f"{layer}/{k}")


@pytest.mark.parametrize("n", SIZES)
def test_staged_grads_match_the_fused_plain_grads(n):
    """The staged tier against the fused tier (B1's plain version): the
    differential anchor of JAX's test_staged_tier_matches_fused_tier."""
    a, tp = arrays(n), port_params()
    xs, ys = t(a["xs"]), t(a["ys"])
    err_s, grads_s = lenet_staged.staged_value_and_ref_grads(tp, xs, ys)
    err_f, grads_f = lenet_fused.fused_value_and_ref_grads(tp, xs, ys)
    np.testing.assert_allclose(float(err_s), float(err_f), atol=ERR_ATOL)
    for g, f in zip(tree_leaves(grads_s), tree_leaves(grads_f)):
        close(g, f.numpy())


# ---------------------------------------------------------------------------
# Routing, counters and the kernel source
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_twins_and_launch_nothing():
    before = {k: c.count for k, c in lenet_staged.launches.items()}
    a = arrays(5)
    lenet_staged.staged_value_and_ref_grads(port_params(), t(a["xs"]), t(a["ys"]))
    lenet_staged.predict(port_params(), t(a["xs"]))
    assert {k: c.count for k, c in lenet_staged.launches.items()} == before
    assert set(lenet_staged.launches) == set(lenet_staged.KERNELS)


@pytest.mark.parametrize("n", [1, 5])
def test_stage_cases_cover_every_kernel_at_the_path_shapes(n):
    """The cases the card checks iterate (chip_smoke.stage_cases records
    them from one run of the path): every launch counter, B9 at both call
    sites, each input of the path's shape and contiguous (at n = 1 the
    transposed reshapes are strided views); on CPU tensors each wrapper
    gives exactly its plain twin."""
    a = arrays(n)
    cases = stage_cases(port_params(), t(a["xs"]), t(a["ys"]))
    assert {k.split("/")[0] for k in cases} == set(lenet_staged.KERNELS)
    assert cases["accum_matmul/conv_wgrad"][2][1].shape == (n * 576, 25)
    assert cases["accum_matmul/pool_wgrad"][2][0].shape == (n * 216, 16)
    for name, (fn, plain, args) in cases.items():
        assert all(x.is_contiguous() for x in args), name
        got, want = fn(*args), plain(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("call", [
    lambda m, p: lenet_staged.conv_fwd(m((2, 28, 28)), p["c1"]["w"], p["c1"]["b"]),
    lambda m, p: lenet_staged.pool_fwd(m((2, 16, 216)), p["s1"]["w"], p["s1"]["b"]),
    lambda m, p: lenet_staged.fc_fwd(m((2, 216)), p["f"]["w"], p["f"]["b"]),
    lambda m, p: lenet_staged.fc_bwd(m((2, 10)), m((2, 216)), p["f"]["w"]),
    lambda m, p: lenet_staged.pool_bwd(m((2, 216)), m((2, 216)), p["s1"]["w"]),
    lambda m, p: lenet_staged.conv_bwd_dpre(m((2, 6, 24, 24)), m((2, 6, 24, 24))),
    lambda m, p: lenet_staged._accum_matmul(m((8, 6)), m((8, 25))),
], ids=["conv_fwd", "pool_fwd", "fc_fwd", "fc_bwd", "pool_bwd", "sigma_prime",
        "accum_matmul"])
def test_other_devices_raise(call):
    def meta(shape):
        return torch.empty(shape, device="meta")

    with pytest.raises(ValueError, match="cuda or cpu"):
        call(meta, port_params())


def test_kernel_source_names_each_tpu_kernel_it_replaces():
    src = SOURCE.read_text()
    for line, name in ((141, "_conv_fwd_kernel"), (201, "_pool_fwd_kernel"),
                       (238, "_fc_fwd_kernel"), (279, "_fc_bwd_kernel"),
                       (333, "_pool_bwd_kernel"), (413, "_sigma_prime_kernel"),
                       (371, "_accum_matmul_kernel")):
        assert f"`{name}`" in src and f"pallas.py:{line}" in src, name
    assert src.count("__global__") == 7  # seven kernels, one launch each
    assert "atomicAdd" not in src  # every sum in a fixed order
    assert "3.35 TB/s" in src and "bound by bytes" in src


def test_kernel_layout_constants_match_the_wrapper():
    names = ("IMG", "CONV", "LANES", "TAPS", "CLASSES", "ACCUM_ROWS")
    assert tuple(_source_const(k) for k in names) == lenet_staged.LAYOUT


def test_library_builds_through_the_one_builder():
    lib = lenet_staged._library
    assert isinstance(lib, _cuda_build.Library)
    assert lib.flags == _cuda_build.NVCC_FLAGS  # no --use_fast_math
    assert lib.source == SOURCE
    assert lib._lib is None  # nothing built on import
