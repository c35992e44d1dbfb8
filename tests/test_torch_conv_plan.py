"""The gradient kernels' host-side plans, which the CPU reaches without a
card: the dgrad kernel's stride phases (``tap_conv.dgrad_phase_taps``)
against a brute-force listing of the conv's nonzero (pixel, tap) pairs
and against JAX's ``_s2_phase_taps(k, inverse=True)``, a plain dgrad
summed phase by phase from the tables against ``conv2d_dgrad_plain`` and
JAX's Pallas dgrad (interpret mode, as tests/test_torch_conv_grad.py runs
it), and the properties of the wgrad kernel's pixel split
(``tap_wgrad.wgrad_plan``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from parallel_cnn_tpu.ops import pallas_conv
from parallel_cnn_tpu_torch.ops import tap_conv, tap_wgrad

SIZES = range(1, 20)
# f32 sums of the same terms in other orders.
PHASED_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nonzero_pairs(size, k, stride):
    """Brute force along one dim: (input position, tap offset) pairs whose
    output position (pos + pad_lo - d) / stride is a whole step inside the
    output."""
    out, lo, _ = tap_conv.same_pads(size, k, stride)
    return {(pos, d) for pos in range(size) for d in range(k)
            if (pos + lo - d) % stride == 0 and 0 <= (pos + lo - d) // stride < out}


def _table_pairs(phase, h, w, k, stride):
    """(iy, ix, dy, dx) pairs the phase's table sends into g's range."""
    oh, ow = -(-h // stride), -(-w // stride)
    pairs = set()
    for slot, ay, ax in phase.taps:
        dy, dx = divmod(slot, k)
        for j in range(phase.hp):
            for i in range(phase.wp):
                if 0 <= j + ay < oh and 0 <= i + ax < ow:
                    pairs.add((j * stride + phase.py, i * stride + phase.px, dy, dx))
    return pairs


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_phase_tables_cover_every_nonzero_pair_once(k, stride):
    for h in SIZES:
        for w in SIZES:
            phases = tap_conv.dgrad_phase_taps(h, w, k, stride)
            assert len(phases) == stride * stride
            assert [(p.py, p.px) for p in phases] == [
                (py, px) for py in range(stride) for px in range(stride)]
            ys, xs = _nonzero_pairs(h, k, stride), _nonzero_pairs(w, k, stride)
            want = {(iy, ix, dy, dx) for iy, dy in ys for ix, dx in xs}
            seen = []
            for p in phases:
                assert p.hp == len(range(p.py, h, stride))
                assert p.wp == len(range(p.px, w, stride))
                slots = [t[0] for t in p.taps]
                assert slots == sorted(set(slots))  # ascending, each once
                pairs = _table_pairs(p, h, w, k, stride)
                seen.extend(pairs)
                for slot, ay, ax in p.taps:
                    dy, dx = divmod(slot, k)
                    # On a stride step for the whole phase ...
                    assert (p.py + tap_conv.same_pads(h, k, stride)[1] - dy) == ay * stride
                    assert (p.px + tap_conv.same_pads(w, k, stride)[1] - dx) == ax * stride
                    # ... and reaching g from some pixel of it: no zero tap.
                    assert any(q[2:] == (dy, dx) for q in pairs)
            assert len(seen) == len(set(seen)) and set(seen) == want


@pytest.mark.parametrize("k", [3, 5, 7])
def test_phase_tables_equal_jax_s2_phase_taps_at_even_sizes(k):
    """The dgrad mapping of JAX's even-size stride-2 path
    (``_dgrad_s2_even``): output phase p takes (a, b, slot). At small
    sizes the port drops the taps no pixel of a phase reaches."""
    jax_taps = pallas_conv._s2_phase_taps(k, inverse=True)
    for h in range(2, 20, 2):
        for w in range(2, 20, 2):
            oh, ow = h // 2, w // 2
            for p, phase in enumerate(tap_conv.dgrad_phase_taps(h, w, k, 2)):
                want = sorted((slot, a, b) for ph, a, b, slot in jax_taps
                              if ph == p and -phase.hp < a < oh and -phase.wp < b < ow)
                assert sorted(phase.taps) == want
                if min(h, w) >= 8:
                    assert len(want) == sum(1 for t in jax_taps if t[0] == p)


def _phased_dgrad(g, w, x_shape, stride):
    """dx summed phase by phase from the kernel's tables, in plain
    PyTorch: each phase's pixels take g shifted by each of its taps,
    times that tap's W^T."""
    n, h, wd, cin = x_shape
    k = w.shape[0]
    oh, ow = g.shape[1], g.shape[2]
    dx = torch.zeros(x_shape, dtype=g.dtype)
    for p in tap_conv.dgrad_phase_taps(h, wd, k, stride):
        acc = torch.zeros((n, p.hp, p.wp, cin), dtype=g.dtype)
        for slot, ay, ax in p.taps:
            dy, dx_ = divmod(slot, k)
            shifted = torch.zeros((n, p.hp, p.wp, g.shape[3]), dtype=g.dtype)
            j0, j1 = max(0, -ay), min(p.hp, oh - ay)
            i0, i1 = max(0, -ax), min(p.wp, ow - ax)
            if j0 < j1 and i0 < i1:
                shifted[:, j0:j1, i0:i1] = g[:, j0 + ay:j1 + ay, i0 + ax:i1 + ax]
            acc += shifted @ w[dy, dx_].T
        dx[:, p.py::stride, p.px::stride] = acc
    return dx


# (b, h, w, cin, cout, k, s): odd and even sizes, every k, both strides.
PHASED_CASES = [
    (2, 8, 8, 4, 8, 1, 2), (2, 7, 5, 4, 6, 1, 2), (2, 5, 7, 3, 5, 3, 1),
    (2, 8, 8, 4, 8, 3, 2), (2, 7, 9, 4, 8, 3, 2), (2, 8, 8, 4, 8, 5, 1),
    (2, 7, 8, 3, 6, 5, 2), (1, 9, 7, 3, 6, 7, 2), (1, 8, 8, 3, 8, 7, 2),
    (2, 3, 2, 3, 4, 7, 2), (1, 1, 1, 3, 4, 5, 2),
]


def _inputs(b, h, w, cin, cout, k, s, seed):
    rng = np.random.default_rng(seed)
    oh, ow = -(-h // s), -(-w // s)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, oh, ow, cout)).astype(np.float32)
    return x, wt, g


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", PHASED_CASES)
def test_phased_dgrad_matches_plain_and_jax_pallas(b, h, w, cin, cout, k, s):
    x, wt, g = _inputs(b, h, w, cin, cout, k, s, b * h + w * k + s)
    got = _phased_dgrad(torch.from_numpy(g), torch.from_numpy(wt), x.shape, s)
    plain = tap_conv.conv2d_dgrad_plain(torch.from_numpy(g), torch.from_numpy(wt),
                                        x.shape, s)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=PHASED_ATOL)
    _, vjp = jax.vjp(lambda a: pallas_conv.conv2d(a, jnp.asarray(wt), s), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(dx_ref), atol=PHASED_ATOL)


def test_dgrad_table_orders_phases_and_counts_blocks():
    """The int32 table the kernel reads (csrc/tap_conv.cu DgradPlan)."""
    phases = tap_conv.dgrad_phase_taps(8, 8, 1, 2)  # 1x1/s2: one live phase
    tile = tap_conv.dgrad_tile(128, phases, 256)
    table = list(tap_conv._dgrad_table(128, phases, 256, tile))
    assert len(table) == 2 + 5 + 16 + 5 + 3 * 49
    n_phases, n_tiles, begin = table[0], table[1], table[2:7]
    assert n_phases == 4 and n_tiles == 256 // tap_conv.DGRAD_TILES[tile][1]
    taps = table[23:28]
    assert taps[:5] == [0, 1, 1, 1, 1]  # the tapped phase first, then 3 of zeros
    bm = tap_conv.DGRAD_TILES[tile][0]
    assert begin == [0] + [4 * (-(-(128 * 16) // bm) * n_tiles) * (i + 1) // 4
                           for i in range(4)]


# (h, cin, k, stride, tile) of every ResNet-18 dgrad: 128x128 only for the
# stride-1 convs of at least 128 channels whose grid fills the SMs.
DGRAD_TILE_CASES = [(32, 64, 3, 1, 1), (32, 64, 3, 2, 1), (32, 64, 1, 2, 1),
                    (16, 128, 3, 1, 0), (16, 128, 3, 2, 1), (16, 128, 1, 2, 1),
                    (8, 256, 3, 1, 0), (8, 256, 3, 2, 1), (8, 256, 1, 2, 1),
                    (4, 512, 3, 1, 1)]


@pytest.mark.parametrize("h,cin,k,s,tile", DGRAD_TILE_CASES)
def test_dgrad_tile_at_resnet18_b128(h, cin, k, s, tile):
    phases = tap_conv.dgrad_phase_taps(h, h, k, s)
    assert tap_conv.dgrad_tile(128, phases, cin) == tile
    blocks = sum(tap_conv._phase_blocks(128, p, cin, tile) for p in phases if p.taps)
    if k == 3:  # the 1x1/s2 projections are too small to fill the card
        assert blocks >= 0.9 * tap_conv.SMS


# Every distinct conv of ResNet-18 at 32x32: (h, cin, cout, k, stride).
RESNET18 = [(32, 3, 64, 3, 1), (32, 64, 64, 3, 1), (32, 64, 128, 3, 2),
            (32, 64, 128, 1, 2), (16, 128, 128, 3, 1), (16, 128, 256, 3, 2),
            (16, 128, 256, 1, 2), (8, 256, 256, 3, 1), (8, 256, 512, 3, 2),
            (8, 256, 512, 1, 2), (4, 512, 512, 3, 1)]


def _check_plan(n, oh, ow, rows, cout):
    plan = tap_wgrad.wgrad_plan(n, oh, ow, rows, cout)
    pixels = n * oh * ow
    assert plan.chunk_pixels > 0 and plan.chunk_pixels % tap_wgrad.STAGE_PIXELS == 0
    # The chunks cover the pixel axis exactly: the last is the only ragged one.
    assert plan.chunks == -(-pixels // plan.chunk_pixels)
    assert (plan.chunks - 1) * plan.chunk_pixels < pixels <= plan.chunks * plan.chunk_pixels
    assert 1 <= plan.chunks <= tap_wgrad.MAX_CHUNKS
    if plan.chunks > 1:
        assert 4 * plan.chunks * rows * cout <= tap_wgrad.SCRATCH_CAP_BYTES
    return plan


@settings(max_examples=200, deadline=None)
@given(n=st.integers(1, 300), oh=st.integers(1, 40), ow=st.integers(1, 40),
       cin=st.integers(1, 600), k=st.sampled_from([1, 3, 5, 7]),
       cout=st.integers(1, 600))
def test_wgrad_plan_covers_pixels_in_stage_multiples_under_the_cap(n, oh, ow, cin, k, cout):
    _check_plan(n, oh, ow, k * k * cin, cout)


@settings(max_examples=50, deadline=None)
@given(n=st.integers(1, 300), oh=st.integers(1, 40), rows=st.integers(1, 5000),
       cout=st.integers(1, 600))
def test_wgrad_plan_depends_on_the_shape_alone(n, oh, rows, cout):
    first = tap_wgrad.wgrad_plan(n, oh, oh, rows, cout)
    tap_wgrad.wgrad_plan(n + 1, oh, oh, rows, cout)  # another shape between
    assert tap_wgrad.wgrad_plan(n, oh, oh, rows, cout) == first


@pytest.mark.parametrize("h,cin,cout,k,s", RESNET18)
def test_wgrad_plan_fills_the_card_at_resnet18_b128(h, cin, cout, k, s):
    oh = -(-h // s)
    plan = _check_plan(128, oh, oh, k * k * cin, cout)
    bm, bn = tap_wgrad.TILE
    blocks = -(-(k * k * cin) // bm) * -(-cout // bn) * plan.chunks
    assert blocks >= 2 * tap_conv.SMS  # two blocks of 128 threads an SM at least


# ---------------------------------------------------------------------------
# The forward kernel's plan (csrc/tap_conv.cu tap_conv_kernel): its block
# tile (``forward_tile``) and grid (``forward_blocks``), and a plain model
# of what its blocks gather and sum.
# ---------------------------------------------------------------------------

_shapes = dict(n=st.integers(1, 300), h=st.integers(1, 40), w=st.integers(1, 40),
               cin=st.integers(1, 600), cout=st.integers(1, 600),
               k=st.sampled_from(tap_conv.SUPPORTED_K), s=st.sampled_from([1, 2]))


def _spans(total, size, tiles):
    """The [lo, hi) ranges of ``tiles`` consecutive tiles of ``size``
    clipped at ``total``."""
    return [(i * size, min((i + 1) * size, total)) for i in range(tiles)]


@settings(max_examples=200, deadline=None)
@given(**_shapes)
def test_forward_grid_covers_every_output_once(n, h, w, cin, cout, k, s):
    """Blocks (i, j) own pixels [i·BM, (i+1)·BM) × channels [j·BN, (j+1)·BN)
    of the (N·OH·OW, Cout) output: for the picked tile and every other,
    each range is non-empty and together they tile each axis exactly, so
    every (pixel, channel) output has one block."""
    oh, ow = tap_conv.same_pads(h, k, s)[0], tap_conv.same_pads(w, k, s)[0]
    pick = tap_conv.forward_tile(n, oh, ow, cin, cout, k)
    assert 0 <= pick < len(tap_conv.FORWARD_TILES)
    for tile, (bm, bn) in enumerate(tap_conv.FORWARD_TILES):
        mt, nt = tap_conv.forward_blocks(n, oh, ow, cout, tile)
        for total, size, tiles in ((n * oh * ow, bm, mt), (cout, bn, nt)):
            spans = _spans(total, size, tiles)
            assert all(lo < hi for lo, hi in spans)
            assert spans[0][0] == 0 and spans[-1][1] == total
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


class _TapCursor:
    """The kernel's (dy, dx, ci) depth cursor, stepped as it steps."""

    def __init__(self, d, cin, k):
        t, self.ci = divmod(d, cin)
        self.dy, self.dx = divmod(t, k)

    def advance(self, by, cin, k):
        self.ci += by
        while self.ci >= cin:
            self.ci -= cin
            self.dx += 1
            if self.dx == k:
                self.dx, self.dy = 0, self.dy + 1


def _depth_walk(k, cin, vec):
    """[stage][slot] -> the HWIO depth index the kernel copies there (None
    past K): copy group dk of a stage holds slots dk·vec .. dk·vec+vec−1,
    from its cursor started at dk·vec and advanced a stage at a time."""
    K = k * k * cin
    stages = -(-K // tap_conv.FORWARD_STAGE)
    walk = [[None] * tap_conv.FORWARD_STAGE for _ in range(stages)]
    for dk in range(tap_conv.FORWARD_STAGE // vec):
        cur = _TapCursor(dk * vec, cin, k)
        for stage in range(stages):
            if stage * tap_conv.FORWARD_STAGE + dk * vec < K:
                for q in range(vec):
                    walk[stage][dk * vec + q] = (cur.dy * k + cur.dx) * cin + cur.ci + q
            cur.advance(tap_conv.FORWARD_STAGE, cin, k)
    return walk


@settings(max_examples=200, deadline=None)
@given(k=st.sampled_from(tap_conv.SUPPORTED_K), cin=st.integers(1, 600), vec=st.sampled_from([1, 4]))
def test_forward_depth_walk_sums_hwio_in_ascending_order(k, cin, vec):
    """Read stage by stage, slot by slot, the kernel's copies list every
    depth term k = (dy, dx, ci) once, ascending, then only padding: the
    order every output sums in, whatever its tile (4-value copies need a
    Cin the 4 divides, which the launch checks)."""
    if vec == 4 and cin % 4:
        cin += 4 - cin % 4
    flat = [d for stage in _depth_walk(k, cin, vec) for d in stage]
    K = k * k * cin
    assert flat[:K] == list(range(K)) and all(d is None for d in flat[K:])


def _tiled_forward(x, w, scale, shift, res, stride, relu, tile, vec):
    """A plain model of the forward kernel at ``tile``: each block decodes
    its pixels' origins, gathers x at the depth walk (zero in the SAME
    padding and past the last pixel), and adds one product a depth step,
    in walk order; then the epilogue. f32, a multiply and an add a step."""
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    oh, pt, _ = tap_conv.same_pads(h, k, stride)
    ow, pl, _ = tap_conv.same_pads(wd, k, stride)
    M, K = n * oh * ow, k * k * cin
    bm, bn = tap_conv.FORWARD_TILES[tile]
    mt, nt = tap_conv.forward_blocks(n, oh, ow, cout, tile)
    xp = torch.zeros((n, h + 2 * 7, wd + 2 * 7, cin))  # room for every tap
    xp[:, 7:7 + h, 7:7 + wd] = x
    wk = w.reshape(K, cout)
    out = torch.empty((M, cout))
    walk = [d for stage in _depth_walk(k, cin, vec) for d in stage]
    for i in range(mt):
        m = torch.arange(i * bm, (i + 1) * bm)
        live = m < M
        img, r = m // (oh * ow), m % (oh * ow)
        iy0, ix0 = (r // ow) * stride - pt, (r % ow) * stride - pl
        acc = torch.zeros((bm, cout))
        for d in walk:
            if d is None:
                continue
            t, ci = divmod(d, cin)
            dy, dx = divmod(t, k)
            iy, ix = iy0 + dy, ix0 + dx
            inside = live & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
            a = torch.where(inside, xp[img.clamp(max=n - 1), iy.clamp(-7, h + 6) + 7,
                                       ix.clamp(-7, wd + 6) + 7, ci], 0.0)
            acc = acc + a[:, None] * wk[d][None, :]
        for j in range(nt):
            z = acc[live][:, j * bn:(j + 1) * bn]
            out[m[live], j * bn:(j + 1) * bn] = z
    z = out.reshape(n, oh, ow, cout) * scale + shift
    if res is not None:
        z = z + res
    return torch.clamp_min(z, 0.0) if relu else z


@settings(max_examples=8, deadline=None)
@given(n=st.integers(1, 3), h=st.integers(1, 11), w=st.integers(1, 11),
       cin=st.sampled_from([1, 3, 4, 8]), cout=st.integers(1, 12),
       k=st.sampled_from(tap_conv.SUPPORTED_K), s=st.sampled_from([1, 2]),
       residual=st.booleans(), relu=st.booleans(), seed=st.integers(0, 2**16))
def test_tiled_forward_model_matches_jax_at_every_tile(n, h, w, cin, cout, k, s,
                                                       residual, relu, seed):
    """The kernel's plan at every tile gives the same bits (each output
    sums the same terms in the same order), within 1e-5 of JAX's Pallas
    ``conv2d_fused`` (interpret mode) and of the port's plain twin."""
    rng = np.random.default_rng(seed)
    oh, ow = -(-h // s), -(-w // s)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    res = rng.standard_normal((n, oh, ow, cout)).astype(np.float32) if residual else None
    t = [None if a is None else torch.from_numpy(a) for a in (x, wt, scale, shift, res)]
    vec = 4 if cin % 4 == 0 and cout % 4 == 0 else 1
    outs = [_tiled_forward(*t, s, relu, tile, vec) for tile in range(len(tap_conv.FORWARD_TILES))]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    plain = tap_conv.conv2d_fused_plain(*t, stride=s, relu=relu)
    np.testing.assert_allclose(outs[0].numpy(), plain.numpy(), atol=PHASED_ATOL)
    ref = np.asarray(pallas_conv.conv2d_fused(x, wt, scale, shift, res, s, relu))
    np.testing.assert_allclose(outs[0].numpy(), ref, atol=PHASED_ATOL)


# (h, cin, cout, k, stride) -> the forward's tile at the serving buckets 1-64
# and the zoo's 128: the stem's one-stage depth takes tile 3 throughout;
# 128x128 (0) where Cout >= 128 and its grid fills the card, 64x64 (1)
# where that grid does, else 32x64 (2).
FORWARD_TILE_CASES = {
    (32, 3, 64, 3, 1): (3, 3, 3, 3, 3, 3, 3, 3),
    (32, 64, 64, 3, 1): (2, 2, 2, 1, 1, 1, 1, 1),
    (32, 64, 128, 3, 2): (2, 2, 2, 2, 1, 1, 0, 0),
    (32, 64, 128, 1, 2): (2, 2, 2, 2, 1, 1, 0, 0),
    (16, 128, 128, 3, 1): (2, 2, 2, 2, 1, 1, 0, 0),
    (16, 128, 256, 3, 2): (2, 2, 2, 2, 2, 1, 1, 0),
    (16, 128, 256, 1, 2): (2, 2, 2, 2, 2, 1, 1, 0),
    (8, 256, 256, 3, 1): (2, 2, 2, 2, 2, 1, 1, 0),
    (8, 256, 512, 3, 2): (2, 2, 2, 2, 2, 2, 1, 1),
    (8, 256, 512, 1, 2): (2, 2, 2, 2, 2, 2, 1, 1),
    (4, 512, 512, 3, 1): (2, 2, 2, 2, 2, 2, 1, 1),
}
FORWARD_BATCHES = (1, 2, 4, 8, 16, 32, 64, 128)


@pytest.mark.parametrize("geometry", FORWARD_TILE_CASES)
def test_forward_tile_at_resnet18_buckets(geometry):
    h, cin, cout, k, s = geometry
    oh = -(-h // s)
    picks = tuple(tap_conv.forward_tile(n, oh, oh, cin, cout, k) for n in FORWARD_BATCHES)
    assert picks == FORWARD_TILE_CASES[geometry]
    for n, tile in zip(FORWARD_BATCHES, picks):
        mt, nt = tap_conv.forward_blocks(n, oh, oh, cout, tile)
        if tile in (0, 1):  # a larger tile only where its grid fills the card
            assert mt * nt >= 0.9 * tap_conv.SMS


def test_forward_tiles_are_each_picked_on_the_serving_and_zoo_paths():
    """Every tile of the kernel is reached at some ResNet-18 conv and batch
    (so the card tests at these shapes hold each one)."""
    picked = {t for row in FORWARD_TILE_CASES.values() for t in row}
    assert picked == set(range(len(tap_conv.FORWARD_TILES)))
