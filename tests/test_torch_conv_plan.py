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
