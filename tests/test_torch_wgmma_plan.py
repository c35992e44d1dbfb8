"""The host-side plans of the bf16 tensor-core conv kernels (wgmma fed by
TMA: ``tap_conv_wgmma_kernel``, ``tap_dgrad_wgmma_kernel`` and
``wgrad_wgmma_kernel``), which the CPU reaches without a card: the shape
rule that picks them (``tap_conv.wgmma_form``), the rectangles of 64
output pixels a block covers (``conv_rect``; their order,
``rect_origins`` below), the TMA box each tap reads (``tap_box_origin``
below, as the kernels compute it; stride 2 through the map's element
strides), the dgrad's phase table (``tap_conv.wgmma_dgrad_plan``, read
block by block as the kernel reads it: ``dgrad_blocks`` below) and the
wgrad's chunks (``tap_wgrad.wgmma_plan``). A plain PyTorch model of the
kernels' box decomposition (zero-filled boxes, tap by tap, in their k16
order, one rounding at the end) is held against JAX's bf16 Pallas forward,
input gradient and weight gradient (interpret mode, under ``jax.jit``, as
tests/test_torch_bf16.py runs them) and against the port's twins."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from parallel_cnn_tpu.ops import pallas_conv
from parallel_cnn_tpu_torch.nn import resnet, vgg
from parallel_cnn_tpu_torch.ops import tap_conv, tap_wgrad

BF16 = torch.bfloat16
#: One bf16 ulp of the output's scale: the model and JAX sum in f32 in
#: other orders and each rounds once.
ULP = 2.0 ** -7
SIZES = (32, 16, 8, 4, 2, 7, 14)
BATCHES = (1, 37, 128)
CH = tap_conv.WGMMA_CHANNELS
K16 = 16


def rect_origins(n, oh, ow, rect):
    """The origins (image, row, column) of the rectangles that tile
    (N, OH, OW), in the kernels' order (csrc/wgmma_conv.cuh
    ``Rect::origin``): rectangle r is block r of the forward's grid and
    step r of the wgrad's pixel walk."""
    bn, bh, bw = rect
    return [(i, y, x) for i in range(0, n, bn) for y in range(0, oh, bh)
            for x in range(0, ow, bw)]


def tap_box_origin(origin, dy, dx, c0, stride, pad_top, pad_left):
    """The TMA box origin (c0, column, row, image) in x's map (C, W, H, N)
    that tap (dy, dx) of a rectangle at ``origin`` (image, row, column)
    reads, as the kernels' ``issue`` computes it; the map's element stride
    s along W and H lands every s-th element of the box."""
    n0, oy0, ox0 = origin
    return c0, ox0 * stride + dx - pad_left, oy0 * stride + dy - pad_top, n0


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# The shape rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,build", [
    ("resnet18", lambda: resnet.resnet18(10)),
    ("resnet50", lambda: resnet.resnet50(10, cifar_stem=True)),
    ("vgg16", lambda: vgg.vgg16(10)),
])
def test_every_conv_but_the_stem_takes_the_tensor_core_forms(name, build):
    """A hook walk of one forward: every conv of ResNet-18, ResNet-50
    (CIFAR stem) and VGG-16 takes the tensor-core forms, except the stem
    (Cin 3), which keeps the FFMA forms."""
    convs = chip_smoke.conv_geometries(build(), (32, 32, 3))
    stems = [c for c in convs if c[1] == 3]
    assert len(stems) == 1 and stems[0][0] == 32
    for h, cin, cout, k, stride, _, _, count in convs:
        assert tap_conv.wgmma_form(cin, cout, k) == (cin != 3), (h, cin, cout, k, stride)


def test_the_rule_reads_the_shape_alone():
    assert tap_conv.wgmma_form(64, 64, 3) and tap_conv.wgmma_form(2048, 512, 1)
    for cin, cout, k in ((3, 64, 3), (32, 64, 3), (64, 96, 3), (64, 64, 5), (64, 64, 7),
                         (20, 10, 3)):
        assert not tap_conv.wgmma_form(cin, cout, k)


def test_ffma_yardsticks_launch_on_the_card_only():
    """``conv2d_bf16_ffma``, ``conv2d_dgrad_bf16_ffma`` and
    ``conv2d_wgrad_bf16_ffma`` launch the FFMA kernels (the tensor-core
    forms' yardstick): a CPU or f32 operand is refused, with no plain
    fallback."""
    x = torch.zeros((1, 4, 4, 64), dtype=BF16)
    w = torch.zeros((3, 3, 64, 64), dtype=BF16)
    for args in ((x, w), (x.float(), w.float())):
        with pytest.raises(TypeError):
            tap_conv.conv2d_bf16_ffma(*args)
        with pytest.raises(TypeError):
            tap_conv.conv2d_dgrad_bf16_ffma(args[0], args[1], x.shape)
        with pytest.raises(TypeError):
            tap_wgrad.conv2d_wgrad_bf16_ffma(args[0], args[0], 3)


def test_tma_ready_copies_only_views_off_the_boundary():
    buf = torch.arange(65, dtype=BF16)
    aligned = torch.empty(64, dtype=BF16)
    assert tap_conv.tma_ready(aligned) is aligned
    off = buf[1:]
    ready = tap_conv.tma_ready(off)
    assert ready.data_ptr() % 16 == 0 and torch.equal(ready, off)


# ---------------------------------------------------------------------------
# Rectangles and boxes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", SIZES)
def test_rect_is_64_pixels_chosen_from_the_map(size):
    bn, bh, bw = tap_conv.conv_rect(size, size)
    assert bn * bh * bw == tap_conv.WGMMA_ROWS
    # Each side fits a TMA box, stride 2 included (256 elements a side).
    assert 2 * bw <= 256 and 2 * bh <= 256 and bn <= 256
    want = {32: (1, 2, 32), 16: (1, 4, 16), 8: (1, 8, 8), 4: (4, 4, 4), 2: (16, 2, 2)}
    if size in want:
        assert (bn, bh, bw) == want[size]
    # No rectangle covers an image with fewer pixels past its edge.
    area = -(-size // bh) * bh * -(-size // bw) * bw
    for w in (1, 2, 4, 8, 16, 32, 64):
        for h in (1, 2, 4, 8, 16, 32, 64):
            if w * h <= 64:
                assert area <= -(-size // h) * h * -(-size // w) * w


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("n", BATCHES)
def test_rectangles_cover_every_output_once(size, n):
    rect = tap_conv.conv_rect(size, size)
    bn, bh, bw = rect
    origins = rect_origins(n, size, size, rect)
    assert len(origins) == -(-n // bn) * -(-size // bh) * -(-size // bw)
    seen = np.zeros((n, size, size), np.int64)
    for i0, y0, x0 in origins:
        seen[i0:i0 + bn, y0:y0 + bh, x0:x0 + bw] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (1, 2), (3, 2)])
@pytest.mark.parametrize("h,w", [(32, 32), (16, 16), (7, 9), (4, 4), (2, 2), (1, 1), (14, 14)])
def test_tap_boxes_read_the_pixels_each_tap_reads(h, w, k, stride):
    """Element (column j, row r) of tap (dy, dx)'s box, read with element
    stride s from its origin, is x's pixel that output (oy0 + r, ox0 + j)
    takes at that tap under XLA's SAME split; at stride 2 the box lands
    every other column and row."""
    oh, pt, _ = tap_conv.same_pads(h, k, stride)
    ow, pl, _ = tap_conv.same_pads(w, k, stride)
    rect = tap_conv.conv_rect(oh, ow)
    _, bh, bw = rect
    for origin in rect_origins(1, oh, ow, rect):
        for dy in range(k):
            for dx in range(k):
                c0, col, row, img = tap_box_origin(origin, dy, dx, 0, stride, pt, pl)
                assert (c0, img) == (0, origin[0])
                for r in range(bh):
                    for j in range(bw):
                        oy, ox = origin[1] + r, origin[2] + j
                        assert row + r * stride == oy * stride - pt + dy
                        assert col + j * stride == ox * stride - pl + dx


# ---------------------------------------------------------------------------
# The dgrad's phase table
# ---------------------------------------------------------------------------

#: csrc/tap_conv.cu ``DgradPlan``: its fields and sizes, in order.
PLAN_FIELDS = (("phases", 1), ("n_tiles", 1), ("block_begin", 5), ("py", 4), ("px", 4),
               ("hp", 4), ("wp", 4), ("tap_begin", 5), ("slot", 49), ("ay", 49), ("ax", 49))


def plan_fields(table):
    """The int32s of a DgradPlan as its named fields."""
    vals, fields = list(table), {}
    for name, size in PLAN_FIELDS:
        fields[name], vals = vals[:size] if size > 1 else vals[0], vals[size:]
    assert not vals
    return fields


def dgrad_blocks(n, h, w, cin, k, stride):
    """Each block of the tensor-core dgrad's grid as the kernel reads its
    plan (csrc/tap_conv.cu ``tap_dgrad_wgmma_kernel``): the rectangle, the
    phase's parity (py, px) and size (hp, wp), the block's first input
    channel, its rectangle's origin (image, phase row, phase column) in
    (N, hp, wp), and the phase's taps (slot, ay, ax)."""
    rect, table = tap_conv.wgmma_dgrad_plan(n, h, w, cin, k, stride)
    f = plan_fields(table)
    bn, bh, bw = rect
    for b in range(f["block_begin"][f["phases"]]):
        ph = 0
        while ph + 1 < f["phases"] and b >= f["block_begin"][ph + 1]:
            ph += 1
        local = b - f["block_begin"][ph]
        hp, wp = f["hp"][ph], f["wp"][ph]
        tiles_h, tiles_w = -(-hp // bh), -(-wp // bw)
        r = local // f["n_tiles"]
        origin = (r // tiles_w // tiles_h * bn, r // tiles_w % tiles_h * bh, r % tiles_w * bw)
        taps = [(f["slot"][t], f["ay"][t], f["ax"][t])
                for t in range(f["tap_begin"][ph], f["tap_begin"][ph + 1])]
        yield (rect, f["py"][ph], f["px"][ph], hp, wp, local % f["n_tiles"] * CH, origin,
               taps)


# (n, h, w, k, s): both strides, odd sizes at stride 2, the 1x1/s2 conv's
# tapless phases, a 1x1 and a 2x2 map at stride 2, 16-image rectangles.
PLAN_CASES = [(1, 32, 32, 3, 1), (37, 16, 16, 3, 2), (3, 7, 9, 3, 2), (2, 7, 7, 1, 2),
              (5, 8, 8, 1, 2), (4, 14, 14, 1, 1), (5, 1, 1, 3, 2), (19, 2, 2, 3, 2),
              (33, 4, 4, 3, 1)]


@pytest.mark.parametrize("n,h,w,k,s", PLAN_CASES)
def test_dgrad_phase_rectangles_write_every_pixel_once(n, h, w, k, s):
    """The blocks' masked stores, at (j·s + py, i·s + px) for the phase
    pixels of their rectangles inside (N, hp, wp), write every dx pixel of
    every channel block exactly once, tapless phases included."""
    cin = 128
    seen = np.zeros((n, h, w, cin // CH), np.int64)
    for rect, py, px, hp, wp, ci0, origin, _ in dgrad_blocks(n, h, w, cin, k, s):
        i, j, ii, real = _out_index(origin, rect, n, hp, wp)
        np.add.at(seen, (i[real].numpy(), (j[real] * s + py).numpy(),
                         (ii[real] * s + px).numpy(), ci0 // CH), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("n,h,w,k,s", PLAN_CASES)
def test_dgrad_table_taps_are_the_phase_taps(n, h, w, k, s):
    """The table lists ``dgrad_phase_taps``' phases that have pixels, most
    taps first (ties in parity order), each with its own taps in its own
    order; a phase of a 1x1/s2 conv's odd rows or columns has none."""
    f = plan_fields(tap_conv.wgmma_dgrad_plan(n, h, w, 64, k, s)[1])
    live = sorted((p for p in tap_conv.dgrad_phase_taps(h, w, k, s) if p.hp and p.wp),
                  key=lambda p: -len(p.taps))
    assert f["phases"] == len(live)
    for q, p in enumerate(live):
        assert (f["py"][q], f["px"][q], f["hp"][q], f["wp"][q]) == (p.py, p.px, p.hp, p.wp)
        rows = range(f["tap_begin"][q], f["tap_begin"][q + 1])
        assert [(f["slot"][t], f["ay"][t], f["ax"][t]) for t in rows] == list(p.taps)
        if k == 1 and s == 2:
            assert bool(p.taps) == (p.py == p.px == 0)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 256), h=st.sampled_from(SIZES), w=st.sampled_from(SIZES),
       cin=st.sampled_from([64, 128, 512, 2048]), k=st.sampled_from([1, 3]),
       s=st.sampled_from([1, 2]))
def test_wgmma_dgrad_plan_reads_the_shape_alone(n, h, w, cin, k, s):
    """The plan is a function of (N, H, W, Cin, k, s): the rectangle is
    ``conv_rect`` of the largest phase, Cin / 64 channel tiles, one block a
    rectangle and tile of each phase; and the batch moves only the block
    counts, so an image's sum order does not depend on it."""
    rect, table = tap_conv.wgmma_dgrad_plan(n, h, w, cin, k, s)
    assert (rect, list(table)) == (rect, list(tap_conv.wgmma_dgrad_plan(n, h, w, cin, k, s)[1]))
    assert rect == tap_conv.conv_rect(-(-h // s), -(-w // s))
    f = plan_fields(table)
    bn, bh, bw = rect
    assert f["n_tiles"] == cin // CH
    counts = [f["block_begin"][q + 1] - f["block_begin"][q] for q in range(f["phases"])]
    assert counts == [-(-n // bn) * -(-f["hp"][q] // bh) * -(-f["wp"][q] // bw) * (cin // CH)
                      for q in range(f["phases"])]
    other = plan_fields(tap_conv.wgmma_dgrad_plan(n + 1, h, w, cin, k, s)[1])
    assert {key: v for key, v in f.items() if key != "block_begin"} == {
        key: v for key, v in other.items() if key != "block_begin"}


@pytest.mark.parametrize("name,build", [
    ("resnet18", lambda: resnet.resnet18(10)),
    ("resnet50", lambda: resnet.resnet50(10, cifar_stem=True)),
    ("vgg16", lambda: vgg.vgg16(10)),
])
def test_every_dgrad_takes_the_tensor_core_form(name, build):
    """Every conv with a dgrad on the path (all but the stem, whose input
    batch needs no gradient) takes the tensor-core dgrad, and its plan
    fits the kernel: at most 9 taps, slots inside w, a grid of int32."""
    convs = chip_smoke.conv_geometries(build(), (32, 32, 3))
    for h, cin, cout, k, stride, _, _, _ in convs:
        if cin == 3:
            continue
        assert tap_conv.wgmma_form(cin, cout, k), (h, cin, cout, k, stride)
        rect, table = tap_conv.wgmma_dgrad_plan(128, h, h, cin, k, stride)
        f = plan_fields(table)
        assert 0 < f["block_begin"][f["phases"]] < 2 ** 31
        assert f["tap_begin"][f["phases"]] == k * k
        assert all(0 <= f["slot"][t] < k * k for t in range(k * k))


# ---------------------------------------------------------------------------
# The wgrad's chunks
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 256), size=st.sampled_from(SIZES), cin=st.sampled_from([64, 128, 512]),
       cout=st.sampled_from([64, 256, 2048]), k=st.sampled_from([1, 3]))
def test_wgmma_plan_depends_on_the_shape_alone(n, size, cin, cout, k):
    plan = tap_wgrad.wgmma_plan(n, size, size, cin, cout, k)
    assert plan == tap_wgrad.wgmma_plan(n, size, size, cin, cout, k)
    assert plan.rect == tap_conv.conv_rect(size, size)
    bn, bh, bw = plan.rect
    rects = -(-n // bn) * -(-size // bh) * -(-size // bw)
    assert (plan.chunks - 1) * plan.chunk_rects < rects <= plan.chunks * plan.chunk_rects
    assert 1 <= plan.chunks <= tap_wgrad.MAX_CHUNKS
    if plan.chunks > 1:
        assert plan.chunks * 4 * k * k * cin * cout <= tap_wgrad.SCRATCH_CAP_BYTES
        assert plan.chunk_rects >= tap_wgrad.WGMMA_MIN_CHUNK_RECTS
    tiles = k * k // tap_wgrad.wgmma_taps(k) * (cin // CH) * (cout // CH)
    # No more chunks than bring the grid to about the target.
    assert plan.chunks == 1 or tiles * plan.chunks <= 1.5 * tap_wgrad.WGMMA_TARGET_BLOCKS


# ---------------------------------------------------------------------------
# The box decomposition against JAX's bf16 Pallas kernels
# ---------------------------------------------------------------------------


def _box(t, origin, rect, c, col, row, step):
    """The (64 pixels, 64 channels) box TMA lands from NHWC ``t`` at
    (c, col, row, image origin[0]) with element stride ``step``: pixel
    p = (i·bh + r)·bw + j, zeros outside ``t``."""
    n, h, w, _ = t.shape
    bn, bh, bw = rect
    p = torch.arange(tap_conv.WGMMA_ROWS)
    i, r, j = p // (bh * bw) + origin[0], p // bw % bh * step + row, p % bw * step + col
    inside = (i < n) & (r >= 0) & (r < h) & (j >= 0) & (j < w)
    vals = t[i.clamp(0, n - 1), r.clamp(0, h - 1), j.clamp(0, w - 1), c:c + CH]
    return torch.where(inside[:, None], vals, 0.0)


def _out_index(origin, rect, n, oh, ow):
    """Each rectangle pixel's output (image, row, column) and whether it is real."""
    bn, bh, bw = rect
    p = torch.arange(tap_conv.WGMMA_ROWS)
    i, y, x = p // (bh * bw) + origin[0], p // bw % bh + origin[1], p % bw + origin[2]
    return i, y, x, (i < n) & (y < oh) & (x < ow)


def forward_model(x, w, stride):
    """The tensor-core forward's arithmetic in f32: for each rectangle and
    64 output channels, the sum over (dy, dx, channel block, k16) of the
    zero-filled x box times w's rows, rounded to bf16 once."""
    n, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[3]
    oh, pt, _ = tap_conv.same_pads(h, k, stride)
    ow, pl, _ = tap_conv.same_pads(wd, k, stride)
    rect = tap_conv.conv_rect(oh, ow)
    wk = w.reshape(k * k * cin, cout)
    out = torch.zeros((n, oh, ow, cout))
    for origin in rect_origins(n, oh, ow, rect):
        i, y, xx, real = _out_index(origin, rect, n, oh, ow)
        for co0 in range(0, cout, CH):
            acc = torch.zeros((tap_conv.WGMMA_ROWS, CH))
            for tap in range(k * k):
                dy, dx = divmod(tap, k)
                for c0 in range(0, cin, CH):
                    _, col, row, _ = tap_box_origin(origin, dy, dx, c0, stride, pt, pl)
                    a = _box(x, origin, rect, c0, col, row, stride)
                    b = wk[tap * cin + c0:tap * cin + c0 + CH, co0:co0 + CH]
                    for kk in range(0, CH, K16):
                        acc = acc + a[:, kk:kk + K16] @ b[kk:kk + K16]
            out[i[real], y[real], xx[real], co0:co0 + CH] = acc[real]
    return out.to(BF16)


def dgrad_model(g, w, x_shape, stride):
    """The tensor-core dgrad's arithmetic in f32: for each block of its
    plan, the sum over the phase's taps (ascending slot), g's channel
    blocks and k16 steps of g's zero-filled box at the tap's shift (ay, ax)
    times 64 rows of w (the tap's slot, the block's input channels) read
    K-major; stored at the phase's pixels (j·s + py, i·s + px), rounded to
    bf16 once."""
    n, h, wd, cin = x_shape
    k, cout = w.shape[0], w.shape[3]
    wk = w.reshape(k * k * cin, cout)
    dx = torch.full((n, h, wd, cin), float("nan"))
    for rect, py, px, hp, wp, ci0, origin, taps in dgrad_blocks(n, h, wd, cin, k, stride):
        acc = torch.zeros((tap_conv.WGMMA_ROWS, CH))
        for slot, ay, ax in taps:
            for c0 in range(0, cout, CH):
                a = _box(g, origin, rect, c0, origin[2] + ax, origin[1] + ay, 1)
                b = wk[slot * cin + ci0:slot * cin + ci0 + CH, c0:c0 + CH]  # ci rows, co depth
                for kk in range(0, CH, K16):
                    acc = acc + a[:, kk:kk + K16] @ b[:, kk:kk + K16].T
        i, j, ii, real = _out_index(origin, rect, n, hp, wp)
        dx[i[real], j[real] * stride + py, ii[real] * stride + px, ci0:ci0 + CH] = acc[real]
    return dx.to(BF16)


def wgrad_model(x, g, k, stride):
    """The tensor-core wgrad's arithmetic in f32: for each chunk of
    ``wgmma_plan``, the sum over its rectangles and their k16 steps of the
    x box at each tap (transposed) times g's box; the chunks' partials
    summed in order, rounded to bf16 once."""
    n, h, wd, cin = x.shape
    cout = g.shape[3]
    oh, pt, _ = tap_conv.same_pads(h, k, stride)
    ow, pl, _ = tap_conv.same_pads(wd, k, stride)
    plan = tap_wgrad.wgmma_plan(n, oh, ow, cin, cout, k)
    origins = rect_origins(n, oh, ow, plan.rect)
    partial = torch.zeros((plan.chunks, k * k * cin, cout))
    for z in range(plan.chunks):
        for origin in origins[z * plan.chunk_rects:(z + 1) * plan.chunk_rects]:
            for co0 in range(0, cout, CH):
                b = _box(g, origin, plan.rect, co0, origin[2], origin[1], 1)
                for tap in range(k * k):
                    dy, dx = divmod(tap, k)
                    for c0 in range(0, cin, CH):
                        _, col, row, _ = tap_box_origin(origin, dy, dx, c0, stride,
                                                                 pt, pl)
                        a = _box(x, origin, plan.rect, c0, col, row, stride)
                        rows = slice(tap * cin + c0, tap * cin + c0 + CH)
                        for kk in range(0, tap_conv.WGMMA_ROWS, K16):
                            partial[z, rows, co0:co0 + CH] += a[kk:kk + K16].T @ b[kk:kk + K16]
    total = partial[0].clone()
    for z in range(1, plan.chunks):
        total += partial[z]
    return total.reshape(k, k, cin, cout).to(BF16)


# (b, h, w, cin, cout, k, s): 3x3/s1 over two channel blocks, 3x3/s2 at odd
# sizes (16-image rectangles past the batch), 1x1/s1, 1x1/s2; wgrads of
# several chunks.
MODEL_CASES = [
    (2, 6, 6, 128, 64, 3, 1),
    (3, 7, 5, 64, 128, 3, 2),
    (37, 4, 4, 64, 64, 1, 1),
    (2, 8, 8, 64, 64, 1, 2),
]


def _bf16_np(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float().numpy()


@functools.cache
def _case(geometry):
    """Seeded bf16 operands and JAX's bf16 forward, input gradient and
    weight gradient."""
    b, h, w, cin, cout, k, s = geometry
    rng = np.random.default_rng(b * h + cin + k * 7 + s)
    oh, ow = -(-h // s), -(-w // s)
    x = _bf16_np(rng.standard_normal((b, h, w, cin)))
    wt = _bf16_np(rng.standard_normal((k, k, cin, cout)) * 0.1)
    g = _bf16_np(rng.standard_normal((b, oh, ow, cout)))

    @jax.jit
    def f(x, w, g):
        y, vjp = jax.vjp(lambda a, c: pallas_conv.conv2d(a, c, s), x, w)
        return (y,) + vjp(g)

    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, wt, g)]
    return (x, wt, g) + tuple(np.asarray(a, np.float32) for a in f(*j))


def _ulp_close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= ULP * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("geometry", MODEL_CASES, ids=lambda g: "x".join(map(str, g)))
def test_box_forward_model_matches_jax_bf16_pallas(geometry):
    x, wt, _, y_ref, _, _ = _case(geometry)
    got = forward_model(torch.from_numpy(x), torch.from_numpy(wt), geometry[-1])
    _ulp_close(got, y_ref)
    twin = tap_conv.conv2d(torch.from_numpy(x).to(BF16), torch.from_numpy(wt).to(BF16),
                           geometry[-1])
    _ulp_close(got, twin.float().numpy())


@pytest.mark.parametrize("geometry", MODEL_CASES, ids=lambda g: "x".join(map(str, g)))
def test_box_wgrad_model_matches_jax_bf16_pallas(geometry):
    x, _, g, _, _, dw_ref = _case(geometry)
    k, s = geometry[5], geometry[6]
    got = wgrad_model(torch.from_numpy(x), torch.from_numpy(g), k, s)
    _ulp_close(got, dw_ref)
    twin = tap_wgrad.conv2d_wgrad(torch.from_numpy(x).to(BF16), torch.from_numpy(g).to(BF16),
                                  k, s)
    _ulp_close(got, twin.float().numpy())


@pytest.mark.parametrize("geometry", MODEL_CASES, ids=lambda g: "x".join(map(str, g)))
def test_box_dgrad_model_matches_jax_bf16_pallas(geometry):
    x, wt, g, _, dx_ref, _ = _case(geometry)
    s = geometry[-1]
    got = dgrad_model(torch.from_numpy(g), torch.from_numpy(wt), x.shape, s)
    _ulp_close(got, dx_ref)
    twin = tap_conv.conv2d_dgrad(torch.from_numpy(g).to(BF16), torch.from_numpy(wt).to(BF16),
                                 x.shape, s)
    _ulp_close(got, twin.float().numpy())
