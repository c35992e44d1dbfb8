"""The port's CUDA kernels on the card: csrc/tap_conv.cu (forward and
dgrad), csrc/tap_wgrad.cu, csrc/tail_ce.cu, csrc/lenet_fused.cu,
csrc/sgd_update.cu (SGD and SGD-momentum), csrc/lenet_staged.cu and
csrc/mosaic_probe.cu held against their plain PyTorch versions, the
wrappers' refusals on CUDA tensors, and the serving, training,
data-parallel and probe paths' launch counts. Every test here skips without a GPU.

This file imports no JAX, so on a machine with the card and without JAX it
runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import ctypes
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from parallel_cnn_tpu_torch.config import (
    Config,
    FusedStepConfig,
    ServeConfig,
    TrainConfig,
)
from parallel_cnn_tpu_torch.benches import mosaic_probe as probe_bench
from parallel_cnn_tpu_torch.data import pipeline, synthetic
from parallel_cnn_tpu_torch.models import lenet_ref
from parallel_cnn_tpu_torch.nn import resnet
from parallel_cnn_tpu_torch.ops._cuda_build import launch_stream
from parallel_cnn_tpu_torch.ops import (
    lenet_fused,
    lenet_staged,
    mosaic_probe,
    sgd_update,
    tail,
    tap_conv,
    tap_wgrad,
)
from parallel_cnn_tpu_torch.serve import (
    AutoScaler,
    Engine,
    NetServer,
    ReplicaDead,
    ReplicaPool,
    WireStats,
    get,
    hot_swap,
    loadgen,
    scenarios,
    serve_stack,
)
from parallel_cnn_tpu_torch.train import step, trainer, zoo
from parallel_cnn_tpu_torch.utils.tree import tree_leaves, tree_map

from chip_smoke import GRAD_CASES as SMOKE_GRAD_CASES
from chip_smoke import (
    B9_SITES,
    engine_bytes,
    R50_GEOMETRIES,
    STEM224,
    VGG_GEOMETRIES,
    GEOMETRIES,
    DOT_KERNELS,
    DOT_ROWS,
    PROBE_EXACT,
    PROBE_LAUNCHES,
    PROBE_RTOL,
    SGD_LR,
    SGD_TREES,
    card_draw,
    forward_at_tile,
    packing_tree_sgd,
    probe_kernel,
    probe_operands,
    resnet18_bucket_sizes,
    sgd_tree,
    stage_cases,
    STAGED_SIZES,
    tree_sgd_launches,
)

# (b, h, w, cin, cout, k, s): tests/test_pallas_conv.py's geometry plus
# ResNet-18's widest stride-2 shapes at a small batch.
CASES = [
    (2, 8, 8, 4, 8, 3, 1),
    (2, 8, 8, 4, 8, 3, 2),
    (2, 7, 9, 4, 8, 3, 2),
    (3, 8, 8, 4, 8, 1, 1),
    (2, 8, 8, 4, 8, 1, 2),
    (2, 5, 7, 3, 5, 3, 1),
    (2, 8, 8, 4, 8, 5, 1),
    (2, 8, 8, 4, 8, 5, 2),
    (2, 12, 8, 3, 8, 7, 1),
    (2, 12, 8, 3, 8, 7, 2),
    (2, 7, 8, 3, 6, 5, 2),
    (2, 9, 7, 3, 6, 7, 2),
    (2, 8, 8, 256, 512, 3, 2),
    (2, 8, 8, 256, 512, 1, 2),
]
# f32 on both sides with TF32 off; weights scaled by 0.1 as in the JAX tests.
ATOL = 1e-5
# CASES and chip_smoke's GRAD_CASES shapes (Cin 3/20, Cout 10, odd sizes at
# stride 2 with k 3, 5, 7): the forward's 4-byte copies and ragged edges.
FORWARD_CASES = CASES + [c[1:] for c in SMOKE_GRAD_CASES]
# The serving bucket ladder at max_batch 64 (serve/engine.py).
BUCKETS = (1, 2, 4, 8, 16, 32, 64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc (the kernel has no CPU mode)")
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _inputs(dev, b, h, w, cin, cout, k, s, residual, seed):
    rng = np.random.default_rng(seed)
    oh, ow = -(-h // s), -(-w // s)
    arrays = (
        rng.standard_normal((b, h, w, cin)),
        rng.standard_normal((k, k, cin, cout)) * 0.1,
        rng.uniform(0.5, 1.5, cout),
        rng.standard_normal(cout) * 0.1,
        rng.standard_normal((b, oh, ow, cout)) if residual else None,
    )
    return [None if a is None else torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in arrays]


@pytest.mark.parametrize("residual,relu", [(False, False), (True, True)])
@pytest.mark.parametrize("b,h,w,cin,cout,k,s", FORWARD_CASES)
def test_kernel_matches_plain_on_card(card, b, h, w, cin, cout, k, s,
                                      residual, relu):
    x, wt, scale, shift, res = _inputs(card, b, h, w, cin, cout, k, s,
                                       residual, 7 * b + h + k)
    before = tap_conv.launches.count
    got = tap_conv.conv2d_fused(x, wt, scale, shift, res, s, relu)
    torch.cuda.synchronize()
    assert tap_conv.launches.count == before + 1
    ref = tap_conv.conv2d_fused_plain(x, wt, scale, shift, res, s, relu)
    tol = ATOL * max(1.0, float(ref.abs().max()))
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=tol)


def test_conv2d_without_epilogue_on_card(card):
    x, wt, *_ = _inputs(card, 2, 8, 8, 4, 8, 3, 2, False, 1)
    got = tap_conv.conv2d(x, wt, 2)
    ref = tap_conv.conv2d_plain(x, wt, 2)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=ATOL)


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", FORWARD_CASES)
def test_forward_every_tile_matches_plain_and_each_other_on_card(card, b, h, w, cin, cout,
                                                                k, s):
    """Each block tile of the forward, launched through the C entry, within
    ATOL of the plain twin, and every tile's output equal bit for bit: the
    tile changes no output's sum."""
    x, wt, scale, shift, res = _inputs(card, b, h, w, cin, cout, k, s, True, b + h + cin)
    outs = []
    for tile in range(len(tap_conv.FORWARD_TILES)):
        launch, out = forward_at_tile(x, wt, scale, shift, res, s, True, tile)
        assert launch() == 0
        outs.append(out)
    ref = tap_conv.conv2d_fused_plain(x, wt, scale, shift, res, s, True)
    torch.cuda.synchronize()
    tol = ATOL * max(1.0, float(ref.abs().max()))
    np.testing.assert_allclose(outs[0].cpu().numpy(), ref.cpu().numpy(), atol=tol)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_forward_entry_refuses_an_unknown_tile_on_card(card):
    x, wt, scale, shift, _ = _inputs(card, 2, 8, 8, 4, 8, 3, 1, False, 0)
    for tile in (-1, len(tap_conv.FORWARD_TILES)):
        assert forward_at_tile(x, wt, scale, shift, None, 1, True, tile)[0]() != 0


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_kernel_is_batch_position_invariant_on_card(card, geometry):
    """Bit-identical rows whatever the batch around them: the serving
    bucket pads with zero rows and must not change a real row. At every
    ResNet-18 conv, the last row of each serving bucket and row 37 of 64
    equal the same row launched alone, though the tile differs with the
    batch (``forward_tile``)."""
    _, h, cin, cout, k, s, residual, relu, _ = geometry
    x, wt, scale, shift, res = _inputs(card, 64, h, h, cin, cout, k, s, residual, h + cin)
    rows = [(b, b - 1) for b in BUCKETS] + [(64, 37)]
    for b, row in rows:
        part = None if res is None else res[:b]
        got = tap_conv.conv2d_fused(x[:b], wt, scale, shift, part, s, relu)
        alone = tap_conv.conv2d_fused(x[row:row + 1], wt, scale, shift,
                                      None if res is None else res[row:row + 1], s, relu)
        assert torch.equal(got[row:row + 1], alone), (b, row)


@pytest.mark.parametrize(
    "which,mutate,err",
    [
        ("x", lambda t: t.double(), TypeError),
        ("x", lambda t: t.permute(0, 2, 1, 3), ValueError),
        ("w", lambda t: t.cpu(), ValueError),
        ("scale", lambda t: t[:4], ValueError),
    ],
    ids=["float64", "non-contiguous", "weights-on-cpu", "scale-shape"],
)
def test_cuda_wrapper_raises_instead_of_falling_back(card, which, mutate, err):
    names = ("x", "w", "scale", "shift")
    args = dict(zip(names, _inputs(card, 2, 8, 8, 4, 8, 3, 1, False, 0)))
    args[which] = mutate(args[which])
    before = tap_conv.launches.count
    with pytest.raises(err):
        tap_conv.conv2d_fused(*(args[n] for n in names), None, 1, True)
    assert tap_conv.launches.count == before


def test_serve_path_launches_the_kernel_on_card(card):
    handle = get("resnet18")
    cfg = ServeConfig(max_batch=4, precompile=False)
    pool, batcher = serve_stack(handle, cfg, device="cuda", seed=0)
    tap_conv.launches.reset()
    with batcher:
        report = loadgen.run(batcher, n_requests=8, concurrency=2, seed=0)
    assert report.completed == 8
    batches = pool.engines[0].stats.predicts
    assert tap_conv.launches.count == 20 * batches > 0


def test_grow_then_retire_returns_the_card_memory_on_card(card):
    """grow → drain → retire: the retired engine holds no tensors, so the
    card's allocated memory returns to its level before the grow."""
    pool = ReplicaPool(get("resnet18"), max_batch=4, device="cuda", precompile=True)
    xs = loadgen.make_samples(3, (32, 32, 3), seed=0)
    pool.predict(xs, replica=0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    i = pool.grow()
    pool.predict(xs, replica=i)
    assert torch.cuda.memory_allocated() > before
    pool.drain(i)
    pool.retire(i)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    assert pool.alive() == [0] and pool.engines[i].model is None


def test_respawned_replica_logits_are_bit_identical_on_card(card):
    """kill → respawn copies the pool's host weights to the card anew; the
    new replica's logits equal the original's bit for bit at every bucket."""
    pool = ReplicaPool(get("resnet18"), n_replicas=2, max_batch=64, device="cuda")
    xs = loadgen.make_samples(64, (32, 32, 3), seed=4)
    first = {b: pool.predict(xs[:b], replica=1)[0] for b in BUCKETS}
    pool.kill(1)
    with pytest.raises(ReplicaDead):
        pool.predict(xs[:1], replica=1)
    assert pool.respawn(1) == 1
    for b in BUCKETS:
        np.testing.assert_array_equal(pool.predict(xs[:b], replica=1)[0], first[b])
        np.testing.assert_array_equal(pool.predict(xs[:b], replica=0)[0], first[b])


def test_runner_added_mid_traffic_launches_the_kernel_on_card(card):
    """The autoscaler's scale-up while requests flow: the grown replica's
    runner thread serves batches on the pool's card through B10, and the
    launches are 20 per executed batch and warm-up."""
    handle = get("resnet18")
    cfg = ServeConfig(max_batch=8, max_wait_ms=1.0, precompile=True)
    tap_conv.launches.reset()
    pool, batcher = serve_stack(handle, cfg, device="cuda", seed=0)
    scaler = AutoScaler(pool, batcher, min_replicas=1, max_replicas=2)
    xs = loadgen.make_samples(8, handle.in_shape, seed=1)
    with batcher:
        early = [batcher.submit(x) for x in xs]
        assert scaler._scale_up(0.0) == "up"
        assert batcher.n_runners == pool.n_replicas == 2
        late = [batcher.submit(x) for _ in range(8) for x in xs]
        for f in early + late:
            assert f.result(timeout=120).shape == (10,)
    assert {f.replica for f in late} == {0, 1}
    assert pool.engines[1].device == pool.engines[0].device
    assert pool.engines[1].device.type == "cuda"
    warmups = sum(e.stats.warmups for e in pool.engines)
    assert tap_conv.launches.count == 20 * (batcher.executed + warmups)


def test_hot_swap_serves_the_new_weights_and_returns_the_card_memory_on_card(card):
    """hot_swap on the card: the grown replica's logits equal a fresh
    engine's from the new weights bit for bit at every bucket, and the
    retired replica gives its weights back (memory at its level before)."""
    handle = get("resnet18")
    pool, batcher = serve_stack(handle, ServeConfig(max_batch=64), device="cuda", seed=0)
    new = handle.init(seed=7)
    xs = loadgen.make_samples(64, handle.in_shape, seed=3)
    with batcher:
        old = batcher.submit(xs[0]).result(timeout=120)
        before = engine_bytes()
        report = hot_swap(pool, batcher, new)
        after = engine_bytes()
        served = batcher.submit(xs[0]).result(timeout=120)
    assert report["failed_delta"] == 0 and report["stuck"] == []
    assert report["swapped"] == [0] and report["grown"] == [1]
    assert after == before and pool.engines[0].model is None
    fresh = Engine(handle, model=new, max_batch=64, device="cuda")
    for b in BUCKETS:
        np.testing.assert_array_equal(pool.engines[1].predict(xs[:b]), fresh.predict(xs[:b]))
    np.testing.assert_array_equal(served, fresh.predict(xs[:1])[0])
    assert not np.array_equal(served, old)


def test_killed_endpoint_fails_inflight_with_exact_launches_on_card(card, tmp_path):
    """A ResNet-18 batcher behind a NetServer: a request held in flight (the
    worker paused) when the endpoint dies is journaled net_failed; the
    batcher still completes it, and B10's launches stay 20 per executed
    batch and warm-up."""
    from parallel_cnn_tpu_torch import obs as obs_lib
    from parallel_cnn_tpu_torch.config import ObsConfig

    handle = get("resnet18")
    tap_conv.launches.reset()
    pool, batcher = serve_stack(handle, ServeConfig(max_batch=8), device="cuda", seed=0,
                                start=False)
    bundle = obs_lib.from_config(ObsConfig(trace=True, dir=str(tmp_path)), run="kill")
    wire = WireStats()
    x = loadgen.make_samples(1, handle.in_shape, seed=0)[0]
    srv = NetServer(batcher, wire=wire, obs=bundle).start()
    nc = loadgen.NetClient(srv.address, timeout_s=30.0)
    outcome = []

    def call():
        try:
            nc.request(x)
        except loadgen.NetTransportError as e:
            outcome.append(e)

    t = threading.Thread(target=call)
    t.start()
    deadline = time.monotonic() + 30
    while wire.snapshot()["submitted"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    srv.kill(reason="test")
    t.join(timeout=30)
    nc.close()
    assert not t.is_alive() and outcome
    with batcher:
        batcher.start()
        deadline = time.monotonic() + 30
        while batcher.stats.snapshot()["completed"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
    delta, balanced = scenarios.settled_wire_delta(wire, {})
    assert balanced and delta["failed"] == delta["submitted"] == 1
    counts = bundle.journal.counts()
    bundle.finish()
    assert counts["net_failed"] == 1 and counts["endpoint_killed"] == 1
    assert obs_lib.conservation(counts, prefix="net_") is None
    assert batcher.executed == 1
    assert tap_conv.launches.count == 20 * (batcher.executed + pool.warmups)


# ---------------------------------------------------------------------------
# The LeNet-ref trainer's kernels
# ---------------------------------------------------------------------------

# B1 vs its plain version, f32 on the card: the two sum up to 576 products
# per grad value in different orders.
LENET_RTOL = 1e-5


def _lenet_inputs(dev, n, seed):
    rng = np.random.default_rng(seed)
    params = tree_map(lambda t: t.to(dev),
                      lenet_ref.init(torch.Generator().manual_seed(seed)))
    xs = torch.from_numpy(rng.uniform(0, 1, (n, 28, 28)).astype(np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, 10, (n,))).to(dev)  # int64, as torch makes them
    return params, xs, ys


# Batches around a warp's 32 and the finish's 32 and 8 batch shards, the
# path's 64, 128 and 1000, and 4097 past every power of two the grids use.
LENET_FUSED_SIZES = [1, 2, 7, 63, 64, 65, 128, 130, 1000, 4097]


@pytest.mark.parametrize("n", LENET_FUSED_SIZES)
def test_lenet_fused_matches_plain_on_card(card, n):
    """B1 against its plain version (f32; sums in other orders, relative to
    each leaf's scale), and a relaunch bit for bit."""
    params, xs, ys = _lenet_inputs(card, n, n)
    before = lenet_fused.launches.count
    err, grads = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
    err2, grads2 = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
    torch.cuda.synchronize()
    assert lenet_fused.launches.count == before + 2
    assert torch.equal(err, err2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(grads2)))
    ref_err, ref = lenet_fused.fused_value_and_ref_grads_plain(params, xs, ys)
    assert abs(float(err) - float(ref_err)) <= LENET_RTOL * max(1.0, abs(float(ref_err)))
    for g, r in zip(tree_leaves(grads), tree_leaves(ref)):
        assert g.shape == r.shape
        tol = LENET_RTOL * max(1.0, float(r.abs().max()))
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=tol)


def test_lenet_fused_reads_images_off_the_16_byte_boundary_on_card(card):
    """Images one value into a buffer take the 4-byte staging; the sums
    keep their order, so the result equals the aligned call's bit for bit."""
    params, xs, ys = _lenet_inputs(card, 65, 9)
    flat = torch.zeros(xs.numel() + 1, device=card)
    flat[1:] = xs.reshape(-1)
    shifted = flat[1:].view(xs.shape)
    assert shifted.data_ptr() % 16
    err, grads = lenet_fused.fused_value_and_ref_grads(params, shifted, ys)
    ref_err, ref = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
    assert torch.equal(err, ref_err)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(ref)))


def test_lenet_fused_is_deterministic_on_card(card):
    params, xs, ys = _lenet_inputs(card, 1000, 3)
    e1, g1 = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
    e2, g2 = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
    assert torch.equal(e1, e2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda p, x, y: (p, x.double(), y), TypeError),
        (lambda p, x, y: (p, x.transpose(1, 2), y), ValueError),
        (lambda p, x, y: (p, x, y.cpu()), ValueError),
        (lambda p, x, y: (p, x, y[:-1]), ValueError),
        (lambda p, x, y: ({**p, "f": {"w": p["f"]["w"].cpu(), "b": p["f"]["b"]}}, x, y),
         ValueError),
        (lambda p, x, y: (p, x[:, :27], y), ValueError),
    ],
    ids=["float64", "non-contiguous", "labels-on-cpu", "label-count",
         "weights-on-cpu", "image-shape"],
)
def test_lenet_fused_raises_instead_of_falling_back(card, mutate, err):
    args = mutate(*_lenet_inputs(card, 4, 0))
    before = lenet_fused.launches.count
    with pytest.raises(err):
        lenet_fused.fused_value_and_ref_grads(*args)
    assert lenet_fused.launches.count == before


@pytest.mark.parametrize("n", [1, 127, 128, 2343, 5 * 128 + 37, 2**20])
def test_sgd_update_is_bit_identical_to_plain_on_card(card, n):
    gen = torch.Generator(device=card).manual_seed(n)
    p = torch.randn(n, generator=gen, device=card)
    g = torch.randn(n, generator=gen, device=card)
    before = sgd_update.launches.count
    got = sgd_update.fused_sgd(p, g, lr=-0.1, scale=1.0 / 64)
    torch.cuda.synchronize()
    assert sgd_update.launches.count == before + 1
    assert torch.equal(got, sgd_update.fused_sgd_plain(p, g, -0.1, 1.0 / 64))
    # An unaligned view takes the scalar path and agrees as well.
    if n > 4:
        got = sgd_update.fused_sgd(p[1:], g[1:], lr=0.05, scale=0.25)
        assert torch.equal(got, sgd_update.fused_sgd_plain(p[1:], g[1:], 0.05, 0.25))


def test_sgd_update_raises_instead_of_falling_back(card):
    p = torch.zeros(16, device=card)
    before = sgd_update.launches.count
    with pytest.raises(TypeError):
        sgd_update.fused_sgd(p, torch.zeros(16, device=card, dtype=torch.float64), lr=0.1)
    with pytest.raises(ValueError):
        sgd_update.fused_sgd(p, torch.zeros(16), lr=0.1)
    with pytest.raises(ValueError):
        sgd_update.fused_sgd(p[::2], torch.zeros(8, device=card), lr=0.1)
    assert sgd_update.launches.count == before


@pytest.mark.parametrize("which", SGD_TREES)
def test_tree_sgd_is_the_packing_composition_bit_for_bit_on_card(card, which):
    """tree_sgd on the card reads each bucket's leaves where they lie: bit
    for bit the parent's composition (both trees packed, fused_sgd_plain
    a bucket, unpacked) for LeNet's fresh params, its params as views of a
    bucket after a step (leaves at element offsets 0, 6, 156, 166, 2,326
    and 2,327: float4, float2 and 4-byte accesses), the mixed tree with
    its 0-d leaf and MAX_LEAVES + 5 leaves (two launches); one launch a
    bucket's MAX_LEAVES leaves, a relaunch bit for bit, and the leaves
    returned as views of one output bucket."""
    params, grads = sgd_tree(which, card)
    if which == "lenet_views":
        leaves = tree_leaves(params)
        assert [t.storage_offset() for t in leaves] == [0, 6, 156, 166, 2326, 2327]
        assert len({t.untyped_storage().data_ptr() for t in leaves}) == 1
    before = sgd_update.launches.count
    got = sgd_update.tree_sgd(params, grads, lr=SGD_LR, scale=1.0 / 64)
    again = sgd_update.tree_sgd(params, grads, lr=SGD_LR, scale=1.0 / 64)
    torch.cuda.synchronize()
    assert sgd_update.launches.count == before + 2 * tree_sgd_launches(params)
    assert tree_sgd_launches(params) == (2 if which == "many" else 1)
    want = packing_tree_sgd(params, grads, SGD_LR, 1.0 / 64, plain=True)
    got_l, again_l, want_l = tree_leaves(got), tree_leaves(again), tree_leaves(want)
    assert len(got_l) == len(want_l) == len(tree_leaves(params))
    for g, a, w in zip(got_l, again_l, want_l):
        assert g.shape == w.shape and torch.equal(g, w) and torch.equal(a, w)
    assert len({t.untyped_storage().data_ptr() for t in got_l}) == 1


def test_sgd_update_leaves_entry_refuses_what_it_does_not_take_on_card(card):
    """The leaf list's C entry refuses an empty list, more than MAX_LEAVES
    leaves, a leaf of length 0 and a null output, and launches nothing; an
    output span off the 16-byte boundary it takes, and writes exactly the
    span, the leaves packed in order."""
    k = sgd_update.MAX_LEAVES + 1
    ps = [torch.randn(3, device=card) for _ in range(k)]
    gs = [torch.randn(3, device=card) for _ in range(k)]
    ptrs = (ctypes.c_void_p * (2 * k))(*[t.data_ptr() for p, g in zip(ps, gs)
                                         for t in (p, g)])
    lens = (ctypes.c_longlong * k)(*([3] * k))
    zero = (ctypes.c_longlong * k)(*([3, 0] + [3] * (k - 2)))
    buf = torch.full((3 * k + 2,), float("nan"), device=card)
    out = buf[1:].data_ptr()  # 4 bytes off the boundary
    lib = sgd_update._lib()
    stream = launch_stream(card)
    before = sgd_update.launches.count
    for args in ((ptrs, lens, 0, out), (ptrs, lens, k, out), (ptrs, zero, 2, out),
                 (ptrs, lens, 2, None)):
        assert lib.sgd_update_leaves(*args, 0.1, 1.0, stream) == 1
    torch.cuda.synchronize()
    assert bool(buf.isnan().all())
    assert lib.sgd_update_leaves(ptrs, lens, 2, out, 0.1, 0.5, stream) == 0
    torch.cuda.synchronize()
    want = sgd_update.fused_sgd_plain(torch.cat(ps[:2]), torch.cat(gs[:2]), 0.1, 0.5)
    assert torch.equal(buf[1:7], want)
    assert bool(buf[0].isnan()) and bool(buf[7:].isnan().all())
    assert sgd_update.launches.count == before  # the C entry counts nothing


# B13 at odd sizes and ResNet-18's first and last bucket (971,328; 5,130).
MOMENTUM_SIZES = [1, 127, 128, 5130, 128_037, 971_328]


def _momentum_inputs(dev, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(n, generator=gen, device=dev) for _ in range(3)]


@pytest.mark.parametrize("n", MOMENTUM_SIZES)
def test_sgd_momentum_is_bit_identical_to_plain_on_card(card, n):
    p, m, g = _momentum_inputs(card, n, n)
    scale = torch.tensor(1.0 / 3.0, device=card)
    before = sgd_update.momentum_launches.count
    got = sgd_update.fused_sgd_momentum(p, m, g, lr=0.1, momentum=0.9, scale=scale)
    again = sgd_update.fused_sgd_momentum(p, m, g, lr=0.1, momentum=0.9, scale=scale)
    want = sgd_update.fused_sgd_momentum_plain(p, m, g, 0.1, 0.9, scale)
    torch.cuda.synchronize()
    assert sgd_update.momentum_launches.count == before + 2
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c) and torch.equal(a, b)
    if n > 4:  # an unaligned view takes the scalar path and agrees as well
        got = sgd_update.fused_sgd_momentum(p[1:], m[1:], g[1:], lr=0.05,
                                            momentum=0.9, scale=scale)
        want = sgd_update.fused_sgd_momentum_plain(p[1:], m[1:], g[1:], 0.05, 0.9, scale)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_sgd_momentum_reads_its_scale_on_the_card(card):
    """The scale is read from device memory at run time: a value written
    into the same tensor on the device (no host copy) changes the result."""
    p, m, g = _momentum_inputs(card, 4096, 1)
    scale = torch.ones((), device=card)
    one = sgd_update.fused_sgd_momentum(p, m, g, lr=0.1, momentum=0.9, scale=scale)
    scale.mul_(0.25)
    quarter = sgd_update.fused_sgd_momentum(p, m, g, lr=0.1, momentum=0.9, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(quarter[1], sgd_update.fused_sgd_momentum_plain(
        p, m, g, 0.1, 0.9, torch.tensor(0.25, device=card))[1])
    assert not torch.equal(one[1], quarter[1])


def test_sgd_momentum_raises_instead_of_falling_back(card):
    p, m, g = _momentum_inputs(card, 16, 2)
    before = sgd_update.momentum_launches.count
    with pytest.raises(TypeError):
        sgd_update.fused_sgd_momentum(p, m.double(), g, lr=0.1, momentum=0.9)
    with pytest.raises(ValueError):
        sgd_update.fused_sgd_momentum(p, m.cpu(), g, lr=0.1, momentum=0.9)
    with pytest.raises(ValueError):
        sgd_update.fused_sgd_momentum(p, m, g, lr=0.1, momentum=0.9,
                                      scale=torch.ones(()))
    with pytest.raises(ValueError):
        sgd_update.fused_sgd_momentum(p[::2], m[::2], g[::2], lr=0.1, momentum=0.9)
    assert sgd_update.momentum_launches.count == before


def _dp_train_rank(mesh, steps):
    from parallel_cnn_tpu_torch.config import CommConfig, FusedStepConfig
    from parallel_cnn_tpu_torch.nn import cifar

    imgs, labels = synthetic.make_image_dataset(16 * steps, seed=3)
    model = cifar.cifar_cnn(generator=torch.Generator().manual_seed(0))
    # 64 KiB buckets: the CIFAR CNN's 308,394 params make 10 of them.
    state, losses = zoo.train(
        model, imgs, labels, batch_size=16, lr=0.01, mesh=mesh,
        comm=CommConfig(impl="ring", bucket_bytes=1 << 16),
        fused=FusedStepConfig(act_dtype="float32"), verbose=False)
    return state.fused is not None, len(state.fused.mom), losses


def test_update_on_arrival_launches_the_kernel_once_per_step_on_card(card):
    from parallel_cnn_tpu_torch.parallel import distributed

    sgd_update.momentum_launches.reset()
    fused, n_buckets, losses = distributed.run(_dp_train_rank, 1, device="cuda",
                                               args=(5,))[0]
    assert fused and n_buckets > 1 and np.isfinite(losses).all()
    assert sgd_update.momentum_launches.count == 5


def _mesh_train_rank(mesh, ops):
    ds = pipeline.Dataset(*synthetic.make_dataset(320, seed=3))
    cfg = Config(train=TrainConfig(batch_size=64, epochs=2, ops=ops, shuffle=True))
    res = trainer.learn(cfg, ds, verbose=False, mesh=mesh)
    return res.steps, res.epoch_errors, tree_map(lambda t: t.cpu(), res.params)


def test_mesh_trainer_launches_the_fused_kernel_once_per_step_on_card(card):
    """LeNet-ref over a 1 x 1 mesh on the card: every step one B1 launch,
    no B2 launch (the mesh step applies its own update), and the same
    trajectory as the single-device kernel path within the step tolerance."""
    from parallel_cnn_tpu_torch.parallel import distributed

    lenet_fused.launches.reset()
    sgd_update.launches.reset()
    steps, errs, params = distributed.run(_mesh_train_rank, 1, device="cuda",
                                          shape=(1, 1), args=("cuda",))[0]
    assert steps == 10 and lenet_fused.launches.count == steps
    assert sgd_update.launches.count == 0
    ds = pipeline.Dataset(*synthetic.make_dataset(320, seed=3))
    single = trainer.learn(Config(train=TrainConfig(batch_size=64, epochs=2, ops="cuda",
                                                    shuffle=True)),
                           ds, verbose=False, device="cuda")
    np.testing.assert_allclose(errs, single.epoch_errors, rtol=1e-5)
    for a, b in zip(tree_leaves(params), tree_leaves(single.params)):
        assert float((a - b.cpu()).abs().max()) <= 1e-5


def _bucket_lists(dev, sizes, seed):
    """Three lists of seeded normal buckets (p, m, g) of these sizes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [[torch.randn(n, generator=gen, device=dev) for n in sizes] for _ in range(3)]


def _bucket_list_sizes(lists):
    """B13's list form: odd lengths (ragged tails in every entry but one),
    ResNet-18's 12 bucket sizes, and more entries than one launch takes (3
    launches)."""
    if lists == "odd":
        return [1, 3, 127, 128_037]
    if lists == "resnet18":
        return resnet18_bucket_sizes()
    return [(37 * i) % 1001 + 1 for i in range(2 * sgd_update.MAX_ENTRIES + 5)]


@pytest.mark.parametrize("view", ["whole", "offset"])
@pytest.mark.parametrize("lists", ["odd", "resnet18", "past-max-entries"])
def test_sgd_momentum_buckets_are_bit_identical_to_plain_on_card(card, lists, view):
    """Each entry of the one-launch list form equals the plain version bit
    for bit, a relaunch too, and the counter moves by one per MAX_ENTRIES
    entries. "offset" views start one value in (p[1:]), off the 16-byte
    boundary, so those entries take the scalar path."""
    sizes = _bucket_list_sizes(lists)
    ps, ms, gs = _bucket_lists(card, [n + 1 for n in sizes], len(sizes))
    if view == "offset":
        ps, ms, gs = ([t[1:] for t in ts] for ts in (ps, ms, gs))
    else:
        ps, ms, gs = ([t[:-1] for t in ts] for ts in (ps, ms, gs))
    scale = torch.tensor(1.0 / 3.0, device=card)
    before = sgd_update.momentum_launches.count
    got = sgd_update.fused_sgd_momentum_buckets(ps, ms, gs, lr=0.1, momentum=0.9,
                                                scale=scale)
    again = sgd_update.fused_sgd_momentum_buckets(ps, ms, gs, lr=0.1, momentum=0.9,
                                                  scale=scale)
    torch.cuda.synchronize()
    launches = -(-len(sizes) // sgd_update.MAX_ENTRIES)
    assert sgd_update.momentum_launches.count == before + 2 * launches
    for i, (p, m, g) in enumerate(zip(ps, ms, gs)):
        want = sgd_update.fused_sgd_momentum_plain(p, m, g, 0.1, 0.9, scale)
        for k in range(2):
            assert torch.equal(got[k][i], want[k]), (i, k)
            assert torch.equal(again[k][i], got[k][i]), (i, k)


def test_sgd_momentum_buckets_refuse_on_card(card):
    """An empty list, a bucket on another device, a wrong dtype in a later
    launch's group: each raises before any launch."""
    ps, ms, gs = _bucket_lists(card, [5, 9], 4)
    before = sgd_update.momentum_launches.count
    with pytest.raises(ValueError):
        sgd_update.fused_sgd_momentum_buckets([], [], [], lr=0.1, momentum=0.9)
    with pytest.raises(ValueError):
        sgd_update.fused_sgd_momentum_buckets(ps, [ms[0], ms[1].cpu()], gs, lr=0.1,
                                              momentum=0.9)
    with pytest.raises(ValueError):
        sgd_update.fused_sgd_momentum_buckets(ps, ms[:1], gs, lr=0.1, momentum=0.9)
    many = _bucket_lists(card, [3] * (sgd_update.MAX_ENTRIES + 1), 5)
    many[2][-1] = many[2][-1].double()
    with pytest.raises(TypeError):
        sgd_update.fused_sgd_momentum_buckets(*many, lr=0.1, momentum=0.9)
    assert sgd_update.momentum_launches.count == before


@pytest.mark.parametrize("ops,fused,counter", [
    ("cuda", False, lenet_fused.launches),
    ("reference", True, sgd_update.launches),
], ids=["ops-cuda", "fused-step"])
def test_train_path_launches_the_kernel_on_card(card, ops, fused, counter):
    imgs, labels = synthetic.make_dataset(640, seed=1)
    cfg = Config(train=TrainConfig(epochs=1, batch_size=64, ops=ops), fused=fused)
    counter.reset()
    res = trainer.learn(cfg, pipeline.Dataset(imgs, labels), verbose=False)
    assert res.steps == 10 and counter.count == 10
    assert res.params["f"]["w"].device.type == "cuda"


def test_cuda_step_matches_plain_step_on_card(card):
    params, xs, ys = _lenet_inputs(card, 64, 9)
    got, e1 = step.cuda_batched_step(params, xs, ys, 0.1)
    want, e2 = step.batched_step(params, xs, ys, 0.1)
    assert abs(float(e1) - float(e2)) < 1e-5
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# The zoo trainer's kernels: dgrad (tap_conv.cu), wgrad (tap_wgrad.cu), the
# fused loss tail (tail_ce.cu)
# ---------------------------------------------------------------------------

# (b, h, w, cin, cout, k, s): every ResNet-18 conv geometry at batch 8, then
# the k = 5 and 7, odd-size and stride-2 shapes of CASES, then chip_smoke's
# GRAD_CASES (many wgrad chunks, a ragged last chunk, Cin 3/20 and Cout 10,
# odd sizes at stride 2 with k 3, 5, 7).
GRAD_CASES = [
    (8, 32, 32, 3, 64, 3, 1), (8, 32, 32, 64, 64, 3, 1),
    (8, 32, 32, 64, 128, 3, 2), (8, 32, 32, 64, 128, 1, 2),
    (8, 16, 16, 128, 128, 3, 1), (8, 16, 16, 128, 256, 3, 2),
    (8, 16, 16, 128, 256, 1, 2), (8, 8, 8, 256, 256, 3, 1),
    (8, 8, 8, 256, 512, 3, 2), (8, 8, 8, 256, 512, 1, 2),
    (8, 4, 4, 512, 512, 3, 1),
] + [c for c in CASES if c[0] < 8] + [c[1:] for c in SMOKE_GRAD_CASES]
# f32 on both sides, TF32 off; the sums run in other orders (wgrad sums
# up to N·OH·OW = 8192 products per value), so relative to the output scale.
GRAD_RTOL = 1e-4


def _close(got, want, rtol=GRAD_RTOL):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    tol = rtol * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


def _grad_inputs(dev, b, h, w, cin, cout, k, s, seed):
    rng = np.random.default_rng(seed)
    oh, ow = -(-h // s), -(-w // s)
    arrays = (rng.standard_normal((b, h, w, cin)),
              rng.standard_normal((k, k, cin, cout)) * 0.1,
              rng.standard_normal((b, oh, ow, cout)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", GRAD_CASES)
def test_dgrad_and_wgrad_match_plain_on_card(card, b, h, w, cin, cout, k, s):
    x, wt, g = _grad_inputs(card, b, h, w, cin, cout, k, s, b + h * w + k)
    d0, w0 = tap_conv.dgrad_launches.count, tap_wgrad.launches.count
    dx = tap_conv.conv2d_dgrad(g, wt, x.shape, s)
    gw = tap_wgrad.conv2d_wgrad(x, g, k, s)
    dx2 = tap_conv.conv2d_dgrad(g, wt, x.shape, s)
    gw2 = tap_wgrad.conv2d_wgrad(x, g, k, s)
    torch.cuda.synchronize()
    assert tap_conv.dgrad_launches.count == d0 + 2
    assert tap_wgrad.launches.count == w0 + 2
    assert torch.equal(dx, dx2) and torch.equal(gw, gw2)  # relaunch
    _close(dx, tap_conv.conv2d_dgrad_plain(g, wt, x.shape, s))
    _close(gw, tap_wgrad.conv2d_wgrad_plain(x, g, k, s))


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9)])
def test_dgrad_writes_exact_zeros_where_no_tap_lands_on_card(card, h, w):
    """A 1x1/s2 conv reaches only the even rows and columns: its other
    three phases have no tap, and the kernel writes them as exact zeros."""
    x, wt, g = _grad_inputs(card, 3, h, w, 8, 16, 1, 2, 7)
    dx = tap_conv.conv2d_dgrad(g, wt, x.shape, 2)
    torch.cuda.synchronize()
    assert bool((dx[:, 1::2] == 0).all()) and bool((dx[:, :, 1::2] == 0).all())
    _close(dx[:, ::2, ::2], g @ wt[0, 0].T)


def test_wgrad_entry_refuses_a_chunk_off_the_stage_depth(card):
    x, wt, g = _grad_inputs(card, 2, 8, 8, 4, 8, 3, 1, 0)
    gw = torch.empty_like(wt)
    lib = tap_wgrad.build().get()
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), g.data_ptr(), None, gw.data_ptr(), 2, 8, 8, 4, 8, 8, 8, 3, 1, 1, 1)
    assert lib.tap_wgrad_stage_pixels() == tap_wgrad.STAGE_PIXELS
    assert lib.tap_conv_wgrad(*args, tap_wgrad.STAGE_PIXELS + 1, stream) != 0
    assert lib.tap_conv_wgrad(*args, 128, stream) == 0  # one chunk: no scratch
    torch.cuda.synchronize()
    _close(gw, tap_wgrad.conv2d_wgrad_plain(x, g, 3, 1))


def test_conv2d_autograd_runs_the_grad_kernels_on_card(card):
    x, wt, g = _grad_inputs(card, 2, 8, 8, 4, 8, 3, 2, 5)
    x.requires_grad_(True)
    wt.requires_grad_(True)
    counts = (tap_conv.launches.count, tap_conv.dgrad_launches.count,
              tap_wgrad.launches.count)
    y = tap_conv.conv2d(x, wt, 2)
    dx, dw = torch.autograd.grad(y, (x, wt), g)
    assert (tap_conv.launches.count, tap_conv.dgrad_launches.count,
            tap_wgrad.launches.count) == tuple(c + 1 for c in counts)
    _close(dx, tap_conv.conv2d_dgrad_plain(g, wt.detach(), x.shape, 2))
    _close(dw, tap_wgrad.conv2d_wgrad_plain(x.detach(), g, 3, 2))
    # No input gradient wanted (the stem's batch): no dgrad launch.
    y = tap_conv.conv2d(x.detach(), wt, 2)
    torch.autograd.grad(y, wt, g)
    assert tap_conv.dgrad_launches.count == counts[1] + 1


def test_grad_wrappers_raise_instead_of_falling_back(card):
    x, wt, g = _grad_inputs(card, 2, 8, 8, 4, 8, 3, 1, 0)
    counts = (tap_conv.dgrad_launches.count, tap_wgrad.launches.count)
    with pytest.raises(TypeError):
        tap_conv.conv2d_dgrad(g.double(), wt, x.shape, 1)
    with pytest.raises(ValueError):
        tap_conv.conv2d_dgrad(g, wt.cpu(), x.shape, 1)
    with pytest.raises(ValueError):
        tap_wgrad.conv2d_wgrad(x, g.transpose(1, 2), 3, 1)
    with pytest.raises(ValueError):
        tap_wgrad.conv2d_wgrad(x, g[:, :4], 3, 1)
    assert (tap_conv.dgrad_launches.count, tap_wgrad.launches.count) == counts


def _tail_inputs(dev, b, pool, seed):
    rng = np.random.default_rng(seed)
    shape = {"max2": (b, 8, 8, 128), "gap": (b, 4, 4, 512), "none": (b, 2, 2, 64)}[pool]
    x = np.maximum(rng.standard_normal(shape), 0.0)  # ReLU ties, as in training
    d = {"max2": 4 * 4 * 128, "gap": 512, "none": 256}[pool]
    w = rng.standard_normal((d, 10)) * 0.05
    bias = rng.standard_normal(10) * 0.1
    y = rng.integers(0, 10, b)
    t = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, w, bias)]
    return (*t, torch.from_numpy(y).to(dev))


@pytest.mark.parametrize("pool", ["max2", "gap", "none"])
@pytest.mark.parametrize("b", [1, 7, 128])
def test_tail_kernel_matches_plain_on_card(card, b, pool):
    x, w, bias, y = _tail_inputs(card, b, pool, b + len(pool))
    before = tail.launches.count
    loss, dl = tail.tail_forward(x, w, bias, y, pool)
    loss2, dl2 = tail.tail_forward(x, w, bias, y, pool)
    torch.cuda.synchronize()
    assert tail.launches.count == before + 2
    assert torch.equal(loss, loss2) and torch.equal(dl, dl2)
    ref_loss, ref_dl = tail.tail_forward_plain(x, w, bias, y, pool)
    _close(loss, ref_loss, 1e-5)
    _close(dl, ref_dl, 1e-5)


def test_tail_raises_instead_of_falling_back(card):
    x, w, bias, y = _tail_inputs(card, 4, "gap", 0)
    before = tail.launches.count
    with pytest.raises(TypeError):
        tail.fused_tail_loss(x, w, bias, y.int(), pool="gap")
    with pytest.raises(ValueError):
        tail.fused_tail_loss(x, w.cpu(), bias, y, pool="gap")
    with pytest.raises(ValueError):
        tail.fused_tail_loss(x.permute(0, 2, 1, 3), w, bias, y, pool="gap")
    assert tail.launches.count == before


def _tail_rows(x, w, bias, y, pool, lo, hi):
    """The kernel's rows for images [lo, hi) run as a batch of their own."""
    return tail.tail_forward(x[lo:hi], w, bias, y[lo:hi], pool)


@pytest.mark.parametrize("pool", ["max2", "gap", "none"])
def test_tail_rows_are_batch_invariant_on_card(card, pool):
    """An image's loss and dlogits are bit-identical in a b128 call, alone
    (b1) and in b7 calls, whatever its place in the batch (a block an
    image: the rows come from the first, a middle and the last block of the
    b128 call)."""
    x, w, bias, y = _tail_inputs(card, 128, pool, 40 + len(pool))
    loss, dl = tail.tail_forward(x, w, bias, y, pool)
    for lo, hi in ((0, 1), (61, 62), (127, 128), (0, 7), (64, 71), (121, 128)):
        part_loss, part_dl = _tail_rows(x, w, bias, y, pool, lo, hi)
        torch.cuda.synchronize()
        assert torch.equal(part_loss, loss[lo:hi]), (lo, hi)
        assert torch.equal(part_dl, dl[lo:hi]), (lo, hi)


def _tail_view(t, view):
    """t itself, or a contiguous copy one float past a 16-byte boundary
    (the kernel's 4-byte loads)."""
    if view == "whole":
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("view", ["whole", "offset"])
@pytest.mark.parametrize("k", [10, 100, 300])
@pytest.mark.parametrize("pool", ["max2", "gap", "none"])
def test_tail_classes_and_out_of_range_labels_match_plain_on_card(card, pool, k, view):
    """K = 10, 100 (the softmax's lanes take several classes) and 300 (more
    classes than a block has threads: the FC takes them in passes), labels
    drawn from [-2, K + 2) (outside [0, K) a zero one-hot row), at b7,
    within 1e-5 of the plain version; a relaunch bit for bit."""
    x, w, bias, _ = _tail_inputs(card, 7, pool, 70 + k)
    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.standard_normal((w.shape[0], k)).astype(np.float32) * 0.05).to(card)
    bias = torch.from_numpy(rng.standard_normal(k).astype(np.float32) * 0.1).to(card)
    y = torch.from_numpy(rng.integers(-2, k + 2, 7)).to(card)
    y[0], y[1] = -1, k  # at least one label on each side of the range
    x = _tail_view(x, view)
    loss, dl = tail.tail_forward(x, w, bias, y, pool)
    loss2, dl2 = tail.tail_forward(x, w, bias, y, pool)
    ref_loss, ref_dl = tail.tail_forward_plain(x, w, bias, y, pool)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2) and torch.equal(dl, dl2)
    _close(loss, ref_loss, 1e-5)
    _close(dl, ref_dl, 1e-5)


@pytest.mark.parametrize("shape", [(4, 4, 64), (3, 5, 8), (8, 8, 32), (2, 2, 6), (4, 4, 512)])
def test_tail_gap_shapes_match_plain_on_card(card, shape):
    """gap at other widths and position counts than ResNet-18's 4x4x512:
    fewer channel quads than threads (4x4x64, 3x5x8), more positions than
    one batch of loads (8x8x32: 64), C = 6 (the 4-byte loads). At b7 within
    1e-5 of the plain version, a relaunch bit for bit, each row as its image
    alone."""
    gen = torch.Generator(device="cuda").manual_seed(shape[2])
    x = torch.relu(torch.randn((7,) + shape, generator=gen, device="cuda"))
    w = torch.randn((shape[2], 10), generator=gen, device="cuda") * shape[2] ** -0.5
    bias = 0.1 * torch.randn((10,), generator=gen, device="cuda")
    y = torch.randint(0, 10, (7,), generator=gen, device="cuda")
    loss, dl = tail.tail_forward(x, w, bias, y, "gap")
    loss2, dl2 = tail.tail_forward(x, w, bias, y, "gap")
    ref_loss, ref_dl = tail.tail_forward_plain(x, w, bias, y, "gap")
    alone = _tail_rows(x, w, bias, y, "gap", 3, 4)
    torch.cuda.synchronize()
    assert torch.equal(loss, loss2) and torch.equal(dl, dl2)
    assert torch.equal(alone[0], loss[3:4]) and torch.equal(alone[1], dl[3:4])
    _close(loss, ref_loss, 1e-5)
    _close(dl, ref_dl, 1e-5)


@pytest.mark.parametrize("pool,shape", [("max2", (3, 2, 2, 12_268)), ("gap", (3, 2, 3, 12_268)),
                                        ("none", (3, 1, 2, 6_134))])
def test_tail_opts_in_at_the_48_kb_limit_and_refuses_past_it_on_card(card, pool, shape):
    """A row of 12,268 features and 10 classes is the widest the wrapper
    takes (D + K + 8 floats in 48 KB); the threads' partial logits take the
    block past 48 KB, so the launch opts in, and it matches the plain
    version. A row of 12,271 features raises ValueError before any
    launch."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.relu(torch.randn(shape, generator=gen, device="cuda"))
    d = 12_268
    w = torch.randn((d, 10), generator=gen, device="cuda") * d ** -0.5
    bias = torch.zeros(10, device="cuda")
    y = torch.arange(3, device="cuda")
    loss, dl = tail.tail_forward(x, w, bias, y, pool)
    ref_loss, ref_dl = tail.tail_forward_plain(x, w, bias, y, pool)
    torch.cuda.synchronize()
    _close(loss, ref_loss, 1e-5)
    _close(dl, ref_dl, 1e-5)
    big = torch.zeros((1, 1, 1, d + 3), device="cuda")
    before = tail.launches.count
    with pytest.raises(ValueError, match="48 KB"):
        tail.tail_forward(big, torch.zeros((d + 3, 10), device="cuda"), bias, y[:1], "none")
    assert tail.launches.count == before


def _zoo_step_models(dev):
    """ResNet-18 on the kernels and on library convs, the same weights."""
    kern = resnet.resnet18(10, backend="cuda",
                           generator=torch.Generator().manual_seed(0)).to(dev)
    plain = resnet.resnet18(10, backend="torch",
                            generator=torch.Generator().manual_seed(0)).to(dev)
    return kern, plain


def test_resnet18_kernel_steps_match_plain_steps_on_card(card):
    """3 steps from one state: f32 sums in other orders, through batch-stat
    BN. At init the net amplifies such differences step by step, so the
    check runs at a gentle LR (f32 against f64 on the CPU at this LR and
    batch: 9e-6 in the loss, 2e-5 in the state after 3 steps)."""
    imgs, labels = synthetic.make_image_dataset(192, seed=3)
    x = torch.from_numpy(imgs).to(card)
    y = torch.from_numpy(labels).to(card, torch.int64)
    opt = zoo.make_optimizer(0.001)
    kern, plain = _zoo_step_models(card)
    sk, sp = zoo.init_state(kern, opt), zoo.init_state(plain, opt)
    f32 = FusedStepConfig(update=False, act_dtype="float32")
    step_k = zoo.make_train_step(kern, opt, fused=f32)
    step_p = zoo.make_train_step(plain, opt)
    counts = (tap_conv.launches.count, tap_conv.dgrad_launches.count,
              tap_wgrad.launches.count, tail.launches.count)
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        for i in range(3):
            sl = slice(64 * i, 64 * (i + 1))
            lk = step_k(sk, x[sl], y[sl])
            lp = step_p(sp, x[sl], y[sl])
            assert abs(float(lk) - float(lp)) <= 1e-4
    finally:
        torch.backends.cudnn.enabled = prev
    after = (tap_conv.launches.count, tap_conv.dgrad_launches.count,
             tap_wgrad.launches.count, tail.launches.count)
    assert [a - c for a, c in zip(after, counts)] == [60, 57, 60, 3]
    for (name, a), (_, b) in zip(kern.state_dict().items(),
                                 plain.state_dict().items()):
        assert float((a - b).abs().max()) <= 5e-4, name


def test_zoo_train_is_deterministic_on_card(card, tmp_path):
    imgs, labels = synthetic.make_image_dataset(64, seed=4)
    runs = []
    for _ in range(2):
        model = resnet.resnet18(10, backend="cuda",
                                generator=torch.Generator().manual_seed(1))
        state, losses = zoo.train(model, imgs, labels, epochs=1, batch_size=16,
                                  verbose=False, device=card)
        runs.append((losses, zoo.ZooState.snapshot(state)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


# ---------------------------------------------------------------------------
# The staged LeNet-ref library (csrc/lenet_staged.cu, B3–B9)
# ---------------------------------------------------------------------------

STAGED_CASES = ("conv_fwd", "pool_fwd", "fc_fwd", "fc_bwd", "pool_bwd", "sigma_prime",
                "accum_matmul/pool_wgrad", "accum_matmul/conv_wgrad")


def _as_tuple(r):
    return r if isinstance(r, tuple) else (r,)


@pytest.mark.parametrize("case", STAGED_CASES)
@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_staged_kernel_matches_plain_on_card(card, n, case):
    """Each kernel at the inputs the staged path gives it, against its
    plain twin (f32, TF32 off; sums in other orders, relative to the
    output's scale), and a relaunch bit for bit (no float atomics)."""
    params, xs, ys = _lenet_inputs(card, n, n + 11)
    fn, plain, args = stage_cases(params, xs, ys)[case]
    counter = lenet_staged.launches[case.split("/")[0]]
    before = counter.count
    got, again = _as_tuple(fn(*args)), _as_tuple(fn(*args))
    torch.cuda.synchronize()
    assert counter.count == before + 2
    for g, a, w in zip(got, again, _as_tuple(plain(*args))):
        assert torch.equal(g, a)
        _close(g, w, LENET_RTOL)


# fmaf(a, b, c) on f32 numpy arrays, rounded once (B6's dout order and B9's).
_fma_f32 = lenet_staged.fma_f32


def _card_view(a: np.ndarray, dev, view: str) -> torch.Tensor:
    """``a`` on the card: a tensor of its own ("whole", 16-byte aligned) or
    a contiguous view one value into a larger buffer ("offset", off the
    16-byte boundary)."""
    t = torch.from_numpy(a).to(dev)
    if view == "whole":
        return t
    flat = torch.zeros(a.size + 1, dtype=t.dtype, device=dev)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(a.shape)


@pytest.mark.parametrize("view", ["whole", "offset"])
@pytest.mark.parametrize("n", [1, 2, 37, 64, 1000])
def test_fc_bwd_matches_plain_and_fma_order_on_card(card, n, view):
    """B6 against its plain twin (gw and gb summed in shards and a tree:
    LENET_RTOL of the output's scale), a relaunch bit for bit, and dout
    bit for bit against the 10 fmas in o order from 0. "offset" views of
    d, s and w start one value in, off the 16-byte boundary, so the kernel
    stages them with 4-byte copies."""
    rng = np.random.default_rng(n)
    d = rng.standard_normal((n, 10)).astype(np.float32)
    s = rng.uniform(0, 1, (n, 216)).astype(np.float32)
    w = (rng.standard_normal((10, 216)) * 0.1).astype(np.float32)
    args = [_card_view(a, card, view) for a in (d, s, w)]
    if view == "offset":
        assert all(a.data_ptr() % 16 for a in args)
    before = lenet_staged.launches["fc_bwd"].count
    got, again = lenet_staged.fc_bwd(*args), lenet_staged.fc_bwd(*args)
    torch.cuda.synchronize()
    assert lenet_staged.launches["fc_bwd"].count == before + 2
    for g, a, want in zip(got, again, lenet_staged.fc_bwd_plain(*args)):
        assert torch.equal(g, a)
        _close(g, want, LENET_RTOL)
    acc = np.zeros((n, 216), np.float32)
    for o in range(10):
        acc = _fma_f32(np.broadcast_to(d[:, o:o + 1], (n, 216)),
                       np.broadcast_to(w[o], (n, 216)), acc)
    np.testing.assert_array_equal(got[2].cpu().numpy(), acc)


# Batches of 1 and 2 (fewer images than a B5 block's warps), around a warp's
# 32 and the path's 64, 133 (a multiple of no block) and 1000.
FWD_SIZES = [1, 2, 7, 63, 64, 65, 133, 1000]


def _fwd_args(card, view, seed, x_shape, w_shape, b_shape, w_scale):
    """Seeded (x, w, b) on the host and as card views. Each view draws its
    own values, so what an aligned run leaves in shared memory never
    matches what an "offset" run must stage."""
    rng = np.random.default_rng([seed, int(view == "offset")])
    x = rng.uniform(0, 1, x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) * w_scale).astype(np.float32)
    b = np.asarray(rng.standard_normal(b_shape), np.float32)
    args = [_card_view(a, card, view) for a in (x, w, b)]
    if view == "offset":
        assert all(a.data_ptr() % 16 for a in args)
    return (x, w, b), args


def _twice(name, fn, args):
    """fn(*args) twice, synchronised: (first, second); two launches counted."""
    counter = lenet_staged.launches[name]
    before = counter.count
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert counter.count == before + 2
    return got, again


@pytest.mark.parametrize("view", ["whole", "offset"])
@pytest.mark.parametrize("n", FWD_SIZES)
def test_conv_fwd_is_bit_identical_to_plain_on_card(card, n, view):
    """B3 bit for bit against its plain twin (each output adds the bias,
    then the 25 taps in (i, j) order, each product and sum rounded on its
    own, whatever thread holds it) and a relaunch bit for bit. "offset"
    views of x, w and b start one value in, off the 16-byte boundary, so
    the kernel stages the image with 4-byte copies."""
    _, args = _fwd_args(card, view, n, (n, 28, 28), (6, 5, 5), (6,), 0.5)
    got, again = _twice("conv_fwd", lenet_staged.conv_fwd, args)
    for g, a, want in zip(got, again, lenet_staged.conv_fwd_plain(*args)):
        assert torch.equal(g, a)
        assert torch.equal(g, want)


@pytest.mark.parametrize("view", ["whole", "offset"])
@pytest.mark.parametrize("n", FWD_SIZES)
def test_fc_fwd_equals_its_fixed_order_on_card(card, n, view):
    """B5's pre_f bit for bit against fc_fwd_order (its lanes' fmas and the
    butterfly, emulated in numpy), out_f bit for bit σ of it, both within
    LENET_RTOL of the plain twin, and a relaunch bit for bit. "offset"
    views take the kernel's 4-byte loads."""
    host, args = _fwd_args(card, view, n + 1, (n, 216), (10, 216),
                           (10,), 0.1)
    got, again = _twice("fc_fwd", lenet_staged.fc_fwd, args)
    order = lenet_staged.fc_fwd_order(*host)
    np.testing.assert_array_equal(got[0].cpu().numpy(), order)
    assert torch.equal(got[1], torch.sigmoid(torch.from_numpy(order).to(card)))
    for g, a, want in zip(got, again, lenet_staged.fc_fwd_plain(*args)):
        assert torch.equal(g, a)
        _close(g, want, LENET_RTOL)


@pytest.mark.parametrize("view", ["whole", "offset"])
@pytest.mark.parametrize("n", FWD_SIZES)
def test_pool_fwd_is_bit_identical_to_plain_on_card(card, n, view):
    """B4 bit for bit against its plain twin (each output adds the bias,
    then the 16 taps in t order, each product and sum rounded on its own)
    and a relaunch bit for bit, at aligned views of xw, w and b and at
    "offset" views one value in, off the 16-byte boundary."""
    _, args = _fwd_args(card, view, n + 2, (n, 16, 216), (4, 4), (), 0.5)
    got, again = _twice("pool_fwd", lenet_staged.pool_fwd, args)
    for g, a, want in zip(got, again, lenet_staged.pool_fwd_plain(*args)):
        assert torch.equal(g, a)
        assert torch.equal(g, want)


@pytest.mark.parametrize("view", ["whole", "offset"])
@pytest.mark.parametrize("n", FWD_SIZES)
def test_pool_bwd_is_bit_identical_to_plain_on_card(card, n, view):
    """B7 bit for bit against its plain twin (dpre = d·s·(1−s) left to
    right from σ of the preact, each dxw row w[t]·dpre, whatever thread
    holds it) and a relaunch bit for bit; "offset" views of d_out, pre and
    w start one value in, so the kernel takes its 4-byte loads."""
    rng = np.random.default_rng([n + 3, int(view == "offset")])
    host = (rng.standard_normal((n, 216)).astype(np.float32),
            (rng.standard_normal((n, 216)) * 2).astype(np.float32),
            rng.standard_normal((4, 4)).astype(np.float32))
    args = [_card_view(a, card, view) for a in host]
    if view == "offset":
        assert all(a.data_ptr() % 16 for a in args)
    got, again = _twice("pool_bwd", lenet_staged.pool_bwd, args)
    for g, a, want in zip(got, again, lenet_staged.pool_bwd_plain(*args)):
        assert torch.equal(g, a)
        assert torch.equal(g, want)


@pytest.mark.parametrize("view", ["whole", "offset", "mixed"])
@pytest.mark.parametrize("n", FWD_SIZES)
def test_sigma_prime_is_bit_identical_to_plain_on_card(card, n, view):
    """B8 bit for bit against its plain twin (σ of the preact with IEEE
    expf and division, then d·s·(1−s) left to right, whatever thread holds
    it) and a relaunch bit for bit, with d and pre as tensors of their own
    ("whole"), as views one value in, off the 16-byte boundary, so the
    kernel takes its 4-byte loads ("offset"), and d whole with pre off it
    ("mixed"). Each view draws its own values."""
    rng = np.random.default_rng([n + 4, ("whole", "offset", "mixed").index(view)])
    host = (rng.standard_normal((n, 6, 24, 24)).astype(np.float32),
            (rng.standard_normal((n, 6, 24, 24)) * 3).astype(np.float32))
    views = {"whole": ("whole", "whole"), "offset": ("offset", "offset"),
             "mixed": ("whole", "offset")}[view]
    args = [_card_view(a, card, v) for a, v in zip(host, views)]
    assert [a.data_ptr() % 16 != 0 for a in args] == [v == "offset" for v in views]
    got, again = _twice("sigma_prime", lenet_staged.conv_bwd_dpre, args)
    assert torch.equal(got, again)
    assert torch.equal(got, lenet_staged.conv_bwd_dpre_plain(*args))


def test_sigma_prime_entry_refuses_a_misaligned_out_on_card(card):
    """B8's float4 stores: the C entry refuses an out off the 16-byte
    boundary (the wrapper always allocates an aligned one) or an empty
    batch and launches nothing; on an aligned out it writes its plain
    twin's values and nothing past them."""
    rng = np.random.default_rng(8)
    d, pre = (torch.from_numpy(rng.standard_normal((2, 6, 24, 24)).astype(np.float32)).to(card)
              for _ in range(2))
    lib = lenet_staged._lib()
    stream = launch_stream(card)
    buf = torch.full((2 * 3456 + 4,), float("nan"), device=card)
    assert lib.lenet_sigma_prime(d.data_ptr(), pre.data_ptr(), buf.data_ptr() + 4, 2,
                                 stream) == 1
    assert lib.lenet_sigma_prime(d.data_ptr(), pre.data_ptr(), buf.data_ptr(), 0,
                                 stream) == 1
    torch.cuda.synchronize()
    assert bool(buf.isnan().all())
    assert lib.lenet_sigma_prime(d.data_ptr(), pre.data_ptr(), buf.data_ptr(), 2,
                                 stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(buf[:2 * 3456].view(2, 6, 24, 24),
                       lenet_staged.conv_bwd_dpre_plain(d, pre))
    assert bool(buf[2 * 3456:].isnan().all())


def test_pool_bwd_entry_refuses_misaligned_outputs_on_card(card):
    """B7's vector stores: the C entry refuses a dpre or dxw off the
    16-byte boundary (the wrapper always allocates aligned ones) and
    launches nothing; on aligned outputs it writes its plain twin's."""
    params, xs, ys = _lenet_inputs(card, 2, 4)
    _, plain, args = stage_cases(params, xs, ys)["pool_bwd"]
    want = plain(*args)
    sizes = [w.numel() for w in want]
    lib = lenet_staged._lib()
    stream = launch_stream(card)
    buf = torch.full((sum(sizes) + 4,), float("nan"), device=card)
    dpre, dxw = buf[:sizes[0]], buf[sizes[0] + 4:]
    ptrs = [a.data_ptr() for a in args]
    for shifted in ((dpre.data_ptr() + 4, dxw.data_ptr()),
                    (dpre.data_ptr(), dxw.data_ptr() + 4)):
        assert lib.lenet_pool_bwd(*ptrs, *shifted, 2, stream) == 1
    torch.cuda.synchronize()
    assert bool(buf.isnan().all())
    assert lib.lenet_pool_bwd(*ptrs, dpre.data_ptr(), dxw.data_ptr(), 2, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(dpre.view(want[0].shape), want[0])
    assert torch.equal(dxw.view(want[1].shape), want[1])


def test_conv_fwd_entry_refuses_misaligned_outputs_on_card(card):
    """B3's float4 stores: the C entry refuses a pre or out off the 16-byte
    boundary (the wrapper always allocates aligned ones) and launches
    nothing."""
    _, (x, w, b) = _fwd_args(card, "whole", 3, (2, 28, 28), (6, 5, 5),
                             (6,), 0.5)
    lib = lenet_staged._lib()
    buf = torch.full((2 * 2 * 3456 + 1,), float("nan"), device=card)
    pre, out = buf[:2 * 3456], buf[2 * 3456:]
    stream = launch_stream(card)
    assert lib.lenet_conv_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), pre.data_ptr(),
                              out.data_ptr() + 4, 2, stream) == 1
    assert lib.lenet_conv_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), pre.data_ptr() + 4,
                              out.data_ptr(), 2, stream) == 1
    torch.cuda.synchronize()
    assert bool(buf.isnan().all())
    assert lib.lenet_conv_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), pre.data_ptr(),
                              buf[2 * 3456 + 4:].data_ptr(), 1, stream) == 0
    torch.cuda.synchronize()
    want = lenet_staged.conv_fwd_plain(x[:1], w, b)
    assert torch.equal(pre[:3456].view(1, 6, 24, 24), want[0])


def test_staged_path_launch_counts_and_anchor_on_card(card):
    """forward and predict are 3 launches, the grads 8; the grads agree
    with B1's within JAX's tolerances for the two tiers."""
    params, xs, ys = _lenet_inputs(card, 64, 5)
    for counter in lenet_staged.launches.values():
        counter.reset()
    lenet_staged.forward(params, xs)
    lenet_staged.predict(params, xs)
    err, grads = lenet_staged.staged_value_and_ref_grads(params, xs, ys)
    counts = {k: c.count for k, c in lenet_staged.launches.items()}
    assert counts == {"conv_fwd": 3, "pool_fwd": 3, "fc_fwd": 3, "fc_bwd": 1,
                      "pool_bwd": 1, "sigma_prime": 1, "accum_matmul": 2}
    ref_err, ref = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
    assert abs(float(err) - float(ref_err)) <= 1e-6
    for g, r in zip(tree_leaves(grads), tree_leaves(ref)):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=1e-5, rtol=1e-5)


def _accum_ticket_is_zero(dev) -> bool:
    return int(lenet_staged._ticket(dev, launch_stream(dev)).item()) == 0


def _accum_checks(a, b):
    """B9 on (a, b): a relaunch bit for bit, bit for bit its fixed order
    (lenet_staged.accum_matmul_order), within LENET_RTOL of the plain twin,
    two launches counted, and the ticket left at 0."""
    counter = lenet_staged.launches["accum_matmul"]
    before = counter.count
    got, again = lenet_staged._accum_matmul(a, b), lenet_staged._accum_matmul(a, b)
    torch.cuda.synchronize()
    assert counter.count == before + 2
    assert torch.equal(got, again)
    order = lenet_staged.accum_matmul_order(a.cpu().numpy(), b.cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), order)
    _close(got, lenet_staged._accum_matmul_plain(a, b), LENET_RTOL)
    assert _accum_ticket_is_zero(a.device)


@pytest.mark.parametrize("n", STAGED_SIZES)
@pytest.mark.parametrize("site", B9_SITES)
def test_accum_matmul_site_equals_its_fixed_order_on_card(card, site, n):
    """B9 at each call site's inputs (chip_smoke.stage_cases) at every
    STAGED_SIZES batch."""
    params, xs, ys = _lenet_inputs(card, n, n + 11)
    _, _, (a, b) = stage_cases(params, xs, ys)[f"accum_matmul/{site}"]
    _accum_checks(a, b)


# One row at each site's width, a row count no block or stage divides, and
# outputs at the limits: ka*kb 256, ka + kb 48, 14 tiles (448 threads).
ACCUM_CARD_SHAPES = [(1, 6, 25), (1, 16, 1), (36_864 + 37, 6, 25), (5003, 16, 16),
                     (3001, 1, 47), (2999, 47, 1), (777, 9, 28)]


@pytest.mark.parametrize("view", ["whole", "offset"])
@pytest.mark.parametrize("rows,ka,kb", ACCUM_CARD_SHAPES)
def test_accum_matmul_matches_plain_and_order_on_card(card, rows, ka, kb, view):
    """B9 on seeded normals; "offset" views start one value into a larger
    buffer, off the 16-byte boundary, so the kernel stages with 4-byte
    copies (the order, and so the result, is the same)."""
    rng = np.random.default_rng(rows + 31 * ka + kb)
    a = _card_view(rng.standard_normal((rows, ka)).astype(np.float32), card, view)
    b = _card_view(rng.standard_normal((rows, kb)).astype(np.float32), card, view)
    _accum_checks(a, b)


def test_accum_plan_is_the_librarys_on_card(card):
    """ops/lenet_staged.accum_plan (which sizes the partials and orders the
    emulation) against the C entry's own plan, and the C plan's refusals."""
    import ctypes

    lib = lenet_staged._lib()
    out = (ctypes.c_int * 4)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    shapes = [(r, ka, kb) for r in (1, 31, 32, 33, 131, 4224, 4225, 36_864, 576_000,
                                    2**31 - 1)
              for ka, kb in ((6, 25), (16, 1), (16, 16), (1, 47), (9, 28), (47, 1))]
    for rows, ka, kb in shapes:
        assert lib.lenet_accum_plan(rows, ka, kb, ptr) == 0
        assert tuple(out) == tuple(lenet_staged.accum_plan(rows, ka, kb)), (rows, ka, kb)
    for bad in ((0, 6, 25), (2**31, 1, 1), (10, 17, 16), (10, 1, 48), (10, 0, 5)):
        assert lib.lenet_accum_plan(*bad, ptr) == 1, bad


@pytest.mark.parametrize(
    "case,mutate,err",
    [
        ("conv_fwd", lambda x, w, b: (x.double(), w, b), TypeError),
        ("conv_fwd", lambda x, w, b: (x, w.cpu(), b), ValueError),
        ("pool_fwd", lambda xw, w, b: (xw[:, :, :215], w, b), ValueError),
        ("fc_fwd", lambda x, w, b: (x, w[:, :200], b), ValueError),
        ("fc_bwd", lambda d, s, w: (d, s.T.contiguous().T, w), ValueError),
        ("pool_bwd", lambda d, p, w: (d, p, w.reshape(16)), ValueError),
        ("sigma_prime", lambda d, p: (d, p.double()), TypeError),
        ("accum_matmul/conv_wgrad", lambda a, b: (a, b[:-1]), ValueError),
        ("accum_matmul/conv_wgrad", lambda a, b: (a.repeat(1, 2), b), RuntimeError),
        ("conv_fwd", lambda x, w, b: (x[:0], w, b), RuntimeError),
    ],
    ids=["conv-float64", "conv-weights-on-cpu", "pool-shape", "fc-weight-shape",
         "fc_bwd-non-contiguous", "pool_bwd-weight-shape", "sigma-float64",
         "accum-rows", "accum-too-many-outputs", "conv-empty-batch"],
)
def test_staged_wrappers_raise_instead_of_falling_back(card, case, mutate, err):
    params, xs, ys = _lenet_inputs(card, 4, 0)
    fn, _, args = stage_cases(params, xs, ys)[case]
    counter = lenet_staged.launches[case.split("/")[0]]
    before = counter.count
    with pytest.raises(err):
        fn(*mutate(*args))
    assert counter.count == before


# ---------------------------------------------------------------------------
# The Mosaic probes (csrc/mosaic_probe.cu, B14–B21)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("odd", [False, True], ids=["probe-shape", "odd-shape"])
@pytest.mark.parametrize("name", mosaic_probe.KERNELS)
def test_probe_kernel_matches_plain_on_card(card, name, odd):
    """Each probe kernel on seeded normals against its plain twin: the
    copies and B18 bit for bit, the products within PROBE_RTOL of the
    output's scale; a relaunch bit for bit. The odd shapes leave a tail in
    every grid dimension (chip_smoke.probe_operands)."""
    gen = torch.Generator(device="cuda").manual_seed(60 + odd)
    args = probe_operands(name, odd, card_draw(gen))
    fn, plain = probe_kernel(name)
    counter = mosaic_probe.launches[name]
    before = counter.count
    got, again = fn(*args), fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert counter.count == before + 2
    assert torch.equal(got, again)
    if name in PROBE_EXACT:
        assert torch.equal(got, want)
    else:
        _close(got, want, PROBE_RTOL)


def test_probe_entry_point_launches_each_kernel_11_times_on_card(card, capsys):
    for counter in mosaic_probe.launches.values():
        counter.reset()
    assert probe_bench.main([]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split("]")[0][1:] for line in lines] == [n for n, _ in probe_bench.PROBES]
    assert all(" RAN cuda" in line for line in lines)
    assert {k: c.count for k, c in mosaic_probe.launches.items()} == {
        name: PROBE_LAUNCHES for name in mosaic_probe.KERNELS}


@pytest.mark.parametrize(
    "name,mutate,err",
    [
        ("rank3_dot", lambda a, b: (a, b.cpu()), ValueError),
        ("lane_merge", lambda x: (x.transpose(1, 2),), ValueError),
        ("lane_split", lambda x, rows: (x.double(), rows), TypeError),
        ("mxu_conv_L", lambda w, x: (w.cpu(), x), ValueError),
        ("vpu_conv", lambda w, x: (w, x.float()), TypeError),
        ("mxu_conv_3d", lambda w, x: (w, x[:24]), ValueError),
        ("pair_dot", lambda x, w: (x, w.T.contiguous().T), ValueError),
        ("two_dot", lambda x, w: (x.cpu(), w), ValueError),
    ],
    ids=["rank3-b-on-cpu", "merge-non-contiguous", "split-float64", "L-w-on-cpu",
         "vpu-x-float32", "3d-24-taps", "pair-w-non-contiguous", "two-x-on-cpu"],
)
def test_probe_wrappers_raise_instead_of_falling_back(card, name, mutate, err):
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = probe_operands(name, True, card_draw(gen))
    counter = mosaic_probe.launches[name]
    before = counter.count
    with pytest.raises(err):
        getattr(mosaic_probe, name)(*mutate(*args))
    assert counter.count == before


# The contraction of B17/B19 and B18 (csrc/mosaic_probe.cu
# conv_contract_kernel): lengths around its columns a thread (1, 7, 8), the
# odd probe shape (1003), 4032 and the probes' 73,728; x whole, one bf16
# value past a 16-byte boundary (the narrow body) and 4 values past it (8
# bytes: the wide body at 2 or 4 columns a thread, the narrow one at 8).
CONTRACT_LENGTHS = (1, 7, 8, 1003, 4032, 73_728)
CONTRACT_VIEWS = {"whole": 0, "offset1": 1, "offset4": 4}


@pytest.mark.parametrize("view", CONTRACT_VIEWS)
@pytest.mark.parametrize("length", CONTRACT_LENGTHS)
@pytest.mark.parametrize("name", ["mxu_conv_L", "mxu_conv_3d", "vpu_conv"])
def test_probe_contract_lengths_and_views_on_card(card, name, length, view):
    """The three entry points against the plain twin (B17/B19 within
    PROBE_RTOL of the output's scale, B18 bit for bit), a relaunch bit for
    bit, one launch a call; through the C entry into a NaN-filled buffer,
    exactly the 6 × length outputs are written, equal to the wrapper's."""
    gen = torch.Generator(device="cuda").manual_seed(length + 10 * CONTRACT_VIEWS[view])
    w = torch.randn((6, 25), generator=gen, device="cuda")
    flat = torch.randn((25, length), generator=gen, device="cuda").bfloat16()
    if CONTRACT_VIEWS[view]:
        flat = _offset_view(flat, CONTRACT_VIEWS[view])
    x = flat if name == "mxu_conv_L" else flat.view(25, 1, length)
    fn, plain = probe_kernel(name)
    counter = mosaic_probe.launches[name]
    before = counter.count
    got, again = fn(w, x), fn(w, x)
    want = plain(w, x)
    torch.cuda.synchronize()
    assert counter.count == before + 2
    assert torch.equal(got, again)
    if name in PROBE_EXACT:
        assert torch.equal(got, want)
    else:
        _close(got, want, PROBE_RTOL)
    out = torch.full((6 * length + 4,), float("nan"), device="cuda")
    entry = getattr(mosaic_probe.build().get(), f"probe_{name}")
    assert entry(w.data_ptr(), x.data_ptr(), out.data_ptr(), length, launch_stream(card)) == 0
    torch.cuda.synchronize()
    assert torch.equal(out[:6 * length].view(got.shape), got)
    assert bool(torch.isnan(out[6 * length:]).all())


# B14 (csrc/mosaic_probe.cu batched_matmul_kernel): depths around its 4-wide
# reads and 128-deep chunk (1, 15-17, 127-129, 300: one, two and three
# chunks, ragged), rows and columns around its tiles (1, 63, 64, 65), and
# batches of 1, 4 and 200; odd k or n take the 4-byte copies.
RANK3_DEPTHS = (1, 15, 16, 17, 127, 128, 129, 300)
RANK3_SIDES = (1, 63, 64, 65)


@pytest.mark.parametrize("n", [1, 4, 200])
@pytest.mark.parametrize("k", RANK3_DEPTHS)
def test_probe_rank3_dot_shapes_on_card(card, k, n):
    """At every (m, p) of RANK3_SIDES: the wrapper within PROBE_RTOL of the
    plain twin's scale, a relaunch bit for bit, one launch a call; through
    the C entry into a NaN-filled buffer with room past the end, exactly the
    n·m·p outputs are written, equal to the wrapper's."""
    gen = torch.Generator(device="cuda").manual_seed(1000 * n + k)
    counter = mosaic_probe.launches["rank3_dot"]
    entry = mosaic_probe.build().get().probe_rank3_dot
    for m in RANK3_SIDES:
        for p in RANK3_SIDES:
            a = torch.randn((n, m, k), generator=gen, device="cuda")
            b = torch.randn((n, k, p), generator=gen, device="cuda")
            before = counter.count
            got, again = mosaic_probe.rank3_dot(a, b), mosaic_probe.rank3_dot(a, b)
            want = mosaic_probe.rank3_dot_plain(a, b)
            torch.cuda.synchronize()
            assert counter.count == before + 2
            assert torch.equal(got, again), (m, p)
            _close(got, want, PROBE_RTOL)
            out = torch.full((n * m * p + 64 * (p + 1),), float("nan"), device="cuda")
            assert entry(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, k, p,
                         launch_stream(card)) == 0
            torch.cuda.synchronize()
            assert torch.equal(out[:n * m * p].view(n, m, p), got), (m, p)
            assert bool(torch.isnan(out[n * m * p:]).all()), (m, p)


def test_probe_rank3_dot_takes_a_batch_past_65535_on_card(card):
    """The grid is one dimension, so a batch past grid.z's 65,535 runs:
    every entry's product equals the plain twin's (k = 1: one product)."""
    gen = torch.Generator(device="cuda").manual_seed(65_537)
    a = torch.randn((65_537, 3, 1), generator=gen, device="cuda")
    b = torch.randn((65_537, 1, 5), generator=gen, device="cuda")
    assert torch.equal(mosaic_probe.rank3_dot(a, b), mosaic_probe.rank3_dot_plain(a, b))


@pytest.mark.parametrize("operand", [0, 1], ids=["a", "b"])
def test_probe_rank3_dot_reads_views_off_the_16_byte_boundary_on_card(card, operand):
    """An operand one value past a 16-byte boundary (the 4-byte copies)
    gives the aligned operand's result bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(7 + operand)
    args = list(probe_operands("rank3_dot", False, card_draw(gen)))
    want = mosaic_probe.rank3_dot(*args)
    args[operand] = _offset_view(args[operand])
    assert torch.equal(mosaic_probe.rank3_dot(*args), want)


# B15/B16's copy (csrc/mosaic_probe.cu copy_kernel): lengths around its
# 16-byte body (1, 3, 5 are head and tail alone) and the probes' two sizes,
# on views 0-3 floats past a 16-byte boundary for the source and for the
# destination (equal offsets take the float4 body after a scalar head;
# unequal ones the 4-byte copy).
COPY_SIZES = (1, 3, 5, 73_728, 1_843_200)
COPY_OFFSETS = [(0, 0), (1, 1), (2, 2), (3, 3), (1, 0), (0, 3), (2, 1)]


@pytest.mark.parametrize("src_off,dst_off", COPY_OFFSETS)
@pytest.mark.parametrize("n", COPY_SIZES)
def test_probe_copy_is_bit_identical_at_any_offset_on_card(card, n, src_off, dst_off):
    """Both copy entries write exactly x's n values into [dst_off,
    dst_off + n) of a NaN-filled buffer and nothing around them, bit for
    bit, on relaunch too; through the wrapper (a fresh, aligned output) the
    result equals the plain twin and counts one launch a call."""
    gen = torch.Generator(device="cuda").manual_seed(n + 4 * src_off + dst_off)
    buf = torch.randn((n + 4,), generator=gen, device="cuda")
    x = buf[src_off:src_off + n]
    lib = mosaic_probe.build().get()
    for entry in (lib.probe_lane_merge, lib.probe_lane_split):
        for _ in range(2):
            out = torch.full((n + 4,), float("nan"), device="cuda")
            assert entry(x.data_ptr(), out[dst_off:].data_ptr(), n, launch_stream(card)) == 0
            torch.cuda.synchronize()
            assert torch.equal(out[dst_off:dst_off + n], x)
            assert bool(torch.isnan(out[:dst_off]).all())
            assert bool(torch.isnan(out[dst_off + n:]).all())
    before = mosaic_probe.launches["lane_merge"].count
    merged = mosaic_probe.lane_merge(x.view(1, 1, n))
    assert torch.equal(merged, mosaic_probe.lane_merge_plain(x.view(1, 1, n)))
    assert mosaic_probe.launches["lane_merge"].count == before + 1
    split = mosaic_probe.lane_split(x.view(1, n), 1)
    assert torch.equal(split, mosaic_probe.lane_split_plain(x.view(1, n), 1))


# B20/B21 on the tensor cores (csrc/mosaic_probe.cu through csrc/wgmma_tile.cuh):
# row counts around the 64-row warpgroup tile and past one wave (10,000 rows
# are 157 tiles on 132 SMs).


@pytest.mark.parametrize("rows", DOT_ROWS)
@pytest.mark.parametrize("name", DOT_KERNELS)
def test_probe_dot_ragged_rows_on_card(card, name, rows):
    """Seeded normals against the plain twin within PROBE_RTOL, a relaunch
    bit for bit, one launch a call."""
    gen = torch.Generator(device="cuda").manual_seed(80 + rows)
    args = probe_operands(name, False, card_draw(gen), rows=rows)
    fn, plain = probe_kernel(name)
    counter = mosaic_probe.launches[name]
    before = counter.count
    got, again = fn(*args), fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert counter.count == before + 2
    assert got.shape == (rows, mosaic_probe.PAIR_N)
    assert torch.equal(got, again)
    _close(got, want, PROBE_RTOL)


@pytest.mark.parametrize("rows", [1, 37, 63])
@pytest.mark.parametrize("name", DOT_KERNELS)
def test_probe_dot_store_is_masked_on_card(card, name, rows):
    """The C entry point writes rows [0, rows) of the output and nothing of
    the ragged tile's other rows: a 64-row NaN-filled buffer keeps them."""
    gen = torch.Generator(device="cuda").manual_seed(90 + rows)
    x, w = probe_operands(name, False, card_draw(gen), rows=rows)
    out = torch.full((64, mosaic_probe.PAIR_N), float("nan"), device="cuda")
    entry = getattr(mosaic_probe.build().get(), f"probe_{name}")
    assert entry(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, launch_stream(card)) == 0
    torch.cuda.synchronize()
    _close(out[:rows], probe_kernel(name)[1](x, w), PROBE_RTOL)
    assert bool(torch.isnan(out[rows:]).all())


def _offset_view(t, elements=1):
    """A contiguous copy of t that starts ``elements`` past an aligned base."""
    buf = torch.empty(t.numel() + elements, dtype=t.dtype, device=t.device)
    view = buf[elements:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("operand", [0, 1], ids=["x", "w"])
@pytest.mark.parametrize("name", DOT_KERNELS)
def test_probe_dot_refuses_misaligned_view_on_card(card, name, operand):
    """TMA needs 16-byte aligned bases: a view one element off raises
    ValueError before any launch, and is never copied."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = list(probe_operands(name, True, card_draw(gen)))
    args[operand] = _offset_view(args[operand])
    counter = mosaic_probe.launches[name]
    before = counter.count
    with pytest.raises(ValueError, match="16-byte"):
        getattr(mosaic_probe, name)(*args)
    assert counter.count == before


# ---------------------------------------------------------------------------
# ResNet-50 and VGG-16: B10/B11/B12 at their shapes; the native ring
# ---------------------------------------------------------------------------


def _geometry_id(g):
    return g[0].replace(" ", "_")


@pytest.mark.parametrize("geometry", R50_GEOMETRIES + [STEM224] + VGG_GEOMETRIES,
                         ids=[f"zoo50-{_geometry_id(g)}" for g in R50_GEOMETRIES + [STEM224]]
                         + [f"vgg-{_geometry_id(g)}" for g in VGG_GEOMETRIES])
def test_zoo50_and_vgg_convs_match_plain_on_card(card, geometry):
    """Every distinct conv of ResNet-50 (CIFAR stem, 1x1s up to 2,048
    channels, 3x3/s2 mids, 1x1/s2 projections), the ImageNet stem at 224²
    and VGG-16's convs: the forward with the geometry's eval epilogue (bare
    for VGG), the dgrad (not the stem's: its input needs no gradient) and
    the wgrad against their plain twins at b4 (b2 at 224²); relaunches bit
    for bit."""
    name, h, cin, cout, k, s, residual, relu, _ = geometry
    b = 2 if h == 224 else 4
    x, wt, scale, shift, res = _inputs(card, b, h, h, cin, cout, k, s, residual, h + cin)
    g = torch.randn(tap_conv.out_shape(x.shape, wt.shape, s), device=card,
                    generator=torch.Generator(device="cuda").manual_seed(cout))
    if geometry in VGG_GEOMETRIES:
        with torch.no_grad():
            got, again = tap_conv.conv2d(x, wt, s), tap_conv.conv2d(x, wt, s)
        want = tap_conv.conv2d_plain(x, wt, s)
    else:
        got = tap_conv.conv2d_fused(x, wt, scale, shift, res, s, relu)
        again = tap_conv.conv2d_fused(x, wt, scale, shift, res, s, relu)
        want = tap_conv.conv2d_fused_plain(x, wt, scale, shift, res, s, relu)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _close(got, want, ATOL)
    if not name.startswith("stem"):
        dx = tap_conv.conv2d_dgrad(g, wt, x.shape, s)
        assert torch.equal(dx, tap_conv.conv2d_dgrad(g, wt, x.shape, s))
        _close(dx, tap_conv.conv2d_dgrad_plain(g, wt, x.shape, s))
    gw = tap_wgrad.conv2d_wgrad(x, g, k, s)
    assert torch.equal(gw, tap_wgrad.conv2d_wgrad(x, g, k, s))
    _close(gw, tap_wgrad.conv2d_wgrad_plain(x, g, k, s))


@pytest.mark.parametrize("shape,classes", [((2, 7, 7, 2048), 1000), ((3, 4, 4, 2048), 10),
                                           ((4, 1, 1, 512), 10)],
                         ids=["zoo50-imagenet-7x7x2048-1000", "zoo50-cifar-4x4x2048-10",
                              "vgg-1x1x512-10"])
def test_zoo50_and_vgg_gap_tails_match_plain_on_card(card, shape, classes):
    """B12's gap mode at ResNet-50's heads (ImageNet and CIFAR) and VGG-16's
    CIFAR head."""
    gen = torch.Generator(device="cuda").manual_seed(classes)
    x = torch.relu(torch.randn(shape, generator=gen, device="cuda"))
    w = torch.randn((shape[-1], classes), generator=gen, device="cuda") * shape[-1] ** -0.5
    b = 0.1 * torch.randn((classes,), generator=gen, device="cuda")
    y = torch.randint(0, classes, (shape[0],), generator=gen, device="cuda")
    before = tail.launches.count
    loss, dl = tail.tail_forward(x, w, b, y, "gap")
    torch.cuda.synchronize()
    assert tail.launches.count == before + 1
    ref_loss, ref_dl = tail.tail_forward_plain(x, w, b, y, "gap")
    _close(loss, ref_loss, ATOL)
    _close(dl, ref_dl, ATOL)


@pytest.mark.parametrize("name", ["resnet50", "vgg16"], ids=["zoo50-resnet50", "vgg-vgg16"])
def test_zoo50_and_vgg_serve_buckets_are_bit_identical_on_card(card, name):
    """The serving forward of ResNet-50 and VGG-16: n = 3 requests through the
    padded b4 bucket equal the b4 forward bit for bit, and every conv runs
    through the kernel."""
    from parallel_cnn_tpu_torch.cli import padded_bucket_parity

    handle = get(name)
    pool, batcher = serve_stack(handle, ServeConfig(max_batch=4, precompile=False),
                                device="cuda", seed=0)
    tap_conv.launches.reset()
    with batcher:
        line = padded_bucket_parity(pool.engines[0], handle.in_shape, seed=3)
    assert line.endswith("bit-identical"), line
    convs = 53 if name == "resnet50" else 13
    assert tap_conv.launches.count == 2 * convs


def test_native_ring_feeds_the_card_as_its_twin(card):
    """The native ring's batches copied to the card (a pageable copy a
    batch) equal the twin's order gathered there."""
    from parallel_cnn_tpu_torch.data import native

    images, labels = synthetic.make_image_dataset(100, seed=6)
    with native.Batcher(images, labels, 16, seed=3) as ring:
        got = list(pipeline.device_batches(
            (next(ring) for _ in range(6)), card, torch.int64))
    twin = pipeline.native_semantics_batches(pipeline.Dataset(images, labels), 16,
                                             shuffle=True, seed=3)
    for (x, y), (tx, ty) in zip(got, twin):
        assert x.device.type == "cuda" and y.dtype == torch.int64
        assert np.array_equal(x.cpu().numpy(), tx) and np.array_equal(y.cpu().numpy(), ty)


def test_native_prefetch_lenet_equals_the_twin_on_card(card, monkeypatch):
    """--prefetch native and the twin (no compiler, so the ring cannot be
    built): the same LeNet-ref params on the card, bit for bit, one
    lenet_fused launch a step each."""
    from parallel_cnn_tpu_torch.data import native

    ds = pipeline.Dataset(*synthetic.make_dataset(1024, seed=2))
    cfg = Config(train=TrainConfig(batch_size=64, ops="cuda", shuffle=True, epochs=2))
    before = lenet_fused.launches.count
    ring = trainer.learn(cfg.replace(train=dataclasses.replace(cfg.train, prefetch="native")),
                         ds, verbose=False, device="cuda")
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    assert not native.available()
    twin = trainer.learn(cfg, ds, verbose=False, device="cuda")
    assert lenet_fused.launches.count - before == 2 * 2 * (1024 // 64)
    for a, b in zip(tree_leaves(ring.params), tree_leaves(twin.params)):
        assert torch.equal(a, b)



# ---------------------------------------------------------------------------
# The bf16 forms of B10 (forward, dgrad), B11 and B12 (JAX's bf16 activations)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
# A bf16 form against its twin (the f32 function of the same bf16 operands,
# rounded once): one bf16 ulp of the output's scale.
BF16_RTOL = 2.0 ** -7


def _bf16_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    tol = BF16_RTOL * max(1.0, float(want.float().abs().max()))
    assert float((got.float() - want.float()).abs().max()) <= tol


def _bf16_counts():
    """bf16 launches of each kernel, its forms together: forward, dgrad and
    wgrad (FFMA and tensor-core each), tail."""
    return (tap_conv.bf16_launches.count + tap_conv.wgmma_launches.count,
            tap_conv.bf16_dgrad_launches.count + tap_conv.wgmma_dgrad_launches.count,
            tap_wgrad.bf16_launches.count + tap_wgrad.wgmma_launches.count,
            tail.bf16_launches.count)


def _wgmma_counts():
    """Launches of the tensor-core forms: forward, dgrad, wgrad."""
    return (tap_conv.wgmma_launches.count, tap_conv.wgmma_dgrad_launches.count,
            tap_wgrad.wgmma_launches.count)


def _f32_counts():
    return (tap_conv.launches.count, tap_conv.dgrad_launches.count,
            tap_wgrad.launches.count, tail.launches.count)


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", FORWARD_CASES)
def test_bf16_conv_forms_match_their_twins_on_card(card, b, h, w, cin, cout, k, s):
    """Forward, dgrad and wgrad in bf16 at every geometry of the f32 forms'
    tests (Cin 3 and 20, Cout 10: the one-value copies; odd sizes at
    stride 2; k 1 to 7), each relaunch bit-identical, counted on the bf16
    counters alone."""
    x, wt, g = (t.to(BF16) for t in _grad_inputs(card, b, h, w, cin, cout, k, s, b + k))
    bf0, f0 = _bf16_counts(), _f32_counts()
    runs = [(lambda: tap_conv.conv2d(x, wt, s),
             lambda: tap_conv.bf16_twin(tap_conv.conv2d_plain, x, wt, stride=s)),
            (lambda: tap_conv.conv2d_dgrad(g, wt, x.shape, s),
             lambda: tap_conv.bf16_twin(tap_conv.conv2d_dgrad_plain, g, wt,
                                        x_shape=x.shape, stride=s)),
            (lambda: tap_wgrad.conv2d_wgrad(x, g, k, s),
             lambda: tap_conv.bf16_twin(tap_wgrad.conv2d_wgrad_plain, x, g, k=k, stride=s))]
    for fn, twin in runs:
        got, again = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _bf16_close(got, twin())
    assert _f32_counts() == f0
    assert tuple(n - m for n, m in zip(_bf16_counts(), bf0)) == (2, 2, 2, 0)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_bf16_forward_is_batch_position_invariant_on_card(card, geometry):
    """The bf16 forward's rows, like the f32 form's, do not depend on the
    batch around them: the tile follows the batch, the sum order does not."""
    _, h, cin, cout, k, s, _, _, _ = geometry
    x, wt = (t.to(BF16) for t in _inputs(card, 64, h, h, cin, cout, k, s, False, h + cin)[:2])
    full = tap_conv.conv2d(x, wt, s)
    for b, row in [(b, b - 1) for b in BUCKETS] + [(64, 37)]:
        assert torch.equal(tap_conv.conv2d(x[row:row + 1], wt, s), full[row:row + 1]), row
        assert torch.equal(tap_conv.conv2d(x[:b], wt, s), full[:b]), b


def test_bf16_conv_forms_read_views_off_the_boundary_on_card(card):
    """Operands one value past a 16-byte boundary agree with the aligned
    launch bit for bit: the tensor-core forms (all three at this shape)
    read an aligned copy, as TMA reads from 16-byte bases only; the FFMA
    dgrad (its yardstick entry) takes the one-value loads and stores."""
    x, wt, g = (t.to(BF16) for t in _grad_inputs(card, 4, 8, 8, 64, 64, 3, 1, 5))

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    assert torch.equal(tap_conv.conv2d(off(x), off(wt), 1), tap_conv.conv2d(x, wt, 1))
    assert torch.equal(tap_conv.conv2d_dgrad(off(g), off(wt), x.shape, 1),
                       tap_conv.conv2d_dgrad(g, wt, x.shape, 1))
    assert torch.equal(tap_conv.conv2d_dgrad_bf16_ffma(off(g), off(wt), x.shape, 1),
                       tap_conv.conv2d_dgrad_bf16_ffma(g, wt, x.shape, 1))
    assert torch.equal(tap_wgrad.conv2d_wgrad(off(x), off(g), 3, 1),
                       tap_wgrad.conv2d_wgrad(x, g, 3, 1))


def test_bf16_conv_autograd_runs_the_bf16_kernels_on_card(card):
    x, wt, g = (t.to(BF16) for t in _grad_inputs(card, 4, 8, 8, 16, 32, 3, 2, 9))
    x.requires_grad_(True)
    wt.requires_grad_(True)
    bf0 = _bf16_counts()
    y = tap_conv.conv2d(x, wt, 2)
    dx, dw = torch.autograd.grad(y, (x, wt), g)
    assert y.dtype == dx.dtype == dw.dtype == BF16
    assert tuple(n - m for n, m in zip(_bf16_counts(), bf0)) == (1, 1, 1, 0)
    assert torch.equal(dx, tap_conv.conv2d_dgrad(g, wt.detach(), x.shape, 2))
    assert torch.equal(dw, tap_wgrad.conv2d_wgrad(x.detach(), g, 3, 2))


@pytest.mark.parametrize("pool", ["max2", "gap", "none"])
@pytest.mark.parametrize("b", [1, 7, 128])
def test_bf16_tail_matches_its_twin_on_card(card, b, pool):
    x, w, bias, y = _tail_inputs(card, b, pool, b + len(pool))
    x, w, bias = (t.to(BF16) for t in (x, w, bias))
    before = _bf16_counts()
    loss, dl = tail.tail_forward(x, w, bias, y, pool)
    loss2, dl2 = tail.tail_forward(x, w, bias, y, pool)
    torch.cuda.synchronize()
    assert tuple(n - m for n, m in zip(_bf16_counts(), before)) == (0, 0, 0, 2)
    assert loss.dtype == dl.dtype == torch.float32
    assert torch.equal(loss, loss2) and torch.equal(dl, dl2)
    ref_loss, ref_dl = tail.tail_forward_plain(x, w, bias, y, pool)
    _bf16_close(loss, ref_loss)
    _bf16_close(dl, ref_dl)


@pytest.mark.parametrize("shape", [(4, 4, 64), (3, 5, 8), (4, 4, 2048)])
def test_bf16_tail_gap_rounds_the_mean_as_its_twin_on_card(card, shape):
    """The gap mean is rounded to bf16 before the FC: the kernel's logits
    follow the twin's, not the f32 mean's, at odd position counts too."""
    gen = torch.Generator(device="cuda").manual_seed(shape[2])
    x = torch.relu(torch.randn((16,) + shape, generator=gen, device="cuda")).to(BF16)
    w = (torch.randn((shape[2], 10), generator=gen, device="cuda") * 0.1).to(BF16)
    bias = torch.zeros(10, device="cuda", dtype=BF16)
    y = torch.randint(0, 10, (16,), generator=gen, device="cuda")
    loss, dl = tail.tail_forward(x, w, bias, y, "gap")
    ref_loss, ref_dl = tail.tail_forward_plain(x, w, bias, y, "gap")
    _bf16_close(loss, ref_loss)
    _bf16_close(dl, ref_dl)


def test_bf16_wrappers_refuse_mixed_dtypes_on_card(card):
    x, wt, g = _grad_inputs(card, 2, 8, 8, 4, 8, 3, 1, 0)
    xb, wb, gb = (t.to(BF16) for t in (x, wt, g))
    before = _bf16_counts() + _f32_counts()
    with pytest.raises(TypeError):
        tap_conv.conv2d(xb, wt, 1)
    with pytest.raises(TypeError):
        tap_conv.conv2d_dgrad(gb, wt, x.shape, 1)
    with pytest.raises(TypeError):
        tap_wgrad.conv2d_wgrad(x, gb, 3, 1)
    from parallel_cnn_tpu_torch.config import NotPortedError

    ones = torch.ones(8, device=card)
    with torch.no_grad(), pytest.raises(NotPortedError):
        tap_conv.conv2d_fused(xb, wb, ones, ones)
    tx, tw, tb, ty = _tail_inputs(card, 4, "gap", 0)
    with pytest.raises(TypeError):
        tail.fused_tail_loss(tx.to(BF16), tw, tb, ty, pool="gap")
    assert _bf16_counts() + _f32_counts() == before


def test_bf16_zoo_step_launches_only_the_bf16_forms_on_card(card):
    """One bf16 fused step of ResNet-18: 20 forwards, 19 dgrads, 20 wgrads
    and 1 tail in bf16, no f32 launch, every dgrad on the tensor cores; the
    masters and momentum stay f32."""
    model = resnet.resnet18(10, backend="cuda",
                            generator=torch.Generator().manual_seed(0)).to(card)
    state = zoo.init_state(model, zoo.make_optimizer(0.01))
    step_fn = zoo.make_train_step(model, state.optimizer,
                                  fused=FusedStepConfig(update=False))
    imgs, labels = synthetic.make_image_dataset(16, seed=3)
    bf0, f0, wg0 = _bf16_counts(), _f32_counts(), _wgmma_counts()
    ffma_dgrad = tap_conv.bf16_dgrad_launches.count
    loss = step_fn(state, torch.from_numpy(imgs).to(card),
                   torch.from_numpy(labels).to(card, torch.int64))
    assert np.isfinite(float(loss))
    assert tuple(n - m for n, m in zip(_bf16_counts(), bf0)) == (20, 19, 20, 1)
    # 19 convs on the tensor cores; the stem (Cin 3) on the FFMA forms,
    # and it has no dgrad.
    assert tuple(n - m for n, m in zip(_wgmma_counts(), wg0)) == (19, 19, 19)
    assert tap_conv.bf16_dgrad_launches.count == ffma_dgrad
    assert _f32_counts() == f0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for t in state.trace.values())


# (b, h, w, cin, cout, k, s) of the tensor-core forms (tap_conv.wgmma_form):
# a 37-image bucket; 2x2 and 7x7 images (16- and 64-image rectangles);
# Cout 64 and 2,048; a 1x1/s2 and 3x3/s2, odd sizes at stride 2 (SAME
# padding above and left), a 1x1 map at stride 2; 14x14 and 32x32 maps.
WGMMA_CASES = [
    (37, 8, 8, 64, 64, 3, 1),
    (5, 2, 2, 128, 64, 3, 1),
    (3, 7, 7, 64, 128, 3, 1),
    (3, 4, 4, 512, 2048, 1, 1),
    (2, 4, 4, 2048, 512, 1, 1),
    (6, 16, 16, 64, 128, 1, 2),
    (6, 16, 16, 64, 128, 3, 2),
    (3, 7, 9, 64, 64, 3, 2),
    (4, 1, 1, 64, 64, 3, 2),
    (2, 14, 14, 128, 64, 3, 1),
    (2, 32, 32, 64, 64, 3, 1),
]


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", WGMMA_CASES)
def test_wgmma_forms_match_their_twins_on_card(card, b, h, w, cin, cout, k, s):
    """The bf16 forward and wgrad on the tensor cores against their twins
    (one bf16 ulp of the output's scale), each relaunch bit-identical,
    counted on the tensor-core counters; the FFMA forms at the same shape
    against the same twins. (The dgrad: test_wgmma_dgrad_matches_its_twin.)"""
    assert tap_conv.wgmma_form(cin, cout, k)
    x, wt, g = (t.to(BF16) for t in _grad_inputs(card, b, h, w, cin, cout, k, s, b + h + k))
    fwd_twin = tap_conv.bf16_twin(tap_conv.conv2d_plain, x, wt, stride=s)
    wgrad_twin = tap_conv.bf16_twin(tap_wgrad.conv2d_wgrad_plain, x, g, k=k, stride=s)
    wg0, bf0 = _wgmma_counts(), (tap_conv.bf16_launches.count, tap_wgrad.bf16_launches.count)
    for fn, twin in ((lambda: tap_conv.conv2d(x, wt, s), fwd_twin),
                     (lambda: tap_wgrad.conv2d_wgrad(x, g, k, s), wgrad_twin)):
        got, again = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _bf16_close(got, twin)
    assert tuple(n - m for n, m in zip(_wgmma_counts(), wg0)) == (2, 0, 2)
    assert (tap_conv.bf16_launches.count, tap_wgrad.bf16_launches.count) == bf0
    _bf16_close(tap_conv.conv2d_bf16_ffma(x, wt, s), fwd_twin)
    _bf16_close(tap_wgrad.conv2d_wgrad_bf16_ffma(x, g, k, s), wgrad_twin)
    assert tuple(n - m for n, m in zip(_wgmma_counts(), wg0)) == (2, 0, 2)


@pytest.mark.parametrize("geometry", GEOMETRIES + R50_GEOMETRIES,
                         ids=[g[0] for g in GEOMETRIES] + ["r50 " + g[0] for g in R50_GEOMETRIES])
def test_wgmma_forward_rows_of_a_bucket_equal_the_batch_on_card(card, geometry):
    """The tensor-core forward's rows do not depend on the batch around
    them (a 37-image bucket against 128 images, single images at the edges
    of a rectangle), and the form is taken at every conv but the stems."""
    _, h, cin, cout, k, s, _, _, _ = geometry
    assert tap_conv.wgmma_form(cin, cout, k) == (cin != 3)
    x, wt = (t.to(BF16) for t in _inputs(card, 128, h, h, cin, cout, k, s, False, h + cin)[:2])
    full = tap_conv.conv2d(x, wt, s)
    assert torch.equal(tap_conv.conv2d(x[:37], wt, s), full[:37])
    for row in (0, 3, 63, 127):
        assert torch.equal(tap_conv.conv2d(x[row:row + 1], wt, s), full[row:row + 1]), row


def test_wgmma_entries_refuse_what_they_do_not_take_on_card(card):
    """The tensor-core C entries refuse a channel count off the 64-channel
    box, a rectangle of other than 64 pixels and an unaligned base
    (cudaErrorInvalidValue, 1), before any launch."""
    lib_f, lib_w = tap_conv.build().get(), tap_wgrad.build().get()
    x, wt, g = (t.to(BF16) for t in _grad_inputs(card, 2, 8, 8, 64, 64, 3, 1, 0))
    part = torch.empty((1, 9 * 64, 64), device=card)
    gw = torch.empty_like(wt)
    out = torch.empty_like(g)
    stream = launch_stream(card)
    args = (2, 8, 8, 64, 8, 8, 64, 3, 1, 1, 1)
    assert lib_f.tap_conv_forward_wgmma(x.data_ptr(), wt.data_ptr(), out.data_ptr(), *args,
                                        1, 8, 8, stream) == 0
    for bad_args, rect in (((2, 8, 8, 32) + args[4:], (1, 8, 8)), (args, (1, 8, 4))):
        assert lib_f.tap_conv_forward_wgmma(x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                            *bad_args, *rect, stream) == 1
        assert lib_w.tap_conv_wgrad_wgmma(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                                          gw.data_ptr(), *bad_args, *rect, 2, stream) == 1
    assert lib_f.tap_conv_forward_wgmma(x.data_ptr() + 2, wt.data_ptr(), out.data_ptr(),
                                        *args, 1, 8, 8, stream) == 1
    assert lib_w.tap_conv_wgrad_wgmma(x.data_ptr(), g.data_ptr() + 2, part.data_ptr(),
                                      gw.data_ptr(), *args, 1, 8, 8, 2, stream) == 1
    # The dgrad's entry: the same refusals, and a table of another channel
    # count (n_tiles) or with a slot past w's taps.
    dx = torch.empty_like(x)
    rect, table = tap_conv.wgmma_dgrad_plan(2, 8, 8, 64, 3, 1)
    dargs = (2, 8, 8, 64, 8, 8, 64, 3, 1)

    def dgrad(g_ptr, a, tab, r):
        return lib_f.tap_conv_dgrad_wgmma(g_ptr, wt.data_ptr(), dx.data_ptr(), *a, tab,
                                          len(tab), *r, stream)

    assert dgrad(g.data_ptr(), dargs, table, rect) == 0
    assert dgrad(g.data_ptr(), (2, 8, 8, 32) + dargs[4:], table, rect) == 1
    assert dgrad(g.data_ptr(), dargs, table, (1, 8, 4)) == 1
    assert dgrad(g.data_ptr() + 2, dargs, table, rect) == 1
    assert dgrad(g.data_ptr(), dargs, tap_conv.wgmma_dgrad_plan(2, 8, 8, 128, 3, 1)[1],
                 rect) == 1
    bad = (ctypes.c_int * len(table))(*table)
    bad[2 + 5 + 16 + 5] = 9  # the first tap's slot, past a 3x3 conv's 9 taps
    assert dgrad(g.data_ptr(), dargs, bad, rect) == 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", WGMMA_CASES)
def test_wgmma_dgrad_matches_its_twin_on_card(card, b, h, w, cin, cout, k, s):
    """The bf16 dgrad on the tensor cores at every geometry class (3x3/s1,
    3x3/s2 at odd sizes, 1x1/s2 with its tapless phases, ResNet-50's wide
    1x1s, 1x1 and 2x2 maps) against its twin within one bf16 ulp of the
    output's scale, each relaunch bit-identical, counted on its own
    counter; the FFMA yardstick against the same twin."""
    assert tap_conv.wgmma_form(cin, cout, k)
    _, wt, g = (t.to(BF16) for t in _grad_inputs(card, b, h, w, cin, cout, k, s, b + w + k))
    shape = (b, h, w, cin)
    twin = tap_conv.bf16_twin(tap_conv.conv2d_dgrad_plain, g, wt, x_shape=shape, stride=s)
    wg0, ffma0 = _wgmma_counts(), tap_conv.bf16_dgrad_launches.count
    got, again = (tap_conv.conv2d_dgrad(g, wt, shape, s) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _bf16_close(got, twin)
    assert tuple(n - m for n, m in zip(_wgmma_counts(), wg0)) == (0, 2, 0)
    assert tap_conv.bf16_dgrad_launches.count == ffma0
    _bf16_close(tap_conv.conv2d_dgrad_bf16_ffma(g, wt, shape, s), twin)
    assert tap_conv.bf16_dgrad_launches.count == ffma0 + 1
    assert tuple(n - m for n, m in zip(_wgmma_counts(), wg0)) == (0, 2, 0)


WGMMA_DGRADS = [g for g in GEOMETRIES if g[2] != 3] + [
    ("r50 " + g[0],) + tuple(g[1:]) for g in R50_GEOMETRIES if g[2] != 3]


@pytest.mark.parametrize("geometry", WGMMA_DGRADS, ids=[g[0] for g in WGMMA_DGRADS])
def test_wgmma_dgrad_rows_of_a_bucket_equal_the_batch_on_card(card, geometry):
    """Every ResNet-18 and ResNet-50 dgrad takes the tensor-core form, and
    an image's dx rows do not depend on the batch around it: a 37-image
    batch's rows equal the same images' rows at b128, bit for bit."""
    _, h, cin, cout, k, s, _, _, _ = geometry
    assert tap_conv.wgmma_form(cin, cout, k)
    gen = torch.Generator(device=card).manual_seed(h + cin + cout)
    oh = -(-h // s)
    g = torch.randn((128, oh, oh, cout), generator=gen, device=card).to(BF16)
    wt = (0.1 * torch.randn((k, k, cin, cout), generator=gen, device=card)).to(BF16)
    wg0 = _wgmma_counts()
    full = tap_conv.conv2d_dgrad(g, wt, (128, h, h, cin), s)
    assert torch.equal(tap_conv.conv2d_dgrad(g[:37], wt, (37, h, h, cin), s), full[:37])
    assert tuple(n - m for n, m in zip(_wgmma_counts(), wg0)) == (0, 2, 0)


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", [(6, 16, 16, 64, 128, 3, 2),
                                                (3, 7, 9, 64, 64, 3, 2)])
def test_wgmma_dgrad_reads_views_off_the_boundary_on_card(card, b, h, w, cin, cout, k, s):
    """g and w one value past a 16-byte boundary give the aligned launch's
    dx bit for bit (the wrapper hands TMA an aligned copy)."""
    _, wt, g = (t.to(BF16) for t in _grad_inputs(card, b, h, w, cin, cout, k, s, 7))

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    shape = (b, h, w, cin)
    want = tap_conv.conv2d_dgrad(g, wt, shape, s)
    for gg, ww in ((off(g), wt), (g, off(wt)), (off(g), off(wt))):
        assert torch.equal(tap_conv.conv2d_dgrad(gg, ww, shape, s), want)


def test_wgmma_dgrad_yardstick_refuses_f32_and_cpu_tensors_on_card(card):
    """``conv2d_dgrad_bf16_ffma`` launches the bf16 FFMA kernel only: an
    f32 CUDA operand and a bf16 CPU one are refused, nothing launched."""
    _, wt, g = _grad_inputs(card, 2, 8, 8, 64, 64, 3, 1, 3)
    counts = _bf16_counts() + _f32_counts()
    for gg, ww in ((g, wt), (g.to(BF16).cpu(), wt.to(BF16).cpu())):
        with pytest.raises(TypeError):
            tap_conv.conv2d_dgrad_bf16_ffma(gg, ww, (2, 8, 8, 64), 1)
    assert _bf16_counts() + _f32_counts() == counts
