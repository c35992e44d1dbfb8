"""Differential tests: the port's tap conv (parallel_cnn_tpu_torch.ops.
tap_conv) vs the JAX package's Pallas conv (ops/pallas_conv.py, interpret
mode on the CPU), on identical numpy inputs from a fixed seed.

On CPU tensors the port runs the kernel's plain PyTorch version; the CUDA
kernel itself (csrc/tap_conv.cu) is held against that plain version by
tests/test_torch_cuda.py, which skips without a GPU, and by chip_smoke.py."""

import numpy as np
import pytest
import torch

from parallel_cnn_tpu.ops import pallas_conv
from parallel_cnn_tpu_torch.ops import tap_conv

# (b, h, w, cin, cout, k, s): the geometry of tests/test_pallas_conv.py.
CASES = [
    (2, 8, 8, 4, 8, 3, 1),
    (2, 8, 8, 4, 8, 3, 2),   # even dims: XLA's SAME puts no pad above/left
    (2, 7, 9, 4, 8, 3, 2),   # odd/mixed dims
    (3, 8, 8, 4, 8, 1, 1),
    (2, 8, 8, 4, 8, 1, 2),
    (2, 5, 7, 3, 5, 3, 1),   # non-tile-friendly spatial dims
    (2, 8, 8, 4, 8, 5, 1),
    (2, 8, 8, 4, 8, 5, 2),
    (2, 12, 8, 3, 8, 7, 1),
    (2, 12, 8, 3, 8, 7, 2),
    (2, 7, 8, 3, 6, 5, 2),
    (2, 9, 7, 3, 6, 7, 2),
]
# (residual, relu): every epilogue the fused kernel takes.
EPILOGUES = [(False, False), (False, True), (True, False), (True, True)]
# The tolerance of the JAX package's own conv tests (weights scaled by 0.1).
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: keep PyTorch's
    CPU kernels to two threads each, as the JAX tests beside them expect."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(b, h, w, cin, cout, k, s, residual, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    oh, ow = -(-h // s), -(-w // s)
    res = (rng.standard_normal((b, oh, ow, cout)).astype(np.float32)
           if residual else None)
    return x, wt, scale, shift, res


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", CASES)
def test_conv2d_matches_jax_pallas(b, h, w, cin, cout, k, s):
    x, wt, *_ = _inputs(b, h, w, cin, cout, k, s, False, b * h + k + s)
    ref = np.asarray(pallas_conv.conv2d(x, wt, s))
    got = tap_conv.conv2d(_t(x), _t(wt), s).numpy()
    assert got.shape == ref.shape == tap_conv.out_shape(x.shape, wt.shape, s)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("residual,relu", EPILOGUES)
@pytest.mark.parametrize("b,h,w,cin,cout,k,s", CASES)
def test_conv2d_fused_matches_jax_pallas(b, h, w, cin, cout, k, s,
                                         residual, relu):
    x, wt, scale, shift, res = _inputs(b, h, w, cin, cout, k, s, residual,
                                       b * h * w + k + s)
    ref = np.asarray(
        pallas_conv.conv2d_fused(x, wt, scale, shift, res, s, relu)
    )
    got = tap_conv.conv2d_fused(
        _t(x), _t(wt), _t(scale), _t(shift), _t(res), s, relu
    ).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)
    if relu:
        assert (got >= 0).all()


def test_same_pads_follow_xla_split():
    # 3x3/s2 on an even size: pad_total 1 goes below, so output o centres
    # on input 2o+1 (PyTorch's padding=1 would centre on 2o).
    assert tap_conv.same_pads(32, 3, 2) == (16, 0, 1)
    assert tap_conv.same_pads(7, 3, 2) == (4, 1, 1)
    assert tap_conv.same_pads(32, 1, 2) == (16, 0, 0)
    assert tap_conv.same_pads(32, 3, 1) == (32, 1, 1)
    assert tap_conv.same_pads(12, 7, 2) == (6, 2, 3)


@pytest.mark.parametrize("k,stride", [(2, 1), (3, 3), (9, 1)])
def test_unsupported_geometry_raises(k, stride):
    x = torch.zeros((1, 8, 8, 2))
    w = torch.zeros((k, k, 2, 4))
    with pytest.raises(ValueError):
        tap_conv.conv2d(x, w, stride)


def test_non_square_or_non_hwio_weights_raise():
    with pytest.raises(ValueError, match="weights must be"):
        tap_conv.conv2d(torch.zeros((1, 8, 8, 2)), torch.zeros((3, 1, 2, 4)), 1)


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda a: {**a, "x": a["x"].double()}, TypeError),
        (lambda a: {**a, "x": a["x"].permute(0, 2, 1, 3)}, ValueError),
        (lambda a: {**a, "residual": torch.zeros((1, 4, 4, 4))}, ValueError),
        (lambda a: {**a, "scale": torch.ones(5)}, ValueError),
        (lambda a: {**a, "w": torch.zeros((3, 3, 3, 4))}, ValueError),
    ],
    ids=["float64", "non-contiguous", "residual-shape", "scale-shape",
         "cin-mismatch"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(mutate, err):
    """The launch wrapper validates before it builds or launches anything,
    so its checks are reachable on the CPU."""
    args = dict(
        x=torch.zeros((2, 8, 8, 2)),
        w=torch.zeros((3, 3, 2, 4)),
        scale=torch.ones(4),
        shift=torch.zeros(4),
        residual=torch.zeros((2, 8, 8, 4)),
    )
    a = mutate(args)
    with pytest.raises(err):
        tap_conv._launch(a["x"], a["w"], a["scale"], a["shift"],
                         a["residual"], 1, True)


def test_kernel_wrapper_refuses_autograd():
    x = torch.zeros((1, 4, 4, 2), requires_grad=True)
    w = torch.zeros((3, 3, 2, 4))
    with pytest.raises(RuntimeError, match="no backward"):
        tap_conv._launch(x, w, None, None, None, 1, False)


def test_cpu_path_launches_nothing():
    tap_conv.launches.reset()
    tap_conv.conv2d(torch.zeros((1, 4, 4, 2)), torch.zeros((3, 3, 2, 4)), 1)
    assert tap_conv.launches.count == 0


def test_launch_counter_loses_no_update_across_threads():
    """The serving path launches from batcher worker threads, all counting
    into one LaunchCounter."""
    import sys
    import threading

    counter = tap_conv.LaunchCounter()
    per_thread, n_threads = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [counter.add() for _ in range(per_thread)])
            for _ in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.count == per_thread * n_threads
    counter.reset()
    assert counter.count == 0
