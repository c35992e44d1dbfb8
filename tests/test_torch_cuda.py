"""The port's CUDA kernel on the card: csrc/tap_conv.cu held against its
plain PyTorch version, the wrapper's refusals on CUDA tensors, and the
serving path's launch count. Every test here skips without a GPU.

This file imports no JAX, so on a machine with the card and without JAX it
runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from parallel_cnn_tpu_torch.config import ServeConfig
from parallel_cnn_tpu_torch.ops import tap_conv
from parallel_cnn_tpu_torch.serve import get, loadgen, serve_stack

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
@pytest.mark.parametrize("b,h,w,cin,cout,k,s", CASES)
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


def test_kernel_is_batch_position_invariant_on_card(card):
    """Bit-identical rows whatever the batch around them: the serving
    bucket pads with zero rows and must not change a real row."""
    x, wt, *_ = _inputs(card, 5, 16, 16, 64, 64, 3, 1, False, 3)
    full = tap_conv.conv2d(x, wt, 1)
    one = tap_conv.conv2d(x[3:4].contiguous(), wt, 1)
    assert torch.equal(full[3:4], one)


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
