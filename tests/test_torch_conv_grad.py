"""The conv's gradients: the port's ``tap_conv.conv2d`` autograd Function
(on the CPU: the plain versions of the dgrad and wgrad kernels) against
``jax.vjp`` of the JAX package's Pallas ``conv2d`` custom VJP, which the
CPU runs in interpret mode (its dgrad reaches ``_tap_kernel``, its wgrad
``_wgrad_tap_kernel``). The same numpy inputs and cotangent go to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.ops import pallas_conv
from parallel_cnn_tpu_torch.ops import tap_conv, tap_wgrad

# (b, h, w, cin, cout, k, s): k in {1, 3, 5, 7}, stride 1 and 2, even and
# odd sizes (JAX's odd-size stride-2 path scatters g onto the stride-1
# grid, pallas_conv.py:1052-1057); tests/test_pallas_conv.py's cases.
CASES = [
    (1, 8, 8, 4, 8, 1, 1),
    (2, 8, 8, 4, 8, 1, 2),
    (2, 7, 5, 4, 6, 1, 2),
    (2, 5, 7, 3, 5, 3, 1),
    (2, 8, 8, 4, 8, 3, 2),
    (2, 7, 9, 4, 8, 3, 2),
    (2, 8, 8, 4, 8, 5, 1),
    (2, 7, 8, 3, 6, 5, 2),
    (1, 8, 6, 3, 8, 7, 1),
    (1, 8, 8, 3, 8, 7, 2),
]
# JAX's own tolerances for its kernels against XLA (test_pallas_conv.py).
DX_ATOL = 1e-5
DW_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(b, h, w, cin, cout, k, s, seed):
    rng = np.random.default_rng(seed)
    oh, ow = -(-h // s), -(-w // s)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    g = rng.standard_normal((b, oh, ow, cout)).astype(np.float32)
    return x, wt, g


@pytest.mark.parametrize("b,h,w,cin,cout,k,s", CASES)
def test_conv2d_grads_match_jax_pallas_vjp(b, h, w, cin, cout, k, s):
    x, wt, g = _inputs(b, h, w, cin, cout, k, s, b * h + w * k + s)
    y_ref, vjp = jax.vjp(lambda a, c: pallas_conv.conv2d(a, c, s),
                         jnp.asarray(x), jnp.asarray(wt))
    dx_ref, dw_ref = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    counts = (tap_conv.launches.count, tap_conv.dgrad_launches.count,
              tap_wgrad.launches.count)
    y = tap_conv.conv2d(xt, wtt, s)
    dx, dw = torch.autograd.grad(y, (xt, wtt), torch.from_numpy(g))

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=DX_ATOL)
    assert dx.shape == x.shape and dw.shape == wt.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), atol=DX_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), atol=DW_ATOL)
    # The CPU path runs the plain versions and launches nothing.
    assert (tap_conv.launches.count, tap_conv.dgrad_launches.count,
            tap_wgrad.launches.count) == counts


@pytest.mark.parametrize("k,s,h", [(3, 2, 8), (1, 2, 7), (5, 1, 5)])
def test_grad_functions_equal_the_autograd_function(k, s, h):
    """conv2d_dgrad / conv2d_wgrad (what the backward calls) equal the
    Function's gradients, and the 1x1/s2 dgrad is zero on the skipped
    pixels."""
    x, wt, g = _inputs(2, h, h, 3, 4, k, s, 11)
    xt, wtt, gt = (torch.from_numpy(a) for a in (x, wt, g))
    dx = tap_conv.conv2d_dgrad(gt, wtt, xt.shape, s)
    dw = tap_wgrad.conv2d_wgrad(xt, gt, k, s)
    xr, wr = xt.clone().requires_grad_(True), wtt.clone().requires_grad_(True)
    ax, aw = torch.autograd.grad(tap_conv.conv2d(xr, wr, s), (xr, wr), gt)
    torch.testing.assert_close(dx, ax, rtol=0, atol=0)
    torch.testing.assert_close(dw, aw, rtol=0, atol=0)
    if k == 1 and s == 2:
        assert float(dx[:, 1::2].abs().max()) == 0.0
        assert float(dx[:, :, 1::2].abs().max()) == 0.0


def test_stem_input_gets_no_gradient():
    """Only the wanted gradients are formed: a batch that needs none (the
    stem's input) leaves the dgrad out."""
    x, wt, g = _inputs(1, 6, 6, 3, 4, 3, 1, 2)
    wtt = torch.from_numpy(wt).requires_grad_(True)
    y = tap_conv.conv2d(torch.from_numpy(x), wtt, 1)
    (dw,) = torch.autograd.grad(y, wtt, torch.from_numpy(g))
    assert dw.shape == wt.shape


def test_conv2d_fused_refuses_autograd():
    x = torch.zeros((1, 4, 4, 2), requires_grad=True)
    w, scale, shift = torch.zeros((3, 3, 2, 4)), torch.ones(4), torch.zeros(4)
    with pytest.raises(RuntimeError, match="forward-only"):
        tap_conv.conv2d_fused(x, w, scale, shift)
    with torch.no_grad():
        assert tap_conv.conv2d_fused(x, w, scale, shift).shape == (1, 4, 4, 4)


@pytest.mark.parametrize("k,s", [(2, 1), (3, 3)])
def test_grad_functions_reject_unsupported_geometry(k, s):
    x = torch.zeros((1, 4, 4, 2))
    g = torch.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError):
        tap_wgrad.conv2d_wgrad(x, g, k, s)
    with pytest.raises(ValueError):
        tap_conv.conv2d_dgrad(g, torch.zeros((k, k, 2, 2)), x.shape, s)
