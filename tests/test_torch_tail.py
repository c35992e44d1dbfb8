"""The fused loss tail: the port's ``ops.tail.fused_tail_loss`` (on the CPU,
the plain version of csrc/tail_ce.cu, and the plain backward) against the
JAX package's ``pallas_tail.fused_tail_loss`` in all three pool modes, once
through its Pallas kernel (interpret mode, ``PCNN_TAIL_KERNEL=1``) and once
through its XLA twin (``=0``). The same numpy inputs go to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.ops import pallas_tail
from parallel_cnn_tpu_torch.nn import Dense, Flatten, GlobalAvgPool, MaxPool, Sequential
from parallel_cnn_tpu_torch.nn import cifar, resnet
from parallel_cnn_tpu_torch.ops import tail

ATOL = 1e-5
SHAPES = {"max2": (6, 8, 8, 16), "gap": (6, 4, 4, 32), "none": (6, 2, 2, 8)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(pool, seed, ties=False):
    rng = np.random.default_rng(seed)
    shape = SHAPES[pool]
    x = rng.standard_normal(shape)
    if ties:
        # ReLU zeros (about half of all windows tie at 0) and exact repeats.
        x = np.maximum(x, 0.0)
        x[:, 1::2, 0::2, :] = x[:, 0::2, 0::2, :]
    d = {"max2": 4 * 4 * 16, "gap": 32, "none": 32}[pool]
    w = rng.standard_normal((d, 10)) * 0.1
    b = rng.standard_normal(10) * 0.1
    y = rng.integers(0, 10, shape[0])
    return x.astype(np.float32), w.astype(np.float32), b.astype(np.float32), y


def _jax(pool, x, w, b, y):
    def f(x, w, b):
        return pallas_tail.fused_tail_loss(x, w, b, jnp.asarray(y, jnp.int32),
                                           pool=pool)

    loss, grads = jax.value_and_grad(f, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return float(loss), [np.asarray(g) for g in grads]


def _port(pool, x, w, b, y):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    loss = tail.fused_tail_loss(*ts, torch.from_numpy(y), pool=pool)
    grads = torch.autograd.grad(loss, ts)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("kernel", ["1", "0"], ids=["pallas-interpret", "xla"])
@pytest.mark.parametrize("pool,ties", [("max2", False), ("max2", True),
                                       ("gap", False), ("none", False)])
def test_fused_tail_matches_jax(monkeypatch, kernel, pool, ties):
    monkeypatch.setenv("PCNN_TAIL_KERNEL", kernel)
    x, w, b, y = _inputs(pool, len(pool) + ties, ties)
    ref_loss, ref_grads = _jax(pool, x, w, b, y)
    before = tail.launches.count
    loss, grads = _port(pool, x, w, b, y)
    assert tail.launches.count == before  # the CPU path launches nothing
    assert abs(loss - ref_loss) <= ATOL
    for got, want in zip(grads, ref_grads):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_max2_ties_route_to_the_first_maximum():
    """A window of equal values sends its whole gradient to its top-left
    element (row-major window order), none to the others."""
    x = np.zeros((1, 2, 2, 1), np.float32)
    w = np.array([[1.0, -1.0]], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tail.fused_tail_loss(xt, torch.from_numpy(w), torch.zeros(2),
                                torch.tensor([0]), pool="max2")
    (dx,) = torch.autograd.grad(loss, xt)
    assert dx[0, 0, 0, 0] != 0
    assert float(dx[0, 0, 1, 0]) == float(dx[0, 1, 0, 0]) == float(dx[0, 1, 1, 0]) == 0.0


@pytest.mark.parametrize("pool", ["max2", "gap", "none"])
def test_plain_forward_matches_jax_ce(pool):
    """The kernel's plain version: per-sample loss and dlogits as JAX's
    shared math (_pooled_flat then _ce_from_logits) gives them."""
    x, w, b, y = _inputs(pool, 3)
    flat, _ = pallas_tail._pooled_flat(jnp.asarray(x), pool)
    oh = jax.nn.one_hot(jnp.asarray(y), 10, dtype=jnp.float32)
    ref_loss, ref_dl = pallas_tail._ce_from_logits(flat @ w + b, oh)
    loss, dl = tail.tail_forward_plain(*(torch.from_numpy(a) for a in (x, w, b, y)),
                                       pool)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), atol=ATOL)
    np.testing.assert_allclose(dl.numpy(), np.asarray(ref_dl), atol=ATOL)


@pytest.mark.parametrize("pool", ["max2", "gap", "none"])
def test_plain_forward_gives_out_of_range_labels_a_zero_one_hot_row(pool):
    """Labels outside [0, K) (the kernel's contract, and jax.nn.one_hot's):
    the loss is log-sum-exp alone and dlogits the softmax, as JAX's shared
    math gives them; in-range rows are unchanged."""
    x, w, b, _ = _inputs(pool, 5)
    y = np.array([-1, 10, 3, 12, -7, 0])
    flat, _ = pallas_tail._pooled_flat(jnp.asarray(x), pool)
    oh = jax.nn.one_hot(jnp.asarray(y), 10, dtype=jnp.float32)
    ref_loss, ref_dl = pallas_tail._ce_from_logits(flat @ w + b, oh)
    loss, dl = tail.tail_forward_plain(*(torch.from_numpy(a) for a in (x, w, b, y)), pool)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), atol=ATOL)
    np.testing.assert_allclose(dl.numpy(), np.asarray(ref_dl), atol=ATOL)
    assert float(dl[0].sum()) == pytest.approx(1.0, abs=1e-5)  # no one-hot taken


def test_split_tail_recognises_the_zoo_heads():
    assert tail.split_tail(resnet.resnet18(10)) == tail.TailSplit(9, "gap")
    assert tail.split_tail(cifar.cifar_cnn()) == tail.TailSplit(20, "max2")
    assert tail.split_tail(Sequential(Flatten(), Dense(4, 2))) == tail.TailSplit(0, "none")
    assert tail.split_tail(Sequential(MaxPool(), Dense(4, 2))) is None
    assert tail.split_tail(Sequential(GlobalAvgPool())) is None


def test_fused_tail_rejects_bad_input():
    x = torch.zeros((2, 3, 4, 1))
    with pytest.raises(ValueError, match="even"):
        tail.fused_tail_loss(x, torch.zeros((2, 3)), torch.zeros(3),
                             torch.zeros(2, dtype=torch.int64), pool="max2")
    with pytest.raises(ValueError, match="unknown pool"):
        tail.fused_tail_loss(x, torch.zeros((12, 3)), torch.zeros(3),
                             torch.zeros(2, dtype=torch.int64), pool="avg")
