"""The fused loss tail: the port's ``ops.tail.fused_tail_loss`` (on the CPU,
the plain version of csrc/tail_ce.cu, and the plain backward) against the
JAX package's ``pallas_tail.fused_tail_loss`` in all three pool modes, at
10 classes and at 100 and 1,000 (the heads the kernel's tiled form takes),
once through its Pallas kernel (interpret mode, ``PCNN_TAIL_KERNEL=1``) and
once through its XLA twin (``=0``). The same numpy inputs go to both. And
``tail_plan``, the kernel's shape-only choice of form."""

import inspect

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
#: The many-class cases' inputs (JAX's interpret kernel at 1,000 classes
#: takes about a second on a CPU at these sizes).
MANY_SHAPES = {"max2": (6, 4, 4, 16), "gap": (6, 3, 3, 64), "none": (6, 3, 3, 8)}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(pool, shape):
    _, h, wd, c = shape
    return {"max2": (h // 2) * (wd // 2) * c, "gap": c, "none": h * wd * c}[pool]


def _inputs(pool, seed, ties=False, k=10):
    rng = np.random.default_rng(seed)
    shape = SHAPES[pool] if k == 10 else MANY_SHAPES[pool]
    x = rng.standard_normal(shape)
    if ties:
        # ReLU zeros (about half of all windows tie at 0) and exact repeats.
        x = np.maximum(x, 0.0)
        x[:, 1::2, 0::2, :] = x[:, 0::2, 0::2, :]
    w = rng.standard_normal((_flat(pool, shape), k)) * 0.1
    b = rng.standard_normal(k) * 0.1
    y = rng.integers(0, k, shape[0])
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
@pytest.mark.parametrize("pool,ties,k", [
    pytest.param(pool, ties, k, id=f"{pool}-{ties}" + ("" if k == 10 else f"-k{k}"))
    for pool, ties, k in [("max2", False, 10), ("max2", True, 10), ("gap", False, 10),
                          ("none", False, 10)]
    + [(pool, False, k) for k in (100, 1000) for pool in ("max2", "gap", "none")]])
def test_fused_tail_matches_jax(monkeypatch, kernel, pool, ties, k):
    monkeypatch.setenv("PCNN_TAIL_KERNEL", kernel)
    x, w, b, y = _inputs(pool, len(pool) + ties + k, ties, k)
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


def test_tail_plan_takes_no_batch_size():
    """The plan is a function of the head's shape alone, so every row is
    the same at any B (the padded serve buckets rely on it)."""
    params = list(inspect.signature(tail.tail_plan).parameters)
    assert params == ["pool", "h", "wd", "c", "k", "dtype", "form"]


@pytest.mark.parametrize("pool,h,wd,c,k", [
    ("gap", 4, 4, 512, 10),      # ResNet-18's CIFAR head
    ("gap", 4, 4, 2048, 10),     # ResNet-50's
    ("max2", 8, 8, 128, 10),     # the CIFAR CNN's
    ("gap", 1, 1, 512, 10),      # VGG-16's
    ("none", 1, 1, 12_268, 10),  # the widest row the per-image form takes
], ids=["resnet18", "resnet50", "cifar-cnn", "vgg16", "48kb-edge"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tail_plan_keeps_the_per_image_form_at_the_cifar_heads(pool, h, wd, c, k, dtype):
    plan = tail.tail_plan(pool, h, wd, c, k, dtype)
    assert plan == tail.TailPlan("image", 0, 0, 0, 0)


@pytest.mark.parametrize("pool,h,wd,c,k", [
    ("gap", 7, 7, 2048, 1000),   # the library resnet50()'s ImageNet head
    ("none", 1, 1, 12_271, 10),  # past the per-image form's 48 KB
    ("max2", 2, 2, 12_288, 10),  # 12,288 floats of pooled row
    ("gap", 3, 3, 64, 100),      # more classes than one warp's lanes
    ("max2", 6, 6, 64, 1000),
    ("none", 3, 3, 8, 33),
], ids=["imagenet", "past-48kb", "12288-floats", "k100", "max2-k1000", "k33"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_tail_plan_tiles_many_classes_and_wide_rows(pool, h, wd, c, k, dtype):
    """The tiled form: feature chunks of whole ring slots that cover D in
    order (the last one ragged), at most MAX_CHUNKS of them; gap's position
    ranges 1, 2, 4 or 8, each of at most POS_SEG positions below 8; the
    scratch an image is the pooled row in x's dtype (none has none) and
    4·chunks·K bytes of partial logits."""
    plan = tail.tail_plan(pool, h, wd, c, k, dtype)
    d = _flat(pool, (0, h, wd, c))
    assert plan.form == "tiled"
    assert plan.chunk_features > 0 and plan.chunk_features % tail.STAGE_FEATURES == 0
    assert (plan.chunks - 1) * plan.chunk_features < d <= plan.chunks * plan.chunk_features
    assert 1 <= plan.chunks <= tail.MAX_CHUNKS
    if pool == "gap":
        assert plan.pos_groups in (1, 2, 4, 8)
        assert plan.pos_groups == 8 or plan.pos_groups * tail.POS_SEG >= h * wd
    itemsize = 2 if dtype == torch.bfloat16 else 4
    pooled = 0 if pool == "none" else d * itemsize
    assert plan.scratch_per_image == pooled + 4 * plan.chunks * k


def test_tail_plan_splits_the_imagenet_head_for_one_wave():
    """7x7x2048 -> 1,000: 16 class tiles × 16 chunks of 128 features fill
    about two blocks an SM for one group of 32 images; the 49 positions in
    4 ranges; 72,192 bytes of scratch an image in f32 (8,192 pooled,
    64,000 partial), 68,096 in bf16."""
    f32 = tail.tail_plan("gap", 7, 7, 2048, 1000, torch.float32)
    bf16 = tail.tail_plan("gap", 7, 7, 2048, 1000, torch.bfloat16)
    assert f32 == tail.TailPlan("tiled", 128, 16, 4, 72_192)
    assert bf16 == tail.TailPlan("tiled", 128, 16, 4, 68_096)
    assert -(-1000 // tail.TILE_CLASSES) * f32.chunks == 256


@pytest.mark.parametrize("pool", ["max2", "gap", "none"])
def test_forced_forms_give_the_plain_results_on_the_cpu(pool):
    """A plan names a kernel form; on a CPU tensor the wrapper takes the
    plain version whatever the plan, and launches nothing."""
    x, w, b, y = (torch.from_numpy(a) for a in _inputs(pool, 9, k=100))
    want = tail.tail_forward_plain(x, w, b, y, pool)
    before = (tail.launches.count, tail.tiled_launches.count)
    for form in tail.FORMS:
        plan = tail.tail_plan(pool, *x.shape[1:], 100, x.dtype, form=form)
        assert plan.form == form
        got = tail.tail_forward(x, w, b, y, pool, plan)
        assert all(torch.equal(g, r) for g, r in zip(got, want))
    assert (tail.launches.count, tail.tiled_launches.count) == before


def test_tail_plan_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown form"):
        tail.tail_plan("gap", 4, 4, 8, 10, torch.float32, form="rows")
    with pytest.raises(ValueError, match="unknown pool"):
        tail.tail_plan("avg", 4, 4, 8, 10, torch.float32)
