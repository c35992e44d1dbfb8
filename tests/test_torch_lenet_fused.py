"""Differential tests of the port's two LeNet kernels' plain versions and
their wrappers, against the JAX package's Pallas kernels in interpret mode:

- ``ops/lenet_fused.py`` (the port of ``_fused_kernel``,
  parallel_cnn_tpu/ops/pallas.py:589) vs ``pallas.fused_value_and_ref_grads``;
- ``ops/sgd_update.py`` (the port of ``_sgd_kernel``,
  parallel_cnn_tpu/ops/pallas_update.py:54) vs ``pallas_update.fused_sgd`` /
  ``tree_sgd``, and ``parallel/collectives.py``'s bucket plan vs JAX's.

The same numpy inputs from a seed go to both; params cross with
``convert.lenet_from_jax``. On a CPU tensor each wrapper runs its plain
version; the kernels themselves are held against it on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.models import lenet_ref as jlenet
from parallel_cnn_tpu.ops import pallas as jpallas
from parallel_cnn_tpu.ops import pallas_update as jupdate
from parallel_cnn_tpu.ops import reference as jref
from parallel_cnn_tpu.parallel import collectives as jcoll
from parallel_cnn_tpu_torch import convert
from parallel_cnn_tpu_torch.models import lenet_ref
from parallel_cnn_tpu_torch.ops import _cuda_build, lenet_fused, reference, sgd_update
from parallel_cnn_tpu_torch.parallel import collectives
from parallel_cnn_tpu_torch.utils.tree import tree_leaves, tree_paths

REPO_CSRC = _cuda_build.CSRC

# B1 plain vs the Pallas kernel (interpret mode, f32): the bounds of
# tests/test_ops_pallas.py's fused-kernel tests.
ERR_ATOL = 1e-6
GRAD_ATOL = GRAD_RTOL = 1e-5
# B2 plain vs the Pallas kernel: the bounds of tests/test_fused_step.py
# (separately compiled f32 expressions may differ by an ulp).
SGD_RTOL, SGD_ATOL = 3e-7, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: keep PyTorch's
    CPU kernels to two threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def jax_params(seed):
    return jax.tree_util.tree_map(np.asarray, jlenet.init(jax.random.key(seed)))


def batch(seed, n):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (n, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, (n,)).astype(np.int32)
    return xs, ys


def assert_tree_close(got, want, atol, rtol):
    for layer in want:
        for k in want[layer]:
            g = np.asarray(got[layer][k])
            w = np.asarray(want[layer][k])
            assert g.shape == w.shape, f"{layer}/{k}"
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                       err_msg=f"{layer}/{k}")


def port_call(jp, xs, ys):
    return lenet_fused.fused_value_and_ref_grads(
        convert.lenet_from_jax(jp), torch.from_numpy(xs), torch.from_numpy(ys))


# ---------------------------------------------------------------------------
# B1: the fused train-step kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 7])
def test_fused_plain_matches_pallas_interpret(n):
    jp = jax_params(7)
    xs, ys = batch(42 + n, n)
    want_e, want_g = jpallas.fused_value_and_ref_grads(jp, xs, ys)
    got_e, got_g = port_call(jp, xs, ys)
    assert got_e.shape == ()
    np.testing.assert_allclose(float(got_e), float(want_e), atol=ERR_ATOL)
    assert_tree_close(got_g, want_g, GRAD_ATOL, GRAD_RTOL)


def test_fused_plain_matches_pallas_over_several_grid_blocks(monkeypatch):
    """A batch over three of JAX's grid blocks with a padded tail (block 4,
    n = 10 pads to 12): the JAX kernel masks its pad rows; the port's
    grid covers exactly n images and divides by the real n."""
    monkeypatch.setattr(jpallas, "FUSED_BLOCK", 4)
    jp = jax_params(3)
    xs, ys = batch(9, 10)
    want_e, want_g = jpallas.fused_value_and_ref_grads(jp, xs, ys)
    got_e, got_g = port_call(jp, xs, ys)
    np.testing.assert_allclose(float(got_e), float(want_e), atol=ERR_ATOL)
    assert_tree_close(got_g, want_g, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("n", [1, 7, 33])
def test_fused_plain_is_the_batch_mean_of_jax_reference_grads(n):
    """err_mean and the grads are the MEAN over the real n of the
    per-sample reference grads (jax.vmap(value_and_ref_grads))."""
    jp = jax_params(11)
    xs, ys = batch(n, n)
    errs, grads = jax.vmap(jref.value_and_ref_grads, in_axes=(None, 0, 0))(jp, xs, ys)
    got_e, got_g = port_call(jp, xs, ys)
    np.testing.assert_allclose(float(got_e), float(jnp.mean(errs)), atol=ERR_ATOL)
    assert_tree_close(got_g, jax.tree_util.tree_map(lambda g: jnp.mean(g, 0), grads),
                      GRAD_ATOL, GRAD_RTOL)


def test_fused_plain_int64_labels_and_determinism():
    """Torch's int64 labels give what int32 labels give, and the same batch
    gives bit-identical grads on every call."""
    tp = lenet_ref.init(torch.Generator().manual_seed(5))
    xs, ys = batch(4, 12)
    x = torch.from_numpy(xs)
    e32, g32 = lenet_fused.fused_value_and_ref_grads(tp, x, torch.from_numpy(ys))
    e64, g64 = lenet_fused.fused_value_and_ref_grads(tp, x, torch.from_numpy(ys).long())
    assert torch.equal(e32, e64)
    for a, b in zip(tree_leaves(g32), tree_leaves(g64)):
        assert torch.equal(a, b)


def test_fused_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    tp = lenet_ref.init(torch.Generator().manual_seed(0))
    xs, ys = batch(0, 4)
    before = lenet_fused.launches.count
    lenet_fused.fused_value_and_ref_grads(tp, torch.from_numpy(xs), torch.from_numpy(ys))
    assert lenet_fused.launches.count == before  # no kernel on the CPU
    meta = torch.empty((4, 28, 28), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lenet_fused.fused_value_and_ref_grads(tp, meta, torch.from_numpy(ys))


def test_fused_output_layout_is_the_params_flatten_order():
    """The kernel writes its grads in the order of LEAVES, which must be
    the params tree's flatten order, and N_GRADS values in all."""
    tp = lenet_ref.init(torch.Generator().manual_seed(0))
    paths = tree_paths(tp)
    assert ["/".join(k) for k in lenet_fused.LEAVES] == paths
    assert lenet_fused.N_GRADS == lenet_ref.num_params(tp) == 2343
    flat = torch.arange(lenet_fused.ROW, dtype=torch.float32)
    tree = lenet_fused._unflatten(flat)
    assert tree["c1"]["b"].tolist() == [0, 1, 2, 3, 4, 5]
    assert float(tree["s1"]["b"]) == 2326 and tree["s1"]["b"].shape == ()
    assert float(tree["s1"]["w"][3, 3]) == 2342


# ---------------------------------------------------------------------------
# B2: the fused SGD kernel's plain version and the bucket plan
# ---------------------------------------------------------------------------


def test_fused_sgd_plain_matches_pallas_interpret():
    n = 5 * 128 + 37  # the odd tail of tests/test_fused_step.py
    rng = np.random.default_rng(17)
    p = rng.normal(size=n).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    want = jupdate.fused_sgd(jnp.asarray(p), jnp.asarray(g), lr=0.05, scale=0.25)
    got = sgd_update.fused_sgd(torch.from_numpy(p), torch.from_numpy(g),
                               lr=0.05, scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SGD_RTOL,
                               atol=SGD_ATOL)
    # The plain version is the three-op expression, each op rounded to f32.
    np.testing.assert_array_equal(
        got.numpy(), p - np.float32(0.05) * (g * np.float32(0.25)))


@pytest.mark.parametrize("bad", [
    lambda p: (p, p[:-1]),
    lambda p: (p.reshape(1, -1), p.reshape(1, -1)),
    lambda p: (p[:0], p[:0]),
], ids=["length", "rank", "empty"])
def test_fused_sgd_refuses_mismatched_buffers(bad):
    p = torch.zeros(8)
    a, b = bad(p)
    with pytest.raises(ValueError):
        sgd_update.fused_sgd(a, b, lr=0.1)


def _mixed_tree(rng):
    """The mixed tree of tests/test_fused_step.py:122 (a matrix, a vector
    and a 0-d leaf in a list)."""
    return {
        "a": rng.normal(size=(7, 11)).astype(np.float32),
        "b": [rng.normal(size=(130,)).astype(np.float32),
              np.float32(rng.normal())],
    }


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("which", ["lenet", "mixed"])
def test_tree_sgd_plain_matches_pallas_interpret(which):
    rng = np.random.default_rng(23)
    if which == "lenet":
        params = jax_params(2)
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    else:
        params = _mixed_tree(rng)
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)
    want = jupdate.tree_sgd(params, grads, lr=-0.1, scale=1.0 / 16)
    got = sgd_update.tree_sgd(_to_torch(params), _to_torch(grads), lr=-0.1,
                              scale=1.0 / 16)
    w_leaves = jax.tree_util.tree_leaves(want)
    g_leaves = tree_leaves(got)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SGD_RTOL,
                                   atol=SGD_ATOL)


def test_tree_sgd_makes_one_bucket_for_lenet():
    tp = lenet_ref.init(torch.Generator().manual_seed(0))
    plan = collectives.plan_buckets(tp)
    assert plan.n_buckets == 1 and plan.bucket_sizes == (2343,)


def _many_leaves_tree(rng):
    """A tree of MAX_LEAVES + 5 leaves of odd lengths (a 0-d one and a
    matrix among them): one bucket that the card updates in two launches."""
    tree = {f"l{i:02d}": rng.normal(size=((i * 37) % 101 + 1,)).astype(np.float32)
            for i in range(sgd_update.MAX_LEAVES + 3)}
    tree["m"] = rng.normal(size=(5, 7)).astype(np.float32)
    tree["z"] = np.float32(rng.normal())
    return tree


def _sgd_tree(which, rng):
    if which == "lenet":
        return jax_params(2)
    return _mixed_tree(rng) if which == "mixed" else _many_leaves_tree(rng)


@pytest.mark.parametrize("which", ["lenet", "mixed", "many"])
def test_tree_sgd_leaf_launches_cover_each_bucket_in_order(which):
    """The card's tree_sgd hands each bucket's leaves to the kernel in
    launches of at most MAX_LEAVES (⌈leaves / MAX_LEAVES⌉ a bucket: one for
    LeNet's 6 leaves and the mixed tree's 3, two for MAX_LEAVES + 5); each
    launch's span starts at its first leaf's slot offset and the kernel's
    prefix offsets (the span's start plus the lengths before) are the
    plan's slot offsets, so the spans tile the bucket exactly."""
    tree = _to_torch(_sgd_tree(which, np.random.default_rng(5)))
    plan = collectives.plan_buckets(tree, shards=1)
    assert plan.n_buckets == 1
    members = sgd_update.bucket_leaves(plan)
    assert [i for m in members for i in m] == [
        i for i, s in enumerate(plan.slots) if s.bucket >= 0]
    for b, m in enumerate(members):
        launches = sgd_update.leaf_launches([plan.slots[i].size for i in m])
        assert len(launches) == -(-len(m) // sgd_update.MAX_LEAVES)
        assert len(launches) == {"lenet": 1, "mixed": 1, "many": 2}[which]
        leaf = iter(m)
        end = 0
        for start, lens in launches:
            assert start == end and 1 <= len(lens) <= sgd_update.MAX_LEAVES
            for off in start + np.concatenate([[0], np.cumsum(lens)[:-1]]):
                slot = plan.slots[next(leaf)]
                assert slot.bucket == b and slot.offset == off
            end = start + sum(lens)
        assert end == plan.bucket_sizes[b] and next(leaf, None) is None


def test_wrapper_max_leaves_is_the_kernel_sources():
    """The wrapper cuts a bucket's leaves into launches of MAX_LEAVES, the
    size of the kernel's parameter struct in csrc/sgd_update.cu; the
    library reports its own, which the wrapper checks when it loads it."""
    import re

    src = (REPO_CSRC / "sgd_update.cu").read_text()
    assert re.findall(r"constexpr int MAX_LEAVES = (\d+);", src) == [
        str(sgd_update.MAX_LEAVES)]
    assert "sgd_update_max_leaves" in sgd_update._library.symbols
    assert "sgd_update_max_leaves()" in src
    # Two kernels: the leaf list (B2) and the momentum list (B13).
    assert len(re.findall(r"__global__ void", src)) == 2


def test_tree_sgd_plain_matches_pallas_interpret_past_max_leaves():
    """The host tree_sgd (pack, plain update, unpack) against JAX's tree_sgd
    on a tree of more leaves than one card launch takes."""
    rng = np.random.default_rng(29)
    params = _many_leaves_tree(rng)
    grads = jax.tree_util.tree_map(
        lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)
    assert len(jax.tree_util.tree_leaves(params)) == sgd_update.MAX_LEAVES + 5
    want = jupdate.tree_sgd(params, grads, lr=-0.1, scale=1.0 / 16)
    got = sgd_update.tree_sgd(_to_torch(params), _to_torch(grads), lr=-0.1,
                              scale=1.0 / 16)
    w_leaves = jax.tree_util.tree_leaves(want)
    g_leaves = tree_leaves(got)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SGD_RTOL,
                                   atol=SGD_ATOL)


def test_fused_sgd_leaves_plain_is_the_packed_update():
    """On CPU tensors the leaf list's plain version is the packed bucket's
    update, bit for bit: what the card's kernel writes."""
    rng = np.random.default_rng(3)
    sizes = (6, 150, 10, 2160, 1, 16)
    ps = [torch.from_numpy(rng.normal(size=n).astype(np.float32)) for n in sizes]
    gs = [torch.from_numpy(rng.normal(size=n).astype(np.float32)) for n in sizes]
    got = sgd_update.fused_sgd_leaves(ps, gs, lr=-0.1, scale=1.0 / 64)
    want = sgd_update.fused_sgd_plain(torch.cat(ps), torch.cat(gs), -0.1, 1.0 / 64)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        sgd_update.fused_sgd_leaves(ps, gs[:-1], lr=0.1)
    with pytest.raises(ValueError):
        sgd_update.fused_sgd_leaves([], [], lr=0.1)


@pytest.mark.parametrize("bucket_bytes,shards", [
    (collectives.DEFAULT_BUCKET_BYTES, 1), (64, 1), (600, 4), (4, 3),
])
@pytest.mark.parametrize("which", ["lenet", "mixed"])
def test_plan_buckets_slots_equal_jax(which, bucket_bytes, shards):
    rng = np.random.default_rng(31)
    tree = jax_params(4) if which == "lenet" else _mixed_tree(rng)
    want = jcoll.plan_buckets(tree, bucket_bytes, shards)
    got = collectives.plan_buckets(_to_torch(tree), bucket_bytes, shards)
    assert ([dataclasses.astuple(s) for s in got.slots]
            == [dataclasses.astuple(s) for s in want.slots])
    assert got.bucket_sizes == want.bucket_sizes
    assert got.bucket_dtypes == want.bucket_dtypes
    assert got.shards == want.shards
    # The packed buffers are JAX's, value for value, and unpack exactly.
    tt = _to_torch(tree)
    buckets = collectives.flatten_buckets(tt, got)
    for b, w in zip(buckets, jcoll.flatten_buckets(tree, want)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(w))
    back = collectives.unflatten_buckets(buckets, got)
    for a, b in zip(tree_leaves(back), tree_leaves(tt)):
        assert torch.equal(a, b)


def test_zero_size_leaf_is_carried_in_the_plan_only():
    tree = {"e": torch.zeros((0, 3)), "w": torch.ones(5)}
    plan = collectives.plan_buckets(tree, 64)
    assert plan.slots[0].bucket == -1 and plan.n_buckets == 1
    back = collectives.unflatten_buckets(collectives.flatten_buckets(tree, plan), plan)
    assert back["e"].shape == (0, 3) and torch.equal(back["w"], tree["w"])


# ---------------------------------------------------------------------------
# The kernel sources and the one builder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source,names", [
    ("lenet_fused.cu", ("pallas.py:589", "_fused_kernel", "189,648 MAC")),
    ("sgd_update.cu", ("pallas_update.py:54", "_sgd_kernel", "12 bytes per element")),
    ("tap_conv.cu", ("pallas_conv.py:228", "_tap_kernel")),
])
def test_kernel_source_names_the_tpu_kernel_and_its_bound(source, names):
    src = (REPO_CSRC / source).read_text()
    for name in names:
        assert name in src, f"{source} lacks {name!r}"
    assert "atomicAdd" not in src  # every sum in a fixed order


def test_fused_kernel_layout_constants_match_the_wrapper():
    """The output row and the per-image pass-1 row, as csrc/lenet_fused.cu
    declares them and the wrapper sizes its buffers by them; the header the
    kernel includes joins its build digest."""
    import re

    src = (REPO_CSRC / "lenet_fused.cu").read_text()
    got = tuple(int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
                for k in ("ROW", "ROW_PASS1"))
    assert got == (lenet_fused.ROW, lenet_fused.ROW_PASS1)
    assert lenet_fused.ROW_PASS1 % 4 == 0  # pass 2 stages 16-byte segments
    assert '#include "ffma_tile.cuh"' in src
    assert [h.name for h in lenet_fused._library.headers] == ["ffma_tile.cuh"]


def test_one_builder_digests_source_and_flags():
    """All three kernels build through ops/_cuda_build.py; each library's
    flags are the shared ones plus its own, so a changed flag builds anew."""
    from parallel_cnn_tpu_torch.ops import tap_conv

    libs = (tap_conv._library, lenet_fused._library, sgd_update._library)
    assert all(isinstance(lib, _cuda_build.Library) for lib in libs)
    assert all(lib.flags[:len(_cuda_build.NVCC_FLAGS)] == _cuda_build.NVCC_FLAGS
               for lib in libs)
    assert "-fmad=false" in sgd_update._library.flags
    assert "--use_fast_math" not in " ".join(lenet_fused._library.flags)
    assert {lib.source.name for lib in libs} == {
        "tap_conv.cu", "lenet_fused.cu", "sgd_update.cu"}
    assert all(lib._lib is None for lib in libs)  # nothing built on import
