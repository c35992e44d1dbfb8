"""The port's bucketed collectives against the JAX package's
(``parallel_cnn_tpu/parallel/collectives.py``) on the CPU: the bucket plan
at 1-4 shards, and the ring reduce-scatter, all-gather and all-reduce in
spawned gloo worlds of 2 and 3 ranks against JAX's ring in ``shard_map``
on a 2- or 3-device slice of the 8-device host platform, on the same
per-rank numpy inputs.

The ring runs the same hops in both packages: every partial sum is one
rounded f32 add in the same order, and a bf16 wire rounds each payload to
nearest even in both, so the results are expected bit-identical. The
bf16 wire also sits within JAX's own bound against the exact sum
(``tests/test_collectives.py``: max error / max |sum| < 2e-2).

One world of each size per module: all cases of a size run in it
(``tests/_torch_dp_ranks.comm_cases``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dp_ranks as ranks
from parallel_cnn_tpu.config import MeshConfig as JaxMeshConfig
from parallel_cnn_tpu.nn import resnet as jax_resnet
from parallel_cnn_tpu.parallel import collectives as jax_coll
from parallel_cnn_tpu.parallel import mesh as jax_mesh
from parallel_cnn_tpu_torch.nn import resnet
from parallel_cnn_tpu_torch.parallel import collectives, distributed
from parallel_cnn_tpu_torch.train import zoo

AXIS = jax_mesh.DATA_AXIS
WORLD_TIMEOUT_S = 240
CHUNK = 96  # elements of one rank's chunk


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Several test workers share the machine: two PyTorch threads each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _slots(plan):
    return [(s.bucket, s.offset, s.size, tuple(s.shape), s.dtype) for s in plan.slots]


# ---------------------------------------------------------------------------
# Bucket plans
# ---------------------------------------------------------------------------


def _odd_tree(np_mod):
    """Scalars, odd lengths, an empty leaf, nesting, an int leaf."""
    return {
        "conv": {"w": np.arange(105, dtype=np.float32).reshape(7, 3, 5),
                 "b": np.arange(13, dtype=np.float32) * 0.5},
        "scalar": np.float32(3.25),
        "empty": np.zeros((0, 4), np.float32),
        "odd": [np.linspace(-1.0, 1.0, 9, dtype=np.float32),
                (np.full((2, 2), -2.0, np.float32),)],
        "count": np.arange(5, dtype=np.int32),
    }


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_plan_matches_jax_on_an_odd_tree(shards):
    tree = _odd_tree(np)
    want = jax_coll.plan_buckets(jax.tree_util.tree_map(jnp.asarray, tree),
                                 bucket_bytes=64, shards=shards)
    got = collectives.plan_buckets(
        jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree),
        bucket_bytes=64, shards=shards)
    assert got.bucket_sizes == want.bucket_sizes
    assert got.bucket_dtypes == want.bucket_dtypes
    assert _slots(got) == _slots(want)


@pytest.fixture(scope="module")
def resnet18_leaves():
    """ResNet-18's params: JAX's tree leaves and the port's, each in its
    package's flatten order (the port's ``jax_ordered_params``)."""
    model = jax_resnet.resnet18(10)
    params, _, _ = model.init(jax.random.key(0), (32, 32, 3))
    jax_leaves = jax.tree_util.tree_leaves(params)
    named = zoo.jax_ordered_params(resnet.resnet18(10, backend="torch"))
    return jax_leaves, named


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_plan_matches_jax_on_resnet18(resnet18_leaves, shards):
    jax_leaves, named = resnet18_leaves
    want = jax_coll.plan_buckets(jax_leaves, shards=shards)
    got = collectives.plan_buckets([p for _, p in named], shards=shards)
    assert got.bucket_sizes == want.bucket_sizes
    assert _slots(got) == _slots(want)
    if shards == 1:
        # 11,173,962 params in 12 buckets of at most 4 MiB.
        assert sum(got.bucket_sizes) == 11_173_962 and got.n_buckets == 12
        assert got.bucket_sizes[-1] == 5_130
    if shards == 4:
        assert got.bucket_sizes[-1] == 5_132  # 5,130 padded to 4 shards


# ---------------------------------------------------------------------------
# Ring collectives: spawned gloo worlds against JAX's shard_map
# ---------------------------------------------------------------------------


def _jax_per_device(fn, xs):
    """fn on each device of an n-device mesh, device r given xs[r]; the
    per-device results stacked in device order."""
    n = len(xs)
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=n, model=1))
    body = jax_mesh.shard_map(lambda s: jax.tree_util.tree_map(
        lambda v: v[None], fn(s)), mesh=mesh, in_specs=(P(AXIS),),
        out_specs=P(AXIS), check_vma=False)
    out = jax.jit(body)(jnp.asarray(np.concatenate(xs)))
    return jax.tree_util.tree_map(np.asarray, out)


def _cases(n, seed):
    rng = np.random.default_rng(seed)
    full = [rng.standard_normal(n * CHUNK).astype(np.float32) for _ in range(n)]
    shard = [rng.standard_normal(CHUNK).astype(np.float32) for _ in range(n)]
    tree_in = [rng.standard_normal(n * 41).astype(np.float32)[:41] for _ in range(n)]
    return [("rs", full, None), ("ag", shard, None), ("ar", full, None),
            ("rs", full, "bfloat16"), ("ag", shard, "bfloat16"),
            ("ar", full, "bfloat16"), ("tree_ring", tree_in, None),
            ("tree_psum", tree_in, None)]


def _jax_case(n, op, inputs, wire):
    if op == "rs":
        return _jax_per_device(
            lambda s: jax_coll.ring_reduce_scatter(s, AXIS, n, wire), inputs)
    if op == "ag":
        return _jax_per_device(
            lambda s: jax_coll.ring_all_gather(s, AXIS, n, wire), inputs)
    if op == "ar":
        return _jax_per_device(
            lambda s: jax_coll.ring_all_reduce(s, AXIS, n, wire), inputs)
    impl = "ring" if op == "tree_ring" else "psum"
    from parallel_cnn_tpu.config import CommConfig as JaxCommConfig

    comm = JaxCommConfig(impl=impl, bucket_bytes=64)
    return _jax_per_device(
        lambda s: jax_coll.tree_all_reduce(
            {"a": s[:37], "b": s[37:40] * 2.0, "c": s[40] * 3.0}, AXIS, n, comm),
        inputs)


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def world(request, host_devices):
    """(n, cases, per-rank port results) from one spawned world of n."""
    n = request.param
    cases = _cases(n, seed=n)
    results = distributed.run(ranks.comm_cases, n, device="cpu", args=(cases,),
                              timeout=WORLD_TIMEOUT_S)
    return n, cases, results


@pytest.mark.parametrize("op,wire", [("rs", None), ("ag", None), ("ar", None),
                                     ("rs", "bfloat16"), ("ag", "bfloat16"),
                                     ("ar", "bfloat16")])
def test_ring_is_bit_identical_to_jax(world, op, wire):
    n, cases, results = world
    (i, (_, inputs, _)), = [(i, c) for i, c in enumerate(cases)
                            if c[0] == op and c[2] == wire]
    want = _jax_case(n, op, inputs, wire)
    for r in range(n):
        got = results[r][i]
        assert got.dtype == np.float32 and got.shape == want[r].shape
        assert np.array_equal(got, want[r]), (
            f"rank {r}: max |Δ| {np.max(np.abs(got - want[r])):.3e}")
    if op == "rs":  # rank r holds the sum of chunk r
        total = np.sum(np.stack(inputs), axis=0, dtype=np.float64).reshape(n, -1)
        got = np.stack([results[r][i] for r in range(n)])
        err = np.max(np.abs(got - total))
        bound = 2e-2 * np.max(np.abs(total)) if wire else 1e-5
        assert err <= bound
    if op == "ag" and wire is None:  # every rank holds every chunk
        for r in range(n):
            assert np.array_equal(results[r][i], np.concatenate(inputs))


def test_bf16_wire_within_jax_bound_of_exact_sum(world):
    n, cases, results = world
    i = [k for k, c in enumerate(cases) if c[0] == "ar" and c[2] == "bfloat16"][0]
    exact = np.sum(np.stack(cases[i][1]), axis=0, dtype=np.float64)
    for r in range(n):
        err = np.max(np.abs(results[r][i] - exact))
        assert err / np.max(np.abs(exact)) < 2e-2


@pytest.mark.parametrize("op", ["tree_ring", "tree_psum"])
def test_tree_all_reduce_matches_jax(world, op):
    n, cases, results = world
    i = [k for k, c in enumerate(cases) if c[0] == op][0]
    want = _jax_case(n, op, cases[i][1], None)
    for r in range(n):
        got = results[r][i]
        assert sorted(got) == sorted(want)
        for k in want:
            # psum on gloo and XLA may sum the ranks in another order.
            np.testing.assert_allclose(got[k], want[k][r].reshape(got[k].shape),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
