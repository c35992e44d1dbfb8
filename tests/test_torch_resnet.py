"""Full-width ResNet-18 (CIFAR stem, 64/128/256/512 channels) in eval mode:
the JAX package with ``conv_backend="pallas"`` (every conv through the
fused Pallas kernel, interpret mode on the CPU) vs the port on the CPU,
weights carried across by ``convert.from_jax`` — and a checkpoint the JAX
trainer's writer produced, served by the port."""

import jax
import numpy as np
import pytest
import torch

from parallel_cnn_tpu.nn import resnet as jax_resnet
from parallel_cnn_tpu.train import checkpoint as jax_checkpoint
from parallel_cnn_tpu.train.zoo import ZooState
from parallel_cnn_tpu_torch import convert
from parallel_cnn_tpu_torch.nn import resnet
from parallel_cnn_tpu_torch.ops import tap_conv
from parallel_cnn_tpu_torch.serve import get

IN_SHAPE = (32, 32, 3)
BATCH = 2
# f32 end to end; the two frameworks sum each conv's products in another
# order, and 20 convs compound that.
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once: keep PyTorch's
    CPU kernels to two threads each, as the JAX tests beside them expect."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _randomize_bn(tree, rng):
    """Give every BatchNorm non-trivial running stats and affine params,
    so the fold (scale = γ·rsqrt(var+ε), shift = β − mean·scale) is tested.
    γ below 1 keeps the residual stream O(1) across the 8 blocks."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "scale":
                out[k] = rng.uniform(0.2, 0.5, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("bias", "mean") and np.ndim(v) == 1:
                out[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = _randomize_bn(v, rng)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_randomize_bn(v, rng) for v in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def reference():
    """JAX params/state (numpy), inputs, and the JAX Pallas-path logits."""
    model = jax_resnet.resnet18(10, cifar_stem=True, conv_backend="pallas")
    params, state, _ = model.init(jax.random.key(0), IN_SHAPE)
    rng = np.random.default_rng(0)
    params = _randomize_bn(jax.tree_util.tree_map(np.asarray, params), rng)
    state = _randomize_bn(jax.tree_util.tree_map(np.asarray, state), rng)
    x = rng.uniform(0.0, 1.0, (BATCH, *IN_SHAPE)).astype(np.float32)
    logits = np.asarray(model.apply(params, state, x, train=False)[0])
    return params, state, x, logits


def _port_logits(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def test_resnet18_full_width_matches_jax_pallas(reference):
    params, state, x, ref = reference
    model = resnet.resnet18(10).eval()
    model.load_state_dict(convert.from_jax(params, state))
    got = _port_logits(model, x)
    assert got.shape == ref.shape == (BATCH, 10)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_resnet18_has_twenty_convs_at_full_width(reference):
    from parallel_cnn_tpu_torch.nn.layers import ConvBNAct

    model = resnet.resnet18(10)
    convs = [m for m in model.modules() if isinstance(m, ConvBNAct)]
    assert len(convs) == 1 + 16 + 3
    widths = sorted({m.conv["w"].shape[3] for m in convs})
    assert widths == [64, 128, 256, 512]
    jax_count = sum(np.size(a) for a in jax.tree_util.tree_leaves(reference[0]))
    assert resnet.num_params(model) == jax_count


def test_jax_checkpoint_served_by_port(reference, tmp_path):
    """checkpoint.save of a full ZooState (optimizer state included) →
    load_jax_checkpoint → the same logits as the weights passed directly."""
    params, state, x, ref = reference
    path = str(tmp_path / "zoo.npz")
    opt_state = {"mom": jax.tree_util.tree_map(np.zeros_like, params)}
    jax_checkpoint.save(path, ZooState(params, state, opt_state))

    direct = resnet.resnet18(10).eval()
    direct.load_state_dict(convert.from_jax(params, state))
    handle = get("resnet18")
    loaded = convert.load_jax_checkpoint(path, handle.init(seed=123))
    got = _port_logits(loaded, x)
    np.testing.assert_array_equal(got, _port_logits(direct, x))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_checkpoint_missing_leaf_raises(reference, tmp_path):
    params, state, _, _ = reference
    path = str(tmp_path / "partial.npz")
    jax_checkpoint.save(path, ZooState(params, {}, {}))  # no BN stats
    with pytest.raises(ValueError, match="lacks required leaves"):
        convert.load_jax_checkpoint(path, resnet.resnet18(10))


def test_checkpoint_corrupt_or_wrong_version_raises(tmp_path):
    meta = np.frombuffer(b'{"version": 99}', dtype=np.uint8)
    old = tmp_path / "old.npz"
    np.savez(old, __meta__=meta, w=np.zeros(4096, np.float32))
    torn = tmp_path / "torn.npz"
    torn.write_bytes(old.read_bytes()[:-200])
    with pytest.raises(ValueError, match="corrupted or unreadable"):
        convert.load_jax_checkpoint(str(torn), resnet.resnet18(10))
    with pytest.raises(ValueError, match="version"):
        convert.load_jax_checkpoint(str(old), resnet.resnet18(10))


def test_from_jax_rejects_a_mismatched_tree(reference):
    params, state, _, _ = reference
    model = resnet.resnet34(10)
    with pytest.raises(RuntimeError):
        model.load_state_dict(convert.from_jax(params, state))


def test_layers_match_jax_in_eval():
    """BatchNorm (running stats), Dense and GlobalAvgPool against the JAX
    layers on the same numpy inputs and params."""
    from parallel_cnn_tpu.nn import layers as jl
    from parallel_cnn_tpu_torch.nn import BatchNorm, Dense, GlobalAvgPool

    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 5, 6)).astype(np.float32)
    bn_p = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
            "bias": rng.standard_normal(6).astype(np.float32)}
    bn_s = {"mean": rng.standard_normal(6).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    bn = BatchNorm(6).eval()
    bn.load_state_dict(convert.from_jax(bn_p, bn_s))
    ref = np.asarray(jl.BatchNorm().apply(bn_p, bn_s, x, train=False)[0])
    with torch.inference_mode():
        np.testing.assert_allclose(bn(torch.from_numpy(x)).numpy(), ref, atol=1e-6)
        scale, shift = bn.fold()
        np.testing.assert_allclose((torch.from_numpy(x) * scale + shift).numpy(),
                                   ref, atol=1e-5)

    pooled = np.array(jl.GlobalAvgPool().apply({}, {}, x)[0])
    np.testing.assert_allclose(GlobalAvgPool()(torch.from_numpy(x)).numpy(),
                               pooled, atol=1e-6)
    d_p = {"w": rng.standard_normal((6, 4)).astype(np.float32),
           "b": rng.standard_normal(4).astype(np.float32)}
    dense = Dense(6, 4)
    dense.load_state_dict(convert.from_jax(d_p, {}))
    with torch.inference_mode():
        got = dense(torch.from_numpy(pooled)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.Dense(4).apply(d_p, {}, pooled)[0]),
                               atol=1e-5)


def test_bn_fold_is_cached_until_bn_changes():
    """ConvBNAct folds BN once; the fold follows load_state_dict, in-place
    edits and a deep copy, and the forward always matches a fresh fold."""
    import copy

    from parallel_cnn_tpu_torch.nn import ConvBNAct
    from parallel_cnn_tpu_torch.ops import tap_conv

    m = ConvBNAct(4, 6, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn((2, 5, 5, 4), generator=torch.Generator().manual_seed(1))

    def expect(mod):
        scale = mod.bn.scale * torch.rsqrt(mod.bn.var + mod.bn.eps)
        shift = mod.bn.bias - mod.bn.mean * scale
        return tap_conv.conv2d_fused(x, mod.conv["w"], scale, shift, None,
                                     mod.stride, mod.relu)

    with torch.inference_mode():
        first = m.folded_bn()
        assert all(a is b for a, b in zip(m.folded_bn(), first))  # reused
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    sd["bn.var"] = torch.full((6,), 4.0)
    sd["bn.bias"] = torch.arange(6, dtype=torch.float32)
    m.load_state_dict(sd)
    with torch.no_grad():
        torch.testing.assert_close(m(x), expect(m), rtol=0, atol=0)
        m.bn.mean.add_(0.5)
        torch.testing.assert_close(m(x), expect(m), rtol=0, atol=0)
        c = copy.deepcopy(m)
        c.bn.scale.mul_(2.0)
        torch.testing.assert_close(c(x), expect(c), rtol=0, atol=0)
        torch.testing.assert_close(m(x), expect(m), rtol=0, atol=0)
    assert not first[0].equal(m.folded_bn()[0])


def test_train_mode_is_refused():
    """Training mode is the unfused composition through conv2d (which has a
    backward); the fused eval kernel path refuses to record a gradient."""
    model = resnet.resnet18(10)  # nn.Module default: training mode
    stem = model[0]
    x = torch.zeros((2, *IN_SHAPE))
    y = model(x)
    assert y.requires_grad and y.shape == (2, 10)
    scale, shift = stem.folded_bn()
    with pytest.raises(RuntimeError, match="forward-only"):
        tap_conv.conv2d_fused(x, stem.conv["w"], scale, shift, None, 1, True)

