"""Fused loss tail: pool → flatten → FC → softmax cross-entropy in one
kernel call (the port's counterpart of ``parallel_cnn_tpu/ops/pallas_tail.py``,
whose TPU kernel is ``_tail_kernel`` at pallas_tail.py:152).

``fused_tail_loss(x, w, b, labels, pool=...)`` is the mean softmax-CE of
``Dense(pool(x))``, a ``torch.autograd.Function``. Its forward writes only
the per-sample loss and ``dlogits = softmax − onehot``: on a CUDA tensor
through the hand kernel in ``csrc/tail_ce.cu``, on a CPU tensor through the
plain version beside it. The backward starts from the saved ``dlogits``
and is plain tensor code, as JAX's is plain XLA (pallas_tail.py:270-300):
``dW = pooledᵀ·dl``, ``db = Σ dl``, ``dx`` routed back through the pool,
with the pooled activations recomputed from the saved input. The ``max2``
backward routes a tied window's gradient to its first maximum in row-major
window order (XLA's select-and-scatter), by masked writes into strided
views: no scatter-add, so the card's backward is deterministic.

bf16 (JAX's bf16 activations): ``x``, ``w`` and ``b`` bf16 launch the
kernel's bf16 form, which sums in f32, rounds the ``gap`` mean to bf16
before the FC (pallas_tail.py:180) and writes f32 ``loss_i`` and
``dlogits``; its plain twin does the same in PyTorch. The backward
upcasts as JAX's ``_backward`` does (pallas_tail.py:270-300): the
products and the ``gap`` division in f32, ``dx`` cast to x's dtype and
``dw``/``db`` to w's. Mixed dtypes raise TypeError.

Two forms of the kernel, chosen by ``tail_plan`` from the shapes alone
(never from B, so a row's bits do not depend on its batch): the per-image
form (a block an image, one CUDA launch) for the 10-class CIFAR heads, and
the tiled form (JAX's batch-block form, three chained CUDA launches: a pool
pass, an FC whose w tiles serve 32 images, a fixed-order finish; scratch
from ``torch.empty``) for many classes or features. Either is one call of
the kernel, one count on ``launches`` (``bf16_launches``), and the tiled
form's also one on ``tiled_launches`` (``bf16_tiled_launches``).

Pool modes (``split_tail`` recognises them on a ``Sequential``):

- ``"max2"`` — MaxPool(2×2, stride 2, VALID) → Flatten → Dense (the CIFAR
  CNN head), flattened in ``(y, x, c)`` order;
- ``"gap"`` — GlobalAvgPool → Dense (the ResNet head);
- ``"none"`` — Flatten → Dense.

Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from parallel_cnn_tpu_torch.ops._cuda_build import (
    Library,
    LaunchCounter,
    check_operand,
    launch_stream,
    raise_on_error,
)

POOLS = ("max2", "gap", "none")
FORMS = ("image", "tiled")
_POOL_CODE = {"max2": 0, "gap": 1, "none": 2}
# The per-image form takes a tail whose pooled row, its logits and 8 floats
# fit the 48 KB of shared memory a block gets without opting in. The
# kernel's partial logits, one a thread, can take a block up to 1 KB past
# that; it then opts in, so that it still takes every tail this check
# accepts.
_SMEM_FLOATS = 48 * 1024 // 4
_INT32_MAX = 2**31 - 1
#: The plan gives the per-image form a tail of at most this many classes
#: (one a lane of the warp that runs its softmax) that fits its 48 KB.
IMAGE_MAX_CLASSES = 32
#: The tiled form's FC block takes TILE_CLASSES classes, its ring slots
#: STAGE_FEATURES features (csrc/tail_ce.cu TILE_K, STAGE_F); its gap pass
#: splits a channel's positions into at most MAX_POS_GROUPS ranges of
#: about POS_SEG (MAX_POS_GROUPS, TAIL_SEG).
TILE_CLASSES = 64
STAGE_FEATURES = 32
MAX_POS_GROUPS = 8
POS_SEG = 16
#: The FC grid the plan aims at for one image group: about two blocks an
#: SM of an H100 (132 SMs).
TARGET_BLOCKS = 264
#: The fewest features a chunk sums (two ring slots), unless D is fewer.
MIN_CHUNK_FEATURES = 64
#: The most feature chunks: the partial logits take at most 4·MAX_CHUNKS·K
#: bytes an image.
MAX_CHUNKS = 64

#: Launches of the tail kernel's f32 form in this process, and of its
#: bf16 form (a wrapper call is one launch, in either form); and of those,
#: the calls in the tiled form.
launches = LaunchCounter()
bf16_launches = LaunchCounter()
tiled_launches = LaunchCounter()
bf16_tiled_launches = LaunchCounter()

_TAIL_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_TILED_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_library = Library("tail_ce.cu", {
    "tail_ce_forward": (_TAIL_ARGS, ctypes.c_int),
    "tail_ce_forward_bf16": (_TAIL_ARGS, ctypes.c_int),
    "tail_ce_forward_tiled": (_TILED_ARGS, ctypes.c_int),
    "tail_ce_forward_tiled_bf16": (_TILED_ARGS, ctypes.c_int),
}, headers=("ffma_tile.cuh",))


class TailPlan(NamedTuple):
    """How the kernel runs one tail shape (``tail_plan``)."""

    form: str             # "image" or "tiled"
    chunk_features: int   # tiled: features a partial logit sums (0 for image)
    chunks: int           # tiled: ceil(D / chunk_features) (0 for image)
    pos_groups: int       # tiled gap: position ranges a channel's sum is split into
    scratch_per_image: int  # tiled: scratch bytes an image (pooled row + partials)


@functools.lru_cache(maxsize=None)
def tail_plan(pool: str, h: int, wd: int, c: int, k: int, dtype: torch.dtype,
              form: Optional[str] = None) -> TailPlan:
    """How the tail kernel runs a (H, W, C) → K head in ``dtype``, from the
    shape alone (no batch size: every row is bit-identical at any B).

    The per-image form where K <= IMAGE_MAX_CLASSES and the row fits its
    48 KB (the CIFAR heads); else the tiled form, whose FC splits D into
    chunks of whole ring slots, as many as bring (class tiles × chunks) to
    about TARGET_BLOCKS, each of at least MIN_CHUNK_FEATURES, at most
    MAX_CHUNKS in all; its gap pass splits the H·W positions into the
    fewest of 1, 2, 4, 8 ranges of at most POS_SEG (8 past 128 positions).
    Its scratch: the pooled rows in ``dtype`` (none has none) and 4·chunks·K
    bytes of partial logits an image. ``form`` forces a form (the smoke
    times both)."""
    if pool not in POOLS:
        raise ValueError(f"unknown pool {pool!r} (one of {POOLS})")
    d = _flat_dim((0, h, wd, c), pool)
    if form is None:
        form = "image" if k <= IMAGE_MAX_CLASSES and d + k + 8 <= _SMEM_FLOATS else "tiled"
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r} (one of {FORMS})")
    if form == "image":
        return TailPlan("image", 0, 0, 0, 0)
    slots = -(-d // STAGE_FEATURES)
    tiles = -(-k // TILE_CLASSES)
    want = min(max(1, round(TARGET_BLOCKS / tiles)),
               max(1, slots // (MIN_CHUNK_FEATURES // STAGE_FEATURES)))
    per_chunk = max(-(-slots // want), -(-slots // MAX_CHUNKS))
    chunk_features = per_chunk * STAGE_FEATURES
    chunks = -(-d // chunk_features)
    groups = 1
    if pool == "gap":
        while groups < MAX_POS_GROUPS and groups * POS_SEG < h * wd:
            groups *= 2
    pooled = 0 if pool == "none" else d * (torch.finfo(dtype).bits // 8)
    return TailPlan("tiled", chunk_features, chunks, groups, pooled + 4 * chunks * k)


def build() -> Library:
    """Compile (if needed) and load the kernel library; returns its record."""
    _library.get()
    return _library


class TailSplit(NamedTuple):
    """Where a Sequential's fusable tail starts: ``trunk`` layers run as
    they are; ``layers[trunk:]`` become one ``fused_tail_loss`` call."""

    trunk: int
    pool: str


def split_tail(model) -> Optional[TailSplit]:
    """The supported tail suffix of a Sequential, else None (the caller
    keeps the unfused composition)."""
    from parallel_cnn_tpu_torch.nn import core, layers

    if not isinstance(model, core.Sequential):
        return None
    ls = list(model)
    if (len(ls) >= 3 and isinstance(ls[-3], layers.MaxPool)
            and (ls[-3].window, ls[-3].stride, ls[-3].padding) == (2, 2, "VALID")
            and isinstance(ls[-2], layers.Flatten)
            and isinstance(ls[-1], layers.Dense)):
        return TailSplit(len(ls) - 3, "max2")
    if (len(ls) >= 2 and isinstance(ls[-2], layers.GlobalAvgPool)
            and isinstance(ls[-1], layers.Dense)):
        return TailSplit(len(ls) - 2, "gap")
    if (len(ls) >= 2 and isinstance(ls[-2], layers.Flatten)
            and isinstance(ls[-1], layers.Dense)):
        return TailSplit(len(ls) - 2, "none")
    return None


def _phases(x: torch.Tensor):
    """The four 2×2-window positions of an even-H/W NHWC tensor as strided
    views, in row-major window order."""
    return (x[:, 0::2, 0::2, :], x[:, 0::2, 1::2, :],
            x[:, 1::2, 0::2, :], x[:, 1::2, 1::2, :])


def _pooled(x: torch.Tensor, pool: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(pooled activations as (B, D), the unflattened max2 pool or None)."""
    if pool == "max2":
        p0, p1, p2, p3 = _phases(x)
        pooled = torch.maximum(torch.maximum(p0, p1), torch.maximum(p2, p3))
        return pooled.reshape(pooled.shape[0], -1), pooled
    if pool == "gap":
        return x.mean(dim=(1, 2)), None
    return x.reshape(x.shape[0], -1), None


def tail_forward_plain(x, w, b, labels, pool: str):
    """Plain version of the kernel: (per-sample loss (B,), dlogits (B, K)),
    f32 for bf16 operands, computed as the bf16 form computes them: the
    operands widened, the gap mean (sum · 1/P in f32) rounded to bf16."""
    if x.dtype == torch.bfloat16:
        xf = x.float()
        if pool == "gap":
            inv = 1.0 / (x.shape[1] * x.shape[2])
            flat = (xf.sum(dim=(1, 2)) * inv).to(torch.bfloat16).float()
        else:
            flat, _ = _pooled(xf, pool)
        logits = flat @ w.float() + b.float()
    else:
        flat, _ = _pooled(x, pool)
        logits = flat @ w + b
    m = logits.max(dim=-1, keepdim=True).values
    e = torch.exp(logits - m)
    se = e.sum(dim=-1, keepdim=True)
    # A label outside [0, K) gives an all-zero row, as jax.nn.one_hot does
    # (torch.nn.functional.one_hot refuses one).
    classes = torch.arange(w.shape[-1], device=labels.device)
    oh = (labels.long()[:, None] == classes).to(logits.dtype)
    loss_i = (torch.log(se) + m)[:, 0] - (logits * oh).sum(dim=-1)
    return loss_i, e / se - oh


def _flat_dim(x_shape, pool: str) -> int:
    _, h, wd, c = x_shape
    if pool == "max2":
        return (h // 2) * (wd // 2) * c
    return c if pool == "gap" else h * wd * c


def _launch(x, w, b, labels, pool: str, plan: Optional[TailPlan]):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    batch, h, wd, c = (int(d) for d in x.shape)
    d = _flat_dim(x.shape, pool)
    k = int(w.shape[-1])
    dev = x.device
    dtype = x.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    check_operand("x", x, dev, (batch, h, wd, c), dtype)
    check_operand("w", w, dev, (d, k), dtype)
    check_operand("b", b, dev, (k,), dtype)
    check_operand("labels", labels, dev, (batch,), torch.int64)
    plan = plan or tail_plan(pool, h, wd, c, k, dtype)
    bf16 = dtype == torch.bfloat16
    loss = torch.empty((batch,), device=dev, dtype=torch.float32)
    dl = torch.empty((batch, k), device=dev, dtype=torch.float32)
    if plan.form == "image":
        if d + k + 8 > _SMEM_FLOATS:
            raise ValueError(f"tail of {d} features x {k} classes exceeds the per-image "
                             "form's 48 KB of shared memory")
        lib = _library.get()
        entry = lib.tail_ce_forward_bf16 if bf16 else lib.tail_ce_forward
        with torch.cuda.device(dev):
            err = entry(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
                loss.data_ptr(), dl.data_ptr(), batch, h, wd, c, d, k,
                _POOL_CODE[pool], launch_stream(dev),
            )
    else:
        chunks = -(-d // plan.chunk_features)  # the kernel's count, whatever plan says
        if max(x.numel(), w.numel(), batch * d, chunks * batch * k) > _INT32_MAX:
            raise ValueError(f"tail of {batch} x {d} features x {k} classes is too large "
                             "for 32-bit indexing")
        lib = _library.get()
        pooled = (None if pool == "none"
                  else torch.empty((batch, d), device=dev, dtype=dtype))
        partial = torch.empty((chunks, batch, k), device=dev, dtype=torch.float32)
        entry = lib.tail_ce_forward_tiled_bf16 if bf16 else lib.tail_ce_forward_tiled
        with torch.cuda.device(dev):
            err = entry(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
                None if pooled is None else pooled.data_ptr(), partial.data_ptr(),
                loss.data_ptr(), dl.data_ptr(), batch, h, wd, c, d, k, _POOL_CODE[pool],
                plan.chunk_features, plan.pos_groups, launch_stream(dev),
            )
    raise_on_error("tail_ce", err)
    (bf16_launches if bf16 else launches).add()
    if plan.form == "tiled":
        (bf16_tiled_launches if bf16 else tiled_launches).add()
    return loss, dl


def tail_forward(x, w, b, labels, pool: str, plan: Optional[TailPlan] = None):
    """(per-sample loss, dlogits): the kernel on a CUDA tensor, in the form
    ``plan`` names (by default ``tail_plan``'s for the shape); the plain
    version on a CPU one."""
    if x.device.type == "cpu":
        return tail_forward_plain(x, w, b, labels, pool)
    if x.device.type != "cuda":
        raise ValueError(f"the tail runs on cuda or cpu tensors, got {x.device}")
    return _launch(x, w, b, labels, pool, plan)


def tail_backward(pool: str, x, w, dl_scaled):
    """(dx, dw, db) from dlogits already scaled by gbar/B (pallas_tail.py
    ``_backward``): the products in dlogits' dtype (f32 for bf16 operands,
    ``flat`` and ``w`` widened), ``dw`` and ``db`` in w's dtype, ``dx`` in
    x's (for f32 every cast is a no-op)."""
    flat, pooled = _pooled(x, pool)
    acc = dl_scaled.dtype
    dw = (flat.to(acc).t() @ dl_scaled).to(w.dtype)
    db = dl_scaled.sum(dim=0).to(w.dtype)
    dflat = dl_scaled @ w.to(acc).t()
    if pool == "gap":
        n, h, wd, c = x.shape
        dx = dflat[:, None, None, :].div(h * wd).expand(n, h, wd, c)
        return dx.to(x.dtype), dw, db
    if pool == "none":
        return dflat.reshape(x.shape).to(x.dtype), dw, db
    dpool = dflat.reshape(pooled.shape)
    zero = torch.zeros((), dtype=dpool.dtype, device=dpool.device)
    taken = torch.zeros(pooled.shape, dtype=torch.bool, device=pooled.device)
    dx = torch.zeros(x.shape, dtype=dpool.dtype, device=x.device)
    for view, phase in zip(_phases(dx), _phases(x)):
        hit = (phase == pooled) & ~taken
        view.copy_(torch.where(hit, dpool, zero))
        taken |= hit
    return dx.to(x.dtype), dw, db


class _FusedTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, labels, pool):
        loss_i, dl = tail_forward(x, w, b, labels, pool)
        ctx.pool = pool
        ctx.save_for_backward(x, w, dl)
        return loss_i.mean()

    @staticmethod
    def backward(ctx, gbar):
        x, w, dl = ctx.saved_tensors
        dl_scaled = dl * (gbar / dl.shape[0])
        dx, dw, db = tail_backward(ctx.pool, x, w, dl_scaled)
        return dx, dw, db, None, None


def fused_tail_loss(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    labels: torch.Tensor, *, pool: str = "none") -> torch.Tensor:
    """Mean softmax-CE loss of the fused tail: a drop-in for
    ``cross_entropy(Dense(pool(x)), labels)``.

    x: (B, H, W, C) in every mode (H and W even for ``max2``); w: (D, K)
    in flatten order;
    b: (K,); labels: (B,) int64 class ids. x, w and b all f32 or all bf16.
    Returns the f32 scalar mean."""
    if pool not in POOLS:
        raise ValueError(f"unknown pool {pool!r} (one of {POOLS})")
    if pool == "max2" and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"max2 tail needs even spatial dims, got "
                         f"{tuple(x.shape[1:3])}")
    if not x.dtype == w.dtype == b.dtype:
        raise TypeError(f"x, w and b must share a dtype, got {x.dtype}, {w.dtype}, "
                        f"{b.dtype}")
    return _FusedTail.apply(x, w, b, labels, pool)
