"""Pipeline-parallel substrate: stage partitioning and the 1F1B schedule
(the port of ``parallel_cnn_tpu/parallel/pipeline.py``).

- ``schedule_events`` is the closed-form 1F1B tick table the step
  (train/pipeline_schedule.py) runs: the forward of microbatch m at stage
  s fires at tick ``s + 2m``, its backward at tick ``2S − 1 − s + 2m``, so
  each stage holds at most S stashed microbatches and idles a share
  (S−1)/(S−1+M) of the ticks. Copied from JAX as it is (numpy only).
- ``split_layers`` chooses stage boundaries by balancing per-layer flops.
  JAX counts them from each layer's jaxpr (``analysis/cost_model.py``
  ``measured_flops``: 2 × the multiply-adds of every conv and dot); the
  port counts the same number from the layer's shapes (``layer_costs``),
  so both packages pick the same boundaries for the same model. JAX's
  count is that of its "xla" conv backend; its "pallas" backend traces
  the Pallas kernel's own tiles and counts other numbers.
- ``pack_acts`` / ``unpack_acts`` flatten a stage-boundary activation into
  the uniform zero-padded ``(microbatch, A_buf)`` wire and stash buffer.
  Activations are channel-last (N, H, W, C) in both packages, so the
  flatten order is JAX's.

Everything here is host-side over static shapes: nothing runs a layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# 1F1B schedule (closed form)
# ---------------------------------------------------------------------------


class TickEvent(NamedTuple):
    """One synchronous tick: per-stage microbatch ids (None = idle).

    ``fwd[s]`` is the microbatch whose forward stage s runs this tick;
    ``bwd[s]`` the microbatch whose backward it runs. A stage's forward and
    backward ticks have different parities, so it never does both in one
    tick.
    """

    fwd: Tuple[Optional[int], ...]
    bwd: Tuple[Optional[int], ...]


def n_ticks(n_stages: int, n_micro: int) -> int:
    """Total ticks of the 1F1B schedule: 2·(M + S − 1)."""
    return 2 * (n_micro + n_stages - 1)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction per stage: (S−1)/(S−1+M). Each stage works 2M of the
    2(M+S−1) ticks, whatever s."""
    return (n_stages - 1) / (n_stages - 1 + n_micro)


def schedule_events(n_stages: int, n_micro: int) -> Tuple[TickEvent, ...]:
    """The deterministic 1F1B tick table for S stages × M microbatches.

    Closed form: Tf(s, m) = s + 2m and Tb(s, m) = 2S − 1 − s + 2m. A
    producer's output is consumed one tick later on both wires
    (Tf(s+1, m) = Tf(s, m) + 1; Tb(s, m) = Tb(s+1, m) + 1), and stash slot
    ``m mod S`` is reuse-safe: Tf(s, m+S) − Tb(s, m) = 2s + 1 > 0.
    """
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    events = []
    for t in range(n_ticks(n_stages, n_micro)):
        fwd: List[Optional[int]] = []
        bwd: List[Optional[int]] = []
        for s in range(n_stages):
            df = t - s
            fwd.append(df // 2 if df >= 0 and df % 2 == 0
                       and df // 2 < n_micro else None)
            db = t - (2 * n_stages - 1 - s)
            bwd.append(db // 2 if db >= 0 and db % 2 == 0
                       and db // 2 < n_micro else None)
        events.append(TickEvent(tuple(fwd), tuple(bwd)))
    return tuple(events)


def schedule_arrays(n_stages: int, n_micro: int):
    """The schedule as (T, S) numpy tables: (fwd_mb, fwd_valid, bwd_mb,
    bwd_valid), int32 microbatch ids (idle entries 0) and bool validity
    masks."""
    events = schedule_events(n_stages, n_micro)
    t_total = len(events)
    fwd_mb = np.zeros((t_total, n_stages), np.int32)
    fwd_valid = np.zeros((t_total, n_stages), bool)
    bwd_mb = np.zeros((t_total, n_stages), np.int32)
    bwd_valid = np.zeros((t_total, n_stages), bool)
    for t, ev in enumerate(events):
        for s in range(n_stages):
            if ev.fwd[s] is not None:
                fwd_mb[t, s] = ev.fwd[s]
                fwd_valid[t, s] = True
            if ev.bwd[s] is not None:
                bwd_mb[t, s] = ev.bwd[s]
                bwd_valid[t, s] = True
    return fwd_mb, fwd_valid, bwd_mb, bwd_valid


def stash_high_water(n_stages: int, n_micro: int) -> int:
    """Most microbatches stashed at once at any stage (simulated): never
    more than S, however large M grows."""
    peak = 0
    for s in range(n_stages):
        live = set()
        for ev in schedule_events(n_stages, n_micro):
            if ev.fwd[s] is not None:
                live.add(ev.fwd[s])
                peak = max(peak, len(live))
            if ev.bwd[s] is not None:
                live.discard(ev.bwd[s])
    return peak


# ---------------------------------------------------------------------------
# Shape-only cost table and stage splitting
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Per-layer static cost row (the splitter's input)."""

    index: int
    name: str
    flops: int          # 2 × multiply-adds of the layer's convs and dots
    param_bytes: int    # trainable residency
    out_shape: Tuple[int, ...]  # batched output (microbatch leading)
    out_numel: int      # per-sample activation numel (wire payload unit)


def _conv_cost(w: torch.Tensor, stride: int, shape):
    """(flops, output shape) of a SAME conv with HWIO ``w`` on one (H, W,
    C) sample: every output takes k·k·Cin multiply-adds, the border's
    zero padding included, as XLA's conv counts them."""
    kh, kw, cin, cout = (int(d) for d in w.shape)
    h, wd, c = shape
    if c != cin:
        raise ValueError(f"conv of {cin} input channels fed {c}")
    out = (math.ceil(h / stride), math.ceil(wd / stride), cout)
    return 2 * out[0] * out[1] * cout * kh * kw * cin, out


def _pool_shape(layer, shape):
    h, wd, c = shape
    if layer.padding == "SAME":
        return (math.ceil(h / layer.stride), math.ceil(wd / layer.stride), c)
    return ((h - layer.window) // layer.stride + 1,
            (wd - layer.window) // layer.stride + 1, c)


def _cost(layer: nn.Module, shape: Tuple[int, ...]):
    """(flops, output shape) of ``layer`` on one sample of ``shape``."""
    from parallel_cnn_tpu_torch.nn import layers as L
    from parallel_cnn_tpu_torch.nn import resnet

    if isinstance(layer, L.ConvBNAct):
        return _conv_cost(layer.conv["w"], layer.stride, shape)
    if isinstance(layer, L.Conv2D):
        return _conv_cost(layer.w, layer.stride, shape)
    if isinstance(layer, L.Dense):
        d, f = (int(v) for v in layer.w.shape)
        if shape[-1] != d:
            raise ValueError(f"Dense of {d} inputs fed {shape[-1]}")
        return 2 * int(np.prod(shape[:-1])) * d * f, tuple(shape[:-1]) + (f,)
    if isinstance(layer, (resnet.BasicBlock, resnet.Bottleneck)):
        flops, out = 0, shape
        for unit in layer.main:
            f, out = _cost(unit, out)
            flops += f
        if layer.proj is not None:
            flops += _cost(layer.proj[0], shape)[0]
        return flops, out
    if isinstance(layer, (L.MaxPool, L.AvgPool)):
        return 0, _pool_shape(layer, shape)
    if isinstance(layer, L.GlobalAvgPool):
        return 0, (shape[-1],)
    if isinstance(layer, L.Flatten):
        return 0, (int(np.prod(shape)),)
    if isinstance(layer, (L.BatchNorm, L.ReLU)):
        return 0, tuple(shape)
    raise TypeError(f"no cost rule for layer {type(layer).__name__}")


def layer_costs(model: nn.Module, in_shape: Sequence[int],
                microbatch: int = 1) -> Tuple[LayerCost, ...]:
    """Per-layer flops / param bytes / output table of a Sequential model
    (JAX's ``layer_costs``), from shapes alone: JAX's
    ``measured_flops`` of each layer's forward at ``microbatch``, i.e. 2 ×
    the multiply-adds of its convs and dots (elementwise work and
    reductions are not counted)."""
    rows = []
    shape = tuple(int(d) for d in in_shape)
    for i, layer in enumerate(model):
        flops, out = _cost(layer, shape)
        rows.append(LayerCost(
            index=i,
            name=type(layer).__name__,
            flops=microbatch * flops,
            param_bytes=sum(p.numel() * p.element_size()
                            for p in layer.parameters()),
            out_shape=(microbatch,) + tuple(out),
            out_numel=int(np.prod(out)),
        ))
        shape = tuple(out)
    return tuple(rows)


def split_layers(model: nn.Module, n_stages: int, in_shape: Sequence[int],
                 microbatch: int = 1,
                 boundaries: Sequence[int] = ()) -> Tuple[int, ...]:
    """Stage-start boundaries (S−1 increasing layer indices in [1, L−1])
    for a contiguous S-way partition of the model (JAX's
    ``split_layers``).

    Automatic (no ``boundaries``): dynamic programming over contiguous
    partitions for the least maximum per-stage flops, the largest
    per-stage param bytes breaking ties. Manual: the given boundaries,
    checked against the layer count and sorted."""
    n_layers = len(model)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_stages > n_layers:
        raise ValueError(
            f"cannot split {n_layers} layers into {n_stages} stages "
            "(every stage needs at least one layer)"
        )
    if boundaries:
        b = tuple(sorted(int(x) for x in boundaries))
        if len(b) != n_stages - 1:
            raise ValueError(
                f"{len(b)} boundaries cannot make {n_stages} stages "
                f"(need {n_stages - 1})"
            )
        if len(set(b)) != len(b) or b[0] < 1 or b[-1] > n_layers - 1:
            raise ValueError(
                f"boundaries {b} must be distinct layer indices in "
                f"[1, {n_layers - 1}]"
            )
        return b
    if n_stages == 1:
        return ()

    costs = layer_costs(model, in_shape, microbatch)
    pref_f = np.concatenate([[0], np.cumsum([c.flops for c in costs])])
    pref_b = np.concatenate([[0], np.cumsum([c.param_bytes for c in costs])])

    def seg(pref, a, b):  # cost of layers [a, b)
        return int(pref[b] - pref[a])

    # best[k, j] = (max flops, max bytes, boundaries) of the first j layers
    # in k stages.
    best = {(1, j): (seg(pref_f, 0, j), seg(pref_b, 0, j), ())
            for j in range(1, n_layers + 1)}
    for k in range(2, n_stages + 1):
        for j in range(k, n_layers + 1):
            cand = None
            for i in range(k - 1, j):
                mf, mb, bs = best[(k - 1, i)]
                key = (max(mf, seg(pref_f, i, j)), max(mb, seg(pref_b, i, j)))
                if cand is None or key < cand[:2]:
                    cand = (*key, bs + (i,))
            best[(k, j)] = cand
    return best[(n_stages, n_layers)][2]


def stage_assignment(n_layers: int, boundaries: Sequence[int]) -> np.ndarray:
    """Layer-index → stage-index map (int32, length n_layers)."""
    assign = np.zeros(n_layers, np.int32)
    for b in boundaries:
        assign[b:] += 1
    return assign


# ---------------------------------------------------------------------------
# Stage-boundary wire buffers
# ---------------------------------------------------------------------------


def boundary_shapes(model: nn.Module, in_shape: Sequence[int],
                    boundaries: Sequence[int],
                    microbatch: int) -> Tuple[Tuple[int, ...], ...]:
    """Batched activation shape crossing each stage boundary: the output
    of the last layer of stages 0..S−2, at the microbatch size."""
    costs = layer_costs(model, in_shape, microbatch)
    return tuple(costs[b - 1].out_shape for b in boundaries)


def wire_numel(model: nn.Module, in_shape: Sequence[int],
               boundaries: Sequence[int], microbatch: int) -> int:
    """A_buf: the per-microbatch wire and stash width, the largest
    per-sample numel over every stage boundary and the model input (the
    first stage stashes its image microbatch in the same buffer)."""
    numels = [int(np.prod(tuple(in_shape)))]
    costs = layer_costs(model, in_shape, microbatch)
    numels += [costs[b - 1].out_numel for b in boundaries]
    return max(numels)


def pack_acts(x: torch.Tensor, a_buf: int) -> torch.Tensor:
    """Flatten a batched activation to (batch, A_buf), zero-padded."""
    flat = x.reshape(x.shape[0], -1)
    pad = a_buf - flat.shape[1]
    if pad < 0:
        raise ValueError(
            f"activation numel {flat.shape[1]} exceeds wire width {a_buf}"
        )
    if pad == 0:
        return flat
    return F.pad(flat, (0, pad))


def unpack_acts(buf: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Recover a batched activation from its packed wire buffer, as a
    contiguous tensor (the conv kernels take no strided input; a padded
    buffer's rows would otherwise stay A_buf apart)."""
    shape = tuple(shape)
    numel = int(np.prod(shape[1:]))
    return buf[:, :numel].reshape(shape).contiguous()
