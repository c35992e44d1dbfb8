"""Per-phase layer profiling (the port of
``parallel_cnn_tpu/utils/profiling.py``; ≙ the reference's per-phase
accumulators and the paper's Tables 4-8: conv / pooling / fully-connected
/ gradient times).

The reference times each phase with host clock() inside forward_pass /
back_pass (Sequential/Main.cpp:80-102,113-141) and, in its CUDA backend,
forgets to synchronize, timing kernel *launches*. Here each phase is
timed on the card between two CUDA events around ``repeats`` calls,
after a warm-up call and a synchronize, so the numbers are device time
(on the host, ``--device cpu``, the host clock around the same calls).

Phases mirror the reference decomposition, over the plain reference ops
(``ops/reference.py``) whatever ``--ops`` trained the params:
    conv  ≙ fp_c1 + sigmoid           (Sequential/Main.cpp:80-85)
    pool  ≙ fp_s1 + sigmoid           (:87-93)
    fc    ≙ fp_preact_f/bias + sigmoid (:95-101)
    grad  ≙ the whole back_pass        (:107-144)

``trace(log_dir, steps)`` records a torch.profiler trace of ``steps``
steps after a warm-up step and writes it as a Chrome trace,
``<log_dir>/trace.json``.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Callable, Dict

import torch

from parallel_cnn_tpu_torch.ops import reference as ops
from parallel_cnn_tpu_torch.ops.activations import sigmoid

TRACE_FILE = "trace.json"


def conv_phase(x: torch.Tensor, p: ops.Params) -> torch.Tensor:
    return sigmoid(ops.conv_c1_forward(x, p["c1"]["w"], p["c1"]["b"]))


def pool_phase(out_c1: torch.Tensor, p: ops.Params) -> torch.Tensor:
    return sigmoid(ops.pool_s1_forward(out_c1, p["s1"]["w"], p["s1"]["b"]))


def fc_phase(out_s1: torch.Tensor, p: ops.Params) -> torch.Tensor:
    flat = out_s1.reshape(out_s1.shape[0], -1)
    return sigmoid(flat @ p["f"]["w"].T + p["f"]["b"])


def forward_phase(x: torch.Tensor, p: ops.Params) -> torch.Tensor:
    return ops.forward(p, x).out_f


def grad_phase(x: torch.Tensor, p: ops.Params, y: torch.Tensor) -> ops.Params:
    """The batch-mean reference grads (per-sample grads, then the mean)."""
    _, grads = ops.value_and_ref_grads(p, x, y)
    return {k: {n: g.mean(dim=0) for n, g in v.items()} for k, v in grads.items()}


def _time_fn(fn: Callable, *args, repeats: int = 10) -> float:
    """Mean seconds a call of fn(*args): one warm-up call and a
    synchronize, then ``repeats`` calls between two CUDA events (on the
    host: the host clock around them)."""
    repeats = max(repeats, 1)
    fn(*args)
    if args[0].is_cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn(*args)
    return max(time.perf_counter() - t0, 1e-12) / repeats


def profile_phases(params: ops.Params, xs: torch.Tensor, ys: torch.Tensor,
                   repeats: int = 10) -> Dict[str, float]:
    """Per-phase mean seconds for a batch (the paper's table
    decomposition), on the device ``xs`` lives on.

    Returns {"conv", "pool", "fc", "grad", "total_forward"}.
    """
    with torch.no_grad():
        out_c1 = conv_phase(xs, params)
        out_s1 = pool_phase(out_c1, params)
        return {
            "conv": _time_fn(conv_phase, xs, params, repeats=repeats),
            "pool": _time_fn(pool_phase, out_c1, params, repeats=repeats),
            "fc": _time_fn(fc_phase, out_s1, params, repeats=repeats),
            "grad": _time_fn(grad_phase, xs, params, ys, repeats=repeats),
            "total_forward": _time_fn(forward_phase, xs, params, repeats=repeats),
        }


def report(phase_seconds: Dict[str, float], n_images: int) -> str:
    """Render the paper-style per-layer table (≙ PDF Table 4 shape)."""
    lines = [f"{'phase':<14}{'ms/batch':>12}{'images/sec':>14}"]
    for name, sec in phase_seconds.items():
        ips = n_images / sec if sec > 0 else float("inf")
        lines.append(f"{name:<14}{sec * 1e3:>12.3f}{ips:>14.0f}")
    return "\n".join(lines)


@contextmanager
def trace(log_dir: str, steps: int, warmup: int = 1):
    """torch.profiler over ``warmup + steps`` steps (the CPU, and the card
    when there is one), the last ``steps`` written as a Chrome trace to
    ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto).
    The port's ``xla_trace``. Yields ``mark``: call it after each step.
    The warm-up steps run with the profiler already tracing and are left
    out, so the traced steps lose no launch to the tracer's start; on the
    card ``mark`` waits for the step's kernels, so the last step's are
    all recorded."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=warmup, active=steps, repeat=1),
                 on_trace_ready=lambda prof: prof.export_chrome_trace(path)) as prof:

        def mark():
            if cuda:
                torch.cuda.synchronize()
            prof.step()

        yield mark
