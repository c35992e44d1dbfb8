"""On-card smoke test of the PyTorch/CUDA port (parallel_cnn_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds every kernel of the serving path from the sources in the
checkout, holds each kernel against its plain PyTorch version at the
shapes that path gives it, drives the port's serving stack (full-width
ResNet-18, random weights and BN statistics from a seed, restored from a
checkpoint in the JAX trainer's format) through its user-facing entry
points, checks the answers, profiles a second serving run for the
device's busy share, times each bucket on the host clock and the device,
times every kernel beside its bound, its plain version and a library
call, and prints one JSON line of kernel
records and, last, one JSON line with the device. Any failure exits
non-zero before the last line. Without a GPU, or without the package
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import faulthandler
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from parallel_cnn_tpu_torch.cli import padded_bucket_parity
from parallel_cnn_tpu_torch.config import ServeConfig
from parallel_cnn_tpu_torch.nn.layers import BatchNorm, ConvBNAct
from parallel_cnn_tpu_torch.nn.resnet import BasicBlock
from parallel_cnn_tpu_torch.ops import tap_conv
from parallel_cnn_tpu_torch.serve import get, loadgen, serve_stack
from parallel_cnn_tpu_torch.utils.backend import card_name_and_power_limit

BATCH = 64
# Published H100 SXM peaks (dense): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# One conv layer, f32, against the plain version (F.conv2d without cuDNN,
# TF32 off): the two sum K <= 4608 products in different orders, so the
# difference is bounded relative to the output's scale.
CONV_RTOL = 1e-4
# Whole-model logits after 20 such layers.
LOGIT_RTOL = 1e-3
SERVE_REQUESTS = 256
SERVE_CONCURRENCY = 16
KERNEL_MODULES = (tap_conv,)
TIME_LIMIT_S = 1100

# (name, H, Cin, Cout, k, stride, residual, relu, count in one forward):
# every distinct conv of ResNet-18 on 32x32 input, with its epilogue.
GEOMETRIES = [
    ("stem 3x3/s1 3->64", 32, 3, 64, 3, 1, False, True, 1),
    ("3x3/s1 64 head", 32, 64, 64, 3, 1, False, True, 2),
    ("3x3/s1 64 tail+res", 32, 64, 64, 3, 1, True, True, 2),
    ("3x3/s2 64->128", 32, 64, 128, 3, 2, False, True, 1),
    ("1x1/s2 64->128 proj", 32, 64, 128, 1, 2, False, False, 1),
    ("3x3/s1 128 head", 16, 128, 128, 3, 1, False, True, 1),
    ("3x3/s1 128 tail+res", 16, 128, 128, 3, 1, True, True, 2),
    ("3x3/s2 128->256", 16, 128, 256, 3, 2, False, True, 1),
    ("1x1/s2 128->256 proj", 16, 128, 256, 1, 2, False, False, 1),
    ("3x3/s1 256 head", 8, 256, 256, 3, 1, False, True, 1),
    ("3x3/s1 256 tail+res", 8, 256, 256, 3, 1, True, True, 2),
    ("3x3/s2 256->512", 8, 256, 512, 3, 2, False, True, 1),
    ("1x1/s2 256->512 proj", 8, 256, 512, 1, 2, False, False, 1),
    ("3x3/s1 512 head", 4, 512, 512, 3, 1, False, True, 1),
    ("3x3/s1 512 tail+res", 4, 512, 512, 3, 1, True, True, 2),
]
CONVS_PER_FORWARD = sum(g[-1] for g in GEOMETRIES)  # 1 + 16 + 3 = 20


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class plain_reference:
    """Context: plain PyTorch convs as a reference — cuDNN off (PyTorch's
    own im2col + f32 GEMM) and TF32 off."""

    def __enter__(self):
        self._cudnn = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False

    def __exit__(self, *exc):
        torch.backends.cudnn.enabled = self._cudnn


def geometry_inputs(h, cin, cout, k, stride, residual, gen):
    dev = "cuda"
    x = torch.randn((BATCH, h, h, cin), generator=gen, device=dev)
    w = torch.randn((k, k, cin, cout), generator=gen, device=dev)
    w *= (2.0 / (k * k * cin)) ** 0.5
    scale = torch.rand((cout,), generator=gen, device=dev) + 0.5
    shift = 0.1 * torch.randn((cout,), generator=gen, device=dev)
    oh = -(-h // stride)
    res = (torch.randn((BATCH, oh, oh, cout), generator=gen, device=dev)
           if residual else None)
    return x, w, scale, shift, res


def lines_read(size, k, stride):
    """Input rows (or columns) a SAME conv reads: all of them, unless the
    stride steps over some, as a 1x1/s2 conv skips every other one."""
    out, pad_lo, _ = tap_conv.same_pads(size, k, stride)
    return len({o * stride - pad_lo + d for o in range(out) for d in range(k)}
               & set(range(size)))


def bound_ms(x, w, stride, out_shape, residual):
    """Least time for the conv on this card: the larger of its operations
    at the f32 peak and its bytes (each input element it reads, once; each
    output once) at the HBM rate."""
    n, oh, ow, cout = out_shape
    _, h, wd, cin = x.shape
    k = w.shape[0]
    flops = 2.0 * n * oh * ow * cout * k * k * cin
    x_read = n * lines_read(h, k, stride) * lines_read(wd, k, stride) * cin
    elems = x_read + w.numel() + 2 * cout + n * oh * ow * cout
    if residual:
        elems += n * oh * ow * cout
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = 4.0 * elems / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_call(x, w, scale, shift, res, stride, relu):
    """cuDNN F.conv2d (f32, TF32 off) on channels-last tensors, padded
    outside the timing, then the epilogue as PyTorch ops: the library
    yardstick for the same function."""
    k = w.shape[0]
    h = x.shape[1]
    _, pt, pb = tap_conv.same_pads(h, k, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (pt, pb, pt, pb)).contiguous(
        memory_format=torch.channels_last)
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    sc = scale.view(1, -1, 1, 1)
    sh = shift.view(1, -1, 1, 1)
    rs = None if res is None else res.permute(0, 3, 1, 2)

    def call():
        y = torch.addcmul(sh, F.conv2d(xp, wl, stride=stride), sc)
        if rs is not None:
            y = y + rs
        return torch.relu_(y) if relu else y

    return call


def random_bn(model, seed):
    """Non-trivial BatchNorm statistics and affine parameters from the
    seed, so the served BN fold is put to the test (γ below 1 keeps the
    residual stream O(1) across the 8 blocks)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.scale.uniform_(0.2, 0.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.mean.normal_(0.0, 0.1, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
    return model


def write_jax_checkpoint(model, path):
    """The model's weights in the JAX trainer's zoo checkpoint format
    ('/'-joined params and model_state paths beside a version-1 __meta__
    blob), so the serve stack restores them as it restores a user's
    --checkpoint."""
    arrays = {}
    for key, t in model.state_dict().items():
        tree = "model_state" if key.endswith((".mean", ".var")) else "params"
        arrays[f"{tree}/{key.replace('.', '/')}"] = t.numpy()
    arrays["__meta__"] = np.frombuffer(json.dumps({"version": 1}).encode(),
                                       np.uint8)
    np.savez(path, **arrays)


def plain_forward(model, x):
    """The model's forward with every conv through the plain version of
    the tap-conv kernel and BN folded here from γ, β, mean and var (an
    independent walk of the module tree, not the kernel wrappers nor the
    layers' own fold)."""

    def cba(m, v, residual=None):
        bn = m.bn
        scale = bn.scale / torch.sqrt(bn.var + bn.eps)
        shift = bn.bias - bn.mean * scale
        return tap_conv.conv2d_fused_plain(v, m.conv["w"], scale, shift,
                                           residual, m.stride, m.relu)

    for layer in model:
        if isinstance(layer, ConvBNAct):
            x = cba(layer, x)
        elif isinstance(layer, BasicBlock):
            sc = cba(layer.proj[0], x) if layer.proj is not None else x
            x = cba(layer.main[1], cba(layer.main[0], x), sc)
        else:
            x = layer(x)
    return x


def profiled_serve(batcher) -> None:
    """Where the serving time goes: a second closed-loop run under
    torch.profiler (CUDA activity only) — device time by kernel and the
    device's busy share of the run's wall time."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report = loadgen.run(batcher, pattern="closed",
                             n_requests=SERVE_REQUESTS,
                             concurrency=SERVE_CONCURRENCY, seed=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if report.completed != SERVE_REQUESTS:
        fail(f"profiled run: {report.completed}/{SERVE_REQUESTS} completed")
    if dev_ms == 0:
        print("[smoke] profiled closed loop: device time not measured "
              "(the profiler saw no device events)", flush=True)
        return
    print(f"[smoke] profiled closed loop: {report.throughput:.1f} req/s, wall "
          f"{wall_ms:.1f} ms, device busy {dev_ms:.1f} ms "
          f"({dev_ms / wall_ms:.1%}), idle {1 - dev_ms / wall_ms:.1%}",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"[smoke]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)


def bucket_breakdown(engine, in_shape) -> None:
    """Per bucket: predict on the host clock (pad, H2D, forward, D2H,
    unpad) beside the forward's device time (CUDA events)."""
    for b in (1, 4, 16, 64):
        xs = loadgen.make_samples(b, in_shape, seed=2)
        xt = torch.from_numpy(xs).cuda()
        dev = cuda_ms(lambda: engine.forward(xt), reps=10)
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine.predict(xs)
            host.append((time.perf_counter() - t0) * 1e3)
        print(f"[smoke] bucket b{b}: predict {float(np.median(host)):.3f} ms "
              f"(host clock, median of 10), forward {dev:.3f} ms (device)",
              flush=True)


def main() -> int:
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    t_start = time.perf_counter()

    # -- 1. the card -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke needs a GPU")
    kind = torch.cuda.get_device_name(0)
    card = card_name_and_power_limit()
    if card is None:
        fail("nvidia-smi could not read the card's name and power limit")
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s); TF32 off", flush=True)

    # -- 2. build every kernel, one nvcc per source, all at once ----------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_MODULES)) as ex:
        libs = list(ex.map(lambda m: m.build(), KERNEL_MODULES))
    print(f"[smoke] built {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    for lib in libs:
        for line in lib.compiler_output.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[smoke] ptxas {lib.path.name}: {line.strip()}")

    # -- 3. kernel vs plain version at every ResNet-18 conv geometry -------
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    max_err = 0.0
    for name, h, cin, cout, k, s, res_on, relu, count in GEOMETRIES:
        x, w, scale, shift, res = geometry_inputs(h, cin, cout, k, s, res_on, gen)
        got = tap_conv.conv2d_fused(x, w, scale, shift, res, s, relu)
        with plain_reference():
            ref = tap_conv.conv2d_fused_plain(x, w, scale, shift, res, s, relu)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            fail(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        tol = CONV_RTOL * max(1.0, float(ref.abs().max()))
        ok = bool(torch.isfinite(got).all()) and err <= tol
        print(f"[smoke] conv {name:24s} b{BATCH}: max |Δ| {err:.3e} "
              f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name}: kernel disagrees with its plain version")
        max_err = max(max_err, err)
        cases.append((name, count, x, w, scale, shift, res, s, relu, got.shape))
    # conv2d (no epilogue) goes through the same kernel.
    x, w = cases[1][2], cases[1][3]
    got = tap_conv.conv2d(x, w, 1)
    with plain_reference():
        ref = tap_conv.conv2d_plain(x, w, 1)
    err = float((got - ref).abs().max())
    tol = CONV_RTOL * max(1.0, float(ref.abs().max()))
    print(f"[smoke] conv2d (no epilogue) 3x3/s1 64: max |Δ| {err:.3e} "
          f"(tol {tol:.1e}) {'ok' if err <= tol else 'FAIL'}", flush=True)
    if not err <= tol:
        fail("conv2d disagrees with its plain version")
    max_err = max(max_err, err)

    # -- 4. the main path: serve full-width ResNet-18 --------------------
    handle = get("resnet18", conv_backend="cuda")
    host = random_bn(handle.init(seed=0), seed=0)
    ckpt = tap_conv.BUILD_DIR / "smoke_resnet18.npz"
    write_jax_checkpoint(host, ckpt)
    cfg = ServeConfig(model="resnet18", checkpoint=str(ckpt), max_batch=64,
                      precompile=True)
    tap_conv.launches.reset()
    t0 = time.perf_counter()
    # seed=1: every weight served must come from the checkpoint.
    pool, batcher = serve_stack(handle, cfg, device="cuda", seed=1)
    warm_s = time.perf_counter() - t0
    with batcher:
        e0 = pool.engines[0]
        print(f"[smoke] serve_stack(resnet18, device='cuda') on {e0.device} "
              f"from {ckpt.name} (random BN stats, seed 0): buckets "
              f"{e0.buckets} warmed in {warm_s:.2f}s", flush=True)
        parity = padded_bucket_parity(e0, handle.in_shape, seed=0)
        print(f"[smoke] {parity}", flush=True)
        if "bit-identical" not in parity:
            fail("padded bucket is not bit-identical to the direct forward")
        report = loadgen.run(batcher, pattern="closed",
                             n_requests=SERVE_REQUESTS,
                             concurrency=SERVE_CONCURRENCY, seed=0)
        lat = report.latency.summary(scale=1e3)
        print(f"[smoke] closed loop: {report.completed}/{report.requests} "
              f"completed at concurrency {SERVE_CONCURRENCY}, "
              f"{report.throughput:.1f} req/s, p50 {lat.get('p50', 0):.2f} ms, "
              f"p99 {lat.get('p99', 0):.2f} ms on {card}", flush=True)
        if report.completed != SERVE_REQUESTS:
            fail(f"only {report.completed}/{SERVE_REQUESTS} requests completed")
        samples = loadgen.make_samples(32, handle.in_shape, seed=1)
        futs = [batcher.submit(s) for s in samples]
        served = np.stack([f.result(timeout=60) for f in futs])
        launches = tap_conv.launches.count
        forwards = e0.stats.warmups + e0.stats.predicts + 1  # +1: parity
        print(f"[smoke] tap_conv launches on the serve path: {launches} over "
              f"{forwards} forwards ({CONVS_PER_FORWARD} convs each)",
              flush=True)
        if launches == 0 or launches < CONVS_PER_FORWARD * forwards:
            fail("the serve path did not run every conv through the kernel")
        snap = batcher.stats.snapshot()
        if snap["submitted"] != (snap["completed"] + snap["shed"]
                                 + snap["expired"] + snap["failed"]):
            fail(f"serve conservation broken: {snap}")
        print(f"[smoke] closed loop: {snap['batches']} batches, occupancy "
              f"{snap['batch_occupancy']:.3f}, mean batch "
              f"{snap['completed'] / max(snap['batches'], 1):.2f}", flush=True)
        profiled_serve(batcher)

    if served.shape != (32, handle.n_outputs) or not np.isfinite(served).all():
        fail(f"served logits have shape {served.shape} or are not finite")
    with torch.inference_mode(), plain_reference():
        ref = plain_forward(host.cuda(), torch.from_numpy(samples).cuda())
        ref = ref.cpu().numpy()
    err = float(np.max(np.abs(served - ref)))
    tol = LOGIT_RTOL * max(1.0, float(np.max(np.abs(ref))))
    print(f"[smoke] served logits vs the written model through the plain "
          f"version on the card: "
          f"max |Δ| {err:.3e} (tol {tol:.1e}), argmax agree "
          f"{int((served.argmax(1) == ref.argmax(1)).sum())}/32", flush=True)
    if not err <= tol:
        fail("served logits disagree with the plain-version model")

    # -- 5. time every geometry: kernel, plain, library, bound -----------
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0, "ops_ms": 0.0}
    for name, count, x, w, scale, shift, res, s, relu, oshape in cases:
        ms = cuda_ms(lambda: tap_conv.conv2d_fused(x, w, scale, shift, res, s, relu))
        with plain_reference():
            plain = cuda_ms(lambda: tap_conv.conv2d_fused_plain(
                x, w, scale, shift, res, s, relu))
        lib = cuda_ms(library_call(x, w, scale, shift, res, s, relu))
        bound, by = bound_ms(x, w, s, oshape, res is not None)
        print(f"[smoke] time {name:24s} b{BATCH}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, library {lib:.4f} ms, bound {bound:.4f} ms "
              f"({by}), {bound / ms:.1%} of bound", flush=True)
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bound)):
            totals[key] += count * v
        if by == "operations":
            totals["ops_ms"] += count * bound
    bucket_breakdown(e0, handle.in_shape)
    xb = torch.from_numpy(loadgen.make_samples(BATCH, handle.in_shape)).cuda()
    fwd_ms = cuda_ms(lambda: e0.forward(xb), reps=10)
    print(f"[smoke] ResNet-18 forward b{BATCH} through the kernels: "
          f"{fwd_ms:.3f} ms ({BATCH / fwd_ms * 1e3:.0f} img/s); its "
          f"{CONVS_PER_FORWARD} convs: kernel {totals['ms']:.3f} ms, plain "
          f"{totals['plain_ms']:.3f} ms, library {totals['library_ms']:.3f} "
          f"ms, bound {totals['bound_ms']:.3f} ms (the record's times are "
          f"these sums)", flush=True)

    record = {
        "name": "tap_conv",
        "route": "cuda",
        "source": "parallel_cnn_tpu_torch/csrc/tap_conv.cu",
        "replaces": "parallel_cnn_tpu/ops/pallas_conv.py:228",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("operations" if totals["ops_ms"] >= totals["bound_ms"] / 2
                     else "bytes"),
        "library_ms": totals["library_ms"],
    }
    print(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
