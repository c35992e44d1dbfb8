"""This checkout's conv forward (B10), probe copies (B15, B16), LeNet step
kernel (B1), B9 contraction, staged conv, pool and FC forwards (B3, B4,
B5), pool backward (B7) and σ′ (B8), the fused SGD (B2) alone and
through ``tree_sgd``, the fused loss tail (B12), the probes'
one-contraction conv (B17, B19), per-filter conv (B18) and batched matmul
(B14) against another checkout's, on one card: outputs compared, times in
turns.

    python -m parallel_cnn_tpu_torch.benches.checkout_ab OTHER_CHECKOUT [tail]

With ``tail``, each side runs B12's cases alone.

``OTHER_CHECKOUT`` is an unpacked copy of another commit (``git archive``
into a directory git ignores). Each side runs in a process of its own from
its own root, through the user-facing wrappers only (``tap_conv.
conv2d_fused``, ``mosaic_probe.lane_merge`` and ``lane_split``) and its own
``chip_smoke`` helpers, building its own kernels; the sides run in turns,
other, this, this, other. Each run computes the forward at every ResNet-18
conv (``chip_smoke.GEOMETRIES``) at batch 64 and 128 on inputs made from a
seed on the host, B1 (``lenet_fused.fused_value_and_ref_grads``) at batch
64, 128 and 1000, B9 (``lenet_staged._accum_matmul``) at both of its
call sites at batch 64, B3, B4, B5, B7 and B8 (``lenet_staged.conv_fwd``,
``pool_fwd``, ``fc_fwd``, ``pool_bwd`` and ``conv_bwd_dpre``) at batch 64
and 1000, on ``chip_smoke``'s seeded LeNet inputs (the staged kernels at
the path's own, ``chip_smoke.stage_cases``; B8 at 1000 also with the L2
cold, two copies of its inputs in turns), and B2 on LeNet's params: one
``sgd_update.fused_sgd`` on the packed 2,343 values, and ``tree_sgd`` on
the fresh params and on params that are views of a bucket after a step
(device time, and host time a call); B12 (``tail.tail_forward``) in gap
and max2 mode at batch 128 on ``chip_smoke.tail_inputs``, in f32 and bf16,
and at the ImageNet head (gap 7x7x2048 -> 1,000, batch 32) in both; B17
and B19 (``mosaic_probe.mxu_conv_L`` and ``mxu_conv_3d``) and B18
(``mosaic_probe.vpu_conv``) at the probes' shapes, the odd ones
(``chip_smoke.probe_operands``) and with x one value past a 16-byte
boundary; B14 (``mosaic_probe.rank3_dot``) at the probe's and the odd
shape; and times each, the copies in turns with ``copy_``, B12 (but the
ImageNet head), B14 and B17–B19 also with the L2 cold (``chip_smoke.cold_ms``). Last, one
profiled ``--fused-step`` LeNet epoch at batch 64
(``chip_smoke.profiled_epoch``): host µs, device ops and idle share a
step. The first run of each side saves its outputs, which are
then compared: the forward, the copies, B3, B4, B7, B8, B2 and B17–B19
bit for bit, B1's, B9's, B5's and B12's within ``chip_smoke.LENET_RTOL``
and B14's within ``chip_smoke.PROBE_RTOL`` of the other side's scale (a
redesign may sum in another order), with the max |Δ| printed.
Prints one line per comparison and per time (each side's two runs
averaged). Exits non-zero where a comparison fails. Needs the card.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]
BATCHES = (64, 128)
COPY_REPS = 300
LENET_BATCHES = (64, 128, 1000)
LENET_REPS = 200
STAGED_FWD_BATCHES = (64, 1000)
STAGED_CASES = ("conv_fwd", "pool_fwd", "fc_fwd", "pool_bwd", "sigma_prime")
#: Outputs whose order a redesign may change: compared within a tolerance.
TOLERANT = ("lenet_fused", "accum_matmul", "fc_fwd", "tail_ce", "rank3_dot")


def side(out_file: str, only_tail: bool = False) -> None:
    """One run in the current checkout: outputs to ``out_file`` (when
    given) and one JSON line of times on stdout."""
    import torch

    import chip_smoke as cs
    from parallel_cnn_tpu_torch.ops import mosaic_probe, tap_conv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    outs, times = {}, {}
    if only_tail:
        tail_cases(outs, times)
        if out_file:
            torch.save(outs, out_file)
        print(json.dumps(times))
        return
    for batch in BATCHES:
        gen = torch.Generator().manual_seed(batch)
        total = 0.0
        for name, h, cin, cout, k, s, res_on, relu, count in cs.GEOMETRIES:
            oh = -(-h // s)
            x, w, scale, shift, res = (t.cuda() if t is not None else None for t in (
                torch.randn((batch, h, h, cin), generator=gen),
                torch.randn((k, k, cin, cout), generator=gen) * (2.0 / (k * k * cin)) ** 0.5,
                torch.rand((cout,), generator=gen) + 0.5,
                0.1 * torch.randn((cout,), generator=gen),
                torch.randn((batch, oh, oh, cout), generator=gen) if res_on else None))
            outs[f"b{batch} {name}"] = tap_conv.conv2d_fused(
                x, w, scale, shift, res, s, relu).cpu()
            ms = cs.cuda_ms(lambda: tap_conv.conv2d_fused(x, w, scale, shift, res, s, relu))
            times[f"forward b{batch} {name}"] = ms
            total += count * ms
        times[f"forward b{batch} {cs.CONVS_PER_FORWARD} convs"] = total
    gen = torch.Generator().manual_seed(0)
    for name, x, rows in (("lane_merge", torch.randn((25, 128, 576), generator=gen), None),
                          ("lane_split", torch.randn((1, 128 * 576), generator=gen), 128)):
        x = x.cuda()
        args = (x,) if rows is None else (x, rows)
        fn = getattr(mosaic_probe, name)
        outs[name] = fn(*args).cpu()
        view = x.view(x.shape[0] if rows is None else rows, -1)
        dst = torch.empty_like(view)
        ms, lib_ms = cs.in_turns(lambda: fn(*args), lambda: dst.copy_(view), COPY_REPS)
        times[name] = ms
        times[f"{name} copy_"] = lib_ms
    from parallel_cnn_tpu_torch.ops import lenet_fused, lenet_staged

    for n in LENET_BATCHES:
        params, xs, ys = cs.lenet_inputs(n, 100 + n)
        err, grads = lenet_fused.fused_value_and_ref_grads(params, xs, ys)
        outs[f"lenet_fused b{n}"] = torch.cat(
            [err.reshape(1)] + [g.reshape(-1) for g in cs.tree_leaves(grads)]).cpu()
        times[f"lenet_fused b{n}"] = cs.cuda_ms(
            lambda: lenet_fused.fused_value_and_ref_grads(params, xs, ys), reps=LENET_REPS)
    params, xs, ys = cs.lenet_inputs(cs.TRAIN_BATCH, 400)
    cases = cs.stage_cases(params, xs, ys)
    for site in cs.B9_SITES:
        a, b = cases[f"accum_matmul/{site}"][2]
        outs[f"accum_matmul {site} b{cs.TRAIN_BATCH}"] = lenet_staged._accum_matmul(a, b).cpu()
        times[f"accum_matmul {site} b{cs.TRAIN_BATCH}"] = cs.cuda_ms(
            lambda: lenet_staged._accum_matmul(a, b), reps=LENET_REPS)
    for n in STAGED_FWD_BATCHES:
        params, xs, ys = cs.lenet_inputs(n, 500 + n)
        cases = cs.stage_cases(params, xs, ys)
        for case in STAGED_CASES:
            fn, _, args = cases[case]
            got = fn(*args)
            outs[f"{case} b{n}"] = torch.cat(
                [o.reshape(-1) for o in (got if isinstance(got, tuple) else (got,))]).cpu()
            times[f"{case} b{n}"] = cs.cuda_ms(lambda: fn(*args), reps=LENET_REPS)
            if case == "sigma_prime" and n == max(STAGED_FWD_BATCHES):
                turn = itertools.cycle([args, tuple(a.clone() for a in args)])
                times[f"{case} b{n} L2 cold"] = cs.cuda_ms(lambda: fn(*next(turn)),
                                                           reps=LENET_REPS)
    sgd_cases(outs, times)
    tail_and_contract_cases(outs, times)
    fused_step_epoch(times)
    if out_file:
        torch.save(outs, out_file)
    print(json.dumps(times))


def sgd_cases(outs: dict, times: dict) -> None:
    """B2 on LeNet's params (chip_smoke.lenet_inputs) and grads from a
    seed: one fused_sgd on the packed values, and tree_sgd on the fresh
    params and on params that are views of a bucket after one tree_sgd."""
    import torch

    import chip_smoke as cs
    from parallel_cnn_tpu_torch.ops import sgd_update
    from parallel_cnn_tpu_torch.parallel import collectives

    params, _, _ = cs.lenet_inputs(cs.TRAIN_BATCH, 700)
    gen = torch.Generator(device="cuda").manual_seed(700)
    grads = cs.tree_map(lambda t: torch.randn(t.shape, generator=gen, device="cuda"), params)
    lr, scale = -0.1, 1.0 / cs.TRAIN_BATCH
    plan = collectives.plan_buckets(params, shards=1)
    p, g = (collectives.flatten_buckets(t, plan)[0] for t in (params, grads))
    outs["sgd_update bucket"] = sgd_update.fused_sgd(p, g, lr=lr, scale=scale).cpu()
    times["sgd_update bucket"] = cs.cuda_ms(
        lambda: sgd_update.fused_sgd(p, g, lr=lr, scale=scale), reps=LENET_REPS)
    views = sgd_update.tree_sgd(params, grads, lr=lr, scale=scale)
    for label, tree in (("fresh", params), ("views", views)):
        got = sgd_update.tree_sgd(tree, grads, lr=lr, scale=scale)
        outs[f"tree_sgd {label}"] = torch.cat([t.reshape(-1) for t in cs.tree_leaves(got)]).cpu()
        ms, call_ms = cs.time_call(lambda: sgd_update.tree_sgd(tree, grads, lr=lr, scale=scale),
                                   reps=LENET_REPS)
        times[f"tree_sgd {label}"] = ms
        times[f"tree_sgd {label} host a call"] = call_ms


def tail_cases(outs: dict, times: dict) -> None:
    """B12 in both zoo tails at batch 128 (with the L2 warm and cold) and
    at the ImageNet head at batch 32, in f32 and in bf16."""
    import torch

    import chip_smoke as cs
    from parallel_cnn_tpu_torch.ops import tail

    gen = torch.Generator(device="cuda").manual_seed(900)
    cases = [(f"tail_ce {pool} b{cs.ZOO_BATCH}", pool, cs.tail_inputs(pool, gen))
             for pool in ("gap", "max2")]
    # The ImageNet head, made here: the other side's chip_smoke may predate it.
    x = torch.relu(torch.randn((cs.IMAGENET_BATCH, 7, 7, 2048), generator=gen, device="cuda"))
    w = torch.randn((2048, 1000), generator=gen, device="cuda") * 2048 ** -0.5
    b = 0.1 * torch.randn((1000,), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (cs.IMAGENET_BATCH,), generator=gen, device="cuda")
    cases += [(f"tail_ce imagenet head b{cs.IMAGENET_BATCH}", "gap", (x, w, b, y))]
    for key, pool, args in cases:
        for dtype in (torch.float32, torch.bfloat16):
            a = tuple(t.to(dtype) if t.is_floating_point() else t for t in args)
            name = key if dtype == torch.float32 else f"{key} bf16"
            loss, dl = tail.tail_forward(*a, pool)
            outs[name] = torch.cat([loss, dl.reshape(-1)]).cpu()
            times[name] = cs.cuda_ms(lambda: tail.tail_forward(*a, pool), reps=LENET_REPS)
            if "imagenet" not in key:
                times[f"{name} L2 cold"] = cs.cold_ms(lambda: tail.tail_forward(*a, pool))


def tail_and_contract_cases(outs: dict, times: dict) -> None:
    """B12 (``tail_cases``), B17–B19 at the probes' shapes, the odd ones
    and with x one value off a 16-byte boundary, and B14 at the probe's and
    the odd shape; times with the L2 warm and cold."""
    import torch

    import chip_smoke as cs
    from parallel_cnn_tpu_torch.ops import mosaic_probe

    tail_cases(outs, times)
    gen = torch.Generator(device="cuda").manual_seed(900)
    for name in ("mxu_conv_L", "mxu_conv_3d", "vpu_conv"):
        fn = getattr(mosaic_probe, name)
        w, x = cs.probe_operands(name, True, cs.card_draw(gen))
        outs[f"{name} odd shape"] = fn(w, x).cpu()
        w, x = cs.probe_operands(name, False, cs.card_draw(gen))
        outs[f"{name} probe shape"] = fn(w, x).cpu()
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        outs[f"{name} x one value off"] = fn(w, view).cpu()
        times[name] = cs.cuda_ms(lambda: fn(w, x), reps=LENET_REPS)
        times[f"{name} L2 cold"] = cs.cold_ms(lambda: fn(w, x))
    for shape in ("odd", "probe"):
        a, b = cs.probe_operands("rank3_dot", shape == "odd", cs.card_draw(gen))
        outs[f"rank3_dot {shape} shape"] = mosaic_probe.rank3_dot(a, b).cpu()
    times["rank3_dot"] = cs.cuda_ms(lambda: mosaic_probe.rank3_dot(a, b), reps=LENET_REPS)
    times["rank3_dot L2 cold"] = cs.cold_ms(lambda: mosaic_probe.rank3_dot(a, b))


def fused_step_epoch(times: dict) -> None:
    """One profiled --fused-step epoch (after a warm one) on the trainer's
    synthetic set: host us, device ops and idle share a step, NaN where
    the profiler saw no device events."""
    import chip_smoke as cs
    from parallel_cnn_tpu_torch.config import Config, FusedStepConfig, TrainConfig
    from parallel_cnn_tpu_torch.data import pipeline, synthetic

    ds = pipeline.Dataset(*synthetic.make_dataset(cs.TRAIN_COUNT, seed=1234))
    res = cs.profiled_epoch(ds, "--fused-step", Config(
        train=TrainConfig(batch_size=cs.TRAIN_BATCH, ops="reference", shuffle=True),
        fused=FusedStepConfig())) or (float("nan"),) * 3
    for key, value in zip(("host us", "device ops", "idle share"), res):
        times[f"--fused-step epoch: {key} a step"] = value


def run_side(root: Path, out_file: str, only_tail: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--side", out_file]
                          + (["tail"] if only_tail else []),
                          cwd=root, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the run in {root} failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--side"] and len(argv) in (2, 3):
        side(argv[1], argv[2:] == ["tail"])
        return 0
    if len(argv) not in (1, 2) or argv[1:] not in ([], ["tail"]):
        print(__doc__, file=sys.stderr)
        return 2
    only_tail = argv[1:] == ["tail"]
    import torch

    from parallel_cnn_tpu_torch.utils.backend import resolve_device

    resolve_device("cuda")
    other = Path(argv[0]).resolve()
    with tempfile.TemporaryDirectory(prefix="checkout_ab_") as tmp:
        files = {"other": os.path.join(tmp, "other.pt"), "this": os.path.join(tmp, "this.pt")}
        runs = {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            root = other if label == "other" else THIS
            first = not runs[label]
            runs[label].append(run_side(root, files[label] if first else "", only_tail))
        a, b = torch.load(files["this"]), torch.load(files["other"])
    from chip_smoke import LENET_RTOL, PROBE_RTOL

    print(f"[ab] this {THIS}, other {other}; runs other, this, this, other", flush=True)
    same = ok = 0
    for key in a:
        eq = torch.equal(a[key], b[key])
        d = float((a[key] - b[key]).abs().max())
        same += eq
        if key.startswith(TOLERANT):
            rtol = PROBE_RTOL if key.startswith("rank3_dot") else LENET_RTOL
            tol = rtol * max(1.0, float(b[key].abs().max()))
            good = d <= tol
            verdict = (f"{'bit-identical' if eq else 'differs'}, max |Δ| {d:.3e} "
                       f"(tol {tol:.1e}) {'ok' if good else 'FAIL'}")
        else:
            good = eq
            verdict = f"{'bit-identical' if eq else 'DIFFERS'} (max |Δ| {d:.3e})"
        ok += good
        print(f"[ab] {key}: {verdict}", flush=True)
    print(f"[ab] {same} of {len(a)} outputs bit-identical; {ok} of {len(a)} as required "
          f"(bit for bit, or within the tolerance for {', '.join(TOLERANT)})", flush=True)
    for key in runs["this"][0]:
        t = [sum(r[key] for r in runs[label]) / 2 for label in ("this", "other")]
        unit = "" if ":" in key else " ms"  # the epoch's figures carry theirs in the key
        print(f"[ab] time {key}: this {t[0]:.5f}{unit}, other {t[1]:.5f}{unit}, this / other "
              f"{t[0] / t[1]:.3f}", flush=True)
    return 0 if ok == len(a) else 1


if __name__ == "__main__":
    sys.exit(main())
