"""Cost-model-driven plan autotuner (the port of
``parallel_cnn_tpu/analysis/autotune.py``: the same plan space, closed
forms, ranking, report section and texts).

It enumerates the legal parallelization-plan space, scores every
candidate against the analytic roofline of a named hardware profile
(``analysis/hw_profiles.py``), drops candidates that bust the peak-HBM
budget, and emits a deterministically ranked table plus the chosen plan
into ``cost_report.json``.

    python -m parallel_cnn_tpu_torch tune --devices N   # rank + persist
    python -m parallel_cnn_tpu_torch --autotune ...     # train on the winner

Scoring:

    t_compute = flops/step / shards / peak_flops  [× (M+S−1)/M bubble]
    t_comm    = bytes_ici/ici_bw + hops_ici·ici_hop
              + bytes_dcn/dcn_bw + hops_dcn·dcn_hop
    t_step    = max(t_compute, t_comm)  if the schedule overlaps,
                t_compute + t_comm      otherwise
    img/s     = global_batch / t_step,  subject to peak_hbm ≤ budget

The byte counts are the JAX package's closed forms for its collectives
(the same ring schedules parallel/collectives.py runs). A flat
(non-hierarchical) ring that spans hosts is charged entirely at NIC
speed — the slowest link gates every hop round — which is why the
hierarchical impl wins multi-host rankings.

Import-light on purpose: torch is only imported inside
:func:`profile_module`'s caller's model (a meta-device model reads
shapes only), so the CLI can consult a saved plan without touching a GPU.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from parallel_cnn_tpu_torch.analysis import hw_profiles
from parallel_cnn_tpu_torch.analysis.hw_profiles import HwProfile

WIRE_ITEMSIZE = {"float32": 4, "bfloat16": 2}

_MIB = 1024 * 1024


class NoFeasiblePlan(ValueError):
    """Every legal plan busts the HBM budget (or the space is empty)."""


class BudgetExceeded(ValueError):
    """A specific plan's predicted peak HBM exceeds the budget — raised
    by :func:`assert_within_budget` BEFORE any tracing happens, so an
    over-budget mutant plan is rejected by the tuner, never traced."""


# ---------------------------------------------------------------------------
# The plan space
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """One point in the parallelization-plan space — exactly the knobs a
    train run hand-sets today (CommConfig + FusedStepConfig +
    PipelineConfig + accum factor)."""

    comm_impl: str = "ring"        # psum | ring | hierarchical
    bucket_bytes: int = 4 * _MIB   # 0 = n/a (psum's monolithic all-reduce)
    wire_dtype: str = "bfloat16"   # float32 | bfloat16 (gradient wire)
    overlap: bool = True
    zero: int = 0                  # 0 | 2 | 3 (optimizer-state sharding)
    accum: int = 2                 # gradient-accumulation microbatches
    stages: int = 1                # 1 | 2 | 4 pipeline stages
    fused: bool = False            # fused update/tail (ZeRO rides this)

    def key(self) -> Tuple:
        """Deterministic total order — the ranking tie-break."""
        return (self.stages, self.zero, self.comm_impl, self.accum,
                self.wire_dtype, -self.bucket_bytes, not self.overlap,
                self.fused)

    def label(self) -> str:
        bits = [self.comm_impl]
        if self.bucket_bytes:
            bits.append(f"{self.bucket_bytes // _MIB or 1}mb")
        bits.append("bf16" if self.wire_dtype == "bfloat16" else "f32")
        if self.overlap:
            bits.append("ovl")
        if self.zero:
            bits.append(f"z{self.zero}")
        bits.append(f"k{self.accum}")
        if self.stages > 1:
            bits.append(f"s{self.stages}")
        return "-".join(bits)

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "Plan":
        fields = {f.name for f in dataclasses.fields(Plan)}
        return Plan(**{k: v for k, v in d.items() if k in fields})

    def flags(self, n_host: int = 1) -> List[str]:
        """The train-CLI flags this plan maps to (informational — the
        ``--autotune`` path applies the plan programmatically)."""
        out = ["--comm-impl", self.comm_impl]
        if self.bucket_bytes:
            out += ["--comm-bucket-mb", str(max(1, self.bucket_bytes // _MIB))]
        out += ["--comm-wire-dtype", self.wire_dtype,
                "--accum-steps", str(self.accum)]
        if self.comm_impl == "hierarchical":
            out += ["--comm-hosts", str(n_host)]
        if self.zero:
            out += ["--fused-step"]
        if self.stages > 1:
            out += ["--pipeline-stages", str(self.stages)]
        return out

    def to_execution_plan(self, n_host: int = 1, n_dev: Optional[int] = None):
        """The full :class:`plan.ExecutionPlan` this search point denotes
        — autotune's Plan is a thin VIEW over the execution contract, so
        tune → train is a lossless artifact hand-off.  Field expansion
        matches :func:`plan_to_configs` exactly (the ``--autotune`` and
        ``--plan`` train paths must resolve identical configs)."""
        from parallel_cnn_tpu_torch import plan as plan_lib

        fused = self.zero > 0
        hier = self.comm_impl == "hierarchical"
        values = dict(
            comm_impl=self.comm_impl,
            bucket_bytes=self.bucket_bytes or 4 * _MIB,
            wire_dtype=self.wire_dtype,
            overlap=self.overlap or fused,
            hosts=n_host if hier else None,
            zero=self.zero,
            fused=fused,
            fused_update=fused,
            act_dtype="bfloat16" if fused else "float32",
            accum=self.accum,
            pipelined=self.stages > 1,
            stages=self.stages,
        )
        if n_dev and self.stages == 1 and not hier:
            values["data"] = n_dev
        if self.zero == 3:
            values["param_sharding"] = "zero3"
            values["opt_sharding"] = "zero3"
        elif self.zero == 2:
            values["opt_sharding"] = "zero3"
        return plan_lib.ExecutionPlan(
            **values,
            provenance=tuple(sorted((k, "autotune") for k in values)),
        )

    @staticmethod
    def from_execution_plan(eplan) -> "Plan":
        """Project an ExecutionPlan back onto the search-space view
        (canonical form — the don't-care axes collapse the same way
        :func:`_canonical` collapses them)."""
        return _canonical(Plan(
            comm_impl=eplan.comm_impl or "psum",
            bucket_bytes=eplan.bucket_bytes,
            wire_dtype=eplan.wire_dtype,
            overlap=eplan.overlap,
            zero=eplan.zero,
            accum=eplan.accum,
            stages=eplan.stages,
            fused=eplan.zero > 0,
        ))


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """The enumerated axes.  Accum factors start at 2 — every overlap
    schedule's closed form assumes ≥ 2 microbatches (K reduce-scatters
    and one all-gather a step)."""

    comm_impls: Tuple[str, ...] = ("psum", "ring", "hierarchical")
    bucket_bytes: Tuple[int, ...] = (1 * _MIB, 4 * _MIB)
    wire_dtypes: Tuple[str, ...] = ("float32", "bfloat16")
    overlaps: Tuple[bool, ...] = (False, True)
    zeros: Tuple[int, ...] = (0, 2, 3)
    accums: Tuple[int, ...] = (2, 4, 8)
    stages: Tuple[int, ...] = (1, 2, 4)
    fuseds: Tuple[bool, ...] = (False, True)


DEFAULT_SPACE = SearchSpace()


def _canonical(p: Plan) -> Plan:
    """Collapse don't-care axes so equivalent points dedupe: psum has no
    bucket/wire/overlap choice, ZeRO schedules are inherently fused +
    overlapped, pipeline grads ride an unfused post-loop ring."""
    if p.comm_impl == "psum":
        p = dataclasses.replace(p, bucket_bytes=0, wire_dtype="float32",
                                overlap=False, zero=0, fused=False)
    if p.stages > 1:
        p = dataclasses.replace(p, comm_impl="ring", zero=0, fused=False,
                                overlap=False)
    if p.zero:
        p = dataclasses.replace(p, overlap=True, fused=True)
    return p


def _legal(p: Plan, *, n_dev: int, n_host: int, global_batch: int) -> bool:
    total_dev = n_dev * n_host
    if p.comm_impl == "hierarchical" and n_host < 2:
        return False
    if p.zero == 2 and p.comm_impl != "ring":
        return False
    if p.zero == 3 and p.comm_impl not in ("ring", "hierarchical"):
        return False
    if p.fused != (p.zero > 0):
        return False
    if p.stages > 1:
        if p.comm_impl != "ring" or total_dev % p.stages:
            return False
        if p.accum < p.stages:  # M ≥ S keeps the 1F1B bubble bounded
            return False
    shards = total_dev // p.stages
    if global_batch % (shards * p.accum):
        return False
    return global_batch // (shards * p.accum) >= 1


def enumerate_plans(space: SearchSpace = DEFAULT_SPACE, *,
                    n_dev: int, n_host: int = 1,
                    global_batch: int) -> Iterator[Plan]:
    """Every legal canonical plan, in deterministic product order."""
    seen = set()
    for impl, bucket, wire, ovl, zero, accum, stages, fused in \
            itertools.product(space.comm_impls, space.bucket_bytes,
                              space.wire_dtypes, space.overlaps,
                              space.zeros, space.accums, space.stages,
                              space.fuseds):
        p = _canonical(Plan(comm_impl=impl, bucket_bytes=bucket,
                            wire_dtype=wire, overlap=ovl, zero=zero,
                            accum=accum, stages=stages, fused=fused))
        if p in seen:
            continue
        seen.add(p)
        if _legal(p, n_dev=n_dev, n_host=n_host, global_batch=global_batch):
            yield p


# ---------------------------------------------------------------------------
# The model profile (what the candidate plans are scored FOR)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Static per-model numbers the scorer consumes — all derived from
    shape-only traces (nothing executes)."""

    name: str
    param_elems: int          # Σ trainable leaf numel
    param_bytes: int          # f32 trainable residency
    mstate_bytes: int         # non-trainable (BN stats etc.) residency
    flops_per_image: int      # fwd+bwd contraction flops (bwd ≈ 2×fwd)
    act_bytes_per_image: int  # f32 activation high-water mark, 1 image
    wire_numel: int           # max per-sample boundary numel (pipe A_buf)
    layer_fwd_flops: Tuple[int, ...]


def profile_module(model, in_shape: Sequence[int],
                   name: str = "model") -> ModelProfile:
    """Build a :class:`ModelProfile` from a ``Sequential`` from shapes
    alone (the model may live on the meta device): the parameter and
    buffer bytes, and the per-layer table of ``parallel/pipeline.py``'s
    ``layer_costs`` over the same top-level layers the JAX package walks.
    The activation high-water mark is JAX's ``_activation_hwm`` at one
    image: the largest (input + output) numel of any top-level layer, in
    f32. Backward flops are approximated as 2× forward — exact ratios
    don't matter for ranking, only consistency across candidates."""
    import numpy as np

    from parallel_cnn_tpu_torch.parallel import pipeline as pipe_lib

    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    rows = pipe_lib.layer_costs(model, in_shape, 1)
    fwd = sum(r.flops for r in rows)
    in_numel = int(np.prod(tuple(in_shape)))
    wire = max([in_numel] + [r.out_numel for r in rows[:-1]])
    outs = [r.out_numel for r in rows]
    hwm = max(a + b for a, b in zip([in_numel] + outs[:-1], outs))
    return ModelProfile(
        name=name,
        param_elems=param_bytes // 4,
        param_bytes=param_bytes,
        mstate_bytes=sum(b.numel() * b.element_size()
                         for b in model.buffers()),
        flops_per_image=3 * fwd,
        act_bytes_per_image=hwm * 4,
        wire_numel=wire,
        layer_fwd_flops=tuple(r.flops for r in rows),
    )


# ---------------------------------------------------------------------------
# Scoring: the closed forms against the roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Score:
    plan: Plan
    img_s: float
    t_compute_s: float
    t_comm_s: float
    bytes_ici: int
    bytes_dcn: int
    peak_hbm: int

    def to_json(self) -> Dict:
        return {
            "plan": self.plan.to_json(),
            "label": self.plan.label(),
            "img_s": round(self.img_s, 1),
            "t_compute_s": self.t_compute_s,
            "t_comm_s": self.t_comm_s,
            "bytes_ici": self.bytes_ici,
            "bytes_dcn": self.bytes_dcn,
            "peak_hbm": self.peak_hbm,
        }


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _geometry(p: Plan, n_dev: int, n_host: int):
    """(d, h, dcn_gated): ring width, host-ring width, and whether a flat
    ring spans hosts (→ every hop round gated by the slowest, DCN, link).
    """
    total = n_dev * n_host
    if p.comm_impl == "hierarchical":
        return n_dev // p.stages, n_host, False
    return total // p.stages, 1, n_host > 1


def _compute_time(p: Plan, mp: ModelProfile, hw: HwProfile, *,
                  global_batch: int, n_dev: int, n_host: int) -> float:
    """Roofline compute term — also the prune lower bound on t_step."""
    total_dev = n_dev * n_host
    t = (mp.flops_per_image * global_batch / total_dev) / hw.peak_flops
    if p.stages > 1:
        # 1F1B: 2(M+S−1) ticks to do 2M ticks of useful work per device.
        t *= (p.accum + p.stages - 1) / p.accum
    return t


def _comm_terms(p: Plan, mp: ModelProfile, hw: HwProfile, *,
                global_batch: int, n_dev: int, n_host: int):
    """(bytes_ici, bytes_dcn, t_comm) per device per step, from the same
    JAX package's closed forms for each ring schedule)."""
    d, h, dcn_gated = _geometry(p, n_dev, n_host)
    k, w, s = p.accum, WIRE_ITEMSIZE[p.wire_dtype], p.stages
    shards = d * h
    e = _round_up(-(-mp.param_elems // s), shards)  # padded ring elems
    dev_pass = (d - 1) * (e // d)
    host_pass = (h - 1) * (e // shards)
    n_buckets = (1 if p.comm_impl == "psum" or not p.bucket_bytes
                 else max(1, -(-e * w // p.bucket_bytes)))

    if p.comm_impl == "psum":
        ici = 2 * dev_pass * 4  # monolithic post-accum all-reduce, f32
        dcn = 0
        hops_i, hops_d = 2 * (d - 1), 0
    elif s > 1:
        micro = global_batch // (shards * k)
        ticks = 2 * (k + s - 1)
        payload = micro * mp.wire_numel * w
        ici = 2 * dev_pass * w + 2 * ticks * payload
        dcn = 0
        hops_i, hops_d = 2 * n_buckets * (d - 1) + 2 * ticks, 0
    elif p.zero:
        ici = k * dev_pass * w + dev_pass * 4  # K RS (wire) + 1 AG (f32)
        dcn = k * host_pass * w + host_pass * 4 if h > 1 else 0
        hops_i = (k + 1) * n_buckets * (d - 1)
        hops_d = (k + 1) * n_buckets * (h - 1)
    else:
        passes = (k + 1) if p.overlap else 2
        ici = passes * dev_pass * w
        dcn = passes * host_pass * w if h > 1 else 0
        hops_i = passes * n_buckets * (d - 1)
        hops_d = passes * n_buckets * (h - 1)

    if dcn_gated:
        # Flat ring spanning hosts: every hop round waits on the slowest
        # (DCN) link — the whole volume moves at NIC speed.
        dcn, ici = ici, 0
        hops_d, hops_i = hops_i, 0
    t = (ici / hw.ici_bytes_per_s + hops_i * hw.ici_hop_s
         + dcn / hw.dcn_bytes_per_s + hops_d * hw.dcn_hop_s)
    return ici, dcn, t


def plan_peak_hbm(p: Plan, mp: ModelProfile, *, global_batch: int,
                  n_dev: int, n_host: int = 1) -> int:
    """Predicted peak resident bytes per device — the same accounting
    shape as cost_model.peak_hbm_bytes, from the profile instead of a
    traced EntrySpec."""
    d, h, _ = _geometry(p, n_dev, n_host)
    shards = d * h
    s = p.stages
    e = _round_up(-(-mp.param_elems // s), shards)
    micro = global_batch // (shards * p.accum)
    act_itemsize = 2 if p.fused else 4
    act = mp.act_bytes_per_image * micro * act_itemsize // 4

    params = mp.param_bytes // s
    momentum = mp.param_bytes // s  # SGD+momentum mirror
    if p.zero == 0:
        resident = params + momentum + mp.mstate_bytes
    elif p.zero == 2:
        resident = params + momentum // shards + mp.mstate_bytes
    else:  # zero == 3
        resident = (params + momentum) // shards + mp.mstate_bytes
    transient = 0
    if p.zero == 3:  # head gather materializes one f32 bucket at a time
        n_buckets = (1 if not p.bucket_bytes else
                     max(1, -(-e * WIRE_ITEMSIZE[p.wire_dtype]
                              // p.bucket_bytes)))
        transient = e * 4 // n_buckets

    if s > 1:
        grad_accum = e * 4  # full per-stage tree (stage psum adds zeros)
        stash = s * micro * mp.wire_numel * 4
        return resident + act + grad_accum + stash
    return resident + act + e * 4 // shards + transient


def score_plan(p: Plan, mp: ModelProfile, hw: HwProfile, *,
               global_batch: int, n_dev: int, n_host: int = 1) -> Score:
    t_comp = _compute_time(p, mp, hw, global_batch=global_batch,
                           n_dev=n_dev, n_host=n_host)
    ici, dcn, t_comm = _comm_terms(p, mp, hw, global_batch=global_batch,
                                   n_dev=n_dev, n_host=n_host)
    overlapped = p.zero > 0 or (p.overlap and p.stages == 1
                                and p.comm_impl != "psum")
    t = max(t_comp, t_comm) if overlapped else t_comp + t_comm
    return Score(
        plan=p,
        img_s=global_batch / t if t > 0 else float("inf"),
        t_compute_s=t_comp,
        t_comm_s=t_comm,
        bytes_ici=ici,
        bytes_dcn=dcn,
        peak_hbm=plan_peak_hbm(p, mp, global_batch=global_batch,
                               n_dev=n_dev, n_host=n_host),
    )


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SearchResult:
    ranked: Tuple[Score, ...]      # top_k, best first
    chosen: Score                  # ranked[0]
    n_enumerated: int
    n_feasible: int
    excluded_hbm: Tuple[Tuple[Plan, int], ...]
    hbm_budget: int
    global_batch: int
    n_dev: int
    n_host: int
    hw_profile: str
    model: str


def search(mp: ModelProfile, *, hw: Optional[HwProfile] = None,
           space: SearchSpace = DEFAULT_SPACE, global_batch: int,
           n_dev: int, n_host: int = 1, hbm_budget: Optional[int] = None,
           top_k: int = 8, prune: bool = True) -> SearchResult:
    """Rank the legal plan space; returns the top_k table, best first.

    ``prune=True`` skips full scoring for candidates whose compute-only
    lower bound already caps their img/s below the current k-th best —
    an admissible bound (t_step ≥ t_compute in both overlap modes), so
    the pruned top-k is PROVABLY identical to the brute-force one
    (tests/test_torch_autotune.py pins the equality).  Ranking is fully
    deterministic: descending img/s, then Plan.key().
    """
    hw = hw or hw_profiles.active_profile()
    budget = hbm_budget if hbm_budget is not None else hw.hbm_bytes
    scored: List[Score] = []
    excluded: List[Tuple[Plan, int]] = []
    kth_best = -1.0
    n_enum = 0
    for p in enumerate_plans(space, n_dev=n_dev, n_host=n_host,
                             global_batch=global_batch):
        n_enum += 1
        peak = plan_peak_hbm(p, mp, global_batch=global_batch,
                             n_dev=n_dev, n_host=n_host)
        if peak > budget:
            excluded.append((p, peak))
            continue
        if prune and len(scored) >= top_k:
            t_lb = _compute_time(p, mp, hw, global_batch=global_batch,
                                 n_dev=n_dev, n_host=n_host)
            if t_lb > 0 and global_batch / t_lb < kth_best:
                continue
        scored.append(score_plan(p, mp, hw, global_batch=global_batch,
                                 n_dev=n_dev, n_host=n_host))
        scored.sort(key=lambda sc: (-sc.img_s, sc.plan.key()))
        if len(scored) >= top_k:
            kth_best = scored[min(top_k, len(scored)) - 1].img_s
    if not scored:
        raise NoFeasiblePlan(
            f"no legal plan fits the {budget} B HBM budget on "
            f"{n_dev}x{n_host} devices at global batch {global_batch} "
            f"({n_enum} enumerated, {len(excluded)} over budget)"
        )
    ranked = tuple(scored[:top_k])
    return SearchResult(
        ranked=ranked, chosen=ranked[0], n_enumerated=n_enum,
        n_feasible=n_enum - len(excluded), excluded_hbm=tuple(excluded),
        hbm_budget=budget, global_batch=global_batch, n_dev=n_dev,
        n_host=n_host, hw_profile=hw.name, model=mp.name,
    )


def assert_within_budget(p: Plan, mp: ModelProfile, *, global_batch: int,
                         n_dev: int, n_host: int = 1,
                         hbm_budget: Optional[int] = None,
                         hw: Optional[HwProfile] = None) -> int:
    """The tuner's hard gate on a single plan — raises
    :class:`BudgetExceeded` when predicted peak HBM busts the budget.
    Call it BEFORE building any step, so an over-budget plan is
    rejected, never run."""
    hw = hw or hw_profiles.active_profile()
    budget = hbm_budget if hbm_budget is not None else hw.hbm_bytes
    peak = plan_peak_hbm(p, mp, global_batch=global_batch, n_dev=n_dev,
                         n_host=n_host)
    if peak > budget:
        raise BudgetExceeded(
            f"plan {p.label()} predicts peak HBM {peak} B > budget "
            f"{budget} B ({hw.name}); the tuner refuses it — nothing "
            "gets traced for a plan that cannot fit"
        )
    return peak


# ---------------------------------------------------------------------------
# Ranking validation (the bench gate's pure core)
# ---------------------------------------------------------------------------

def pairwise_agreement(predicted: Sequence[float],
                       measured: Sequence[float], *,
                       min_ratio: float = 1.10) -> Tuple[int, int]:
    """(agreeing, total) over candidate pairs the MODEL separates by at
    least ``min_ratio`` — pairs the model calls a near-tie don't vote,
    because timing noise can't adjudicate them."""
    if len(predicted) != len(measured):
        raise ValueError("predicted/measured length mismatch")
    agree = total = 0
    for i, j in itertools.combinations(range(len(predicted)), 2):
        hi, lo = (i, j) if predicted[i] >= predicted[j] else (j, i)
        if predicted[lo] <= 0 or predicted[hi] < min_ratio * predicted[lo]:
            continue
        total += 1
        if measured[hi] > measured[lo]:
            agree += 1
    return agree, total


def order_gate(predicted: Sequence[float], measured: Sequence[float], *,
               min_ratio: float = 1.10,
               threshold: float = 0.75) -> Tuple[bool, str]:
    """The pairwise-order check: the measured ordering must agree with
    the model on ≥ ``threshold`` of the model-separated pairs. Returns
    (ok, human summary). A doctored table that inverts the model's
    ranking fails this by construction (benches/mesh_tune.py prints
    both)."""
    agree, total = pairwise_agreement(predicted, measured,
                                      min_ratio=min_ratio)
    frac = 1.0 if total == 0 else agree / total
    ok = frac >= threshold
    return ok, (f"{agree}/{total} separated pairs agree "
                f"(ratio>={min_ratio:.2f}, threshold={threshold:.2f})")


# ---------------------------------------------------------------------------
# Report persistence (the cost_report.json "autotune" section)
# ---------------------------------------------------------------------------

def build_section(result: SearchResult) -> Dict:
    return {
        "model": result.model,
        "hw_profile": result.hw_profile,
        "global_batch": result.global_batch,
        "n_dev": result.n_dev,
        "n_host": result.n_host,
        "hbm_budget_bytes": result.hbm_budget,
        "n_enumerated": result.n_enumerated,
        "n_feasible": result.n_feasible,
        "n_excluded_hbm": len(result.excluded_hbm),
        "chosen": {
            **result.chosen.to_json(),
            "flags": result.chosen.plan.flags(result.n_host),
        },
        "ranked": [sc.to_json() for sc in result.ranked],
    }


def write_section(path, section: Dict) -> Path:
    """Merge the autotune section into the cost report, preserving the
    accountant's traced entries; a version-mismatched report is rejected
    (CostSchemaError), never silently rewritten.  ``path=None`` resolves
    to the shipped report (cost_model.DEFAULT_COST_REPORT), mirroring
    load_chosen_plan.  Returns the resolved path."""
    from parallel_cnn_tpu_torch.analysis import cost_model

    path = Path(path or cost_model.DEFAULT_COST_REPORT)
    rows: Dict = {}
    if path.exists():
        rows = cost_model.load_cost_report(path).get("entries", {})
    cost_model.write_cost_report(path, rows, autotune=section)
    return path


def load_chosen_plan(path=None) -> Tuple[Plan, Dict]:
    """(chosen Plan, full autotune section) from a cost report — the
    ``--autotune`` train path consumes this.
    Schema-version mismatches and missing sections fail loudly."""
    from parallel_cnn_tpu_torch.analysis import cost_model

    path = Path(path or cost_model.DEFAULT_COST_REPORT)
    if not path.exists():
        raise NoFeasiblePlan(
            f"{path}: no cost report — run `python -m "
            "parallel_cnn_tpu_torch tune` first"
        )
    data = cost_model.load_cost_report(path)
    section = data.get("autotune")
    if not section or "chosen" not in section:
        raise NoFeasiblePlan(
            f"{path.name}: no autotune section — run `python -m "
            "parallel_cnn_tpu_torch tune` to rank the plan space first"
        )
    return Plan.from_json(section["chosen"]["plan"]), section


def plan_to_configs(p: Plan, n_host: int = 1):
    """(CommConfig, Optional[FusedStepConfig], Optional[PipelineConfig],
    accum) — the Config pieces the chosen plan expands into; explicit
    env/flags still override field-by-field (cli.config_from_args)."""
    from parallel_cnn_tpu_torch import config as config_lib

    comm = config_lib.CommConfig(
        impl=p.comm_impl,
        bucket_bytes=p.bucket_bytes or config_lib.CommConfig().bucket_bytes,
        wire_dtype=p.wire_dtype,
        overlap=p.overlap or p.zero > 0,
        hosts=n_host if p.comm_impl == "hierarchical" else None,
    )
    fused = (config_lib.FusedStepConfig(zero=p.zero) if p.zero else None)
    pipe = (config_lib.PipelineConfig(stages=p.stages)
            if p.stages > 1 else None)
    return comm, fused, pipe, p.accum


def format_table(result: SearchResult) -> str:
    """The human-readable ranked table the `tune` subcommand prints."""
    lines = [
        f"autotune: model={result.model} hw={result.hw_profile} "
        f"batch={result.global_batch} devices={result.n_dev}x"
        f"{result.n_host} budget={result.hbm_budget // _MIB} MiB",
        f"  {result.n_enumerated} legal plans, {result.n_feasible} within "
        f"budget, {len(result.excluded_hbm)} excluded (HBM)",
        f"  {'#':>2} {'plan':<28} {'img/s':>12} {'t_comp_ms':>10} "
        f"{'t_comm_ms':>10} {'hbm_MiB':>8}",
    ]
    for i, sc in enumerate(result.ranked):
        mark = " *" if i == 0 else f"{i + 1:>2}"
        lines.append(
            f"  {mark} {sc.plan.label():<28} {sc.img_s:>12.1f} "
            f"{sc.t_compute_s * 1e3:>10.3f} {sc.t_comm_s * 1e3:>10.3f} "
            f"{sc.peak_hbm / _MIB:>8.1f}"
        )
    lines.append(
        "  chosen: " + " ".join(result.chosen.plan.flags(result.n_host))
    )
    return "\n".join(lines)
