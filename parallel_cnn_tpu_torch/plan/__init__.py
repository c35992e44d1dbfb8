"""ExecutionPlan: one declarative, serializable execution contract (the
port of ``parallel_cnn_tpu/plan/__init__.py``, same names, same texts).

Everything that decides HOW a run executes — mesh topology and axis
sizes ``(host, stage, data, model)``, the collective implementation ×
bucket × wire × overlap, the ZeRO level, pipeline stages/split, the
fused-step pieces, gradient accumulation, activation dtypes, sharding
policy, and the serve-side compile policy — lives in ONE frozen
dataclass with ONE resolution site (:func:`build_plan`), one legality
matrix (:meth:`ExecutionPlan.validate`), one place that turns it into
ranks (:meth:`ExecutionPlan.launch`: how many ranks
``parallel/distributed.py`` spawns and the mesh line) and one mesh
constructor (:meth:`ExecutionPlan.make_mesh`: this rank's mesh, the
only caller of ``parallel/mesh.py``'s constructors outside
``parallel/``), and a schema-versioned JSON round-trip (``plan.json``,
written by ``plan show --save``, loaded by ``--plan``/``PCNN_PLAN``).

JAX builds one mesh over every device in one process; the port runs one
process a rank, so JAX's ``make_mesh`` is split in two: ``launch`` (the
world and its shape, in the launching process) and ``make_mesh(rank,
world, device, cache=None)`` (in each rank, after its process group is
up), which makes JAX's decision, elastic first.

Per-knob **provenance** records where each resolved value came from —
``flag`` beats ``env`` beats ``autotune`` (a plan file) beats
``default`` — so ``plan show`` can answer "why is this run using a ring
collective" without re-deriving the config layering. Provenance is
carried on the plan but excluded from equality and from the content
fingerprint: two plans that execute identically ARE identical, however
their knobs were sourced.

The **fingerprint** (sha256 of the canonical field JSON, 16 hex chars)
is the plan's stable identity, equal to the JAX package's for the same
fields: it is stamped into checkpoint metadata (restore refuses a
mismatched file unless ``--replan``) and keys the elastic trainer's
step cache (``derive_resized`` returning an already-seen plan means the
built step is reused).

Import-light on purpose: no torch at module scope — building,
validating, serializing and diffing plans work in a process that never
touches a GPU (``plan show``, ``plan diff``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Tuple

PLAN_SCHEMA_VERSION = 1

#: Precedence order for per-knob provenance (highest first).
PROVENANCE_ORDER = ("flag", "env", "autotune", "default")


class PlanError(ValueError):
    """Base class for every typed plan failure."""


class PlanSchemaError(PlanError):
    """A plan file could not be decoded: wrong schema version, unknown
    fields, or a stored fingerprint that does not match the stored
    fields (tamper/corruption)."""


class PlanLegalityError(PlanError):
    """The knob combination is outside the legality matrix (the checks
    that used to live as ad-hoc ``cli.py`` argument guards)."""


class PlanMismatchError(PlanError):
    """A checkpoint was written under a different ExecutionPlan than the
    one live in this run.  Carries both fingerprints; pass ``--replan``
    (or go through the elastic reshard path, which recomputes sharding)
    to load it anyway."""

    def __init__(self, *, stored: str, live: str, path: str = ""):
        self.stored = stored
        self.live = live
        self.path = path
        where = f" in {path}" if path else ""
        super().__init__(
            f"checkpoint plan fingerprint {stored}{where} does not match "
            f"the live plan {live}; the file was written under a different "
            "execution contract — rerun with the original knobs, or pass "
            "--replan to re-shard it under the live plan"
        )


#: The single error text for "this mode owns the mesh axes" — the three
#: near-identical strings cli.py used to carry, now one constant.
MESH_AXES_OWNED_ERROR = (
    "{owner} builds its own {axes} mesh over all devices; "
    "drop --mesh-data/--mesh-model{extra}"
)

#: Explicit-collective path without a mesh (the old cli.py guard text).
COMM_NEEDS_MESH_ERROR = (
    "--comm-impl/PCNN_COMM_* select the explicit mesh collective path; "
    "add --mesh-data N (or --mesh-model)"
)

COMM_DATA_ONLY_ERROR = (
    "--comm-impl is data-parallel only; the explicit collective path "
    "composes with the data axis, not --mesh-model (drop one of the two)"
)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """The full execution contract, resolved and frozen.

    Field semantics (every default is the historical single-device
    GSPMD path — a default-constructed plan changes nothing):

    - ``hosts``/``stages``/``data``/``model``: the 4-axis mesh topology.
      ``data=None`` with ``model=1``, ``stages=1`` and no hierarchical
      comm means *no mesh* (:meth:`make_mesh` returns None).  For
      pipeline and hierarchical modes the mode owns the axis sizes and
      ``data`` stays None ("all remaining devices").
    - ``comm_impl``: None = compiler-inserted GSPMD psum; "psum"/"ring"/
      "hierarchical" = the explicit collective path with ``bucket_bytes``
      × ``wire_dtype`` × ``overlap``.
    - ``zero``: optimizer-state partitioning level (0, 2, 3); non-zero
      requires the fused update-on-arrival step (``fused_update``).
    - ``fused``/``fused_update``/``fused_tail``/``act_dtype``: the
      fused-step pieces (``fused`` = a FusedStepConfig exists).
    - ``accum``: gradient-accumulation microbatch count.
    - ``split``/``pipe_wire_dtype``/``pipe_act_dtype``: pipeline stage
      boundaries and wire/compute dtypes (meaningful when stages > 1).
    - ``param_sharding``/``opt_sharding``: per-leaf sharding policy the
      trainer applies ("replicated", "model" = filter/channel sharding
      over the model axis, "zero3" = resident shard rows over data).
      The per-leaf layout derives from these policies
      (parallel/zoo_sharding.py, zoo.init_zero3_state).
    - ``precompile``/``aot_cache``: the serve-side compile policy —
      build every bucket eagerly, and (in JAX; ROADMAP A12b here)
      persist executables on disk keyed by this plan's fingerprint.
    - ``elastic``: True on plans produced by :func:`derive_resized` —
      the mesh is built over the surviving-device prefix
      (``make_elastic_mesh``) instead of the full device set.
    """

    hosts: Optional[int] = None
    stages: int = 1
    data: Optional[int] = None
    model: int = 1
    comm_impl: Optional[str] = None
    bucket_bytes: int = 4 * 1024 * 1024
    wire_dtype: str = "float32"
    overlap: bool = True
    zero: int = 0
    fused: bool = False
    fused_update: bool = False
    fused_tail: bool = True
    act_dtype: str = "float32"
    accum: int = 1
    # pipelined=True with stages=1 is the DEGENERATE pipeline (a real
    # (stage=1, data) mesh + the 1F1B machinery delegating to the flat
    # ring step, bit-exact by construction) — distinct from the default
    # non-pipelined stages=1.
    pipelined: bool = False
    split: str = ""
    pipe_wire_dtype: str = "float32"
    pipe_act_dtype: str = "float32"
    param_sharding: str = "replicated"
    opt_sharding: str = "replicated"
    precompile: bool = False
    aot_cache: bool = False
    elastic: bool = False
    provenance: Tuple[Tuple[str, str], ...] = dataclasses.field(
        default=(), compare=False
    )

    # -- identity --------------------------------------------------------

    def fields(self) -> Dict[str, Any]:
        """Identity fields as a plain dict (provenance excluded)."""
        d = dataclasses.asdict(self)
        d.pop("provenance")
        return d

    def fingerprint(self) -> str:
        """Stable 16-hex-char content hash of the identity fields.

        Line of trust: everything downstream that must never silently
        cross plans — checkpoint restore, the elastic step cache —
        compares THIS string."""
        blob = json.dumps(self.fields(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def __hash__(self) -> int:  # frozen dataclass + unhashable-safe use
        return hash(self.fingerprint())

    def provenance_of(self, field_name: str) -> str:
        for name, source in self.provenance:
            if name == field_name:
                return source
        return "default"

    # -- serialization ---------------------------------------------------

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "version": PLAN_SCHEMA_VERSION,
            "fingerprint": self.fingerprint(),
            "plan": self.fields(),
            "provenance": dict(self.provenance),
        }

    def to_json(self) -> str:
        """Byte-stable JSON: sorted keys, fixed indent, trailing newline
        — save(load(s)) reproduces s exactly."""
        return json.dumps(self.to_json_dict(), sort_keys=True, indent=2) + "\n"

    @classmethod
    def from_json_dict(cls, doc: Dict[str, Any]) -> "ExecutionPlan":
        version = doc.get("version")
        if version != PLAN_SCHEMA_VERSION:
            raise PlanSchemaError(
                f"plan schema version {version!r} is not the supported "
                f"version {PLAN_SCHEMA_VERSION}; regenerate the file with "
                "this build's `tune --report` (or `plan show --save`)"
            )
        raw = doc.get("plan")
        if not isinstance(raw, dict):
            raise PlanSchemaError("plan file has no 'plan' object")
        known = {f.name for f in dataclasses.fields(cls)} - {"provenance"}
        unknown = sorted(set(raw) - known)
        if unknown:
            raise PlanSchemaError(
                f"plan file carries unknown field(s) {unknown} — written "
                "by a newer build? (schema version is "
                f"{PLAN_SCHEMA_VERSION} either way; refusing to guess)"
            )
        prov = doc.get("provenance", {})
        if not isinstance(prov, dict):
            raise PlanSchemaError("plan 'provenance' must be an object")
        plan = cls(**raw, provenance=tuple(sorted(prov.items())))
        stored = doc.get("fingerprint")
        if stored is not None and stored != plan.fingerprint():
            raise PlanSchemaError(
                f"stored fingerprint {stored} does not match the stored "
                f"fields (recomputed {plan.fingerprint()}) — the file was "
                "hand-edited or torn; regenerate it"
            )
        return plan

    # -- mesh ------------------------------------------------------------

    def launch(self, device=None) -> Tuple[int, Dict[str, int]]:
        """(ranks to spawn, JAX's ``dict(mesh.shape)``) for this plan on
        ``device``: the (stage, data) pipeline mesh or the (host, data)
        hierarchical mesh over every card, or the (data, model) mesh
        (``data=None``: every card the model axis leaves); on the CPU
        the gloo worlds of ``parallel/distributed.py``. ``(1, {})`` is
        the single-device run (no mesh). Reads the card count, so it
        runs in the launching process, not in ``plan show``."""
        from parallel_cnn_tpu_torch.config import MeshConfig
        from parallel_cnn_tpu_torch.parallel import distributed

        if self.pipelined or self.stages > 1:
            s, d = distributed.resolve_pipeline_shape(self.stages, device)
            return s * d, {"stage": s, "data": d}
        if self.comm_impl == "hierarchical":
            h, d = distributed.resolve_hier_shape(self.hosts, device)
            return h * d, {"host": h, "data": d}
        if self.data is None and self.model == 1:
            return 1, {}
        n_data, n_model = distributed.resolve_shape(
            MeshConfig(data=self.data, model=self.model), device)
        return n_data * n_model, {"data": n_data, "model": n_model}

    def make_mesh(self, rank: int, world: int, device, cache=None):
        """This rank's view of THE mesh this plan describes over
        ``world`` ranks, or None for the single-device path. JAX's
        decision (plan/__init__.py ``make_mesh``), elastic first: an
        elastic plan's mesh over the first ``world()`` ranks of the
        spawned world (``cache``: the controller's per-topology views),
        the pipeline mesh, the hierarchical mesh, then the flat mesh —
        a ``DataMesh`` for the explicit collectives (data axis only), a
        ``Mesh2D`` for the GSPMD path. Every rank calls it after
        ``init_process_group`` (it makes the axis groups)."""
        from parallel_cnn_tpu_torch.parallel import mesh as mesh_lib

        if self.elastic:
            return mesh_lib.make_elastic_mesh(
                self.world(), n_hosts=self.hosts or 1, device=device,
                cache=cache)
        if self.pipelined or self.stages > 1:
            return mesh_lib.make_pipeline_mesh(rank, world, device,
                                               self.stages)
        if self.comm_impl == "hierarchical":
            return mesh_lib.make_hier_mesh(rank, world, device,
                                           self.hosts or 1)
        if self.data is not None or self.model > 1:
            if self.comm_impl is not None:
                return mesh_lib.DataMesh(world=world, rank=rank,
                                         device=device)
            return mesh_lib.make_mesh_2d(rank, world, device,
                                         world // self.model, self.model)
        return None

    def world(self) -> int:
        """Device count the plan claims, when its axes pin one (elastic
        derived plans always do)."""
        if self.data is None:
            raise PlanError("plan does not pin a world size (data=None)")
        return (self.hosts or 1) * self.data * max(self.stages, 1) \
            * max(self.model, 1)

    # -- legality --------------------------------------------------------

    def validate(self) -> "ExecutionPlan":
        """The legality matrix, with typed errors.  These checks used to
        live as argument guards in cli.py; every consumer (CLI, plan
        files, tune hand-off, elastic derivation) now passes through the
        same matrix.  Returns self so call sites can chain."""
        if self.comm_impl not in (None, "psum", "ring", "hierarchical"):
            raise PlanLegalityError(
                f"unknown comm impl {self.comm_impl!r} "
                "(psum, ring, or hierarchical)"
            )
        explicit_axes = self.data is not None or self.model > 1
        if self.pipelined or self.stages > 1:
            if explicit_axes and not self.elastic:
                raise PlanLegalityError(MESH_AXES_OWNED_ERROR.format(
                    owner="--pipeline-stages", axes="(stage, data)",
                    extra="",
                ))
            if self.comm_impl == "hierarchical":
                raise PlanLegalityError(
                    "pipeline gradients reduce over the flat data axis; "
                    "use --comm-impl ring (not hierarchical)"
                )
            if self.zero == 3 and self.stages > 1:
                raise PlanLegalityError(
                    "pipeline composes with ZeRO-2 only: ZeRO-3's "
                    "just-in-time head gathers contradict per-stage param "
                    "residency (docs/pipeline.md)"
                )
        elif self.comm_impl == "hierarchical":
            if explicit_axes and not self.elastic:
                raise PlanLegalityError(MESH_AXES_OWNED_ERROR.format(
                    owner="--comm-impl hierarchical", axes="(host, device)",
                    extra=" (size the host axis with --comm-hosts)",
                ))
            if self.hosts is not None and self.hosts < 2 and not self.elastic:
                raise PlanLegalityError(
                    f"hierarchical comm needs a host axis of >= 2 "
                    f"(got hosts={self.hosts}); use --comm-impl ring on "
                    "a single host"
                )
        if self.comm_impl is not None and not self.elastic:
            mesh_present = (explicit_axes or self.pipelined
                            or self.stages > 1
                            or self.comm_impl == "hierarchical")
            if not mesh_present:
                raise PlanLegalityError(COMM_NEEDS_MESH_ERROR)
            if self.model > 1:
                raise PlanLegalityError(COMM_DATA_ONLY_ERROR)
        if self.zero not in (0, 2, 3):
            raise PlanLegalityError(f"zero level {self.zero} not in (0, 2, 3)")
        if self.zero > 0 and not self.fused_update:
            raise PlanLegalityError(
                f"zero={self.zero} shards optimizer state into the fused "
                "update-on-arrival collective schedule; it requires the "
                "fused step (fused ⟺ zero>0)"
            )
        if self.fused_update and self.zero not in (2, 3):
            raise PlanLegalityError(
                "fused update-on-arrival partitions optimizer state; "
                f"zero must be 2 or 3 (got {self.zero})"
            )
        if self.zero == 2 and self.comm_impl != "ring":
            raise PlanLegalityError(
                "ZeRO-2 update-on-arrival rides the flat ring; use "
                "--comm-impl ring (or zero=3 on a hierarchical mesh)"
            )
        if self.zero == 3 and self.comm_impl not in ("ring", "hierarchical"):
            raise PlanLegalityError(
                "ZeRO-3 needs the explicit ring or hierarchical collective "
                "path (--comm-impl ring|hierarchical)"
            )
        if self.fused_update and not self.fused:
            raise PlanLegalityError("fused_update implies fused")
        if self.accum < 1:
            raise PlanLegalityError(f"accum must be >= 1, got {self.accum}")
        if self.param_sharding not in ("replicated", "model", "zero3"):
            raise PlanLegalityError(
                f"unknown param sharding policy {self.param_sharding!r}"
            )
        if self.param_sharding == "model" and self.model <= 1:
            raise PlanLegalityError(
                "param_sharding='model' needs a model axis > 1"
            )
        return self

    # -- config views ----------------------------------------------------

    def comm_config(self):
        """The CommConfig this plan implies, or None (GSPMD path)."""
        if self.comm_impl is None:
            return None
        from parallel_cnn_tpu_torch.config import CommConfig

        return CommConfig(
            impl=self.comm_impl, bucket_bytes=self.bucket_bytes,
            wire_dtype=self.wire_dtype, overlap=self.overlap,
            hosts=self.hosts,
        )

    def fused_config(self):
        """The FusedStepConfig this plan implies, or None."""
        if not self.fused:
            return None
        from parallel_cnn_tpu_torch.config import FusedStepConfig

        return FusedStepConfig(
            update=self.fused_update, tail=self.fused_tail,
            act_dtype=self.act_dtype,
            zero=self.zero if self.zero in (2, 3) else 2,
        )

    def pipeline_config(self):
        """The PipelineConfig this plan implies, or None."""
        if not self.pipelined and self.stages <= 1:
            return None
        from parallel_cnn_tpu_torch.config import PipelineConfig

        return PipelineConfig(
            stages=self.stages, split=self.split,
            wire_dtype=self.pipe_wire_dtype, act_dtype=self.pipe_act_dtype,
        )

    # -- cost-table mapping ----------------------------------------------

    def cost_table_key(self) -> Tuple[str, Optional[str]]:
        """(cost-table entry, closed-form collective kind) this plan's
        step is ratcheted under in the JAX package's cost baseline (the
        same strings; ``plan show`` prints them, the checker that reads
        them is ROADMAP A13c). The kind is None when the plan has no
        explicit collective (psum/GSPMD: nothing to count against a
        closed form).
        """
        if self.stages > 1:
            return (f"train.pipeline_step.pipe{self.stages}_ring",
                    "pipeline_ring")
        if self.zero == 3:
            if self.comm_impl == "hierarchical":
                return ("zoo.zero3_step.hier_bf16", "zero3_hier")
            return ("zoo.zero3_step.ring_bf16", "zero3_ring")
        if self.zero == 2:
            return ("zoo.fused_step.ring_bf16", "zero2_ring")
        if self.comm_impl == "hierarchical":
            return ("zoo.comm_step.hier_bf16",
                    "hier_overlap" if self.overlap else "hier_post")
        if self.comm_impl == "ring":
            return ("zoo.comm_step.ring_bf16",
                    "ring_overlap" if self.overlap else "ring_post")
        return ("plan.resolved", None)


# ---------------------------------------------------------------------------
# Resolution: Config (+argparse namespace) -> ExecutionPlan with provenance
# ---------------------------------------------------------------------------

#: plan field -> (argparse attribute, env var) for provenance labeling.
#: None means "no flag/env source exists for this knob".
_KNOB_SOURCES: Dict[str, Tuple[Optional[str], Optional[str]]] = {
    "hosts": ("comm_hosts", "PCNN_COMM_HOSTS"),
    "stages": ("pipeline_stages", "PCNN_PIPELINE_STAGES"),
    "data": ("mesh_data", None),
    "model": ("mesh_model", None),
    "comm_impl": ("comm_impl", "PCNN_COMM_IMPL"),
    "bucket_bytes": ("comm_bucket_mb", "PCNN_COMM_BUCKET_BYTES"),
    "wire_dtype": ("comm_wire_dtype", "PCNN_COMM_WIRE_DTYPE"),
    "overlap": (None, "PCNN_COMM_OVERLAP"),
    "zero": (None, "PCNN_ZERO_LEVEL"),
    "fused": ("fused_step", "PCNN_FUSED_STEP"),
    "fused_update": ("fused_step", "PCNN_FUSED_STEP"),
    "act_dtype": ("act_dtype", "PCNN_ACT_DTYPE"),
    "accum": ("accum_steps", None),
    "pipelined": ("pipeline_stages", "PCNN_PIPELINE_STAGES"),
    "split": ("pipeline_split", "PCNN_PIPELINE_SPLIT"),
    "pipe_wire_dtype": ("pipeline_wire_dtype", "PCNN_PIPELINE_WIRE_DTYPE"),
    "pipe_act_dtype": ("pipeline_act_dtype", "PCNN_PIPELINE_ACT_DTYPE"),
    "precompile": ("no_precompile", "PCNN_SERVE_PRECOMPILE"),
    "aot_cache": ("aot_cache_dir", "PCNN_SERVE_AOT_CACHE_DIR"),
}

def _provenance(
    field_name: str, args, present_env: frozenset, autotune_filled
) -> str:
    """flag > env > autotune > default, per knob.

    The autotune check runs first NOT because autotune outranks flags —
    cli.config_from_args records a knob in ``_autotune_filled`` only
    when neither a flag nor an env var pinned it (and then writes the
    tuned value back onto ``args``, which would otherwise read as a
    flag here); membership is therefore proof the higher layers passed.
    """
    if field_name in autotune_filled:
        return "autotune"
    flag_attr, env_var = _KNOB_SOURCES.get(field_name, (None, None))
    flag_val = getattr(args, flag_attr, None) if flag_attr and args else None
    # store_true flags default to False, value flags to None — either
    # sentinel means "not passed on the command line".
    if flag_val is not None and flag_val is not False:
        return "flag"
    if env_var is not None and env_var in present_env:
        return "env"
    return "default"


def build_plan(config, args=None, *, autotune_filled=()) -> "ExecutionPlan":
    """THE resolution site: a layered Config (flags already applied over
    env over autotune over defaults by ``cli.config_from_args``) becomes
    one ExecutionPlan, with per-knob provenance labels.

    ``args`` is the argparse namespace (None for programmatic callers —
    provenance then degrades to env/autotune/default).
    ``autotune_filled`` names the knobs the autotune block filled in
    (cli records them; a knob is labeled "autotune" only when neither a
    flag nor an env var pinned it).
    """
    from parallel_cnn_tpu_torch import config as config_mod

    comm = getattr(config, "comm", None)
    fused = getattr(config, "fused", None)
    pipeline = getattr(config, "pipeline", None)
    mesh_cfg = getattr(config, "mesh", None)
    serve = getattr(config, "serve", None)
    net = getattr(config, "net", None)

    values: Dict[str, Any] = {}
    if comm is not None:
        values.update(
            comm_impl=comm.impl, bucket_bytes=comm.bucket_bytes,
            wire_dtype=comm.wire_dtype, overlap=comm.overlap,
            hosts=comm.hosts,
        )
    if fused is not None:
        values.update(
            fused=True, fused_update=fused.update, fused_tail=fused.tail,
            act_dtype=fused.act_dtype,
            zero=fused.zero if fused.update else 0,
        )
    if pipeline is not None:
        values.update(
            pipelined=True,
            stages=pipeline.stages, split=pipeline.split,
            pipe_wire_dtype=pipeline.wire_dtype,
            pipe_act_dtype=pipeline.act_dtype,
        )
    if mesh_cfg is not None:
        values.update(data=mesh_cfg.data, model=mesh_cfg.model)
    if args is not None and getattr(args, "accum_steps", None):
        values["accum"] = args.accum_steps
    if serve is not None:
        values["precompile"] = serve.precompile
    if net is not None:
        values["aot_cache"] = net.aot_cache_dir is not None
    # Sharding policy follows the partitioning mode deterministically.
    if values.get("zero", 0) == 3:
        values["param_sharding"] = "zero3"
        values["opt_sharding"] = "zero3"
    elif values.get("model", 1) > 1:
        values["param_sharding"] = "model"
        values["opt_sharding"] = "model"
    elif values.get("zero", 0) == 2:
        values["opt_sharding"] = "zero3"  # ZeRO-2: opt shards, params full

    present_env = config_mod.present_plan_env()
    filled = frozenset(autotune_filled) | frozenset(
        getattr(args, "_autotune_filled", ()) if args is not None else ()
    )
    prov = tuple(sorted(
        (name, _provenance(name, args, present_env, filled))
        for name in values
    ))
    return ExecutionPlan(**values, provenance=prov)


def serve_plan(serve_cfg, net_cfg=None, *,
               cache_dir: Optional[str] = None) -> "ExecutionPlan":
    """The serving front door's plan: eval sharding is single-device
    replicated, so only the compile/AOT policy varies. In JAX its
    fingerprint folds into the engines' on-disk AOT-executable cache
    key; the port has no such cache yet (ROADMAP A12b), so nothing
    calls it here."""
    return ExecutionPlan(
        precompile=bool(getattr(serve_cfg, "precompile", False)),
        aot_cache=bool(
            cache_dir
            or (net_cfg is not None
                and getattr(net_cfg, "aot_cache_dir", None))
        ),
        provenance=(("aot_cache", "flag"), ("precompile", "flag")),
    )


# ---------------------------------------------------------------------------
# Elastic derivation
# ---------------------------------------------------------------------------

def derive_resized(
    plan: ExecutionPlan, new_world: int, *, n_hosts: Optional[int] = None
) -> ExecutionPlan:
    """The plan an elastic resize lands on: same contract, new topology.

    Mirrors ``mesh.make_elastic_mesh``'s topology decision exactly —
    hierarchical while the host axis still divides the new world, flat
    ring otherwise — so the derived plan's fields stay truthful about
    the mesh :meth:`ExecutionPlan.make_mesh` will build.  Deriving is
    pure and deterministic: resizing back to an already-seen world
    yields an EQUAL plan (same fingerprint), which is what gates the
    trainer's recompile-once step cache.
    """
    if new_world < 1:
        raise PlanLegalityError(f"world must be >= 1, got {new_world}")
    if n_hosts is None:
        h = plan.hosts or 1
        n_hosts = h if h > 1 and new_world % h == 0 else 1
    if n_hosts > 1 and new_world % n_hosts != 0:
        raise PlanLegalityError(
            f"elastic world {new_world} is not divisible by "
            f"n_hosts {n_hosts}"
        )
    hier = n_hosts > 1
    prov = dict(plan.provenance)
    for name in ("hosts", "data", "comm_impl"):
        prov[name] = "elastic"
    return dataclasses.replace(
        plan,
        hosts=n_hosts if hier else None,
        data=new_world // n_hosts,
        comm_impl="hierarchical" if hier else "ring",
        elastic=True,
        provenance=tuple(sorted(prov.items())),
    )


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def save_plan(path, plan: ExecutionPlan) -> None:
    with open(path, "w") as f:
        f.write(plan.to_json())


def load_plan(path) -> ExecutionPlan:
    """Load a plan file: a bare plan document (``plan show --save``, or
    JAX's) or a ``tune --report`` artifact that embeds one under
    "plan". A report without an embedded plan converts its chosen
    autotune plan (analysis/autotune.py), as JAX's does."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise PlanError(f"cannot read plan file {path}: {e}") from e
    except ValueError as e:
        raise PlanSchemaError(f"plan file {path} is not JSON: {e}") from e
    if not isinstance(doc, dict):
        raise PlanSchemaError(f"plan file {path} is not a JSON object")
    inner = doc.get("plan")
    if isinstance(inner, dict) and "plan" in inner and "version" in inner:
        # A `tune --report` artifact embedding a full plan document
        # under "plan" (a bare plan doc's "plan" is the flat field map).
        return ExecutionPlan.from_json_dict(inner)
    if inner is not None or "autotune" not in doc:
        return ExecutionPlan.from_json_dict(doc)
    # tune --report artifact without an embedded plan: convert the
    # chosen autotune plan (older reports; `tune` now embeds "plan").
    from parallel_cnn_tpu_torch.analysis import autotune as autotune_lib

    chosen, section = autotune_lib.load_chosen_plan(path)
    return chosen.to_execution_plan(
        n_host=int(section.get("n_host", 1) or 1),
        n_dev=int(section.get("n_dev", 0) or 0) or None,
    )


# ---------------------------------------------------------------------------
# Rendering: `plan show` / `plan diff`
# ---------------------------------------------------------------------------

def format_plan(plan: ExecutionPlan, *, title: str = "") -> str:
    """The resolved plan, one knob per line with provenance."""
    lines = []
    if title:
        lines.append(title)
    lines.append(f"fingerprint: {plan.fingerprint()}  "
                 f"(schema v{PLAN_SCHEMA_VERSION})")
    entry, kind = plan.cost_table_key()
    lines.append(f"cost table:  {entry}"
                 + (f"  [{kind}]" if kind else ""))
    width = max(len(f.name) for f in dataclasses.fields(ExecutionPlan))
    for name, value in sorted(plan.fields().items()):
        src = plan.provenance_of(name)
        lines.append(f"  {name:<{width}}  {value!r:<12}  [{src}]")
    return "\n".join(lines)


def diff_plans(a: ExecutionPlan, b: ExecutionPlan) -> str:
    """Field-by-field diff; empty string when the plans are equal."""
    fa, fb = a.fields(), b.fields()
    lines = []
    for name in sorted(fa):
        if fa[name] != fb[name]:
            lines.append(
                f"  {name}: {fa[name]!r} [{a.provenance_of(name)}] -> "
                f"{fb[name]!r} [{b.provenance_of(name)}]"
            )
    if not lines:
        return ""
    header = (f"plans differ ({a.fingerprint()} -> {b.fingerprint()}), "
              f"{len(lines)} field(s):")
    return "\n".join([header] + lines)
