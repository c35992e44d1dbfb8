"""The cost report's file format (the report I/O of
``parallel_cnn_tpu/analysis/cost_model.py``: the same schema version,
error type, texts and JSON layout, so a report either package writes
loads in the other).

``analysis/cost_report.json`` holds a schema ``version``, the roofline
``constants`` of the active hardware profile, the accountant's traced
``entries`` and the autotuner's ``autotune`` section (``tune`` writes it;
``--autotune`` reads the chosen plan from it). The traced entries and the
ratchet against them are the ``check --cost`` family, which the port does
not have yet (ROADMAP A13c): the port keeps whatever entries a report
carries and writes none of its own.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

from parallel_cnn_tpu_torch.analysis import hw_profiles

_ANALYSIS_DIR = Path(__file__).resolve().parent
DEFAULT_COST_REPORT = _ANALYSIS_DIR / "cost_report.json"

COST_SCHEMA_VERSION = 1


class CostSchemaError(ValueError):
    """A cost artifact (baseline/report) carries the wrong schema version
    — refuse to compare keys that may mean something else."""


def _check_schema_version(data: Dict, path: Path) -> None:
    got = data.get("version")
    if got != COST_SCHEMA_VERSION:
        raise CostSchemaError(
            f"{Path(path).name}: schema version {got!r} != "
            f"{COST_SCHEMA_VERSION}; stale artifact — regenerate it "
            "(check --cost --update-cost-baseline, or `tune` for the "
            "autotune section) instead of silently comparing wrong keys"
        )


def load_cost_report(path: Path) -> Dict:
    """The full cost report payload, schema-version checked (the
    ``--autotune`` consumer goes through this)."""
    data = json.loads(Path(path).read_text())
    _check_schema_version(data, path)
    return data


def write_cost_report(path: Path, rows: Dict[str, Dict],
                      autotune: Optional[Dict] = None) -> None:
    """Write the report; an existing version-valid report's ``autotune``
    section is carried over unless a fresh one is passed in. The
    ``constants`` are the ACTIVE profile's (``PCNN_HW_PROFILE``), not the
    profile a ``tune --hw`` scored against, exactly as the JAX package
    stamps them, so both packages write the same report."""
    path = Path(path)
    if autotune is None and path.exists():
        try:
            prev = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            prev = {}
        if prev.get("version") == COST_SCHEMA_VERSION:
            autotune = prev.get("autotune")
    hw = hw_profiles.active_profile()
    payload = {
        "version": COST_SCHEMA_VERSION,
        "constants": {
            "hw_profile": hw.name,
            "peak_flops": hw.peak_flops,
            "ici_bytes_per_s": hw.ici_bytes_per_s,
            "dcn_bytes_per_s": hw.dcn_bytes_per_s,
        },
        "entries": rows,
    }
    if autotune is not None:
        payload["autotune"] = autotune
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
