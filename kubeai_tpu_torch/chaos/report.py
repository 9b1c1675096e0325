"""The campaign document's schema (port of kubeai_tpu/chaos/report.py):
``validate_chaos_doc`` returns its problems, none when it is valid.
"""

from __future__ import annotations

REQUIRED_KEYS = (
    "bench", "schema_version", "seed", "episodes", "replicas",
    "requests_per_episode", "site_coverage", "subsystems_covered",
    "sites_fired", "invariants", "violations", "degradation",
    "duration_s",
)

INVARIANT_KEYS = (
    "stream_shape", "conservation", "tokens", "recovery", "incident",
)


def validate_chaos_doc(doc: dict, *, min_episodes: int = 1,
                       min_sites: int = 0, min_subsystems: int = 0,
                       require_clean: bool = False) -> list[str]:
    """Structural + coverage validation. The coverage floors are the
    campaign acceptance knobs (the soak requires >=4 fired sites across
    >=3 subsystems; the fast tier-1 variant only requires shape)."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["CHAOS doc is not an object"]
    for k in REQUIRED_KEYS:
        if k not in doc:
            problems.append(f"missing key: {k}")
    if problems:
        return problems
    if doc["bench"] != "chaos":
        problems.append(f"bench must be 'chaos', got {doc['bench']!r}")
    if doc["schema_version"] != 1:
        problems.append(f"unknown schema_version {doc['schema_version']!r}")
    if not isinstance(doc["episodes"], int) or doc["episodes"] < min_episodes:
        problems.append(
            f"episodes={doc['episodes']!r}, need an int >= {min_episodes}"
        )
    cov = doc["site_coverage"]
    if not isinstance(cov, dict):
        problems.append("site_coverage must be an object")
    else:
        for site, ent in cov.items():
            for field in ("subsystem", "episodes_armed", "fired"):
                if field not in ent:
                    problems.append(f"site_coverage[{site}] missing {field}")
    fired = doc["sites_fired"]
    if not isinstance(fired, list):
        problems.append("sites_fired must be a list")
    elif len(fired) < min_sites:
        problems.append(
            f"only {len(fired)} fault site(s) fired ({fired}); need >= {min_sites}"
        )
    subs = doc["subsystems_covered"]
    if not isinstance(subs, list):
        problems.append("subsystems_covered must be a list")
    elif len(subs) < min_subsystems:
        problems.append(
            f"only {len(subs)} subsystem(s) covered ({subs}); need >= {min_subsystems}"
        )
    inv = doc["invariants"]
    if not isinstance(inv, dict):
        problems.append("invariants must be an object")
    else:
        for k in INVARIANT_KEYS:
            if k not in inv or "violations" not in inv.get(k, {}):
                problems.append(f"invariants.{k}.violations missing")
    if not isinstance(doc["violations"], list):
        problems.append("violations must be a list")
    elif require_clean and doc["violations"]:
        problems.append(
            f"campaign not clean: {len(doc['violations'])} violating episode(s)"
        )
    for v in doc["violations"] if isinstance(doc["violations"], list) else []:
        for field in ("episode", "seed", "violations", "schedule",
                      "reduced_schedule", "replay"):
            if field not in v:
                problems.append(f"violation entry missing {field}")
    return problems
