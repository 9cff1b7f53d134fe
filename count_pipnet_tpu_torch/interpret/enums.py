"""Prototype label registry: hand-curated human-readable labels for
specific trained runs, used by visualization/attribution legends.

The port's copy of count_pipnet_tpu/interpret/enums.py (pure Python).

Reference: util/enums.py:1-56 — a dict keyed by run name, each value a list
of {"prototype": idx, "label": str} entries (e.g. "Circ(3)" = a prototype
firing on three circles, "Dead" = never active). The reference ships labels
for 3 of its trained runs; entries here are registered per-run by users of
this framework via :func:`register_labels` (label sets are checkpoints'
metadata, not portable across differently-seeded runs).
"""

from typing import Dict, List, Optional

__all__ = [
    "prototype_labels", "register_labels", "labels_for_run",
    "prototype_groups", "register_groups", "groups_for_run",
    "build_group_definitions", "GROUP_COLORS", "GROUP_PRIORITY",
]

# run-name -> [{"prototype": int, "label": str}, ...]
prototype_labels: Dict[str, List[dict]] = {
    # Example structure (labels are per-trained-run artifacts):
    "example_shapes_run": [
        {"prototype": 0, "label": "Circ(1)"},
        {"prototype": 1, "label": "Hex(1,2)"},
        {"prototype": 2, "label": "Dead"},
    ],
}


def register_labels(run_name: str, labels: List[dict]):
    """Register or replace the label set for a run."""
    prototype_labels[run_name] = list(labels)


def labels_for_run(run_name: str) -> Dict[int, str]:
    """Return {prototype_idx: label} for a run ('' labels by default)."""
    entries = prototype_labels.get(run_name, [])
    return {e["prototype"]: e["label"] for e in entries}


# ---------------------------------------------------------------------------
# Prototype groups (reference notebooks/main_interp.py:533-648): hand-curated
# semantic groupings of a trained run's prototypes ("count"-selective,
# "shape"-selective, mixed, unique), used by the grouped global-explanation
# view to order and color-band the prototype axis. Like labels, groups are
# per-trained-run artifacts registered by the user after inspecting the run.
# ---------------------------------------------------------------------------

# Default group palette / ordering, mirroring the reference's
# group_to_color / group_to_priority (main_interp.py:560-576).
GROUP_COLORS: Dict[str, str] = {
    "count": "#e03030",
    "shape": "#00bfff",
    "mixed": "#006400",
    "unique": "#ffcf00",
    "dead": "#909090",
}
GROUP_PRIORITY: Dict[str, int] = {
    "shape": 1, "count": 2, "mixed": 3, "unique": 4, "dead": 5,
}

# run-name -> {"group_name": [prototype indices], ...}
prototype_groups: Dict[str, Dict[str, List[int]]] = {}


def register_groups(run_name: str, groups: Dict[str, List[int]]):
    """Register or replace the prototype-group assignment for a run."""
    prototype_groups[run_name] = {k: list(v) for k, v in groups.items()}


def groups_for_run(run_name: str) -> Dict[str, List[int]]:
    return {k: list(v) for k, v in
            prototype_groups.get(run_name, {}).items()}


def build_group_definitions(
        num_prototypes: int,
        groups: Dict[str, List[int]],
        labels: Optional[Dict[int, str]] = None,
        colors: Optional[Dict[str, str]] = None,
        priority: Optional[Dict[str, int]] = None,
) -> List[dict]:
    """Per-prototype group definitions with the reference's validation
    semantics (main_interp.py:578-640): a prototype assigned to more than
    one group is an error; prototypes assigned to none fall into a "dead"
    group; every prototype gets {group_name, color, label, order_priority}.

    Unknown group names get a color from a fallback cycle and priority
    after all known groups, so user-defined group taxonomies work too.
    """
    labels = labels or {}
    colors = {**GROUP_COLORS, **(colors or {})}
    priority = {**GROUP_PRIORITY, **(priority or {})}

    index_to_group: Dict[int, str] = {}
    duplicates = []
    for name, idxs in groups.items():
        for i in idxs:
            if not (0 <= i < num_prototypes):
                raise ValueError(
                    f"group {name!r} references prototype {i} outside "
                    f"[0, {num_prototypes})")
            if i in index_to_group:
                duplicates.append(i)
            index_to_group[i] = name
    if duplicates:
        raise ValueError(
            f"prototypes assigned to multiple groups: {sorted(duplicates)}")

    fallback_cycle = ["#7a3ff0", "#0f9d58", "#f4511e", "#00897b",
                      "#c2185b", "#5d4037"]
    next_prio = max(priority.values(), default=0) + 1
    defs = []
    for i in range(num_prototypes):
        g = index_to_group.get(i, "dead")
        if g not in colors:
            colors[g] = fallback_cycle[len(colors) % len(fallback_cycle)]
        if g not in priority:
            priority[g] = next_prio
            next_prio += 1
        defs.append({
            "prototype": i,
            "group_name": g,
            "color": colors[g],
            "label": labels.get(i, "Dead" if g == "dead" else f"P{i}"),
            "order_priority": priority[g],
        })
    return defs
