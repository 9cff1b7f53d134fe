"""Global-explanation analysis for trained runs.

The port's copy of notebooks/main_interp.py (reference
notebooks/main_interp.py): loads trained runs, computes the global
explanation (the virtual class x prototype weight matrix,
calculate_global_explanation :345) and renders class<->prototype
visualizations (show_global_explanation :390,648). Rebuilt on
matplotlib, which is imported where a figure is drawn. The weights are
read on the CPU: nothing here runs a forward.

Usage:
    python -m count_pipnet_tpu_torch.notebooks.main_interp \
        --run_dir ./runs/<run> \
        [--out global_explanation.png]
"""

import argparse
import os


def calculate_global_explanation(run_dir, checkpoint="net_best"):
    """[num_classes, num_prototypes] virtual weight matrix + metadata.

    Count-PIPNet: |intermediate attribution| x classifier weights
    (reference notebooks/main_interp.py:345); PIP-Net: raw classifier
    weights.
    """
    from ..interpret.interpret_idg import load_model_for_interpretation
    from ..models.pipnet import CountPIPNet, importance_per_class

    model, args = load_model_for_interpretation(run_dir, checkpoint, "cpu")
    if isinstance(model, CountPIPNet):
        weights = importance_per_class(model).cpu().numpy()
    else:
        weights = model.classification.weight.detach().cpu().numpy()
    return {
        "weights": weights,
        "num_classes": weights.shape[0],
        "num_prototypes": weights.shape[1],
        "args": args,
        "run_dir": run_dir,
    }


def show_global_explanation(explanation, out_path, threshold=1e-3,
                            class_names=None, prototype_labels=None,
                            group_defs=None):
    """Class x prototype heatmap + per-class relevant-prototype listing
    (reference notebooks/main_interp.py:390,648). With ``group_defs``
    (per-prototype dicts from
    count_pipnet_tpu_torch.interpret.enums.build_group_definitions)
    the
    prototype axis is ordered by group priority, tick labels take the
    group colors, and a colored group band runs above the heatmap —
    the reference's grouped figure (main_interp.py:648-880)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    w = explanation["weights"]
    C, P = w.shape
    order = list(range(P))
    if group_defs:
        order.sort(key=lambda p: (group_defs[p]["order_priority"], p))
        w = w[:, order]
    fig, ax = plt.subplots(figsize=(max(6, P * 0.35), max(4, C * 0.3)))
    im = ax.imshow(w, aspect="auto", cmap="magma")
    ax.set_xlabel("Prototype")
    ax.set_ylabel("Class")
    ax.set_xticks(range(P))
    if group_defs:
        labels = [group_defs[p]["label"] for p in order]
    else:
        labels = [
            (prototype_labels or {}).get(p, f"P{p}") for p in range(P)]
    ax.set_xticklabels(labels, rotation=90, fontsize=7)
    if group_defs:
        for j, p in enumerate(order):
            ax.get_xticklabels()[j].set_color(group_defs[p]["color"])
            # group band above the heatmap (axes coords)
            ax.add_patch(plt.Rectangle(
                (j - 0.5, -0.5), 1.0, -max(0.02 * C, 0.3), clip_on=False,
                facecolor=group_defs[p]["color"], edgecolor="none"))
        seen = {}
        for d in group_defs:
            seen.setdefault(d["group_name"], d["color"])
        handles = [plt.Line2D([], [], marker="s", linestyle="",
                              markersize=8, color=c, label=n)
                   for n, c in seen.items()]
        ax.legend(handles=handles, loc="lower left",
                  bbox_to_anchor=(0.0, 1.03), ncol=len(seen), fontsize=7,
                  frameon=False)
    if class_names and len(class_names) == C:
        ax.set_yticks(range(C))
        ax.set_yticklabels(class_names, fontsize=7)
    fig.colorbar(im, label="virtual weight")
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    w = explanation["weights"]  # listing below uses original order

    # text listing: relevant prototypes per class
    lines = []
    for c in range(C):
        relevant = [(p, float(w[c, p])) for p in range(P)
                    if w[c, p] > threshold]
        relevant.sort(key=lambda t: -t[1])
        name = class_names[c] if class_names and c < len(class_names) \
            else f"class {c}"
        lines.append(f"{name}: " + ", ".join(
            f"P{p}({v:.3f})" for p, v in relevant))
    txt_path = os.path.splitext(out_path)[0] + ".txt"
    with open(txt_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"Global explanation written to {out_path} and {txt_path}")
    return lines


def main():
    ap = argparse.ArgumentParser("Global explanation for a trained run")
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--checkpoint", default="net_best")
    ap.add_argument("--out", default="")
    ap.add_argument("--threshold", type=float, default=1e-3)
    ap.add_argument("--groups_json", default="",
                    help="JSON with prototype groups/labels/colors for "
                         "the grouped figure (same schema as "
                         "interp_explorer --groups_json)")
    args = ap.parse_args()
    expl = calculate_global_explanation(args.run_dir, args.checkpoint)
    out = args.out or os.path.join(args.run_dir, "global_explanation.png")
    group_defs = None
    if args.groups_json:
        import json

        from ..interpret.enums import build_group_definitions
        with open(args.groups_json) as f:
            spec = json.load(f)
        group_defs = build_group_definitions(
            expl["num_prototypes"], spec.get("groups", {}),
            labels={int(k): v
                    for k, v in spec.get("labels", {}).items()},
            colors=spec.get("colors"), priority=spec.get("priority"))
    show_global_explanation(expl, out, threshold=args.threshold,
                            group_defs=group_defs)


if __name__ == "__main__":
    main()
