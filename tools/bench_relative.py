"""Run the two-solver relative benchmark and render the comparison figure.

The rebuild of the reference's precomputed `benchmarks` artifact
(reference data/benchmarks.rda + vignettes/benchmarks.Rmd:40-53): this
framework (on the default JAX device, the GPU where there is one) vs scikit-learn (CPU; coordinate descent for the gaussian
families — glmnet's own algorithm — and SAGA logistic for the link
families), loss-vs-time at lambda = 1/n on the four bundled datasets.

Writes docs/relative_benchmarks.png and prints a JSON summary per panel.
Run from the repo root:  python tools/bench_relative.py
"""

import json
import sys

import os

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# series colors: validated categorical slots 1-2 (blue, orange)
C_OURS = "#2a78d6"
C_SK = "#eb6834"
INK = "#3a3a3a"
MUTED = "#8a8a8a"


def main():
    import jax
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from sgdnet_tpu.benchmarks.relative import run_relative

    res = run_relative()

    panels = list(res.keys())  # dataset/penalty
    fig, axes = plt.subplots(2, 4, figsize=(13, 6), sharey=False)
    fig.patch.set_facecolor("white")

    for ax, key in zip(axes.ravel(), panels):
        ours, sk = res[key]["sgdnet_tpu"], res[key]["sklearn"]
        # loss suboptimality above the best loss either solver reached
        best = min(float(ours["losses"].min()), float(sk["losses"].min()))
        span = max(
            float(max(ours["losses"].max(), sk["losses"].max())) - best, 1e-12
        )

        def gap(c):
            return np.maximum((c["losses"] - best) / span, 1e-9)

        ax.plot(ours["times"], gap(ours), color=C_OURS, lw=2,
                marker="o", ms=3.5, label=f"sgdnet_tpu ({jax.devices()[0].device_kind})")
        ax.plot(sk["times"], gap(sk), color=C_SK, lw=2,
                marker="o", ms=3.5, label="scikit-learn (CPU)")
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_title(key, fontsize=10, color=INK)
        ax.grid(True, which="major", color="#e8e8e8", lw=0.6)
        ax.tick_params(labelsize=8, colors=MUTED)
        for s in ax.spines.values():
            s.set_color("#d0d0d0")

        t_tight_ours = float(ours["times"][np.argmin(ours["losses"])])
        t_tight_sk = float(sk["times"][np.argmin(sk["losses"])])

        def t_to_gap(c, frac=1e-3):
            """Time to reach within frac of the SHARED loss span above the
            shared best — the same criterion for both solvers (time-to-best
            compares each solver at its own tightest stopping point, which
            is not apples-to-apples)."""
            ok = c["losses"] <= best + frac * span
            return float(c["times"][np.argmax(ok)]) if ok.any() else float("inf")

        # affine time model decomposition for our curve: t = overhead + e*t_ep
        t_arr, e_arr = ours["times"], ours.get("epochs")
        if e_arr is not None and len(e_arr) > 1:
            t_ep = float((t_arr[-1] - t_arr[0]) / (e_arr[-1] - e_arr[0]))
            ovh = float(t_arr[0] - e_arr[0] * t_ep)
        else:
            t_ep, ovh = float("nan"), float("nan")
        print(json.dumps({
            "panel": key,
            "our_best_loss": float(ours["losses"].min()),
            "sk_best_loss": float(sk["losses"].min()),
            "our_time_to_best_s": t_tight_ours,
            "sk_time_to_best_s": t_tight_sk,
            "our_t_to_1e3span_s": t_to_gap(ours),
            "sk_t_to_1e3span_s": t_to_gap(sk),
            "our_overhead_s": ovh,
            "our_epoch_s": t_ep,
        }), file=sys.stderr)

    axes[0, 0].set_ylabel("normalized loss gap", fontsize=9, color=INK)
    axes[1, 0].set_ylabel("normalized loss gap", fontsize=9, color=INK)
    for ax in axes[1]:
        ax.set_xlabel("wall time (s)", fontsize=9, color=INK)
    handles, labels = axes[0, 0].get_legend_handles_labels()
    fig.legend(handles, labels, loc="upper center", ncol=2, frameon=False,
               fontsize=10, bbox_to_anchor=(0.5, 1.02))
    fig.suptitle("Loss vs wall time at lambda = 1/n (reference benchmark protocol)",
                 fontsize=11, color=INK, y=1.06)
    fig.tight_layout()
    fig.savefig("docs/relative_benchmarks.png", dpi=130, bbox_inches="tight")
    print("wrote docs/relative_benchmarks.png", file=sys.stderr)


if __name__ == "__main__":
    main()
