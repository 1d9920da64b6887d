"""Result post-processing: inlier-ratio tables and multi-experiment reports.

Counterpart of `deepfepe_tpu/eval/results.py`, a numpy copy of
`utils/eval_tools.py`'s `Result_processor` (:27-178: one run's npz ->
epipolar-distance inlier ratios and err_q/err_t summaries) and the table
side of `Exp_table_processor` (:181-243, 452-585: experiments side by side
with mean and median rows, the best entries bold, Markdown and LaTeX). It
reads the npz dumps `eval_good` writes ({our,base}_name + filename with
err_q, err_t and epi_dists). `plot_metrics` returns None where matplotlib
is missing.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

DEFAULT_THRESHOLDS = (0.1, 0.5, 1.0, 2.0)
DEFAULT_ANGLE_THRESHOLDS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0)


class ResultProcessor:
    """Summaries over one experiment's per-pair results."""

    def __init__(self, results: Dict[str, np.ndarray]):
        self.results = results

    @classmethod
    def from_npz(cls, path: str) -> "ResultProcessor":
        with np.load(path, allow_pickle=True) as z:
            return cls({k: z[k] for k in z.files})

    def inlier_ratio(
        self, thresholds: Sequence[float] = DEFAULT_THRESHOLDS
    ) -> Dict[float, float]:
        """Mean fraction of correspondences under each epi-dist threshold
        (ref: Result_processor.inlier_ratio)."""
        d = self.results["epi_dists"]
        return {
            float(t): float(np.mean(d < t)) for t in thresholds
        }

    def pose_error_stats(self) -> Dict[str, float]:
        out = {}
        for k in ("err_q", "err_t"):
            if k in self.results:
                v = np.asarray(self.results[k], np.float64)
                out[f"{k}_mean"] = float(np.mean(v))
                out[f"{k}_median"] = float(np.median(v))
                out[f"{k}_max"] = float(np.max(v))
        return out

    def ratio_curve(
        self,
        key: str = "err_q",
        thresholds: Sequence[float] = DEFAULT_ANGLE_THRESHOLDS,
    ) -> Dict[float, float]:
        """Cumulative accuracy curve: fraction of pairs with error < th
        (ref: write_metrics_summary ratio curves, train_good_utils.py:806)."""
        v = np.asarray(self.results[key], np.float64)
        return {float(t): float(np.mean(v < t)) for t in thresholds}

    def inlier_ratio_masked(
        self,
        thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
        mask_key: Optional[str] = None,
        mask_thd: float = 0.0,
    ) -> Dict[str, np.ndarray]:
        """Per-sample inlier ratios, optionally restricted to
        correspondences whose `mask_key` score exceeds mask_thd
        (ref: Result_processor.inlier_ratio :72-105 with mask_entry).

        Returns {'inlier_ratio': [T, S], 'num_corrs': [S]}."""
        d = np.asarray(self.results["epi_dists"], np.float64)
        if d.ndim == 1:
            d = d[None]
        mask = np.ones_like(d, bool)
        if mask_key is not None and mask_key in self.results:
            mask = np.asarray(self.results[mask_key]) > mask_thd
        num = np.maximum(mask.sum(-1), 1)
        ratios = np.stack(
            [((d < t) & mask).sum(-1) / num for t in thresholds]
        )
        return {
            "inlier_ratio": ratios,
            "num_corrs": mask.sum(-1),
        }

    def ap_inlier_thd(
        self,
        inlier_thds: Sequence[float] = DEFAULT_THRESHOLDS,
        mask_thds: Sequence[float] = (0.0,),
        mask_key: str = "mscores",
    ) -> Dict[str, np.ndarray]:
        """Inlier-ratio table across score-mask thresholds
        (ref: Result_processor.ap_inlier_thd :113-139).

        Returns {'inlier_thd': [M, T, S], 'num_corrs': [M, S]}."""
        tables, nums = [], []
        for thd in mask_thds:
            r = self.inlier_ratio_masked(
                inlier_thds, mask_key=mask_key, mask_thd=thd
            )
            tables.append(r["inlier_ratio"])
            nums.append(r["num_corrs"])
        return {
            "inlier_thd": np.stack(tables),
            "num_corrs": np.stack(nums),
        }


class ExpTableProcessor:
    """Aggregate several experiments into comparison tables."""

    def __init__(self, experiments: Dict[str, ResultProcessor]):
        self.experiments = experiments

    @classmethod
    def from_dirs(
        cls, paths: Dict[str, str], filename: str = "DeepF_err_ratio.npz"
    ) -> "ExpTableProcessor":
        return cls(
            {
                name: ResultProcessor.from_npz(str(Path(p) / filename))
                for name, p in paths.items()
            }
        )

    @classmethod
    def from_config(cls, config: Dict) -> "ExpTableProcessor":
        """Build from a table config dict (ref configs/table_*.yaml schema:
        `data.base_path` + `data.seq_dict: symbol -> [folder, filename, ...]`
        consumed by Exp_table_processor, eval_tools.py:181-243). Extra list
        entries past (folder, filename) — checkpoint iters etc. — are
        ignored, as the reference does for table assembly. Missing npz files
        are skipped with a warning rather than failing the whole table
        (the reference's check_output behavior, run_eval_good.py:296-356)."""
        data = config.get("data", config)
        base = Path(data.get("base_path", "."))
        exps: Dict[str, ResultProcessor] = {}
        for sym, entry in (data.get("seq_dict") or {}).items():
            folder, filename = entry[0], entry[1]
            path = base / folder / filename
            if not path.exists():
                print(f"[ExpTableProcessor] missing: {path} (skipped)")
                continue
            exps[sym] = ResultProcessor.from_npz(str(path))
        return cls(exps)

    def table(
        self, metrics: Sequence[str] = ("err_q_median", "err_t_median")
    ) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                m: rp.pose_error_stats().get(m, float("nan"))
                for m in metrics
            }
            for name, rp in self.experiments.items()
        }

    def highlights(
        self, metric: str = "err_q_median", lower_better: bool = True
    ) -> str:
        t = self.table((metric,))
        vals = {k: v[metric] for k, v in t.items()}
        pick = min if lower_better else max
        return pick(vals, key=vals.get)

    @staticmethod
    def highlights_table(
        line_list: Sequence[Sequence[float]],
        reverse_arr: Optional[Sequence[float]] = None,
        top_k: int = 1,
    ) -> Dict[str, np.ndarray]:
        """Per-column top-k entry flags (ref: get_highlights_table
        :452-470). reverse_arr: +1 = higher-better, -1 = lower-better per
        column (the reference's convention); defaults to lower-better."""
        nums = np.asarray(line_list, np.float64)
        rev = (
            np.asarray(reverse_arr, np.float64)
            if reverse_arr is not None
            else -np.ones(nums.shape[1])
        )
        scored = nums * rev
        order = np.empty_like(scored, dtype=np.intp)
        for j in range(scored.shape[1]):
            idx = np.empty(scored.shape[0], np.intp)
            idx[np.argsort(scored[:, j])] = np.arange(scored.shape[0])[::-1]
            order[:, j] = idx
        return {
            "table_argsort": order.T,
            "table_highlights": order < top_k,
        }

    def to_markdown(
        self,
        metrics: Sequence[str] = ("err_q_median", "err_t_median"),
        top_k: int = 1,
        higher_better: Sequence[bool] = (),
        summary_rows: bool = True,
    ) -> str:
        """Markdown comparison table with per-column top-k bolding and
        mean/median summary rows (ref: print_tables :472-540 +
        get_mean_median :235-242)."""
        t = self.table(metrics)
        names = list(t)
        lines_vals = [[t[n][m] for m in metrics] for n in names]
        rev = [
            1.0 if (i < len(higher_better) and higher_better[i]) else -1.0
            for i in range(len(metrics))
        ]
        hi = self.highlights_table(lines_vals, rev, top_k)[
            "table_highlights"
        ]
        out = ["| exp | " + " | ".join(metrics) + " |",
               "|" + "---|" * (len(metrics) + 1)]
        for n, vals, h in zip(names, lines_vals, hi):
            cells = [
                f"**{v:.3f}**" if b else f"{v:.3f}"
                for v, b in zip(vals, h)
            ]
            out.append("| " + " | ".join([n] + cells) + " |")
        if summary_rows and names:
            arr = np.asarray(lines_vals, np.float64)
            for label, agg in (("mean", np.nanmean), ("median", np.nanmedian)):
                cells = [f"{agg(arr[:, j]):.3f}" for j in range(arr.shape[1])]
                out.append("| " + " | ".join([f"_{label}_"] + cells) + " |")
        return "\n".join(out)

    def plot_metrics(
        self,
        metrics: Sequence[str] = ("err_q_median", "err_t_median"),
        save_path: Optional[str] = None,
    ):
        """Figure assembly: one bar panel per metric across experiments
        (ref: plot_table_for_metrics :542-572). Returns the figure, or None
        when matplotlib is unavailable."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        t = self.table(metrics)
        names = list(t)
        fig, axes = plt.subplots(
            1, len(metrics), figsize=(4 * len(metrics), 3), squeeze=False
        )
        for j, m in enumerate(metrics):
            ax = axes[0][j]
            vals = [t[n][m] for n in names]
            ax.bar(range(len(names)), vals)
            ax.set_xticks(range(len(names)))
            ax.set_xticklabels(names, rotation=30, ha="right", fontsize=8)
            ax.set_title(m, fontsize=9)
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=150)
        return fig

    def to_latex(
        self, metrics: Sequence[str] = ("err_q_median", "err_t_median")
    ) -> str:
        """LaTeX table emission (ref: Exp_table_processor.print_tables :472)."""
        t = self.table(metrics)
        header = " & ".join(["exp"] + list(metrics)) + r" \\"
        lines = [r"\begin{tabular}{l" + "c" * len(metrics) + "}", header,
                 r"\hline"]
        best = {m: self.highlights(m) for m in metrics}
        for name, row in t.items():
            cells = []
            for m in metrics:
                v = f"{row[m]:.3f}"
                if best[m] == name:
                    v = r"\textbf{" + v + "}"
                cells.append(v)
            lines.append(" & ".join([name] + cells) + r" \\")
        lines.append(r"\end{tabular}")
        return "\n".join(lines)
