"""k-fold cross-validation over an (alpha grid x lambda path).

Equivalent of the reference's `cv_sgdnet` (reference R/cv_sgdnet.R:113-299),
with two deliberate changes, both documented in SURVEY.md §3.3 / §7:

* Fold orientation: the reference trains on the *j*-th fold and tests on
  the other k-1 folds (an inversion of its own docs, reference
  R/cv_sgdnet.R:182-183).  We implement classic k-fold: train on k-1
  folds, test on the held-out fold.
* Fold fits run as one batched computation when possible: each fold is a
  0/1 `sample_weight` mask over the same design matrix, so fold fits share
  shapes/compilation and can be sharded across devices (see
  parallel/cv.py) instead of the reference's serial R loop
  (reference R/cv_sgdnet.R:178-200).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sgdnet_tpu.api.fit import SgdnetFit, at_highest_precision, fit as fit_fn
from sgdnet_tpu.api.score import score as score_fn


@dataclass
class CvFit:
    """Cross-validation result (reference cv_sgdnet object,
    R/cv_sgdnet.R:244-253)."""

    alpha: np.ndarray  # alpha grid
    lambda_: list  # per-alpha lambda paths
    cv_summary: dict  # columns: alpha, lambda, mean, sd, ci_lo, ci_up
    cv_raw: list  # per-alpha (nfolds, nlambda) score matrices
    name: str
    fit: SgdnetFit  # full-data fit at the winning alpha
    fits: list  # full-data fits for every alpha
    alpha_min: float
    lambda_min: float
    lambda_1se: float
    type_measure: str

    def predict(self, newx=None, s="lambda_min", type="link", **kwargs):
        """(reference R/predict.cv_sgdnet.R:43-52)"""
        if isinstance(s, str):
            if s not in ("lambda_min", "lambda_1se"):
                raise ValueError("s must be 'lambda_min', 'lambda_1se', or numeric")
            s = getattr(self, s)
        from sgdnet_tpu.api.predict import predict

        return predict(self.fit, newx=newx, s=s, type=type, **kwargs)

    def coef(self, s="lambda_min", **kwargs):
        return self.predict(s=s, type="coefficients", **kwargs)

    def score(self, x, y, type_measure=None, s="lambda_1se", offset=None):
        """(reference R/score.R:182-191)"""
        if isinstance(s, str):
            s = getattr(self, s)
        return score_fn(self.fit, x, y, type_measure or self.type_measure, s=s, offset=offset)

    def deviance(self):
        """Deviance along the winning fit's path
        (reference R/deviance.sgdnet.R:39-41)."""
        return self.fit.deviance()

    def plot(self, **kwargs):
        from sgdnet_tpu.api.plot import plot_cv

        return plot_cv(self, **kwargs)

    def summary(self) -> str:
        """Text summary (reference R/print.cv_sgdnet.R:44-54)."""
        lines = [
            f"Cross-validation ({self.name})",
            f"  alpha_min:  {self.alpha_min:g}",
            f"  lambda_min: {self.lambda_min:.6g}",
            f"  lambda_1se: {self.lambda_1se:.6g}",
            "",
            "  alpha    lambda      mean        sd",
        ]
        s = self.cv_summary
        for i in range(len(s["lambda"])):
            lines.append(
                f"  {s['alpha'][i]:<6g} {s['lambda'][i]:<10.4g} "
                f"{s['mean'][i]:<10.5g} {s['sd'][i]:<10.5g}"
            )
        return "\n".join(lines)

    def __repr__(self):
        return (
            f"CvFit(name={self.name!r}, alpha_min={self.alpha_min}, "
            f"lambda_min={self.lambda_min:.6g}, lambda_1se={self.lambda_1se:.6g})"
        )


_MEASURE_NAMES = {
    "deviance": {
        "gaussian": "Mean-Squared Error",
        "mgaussian": "Mean-Squared Error",
        "binomial": "Binomial Deviance",
        "poisson": "Poisson Deviance",
        "multinomial": "Multinomial Deviance",
    },
    "mse": "Mean-Squared Error",
    "mae": "Mean Absolute Error",
    "class": "Misclassification Error",
    "auc": "AUC",
}


def _find_optimum(lambdas, means, sds, maximize=False):
    """lambda_min / lambda_1se selection (reference R/cv_sgdnet.R:265-282)."""
    means = np.asarray(means)
    if maximize:
        means = -means
    ind = int(np.nanargmin(means))
    within = means <= means[ind] + np.asarray(sds)[ind]
    lambda_1se = float(np.max(np.asarray(lambdas)[within]))
    return ind, float(lambdas[ind]), lambda_1se, float(means[ind])


@at_highest_precision
def cv_fit(
    x,
    y,
    alpha=1.0,
    lambda_path=None,
    nfolds: int = 10,
    foldid=None,
    type_measure: str = "deviance",
    seed: int = 0,
    parallel: bool = False,
    cv_mesh=None,
    offset=None,
    **fit_kwargs,
) -> CvFit:
    """Cross-validate elastic-net GLM fits over alpha x lambda.

    `alpha` may be a scalar or a grid; `lambda_path` may be None (auto per
    alpha), one array (single alpha), or a list of arrays matching `alpha`
    (reference R/cv_sgdnet.R:142-158).  With `parallel=True`, fold fits for
    each alpha run as one vmapped/sharded computation across devices.
    """
    alphas = np.atleast_1d(np.asarray(alpha, dtype=np.float64))
    n_alpha = len(alphas)
    if nfolds <= 2:
        raise ValueError("nfolds must be greater than 2")

    n_samples = np.asarray(y).shape[0]
    if nfolds > n_samples:
        raise ValueError("you cannot have more folds than samples.")

    if isinstance(lambda_path, (list, tuple)) and len(lambda_path) and not np.isscalar(lambda_path[0]):
        if n_alpha != len(lambda_path):
            raise ValueError("the length of the lambda list needs to match the number of alpha.")
        lambda_list = [np.asarray(l) if l is not None else None for l in lambda_path]
    elif lambda_path is None:
        lambda_list = [None] * n_alpha
    else:
        if n_alpha > 1:
            raise ValueError(
                "you need a list of lambdas (or None) when you have multiple alphas."
            )
        lambda_list = [np.asarray(lambda_path, dtype=np.float64)]

    offset_arr = None
    if offset is not None:
        offset_arr = np.asarray(offset, dtype=np.float64)

    # observation weights: full-data fits take the whole vector; fold fits
    # the training subset (scores stay unweighted, like the reference's
    # score(); glmnet additionally weights the CV means)
    sw_arr = fit_kwargs.pop("sample_weight", None)
    if sw_arr is not None:
        sw_arr = np.asarray(sw_arr, dtype=np.float64)
        if sw_arr.shape != (n_samples,):
            raise ValueError("sample_weight must have one entry per sample")
    # full-data fit per alpha (reference R/cv_sgdnet.R:160-162)
    fits = [
        fit_fn(
            x, y, alpha=float(alphas[i]), lambda_path=lambda_list[i], offset=offset_arr,
            sample_weight=sw_arr, **fit_kwargs,
        )
        for i in range(n_alpha)
    ]
    lambda_list = [f.lambda_ for f in fits]

    # fold assignment (reference R/cv_sgdnet.R:168-174)
    if foldid is None:
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n_samples)
        foldid = np.zeros(n_samples, dtype=int)
        for j, chunk in enumerate(np.array_split(perm, nfolds)):
            foldid[chunk] = j
    else:
        foldid = np.asarray(foldid)
        if len(foldid) != n_samples:
            raise ValueError("the length of `foldid` must match the number of samples")
        nfolds = len(np.unique(foldid))

    x_np_known = not hasattr(x, "tocsr")  # scipy handled by fit

    cv_raw = []
    for i in range(n_alpha):
        scores = np.full((nfolds, len(lambda_list[i])), np.nan)
        if parallel:
            from sgdnet_tpu.parallel.cv import parallel_fold_scores

            scores = parallel_fold_scores(
                x,
                y,
                foldid,
                nfolds,
                alpha=float(alphas[i]),
                lambda_path=lambda_list[i],
                type_measure=type_measure,
                mesh=cv_mesh,
                seed=seed,
                sample_weight=sw_arr,
                offset=offset_arr,
                **fit_kwargs,
            )
        else:
            for j in range(nfolds):
                test = foldid == j
                train = ~test
                if x_np_known:
                    x_tr, x_te = np.asarray(x)[train], np.asarray(x)[test]
                else:
                    x_tr, x_te = x[np.flatnonzero(train)], x[np.flatnonzero(test)]
                y_arr = np.asarray(y)
                y_tr, y_te = y_arr[train], y_arr[test]
                o_tr = o_te = None
                if offset_arr is not None:
                    o_tr, o_te = offset_arr[train], offset_arr[test]
                sw_tr = sw_arr[train] if sw_arr is not None else None
                f = fit_fn(
                    x_tr, y_tr, alpha=float(alphas[i]), lambda_path=lambda_list[i],
                    offset=o_tr, sample_weight=sw_tr, **fit_kwargs,
                )
                scores[j] = score_fn(f, x_te, y_te, type_measure, s=lambda_list[i], offset=o_te)
        cv_raw.append(scores)

    # summary (reference R/cv_sgdnet.R:204-215, 293-299)
    rows = {"alpha": [], "lambda": [], "mean": [], "sd": [], "ci_lo": [], "ci_up": []}
    optima = []
    maximize = type_measure == "auc"
    for i in range(n_alpha):
        means = np.nanmean(cv_raw[i], axis=0)
        sds = np.nanstd(cv_raw[i], axis=0, ddof=1)
        rows["alpha"].extend([alphas[i]] * len(means))
        rows["lambda"].extend(lambda_list[i])
        rows["mean"].extend(means)
        rows["sd"].extend(sds)
        rows["ci_lo"].extend(means - sds)
        rows["ci_up"].extend(means + sds)
        ind, lam_min, lam_1se, err = _find_optimum(lambda_list[i], means, sds, maximize)
        optima.append((err, float(alphas[i]), lam_min, lam_1se, i))

    best = min(optima)
    _, alpha_min, lambda_min, lambda_1se, best_i = best

    name = _MEASURE_NAMES[type_measure]
    if isinstance(name, dict):
        name = name[fits[best_i].family]

    return CvFit(
        alpha=alphas,
        lambda_=lambda_list,
        cv_summary={k: np.asarray(v) for k, v in rows.items()},
        cv_raw=cv_raw,
        name=name,
        fit=fits[best_i],
        fits=fits,
        alpha_min=alpha_min,
        lambda_min=lambda_min,
        lambda_1se=lambda_1se,
        type_measure=type_measure,
    )
