"""Generate checked-in golden oracle coefficient paths (one-time).

The reference's correctness strategy is same-input comparison against a
reference implementation at 1e-3 (reference tests/testthat/setup.R:56-100);
SURVEY §4(b) prescribes a *stored* golden-path oracle since R/glmnet is not
available in this environment.  This script computes, once, f64 oracle
coefficient paths with scikit-learn (coordinate descent / SAGA at tight
tolerance, plus closed forms) on the four bundled reference datasets over
the alpha x standardize grid, and stores them as tests/golden/*.npz.
tests/test_golden.py asserts against them in CI — the durable, fast form of
the 1e-3 contract.

Run from /root/repo:  python tools/gen_golden.py
"""

import sys

sys.path.insert(0, "/root/repo")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import sgdnet_tpu as st  # noqa: E402
from sgdnet_tpu.data import load_abalone, load_heart, load_student, load_wine  # noqa: E402
from tests.helpers import pop_sd, sklearn_enet_path, sklearn_logistic  # noqa: E402

OUT = "tests/golden"


def gen_abalone():
    x, y = load_abalone()
    out = {}
    for alpha in (0.0, 0.5, 1.0):
        for std in (True, False):
            fit = st.fit(x, y, alpha=alpha, nlambda=10, standardize=std, dtype=np.float64)
            lams = fit.lambda_
            # skip the first ridge point (penalty convention differs there,
            # reference setup.R:86-91 / R/sgdnet.R:96-104)
            use = lams[1:] if alpha == 0.0 else lams
            a0_o, beta_o = sklearn_enet_path(x, y, use, mix=alpha, standardize=std)
            key = f"a{alpha}_s{int(std)}"
            out[f"{key}_lambda"] = lams
            out[f"{key}_a0"] = a0_o
            out[f"{key}_beta"] = beta_o
            print(f"abalone {key}: {len(use)} oracle points")
    np.savez_compressed(f"{OUT}/abalone.npz", **out)


def gen_heart():
    x, y = load_heart()
    out = {}
    for alpha in (0.0, 1.0):
        fit = st.fit(x, y, family="binomial", alpha=alpha, nlambda=8, dtype=np.float64)
        lams = fit.lambda_
        use = lams[1:] if alpha == 0.0 else lams
        a0s, betas = [], []
        for lam in use:
            a0, beta = sklearn_logistic(x, y, lam, mix=alpha, tol=1e-10)
            a0s.append(a0)
            betas.append(beta)
        key = f"a{alpha}_s1"
        out[f"{key}_lambda"] = lams
        out[f"{key}_a0"] = np.asarray(a0s)
        out[f"{key}_beta"] = np.asarray(betas)
        print(f"heart {key}: {len(use)} oracle points")
    np.savez_compressed(f"{OUT}/heart.npz", **out)


def gen_wine():
    from sklearn.linear_model import LogisticRegression

    x, y = load_wine()
    n = len(y)
    xc, xs = x.mean(0), pop_sd(x)
    xt = (x - xc) / xs
    out = {}
    for alpha in (0.0, 1.0):
        # wine is near-separable: small lambdas give huge, ill-conditioned
        # multinomial-lasso solutions no two solvers agree on — pin the
        # contract on a well-conditioned range
        fit = st.fit(x, y, family="multinomial", alpha=alpha, nlambda=6,
                     lambda_min_ratio=0.05, dtype=np.float64)
        lams = fit.lambda_
        use = lams[2:] if alpha == 0.0 else lams[1:]  # interior points only
        a0s, betas = [], []
        for lam in use:
            if alpha == 0.0:
                lr = LogisticRegression(
                    C=1.0 / (n * lam), solver="lbfgs", tol=1e-10, max_iter=20000
                )
            else:
                lr = LogisticRegression(
                    C=1.0 / (n * lam), solver="saga", penalty="l1", tol=1e-10, max_iter=200000
                )
            lr.fit(xt, y)
            beta = lr.coef_ / xs[None, :]  # (k, p) on original scale
            a0 = lr.intercept_ - beta @ xc
            a0s.append(a0 - a0.mean())  # sum-zero centering (R/sgdnet.R:409-410)
            betas.append(beta)
        key = f"a{alpha}_s1"
        out[f"{key}_lambda"] = lams
        out[f"{key}_skip"] = np.asarray(len(lams) - len(use))
        out[f"{key}_a0"] = np.asarray(a0s)
        out[f"{key}_beta"] = np.asarray(betas)
        print(f"wine {key}: {len(use)} oracle points")
    np.savez_compressed(f"{OUT}/wine.npz", **out)


def gen_student():
    from sklearn.linear_model import MultiTaskElasticNet

    x, y = load_student()
    xc, xs = x.mean(0), pop_sd(x)
    xt = (x - xc) / xs
    out = {}
    for alpha in (0.5, 1.0):
        fit = st.fit(x, y, family="mgaussian", alpha=alpha, nlambda=8, dtype=np.float64)
        lams = fit.lambda_
        use = lams[1:]
        a0s, betas = [], []
        for lam in use:
            # our objective (standardized x; mgaussian y_scale == 1):
            #   (1/n) 0.5 sum ||y_i - w x_i||^2 + l2/2 ||w||^2_F + l1 sum_j ||w_j||_2
            # MultiTaskElasticNet: (1/(2n)) ||Y - XW||^2_F
            #   + a*rho ||W||_21 + 0.5*a*(1-rho) ||W||_F^2  =>  a = lam, rho = alpha
            en = MultiTaskElasticNet(
                alpha=lam, l1_ratio=alpha, fit_intercept=True, tol=1e-12, max_iter=200000
            )
            en.fit(xt, y)
            beta = en.coef_ / xs[None, :]  # (k, p) original scale
            a0 = en.intercept_ - beta @ xc
            a0s.append(a0)
            betas.append(beta)
        key = f"a{alpha}_s1"
        out[f"{key}_lambda"] = lams
        out[f"{key}_a0"] = np.asarray(a0s)
        out[f"{key}_beta"] = np.asarray(betas)
        print(f"student {key}: {len(use)} oracle points")
    np.savez_compressed(f"{OUT}/student.npz", **out)


if __name__ == "__main__":
    import os

    os.makedirs(OUT, exist_ok=True)
    gen_abalone()
    gen_heart()
    gen_wine()
    gen_student()
    print("golden paths written to", OUT)
