"""Export the reference package's example datasets to .npz for this framework.

Reads /root/reference/data/{abalone,heart,wine,student}.rda (documented in
reference R/data.R:40-191) and writes sgdnet_tpu/data/<name>.npz with:
  x        -- dense float64 design matrix (n, p)
  y        -- response: float64 vector, string labels, or float64 matrix
  x_sparse -- bool flag: the original x was a dgCMatrix
  feature_names / response_names where available

Run once:  python tools/export_datasets.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools.rda import RObj, factor_to_labels, load_rda, to_matrix

REF = "/root/reference/data"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sgdnet_tpu", "data")


def s4_dgc_to_dense(obj: RObj):
    """Convert a serialized dgCMatrix S4 object to a dense numpy array."""
    i = np.asarray(obj.attrs["i"].data, dtype=int)
    p = np.asarray(obj.attrs["p"].data, dtype=int)
    x = np.asarray(obj.attrs["x"].data, dtype=np.float64)
    nrow, ncol = np.asarray(obj.attrs["Dim"].data, dtype=int)
    dense = np.zeros((nrow, ncol))
    for j in range(ncol):
        for k in range(p[j], p[j + 1]):
            dense[i[k], j] = x[k]
    dimnames = obj.attrs.get("Dimnames")
    colnames = None
    if dimnames is not None and dimnames.data[1] is not None:
        colnames = [s for s in dimnames.data[1].data]
    return dense, colnames


def export(name: str):
    d = load_rda(f"{REF}/{name}.rda")
    top = d[name]
    names = [s for s in top.attrs["names"].data]
    parts = dict(zip(names, top.data))
    out = {}

    xobj = parts["x"]
    if xobj.data is None:  # S4 dgCMatrix
        x, colnames = s4_dgc_to_dense(xobj)
        out["x_sparse"] = np.array(True)
    elif any(c.data == ["data.frame"] for k, c in xobj.attrs.items() if k == "class"):
        colnames = [s for s in xobj.attrs["names"].data]
        cols = [np.asarray(col.data, dtype=np.float64) for col in xobj.data]
        x = np.column_stack(cols)
        out["x_sparse"] = np.array(False)
    else:
        x = to_matrix(xobj)
        dn = xobj.attrs.get("dimnames")
        colnames = None
        if dn is not None and dn.data[1] is not None:
            colnames = [s for s in dn.data[1].data]
        out["x_sparse"] = np.array(False)
    out["x"] = x
    if colnames:
        out["feature_names"] = np.asarray(colnames)

    yobj = parts["y"]
    if "levels" in yobj.attrs:  # factor
        out["y"] = factor_to_labels(yobj)
    elif yobj.attr("dim") is not None:  # matrix response (student)
        out["y"] = to_matrix(yobj)
        dn = yobj.attrs.get("dimnames")
        if dn is not None and dn.data[1] is not None:
            out["response_names"] = np.asarray([s for s in dn.data[1].data])
    else:
        out["y"] = np.asarray(yobj.data, dtype=np.float64)

    os.makedirs(OUT, exist_ok=True)
    np.savez_compressed(f"{OUT}/{name}.npz", **out)
    print(f"{name}: x {x.shape} sparse={out['x_sparse']} y {out['y'].shape} {out['y'].dtype}")


if __name__ == "__main__":
    for name in ["abalone", "heart", "wine", "student"]:
        export(name)
