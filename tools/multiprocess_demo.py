"""True multi-process data-parallel fit demo (jax.distributed + gloo).

Launches N worker processes, each owning 4 virtual CPU devices, wires them
with `jax.distributed.initialize`, and runs one data-parallel `st.fit` over
the global 'data' mesh — the same code path a multi-host cluster runs, with
gloo standing in for the interconnect.  Process 0 saves the coefficient path; the launcher
then refits single-process (same global batch) and reports the max
coefficient difference.

Run: python tools/multiprocess_demo.py [n_processes]
"""

import subprocess
import sys
import tempfile

import numpy as np

WORKER = """
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]; out = sys.argv[4]
sys.path.insert(0, sys.argv[5])  # repo root (worker script lives in /tmp)
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
import numpy as np
import sgdnet_tpu as st
from sgdnet_tpu.parallel.multihost import global_data_mesh
rng = np.random.default_rng(0)
n, p = 512, 10
x = rng.normal(size=(n, p))
y = x @ (rng.normal(size=p) * 0.5) + 0.1 * rng.normal(size=n)
fit = st.fit(x, y, family="gaussian", nlambda=5, batch_size=8, mesh=global_data_mesh(),
             dtype=np.float32, thresh=1e-6)
if pid == 0:
    np.save(out, fit.beta)
    print("[p0]", jax.process_count(), "processes,", jax.device_count(), "global devices,",
          "dev_ratio:", np.round(fit.dev_ratio, 4), flush=True)
"""


def main(nproc: int = 2, port: int = 52345) -> float:
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tempfile.mktemp(suffix=".npy")
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(WORKER)
        worker_path = f.name
    procs = [
        subprocess.Popen(
            [sys.executable, worker_path, str(i), str(nproc), str(port), out, repo],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=repo,
        )
        for i in range(nproc)
    ]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(o)
            raise RuntimeError(f"worker {i} failed (exit {p.returncode})")
    print(outs[0].strip().splitlines()[-1])

    beta_mp = np.load(out)

    import os

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={4 * nproc}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import sgdnet_tpu as st
    from sgdnet_tpu.parallel.dist import make_mesh

    rng = np.random.default_rng(0)
    n, p = 512, 10
    x = rng.normal(size=(n, p))
    y = x @ (rng.normal(size=p) * 0.5) + 0.1 * rng.normal(size=n)
    f1 = st.fit(x, y, family="gaussian", nlambda=5, batch_size=8,
                mesh=make_mesh(4 * nproc), dtype=np.float32, thresh=1e-6)
    diff = float(np.abs(beta_mp - f1.beta).max())
    print(f"{nproc}-process vs single-process max |dbeta|: {diff:.3e}")
    return diff


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
