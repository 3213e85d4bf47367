"""Why the sharded local BA sums over points in float64: a witness.

At float32 the sums over points and observations (H_cc, b_c, T^T U, T b_p,
the cost) hang on the order of their terms, and the staged LM's early
stop and weakly held points hang on those sums. So an unsharded float32
solve of tests/test_distributed.py's window (L=4, C=8, P=64, MO=4, "flat"
at bfloat16) with its points permuted parts from the unpermuted solve by
millimetres and by LM iterations, in the JAX package as in the port: the
split over ranks, which changes the order the same way, cannot be held
to the JAX package's two-process gate (1e-4 m) at float32. With the
port's reduction hook (an identity here) those sums accumulate in
float64, and every permutation gives the unpermuted result bit for bit.

    python tests/test_torch_sum_order.py

prints the permutation study and, beside it, the JAX package's own
two-process sharded solve of that window (tests/test_distributed.py's
worker, two processes over 127.0.0.1): how far it lies from the
single-process solve and both LM iteration counts.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np

from gmmloc_tpu.config import CameraConfig as JCameraConfig
from gmmloc_tpu.geometry import camera as jcam
from gmmloc_tpu.solver import local_ba as jba

from gmmloc_tpu_torch import entry
from gmmloc_tpu_torch.solver import local_ba

from test_torch_parallel import _distributed_test_problem

PER_POINT = ("pts", "pt_valid", "obs_cam", "obs_uvr", "obs_stereo", "obs_sigma2_inv",
             "obs_valid", "str_type", "str_normal", "str_mean", "str_sqrt_info")


def permutation_study(n_perms: int = 3) -> dict:
    """For the unpermuted window and `n_perms` seeded permutations of its
    points: each solve's LM iterations and how far its points (m) and
    camera positions (m) lie from the unpermuted solve's, for the port
    without the hook (float32 sums), the port with an identity hook
    (float64 sums) and the JAX package (float32 sums)."""
    cam, prob, L = _distributed_test_problem()
    rng = np.random.default_rng(123)
    perms = [np.arange(64)] + [rng.permutation(64) for _ in range(n_perms)]
    jc = jcam.CameraParams.from_config(JCameraConfig())

    def port(p, hook):
        r = local_ba.solve_local_ba(cam, entry.ba_problem(p, "cpu"), L, reduce_sum=hook)
        return r.pts.numpy(), r.cam_t.numpy(), int(r.n_iters)

    def jax(p):
        r = jba.solve_local_ba(jc, jba.BAProblem(**{k: jnp.asarray(v) for k, v in p.items()}),
                               n_free=L)
        return np.asarray(r.pts), np.asarray(r.cam_t), int(r.n_iters)

    solvers = dict(port_f32=lambda p: port(p, None),
                   port_f64=lambda p: port(p, lambda t: t), jax_f32=jax)
    out = {}
    for name, solve in solvers.items():
        rows, base = [], None
        for perm in perms:
            pts, cam_t, iters = solve({k: (v[perm] if k in PER_POINT else v)
                                       for k, v in prob.items()})
            pts = pts[np.argsort(perm)]
            base = base or (pts, cam_t)
            rows.append(dict(iters=iters, pts_m=float(np.abs(pts - base[0]).max()),
                             cam_t_m=float(np.abs(cam_t - base[1]).max())))
        out[name] = rows
    return out


def test_float64_sums_do_not_hang_on_point_order():
    study = permutation_study()
    f64 = study["port_f64"]
    assert all(r["pts_m"] == 0 and r["cam_t_m"] == 0 and r["iters"] == f64[0]["iters"]
               for r in f64), f64
    # at float32 both packages part by more than the two-process gate
    for name in ("port_f32", "jax_f32"):
        assert max(r["pts_m"] for r in study[name]) > 1e-4, study[name]
        assert len({r["iters"] for r in study[name]}) > 1, study[name]


def jax_two_process() -> dict:
    """tests/test_distributed.py's worker over two local processes, also
    reporting the LM iterations of its single-process and sharded solves."""
    import test_distributed

    worker = test_distributed._WORKER.replace(
        '"err_cam": err_cam}))',
        '"err_cam": err_cam, "iters_single": int(res_single.n_iters), '
        '"iters_sharded": int(np.asarray(res_sh.n_iters.addressable_data(0)))}))')
    assert worker != test_distributed._WORKER
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = tempfile.mkdtemp()
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, out_dir], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, GMMLOC_COORDINATOR=f"127.0.0.1:{port}",
                 GMMLOC_NUM_PROCESSES="2", GMMLOC_PROCESS_ID=str(i),
                 JAX_PLATFORMS_OVERRIDE="cpu")) for i in range(2)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (o, e) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"rc {p.returncode}\n{o}\n{e}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


if __name__ == "__main__":
    print(json.dumps(dict(permutations=permutation_study(6), jax_two_process=jax_two_process()),
                     indent=1))
