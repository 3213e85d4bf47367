"""The port's pose-graph optimization against the JAX package.

The two cases of `tests/test_pose_graph.py` run on the port, on the JAX
test's own drifted ring graph. Parity on the same graphs: the ring, and
a graph whose odometry edges are measured at the current poses (their
residuals start at exactly zero, as the loop closer builds them) plus
one loop edge. Gates: final q and t within 1e-4, the cost within 1e-4
relative where it is well above float32 noise. The Jacobians at a zero
residual are finite (forward and reverse mode agree).
"""

import numpy as np
import pytest
import torch

from gmmloc_tpu.geometry import se3 as jse3
from gmmloc_tpu.solver import pose_graph as jpg
from tests.test_pose_graph import ring_graph

from gmmloc_tpu_torch.geometry import se3
from gmmloc_tpu_torch.solver import pose_graph as pg

torch.set_num_threads(1)


def to_port(g) -> pg.PoseGraph:
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    return pg.PoseGraph(
        q=f32(g.q), t=f32(g.t), valid=torch.tensor(np.asarray(g.valid)),
        fixed=torch.tensor(np.asarray(g.fixed)),
        edge_i=torch.tensor(np.asarray(g.edge_i), dtype=torch.int64),
        edge_j=torch.tensor(np.asarray(g.edge_j), dtype=torch.int64),
        edge_q=f32(g.edge_q), edge_t=f32(g.edge_t), edge_info=f32(g.edge_info),
        edge_valid=torch.tensor(np.asarray(g.edge_valid)))


def test_edge_residual_zero_at_truth(rng):
    g, q_gt, t_gt = ring_graph(rng, drift=0.0)
    gg = to_port(g._replace(q=q_gt, t=t_gt))
    r, _, _ = pg._edge_terms(gg)
    np.testing.assert_allclose(r.numpy(), 0.0, atol=1e-5)


def test_pose_graph_corrects_drift(rng):
    g, q_gt, t_gt = ring_graph(rng, n=12, drift=0.03)
    init_err = np.linalg.norm(np.asarray(g.t) - np.asarray(t_gt), axis=1)
    assert init_err.max() > 0.05
    q, t, cost = pg.optimize_pose_graph(to_port(g), iters=25, device="cpu")
    assert float(cost) < 1e-6
    err = np.linalg.norm(t.numpy() - np.asarray(t_gt), axis=1)
    assert err.max() < 1e-3, err.max()


def zero_odometry_graph(rng, n=10):
    """Drifted poses on a ring; odometry edges measured at the current
    poses (zero residual), a loop edge from the last pose to the first
    at the ground truth's relative pose, higher information on the loop
    edge (the loop closer's 100 / 400)."""
    g, q_gt, t_gt = ring_graph(rng, n=n, drift=0.05)
    q, t = g.q, g.t
    ei = list(range(n - 1)) + [n - 1]
    ej = list(range(1, n)) + [0]
    eq, et = [], []
    for a, b in zip(ei[:-1], ej[:-1]):
        dq, dt = jse3.compose(q[a], t[a], *jse3.inverse(q[b], t[b]))
        eq.append(dq)
        et.append(dt)
    dq, dt = jse3.compose(q_gt[n - 1], t_gt[n - 1], *jse3.inverse(q_gt[0], t_gt[0]))
    eq.append(dq)
    et.append(dt)
    info = np.full((n, 6), 100.0, np.float32)
    info[-1] = 400.0
    return g._replace(
        edge_i=np.array(ei, np.int32), edge_j=np.array(ej, np.int32),
        edge_q=np.stack([np.asarray(x) for x in eq]).astype(np.float32),
        edge_t=np.stack([np.asarray(x) for x in et]).astype(np.float32),
        edge_info=info, edge_valid=np.ones(n, bool))


def _graphs(seed):
    rng = np.random.default_rng(seed)
    return {"ring": ring_graph(rng, n=12, drift=0.03)[0],
            "zero_odometry": zero_odometry_graph(rng)}


@pytest.mark.parametrize("kind", ["ring", "zero_odometry"])
@pytest.mark.parametrize("iters", [3, 15])
def test_pose_graph_matches_reference(kind, iters):
    import jax.numpy as jnp

    g = _graphs(7)[kind]
    jg = jpg.PoseGraph(*[jnp.asarray(np.asarray(x)) for x in g])
    qa, ta, ca = (np.asarray(x) for x in jpg.optimize_pose_graph(jg, iters=iters))
    qb, tb, cb = (x.numpy() for x in pg.optimize_pose_graph(to_port(g), iters=iters,
                                                                device="cpu"))
    np.testing.assert_allclose(qb, qa, atol=1e-4)
    np.testing.assert_allclose(tb, ta, atol=1e-4)
    if ca > 1e-3:
        np.testing.assert_allclose(cb, ca, rtol=1e-4)
    else:
        assert cb < 1e-3
    c0 = float(pg.optimize_pose_graph(to_port(g), iters=0, device="cpu")[2])
    assert float(cb) < c0


def test_zero_residual_jacobians_are_finite():
    g = to_port(zero_odometry_graph(np.random.default_rng(3)))
    r, Ji, Jj = pg._edge_terms(g)
    odo = slice(0, len(r) - 1)
    assert float(r[odo].abs().max()) < 1e-5
    assert torch.isfinite(Ji).all() and torch.isfinite(Jj).all()
    # at identity poses and an identity measurement the Jacobians are the
    # identity and its negative
    one = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    zero = torch.zeros(1, 3)
    z6 = torch.zeros(1, 6)
    ji, jj = (j[0] for j in pg._jacobians(z6, z6, one, zero, one, zero, one, zero))
    torch.testing.assert_close(ji, torch.eye(6), atol=1e-6, rtol=0)
    torch.testing.assert_close(jj, -torch.eye(6), atol=1e-6, rtol=0)
    # reverse mode agrees with forward mode at the zero residuals
    args = (g.q[g.edge_i][odo], g.t[g.edge_i][odo], g.q[g.edge_j][odo],
            g.t[g.edge_j][odo], g.edge_q[odo], g.edge_t[odo])
    zz = torch.zeros(len(args[0]), 6)
    rev = torch.func.vmap(torch.func.jacrev(pg._res, argnums=0))(zz, zz, *args)
    torch.testing.assert_close(rev, Ji[odo], atol=1e-5, rtol=1e-5)


def test_jax_jacobian_matches_port_at_zero_residual():
    g = zero_odometry_graph(np.random.default_rng(3))
    import jax.numpy as jnp

    jg = jpg.PoseGraph(*[jnp.asarray(np.asarray(x)) for x in g])
    _, ja, jb = (np.asarray(x) for x in jpg._edge_terms(jg))
    _, pa, pb = (x.numpy() for x in pg._edge_terms(to_port(g)))
    assert np.isfinite(ja).all()
    np.testing.assert_allclose(pa, ja, atol=1e-4)
    np.testing.assert_allclose(pb, jb, atol=1e-4)


def test_pose_graph_device_defaults_to_cuda():
    """The solve runs on `device` ("cuda" unless the caller asks for the
    CPU) and returns tensors there; without a card the default raises."""
    g = to_port(_graphs(1)["ring"])
    q, t, cost = pg.optimize_pose_graph(g, iters=2, device="cpu")
    assert q.device == t.device == cost.device == torch.device("cpu")
    assert torch.isfinite(se3.quat_normalize(q)).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pg.optimize_pose_graph(g, iters=2)
