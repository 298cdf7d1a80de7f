"""seevcn_torch.ops.clustering against the JAX package on the CPU. Labels,
ids included, and cluster masks must be exactly equal; inputs are built
with no pair distance within 1e-3 of eps, where the two frameworks' f32
Gram distances could fall on different sides."""
import jax.numpy as jnp
import numpy as np
import pytest

from seevcn_tpu.ops import clustering as JCL
from seevcn_torch.ops import clustering as TCL
from seevcn_torch.testing import assert_close, to_torch


def _lattice_scene(seed, n, eps):
    """n points: jittered square lattice patches (spacing 0.6 eps, so the
    nearest non-neighbour sits at 1.2 eps), one long chain, and strays."""
    rng = np.random.RandomState(seed)
    s = 0.6 * eps
    pts = []
    for _ in range(3):
        w, h = rng.randint(2, 6, 2)
        gx, gy = np.meshgrid(np.arange(w), np.arange(h))
        patch = np.stack([gx.ravel() * s, gy.ravel() * s,
                          np.zeros(gx.size)], 1)
        pts.append(patch + rng.uniform(-8, 8, 3))
    chain = np.stack([np.arange(30) * s, np.zeros(30), np.zeros(30)], 1)
    pts.append(chain + [-12.0, 10.0, 1.0])
    pts = np.concatenate(pts)
    strays = rng.uniform(-15, 15, (n - len(pts), 3))
    pts = np.concatenate([pts, strays])[:n]
    pts = pts + rng.uniform(-0.01 * eps, 0.01 * eps, pts.shape)
    pts = pts[rng.permutation(n)].astype(np.float32)
    d = np.sqrt(((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1))
    assert not (np.abs(d - eps) < 1e-3).any()
    return pts


@pytest.mark.parametrize("min_points,n_iters", [(1, 12), (3, 12), (3, 3)])
def test_dbscan_labels_equal(min_points, n_iters):
    eps = 0.5
    pts = _lattice_scene(0, 128, eps)
    valid = np.random.RandomState(1).rand(128) > 0.1
    got = TCL.dbscan(to_torch(pts), eps, min_points=min_points,
                     valid=to_torch(valid), n_iters=n_iters)
    ref = JCL.dbscan(jnp.asarray(pts), eps, min_points=min_points,
                     valid=jnp.asarray(valid), n_iters=n_iters)
    assert_close(got.int(), np.asarray(ref).astype(np.int32))
    assert len(set(np.asarray(ref).tolist()) - {-1}) >= 4


def test_dbscan_batched_per_instance_eps():
    eps = np.array([0.3, 0.5, 0.7], np.float32)
    pts = np.stack([_lattice_scene(10 + i, 96, float(e))
                    for i, e in enumerate(eps)])
    valid = np.random.RandomState(2).rand(3, 96) > 0.1
    got = TCL.dbscan(to_torch(pts), to_torch(eps), min_points=3,
                     valid=to_torch(valid), n_iters=8)
    for i in range(3):
        ref = JCL.dbscan(jnp.asarray(pts[i]), jnp.asarray(eps[i]),
                         min_points=3, valid=jnp.asarray(valid[i]), n_iters=8)
        assert_close(got[i].int(), np.asarray(ref).astype(np.int32))


def test_largest_and_best_cluster_mask():
    # test_device_pipeline.py:205-224 scene: a 20-pt and a 30-pt cluster
    pts = np.zeros((64, 3), np.float32)
    pts[:20] = np.random.RandomState(0).randn(20, 3) * 0.03 + [5, 0, 0]
    pts[20:50] = np.random.RandomState(1).randn(30, 3) * 0.03 + [12, 3, 0]
    valid = np.zeros(64, bool)
    valid[:50] = True
    labels = np.asarray(JCL.dbscan(jnp.asarray(pts), 0.5, min_points=3,
                                   valid=jnp.asarray(valid)))
    tl = to_torch(labels.astype(np.int32))
    assert_close(TCL.largest_cluster_mask(tl),
                 JCL.largest_cluster_mask(jnp.asarray(labels)))
    w = np.zeros(64, np.int32)
    w[:20] = 1
    for weights in (w, np.zeros(64, np.int32)):
        assert_close(TCL.best_cluster_mask(tl, to_torch(weights)),
                     JCL.best_cluster_mask(jnp.asarray(labels),
                                           jnp.asarray(weights)))
    # equal-size clusters: the tie goes to the smallest id in both
    tie = np.array([3, 3, 7, 7, -1, 0, 0], np.int32)
    assert_close(TCL.largest_cluster_mask(to_torch(tie)),
                 JCL.largest_cluster_mask(jnp.asarray(tie)))


def _nearest_core_scene():
    # test_device_pipeline.py:256-278: a far strip with more core points
    # than the object, which is split into a near face and a roof
    rng = np.random.RandomState(0)
    face = rng.randn(40, 3).astype(np.float32) * 0.05 + [10, 0.5, -0.8]
    roof = rng.randn(35, 3).astype(np.float32) * 0.05 + [11.5, 0.5, 0.0]
    strip = rng.randn(60, 3).astype(np.float32) * 0.08 + [39, 2.5, -1.7]
    pts = np.concatenate([face, roof, strip]).astype(np.float32)
    labels = np.concatenate([np.zeros(40), np.full(35, 40),
                             np.full(60, 75)]).astype(np.int32)
    return pts, labels


@pytest.mark.parametrize("core_kind", ["all", "none", "strip_only", "mixed"])
def test_nearest_core_cluster_mask(core_kind):
    pts, labels = _nearest_core_scene()
    core = {"all": np.ones(135, bool), "none": np.zeros(135, bool),
            "strip_only": np.arange(135) >= 75,
            "mixed": np.random.RandomState(3).rand(135) > 0.6}[core_kind]
    got = TCL.nearest_core_cluster_mask(to_torch(labels), to_torch(core),
                                        to_torch(pts))
    ref = JCL.nearest_core_cluster_mask(jnp.asarray(labels),
                                        jnp.asarray(core), jnp.asarray(pts))
    assert_close(got, ref)


def test_nearest_core_cluster_mask_batched():
    pts, labels = _nearest_core_scene()
    cores = np.stack([np.ones(135, bool), np.zeros(135, bool),
                      np.arange(135) < 50])
    got = TCL.nearest_core_cluster_mask(
        to_torch(np.stack([labels] * 3)), to_torch(cores),
        to_torch(np.stack([pts] * 3)))
    for i in range(3):
        ref = JCL.nearest_core_cluster_mask(
            jnp.asarray(labels), jnp.asarray(cores[i]), jnp.asarray(pts))
        assert_close(got[i], ref)


def test_largest_cluster_batch():
    eps = 0.4
    pts = np.stack([_lattice_scene(20 + i, 128, eps) for i in range(3)])
    valid = np.random.RandomState(4).rand(3, 128) > 0.1
    valid[2] = False
    valid[2, :2] = True              # too few points: all noise -> fallback
    got = TCL.largest_cluster_batch(to_torch(pts), eps, min_points=2,
                                    total_pts=128, valid=to_torch(valid))
    ref = JCL.largest_cluster_batch(jnp.asarray(pts), eps, min_points=2,
                                    total_pts=128, valid=jnp.asarray(valid))
    assert_close(got, ref)
