"""seevcn_torch VCN nets and inference chain against the flax models, with
the flax weights carried across by seevcn_torch.utils.weights. Outputs
agree within atol 1e-3 m / rtol 1e-4: f32 sums run in another order through
the 1024-wide layers. The partial-mesh and cluster steps, fed the same
coarse cloud, agree exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seevcn_tpu.models.vcn.inference import _forward_chain
from seevcn_tpu.models.vcn.nets import build_vcn as jax_build_vcn
from seevcn_torch.models.vcn.inference import VCNInference, forward_chain
from seevcn_torch.models.vcn.nets import build_vcn
from seevcn_torch.ops.clustering import largest_cluster_batch
from seevcn_torch.ops.sampling import partial_mesh_batch
from seevcn_torch.testing import assert_close, to_torch
from seevcn_torch.utils.weights import vcn_state_dict_from_flax

B, N, NC = 3, 128, 128


def _obj_points(rng, b=B, n=N):
    # test_reference_parity.py:74-81: objects spread over frustum angles
    pts = rng.randn(b, n, 3).astype(np.float32) * np.array(
        [1.8, 0.8, 0.6], np.float32)
    pts += np.array([12.0, 3.0, -0.5], np.float32)
    pts[1, :, 1] -= 8.0
    pts[2, :, 0] += 10.0
    return pts


def _gt_boxes(rng, b=B):
    return np.concatenate([rng.randn(b, 3) * 5 + [12, 0, -0.5],
                           rng.uniform(3.5, 4.5, (b, 1)),
                           rng.uniform(1.5, 2.0, (b, 2)),
                           rng.uniform(-np.pi, np.pi, (b, 1))],
                          1).astype(np.float32)


def flax_variables(name, seed, num_coarse=NC):
    """flax init, as numpy, with BatchNorm statistics and affine terms made
    non-trivial so the carried-over BN is exercised."""
    model = jax_build_vcn(name, num_coarse=num_coarse)
    inp = {"input": jnp.zeros((2, 64, 3))}
    if name.endswith("CN"):
        inp["gt_boxes"] = jnp.ones((2, 7))
    variables = jax.tree.map(np.asarray,
                             model.init(jax.random.PRNGKey(seed), inp))
    rng = np.random.RandomState(seed)

    def perturb(path, x):
        key = jax.tree_util.keystr(path)
        if "bn" not in key:
            return x
        if "var" in key:
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if "scale" in key:
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.mark.parametrize("name", ["VCN_VC", "VCN_CN"])
def test_vcn_forward_matches_flax(name):
    model, variables = flax_variables(name, 0)
    rng = np.random.RandomState(5)
    pts = _obj_points(rng)
    gt = _gt_boxes(rng)
    j_in = {"input": jnp.asarray(pts)}
    t_in = {"input": to_torch(pts)}
    if name.endswith("CN"):
        j_in["gt_boxes"] = jnp.asarray(gt)
        t_in["gt_boxes"] = to_torch(gt)
    ref = model.apply(variables, j_in)

    net = build_vcn(name, num_coarse=NC)
    net.load_state_dict(vcn_state_dict_from_flax(variables, name), strict=True)
    net.eval()
    with torch.no_grad():
        got = net(t_in)
    assert set(got) == set(ref)
    for k in ref:
        assert_close(got[k], ref[k], atol=1e-3, rtol=1e-4, name=k)


def test_forward_chain_steps_equal_given_coarse():
    model, variables = flax_variables("VCN_VC", 2)
    pts = _obj_points(np.random.RandomState(6))
    ref = np.asarray(_forward_chain(variables, jnp.asarray(pts), None,
                                    model=model, sel_k=30, eps=0.4))
    coarse, surface = ref[1], ref[2]
    # precondition: no surface pair within 1e-4 m of the cluster eps, where
    # the f32 Gram distances of the two frameworks could round apart
    d = np.sqrt(((surface[:, :, None].astype(np.float64)
                  - surface[:, None]) ** 2).sum(-1))
    assert not (np.abs(d - 0.4) < 1e-4).any()

    t_surface = partial_mesh_batch(to_torch(pts), to_torch(coarse), k=30,
                                   surface_pts=NC)
    assert_close(t_surface, surface, name="surface")
    t_clustered = largest_cluster_batch(t_surface, eps=0.4, min_points=2,
                                        total_pts=NC)
    assert_close(t_clustered, ref[3], name="clustered")

    # and the whole chain through VCNInference, weights carried across
    vcn = VCNInference("VCN_VC", vcn_state_dict_from_flax(variables, "VCN_VC"),
                       num_points=NC, device="cpu")
    out = vcn(to_torch(pts))
    assert out.shape == (4, B, NC, 3)
    assert_close(out[1], coarse, atol=1e-3, rtol=1e-4, name="coarse")
    assert_close(forward_chain(vcn.model, to_torch(pts))[0], pts)


def test_state_dict_keys_are_the_reference_names():
    _, variables = flax_variables("VCN_VC", 2)
    sd = vcn_state_dict_from_flax(variables, "VCN_VC")
    assert "encoder.mlp_conv1.0.weight" in sd
    assert sd["encoder.mlp_conv1.0.weight"].shape == (128, 3, 1)   # Conv1d
    assert sd["shape_fc.4.weight"].shape == (3 * NC, 1024)          # Linear
    assert sd["pose_fc.2.weight"].shape == (9, 512)
    assert set(sd) == set(build_vcn("VCN_VC", num_coarse=NC).state_dict())
