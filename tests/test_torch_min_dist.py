"""The min-distance kernels of the port against the JAX Pallas kernels in
interpret mode and against their XLA reference. The pruned form (K1) is
held to its contract: the within-radius set is equal, values are exact
(atol 1e-4) where the truth is <= r^2, and no value is below the truth. The
unpruned difference form (K2) is held to the Pallas kernel at f32 rounding,
the Gram form (K3) at the reference's own tolerance for it (atol 2e-3,
rtol 1e-3).

The tests marked ``cuda`` import no JAX, so they also run on a machine with
a card and no JAX: ``python -m pytest tests/test_torch_min_dist.py -m cuda
--noconftest``."""
import numpy as np
import pytest
import torch

from seevcn_torch.ops.cuda import min_dist as MD
from seevcn_torch.ops.cuda.min_dist import (min_sqdist, min_sqdist_gram_plain,
                                          min_sqdist_plain, pairs_near_boxes,
                                          pruned_sweep_plain)
from seevcn_torch.testing import (K2_CARD_EDGES, K2_EDGES, k2_edge_case, to_numpy,
                                  to_torch)


def _wide_vs_clustered(seed, n, k_centres, per, r):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    centres = rng.uniform(-40, 40, (k_centres, 3)).astype(np.float32)
    b = (centres[:, None, :] + rng.uniform(-2, 2, (k_centres, per, 3))
         ).reshape(-1, 3).astype(np.float32)
    # queries scattered on the supports, so the within-radius set is not empty
    a[: n // 4] = b[rng.randint(0, len(b), n // 4)] + rng.uniform(
        -r, r, (n // 4, 3)).astype(np.float32)
    return a, b, None


def _case(name):
    rng = np.random.RandomState(10 + CASES.index(name))
    if name == "wide_vs_clustered":        # test_pallas_min_dist.py:56-74
        return (*_wide_vs_clustered(3, 2500, 4, 300, 0.8), 0.8)
    if name == "randn_scaled":             # test_pallas_min_dist.py:8-14
        return (rng.randn(700, 3).astype(np.float32) * 5,
                rng.randn(1300, 3).astype(np.float32) * 5, None, 1.0)
    if name == "invalid_rows":             # test_pallas_min_dist.py:77-84
        a = np.array([[10.0, 0, 0], [-30.0, 2, 1]], np.float32)
        b = np.array([[10.1, 0, 0], [15.0, 0, 0]], np.float32)
        return a, b, np.array([True, False]), 0.5
    if name == "tiny_ragged":              # N, M far from tile multiples
        return (rng.randn(3, 3).astype(np.float32),
                rng.randn(5, 3).astype(np.float32), None, 1.0)
    if name == "ragged_past_tiles":
        a, b, _ = _wide_vs_clustered(5, 1029, 3, 347, 0.3)
        valid = rng.rand(len(b)) > 0.2
        return a, b, valid, 0.3
    if name == "all_invalid":
        a, b, _ = _wide_vs_clustered(6, 300, 2, 100, 0.5)
        return a, b, np.zeros(len(b), bool), 0.5
    if name == "single_query":
        a, b, _ = _wide_vs_clustered(7, 4, 2, 600, 0.5)
        return a[:1], b, None, 0.5
    # K1 cases that its tiling by query rows never met
    if name == "clusters_random_order":    # 9 cars, rows in scan order
        a, b, _ = _wide_vs_clustered(8, 3000, 9, 700, 0.2)
        return a[rng.permutation(len(a))], b, rng.rand(len(b)) > 0.1, 0.2
    if name == "row_at_r_from_face":       # gap == r exactly: not pruned
        b = rng.uniform(0, 1, (96, 3)).astype(np.float32)
        b[40] = [0.0, 0.5, 0.5]            # on the face x = 0 of sub-tile 1
        b[:, 0] = np.maximum(b[:, 0], 0.0)
        a = np.array([[-0.5, 0.5, 0.5],    # exactly r from b[40]
                      [-0.5, 0.1, 0.9],    # r from the face, farther from b
                      [-0.5, 3.0, 0.5], [0.25, 0.25, 0.25]], np.float32)
        return a, b, None, 0.5
    if name == "near_two_clusters":        # rows within r of two cars
        b = np.concatenate([rng.uniform(-1, 0, (1024, 3)),
                            rng.uniform(0.3, 1.3, (1100, 3))]).astype(np.float32)
        a = np.stack([rng.uniform(-0.3, 0.6, 500), rng.uniform(0, 0.3, 500),
                      rng.uniform(-0.3, 0.3, 500)], 1).astype(np.float32)
        return a, b, None, 0.5
    if name == "ragged_n_m":               # N % 32 != 0, M % 32 != 0
        a, b, _ = _wide_vs_clustered(9, 45, 3, 333, 0.5)
        return a, b, rng.rand(len(b)) > 0.25, 0.5
    if name == "copies_of_one_row":        # 24k rows at one place
        b = (rng.uniform(-2, 2, (2000, 3)) + [20.0, -5.0, -1.0]).astype(np.float32)
        a = np.repeat(b[7:8] + np.float32(0.03), 24576, axis=0)
        return a, b, None, 0.1
    raise KeyError(name)


CASES = ["wide_vs_clustered", "randn_scaled", "invalid_rows", "tiny_ragged",
         "ragged_past_tiles", "all_invalid", "single_query",
         "clusters_random_order", "row_at_r_from_face", "near_two_clusters",
         "ragged_n_m", "copies_of_one_row"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _truth64(a, b, valid):
    d = ((a[:, None, :].astype(np.float64) - b[None].astype(np.float64)) ** 2
         ).sum(-1)
    if valid is not None:
        d = np.where(valid[None], d, np.inf)
    return d.min(1) if d.shape[1] else np.full(len(a), np.inf)


def assert_contract(got, truth, r):
    r2 = np.float32(r * r)
    got_in, ref_in = got <= r2, truth <= r2
    np.testing.assert_array_equal(got_in, ref_in)
    np.testing.assert_allclose(got[ref_in], truth[ref_in], atol=1e-4)
    finite = np.isfinite(truth)
    assert (got[finite] >= truth[finite] * (1 - 1e-5) - 1e-4).all()
    assert (got[~finite] >= 1e17).all()


@pytest.mark.parametrize("name", CASES)
def test_plain_and_dispatch_match_jax_on_contract(name):
    import jax.numpy as jnp

    from seevcn_tpu.ops.pallas.min_dist import min_sqdist as jax_min_sqdist
    from seevcn_tpu.ops.pallas.min_dist import min_sqdist_reference

    a, b, valid, r = _case(name)
    # precondition: no true distance within 1e-5 r^2 of the threshold, where
    # the Gram and difference forms could round to different sides, but for
    # distances of exactly r, which every f32 form gets exactly
    t64 = _truth64(a, b, valid)
    assert not ((np.abs(t64 - r * r) <= 1e-5 * r * r) & (t64 != r * r)).any()

    jv = None if valid is None else jnp.asarray(valid)
    jax_pruned = np.asarray(jax_min_sqdist(jnp.asarray(a), jnp.asarray(b),
                                           b_valid=jv, interpret=True,
                                           prune_radius=r))
    truth = np.asarray(min_sqdist_reference(jnp.asarray(a), jnp.asarray(b), jv))

    tv = None if valid is None else to_torch(valid)
    plain = to_numpy(min_sqdist_plain(to_torch(a), to_torch(b), tv))
    disp = to_numpy(min_sqdist(to_torch(a), to_torch(b), tv, prune_radius=r))

    np.testing.assert_array_equal(disp, plain)       # CPU dispatch = plain
    np.testing.assert_allclose(plain, truth, atol=1e-4, rtol=1e-5)
    assert_contract(plain, truth, r)
    assert_contract(jax_pruned, truth, r)            # the reference kernel too
    # the plain version of the card's route: its keys, order and sweep
    route, swept = pruned_sweep_plain(to_torch(a), to_torch(b), tv, r)
    assert_contract(to_numpy(route), truth, r)
    assert swept >= pairs_near_boxes(to_torch(a), to_torch(b), tv, r, 32)
    assert swept <= len(a) * -(-len(b) // 32) * 32
    r2 = np.float32(r * r)
    np.testing.assert_array_equal(plain <= r2, jax_pruned <= r2)
    inside = truth <= r2
    np.testing.assert_allclose(plain[inside], jax_pruned[inside], atol=1e-4)


def test_unported_forms_raise():
    # every form of the reference is ported; an unknown one still raises
    a = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="form"):
        min_sqdist(a, a, form="cosine")
    with pytest.raises(ValueError, match="form"):
        min_sqdist(a, a, form="cosine", prune_radius=0.1)
    assert min_sqdist(a, a).shape == (4,)
    assert min_sqdist(a, a, form="gram", prune_radius=0.1).shape == (4,)


def test_plain_is_chunk_invariant():
    a, b, _, r = _case("ragged_past_tiles")
    full = min_sqdist_plain(to_torch(a), to_torch(b))
    chunked = min_sqdist_plain(to_torch(a), to_torch(b), chunk=100)
    torch.testing.assert_close(chunked, full, rtol=0, atol=0)


# --- the pieces of K1's route, on the CPU --------------------------------------

def test_query_keys_first_near_tile_or_none():
    # tiles 0 and 2 overlap near the origin, tile 1 sits at x = 10, tile 2
    # is ragged (452 rows); a row near tiles 0 and 2 takes 0, none reads 3
    rng = np.random.RandomState(20)
    b = np.concatenate([rng.uniform(0, 1, (1024, 3)),
                        rng.uniform(0, 1, (1024, 3)) + [10.0, 0, 0],
                        rng.uniform(0, 1, (452, 3))]).astype(np.float32)
    boxes = MD.support_tile_boxes(to_torch(b))
    assert boxes.shape == (3, 6)
    a = np.array([[0.5, 0.5, 0.5], [10.5, 0.5, 0.5], [5.0, 0.5, 0.5],
                  [1.05, 0.5, 0.5], [11.2, 0.5, 0.5]], np.float32)
    hi0 = b[:1024, 0].max()
    a[3, 0] = hi0 + 0.05                   # 0.05 past tile 0's face
    keys = MD.query_keys(to_torch(a), boxes, 0.1)
    assert keys.dtype == torch.int32
    assert keys.tolist() == [0, 1, 3, 0, 3]
    assert MD.query_keys(to_torch(a), boxes[:0], 0.1).tolist() == [0] * 5


def test_pruned_order_and_its_inverse():
    keys = torch.tensor([3, 0, 2, 0, 3, 1, 0, 2], dtype=torch.int32)
    perm = MD.pruned_order(keys)
    assert perm.tolist() == [1, 3, 6, 5, 2, 7, 0, 4]    # stable within a key
    x = torch.arange(8.0) * 10
    back = torch.empty_like(x)
    back[perm] = x[perm]                   # the sweep's write to the row's place
    torch.testing.assert_close(back, x, rtol=0, atol=0)
    assert torch.equal(perm[torch.argsort(perm)], torch.arange(8))


def test_group_boxes_skip_invalid_rows_and_ragged_group():
    rng = np.random.RandomState(21)
    b = rng.uniform(-1, 1, (70, 3)).astype(np.float32)
    valid = np.ones(70, bool)
    b[5] = [50.0, -50.0, 50.0]             # invalid: must not widen group 0
    valid[5] = False
    valid[32:64] = False                   # group 1 has no valid row
    b[69] = [9.0, 9.0, 9.0]                # in the ragged group 2 (6 rows)
    got = to_numpy(MD.support_tile_boxes(to_torch(b), to_torch(valid), 32))
    assert got.shape == (3, 6)
    for g, rows in enumerate((range(0, 32), range(32, 64), range(64, 70))):
        ok = [j for j in rows if valid[j]]
        if not ok:
            assert (got[g, :3] == np.inf).all() and (got[g, 3:] == -np.inf).all()
            continue
        np.testing.assert_array_equal(got[g, :3], b[ok].min(0))
        np.testing.assert_array_equal(got[g, 3:], b[ok].max(0))
    assert got[2, 3] == 9.0 and got[0, 3] < 50.0


def test_pairs_near_boxes_hand_made():
    # groups of 2 rows over 5 support rows: boxes [0,1]x0x0, [10,11]x0x0,
    # and the ragged [20]x0x0; row 3 is invalid and widens nothing
    b = torch.tensor([[0.0, 0, 0], [1, 0, 0], [10, 0, 0], [99, 0, 0],
                      [20, 0, 0]])
    valid = torch.tensor([True, True, True, False, True])
    a = torch.tensor([[0.5, 0, 0], [1.3, 0, 0], [9.8, 0, 0], [20, 0.2, 0],
                      [50, 0, 0]])
    # row 0: group 0 (2 rows); row 1: none at r = 0.25; row 2: group 1
    # (2 rows, its invalid one counted); row 3: group 2 (1 row); row 4: none
    assert pairs_near_boxes(a, b, valid, 0.25, 2) == 2 + 2 + 1
    assert pairs_near_boxes(a, b, valid, 0.35, 2) == 2 + 2 + 2 + 1
    # all rows valid: row 3 (x = 99) widens group 1 over rows 3 and 4 too
    assert pairs_near_boxes(a, b, None, 0.25, 2) == 2 + 2 + (2 + 1) + 2
    assert pairs_near_boxes(a, b[:0], None, 1.0, 2) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(name, cuda_device):
    a, b, valid, r = _case(name)
    ta, tb = to_torch(a, cuda_device), to_torch(b, cuda_device)
    tv = None if valid is None else to_torch(valid, cuda_device)
    got = min_sqdist(ta, tb, tv, prune_radius=r)
    torch.cuda.synchronize()
    plain = min_sqdist_plain(ta, tb, tv)
    assert_contract(to_numpy(got), to_numpy(plain), r)
    # bit for bit the plain version of the route; its boxes, keys and order
    # as well
    route, _ = pruned_sweep_plain(ta, tb, tv, r)
    torch.testing.assert_close(got, route, rtol=0, atol=0)
    _, parts = MD._pruned_route_parts(ta, tb, tv, r)
    torch.testing.assert_close(parts["sub_box"],
                               MD.support_tile_boxes(tb, tv, MD.SUB), rtol=0, atol=0)
    torch.testing.assert_close(parts["tile_box"],
                               MD.support_tile_boxes(tb, tv, MD.TS), rtol=0, atol=0)
    keys = MD.query_keys(ta, parts["tile_box"], r)
    assert torch.equal(parts["keys"], keys)
    assert torch.equal(parts["perm"].long(), MD.pruned_order(keys))


# --- K2 (form="diff", no radius) and K3 (form="gram") ----------------------

def _dense_case(name):
    if name == "lidar_range":              # test_pallas_min_dist.py:35-44
        rng = np.random.RandomState(2)
        a = rng.randn(500, 3).astype(np.float32) * 3 + [45.0, -20.0, 0.0]
        b = rng.randn(900, 3).astype(np.float32) * 3 + [44.0, -19.0, 0.0]
        return a.astype(np.float32), b.astype(np.float32), None
    if name == "gram_invalid_rows":        # test_pallas_min_dist.py:47-53
        return (np.array([[10.0, 0, 0]], np.float32),
                np.array([[10.1, 0, 0], [15.0, 0, 0]], np.float32),
                np.array([False, True]))
    if name == "past_two_tiles":           # N, M past tile multiples, invalid rows
        rng = np.random.RandomState(4)
        a = rng.uniform(-30, 30, (2051, 3)).astype(np.float32)
        b = rng.uniform(-30, 30, (2305, 3)).astype(np.float32)
        return a, b, rng.rand(2305) > 0.3
    if name in K2_CARD_EDGES:
        return k2_edge_case(name)
    a, b, valid, _ = _case(name)
    return a, b, valid


DENSE_CASES = CASES + ["lidar_range", "gram_invalid_rows", "past_two_tiles"]
# on the card: K2 and K3 on every dense case, and K2 at the edges of its tiling
CARD_CASES = ([(name, form) for name in DENSE_CASES for form in ("diff", "gram")]
              + [(name, "diff") for name in K2_CARD_EDGES])
# K3 against the exact difference form: the reference's own tolerance for
# its Gram kernel (test_pallas_min_dist.py:44)
GRAM_ATOL, GRAM_RTOL = 2e-3, 1e-3


@pytest.mark.parametrize("form", ["diff", "gram"])
@pytest.mark.parametrize("name", DENSE_CASES)
def test_dense_forms_match_jax(name, form):
    import jax.numpy as jnp

    from seevcn_tpu.ops.pallas.min_dist import min_sqdist as jax_min_sqdist
    from seevcn_tpu.ops.pallas.min_dist import min_sqdist_reference

    a, b, valid = _dense_case(name)
    jv = None if valid is None else jnp.asarray(valid)
    jax_k = np.asarray(jax_min_sqdist(jnp.asarray(a), jnp.asarray(b),
                                      b_valid=jv, interpret=True, form=form))
    truth = np.asarray(min_sqdist_reference(jnp.asarray(a), jnp.asarray(b), jv))
    tv = None if valid is None else to_torch(valid)
    got = to_numpy(min_sqdist(to_torch(a), to_torch(b), tv, form=form))
    assert got.shape == (len(a),) and got.dtype == np.float32

    finite = np.isfinite(truth)
    if form == "diff":
        # the same f32 difference form as the Pallas kernel: only the
        # compiler's rounding of the sums can differ
        np.testing.assert_allclose(got, jax_k, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got[finite], truth[finite], rtol=1e-6,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got, jax_k, rtol=GRAM_RTOL, atol=GRAM_ATOL)
        np.testing.assert_allclose(got[finite], truth[finite],
                                   rtol=GRAM_RTOL, atol=GRAM_ATOL)
    # a support with no valid row: both routes give what the reference
    # kernel gives (every support row at 1e9, about 3e18), not the
    # reference's inf
    assert (np.isfinite(got[~finite]) & (got[~finite] > 1e18)).all()
    np.testing.assert_allclose(got[~finite], jax_k[~finite], rtol=1e-6)


def test_dense_forms_cpu_route_is_plain():
    a, b, valid = _dense_case("past_two_tiles")
    ta, tb, tv = to_torch(a), to_torch(b), to_torch(valid)
    far = torch.where(tv[:, None], tb, 1e9)
    torch.testing.assert_close(min_sqdist(ta, tb, tv), min_sqdist_plain(ta, far),
                               rtol=0, atol=0)
    torch.testing.assert_close(min_sqdist(ta, tb, tv, form="gram"),
                               min_sqdist_gram_plain(ta, tb, tv), rtol=0, atol=0)
    torch.testing.assert_close(min_sqdist_gram_plain(ta, tb, tv, chunk=97),
                               min_sqdist_gram_plain(ta, tb, tv), rtol=0, atol=0)
    # an empty support reads as the reference's tile padding: about 3e18
    empty = torch.zeros((0, 3))
    for form in ("diff", "gram"):
        d = min_sqdist(ta[:5], empty, form=form)
        assert torch.isfinite(d).all() and (d > 1e18).all()


# --- K2's tiling: the min on the distances' bits, over units of work -----------

def _f32(*vals):
    return np.array(vals, np.float32)


MIN_VALUES = np.concatenate([
    _f32(0.0, np.finfo(np.float32).smallest_subnormal, 1e-30, 1e18, 3e18, np.inf),
    np.random.RandomState(30).uniform(0, 100, 26).astype(np.float32)])


@pytest.mark.parametrize("seed", range(5))
def test_int_bit_min_is_float_min(seed):
    """K2 takes the min of two distances and the running min in one 3-input
    integer min of their bits: for values >= +0 (and +inf) the int32 view
    orders as the floats do, so the result is the float min, bit for bit."""
    v = MIN_VALUES[np.random.RandomState(seed).permutation(len(MIN_VALUES))]
    bits = v.view(np.int32)
    assert bits.min().view(np.float32) == v.min()
    assert bits.min().view(np.float32).tobytes() == v.min().tobytes()
    best = np.int32(0x7F800000)                      # +inf, where the kernel starts
    for d0, d1 in zip(bits[0::2], bits[1::2]):       # two pairs a step
        best = min(best, d0, d1)
    assert np.int32(best).view(np.float32).tobytes() == v.min().tobytes()
    # a pair's distance is never -0: (-0) * (-0) and the sums of +0 are +0
    z = to_torch(_f32(-0.0, 0.0))
    d = min_sqdist_plain(z[None, :1].repeat(1, 3), z[None, 1:].repeat(1, 3))
    assert d.view(torch.int32).item() == 0


def _k2_units(a, b, pad_row):
    """min_sqdist_plain over each unit of K2's work (K2_GROUP rows x K2_TILE
    support rows, the support padded to whole tiles with ``pad_row``),
    combined by the int min of the bits, as the kernel's atomicMin does. A
    block sweeps a run of units and a min is associative, so every cut of
    the units into runs gives these bits."""
    m = b.shape[0]
    bp = torch.cat([b, pad_row.expand((-m) % MD.K2_TILE, 3)])
    out = torch.full((a.shape[0],), 0x7F800000, dtype=torch.int32)
    for g in range(0, a.shape[0], MD.K2_GROUP):
        for t in range(0, bp.shape[0], MD.K2_TILE):
            part = min_sqdist_plain(a[g:g + MD.K2_GROUP], bp[t:t + MD.K2_TILE])
            out[g:g + MD.K2_GROUP] = torch.minimum(out[g:g + MD.K2_GROUP],
                                                   part.view(torch.int32))
    return out.view(torch.float32)


@pytest.mark.parametrize("name", K2_EDGES)
def test_k2_units_with_int_min_equal_plain(name):
    """The plain version over the whole support equals, bit for bit, the
    int-bit min of the plain version over K2's units, with the invalid rows
    pushed to 1e9 and the support padded with copies of its last row, as
    the kernel pads it. Padding rows at 1e9, as the TPU wrapper pads, would
    not: a query row at 1e9 would read 0."""
    a, b, valid = k2_edge_case(name)
    ta = to_torch(a)
    tb = MD.push_invalid(to_torch(b), None if valid is None else to_torch(valid))
    whole = min_sqdist_plain(ta, tb)
    assert torch.equal(_k2_units(ta, tb, tb[-1:]).view(torch.int32),
                       whole.view(torch.int32))
    assert torch.equal(min_sqdist(ta, to_torch(b), None if valid is None
                                  else to_torch(valid), form="diff"), whole)
    far = _k2_units(ta, tb, tb.new_full((1, 3), MD.FAR))
    if name == "queries_at_far":
        assert (far[-4:] == 0).all() and (whole[-4:] > 1e18).all()
    else:
        assert torch.equal(far, whole)


@pytest.mark.parametrize("name", K2_EDGES)
def test_k2_edges_match_jax(name):
    """K2's edges against the Pallas kernel in interpret mode, which pads
    the support to 1,024-row tiles with rows at 1e9: it agrees everywhere
    but at the query rows that sit at 1e9, where its padding reads 0."""
    import jax.numpy as jnp

    from seevcn_tpu.ops.pallas.min_dist import min_sqdist as jax_min_sqdist

    a, b, valid = k2_edge_case(name)
    jv = None if valid is None else jnp.asarray(valid)
    jax_k = np.asarray(jax_min_sqdist(jnp.asarray(a), jnp.asarray(b), b_valid=jv,
                                      interpret=True, form="diff"))
    got = to_numpy(min_sqdist(to_torch(a), to_torch(b), None if valid is None
                              else to_torch(valid), form="diff"))
    at_far = (a == np.float32(MD.FAR)).all(1)
    np.testing.assert_allclose(got[~at_far], jax_k[~at_far], rtol=1e-6, atol=1e-5)
    assert (jax_k[at_far] == 0).all() and (got[at_far] > 1e18).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name,form", CARD_CASES)
def test_dense_kernel_matches_plain_on_card(name, form, cuda_device):
    """K2 against its plain version on the same card, bit for bit, also at
    the edges of its tiling; K3 against its plain version and the exact
    difference form at the reference's tolerance."""
    from seevcn_torch.ops.cuda.min_dist import gram_inputs, push_invalid

    a, b, valid = _dense_case(name)
    ta, tb = to_torch(a, cuda_device), to_torch(b, cuda_device)
    tv = None if valid is None else to_torch(valid, cuda_device)
    got = min_sqdist(ta, tb, tv, form=form)
    torch.cuda.synchronize()
    if form == "diff":
        plain = min_sqdist_plain(ta, push_invalid(tb, tv))
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
    else:
        # the kernel fuses the multiply-adds the plain version rounds one by
        # one: both are held at the reference's Gram tolerance
        plain = min_sqdist_gram_plain(ta, tb, tv)
        torch.testing.assert_close(got, plain, rtol=GRAM_RTOL, atol=GRAM_ATOL)
        ga, gb = gram_inputs(ta, tb, tv)
        exact = min_sqdist_plain(ga, gb)
        ok = torch.isfinite(min_sqdist_plain(ta, tb, tv))
        torch.testing.assert_close(got[ok], exact[ok],
                                   rtol=GRAM_RTOL, atol=GRAM_ATOL)
