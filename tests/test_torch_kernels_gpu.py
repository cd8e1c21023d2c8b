"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test skips where no CUDA device is present (decided
inside the fixture, never at import). On a machine with one, without
tests/conftest.py, which sets up JAX for the other tests:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from mal_tpu_torch.ops.cost_volume import compute_depth_bins, plane_sweep_terms
from mal_tpu_torch.ops.cuda import cost_volume_kernel as tk
from mal_tpu_torch.ops.cuda import deform_sample as k5
from mal_tpu_torch.ops.cuda import gauss_newton as gn
from mal_tpu_torch.ops.cuda import swin_block as k23
from mal_tpu_torch.ops.cuda import window_attention as k4
from mal_tpu_torch.segment.swin import shift_mask
from mal_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _poses(kind, BF, rng):
    """(BF, 1, 4, 4) poses. "random": translations up to 0.3 and the last
    pose missing (all zeros); the others drive K1 / K6 down each of their
    routes: "smeared": translations of 0.5, whose near planes smear a
    tile's corners across the image; "zero": every pose missing (x = 0, so
    every sample is masked); "behind": half turns about the vertical axis,
    which put every plane farther than the translation behind the camera
    (zh < 0) and project it back into the image."""
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (BF, 1, 4, 4)).copy()
    if kind == "random":
        poses[:, 0, :3, 3] = rng.uniform(-0.3, 0.3, (BF, 3))
        poses[-1] = 0.0
    elif kind == "smeared":
        poses[:, 0, :3, 3] = rng.uniform(-0.5, 0.5, (BF, 3))
        poses[:, 0, 0, 3] = np.where(np.arange(BF) % 2, 0.5, -0.5)
    elif kind == "zero":
        poses[:] = 0.0
    elif kind == "behind":
        for b in range(BF):
            a = np.pi + rng.uniform(-0.1, 0.1)
            poses[b, 0, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                   [-np.sin(a), 0, np.cos(a)]]
        poses[:, 0, :3, 3] = rng.uniform(-0.2, 0.2, (BF, 3))
    return poses


def _k1_inputs(BF, h, w, C, D, seed=0, kind="random", min_depth=0.1):
    rng = np.random.RandomState(seed)
    cur = torch.from_numpy(rng.uniform(0, 1, (BF, h, w, C)).astype(np.float32))
    lookup = torch.from_numpy(rng.uniform(0, 1, (BF, h, w, C)).astype(np.float32))
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    M, t = plane_sweep_terms(torch.from_numpy(_poses(kind, BF, rng)),
                             torch.from_numpy(np.broadcast_to(K, (BF, 4, 4)).copy()),
                             torch.from_numpy(np.broadcast_to(np.linalg.inv(K),
                                                              (BF, 4, 4)).copy()))
    return (cur, lookup, M.reshape(BF, 3, 3).contiguous(),
            t.reshape(BF, 3).contiguous(), compute_depth_bins(min_depth, 10.0, D))


# (BF, h, w, C, D): a ragged pixel count, few channels, the widest the
# kernel takes, and the main path's shape
@pytest.mark.parametrize("shape", [(3, 13, 21, 8, 8), (2, 9, 17, 256, 16),
                                   (12, 48, 160, 64, 96)])
def test_k1_matches_plain_version(cuda, shape):
    args = [a.to(cuda) for a in _k1_inputs(*shape)]
    before = tk.plane_sweep_diffs.launches
    out = tk.plane_sweep_diffs(*args)
    assert tk.plane_sweep_diffs.launches == before + 1
    plain = tk.plane_sweep_diffs_reference(*args, chunk=8)
    torch.cuda.synchronize()
    # the projection is bit-identical, so no border decision flips; the
    # channel sums round in another order
    assert ((out == 0) != (plain == 0)).sum().item() == 0
    torch.testing.assert_close(out, plain, rtol=0, atol=3e-5)


def test_k1_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cur, lookup, M, t, bins = [a.to(cuda) for a in _k1_inputs(2, 8, 12, 8, 8)]
    with pytest.raises(TypeError):
        tk.plane_sweep_diffs(cur.double(), lookup, M, t, bins)
    with pytest.raises(ValueError, match="contiguous"):
        tk.plane_sweep_diffs(cur.transpose(1, 2), lookup, M, t, bins)
    with pytest.raises(ValueError, match="multiple of 4"):
        tk.plane_sweep_diffs(cur[..., :6].contiguous(),
                             lookup[..., :6].contiguous(), M, t, bins)
    with pytest.raises(ValueError, match="is on"):
        tk.plane_sweep_diffs(cur, lookup.cpu(), M, t, bins)


def _k6_extra(BF, h, w, seed=0):
    """An occlusion mask with black patches and a mixed apply_occ (BF,)."""
    rng = np.random.RandomState(seed)
    occ = np.zeros((BF, h, w), np.float32)
    occ[:, h // 4:h // 2, w // 4:w // 2] = 1.0
    occ[:, rng.randint(0, h - 3), :] = 1.0
    apply_occ = (np.arange(BF) % 3 != 2).astype(np.float32)
    return torch.from_numpy(occ), torch.from_numpy(apply_occ)


# (BF, h, w, C, D, pool_th): a ragged pixel count, few channels, the widest
# the kernel takes, and DynamicDepth's shape and threshold
@pytest.mark.parametrize("shape", [(3, 13, 21, 8, 8, 0.7),
                                   (2, 9, 17, 256, 16, 0.15),
                                   (14, 48, 128, 64, 96, 0.15)])
def test_k6_matches_plain_version(cuda, shape):
    BF, h, w, C, D, pool_th = shape
    cur, lookup, M, t, bins = [a.to(cuda) for a in _k1_inputs(BF, h, w, C, D)]
    occ, apply_occ = [a.to(cuda) for a in _k6_extra(BF, h, w)]
    args = (cur, lookup, occ, apply_occ, M, t, bins, pool_th)
    before = tk.plane_sweep_diffs_occ.launches
    out = tk.plane_sweep_diffs_occ(*args)
    assert tk.plane_sweep_diffs_occ.launches == before + 1
    plain = tk.plane_sweep_diffs_occ_reference(*args, chunk=8)
    torch.cuda.synchronize()
    # as K1: the projection and the warped mask are bit-identical, so no
    # border and no occlusion decision flips, and an occluded sample's
    # value (mean |1 - cur|) is far from an open one's
    assert ((out == 0) != (plain == 0)).sum().item() == 0
    torch.testing.assert_close(out, plain, rtol=0, atol=3e-5)
    # the substitution fired, on the applied frames only (the last frame's
    # pose is missing: it samples nothing)
    open_ = tk.plane_sweep_diffs_occ_reference(
        cur, lookup, occ, torch.zeros_like(apply_occ), M, t, bins, pool_th,
        chunk=8)
    changed = (out - open_).abs().flatten(1).amax(1) > 1e-3
    sampled = (open_ != 0).flatten(1).any(1)
    assert changed.tolist() == (apply_occ.bool() & sampled).tolist()
    assert changed.any().item()


def _behind_inside(M, t, bins, h, w):
    """Samples inside the border masks whose plane lies behind the camera."""
    u = torch.arange(w, dtype=torch.float32, device=M.device)
    v = torch.arange(h, dtype=torch.float32, device=M.device)[:, None]
    m = M.reshape(-1, 9, 1, 1, 1)
    d = bins.reshape(1, -1, 1, 1)
    zh = d * (m[:, 6] * u + m[:, 7] * v + m[:, 8]) + t[:, 2, None, None, None]
    x = (d * (m[:, 0] * u + m[:, 1] * v + m[:, 2]) + t[:, 0, None, None, None]) / (zh + 1e-7)
    y = (d * (m[:, 3] * u + m[:, 4] * v + m[:, 5]) + t[:, 1, None, None, None]) / (zh + 1e-7)
    inside = ((x >= 2) & (x <= w - 2) & (y >= 2) & (y <= h - 2)
              & (u >= 2) & (u <= w - 3) & (v >= 2) & (v <= h - 3))
    return (inside & (zh < 0)).sum().item()


# (kind, BF, h, w, C, D, min_depth, the routes the case must reach): near
# planes that smear tiles past the shared-memory budget, a row of 9 and a
# width that is no multiple of the kernel's 32-pixel tiles, 4 channels, 256
# (whose boxes fit only on a narrow map), every pose missing, and planes
# behind the camera
ROUTE_CASES = {
    "smeared": ("smeared", 4, 48, 160, 64, 32, 0.02, ("staged", "direct")),
    "ragged": ("random", 3, 9, 45, 64, 16, 0.1, ("staged",)),
    "c4": ("random", 2, 24, 70, 4, 16, 0.1, ("staged",)),
    "c256": ("random", 2, 16, 64, 256, 16, 0.1, ("direct",)),
    "c256_narrow": ("random", 2, 16, 12, 256, 16, 0.1, ("staged",)),
    "zero_pose": ("zero", 2, 16, 40, 16, 8, 0.1, ("empty",)),
    "behind": ("behind", 2, 24, 80, 32, 16, 0.1, ("staged",)),
}


def _check_routes(name, routes, M, t, bins, h, w, C, occ):
    """The kernel's tiles by route equal plane_sweep_routes' count, and
    the case reaches the routes it is there for."""
    want = tk.plane_sweep_routes(M, t, bins, h, w, C, occ=occ)
    got = dict(zip(tk.ROUTES, routes.tolist()))
    assert got == want
    assert all(got[r] > 0 for r in ROUTE_CASES[name][-1])
    if name == "zero_pose":
        assert got["staged"] == got["direct"] == 0
    if name == "behind":
        assert _behind_inside(M, t, bins, h, w) > 0


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_k1_routes_match_plain_version(cuda, name):
    kind, BF, h, w, C, D, min_depth, _ = ROUTE_CASES[name]
    cur, lookup, M, t, bins = [a.to(cuda) for a in _k1_inputs(
        BF, h, w, C, D, kind=kind, min_depth=min_depth)]
    routes = torch.zeros(len(tk.ROUTES), dtype=torch.int32, device=cuda)
    out = tk.plane_sweep_diffs(cur, lookup, M, t, bins, routes=routes)
    plain = tk.plane_sweep_diffs_reference(cur, lookup, M, t, bins, chunk=8)
    torch.cuda.synchronize()
    assert ((out == 0) != (plain == 0)).sum().item() == 0
    torch.testing.assert_close(out, plain, rtol=0, atol=3e-5)
    _check_routes(name, routes, M, t, bins, h, w, C, occ=False)


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_k6_routes_match_plain_version(cuda, name):
    kind, BF, h, w, C, D, min_depth, _ = ROUTE_CASES[name]
    cur, lookup, M, t, bins = [a.to(cuda) for a in _k1_inputs(
        BF, h, w, C, D, kind=kind, min_depth=min_depth)]
    occ, apply_occ = [a.to(cuda) for a in _k6_extra(BF, h, w)]
    pool_th = 0.15
    args = (cur, lookup, occ, apply_occ, M, t, bins, pool_th)
    routes = torch.zeros(len(tk.ROUTES), dtype=torch.int32, device=cuda)
    out = tk.plane_sweep_diffs_occ(*args, routes=routes)
    plain = tk.plane_sweep_diffs_occ_reference(*args, chunk=8)
    torch.cuda.synchronize()
    assert ((out == 0) != (plain == 0)).sum().item() == 0
    torch.testing.assert_close(out, plain, rtol=0, atol=3e-5)
    # occlusion decisions: where the occluded value (every sample occluded)
    # and the open one (none) are well apart, which of them each side gave
    occluded = tk.plane_sweep_diffs_occ_reference(
        cur, lookup, torch.ones_like(occ), torch.ones_like(apply_occ), M, t,
        bins, pool_th, chunk=8)
    open_ = tk.plane_sweep_diffs_occ_reference(
        cur, lookup, occ, torch.zeros_like(apply_occ), M, t, bins, pool_th,
        chunk=8)
    apart = (occluded - open_).abs() > 3e-3

    def chose_occluded(x):
        return (x - occluded).abs() < (x - open_).abs()

    assert (apart & (chose_occluded(out) != chose_occluded(plain))).sum().item() == 0
    if name != "zero_pose":
        assert (apart & chose_occluded(plain)).any().item()
    _check_routes(name, routes, M, t, bins, h, w, C, occ=True)


def test_k6_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cur, lookup, M, t, bins = [a.to(cuda) for a in _k1_inputs(2, 8, 12, 8, 8)]
    occ, apply_occ = [a.to(cuda) for a in _k6_extra(2, 8, 12)]
    with pytest.raises(ValueError, match="do not fit"):
        tk.plane_sweep_diffs_occ(cur, lookup, occ[:, :4].contiguous(),
                                 apply_occ, M, t, bins, 0.15)
    with pytest.raises(TypeError):
        tk.plane_sweep_diffs_occ(cur, lookup, occ.double(), apply_occ, M, t,
                                 bins, 0.15)
    with pytest.raises(ValueError, match="is on"):
        tk.plane_sweep_diffs_occ(cur, lookup, occ, apply_occ.cpu(), M, t,
                                 bins, 0.15)


def _k4_case(cuda, Hp, Wp, images, ws, heads, shifted, seed):
    """Seeded K4 inputs for `images` maps of Hp x Wp in ws x ws windows."""
    rng = np.random.RandomState(seed)
    N, nm = ws * ws, (Hp // ws) * (Wp // ws)
    qkv = torch.from_numpy(rng.randn(nm * images, N, 3 * heads * 32)
                           .astype(np.float32)).to(cuda)
    table = torch.from_numpy((0.1 * rng.randn((2 * ws - 1) ** 2, heads))
                             .astype(np.float32)).to(cuda)
    mask = shift_mask(Hp, Wp, ws, ws // 2, cuda) if shifted else None
    return qkv, table, mask


def _k4_check(qkv, table, mask, heads, route=None):
    before = k4.window_attention.launches
    out = k4.window_attention(qkv, table, mask, heads, route=route)
    assert k4.window_attention.launches == before + 1
    plain = k4.window_attention_reference(qkv, table, mask, heads)
    torch.cuda.synchronize()
    # outputs of O(1): softmax sums and 32-wide products in another order
    torch.testing.assert_close(out, plain, rtol=0, atol=2e-5)


# (windows per image, images, window size, heads, shifted): Swin-T's window
# (the loop kernel) with and without a mask, Swin-L's (the tiled kernel)
# with and without one, and a window of 25 tokens (a ragged warp)
@pytest.mark.parametrize("nm,images,ws,heads,shifted", [
    (1, 5, 7, 3, False), (4, 3, 12, 6, True), (4, 2, 5, 2, True),
    (4, 2, 7, 3, True), (1, 3, 12, 4, False), (1, 3, 5, 2, False)])
def test_k4_matches_plain_version(cuda, nm, images, ws, heads, shifted):
    side = ws if nm == 1 else 2 * ws
    _k4_check(*_k4_case(cuda, side, side, images, ws, heads, shifted, ws),
              heads)


# the four Swin-L stages at 192x640 (padded maps, heads, shifted), at one
# and two images: one block of the tiled kernel takes several heads of one
# window, and its range of (window, head) pairs starts and ends mid-window
@pytest.mark.parametrize("images", [1, 2])
@pytest.mark.parametrize("Hp,Wp,heads,shifted", [
    (48, 168, 6, True), (24, 84, 12, True), (12, 48, 24, False),
    (12, 24, 48, False)])
def test_k4_at_the_swin_l_stages(cuda, Hp, Wp, heads, shifted, images):
    assert k4.TILED_WINDOW == 12
    _k4_check(*_k4_case(cuda, Hp, Wp, images, 12, heads, shifted, heads),
              heads)


# the four Swin-T stages of MaskFormer v1 at 256x448 (padded maps, heads),
# each shifted and not, at two images: the w7 kernel, chosen by
# `window_attention_route`, and the loop kernel it replaced
@pytest.mark.parametrize("shifted", [True, False])
@pytest.mark.parametrize("Hp,Wp,heads", [(70, 112, 3), (35, 56, 6),
                                         (21, 28, 12), (14, 14, 24)])
def test_k4_w7_at_the_swin_t_stages(cuda, Hp, Wp, heads, shifted):
    assert k4.window_attention_route(7) == "w7"
    qkv, table, mask = _k4_case(cuda, Hp, Wp, 2, 7, heads, shifted, heads)
    _k4_check(qkv, table, mask, heads)
    _k4_check(qkv, table, mask, heads, route="loop")


# window 8, which no model runs: the loop route, shifted and not
@pytest.mark.parametrize("shifted", [True, False])
def test_k4_loop_route_at_window_8(cuda, shifted):
    assert k4.window_attention_route(8) == "loop"
    _k4_check(*_k4_case(cuda, 16, 24, 2, 8, 2, shifted, 8), 2)


def test_k4_route_must_take_the_window(cuda):
    qkv, table, mask = _k4_case(cuda, 14, 14, 1, 7, 2, True, 0)
    with pytest.raises(ValueError, match="route 'tiled'"):
        k4.window_attention(qkv, table, mask, 2, route="tiled")


def test_k4_adds_the_masks_own_value(cuda):
    """The tiled kernel keeps the mask as bits and its one non-zero value:
    a mask of -50 is added as -50."""
    qkv, table, mask = _k4_case(cuda, 24, 24, 2, 12, 3, True, 0)
    _k4_check(qkv, table, 0.5 * mask, 3)


def test_k4_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    qkv = torch.zeros(4, 49, 3 * 64, device=cuda)
    table = torch.zeros(169, 2, device=cuda)
    with pytest.raises(ValueError, match="heads"):
        k4.window_attention(qkv, table, None, 3)
    with pytest.raises(ValueError, match="square"):
        k4.window_attention(qkv[:, :48].contiguous(), table, None, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k4.window_attention(qkv.transpose(0, 1), table, None, 2)


# (B, Lq, heads, ch, levels, points, channels a staged block takes): a small
# set with 4 levels and 8-wide channels, the pixel decoder's 3 levels x 4
# points at 32 channels on 600 queries and at the main path's 2520 (at B =
# 2; neither a multiple of a round's 256 queries, kStagedThreads), and two
# slices too large for shared memory at 8 channels (10,240 and 16,384
# tokens): the gather kernel
@pytest.mark.parametrize("B,Lq,heads,ch,shapes,P,plan", [
    (2, 37, 4, 8, [(6, 10), (3, 5), (2, 3), (1, 2)], 2, 8),
    (2, 600, 8, 32, [(6, 20), (12, 40), (24, 80)], 4, 8),
    (2, 2520, 8, 32, [(6, 20), (12, 40), (24, 80)], 4, 8),
    (1, 300, 2, 8, [(64, 128), (32, 64)], 4, None),
    (1, 50, 2, 8, [(128, 128)], 2, None)])
def test_k5_matches_plain_version(cuda, B, Lq, heads, ch, shapes, P, plan):
    rng = np.random.RandomState(Lq)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    assert k5.staged_channels(S, ch, P) == plan
    value = torch.from_numpy(rng.randn(B, S, heads, ch).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(-0.2, 1.2, (B, Lq, heads, L, P, 2))
                            .astype(np.float32))
    aw = torch.from_numpy(rng.uniform(0, 1, (B, Lq, heads, L, P))
                          .astype(np.float32))
    args = [value.to(cuda), shapes, locs.to(cuda), aw.to(cuda)]
    before = k5.ms_deform_attn_core.launches
    out = k5.ms_deform_attn_core(*args)
    assert k5.ms_deform_attn_core.launches == before + 1
    plain = k5.ms_deform_attn_core_per_level(*args)
    torch.cuda.synchronize()
    # sample coordinates rounded in another order (x * w - 0.5 against
    # grid_sample's ((2x - 1 + 1) * w - 1) / 2) move bilinear weights by
    # ~1e-7 relative of the coordinate, on values of O(1) summed over up
    # to 32 samples
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-4)


def test_k5_skips_corners_outside_the_map(cuda):
    """A corner outside a level's map adds nothing, as in grid_sample: a
    non-finite value at a token that no sample takes as an inside corner
    (each level's first, top left) reaches no output."""
    rng = np.random.RandomState(5)
    shapes = [(6, 20), (12, 40), (24, 80)]
    B, Lq, heads, ch, L, P = 1, 300, 8, 32, 3, 4
    S = sum(h * w for h, w in shapes)
    assert k5.staged_channels(S, ch, P) == 8
    value = rng.randn(B, S, heads, ch).astype(np.float32)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        value[:, start] = (np.inf, np.nan, -np.inf)[lvl]
        start += h * w
    # x * w - 0.5 >= 3 and y * h - 0.5 >= 1 at every level: token 0 is
    # never a corner, and the corners past the far edges are outside
    locs = rng.uniform(0.6, 1.3, (B, Lq, heads, L, P, 2)).astype(np.float32)
    aw = rng.uniform(0, 1, (B, Lq, heads, L, P)).astype(np.float32)
    args = [torch.from_numpy(value).to(cuda), shapes,
            torch.from_numpy(locs).to(cuda), torch.from_numpy(aw).to(cuda)]
    out = k5.ms_deform_attn_core(*args)
    plain = k5.ms_deform_attn_core_per_level(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(plain).all()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-4)


def test_k5_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    value = torch.zeros(1, 6, 2, 8, device=cuda)
    locs = torch.zeros(1, 3, 2, 1, 2, 2, device=cuda)
    aw = torch.zeros(1, 3, 2, 1, 2, device=cuda)
    with pytest.raises(ValueError, match="do not sum"):
        k5.ms_deform_attn_core(value, [(2, 2)], locs, aw)
    with pytest.raises(TypeError):
        k5.ms_deform_attn_core(value.double(), [(2, 3)], locs, aw)
    with pytest.raises(ValueError, match="is on"):
        k5.ms_deform_attn_core(value, [(2, 3)], locs.cpu(), aw)


def _block_params(C, heads, ws, hidden, seed):
    """Seeded K2 / K3 parameters in nn.Linear's layout."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (shift + scale * rng.randn(*shape)).astype(np.float32))

    return {"ln_s": t(C, scale=0.1, shift=1.0), "ln_b": t(C, scale=0.1),
            "wqkv": t(3 * C, C, scale=C ** -0.5), "bqkv": t(3 * C, scale=0.1),
            "table": t((2 * ws - 1) ** 2, heads, scale=0.5),
            "wproj": t(C, C, scale=C ** -0.5), "bproj": t(C, scale=0.1),
            "w1": t(hidden, C, scale=C ** -0.5), "b1": t(hidden, scale=0.1),
            "w2": t(C, hidden, scale=hidden ** -0.5), "b2": t(C, scale=0.1)}


def _close_in(dtype, out, plain):
    """fp32: sums in another order and erff against torch.erf, on outputs
    of O(1). bf16: both round at the same places, so an output moves by an
    ulp or two (2^-8 of its binade) where an fp32 sum in another order
    crosses a rounding boundary, and on average hardly at all."""
    assert out.dtype == plain.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(out, plain, rtol=0, atol=2e-4)
    else:
        torch.testing.assert_close(out.float(), plain.float(), rtol=2 ** -6,
                                   atol=2 ** -6)
        assert (out.float() - plain.float()).abs().mean().item() <= 3e-4


# (B, H, W, C, heads, window, shifted): Swin-T's window on a padded map with
# a ragged row count, Swin-L's on a shifted and padded one, a wide block on
# a map one window high, and a window size the tensor-core attention core is
# not built for (in bf16 it takes the fp32 loop); then Swin-L's stage 0 on a
# map ragged both ways, with enough windows that a core block takes two heads
# of one window (its mask staged once, the second head's q, k, v loaded while
# the first is multiplied) and writes both back in stream order
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,heads,ws,shifted", [
    (3, 16, 24, 96, 3, 7, True), (2, 24, 40, 192, 6, 12, True),
    (2, 6, 20, 768, 24, 12, False), (2, 10, 13, 64, 2, 5, True),
    (4, 45, 161, 192, 6, 12, True)])
def test_k2_matches_plain_version(cuda, B, H, W, C, heads, ws, shifted, dtype):
    p = {k: v.to(cuda) for k, v in _block_params(C, heads, ws, 4 * C, C).items()}
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    x = torch.from_numpy(np.random.RandomState(H).randn(B, H, W, C)
                         .astype(np.float32)).to(cuda)
    xr = torch.nn.functional.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
    valid = torch.nn.functional.pad(torch.ones(H, W, device=cuda),
                                    (0, Wp - W, 0, Hp - H))
    mask = None
    if shifted:
        xr = torch.roll(xr, (-ws // 2, -ws // 2), dims=(1, 2))
        valid = torch.roll(valid, (-ws // 2, -ws // 2), dims=(0, 1))
        mask = shift_mask(Hp, Wp, ws, ws // 2, cuda)
    args = (xr.to(dtype).contiguous(), valid.contiguous(), p["ln_s"],
            p["ln_b"], p["wqkv"], p["bqkv"], p["table"], mask, p["wproj"],
            p["bproj"])
    kwargs = dict(window_size=ws, num_heads=heads, compute_dtype=dtype)
    before = k23.swin_attn_fused.launches
    out = k23.swin_attn_fused(*args, **kwargs)
    assert k23.swin_attn_fused.launches == before + 1
    plain = k23.swin_attn_reference(*args, **kwargs)
    torch.cuda.synchronize()
    _close_in(dtype, out, plain)


# (tokens, C): a ragged token count, a row count below one tile, Swin-L's
# widest block; then, for the bf16 kernels, the fused MLP at each of its
# widths (64, 192 on a ragged count of 128-token tiles, 256), the two-GEMM
# form on the 192-wide GEMM tiles at C = 384 and at Swin-L's stage-3 size,
# whose fc2 has fewer tiles (96) than the card has SMs
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens,C", [
    (1000, 96), (77, 192), (300, 1536), (513, 64), (4099, 192), (600, 256),
    (2000, 384), (1440, 1536)])
def test_k3_matches_plain_version(cuda, tokens, C, dtype):
    p = {k: v.to(cuda) for k, v in _block_params(C, 1, 1, 4 * C, C).items()}
    x = torch.from_numpy(np.random.RandomState(C).randn(tokens, C)
                         .astype(np.float32)).to(cuda).to(dtype)
    args = (x, p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"], p["b2"])
    before = k23.swin_mlp_fused.launches
    out = k23.swin_mlp_fused(*args, compute_dtype=dtype)
    assert k23.swin_mlp_fused.launches == before + 1
    plain = k23.swin_mlp_reference(*args, compute_dtype=dtype)
    torch.cuda.synchronize()
    _close_in(dtype, out, plain)


def test_k2_k3_with_an_fp32_stream_and_bf16_products(cuda):
    """The third combination the kernels take: an fp32 stream with the bf16
    compute type (a fused block called outside a bf16 stage)."""
    C, heads, ws = 96, 3, 7
    p = {k: v.to(cuda) for k, v in _block_params(C, heads, ws, 4 * C, 3).items()}
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 14, 21, C)
                         .astype(np.float32)).to(cuda)
    valid = torch.ones(14, 21, device=cuda)
    args = (x, valid, p["ln_s"], p["ln_b"], p["wqkv"], p["bqkv"], p["table"],
            None, p["wproj"], p["bproj"])
    kwargs = dict(window_size=ws, num_heads=heads, compute_dtype=torch.bfloat16)
    out = k23.swin_attn_fused(*args, **kwargs)
    plain = k23.swin_attn_reference(*args, **kwargs)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, plain, rtol=2 ** -6, atol=2 ** -6)
    args = (x.reshape(-1, C), p["ln_s"], p["ln_b"], p["w1"], p["b1"], p["w2"],
            p["b2"])
    out = k23.swin_mlp_fused(*args, compute_dtype=torch.bfloat16)
    plain = k23.swin_mlp_reference(*args, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(out, plain, rtol=2 ** -6, atol=2 ** -6)


def test_k2_k3_wrappers_reject_what_the_kernels_do_not_take(cuda):
    C, heads, ws = 96, 3, 7
    p = {k: v.to(cuda) for k, v in _block_params(C, heads, ws, 4 * C, 1).items()}
    x = torch.zeros(1, 14, 14, C, device=cuda)
    valid = torch.ones(14, 14, device=cuda)

    def attn(x=x, valid=valid, heads=heads, dt=torch.float32, **over):
        q = dict(p, **over)
        return k23.swin_attn_fused(
            x, valid, q["ln_s"], q["ln_b"], q["wqkv"], q["bqkv"], q["table"],
            None, q["wproj"], q["bproj"], window_size=ws, num_heads=heads,
            compute_dtype=dt)

    with pytest.raises(TypeError, match="bfloat16 stream"):
        attn(x=x.bfloat16())
    with pytest.raises(TypeError, match="compute_dtype"):
        attn(dt=torch.float16)
    with pytest.raises(ValueError, match="heads"):
        attn(heads=2)
    with pytest.raises(ValueError, match="tile"):
        attn(x=x[:, :13].contiguous(), valid=valid[:13].contiguous())
    with pytest.raises(TypeError, match="wqkv"):
        attn(wqkv=p["wqkv"].bfloat16())
    with pytest.raises(ValueError, match="is on"):
        attn(valid=valid.cpu())
    with pytest.raises(ValueError, match="multiples"):
        k23.swin_mlp_fused(torch.zeros(8, 48, device=cuda), p["ln_s"][:48],
                           p["ln_b"][:48], p["w1"][:, :48].contiguous(),
                           p["b1"], p["w2"][:48].contiguous(), p["b2"][:48])


@pytest.mark.parametrize("G,T,S,ch,shapes", [
    (3, 2, 300, 8, ((2, 3), (3, 5), (6, 10))),
    (16, 1, 2048, 32, ((6, 20), (12, 40), (24, 80)))])
def test_k5b_matches_plain_version(cuda, G, T, S, ch, shapes):
    rng = np.random.RandomState(S)
    vms = [torch.from_numpy(rng.randn(G, h * ch, w).astype(np.float32)).to(cuda)
           for h, w in shapes]
    x, y = (torch.from_numpy(rng.uniform(-0.2, 1.2, (G, T, 3, S))
                             .astype(np.float32)).to(cuda) for _ in range(2))
    aw = torch.from_numpy(rng.uniform(0, 1, (G, T, 3, S))
                          .astype(np.float32)).to(cuda)
    before = k5.deform_sample_fused.launches
    out = k5.deform_sample_fused(*vms, x, y, aw, shapes, ch)
    assert k5.deform_sample_fused.launches == before + 1
    plain = k5.deform_sample_fused_reference(*vms, x, y, aw, shapes, ch)
    torch.cuda.synchronize()
    # x * w - 0.5 contracted into one rounding in the kernel moves a
    # coordinate by an ulp, and a bilinear weight with it, on values of O(1)
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="level values"):
        k5.deform_sample_fused(vms[1], vms[1], vms[2], x, y, aw, shapes, ch)


# (G, T, S, ch, levels): the pixel decoder's levels at 192x640 (every width
# a multiple of 4: float4 staging) and odd widths (4-byte staging), each on
# both routes; the staged one is the default where a slice fits
@pytest.mark.parametrize("route", ["staged", "gather"])
@pytest.mark.parametrize("G,T,S,ch,shapes", [
    (8, 2, 2048, 32, ((6, 20), (12, 40), (24, 80))),
    (4, 3, 333, 16, ((5, 7), (6, 13), (10, 21)))])
def test_k5b_routes_match_plain_version(cuda, G, T, S, ch, shapes, route):
    assert k5.major_staged_channels(sum(h * w for h, w in shapes), ch) == 8
    rng = np.random.RandomState(S + ch)
    vms = [torch.from_numpy(rng.randn(G, h * ch, w).astype(np.float32)).to(cuda)
           for h, w in shapes]
    x, y, aw = (torch.from_numpy(rng.uniform(-0.2, 1.2, (G, T, 3, S))
                                 .astype(np.float32)).to(cuda) for _ in range(3))
    before = k5.deform_sample_fused.launches
    out = k5.deform_sample_fused(*vms, x, y, aw, shapes, ch, route=route)
    assert k5.deform_sample_fused.launches == before + 1
    plain = k5.deform_sample_fused_reference(*vms, x, y, aw, shapes, ch)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-4)
    # the staged kernel does the gather kernel's arithmetic: the same bits
    other = "gather" if route == "staged" else "staged"
    assert torch.equal(out, k5.deform_sample_fused(*vms, x, y, aw, shapes,
                                                   ch, route=other))


def test_k5b_staged_route_must_fit(cuda):
    vms = [torch.zeros(1, 12 * h, w, device=cuda) for h, w in ((1, 2),) * 3]
    x = torch.zeros(1, 1, 3, 4, device=cuda)
    with pytest.raises(ValueError, match="route 'staged'"):
        k5.deform_sample_fused(*vms, x, x, x, ((1, 2),) * 3, 12,
                               route="staged")


@pytest.mark.parametrize("name", ["plane_sweep_diffs", "plane_sweep_diffs_occ",
                                  "swin_attn_fused", "swin_mlp_fused",
                                  "window_attention", "ms_deform_attn_core",
                                  "deform_sample_fused"])
def test_wrapper_refuses_a_gradient_on_the_card(cuda, name):
    """tests/test_torch_grad_guard.py's check on CUDA tensors: the kernel
    runs under no_grad, and a gradient-requiring input raises before any
    launch."""
    from test_torch_grad_guard import check_guard

    check_guard(name, cuda)


def _gn_inputs(B, C, h, w, weights="uniform", seed=0):
    """(f, src_feat, J_pixel_xi, wmap) of DualRefine's Gauss-Newton step,
    float64 on the CPU, with the main path's magnitudes (features in
    [0, 1], fx ~ fy ~ 92, points 2-20 m deep). `weights`: "uniform" in
    [0, 1]; "zeros": a third of the pixels 0 and the last element all 0;
    "robust": the uniform weights times the Barron weight of the squared
    residual and a border mask, as `direct_align` composes them."""
    from mal_tpu_torch.dualref.pose_update import barron_weight

    rng = np.random.RandomState(seed)
    N = h * w
    f = rng.uniform(0, 1, (B, C, 5, N))
    src = rng.uniform(0, 1, (B, C, N))
    X, Y = rng.uniform(-10, 10, (2, B, N))
    Z = rng.uniform(2, 20, (B, N))
    fx, fy = 92.8, 92.2
    jx = np.stack([fx / Z, 0 * Z, -fx * X / Z ** 2, -fx * X * Y / Z ** 2,
                   fx + fx * X * X / Z ** 2, -fx * Y / Z], -1)
    jy = np.stack([0 * Z, fy / Z, -fy * Y / Z ** 2, -fy - fy * Y * Y / Z ** 2,
                   fy * X * Y / Z ** 2, fy * X / Z], -1)
    wmap = rng.uniform(0, 1, (B, N))
    if weights == "zeros":
        wmap[:, ::3] = 0.0
        wmap[-1] = 0.0
    elif weights == "robust":
        cost = ((src - f[:, :, 0]) ** 2).sum(1)
        border = np.zeros((h, w))
        border[2:h - 2, 2:w - 2] = 1.0
        wmap = (wmap * barron_weight(torch.tensor(cost)).numpy()
                * border.reshape(1, N))
    return [torch.tensor(a) for a in (f, src, np.stack([jx, jy], 2), wmap)]


def _rel_err(x, truth):
    """max |x - truth| as a share of truth's largest entry; where truth is
    all 0, max |x| (0 only where x is 0 too)."""
    scale = truth.abs().max()
    err = (x.double() - truth).abs().max()
    return float(err / scale if scale > 0 else err)


# DualRefine's KITTI shape (batch 12, 64 channels, 48 x 160), and a ragged
# one: one element, K = 5 x 273 elements no multiple of the 64 lanes
GN_CELL = (12, 64, 48, 160)


@pytest.mark.parametrize("weights", ["uniform", "zeros", "robust"])
@pytest.mark.parametrize("shape", [GN_CELL, (1, 5, 13, 21)])
def test_gauss_newton_matches_plain_version(cuda, shape, weights):
    """H and b against the plain version in float64 on the card, no
    farther than the plain version in float32 (cuBLAS's order) by more
    than float32's rounding; at the cell's shape the plain version's
    float32 bits; an all-zero weight gives 0."""
    args64 = [a.to(cuda) for a in _gn_inputs(*shape, weights=weights)]
    args = [a.float() for a in args64]
    before = gn.normal_equations.launches
    with profiling.recording() as records:
        H, b = gn.normal_equations(*args)
    assert gn.normal_equations.launches == before + 1
    assert records.counts == {"gauss_newton_kernel": 1}
    H64, b64 = gn.normal_equations_reference(*args64)
    H32, b32 = gn.normal_equations_reference(*args)
    torch.cuda.synchronize()
    if shape == GN_CELL:
        assert torch.equal(H, H32) and torch.equal(b, b32)
    for name, got, plain, truth in (("H", H, H32, H64), ("b", b, b32, b64)):
        err, plain_err = _rel_err(got, truth), _rel_err(plain, truth)
        print(f"{name}: kernel {err:.3g}, plain fp32 {plain_err:.3g}")
        assert err <= 2 * plain_err + 2e-7, name
    if weights == "zeros":
        assert not H[-1].any() and not b[-1].any()


@pytest.mark.parametrize("weights", ["uniform", "zeros"])
@pytest.mark.parametrize("shape", [GN_CELL, (1, 5, 13, 21)])
def test_gauss_newton_backward_matches_autograd(cuda, shape, weights):
    """The gradients of f, src_feat, J_pixel_xi and wmap from the backward
    kernel against autograd through the plain version in float64, for a
    non-symmetric dH; one backward launch."""
    args64 = [a.to(cuda) for a in _gn_inputs(*shape, weights=weights,
                                              seed=1)]
    rng = np.random.RandomState(2)
    dH64 = torch.tensor(rng.randn(shape[0], 6, 6), device=cuda)
    db64 = torch.tensor(rng.randn(shape[0], 6), device=cuda)
    leaves64 = [a.clone().requires_grad_(True) for a in args64]
    H, b = gn.normal_equations_reference(*leaves64)
    want = torch.autograd.grad((H * dH64).sum() + (b * db64).sum(), leaves64)
    leaves = [a.float().requires_grad_(True) for a in args64]
    before = gn.normal_equations.backward_launches
    with profiling.recording() as records:
        H, b = gn.normal_equations(*leaves)
        got = torch.autograd.grad(
            (H * dH64.float()).sum() + (b * db64.float()).sum(), leaves)
    assert gn.normal_equations.backward_launches == before + 1
    assert records.counts == {"gauss_newton_kernel": 1,
                              "gauss_newton_kernel_bwd": 1}
    for name, g, truth in zip(("f", "src_feat", "J_pixel_xi", "wmap"), got,
                              want):
        assert g.dtype is torch.float32 and g.shape == truth.shape, name
        err = _rel_err(g, truth)
        print(f"d{name}: {err:.3g}")
        assert err <= 1e-5, name


def test_gauss_newton_two_launches_give_the_same_bits(cuda):
    args = [a.float().to(cuda).requires_grad_(True)
            for a in _gn_inputs(*GN_CELL, seed=3)]
    outs = []
    for _ in range(2):
        H, b = gn.normal_equations(*args)
        grads = torch.autograd.grad(H.sum() + 3 * b.sum(), args)
        outs.append((H, b, *grads))
    for x, y in zip(*outs):
        assert torch.equal(x, y)


def test_gauss_newton_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    f, src, Jp, wmap = [a.float().to(cuda) for a in _gn_inputs(2, 8, 6, 10)]
    before = gn.normal_equations.launches
    with pytest.raises(TypeError, match="float32"):
        gn.normal_equations(f.double(), src, Jp, wmap)
    with pytest.raises(TypeError, match="float32"):
        gn.normal_equations(f, src, Jp, wmap.half())
    with pytest.raises(ValueError, match="contiguous"):
        gn.normal_equations(f, src, Jp.transpose(2, 3).contiguous()
                            .transpose(2, 3), wmap)
    with pytest.raises(ValueError, match="contiguous"):
        gn.normal_equations(f[..., ::2], src[..., ::2], Jp[:, ::2], wmap[:, ::2])
    with pytest.raises(ValueError, match=r"\(B, C, 5, N\)"):
        gn.normal_equations(f[:, :, :3].contiguous(), src, Jp, wmap)
    with pytest.raises(ValueError, match="src_feat"):
        gn.normal_equations(f, src[:, :4].contiguous(), Jp, wmap)
    with pytest.raises(ValueError, match="J_pixel_xi"):
        gn.normal_equations(f, src, Jp.reshape(2, 60, 12), wmap)
    with pytest.raises(ValueError, match="is on cpu"):
        gn.normal_equations(f, src, Jp, wmap.cpu())
    assert gn.normal_equations.launches == before
