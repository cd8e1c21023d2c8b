"""DualRefine's Gauss-Newton normal equations (`mal_tpu_torch/ops/cuda/
gauss_newton.py`) on the CPU: the plain version against the arithmetic
`direct_align` ran before it and against a closed form, its gradient by
`gradcheck`, the CUDA kernel's forward order of summation and its
backward arithmetic written out in PyTorch against the plain version and
its autograd, the wrapper's
checks, and `direct_align` taking the plain route on CPU tensors with no
launch counted. The kernel itself runs in `tests/test_torch_kernels_gpu.py`
on a card.
"""

import numpy as np
import pytest
import torch

from mal_tpu_torch.dualref.pose_update import direct_align, sample_tgt
from mal_tpu_torch.ops.cuda import gauss_newton as gn
from mal_tpu_torch.utils import profiling


def inputs(B=2, C=5, h=6, w=11, seed=0, dtype=torch.float64):
    """(f, src_feat, J_pixel_xi, wmap) with the main path's magnitudes:
    features in [0, 1], fx ~ fy ~ 92 at the feature scale, points 2-20 m
    deep, weights in [0, 1]."""
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
    Jp = np.stack([jx, jy], 2)
    wmap = rng.uniform(0, 1, (B, N))
    return [torch.tensor(a, dtype=dtype) for a in (f, src, Jp, wmap)]


def before_kernel(f, src, Jp, wmap):
    """`direct_align`'s arithmetic before the kernel, from sample_tgt's
    (warped, grads) on: grads (B, C, 2, h, w) stacked from the samples."""
    B, C, _, N = f.shape
    grads = torch.stack([(f[:, :, 1] - f[:, :, 2]) / 2.0,
                         (f[:, :, 3] - f[:, :, 4]) / 2.0], dim=2)
    J_img_pixel = grads.reshape(B, C, 2, N).permute(0, 3, 1, 2)
    J = -(J_img_pixel @ Jp)
    res = (src - f[:, :, 0]).reshape(B, C, N).transpose(1, 2)
    JW = J * wmap.reshape(B, N, 1, 1)
    return (torch.einsum("bnck,bncl->bkl", JW, J),
            -torch.einsum("bnck,bnc->bk", JW, res))


def kernel_forward(f, src, Jp, wmap, lanes=gn.LANES, chunk=gn.CHUNK):
    """The forward kernel's order. H: element e = n C + c goes to lane
    e mod 64 and chunk e // 16384; the (chunk, lane) sums are folded lane
    by lane, chunk by chunk, over lanes 0-31 and over lanes 32-63, and the
    two halves added. b: element e' = c N + n goes to lane e' mod 32, and
    the 32 lane sums meet in a shuffle tree (offsets 16, 8, 4, 2, 1)."""
    B, C, _, N = f.shape
    K = N * C
    gx = (f[:, :, 1] - f[:, :, 2]) * 0.5                    # (B, C, N)
    gy = (f[:, :, 3] - f[:, :, 4]) * 0.5
    r = src - f[:, :, 0]
    j = -(gy[..., None] * Jp[:, None, :, 1] + gx[..., None] * Jp[:, None, :, 0])
    wj = wmap[:, None, :, None] * j                         # (B, C, N, 6)
    # H, over e = n C + c
    terms = (wj[..., :, None] * j[..., None, :]).permute(0, 2, 1, 3, 4)
    terms = terms.reshape(B, K, 36)
    e = torch.arange(K)
    group = (e // chunk) * lanes + e % lanes
    chunks = -(-K // chunk)
    sums = torch.zeros(B, chunks * lanes, 36, dtype=f.dtype)
    sums.index_add_(1, group, terms)
    sums = sums.reshape(B, chunks, lanes, 36)
    halves = []
    for half in range(2):
        total = torch.zeros(B, 36, dtype=f.dtype)
        for lane in range(half * lanes // 2, (half + 1) * lanes // 2):
            for c in range(chunks):
                total = total + sums[:, c, lane]
        halves.append(total)
    H = (halves[0] + halves[1]).reshape(B, 6, 6)
    # b, over e' = c N + n
    terms = (wj * r[..., None]).reshape(B, K, 6)
    v = torch.zeros(B, 32, 6, dtype=f.dtype)
    v.index_add_(1, e % 32, terms)
    for off in (16, 8, 4, 2, 1):
        v[:, :off] = v[:, :off] + v[:, off:2 * off]
    return H, -v[:, 0]


def kernel_backward(f, src, Jp, wmap, dH, db):
    """The backward kernel's arithmetic: S = dH + dHᵀ; per (pixel,
    channel) dj = w (S j - r db), dr = -w (j . db), dg = -Jp dj; df and
    dsrc from dr and dg, dJp and dw summed over the pixel's channels."""
    gx = (f[:, :, 1] - f[:, :, 2]) * 0.5
    gy = (f[:, :, 3] - f[:, :, 4]) * 0.5
    r = src - f[:, :, 0]
    jx, jy = Jp[:, None, :, 0], Jp[:, None, :, 1]           # (B, 1, N, 6)
    j = -(gx[..., None] * jx + gy[..., None] * jy)          # (B, C, N, 6)
    S = dH + dH.transpose(1, 2)
    Sj = torch.einsum("bkl,bcnl->bcnk", S, j)
    jdb = torch.einsum("bcnk,bk->bcn", j, db)
    w = wmap[:, None]
    dj = w[..., None] * (Sj - r[..., None] * db[:, None, None])
    dr = -w * jdb
    dgx = -(jx * dj).sum(-1)
    dgy = -(jy * dj).sum(-1)
    df = torch.stack([-dr, 0.5 * dgx, -0.5 * dgx, 0.5 * dgy, -0.5 * dgy], 2)
    dJp = torch.stack([-(gx[..., None] * dj).sum(1),
                       -(gy[..., None] * dj).sum(1)], 2)
    dw = (0.5 * (j * Sj).sum(-1) - r * jdb).sum(1)
    return df, dr, dJp, dw


def test_plain_version_is_the_arithmetic_before_the_kernel():
    args = inputs()
    H, b = gn.normal_equations_reference(*args)
    H0, b0 = before_kernel(*args)
    assert torch.equal(H, H0) and torch.equal(b, b0)
    # the float32 path too, to the bit
    args32 = inputs(dtype=torch.float32)
    for got, want in zip(gn.normal_equations_reference(*args32),
                         before_kernel(*args32)):
        assert torch.equal(got, want)


def test_plain_version_equals_the_closed_form():
    """H = sum_n w Jpᵀ (sum_c g gᵀ) Jp and b = sum_n w Jpᵀ (sum_c g r)."""
    f, src, Jp, wmap = inputs(seed=1)
    g = torch.stack([(f[:, :, 1] - f[:, :, 2]) / 2,
                     (f[:, :, 3] - f[:, :, 4]) / 2], 2)     # (B, C, 2, N)
    r = src - f[:, :, 0]
    G = torch.einsum("bcan,bcdn->bnad", g, g)
    gr = torch.einsum("bcan,bcn->bna", g, r)
    H = torch.einsum("bn,bnak,bnad,bndl->bkl", wmap, Jp, G, Jp)
    b = torch.einsum("bn,bnak,bna->bk", wmap, Jp, gr)
    H_p, b_p = gn.normal_equations_reference(f, src, Jp, wmap)
    torch.testing.assert_close(H_p, H, rtol=1e-12, atol=0)
    torch.testing.assert_close(b_p, b, rtol=1e-12, atol=1e-12)


def test_plain_version_passes_gradcheck():
    args = [a.requires_grad_(True) for a in inputs(B=2, C=3, h=2, w=3, seed=2)]
    assert torch.autograd.gradcheck(gn.normal_equations_reference, args)


# ragged: K = 5 x 273 no multiple of 64 lanes or of 32; two chunks of
# 16384 elements, the second part full; the main path's 64 channels
@pytest.mark.parametrize("shape", [(1, 5, 13, 21), (1, 7, 60, 64),
                                   (2, 64, 4, 32)])
def test_kernel_forward_arithmetic_equals_plain_version(shape):
    B, C, h, w = shape
    args = inputs(B, C, h, w, seed=3)
    H, b = kernel_forward(*args)
    H_p, b_p = gn.normal_equations_reference(*args)
    torch.testing.assert_close(H, H_p, rtol=1e-12, atol=0)
    torch.testing.assert_close(b, b_p, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("zero_weights", [False, True])
def test_kernel_backward_arithmetic_equals_autograd(zero_weights):
    """The hand-written backward's formulas against autograd through the
    plain version, for every input, with a non-symmetric dH."""
    f, src, Jp, wmap = inputs(B=2, C=5, h=5, w=7, seed=4)
    if zero_weights:
        wmap[:, ::3] = 0.0
    rng = np.random.RandomState(5)
    dH = torch.tensor(rng.randn(2, 6, 6))
    db = torch.tensor(rng.randn(2, 6))
    leaves = [a.clone().requires_grad_(True) for a in (f, src, Jp, wmap)]
    H, b = gn.normal_equations_reference(*leaves)
    want = torch.autograd.grad((H * dH).sum() + (b * db).sum(), leaves)
    got = kernel_backward(f, src, Jp, wmap, dH, db)
    for name, g, w_ in zip(("f", "src", "Jp", "wmap"), got, want):
        torch.testing.assert_close(g, w_, rtol=1e-10, atol=1e-10, msg=name)


def test_check_refuses_what_the_kernel_does_not_take():
    f, src, Jp, wmap = inputs(dtype=torch.float32)
    assert gn._check(f, src, Jp, wmap) == (2, 5, 66)
    with pytest.raises(TypeError):
        gn._check(f.double(), src, Jp, wmap)
    with pytest.raises(ValueError, match="contiguous"):
        gn._check(f, src.transpose(1, 2).contiguous().transpose(1, 2), Jp, wmap)
    with pytest.raises(ValueError, match=r"\(B, C, 5, N\)"):
        gn._check(f[:, :, :4].contiguous(), src, Jp, wmap)
    with pytest.raises(ValueError, match="J_pixel_xi"):
        gn._check(f, src, Jp[:, :-1].contiguous(), wmap)
    with pytest.raises(ValueError, match="wmap"):
        gn._check(f, src, Jp, wmap[:1].contiguous())
    with pytest.raises(ValueError, match="device"):
        gn.normal_equations(*(a.to("meta") for a in (f, src, Jp, wmap)))


@pytest.mark.parametrize("robust", [False, True])
def test_direct_align_on_cpu_takes_the_plain_route(robust):
    """On CPU tensors `direct_align` runs the plain version: no launch
    counted and neither profiling counter, and a finite, non-zero update."""
    rng = np.random.RandomState(6)
    B, C, h, w = 2, 4, 6, 8
    t = lambda *s: torch.tensor(rng.uniform(0.2, 1, s), dtype=torch.float32)
    src, tgt, src_w, tgt_w, weight = (t(B, C, h, w), t(B, C, h, w),
                                      t(B, 1, h, w), t(B, 1, h, w),
                                      t(B, 1, h, w))
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    c = torch.stack([xs + 0.3, ys - 0.2])[None, :, None, None]
    off = torch.tensor([[0.0, 1, -1, 0, 0], [0, 0, 0, 1, -1]])
    p2 = (c + off[None, :, None, :, None, None]).expand(B, 2, 1, 5, h, w)
    P2 = torch.stack([torch.full((B, h * w), 0.5), torch.full((B, h * w), -0.3),
                      torch.full((B, h * w), 8.0)], 1)
    K = torch.eye(4).repeat(B, 1, 1)
    K[:, 0, 0], K[:, 1, 1] = 0.58 * w, 1.92 * h
    poses = torch.eye(4).repeat(B, 1, 1)
    launches = (gn.normal_equations.launches,
                gn.normal_equations.backward_launches)
    with profiling.recording() as records:
        new_pose, upd = direct_align(poses, K, p2, P2, src, tgt, src_w, tgt_w,
                                     weight, robust_pose_loss=robust)
    assert (gn.normal_equations.launches,
            gn.normal_equations.backward_launches) == launches
    assert "gauss_newton_kernel" not in records.counts
    assert "gauss_newton_kernel_bwd" not in records.counts
    assert torch.isfinite(upd).all() and upd.abs().max() > 0
    f, _ = sample_tgt(tgt, tgt_w, p2)
    assert f.shape == (B, C, 5, h, w)
