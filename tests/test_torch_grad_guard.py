"""The kernel wrappers refuse a gradient they cannot give.

Each of the seven wrappers of a hand-written kernel is forward-only, as its
Pallas kernel is in `mal_tpu`. Under grad mode, an input that requires a
gradient makes the wrapper raise before it dispatches on the device, so
the plain version on the CPU refuses it too; under `torch.no_grad()`, or
on inputs that need no gradient, it runs as before.
`tests/test_torch_kernels_gpu.py` holds the same on CUDA tensors.

No JAX here: the GPU test file imports `CASES`.
"""

import numpy as np
import pytest
import torch

from mal_tpu_torch.ops.cost_volume import compute_depth_bins
from mal_tpu_torch.ops.cuda import cost_volume_kernel as k1
from mal_tpu_torch.ops.cuda import deform_sample as k5
from mal_tpu_torch.ops.cuda import swin_block as k23
from mal_tpu_torch.ops.cuda import window_attention as k4


def _t(rng, *shape, lo=None, hi=None):
    a = (rng.randn(*shape) if lo is None else rng.uniform(lo, hi, shape))
    return torch.from_numpy(a.astype(np.float32))


def _k1(rng, occ=False):
    BF, h, w, C, D = 2, 8, 12, 8, 4
    M = torch.eye(3).expand(BF, 3, 3).contiguous()
    t = torch.tensor([[0.1, 0.0, 0.0]]).expand(BF, 3).contiguous()
    args = [_t(rng, BF, h, w, C, lo=0, hi=1), _t(rng, BF, h, w, C, lo=0, hi=1)]
    if occ:
        args += [torch.zeros(BF, h, w), torch.ones(BF)]
    args += [M, t, compute_depth_bins(0.1, 10.0, D)]
    return args + [0.7] if occ else args


def _k2(rng):
    B, Hp, Wp, C, heads, ws = 1, 4, 4, 64, 2, 2
    args = [_t(rng, B, Hp, Wp, C), torch.ones(Hp, Wp), 1 + 0.1 * _t(rng, C),
            0.1 * _t(rng, C), 0.1 * _t(rng, 3 * C, C), 0.1 * _t(rng, 3 * C),
            0.1 * _t(rng, (2 * ws - 1) ** 2, heads), None,
            0.1 * _t(rng, C, C), 0.1 * _t(rng, C)]
    return args, {"window_size": ws, "num_heads": heads}


def _k3(rng):
    C = 64
    return [_t(rng, 10, C), 1 + 0.1 * _t(rng, C), 0.1 * _t(rng, C),
            0.1 * _t(rng, 4 * C, C), 0.1 * _t(rng, 4 * C),
            0.1 * _t(rng, C, 4 * C), 0.1 * _t(rng, C)]


def _k4(rng):
    heads, ws = 2, 2
    return [_t(rng, 3, ws * ws, 3 * heads * 32),
            0.1 * _t(rng, (2 * ws - 1) ** 2, heads), None, heads]


def _k5(rng):
    B, Lq, heads, ch, P = 1, 5, 2, 8, 2
    shapes = [(2, 3), (1, 2)]
    S = sum(h * w for h, w in shapes)
    return [_t(rng, B, S, heads, ch), shapes,
            _t(rng, B, Lq, heads, len(shapes), P, 2, lo=0, hi=1),
            _t(rng, B, Lq, heads, len(shapes), P, lo=0, hi=1)]


def _k5b(rng):
    G, T, S, ch = 2, 1, 3, 8
    shapes = ((1, 2), (2, 2), (2, 3))
    return ([_t(rng, G, h * ch, w) for h, w in shapes]
            + [_t(rng, G, T, 3, S, lo=0, hi=1) for _ in range(3)]
            + [shapes, ch])


# name -> (wrapper, inputs(rng) -> (args, kwargs))
CASES = {
    "plane_sweep_diffs": (k1.plane_sweep_diffs, lambda r: (_k1(r), {})),
    "plane_sweep_diffs_occ": (k1.plane_sweep_diffs_occ,
                              lambda r: (_k1(r, occ=True), {})),
    "swin_attn_fused": (k23.swin_attn_fused, _k2),
    "swin_mlp_fused": (k23.swin_mlp_fused, lambda r: (_k3(r), {})),
    "window_attention": (k4.window_attention, lambda r: (_k4(r), {})),
    "ms_deform_attn_core": (k5.ms_deform_attn_core, lambda r: (_k5(r), {})),
    "deform_sample_fused": (k5.deform_sample_fused, lambda r: (_k5b(r), {})),
}


def check_guard(name: str, device) -> None:
    """`name`'s wrapper on `device`: under no_grad, and on inputs that need
    no gradient, it runs as before; under grad mode it raises, naming
    itself and the missing backward, for an input of each position that
    requires a gradient, and launches nothing."""
    fn, make = CASES[name]
    args, kwargs = make(np.random.RandomState(0))
    args = [a.to(device) if isinstance(a, torch.Tensor) else a for a in args]
    want = fn(*args, **kwargs)           # nothing requires a gradient
    tensors = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    for i in tensors:
        marked = list(args)
        marked[i] = args[i].clone().requires_grad_()
        launches = fn.launches
        with pytest.raises(RuntimeError, match=f"{name}: the kernel has no "
                           "backward"):
            fn(*marked, **kwargs)
        assert fn.launches == launches
        with torch.no_grad():
            got = fn(*marked, **kwargs)
        assert not got.requires_grad
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_refuses_a_gradient(name):
    check_guard(name, "cpu")
