"""Shared helpers for the parity tests of the PyTorch port (`mal_tpu_torch`)
against `mal_tpu`: inputs made from a numpy seed, handed to both packages."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mal_tpu.config import Config

CFG = Config(height=64, width=96, num_depth_bins=16, batch_size=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port in a module that imports this
    fixture: the suite runs several workers on the host's cores, and
    PyTorch's default of one thread per core then oversubscribes them (a
    CPU step ran ~30x slower under a six-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def compiled(fn, *args):
    """`jax.jit(fn)` compiled for `args` without LLVM's expensive passes:
    the same numbers (a step's loss agrees to the bit) for a fifth less
    compile time, which dominates the parity tests' set-up. Call the
    result with arguments of the same shapes and types."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_llvm_disable_expensive_passes": True})


def run_jitted(fn, *args):
    """`jax.jit(fn)(*args)` through `compiled`."""
    return compiled(fn, *args)(*args)


def np_batch(cfg: Config, seed: int = 0, batch_size: int = 2) -> dict:
    """A KITTI-shaped batch (NHWC images, K, inv_K) as numpy arrays."""
    rng = np.random.RandomState(seed)
    B, H, W = batch_size, cfg.height, cfg.width
    color, color_aug = {}, {}
    for f in cfg.frames_to_load:
        c = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
        color[str(f)] = c
        color_aug[str(f)] = np.clip(
            c + 0.02 * rng.randn(B, H, W, 3).astype(np.float32), 0, 1)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.58 * W, 1.92 * H
    K[0, 2], K[1, 2] = 0.5 * W, 0.5 * H
    K = np.broadcast_to(K, (B, 4, 4)).copy()
    return {"color": color, "color_aug": color_aug, "K": K,
            "inv_K": np.linalg.inv(K).astype(np.float32)}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def to_numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def nchw(a) -> np.ndarray:
    """NHWC numpy -> NCHW numpy."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


def leaves(tree, prefix=()):
    """(path, leaf) pairs of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_variables(cfg: Config, seed: int = 0):
    """Random flax (params, batch_stats) of `mal_tpu`'s MALModel, as numpy."""
    from mal_tpu.models import MALModel as JaxMALModel

    model = JaxMALModel(cfg)
    rng = jax.random.PRNGKey(seed)
    batch = to_jax(np_batch(cfg, seed, batch_size=1))
    # jitted: the same values as op by op, in a third of the time
    variables = jax.jit(lambda r, b: model.init(
        {"params": r}, b, jnp.asarray(0.1), jnp.asarray(10.0), r,
        train=True))(rng, batch)
    return to_numpy(variables["params"]), to_numpy(variables["batch_stats"])


@functools.lru_cache(maxsize=None)
def _blank_model(cfg: Config):
    from mal_tpu_torch.models import MALModel

    return MALModel(torch_cfg(cfg), device="cpu", init_weights=False)


def port_model(cfg: Config, params, batch_stats):
    """The port's MALModel on the CPU, carrying the flax weights. The nets
    are copied from one built per config without drawing its weights
    (seconds): the strict load overwrites every one."""
    from mal_tpu_torch.convert.jax_params import load_jax_variables

    model = copy.deepcopy(_blank_model(cfg))
    load_jax_variables(model, params, batch_stats)
    return model


def torch_cfg(cfg: Config):
    from mal_tpu_torch.config import Config as TorchConfig

    return TorchConfig(**cfg.__dict__)


# --------------------------------------------------------------------------
# bf16 comparisons (tests/test_torch_fast_mode.py says why they come in two
# kinds)
# --------------------------------------------------------------------------

SHARE = 0.2        # one layer, given mal_tpu's own bf16 input
END_TO_END = 1.5   # whole networks: sqrt(2), two independent bf16 runs, and a margin


def as_f32(x) -> np.ndarray:
    """A torch tensor or a jax array of any float type as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def as_torch(x, dtype=torch.float32, channels_first=False) -> torch.Tensor:
    """A jax or numpy array as a torch tensor of `dtype` (exact for a bf16
    array read as bf16), NHWC -> NCHW on request."""
    a = as_f32(x)
    return torch.from_numpy(nchw(a) if channels_first else a).to(dtype)


def check_bf16(got, want, exact, atol, rtol=0.0, share=SHARE, what=""):
    """`got` (the port in bf16) against `want` (mal_tpu in bf16): elementwise
    within `atol` + `rtol` |want|, and on average within `share` of the mean
    distance of `want` from `exact`, an fp32 result on the same input, which
    must be there."""
    got, want, exact = as_f32(got), as_f32(want), as_f32(exact)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    mode_gap = np.abs(want - exact).mean()
    assert mode_gap > 0, what          # bf16 and fp32 do differ here
    mean = np.abs(got - want).mean()
    assert mean <= share * mode_gap, (what, mean / mode_gap, mean, mode_gap)


def random_mal_variables(cfg: Config, seed: int = 0):
    """Random (params, batch_stats) on the shapes of `mal_tpu`'s MALModel
    tree (its DynDepthModel's for `method="dynamicdepth"`), as numpy,
    without running or compiling its initialisers: kernels normal at
    1 / sqrt(fan_in), scales near 1, biases and running means small,
    running variances near 1."""
    batch = np_batch(cfg, seed, batch_size=1)
    if cfg.method == "dynamicdepth":
        from mal_tpu.dynamic.model import DynDepthModel as JaxModel
        for k in ("doj_mask", "doj_mask-1", "doj_mask+1"):
            batch[k] = np.zeros((1, cfg.height, cfg.width), np.float32)
    else:
        from mal_tpu.models import MALModel as JaxModel

    batch = to_jax(batch)
    shapes = jax.eval_shape(
        lambda r, b: JaxModel(cfg).init(
            {"params": r}, b, jnp.asarray(0.1), jnp.asarray(10.0), r,
            train=True), jax.random.PRNGKey(0), batch)
    tree = random_tree(shapes, seed)
    return tree["params"], tree["batch_stats"]


def random_tree(shapes, seed: int = 0):
    """Random numpy leaves on the shapes of a flax variables tree (from
    `jax.eval_shape` of an `init`): kernels and weight-norm directions `v`
    normal at 1 / sqrt(fan_in), scales, weight-norm gains and running
    variances near 1, the rest (biases, means) small."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        r = rng.randn(*s.shape)
        if name in ("kernel", "v"):
            a = r / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var", "g"):
            a = 1.0 + 0.1 * np.abs(r)
        else:                      # bias, mean
            a = 0.1 * r
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_criterion_draws(key, layers: int, batch: int, targets: int,
                        num_points: int) -> list[dict]:
    """The random points `mal_tpu`'s `set_criterion_deep(key, ...)` draws
    (`mal_tpu/segment/criterion.py:154,190,260`: a key a layer, split into
    the matching's and the losses', the latter split into the oversampled
    and the random points), as the port's injected `draws`."""
    from mal_tpu_torch.segment.criterion import CriterionConfig, point_counts

    n_over, _, n_rand = point_counts(CriterionConfig(num_points=num_points))
    N = batch * targets
    out = []
    for k in jax.random.split(key, layers):
        km, kl = jax.random.split(k)
        k1, k2 = jax.random.split(kl)
        out.append({name: torch.from_numpy(np.array(jax.random.uniform(
            kk, shape))) for name, kk, shape in (
                ("match", km, (batch, num_points, 2)),
                ("oversample", k1, (N, n_over, 2)),
                ("rand", k2, (N, n_rand, 2)))})
    return out
