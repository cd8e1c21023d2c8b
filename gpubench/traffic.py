"""The generator of every training cell's inputs and weights, all drawn
on the device from `--seed` in a few large calls.

A cell's traffic mix is a data file, `mixes/<traffic>.json`, found by the
workload's `traffic` name in `BENCHMARK.json`. Its parameters: `pool`
distinct batches that the window cycles through, each of the
configuration's `batch_size` items a process, with their random draws
(`matching_aug`, `automask_noise`); `frames` ("uniform": every pixel
uniform in [0, 1]), `aug_noise` (the standard deviation of the augmented
copies' Gaussian noise) and `intrinsics` (fx, fy, cx, cy over the width
and height). Item sizes and frame ids come from the configuration's
`port_config`. The batches have the port's `synthetic_batch` format
(`mal_tpu_torch/data/synthetic.py`, copied here frozen).

A mix may also carry `doj`, dynamic-object masks: each item's frame 0
holds a uniform number of axis-aligned boxes in `boxes` [lo, hi], each
`width` and `height` [lo, hi] pixels, uniform in place; each box moves by
a uniform (dx, dy) in `shift_x` and `shift_y` [lo, hi] a frame, so frame
f holds it shifted by f (dx, dy). The batch then has `doj_mask` and
`doj_mask-1` / `doj_mask+1` (by the loss frames), each (B, H, W) float32
in {0, 1}, the format `mal_tpu_torch/data/doj.py` loads. They are drawn
after the draws, so a mix without them draws what it drew before.

Data shard s of pool entry j is drawn from its own generator, seeded by
(seed, j, s), so a process makes only its shard, and the reference the
global batch by concatenating the shards in rank order.
"""

from __future__ import annotations

import numpy as np
import torch

WEIGHTS_STREAM = 2 ** 20   # the pool index of the weights' generator


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed drawn from (seed, keys): any whole `seed`, however
    large, maps to a valid `torch.Generator` seed."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    words = [seed & 0xFFFFFFFF, seed >> 32, *keys]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def frame_ids(cfg: dict) -> list[int]:
    """`Config.frames_to_load` of a `port_config`: the loss frames, then the
    matching frames not among them."""
    out = list(cfg.get("frame_ids", (0, -1, 1)))
    for idx in range(-1, -1 - cfg.get("num_matching_frames", 1), -1):
        if idx not in out:
            out.append(idx)
    return out


def make_batch(mix: dict, cfg: dict, batch: int, generator: torch.Generator,
               device: torch.device) -> dict:
    """One batch of `batch` items in the port's input format (NHWC frames
    by frame id, K and inv_K at full resolution)."""
    if mix["frames"] != "uniform":
        raise ValueError(f"unknown frames {mix['frames']!r}")
    H, W = cfg.get("height", 192), cfg.get("width", 640)
    color, color_aug = {}, {}
    for f in frame_ids(cfg):
        color[str(f)] = torch.rand((batch, H, W, 3), generator=generator,
                                   device=device)
        noise = torch.randn((batch, H, W, 3), generator=generator,
                            device=device)
        color_aug[str(f)] = (color[str(f)]
                             + mix["aug_noise"] * noise).clamp(0.0, 1.0)
    fx, fy, cx, cy = mix["intrinsics"]
    K = torch.eye(4, dtype=torch.float32, device=device)
    K[0, 0], K[1, 1] = fx * W, fy * H
    K[0, 2], K[1, 2] = cx * W, cy * H
    K = K.expand(batch, 4, 4).contiguous()
    return {"color": color, "color_aug": color_aug, "K": K,
            "inv_K": torch.linalg.inv(K)}


def make_draws(cfg: dict, batch: int, generator: torch.Generator,
               device: torch.device) -> dict:
    """The step's random draws: the matching augmentation's uniform (B,)
    and the automask tie-break noise (B, 1, H, W)."""
    H, W = cfg.get("height", 192), cfg.get("width", 640)
    return {"matching_aug": torch.rand((batch,), generator=generator,
                                       device=device),
            "automask_noise": torch.randn((batch, 1, H, W),
                                          generator=generator, device=device)}


def _uniform_ints(u: torch.Tensor, bounds: list[int]) -> torch.Tensor:
    """Whole numbers uniform in [lo, hi] from `u` uniform in [0, 1)."""
    lo, hi = bounds
    return (u * (hi - lo + 1)).floor().clamp(max=hi - lo) + lo


def make_doj_masks(doj: dict, cfg: dict, batch: int,
                   generator: torch.Generator, device: torch.device) -> dict:
    """The dynamic-object masks of `batch` items (see the module)."""
    H, W = cfg.get("height", 192), cfg.get("width", 640)
    n = doj["boxes"][1]
    count = _uniform_ints(torch.rand((batch, 1), generator=generator,
                                     device=device), doj["boxes"])
    u = torch.rand((6, batch, n), generator=generator, device=device)
    w = _uniform_ints(u[0], doj["width"]).clamp(max=W)
    h = _uniform_ints(u[1], doj["height"]).clamp(max=H)
    x0 = (u[2] * (W - w + 1)).floor()
    y0 = (u[3] * (H - h + 1)).floor()
    dx = _uniform_ints(u[4], doj["shift_x"])
    dy = _uniform_ints(u[5], doj["shift_y"])
    kept = torch.arange(n, device=device) < count            # (B, n)
    xs = torch.arange(W, dtype=torch.float32, device=device)
    ys = torch.arange(H, dtype=torch.float32, device=device)

    def raster(f: int) -> torch.Tensor:
        left, top = x0 + f * dx, y0 + f * dy
        inx = (xs >= left[..., None]) & (xs < (left + w)[..., None])
        iny = (ys >= top[..., None]) & (ys < (top + h)[..., None])
        boxes = iny[..., :, None] & inx[..., None, :] & kept[..., None, None]
        return boxes.any(dim=1).to(torch.float32)             # (B, H, W)

    out = {"doj_mask": raster(0)}
    for f in frame_ids(cfg)[1:]:
        out[f"doj_mask{f:+d}"] = raster(f)
    return out


def shard_inputs(mix: dict, cfg: dict, seed: int, entry: int, shard: int,
                 device: torch.device) -> tuple[dict, dict]:
    """(batch, draws) of data shard `shard` of pool entry `entry`."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, entry, shard))
    B = cfg.get("batch_size", 12)
    batch = make_batch(mix, cfg, B, g, device)
    draws = make_draws(cfg, B, g, device)
    if "doj" in mix:
        batch.update(make_doj_masks(mix["doj"], cfg, B, g, device))
    return batch, draws


def concat(parts: list[dict]) -> dict:
    """Shards' batches or draws joined along the batch axis."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: concat([p[k] for p in parts]) for k in first}
    return torch.cat(parts)


def global_inputs(mix: dict, cfg: dict, seed: int, entry: int, shards: int,
                  device: torch.device) -> tuple[dict, dict]:
    """(batch, draws) of pool entry `entry` over all `shards` data shards,
    in rank order: the global batch a one-process reference steps on."""
    parts = [shard_inputs(mix, cfg, seed, entry, s, device)
             for s in range(shards)]
    return concat([p[0] for p in parts]), concat([p[1] for p in parts])


def leaf_values(name: str, p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A parameter's starting values from `u`, uniform in [-1, 1) of its
    shape: a matrix or kernel of fan-in n is uniform with variance 1 / n
    (flax's lecun scale), a relative-position table has the scale 0.02 of
    the published initialisation, a vector named `weight` (a norm's scale)
    is 1 and any other vector (a bias) 0."""
    if p.dim() >= 2:
        scale = (0.02 if "relative_position_bias_table" in name
                 else (1.0 / (p[0].numel())) ** 0.5)
        return u * (scale * 3.0 ** 0.5)
    if name.endswith("weight"):
        return torch.ones_like(u)
    return torch.zeros_like(u)


def fill_weights(modules: list[tuple[str, torch.nn.Module]], seed: int,
                 device: torch.device) -> list[tuple[str, tuple]]:
    """Set every parameter of `modules` (prefix, module) from one uniform
    draw of the seed on `device`, in the order of `named_parameters`.
    Returns the (name, shape) sequence it filled, which two sides that
    share weights must agree on."""
    params = [(f"{prefix}.{n}", p) for prefix, m in modules
              for n, p in m.named_parameters()]
    total = sum(p.numel() for _, p in params)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, WEIGHTS_STREAM))
    flat = torch.rand((total,), generator=g, device=device).mul_(2).sub_(1)
    off = 0
    with torch.no_grad():
        for name, p in params:
            u = flat[off:off + p.numel()].view(p.shape)
            p.copy_(leaf_values(name, p, u))
            off += p.numel()
    return [(n, tuple(p.shape)) for n, p in params]
