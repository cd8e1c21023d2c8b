"""Faults planted under the timed step, for the tests that see `correct`
come out false: each takes the port's `train_step` and returns a broken
step with the same call."""

from __future__ import annotations

import torch

from gpubench.reference.runner import take_items


def unchanged(step):
    """A step that returns its state unchanged: parameters, bins and
    balancer as they were before it."""
    def broken(st, batch, epoch=0.0, generator=None, draws=None):
        params = [p.detach().clone() for p in st.model.parameters()]
        bins, balancer = st.bins, st.balancer
        st, metrics = step(st, batch, epoch, generator, draws)
        with torch.no_grad():
            for p, p0 in zip(st.model.parameters(), params):
                p.copy_(p0)
        st.bins, st.balancer = bins, balancer
        return st, metrics
    return broken


def half_batch(step):
    """Half of the batch left out: the step's means over the rest."""
    def broken(st, batch, epoch=0.0, generator=None, draws=None):
        half = slice(0, batch["K"].shape[0] // 2)
        return step(st, take_items(batch, half), epoch, generator,
                    None if draws is None else take_items(draws, half))
    return broken


def no_exchange(step):
    """The exchange between processes left out: each process steps on its
    shard as if it were alone (the port's step sees a world of one)."""
    from mal_tpu_torch.parallel import distributed

    def broken(*args, **kwargs):
        world = distributed.world
        distributed.world = lambda: 1
        try:
            return step(*args, **kwargs)
        finally:
            distributed.world = world
    return broken


def no_domd(step):
    """The batch's dynamic-object masks (`doj_mask*`) left out, so that
    DynamicDepth's step skips the DOMD warp it needs them for."""
    def broken(st, batch, epoch=0.0, generator=None, draws=None):
        kept = {k: v for k, v in batch.items() if not k.startswith("doj_mask")}
        return step(st, kept, epoch, generator, draws)
    return broken


def _patched(step, module, name: str, make):
    """`step` with `module.name` replaced by `make(original)` while it
    runs."""
    def broken(*args, **kwargs):
        original = getattr(module, name)
        setattr(module, name, make(original))
        try:
            return step(*args, **kwargs)
        finally:
            setattr(module, name, original)
    return broken


def k5_negated(step):
    """K5 (the deformable attention core of the segmenter's pixel decoder)
    returning its output negated."""
    from mal_tpu_torch.segment import msdeform

    def make(core):
        def negated(*args, **kwargs):
            return -core(*args, **kwargs)
        return negated
    return _patched(step, msdeform, "ms_deform_attn_core", make)


def k2_zeroed(step):
    """K2 (the fused Swin attention half-block) returning zeros: the
    segmenter's backbone loses every attention branch. Only the fused
    blocks launch K2, so it breaks nothing where they are off."""
    from mal_tpu_torch.segment import swin

    def make(fused):
        def zeroed(x, *args, **kwargs):
            return torch.zeros_like(fused(x, *args, **kwargs))
        return zeroed
    return _patched(step, swin, "swin_attn_fused", make)


def k6_zeroed(step):
    """K6 (the occlusion-aware plane-sweep differences of DynamicDepth's
    cost volume) returning zeros: every plane of every pixel reads as
    missing."""
    from mal_tpu_torch.dynamic import cost_volume

    def make(kernel):
        def zeroed(*args, **kwargs):
            return torch.zeros_like(kernel(*args, **kwargs))
        return zeroed
    return _patched(step, cost_volume, "plane_sweep_diffs_occ", make)


def k6_twin(step):
    """Not a fault, a witness: DynamicDepth's cost volume computed by the
    port's plain twin (`occlusion_aware_cost_volume`, `F.grid_sample`)
    where the step launches K6, as the reference computes it."""
    from mal_tpu_torch.dynamic import cost_volume, model

    def make(kernel):
        def twin(*args, cv_min=False, set_1=False, pool_th=0.7):
            return cost_volume.occlusion_aware_cost_volume(
                *args, cv_min=cv_min, set_1=set_1, pool_th=pool_th)
        return twin
    return _patched(step, model, "occlusion_aware_cost_volume_kernel", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "k5_negated": k5_negated,
          "k2_zeroed": k2_zeroed, "no_domd": no_domd, "k6_zeroed": k6_zeroed}
VARIANTS = {**FAULTS, "k6_twin": k6_twin}   # what the readings tool plants
