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


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "k5_negated": k5_negated,
          "k2_zeroed": k2_zeroed}
