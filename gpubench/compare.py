"""What decides `correct` in a training cell: the program's first steps,
which the window's own call and feed drive in set-up, against the plain
reference's (`reference/runner.py`) from the same weights, batches and
draws.

Readings, on each side (`readings` below): each step's loss; the norm of
the first step's gradient, leaf by leaf, as the optimizer got it (Adam's
first moment after one step over 1 - beta1); the norm of each leaf's
change after the compared steps; the depth bins and the loss balancer
after them. The numbers compared:

- `loss_gap`: the largest |loss - reference| / |reference| over the steps;
- `grad_gap`, `change_gap`: the worst leaf's |norm - reference norm| over
  the larger of the reference's norm of that leaf and the median leaf's.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's move under Adam by round-off alone and are left out of both;
- `grad_median_gap`, `change_median_gap`: the median leaf's gradient
  and change gaps by the measure of `grad_gap` and `change_gap`: steady
  from seed to seed where the worst leaf swings (a cell that compares
  them in their place says why in PERF.md);
- `grad_norm_gap.<group>`, `change_norm_gap.<group>`, for each group of
  leaves that the workload's `leaf_groups` names by the prefixes of
  their names: the gap of the group's whole first gradient and change
  (the norm over its kept leaves' norms), |norm - reference norm| /
  reference norm;
- `state_gap`: the largest relative gap of the bins and the balancer;
- `seg_features_gap` (cells with the temporal hint): the segmenter's
  features after K2 / K3 (the Swin backbone) and K5 (the pixel decoder's
  deformable attention), that is the pixel decoder's four outputs (the
  mask features and the three encoded scales), in the first step's
  forward over the batch's current frames, which both sides see alike:
  the largest |program - reference| / |reference| of the four, each over
  the whole tensor. (The transformer decoder after them thresholds its
  attention masks at 0.5: rounding flips thousands of their entries, so
  its outputs' gap swings by seed, tenfold, over the same features.)
- `confidence_flips`: the pixels whose cost-volume confidence (the depth
  model's `consistency_mask`: every plane observed) in the first step's
  forward differs between the two sides, over the reference's confident
  pixels (at least 1), on the program's items (rank 0's shard is the
  global batch's first items); beside it, not a gap, `confident_pixels`:
  how many the reference has there;
- `rank_gap` (several processes): the largest |parameter - rank 0's| of
  any rank after the compared steps, exact: the ranks apply one update.
"""

from __future__ import annotations

import statistics

import torch

ADAM_BETA1 = 0.9
NEGLIGIBLE = 1e-3   # of the median leaf's reference gradient


def leaf_names(model: torch.nn.Module, optimizer) -> list[str]:
    """The optimizer's parameters by their names in `model`, in its order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _params(optimizer) -> list[torch.Tensor]:
    return [p for g in optimizer.param_groups for p in g["params"]]


def grad_norms(optimizer) -> list[float]:
    """Each leaf's first gradient as Adam got it, from its state after one
    step: exp_avg = (1 - beta1) g."""
    norms = [torch.linalg.vector_norm(optimizer.state[p]["exp_avg"])
             for p in _params(optimizer)]
    return (torch.stack(norms) / (1.0 - ADAM_BETA1)).tolist()


def change_norms(optimizer, start: list[torch.Tensor]) -> list[float]:
    """Each leaf's change from `start` (`snapshot`), on the host."""
    norms = [torch.linalg.vector_norm(p.detach().cpu() - p0)
             for p, p0 in zip(_params(optimizer), start)]
    return torch.stack(norms).tolist()


class SegmenterFeatures:
    """Keep, on the host, the outputs of a Mask2Former's pixel decoder in
    its first forward while attached (a forward hook): (mask features,
    [res5', res4', res3'])."""

    def __init__(self, segmenter: torch.nn.Module | None):
        self.outputs: list[torch.Tensor] = []
        self.handle = (None if segmenter is None else segmenter.sem_seg_head
                       .pixel_decoder.register_forward_hook(self._keep))

    def _keep(self, module, args, out) -> None:
        if not self.outputs:
            mask_features, scales = out
            self.outputs = [t.detach().float().cpu()
                            for t in [mask_features, *scales]]

    def detach(self) -> list[torch.Tensor]:
        if self.handle is not None:
            self.handle.remove()
        return self.outputs


class FirstOutput:
    """Keep, on the host, the output `key` of a model's first forward
    while attached (a forward hook); None where it gives none."""

    def __init__(self, model: torch.nn.Module, key: str):
        self.key, self.value = key, None
        self.handle = model.register_forward_hook(self._keep)

    def _keep(self, module, args, out) -> None:
        if self.value is None and isinstance(out, dict) and self.key in out:
            self.value = out[self.key].detach().cpu()

    def detach(self) -> torch.Tensor | None:
        self.handle.remove()
        return self.value


def _relative_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got - ref)
                 / torch.linalg.vector_norm(ref))


def snapshot(optimizer) -> list[torch.Tensor]:
    """The parameters' values, copied to the host (the card holds no copy
    that the program's own run would not)."""
    return [p.detach().to("cpu", copy=True) for p in _params(optimizer)]


def state_values(bins, balancer) -> dict[str, float]:
    """The depth bins and the balancer's state, as floats."""
    out = {"min_depth": float(bins.min_depth), "max_depth": float(bins.max_depth)}
    for field in ("w", "running_sum", "prev_total", "prev_mean"):
        for i, v in enumerate(getattr(balancer, field).reshape(-1).tolist()):
            out[f"balancer.{field}.{i}"] = v
    return out


def _worst_leaf(got: list[float], ref: list[float], keep: list[bool],
                floor: float) -> float:
    return max((abs(g - r) / max(r, floor)
                for g, r, k in zip(got, ref, keep) if k), default=0.0)


def _median_leaf(got: list[float], ref: list[float], keep: list[bool],
                 floor: float) -> float:
    return statistics.median(abs(g - r) / max(r, floor)
                             for g, r, k in zip(got, ref, keep) if k)


def _group_norm(norms: list[float], member: list[bool]) -> float:
    return sum(n * n for n, m in zip(norms, member) if m) ** 0.5


def numbers(prog: dict, ref: dict,
            groups: dict[str, list[str]] | None = None) -> dict[str, float]:
    """The compared numbers of two sides' readings (see the module);
    `groups` maps a group's name to the prefixes of its leaves' names."""
    if prog["names"] != ref["names"]:
        raise ValueError("the program's and the reference's leaves differ")
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    g_med = statistics.median(ref["grad"])
    keep = [g >= NEGLIGIBLE * g_med for g in ref["grad"]]
    c_med = statistics.median(c for c, k in zip(ref["change"], keep) if k)
    state = max(abs(prog["state"][k] - v) / abs(v)
                for k, v in ref["state"].items() if v != 0.0)
    out = {"loss_gap": loss,
           "grad_gap": _worst_leaf(prog["grad"], ref["grad"], keep, g_med),
           "grad_median_gap": _median_leaf(prog["grad"], ref["grad"], keep,
                                           g_med),
           "change_gap": _worst_leaf(prog["change"], ref["change"], keep,
                                     c_med),
           "change_median_gap": _median_leaf(prog["change"], ref["change"],
                                             keep, c_med),
           "state_gap": state}
    for group, prefixes in (groups or {}).items():
        member = [k and n.startswith(tuple(prefixes))
                  for n, k in zip(ref["names"], keep)]
        if not any(member):
            raise ValueError(f"leaf group {group!r} has no leaf")
        for kind in ("grad", "change"):
            want = _group_norm(ref[kind], member)
            out[f"{kind}_norm_gap.{group}"] = (
                abs(_group_norm(prog[kind], member) - want) / want)
    if prog.get("seg") and ref.get("seg"):
        out["seg_features_gap"] = max(
            _relative_gap(p, r) for p, r in zip(prog["seg"], ref["seg"]))
    if prog.get("confidence") is not None and ref.get("confidence") is not None:
        got = prog["confidence"]
        want = ref["confidence"][:got.shape[0]]
        out["confidence_flips"] = float((got != want).sum()
                                        / want.sum().clamp(min=1))
        out["confident_pixels"] = float(want.sum())
    if "rank_gap" in prog:
        out["rank_gap"] = prog["rank_gap"]
    return out


def judge(numbers_: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict]:
    """(correct, {name: [number, limit]}): correct where every number is
    finite and at most its limit."""
    table = {k: [numbers_[k], limits[k]] for k in limits}
    ok = all(v == v and v <= lim for v, lim in table.values())
    return ok, table


def excluded(ref: dict) -> list[str]:
    """The leaves left out by the rule on the reference's gradient."""
    g_med = statistics.median(ref["grad"])
    return [n for n, g in zip(ref["names"], ref["grad"])
            if g < NEGLIGIBLE * g_med]
