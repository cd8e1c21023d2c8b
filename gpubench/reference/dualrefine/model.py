"""DualRefine: equilibrium joint depth and pose refinement (PyTorch, NCHW),
frozen from the port's `mal_tpu_torch/dualref/model.py`, a re-design of
`dualrefine/networks/depth_pose.py` (`DEQDepthPose`). An HRNet trunk and
an attention decoder give the initial 1/4-resolution disparity, the
context and hidden states and the matching features; the DEQ function
samples epipolar costs around the current depth, runs the ConvGRU update
and applies Gauss-Newton pose refinements. The fixed point over
(hidden state, depth) is solved by Anderson acceleration (or plain
iteration), with the pose threaded through every evaluation unmixed; the
final pose is the trajectory pose with the smallest update norm
(`depth_pose.py:539-544`). Training supervises phantom-gradient unrolls
from the detached solution; inference can blend refined and initial
disparity through the epipolar consistency mask (`:611-666`).

Images are NCHW (B, 3, H, W); every disparity comes out (B, 1, h, w), the
consistency mask (B, 1, h, w) bool, poses (B, 4, 4). Submodules carry the
names of the reference's `depth_pose.pth` (`cnet_*`, `decoder.convs.*`,
`conv2`, `context`, `hidden`, `update_block`, `pnets.{0,1,2}`,
`pose_update.weights`, `reproject_2`), in the port's order, so that the
benchmark's weights fill both alike.

Here in float32 only, with torch's default initialisation (the benchmark
sets every weight from the seed); the implicit-function-theorem output
(`--ift`) is not copied.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpubench.reference.device import resolve_device
from gpubench.reference.dualrefine import geometry
from gpubench.reference.dualrefine.corr import (build_pyramid, epipolar_cost,
                                                epipolar_cost_simple)
from gpubench.reference.dualrefine.hr_decoder import HRDepthDecoder
from gpubench.reference.dualrefine.hrnet import HRNet
from gpubench.reference.dualrefine.pose_update import direct_align
from gpubench.reference.dualrefine.reprojections import Reprojections
from gpubench.reference.dualrefine.solvers import anderson_solver_aux
from gpubench.reference.dualrefine.update import (SmallUpdateBlock,
                                                  convex_upsample_disp)
from gpubench.reference.models.resnet import (BatchNorm2d, ResNetFeatures,
                                              imagenet_normalize)
from gpubench.reference.ops.interp import resize_nearest

Tensor = torch.Tensor

HIDDEN_DIM = 64    # `depth_pose.py:44-45`: hdim = cdim = 64
CONTEXT_DIM = 64


class _ResidualBlockIN(nn.Module):
    """RAFT ResidualBlock with instance norm (`extractor.py:6-57`):
    torch's `InstanceNorm2d` default, no affine parameters, eps 1e-5."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(F.instance_norm(self.conv1(x), eps=1e-5))
        y = F.relu(F.instance_norm(self.conv2(y), eps=1e-5))
        return F.relu(x + y)


class _ResidualBlockBN(nn.Module):
    """RAFT ResidualBlock with batch norm (`PoseUpdate._make_layer`,
    `utils/utils.py:284-291`)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm2 = BatchNorm2d(planes)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        return F.relu(x + y)


def _feat_head(planes: int, out_dim: int) -> nn.Sequential:
    """ResidualBlock + 3x3 conv (`conv2` / `context` / `hidden`,
    `depth_pose.py:141-151`)."""
    return nn.Sequential(_ResidualBlockIN(planes),
                         nn.Conv2d(planes, out_dim, 3, padding=1))


class _PoseUpdate(nn.Module):
    """The uncertainty head of the reference's `PoseUpdate`
    (`utils/utils.py:272-276`): two batch-norm ResidualBlocks, a bias-free
    1x1 conv and a ReLU, in `weights`."""

    def __init__(self, planes: int = 64):
        super().__init__()
        self.weights = nn.Sequential(
            nn.Sequential(_ResidualBlockBN(planes), _ResidualBlockBN(planes)),
            nn.Conv2d(planes, 1, 1, bias=False), nn.ReLU())

    def forward(self, x: Tensor) -> Tensor:
        return self.weights(x)


class _PoseHead(nn.Module):
    """The pose decoder of `pnets.{s}.1` (squeeze 1x1, two 3x3, a 1x1 to 6,
    global mean, x0.01), in fp32."""

    def __init__(self, num_ch_in: int = 512):
        super().__init__()
        self.squeeze = nn.Conv2d(num_ch_in, 256, 1)
        self.pose0 = nn.Conv2d(256, 256, 3, padding=1)
        self.pose1 = nn.Conv2d(256, 256, 3, padding=1)
        self.pose2 = nn.Conv2d(256, 6, 1)

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor]:
        y = F.relu(self.squeeze(x))
        y = F.relu(self.pose0(y))
        y = F.relu(self.pose1(y))
        y = 0.01 * self.pose2(y).mean(dim=(2, 3))
        return y[:, :3], y[:, 3:]


class DEQState(NamedTuple):
    net: Tensor       # (B, hidden, h, w)
    depth: Tensor     # (B, 1, h, w)
    pose: Tensor      # (B, 4, 4)
    upd_norm: Tensor  # (B,) the last pose update's norm


def _detach(state: DEQState) -> DEQState:
    return DEQState(*(t.detach() for t in state))


def remat(fn, *args):
    """`fn(*args)` under `torch.utils.checkpoint` (non-reentrant) when
    gradients are on: the backward recomputes it, as the port's `remat`
    does for the DEQ function, which holds no BatchNorm."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


class DEQDepthPose(nn.Module):
    """DualRefine's depth-pose model on `device` (default: the GPU, raising
    if there is none), in float32."""

    def __init__(self, cfg, device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        trunk = HRNet(18 if cfg.num_layers == 18 else cfg.num_layers)
        # the trunk's children sit on this module as `cnet_<name>`, the
        # reference's attribute names; `_trunk` runs them
        for name, child in trunk.named_children():
            self.add_module("cnet_" + name, child)
        self._trunk = (trunk,)
        self.decoder = HRDepthDecoder(trunk.num_ch_enc)
        self.conv2 = _feat_head(64, 64)
        self.context = _feat_head(64, CONTEXT_DIM)
        self.hidden = _feat_head(64, HIDDEN_DIM)
        cor_planes = (cfg.corr_levels * cfg.num_cost_volume_head
                      * (2 * cfg.corr_radius + 1))
        self.update_block = SmallUpdateBlock(
            cor_planes, CONTEXT_DIM, HIDDEN_DIM,
            use_wnorm=not cfg.disable_wnorm,
            evolving_pose_weight=not cfg.disable_evolving_pose_weight)
        self.reproject_2 = Reprojections(
            corr_radius=cfg.corr_radius, num_levels=cfg.corr_levels,
            min_depth=cfg.min_depth, max_depth=cfg.max_depth)
        # one pose net per camera side (`depth_pose.py:153-172`)
        self.pnets = nn.ModuleList([
            nn.ModuleList([ResNetFeatures(18, num_input_images=2),
                           _PoseHead()]) for _ in range(3)])
        self.pose_update = _PoseUpdate(64)
        self.to(device)

    # ------------------------------------------------------------------
    def _initial_pose(self, image1: Tensor, image2: Tensor, invert: bool,
                      side: int, sides: Tensor | None) -> Tensor:
        """The per-side pose nets (`depth_pose.py:153-172,411-416`): net
        `side`, or with `sides` (B,) every net and a per-sample pick."""
        pair = [image2, image1] if invert else [image1, image2]
        x = torch.cat(pair, dim=1)

        def pose_for(s: int) -> Tensor:
            trunk, head = self.pnets[s]
            aa, t = head(trunk(x)[-1].to(x.dtype))
            return geometry.transformation_from_parameters(aa, t, invert=invert)

        if sides is None:
            return pose_for(side)
        poses = torch.stack([pose_for(s) for s in range(3)], dim=1)
        return poses[torch.arange(x.shape[0], device=x.device), sides.long()]

    # ------------------------------------------------------------------
    def forward(self, image1: Tensor, image2: Tensor, K_full: Tensor,
                invert: bool = False, side: int = 0, train: bool = False,
                sides: Tensor | None = None, num_iters: int | None = None,
                combine_via_mask: bool | None = None,
                image3: Tensor | None = None):
        """Returns (outputs, [T0, T*]).

        outputs: the initial disparities `disp_{0,1,2,3}_0` and
        `disp_{0,2}_k` of each supervised state k >= 1 (eval: k = 1), the
        `consistency_mask`, and with `image3` (the future frame) `pose_p1`,
        the pose-net-only pose the reference runs for frame +1, not
        inverted (`trainer.py:325-330`). `train` selects batch statistics
        in every BatchNorm (and updates them)."""
        cfg = self.cfg
        self.train(train)
        B, _, H, W = image1.shape
        if num_iters is None:
            num_iters = (cfg.deq_iters if train
                         else int(cfg.deq_iters * cfg.deq_eval_factor))
        if combine_via_mask is None:
            combine_via_mask = not train
        im1 = imagenet_normalize(image1)
        im2 = imagenet_normalize(image2)

        # the stem runs on the concatenated pair, so that train-mode BN
        # statistics pool both images (`depth_pose.py:203-213`); the stages
        # and the decoder on image 1's half. Fast mode casts the taps back.
        taps = self._trunk[0](torch.cat([im1, im2]), stages_count=B)
        taps = {k: ([t.to(im1.dtype) for t in v] if isinstance(v, list)
                    else v.to(im1.dtype)) for k, v in taps.items()}
        taps1 = {**taps, "stem1": taps["stem1"][:B],
                 "stem2": taps["stem2"][:B]}
        disps, inter = self.decoder(taps1)
        x2b = inter["relu_x18"]
        fmap1 = self.conv2(taps1["stem2"])
        fmap2 = self.conv2(taps["stem2"][B:])
        inp = F.relu(self.context(x2b))
        net0 = torch.tanh(self.hidden(x2b))
        f2_pyramid = build_pyramid(fmap2, cfg.corr_levels)
        K2 = geometry.scale_intrinsics(K_full, 2)

        # the Gauss-Newton uncertainty weights (`utils.py:291-298`), one
        # call on the 2B stem features: the head's BN pools both images
        if cfg.disable_fixed_pose_weight:
            src_w = tgt_w = torch.ones_like(fmap1[:, :1])
        else:
            w2b = self.pose_update(taps["stem2"])
            src_w, tgt_w = 1.0 / (1.0 + w2b[:B]), 1.0 / (1.0 + w2b[B:])

        pose0 = self._initial_pose(im1, im2, invert, side, sides)
        disp_2_0 = disps[2]
        depth0 = geometry.disp_to_depth(disp_2_0, cfg.min_depth,
                                        cfg.max_depth)[1]
        outputs = {"disp_2_0": disp_2_0,
                   "disp_0_0": convex_upsample_disp(
                       disp_2_0, self.update_block.upsample_mask(net0)),
                   "disp_1_0": disps[1], "disp_3_0": disps[3]}

        def deq_func(state: DEQState) -> DEQState:
            c, max_dx, _ = self.reproject_2.depth2epipolarcoords(
                state.pose, state.depth, K2)
            corr = epipolar_cost(fmap1, f2_pyramid, c, cfg.corr_levels,
                                 num_head=cfg.num_cost_volume_head)
            net, delta = self.update_block(state.net, inp, corr, state.depth)
            new_depth = (state.depth + torch.tanh(delta) * max_dx).clamp(
                cfg.min_depth, cfg.max_depth)
            if cfg.disable_pose_updates:
                # the Gauss-Newton refinement never runs (`:450-455`)
                return DEQState(net, new_depth, state.pose,
                                torch.zeros_like(state.upd_norm))
            weight = (None if cfg.disable_evolving_pose_weight
                      else self.update_block.pose_weight(net))
            pose = state.pose
            upd = torch.zeros(B, 6, dtype=pose.dtype, device=pose.device)
            for _ in range(cfg.num_pose_iter):
                c_p, P2 = self.reproject_2.depth2gradcoords(pose, new_depth, K2)
                pose, upd = direct_align(pose, K2, c_p, P2, fmap1, fmap2,
                                         src_w, tgt_w, weight,
                                         robust_pose_loss=cfg.robust_pose_loss)
            return DEQState(net, new_depth, pose,
                            torch.linalg.vector_norm(upd, dim=-1))

        h, w = net0.shape[-2:]
        nch = net0.shape[1]

        def flatten(net: Tensor, depth: Tensor) -> Tensor:
            return torch.cat([net.reshape(B, -1), depth.reshape(B, -1)], dim=1)

        def unflatten(z: Tensor) -> tuple[Tensor, Tensor]:
            return (z[:, :nch * h * w].reshape(B, nch, h, w),
                    z[:, nch * h * w:].reshape(B, 1, h, w))

        def vec_f(z: Tensor, aux):
            new = deq_func(DEQState(*unflatten(z), *aux))
            return flatten(new.net, new.depth), (new.pose, new.upd_norm)

        # The fixed-point solve over (net, depth), the pose an unmixed
        # auxiliary state (`depth_pose.py:417-476,517-530`); the initial
        # trajectory entry carries update norm 1 (`:425`). In training the
        # solve is gradient-free: the phantom unrolls below carry it.
        state = DEQState(net0, depth0, pose0, torch.ones_like(depth0[:, 0, 0, 0]))
        poses_t, upds_t = [pose0], [state.upd_norm]
        states_t: list[DEQState] = []
        solve_state = _detach(state) if train else state
        anderson_res = None
        with torch.no_grad() if train else contextlib.nullcontext():
            if cfg.deq_solver == "anderson":
                anderson_res = anderson_solver_aux(
                    vec_f, flatten(solve_state.net, solve_state.depth),
                    (solve_state.pose, solve_state.upd_norm), steps=num_iters,
                    stop_mode=cfg.deq_stop_mode)
                solve_state = DEQState(*unflatten(anderson_res.result),
                                       *anderson_res.aux)
                traj_poses, traj_upds = anderson_res.aux_trajectory
                poses_t += list(traj_poses)
                upds_t += list(traj_upds)
                for i, z in enumerate(anderson_res.z_trajectory):
                    states_t.append(DEQState(*unflatten(z), traj_poses[i],
                                             traj_upds[i]))
            else:
                for _ in range(num_iters):
                    solve_state = deq_func(solve_state)
                    poses_t.append(solve_state.pose)
                    upds_t.append(solve_state.upd_norm)
                    states_t.append(solve_state)
        state_star = solve_state

        # the pose with the smallest update norm over the trajectory, in
        # both modes (`depth_pose.py:540-545,604-609`)
        best = torch.argmin(torch.stack(upds_t), dim=0)
        pose_star = torch.take_along_dim(
            torch.stack(poses_t), best[None, :, None, None], dim=0)[0]

        if train:
            final_states, pose_star = self._phantom_taps(
                cfg, deq_func, vec_f, flatten, unflatten, anderson_res,
                states_t, num_iters, pose_star, state_star)
        else:
            final_states = [state_star]
        for k, st in enumerate(final_states, start=1):
            disp2 = geometry.depth_to_disp(st.depth, cfg.min_depth,
                                           cfg.max_depth)
            outputs[f"disp_2_{k}"] = disp2
            outputs[f"disp_0_{k}"] = convex_upsample_disp(
                disp2, self.update_block.upsample_mask(st.net))

        if combine_via_mask or train:
            # training computes the mask for the consistency loss; eval also
            # blends with it. Train quirk: the reference's `_deq_forward`
            # discards the solver result, so the mask reads the INITIAL
            # depth, paired with the post-phantom pose (`:486-495`)
            mask_depth = depth0 if train else state_star.depth
            mask_pose = (pose_star if cfg.pose_for_consistency_mask == "Tstar"
                         else pose0)
            mask = self._consistency_mask(mask_depth, mask_pose, fmap1,
                                          f2_pyramid, K2)
            outputs["consistency_mask"] = mask
        if combine_via_mask and not train:
            m = mask.to(outputs["disp_2_1"].dtype)
            outputs["disp_2_1"] = (outputs["disp_2_1"] * m
                                   + outputs["disp_2_0"] * (1 - m))
            m0 = resize_nearest(m, H, W)
            outputs["disp_0_1"] = (outputs["disp_0_1"] * m0
                                   + outputs["disp_0_0"] * (1 - m0))

        if image3 is not None:
            outputs["pose_p1"] = self._initial_pose(
                im1, imagenet_normalize(image3), False, side, sides)
        return outputs, [pose0, pose_star]

    # ------------------------------------------------------------------
    @staticmethod
    def _phantom_taps(cfg, deq_func, vec_f, flatten, unflatten, anderson_res,
                      states_t, num_iters, pose_star, state_star):
        """The supervised states of a training forward (`--n_losses` /
        `--indexing`, `depth_pose.py:491-513`), each a phantom-gradient
        unroll from its detached value. Returns (states, the pose after the last phantom
        call, which is T*)."""
        if anderson_res is not None:
            # deq-lib tap semantics: a tap at solver step s is the
            # lowest-residual mixed iterate X_j with j <= s - 3; the default
            # tap (indexing [f_thres]) is the solver result
            if cfg.deq_indexing:
                steps_sel = sorted({int(i) for i in cfg.deq_indexing}
                                   | {num_iters})
            elif cfg.deq_n_losses > 1:
                n_loss = min(num_iters, max(cfg.deq_n_losses, 1))
                delta = num_iters // n_loss
                steps_sel = [(kk + 1) * delta for kk in range(n_loss)]
            else:
                steps_sel = [num_iters]
            fired = [t for t in steps_sel if 3 <= t <= num_iters] or [num_iters]
            trace = (anderson_res.abs_trace if cfg.deq_stop_mode == "abs"
                     else anderson_res.rel_trace)
            states_for_tap = []
            for t in fired:
                if t - 2 <= 0 or trace.shape[0] == 0:
                    z_tap = anderson_res.result   # the mixing never ran
                else:
                    z_tap = anderson_res.mixed_trajectory[
                        torch.argmin(trace[:t - 2])]
                states_for_tap.append(DEQState(*unflatten(z_tap), pose_star,
                                               state_star.upd_norm))
            sel = list(range(len(states_for_tap)))
        else:
            n_avail = len(states_t)
            if cfg.deq_indexing:
                sel = sorted({min(max(int(i), 1), n_avail) - 1
                              for i in (*cfg.deq_indexing, n_avail)})
            else:
                n_loss = max(cfg.deq_n_losses, 1)
                delta = max(n_avail // n_loss, 1)
                sel = sorted({min((k + 1) * delta, n_avail) - 1
                              for k in range(n_loss)})
            states_for_tap = states_t

        def deq_step(net, depth, pose, upd_norm):
            return tuple(deq_func(DEQState(net, depth, pose, upd_norm)))

        final_states: list[DEQState] = []
        # the phantom calls continue the pose from the min-update-norm pick
        # (`depth_pose.py:540-551`); the pose after the last one is T*
        phantom_pose = pose_star
        for pos, idx in enumerate(sel):
            z = _detach(states_for_tap[idx])
            z = DEQState(z.net, z.depth, phantom_pose, z.upd_norm)
            steps_out = []
            for _ in range(cfg.phantom_grad_steps):
                # recomputed in the backward, as `jax.checkpoint` does
                # (`mal_tpu/dualref/model.py:451`); deq_func holds no BN
                z_new = DEQState(*remat(deq_step, *z))
                if cfg.deq_tau != 1.0:
                    # damping of the fixed-point vector only; the pose is
                    # module state in the reference, not damped
                    t = cfg.deq_tau
                    z_new = DEQState((1 - t) * z.net + t * z_new.net,
                                     (1 - t) * z.depth + t * z_new.depth,
                                     z_new.pose, z_new.upd_norm)
                z = z_new
                steps_out.append(z)
            phantom_pose = z.pose
            # `--sup_all` supervises every phantom step
            final_states.extend(steps_out if cfg.deq_sup_all
                                else steps_out[-1:])
        return final_states, phantom_pose

    @torch.no_grad()
    def _consistency_mask(self, depth: Tensor, pose: Tensor, fmap1: Tensor,
                          f2_pyramid: list[Tensor], K2: Tensor) -> Tensor:
        """Epipolar argmin-cost depth within 2x of `depth`
        (`depth_pose.py:553-593`): (B, 1, h, w) bool."""
        c0, ds0 = self.reproject_2.depthbins2coords(pose, depth, K2)
        corr0 = epipolar_cost_simple(fmap1, f2_pyramid, c0, num_levels=1)
        idx = torch.argmin(corr0, dim=1, keepdim=True)       # (B, 1, h, w)
        max_d = torch.gather(ds0[:, 0], 1, idx)
        return (((max_d - depth) / depth) < 1.0) & (((depth - max_d) / max_d)
                                                     < 1.0)
