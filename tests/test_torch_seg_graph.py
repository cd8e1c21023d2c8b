"""The frozen segmenter's constants and its CUDA-graph route
(`mal_tpu_torch.segment.mask2former.make_seg_fn`).

On the CPU: the normalisation's mean and std (the model's buffers) and the
deformable layers' level sizes (made once per shapes and device) give the
same bits as the host-list formulas they replace, and a second forward
copies nothing from the host. Marked `gpu` (skipped where no CUDA device is
present, decided inside the fixture): the replayed forward against the
eager one, bit for bit, with a Swin-T Mask2Former in fast mode (K2, K3 and
K5 inside the graph). On a machine with a card, without tests/conftest.py,
which sets up JAX for the other tests:

    python -m pytest --noconftest tests/test_torch_seg_graph.py -q
"""

import pytest
import torch

from mal_tpu_torch.ops.cuda.deform_sample import ms_deform_attn_core
from mal_tpu_torch.segment import mask2former as m2f
from mal_tpu_torch.segment.mask2former import (Mask2Former,
                                               instance_inference,
                                               make_seg_fn,
                                               preprocess_images)
from mal_tpu_torch.segment.msdeform import (HEADS, LEVELS, POINTS,
                                            MSDeformAttn)
from mal_tpu_torch.segment.maskformer_v1 import MaskFormerV1
from mal_tpu_torch.utils import profiling

B, H, W, QUERIES, INSTANCES = 2, 64, 96, 8, 4


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _segmenter(device, **kw) -> Mask2Former:
    return Mask2Former(swin_size="tiny", num_queries=QUERIES, device=device,
                       generator=torch.Generator().manual_seed(1), **kw)


def _images(seed: int, device, batch: int = B) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((batch, H, W, 3), generator=g).to(device)


def _instances_equal(got, want) -> None:
    for name, a, b in zip(got._fields, got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


# --------------------------------------------------------------------------
# The constants, on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bgr_input", [True, False])
def test_pixel_stats_give_the_host_list_formulas_bits(bgr_input):
    model = _segmenter("cpu", init_weights=False, bgr_input=bgr_input)
    images = _images(0, "cpu")
    got = preprocess_images(images, bgr_input, mean=model.pixel_mean,
                            std=model.pixel_std)
    x = images.flip(-1) if bgr_input else images
    want = ((x * 255.0 - torch.tensor(m2f._PIXEL_MEAN))
            / torch.tensor(m2f._PIXEL_STD))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # not in the state dict: the published checkpoints' keys are unchanged
    assert not {"pixel_mean", "pixel_std"} & set(model.state_dict())


def test_maskformer_v1_has_the_pixel_stats_outside_its_state_dict():
    model = MaskFormerV1(device="cpu", init_weights=False)
    assert model.pixel_mean.tolist() == torch.tensor(m2f._PIXEL_MEAN).tolist()
    assert model.pixel_std.tolist() == torch.tensor(m2f._PIXEL_STD).tolist()
    assert not {"pixel_mean", "pixel_std"} & set(model.state_dict())


def _old_msdeform(attn: MSDeformAttn, query, refs, value, shapes):
    """`MSDeformAttn.forward` with its level sizes copied from a host list
    at each call, as it was before they were kept."""
    Bq, Lq, C = query.shape
    value = attn.value_proj(value).reshape(Bq, -1, HEADS, C // HEADS)
    offsets = attn.sampling_offsets(query).reshape(Bq, Lq, HEADS, LEVELS,
                                                   POINTS, 2)
    w = attn.attention_weights(query).reshape(Bq, Lq, HEADS, LEVELS * POINTS)
    w = w.softmax(dim=-1).reshape(Bq, Lq, HEADS, LEVELS, POINTS)
    sizes = torch.tensor([[w_, h_] for h_, w_ in shapes],
                         dtype=torch.float32, device=query.device)
    locs = (refs[:, :, None, :, None, :]
            + offsets / sizes[None, None, None, :, None, :])
    out = ms_deform_attn_core(value, shapes, locs.contiguous(),
                              w.contiguous())
    return attn.output_proj(out)


def test_msdeform_level_sizes_give_the_host_list_formulas_bits():
    torch.manual_seed(0)
    attn = MSDeformAttn()
    for p in attn.parameters():   # offsets that reach across the levels
        torch.nn.init.normal_(p, std=0.5)
    shapes = [(2, 3), (4, 6), (8, 12)]
    tokens = sum(h * w for h, w in shapes)
    query = torch.randn(2, tokens, 256)
    value = torch.randn(2, tokens, 256)
    refs = torch.rand(2, tokens, LEVELS, 2)
    with torch.no_grad():
        want = _old_msdeform(attn, query, refs, value, shapes)
        with profiling.recording() as records:
            first = attn(query, refs, value, shapes)
        with profiling.recording() as again:
            second = attn(query, refs, value, shapes)
        # another set of shapes makes its own sizes, once
        with profiling.recording() as other:
            attn(query[:, :30], refs[:, :30], value[:, :30],
                 [(1, 2), (2, 4), (4, 5)])
    torch.testing.assert_close(first, want, rtol=0, atol=0)
    torch.testing.assert_close(second, want, rtol=0, atol=0)
    assert records.counts == {"host_syncs": 1} and again.counts == {}
    assert other.counts == {"host_syncs": 1}


@pytest.fixture(scope="module")
def cpu_segmenter():
    return _segmenter("cpu")


def test_second_forward_copies_nothing_from_the_host():
    """The first forward at a shape copies each deformable layer's level
    sizes (6); the second copies nothing, and gives the same bits."""
    model = _segmenter("cpu")
    images = _images(1, "cpu")
    deform = sum(isinstance(m, MSDeformAttn) for m in model.modules())
    with torch.no_grad():
        with profiling.recording() as first:
            want = model(images)
        with profiling.recording() as second:
            got = model(images)
    assert deform == 6
    assert first.counts == {"host_syncs": deform} and second.counts == {}
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_forward_does_not_depend_on_the_input_layout(cpu_segmenter):
    """A permuted view of NCHW frames, as the synthesis hands them over,
    gives the bits of its contiguous copy."""
    g = torch.Generator().manual_seed(4)
    view = torch.rand((B, 3, H, W), generator=g).permute(0, 2, 3, 1)
    with torch.no_grad():
        got, want = cpu_segmenter(view), cpu_segmenter(view.contiguous())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_seg_fn_on_the_cpu_stays_eager(cpu_segmenter):
    model = cpu_segmenter
    seg_fn = make_seg_fn(model, INSTANCES)
    for seed in (2, 2, 3):
        images = _images(seed, "cpu")
        with profiling.recording() as records:
            got = seg_fn(images)
        with torch.no_grad():
            want = instance_inference(*model(images), H, W, INSTANCES)
        _instances_equal(got, want)
        assert not {"seg_graph_captures", "seg_graph_replays"} & set(
            records.counts)


# --------------------------------------------------------------------------
# The graph, on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def fast_segmenter(cuda):
    """A Swin-T Mask2Former on the card as the hint cell runs its
    segmenter: bf16 with every Swin block as K2 and K3, K5 in the pixel
    decoder."""
    return _segmenter(cuda, bf16_backbone=True, fused_swin=True)


def _eager(model, images):
    with torch.no_grad():
        return instance_inference(*model(images), H, W, INSTANCES)


def _warped(seed: int, device) -> torch.Tensor:
    """A (B, H, W, 3) permuted view of NCHW frames, as the synthesis hands
    its warped frames to the segmenter."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((B, 3, H, W), generator=g).to(device).permute(0, 2, 3, 1)


@pytest.mark.gpu
def test_replay_equals_the_eager_forward_bit_for_bit(fast_segmenter, cuda):
    """Six calls: the warm-up, the capture, then replays, one of them on a
    permuted view; each call's instances equal the eager forward's (which
    does not depend on its input's layout: `preprocess_images`)."""
    model = fast_segmenter
    seg_fn = make_seg_fn(model, INSTANCES)
    inputs = [_images(10, cuda), _images(11, cuda), _images(12, cuda),
              _warped(13, cuda), _images(14, cuda), _images(10, cuda)]
    with profiling.recording() as records:
        for x in inputs:
            _instances_equal(seg_fn(x), _eager(model, x))
    assert records.counts["seg_graph_captures"] == 1
    assert records.counts["seg_graph_replays"] == 5


@pytest.mark.gpu
def test_three_results_alive_each_equal_their_eager_value(fast_segmenter,
                                                          cuda):
    """Two steps' worth of calls in the step's order (the current frame,
    then the two warped frames), the three results of each held at once:
    no stale input, no output aliased by the next replay."""
    model = fast_segmenter
    seg_fn = make_seg_fn(model, INSTANCES)
    for step in range(2):
        frames = [_images(20 + step, cuda), _warped(30 + step, cuda),
                  _warped(40 + step, cuda)]
        got = [seg_fn(x) for x in frames]
        for x, inst in zip(frames, got):
            _instances_equal(inst, _eager(model, x))


@pytest.mark.gpu
def test_replays_make_no_sync_and_count_the_launches(fast_segmenter, cuda):
    """After the warm-up and the capture, replays synchronise nothing
    (the sync debug mode raises on a sync), and each adds to the kernel
    wrappers' `.launches` what an eager forward launches."""
    model = fast_segmenter
    seg_fn = make_seg_fn(model, INSTANCES)
    x = _images(50, cuda)
    before = [f.launches for f in m2f._COUNTED]
    _eager(model, x)
    per_forward = [f.launches - n for f, n in zip(m2f._COUNTED, before)]
    assert per_forward[0] == per_forward[1] == 12   # K2, K3: 12 Swin-T blocks
    assert per_forward[3] == 6                      # K5: 6 encoder layers
    seg_fn(x)
    seg_fn(x)        # the capture, and its replay
    torch.cuda.synchronize()
    start = [f.launches for f in m2f._COUNTED]
    replays = 3
    inputs = [_images(51 + i, cuda) for i in range(replays)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for images in inputs:
            seg_fn(images)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(m2f._COUNTED, start)] == [
        replays * n for n in per_forward]


@pytest.mark.gpu
def test_a_shape_seen_once_is_not_captured(fast_segmenter, cuda):
    model = fast_segmenter
    seg_fn = make_seg_fn(model, INSTANCES)
    with profiling.recording() as records:
        seg_fn(_images(60, cuda))
        seg_fn(_images(61, cuda, batch=1))    # a ragged last batch
        seg_fn(_images(62, cuda, batch=3))
    assert "seg_graph_captures" not in records.counts
    assert "seg_graph_replays" not in records.counts
    with profiling.recording() as records:
        seg_fn(_images(63, cuda, batch=1))
    assert records.counts == {"seg_graph_captures": 1,
                              "seg_graph_replays": 1}


@pytest.mark.gpu
def test_weights_loaded_in_place_reach_the_replay(fast_segmenter, cuda):
    model = fast_segmenter
    seg_fn = make_seg_fn(model, INSTANCES)
    x = _images(70, cuda)
    seg_fn(x)
    before = seg_fn(x)        # captured
    other = _segmenter("cpu", bf16_backbone=True, fused_swin=True)
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(1.5)
    model.load_state_dict(other.state_dict())
    after = seg_fn(x)
    _instances_equal(after, _eager(model, x))
    assert not torch.equal(after.scores, before.scores)
