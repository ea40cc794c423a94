"""Parity of the PyTorch port's operators with the JAX package, on the CPU, in f32.

The same inputs, drawn from a numpy seed, go through the JAX function and
its counterpart in `lwdetr_tpu_torch`. Where the JAX function reaches a
Pallas kernel it runs in interpret mode, as the JAX package's own tests run
it; the port runs its plain versions, which its CUDA kernels are held
against on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lwdetr_tpu.ops import box_ops as jbox
from lwdetr_tpu.ops import deform_attn as jda
from lwdetr_tpu.ops import embeddings as jemb
from lwdetr_tpu.ops import flash_attention as jfa
from lwdetr_tpu.ops import resize as jresize
from lwdetr_tpu_torch.ops import box_ops as tbox
from lwdetr_tpu_torch.ops import deform_attn as tda
from lwdetr_tpu_torch.ops import embeddings as temb
from lwdetr_tpu_torch.ops import flash_attention as tfa
from lwdetr_tpu_torch.ops import resize as tresize

# f32 on both sides; sums run in another order, so agreement is to a few ulp
# of the output's magnitude
ATOL = 2e-5


def _boxes(rng, n):
    cxcy = rng.uniform(0.2, 0.8, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    return np.concatenate([cxcy, wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area",
                                  "elementwise_box_iou", "elementwise_generalized_box_iou",
                                  "box_iou", "generalized_box_iou"])
def test_box_ops_match_jax(name):
    rng = np.random.default_rng(0)
    a = np.array(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(rng, 7))))
    b = np.array(jbox.box_cxcywh_to_xyxy(jnp.asarray(_boxes(rng, 7 if "element" in name else 5))))
    args = (a,) if name in ("box_cxcywh_to_xyxy", "box_xyxy_to_cxcywh", "box_area") else (a, b)
    ref = getattr(jbox, name)(*map(jnp.asarray, args))
    out = getattr(tbox, name)(*map(torch.from_numpy, args))
    if name == "box_iou":  # (iou, union)
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("src,dst", [(14, 40), (14, 8), (14, 14), (7, 20)])
def test_bicubic_matrix_matches_jax_and_torch(src, dst):
    np.testing.assert_array_equal(tresize.bicubic_resize_matrix(src, dst),
                                  jresize.bicubic_resize_matrix(src, dst))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, src, src, 5)).astype(np.float32)
    out = tresize.bicubic_resize_2d(torch.from_numpy(x), (dst, dst)).numpy()
    ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(dst, dst),
                        mode="bicubic", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jresize.bicubic_resize_2d(jnp.asarray(x), (dst, dst))),
                               atol=1e-5)


@pytest.mark.parametrize("src,dst", [(640, 40), (100, 33), (8, 8)])
def test_nearest_index_matches_jax(src, dst):
    np.testing.assert_array_equal(tresize.nearest_resize_index(src, dst),
                                  jresize.nearest_resize_index(src, dst))


def test_sine_position_embedding_matches_jax():
    mask = np.zeros((2, 6, 9), bool)
    mask[1, 4:, :] = True
    mask[1, :, 7:] = True
    ref = jemb.sine_position_embedding(jnp.asarray(mask), num_pos_feats=16)
    out = temb.sine_position_embedding(torch.from_numpy(mask), num_pos_feats=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("coords", [2, 4])
def test_query_sine_embed_matches_jax(coords):
    pos = np.random.default_rng(2).uniform(0, 1, (2, 5, coords)).astype(np.float32)
    ref = jemb.query_sine_embed(jnp.asarray(pos), dim=32)
    out = temb.query_sine_embed(torch.from_numpy(pos), dim=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("N,heads,D,with_bias,scale", [
    (100, 3, 16, True, 1.0),        # window blocks: K1's dispatch
    (200, 3, 16, False, 1.0),       # global blocks: K2's dispatch
    (200, 2, 32, False, 32 ** -0.5),  # decoder self-attention shape class
    (200, 3, 16, True, 0.25),       # bias added inline, then K2
])
def test_attention_cm_matches_jax_interpret(N, heads, D, with_bias, scale):
    rng = np.random.default_rng(3)
    B, C = 2, heads * D
    qkv = rng.standard_normal((B, 3 * C, N)).astype(np.float32)
    bias = rng.standard_normal((3 * C,)).astype(np.float32) * 0.5 if with_bias else None
    ref = jfa.attention_cm(jnp.asarray(qkv), heads, scale, interpret=True,
                           bias=None if bias is None else jnp.asarray(bias))
    out = tfa.attention_cm(torch.from_numpy(qkv), heads, scale,
                           bias=None if bias is None else torch.from_numpy(bias))
    assert out.shape == (B, C, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("D", [8, 24, 48])
@pytest.mark.parametrize("N,with_bias", [(100, True), (100, False), (200, True)],
                         ids=["window_bias", "window", "long_bias"])
def test_zero_padded_attention_equals_the_plain_version(D, N, with_bias):
    """F4: a head_dim outside {16, 32, 64} reaches a kernel zero-padded to the
    next case. On the same padded inputs the plain version gives the
    unpadded output, and d(qkv), d(bias) sliced back, within f32 rounding of
    a sum in another order, and JAX's attention on the unpadded inputs."""
    rng = np.random.default_rng(D + N)
    B, heads = 2, 3
    C = heads * D
    qkv = rng.standard_normal((B, 3 * C, N)).astype(np.float32)
    bias = rng.standard_normal((3 * C,)).astype(np.float32) * 0.5 if with_bias else None
    dout = rng.standard_normal((B, C, N)).astype(np.float32)
    scale = D ** -0.5
    assert tfa.padded_head_dim(D) == {8: 16, 24: 32, 48: 64}[D]

    def run(fn):
        q = torch.from_numpy(qkv).requires_grad_()
        b = None if bias is None else torch.from_numpy(bias).requires_grad_()
        out = fn(q, heads, scale, b)
        out.backward(torch.from_numpy(dout))
        return out.detach(), q.grad, None if b is None else b.grad

    padded, plain = run(tfa.attention_cm_padded), run(tfa.attention_cm)
    assert padded[0].shape == (B, C, N) and padded[1].shape == qkv.shape
    for got, want in zip(padded, plain):
        if want is not None:
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=1e-5)
    ref = jfa.attention_cm(jnp.asarray(qkv), heads, scale, interpret=True,
                           bias=None if bias is None else jnp.asarray(bias))
    np.testing.assert_allclose(padded[0].numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("D", [80, 128])
@pytest.mark.parametrize("N", [100, 200], ids=["short", "long"])
def test_attention_above_head_dim_64_runs_zero_padded_to_the_wide_case(D, N):
    """F4: the decoder's head dims above 64 reach the kernels' wide case
    (128 and up), zero-padded: on the same padded inputs the plain version
    gives the unpadded output and d(qkv) sliced back, and JAX's attention."""
    rng = np.random.default_rng(D + N)
    B, heads = 2, 2
    qkv = rng.standard_normal((B, 3 * heads * D, N)).astype(np.float32)
    dout = rng.standard_normal((B, heads * D, N)).astype(np.float32)
    scale = D ** -0.5
    assert tfa.padded_head_dim(D) == 128 and tfa.padded_head_dim(129) == 256

    def run(fn):
        q = torch.from_numpy(qkv).requires_grad_()
        out = fn(q, heads, scale)
        out.backward(torch.from_numpy(dout))
        return out.detach(), q.grad

    padded, plain = run(tfa.attention_cm_padded), run(tfa.attention_cm)
    for got, want in zip(padded, plain):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=1e-5)
    ref = jfa.attention_cm(jnp.asarray(qkv), heads, scale, interpret=True)
    np.testing.assert_allclose(padded[0].numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("D", [257, 512, 1024])
def test_attention_refuses_head_dims_above_the_widest_case(D):
    """F7: the wide case takes 512, 1024 and 2048 (chunked), so these decoder
    heads now run, 257 zero-padded to 512; the widest case is 2048, and above
    it the padding route refuses, naming the limit, rather than pad."""
    assert tfa.padded_head_dim(256) == 256
    assert tfa.padded_head_dim(D) == {257: 512, 512: 512, 1024: 1024}[D]
    assert tfa.padded_head_dim(D + 1) == {257: 512, 512: 1024, 1024: 2048}[D]
    assert tfa.padded_head_dim(2048) == 2048
    with pytest.raises(ValueError, match="up to 2048"):
        tfa.padded_head_dim(2048 + D)


def test_the_window_kernel_with_a_bias_refuses_head_dims_above_64():
    """K1 / K7 (the ViT's window attention with its qkv bias) keep head_dim
    64 as their largest: every ViT of the JAX package has 12 heads of at most
    64 channels. The refusal names that reason."""
    with pytest.raises(ValueError, match="12 heads"):
        tfa.attention_cm_padded(torch.zeros(1, 3 * 72, 10), 1, 1.0, bias=torch.zeros(3 * 72))


SHAPES = ((8, 10), (4, 5))


def _deform_inputs(seed, B=2, Q=7, heads=2, D=8, P=2):
    rng = np.random.default_rng(seed)
    L = len(SHAPES)
    len_in = sum(h * w for h, w in SHAPES)
    value_t = rng.standard_normal((B, heads * D, len_in)).astype(np.float32)
    # a fifth of the points land outside [0, 1]: their corners must drop out
    loc = rng.uniform(-0.25, 1.25, (B, Q, heads, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, Q, heads, L * P))
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value_t, loc, w.reshape(B, Q, heads, L, P).astype(np.float32), heads


def test_ms_deform_attn_cm_matches_jax_interpret():
    value_t, loc, w, heads = _deform_inputs(4)
    ref = jda.ms_deform_attn_cm(jnp.asarray(value_t), SHAPES, jnp.asarray(loc), jnp.asarray(w),
                                heads, interpret=True)
    out = tda.ms_deform_attn_cm(torch.from_numpy(value_t), SHAPES, torch.from_numpy(loc),
                                torch.from_numpy(w), heads)
    assert out.shape == (2, value_t.shape[1], loc.shape[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_ms_deform_attn_cm_matches_gather_reference():
    # the JAX gather formulation (grid_sample semantics), row-major layout
    value_t, loc, w, heads = _deform_inputs(5)
    B, C, len_in = value_t.shape
    value = value_t.reshape(B, heads, C // heads, len_in).transpose(0, 3, 1, 2)
    ref = jda.ms_deform_attn(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(w))
    out = tda.ms_deform_attn_cm(torch.from_numpy(value_t), SHAPES, torch.from_numpy(loc),
                                torch.from_numpy(w), heads)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("heads,levels,points", [(16, 1, 2), (8, 2, 4)])
def test_sampling_offsets_init_bias_matches_jax(heads, levels, points):
    np.testing.assert_array_equal(tda.sampling_offsets_init_bias(heads, levels, points).numpy(),
                                  np.asarray(jda.sampling_offsets_init_bias(heads, levels, points)))


# two levels of unequal size (16 x 12 and 5 x 7), head_dim 16, 4 points
PANEL_SHAPES = ((16, 12), (5, 7))


def _panel_inputs(seed, B=2, Q=11, heads=2, D=16, P=4, shapes=PANEL_SHAPES):
    """Per-level head-major panels (B, H, H_l, W_l * D), locations of which a
    fifth fall outside [0, 1] (some far outside) and some exactly on the
    borders, softmax weights."""
    rng = np.random.default_rng(seed)
    L = len(shapes)
    vals = [rng.standard_normal((B, heads, h, w * D)).astype(np.float32) for h, w in shapes]
    loc = rng.uniform(-0.25, 1.25, (B, Q, heads, L, P, 2)).astype(np.float32)
    loc[0, 0] = 0.0
    loc[0, 1] = 1.0
    loc[0, 2, 0] = -7.5
    loc[0, 2, 1] = 1e9
    logits = rng.standard_normal((B, Q, heads, L * P))
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return vals, loc, w.reshape(B, Q, heads, L, P).astype(np.float32)


def test_ms_deform_attn_sep_panels_matches_jax_interpret():
    vals, loc, w = _panel_inputs(6)
    ref = jda.ms_deform_attn_sep_panels(tuple(jnp.asarray(v) for v in vals), PANEL_SHAPES,
                                        jnp.asarray(loc), jnp.asarray(w), interpret=True)
    out = tda.ms_deform_attn_sep_panels([torch.from_numpy(v) for v in vals], PANEL_SHAPES,
                                        torch.from_numpy(loc), torch.from_numpy(w))
    assert out.shape == (2, loc.shape[1], 2 * 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_ms_deform_attn_sep_panels_matches_gather_reference():
    # the JAX gather formulation (grid_sample semantics) on the same values, row-major
    vals, loc, w = _panel_inputs(7)
    B, H, D = 2, 2, 16
    value = np.concatenate([v.reshape(B, H, -1, D) for v in vals], axis=2).transpose(0, 2, 1, 3)
    ref = jda.ms_deform_attn(jnp.asarray(value), PANEL_SHAPES, jnp.asarray(loc), jnp.asarray(w))
    out = tda.ms_deform_attn_sep_panels([torch.from_numpy(v) for v in vals], PANEL_SHAPES,
                                        torch.from_numpy(loc), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("D", [16, 32])
def test_the_two_plain_samplers_agree(D):
    # the same values laid out head-major per level and channel-major: one
    # function, to f32 rounding (the same products, summed in another order)
    vals, loc, w = _panel_inputs(8, D=D)
    B, H = 2, 2
    value_t = np.concatenate([v.reshape(B, H, -1, D) for v in vals], axis=2)  # (B, H, Len, D)
    value_t = np.ascontiguousarray(value_t.transpose(0, 1, 3, 2)).reshape(B, H * D, -1)
    panels = tda.ms_deform_attn_sep_panels_plain([torch.from_numpy(v) for v in vals],
                                                 PANEL_SHAPES, torch.from_numpy(loc),
                                                 torch.from_numpy(w))
    cm = tda.ms_deform_attn_cm_plain(torch.from_numpy(value_t), PANEL_SHAPES,
                                     torch.from_numpy(loc), torch.from_numpy(w), H)
    np.testing.assert_allclose(panels.numpy(), cm.numpy().transpose(0, 2, 1), atol=2e-6)


def test_ms_deform_attn_sep_panels_keeps_the_panels_dtype():
    vals, loc, w = _panel_inputs(9)
    out = tda.ms_deform_attn_sep_panels([torch.from_numpy(v).bfloat16() for v in vals],
                                        PANEL_SHAPES, torch.from_numpy(loc), torch.from_numpy(w))
    ref = tda.ms_deform_attn_sep_panels([torch.from_numpy(v).bfloat16().float() for v in vals],
                                        PANEL_SHAPES, torch.from_numpy(loc), torch.from_numpy(w))
    assert out.dtype == torch.bfloat16
    # bf16 rounds where the JAX kernel rounds (ops/deform_attn.py, "bf16"):
    # each level's per-column sums and the output, half a bf16 ulp each, of
    # partial sums no larger than the sum of the terms' magnitudes
    mags = tda.ms_deform_attn_sep_panels([torch.from_numpy(np.abs(v)).bfloat16().float()
                                          for v in vals], PANEL_SHAPES, torch.from_numpy(loc),
                                         torch.from_numpy(np.abs(w)))
    excess = (out.float() - ref).abs() - 2.0 ** -8 * (ref.abs() + mags) - 1e-6
    assert excess.max().item() <= 0


def _split_case(layout, D, seed):
    """Inputs of one sampler layout at head dim D (two heads, two levels, 4
    points) and the call of its pad-and-split route and of its unsplit plain
    version: (tensors that want a gradient, split(*tensors), plain(*tensors))."""
    vals, loc, w = _panel_inputs(seed, D=D)
    B, H = 2, 2
    value = np.concatenate([v.reshape(B, H, -1, D) for v in vals], axis=2)  # (B, H, Len, D)
    shapes = PANEL_SHAPES
    if layout == "sep":
        tensors = [torch.from_numpy(v) for v in vals] + [torch.from_numpy(loc), torch.from_numpy(w)]
        return (tensors,
                lambda *t: tda.ms_deform_attn_sep_panels_split(list(t[:2]), shapes, *t[2:]),
                lambda *t: tda.ms_deform_attn_sep_panels_plain(list(t[:2]), shapes, *t[2:]))
    if layout == "rowmajor":
        tensors = [torch.from_numpy(np.ascontiguousarray(value.transpose(0, 2, 1, 3))),
                   torch.from_numpy(loc), torch.from_numpy(w)]
        return (tensors, lambda *t: tda.ms_deform_attn_split(t[0], shapes, *t[1:]),
                lambda *t: tda.ms_deform_attn_plain(t[0], shapes, *t[1:]))
    value_t = np.ascontiguousarray(value.transpose(0, 1, 3, 2)).reshape(B, H * D, -1)
    tensors = [torch.from_numpy(value_t), torch.from_numpy(loc), torch.from_numpy(w)]
    return (tensors, lambda *t: tda.ms_deform_attn_cm_split(t[0], shapes, *t[1:], H),
            lambda *t: tda.ms_deform_attn_cm_plain(t[0], shapes, *t[1:], H))


@pytest.mark.parametrize("D", [12, 72, 96, 128])
@pytest.mark.parametrize("layout", ["sep", "rowmajor", "cm"])
def test_pad_and_split_route_equals_the_unsplit_plain_version(layout, D):
    """F4: K4 / K5 / K10 / K10b take head dims that are a multiple of 8 up to
    64, K8 a multiple of 4 up to 128. Any other head dim is zero-padded and
    split into groups that share the head's points and weights
    (`head_groups`). With the plain versions standing in for the kernels, the
    route gives the unsplit plain version's output and gradients of the
    values, the locations and the weights (the groups' d(loc), d(weights)
    summed)."""
    multiple, largest = (4, 128) if layout == "cm" else (8, 64)
    G, Dg = tda.head_groups(D, multiple, largest)
    assert Dg % multiple == 0 and Dg <= largest and G * Dg >= D and (G - 1) * Dg < D
    tensors, split, plain = _split_case(layout, D, seed=D)
    dout = None
    results = []
    for fn in (split, plain):
        ins = [t.clone().requires_grad_() for t in tensors]
        out = fn(*ins)
        if dout is None:
            dout = torch.from_numpy(np.random.default_rng(D).standard_normal(
                tuple(out.shape)).astype(np.float32))
        grads = torch.autograd.grad(out, ins, dout)
        results.append((out.detach(),) + grads)
    for got, want in zip(*results):
        assert got.shape == want.shape
        scale = max(1.0, want.abs().max().item())
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL * scale)


# ---- F7: attention at every decoder head dim --------------------------------


@pytest.mark.parametrize("D,N", [(512, 40), (1024, 24), (512, 150)])
def test_wide_plain_attention_matches_the_jax_kernel_in_interpret_mode(D, N):
    """The plain version the chunked wide case is held to on the card, at
    head_dim 512 / 1024 (one head), against the JAX `attention_cm` through
    its Pallas kernels in interpret mode: the all-heads kernel (K9's) at N <=
    128, `_attn_cm_kernel` (K2's) above; forward and the backward through
    `jax.vjp`, in f32."""
    rng = np.random.default_rng(D + N)
    qkv = rng.standard_normal((2, 3 * D, N)).astype(np.float32)
    dout = rng.standard_normal((2, D, N)).astype(np.float32)
    scale = D ** -0.5
    ref, vjp = jax.vjp(lambda t: jfa.attention_cm(t, 1, scale, interpret=True), jnp.asarray(qkv))
    (dref,) = vjp(jnp.asarray(dout))
    x = torch.from_numpy(qkv).requires_grad_()
    out = tfa.attention_cm(x, 1, scale)
    (dx,) = torch.autograd.grad(out, [x], torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5)
    dref = np.asarray(dref)
    np.testing.assert_allclose(dx.numpy(), dref, atol=2e-5 * max(1.0, np.abs(dref).max()))
    np.testing.assert_allclose(tfa.attention_cm_bwd_plain(torch.from_numpy(qkv),
                                                          torch.from_numpy(dout), 1, scale),
                               dref, atol=2e-5 * max(1.0, np.abs(dref).max()))
