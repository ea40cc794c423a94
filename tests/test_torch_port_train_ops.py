"""The port's plain backward versions of the attention and of the panel sampler
against `jax.grad` through the JAX package's Pallas kernels (interpret mode),
on the CPU in f32: the same inputs, made from a seed with numpy, go to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.ops import deform_attn as jda
from lwdetr_tpu.ops import flash_attention as jfa
from lwdetr_tpu_torch.ops import deform_attn as tda
from lwdetr_tpu_torch.ops import flash_attention as tfa

# f32 on both sides, sums in another order: 1e-5 absolute on gradients of order 1
ATOL = 1e-5


def _attention_inputs(seed, B, N, H, D, with_bias):
    rng = np.random.default_rng(seed)
    C = H * D
    # scores of order 1 (a ViT's), so that the softmax is neither flat nor one-hot
    qkv = (0.5 * rng.standard_normal((B, 3 * C, N))).astype(np.float32)
    bias = (0.3 * rng.standard_normal(3 * C)).astype(np.float32) if with_bias else None
    dout = rng.standard_normal((B, C, N)).astype(np.float32)
    return qkv, bias, dout


@pytest.mark.parametrize("B,N,H,D,with_bias", [
    (2, 256, 4, 16, False),   # the long-N kernel (K6's counterpart)
    (4, 100, 4, 16, False),   # ragged N <= 128 without a bias
    (4, 100, 4, 16, True),    # the window kernel with the fused bias (K7's counterpart)
    (2, 300, 2, 32, False),   # ragged N = 300: the decoder's self-attention
    (2, 300, 2, 32, True),    # N > 128 with a bias: added inline
])
def test_attention_backward_plain_matches_jax_grad(B, N, H, D, with_bias):
    qkv, bias, dout = _attention_inputs(31, B, N, H, D, with_bias)
    scale = D ** -0.5

    def jloss(t, b):
        return jnp.sum(jfa.attention_cm(t, H, scale, interpret=True, bias=b) * dout)

    if with_bias:
        jg, jb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    else:
        jg, jb = jax.grad(jloss)(jnp.asarray(qkv), None), None
    tq, td = torch.from_numpy(qkv), torch.from_numpy(dout)
    tb = torch.from_numpy(bias) if with_bias else None
    dqkv = tfa.attention_cm_bwd_plain(tq, td, H, scale, bias=tb)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(jg), atol=ATOL)
    if with_bias:
        # d(bias) sums B x N terms to values of order 50, where one f32 ulp is
        # 4e-6: the two sides differ by up to 3 ulp (1.1e-5 measured)
        np.testing.assert_allclose(dqkv.sum((0, 2)).numpy(), np.asarray(jb), atol=10 * ATOL)
    # with the forward's output given, the row term is sum_d d(out) out, as K6 forms it
    x = tq if tb is None else tq + tb[:, None]
    out = tfa.attention_cm_plain(x, H, scale)
    np.testing.assert_allclose(tfa.attention_cm_bwd_plain(x, td, H, scale, out=out).numpy(),
                               np.asarray(jg), atol=ATOL)


def _panel_inputs(seed, shapes, P, B=2, Q=13, heads=2, D=16):
    """Panels, locations of which a fifth fall outside [0, 1] (some far outside,
    some on the borders), softmax weights, and d(out)."""
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
    dout = rng.standard_normal((B, Q, heads * D)).astype(np.float32)
    return vals, loc, w.reshape(B, Q, heads, L, P).astype(np.float32), dout


@pytest.mark.parametrize("shapes,P", [(((16, 12),), 2), (((16, 12), (5, 7)), 4),
                                      (((8, 8), (4, 4)), 2)],
                         ids=["1-level-2-points", "2-levels-4-points", "2-levels-2-points"])
def test_panel_sampler_backward_plain_matches_jax_grad(shapes, P):
    vals, loc, w, dout = _panel_inputs(41, shapes, P)

    def jloss(vs, l, a):
        return jnp.sum(jda.ms_deform_attn_sep_panels(vs, shapes, l, a, interpret=True) * dout)

    jv, jl, jw = jax.grad(jloss, argnums=(0, 1, 2))(
        tuple(jnp.asarray(v) for v in vals), jnp.asarray(loc), jnp.asarray(w))
    dvals, dloc, dw = tda.ms_deform_attn_sep_panels_bwd_plain(
        [torch.from_numpy(v) for v in vals], shapes, torch.from_numpy(loc), torch.from_numpy(w),
        torch.from_numpy(dout))
    for dv, ref in zip(dvals, jv):
        np.testing.assert_allclose(dv.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jw), atol=ATOL)
    # d(loc) is W_l (or H_l) times sums of order 1 and reaches 100, where one
    # f32 ulp is 8e-6 (8.6e-6 measured): the bound scales with the level's size
    np.testing.assert_allclose(dloc.numpy(), np.asarray(jl), atol=ATOL * max(max(s) for s in shapes))
    # a point far outside the map carries no gradient at all
    assert not dloc[0, 2].any() and not dw[0, 2].any()


def test_attention_functions_pass_gradcheck_in_f64():
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(1, 24, 5, generator=g, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(24, generator=g, dtype=torch.float64, requires_grad=True)
    # the Functions run the plain forward and the plain backward on CPU tensors
    assert torch.autograd.gradcheck(lambda a, b: tfa.window_attention_bias(a, b, 2, 0.5),
                                    (qkv, bias))
    assert torch.autograd.gradcheck(lambda a: tfa.flash_attention_cm(a, 2, 0.5), (qkv,))


def test_panel_sampler_function_passes_gradcheck_in_f64():
    g = torch.Generator().manual_seed(1)
    shapes = [(3, 4), (2, 2)]
    vals = [torch.randn(1, 2, h, w * 4, generator=g, dtype=torch.float64, requires_grad=True)
            for h, w in shapes]
    # points a third of a pixel off the grid lines, where the floor is constant
    # over the finite difference; a few outside the map
    cells = torch.randint(-1, 5, (1, 3, 2, 2, 2, 2), generator=g).double() + 1.0 / 3
    size = torch.tensor([[4.0, 3.0], [2.0, 2.0]], dtype=torch.float64)  # (L, (W, H))
    loc = ((cells + 0.5) / size[None, None, None, :, None, :]).requires_grad_()
    w = torch.rand(1, 3, 2, 2, 2, generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda l, a, *vs: tda.ms_deform_attn_sep_panels(vs, shapes, l, a), (loc, w, *vals))


@pytest.mark.parametrize("with_bias,N", [(True, 100), (False, 100), (True, 200), (False, 200)])
def test_attention_function_matches_autograd_through_the_plain_forward(with_bias, N):
    qkv, bias, dout = _attention_inputs(51, 2, N, 2, 16, with_bias)
    grads = []
    for through_function in (True, False):
        tq = torch.from_numpy(qkv).requires_grad_()
        tb = torch.from_numpy(bias).requires_grad_() if with_bias else None
        if through_function:
            out = tfa.attention_cm(tq, 2, bias=tb)
        else:
            out = tfa.attention_cm_plain(tq if tb is None else tq + tb[:, None], 2, 16 ** -0.5)
        out.backward(torch.from_numpy(dout))
        grads.append((out.detach(), tq.grad, None if tb is None else tb.grad))
    (o1, g1, b1), (o2, g2, b2) = grads
    torch.testing.assert_close(o1, o2, atol=1e-6, rtol=0)
    torch.testing.assert_close(g1, g2, atol=ATOL, rtol=0)
    if with_bias:
        torch.testing.assert_close(b1, b2, atol=10 * ATOL, rtol=0)


def test_panel_sampler_function_matches_autograd_through_the_plain_forward():
    shapes = ((16, 12), (5, 7))
    vals, loc, w, dout = _panel_inputs(61, shapes, 4)
    grads = []
    for fn in (tda.ms_deform_attn_sep_panels, tda.ms_deform_attn_sep_panels_plain):
        tv = [torch.from_numpy(v).requires_grad_() for v in vals]
        tl, tw = torch.from_numpy(loc).requires_grad_(), torch.from_numpy(w).requires_grad_()
        fn(tv, shapes, tl, tw).backward(torch.from_numpy(dout))
        grads.append([v.grad for v in tv] + [tl.grad, tw.grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL * 16, rtol=0)


def test_backward_keeps_the_input_dtypes():
    vals, loc, w, dout = _panel_inputs(71, ((5, 7),), 2)
    tv = [torch.from_numpy(v).bfloat16().requires_grad_() for v in vals]
    tl, tw = torch.from_numpy(loc).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tda.ms_deform_attn_sep_panels(tv, ((5, 7),), tl, tw).backward(torch.from_numpy(dout).bfloat16())
    assert tv[0].grad.dtype == torch.bfloat16 and tl.grad.dtype == tw.grad.dtype == torch.float32
    qkv = torch.randn(1, 96, 20, generator=torch.Generator().manual_seed(0)).bfloat16()
    qkv.requires_grad_()
    bias = torch.zeros(96, requires_grad=True)
    tfa.attention_cm(qkv, 2, bias=bias).sum().backward()
    assert qkv.grad.dtype == torch.bfloat16 and bias.grad.dtype == torch.float32
