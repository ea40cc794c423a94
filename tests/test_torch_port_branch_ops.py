"""The port's short attention without a bias (K9's plain version), the backward
of the channel-major sampler (K8's) and the row-major sampler with its backward
(K10's) against the JAX package's Pallas kernels in interpret mode, and the
cross-attention module in each `force_branch`, on the CPU in f32: the same
inputs, made from a seed with numpy, go to both.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.models.transformer import MSDeformAttnModule as JaxMSDeformAttn
from lwdetr_tpu.ops import deform_attn as jda
from lwdetr_tpu.ops import flash_attention as jfa
from lwdetr_tpu_torch.models import transformer as ttr
from lwdetr_tpu_torch.ops import deform_attn as tda
from lwdetr_tpu_torch.ops import flash_attention as tfa

# two levels of 144 + 30 positions: over the 128 below which the JAX row-major
# sampler leaves its kernel for the gather formulation
SHAPES = ((12, 12), (5, 6))
LEN_IN = sum(h * w for h, w in SHAPES)


@pytest.mark.parametrize("N", [7, 100, 128])
def test_short_attention_without_bias_matches_jax(N):
    rng = np.random.default_rng(N)
    B, H, D = 3, 2, 32
    qkv = (0.5 * rng.standard_normal((B, 3 * H * D, N))).astype(np.float32)
    dout = rng.standard_normal((B, H * D, N)).astype(np.float32)
    scale = D ** -0.5
    ref, vjp = jax.vjp(lambda t: jfa.attention_cm(t, H, scale, interpret=True), jnp.asarray(qkv))
    (jg,) = vjp(jnp.asarray(dout))
    tq = torch.from_numpy(qkv).requires_grad_()
    with mock.patch.object(tfa, "window_attention", wraps=tfa.window_attention) as spy:
        out = tfa.attention_cm(tq, H, scale)
    assert spy.call_count == 1  # K9's wrapper, not K2's
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    # 1e-4 of the largest gradient
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg),
                               atol=1e-4 * float(np.abs(np.asarray(jg)).max()))
    np.testing.assert_allclose(
        tfa.attention_cm_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(dout), H, scale).numpy(),
        tq.grad.numpy(), atol=1e-6)


@pytest.mark.parametrize("N,bias,wrapper", [
    (128, False, "window_attention"), (129, False, "flash_attention_cm"),
    (1, False, "window_attention"), (128, True, "window_attention_bias"),
    (129, True, "flash_attention_cm")])
def test_attention_dispatch_is_the_jax_packages(N, bias, wrapper):
    """bias and N <= 128 -> K1; no bias and N <= 128 -> K9; else K2."""
    g = torch.Generator().manual_seed(N)
    qkv = torch.randn(1, 3 * 32, N, generator=g)
    b = torch.randn(96, generator=g) if bias else None
    names = ("window_attention", "window_attention_bias", "flash_attention_cm")
    spies = {n: mock.Mock(wraps=getattr(tfa, n)) for n in names}
    with mock.patch.multiple(tfa, **spies):
        out = tfa.attention_cm(qkv, 2, bias=b)
    assert {n: s.call_count for n, s in spies.items()} == {n: int(n == wrapper) for n in names}
    x = qkv if b is None else qkv + b[:, None]
    torch.testing.assert_close(out, tfa.attention_cm_plain(x, 2, 16 ** -0.5), atol=1e-6, rtol=0)


def test_window_kernels_refuse_a_long_sequence():
    with pytest.raises(ValueError, match="N <= 128"):
        tfa._check_window(torch.zeros(1, 96, 129), None)


def _sampler_inputs(seed, P=2, B=2, Q=11, heads=2, D=16):
    """Values, locations (a quarter outside [0, 1], some far outside, some on
    the borders, some on grid lines), softmax weights, d(out) (B, Q, C)."""
    rng = np.random.default_rng(seed)
    L = len(SHAPES)
    value = rng.standard_normal((B, LEN_IN, heads, D)).astype(np.float32)
    loc = rng.uniform(-0.25, 1.25, (B, Q, heads, L, P, 2)).astype(np.float32)
    loc[0, 0] = 0.0
    loc[0, 1] = 1.0
    loc[0, 2, 0] = -7.5
    loc[0, 2, 1] = 1e9
    # on the grid lines of level 0: pixel coordinates 3.0 and 7.0 exactly
    loc[1, 0, :, 0, :, 0] = 3.5 / 12
    loc[1, 0, :, 0, :, 1] = 7.5 / 12
    logits = rng.standard_normal((B, Q, heads, L * P))
    w = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(B, Q, heads, L, P)
    dout = rng.standard_normal((B, Q, heads * D)).astype(np.float32)
    return value, loc, w.astype(np.float32), dout


def _check_sampler_grads(got, ref, dloc_scale):
    dv, dl, dw = got
    jv, jl, jw = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(dv.numpy(), jv, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), jw, atol=1e-5)
    # d(loc) is W_l (or H_l) times sums of order 1: the bound scales with the map
    np.testing.assert_allclose(dl.numpy(), jl, atol=1e-5 * dloc_scale)
    # a point far outside the map carries no gradient at all
    assert not dl[0, 2].any() and not dw[0, 2].any()


@pytest.mark.parametrize("P", [2, 4])
def test_channel_major_sampler_backward_plain_matches_jax_grad(P):
    value, loc, w, dout = _sampler_inputs(81, P)
    B, _, H, D = value.shape
    value_t = np.ascontiguousarray(value.reshape(B, LEN_IN, H * D).transpose(0, 2, 1))
    dout_t = np.ascontiguousarray(dout.transpose(0, 2, 1))  # (B, C, Q)

    def jloss(v, l, a):
        return jnp.sum(jda.ms_deform_attn_cm(v, SHAPES, l, a, H, interpret=True) * dout_t)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(value_t), jnp.asarray(loc),
                                             jnp.asarray(w))
    got = tda.ms_deform_attn_cm_bwd_plain(torch.from_numpy(value_t), SHAPES,
                                          torch.from_numpy(loc), torch.from_numpy(w),
                                          torch.from_numpy(dout_t), H)
    assert got[0].shape == value_t.shape
    _check_sampler_grads(got, ref, 12)
    # and the same through the Function (plain forward, plain backward on the CPU)
    tv, tl, tw = (torch.from_numpy(x).requires_grad_() for x in (value_t, loc, w))
    tda.ms_deform_attn_cm(tv, SHAPES, tl, tw, H).backward(torch.from_numpy(dout_t))
    for a, b in zip((tv.grad, tl.grad, tw.grad), got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("P", [2, 4])
def test_row_major_sampler_matches_jax_kernel_and_gather(P):
    value, loc, w, dout = _sampler_inputs(91, P)
    jargs = (jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(w))
    out = tda.ms_deform_attn(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                             torch.from_numpy(w))
    assert out.shape == dout.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jda.ms_deform_attn_pallas(
        *jargs, interpret=True)), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jda.ms_deform_attn(*jargs)), atol=1e-5)

    got = tda.ms_deform_attn_bwd_plain(torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                                       torch.from_numpy(w), torch.from_numpy(dout))
    assert got[0].shape == value.shape
    for fn in (lambda *a: jda.ms_deform_attn_pallas(*a, interpret=True), jda.ms_deform_attn):
        ref = jax.grad(lambda v, l, a: jnp.sum(fn(v, SHAPES, l, a) * dout), argnums=(0, 1, 2))(
            jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
        _check_sampler_grads(got, ref, 12)
    tv, tl, tw = (torch.from_numpy(x).requires_grad_() for x in (value, loc, w))
    tda.ms_deform_attn(tv, SHAPES, tl, tw).backward(torch.from_numpy(dout))
    for a, b in zip((tv.grad, tl.grad, tw.grad), got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_the_three_layouts_agree_on_one_input():
    value, loc, w, dout = _sampler_inputs(101)
    B, _, H, D = value.shape
    tv, tl, tw = torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(w)
    ref = tda.ms_deform_attn_plain(tv, SHAPES, tl, tw)
    value_t = tv.reshape(B, LEN_IN, H * D).transpose(1, 2)
    torch.testing.assert_close(tda.ms_deform_attn_cm_plain(value_t, SHAPES, tl, tw, H),
                               ref.transpose(1, 2), atol=1e-6, rtol=0)
    panels = [p.contiguous() for p in tda._rowmajor_panels(tv, SHAPES)]
    assert [tuple(p.shape) for p in panels] == [(B, H, 12, 12 * D), (B, H, 5, 6 * D)]
    torch.testing.assert_close(tda.ms_deform_attn_sep_panels_plain(panels, SHAPES, tl, tw), ref,
                               atol=0, rtol=0)
    for a, b in zip(tda._cm_panels(value_t, SHAPES, H), panels):
        assert torch.equal(a, b)


def _gradcheck_inputs():
    g = torch.Generator().manual_seed(1)
    shapes = [(3, 4), (2, 2)]
    value = torch.randn(1, 16, 2, 4, generator=g, dtype=torch.float64, requires_grad=True)
    # points a third of a pixel off the grid lines, where the floor is constant
    # over the finite difference; a few outside the map
    cells = torch.randint(-1, 5, (1, 3, 2, 2, 2, 2), generator=g).double() + 1.0 / 3
    size = torch.tensor([[4.0, 3.0], [2.0, 2.0]], dtype=torch.float64)  # (L, (W, H))
    loc = ((cells + 0.5) / size[None, None, None, :, None, :]).requires_grad_()
    w = torch.rand(1, 3, 2, 2, 2, generator=g, dtype=torch.float64, requires_grad=True)
    return shapes, value, loc, w


def test_row_major_sampler_function_passes_gradcheck_in_f64():
    shapes, value, loc, w = _gradcheck_inputs()
    assert torch.autograd.gradcheck(lambda v, l, a: tda.ms_deform_attn(v, shapes, l, a),
                                    (value, loc, w))


def test_channel_major_sampler_function_passes_gradcheck_in_f64():
    shapes, value, loc, w = _gradcheck_inputs()
    value_t = value.detach().reshape(1, 16, 8).transpose(1, 2).contiguous().requires_grad_()
    assert torch.autograd.gradcheck(lambda v, l, a: tda.ms_deform_attn_cm(v, shapes, l, a, 2),
                                    (value_t, loc, w))


def test_short_attention_function_passes_gradcheck_in_f64():
    qkv = torch.randn(1, 24, 5, generator=torch.Generator().manual_seed(0), dtype=torch.float64,
                      requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: tfa.window_attention(a, 2, 0.5), (qkv,))


def test_sampler_backwards_keep_the_input_dtypes():
    value, loc, w, dout = _sampler_inputs(111)
    B, _, H, D = value.shape
    tv = torch.from_numpy(value).bfloat16().requires_grad_()
    tl, tw = torch.from_numpy(loc).requires_grad_(), torch.from_numpy(w).requires_grad_()
    tda.ms_deform_attn(tv, SHAPES, tl, tw).backward(torch.from_numpy(dout).bfloat16())
    assert tv.grad.dtype == torch.bfloat16 and tl.grad.dtype == tw.grad.dtype == torch.float32
    vt = torch.from_numpy(value).reshape(B, LEN_IN, H * D).transpose(1, 2).bfloat16()
    vt = vt.contiguous().requires_grad_()
    out = tda.ms_deform_attn_cm(vt, SHAPES, tl, tw, H)
    out.backward(torch.from_numpy(dout).transpose(1, 2).bfloat16())
    assert out.dtype == vt.grad.dtype == torch.bfloat16 and vt.grad.shape == vt.shape


# ---- the cross-attention module in each branch ----

B, Q, C, HEADS, POINTS = 2, 20, 32, 2, 2
BRANCH_WRAPPER = {"cm": "ms_deform_attn_cm", "sep": "ms_deform_attn_sep_panels",
                  "gather": "ms_deform_attn"}


@pytest.fixture(scope="module")
def module_case():
    rng = np.random.default_rng(2)
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    memory = rng.standard_normal((B, LEN_IN, C)).astype(np.float32)
    refs = rng.uniform(0.1, 0.9, (B, Q, len(SHAPES), 2)).astype(np.float32)
    jmod = JaxMSDeformAttn(d_model=C, n_levels=len(SHAPES), n_heads=HEADS, n_points=POINTS,
                           force_branch="gather")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(query), jnp.asarray(refs),
                       jnp.asarray(memory), SHAPES)["params"]
    # no zero-initialized offset or weight projection
    params = {name: {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in p.items()} for name, p in params.items()}
    state_dict = {f"{name}.{'weight' if k == 'kernel' else k}":
                  torch.from_numpy(np.ascontiguousarray(v.T if k == "kernel" else v))
                  for name, p in params.items() for k, v in p.items()}
    return query, memory, refs, params, state_dict


def _jax_module(branch):
    return JaxMSDeformAttn(d_model=C, n_levels=len(SHAPES), n_heads=HEADS, n_points=POINTS,
                           force_branch=branch, kernel_interpret=branch != "gather")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("branch", ["sep", "cm", "gather"])
def test_module_matches_jax_module_in_each_branch(module_case, branch, train):
    query, memory, refs, params, state_dict = module_case
    jmod = _jax_module(branch)

    def jloss(p, q, m):
        out = jmod.apply({"params": p}, q, jnp.asarray(refs), m, SHAPES, train=train)
        return jnp.sum(out ** 2), out

    (_, ref), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(query), jnp.asarray(memory))

    tmod = ttr.MSDeformAttnModule(C, len(SHAPES), HEADS, POINTS, force_branch=branch).train(train)
    tmod.load_state_dict(state_dict, strict=True)  # one state_dict loads into every branch
    tq, tm = torch.from_numpy(query).requires_grad_(), torch.from_numpy(memory).requires_grad_()
    names = tuple(BRANCH_WRAPPER.values())
    spies = {n: mock.Mock(wraps=getattr(tda, n)) for n in names}
    with mock.patch.multiple(tda, **spies):
        out = tmod(tq, torch.from_numpy(refs), tm, SHAPES,
                   tm.split([h * w for h, w in SHAPES], dim=1))
    assert {n: s.call_count for n, s in spies.items()} == \
        {n: int(n == BRANCH_WRAPPER[branch]) for n in names}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4)
    (out ** 2).sum().backward()

    # the JAX test's own bound: 2e-3 of max(1, the largest gradient of the tensor)
    def close(got, want, what):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=2e-3, rtol=2e-3,
                                   err_msg=what)

    jp, jq, jm = jgrads
    close(tq.grad, jq, "query")
    close(tm.grad, jm, "memory")
    for name, p in jp.items():
        sub = getattr(tmod, name)
        close(sub.weight.grad, np.asarray(p["kernel"]).T, f"{name}.weight")
        close(sub.bias.grad, p["bias"], f"{name}.bias")


def test_force_branch_takes_only_the_three_names():
    with pytest.raises(ValueError, match="force_branch"):
        ttr.MSDeformAttnModule(C, 1, HEADS, POINTS, force_branch="dense")
    model = torch.nn.Sequential(ttr.MSDeformAttnModule(C, 1, HEADS, POINTS),
                                torch.nn.Sequential(ttr.MSDeformAttnModule(C, 1, HEADS, POINTS)))
    ttr.set_force_branch(model, "gather")
    assert [m.force_branch for m in model.modules()
            if isinstance(m, ttr.MSDeformAttnModule)] == ["gather", "gather"]
    assert ttr.set_force_branch(model, None)[0].force_branch is None
    with pytest.raises(ValueError, match="force_branch"):
        ttr.set_force_branch(model, "CM")
    # the three branches hold the same parameters under the same names
    keys = [tuple(ttr.MSDeformAttnModule(C, 2, HEADS, POINTS, force_branch=b).state_dict())
            for b in (None, "sep", "cm", "gather")]
    assert len(set(keys)) == 1
