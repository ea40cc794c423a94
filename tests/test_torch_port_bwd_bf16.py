"""The port's plain attention backward on bf16 inputs against `jax.vjp` through
the JAX package's Pallas kernels (interpret mode), on the CPU: the same bf16
inputs, made from a seed with numpy, go to both. The JAX kernels round ds and
p to bf16 before their products and (the window kernel) the biased panel once;
the plain version rounds alike, and is what K6 and K7 are held to on the card.

Tolerance: the share of elements whose bf16 bits differ from JAX's is at most
MAX_BITS_DIFFERENT (a sum in another f32 order, or p at an f32 ulp apart,
tips a rounding now and then: 0.01-0.06% measured), and every element lies
within `bf16_bwd_error_bound` of JAX's. Without the roundings 42-44% of the
elements differ, which the tests show fails the first bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.ops import flash_attention as jfa
from lwdetr_tpu_torch.ops import flash_attention as tfa

MAX_BITS_DIFFERENT = 0.005
# the plain version without the roundings must differ in at least this share
MIN_BITS_DIFFERENT_UNROUNDED = 0.2

CASES = [
    (2, 256, 4, 16, False),  # K6's branch
    (2, 300, 2, 32, False),  # K6's branch, ragged: the decoder's self-attention
    (4, 100, 4, 16, False),  # K7's branch without a bias (K7nb)
    (4, 100, 2, 32, False),
    (4, 100, 4, 16, True),   # K7 with the bias on the panel
    (4, 100, 2, 32, True),
]


def _inputs(B, N, H, D, with_bias):
    rng = np.random.default_rng(N + 7 * D + with_bias)
    C = H * D
    qkv = (0.5 * rng.standard_normal((B, 3 * C, N))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * C)).astype(np.float32) if with_bias else None
    dout = rng.standard_normal((B, C, N)).astype(np.float32)
    t16 = torch.from_numpy(qkv).bfloat16()
    d16 = torch.from_numpy(dout).bfloat16()
    return t16, d16, None if bias is None else torch.from_numpy(bias)


def _jax_grads(t16, d16, bias, H, scale):
    """JAX's bf16 d(qkv) (and f32 d(bias)) through the Pallas kernels."""
    q = jnp.asarray(t16.float().numpy(), jnp.bfloat16)
    g = jnp.asarray(d16.float().numpy(), jnp.bfloat16)
    if bias is None:
        _, vjp = jax.vjp(lambda x: jfa.attention_cm(x, H, scale, interpret=True), q)
        (dq,) = vjp(g)
        db = None
    else:
        _, vjp = jax.vjp(lambda x, b: jfa.attention_cm(x, H, scale, interpret=True, bias=b),
                         q, jnp.asarray(bias.numpy()))
        dq, db = vjp(g)
        db = torch.from_numpy(np.array(db))
    return torch.from_numpy(np.array(dq.astype(jnp.float32))), db


def _unrounded(t16, d16, H, scale, bias=None, out=None):
    """The same backward with no rounding before the products: in f32 on the
    panel the bias went into, rounded to bf16 once at the end."""
    panel = t16 if bias is None else t16 + bias.bfloat16()[:, None]
    return tfa.attention_cm_bwd_plain(panel.float(), d16.float(), H, scale,
                                      out=None if out is None else out.float()).bfloat16()


def _bits_different(x, ref):
    return (x.float() != ref).float().mean().item()


@pytest.mark.parametrize("B,N,H,D,with_bias", CASES)
def test_bf16_plain_backward_rounds_as_the_jax_kernels(B, N, H, D, with_bias):
    scale = D ** -0.5
    t16, d16, bias = _inputs(B, N, H, D, with_bias)
    ref, ref_db = _jax_grads(t16, d16, bias, H, scale)
    dqkv = tfa.attention_cm_bwd_plain(t16, d16, H, scale, bias=bias)
    assert dqkv.dtype == torch.bfloat16 and dqkv.shape == t16.shape
    share = _bits_different(dqkv, ref)
    assert share <= MAX_BITS_DIFFERENT, f"{share:.4f} of the elements differ from JAX's"
    bound = tfa.bf16_bwd_error_bound(t16, d16, H, scale, ref, bias=bias)
    excess = ((dqkv.float() - ref).abs() - bound).max().item()
    assert excess <= 0, f"over bf16_bwd_error_bound by {excess}"
    if bias is not None:  # summed in f32 on both sides from (nearly) the same bf16 values
        db = dqkv.float().sum(dim=(0, 2))
        torch.testing.assert_close(db, ref_db, atol=1e-3 * ref_db.abs().max().item(), rtol=0)
    # the check tells the rounding apart: without it the bits differ far more often
    unrounded = _bits_different(_unrounded(t16, d16, H, scale, bias), ref)
    assert unrounded >= MIN_BITS_DIFFERENT_UNROUNDED, unrounded
    assert unrounded > MAX_BITS_DIFFERENT


@pytest.mark.parametrize("B,N,H,D", [(2, 256, 4, 16), (2, 300, 2, 32)])
def test_row_term_from_the_output_sits_farther_from_jax(B, N, H, D):
    """Why K6 forms row_i = sum_j p dp as the JAX kernel does, one more sweep of
    S and dP, and not sum_d d(out) out from the forward's bf16 output: that
    form moves 15-17% of the gradient's elements off JAX's bits (rounding
    noise: under 0.1%)."""
    scale = D ** -0.5
    t16, d16, _ = _inputs(B, N, H, D, False)
    ref, _ = _jax_grads(t16, d16, None, H, scale)
    out = tfa.attention_cm_plain(t16, H, scale)  # bf16, as K2 writes it
    jax_row = _bits_different(tfa.attention_cm_bwd_plain(t16, d16, H, scale), ref)
    out_row = _bits_different(tfa.attention_cm_bwd_plain(t16, d16, H, scale, out=out), ref)
    assert jax_row <= MAX_BITS_DIFFERENT
    assert out_row > 10 * MAX_BITS_DIFFERENT, (jax_row, out_row)


def test_f32_plain_backward_makes_no_bf16_rounding():
    """The f32 path is the f32 formula: the same as the bf16 inputs' values
    taken through it in f64, to f32 rounding."""
    t16, d16, bias = _inputs(2, 100, 2, 16, True)
    panel = (t16 + bias.bfloat16()[:, None]).float()
    f32 = tfa.attention_cm_bwd_plain(panel, d16.float(), 2, 0.25)
    f64 = tfa.attention_cm_bwd_plain(panel.double(), d16.double(), 2, 0.25)
    torch.testing.assert_close(f32.double(), f64, atol=1e-6, rtol=0)
