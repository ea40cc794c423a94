"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips inside its fixture when no CUDA device is
present, so every worker collects the same tests. On the card:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q
"""
import pytest
import torch

from lwdetr_tpu_torch.ops import deform_attn as da
from lwdetr_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

# Each kernel against its plain version run in f32 on the same inputs,
# element by element within ATOL + RTOL * |plain|. f32: the same f32
# arithmetic summed in another order. bf16: the kernel computes in f32 and
# rounds its result once, to nearest even, so it lies within half a bf16 ulp,
# at most 2^-8 of the value, of the f32 result.
ATOL = 2e-5
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(g, B, C, N, dtype):
    return (0.5 * torch.randn((B, 3 * C, N), generator=g, device="cuda")).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,N,heads", [(16, 192, 100, 12), (3, 64, 49, 2), (2, 128, 128, 4),
                                         (2, 128, 1, 2),
                                         (16, 384, 100, 12), (16, 768, 100, 12)])  # head_dim 32, 64
def test_window_attention_bias_matches_plain(cuda, dtype, B, C, N, heads):
    qkv = _qkv(cuda, B, C, N, dtype)
    bias = 0.1 * torch.randn((3 * C,), generator=cuda, device="cuda")
    out = fa.window_attention_bias(qkv, bias, heads, 0.7)
    ref = fa.attention_cm_plain(qkv.float() + bias[:, None], heads, 0.7)
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,N,heads,scale", [(2, 192, 1600, 12, 1.0), (2, 256, 300, 8, 32 ** -0.5),
                                               (1, 128, 33, 2, 0.125), (1, 128, 1, 2, 0.125),
                                               (2, 384, 1600, 12, 1.0),  # head_dim 32
                                               (2, 768, 1600, 12, 1.0),  # head_dim 64
                                               (2, 384, 300, 12, 32 ** -0.5)])
def test_flash_attention_cm_matches_plain(cuda, dtype, B, C, N, heads, scale):
    qkv = _qkv(cuda, B, C, N, dtype)
    out = fa.flash_attention_cm(qkv, heads, scale)
    ref = fa.attention_cm_plain(qkv.float(), heads, scale)
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,Q,heads,P", [([(40, 40)], 300, 16, 2),
                                              ([(16, 20), (8, 10)], 37, 8, 4)])
def test_deform_attn_cm_matches_plain(cuda, dtype, shapes, Q, heads, P):
    B, C, L = 2, 8 * heads, len(shapes)
    len_in = sum(h * w for h, w in shapes)
    value_t = torch.randn((B, C, len_in), generator=cuda, device="cuda").to(dtype)
    loc = torch.rand((B, Q, heads, L, P, 2), generator=cuda, device="cuda") * 1.4 - 0.2
    w = torch.rand((B, Q, heads, L, P), generator=cuda, device="cuda")
    out = da.ms_deform_attn_cm(value_t, shapes, loc, w, heads)
    ref = da.ms_deform_attn_cm_plain(value_t.float(), shapes, loc, w, heads)
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL[dtype])


def _panels(g, B, heads, D, shapes, dtype):
    return [torch.randn((B, heads, h, w * D), generator=g, device="cuda").to(dtype)
            for h, w in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,Q,heads,D,P", [([(80, 80), (20, 20)], 300, 24, 16, 4),
                                                ([(16, 20), (8, 10)], 37, 3, 32, 2),
                                                ([(5, 7)], 1, 2, 16, 1)])
def test_deform_attn_sep_panels_matches_plain(cuda, dtype, shapes, Q, heads, D, P):
    B, L = 2, len(shapes)
    vals = _panels(cuda, B, heads, D, shapes, dtype)
    # a quarter of the points fall outside [0, 1]; some lie on the borders, far out, or are NaN
    loc = torch.rand((B, Q, heads, L, P, 2), generator=cuda, device="cuda") * 1.4 - 0.2
    loc[0, 0, 0, 0, 0] = torch.tensor([0.0, 1.0])
    loc[1, 0, 0, 0, 0] = torch.tensor([-1e9, 0.5])
    loc[1, 0, 1, 0, 0] = torch.tensor([0.5, float("nan")])
    w = torch.rand((B, Q, heads, L, P), generator=cuda, device="cuda")
    out = da.ms_deform_attn_sep_panels(vals, shapes, loc, w)
    ref = da.ms_deform_attn_sep_panels_plain([v.float() for v in vals], shapes,
                                             torch.nan_to_num(loc, nan=-5.0), w)
    assert out.shape == (B, Q, heads * D) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=RTOL[dtype])


def test_deform_attn_sep_panels_agrees_with_the_channel_major_kernel(cuda):
    # K4 and K3 compute one function from two layouts of the same values
    shapes, B, Q, heads, D, P = [(12, 9), (6, 5)], 2, 50, 4, 16, 4
    vals = _panels(cuda, B, heads, D, shapes, torch.float32)
    loc = torch.rand((B, Q, heads, 2, P, 2), generator=cuda, device="cuda") * 1.4 - 0.2
    w = torch.rand((B, Q, heads, 2, P), generator=cuda, device="cuda")
    value_t = torch.cat([v.reshape(B, heads, -1, D) for v in vals], dim=2)
    value_t = value_t.transpose(2, 3).reshape(B, heads * D, -1)
    out = da.ms_deform_attn_sep_panels(vals, shapes, loc, w)
    ref = da.ms_deform_attn_cm(value_t, shapes, loc, w, heads).transpose(1, 2)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0.0)


def test_dispatch_counts_launches(cuda):
    kernels = (fa.window_attention_bias_kernel, fa.flash_attention_cm_kernel,
               da.deform_attn_cm_kernel, da.deform_attn_sep_kernel)
    before = [k.launches for k in kernels]
    qkv = _qkv(cuda, 2, 64, 100, torch.float32)
    fa.attention_cm(qkv, 4, bias=torch.zeros(192, device="cuda"))  # N <= 128 with bias: K1
    fa.attention_cm(qkv, 4)  # no bias: K2
    fa.attention_cm(_qkv(cuda, 2, 64, 200, torch.float32), 4,
                    bias=torch.zeros(192, device="cuda"))  # N > 128: bias inline, K2
    da.ms_deform_attn_cm(torch.zeros((1, 16, 12), device="cuda"), [(3, 4)],
                         torch.rand((1, 5, 2, 1, 2, 2), device="cuda"),
                         torch.rand((1, 5, 2, 1, 2), device="cuda"), 2)
    da.ms_deform_attn_sep_panels([torch.zeros((1, 2, 3, 4 * 16), device="cuda")], [(3, 4)],
                                 torch.rand((1, 5, 2, 1, 2, 2), device="cuda"),
                                 torch.rand((1, 5, 2, 1, 2), device="cuda"))
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 2, 1, 1]


def test_autograd_on_cuda_is_refused(cuda):
    qkv = _qkv(cuda, 1, 64, 50, torch.float32).requires_grad_()
    with pytest.raises(NotImplementedError, match="K6"):
        fa.attention_cm(qkv, 4)
    value_t = torch.zeros((1, 16, 12), device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="K8"):
        da.ms_deform_attn_cm(value_t, [(3, 4)], torch.rand((1, 5, 2, 1, 2, 2), device="cuda"),
                             torch.rand((1, 5, 2, 1, 2), device="cuda"), 2)
    panel = torch.zeros((1, 2, 3, 4 * 16), device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="K5"):
        da.ms_deform_attn_sep_panels([panel], [(3, 4)],
                                     torch.rand((1, 5, 2, 1, 2, 2), device="cuda"),
                                     torch.rand((1, 5, 2, 1, 2), device="cuda"))


def test_sep_panels_refuses_what_the_kernel_does_not_take(cuda):
    loc = torch.rand((1, 5, 2, 1, 2, 2), device="cuda")
    w = torch.rand((1, 5, 2, 1, 2), device="cuda")
    launches = da.deform_attn_sep_kernel.launches
    with pytest.raises(ValueError, match="head_dim"):
        da.ms_deform_attn_sep_panels([torch.zeros((1, 2, 3, 4 * 8), device="cuda")], [(3, 4)],
                                     loc, w)
    with pytest.raises(TypeError):
        da.ms_deform_attn_sep_panels([torch.zeros((1, 2, 3, 4 * 16), device="cuda",
                                                  dtype=torch.float16)], [(3, 4)], loc, w)
    with pytest.raises(ValueError, match="panel must be"):
        da.ms_deform_attn_sep_panels([torch.zeros((1, 2, 4, 4 * 16), device="cuda")], [(3, 4)],
                                     loc, w)
    with pytest.raises(ValueError, match="one device"):
        da.ms_deform_attn_sep_panels([torch.zeros((1, 2, 3, 4 * 16), device="cuda")], [(3, 4)],
                                     loc, w.cpu())
    assert da.deform_attn_sep_kernel.launches == launches


def test_unsupported_shapes_raise(cuda):
    with pytest.raises(ValueError):
        fa.window_attention_bias(_qkv(cuda, 1, 64, 129, torch.float32),
                                 torch.zeros(192, device="cuda"), 4, 1.0)
    with pytest.raises(ValueError):
        fa.flash_attention_cm(_qkv(cuda, 1, 48, 10, torch.float32), 4, 1.0)  # head_dim 12
    with pytest.raises(TypeError):
        fa.flash_attention_cm(_qkv(cuda, 1, 64, 10, torch.float16), 4, 1.0)
