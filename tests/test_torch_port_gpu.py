"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips inside its fixture when no CUDA device is
present, so every worker collects the same tests. On the card:

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q
"""
from unittest import mock

import pytest
import torch

from lwdetr_tpu_torch.models import transformer as tr
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
# The bf16 attention kernels (K1, K2, K9, on the tensor cores) also round the
# softmax weights to bf16 before PV, as the JAX kernels do: they are held to
# `fa.bf16_error_bound` (ATOL + 2^-8 |plain| + 2^-8 plain(q, k, |v|), derived
# there) against the plain version that rounds alike, and against the f32
# plain version on the same bf16 values. The bf16 attention backwards (K6,
# K7) round ds and p to bf16 before their products, as the JAX kernels do:
# they are held to `fa.bf16_bwd_error_bound` in the same two ways.
# The bf16 samplers (K3, K4, K10; K5's backward) round where the JAX kernels
# round (`ops/deform_attn.py`, "bf16"), as their plain versions on the same
# bf16 values do: held to those within ATOL + SAMPLER_RTOL |plain|, one bf16
# ulp, since a sum in another f32 order may tip a rounding. K5's bf16 d(loc) and
# d(weights) come from bf16 weight gradients: within `sep_panels_bwd_bf16_bound`
# (one ulp of each) of the plain version's.
SAMPLER_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def _sampler_ref(plain, value, dtype, *args):
    """A forward sampler's plain reference: on the f32 values in f32, on the
    bf16 values themselves in bf16 (rounding as the kernel), as f32."""
    if dtype == torch.float32:
        value = [v.float() for v in value] if isinstance(value, list) else value.float()
    return plain(value, *args).float()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # f32 stays f32 in matmuls and convolutions alike (as the CLI sets it), so
    # no test's result depends on which test set the flags before it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(g, B, C, N, dtype):
    return (0.5 * torch.randn((B, 3 * C, N), generator=g, device="cuda")).to(dtype)


def _close_attention(out, panel, heads, scale):
    """An attention kernel's output against the plain version on `panel`
    (the bf16 or f32 values it attended over): f32 within ATOL, bf16 within
    `bf16_error_bound` of the plain version that rounds p and of the f32 one."""
    ref32 = fa.attention_cm_plain(panel.float(), heads, scale)
    if panel.dtype == torch.float32:
        torch.testing.assert_close(out.float(), ref32, atol=ATOL, rtol=0.0)
        return
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    for ref in (fa.attention_cm_plain(panel, heads, scale).float(), ref32):
        bound = fa.bf16_error_bound(panel, heads, scale, ref)
        excess = ((out.float() - ref).abs() - bound).max().item()
        assert excess <= 0, f"over the bf16 bound by {excess}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,N,heads", [(16, 192, 100, 12), (3, 64, 49, 2), (2, 128, 128, 4),
                                         (2, 128, 1, 2),
                                         (16, 384, 100, 12), (16, 768, 100, 12),  # head_dim 32, 64
                                         # N = 33: rows neither 8- nor 16-byte aligned (plain
                                         # loads), at head_dim 16, 32, 64
                                         (2, 64, 33, 4), (2, 128, 33, 4), (2, 256, 33, 4)])
def test_window_attention_bias_matches_plain(cuda, dtype, B, C, N, heads):
    qkv = _qkv(cuda, B, C, N, dtype)
    bias = 0.1 * torch.randn((3 * C,), generator=cuda, device="cuda")
    out = fa.window_attention_bias(qkv, bias, heads, 0.7)
    # the panel the kernel attends over: bf16(x + bf16(bias)) in bf16 (the JAX
    # kernel's rounding), the f32 sum in f32
    _close_attention(out, qkv + bias.to(dtype)[:, None], heads, 0.7)


# the copy widths of K2's bf16 loads: N % 8 == 0 takes 16-byte copies (1600),
# N % 4 == 0 8-byte ones (100, 300), any other N plain loads (33, 129)
# head_dim 16, 32 and 64 (4 heads) at each of them
UNALIGNED = [(1, 64 * m, n, 4, 0.25) for n in (100, 300, 33, 129) for m in (1, 2, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,N,heads,scale", [(2, 192, 1600, 12, 1.0), (2, 256, 300, 8, 32 ** -0.5),
                                               (1, 128, 33, 2, 0.125), (1, 128, 1, 2, 0.125),
                                               (2, 384, 1600, 12, 1.0),  # head_dim 32
                                               (2, 768, 1600, 12, 1.0),  # head_dim 64
                                               (2, 384, 300, 12, 32 ** -0.5)] + UNALIGNED)
def test_flash_attention_cm_matches_plain(cuda, dtype, B, C, N, heads, scale):
    qkv = _qkv(cuda, B, C, N, dtype)
    out = fa.flash_attention_cm(qkv, heads, scale)
    _close_attention(out, qkv, heads, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,N,heads,scale", [(2, 192, 1600, 12, 1.0), (2, 256, 300, 8, 32 ** -0.5),
                                               (2, 768, 1600, 12, 1.0), (1, 128, 129, 4, 0.125)])
def test_flash_attention_cm_log_sum_exp_matches_plain(cuda, dtype, B, C, N, heads, scale):
    """The row log-sum-exp K2 writes for K6 (log2 units), in f32 and bf16,
    against the plain one from the f32 scores of the same values, within
    2e-5 + 2^-8 |lse|; writing it changes no output."""
    qkv = _qkv(cuda, B, C, N, dtype)
    out, lse = fa.flash_attention_cm_fwd(qkv, heads, scale, with_lse=True)
    assert lse.shape == (B, heads, N) and lse.dtype == torch.float32
    assert torch.equal(out, fa.flash_attention_cm_fwd(qkv, heads, scale)[0])
    x = qkv.float().reshape(B, 3, heads, C // heads, N)
    s = torch.einsum("bhdn,bhdm->bhnm", x[:, 0] * scale, x[:, 1])
    ref = torch.logsumexp(s, dim=-1) / torch.log(torch.tensor(2.0))
    torch.testing.assert_close(lse, ref, atol=2e-5, rtol=2.0 ** -8)


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
    ref = _sampler_ref(lambda v, *a: da.ms_deform_attn_cm_plain(v, *a), value_t, dtype, shapes,
                       loc, w, heads)
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=SAMPLER_RTOL[dtype])


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
    ref = _sampler_ref(da.ms_deform_attn_sep_panels_plain, vals, dtype, shapes,
                       torch.nan_to_num(loc, nan=-5.0), w)
    assert out.shape == (B, Q, heads * D) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=SAMPLER_RTOL[dtype])


# K4 and K10 beyond the paths' shapes: (B, shapes, Q, heads, D, P). A Q that
# no query tile divides, Q = 1, head_dim 32 and 64 (3 points a level: 6 a (q,
# h), padded to 8 in the point table), four levels (16 points a (q, h)), and
# head_dim 8 (the micro fixture's cross-attention) and 24 (no power of two)
SEP_ROUTE_CASES = [(4, [(40, 40)], 1001, 16, 16, 2), (2, [(5, 7)], 1, 2, 16, 1),
                   (4, [(40, 40)], 300, 8, 32, 2), (2, [(20, 20), (10, 10)], 77, 4, 64, 3),
                   (2, [(40, 40), (20, 20), (10, 10), (5, 5)], 150, 8, 16, 4),
                   (2, [(16, 16), (4, 4)], 60, 8, 8, 4), (2, [(12, 10)], 33, 4, 24, 2)]


@pytest.mark.parametrize("layout", ["panels", "rowmajor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,shapes,Q,heads,D,P", SEP_ROUTE_CASES)
def test_panel_and_row_major_forwards_match_plain_on_every_route(cuda, layout, dtype, B, shapes,
                                                                 Q, heads, D, P):
    """K4 (panels) and K10 (row-major) against the plain version, one launch
    each, with points on the borders, far outside, NaN and (the last query) on
    grid lines; the route keeps no stack and spills nothing."""
    L = len(shapes)
    vals = _panels(cuda, B, heads, D, shapes, dtype)
    loc, w = _sampler_points(cuda, B, Q, heads, L, P)
    for lvl, (h, wd) in enumerate(shapes):  # pixel centres: fractions 0
        for axis, size in ((0, wd), (1, h)):
            pick = torch.randint(0, size, (B, heads, P), generator=cuda, device="cuda")
            loc[:, -1, :, lvl, :, axis] = (pick.float() + 0.5) / size
    kernel = da.deform_attn_sep_kernel if layout == "panels" else da.deform_attn_rowmajor_kernel
    route = da.sep_route(kernel, B, Q, heads, D, L, P, dtype)
    assert route["local_bytes"] == 0 and route["threads"] <= 512, route
    before = kernel.launches
    if layout == "panels":
        out = da.ms_deform_attn_sep_panels(vals, shapes, loc, w)
    else:
        value = torch.cat([v.reshape(B, heads, -1, D) for v in vals], dim=2)
        out = da.ms_deform_attn(value.transpose(1, 2).contiguous(), shapes, loc, w)
    assert kernel.launches == before + 1
    clean = torch.nan_to_num(loc, nan=-5.0)
    if layout == "panels":
        ref = _sampler_ref(da.ms_deform_attn_sep_panels_plain, vals, dtype, shapes, clean, w)
    else:
        ref = _sampler_ref(da.ms_deform_attn_plain, value.transpose(1, 2).contiguous(), dtype,
                           shapes, clean, w)
    assert out.shape == (B, Q, heads * D) and out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=SAMPLER_RTOL[dtype])


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


def test_bench_attention_times_each_attention_of_a_forward(cuda):
    """`bench_attention` keeps the inputs of every attention of tiny's eval
    forward, each under the kernel that launched for it."""
    from lwdetr_tpu_torch import bench_attention

    out = bench_attention.run("tiny", 1)
    launches = {}
    for row in out["kernels"]:
        launches[row["kernel"]] = launches.get(row["kernel"], 0) + row["launches"]
        assert row["device_ms"] > 0 and row["ms"] > 0
    assert launches == {"K1": 3, "K2": 3, "K9": 3}
    assert "k2_device_ms" in next(r for r in out["kernels"] if r["kernel"] == "K9")


def test_dispatch_counts_launches(cuda):
    kernels = (fa.window_attention_bias_kernel, fa.flash_attention_cm_kernel,
               da.deform_attn_cm_kernel, da.deform_attn_sep_kernel, fa.window_attention_kernel,
               da.deform_attn_rowmajor_kernel)
    before = [k.launches for k in kernels]
    qkv = _qkv(cuda, 2, 64, 100, torch.float32)
    fa.attention_cm(qkv, 4, bias=torch.zeros(192, device="cuda"))  # N <= 128 with bias: K1
    fa.attention_cm(qkv, 4)  # N <= 128, no bias: K9
    fa.attention_cm(_qkv(cuda, 2, 64, 128, torch.float32), 4)  # N = 128: still K9
    fa.attention_cm(_qkv(cuda, 2, 64, 129, torch.float32), 4)  # N = 129: K2
    fa.attention_cm(_qkv(cuda, 2, 64, 200, torch.float32), 4,
                    bias=torch.zeros(192, device="cuda"))  # N > 128: bias inline, K2
    da.ms_deform_attn(torch.zeros((1, 12, 2, 16), device="cuda"), [(3, 4)],
                      torch.rand((1, 5, 2, 1, 2, 2), device="cuda"),
                      torch.rand((1, 5, 2, 1, 2), device="cuda"))
    da.ms_deform_attn_cm(torch.zeros((1, 16, 12), device="cuda"), [(3, 4)],
                         torch.rand((1, 5, 2, 1, 2, 2), device="cuda"),
                         torch.rand((1, 5, 2, 1, 2), device="cuda"), 2)
    da.ms_deform_attn_sep_panels([torch.zeros((1, 2, 3, 4 * 16), device="cuda")], [(3, 4)],
                                 torch.rand((1, 5, 2, 1, 2, 2), device="cuda"),
                                 torch.rand((1, 5, 2, 1, 2), device="cuda"))
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 2, 1, 1, 2, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,N,heads", [(8, 256, 100, 8), (52, 256, 100, 8), (3, 64, 49, 2),
                                         (2, 128, 128, 4), (2, 128, 1, 2), (3, 192, 100, 12),
                                         (2, 768, 100, 12),  # head_dim 32, 16, 64
                                         (2, 64, 33, 4), (2, 256, 33, 4),  # plain loads
                                         (2, 512, 33, 8)])  # head_dim 64, plain loads
def test_window_attention_without_bias_matches_plain(cuda, dtype, B, C, N, heads):
    qkv = _qkv(cuda, B, C, N, dtype).requires_grad_()
    dout = torch.randn((B, C, N), generator=cuda, device="cuda").to(dtype)
    kernels = (fa.window_attention_kernel, fa.window_attention_bwd_kernel,
               fa.window_attention_bias_kernel, fa.window_attention_bias_bwd_kernel,
               fa.flash_attention_cm_kernel, fa.flash_attention_cm_bwd_kernel)
    before = [k.launches for k in kernels]
    with mock.patch.object(fa, "attention_cm_plain", side_effect=AssertionError("plain")), \
            mock.patch.object(fa, "attention_cm_bwd_plain", side_effect=AssertionError("plain")):
        out = fa.attention_cm(qkv, heads, 0.7)
        out.backward(dout)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0, 0, 0, 0]
    assert out.dtype == dtype and qkv.grad.dtype == dtype
    _close_attention(out.detach(), qkv.detach(), heads, 0.7)
    _close_attention_bwd(qkv.grad, qkv.detach(), dout, heads, 0.7, "K7 without a bias")


def _sampler_points(g, B, Q, heads, L, P):
    """A quarter of the points outside [0, 1]; some on the borders, far out, or NaN."""
    loc = torch.rand((B, Q, heads, L, P, 2), generator=g, device="cuda") * 1.4 - 0.2
    loc[0, 0, 0, 0, 0] = torch.tensor([0.0, 1.0])
    loc[1, 0, 0, 0, 0] = torch.tensor([-1e9, 0.5])
    loc[1, 0, 1, 0, 0] = torch.tensor([0.5, float("nan")])
    w = torch.rand((B, Q, heads, L, P), generator=g, device="cuda")
    return loc, w


SAMPLER_CASES = [([(40, 40)], 1300, 16, 16, 2), ([(80, 80), (20, 20)], 301, 24, 16, 4),
                 ([(16, 20), (8, 10)], 37, 3, 32, 2), ([(5, 7)], 1, 2, 16, 1)]
# K5 / K10b: (B, shapes, Q, heads, D, P): many maps of 40 x 40 with few
# queries, small's and tiny's train map with small's queries, large's train
# levels, head_dim 32, a map of 5 rows, and a 160 x 160 map beside a small one
SAMPLER_BWD_CASES = [(8, [(40, 40)], 300, 16, 16, 2), (2, [(40, 40)], 3900, 16, 16, 2),
                     (2, [(80, 80), (20, 20)], 3900, 24, 16, 4),
                     (2, [(16, 20), (8, 10)], 37, 3, 32, 2), (2, [(5, 7)], 1, 2, 16, 1),
                     (2, [(160, 160), (20, 20)], 50, 2, 16, 2),
                     (2, [(16, 16), (4, 4)], 60, 8, 8, 4), (2, [(20, 20), (10, 10)], 77, 4, 64, 3),
                     (2, [(12, 10)], 33, 4, 24, 2)]


def _check_sampler_grads(name, dtype, grads, refs, rtol=None):
    (dv, dl, dw), (rv, rl, rw) = grads, refs
    assert dv.dtype == dtype and dl.dtype == dw.dtype == torch.float32
    # d(value) sums up to hundreds of atomic adds per position in an order that
    # changes from run to run: 4 x the f32 bound
    _close_bwd(dv, rv.float(), dtype, f"{name} d(value)", atol_scale=4.0, rtol=rtol)
    _close_bwd(dl, rl, torch.float32, f"{name} d(loc)")
    _close_bwd(dw, rw, torch.float32, f"{name} d(weights)")
    assert ((rv == 0) <= (dv == 0)).all()  # untouched positions get an exact zero
    assert not dl[1, 0, 0, 0, 0].any() and not dl[1, 0, 1, 0, 0].any()  # far out, NaN
    assert not dw[1, 0, 0, 0, 0].any() and not dw[1, 0, 1, 0, 0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,Q,heads,D,P", SAMPLER_CASES)
def test_deform_attn_cm_bwd_matches_plain(cuda, dtype, shapes, Q, heads, D, P):
    B, L, len_in = 2, len(shapes), sum(h * w for h, w in shapes)
    value_t = torch.randn((B, heads * D, len_in), generator=cuda, device="cuda").to(dtype)
    value_t.requires_grad_()
    loc, w = (t.requires_grad_() for t in _sampler_points(cuda, B, Q, heads, L, P))
    dout = torch.randn((B, heads * D, Q), generator=cuda, device="cuda").to(dtype)
    before = (da.deform_attn_cm_kernel.launches, da.deform_attn_cm_bwd_kernel.launches)
    with mock.patch.object(da, "ms_deform_attn_cm_plain", side_effect=AssertionError("plain")), \
            mock.patch.object(da, "ms_deform_attn_cm_bwd_plain",
                              side_effect=AssertionError("plain")):
        da.ms_deform_attn_cm(value_t, shapes, loc, w, heads).backward(dout)
    assert (da.deform_attn_cm_kernel.launches, da.deform_attn_cm_bwd_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    refs = _cm_bwd_ref(value_t.detach(), shapes, torch.nan_to_num(loc.detach(), nan=-5.0),
                       w.detach(), dout, heads)
    _check_sampler_grads("K8", dtype, (value_t.grad, loc.grad, w.grad), refs,
                         SAMPLER_RTOL[dtype])


def _cm_bwd_ref(value_t, shapes, loc, w, dout, heads):
    """K8's plain reference: in f32 on f32 values; on bf16 values in bf16, its
    d(value) from the merged weights rounded as the kernel rounds them."""
    if value_t.dtype == torch.float32:
        return da.ms_deform_attn_cm_bwd_plain(value_t, shapes, loc, w, dout.float(), heads)
    return da.ms_deform_attn_cm_bwd_plain(value_t, shapes, loc, w, dout, heads)


# K3 and K8 on each route of `csrc/deform_cm.cuh`: (B, shapes, Q, heads, D,
# P). large's two levels (over the staging budget: gathered from device
# memory); tiny's train map with a Q that no CTA's query slice divides
# (several CTAs a map); Q = 1; a bf16 map of 840 bytes, no multiple of 16
# (copied element by element; 1680 bytes in f32: bulk copies); D = 32 (in
# f32 a map of 205 KB: device memory; in bf16 staged)
CM_ROUTE_CASES = [(8, [(80, 80), (20, 20)], 300, 24, 16, 4), (4, [(40, 40)], 1001, 16, 16, 2),
                  (2, [(5, 7)], 1, 2, 16, 1), (2, [(5, 7)], 37, 3, 12, 2),
                  (4, [(40, 40)], 300, 8, 32, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,shapes,Q,heads,D,P", CM_ROUTE_CASES)
def test_channel_major_pair_matches_plain_on_every_route(cuda, dtype, B, shapes, Q, heads, D, P):
    L, len_in = len(shapes), sum(h * w for h, w in shapes)
    value_t = torch.randn((B, heads * D, len_in), generator=cuda, device="cuda").to(dtype)
    loc, w = _sampler_points(cuda, B, Q, heads, L, P)
    dout = torch.randn((B, heads * D, Q), generator=cuda, device="cuda").to(dtype)
    routes = {k.name: da.cm_route(k, value_t, Q, heads)
              for k in (da.deform_attn_cm_kernel, da.deform_attn_cm_bwd_kernel)}
    map_bytes = D * len_in * value_t.element_size()
    for name, route in routes.items():
        assert route["local_bytes"] == 0, (name, route)
        if map_bytes > 200_000:
            assert not route["staged"], (name, route)
        elif map_bytes % 16:
            assert route["staged"] and not route["bulk_copy"], (name, route)
        else:
            assert route["staged"] and route["bulk_copy"], (name, route)
            assert route["shared_bytes"] == map_bytes, (name, route)
    before = (da.deform_attn_cm_kernel.launches, da.deform_attn_cm_bwd_kernel.launches)
    out = da.ms_deform_attn_cm(value_t, shapes, loc, w, heads)
    grads = da.ms_deform_attn_cm_bwd(value_t, shapes, loc, w, dout, heads)
    assert (da.deform_attn_cm_kernel.launches, da.deform_attn_cm_bwd_kernel.launches) == \
        (before[0] + 1, before[1] + 1)
    # a NaN location gives nothing, as one far outside the map
    loc_ref = torch.nan_to_num(loc, nan=-5.0)
    ref = _sampler_ref(lambda v, *a: da.ms_deform_attn_cm_plain(v, *a), value_t, dtype, shapes,
                       loc_ref, w, heads)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, atol=ATOL, rtol=SAMPLER_RTOL[dtype])
    refs = _cm_bwd_ref(value_t, shapes, loc_ref, w, dout, heads)
    _check_sampler_grads("K8", dtype, grads, refs, SAMPLER_RTOL[dtype])


def test_channel_major_backward_refuses_head_dims_off_whole_float4s(cuda):
    value_t = torch.zeros((1, 12, 12), device="cuda")  # 2 heads of 6 channels
    loc = torch.rand((1, 5, 2, 1, 2, 2), device="cuda")
    w = torch.rand((1, 5, 2, 1, 2), device="cuda")
    launches = da.deform_attn_cm_bwd_kernel.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        da.ms_deform_attn_cm_bwd(value_t, [(3, 4)], loc, w, torch.zeros((1, 12, 5), device="cuda"),
                                 2)
    assert da.deform_attn_cm_bwd_kernel.launches == launches
    da.ms_deform_attn_cm(value_t, [(3, 4)], loc, w, 2)  # the forward takes any head dim


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,shapes,Q,heads,D,P", SAMPLER_BWD_CASES)
def test_deform_attn_row_major_matches_plain(cuda, dtype, B, shapes, Q, heads, D, P):
    L, len_in = len(shapes), sum(h * w for h, w in shapes)
    value = torch.randn((B, len_in, heads, D), generator=cuda, device="cuda").to(dtype)
    value.requires_grad_()
    loc, w = (t.requires_grad_() for t in _sampler_points(cuda, B, Q, heads, L, P))
    dout = torch.randn((B, Q, heads * D), generator=cuda, device="cuda").to(dtype)
    kernels = (da.deform_attn_rowmajor_kernel, da.deform_attn_rowmajor_bwd_kernel,
               da.deform_attn_sep_kernel, da.deform_attn_sep_bwd_kernel)
    before = [k.launches for k in kernels]
    with mock.patch.object(da, "ms_deform_attn_sep_panels_plain",
                           side_effect=AssertionError("plain")), \
            mock.patch.object(da, "ms_deform_attn_sep_panels_bwd_plain",
                              side_effect=AssertionError("plain")):
        out = da.ms_deform_attn(value, shapes, loc, w)
        out.backward(dout)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 0, 0]
    clean = torch.nan_to_num(loc.detach(), nan=-5.0)
    ref = _sampler_ref(da.ms_deform_attn_plain, value.detach(), dtype, shapes, clean, w.detach())
    assert out.shape == (B, Q, heads * D) and out.dtype == dtype
    torch.testing.assert_close(out.detach().float(), ref, atol=ATOL, rtol=SAMPLER_RTOL[dtype])
    refs = da.ms_deform_attn_bwd_plain(value.detach().float(), shapes, clean, w.detach(),
                                       dout.float())
    _check_sampler_grads("K10", dtype, (value.grad, loc.grad, w.grad), refs)


def test_row_major_sampler_refuses_what_the_kernel_does_not_take(cuda):
    loc = torch.rand((1, 5, 2, 1, 2, 2), device="cuda")
    w = torch.rand((1, 5, 2, 1, 2), device="cuda")
    launches = da.deform_attn_rowmajor_kernel.launches
    # F4: head dims that are no multiple of 8, or over 64, reach the kernel
    # zero-padded and split into groups (`head_groups`), one launch each
    for D in (12, 72):
        value = torch.randn((1, 12, 2, D), device="cuda")
        out = da.ms_deform_attn(value, [(3, 4)], loc, w)
        torch.testing.assert_close(out, da.ms_deform_attn_plain(value, [(3, 4)], loc, w),
                                   atol=ATOL, rtol=0)
    assert da.deform_attn_rowmajor_kernel.launches == launches + 2
    launches += 2
    with pytest.raises(TypeError):
        da.ms_deform_attn(torch.zeros((1, 12, 2, 16), device="cuda", dtype=torch.float16),
                          [(3, 4)], loc, w)
    with pytest.raises(ValueError, match="add up"):
        da.ms_deform_attn(torch.zeros((1, 13, 2, 16), device="cuda"), [(3, 4)], loc, w)
    with pytest.raises(ValueError, match="one device"):
        da.ms_deform_attn(torch.zeros((1, 12, 2, 16), device="cuda"), [(3, 4)], loc, w.cpu())
    assert da.deform_attn_rowmajor_kernel.launches == launches


# Backward kernels against their plain versions in f32 on the same inputs. The
# gradients are sums of many terms of either sign, so the f32 bound scales with
# the result's magnitude: ATOL x max(1, max|plain|); bf16 as above.
def _close_bwd(out, ref, dtype, name, atol_scale=1.0, rtol=None):
    atol = ATOL * atol_scale * max(1.0, ref.abs().max().item())
    rtol = RTOL[dtype] if rtol is None else rtol
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol, msg=lambda m: f"{name}: {m}")


def _close_attention_bwd(dqkv, qkv, dout, heads, scale, name, bias=None):
    """An attention backward kernel's d(qkv) against the plain backward: f32
    within ATOL x max(1, max|plain|); bf16 within `bf16_bwd_error_bound` of the
    plain version that rounds ds and p and of the f32 one on the same values
    (the panel with the bias rounded in once)."""
    panel = qkv if bias is None else qkv + bias.to(qkv.dtype)[:, None]
    ref32 = fa.attention_cm_bwd_plain(panel.float(), dout.float(), heads, scale)
    assert dqkv.shape == qkv.shape and dqkv.dtype == qkv.dtype
    if qkv.dtype == torch.float32:
        _close_bwd(dqkv, ref32, torch.float32, name)
        return
    assert torch.isfinite(dqkv).all()
    for ref in (fa.attention_cm_bwd_plain(qkv, dout, heads, scale, bias=bias).float(), ref32):
        bound = fa.bf16_bwd_error_bound(qkv, dout, heads, scale, ref, bias=bias)
        excess = ((dqkv.float() - ref).abs() - bound).max().item()
        assert excess <= 0, f"{name}: over the bf16 backward bound by {excess}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,N,heads", [(64, 192, 100, 12), (3, 64, 49, 2), (2, 128, 128, 4),
                                         (2, 128, 1, 2), (16, 384, 100, 12), (16, 768, 100, 12),
                                         (3, 256, 33, 8), (3, 512, 33, 8)])  # plain loads
def test_window_attention_bias_bwd_matches_plain(cuda, dtype, B, C, N, heads):
    qkv = _qkv(cuda, B, C, N, dtype)
    bias = 0.1 * torch.randn((3 * C,), generator=cuda, device="cuda")
    dout = torch.randn((B, C, N), generator=cuda, device="cuda").to(dtype)
    before = fa.window_attention_bias_bwd_kernel.launches
    dqkv = fa.window_attention_bias_bwd(qkv, bias, dout, heads, 0.7)
    assert fa.window_attention_bias_bwd_kernel.launches == before + 1
    _close_attention_bwd(dqkv, qkv, dout, heads, 0.7, "K7", bias=bias)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,N,heads,scale", [(4, 192, 1600, 12, 1.0), (52, 256, 300, 8, 32 ** -0.5),
                                               (1, 128, 33, 2, 0.125), (1, 128, 1, 2, 0.125),
                                               (2, 384, 1600, 12, 1.0),  # head_dim 32
                                               (2, 768, 1600, 12, 1.0),  # head_dim 64
                                               (2, 384, 300, 12, 0.125), (2, 768, 300, 12, 0.125),
                                               (1, 256, 33, 8, 0.125), (1, 512, 33, 8, 0.125)])
def test_flash_attention_cm_bwd_matches_plain(cuda, dtype, B, C, N, heads, scale):
    qkv = _qkv(cuda, B, C, N, dtype).requires_grad_()
    dout = torch.randn((B, C, N), generator=cuda, device="cuda").to(dtype)
    before = fa.flash_attention_cm_bwd_kernel.launches
    out = fa.flash_attention_cm(qkv, heads, scale)
    out.backward(dout)
    assert fa.flash_attention_cm_bwd_kernel.launches == before + 1
    _close_attention_bwd(qkv.grad, qkv.detach(), dout, heads, scale, "K6")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,shapes,Q,heads,D,P", SAMPLER_BWD_CASES)
def test_deform_attn_sep_panels_bwd_matches_plain(cuda, dtype, B, shapes, Q, heads, D, P):
    L = len(shapes)
    vals = [v.requires_grad_() for v in _panels(cuda, B, heads, D, shapes, dtype)]
    loc, w = (t.requires_grad_() for t in _sampler_points(cuda, B, Q, heads, L, P))
    dout = torch.randn((B, Q, heads * D), generator=cuda, device="cuda").to(dtype)
    before = da.deform_attn_sep_bwd_kernel.launches
    with mock.patch.object(da, "ms_deform_attn_sep_panels_bwd_plain",
                           side_effect=AssertionError("plain")):
        da.ms_deform_attn_sep_panels(vals, shapes, loc, w).backward(dout)
    assert da.deform_attn_sep_bwd_kernel.launches == before + 1
    clean = torch.nan_to_num(loc.detach(), nan=-5.0)
    _check_sep_bwd(dtype, [v.detach() for v in vals], shapes, clean, w.detach(), dout,
                   ([v.grad for v in vals], loc.grad, w.grad))


def _check_sep_bwd(dtype, vals, shapes, loc, w, dout, grads):
    """K5's gradients against the plain backward: in f32 on f32 values as the
    other backwards; in bf16 on the bf16 values (rounding as the kernel), d(value)
    within one bf16 ulp, d(loc) and d(weights) within `sep_panels_bwd_bf16_bound`."""
    dvals, dloc, dw = grads
    if dtype == torch.float32:
        rvals, rloc, rw = da.ms_deform_attn_sep_panels_bwd_plain(vals, shapes, loc, w, dout)
        for dv, rv in zip(dvals, rvals):
            _check_sampler_grads("K5", dtype, (dv, dloc, dw), (rv, rloc, rw))
        return
    rvals, rloc, rw = da.ms_deform_attn_sep_panels_bwd_plain(vals, shapes, loc, w, dout)
    bloc, bw = da.sep_panels_bwd_bf16_bound(vals, shapes, loc, w, dout)
    for dv, rv in zip(dvals, rvals):
        assert dv.dtype == torch.bfloat16
        scale = 4 * ATOL * max(1.0, rv.float().abs().max().item())
        torch.testing.assert_close(dv.float(), rv.float(), atol=scale, rtol=SAMPLER_RTOL[dtype])
    for name, got, ref, bound in (("d(loc)", dloc, rloc, bloc), ("d(weights)", dw, rw, bw)):
        excess = ((got - ref).abs() - bound - ATOL * max(1.0, ref.abs().max().item())).max()
        assert excess.item() <= 0, f"K5 bf16 {name} over its bound by {excess.item()}"
    assert not dloc[1, 0, 0, 0, 0].any() and not dw[1, 0, 0, 0, 0].any()  # far out


# A location whose pixel coordinate x W - 0.5 (W = 40) is 8.0 when the
# product is rounded before the difference, as PyTorch and the plain versions
# round it, and 7.9999996 when the two are one fused multiply-add. The sampling
# is continuous there, its gradient in loc is not: the floor picks the corners
# of d(loc), which jumps by W w <g, v9 - 2 v8 + v7>.
GRID_LINE_X = float.fromhex("0x1.b33332p-3")


@pytest.mark.parametrize("layout", ["panels", "rowmajor", "cm"])
def test_sampling_coordinates_round_as_the_plain_versions(cuda, layout):
    B, H, D, P, Q, shapes = 2, 2, 16, 1, 5, [(40, 40)]
    vals = _panels(cuda, B, H, D, shapes, torch.float32)
    loc = torch.full((B, Q, H, 1, P, 2), GRID_LINE_X, device="cuda")
    loc[:, 1:, :, :, :, 1] = torch.rand((B, Q - 1, H, 1, P), generator=cuda, device="cuda")
    w = torch.rand((B, Q, H, 1, P), generator=cuda, device="cuda")
    dout = torch.randn((B, Q, H * D), generator=cuda, device="cuda")
    assert float(torch.floor(loc[0, 0, 0, 0, 0, 0] * 40 - 0.5)) == 8.0
    rows = vals[0].reshape(B, H, -1, D)
    if layout == "panels":
        got = da.ms_deform_attn_sep_panels_bwd(vals, shapes, loc, w, dout)
        ref = da.ms_deform_attn_sep_panels_bwd_plain(vals, shapes, loc, w, dout)
    elif layout == "rowmajor":
        value = rows.transpose(1, 2).contiguous()
        got = da.ms_deform_attn_bwd(value, shapes, loc, w, dout)
        ref = da.ms_deform_attn_bwd_plain(value, shapes, loc, w, dout)
    else:
        value_t = rows.transpose(2, 3).reshape(B, H * D, -1).contiguous()
        dout_t = dout.transpose(1, 2).contiguous()
        got = da.ms_deform_attn_cm_bwd(value_t, shapes, loc, w, dout_t, H)
        ref = da.ms_deform_attn_cm_bwd_plain(value_t, shapes, loc, w, dout_t, H)
    _close_bwd(got[1], ref[1], torch.float32, f"{layout} d(loc) on a grid line")
    _close_bwd(got[2], ref[2], torch.float32, f"{layout} d(weights) on a grid line")


def test_backward_dispatch_counts_launches(cuda):
    kernels = (da.deform_attn_sep_bwd_kernel, fa.flash_attention_cm_bwd_kernel,
               fa.window_attention_bias_bwd_kernel)
    before = [k.launches for k in kernels]
    qkv = _qkv(cuda, 2, 64, 100, torch.float32).requires_grad_()
    long_qkv = _qkv(cuda, 2, 64, 200, torch.float32).requires_grad_()
    bias = torch.zeros(192, device="cuda", requires_grad=True)
    (fa.attention_cm(qkv, 4, bias=bias).sum() + fa.attention_cm(long_qkv, 4).sum()).backward()
    assert bias.grad.shape == (192,)
    panel = torch.zeros((1, 2, 3, 4 * 16), device="cuda", requires_grad=True)
    da.ms_deform_attn_sep_panels([panel], [(3, 4)], torch.rand((1, 5, 2, 1, 2, 2), device="cuda"),
                                 torch.rand((1, 5, 2, 1, 2), device="cuda")).sum().backward()
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
    with torch.no_grad():  # no gradient wanted: K2 writes no log-sum-exp
        fa.attention_cm(long_qkv, 4)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]


def test_sep_panels_refuses_what_the_kernel_does_not_take(cuda):
    loc = torch.rand((1, 5, 2, 1, 2, 2), device="cuda")
    w = torch.rand((1, 5, 2, 1, 2), device="cuda")
    launches = da.deform_attn_sep_kernel.launches
    # F4: no multiple of 8, over 64: zero-padded and split into groups, one launch each
    for D in (12, 72):
        panel = torch.randn((1, 2, 3, 4 * D), device="cuda")
        out = da.ms_deform_attn_sep_panels([panel], [(3, 4)], loc, w)
        torch.testing.assert_close(out, da.ms_deform_attn_sep_panels_plain([panel], [(3, 4)],
                                                                           loc, w),
                                   atol=ATOL, rtol=0)
    assert da.deform_attn_sep_kernel.launches == launches + 2
    launches += 2
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


def test_one_train_step_through_the_kernels_matches_the_plain_backwards(cuda):
    """A reduced model's train step (forward, matching, losses, backward) on the
    card, in each cross-attention branch: the gradients through the backward
    kernels against the same forward with each backward swapped for its plain
    version, per parameter tensor."""
    from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
    from lwdetr_tpu_torch.models.criterion import SetCriterion, Targets
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.weights import init_state_dict

    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(encoder="vit_tiny", vit_encoder_num_layers=3, window_block_indexes=(0, 2),
                      out_feature_indexes=(1, 2), projector_scale=("P4",), hidden_dim=64,
                      dim_feedforward=128, sa_nheads=4, ca_nheads=4, dec_n_points=2,
                      dec_layers=2, group_detr=3, num_queries=16, num_classes=7, two_stage=True,
                      bbox_reparam=True, lite_refpoint_refine=True)
    tcfg = TrainConfig(ia_bce_loss=True, cls_loss_coef=1.0, max_gt=8)
    model = build_model(cfg, state_dict=init_state_dict(cfg, 0), train=True)
    criterion = SetCriterion(cfg, tcfg)
    images = torch.randn((2, 256, 256, 3), generator=cuda, device="cuda")
    targets = Targets(torch.randint(0, 7, (2, 8), generator=cuda, device="cuda"),
                      torch.rand((2, 8, 4), generator=cuda, device="cuda") * 0.4 + 0.2,
                      (torch.arange(8, device="cuda") < 3).expand(2, -1).contiguous())
    kernels = {k.name: k for k in (
        fa.window_attention_bias_kernel, fa.flash_attention_cm_kernel, da.deform_attn_cm_kernel,
        da.deform_attn_sep_kernel, da.deform_attn_sep_bwd_kernel,
        fa.flash_attention_cm_bwd_kernel, fa.window_attention_bias_bwd_kernel,
        da.deform_attn_cm_bwd_kernel, fa.window_attention_kernel, fa.window_attention_bwd_kernel,
        da.deform_attn_rowmajor_kernel, da.deform_attn_rowmajor_bwd_kernel)}

    def grads():
        model.zero_grad(set_to_none=True)
        total, _ = criterion(model(images), targets, train=True)
        total.backward()
        return total.item(), {n: p.grad.clone() for n, p in model.named_parameters()}

    # 2 window blocks (K1 / K7), 1 global block of 256 tokens (K2 / K6), 2 decoder
    # layers: self-attention over 16 queries a group without a bias (K9 / K7nb)
    # and the sampler of the branch
    common = {"K1": 2, "K2": 1, "K6": 1, "K7": 2, "K9": 2, "K7nb": 2}
    samplers = {None: {"K4": 2, "K5": 2}, "sep": {"K4": 2, "K5": 2}, "cm": {"K3": 2, "K8": 2},
                "gather": {"K10": 2, "K10b": 2}}
    losses = {}
    for branch, expected in samplers.items():
        tr.set_force_branch(model, branch)
        before = {n: k.launches for n, k in kernels.items()}
        loss_k, grads_k = grads()
        assert {n: k.launches - before[n] for n, k in kernels.items()} == \
            {n: {**common, **expected}.get(n, 0) for n in kernels}, branch
        with mock.patch.object(fa, "window_attention_bias_bwd",
                               lambda qkv, bias, dout, heads, scale:
                               fa.attention_cm_bwd_plain(qkv, dout, heads, scale, bias=bias)), \
                mock.patch.object(fa, "flash_attention_cm_bwd",
                                  lambda qkv, lse, dout, heads, scale:
                                  fa.attention_cm_bwd_plain(qkv, dout, heads, scale)), \
                mock.patch.object(da, "ms_deform_attn_sep_panels_bwd",
                                  da.ms_deform_attn_sep_panels_bwd_plain), \
                mock.patch.object(da, "ms_deform_attn_cm_bwd",
                                  da.ms_deform_attn_cm_bwd_plain), \
                mock.patch.object(da, "ms_deform_attn_bwd", da.ms_deform_attn_bwd_plain):
            loss_p, grads_p = grads()
        assert loss_p == pytest.approx(loss_k, rel=1e-6)
        top = max(g.abs().max().item() for g in grads_p.values())
        for name, g in grads_p.items():
            err = (grads_k[name] - g).abs().max().item()
            assert err <= 1e-3 * max(g.abs().max().item(), 1e-5 * top), (branch, name)
        losses[branch] = loss_k
    # the three layouts compute one function
    assert max(losses.values()) - min(losses.values()) <= 1e-4


@pytest.mark.parametrize("preset,remat", [("large", False), ("xlarge", True)])
def test_large_bf16_train_step_launches_each_kernel_as_expected(cuda, preset, remat):
    """One bf16 train step of the release recipe at 640x640, batch 2 (drop_path
    0.1 at its step-0 rate): the forward launches K1 6, K2 7 (4 global blocks +
    3 decoder self-attentions), K4 3 (the panels, as in every train step);
    with remat every ViT block runs its forward twice (K1 12, K2 4 x 2 + 3);
    the backward K7 6, K6 7, K5 3; the loss is finite."""
    from lwdetr_tpu_torch import bench_train

    kernels = {"K1": fa.window_attention_bias_kernel, "K2": fa.flash_attention_cm_kernel,
               "K4": da.deform_attn_sep_kernel, "K5": da.deform_attn_sep_bwd_kernel,
               "K6": fa.flash_attention_cm_bwd_kernel, "K7": fa.window_attention_bias_bwd_kernel}
    state, step = bench_train.make_train_step(preset, 2, dtype=torch.bfloat16,
                                              grad_checkpointing=remat)
    assert state.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    before = {k: v.launches for k, v in kernels.items()}
    metrics = step()
    assert torch.isfinite(metrics["loss"]).item()
    got = {k: v.launches - before[k] for k, v in kernels.items()}
    assert got == {"K1": 12 if remat else 6, "K2": 11 if remat else 7, "K4": 3, "K5": 3,
                   "K6": 7, "K7": 6}, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decoder_dropout_takes_the_self_attention_off_the_kernels(cuda, dtype):
    """A dropout rate above 0 in train mode drops the decoder's attention
    weights on the einsum form, as the JAX module does: the decoder's
    self-attention launches no kernel (its K9 / K7nb go), everything else runs
    as without dropout; the drawn masks have the JAX sites' shapes."""
    from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
    from lwdetr_tpu_torch.models import drop
    from lwdetr_tpu_torch.models.criterion import SetCriterion, Targets
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = ModelConfig(encoder="vit_tiny", vit_encoder_num_layers=3, window_block_indexes=(0, 2),
                      out_feature_indexes=(1, 2), projector_scale=("P4",), hidden_dim=64,
                      dim_feedforward=128, sa_nheads=4, ca_nheads=4, dec_n_points=2,
                      dec_layers=2, group_detr=3, num_queries=16, num_classes=7, two_stage=True,
                      bbox_reparam=True, lite_refpoint_refine=True, drop_path=0.1, dropout=0.1)
    model = build_model(cfg, state_dict=init_state_dict(cfg, 0), train=True, dtype=dtype)
    criterion = SetCriterion(cfg, TrainConfig(ia_bce_loss=True, cls_loss_coef=1.0, max_gt=8))
    images = torch.randn((2, 256, 256, 3), generator=cuda, device="cuda")
    targets = Targets(torch.randint(0, 7, (2, 8), generator=cuda, device="cuda"),
                      torch.rand((2, 8, 4), generator=cuda, device="cuda") * 0.4 + 0.2,
                      (torch.arange(8, device="cuda") < 3).expand(2, -1).contiguous())
    kernels = (fa.window_attention_bias_kernel, fa.flash_attention_cm_kernel,
               fa.window_attention_kernel, fa.window_attention_bwd_kernel,
               da.deform_attn_sep_kernel, da.deform_attn_sep_bwd_kernel)
    shapes = []

    def draws(rate):
        gen = drop.Bernoulli(drop.step_generator("cuda", 0, 0))

        def source(keep, shape, like):
            shapes.append(tuple(shape))
            return gen(keep, shape, like)

        before = [k.launches for k in kernels]
        total, _ = criterion(model(images, None, [0.0, 0.05, 0.1], rate, source), targets,
                             train=True)
        total.backward()
        assert torch.isfinite(total).item()
        return {k.name: k.launches - b for k, b in zip(kernels, before)}

    plain = draws(0.0)
    assert shapes == [(32, 1, 1)] * 4  # blocks 1 and 2, two sites each; dropout 0 draws nothing
    shapes.clear()
    dropped = draws(0.1)
    assert plain == {"K1": 2, "K2": 1, "K9": 2, "K7nb": 2, "K4": 2, "K5": 2}
    assert dropped == dict(plain, K9=0, K7nb=0)
    layer = [(6, 4, 16, 16), (2, 48, 64), (2, 48, 64), (2, 48, 128), (2, 48, 64)]
    assert shapes == [(32, 1, 1)] * 4 + layer * 2


# -- M1, the assignment, and attention at zero-padded head dims (F4) -----------------------------


def _m1_inputs(g, S, B, G, Qg, T, counts, kind):
    from lwdetr_tpu_torch.models import matcher as tm

    valid = torch.arange(T, device="cuda")[None, :] < torch.tensor(counts, device="cuda")[:, None]
    if kind == "int":
        return torch.randint(0, 3, (S, B, T, G * Qg), generator=g, device="cuda").float(), valid
    logits = torch.randn((S, B, G * Qg, 91), generator=g, device="cuda")
    boxes = torch.rand((S, B, G * Qg, 4), generator=g, device="cuda") * 0.4 + 0.2
    labels = torch.randint(0, 91, (B, T), generator=g, device="cuda")
    tboxes = torch.rand((B, T, 4), generator=g, device="cuda") * 0.4 + 0.2
    cost = tm.match_cost_matrix(logits, boxes, labels, tboxes, valid)
    if kind == "nan":
        cost[:, 0, 1] = float("nan")
        cost[:, -1, T - 1] = float("nan")
    return cost.contiguous(), valid


@pytest.mark.parametrize("S,B,G,Qg,T,counts,kind", [
    (4, 4, 13, 300, 100, (7, 7, 7, 7), "match"),     # small's train step
    (4, 2, 13, 300, 100, (7, 7), "match"),           # large's
    (4, 4, 13, 300, 100, (100, 100, 100, 100), "match"),  # every target row valid
    (2, 4, 3, 300, 100, (7, 30, 0, 100), "int"),     # ties everywhere
    (1, 3, 2, 20, 7, (7, 6, 3), "match"),
    (2, 2, 3, 20, 10, (6, 4), "nan"),
    (1, 2, 1, 4, 6, (3, 4), "match"),                # more target slots than queries
], ids=["small", "large", "all_valid", "ties", "sweep_7x20", "nan_rows", "t_above_q"])
def test_assignment_kernel_gives_the_plain_versions_columns(cuda, S, B, G, Qg, T, counts, kind):
    from lwdetr_tpu_torch.models import matcher as tm

    cost, valid = _m1_inputs(cuda, S, B, G, Qg, T, counts, kind)
    before = tm.assignment_kernel.launches
    out = tm.assign(cost, valid, G)
    torch.cuda.synchronize()
    assert tm.assignment_kernel.launches == before + 1
    assert out.shape == (S, B, G, T) and out.dtype == torch.int64
    assert torch.equal(out, tm.assign_plain(cost, valid, G))
    assert tm.kernel_attributes()["local_bytes"] == 0


def test_hungarian_match_launches_m1_once_without_waiting_for_the_device(cuda):
    from lwdetr_tpu_torch.models import matcher as tm

    S, B, G, Qg, T, K = 4, 2, 13, 300, 100, 91
    logits = torch.randn((S, B, G * Qg, K), generator=cuda, device="cuda")
    boxes = torch.rand((S, B, G * Qg, 4), generator=cuda, device="cuda") * 0.4 + 0.2
    labels = torch.randint(0, K, (B, T), generator=cuda, device="cuda")
    tboxes = torch.rand((B, T, 4), generator=cuda, device="cuda") * 0.4 + 0.2
    valid = (torch.arange(T, device="cuda") < 7).expand(B, T).contiguous()
    before = tm.assignment_kernel.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        matched = tm.hungarian_match(logits, boxes, labels, tboxes, valid, group_detr=G)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tm.assignment_kernel.launches == before + 1
    cost = tm.match_cost_matrix(logits, boxes, labels, tboxes, valid)
    assert torch.equal(matched, tm.assign_plain(cost, valid, G))


def test_assignment_kernel_refuses_more_than_1023_queries_a_group(cuda):
    from lwdetr_tpu_torch.models import matcher as tm

    with pytest.raises(ValueError, match="1023"):
        tm.assign(torch.zeros((1, 1, 2, 1024), device="cuda"),
                  torch.ones((1, 2), dtype=torch.bool, device="cuda"), 1)


def test_staged_rows_fit_the_shared_memory_budget(cuda):
    from lwdetr_tpu_torch.models import matcher as tm

    for T, Q in [(1, 5), (4, 4), (7, 20), (30, 100), (100, 300), (300, 300), (1, 1023)]:
        layout = tm.shared_layout(T, Q)
        assert 0 <= layout["staged_rows"] <= T
        assert layout["shared_bytes"] <= layout["budget_bytes"]
    assert tm.shared_layout(7, 300)["staged_rows"] == 7
    rows = tm.shared_layout(100, 300)["staged_rows"]
    assert rows < 100 <= rows + 30


@pytest.mark.parametrize("D", [8, 24, 48, 150, 300, 2100])
@pytest.mark.parametrize("N,with_bias,kernel", [(100, True, "K1"), (100, False, "K9"),
                                                (300, False, "K2")])
def test_attention_at_padded_head_dims_matches_the_plain_version(cuda, D, N, with_bias, kernel):
    """F4: head_dim 8, 24, 48 reach K1 / K9 / K2 (and K7 / K7nb / K6)
    zero-padded to 16, 32, 64, and 150, 300, 2100 reach K9 / K2 (K7nb / K6)
    zero-padded to the wide case's 192, 320, 2112, forward and d(qkv) within
    ATOL (x max(1, max |plain|)) of the plain version; d(bias) sums B x N such
    terms, so within B x N times that. K1 with its qkv bias refuses a head
    above 64, naming the ViT's 12 heads."""
    kern = {"K1": fa.window_attention_bias_kernel, "K9": fa.window_attention_kernel,
            "K2": fa.flash_attention_cm_kernel}[kernel]
    bwd = {"K1": fa.window_attention_bias_bwd_kernel, "K9": fa.window_attention_bwd_kernel,
           "K2": fa.flash_attention_cm_bwd_kernel}[kernel]
    heads, B = (4, 2) if D <= 64 else (1, 2)
    qkv = _qkv(cuda, B, heads * D, N, torch.float32).requires_grad_()
    bias = (0.1 * torch.randn(3 * heads * D, generator=cuda, device="cuda")).requires_grad_() \
        if with_bias else None
    dout = torch.randn((B, heads * D, N), generator=cuda, device="cuda")
    if with_bias and D > 64:
        with pytest.raises(ValueError, match="12 heads"):
            fa.attention_cm(qkv, heads, bias=bias)
        return
    n0, b0 = kern.launches, bwd.launches
    out = fa.attention_cm(qkv, heads, bias=bias)
    grads = torch.autograd.grad(out, [qkv] + ([bias] if with_bias else []), dout)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1 and bwd.launches == b0 + 1
    q2 = qkv.detach().clone().requires_grad_()
    b2 = None if bias is None else bias.detach().clone().requires_grad_()
    ref = fa.attention_cm_plain(q2 if b2 is None else q2 + b2[:, None], heads, D ** -0.5)
    ref_grads = torch.autograd.grad(ref, [q2] + ([b2] if with_bias else []), dout)
    assert (out - ref).abs().max().item() <= ATOL
    scale = max(1.0, ref_grads[0].abs().max().item())
    assert (grads[0] - ref_grads[0]).abs().max().item() <= ATOL * scale
    if with_bias:
        assert (grads[1] - ref_grads[1]).abs().max().item() <= ATOL * scale * B * N


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [80, 128, 150, 192, 256, 300, 320, 384, 512, 1024, 2048, 2100,
                               2112])
@pytest.mark.parametrize("N,kernel", [(300, "K2"), (100, "K9")])
def test_wide_head_dims_match_the_plain_version(cuda, dtype, D, N, kernel):
    """F4 / F7: the decoder's head dims above 64 reach the wide case of K2 /
    K9 and of their backwards K6 / K7nb (`csrc/attention_wide.cuh`: every
    multiple of 64 from 128 up, 2112 wider than the widest head it once took),
    the others zero-padded to the next multiple of 64 (80 to 128, 150 to 192,
    300 to 320, 2100 to 2112): forward and d(qkv) against the plain version on
    the unpadded inputs, in f32 within ATOL (x max(1, max |plain|)) and in
    bf16 within `bf16_error_bound` / `bf16_bwd_error_bound` at the kernel's
    head dim (for a padded head: of the padded inputs, checked at the padded
    head dim); no case spills."""
    _check_wide_case(cuda, dtype, 3, 2 if D < 256 else 1, D, N, kernel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,heads,D,N,kernel", [
    (52, 2, 128, 300, "K2"),   # bf16: FlashAttention-2's shape (64-row blocks fill the card)
    (52, 2, 128, 301, "K2"),   # the same at an odd N
    (3, 2, 192, 301, "K2"),    # odd N: bf16 rows staged by plain loads, f32 by 4-byte copies
    (3, 1, 2112, 99, "K9"),    # odd N in clusters of blocks
    (1, 1, 128, 3201, "K2"),   # rows too long for the resident kernels: the streaming ones
])
def test_wide_case_at_full_batches_and_odd_token_counts(cuda, dtype, B, heads, D, N, kernel):
    """The wide case's other kernels: FlashAttention-2's shape at a batch that
    fills the card, odd token counts in each kernel family, and the streaming
    kernels over 3201 tokens, forward and backward, held to the plain version
    as in test_wide_head_dims_match_the_plain_version."""
    _check_wide_case(cuda, dtype, B, heads, D, N, kernel)


def _check_wide_case(cuda, dtype, B, heads, D, N, kernel):
    kern = {"K2": fa.flash_attention_cm_kernel, "K9": fa.window_attention_kernel}[kernel]
    bwd = {"K2": fa.flash_attention_cm_bwd_kernel, "K9": fa.window_attention_bwd_kernel}[kernel]
    qkv = _qkv(cuda, B, heads * D, N, dtype).requires_grad_()
    dout = torch.randn((B, heads * D, N), generator=cuda, device="cuda").to(dtype)
    scale = D ** -0.5
    n0, b0 = kern.launches, bwd.launches
    out = fa.attention_cm(qkv, heads, scale)
    (dqkv,) = torch.autograd.grad(out, [qkv], dout)
    torch.cuda.synchronize()
    assert (kern.launches - n0, bwd.launches - b0) == (1, 1)
    x = qkv.detach()
    Dp = fa.padded_head_dim(D)
    xp = fa._pad_heads(x, heads, D, Dp)
    for k in (kern, bwd):
        assert fa.kernel_attributes(k, xp, heads)["spill_bytes"] == 0, k.name
    if dtype == torch.float32:
        ref = fa.attention_cm_plain(x, heads, scale)
        dref = fa.attention_cm_bwd_plain(x, dout, heads, scale)
        assert (out - ref).abs().max().item() <= ATOL
        assert (dqkv - dref).abs().max().item() <= ATOL * max(1.0, dref.abs().max().item())
        return

    def padded(t):  # (B, heads * D, N) -> each head's channels zero-padded to Dp
        return torch.nn.functional.pad(t.reshape(B, heads, D, N), (0, 0, 0, Dp - D)).reshape(
            B, heads * Dp, N)

    gp = padded(dout)
    ref = fa.attention_cm_plain(xp, heads, scale).float()
    dref = fa.attention_cm_bwd_plain(xp, gp, heads, scale).float()
    bound = fa.bf16_error_bound(xp, heads, scale, ref)
    dbound = fa.bf16_bwd_error_bound(xp, gp, heads, scale, dref)
    assert ((padded(out.detach()).float() - ref).abs() - bound).max().item() <= 0
    dqkvp = fa._pad_heads(dqkv, heads, D, Dp).float()
    assert ((dqkvp - dref).abs() - dbound).max().item() <= 0


def _padded_batch(g, B, side, valid_hw):
    mask = torch.ones((B, side, side), dtype=torch.bool, device="cuda")
    for i, (h, w) in enumerate(valid_hw):
        mask[i, :h, :w] = False
    images = torch.randn((B, side, side, 3), generator=g, device="cuda") * ~mask[..., None]
    return images, mask


@pytest.mark.parametrize("branch", [None, "cm", "sep", "gather"])
def test_padded_forward_through_the_kernels_matches_the_plain_versions(cuda, branch):
    """F6: a padded batch (two images of 256 x 384 and 384 x 256 padded to
    384 x 384) through a reduced model in each cross-attention branch,
    against the same model on the plain versions with the same picks."""
    from lwdetr_tpu_torch.config import ModelConfig
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = ModelConfig(encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
                      out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64,
                      dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2,
                      dec_layers=2, group_detr=2, num_queries=12, num_classes=7,
                      two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
    model = tr.set_force_branch(build_model(cfg, device="cuda",
                                            state_dict=init_state_dict(cfg, seed=0)), branch)
    images, mask = _padded_batch(cuda, 2, 384, ((256, 384), (384, 256)))
    picks, select = [], tr.select_proposals

    def record(scores, k):
        picks.append(select(scores, k))
        return picks[-1]

    with torch.no_grad(), mock.patch.object(tr, "select_proposals", record):
        out = model(images, mask)
    plain_attention = lambda qkv, heads, scale=None, bias=None: fa.attention_cm_plain(  # noqa
        qkv if bias is None else qkv + bias[:, None], heads, scale)
    with torch.no_grad(), mock.patch.object(tr, "select_proposals", lambda s, k: picks[0]), \
            mock.patch.object(fa, "attention_cm", plain_attention), \
            mock.patch.object(da, "ms_deform_attn_cm", da.ms_deform_attn_cm_plain), \
            mock.patch.object(da, "ms_deform_attn_sep_panels",
                              da.ms_deform_attn_sep_panels_plain), \
            mock.patch.object(da, "ms_deform_attn", da.ms_deform_attn_plain):
        ref = model(images, mask)
    assert (out["pred_logits"] - ref["pred_logits"]).abs().max().item() <= 1e-4
    assert (out["pred_boxes"] - ref["pred_boxes"]).abs().max().item() <= 1e-5


def test_padded_train_step_enqueues_without_a_host_sync(cuda):
    """F6: a padded train step of a reduced model (valid ratios, masks,
    proposals and M1 on the card) runs under `set_sync_debug_mode("error")`."""
    from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
    from lwdetr_tpu_torch.models.criterion import SetCriterion
    from lwdetr_tpu_torch.train import engine
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = ModelConfig(encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
                      out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64,
                      dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2,
                      dec_layers=2, group_detr=2, num_queries=12, num_classes=7,
                      two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
    tcfg = TrainConfig(ia_bce_loss=True, max_gt=6)
    state = engine.create_train_state(cfg, tcfg, niter_per_ep=10, device="cuda",
                                      state_dict=init_state_dict(cfg, seed=0))
    step = engine.build_train_step(state, SetCriterion(cfg, tcfg), tcfg,
                                   static_zero_drop_path=True, static_zero_dropout=True)
    images, mask = _padded_batch(cuda, 2, 384, ((256, 384), (384, 256)))
    batch = {"images": images, "pad_mask": mask,
             "labels": torch.randint(0, 7, (2, 6), generator=cuda, device="cuda"),
             "boxes": torch.rand((2, 6, 4), generator=cuda, device="cuda") * 0.3 + 0.2,
             "valid": torch.arange(6, device="cuda")[None].expand(2, 6) < 4}
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(metrics["loss"]).item()



def _micro_chain_setup(cuda_batch):
    """A `bench_train.make_train_setup`-shaped namespace for the reduced model
    at 128 x 128, batch 2, drop_path 0.1 and dropout 0.1, 2 steps an epoch with
    lr_drop 1 (the lr drops before the third step)."""
    from types import SimpleNamespace

    from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
    from lwdetr_tpu_torch.models.criterion import SetCriterion
    from lwdetr_tpu_torch.train import engine
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = ModelConfig(encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
                      out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64,
                      dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2,
                      dec_layers=2, group_detr=2, num_queries=12, num_classes=7,
                      two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
    tcfg = TrainConfig(ia_bce_loss=True, use_ema=True, max_gt=6, lr_drop=1)

    def setup():
        state = engine.create_train_state(cfg, tcfg, niter_per_ep=2, device="cuda",
                                          state_dict=init_state_dict(cfg, seed=0))
        return SimpleNamespace(state=state, criterion=SetCriterion(cfg, tcfg), tcfg=tcfg,
                               data=cuda_batch, scheds=[[0.1], [0.1]], seed=0, niter_per_ep=2,
                               static=dict(static_zero_drop_path=False,
                                           static_zero_dropout=False))

    return setup


def test_micro_train_chain_matches_eager_steps(cuda):
    """The reduced model's train step captured as a CUDA graph
    (`build_train_chain`) against eager steps: `chip_smoke.chain_check`'s
    checks (the first loss bit-equal, later ones within 1e-3, lrs across the
    drop, masks equal and new each replay, the state within 1e-3, the
    kernels' launches a replay equal to an eager step's)."""
    import chip_smoke

    batch = {"images": torch.randn((2, 128, 128, 3), generator=cuda, device="cuda"),
             "labels": torch.randint(0, 7, (2, 6), generator=cuda, device="cuda"),
             "boxes": torch.rand((2, 6, 4), generator=cuda, device="cuda") * 0.3 + 0.2,
             "valid": torch.arange(6, device="cuda")[None].expand(2, 6) < 4}
    kernels = list(chip_smoke.port_kernels().values())
    launches, res = chip_smoke.chain_check(torch, kernels, "", "micro", _micro_chain_setup(batch))
    assert res["masks_per_step"] > 0
    assert launches["K1"] == 3 * res["launches_per_replay_profiled"]["K1 window_attention_bias"]


def test_batch1_eval_graph_is_bit_equal_and_refuses_a_changed_weight(cuda):
    """The reduced model's bf16 forward + `post_process` as a guarded graph
    (`bench_all.batch1_graph`): its detections equal the eager call's bit for
    bit; after a weight is written in place the replay refuses (the cached
    bf16 cast would be stale)."""
    from lwdetr_tpu_torch import bench_all
    from lwdetr_tpu_torch.config import ModelConfig
    from lwdetr_tpu_torch.models.lwdetr import build_model, post_process
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = ModelConfig(encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
                      out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64,
                      dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2,
                      dec_layers=2, group_detr=2, num_queries=12, num_select=10, num_classes=7,
                      two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
    model = build_model(cfg, "cuda", torch.bfloat16, state_dict=init_state_dict(cfg, seed=0))
    image = torch.randn((1, 128, 128, 3), generator=cuda, device="cuda").to(torch.bfloat16)

    def forward(x):
        out = model(x)
        return post_process(out["pred_logits"], out["pred_boxes"],
                            torch.full((1, 2), 128.0, device="cuda"), 10)

    with torch.no_grad():
        ref = [t.clone() for t in forward(image)]
    graph = bench_all.batch1_graph(model, forward, image)
    for _ in range(2):
        got = graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with torch.no_grad():
        model.class_embed.weight.mul_(1.0)
    with pytest.raises(RuntimeError, match="capture it again"):
        graph.replay()
