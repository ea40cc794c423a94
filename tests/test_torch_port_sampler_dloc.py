"""d(loc) of the sampler backwards from differenced corner values.

d(loc_x) = W_l w <g, (1-fy)(v01 - v00) + fy (v11 - v10)> (d(loc_y) alike).
Taken as a difference of two dot products, <g, v01> - <g, v00>, it cancels
where neighbouring values are close, and keeps the f32 rounding of each dot
product, of order eps |<g, v00>|, against a result of order |<g, v01 - v00>|.
The plain backward (and K5, K8, K10's backward on the card) differences the
corners first, which is exact for close values (Sterbenz), and takes one dot
product. On a smooth map, 1 + 1e-3 noise, the f32 result must lie much closer
to the f64 one than the old formula's.
"""
import numpy as np
import pytest
import torch

from lwdetr_tpu_torch.ops import deform_attn as tda

SHAPES = [(40, 40)]
B, Q, H, D, P = 2, 200, 4, 16, 2
# max |f32 - f64| of d(loc), old formula over new, measured on this input for
# seeds 0-3: 75.5, 48.1, 67.4, 62.2 (the new one's error, 1.2e-6 to 1.8e-6 of
# max |d(loc)| 0.7-0.8, comes from px = x W - 0.5 rounded in f32)
MIN_GAIN = 40.0


def _smooth_inputs(seed):
    rng = np.random.default_rng(seed)
    vals = [(1.0 + 1e-3 * rng.standard_normal((B, H, h, w * D))).astype(np.float32)
            for h, w in SHAPES]
    loc = rng.uniform(0.02, 0.98, (B, Q, H, len(SHAPES), P, 2)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (B, Q, H, len(SHAPES), P)).astype(np.float32)
    dout = rng.standard_normal((B, Q, H * D)).astype(np.float32)
    return [torch.from_numpy(v) for v in vals], *(torch.from_numpy(x) for x in (loc, w, dout))


def _old_dloc(vals, loc, w, dout):
    """d(loc) as the difference of four corner dot products (the formula before
    the repair, and the JAX package's VJP of `_prep_separable`), in f32."""
    g = dout.reshape(B, Q, H, D).permute(0, 2, 1, 3)
    dloc = torch.zeros_like(loc)
    for lvl, ((Hl, Wl), panel) in enumerate(zip(SHAPES, vals)):
        v_l = panel.reshape(B, H, Hl * Wl, D)
        px = loc[:, :, :, lvl, :, 0] * Wl - 0.5
        py = loc[:, :, :, lvl, :, 1] * Hl - 0.5
        x0, y0 = torch.floor(px), torch.floor(py)
        fx, fy = px - x0, py - y0
        x0, y0 = x0.long(), y0.long()
        dots = {}
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)
            idx = yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)
            idx = idx.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1).expand(-1, -1, -1, D)
            corner = torch.gather(v_l, 2, idx).reshape(B, H, Q, P, D)
            dots[dy, dx] = torch.einsum("bhqd,bhqpd->bhqp", g, corner).permute(0, 2, 1, 3) * valid
        d00, d01, d10, d11 = dots[0, 0], dots[0, 1], dots[1, 0], dots[1, 1]
        aw = w[:, :, :, lvl]
        dloc[:, :, :, lvl, :, 0] = Wl * aw * ((1 - fy) * (d01 - d00) + fy * (d11 - d10))
        dloc[:, :, :, lvl, :, 1] = Hl * aw * ((1 - fx) * (d10 - d00) + fx * (d11 - d01))
    return dloc


def _plain_dloc(layout, vals, loc, w, dout):
    """d(loc) of one layout's plain backward (each regroups the same values)."""
    if layout == "panels":
        return tda.ms_deform_attn_sep_panels_bwd_plain(vals, SHAPES, loc, w, dout)[1]
    rows = torch.cat([v.reshape(B, H, -1, D) for v in vals], dim=2)  # (B, H, Len_in, D)
    if layout == "rowmajor":
        return tda.ms_deform_attn_bwd_plain(rows.transpose(1, 2).contiguous(), SHAPES, loc, w,
                                            dout)[1]
    value_t = rows.transpose(2, 3).reshape(B, H * D, -1).contiguous()
    return tda.ms_deform_attn_cm_bwd_plain(value_t, SHAPES, loc, w,
                                           dout.transpose(1, 2).contiguous(), H)[1]


@pytest.mark.parametrize("layout", ["panels", "rowmajor", "cm"])
def test_differenced_corners_bring_f32_dloc_closer_to_f64(layout):
    vals, loc, w, dout = _smooth_inputs(0)
    ref = _plain_dloc(layout, [v.double() for v in vals], loc.double(), w.double(),
                      dout.double())
    new = _plain_dloc(layout, vals, loc, w, dout)
    old = _old_dloc(vals, loc, w, dout)
    assert new.dtype == old.dtype == torch.float32
    err_new = (new.double() - ref).abs().max().item()
    err_old = (old.double() - ref).abs().max().item()
    assert err_old >= MIN_GAIN * err_new, (err_old, err_new)
    # the f32 result itself: within a few f32 roundings of px, relative to its size
    assert err_new <= 1e-5 * ref.abs().max().item()


def test_old_formula_copy_matches_the_plain_backward_in_f64():
    """The test's copy of the old formula is that formula: in f64 it agrees
    with the plain backward (the two differ in rounding only)."""
    vals, loc, w, dout = _smooth_inputs(1)
    vals, loc, w, dout = [v.double() for v in vals], loc.double(), w.double(), dout.double()
    ref = tda.ms_deform_attn_sep_panels_bwd_plain(vals, SHAPES, loc, w, dout)[1]
    torch.testing.assert_close(_old_dloc(vals, loc, w, dout), ref, atol=1e-11, rtol=0)
