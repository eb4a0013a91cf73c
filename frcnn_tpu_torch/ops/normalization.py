"""Masked input normalization, batched over images.

Port of the JAX package's ``ops/normalization.py``: per-channel centering
and unbiased-std scaling over the true image region, then spatial
contrastive normalization of the luminance channel with a separable
Gaussian (``nn.SpatialContrastiveNormalization(1, image.gaussian1D(7))``)
whose border correction is the same smoothing applied to the validity
mask. :func:`normalize_s2d` computes the same thing directly on the
space-to-depth planes the serving path feeds the block0 kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DIV_THRESHOLD = 1e-4  # nn.SpatialDivisiveNormalization default threshold


def gaussian1d(width: int) -> np.ndarray:
    """``image.gaussian1D(width)`` (amplitude 1, sigma 0.25, not
    renormalized)."""
    i = np.arange(width, dtype=np.float64)
    x = i / (width - 1) - 0.5
    return np.exp(-(x ** 2) / (2 * 0.25 ** 2)).astype(np.float32)


def _smooth(x, k):
    """Separable zero-padded 'same' smoothing of [..., H, W]."""
    w = len(k)
    lo, hi = w // 2, (w - 1) // 2
    H, W = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (0, 0, lo, hi))
    x = sum(float(k[i]) * xp[..., i:i + H, :] for i in range(w))
    xp = F.pad(x, (lo, hi))
    return sum(float(k[i]) * xp[..., :, i:i + W] for i in range(w))


def contrastive_normalize(y, valid_mask, width: int = 7):
    """Contrastive normalization of one channel ``y`` [..., H, W] over the
    0/1 ``valid_mask``; the padded region comes out zero."""
    k = gaussian1d(width)
    ym = y * valid_mask
    safe_coef = torch.clamp(_smooth(valid_mask, k), min=1e-12)
    mean = _smooth(ym, k) / safe_coef
    sub = (y - mean) * valid_mask
    var = _smooth(sub * sub, k) / safe_coef
    std = torch.sqrt(torch.clamp(var, min=0.0))
    std = torch.where(std <= DIV_THRESHOLD,
                      torch.full_like(std, DIV_THRESHOLD), std)
    return (sub / std) * valid_mask


def _std_scale(ssum, ssq, n):
    """1/std (torch: unbiased, guard std > 1e-8, else 1)."""
    m = ssum / n
    var = (ssq - n * m * m) / torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.where(std > 1e-8, 1.0 / torch.clamp(std, min=1e-20),
                       torch.ones_like(std))


def normalize_image(img, true_h, true_w, method: str = "contrastive",
                    width: int = 7, centering: bool = True,
                    scaling: bool = True):
    """Normalize padded images ``img`` [B, H, W, 3] whose true extents are
    ``true_h``/``true_w`` [B]. Channel 0 gets the contrastive step."""
    B, H, W, _ = img.shape
    th = torch.as_tensor(true_h, device=img.device).reshape(B, 1, 1)
    tw = torch.as_tensor(true_w, device=img.device).reshape(B, 1, 1)
    yy = torch.arange(H, device=img.device)[None, :, None]
    xx = torch.arange(W, device=img.device)[None, None, :]
    mask = ((yy < th) & (xx < tw)).to(img.dtype)          # [B, H, W]
    n = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)[:, None, None, None]
    m3 = mask[..., None]
    x = img * m3
    if centering:
        mean = x.sum(dim=(1, 2), keepdim=True) / n
        x = (x - mean) * m3
    if scaling:
        m = x.sum(dim=(1, 2), keepdim=True) / n
        var = ((x * x).sum(dim=(1, 2), keepdim=True) - n * m * m) \
            / torch.clamp(n - 1.0, min=1.0)
        std = torch.sqrt(torch.clamp(var, min=0.0))
        x = torch.where(std > 1e-8, x / torch.clamp(std, min=1e-20), x)
    if method == "contrastive":
        y0 = contrastive_normalize(x[..., 0], mask, width)
        x = torch.cat([y0[..., None], x[..., 1:]], dim=-1)
    return x * m3


def _smooth_phased(z, k):
    """Separable zero-padded 'same' smoothing in original pixel space of a
    phase-major 2x2 space-to-depth decomposition ``z`` [..., 4, Hc, Wc]
    (page 2*qy+qx holds pixels (2i+qy, 2j+qx)). A tap at offset t-3 reads,
    for output phase a, source phase (a+t-3) mod 2 at plane shift
    floor((a+t-3)/2)."""
    w = len(k)
    if w != 7:
        raise ValueError("phased smoothing is specialized to width 7")
    Hc, Wc = z.shape[-2], z.shape[-1]
    zp = F.pad(z, (0, 0, 2, 2))
    rows = []
    for a in (0, 1):
        acc = 0.0
        for t in range(w):
            s = a + t - 3
            qp, shift = s % 2, s // 2
            acc = acc + float(k[t]) * zp[..., 2 * qp:2 * qp + 2,
                                         2 + shift:2 + shift + Hc, :]
        rows.append(acc)
    z = torch.cat(rows, dim=-3)
    zp = F.pad(z, (2, 2))
    cols = []
    for qy in (0, 1):
        for b in (0, 1):
            acc = 0.0
            for t in range(w):
                s = b + t - 3
                qp, shift = s % 2, s // 2
                p = 2 * qy + qp
                acc = acc + float(k[t]) * zp[..., p:p + 1, :,
                                             2 + shift:2 + shift + Wc]
            cols.append(acc)
    return torch.cat(cols, dim=-3)


def _s2d_masks(Hc, Wc, true_h, true_w, dtype, device):
    """Validity of the s2d planes for images of true size [B]: luminance
    [B, 4, Hc, Wc] and the rank-1 chroma factors rv [B, Hc, 8],
    cv [B, 8, Wc]. Plane (qy, qx) holds image pixel (2i+qy-1, 2j+qx-1)."""
    th = torch.as_tensor(true_h, device=device)[:, None, None]
    tw = torch.as_tensor(true_w, device=device)[:, None, None]
    ia = torch.arange(Hc, device=device)
    ja = torch.arange(Wc, device=device)
    q = torch.arange(2, device=device)
    r = 2 * ia[None, :] + q[:, None] - 1                  # [2(qy), Hc]
    c = 2 * ja[None, :] + q[:, None] - 1                  # [2(qx), Wc]
    rv2 = (r >= 0) & (r < th)                             # [B, 2, Hc]
    cv2 = (c >= 0) & (c < tw)                             # [B, 2, Wc]
    m4 = (rv2[:, :, None, :, None] & cv2[:, None, :, None, :])
    m4 = m4.reshape(-1, 4, Hc, Wc).to(dtype)
    ch = torch.arange(8, device=device)
    qy, qx = (ch // 2) // 2, (ch // 2) % 2
    rv = rv2[:, qy, :].transpose(1, 2).to(dtype)          # [B, Hc, 8]
    cv = cv2[:, qx, :].to(dtype)                          # [B, 8, Wc]
    return m4, rv, cv


def normalize_s2d(lum4, chroma, true_h, true_w, method: str = "contrastive",
                  width: int = 7, centering: bool = True,
                  scaling: bool = True):
    """:func:`normalize_image` on the space-to-depth planes, batched.

    lum4 [B, 4, Hc, Wc], chroma [B, Hc, 8, Wc] (``pack_s2d_np`` layout),
    true_h/true_w [B]. Returns the normalized (lum4, chroma), numerically
    the packed planes of the normalized image.
    """
    B, _, Hc, Wc = lum4.shape
    m4, rv, cv = _s2d_masks(Hc, Wc, true_h, true_w, lum4.dtype, lum4.device)
    cmask = rv[:, :, :, None] * cv[:, None, :, :]         # [B, Hc, 8, Wc]
    n = torch.clamp((torch.as_tensor(true_h, device=lum4.device)
                     * torch.as_tensor(true_w, device=lum4.device))
                    .to(lum4.dtype), min=1.0)             # [B]

    def per_uv(s8):                                       # [B, 8] -> [B, 2]
        return torch.stack([s8[:, 0::2].sum(-1), s8[:, 1::2].sum(-1)], -1)

    def to_ch(v2):                                        # [B, 2] -> bcast
        return v2.repeat(1, 4)[:, None, :, None]

    y = lum4 * m4
    x = chroma * cmask
    nb = n[:, None, None, None]
    if centering:
        y = (y - y.sum(dim=(1, 2, 3), keepdim=True) / nb) * m4
        mean2 = per_uv(x.sum(dim=(1, 3))) / n[:, None]
        x = (x - to_ch(mean2)) * cmask
    if scaling:
        y = y * _std_scale(y.sum(dim=(1, 2, 3), keepdim=True),
                           (y * y).sum(dim=(1, 2, 3), keepdim=True), nb)
        sc2 = _std_scale(per_uv(x.sum(dim=(1, 3))),
                         per_uv((x * x).sum(dim=(1, 3))), n[:, None])
        x = x * to_ch(sc2)
    if method == "contrastive":
        k = gaussian1d(width)
        safe_coef = torch.clamp(_smooth_phased(m4, k), min=1e-12)
        mean_l = _smooth_phased(y, k) / safe_coef
        sub = (y - mean_l) * m4
        var_l = _smooth_phased(sub * sub, k) / safe_coef
        std_l = torch.sqrt(torch.clamp(var_l, min=0.0))
        std_l = torch.where(std_l <= DIV_THRESHOLD,
                            torch.full_like(std_l, DIV_THRESHOLD), std_l)
        y = (sub / std_l) * m4
    return y, x
