"""Int8 x int8 convolution with exact int32 sums, NHWC.

The JAX package leaves this product to XLA
(``lax.conv_general_dilated`` on int8 operands with
``preferred_element_type=int32``, ``frcnn_tpu/models/quant.py:85-92``),
outside any Pallas kernel. The port does it as an explicit im2col of the
padded NHWC input (one copy per tap into a [M, K] int8 matrix, column
``(dy * kw + dx) * C + c``) and one library int8 matrix product,
``torch._int_mm``, whose int32 sums are exact on the CPU and on the card.
``F.conv2d`` is no route: on int8 CPU tensors it returns int8, not the
int32 sums.

``torch._int_mm`` on CUDA takes more than 16 rows and an inner size and a
column count that are multiples of 8; the matrices are padded with zero
rows and columns to meet that, which leaves every sum as it is (the
vgg_small anchor heads' 18 outputs become 24, the NHWC first conv's
K = 27 becomes 32). A shape it refuses raises: there is no float
fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MIN_ROWS = 17       # _int_mm on CUDA: more than 16 rows


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def weight_matrix(wq_oihw: torch.Tensor) -> torch.Tensor:
    """int8 OIHW [N, C, kh, kw] -> the product's int8 [N8, K8] (row o,
    column (dy * kw + dx) * C + c), zero padded to multiples of 8."""
    n, c, kh, kw = wq_oihw.shape
    k = kh * kw * c
    w = torch.zeros((_ceil8(n), _ceil8(k)), dtype=torch.int8,
                    device=wq_oihw.device)
    w[:n, :k] = wq_oihw.permute(0, 2, 3, 1).reshape(n, k)
    return w


def im2col(xq: torch.Tensor, kh: int, kw: int, padding) -> torch.Tensor:
    """int8 NHWC [B, H, W, C] -> int8 [max(M, 17), K8] patch matrix, M =
    B * Ho * Wo rows in NHWC order. ``padding``: ((top, bottom), (left,
    right)) zeros around the image."""
    (pt, pb), (pl, pr) = padding
    if pt or pb or pl or pr:
        xq = F.pad(xq, (0, 0, pl, pr, pt, pb))
    B, Hp, Wp, C = xq.shape
    Ho, Wo = Hp - kh + 1, Wp - kw + 1
    M, K = B * Ho * Wo, kh * kw * C
    Mp, Kp = max(M, MIN_ROWS), _ceil8(K)
    cols = torch.empty((Mp, Kp), dtype=torch.int8, device=xq.device)
    if Mp > M:
        cols[M:].zero_()
    if Kp > K:
        cols[:M, K:].zero_()
    # copy 4 bytes at a time where the channels allow it
    word = torch.int32 if C % 4 == 0 and Kp % 4 == 0 else torch.int8
    r = 4 if word == torch.int32 else 1
    src = xq.contiguous().view(word)
    dst = cols[:M].view(word).view(B, Ho, Wo, Kp // r)
    cw = C // r
    for dy in range(kh):
        for dx in range(kw):
            t = dy * kw + dx
            dst[..., t * cw:(t + 1) * cw] = src[:, dy:dy + Ho, dx:dx + Wo]
    return cols


def conv2d_int8(xq: torch.Tensor, wmat: torch.Tensor, kh: int, kw: int,
                padding, n_out: int) -> torch.Tensor:
    """Exact int32 sums of the int8 convolution of NHWC ``xq`` with the
    weights ``wmat`` of :func:`weight_matrix`: int32 NHWC [B, Ho, Wo,
    n_out] (a view of the padded product)."""
    B, H, W, _ = xq.shape
    (pt, pb), (pl, pr) = padding
    Ho, Wo = H + pt + pb - kh + 1, W + pl + pr - kw + 1
    cols = im2col(xq, kh, kw, padding)
    acc = torch._int_mm(cols, wmat.t())
    return acc[:B * Ho * Wo].view(B, Ho, Wo, wmat.shape[0])[..., :n_out]
