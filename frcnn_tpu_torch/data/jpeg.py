"""JPEG decoding without a C library: numpy and Python.

:func:`decode` gives the bytes that PIL's ``Image.open(p).convert("RGB")``
gives (Pillow over libjpeg-turbo: the islow integer IDCT, fancy
upsampling, the fixed-point color conversions), bit for bit:

* markers SOI, APPn (JFIF; Adobe's APP14 and its transform flag), DQT (8-
  and 16-bit tables), DHT, DRI and RSTn, SOS, COM, EOI;
* baseline and extended sequential Huffman frames (SOF0, SOF1) and
  progressive Huffman frames (SOF2: DC and AC scans, first and refinement
  passes, EOB runs), 8-bit samples, 1, 3 or 4 components, any integral
  sampling factors (fancy upsampling for h2v1, h1v2 and h2v2 as libjpeg
  chooses it, replication otherwise), partial MCUs at any size;
* gray is repeated to three channels; YCbCr, RGB, Adobe CMYK and YCCK as
  libjpeg and PIL's ``convert("RGB")`` read them.

The entropy decode is serial. It looks every bit position of a scan up at
once in numpy (per Huffman table: the code's length, its symbol and the
value of the bits that follow, from a 16-bit lookahead table as
libjpeg's ``jdhuff.c`` keeps, which holds every code since JPEG's codes
are at most 16 bits long), and a Python loop then walks the symbols.
Dequantization, IDCT, upsampling and color conversion run over all blocks
at once in numpy.

Refused with ``ValueError`` naming the cause: arithmetic coding (SOF9-11,
SOF13-15, DAC), lossless (SOF3) and hierarchical (SOF5-7, DHP, EXP)
frames, precisions other than 8 bits, other component counts, fractional
sampling ratios, and entropy data that is truncated or corrupt (an
invalid code, a coefficient past its band, a missing or misnumbered
restart marker, a scan that reads past its data).
"""

from __future__ import annotations

import struct

import numpy as np

# libjpeg's integer DCTs (jfdctint.c, jidctint.c): 13 fraction bits in the
# constants, 2 more bits kept between the passes
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _descale(x, n: int):
    """libjpeg's DESCALE: x / 2^n rounded half up (an arithmetic shift)."""
    return (x + (1 << (n - 1))) >> n


def _odd_rotation(t4, t5, t6, t7):
    """The shared odd part of the integer DCTs: (t4', t5', t6', t7')."""
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _F1175
    z1, z2 = -z1 * _F0899, -z2 * _F2562
    z3, z4 = -z3 * _F1961 + z5, -z4 * _F0390 + z5
    return (t4 * _F0298 + z1 + z3, t5 * _F2053 + z2 + z4,
            t6 * _F3072 + z2 + z3, t7 * _F1501 + z1 + z4)


def _idct_pass(d, axis: int, last: bool):
    """One pass of ``jpeg_idct_islow`` along ``axis`` (length 8)."""
    g = [np.take(d, i, axis=axis) for i in range(8)]
    z1 = (g[2] + g[6]) * _F0541
    tmp2, tmp3 = z1 - g[6] * _F1847, z1 + g[2] * _F0765
    tmp0, tmp1 = (g[0] + g[4]) << _CONST_BITS, (g[0] - g[4]) << _CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = _odd_rotation(g[7], g[5], g[3], g[1])
    n = _CONST_BITS + _PASS1_BITS + 3 if last else _CONST_BITS - _PASS1_BITS
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1,
           t11 - o2, t10 - o3]
    return np.stack([_descale(v, n) for v in out], axis=axis)


def _fix(x: float) -> int:
    """libjpeg's FIX(x) at 16 fraction bits."""
    return int(x * 65536 + 0.5)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB (``jdcolor.c``), clipped."""
    half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix(1.402) * cr + half) >> 16)
    g = y + ((-_fix(0.34414) * cb + half - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.772) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _fancy_upsample(c: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2 "fancy" upsampling (``jdsample.c``): each output
    pixel 9/16, 3/16, 3/16, 1/16 of its four nearest samples, edge samples
    repeated, with the library's biases (8 and 7)."""
    up = np.concatenate([c[:1], c[:-1]], 0)
    down = np.concatenate([c[1:], c[-1:]], 0)
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.int64)
    for v, near in ((0, up), (1, down)):
        s = 3 * c + near                          # the column sums
        left = np.concatenate([s[:, :1], s[:, :-1]], 1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
        out[v::2, 0::2] = (3 * s + left + 8) >> 4
        out[v::2, 1::2] = (3 * s + right + 7) >> 4
    return out




def _h2v1_fancy(c: np.ndarray) -> np.ndarray:
    """libjpeg's h2v1 fancy upsampling: each output sample 3/4 of its
    nearest input sample and 1/4 of the next nearest, edge samples
    repeated, biases 1 and 2."""
    left = np.concatenate([c[:, :1], c[:, :-1]], 1)
    right = np.concatenate([c[:, 1:], c[:, -1:]], 1)
    out = np.empty((c.shape[0], 2 * c.shape[1]), np.int64)
    out[:, 0::2] = (3 * c + left + 1) >> 2
    out[:, 1::2] = (3 * c + right + 2) >> 2
    return out


def _h1v2_fancy(c: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's h1v2 fancy upsampling: :func:`_h2v1_fancy` down
    the columns."""
    return _h2v1_fancy(c.T).T


# the natural (row-major) index of each zigzag position
_NATURAL = np.array(sorted(range(64), key=lambda n: (
    n // 8 + n % 8, n // 8 if (n // 8 + n % 8) % 2 else -(n // 8))))
_TO_NATURAL = np.argsort(_NATURAL)      # natural index -> zigzag position

_MARKER_NAMES = {0xC3: "SOF3 (lossless)", 0xC5: "SOF5 (hierarchical)",
                 0xC6: "SOF6 (hierarchical, progressive)",
                 0xC7: "SOF7 (hierarchical, lossless)",
                 0xC9: "SOF9 (arithmetic coding)",
                 0xCA: "SOF10 (arithmetic coding, progressive)",
                 0xCB: "SOF11 (arithmetic coding, lossless)",
                 0xCC: "DAC (arithmetic coding)",
                 0xCD: "SOF13 (hierarchical, arithmetic coding)",
                 0xCE: "SOF14 (hierarchical, arithmetic coding, progressive)",
                 0xCF: "SOF15 (hierarchical, arithmetic coding, lossless)",
                 0xDE: "DHP (hierarchical)", 0xDF: "EXP (hierarchical)",
                 0xDC: "DNL"}


class _Huffman:
    """A Huffman table as a 16-bit lookahead table (``lut``, a list): for
    every 16-bit window, ``symbol << 5 | length`` of the code it starts
    with, 0 where it starts with no code."""

    def __init__(self, counts, symbols):
        lut = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for n in range(1, 17):
            for _ in range(counts[n - 1]):
                if code >= (1 << n) - (n == 16) or k >= len(symbols):
                    raise ValueError("bad Huffman table")
                lut[code << (16 - n):(code + 1) << (16 - n)] = \
                    symbols[k] << 5 | n
                code, k = code + 1, k + 1
            code <<= 1
        self.lut = lut.tolist()
        self.max_symbol = max(symbols, default=0)


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.q = None                 # the latched quantization table


class _Bits:
    """A scan's entropy-coded data: the restart segments with their
    stuffed zero bytes removed, as one bit string; ``starts`` and ``ends``
    the bit offsets of each segment; ``window[p]`` the 16 bits from bit p
    on (zeros past the end); ``end`` the marker after the data."""

    def __init__(self, data: bytes, pos: int):
        arr = np.frombuffer(data, np.uint8)
        ff = np.flatnonzero(arr[pos:] == 0xFF) + pos
        drop, cuts, expect, end = [], [], 0, None
        i = 0
        while i < len(ff):
            p = int(ff[i])
            q = p + 1
            while q < len(data) and data[q] == 0xFF:      # fill bytes
                q += 1
            if q >= len(data):
                raise ValueError("truncated JPEG: no marker after the scan")
            if data[q] == 0x00:                           # a stuffed 0xFF
                drop.extend(range(p + 1, q + 1))
            elif 0xD0 <= data[q] <= 0xD7:
                if data[q] != 0xD0 + expect:
                    raise ValueError(f"corrupt JPEG: RST{data[q] - 0xD0} "
                                     f"where RST{expect} was due")
                expect = (expect + 1) % 8
                cuts.append((p, q + 1))
            else:
                end = p
                break
            while i < len(ff) and ff[i] <= q:
                i += 1
        if end is None:
            raise ValueError("truncated JPEG: the scan's data has no end")
        keep = np.ones(end - pos, bool)
        keep[np.asarray(drop, np.int64) - pos] = False
        bounds = [pos]
        for a, b in cuts:
            keep[a - pos:b - pos] = False
            bounds += [a, b]
        bounds.append(end)
        # byte offsets of each segment's start in the unstuffed data
        kept = np.concatenate([[0], np.cumsum(keep)])
        self.starts = [8 * int(kept[a - pos]) for a in bounds[0::2]]
        self.ends = [8 * int(kept[b - pos]) for b in bounds[1::2]]
        body = np.concatenate([arr[pos:end][keep], np.zeros(8, np.uint8)])
        b = body.astype(np.int64)
        u32 = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
        self.window = memoryview((np.repeat(u32, 8) >> (16 - np.tile(
            np.arange(8), len(u32)))) & 0xFFFF)
        self.end = end


def _corrupt(what: str = "") -> ValueError:
    return ValueError("corrupt JPEG entropy data" + (f": {what}" if what
                                                      else ""))


def _read_segment(data: bytes, pos: int):
    if pos + 2 > len(data):
        raise ValueError("truncated JPEG: a marker segment is cut off")
    n = struct.unpack(">H", data[pos:pos + 2])[0]
    if n < 2 or pos + n > len(data):
        raise ValueError("truncated JPEG: a marker segment is cut off")
    return data[pos + 2:pos + n], pos + n


def _scan_order(comps, scan, frame):
    """The scan's blocks in decode order: (component slot in the scan,
    flat offset of the block's first coefficient) as two lists, and the
    blocks per MCU."""
    if len(scan) == 1:
        c = scan[0]
        by, bx = np.meshgrid(np.arange(c.bh), np.arange(c.bw), indexing="ij")
        base = ((by * c.bw_full + bx) * 64).ravel()
        return [0] * base.size, base.tolist(), 1
    mcuy, mcux = frame["mcuy"], frame["mcux"]
    bases, slots = [], []
    my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
    for k, c in enumerate(scan):
        v, h = np.meshgrid(np.arange(c.v), np.arange(c.h), indexing="ij")
        by = my.ravel()[:, None] * c.v + v.ravel()[None]
        bx = mx.ravel()[:, None] * c.h + h.ravel()[None]
        bases.append((by * c.bw_full + bx) * 64)
        slots.append(np.full(bases[-1].shape, k))
    return (np.concatenate(slots, 1).ravel().tolist(),
            np.concatenate(bases, 1).ravel().tolist(),
            sum(c.h * c.v for c in scan))


def _segments(bits: _Bits, n_mcus: int, per_mcu: int, restart: int):
    """(block from, block to, bit start, bit end) of each restart interval
    the scan needs."""
    per = restart * per_mcu if restart else n_mcus * per_mcu
    n = -(-n_mcus * per_mcu // per)
    if len(bits.starts) < n:
        raise ValueError("truncated JPEG: fewer restart intervals than MCUs "
                         "need")
    return [(k * per, min((k + 1) * per, n_mcus * per_mcu), bits.starts[k],
             bits.ends[k]) for k in range(n)]


def _check_end(pos: int, end: int):
    if pos > end:
        raise ValueError("truncated or corrupt JPEG: a scan reads past the "
                         "end of its data")


def _sequential(win, segs, slots, bases, coefs, dcs, acs):
    """A baseline or extended sequential scan (``jdhuff.c::decode_mcu``).
    A symbol's size s is followed by s bits x: the value is x where its
    top bit is set, else x - 2^s + 1 (HUFF_EXTEND)."""
    for b0, b1, pos, end in segs:
        pred = [0] * len(coefs)
        for slot, base in zip(slots[b0:b1], bases[b0:b1]):
            cl, ac = coefs[slot], acs[slot]
            e = dcs[slot][win[pos]]
            if not e:
                raise _corrupt("invalid DC code")
            pos += e & 31
            s = e >> 5
            if s:
                x = win[pos] >> (16 - s)
                pos += s
                pred[slot] += x if x >> (s - 1) else x - (1 << s) + 1
            cl[base] = pred[slot]
            k = 1
            while k < 64:
                e = ac[win[pos]]
                if not e:
                    raise _corrupt("invalid AC code")
                pos += e & 31
                rs = e >> 5
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise _corrupt("a coefficient past the block")
                    x = win[pos] >> (16 - s)
                    pos += s
                    cl[base + k] = x if x >> (s - 1) else x - (1 << s) + 1
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
        _check_end(pos, end)


def _dc_first(win, segs, slots, bases, coefs, dcs, al):
    for b0, b1, pos, end in segs:
        pred = [0] * len(coefs)
        for slot, base in zip(slots[b0:b1], bases[b0:b1]):
            e = dcs[slot][win[pos]]
            if not e:
                raise _corrupt("invalid DC code")
            pos += e & 31
            s = e >> 5
            if s:
                x = win[pos] >> (16 - s)
                pos += s
                pred[slot] += x if x >> (s - 1) else x - (1 << s) + 1
            coefs[slot][base] = pred[slot] << al
        _check_end(pos, end)


def _dc_refine(win, segs, slots, bases, coefs, al):
    for b0, b1, pos, end in segs:
        for slot, base in zip(slots[b0:b1], bases[b0:b1]):
            if win[pos] >> 15:
                coefs[slot][base] |= 1 << al
            pos += 1
        _check_end(pos, end)


def _eob_run(win, pos, r):
    """EOBr's run length (2^r plus r appended bits) and the position
    after those bits."""
    if not r:
        return 1, pos
    return (1 << r) + (win[pos] >> (16 - r)), pos + r


def _ac_first(win, segs, bases, cl, ac, ss, se, al):
    """``jdphuff.c::decode_mcu_AC_first``."""
    for b0, b1, pos, end in segs:
        eobrun = 0
        for base in bases[b0:b1]:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                e = ac[win[pos]]
                if not e:
                    raise _corrupt("invalid AC code")
                pos += e & 31
                rs = e >> 5
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    if k > se:
                        raise _corrupt("a coefficient past the band")
                    x = win[pos] >> (16 - s)
                    pos += s
                    cl[base + k] = (x if x >> (s - 1)
                                    else x - (1 << s) + 1) << al
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun, pos = _eob_run(win, pos, r)
                    eobrun -= 1
                    break
        _check_end(pos, end)


def _ac_refine(win, segs, bases, cl, ac, ss, se, al):
    """``jdphuff.c::decode_mcu_AC_refine``: new coefficients of +-2^al and
    a correction bit for each coefficient already nonzero."""
    p1, m1 = 1 << al, -1 << al
    for b0, b1, pos, end in segs:
        eobrun = 0
        for base in bases[b0:b1]:
            k = ss
            if not eobrun:
                while k <= se:
                    e = ac[win[pos]]
                    if not e:
                        raise _corrupt("invalid AC code")
                    pos += e & 31
                    rs = e >> 5
                    r, s = rs >> 4, rs & 15
                    if s:
                        if s != 1:
                            raise _corrupt("a refinement coefficient of size "
                                           f"{s}")
                        s = p1 if win[pos] >> 15 else m1
                        pos += 1
                    elif r != 15:
                        eobrun, pos = _eob_run(win, pos, r)
                        break
                    # over nonzero coefficients (each a correction bit) and
                    # r zero ones, to the zero the new coefficient takes
                    while k <= se:
                        z = base + k
                        v = cl[z]
                        if v:
                            if win[pos] >> 15 and not v & p1:
                                cl[z] = v + p1 if v >= 0 else v + m1
                            pos += 1
                        elif r:
                            r -= 1
                        else:
                            break
                        k += 1
                    if s:
                        if k > se:
                            raise _corrupt("a coefficient past the band")
                        cl[base + k] = s
                    k += 1
            if eobrun:
                while k <= se:
                    z = base + k
                    v = cl[z]
                    if v:
                        if win[pos] >> 15 and not v & p1:
                            cl[z] = v + p1 if v >= 0 else v + m1
                        pos += 1
                    k += 1
                eobrun -= 1
        _check_end(pos, end)


def _frame(data: bytes, pos: int, marker: int, comps):
    seg, pos = _read_segment(data, pos)
    if len(seg) < 6:
        raise ValueError("truncated JPEG frame header")
    precision, height, width, n = struct.unpack(">BHHB", seg[:6])
    if precision != 8:
        raise ValueError(f"{precision}-bit JPEG samples: only 8-bit ones "
                         f"decode")
    if height == 0 or width == 0:
        raise ValueError("JPEG frame of zero size (DNL is not read)")
    if n not in (1, 3, 4) or len(seg) < 6 + 3 * n:
        raise ValueError(f"JPEG frame of {n} components: 1, 3 or 4 decode")
    for i in range(n):
        cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise ValueError(f"JPEG component of sampling {h}x{v}, table "
                             f"{tq}")
        comps.append(_Component(cid, h, v, tq))
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    frame = {"width": width, "height": height, "hmax": hmax, "vmax": vmax,
             "mcux": -(-width // (8 * hmax)), "mcuy": -(-height // (8 * vmax)),
             "progressive": marker == 0xC2}
    for c in comps:
        if hmax % c.h or vmax % c.v:
            raise ValueError(f"JPEG sampling ratio {hmax}/{c.h}x{vmax}/{c.v} "
                             f"is not integral")
        c.w = -(-width * c.h // hmax)           # the downsampled size
        c.hh = -(-height * c.v // vmax)
        c.bw, c.bh = -(-c.w // 8), -(-c.hh // 8)
        c.bw_full, c.bh_full = frame["mcux"] * c.h, frame["mcuy"] * c.v
        c.coef = [0] * (c.bw_full * c.bh_full * 64)
    return frame, pos


def _scan(data, pos, frame, comps, qtables, dc_tabs, ac_tabs, restart):
    seg, pos = _read_segment(data, pos)
    n = seg[0] if seg else 0
    if not 1 <= n <= 4 or len(seg) != 4 + 2 * n:
        raise ValueError("bad JPEG scan header")
    by_id = {c.id: c for c in comps}
    scan, tables = [], []
    for i in range(n):
        cid, t = seg[1 + 2 * i:3 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"JPEG scan of an unknown component {cid}")
        scan.append(by_id[cid])
        tables.append((t >> 4, t & 15))
    ss, se, a = seg[1 + 2 * n:4 + 2 * n]
    ah, al = a >> 4, a & 15
    if frame["progressive"]:
        if (ss == 0) != (se == 0) or se < ss or se > 63 or (ss and n > 1) \
                or al > 13:
            raise ValueError(f"bad progressive JPEG scan: Ss {ss} Se {se} "
                             f"over {n} components")
    elif (ss, se, ah, al) != (0, 63, 0, 0):
        raise ValueError(f"bad sequential JPEG scan: Ss {ss} Se {se} Ah "
                         f"{ah} Al {al}")
    for c in scan:
        if c.q is None:                 # latched at the component's first
            if qtables[c.tq] is None:   # scan, as libjpeg does
                raise ValueError(f"JPEG quantization table {c.tq} missing")
            c.q = qtables[c.tq]
    bits = _Bits(data, pos)
    slots, bases, per_mcu = _scan_order(comps, scan, frame)
    n_mcus = len(bases) // per_mcu
    segs = _segments(bits, n_mcus, per_mcu, restart)
    coefs = [c.coef for c in scan]

    def table(tabs, k, ac):
        t = tabs[k]
        if t is None:
            raise ValueError(f"JPEG Huffman table {k} missing")
        if not ac and t.max_symbol > 15:
            raise ValueError("bad JPEG DC Huffman table")
        return t.lut

    win = bits.window
    try:
        if ss == 0 and ah == 0:
            dcs = [table(dc_tabs, td, False) for td, _ in tables]
            if frame["progressive"]:
                _dc_first(win, segs, slots, bases, coefs, dcs, al)
            else:
                acs = [table(ac_tabs, ta, True) for _, ta in tables]
                _sequential(win, segs, slots, bases, coefs, dcs, acs)
        elif ss == 0:
            _dc_refine(win, segs, slots, bases, coefs, al)
        else:
            ac = table(ac_tabs, tables[0][1], True)
            fn = _ac_refine if ah else _ac_first
            fn(win, segs, bases, coefs[0], ac, ss, se, al)
    except IndexError as e:     # a walk past the last position of the data
        raise _corrupt("a scan reads past the end of its data") from e
    return bits.end


def _plane(c: _Component) -> np.ndarray:
    """Component ``c``'s samples [c.hh, c.w] (int64): dequantized, the
    islow IDCT (columns, then rows), +128 and the range limit."""
    coef = np.asarray(c.coef, np.int64).reshape(c.bh_full, c.bw_full, 64)
    blocks = coef[:c.bh, :c.bw][..., _TO_NATURAL] * c.q
    blocks = blocks.reshape(c.bh, c.bw, 8, 8)
    rec = _idct_pass(_idct_pass(blocks, -2, False), -1, True)
    rec = np.clip(rec + 128, 0, 255)
    return rec.transpose(0, 2, 1, 3).reshape(8 * c.bh, 8 * c.bw)[:c.hh, :c.w]


def _upsample(p: np.ndarray, c: _Component, frame) -> np.ndarray:
    """``jdsample.c``'s choice for the component's ratio: fancy h2v1 and
    h2v2 where the downsampled width exceeds 2, fancy h1v2, replication
    otherwise; cropped to the image."""
    rh, rv = frame["hmax"] // c.h, frame["vmax"] // c.v
    if (rh, rv) == (2, 1) and c.w > 2:
        p = _h2v1_fancy(p)
    elif (rh, rv) == (1, 2):
        p = _h1v2_fancy(p)
    elif (rh, rv) == (2, 2) and c.w > 2:
        p = _fancy_upsample(p)
    elif (rh, rv) != (1, 1):
        p = np.repeat(np.repeat(p, rv, 0), rh, 1)
    return p[:frame["height"], :frame["width"]]


def _muldiv255(a, b):
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """libjpeg's CMYK read as PIL's ``CMYK;I`` (inverted) and converted by
    its ``convert("RGB")``."""
    nk = k                                  # 255 - (255 - k)
    out = [np.clip(nk - _muldiv255(255 - x, nk), 0, 255) for x in (c, m, y)]
    return np.stack(out, -1).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """Decode a JPEG file's bytes to uint8 RGB [h, w, 3]; ``ValueError``
    for what it does not decode (see the module docstring)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG: no SOI marker")
    qtables = [None] * 4
    dc_tabs, ac_tabs = [None] * 4, [None] * 4
    comps, frame, restart = [], None, 0
    jfif, adobe = False, None
    pos, done = 2, False
    while not done:
        # the next marker, past extraneous bytes as libjpeg skips them
        m = 0
        while m == 0:
            pos = data.find(b"\xff", pos)
            if pos < 0:
                raise ValueError("truncated JPEG: no EOI marker")
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1
            if pos >= len(data):
                raise ValueError("truncated JPEG: no EOI marker")
            m = data[pos]
            pos += 1
        if m in _MARKER_NAMES:
            raise ValueError(f"JPEG {_MARKER_NAMES[m]} is not decoded")
        if m == 0xD9:
            done = True
        elif m == 0x01 or 0xD0 <= m <= 0xD7:
            continue
        elif m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG with two frames")
            frame, pos = _frame(data, pos, m, comps)
        elif m == 0xC4:
            seg, pos = _read_segment(data, pos)
            i = 0
            while i < len(seg):
                if i + 17 > len(seg):
                    raise ValueError("truncated JPEG Huffman table")
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                symbols = seg[i + 17:i + 17 + sum(counts)]
                if tc > 1 or th > 3 or len(symbols) < sum(counts):
                    raise ValueError("bad JPEG Huffman table")
                (ac_tabs if tc else dc_tabs)[th] = _Huffman(counts,
                                                            list(symbols))
                i += 17 + sum(counts)
        elif m == 0xDB:
            seg, pos = _read_segment(data, pos)
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 64 * (pq + 1)
                if pq > 1 or tq > 3 or i + 1 + size > len(seg):
                    raise ValueError("bad JPEG quantization table")
                q = np.frombuffer(seg[i + 1:i + 1 + size],
                                  ">u2" if pq else np.uint8)
                qtables[tq] = q.astype(np.int64)[_TO_NATURAL]
                i += 1 + size
        elif m == 0xDD:
            seg, pos = _read_segment(data, pos)
            if len(seg) < 2:
                raise ValueError("bad JPEG restart interval")
            restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame")
            pos = _scan(data, pos, frame, comps, qtables, dc_tabs, ac_tabs,
                        restart)
        elif m == 0xD8:
            raise ValueError("corrupt JPEG: a second SOI marker")
        else:                           # APPn, COM and others with a length
            seg, pos = _read_segment(data, pos)
            if m == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\x00":
                jfif = True
            if m == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
    if frame is None:
        raise ValueError("JPEG without a frame")
    if any(c.q is None for c in comps):
        raise ValueError("JPEG component without a scan")
    planes = [_upsample(_plane(c), c, frame) for c in comps]
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, 2)
    if len(planes) == 3:
        ids = tuple(c.id for c in comps)
        rgb = (not jfif and adobe == 0) or (
            not jfif and adobe is None and ids == (82, 71, 66))
        if rgb:
            return np.stack(planes, -1).astype(np.uint8)
        return _ycc_to_rgb(*planes)
    if adobe is not None and adobe != 0:        # YCCK
        cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int64)
        return _cmyk_to_rgb(cmy[..., 0], cmy[..., 1], cmy[..., 2], planes[3])
    return _cmyk_to_rgb(*planes)
