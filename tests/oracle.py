"""Independent numpy (float64) oracle implementing the reference's HLSL
sampling semantics per-pixel, straight from the shader text.  Used to verify
the package's phase-composed / matmul-based formulations.

HLSL conventions modeled here:
 * texture coordinates u in [0,1]; texel centers at (i+0.5)/N
 * point sampler: texel floor(u*N), CLAMP addressing
 * linear sampler: pos = u*N - 0.5, lerp between floor/ceil texels, CLAMP
"""

from __future__ import annotations

import math

import numpy as np


def _clampi(i, n):
    return np.clip(i, 0, n - 1)


def sample_point(img: np.ndarray, u: float, v: float) -> float:
    h, w = img.shape
    x = _clampi(int(math.floor(u * w)), w)
    y = _clampi(int(math.floor(v * h)), h)
    return img[y, x]


def sample_linear(img: np.ndarray, u: float, v: float) -> float:
    h, w = img.shape
    px = u * w - 0.5
    py = v * h - 0.5
    x0 = int(math.floor(px))
    y0 = int(math.floor(py))
    tx = px - x0
    ty = py - y0
    x0c, x1c = _clampi(x0, w), _clampi(x0 + 1, w)
    y0c, y1c = _clampi(y0, h), _clampi(y0 + 1, h)
    a = img[y0c, x0c] * (1 - tx) + img[y0c, x1c] * tx
    b = img[y1c, x0c] * (1 - tx) + img[y1c, x1c] * tx
    return a * (1 - ty) + b * ty


def sample_point_offset(img: np.ndarray, u: float, v: float, ox: int, oy: int):
    """tex.Sample(samp, uv, int2(ox,oy)) — texel offset applied after
    coordinate-to-texel mapping."""
    h, w = img.shape
    x = _clampi(int(math.floor(u * w)) + ox, w)
    y = _clampi(int(math.floor(v * h)) + oy, h)
    return img[y, x]


# -- chroma upsampling oracle (ShaderGetPixels, Source/Shaders.cpp:82-529) ---

def catmullrom_weights(t: float) -> np.ndarray:
    t2, t3 = t * t, t * t * t
    return np.array([
        t2 - (t3 + t) / 2,
        t3 * 1.5 + 1 - t2 * 2.5,
        t2 * 2 + t / 2 - t3 * 1.5,
        (t3 - t2) / 2,
    ])


def chroma_upsample_420(c: np.ndarray, method: str, loc: str,
                        out_h: int, out_w: int) -> np.ndarray:
    """Per-pixel evaluation of the 420 chroma section of the convert shader.

    method: 'nearest' | 'bilinear' | 'catmullrom'
    loc: 'mpeg2' | 'mpeg1' | 'cosited'
    """
    H, W = out_h, out_w
    out = np.zeros((H, W))
    dx, dy = 1.0 / W, 1.0 / H
    for yy in range(H):
        for xx in range(W):
            u = (xx + 0.5) / W
            v = (yy + 0.5) / H
            if method == "nearest":
                out[yy, xx] = sample_point(c, u, v)
            elif method == "bilinear":
                if loc == "cosited":
                    pu, pv = u + dx * 0.5, v + dy * 0.5
                elif loc == "mpeg1":
                    pu, pv = u, v
                else:
                    pu, pv = u + dx * 0.5, v
                out[yy, xx] = sample_linear(c, pu, pv)
            elif method == "catmullrom":
                # t = frac(Tex * (wh*0.5)) + strChromaPos2
                shift = {"cosited": (-0.25, -0.25), "mpeg1": (-0.5, -0.5),
                         "mpeg2": (-0.25, -0.5)}[loc]
                tx = (u * (W * 0.5)) % 1.0 + shift[0]
                ty = (v * (H * 0.5)) % 1.0 + shift[1]
                wx = catmullrom_weights(tx)
                wy = catmullrom_weights(ty)
                acc = 0.0
                for jj in range(4):
                    for ii in range(4):
                        acc += (wx[ii] * wy[jj]
                                * sample_point_offset(c, u, v, ii - 1, jj - 1))
                out[yy, xx] = acc
            else:
                raise ValueError(method)
    return out


def chroma_upsample_422(c: np.ndarray, method: str, out_w: int) -> np.ndarray:
    """3-plane 4:2:2 chroma section (Source/Shaders.cpp:300-318)."""
    H = c.shape[0]
    W = out_w
    out = np.zeros((H, W))
    dx = 1.0 / W
    for yy in range(H):
        v = (yy + 0.5) / H
        for xx in range(W):
            u = (xx + 0.5) / W
            if method == "nearest":
                out[yy, xx] = sample_point(c, u, v)
            elif xx % 2 == 0:
                out[yy, xx] = sample_point(c, u, v)
            elif method == "bilinear":
                # pos = Tex + float2(dx*0.5, 0), linear sampler
                out[yy, xx] = sample_linear(c, u + dx * 0.5, v)
            else:  # catmullrom: CATMULLROM_05 over taps at -2dx..+4dx of Tex-dx
                base = u - dx
                taps = [sample_point(c, base + k * 2 * dx, v) for k in (-1, 0, 1, 2)]
                out[yy, xx] = (9 * (taps[1] + taps[2]) - (taps[0] + taps[3])) / 16.0
    return out


# -- resize oracles -----------------------------------------------------------

def interp_resize_axis(img: np.ndarray, out_size: int, method: str) -> np.ndarray:
    """ps_interpolation_* along the last axis (per-pixel loop)."""
    h, w = img.shape
    out = np.zeros((h, out_size))
    for j in range(out_size):
        pos = (j + 0.5) * w / out_size - 0.5
        t = pos - math.floor(pos)
        base = int(math.floor(pos))
        if method == "mitchell":
            t2, t3 = t * t, t * t * t
            wts = (np.array([1., 16., 1., 0.]) / 18.
                   + np.array([-.5, 0., .5, 0.]) * t
                   + np.array([5., -12., 9., -2.]) / 6. * t2
                   + np.array([-7., 21., -21., 7.]) / 18. * t3)
            taps = [base - 1, base, base + 1, base + 2]
        elif method == "catmullrom":
            t2, t3 = t * t, t * t * t
            wts = (np.array([-.5, 0., .5, 0.]) * t
                   + np.array([1., -2.5, 2., -.5]) * t2
                   + np.array([-.5, 1.5, -1.5, .5]) * t3)
            wts[1] += 1.0
            taps = [base - 1, base, base + 1, base + 2]
        elif method == "lanczos2":
            if t == 0.0:
                out[:, j] = img[:, _clampi(base, w)]
                continue
            wset = np.array([1 + t, t, 1 - t, 2 - t]) * np.pi
            wts = np.sin(wset) * np.sin(wset * 0.5) / (wset * wset * 0.5)
            wc = 1.0 - wts.sum()
            wts[1] += wc * (1 - t)
            wts[2] += wc * t
            taps = [base - 1, base, base + 1, base + 2]
        elif method == "lanczos3":
            if t == 0.0:
                out[:, j] = img[:, _clampi(base, w)]
                continue
            wset0 = (np.array([2., 1., 0.]) + t) * np.pi
            wset1 = (np.array([1., 2., 3.]) - t) * np.pi
            w0 = np.sin(wset0) * np.sin(wset0 * .5) / (wset0 * wset0 * .5)
            w1 = np.sin(wset1) * np.sin(wset1 * .5) / (wset1 * wset1 * .5)
            wc = 1.0 - (w0.sum() + w1.sum())
            w0[2] += wc * (1 - t)
            w1[0] += wc * t
            wts = np.concatenate([w0, w1])
            taps = [base - 2, base - 1, base, base + 1, base + 2, base + 3]
        else:
            raise ValueError(method)
        acc = np.zeros(h)
        for wt, tap in zip(wts, taps):
            acc += wt * img[:, _clampi(tap, w)]
        out[:, j] = acc
    return out


_FILTERS = {
    "box": (lambda x: 1.0 if -0.5 <= x < 0.5 else 0.0, 0.5),
    "bilinear": (lambda x: max(0.0, 1.0 - abs(x)), 1.0),
    "hamming": (lambda x: 1.0 if x == 0 else (
        0.0 if abs(x) >= 1.0 else
        math.sin(abs(x) * math.pi) / (abs(x) * math.pi)
        * (0.54 + 0.46 * math.cos(abs(x) * math.pi))), 1.0),
    "bicubic": (None, 2.0),        # A=-0.5, filled below
    "bicubic_sharp": (None, 2.0),  # A=-1.5
    "lanczos": (None, 3.0),
}


def _bicubic(a):
    def f(x):
        x = abs(x)
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
        if x < 2.0:
            return (((x - 5) * x + 8) * x - 4) * a
        return 0.0
    return f


def _lanczos3f(x):
    if not (-3.0 <= x < 3.0):
        return 0.0
    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v
    return sinc(x) * sinc(x / 3)


_FILTERS["bicubic"] = (_bicubic(-0.5), 2.0)
_FILTERS["bicubic_sharp"] = (_bicubic(-1.5), 2.0)
_FILTERS["lanczos"] = (_lanczos3f, 3.0)


def conv_resize_axis(img: np.ndarray, out_size: int, filt: str) -> np.ndarray:
    """ps_convolution.hlsl along the last axis (per-pixel loop)."""
    f, support0 = _FILTERS[filt]
    h, w = img.shape
    scale = w / out_size
    support = support0 * scale
    ss = 1.0 / scale
    out = np.zeros((h, out_size))
    for j in range(out_size):
        pos = (j + 0.5) / out_size * w + 0.5
        low = int(math.floor(pos - support))
        high = int(math.ceil(pos + support))
        ww = 0.0
        acc = np.zeros(h)
        for n in range(low, high):
            wt = f((n - pos + 0.5) * ss)
            ww += wt
            acc += wt * img[:, _clampi(n, w)]
        out[:, j] = acc / ww
    return out
