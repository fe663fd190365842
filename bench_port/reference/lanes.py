"""Vector and quaternion helpers on lane lists (3- or 4-lists whose entries
are ``(B,)`` tensors or static Python floats), built on the zero-pruning
scalar helpers of ``newton.py`` (frozen from the port's ``ops/lanes.py``)."""
from __future__ import annotations

import torch

from .newton import sadd, smul, ssub


# sincos's float32 constants: 2/pi, pi/2 in three parts, and cephes'
# minimax coefficients of sin and cos on [-pi/4, pi/4]
_TWO_OVER_PI = 6.366197467e-01
_PIO2 = (1.570312500e+00, 4.837512970e-04, 7.549790126e-08)
_SIN = (-1.951529557e-04, 8.332161233e-03, -1.666665524e-01)
_COS = (2.443315680e-05, -1.388731645e-03, 4.166664556e-02)


def sincos(x):
    """(sin x, cos x) of a float32 lane by the float32 operations of
    ``csrc/lanes.cuh`` sincos_k1, in the same order, so the twin and kernel
    K1 get the same bits on the CPU and on the card: x - k pi/2 with k the
    nearest quadrant, cephes' polynomials, the quadrant's signs."""
    k = torch.floor(x * _TWO_OVER_PI + 0.5)
    r = ((x - k * _PIO2[0]) - k * _PIO2[1]) - k * _PIO2[2]
    z = r * r
    ps = ((_SIN[0] * z + _SIN[1]) * z + _SIN[2]) * z * r + r
    pc = ((_COS[0] * z + _COS[1]) * z + _COS[2]) * z * z - 0.5 * z + 1.0
    q = k - 4.0 * torch.floor(k * 0.25)
    s = torch.where(q == 0, ps, torch.where(q == 1, pc, torch.where(
        q == 2, -ps, -pc)))
    c = torch.where(q == 0, pc, torch.where(q == 1, -ps, torch.where(
        q == 2, -pc, ps)))
    return s, c


def sqrt(x):
    """The correctly rounded square root of a lane, as IEEE's sqrtf in the
    kernels: PyTorch's vectorized float32 sqrt on some CPUs is not (AVX-512
    builds miss in the last bit on ~0.7% of inputs), so float32 lanes take
    it in float64, rounded once, which is exact for a float32 operand."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def lane(x, B, dtype, device):
    """Static float or (B,) tensor -> (B,) tensor."""
    if isinstance(x, torch.Tensor):
        return x.expand(B)
    return torch.full((B,), float(x), dtype=dtype, device=device)


def dot3(a, b):
    return sadd(smul(a[0], b[0]), smul(a[1], b[1]), smul(a[2], b[2]))


def cross3(a, b):
    return [ssub(smul(a[1], b[2]), smul(a[2], b[1])),
            ssub(smul(a[2], b[0]), smul(a[0], b[2])),
            ssub(smul(a[0], b[1]), smul(a[1], b[0]))]


def v3add(a, b):
    return [sadd(a[0], b[0]), sadd(a[1], b[1]), sadd(a[2], b[2])]


def v3sub(a, b):
    return [ssub(a[0], b[0]), ssub(a[1], b[1]), ssub(a[2], b[2])]


def v3scale(s, v):
    return [smul(s, v[0]), smul(s, v[1]), smul(s, v[2])]


def qmul(a, b):
    """Hamilton product of [w, x, y, z] lane lists."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return [
        ssub(smul(aw, bw), sadd(smul(ax, bx), smul(ay, by), smul(az, bz))),
        sadd(smul(aw, bx), smul(ax, bw), ssub(smul(ay, bz), smul(az, by))),
        sadd(smul(aw, by), smul(ay, bw), ssub(smul(az, bx), smul(ax, bz))),
        sadd(smul(aw, bz), smul(az, bw), ssub(smul(ax, by), smul(ay, bx))),
    ]


def qrot(q, v):
    """Rotate v by q: v + 2*(w*(u x v) + u x (u x v))."""
    u = q[1:]
    uv = cross3(u, v)
    uuv = cross3(u, uv)
    return [sadd(v[k], smul(2.0, sadd(smul(q[0], uv[k]), uuv[k])))
            for k in range(3)]


def qmat(q):
    """3x3 rotation matrix (list of rows) of q."""
    w, x, y, z = q
    return [
        [ssub(1.0, smul(2.0, sadd(smul(y, y), smul(z, z)))),
         smul(2.0, ssub(smul(x, y), smul(w, z))),
         smul(2.0, sadd(smul(x, z), smul(w, y)))],
        [smul(2.0, sadd(smul(x, y), smul(w, z))),
         ssub(1.0, smul(2.0, sadd(smul(x, x), smul(z, z)))),
         smul(2.0, ssub(smul(y, z), smul(w, x)))],
        [smul(2.0, ssub(smul(x, z), smul(w, y))),
         smul(2.0, sadd(smul(y, z), smul(w, x))),
         ssub(1.0, smul(2.0, sadd(smul(x, x), smul(y, y))))],
    ]
