"""Vector math over trailing-dim-3 tensors.

Counterpart of `vision_tpu/core/math.py`: every op is vectorized over an
arbitrary leading batch shape with a trailing component axis.
"""
from __future__ import annotations

import torch

Pi = 3.14159265358979323846
InvPi = 1.0 / Pi
Inv2Pi = 1.0 / (2.0 * Pi)
Inv4Pi = 1.0 / (4.0 * Pi)
TwoPi = 2.0 * Pi
# float32(1) - eps/2, as the JAX package computes it
OneMinusEpsilon = 0.99999994039535522


def vec3(x, y, z):
    return torch.stack([x, y, z], dim=-1)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def dotv(a, b):
    """dot with kept trailing axis (for broadcasting against vectors)."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length_squared(a):
    return dot(a, a)


def normalize(a, eps=1e-20):
    return a * torch.rsqrt(torch.clamp_min(length_squared(a), eps))[..., None]


def sqr(x):
    return x * x


def safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 1e-20))


class _Sqrt0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return torch.where(y > 0.0, g / (2.0 * y), 0.0)


def sqrt0(x):
    """sqrt(x) whose gradient at x = 0 is 0 instead of inf: where a select
    drops the root's result at 0, the unselected branch's 0 * inf would
    make the gradient NaN. The same single op when no gradient is taken."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Sqrt0.apply(x)
    return torch.sqrt(x)


class _Asin0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.arcsin(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        inside = torch.abs(x) < 1.0
        return torch.where(inside, g * torch.rsqrt(
            torch.where(inside, 1.0 - x * x, 1.0)), 0.0)


def asin0(x):
    """arcsin(x) whose gradient at |x| = 1 is 0 instead of inf (see
    `sqrt0`)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Asin0.apply(x)
    return torch.arcsin(x)


class _Clip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        lo, hi = ctx.bounds
        w = torch.where((x > lo) & (x < hi), 1.0,
                        torch.where((x == lo) | (x == hi), 0.5, 0.0))
        return g * w, None, None


def clip(x, lo, hi):
    """clamp(x, lo, hi) with the JAX package's gradient (`jnp.clip`, a
    maximum then a minimum): 1 inside, 1/2 at a bound, 0 outside, where
    torch's clamp passes 1 at a bound. The same single op when no
    gradient is taken."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Clip.apply(x, lo, hi)
    return torch.clamp(x, lo, hi)


def safe_div(a, b, eps=0.0):
    """a/b with `eps` where b == 0 (renderer convention for degenerate pdfs)."""
    nz = b != 0.0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)), eps)


def safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def lerp(t, a, b):
    return a + t * (b - a)


def sign_of(x):
    return torch.where(x >= 0.0, 1.0, -1.0)


def luminance(rgb):
    """Rec.709 luminance of linear RGB."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169


def face_forward(v, ref):
    """Flip v so it lies in the hemisphere of ref."""
    return torch.where(dotv(v, ref) < 0.0, -v, v)


def reflect(wo, n):
    """Mirror reflection: -wo + 2 dot(wo, n) n (wo points away)."""
    return -wo + 2.0 * dotv(wo, n) * n


def refract(wi, n, eta):
    """Refraction of wi about n with relative IOR eta. Returns (valid, wt)."""
    cos_theta_i = dot(n, wi)
    sin2_theta_i = torch.clamp_min(1.0 - sqr(cos_theta_i), 0.0)
    sin2_theta_t = sin2_theta_i / sqr(eta)
    valid = sin2_theta_t < 1.0
    cos_theta_t = safe_sqrt(1.0 - sin2_theta_t)
    wt = -wi / eta[..., None] + (cos_theta_i / eta - cos_theta_t)[..., None] * n
    return valid, wt


def spherical_theta(v):
    return safe_acos(v[..., 2])


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + TwoPi, p)


def coordinate_system(n):
    """(t, b) orthonormal to unit n: Duff et al. branchless ONB."""
    s = sign_of(n[..., 2])
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = vec3(1.0 + s * sqr(n[..., 0]) * a, s * b, -s * n[..., 0])
    bt = vec3(b, s + sqr(n[..., 1]) * a, -n[..., 1])
    return t, bt


def to_local(t, b, n, v):
    """World -> local (z = n)."""
    return vec3(dot(v, t), dot(v, b), dot(v, n))


def to_world(t, b, n, v):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


# local-frame trig helpers (z-up shading space)

def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def cos2_theta(w):
    return sqr(w[..., 2])


def sin2_theta(w):
    return torch.clamp_min(1.0 - cos2_theta(w), 0.0)


def sin_theta(w):
    return sqrt0(sin2_theta(w))


def tan2_theta(w):
    return safe_div(sin2_theta(w), cos2_theta(w))


def cos_phi(w):
    st = sin_theta(w)
    z = st == 0.0
    return torch.where(z, 1.0, torch.clamp(
        w[..., 0] / torch.where(z, torch.ones_like(st), st), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    z = st == 0.0
    return torch.where(z, 0.0, torch.clamp(
        w[..., 1] / torch.where(z, torch.ones_like(st), st), -1.0, 1.0))


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0
