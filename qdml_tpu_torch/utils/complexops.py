"""Complex values as real ``(re, im)`` tensor pairs (``qdml_tpu/utils/complexops.py``).

The JAX package carries complex numbers as its ``CArr`` real pair because the
TPU backend has no complex64; the port keeps the same representation so that
every function compares like with like against the reference, and the CUDA
kernels read and write plain float32 buffers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CArr(NamedTuple):
    """A complex tensor as its real and imaginary float32 parts."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.re.shape

    def abs2(self) -> torch.Tensor:
        return self.re * self.re + self.im * self.im

    def reshape(self, *shape) -> "CArr":
        return CArr(self.re.reshape(*shape), self.im.reshape(*shape))


def ceinsum(spec: str, a: CArr, b: CArr) -> CArr:
    """Complex einsum over CArr operands via four real einsums."""
    rr = torch.einsum(spec, a.re, b.re)
    ii = torch.einsum(spec, a.im, b.im)
    ri = torch.einsum(spec, a.re, b.im)
    ir = torch.einsum(spec, a.im, b.re)
    return CArr(rr - ii, ri + ir)


def ckron(a: CArr, b: CArr) -> CArr:
    """Complex Kronecker product of 2-D CArrs: (p,q) x (r,s) -> (pr, qs)."""
    out = ceinsum("ij,kl->ikjl", a, b)
    p, q = a.shape
    r, s = b.shape
    return out.reshape(p * r, q * s)


def pack_h(h: CArr) -> torch.Tensor:
    """Flat complex channel ``(..., h_dim)`` -> real target ``(..., 2*h_dim)``,
    real half first (reference ``cat([real, imag], dim=1)``)."""
    return torch.cat([h.re, h.im], dim=-1)


def unpack_h(h2: torch.Tensor) -> CArr:
    """Inverse of :func:`pack_h`."""
    d = h2.shape[-1] // 2
    return CArr(h2[..., :d], h2[..., d:])


def yp_to_image(yp: CArr, n_sub: int = 16, n_beam: int = 8) -> torch.Tensor:
    """Flat beam-major complex pilots ``(..., n_beam*n_sub)`` -> NHWC image
    ``(..., n_sub, n_beam, 2)`` with re/im as the trailing channel, the JAX
    package's request layout (the models permute to NCHW themselves)."""
    lead = yp.re.shape[:-1]
    re = yp.re.reshape(lead + (n_beam, n_sub))
    im = yp.im.reshape(lead + (n_beam, n_sub))
    img = torch.stack([re, im], dim=-1)  # (..., n_beam, n_sub, 2)
    return img.transpose(-2, -3)  # (..., n_sub, n_beam, 2)


def cexp_i(theta: torch.Tensor) -> CArr:
    """``exp(i * theta)`` for real theta."""
    return CArr(torch.cos(theta), torch.sin(theta))


def cexp_i_ramp(theta: torch.Tensor, n: int, split: int | None = None) -> CArr:
    """``exp(i * theta[..., None] * arange(n))`` from ``split + ceil(n /
    split)`` sin/cos pairs per theta element instead of n
    (``qdml_tpu/utils/complexops.py:180-209``): the ramp index factors as
    ``k = a + split * b`` and ``e^{i theta k} = e^{i theta a} e^{i theta
    split b}``, one complex outer product. Exact to float32 rounding, with
    no recurrence error. ``split`` defaults to the divisor of n nearest
    below ``round(sqrt(n))``, so no tail is sliced off."""
    if split is None:
        split = max(1, int(round(n**0.5)))
        while n % split:  # prefer a divisor of n: no tail slice needed
            split -= 1
    n_hi = -(-n // split)
    a = torch.arange(split, dtype=theta.dtype, device=theta.device)
    b = torch.arange(n_hi, dtype=theta.dtype, device=theta.device) * split
    lo = cexp_i(theta[..., None] * a)  # (..., split)
    hi = cexp_i(theta[..., None] * b)  # (..., n_hi)
    out = CArr(
        hi.re[..., :, None] * lo.re[..., None, :] - hi.im[..., :, None] * lo.im[..., None, :],
        hi.re[..., :, None] * lo.im[..., None, :] + hi.im[..., :, None] * lo.re[..., None, :],
    ).reshape(*theta.shape, n_hi * split)
    return CArr(out.re[..., :n], out.im[..., :n]) if n_hi * split != n else out
