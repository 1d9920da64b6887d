"""The robust epipolar residual: kernel K3 and its backward.

Replaces `deepfepe_tpu/ops/pallas/epi_residual_pallas.py`
(`epi_residual_pallas`) and computes `compute_epi_residual` of
`deepfepe_tpu/geometry/epipolar.py`: per correspondence
    d = |x2ᵀFx1| · (1/(‖(Fx1)_xy‖+eps) + 1/(‖(Fᵀx2)_xy‖+eps)),
clamped at `clamp_at`, on homogeneous points [..., N, 3] and F [..., 3, 3].

`epi_residual` routes by device: CPU tensors take the plain version,
`epi_residual_ref` (differentiated by autograd); CUDA float32 tensors take
the kernel through the `EpiResidual` autograd Function, whose backward is a
kernel too (`csrc/epi_residual.cu`); other CUDA tensors raise. The kernels
work on points [P, N, 3] and matrices [P, M, 9]: `Layout` maps each
caller's broadcast onto that without expanding the points (DeepFNet: [B, N,
3] with [B, 3, 3]; the F-loss: [1, B, V, 3] with [L, B, 3, 3]; the sample
loss: [1, B, 1, V, 3] with [L, B, S, 3, 3]). The backward has the plain
version's semantics: no gradient through a norm that is exactly 0 (as
`geometry.basic.safe_norm`), none through |s| at s = 0, and the clamp
passes it where d <= clamp_at. The points' gradients are computed only
when autograd asks for them (learned offsets).

`epi_residual.launches` counts forward launches; `epi_residual_bwd.launches`
backward calls that launched a kernel, and `epi_residual_bwd.point_launches`
those that launched the points' gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ..geometry.basic import safe_norm
from ..utils import build

SOURCE = "epi_residual.cu"
MAX_GRID = 65535  # the kernels' grid y (P) and z (M / 64) limits
MATRICES_PER_TILE = 64

_lib = None


def epi_residual_ref(pts1_h, pts2_h, F, clamp_at: float = 0.5, eps: float = 1e-6):
    """Plain version on any broadcast of points [..., N, 3] and F [..., 3, 3]."""
    Fx1 = pts1_h @ F.transpose(-1, -2)  # rows (F x1)ᵀ: lines in image 2
    Ftx2 = pts2_h @ F                   # rows (Fᵀ x2)ᵀ: lines in image 1
    s = torch.sum(pts2_h * Fx1, dim=-1)
    n1 = safe_norm(Fx1[..., :2], dim=-1)
    n2 = safe_norm(Ftx2[..., :2], dim=-1)
    d = torch.abs(s) * (1.0 / (n1 + eps) + 1.0 / (n2 + eps))
    return torch.clamp(d, max=clamp_at)


def epi_residual_bwd_ref(pts1, pts2, F9, g, clamp_at: float, eps: float):
    """Plain version of the backward kernels in their layout: points [P, N,
    3], F9 [P, M, 9], cotangent g [P, M, N] -> (dF9 [P, M, 9], dpts1,
    dpts2 [P, N, 3]), with the kernels' formulas."""
    P, M = F9.shape[:2]
    F = F9.reshape(P, M, 3, 3)
    x1, x2 = pts1[:, None], pts2[:, None]  # [P, 1, N, 3]
    l1 = x1 @ F.transpose(-1, -2)          # F x1, [P, M, N, 3]
    l2 = x2 @ F                            # Fᵀ x2
    s = torch.sum(x2 * l1, dim=-1)
    n1, n2 = safe_norm(l1[..., :2], dim=-1), safe_norm(l2[..., :2], dim=-1)
    r1, r2 = 1.0 / (n1 + eps), 1.0 / (n2 + eps)
    gd = torch.where(s.abs() * (r1 + r2) <= clamp_at, g, torch.zeros_like(g))
    gs = gd * torch.sign(s) * (r1 + r2)
    zero = torch.zeros_like(s)
    u1 = torch.where(n1 > 0, -gd * s.abs() * r1 * r1 / torch.where(n1 > 0, n1, 1.0), zero)
    u2 = torch.where(n2 > 0, -gd * s.abs() * r2 * r2 / torch.where(n2 > 0, n2, 1.0), zero)
    gl1 = gs[..., None] * x2 + torch.stack([u1 * l1[..., 0], u1 * l1[..., 1], zero], dim=-1)
    gl2 = torch.stack([u2 * l2[..., 0], u2 * l2[..., 1], zero], dim=-1)
    dF = (gl1[..., :, None] * x1[..., None, :] + x2[..., :, None] * gl2[..., None, :]).sum(-3)
    dpts1 = (gl1 @ F).sum(1)
    dpts2 = (gs[..., None] * l1 + gl2 @ F.transpose(-1, -2)).sum(1)
    return dF.reshape(P, M, 9), dpts1, dpts2


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.epi_residual_f32.argtypes = [P, P, P, P, I, I, I, Fl, Fl, P]
    lib.epi_residual_f32.restype = ctypes.c_int
    lib.epi_residual_bwd_f32.argtypes = [P, P, P, P, P, P, P, I, I, I, Fl, Fl, P]
    lib.epi_residual_bwd_f32.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def _check(*ts):
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError(f"the K3 kernels take CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ts):
        raise ValueError(f"the K3 kernels take contiguous float32 tensors, got "
                         f"{[t.dtype for t in ts]}")
    P, M = ts[2].shape[:2]
    if P > MAX_GRID or -(-M // MATRICES_PER_TILE) > MAX_GRID:
        raise ValueError(f"the K3 kernels take P <= {MAX_GRID} items and M <= "
                         f"{MAX_GRID * MATRICES_PER_TILE} matrices, got P = {P}, M = {M}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def epi_residual_fwd(pts1, pts2, F9, clamp_at: float, eps: float) -> torch.Tensor:
    """Points [P, N, 3], F9 [P, M, 9] -> residuals [P, M, N]: K3 on CUDA
    tensors, the plain version on CPU tensors."""
    P, M = F9.shape[:2]
    N = pts1.shape[1]
    if pts1.device.type == "cpu":
        return epi_residual_ref(pts1[:, None], pts2[:, None], F9.reshape(P, M, 3, 3), clamp_at,
                                eps)
    _check(pts1, pts2, F9)
    out = torch.empty((P, M, N), dtype=torch.float32, device=pts1.device)
    with torch.cuda.device(pts1.device):
        rc = _load().epi_residual_f32(pts1.data_ptr(), pts2.data_ptr(), F9.data_ptr(),
                                      out.data_ptr(), P, M, N, clamp_at, eps, _stream(pts1))
    if rc != 0:
        raise RuntimeError(f"K3 kernel launch failed: cudaError {rc}")
    epi_residual.launches += 1
    return out


def epi_residual_bwd(pts1, pts2, F9, g, clamp_at: float, eps: float, need_F: bool = True,
                     need_pts1: bool = True, need_pts2: bool = True):
    """(dF9 [P, M, 9], dpts1, dpts2 [P, N, 3]) for the cotangent g [P, M,
    N], each None unless asked for: K3's backward kernels on CUDA tensors
    (dF by a fixed-order reduction, the points' gradients in one more
    launch), the plain version on CPU tensors."""
    if pts1.device.type == "cpu":
        dF, d1, d2 = epi_residual_bwd_ref(pts1, pts2, F9, g, clamp_at, eps)
        return dF if need_F else None, d1 if need_pts1 else None, d2 if need_pts2 else None
    _check(pts1, pts2, F9, g)
    P, M = F9.shape[:2]
    N = pts1.shape[1]
    dF = torch.empty_like(F9) if need_F else None
    d1 = torch.empty_like(pts1) if need_pts1 else None
    d2 = torch.empty_like(pts2) if need_pts2 else None
    if not (need_F or need_pts1 or need_pts2):
        return dF, d1, d2
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(pts1.device):
        rc = _load().epi_residual_bwd_f32(pts1.data_ptr(), pts2.data_ptr(), F9.data_ptr(),
                                          g.data_ptr(), ptr(dF), ptr(d1), ptr(d2), P, M, N,
                                          clamp_at, eps, _stream(pts1))
    if rc != 0:
        raise RuntimeError(f"K3 backward kernel launch failed: cudaError {rc}")
    epi_residual_bwd.launches += 1
    if need_pts1 or need_pts2:
        epi_residual_bwd.point_launches += 1
    return dF, d1, d2


epi_residual_bwd.launches = 0
epi_residual_bwd.point_launches = 0


class Layout:
    """Where the broadcast of points [..., N, 3] against F [..., 3, 3] puts
    each batch axis: on P when the points have it (F must have it too), on
    M when only F has it. Raises for other patterns (F broadcast over
    points, or the two point sets of different shapes)."""

    def __init__(self, pts1, pts2, F):
        if pts1.shape != pts2.shape or pts1.shape[-1] != 3 or F.shape[-2:] != (3, 3):
            raise ValueError(f"K3 takes two point sets [..., N, 3] of one shape and F "
                             f"[..., 3, 3], got {tuple(pts1.shape)}, {tuple(pts2.shape)}, "
                             f"{tuple(F.shape)}")
        nb = max(pts1.dim(), F.dim()) - 2
        ps = (1,) * (nb - pts1.dim() + 2) + tuple(pts1.shape[:-2])
        fs = (1,) * (nb - F.dim() + 2) + tuple(F.shape[:-2])
        p_axes, m_axes = [], []
        for i, (a, b) in enumerate(zip(ps, fs)):
            if a == b:
                p_axes.append(i)
            elif a == 1:
                m_axes.append(i)
            else:
                raise ValueError(f"K3 takes F with every batch axis of the points, got points "
                                 f"{tuple(pts1.shape)} and F {tuple(F.shape)}")
        self.pts_shape, self.F_shape = tuple(pts1.shape), tuple(F.shape)
        self.fs, self.nb, self.N = fs, nb, pts1.shape[-2]
        self.order = p_axes + m_axes
        self.inverse = [self.order.index(i) for i in range(nb)]
        self.lead = tuple(fs[i] for i in self.order)  # [P axes..., M axes...]
        self.P = 1
        for i in p_axes:
            self.P *= fs[i]
        self.M = 1
        for i in m_axes:
            self.M *= fs[i]

    def points(self, pts):
        return pts.reshape(self.P, self.N, 3).contiguous()

    def matrices(self, F):
        Fb = F.reshape(self.fs + (3, 3)).permute(*self.order, self.nb, self.nb + 1)
        return Fb.reshape(self.P, self.M, 9).contiguous()

    def residual(self, out):
        """[P, M, N] -> the broadcast shape [..., N] (a permuted view)."""
        return out.reshape(self.lead + (self.N,)).permute(*self.inverse, self.nb)

    def cotangent(self, g):
        """The broadcast shape's cotangent -> [P, M, N], contiguous."""
        return g.permute(*self.order, self.nb).reshape(self.P, self.M, self.N).contiguous()

    def F_grad(self, dF9):
        dF = dF9.reshape(self.lead + (3, 3)).permute(*self.inverse, self.nb, self.nb + 1)
        return dF.reshape(self.F_shape)

    def points_grad(self, d):
        return d.reshape(self.pts_shape)


class EpiResidual(torch.autograd.Function):
    """K3 forward, K3 backward; inputs (pts1_h, pts2_h, F, clamp_at, eps).
    On CPU tensors it runs the kernels' plain versions in their layout (the
    tests use that to check the layout and the backward's formulas)."""

    @staticmethod
    def forward(ctx, pts1_h, pts2_h, F, clamp_at, eps):
        lay = Layout(pts1_h, pts2_h, F)
        p1, p2, F9 = lay.points(pts1_h), lay.points(pts2_h), lay.matrices(F)
        out = epi_residual_fwd(p1, p2, F9, clamp_at, eps)
        ctx.save_for_backward(p1, p2, F9)
        ctx.lay, ctx.clamp_at, ctx.eps = lay, clamp_at, eps
        return lay.residual(out)

    @staticmethod
    def backward(ctx, g):
        p1, p2, F9 = ctx.saved_tensors
        lay = ctx.lay
        n1, n2, nF = ctx.needs_input_grad[:3]
        dF, d1, d2 = epi_residual_bwd(p1, p2, F9, lay.cotangent(g), ctx.clamp_at, ctx.eps,
                                      nF, n1, n2)
        return (lay.points_grad(d1) if n1 else None, lay.points_grad(d2) if n2 else None,
                lay.F_grad(dF) if nF else None, None, None)


def epi_residual(pts1_h, pts2_h, F, clamp_at: float = 0.5, eps: float = 1e-6):
    """The clamped residual [..., N] of points [..., N, 3] against F [...,
    3, 3], differentiable in all three. CPU tensors take the plain version;
    CUDA float32 tensors launch K3 (and its backward); others raise."""
    ts = (pts1_h, pts2_h, F)
    if all(t.device.type == "cpu" for t in ts):
        return epi_residual_ref(pts1_h, pts2_h, F, clamp_at, eps)
    if not all(t.is_cuda for t in ts) or any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"the K3 kernels take CUDA float32 tensors, got "
                         f"{[(t.dtype, str(t.device)) for t in ts]}")
    return EpiResidual.apply(pts1_h, pts2_h, F, float(clamp_at), float(eps))


epi_residual.launches = 0
