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
index each item's M matrices against its N points as [P, M_hi, M_lo, N].
`Layout` maps each caller's broadcast onto that as element strides of
every tensor (DeepFNet: [B, N, 3] with [B, 3, 3]; the F-loss: [1, B, V, 3]
with [L, B, 3, 3]; the sample loss: [1, B, 1, V, 3] with [L, B, S, 3, 3]),
so nothing is copied or expanded: the kernels read the points, F and the
cotangent where the caller left them, write the residual contiguous in
the broadcast shape and dF in F's shape. A forward call is one device
operation, a backward call one (the points' gradients included). On CPU
tensors the Function runs the plain versions on the same strided views
(`torch.as_strided`), which is how the tests check the strides. The
backward has the plain version's semantics: no gradient through a norm
that is exactly 0 (as `geometry.basic.safe_norm`), none through |s| at s =
0, and the clamp passes it where d <= clamp_at. The points' gradients are
computed only when autograd asks for them (learned offsets).

`epi_residual.launches` counts forward launches; `epi_residual_bwd.launches`
backward launches, and `epi_residual_bwd.point_launches` those that also
computed the points' gradients.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..geometry.basic import safe_norm
from ..utils import build

SOURCE = "epi_residual.cu"
MAX_WORK = 2**31 - 1  # residuals a call: the kernels index the (p, m, n) work in 32 bits
GEO = 22              # long longs of a call's geometry (csrc/epi_residual.cu `Geo`)

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
    """Plain version of the backward kernel in its layout: points [P, N,
    3], F9 [P, M, 9], cotangent g [P, M, N] -> (dF9 [P, M, 9], dpts1,
    dpts2 [P, N, 3]), with the kernel's formulas."""
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
    P, Fl = ctypes.c_void_p, ctypes.c_float
    lib.epi_residual_f32.argtypes = [P, P, P, P, P, Fl, Fl, P]
    lib.epi_residual_f32.restype = ctypes.c_int
    lib.epi_residual_bwd_f32.argtypes = [P, P, P, P, P, P, P, P, Fl, Fl, P]
    lib.epi_residual_bwd_f32.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build.load(SOURCE))
    return _lib


def _contiguous_strides(shape) -> tuple:
    strides, step = [], 1
    for size in reversed(shape):
        strides.append(step)
        step *= size
    return tuple(reversed(strides))


def _fits(run, sizes, strides) -> bool:
    """Whether `strides` address the axes of `run` (in order) as one axis."""
    return all(strides[a] == strides[b] * sizes[b] for a, b in zip(run, run[1:]))


def _runs(axes, sizes, strides_of) -> list:
    """`axes` (in order, each of size > 1) cut into runs that every tensor
    of `strides_of` addresses as one axis."""
    runs = []
    for i in axes:
        if runs and all(_fits([runs[-1][-1], i], sizes, st) for st in strides_of):
            runs[-1].append(i)
        else:
            runs.append([i])
    return runs


class Layout:
    """Where the broadcast of points [..., N, 3] against F [..., 3, 3] puts
    each batch axis in the kernels' [P, M_hi, M_lo, N]: on P when the
    points have it (F must have it too), on M when only F has it. The
    axes of each kind are merged into runs that every tensor (the points,
    F, the residual, dF) addresses as one axis; a call takes one P run and
    up to two M runs. Raises for other patterns (F broadcast over points,
    the two point sets of different shapes, more runs than that, more than
    MAX_WORK residuals). Built from shapes and strides alone: `layout`
    keeps one a pattern."""

    def __init__(self, pts_shape, pts1_stride, pts2_shape, pts2_stride, F_shape, F_stride):
        if pts_shape != pts2_shape or pts_shape[-1] != 3 or F_shape[-2:] != (3, 3):
            raise ValueError(f"K3 takes two point sets [..., N, 3] of one shape and F "
                             f"[..., 3, 3], got {tuple(pts_shape)}, {tuple(pts2_shape)}, "
                             f"{tuple(F_shape)}")
        nb = max(len(pts_shape), len(F_shape)) - 2
        ps = (1,) * (nb - len(pts_shape) + 2) + tuple(pts_shape[:-2])
        fs = (1,) * (nb - len(F_shape) + 2) + tuple(F_shape[:-2])
        p_axes, m_axes = [], []
        for i, (a, b) in enumerate(zip(ps, fs)):
            if a != b and a != 1:
                raise ValueError(f"K3 takes F with every batch axis of the points, got points "
                                 f"{tuple(pts_shape)} and F {tuple(F_shape)}")
            if b > 1:
                (p_axes if a == b else m_axes).append(i)
        N = pts_shape[-2]
        self.N, self.pts_shape, self.F_shape = N, tuple(pts_shape), tuple(F_shape)
        self.out_shape = fs + (N,)  # the broadcast shape of the residual
        pad = lambda st, n: (0,) * (nb + 2 - n) + tuple(st)  # noqa: E731
        st_1, st_2 = pad(pts1_stride, len(pts_shape)), pad(pts2_stride, len(pts_shape))
        st_F = pad(F_stride, len(F_shape))
        st_out = _contiguous_strides(self.out_shape)
        st_dF = _contiguous_strides(fs + (3, 3))
        p_runs = _runs(p_axes, fs, (st_F, st_out, st_dF, st_1, st_2))
        m_runs = _runs(m_axes, fs, (st_F, st_out, st_dF))
        if len(p_runs) > 1 or len(m_runs) > 2:
            raise ValueError(f"K3 addresses one run of item axes and two of matrix axes by "
                             f"strides; points {tuple(pts_shape)} {tuple(pts1_stride)} and F "
                             f"{tuple(F_shape)} {tuple(F_stride)} need {len(p_runs)} and "
                             f"{len(m_runs)}")
        # [P run, M_hi run, M_lo run]; an absent run is an axis of size 1.
        self.runs = p_runs + [[]] * (3 - len(p_runs) - len(m_runs)) + m_runs
        self.P, self.MH, self.ML = (math.prod(fs[i] for i in r) for r in self.runs)
        self.M = self.MH * self.ML
        if self.P * self.M * N > MAX_WORK:
            raise ValueError(f"K3 takes at most {MAX_WORK} residuals a call, got P = {self.P}, "
                             f"M = {self.M}, N = {N}")
        self._fs = fs
        run_strides = lambda st: tuple(st[r[-1]] if r else 0 for r in self.runs)  # noqa: E731
        self.p1 = (run_strides(st_1)[0], pts1_stride[-2], pts1_stride[-1])
        self.p2 = (run_strides(st_2)[0], pts2_stride[-2], pts2_stride[-1])
        self.f = run_strides(st_F) + (F_stride[-2], F_stride[-1])
        self.o = run_strides(st_out) + (1,)
        self.d = run_strides(st_dF)
        self.geo = self._geo(self.o)
        self._cotangents = {}

    def _geo(self, o) -> tuple:
        """The C interface's geometry (csrc/epi_residual.cu `Geo`) with `o`
        as the residual's or the cotangent's strides: the array and its
        address."""
        arr = (ctypes.c_longlong * GEO)(self.P, self.MH, self.ML, self.N, *self.p1, *self.p2,
                                        *self.f, *o, *self.d)
        return arr, ctypes.addressof(arr)

    def cotangent_strides(self, g_stride) -> tuple | None:
        """The cotangent's strides in the kernels' [P, M_hi, M_lo, N], None
        when its strides do not address the runs."""
        if not all(_fits(r, self._fs, g_stride) for r in self.runs):
            return None
        return tuple(g_stride[r[-1]] if r else 0 for r in self.runs) + (g_stride[-1],)

    def cotangent(self, g):
        """(g, the backward's geometry, g's strides): g as it is where its
        strides address the runs (autograd hands back the residual's
        contiguous layout), else its contiguous copy."""
        key = g.stride()
        hit = self._cotangents.get(key)
        if hit is None:
            o = self.cotangent_strides(key)
            hit = self._cotangents[key] = (o is not None, *(self._geo(o) if o else self.geo),
                                           o or self.o)
        fits, arr, addr, o = hit
        return (g if fits else g.contiguous()), addr, o

    # Views of the kernels' index space, for the CPU route and the tests.
    def points(self, pts, strides):
        return pts.as_strided((self.P, self.N, 3), strides, pts.storage_offset())

    def matrices(self, F):
        """F as the kernel reads it, [P, M_hi, M_lo, 3, 3]: a view of F's
        storage, no copy."""
        return F.as_strided((self.P, self.MH, self.ML, 3, 3), self.f, F.storage_offset())

    def rows(self, t, strides):
        """The residual or its cotangent as [P, M_hi, M_lo, N] (a view)."""
        return t.as_strided((self.P, self.MH, self.ML, self.N), strides, t.storage_offset())

    def F_grad_rows(self, dF):
        """dF (F's shape, contiguous) as [P, M_hi, M_lo, 3, 3] (a view)."""
        return dF.as_strided((self.P, self.MH, self.ML, 3, 3), self.d + (3, 1))


@functools.lru_cache(maxsize=256)
def _layout(*key) -> Layout:
    return Layout(*key)


def layout(pts1, pts2, F) -> Layout:
    """The Layout of this pattern of shapes and strides (one a pattern)."""
    return _layout(pts1.shape, pts1.stride(), pts2.shape, pts2.stride(), F.shape, F.stride())


def _check(*ts):
    dev = ts[0].device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"the K3 kernels take CUDA tensors on one device, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"the K3 kernels take float32 tensors, got {[t.dtype for t in ts]}")


def _launch(dev: torch.device, fn, *args) -> None:
    """fn(*args, stream) on dev's current stream, entering dev only when it
    is not the current device; raises on a nonzero cudaError."""
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3 kernel launch failed: cudaError {rc}")


def forward(lay: Layout, pts1, pts2, F, clamp_at: float, eps: float) -> torch.Tensor:
    """The residual in the broadcast shape, contiguous: K3 on CUDA tensors,
    the plain version on the Layout's views of CPU tensors."""
    if F.device.type == "cpu":
        res = epi_residual_ref(lay.points(pts1, lay.p1)[:, None, None],
                               lay.points(pts2, lay.p2)[:, None, None], lay.matrices(F),
                               clamp_at, eps)
        out = res.new_empty(lay.out_shape)
        lay.rows(out, lay.o).copy_(res)
        return out
    _check(pts1, pts2, F)
    out = torch.empty(lay.out_shape, dtype=torch.float32, device=F.device)
    _launch(F.device, _load().epi_residual_f32, pts1.data_ptr(), pts2.data_ptr(), F.data_ptr(),
            out.data_ptr(), lay.geo[1], clamp_at, eps)
    epi_residual.launches += 1
    return out


def backward(lay: Layout, pts1, pts2, F, g, clamp_at: float, eps: float, need_F: bool = True,
             need_pts1: bool = True, need_pts2: bool = True):
    """(dF in F's shape, dpts1, dpts2 in the points' shape) for the
    residual's cotangent g, each None unless asked for: one launch of K3's
    backward on CUDA tensors (dF's sums over the points and the points'
    over the matrices in fixed-order cluster reductions), the plain
    version on the Layout's views of CPU tensors."""
    g, geo, o = lay.cotangent(g)
    if F.device.type == "cpu":
        P, M, N = lay.P, lay.M, lay.N
        dF9, d1, d2 = epi_residual_bwd_ref(
            lay.points(pts1, lay.p1), lay.points(pts2, lay.p2),
            lay.matrices(F).reshape(P, M, 9), lay.rows(g, o).reshape(P, M, N), clamp_at, eps)
        dF = dp1 = dp2 = None
        if need_F:
            dF = dF9.new_empty(lay.F_shape)
            lay.F_grad_rows(dF).copy_(dF9.view(lay.P, lay.MH, lay.ML, 3, 3))
        if need_pts1:
            dp1 = d1.reshape(lay.pts_shape)
        if need_pts2:
            dp2 = d2.reshape(lay.pts_shape)
        return dF, dp1, dp2
    _check(pts1, pts2, F, g)
    dF = torch.empty(lay.F_shape, dtype=torch.float32, device=F.device) if need_F else None
    dp1, dp2 = (torch.empty(lay.pts_shape, dtype=torch.float32, device=F.device) if need
                else None for need in (need_pts1, need_pts2))
    if not (need_F or need_pts1 or need_pts2):
        return dF, dp1, dp2
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _launch(F.device, _load().epi_residual_bwd_f32, pts1.data_ptr(), pts2.data_ptr(),
            F.data_ptr(), g.data_ptr(), ptr(dF), ptr(dp1), ptr(dp2), geo, clamp_at, eps)
    epi_residual_bwd.launches += 1
    if need_pts1 or need_pts2:
        epi_residual_bwd.point_launches += 1
    return dF, dp1, dp2


def _kernel_layout(pts1, pts2, F9):
    """Points [P, N, 3] and F9 [P, M, 9] as one item's matrices against its
    points: ([P, 1, N, 3] views, F [P, M, 3, 3] view, their Layout)."""
    P, M = F9.shape[:2]
    a, b, F = pts1[:, None], pts2[:, None], F9.view(P, M, 3, 3)
    return a, b, F, layout(a, b, F)


def epi_residual_fwd(pts1, pts2, F9, clamp_at: float, eps: float) -> torch.Tensor:
    """Points [P, N, 3], F9 [P, M, 9] -> residuals [P, M, N]: K3 on CUDA
    tensors, the plain version on CPU tensors."""
    a, b, F, lay = _kernel_layout(pts1, pts2, F9)
    return forward(lay, a, b, F, clamp_at, eps)


def epi_residual_bwd(pts1, pts2, F9, g, clamp_at: float, eps: float, need_F: bool = True,
                     need_pts1: bool = True, need_pts2: bool = True):
    """(dF9 [P, M, 9], dpts1, dpts2 [P, N, 3]) for the cotangent g [P, M,
    N], each None unless asked for: K3's backward on CUDA tensors (one
    launch), the plain version on CPU tensors."""
    a, b, F, lay = _kernel_layout(pts1, pts2, F9)
    dF, d1, d2 = backward(lay, a, b, F, g, clamp_at, eps, need_F, need_pts1, need_pts2)
    return (None if dF is None else dF.view(F9.shape), None if d1 is None else d1.view(pts1.shape),
            None if d2 is None else d2.view(pts2.shape))


epi_residual_bwd.launches = 0
epi_residual_bwd.point_launches = 0


class EpiResidual(torch.autograd.Function):
    """K3 forward, K3 backward; inputs (pts1_h, pts2_h, F, clamp_at, eps).
    On CPU tensors it runs the kernels' plain versions on the Layout's
    strided views (the tests use that to check the Layout and the
    backward's formulas)."""

    @staticmethod
    def forward(ctx, pts1_h, pts2_h, F, clamp_at, eps):
        lay = layout(pts1_h, pts2_h, F)
        ctx.save_for_backward(pts1_h, pts2_h, F)
        ctx.lay, ctx.clamp_at, ctx.eps = lay, clamp_at, eps
        return forward(lay, pts1_h, pts2_h, F, clamp_at, eps)

    @staticmethod
    def backward(ctx, g):
        p1, p2, F = ctx.saved_tensors
        n1, n2, nF = ctx.needs_input_grad[:3]
        dF, d1, d2 = backward(ctx.lay, p1, p2, F, g, ctx.clamp_at, ctx.eps, nF, n1, n2)
        return d1, d2, dF, None, None


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
