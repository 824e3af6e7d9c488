"""What the field kernels' wrappers share: the field ``(points, dirs) ->
(rgb, sigma)`` of one model through a forward and a backward kernel.

A family's wrapper (``NerfField``, ``SirenField``, ``GaborField``) subclasses
``FusedField`` and says how its model packs (``params_f32``: the float32
tensors, differentiable in the model's parameters; ``cast``: the packing as
the kernels read it), which shapes its kernels cover (``supported``), and
how its plain versions run and its kernels launch. On CPU tensors a wrapper
runs the plain versions; on CUDA tensors it launches the kernels or raises.
It never falls back from one to the other. Under autograd (the model's
parameters, or the points or directions, requiring grad) the field is
differentiable through ``_FieldFn``, whose backward is the backward kernel;
each subclass's ``launches`` and ``bwd_launches`` count its kernels'
launches over all instances. ``fwd_library()`` and ``bwd_library()`` name
the library each launch takes (bfloat16 on the tensor cores where a family
has one).
"""

from __future__ import annotations

import torch


class _FieldFn(torch.autograd.Function):
    """The field as a function of the points, the directions (n, 3) and the
    float32 parameter tensors ``params`` (none for fixed weights), evaluated
    on ``packed``; its backward is the backward kernel (the plain version on
    the CPU), giving them all their cotangents as the TPU kernel's VJP
    does."""

    @staticmethod
    def forward(ctx, field, packed, pts, dirs, *params):
        rgb, sigma = field._forward(packed, pts.detach(), dirs.detach())
        ctx.field, ctx.packed, ctx.n_params = field, packed, len(params)
        ctx.save_for_backward(pts, dirs)
        return rgb, sigma

    @staticmethod
    def backward(ctx, g_rgb, g_sigma):
        pts, dirs = ctx.saved_tensors
        cot = torch.zeros((pts.shape[0], 4), dtype=torch.float32, device=pts.device)
        if g_rgb is not None:
            cot[:, :3] = g_rgb
        if g_sigma is not None:
            cot[:, 3] = g_sigma
        *grads, dpts, ddirs = ctx.field._backward(ctx.packed, pts.detach(),
                                                  dirs.detach(), cot)
        return (None, None, dpts, ddirs, *grads[:ctx.n_params])


class FusedField:
    """The field ``(points (..., 3), dirs (..., 3)) -> (rgb (..., 3), sigma
    (...,))`` of ``model`` through a family's field kernels. ``packed`` fixes
    the weights (a ``cast`` packing, no gradient), as an occupancy bake or a
    distillation teacher wants; otherwise each call packs the model's
    current parameters and, under autograd, gives them, the points and the
    directions their gradients.

    A family defines ``params_f32()`` (the float32 parameter tensors),
    ``cast(*params)`` (their packing as the kernels read it),
    ``supported()`` and ``_unsupported()`` (the kernels' shapes and the
    message outside them), ``_packed_args(packed)`` where its packing is not
    a ``Packed``, and ``_plain_forward`` / ``_plain_backward`` /
    ``_launch_fwd`` / ``_launch_bwd`` (the plain versions and the kernel
    launches, each ``(packed, pts, dirs[, cot])``; the backward returns
    ``(*grads, dpts, ddirs)``, one gradient per parameter tensor, and its
    launch takes ``run`` and ``stash`` as ``_backward`` does)."""

    launches = 0
    bwd_launches = 0
    family = "field"
    plan = None        # a family's shape plan (nerf_plan.py, siren_plan.py, gabor_plan.py)

    def __init__(self, model, packed=None):
        self.model = model
        self.cdt = model.cdt
        self.h = model.hidden_dim
        self.packed = packed

    # -- shared

    def pack(self):
        """This field with the model's current weights packed once."""
        with torch.no_grad():
            return type(self)(self.model, self.cast(*self.params_f32()))

    def __call__(self, points: torch.Tensor, dirs: torch.Tensor):
        shape = points.shape[:-1]
        pts = points.reshape(-1, 3).float()
        drs = dirs.reshape(-1, 3).float()
        train_weights = self.packed is None and any(
            p.requires_grad for p in self.model.parameters())
        if torch.is_grad_enabled() and (pts.requires_grad or drs.requires_grad
                                        or train_weights):
            params = self.params_f32() if train_weights else ()
            packed = self.packed
            if packed is None:
                with torch.no_grad():
                    packed = self.cast(*(p.detach() for p in params))
            rgb, sigma = _FieldFn.apply(self, packed, pts, drs, *params)
        else:
            packed = self.packed
            if packed is None:
                with torch.no_grad():
                    packed = self.cast(*self.params_f32())
            rgb, sigma = self._forward(packed, pts, drs)
        return rgb.reshape(*shape, 3), sigma.reshape(shape)

    def _count(self, counter: str) -> None:
        """One launch more on the class's ``counter`` (``launches`` or
        ``bwd_launches``); a family with a shape ``plan`` also counts it in
        its ``shape_launches`` by ``(counter, plan tag, compute dtype)``."""
        cls = type(self)
        setattr(cls, counter, getattr(cls, counter) + 1)
        if self.plan is not None:
            cls.shape_launches[counter, self.plan.tag, str(self.cdt)[6:]] += 1

    def _route(self, x: torch.Tensor) -> str:
        if x.device.type in ("cpu", "cuda"):
            return x.device.type
        raise ValueError(f"the {self.family} field runs on cuda or cpu, not {x.device}")

    def _forward(self, packed, pts: torch.Tensor, dirs: torch.Tensor):
        if self._route(pts) == "cpu":
            return self._plain_forward(packed, pts, dirs)
        return self._launch_fwd(packed, pts, dirs)

    def _backward(self, packed, pts: torch.Tensor, dirs: torch.Tensor,
                  cot: torch.Tensor, run: int | None = None, stash: dict | None = None):
        """``(*grads, dpts, ddirs)``: the float32 gradients of
        ``params_f32``'s tensors, then the point and direction cotangents.
        On the card ``run`` replaces the plan's points a CTA (``_bwd_plan``;
        a multiple of 64), and a ``stash`` dict receives the launch's
        ``scratch`` (float32), ``run``, ``grid`` and ``per_point`` (floats a
        point of a CTA's stash), for reading the recomputed forward."""
        if self._route(pts) == "cpu":
            return self._plain_backward(packed, pts, dirs, cot)
        return self._launch_bwd(packed, pts, dirs, cot, run, stash)

    def _packed_args(self, packed) -> tuple:
        """(name, tensor, shape, dtype) of each tensor of a ``Packed``
        packing that the kernels read."""
        return (("wmat", packed.wmat, packed.wmat.shape, self.cdt),
                ("vec", packed.vec, packed.vec.shape, torch.float32))

    def _check(self, packed, pts: torch.Tensor, dirs: torch.Tensor,
               cot: torch.Tensor | None = None) -> None:
        """Raise ``NotImplementedError`` outside the kernels' shapes and
        ``ValueError`` for a kernel input of another device, dtype or shape
        than it takes: the points and directions (n, 3), the cotangent (n,
        4) and the packing's tensors (``_packed_args``: name, tensor, shape,
        dtype)."""
        if not self.supported():
            raise NotImplementedError(self._unsupported())
        n = pts.shape[0]
        named = (("points", pts, (n, 3), torch.float32),
                 ("dirs", dirs, (n, 3), torch.float32))
        if cot is not None:
            named += (("cotangent", cot, (n, 4), torch.float32),)
        dev = pts.device
        for name, x, shape, dtype in named + self._packed_args(packed):
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape):
                raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {dev}, "
                                 f"got {x.dtype} {tuple(x.shape)} on {x.device}")

    @staticmethod
    def _runs(n: int, dev) -> tuple[int, int]:
        """``(run, grid)`` of a backward kernel: about one run of points an
        SM, whole 64-point chunks."""
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        return bwd_runs(n, n_sm)

    def _bwd_plan(self, n: int, dev, run: int | None) -> tuple[int, int]:
        """``(run, grid)`` of this backward launch: ``_runs``' or the given
        run's."""
        return self._runs(n, dev) if run is None else (run, -(-n // run))


def bwd_runs(n: int, n_sm: int) -> tuple[int, int]:
    """``(run, grid)``: about one run of ``n`` points on each of ``n_sm``
    SMs, whole 64-point chunks."""
    run = -(-(-(-n // n_sm)) // 64) * 64
    return run, -(-n // run)
