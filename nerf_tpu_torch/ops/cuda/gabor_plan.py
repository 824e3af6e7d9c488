"""The GaborNet kernels' plan at each shape they take (PERF.md rows 11-14).

nerf_tpu's GaborNet kernels take hidden h with h % 128 == 0 and (h/2) % 128
== 0, any number n of filter stages, and the direction encoding padded to
d_pad = 32 ceil(real_d / 32) columns (``fused_render_gabor.py::
FusedGaborRender.supported``, ``fused_gabor.py::make_fused_gabor_apply``).
The port's kernels take every such shape with 256 <= h <= 1024, d_pad <= 64
and n >= 1 whose packed offsets fit a 32-bit int (about 2,000 stages at
hidden 1024); outside those, a launch raises ``NotImplementedError``. A
one-stage net is nerf_tpu's too: its loops over the stages run with n = 1.

A shape's plan says how the kernels hold it in an SM's 227 KB of shared
memory and what a train pass stashes a point; ``GaborPlan.defines`` passes
it to ``nvcc`` (``build.py`` compiles one library a shape on demand), the
depth as -DGABOR_NL (a build a depth: the stage loops, the packed offsets
and the stash are compile-time, as the width is, and the default build
stays the 8-stage one it was), where the sources' static_asserts hold the
same sums. The chunks are the NeRF family's (``nerf_plan.chunks``):

  * float32 (the CUDA cores): chunks of ``p`` points, both activation
    buffers feature-major in shared memory, each product in blocks of 256
    output columns (the rgb head's of 128), the weight stage one block's;
  * bfloat16 (the tensor cores): forward chunks of ``tc_p`` points in one
    activation tile at hidden 256 (two CTAs an SM) and two wider (a stage's
    blocks read one and write the other); the backward's dz W^T in chunks
    of ``tc_pb`` points and blocks of 256 columns, each block with its
    float32 u tile.
"""

from __future__ import annotations

from dataclasses import dataclass

from nerf_tpu_torch.ops.cuda.nerf_plan import (
    _KT, _KTC, _NB, _NS_DACT, _NS_DW, _NS_FWD, _THREADS, _WARPS, SM_SHARED, WIDTHS, ShapePlan,
    chunks)
from nerf_tpu_torch.ops.cuda.siren_plan import D_PADS, d_pad

DEFAULT_LAYERS = 8               # the stages of the default build
# the GaborNet family's libraries (rows 11-14), each built at every shape a run uses
LIBS = ("fused_render_gabor_fwd", "fused_render_gabor_fwd_tc",
        "fused_render_gabor_train", "fused_render_gabor_train_tc",
        "fused_gabor_fwd", "fused_gabor_fwd_tc", "fused_gabor_bwd", "fused_gabor_bwd_tc")

# the GaborNet sources' own constants (fused_render_gabor_common.cuh,
# fused_render_gabor_tc_common.cuh); the shared ones are nerf_plan.py's
_N_COLS, _DENC_LD = 16, 64
_N_GC, _N_BC, _NRUN = 7, 8, 9
_INT_MAX = 2 ** 31 - 1


def _offsets_fit(h: int, n: int) -> bool:
    """Whether the packed matrices' offsets ((n + 2) h^2 bound them) fit the
    sources' 32-bit ints (their static_assert)."""
    return (n + 2) * h * h <= _INT_MAX


def covered(h: int, dp: int, n: int) -> bool:
    """Whether the port's kernels take hidden ``h`` with the direction
    encoding padded to ``dp`` columns and ``n`` filter stages."""
    return h in WIDTHS and dp in D_PADS and n >= 1 and _offsets_fit(h, n)


@dataclass(frozen=True)
class GaborPlan(ShapePlan):
    """One shape's plan: hidden ``h``, the padded direction encoding
    ``d_pad``, ``n`` filter stages, the float32 chunk ``p`` and the
    bfloat16 forward and backward chunks ``tc_p`` / ``tc_pb`` (points
    each)."""

    h: int
    d_pad: int
    n: int
    p: int
    tc_p: int
    tc_pb: int
    libs = LIBS

    @property
    def pads(self) -> tuple:
        return (("d", "DP", self.d_pad, 32),)

    @property
    def tag(self) -> str:
        return super().tag + f"n{self.n}"

    @property
    def default(self) -> bool:
        return super().default and self.n == DEFAULT_LAYERS

    @property
    def defines(self) -> tuple:
        if self.default:
            return ()
        width = (f"-DNERF_H={self.h}", f"-DNERF_DP={self.d_pad}", f"-DNERF_P={self.p}",
                 f"-DNERF_TC_P={self.tc_p}", f"-DNERF_TC_PB={self.tc_pb}")
        return (*width, f"-DGABOR_NL={self.n}")

    # -- float32 (fused_render_gabor_common.cuh's SM_* plan)

    @property
    def smem_f32(self) -> int:
        """Bytes of shared memory of every float32 GaborNet kernel: two
        activation buffers, the direction encoding, twelve per-point columns
        (t, t^2, delta, sigma, rgb (3), the coefficient row, a field's point
        (3) and |x|^2), the weight stage of one block."""
        lda = self.p + 4
        floats = (2 * self.h + self.d_pad) * lda + 12 * self.p
        return floats * 4 + 2 * _KT * _NB * 4

    def f32_floats_per_point(self, ndz: int) -> int:
        """Floats a point of a float32 backward's scratch with ``ndz`` dz
        buffers (2: the train pass, 4: the field backward): z_1..z_n,
        u_2..u_n, feat, y, denc (64 columns), the dz buffers, 16 per-point
        columns."""
        h = self.h
        return self.n * h + (self.n - 1) * h + h + h // 2 + _DENC_LD + ndz * h + _N_COLS

    # -- bfloat16 (fused_render_gabor_tc_common.cuh's GB_* and BB_* plans)

    @property
    def one_tile(self) -> bool:
        return self.h == _NB

    @property
    def smem_fwd_tc(self) -> int:
        """Bytes of a bf16 forward CTA (SMEM_GABOR_TC): the activation tiles,
        the direction encoding, the weight stages, the density partials,
        eight per-point columns and the coefficient rows."""
        tiles = (1 if self.one_tile else 2) * self.tc_p * (self.h + 8) * 2
        denc = self.tc_p * (self.d_pad + 8) * 2
        return (tiles + denc + _NS_FWD * _KTC * (_NB + 8) * 2 + _WARPS * self.tc_p * 4
                + (_N_GC + 1) * self.tc_p * 4 + self.tc_p * 4)

    @property
    def smem_bwd_tc(self) -> int:
        """Bytes of the bf16 backward kernels (SMEM_BWD): a dz chunk of every
        column, a block's output and its float32 u (the weight gradients'
        stages overlay them), the dz W^T stages, eight per-point columns, a
        reduction buffer and nine running sums a column."""
        tiles = self.tc_pb * ((self.h + 8) * 2 + (_NB + 8) * 2 + (_NB + 8) * 4)
        dw_stage = _NS_DW * _KTC * ((_NB + 8) + (_NB // 2 + 8)) * 2
        dact_stage = _NS_DACT * _NB * (_KTC + 8) * 2
        return (max(tiles, dw_stage) + dact_stage + _N_BC * self.tc_pb * 4
                + 4 * _THREADS * 4 + _NRUN * self.h * 4)

    @property
    def fwd_ctas_per_sm(self) -> int:
        """bf16 forward CTAs resident on an SM (two at most)."""
        return min(2, SM_SHARED // (self.smem_fwd_tc + 1024))

    @property
    def tc_bytes_per_point(self) -> int:
        """Stash bytes a point of the bf16 train pass and field backward
        (TC_BYTES_PER_POINT): z_1..z_n, feat and two dz buffers (bf16, h), y
        (h/2), denc (d_pad), then u_2..u_n, z_n and 16 per-point columns in
        float32."""
        h = self.h
        return 2 * ((self.n + 3) * h + h // 2 + self.d_pad) + 4 * (self.n * h + _N_COLS)

    @property
    def n_w(self) -> int:
        """Floats of the packed matrices: w_1..w_{n-1}, wre, wr0f, wr0d,
        wr1."""
        h, hr = self.h, self.h // 2
        return (self.n - 1) * h * h + h * h + h * hr + self.d_pad * hr + hr * 8

    @property
    def n_b(self) -> int:
        """Floats of the packed vectors: b_1..b_{n-1}, bre, ws, br0, br1,
        bs."""
        return (self.n + 1) * self.h + self.h // 2 + 9

    def smem(self) -> dict:
        """Every kernel's shared memory, by kernel."""
        return {"f32": self.smem_f32, "fwd_tc": self.smem_fwd_tc, "bwd_tc": self.smem_bwd_tc}


def plan(h: int, dp: int, n: int) -> GaborPlan:
    """The plan of hidden ``h`` with the direction encoding padded to ``dp``
    columns and ``n`` stages; raises ``NotImplementedError`` outside the
    shapes the kernels take."""
    if not covered(h, dp, n):
        raise NotImplementedError(
            f"the GaborNet kernels take hidden {WIDTHS} with the direction encoding padded "
            f"to at most {D_PADS[-1]} columns and at least one stage; got hidden {h}, {dp} "
            f"columns, {n} stages (ROADMAP.md queue 2)")
    return GaborPlan(h, dp, n, **chunks(h))
