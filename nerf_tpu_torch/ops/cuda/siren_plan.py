"""The SIREN kernels' plan at each shape they take (PERF.md rows 6-10).

nerf_tpu's SIREN kernels take hidden h with h % 128 == 0 and (h/2) % 128 ==
0 at 8 sine layers, and the direction encoding padded to d_pad = 32
ceil(real_d / 32) columns (``fused_siren.py::make_fused_siren_apply``,
``fused_render_siren.py::FusedSirenRender.supported``); the raw positions
take 8 padded rows and no encoding. The port's kernels take every such
shape with 256 <= h <= 1024 and d_pad <= 64; outside those, a launch raises
``NotImplementedError``.

A shape's plan says how the kernels hold it in an SM's 227 KB of shared
memory and what a train pass stashes a point; ``SirenPlan.defines`` passes
it to ``nvcc`` (``build.py`` compiles one library a shape on demand), where
the sources' static_asserts hold the same sums. The chunks are the NeRF
family's (``nerf_plan.chunks``):

  * float32 (the CUDA cores): chunks of ``p`` points, both activation
    buffers feature-major in shared memory, each product in blocks of 256
    output columns (the rgb head's of 128), the weight stage one block's;
  * bfloat16 (the tensor cores): forward chunks of ``tc_p`` points in two
    activation tiles (a layer's blocks read one and write the other, so
    that a near tie is recomputed from the layer's input), two CTAs an SM
    where two fit (hidden 256 with d_pad 32); the backward's dz W^T in
    chunks of ``tc_pb`` points and blocks of 256 columns, each block with
    its float32 cosines.
"""

from __future__ import annotations

from dataclasses import dataclass

from nerf_tpu_torch.ops.cuda.nerf_plan import (
    _KT, _KTC, _NB, _NS_DACT, _NS_DW, _NS_FWD, _THREADS, _WARPS, SM_SHARED, WIDTHS, ShapePlan,
    chunks)

D_PADS = (32, 64)                # the padded direction-encoding widths
NUM_LAYERS = 8                   # the sine layers both sides take
# the SIREN family's libraries (rows 6-10), each built at every shape a run uses
LIBS = ("fused_render_siren_fwd", "fused_render_siren_fwd_tc",
        "fused_render_siren_train", "fused_render_siren_train_tc",
        "fused_siren_fwd", "fused_siren_fwd_tc", "fused_siren_bwd", "fused_siren_bwd_tc")

# the SIREN sources' own constants (fused_render_siren_common.cuh,
# fused_render_siren_tc_common.cuh); the shared ones are nerf_plan.py's
_N_COLS, _DENC_LD, _N_SC, _TIE_CAP = 16, 64, 9, 1024


def d_pad(dir_freqs: int) -> int:
    """The direction encoding's width padded as nerf_tpu pads it (to a
    multiple of 32 columns)."""
    return -(-3 * (1 + 2 * dir_freqs) // 32) * 32


def covered(h: int, dp: int) -> bool:
    """Whether the port's kernels take hidden ``h`` with the direction
    encoding padded to ``dp`` columns (8 sine layers)."""
    return h in WIDTHS and dp in D_PADS


@dataclass(frozen=True)
class SirenPlan(ShapePlan):
    """One shape's plan: hidden ``h``, the padded direction encoding
    ``d_pad``, the float32 chunk ``p`` and the bfloat16 forward and backward
    chunks ``tc_p`` / ``tc_pb`` (points each)."""

    h: int
    d_pad: int
    p: int
    tc_p: int
    tc_pb: int
    libs = LIBS

    @property
    def pads(self) -> tuple:
        return (("d", "DP", self.d_pad, 32),)

    # -- float32 (fused_render_siren_common.cuh's SM_* plan)

    @property
    def smem_f32(self) -> int:
        """Bytes of shared memory of every float32 SIREN kernel: two
        activation buffers, the raw positions (4 rows), the direction
        encoding, six per-point columns, the weight stage of one block."""
        lda = self.p + 4
        floats = (2 * self.h + self.d_pad) * lda + 4 * self.p + 6 * self.p
        return floats * 4 + 2 * _KT * _NB * 4

    @property
    def f32_floats_per_point(self) -> int:
        """Floats a point of the float32 train pass's and field backward's
        scratch (FLOATS_PER_POINT): h1..h8 and their cosines, feat, y and
        cr0, denc (64 columns), two dz buffers, 16 per-point columns."""
        h = self.h
        return 2 * NUM_LAYERS * h + h + 2 * (h // 2) + _DENC_LD + 2 * h + _N_COLS

    # -- bfloat16 (fused_render_siren_tc_common.cuh's SB_* and BB_* plans)

    @property
    def smem_fwd_tc(self) -> int:
        """Bytes of a bf16 forward CTA (SB_END): two activation tiles, the
        direction encoding, the weight stages, the density partials, nine
        per-point columns, the near ties' counts and positions."""
        tiles = 2 * self.tc_p * (self.h + 8) * 2
        denc = self.tc_p * (self.d_pad + 8) * 2
        return (tiles + denc + _NS_FWD * _KTC * (_NB + 8) * 2 + _WARPS * self.tc_p * 4
                + _N_SC * self.tc_p * 4 + 16 + _TIE_CAP * 2)

    @property
    def smem_bwd_tc(self) -> int:
        """Bytes of the bf16 backward kernel (SMEM_BWD): a dz chunk of every
        column, a block's output and its float32 cosines (the weight
        gradients' stages overlay them), the dz W^T stages, four per-point
        columns, a reduction buffer."""
        tiles = self.tc_pb * ((self.h + 8) * 2 + (_NB + 8) * 2 + (_NB + 8) * 4)
        dw_stage = _NS_DW * _KTC * ((_NB + 8) + (_NB // 2 + 8)) * 2
        dact_stage = _NS_DACT * _NB * (_KTC + 8) * 2
        return max(tiles, dw_stage) + dact_stage + 4 * self.tc_pb * 4 + 4 * _THREADS * 4

    @property
    def fwd_ctas_per_sm(self) -> int:
        """bf16 forward CTAs resident on an SM (two at most)."""
        return min(2, SM_SHARED // (self.smem_fwd_tc + 1024))

    @property
    def tie_ulps(self) -> int:
        """The bf16 chain's near-tie margin (TIE_ULPS, in ulps of 2^-24 w0
        (|acc + b| + 1)): H / 8, twice the smallest margin that left no
        flipped rounding in chip_tie_margin.py's sweeps at hidden 256, 512
        and 1024 (16, 32 and 64; at 768, 64 left none either)."""
        return self.h // 8

    @property
    def tc_bytes_per_point(self) -> int:
        """Stash bytes a point of the bf16 train pass and field backward
        (TC_BYTES_PER_POINT): h1..h8, feat and two dz buffers (bf16, h), y
        (h/2), denc (d_pad), then h8, c1..c8 (h), cr0 (h/2) and 16 per-point
        columns in float32."""
        h, hr = self.h, self.h // 2
        return 2 * (11 * h + hr + self.d_pad) + 4 * (9 * h + hr + _N_COLS)

    def smem(self) -> dict:
        """Every kernel's shared memory, by kernel."""
        return {"f32": self.smem_f32, "fwd_tc": self.smem_fwd_tc, "bwd_tc": self.smem_bwd_tc}


def plan(h: int, dp: int) -> SirenPlan:
    """The plan of hidden ``h`` with the direction encoding padded to ``dp``
    columns; raises ``NotImplementedError`` outside the shapes the kernels
    take."""
    if not covered(h, dp):
        raise NotImplementedError(
            f"the SIREN kernels take hidden {WIDTHS} with the direction encoding padded "
            f"to at most {D_PADS[-1]} columns; got hidden {h}, {dp} (ROADMAP.md queue 2)")
    return SirenPlan(h, dp, **chunks(h))
