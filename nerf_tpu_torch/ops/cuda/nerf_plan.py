"""The NeRF kernels' plan at each shape they take (PERF.md rows 1-5).

nerf_tpu's NeRF kernels take hidden h with h % 128 == 0 and (h/2) % 128 ==
0 and encodings padded to p_pad = 64 ceil(real_p / 64) and d_pad = 32
ceil(real_d / 32) columns (``fused_nerf.py::make_fused_nerf_apply``). The
port's kernels take every such shape with 256 <= h <= 1024, p_pad <= 128
and d_pad <= 64; outside those, a launch raises ``NotImplementedError``.

A shape's plan says how the kernels hold it in an SM's 227 KB of shared
memory and what a train pass stashes a point; ``NerfPlan.defines`` passes it
to ``nvcc`` (``build.py`` compiles one library a shape on demand), where
the sources' static_asserts hold the same sums. The plan:

  * float32 (the CUDA cores): chunks of ``p`` points (64 at hidden 256,
    32 at 512, 16 wider), both activation buffers feature-major in shared
    memory, each product in blocks of 256 output columns;
  * bfloat16 (the tensor cores): forward chunks of ``tc_p`` points (64 up
    to hidden 512, 32 wider), one activation tile at hidden 256 (two CTAs
    an SM) and two wider (a layer's blocks read one and write the other);
    the backward's dz W^T in chunks of ``tc_pb`` points (64 at hidden 256,
    32 wider) and blocks of 256 columns.
"""

from __future__ import annotations

from dataclasses import dataclass

WIDTHS = (256, 512, 768, 1024)   # the hidden widths the kernels take
P_PADS = (64, 128)               # the padded position-encoding widths
D_PADS = (32, 64)                # the padded direction-encoding widths
SMEM_LIMIT = 232_448             # shared memory a CTA can have on an H100 (227 KB)
SM_SHARED = 233_472              # an SM's shared memory, 1 KB a CTA reserved
# the NeRF family's libraries (rows 1-5), each built at every shape a run uses
LIBS = ("fused_render_fwd", "fused_render_fwd_tc", "fused_render_train",
        "fused_render_train_tc", "fused_nerf_fwd", "fused_nerf_fwd_tc",
        "fused_nerf_bwd", "fused_nerf_bwd_tc")

# the sources' constants (render_common.cuh, render_tc.cuh)
_NB, _KT, _KTC, _THREADS, _WARPS = 256, 16, 32, 256, 8
_NS_FWD, _NS_DACT, _NS_DW = 2, 3, 4
_N_COLS = 12


def enc_pads(pos_freqs: int, dir_freqs: int) -> tuple[int, int]:
    """``(p_pad, d_pad)``: the encodings' widths padded as nerf_tpu pads
    them (to multiples of 64 and 32 columns)."""
    real_p, real_d = 3 * (1 + 2 * pos_freqs), 3 * (1 + 2 * dir_freqs)
    return -(-real_p // 64) * 64, -(-real_d // 32) * 32


def covered(h: int, p_pad: int, d_pad: int) -> bool:
    """Whether the port's kernels take hidden ``h`` with these padded
    encodings."""
    return h in WIDTHS and p_pad in P_PADS and d_pad in D_PADS


class ShapePlan:
    """What every family's plan shares: the name of its shape (``tag``),
    whether it is the default one, its -D flags and its builds. A family
    gives hidden ``h``, the chunks ``p`` / ``tc_p`` / ``tc_pb``, ``libs``
    and ``pads``: (tag letter, -D suffix, width, default width) of each
    padded encoding."""

    libs: tuple = ()

    @property
    def tag(self) -> str:
        return f"h{self.h}" + "".join(f"{c}{w}" for c, _, w, _ in self.pads)

    @property
    def default(self) -> bool:
        """The shape every library is built at (no -D flags)."""
        return self.h == 256 and all(w == d for *_, w, d in self.pads)

    @property
    def defines(self) -> tuple:
        """The -D flags of this shape (none at the default one)."""
        if self.default:
            return ()
        return (f"-DNERF_H={self.h}", *(f"-DNERF_{n}={w}" for _, n, w, _ in self.pads),
                f"-DNERF_P={self.p}", f"-DNERF_TC_P={self.tc_p}", f"-DNERF_TC_PB={self.tc_pb}")

    @property
    def builds(self) -> list:
        """``build.build_shaped``'s jobs of this shape: each of the family's
        libraries."""
        return [(name, self.tag, self.defines) for name in self.libs]


@dataclass(frozen=True)
class NerfPlan(ShapePlan):
    """One shape's plan: hidden ``h``, padded encodings ``p_pad`` /
    ``d_pad``, the float32 chunk ``p`` and the bfloat16 forward and
    backward chunks ``tc_p`` / ``tc_pb`` (points each)."""

    h: int
    p_pad: int
    d_pad: int
    p: int
    tc_p: int
    tc_pb: int
    libs = LIBS

    @property
    def pads(self) -> tuple:
        return (("p", "PP", self.p_pad, 64), ("d", "DP", self.d_pad, 32))

    # -- float32 (fused_render_common.cuh's SM_* plan)

    @property
    def smem_f32(self) -> int:
        """Bytes of shared memory of every float32 NeRF kernel: two
        activation buffers, the encodings, six per-point columns, the
        weight stage."""
        lda = self.p + 4
        floats = (2 * self.h + self.p_pad + self.d_pad) * lda + 6 * self.p
        return floats * 4 + 2 * _KT * _NB * 4

    def f32_floats_per_point(self, ndz: int) -> int:
        """Floats a point of a float32 backward's scratch with ``ndz`` dz
        buffers (2: the train pass, 3: the field backward)."""
        h = self.h
        return 10 * h + h // 2 + 2 * self.p_pad + ndz * h + _N_COLS

    # -- bfloat16 (fused_render_tc_common.cuh's FB_* and BB_* plans)

    @property
    def one_tile(self) -> bool:
        return self.h == _NB

    @property
    def smem_train_fwd(self) -> int:
        """Bytes of shared memory of a bf16 forward chain (FB_END): the
        activation tiles, the encodings, the weight stages, the density
        partials."""
        tiles = (1 if self.one_tile else 2) * self.tc_p * (self.h + 8) * 2
        enc = self.tc_p * ((self.p_pad + 8) + (self.d_pad + 8)) * 2
        return tiles + enc + _NS_FWD * _KTC * (_NB + 8) * 2 + _WARPS * self.tc_p * 4

    @property
    def smem_fwd_tc(self) -> int:
        """Bytes of the bf16 forward render and field forward: the chain's
        plan and six per-point columns."""
        return self.smem_train_fwd + 6 * self.tc_p * 4

    @property
    def smem_bwd_tc(self) -> int:
        """Bytes of the bf16 backward kernel (SMEM_BWD)."""
        tiles = self.tc_pb * ((self.h + 8) * 2 + (_NB + 8) * 2 + (_NB + 8) * 4)
        dw_stage = _NS_DW * _KTC * ((_NB + 8) + (_NB // 2 + 8)) * 2
        dact_stage = _NS_DACT * _NB * (_KTC + 8) * 2
        return max(tiles, dw_stage) + dact_stage + 4 * self.tc_pb * 4 + 4 * _THREADS * 4

    @property
    def fwd_ctas_per_sm(self) -> int:
        """bf16 forward CTAs resident on an SM (two at most)."""
        return min(2, SM_SHARED // (self.smem_fwd_tc + 1024))

    @property
    def tc_bytes_per_point(self) -> int:
        """Stash bytes a point of the bf16 train pass (TC_BYTES_PER_POINT):
        h1..h8, r(h9), feat, two dz buffers (bf16, h), y (h/2), the
        encodings (bf16), h9 and 12 per-point columns (float32)."""
        h = self.h
        return 2 * (12 * h + h // 2 + self.p_pad + self.d_pad) + 4 * (h + _N_COLS)

    @property
    def field_tc_bytes_per_point(self) -> int:
        """The bf16 field backward's: the train pass's and dz6 w6p^T
        (p_pad float32 columns)."""
        return self.tc_bytes_per_point + 4 * self.p_pad

    def smem(self) -> dict:
        """Every kernel's shared memory, by kernel."""
        return {"f32": self.smem_f32, "fwd_tc": self.smem_fwd_tc,
                "train_fwd_tc": self.smem_train_fwd, "bwd_tc": self.smem_bwd_tc}


def chunks(h: int) -> dict:
    """The chunk rule of every family built at hidden ``h`` (the NeRF's
    here, the SIREN's in ``siren_plan.py``): the float32 chunk ``p``, the
    bf16 forward chunk ``tc_p`` and the bf16 backward chunk ``tc_pb``
    (points each)."""
    return dict(p=64 if h == 256 else 32 if h == 512 else 16,
                tc_p=64 if h <= 512 else 32, tc_pb=64 if h == 256 else 32)


def plan(h: int, p_pad: int, d_pad: int) -> NerfPlan:
    """The plan of hidden ``h`` with padded encodings ``p_pad`` / ``d_pad``;
    raises ``NotImplementedError`` outside the shapes the kernels take."""
    if not covered(h, p_pad, d_pad):
        raise NotImplementedError(
            f"the NeRF kernels take hidden {WIDTHS} with encodings padded to at most "
            f"{P_PADS[-1]}/{D_PADS[-1]} columns; got hidden {h}, {p_pad}/{d_pad} "
            "(ROADMAP.md queue 2)")
    return NerfPlan(h, p_pad, d_pad, **chunks(h))
