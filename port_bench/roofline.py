"""The yardstick: the H100's peaks, each hand kernel's bytes and float32
operations at a launch's shapes, and the least time of a whole training
step or served frame. Frozen with the benchmark, so that a later change
to a kernel cannot change what it is measured against.

The per-kernel arithmetic is chip_smoke.py's (its kernel records' `bytes`
and `flops`), copied: each input byte read once, each output byte written
once; B3 and B4 count the (instance, pixel) pairs that the plain twin of
the compositor evaluates on the same inputs.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12          # float32 outside the tensor cores (TF32 off)
# f32 operations of a gated (instance, pixel) pair in B3 and B4: dx, dy,
# power (9) and the power > 0 test; the exp and the 1/255 test that some
# also take are left out, so the bound stays a lower bound
GATED_PAIR_OPS = 12
N_GEOM_GRAD = 6              # geometry columns of a B4 gradient row
TILE_PIX = 256


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the two."""
    return max(nbytes / HBM_BYTES_S, flops / FP32_FLOP_S)


def round8(x: int) -> int:
    return -(-x // 8) * 8


# ---------------------------------------------------------------------------
# hand kernels: (bytes, flops) of one launch
# ---------------------------------------------------------------------------
def compact_live(n: int):
    """B2 over n Gaussians: per row the start, count, rect and depth key
    read (28 B) and the [n, 8] int32 table row written (32 B)."""
    return n * 28 + n * 32, 0


def expand(n_live: int, slots: int):
    """B1: the live table rows read, every key and id slot written."""
    return n_live * 32 + slots * 12, 0


def composite_fwd(packed_numel: int, R: int, T: int, ch: int,
                  hit: int, gated: int, culled: int):
    """B3: the packed rows, ids and tile ranges read, the [T, ch + 1, 256]
    output written; per composited pair 16 for power and alpha, 3 for T
    and its test, 1 for the weight and 2 ch for the blend, per gated pair
    GATED_PAIR_OPS in the (instance, quarter)s its culling keeps."""
    nbytes = (packed_numel + R + 2 * T + T * (ch + 1) * TILE_PIX) * 4
    return nbytes, hit * (20 + 2 * ch) + (gated - culled) * GATED_PAIR_OPS


def composite_bwd(packed_numel: int, R: int, fwd_numel: int, ch: int,
                  hit: int, gated: int):
    """B4: rows, ids, slots read, the forward output and its gradient
    read, one gradient row per instance written; per composited pair ~36
    for power, alpha, T and dL/dalpha, 2 ch for f.g, 14 + ch for the
    pixel's 6 + ch values, nc = 6 + ch for their sum."""
    gc = round8(N_GEOM_GRAD + ch)
    nc = N_GEOM_GRAD + ch
    nbytes = (packed_numel + 2 * R + 2 * fwd_numel + R * gc) * 4
    return nbytes, hit * (50 + 3 * ch + nc) + gated * GATED_PAIR_OPS


def segment_sum(rows_used: int, D: int, n: int):
    """B5: the rows in [bounds[0], bounds[n]) and the bounds read, the
    [n, D] sums written; one add per row element."""
    return (rows_used * D + n + 1 + n * D) * 4, rows_used * D


def grid_sample(npix: int, C: int, cells: int):
    """B7: the coords read, the [C, npix] samples written, each distinct
    grid cell that a tap reaches read once; 12 + 8 C per pixel."""
    return npix * 8 + C * npix * 4 + cells * C * 4, npix * (12 + 8 * C)


def grid_sample_bwd(npix: int, C: int, grid_numel: int):
    """B8: coords and upstream gradient read, the dense grid gradient
    written once; 4 taps of 20 + 2 C per pixel."""
    return npix * 8 + C * npix * 4 + grid_numel * 4, 4 * npix * (20 + 2 * C)


# ---------------------------------------------------------------------------
# the whole step or frame
# ---------------------------------------------------------------------------
# float32 operations per alive Gaussian in the forward, from the shapes:
# the preprocess (world->view and projection 2 x 28, the 3-D covariance
# from scale and quaternion ~60, its projection ~50, the conic and radius
# ~20, the SH colour: 2 per coefficient and channel plus ~40 for the
# degree-3 basis)
PREP_OPS = 56 + 60 + 50 + 20 + 40
# per basis coefficient and channel of a trajectory: one multiply-add
DEFORM_OPS_PER_COEF = 2
# per pixel in the forward: the sky (a direction, its angles ~20, the
# bilinear tap 12 + 8 C), the blend with the foreground (2 C), the losses
# (L1 3 C, SSIM's two separable 11-tap passes over 5 maps per channel,
# 2 * 2 * 11 * 5 C, and its per-pixel formula ~20 C; depth, flow, sky
# and object terms ~30)
SKY_OPS = 20 + 12 + 8 * 3
LOSS_OPS = 3 * 3 + 2 * 2 * 11 * 5 * 3 + 20 * 3 + 30
BACKWARD_FACTOR = 2          # a backward takes at least twice the forward


def deform_ops(n_scene: int, n_obj: int, sh_k: int, c_shs: int, c_xyz: int,
               c_rot: int, c_bg: int) -> int:
    """Forward operations of the temporal deformation: the colour
    trajectory on every DC term, the object position and quaternion
    trajectories, the background trajectory on every position, the time
    mask (~10) on object Gaussians."""
    n = n_scene + n_obj
    per = DEFORM_OPS_PER_COEF
    return (n * 3 * c_shs * per + n_obj * (3 * c_xyz + 4 * c_rot) * per
            + n * 3 * c_bg * per + n_obj * 10)


def forward_ops(n_scene: int, n_obj: int, sh_k: int, c_shs: int, c_xyz: int,
                c_rot: int, c_bg: int, pixels: int, hit: int, gated: int,
                culled: int, ch: int, losses: bool) -> int:
    n = n_scene + n_obj
    ops = deform_ops(n_scene, n_obj, sh_k, c_shs, c_xyz, c_rot, c_bg)
    ops += n * (PREP_OPS + 2 * sh_k * 3)
    ops += hit * (20 + 2 * ch) + (gated - culled) * GATED_PAIR_OPS
    ops += pixels * (SKY_OPS + 2 * 3)
    if losses:
        ops += pixels * LOSS_OPS
    return ops


def trainable_floats(n_scene: int, n_obj: int, sh_k: int, c_shs: int,
                     c_xyz: int, c_rot: int, c_bg: int, env_numel: int):
    """Trainable floats of the alive Gaussians and the sky."""
    scene = 3 + 3 * sh_k + 3 + 4 + 1 + 3 * c_shs
    obj = scene + 3 * c_xyz + 4 * c_rot + 2
    return n_scene * scene + n_obj * obj + 3 * c_bg + env_numel


def train_step_bound(n_scene: int, n_obj: int, sh_k: int, c_shs: int,
                     c_xyz: int, c_rot: int, c_bg: int, env_numel: int,
                     pixels: int, flow_pixels: int, hit: int, gated: int,
                     culled: int, ch: int):
    """(bytes, flops) of one training step's required work. Bytes: each
    trainable float and both of its Adam moments read once and written
    once (24 B); the frame batch read once (image 3, depth, sky, object
    mask, flow target 2 and visibility a pixel); the statistics (max
    radius, gradient sum, count) read and written once. Operations: the
    forward and at least twice it for the backward."""
    floats = trainable_floats(n_scene, n_obj, sh_k, c_shs, c_xyz, c_rot,
                              c_bg, env_numel)
    n = n_scene + n_obj
    nbytes = floats * 24 + (6 * pixels + 3 * flow_pixels) * 4 + n * 3 * 8
    fwd = forward_ops(n_scene, n_obj, sh_k, c_shs, c_xyz, c_rot, c_bg,
                      pixels, hit, gated, culled, ch, losses=True)
    return nbytes, fwd * (1 + BACKWARD_FACTOR)


def render_frame_bound(n_scene: int, n_obj: int, sh_k: int, c_shs: int,
                       c_xyz: int, c_rot: int, c_bg: int, pixels: int,
                       sky_cells: int, hit: int, gated: int, culled: int,
                       ch: int, outputs_per_pixel: int):
    """(bytes, flops) of one served frame: the parameters that deform and
    preprocess read (every trainable float of the alive Gaussians), the
    sky cells its taps reach (3 channels), the outputs written; the
    forward's operations."""
    floats = trainable_floats(n_scene, n_obj, sh_k, c_shs, c_xyz, c_rot,
                              c_bg, 0)
    nbytes = floats * 4 + sky_cells * 3 * 4 + pixels * outputs_per_pixel * 4
    return nbytes, forward_ops(n_scene, n_obj, sh_k, c_shs, c_xyz, c_rot,
                               c_bg, pixels, hit, gated, culled, ch,
                               losses=False)
