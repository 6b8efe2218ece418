"""The table of peaks and the work a step or a view needs, counted from
shapes and from the reference's instance lists, never from the program's
buffers.  A roofline time is the larger of operations over the float32
peak and bytes over the memory bandwidth; each count is what these inputs
need, not the most they could.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published (data sheet; dense, no sparsity), at 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

F32 = 4
NUM_FIELDS = 10  # a Gaussian's blend row: mean, conic, opacity, colour, inverse depth
SH_COEFFS = 16  # degree 3

# Float operations per (pixel, instance) pair, the kernels' published rule:
# the forward blend visits a pair (16: offset, power, alpha, cap, the two
# eligibility tests), tests the transmittance on an eligible one (3: per
# contributing pair and per saturating pixel) and accumulates a
# contributing one (9); the backward replays a pair (17) and forms and sums
# a contributing pair's ten gradient terms (37).
K2_VISIT, K2_ELIGIBLE, K2_CONTRIB = 16, 3, 9
K5_REPLAY, K5_CONTRIB = 17, 37


def blend_counts(params, alive, cam, bg, sh_degree: int) -> dict:
    """The blend's work at one camera, counted on the reference's lists
    (``reference.render.Work``), and the number of instances."""
    from benchmark.reference import render as rr

    _, _, _, bins, w = rr.view(params, alive, cam, bg, sh_degree, count_work=True)
    return dict(w._asdict(), instances=int(bins.owner.numel()))


def roofline_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def k2(w: dict) -> tuple:
    """(operations, bytes) of the forward blend on one image: each
    instance a tile reads (its index and its field row), the eight output
    planes of every pixel, and each tile's range."""
    ops = (K2_VISIT * w["visited"] + K2_ELIGIBLE * (w["contributing"] + w["saturated"])
           + K2_CONTRIB * w["contributing"])
    nbytes = w["read_fwd"] * (4 + NUM_FIELDS * F32) + w["tiles"] * (256 * 8 * F32 + 8)
    return ops, nbytes


def k5(w: dict) -> tuple:
    """(operations, bytes) of the backward blend: each instance replayed
    (index, field row, gradient row out), the forward's planes and the
    five cotangent planes of every pixel, and each tile's range."""
    ops = K5_REPLAY * w["replayed"] + K5_CONTRIB * w["contributing"]
    nbytes = (w["read_bwd"] * (4 + 2 * NUM_FIELDS * F32)
              + w["tiles"] * (256 * (8 + 5) * F32 + 8))
    return ops, nbytes


def preprocess_bytes(capacity: int, backward: bool) -> float:
    """Projection and SH of every slot: the 59 stored floats read, the
    blend row and four integers of binning written; backward, the blend
    row's gradient and the stored floats read again and their gradient
    written."""
    stored = 3 + 3 + 4 + 1 + 3 * SH_COEFFS
    fwd = capacity * (stored + NUM_FIELDS + 4) * F32
    bwd = capacity * (NUM_FIELDS + 2 * stored) * F32
    return fwd + (bwd if backward else 0.0)


def sort_bytes(instances: int) -> float:
    """The keys (8 B) and owners (4 B) of every instance written once by
    the expansion, read and written once by the sort."""
    return instances * 12 * 3


def loss_work(pixels: int) -> tuple:
    """L1 + SSIM forward and backward over three channels: five moments
    blurred by 11 + 11 taps (two operations each) and some 30 more per
    value, twice for the backward; the image and target read and the
    image's gradient written."""
    ops = 3 * pixels * 2 * (5 * 22 * 2 + 30)
    return ops, 3 * pixels * 3 * F32


def adam_bytes(capacity: int) -> float:
    """Parameters, gradients and both moments read; parameters and moments
    written."""
    stored = 3 + 3 + 4 + 1 + 3 * SH_COEFFS
    return capacity * stored * 7 * F32


def train_step_s(w: dict, capacity: int, pixels: int) -> float:
    """The least time one training step's work takes on the card."""
    return (roofline_s(0, preprocess_bytes(capacity, True))
            + roofline_s(0, sort_bytes(w["instances"])) + roofline_s(*k2(w))
            + roofline_s(*k5(w)) + roofline_s(*loss_work(pixels))
            + roofline_s(0, adam_bytes(capacity)))


def view_s(w: dict, capacity: int) -> float:
    """The least time one inference view's work takes on the card."""
    return (roofline_s(0, preprocess_bytes(capacity, False))
            + roofline_s(0, sort_bytes(w["instances"])) + roofline_s(*k2(w)))
