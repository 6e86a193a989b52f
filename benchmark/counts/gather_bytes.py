"""Bytes the bilinear gather and its backward must move, from shapes:
each input byte read once, each output byte written once (coordinates,
outputs and gradients float32; images in the dtype the warp reads).

The backward warps (``bwarp``, relative coordinates) read their whole
source image: flows of tens of pixels reach nearly every pixel. FGAC's
sampler takes absolute coordinates, the raw flow values, so its taps
reach only the corner of the image that the flows' range spans (a few
tens of pixels square); its image bytes, and its image gradient's, are
counted as 0, which undercounts by less than a thousandth."""
from __future__ import annotations

F32 = 4


def _relative_pair(n: int, c: int, hw: int, image: int) -> int:
    """One forward launch on two halves of n images of c channels."""
    return 2 * n * (c * hw * image + 2 * hw * F32 + c * hw * F32)


def serve_window(h: int, w: int, instants: int, n_update: int, nf: int,
                 image_bytes: int) -> int:
    """A window's gathers at the padded size: FGAC's two samples of one
    frame's keys, the Stage-I features' and the refined features' pairs,
    and each boosting step's pair of frames, at every instant."""
    hw = h * w
    fgac = 2 * (2 * hw * F32 + nf * hw * F32)
    features = 2 * _relative_pair(instants, nf, hw, image_bytes)
    frames = n_update * _relative_pair(instants, 3, hw, image_bytes)
    return fgac + features + frames


def _relative_pair_bwd(n: int, c: int, hw: int) -> int:
    """One backward launch on two halves: image, coordinates and output
    gradient read; image and coordinate gradients written."""
    return 2 * n * (3 * c * hw * F32 + 4 * hw * F32)


def train_step_bwd(batch: int, size: int, n_update: int, nf: int) -> int:
    """A float32 train step's gather backwards: FGAC's two (coordinates
    and output gradient read, coordinate gradient written), the two
    feature pairs and one frame pair a boosting step."""
    hw = size * size
    fgac = 2 * batch * (nf * hw * F32 + 4 * hw * F32)
    return (fgac + 2 * _relative_pair_bwd(batch, nf, hw)
            + n_update * _relative_pair_bwd(batch, 3, hw))
