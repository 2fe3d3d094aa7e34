"""Automated parity checks against the reference's shipped golden PNGs.

The torch port's copy of `rust_raytrace_tpu/utils/parity.py`: numpy only,
the same constants and arithmetic.  The golden teapot_4k_tris.png is not
in this repository, so the port exercises these on synthetic images and
on tests/goldens/circles_96x54.png.

teapot_4k_tris.png is the golden of the shipped main.rs scene (3840x2160).
Its stochastic object pixels cannot match any re-render (1-spp bounce noise,
docs/PARITY.md), and the golden itself predates the shipped source (its sky
r-channel 127 is unreachable from either in-source sky constant) — so parity
is gated on the DETERMINISTIC structure instead:

  - sky constancy: pixels that are sky in the golden must render as our sky
    constant (128,180,255 — the CPU sky, raytrace.rs:1264), within the
    golden's own 1-2/255 quantization-era drift;
  - silhouette IoU: the non-sky mask (geometry footprint incl. the
    edge-wireframe) must overlap the golden's to high intersection-over-union
    — catching any camera, transform, or geometry regression.

Checked at reduced resolution in tests (box-downsampled golden vs a small
render — sky/silhouette survive downsampling) and reported at full
resolution by the bench.
"""

from typing import Optional, Tuple

import numpy as np

#: the golden's sky pixel (predates the shipped source's 128,180,255)
GOLDEN_SKY = np.asarray([127, 178, 255], dtype=np.float32)
OUR_SKY = np.asarray([128, 180, 255], dtype=np.float32)
SKY_TOL = 3.0       # covers the golden-era constant drift


def downsample_u8(img: np.ndarray, factor: int) -> np.ndarray:
    """Box-filter downsample of an [H, W, 3] u8 image."""
    h, w = img.shape[0] // factor * factor, img.shape[1] // factor * factor
    x = img[:h, :w].reshape(h // factor, factor, w // factor, factor, 3)
    return x.mean(axis=(1, 3)).astype(np.float32)


def sky_mask(img: np.ndarray, sky, tol: float = SKY_TOL) -> np.ndarray:
    return (np.abs(img.astype(np.float32) - sky).max(axis=-1) <= tol)


def parity_stats(ours: np.ndarray, golden: np.ndarray) -> dict:
    """ours/golden: [H, W, 3] u8-ish arrays of the SAME shape.

    Returns {sky_mean_abs_diff, silhouette_iou, rmse, mae} — the
    deterministic parity gates plus the overall error norms (stochastic,
    reported not gated).  rmse is sqrt(mean(sq)); mae is mean(|diff|)
    (both over [0,1]-normalized channels).
    """
    ours_f = ours.astype(np.float32)
    golden_f = golden.astype(np.float32)

    gsky = sky_mask(golden_f, GOLDEN_SKY)
    osky = sky_mask(ours_f, OUR_SKY)
    sky_diff = float(np.abs(ours_f[gsky] - golden_f[gsky]).mean()) \
        if gsky.any() else float("nan")

    inter = (~gsky & ~osky).sum()
    union = (~gsky | ~osky).sum()
    iou = float(inter / union) if union else float("nan")

    sq = ((ours_f - golden_f) / 255.0) ** 2
    rmse = float(np.sqrt(sq.mean()))
    mae = float(np.abs((ours_f - golden_f) / 255.0).mean())
    return {
        "sky_mean_abs_diff": sky_diff,
        "silhouette_iou": iou,
        "rmse": rmse,
        "mae": mae,
        "sky_fraction_golden": float(gsky.mean()),
    }
