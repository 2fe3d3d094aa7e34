"""PNG output with the reference's exact quantization.

The torch port's copy of `rust_raytrace_tpu/utils/png.py`: numpy only, so the
port imports nothing of the JAX package.

`write_png` (raytrace_lib/src/raytrace.rs:1460-1478) emits 8-bit RGB with NO
gamma correction and quantizes with Rust's `(c * 255.) as u8` cast, which
truncates toward zero, saturates to [0, 255], and maps NaN to 0.  Golden-image
comparisons depend on reproducing that exact mapping.
"""

import numpy as np

__all__ = ["quantize_u8", "write_png", "read_png", "rmse"]


def quantize_u8(img: np.ndarray) -> np.ndarray:
    """f32 [0,1] colors -> u8 via Rust `as u8` semantics (trunc/saturate/NaN->0).

    u8 input passes through unchanged (already quantized, e.g. on device)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    x = img.astype(np.float32) * np.float32(255.0)
    x = np.nan_to_num(x, nan=0.0, posinf=255.0, neginf=0.0)
    return np.clip(np.trunc(x), 0.0, 255.0).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] float colors to an 8-bit RGB PNG (raytrace.rs:1460-1478)."""
    from PIL import Image

    Image.fromarray(quantize_u8(img), mode="RGB").save(path, format="PNG")


def read_png(path: str) -> np.ndarray:
    """Read a PNG as u8 [H, W, 3] (dropping alpha if present)."""
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"))
    return arr


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    """RMSE between two images in [0,1] color space (u8 inputs are scaled)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.dtype == np.uint8:
        a = a.astype(np.float64) / 255.0
    if b.dtype == np.uint8:
        b = b.astype(np.float64) / 255.0
    return float(np.sqrt(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))
