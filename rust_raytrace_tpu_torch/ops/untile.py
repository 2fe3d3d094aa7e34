"""The quantized image's un-tiling: tile-major u8 pixels to [H, W, 3].

Counterpart: the quantized branch of `rust_raytrace_tpu/engine.py`'s
`_assemble_host_image`, a numpy scatter through the tile permutation on the
host.  The port un-tiles where the image lies: `untile_u8` runs the CUDA
kernel of `csrc/untile.cu` on a CUDA tensor, before the copy to the host,
and `untile_u8_plain` on a CPU tensor.  No TPU kernel is replaced; the
kernel exists because the host scatter held the host for ~90 ms a
2560x1440 frame with the card idle.

src is the device's quantized image, u8 [3, Pp] in tile-major pixel order
(`engine.camera_rays_tiled`: tile t of the row-major tile grid, then the
tile's pixels row-major), Pp >= H * W, the columns past H * W padding.  T is
`engine.pick_tile`'s tile; H and W are multiples of it.
"""

import torch

from ..utils import native

#: the tiles `engine.pick_tile` picks, which the kernel takes
TILES = (32, 16, 8, 1)


def untile_u8_plain(src: torch.Tensor, H: int, W: int, T: int):
    """Plain torch version of `untile_u8`: one permuted copy."""
    return (src[:, :H * W].reshape(3, H // T, W // T, T, T)
            .permute(1, 3, 2, 4, 0).reshape(H, W, 3).contiguous())


def untile_u8(src: torch.Tensor, H: int, W: int, T: int) -> torch.Tensor:
    """The [H, W, 3] u8 image of the tile-major src [3, Pp] (a new tensor on
    src's device).  Raises on what the kernel does not take: a tile not in
    TILES, H or W not a positive multiple of it, fewer than H * W columns,
    a last dim that is not dense."""
    dev = src.device
    if dev.type == "cpu":
        return untile_u8_plain(src, H, W, T)
    native.require(dev.type == "cuda", f"untile_u8: no kernel for device {dev}")
    native.require(T in TILES and H > 0 and W > 0 and H % T == 0
                   and W % T == 0 and H // T <= 65535,
                   f"untile_u8: tile {T} for {H}x{W}")
    Pp = src.shape[1]
    native.require(Pp >= H * W, f"untile_u8: {Pp} columns for {H}x{W}")
    native.check_tensor("src", src, dev, (3, Pp), torch.uint8,
                        contiguous=False)
    out = torch.empty((H, W, 3), dtype=torch.uint8, device=dev)
    native.UNTILE(src.data_ptr(), out.data_ptr(), H, W, T, src.stride(0),
                  native.stream(dev))
    return out
