"""Terminal image display — the SDL results window, headless.

The torch port's copy of `rust_raytrace_tpu/utils/term_display.py`, on the
port's own `utils/png.quantize_u8`.

The reference ends its run by opening an SDL2 window, blitting the final
framebuffer into a BGR888 texture, and blocking until Escape/Quit
(raytrace/src/main.rs:229-270).  This environment has no display server, so
the analog renders the framebuffer directly into the terminal with 24-bit
ANSI color, two image rows per character cell via the upper-half-block glyph
(U+2580: foreground = top pixel, background = bottom pixel), and optionally
blocks for a keypress like the SDL event loop.

The image -> text conversion is a pure function (`to_ansi`) so it is unit
testable without a terminal; quantization reuses the PNG writer's exact
`(c * 255.) as u8` semantics so the displayed colors are the PNG's bytes.
"""

import os
import sys

import numpy as np

from .png import quantize_u8

__all__ = ["downsample_u8", "to_ansi", "display_image"]

_RESET = "\x1b[0m"


def downsample_u8(img: np.ndarray, max_w: int, max_h: int) -> np.ndarray:
    """Area-average a [H, W, 3] u8 image to fit within (max_w, max_h) pixels.

    Integer box filter over an even grid (cheap, alias-free enough for a
    preview; the PNG keeps the full-resolution bytes).  Never upscales.
    """
    img = np.asarray(img)
    h, w = img.shape[:2]
    if w <= max_w and h <= max_h:
        return img
    # one scale factor, preserve aspect
    scale = min(max_w / w, max_h / h)
    ow = max(1, int(w * scale))
    oh = max(1, int(h * scale))
    # box filter via bucketed mean: pixel (i, j) of the output averages the
    # source rows/cols whose scaled index floors to (i, j)
    ys = np.minimum((np.arange(h) * oh) // h, oh - 1)
    xs = np.minimum((np.arange(w) * ow) // w, ow - 1)
    acc = np.zeros((oh, ow, 3), dtype=np.float64)
    cnt = np.zeros((oh, ow, 1), dtype=np.float64)
    np.add.at(acc, (ys[:, None], xs[None, :]), img.astype(np.float64))
    np.add.at(cnt, (ys[:, None], xs[None, :]), 1.0)
    return (acc / cnt).astype(np.uint8)


def to_ansi(img: np.ndarray, max_cols: int = 0, max_rows: int = 0) -> str:
    """Render an image as truecolor ANSI half-block text.

    img: [H, W, 3] float [0,1] or u8.  max_cols/max_rows bound the OUTPUT
    text size (each text row shows two image rows); 0 means no bound.
    Returns a string ending in a newline, colors reset at each line end.
    """
    img = quantize_u8(img)
    if max_cols or max_rows:
        img = downsample_u8(img, max_cols or img.shape[1],
                            2 * max_rows if max_rows else img.shape[0])
    h, w = img.shape[:2]
    if h % 2:  # pad the final odd row with black bottom halves
        img = np.concatenate([img, np.zeros((1, w, 3), np.uint8)], axis=0)
        h += 1
    top = img[0::2]
    bot = img[1::2]
    lines = []
    for y in range(h // 2):
        cells = []
        for x in range(w):
            tr, tg, tb = (int(v) for v in top[y, x])
            br, bg, bb = (int(v) for v in bot[y, x])
            cells.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                         f"\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(cells) + _RESET)
    return "\n".join(lines) + "\n"


def display_image(img: np.ndarray, out=None, wait: bool = False,
                  title: str = "Results") -> None:
    """Show the final framebuffer in the terminal (main.rs:229-270 analog).

    wait=True blocks until a key is pressed (q/Escape/anything — the SDL
    event-pump loop), only when stdin is a TTY.
    """
    out = out or sys.stdout
    try:
        cols, rows = os.get_terminal_size(out.fileno())
    except (OSError, ValueError):
        cols, rows = 100, 40
    out.write(f"-- {title} --\n")
    out.write(to_ansi(img, max_cols=cols, max_rows=max(4, rows - 3)))
    out.flush()
    if wait and sys.stdin.isatty():
        out.write("press any key to close...\n")
        out.flush()
        import termios
        import tty
        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        try:
            tty.setraw(fd)
            sys.stdin.read(1)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, saved)
