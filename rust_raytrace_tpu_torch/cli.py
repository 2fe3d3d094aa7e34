"""Command-line application (the reference's `raytrace` binary, main.rs:89-273).

The torch port's counterpart of `rust_raytrace_tpu/cli.py`, with the same
subcommands, options and defaults, so that a command line of the JAX
package runs unchanged here.  The JAX CLI picks the TPU, or interpret mode
off it; this one takes `--device` (default `cuda`), and with `--device
cuda` and no card it exits with an error rather than render on the CPU.
`--device cpu` runs every kernel's plain torch version.  Backend names are
the JAX package's: `engine` is the Engine; `simple`, `pallas` and
`pallas_interpret` are the WavefrontRenderer's "kernel" backend (B11),
`xla` its "portable" one; `oracle` is the numpy reference renderer.

Subcommands:
  render   — render a scene to PNG with any backend, print the stats report
             (print_stats semantics, progress.rs:157-184), optionally dump
             per-ray debug CSVs (debug.rs format)
  diff     — differential-compare two renders per pixel/ray (the
             main.rs:206-227 dual-render + compare_to flow)
  tune     — hill-climb (page_size, ray_chunk) for the engine, the analog of
             the reference's octree-parameter tuner `optimize()`
             (main.rs:20-62)

Examples:
  python -m rust_raytrace_tpu_torch.cli render --scene teapot \
      --resolution 2k --out test.png --stats
  python -m rust_raytrace_tpu_torch.cli render --device cpu \
      --scene circles --resolution 64x64
  python -m rust_raytrace_tpu_torch.cli diff --scene teapot \
      --resolution dev --a engine --b oracle
  python -m rust_raytrace_tpu_torch.cli tune --scene teapot --resolution 2k
"""

import argparse
import sys
import time

import numpy as np
import torch

from .models import REGISTRY
from .utils import png
from .utils.progress import create_ctx
from .utils.rng import prng_key

#: the ray chunks `tune` walks (the JAX CLI's grid) and the steps of 8 from
#: the engine's page size it tries
CHUNK_OPTS = (256, 512, 1024, 2048, 4096)
PAGE_STEPS = range(-2, 5)


def build_scene(args):
    build = REGISTRY[args.scene]
    res = args.resolution
    if isinstance(res, str) and "x" in res and res[0].isdigit():
        w, h = res.split("x")
        res = (int(w), int(h))      # explicit WxH, e.g. --resolution 640x480
    kwargs = dict(resolution=res, maxdepth=args.maxdepth, samples=args.spp)
    if getattr(args, "lights", False):
        if args.scene != "teapot":
            raise SystemExit("--lights is wired for the teapot scene")
        kwargs["with_light"] = True
    if getattr(args, "obj", None):
        if args.scene not in ("obj", "teapot"):
            raise SystemExit("--obj applies to the 'obj' (or teapot) scene")
        kwargs["obj_path"] = args.obj
        if args.scene == "obj":
            kwargs["scale"] = args.obj_scale
    elif args.scene == "obj":
        raise SystemExit("the 'obj' scene needs --obj PATH")
    return build(**kwargs)


def device_of(args) -> torch.device:
    """The device every renderer of this run uses: the card unless the
    caller asked for the CPU.  No card for --device cuda is an error."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch sees no CUDA device (pass "
                         "--device cpu to render on the CPU)")
    return dev


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_renderer(name: str, scene, args):
    dev = args.device
    if name == "engine":
        from .engine import Engine
        return Engine(scene, page_size=args.page_size,
                      ray_chunk=args.ray_chunk, device=dev)
    if name in ("simple", "xla", "pallas", "pallas_interpret"):
        from .render import WavefrontRenderer
        backend = "portable" if name == "xla" else "kernel"
        return WavefrontRenderer(scene, page_size=args.page_size,
                                 ray_chunk=args.ray_chunk, backend=backend,
                                 device=dev)
    if name == "oracle":
        return None
    raise SystemExit(f"unknown backend {name!r}")


def run_render(backend_name, scene, vp, args, key_seed=0):
    from . import oracle

    if backend_name == "oracle":
        t0 = time.perf_counter()
        stats = oracle.OracleStats()
        debug_ctx = octree = None
        if args.debug_csv is not None:
            # record per-ray candidate sets from an octree walk
            # (raytrace.rs:1018-1021) for the differ
            from .octree import build_bounding_box
            from .utils.raydebug import DebugCtx
            corners = scene.tris.corners[1:].reshape(-1, 3)
            center = (corners.min(axis=0) + corners.max(axis=0)) / 2
            len2 = float((corners.max(axis=0) - corners.min(axis=0)).max())
            octree = build_bounding_box(scene.tris, center, len2 + 0.1,
                                        maxdepth=10, minobjs=19)
            debug_ctx = DebugCtx()
        img = oracle.render(scene.tris, vp, rng=oracle.NumpyRng(key_seed),
                            stats=stats, debug_ctx=debug_ctx, octree=octree)
        seconds = time.perf_counter() - t0
        from .render import RenderResult
        result = RenderResult(image=img, rays_traced=stats.rays,
                              wave_rays=np.asarray([stats.rays]),
                              primary_t=None, primary_id=None,
                              seconds=seconds)
        result.debug_ctx = debug_ctx
        return result

    r = make_renderer(backend_name, scene, args)
    kwargs = {}
    if backend_name == "engine":
        kwargs = dict(debug=args.debug_csv is not None, quantize=not args.f32)
        if getattr(args, "band_rows", None):
            if args.debug_csv is not None:
                raise SystemExit("--debug-csv needs the full-image render "
                                 "(banded renders carry no debug buffers)")
            del kwargs["debug"]
            return r.render_banded(vp, key=prng_key(key_seed),
                                   band_rows=args.band_rows, **kwargs)
    return r.render(vp, key=prng_key(key_seed), **kwargs)


def cmd_render(args):
    scene, vp = build_scene(args)
    progress = create_ctx(vp.width, vp.height, enable_io=args.progress)
    result = run_render(args.backend, scene, vp, args)
    progress.update_wavefront(result)
    progress.finish()

    if args.out:
        png.write_png(args.out, result.image)
        print(f"wrote {args.out}")
    if args.stats:
        progress.print_stats()
    if args.debug_csv:
        if result.primary_id is None:
            print("debug buffers unavailable for this backend", file=sys.stderr)
        else:
            from .utils.raydebug import from_render_result
            ctx = from_render_result(result, vp)
            with open(args.debug_csv, "w") as f:
                ctx.write_debug_header(f)
                ctx.write_all_debug_context(f)
            print(f"wrote {args.debug_csv}")
    if args.golden:
        golden = png.read_png(args.golden)
        r = png.rmse(png.quantize_u8(result.image), golden)
        print(f"rmse vs {args.golden}: {r:.6f}")
    if args.view:
        # the reference's SDL results window (main.rs:229-270), headless:
        # truecolor terminal blit, block for a key like the SDL event pump
        from .utils.term_display import display_image
        display_image(result.image, wait=args.view == "wait")


def cmd_diff(args):
    scene, vp = build_scene(args)
    args.debug_csv = "x"  # force debug buffers on
    ra = run_render(args.a, scene, vp, args)
    rb = run_render(args.b, scene, vp, args)

    img_diff = np.abs(ra.image.astype(np.float64) / (255.0 if ra.image.dtype == np.uint8 else 1.0)
                      - rb.image.astype(np.float64) / (255.0 if rb.image.dtype == np.uint8 else 1.0))
    print(f"image rmse: {np.sqrt((img_diff ** 2).mean()):.6f}  "
          f"max: {img_diff.max():.6f}")

    from .utils.raydebug import from_render_result

    def ctx_of(r):
        if getattr(r, "debug_ctx", None) is not None:
            return r.debug_ctx
        if r.primary_id is not None:
            return from_render_result(r, vp)
        return None

    ctx_a, ctx_b = ctx_of(ra), ctx_of(rb)
    if ctx_a is not None and ctx_b is not None:
        err = ctx_a.compare_to(ctx_b, sys.stdout)
        return 1 if err else 0
    return 0


def cmd_tune(args):
    """Hill-climb (page_size, ray_chunk) — reference optimize(), main.rs:20-62.

    The candidate grid adapts to the scene: page sizes span 40..page_size+32
    around the engine's auto-bumped default (big scenes force larger pages),
    and the walk starts from the engine defaults.  Each timed render ends
    in a device synchronize before the clock is read."""
    from .engine import Engine

    dev = args.device
    scene, vp = build_scene(args)
    auto_ps = Engine(scene, device=dev).page_size     # after the auto bump
    page_opts = sorted({max(40, auto_ps + 8 * k) for k in PAGE_STEPS})
    chunk_opts = list(CHUNK_OPTS)
    runtimes = {}

    def run(ps, rc):
        if (ps, rc) not in runtimes:
            print(f"Running iteration page_size={ps} ray_chunk={rc}")
            eng = Engine(scene, page_size=ps, ray_chunk=rc, device=dev)
            eng.render(vp)  # plan the boundary schedule
            eng._auto_schedule = False
            eng.render(vp)  # warm up on the planned schedule
            _sync(dev)
            t0 = time.perf_counter()
            eng.render(vp, key=prng_key(1))
            _sync(dev)
            runtimes[(ps, rc)] = time.perf_counter() - t0
            print(f"Runtime: {runtimes[(ps, rc)]:.3f}")
        return runtimes[(ps, rc)]

    pi = page_opts.index(min(page_opts, key=lambda p: abs(p - auto_ps)))
    ci = chunk_opts.index(min(chunk_opts, key=lambda c: abs(c - 1024)))
    while True:
        best = None
        for dp in (-1, 0, 1):
            for dc in (-1, 0, 1):
                p, c = pi + dp, ci + dc
                if 0 <= p < len(page_opts) and 0 <= c < len(chunk_opts):
                    t = run(page_opts[p], chunk_opts[c])
                    if best is None or t < best[0]:
                        best = (t, p, c)
        if (best[1], best[2]) == (pi, ci):
            break
        pi, ci = best[1], best[2]
    print(f"Found minimum at page_size={page_opts[pi]} "
          f"ray_chunk={chunk_opts[ci]} ({runtimes[(page_opts[pi], chunk_opts[ci])]:.3f}s)")


def main(argv=None):
    # env_logger::init() analog (main.rs:91): RUST_RAYTRACE_LOG=debug enables
    # depth-indented per-ray/per-box traversal tracing on the oracle paths
    from .utils.tracelog import init_from_env
    init_from_env()

    p = argparse.ArgumentParser(prog="rust_raytrace_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="teapot", choices=sorted(REGISTRY))
        sp.add_argument("--resolution", default="dev")
        sp.add_argument("--maxdepth", type=int, default=5)
        sp.add_argument("--spp", type=int, default=1)
        sp.add_argument("--page-size", type=int, default=56)
        sp.add_argument("--ray-chunk", type=int, default=1024)
        sp.add_argument("--lights", action="store_true",
                        help="enable the shadow-ray light (teapot scene)")
        sp.add_argument("--obj", help="path to a user .obj mesh "
                                      "(--scene obj; auto-framed camera)")
        sp.add_argument("--obj-scale", type=float, default=1.0,
                        help="uniform scale applied to --obj vertices")
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the renderers run: the card (its "
                             "kernels), or the CPU (their plain versions)")

    sp = sub.add_parser("render", help="render a scene to PNG")
    common(sp)
    sp.add_argument("--backend", default="engine",
                    choices=["engine", "simple", "xla", "pallas",
                             "pallas_interpret", "oracle"])
    sp.add_argument("--out", default="test.png")
    sp.add_argument("--band-rows", type=int, default=0,
                    help="render in horizontal bands of this many rows "
                         "(engine backend; bounds device memory for huge "
                         "resolutions — the reference's row-queue analog)")
    sp.add_argument("--stats", action="store_true")
    sp.add_argument("--progress", action="store_true")
    sp.add_argument("--debug-csv")
    sp.add_argument("--golden", help="golden PNG to compare against (rmse)")
    sp.add_argument("--f32", action="store_true",
                    help="keep a float framebuffer (no device quantization)")
    sp.add_argument("--view", nargs="?", const="show", default=None,
                    choices=["show", "wait"],
                    help="display the result in the terminal (ANSI "
                         "truecolor); 'wait' blocks for a key like the "
                         "reference's SDL window")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("diff", help="differential-compare two backends")
    common(sp)
    sp.add_argument("--a", default="engine")
    sp.add_argument("--b", default="simple")
    sp.add_argument("--f32", action="store_true")
    sp.set_defaults(fn=cmd_diff)

    sp = sub.add_parser("tune", help="hill-climb engine parameters")
    common(sp)
    sp.set_defaults(fn=cmd_tune)

    args = p.parse_args(argv)
    if not hasattr(args, "debug_csv"):
        args.debug_csv = None
    if not hasattr(args, "f32"):
        args.f32 = False
    args.device = device_of(args)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
