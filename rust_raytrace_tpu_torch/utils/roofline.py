"""Measured device roofline: the card's fp32 FMA rate and stream bandwidth.

Counterpart: `rust_raytrace_tpu/utils/roofline.py` (`measure_vpu_peak`,
`measure_hbm_bw`).  The JAX package measures its denominators on the TPU
because that chip's clock and binning are not otherwise observable.  On
the H100 the published peaks below stay the denominators of every
roofline share (PERF.md §6, chip_smoke.py's bounds), stated beside the
card's power limit; these measurements are reported beside them, as what
the card in hand sustains, and replace nothing.

- fp32 FMA rate: a hand-written CUDA probe (`csrc/roofline.cu`,
  `native.FMA_PEAK`): each thread runs `nchains` independent fmaf chains
  in registers for `iters * UNROLL` steps.  Torch elementwise ops cannot
  measure this rate: each is a kernel of its own, bound by memory.  The
  JAX probe's (32, 384) over 1024x1024 arrays is a TPU shape; the chains
  a thread and the blocks an SM here are the knee of chip_smoke.py's
  sweep on the card.
- Stream bandwidth: `x.add_(y)` over two 256 MB float32 tensors (past the
  50 MB L2), 3 x 4 bytes an element an iteration (read x, read y, write
  x), as the JAX version streams `x = x + y` (XLA's own fused add there,
  not a Pallas kernel).

Both time the card with CUDA events after a warm-up and take the best of
`nruns`; both raise without a CUDA device.
"""

import numpy as np
import torch

from . import native

#: NVIDIA H100 SXM data sheet, at the full 700 W power limit: float32
#: outside the tensor cores, and HBM3
PUBLISHED_FP32_FLOP_PER_S = 67e12
PUBLISHED_HBM_BYTES_PER_S = 3.35e12

#: FMA steps of a probe thread's loop body, a chain (csrc/roofline.cu)
UNROLL = 32
#: the probe shape kept from chip_smoke.py's sweep on the card: the knee,
#: the fewest chains x blocks within 3% of the sweep's best (NVIDIA H100
#: 80GB HBM3, 700 W: 4 chains and 1 block of 256 threads an SM read 64.85
#: TFLOP/s, 16 x 8 the best 66.24; 1 chain 26.55-33.13, 2 chains
#: 43.30-44.41: latency-bound)
NCHAINS = 4
BLOCKS_PER_SM = 1
THREADS = 256
CHAINS = (1, 2, 4, 8, 16)
#: FLOPs of one probe launch when `iters` is not given: ~4 ms at the
#: published rate, so the launch's own overhead is noise
LAUNCH_FLOPS = 2.0 ** 38


def fma_peak_flops(threads: int, nchains: int, iters: int,
                   unroll: int = UNROLL) -> float:
    """FLOPs of one probe launch: 2 a fused multiply-add."""
    return 2.0 * threads * nchains * unroll * iters


def probe_iters(threads: int, nchains: int, flops: float = LAUNCH_FLOPS,
                unroll: int = UNROLL) -> int:
    """The loop count that gives a probe launch of `threads` threads about
    `flops` FLOPs."""
    return max(1, round(flops / fma_peak_flops(threads, nchains, 1, unroll)))


def stream_bytes(n: int, iters: int) -> float:
    """Bytes of `iters` x.add_(y) over n float32 elements each."""
    return 3.0 * 4 * n * iters


def _cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"roofline: measures a CUDA device, not {dev}")
    return dev


def _best_ms(fn, nruns: int) -> float:
    """Least CUDA-event time of fn() over nruns calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(nruns):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        best = ms if best is None else min(best, ms)
    return best


def measure_fp32_peak(nchains: int = NCHAINS,
                      blocks_per_sm: int = BLOCKS_PER_SM, nruns: int = 3,
                      device="cuda") -> float:
    """Returns the measured fp32 FMA throughput in FLOP/s (1 FMA = 2
    FLOPs): one probe launch of blocks_per_sm blocks an SM of THREADS
    threads, `nchains` chains a thread (one of CHAINS), `probe_iters`
    loops of UNROLL steps."""
    dev = _cuda(device)
    native.require(nchains in CHAINS, f"nchains {nchains} not in {CHAINS}")
    threads = torch.cuda.get_device_properties(dev).multi_processor_count \
        * blocks_per_sm * THREADS
    iters = probe_iters(threads, nchains)
    out = torch.empty((threads * nchains,), dtype=torch.float32, device=dev)
    a, b = float(np.float32(1.0000001)), 1e-12

    def launch():
        native.FMA_PEAK(out.data_ptr(), a, b, iters, nchains,
                        threads // THREADS, THREADS, native.stream(dev))

    ms = _best_ms(launch, nruns)
    if not torch.isfinite(out).all():
        raise AssertionError("fma_peak: a chain is not finite")
    return fma_peak_flops(threads, nchains, iters) / (ms / 1e3)


def measure_hbm_bw(iters: int = 16, mb: int = 256, nruns: int = 3,
                   device="cuda") -> float:
    """Returns the measured stream bandwidth in bytes/s."""
    dev = _cuda(device)
    n = mb * (1 << 20) // 4
    x = torch.arange(n, dtype=torch.float32, device=dev) * 1e-9
    y = torch.full((n,), 1e-9, dtype=torch.float32, device=dev)

    def loop():
        for _ in range(iters):
            x.add_(y)

    ms = _best_ms(loop, nruns)
    return stream_bytes(n, iters) / (ms / 1e3)
