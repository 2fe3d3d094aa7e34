"""The port's roofline (`rust_raytrace_tpu_torch/utils/roofline.py`) on the
CPU: its operation and byte counts from the shapes, and its refusal to
measure anything but a CUDA device."""

import pytest
import torch

from rust_raytrace_tpu_torch.utils import native, roofline


def test_published_peaks():
    """The H100 SXM data sheet's, at 700 W."""
    assert roofline.PUBLISHED_FP32_FLOP_PER_S == 67e12
    assert roofline.PUBLISHED_HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("threads,nchains,iters", [
    (132 * 4 * 256, 4, 4096), (256, 1, 1), (33 * 1024, 16, 7)])
def test_fma_peak_flops(threads, nchains, iters):
    """2 FLOPs a fused multiply-add, UNROLL of them a chain a loop."""
    want = 2 * threads * nchains * roofline.UNROLL * iters
    assert roofline.fma_peak_flops(threads, nchains, iters) == want


def test_probe_iters_sizes_a_launch():
    for nchains in roofline.CHAINS:
        threads = 132 * 4 * 256
        it = roofline.probe_iters(threads, nchains)
        flops = roofline.fma_peak_flops(threads, nchains, it)
        assert abs(flops / roofline.LAUNCH_FLOPS - 1) < 0.01
    assert roofline.probe_iters(1 << 30, 16) == 1


def test_stream_bytes():
    """x.add_(y): read x, read y, write x, 4 bytes each, an iteration."""
    n = 256 * (1 << 20) // 4
    assert roofline.stream_bytes(n, 16) == 3 * 4 * n * 16
    assert roofline.stream_bytes(n, 1) == 3 * 256 * (1 << 20)


def test_probe_is_not_a_render_kernel():
    assert native.FMA_PEAK not in native.KERNELS
    assert native.FMA_PEAK.source.endswith("csrc/roofline.cu")


@pytest.mark.parametrize("fn", ["measure_fp32_peak", "measure_hbm_bw"])
def test_measure_refuses_the_cpu(fn, monkeypatch):
    """A CPU device always, and the default device where torch sees no
    CUDA device."""
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(roofline, fn)(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(roofline, fn)()
