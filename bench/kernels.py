"""Per-kernel microbenchmarks with empirically-probed rooflines.

Probes (stream copy -> HBM GB/s; big bf16/f32 matmul -> TFLOP/s) establish
what THIS chip can do; each kernel row then reports achieved samples/s,
effective GB/s over its minimal HBM traffic, and the fraction of the
measured memory roofline that represents.  "Speed-of-light" for the
memory-bound DSP kernels here = the stream-copy bandwidth.

Traffic accounting: `bytes` counts the minimal algorithmic HBM traffic
(inputs read once + outputs written once).  A kernel at fraction ~1.0 is
making one fused pass; fractions far below 1.0 indicate extra materialized
intermediates or serialized passes -- the signal to look at the trace
before reaching for a kernel (SURVEY.md §7 M5).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from bench.util import Report, bench
from ofdm_jax.config import OfdmConfig
from ofdm_jax.kernels import fft as kfft
from ofdm_jax.ops import sync as ksync
from ofdm_jax.spectrum import channelizer as kchan
from ofdm_jax.spectrum import psd as kpsd

C64 = 8      # bytes per complex64 (travels as 2x f32 on the wire)
F32 = 4


def _noise(shape, seed=0, dtype=np.complex64):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.complexfloating):
        x = rng.randn(*shape) + 1j * rng.randn(*shape)
        return x.astype(dtype)
    return rng.randn(*shape).astype(dtype)


def probe_membw(report: Report, mb: int = 256) -> float:
    """Stream copy: y = x + 1 over `mb` MB of f32.  Returns GB/s."""
    n = mb * (1 << 20) // F32
    x = np.arange(n, dtype=np.float32) * 1e-6
    sec = bench(lambda a: a + 1.0, (x,))
    gbps = 2 * n * F32 / sec / 1e9  # read + write; scalar re-read ~free (fused)
    report.add(kernel="probe_stream_copy", mb=mb, sec=sec, gbps=gbps)
    return gbps


def probe_matmul(report: Report, n: int = 4096) -> float:
    """bf16 n^3 matmul.  Returns TFLOP/s."""
    a = _noise((n, n), 1, np.float32).astype(jnp.bfloat16)
    b = _noise((n, n), 2, np.float32).astype(jnp.bfloat16)
    sec = bench(
        lambda p, q: jnp.dot(p, q, preferred_element_type=jnp.float32),
        (a, b),
    )
    tflops = 2 * n**3 / sec / 1e12
    report.add(kernel="probe_matmul_bf16", n=n, sec=sec, tflops=tflops)
    return tflops


def bench_fft(report: Report, membw: float, mm_tflops: float):
    """Batched matmul-DFT at OFDM/PSD-relevant sizes.

    Protocol (r5): a SELF-CHAINED fori_loop of y = ifft(fft(y)) -- data
    dependence serializes iterations with ZERO harness passes (the loop
    carry IS the transform output), so frac_membw is exact, unlike the
    generic bench() whose perturb/reduce machinery adds up to ~1.5 passes
    of ambiguity on memory-bound rows.  Each iteration times TWO
    transforms; sec is per transform."""
    import time

    import jax.numpy as jnp

    from ofdm_jax.utils.device_io import maybe_encode, packed_io

    for batch, n in [(1 << 17, 64), (1 << 15, 256), (1 << 13, 1024),
                     (1 << 11, 4096)]:
        x = _noise((batch, n), seed=n)
        reps, n_iter, trials = 24, 4, 3

        def repeated(a, _n=n):
            def body(i, c):
                return kfft.ifft(kfft.fft(c))
            y = jax.lax.fori_loop(0, reps, body, a)
            return jnp.sum(jnp.real(y[:1, :8]))

        jfn = jax.jit(packed_io(repeated))
        d = jax.device_put(maybe_encode(x))
        jax.device_get(jfn(d))
        sec = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            jax.device_get([jfn(d) for _ in range(n_iter)])
            sec = min(sec, (time.perf_counter() - t0) / (n_iter * reps * 2))
        samples = batch * n
        # complex matmul = 4 real matmuls (+ four-step stages for n>256)
        stages = 1 if n <= 256 else 2
        flops = 8.0 * samples * (np.sqrt(n) if stages == 2 else n) * stages
        bytes_ = samples * C64 * 2  # in + out
        report.add(
            kernel=f"fft{n}", batch=batch, sec=sec,
            msamp_s=samples / sec / 1e6,
            gbps=bytes_ / sec / 1e9,
            frac_membw=bytes_ / sec / 1e9 / membw,
            tflops=flops / sec / 1e12,
            frac_matmul=flops / sec / 1e12 / mm_tflops,
            protocol="self-chained ifft(fft(.)), exact accounting",
        )


def bench_sync(report: Report, membw: float):
    """Schmidl-Cox stages over a steady-state block (n = 2^22: at the old
    2^20 the ~0.3 ms per-program floor dominated -- VERDICT r3 weak #2)."""
    spec = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
    n = 1 << 22
    x = _noise((n,), 3)

    # THE production detect stage: per-row summaries on the path this
    # backend runs (the kernels/detect.py kernels on a GPU)
    from ofdm_jax.utils.device_io import PackedComplex

    sec = bench(lambda a: ksync.detect_rows(
        spec, PackedComplex(jnp.real(a), jnp.imag(a))), (x,))
    # two f32 planes in, one f32 metric plane written and read back
    bytes_ = n * 16
    report.add(
        kernel="detect_rows", n=n, sec=sec, msamp_s=n / sec / 1e6,
        gbps=bytes_ / sec / 1e9, frac_membw=bytes_ / sec / 1e9 / membw,
    )

    sec = bench(lambda a: ksync.schmidl_cox(spec, a), (x,))
    # minimal traffic: read x (c64), write M/P/R (f32 + c64 + f32)
    bytes_ = n * (C64 + F32 + C64 + F32)
    report.add(
        kernel="schmidl_cox_metric", n=n, sec=sec,
        msamp_s=n / sec / 1e6, gbps=bytes_ / sec / 1e9,
        frac_membw=bytes_ / sec / 1e9 / membw,
        note="diagnostic API path (materializes full M/P/R streams + local "
             "energy gate); production detection rides detect_rows",
    )

    sec = bench(lambda a: ksync.detect_frames(spec, a, 8), (x,))
    report.add(
        kernel="detect_frames", n=n, sec=sec, msamp_s=n / sec / 1e6,
    )

    # K = 480 slot windows of max_frame_len (the receiver's slot gather)
    from ofdm_jax.modem.rx import gather_windows

    F = spec.max_frame_len
    starts = np.sort(np.random.RandomState(7).randint(0, n - F, 480)
                     ).astype(np.int32)
    sec = bench(lambda a, s: gather_windows(
        jnp.real(a), jnp.imag(a), s, F), (x, starts))
    bytes_ = 480 * F * C64 * 2
    report.add(
        kernel="slot_gather480", n=n, sec=sec, gbps=bytes_ / sec / 1e9,
        frac_membw=bytes_ / sec / 1e9 / membw,
    )

    # standalone window sum (lax.reduce_window): the plain detect path's
    # building block and the SyncMetric API's
    sec = bench(lambda a: ksync.moving_sum(a, 32), (np.abs(_noise((n, ), 4)).astype(np.float32),))
    bytes_ = n * (F32 * 2)
    report.add(
        kernel="moving_sum_w32", n=n, sec=sec,
        msamp_s=n / sec / 1e6,
        gbps=bytes_ / sec / 1e9, frac_membw=bytes_ / sec / 1e9 / membw,
    )


def bench_channelizer(report: Report, membw: float):
    """THE production path: channelize_stream with its tail carry, at
    64/256/512 channels (512 = BASELINE config 5), plus the one-shot
    zero-history channelize for comparison."""
    n = 1 << 23
    for n_chan in (64, 256, 512):
        x = _noise((n,), 5)
        taps = kchan.lowpass_taps(n_chan)
        poly = kchan.polyphase_decompose(taps, n_chan)
        tail = np.zeros(kchan.stream_tail_len(n_chan, taps), np.complex64)
        sec = bench(
            lambda a, t, nc=n_chan, tp=taps, pp=poly:
                kchan.channelize_stream(a, t, nc, tp, pp),
            (x, tail),
        )
        bytes_ = n * C64 * 2  # in + out; tail carry ~free
        report.add(
            kernel=f"channelize_stream{n_chan}", n=n, sec=sec,
            msamp_s=n / sec / 1e6, gbps=bytes_ / sec / 1e9,
            frac_membw=bytes_ / sec / 1e9 / membw,
        )

    x = _noise((n,), 5)
    taps = kchan.lowpass_taps(64)
    sec = bench(lambda a: kchan.channelize(a, 64, taps), (x,))
    bytes_ = n * C64 * 2
    report.add(
        kernel="pfb_channelizer64_oneshot", n=n, sec=sec,
        msamp_s=n / sec / 1e6, gbps=bytes_ / sec / 1e9,
        frac_membw=bytes_ / sec / 1e9 / membw,
    )


def bench_psd(report: Report, membw: float):
    """psd_frames as shipped (the XLA chain), 1-D and batched input."""
    n = 1 << 22
    for fft_len in (256, 1024):
        x = _noise((n,), 6)
        sec = bench(lambda a, fl=fft_len: kpsd.psd_frames(a, fl), (x,))
        bytes_ = n * (C64 + F32)
        report.add(
            kernel=f"psd_frames{fft_len}", n=n, sec=sec,
            msamp_s=n / sec / 1e6,
            gbps=bytes_ / sec / 1e9, frac_membw=bytes_ / sec / 1e9 / membw,
        )

    fft_len = 1024
    x = _noise((n,), 6)
    # the same chain over a (1, n) batch
    sec = bench(
        lambda a: kpsd.psd_frames(a.reshape(1, -1), fft_len)[0], (x,)
    )
    bytes_ = n * (C64 + F32)
    report.add(
        kernel=f"psd_frames{fft_len}_batched", n=n, sec=sec,
        msamp_s=n / sec / 1e6,
        gbps=bytes_ / sec / 1e9, frac_membw=bytes_ / sec / 1e9 / membw,
    )


def main():
    report = Report("kernels")
    print(f"# backend={jax.default_backend()} device={jax.devices()[0]}")
    membw = probe_membw(report)
    mm = probe_matmul(report)
    bench_fft(report, membw, mm)
    bench_sync(report, membw)
    bench_channelizer(report, membw)
    bench_psd(report, membw)
    report.save()


if __name__ == "__main__":
    main()
