"""tpufft_torch imports with neither jax nor tpufft loaded, and builds
nothing at import, neither the CUDA library nor the native host engine
(checked in a fresh interpreter)."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = textwrap.dedent("""
        import sys
        import tpufft_torch
        import tpufft_torch.convert, tpufft_torch.execute, tpufft_torch._build
        import tpufft_torch.kernels.minor_fft
        import tpufft_torch.kernels.inner_fft, tpufft_torch.kernels.pair_fft
        import tpufft_torch.kernels.cube_fft, tpufft_torch.kernels.mid_pair_fft
        import tpufft_torch.kernels.fused_fft
        import tpufft_torch.kernels.real_fft, tpufft_torch.kernels.dense_mm
        import tpufft_torch.signal, tpufft_torch.realtrans
        import tpufft_torch.czt, tpufft_torch.fhtlog
        import tpufft_torch.kernels.stft_mm, tpufft_torch.spectral
        import tpufft_torch.shorttime, tpufft_torch.windows
        import tpufft_torch.design, tpufft_torch.iir, tpufft_torch.multirate
        import tpufft_torch.sigtools, tpufft_torch.ndimage
        import tpufft_torch.ltisys, tpufft_torch.waveforms
        import tpufft_torch.peaks, tpufft_torch.bsplines
        import tpufft_torch.backend, tpufft_torch.native
        import tpufft_torch.parallel
        assert "jax" not in sys.modules, "jax was imported"
        assert "tpufft" not in sys.modules, "tpufft was imported"
        assert "triton" not in sys.modules, "triton was imported"
        assert tpufft_torch._build.load.cache_info().currsize == 0
        assert tpufft_torch.native._lib.cache_info().currsize == 0
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
