"""Smoke run of tpufft_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits nonzero) on failure:

1. the card: ``nvidia-smi``'s name and power limit, and PyTorch's device
   name; no card is an error, never a CPU run;
2. the build of the CUDA sources in ``tpufft_torch/csrc``, one ``nvcc``
   per source, started together (time and ptxas's resource report);
3. the minor-axis kernel against its plain PyTorch version on the card, on a
   ragged batch of 257 rows: every power-of-two length of the line form (2
   to 4096: one warp's lanes for n <= 64, each four-step geometry to 2048,
   three factors at 4096), every mixed-radix length of it (3, 5 and 15
   times a power of two, 93, 1000, 1080, 2160), every three-factor length
   above 4096 (4320 to 16384) and the stage form's length classes (127,
   1792, 4100), each
   printed with its form (``minor_fft.form``), forward and inverse, scale
   1 and 1/n, f32 and bf16 storage;
4. the main path, ``plan_fft`` + ``fft``/``ifft`` on c64 ``SplitComplex``
   planes at (100000, 1024) and (1000000, 93): rows against ``np.fft.fft``,
   the round trip, the launch counts (the kernel ran, its plain version
   did not) and the form the library launched (the line form at both);
5. times by CUDA events (median of 20 after warm-up) at both shapes: the
   main path, the kernel, its plain version, ``torch.fft.fft`` (cuFFT, a
   baseline only), a device copy of both planes (the floor) and the
   kernel's stage form (``stages=True``), with the kernel held against its
   plain version at those shapes;
6. the strided-axis kernel (K2 and K3, with and without the (n, M)
   twiddle) and the pair kernel (K4) against their plain versions, on
   ragged pre and post edges: lengths 8 to 16384, pairs (8, 93) to
   (160, 48), both directions, scale 1 and 1/n, f32 and bf16 storage;
   then every length of the strided kernel's line form (n = r 2^a, r in
   {1, 3, 5}, 8 to 2048; 15 2^a, 30 to 1920; 25, 93, 1080) on a ragged
   (3, n, 241), K2 and K3 with the twiddle, each printed with its form
   (``inner_fft.form``: line or stage);
7. the new paths at full size, each driven with every count set to 0
   just before it and read just after: ``fft2`` on (100, 640, 480) (K2 +
   K1), ``fftn(axes=(1, 2, 3))`` on (10, 128, 128, 128) (K3 + K4), the
   two-pass ``fft`` on (16, 1048576) (K3 with the twiddle and the
   swapped store + K2) and
   Bluestein ``fft`` on (10000, 4099) (K1 twice), each against
   ``np.fft`` on a few slices and through the round trip;
8. times at those shapes: the path, each kernel alone at the shape the
   path gives it, its plain version, cuFFT (a baseline only) and a device
   copy of both planes, plus the old movedim route of the strided axis and
   K4's packed form on (200000, 8, 93) beside ``fft2`` and its copy floor;
   K2 and K3 printed with their form and geometry, and K2 also timed on
   ``rfft2``'s (100, 640, 241);
9. the real-transform kernels K7 (rfft) and K8 (irfft), K9 (the zero-pad
   DFT, K1 with the pad in its load) and K4 with ``n2_in`` against their
   plain versions on ragged batches: even and odd real lengths 2 to 32768
   (every length of K7's and K8's line form among them: 256 to 8192 at
   power-of-two halves, the 29 mixed-radix halves of
   ``real_fft._REAL_STEP`` (n = 24 to 7680) and odd n = 93; each length
   printed with its form, ``real_fft.form``), pads (1 -> 2),
   (33 -> 64), (93 -> 128), (1000 -> 1024), (1024 -> 2048), (2047 ->
   4096), (300 -> 384) and (n - 1 -> n) at every mixed-radix and
   three-factor length on K9's line form, (5000 -> 8192) and (4099 ->
   8320) on it too and (3000 -> 4100) on the stage form (each printed with
   its form, ``minor_fft.form``), pairs (64, 93
   -> 128) and (120, 100 -> 128), scale 1 and 1/n, f32 and bf16 storage;
10. the real and padded paths at full size, each call driven with every
    count set to 0 just before it and read just after: ``rfft`` and
    ``irfft`` on (100000, 1024) (K7, K8), ``rfft`` on (1000000, 93) (K7,
    odd n), ``rfft2`` and ``irfft2`` on (100, 640, 480) (K7 + K2, K2 + K8),
    ``fft(n="fast-aligned")`` on (1000000, 93) -> 128 (K9) and
    ``fft2(s=(64, 128))`` on (10000, 64, 93) (K4 with ``n2_in``), each
    against ``np.fft`` on a few slices and through its round trip;
11. times at those shapes: the path, each kernel alone (K7 and K8 with
    their form), its plain version, cuFFT (a baseline only) and the copy
    floor (one read of the input and one write of the output), K8's line
    form beside its stage form (kept in the library) at n = 1024, the
    ``rfft`` path split into K7, the interleave of its planes and the
    rest, K7 alone at (400000, 256) and (12500, 8192) beside
    ``torch.fft.rfft``, K8 alone there beside its stage form and
    ``torch.fft.irfft``, K9 alone at (1000000, 93 -> 128), (100000, 1024
    -> 2048) and (10000, 2047 -> 4096) beside its stage form (kept in the
    library), ``torch.fft.fft(x, n)`` and the copy floor, plus ``rfft``
    along a non-minor axis (movedim + K7 + movedim back);
12. the dense-matrix kernels K10 (complex), K11 (real) and K12 (real, the
    DCT/DST table) against their plain versions (f32 matmuls, TF32 off) on
    ragged batches of 257 rows: squares 2 to 512, rectangles (93 -> 128),
    (128 -> 93) and (36 -> 100), and every DCT/DST (kind, type, norm,
    direction) at n = 2 to 1024; each on its body (``dense_mm.form``: the
    3xTF32 tensor-core body where both lengths are multiples of 4, for K10
    the block product [Xr | Xi] [[Wr, Wi], [-Wi, Wr]], else the FMA body)
    at batches of 1, 127, 129 and 257 rows, and on edge-value rows (+-Inf,
    NaN, 3.4e38, FLT_MAX, rows scaled by 1e-20 and 1e18) whose Inf and NaN
    must fall where the plain version's do;
13. the filtering, convolution, DCT/DST, czt and fht paths at full size,
    each call driven with every count set to 0 just before it and read just
    after: ``hilbert`` (100000, 512) (K10), a low-pass ``plan_filter(512)``
    on real (K11) and c64 (K10) rows, ``dct``/``idct`` (100000, 1024) and
    ``dst``/``idst`` type 4 (100000, 93) (K12), ``fftconvolve`` (100, 640,
    480) with a (1, 31, 31) kernel, ``oaconvolve`` (16, 2000000) with
    (1, 1025), ``resample`` (10000, 4800) -> 4410, ``envelope`` (10000,
    4096), ``czt`` (100000, 1024) -> 1024 on a zoomed arc (K9 + K1) and
    ``fht``/``ifht`` (100000, 1024) (K7 + K8), each against scipy in
    float64 on a few rows and through its round trip where it has one;
14. times: each of those paths, K10, K11 and K12 alone at their paths'
    shapes, their plain versions and ``torch.matmul`` on the same operands
    (cuBLAS, a yardstick only); for each the body it runs, its operations
    bound on the FP32 cores beside the 3xTF32 one, and the FMA body's time
    (for K10 the form it had before the tensor-core one); for K11 and K12
    ``torch.matmul`` with ``allow_tf32`` (one TF32 product:
    informational, it fails the 1e-5 check); and the filter's
    dense route (K10) against its composed route (K1, multiply, K1) on
    (100000, n) for n = 64 to 512;
15. the short-time Fourier kernels K13 (overlapped-frame STFT, an FFT of
    each frame in shared memory), K14 (inverse STFT with overlap-add; each
    case printed with its form, ``stft_mm.istft_form``, and also run on
    the dense body with the same function as a matrix, ``istft_ola``, and
    twice to the same bits) and K15 (Welch and CSD accumulators on K13's
    frame FFT) against their plain versions: hop 128, 64 and 32, nperseg
    128 to 1024, nfft >
    nperseg, detrend False, "constant" and "linear", batches of 1, 3 and
    70 rows, f32 and bf16 signals; for K13 and K15 also odd nfft (255,
    93), a hop longer than a frame, hop 1, ragged last runs of frames, and
    for K13 a ShortTimeFFT's window and per-bin factor (onesided2X, psd
    scaling, a phase shift); K15 run twice on each case gives the same
    bits;
16. the spectral paths at full size on (64, 1048576) f32 signals, each call
    driven with every count set to 0 just before it and read just after:
    ``stft(nperseg=256)`` (K13), its ``istft`` (K14), ``welch`` (K15),
    ``csd`` and ``coherence`` of two signals (K15), ``spectrogram`` at
    hop 128 (K13), ``ShortTimeFFT(hann(128), hop=64, fs=48000)``'s
    ``stft`` and ``istft`` (K13, K14), ``periodogram`` of (64, 16384) (K7)
    and ``lombscargle`` of 20000 samples at 4000 frequencies, each against
    scipy in float64 on a few rows (limit 1e-4) and through the round
    trips;
17. times: those paths, K13, K14 and K15 (welch, csd) alone at their
    paths' shapes (each bound by its bytes: the signal read once and the
    planes written once, or the planes read and the signal written; their
    operations are the FFT's), their plain versions and the PyTorch
    yardsticks:
    ``torch.stft(center=False)`` for K13, ``torch.istft`` for K14 and
    ``torch.stft`` then ``abs() ** 2`` and a sum (a short composition) for
    K15; K14's line form beside its dense body (kept in the library) at
    nfft = 256, and K13 and K14 at ShortTimeFFT's hop 64 (K14 with its
    form);
18. the thread-block-cluster kernels K5 (the trailing cube) and K6 (two
    middle axes of (pre, n1, n2, L)) against their plain versions: cubes
    (8, 8, 8) to (64, 64, 64) and (24, 40, 56) (clusters of 1 to 16
    blocks), pairs (8, 16, 128) to (128, 512, 3) and (160, 160, 12) to
    (120, 5, 11), among them (64, 128, 37) (a ragged L), pre 3 and 5, both directions, scale 1 and 1/N, f32 and
    bf16 storage; which form of each kernel each shape runs (the line
    form for power-of-two axes up to 64 for K5, up to 128 for K6; K6's
    generic-radix form for its other pairs of r 2^a, r in 1, 3, 5, 7, 15,
    up to 240, and 256, such as (160, 160), (48, 160), (56, 56),
    (256, 128) and (240, 120); else the stage form) and how many clusters
    of each kernel the card holds at once
    (``cudaOccupancyMaxActiveClusters``), as SMs kept busy;
19. the ND paths at full size, each call driven with every count set to 0
    just before it and read just after: ``fftn(axes=(1, 2, 3))`` on
    (100, 64, 64, 64) (K5 once, K3 and K4 never), ``fftn`` over every axis
    of (1, 64, 64, 64, 64) (K3 once, then K5), ``fftn(axes=(1, 2))`` on the
    channels-last (32, 64, 128, 128) (K6 once, the strided kernel never),
    each against ``np.fft`` on a few slices and through its round trip,
    and the backward of the cube path against numpy;
20. times: those paths, K5 and K6 alone, their plain versions, cuFFT
    (``torch.fft.fftn``, a yardstick only), the routes they replace (K3 +
    K4 for the cube, K3 + K2 for the pair) and the copy floor, with K5's
    form and clusters at once beside K3 + K4 and cuFFT, K6's form beside
    its stage form, K3 + K2 and cuFFT; and K6 (its form and the stage
    form) against the two strided passes at about 268 MB for L = 1 to
    512, the sweep behind ``execute.MID_PAIR_MIN_L``;
21. the fused-storage kernels K16 (cube), K17 (pair), K18 (a leading
    axis, M > 1), K19 (the axis next to the minor one, M = 1) and K20 (the
    minor axis, on every power-of-two half and every mixed-radix length
    of K1's line form and on the stage form, each printed with its form)
    against their plain versions:
    halves 2 to 16384 (93 among them), ragged pre, B and M, the cubes of
    phase 18 (clusters of 1 to 16 blocks), K18 and K19 at every length of
    the strided line form (halves L = 2 to 256; each printed with its
    form), both directions, scale 1 and 1/N, f32 and bf16 storage;
22. the layouts at full size, each call driven with every count set to 0
    just before it and read just after: lane-fused ``plan_fft`` of
    (100, 64, 64, 64) axes 1-3 (K16 once; P1) and its bf16 form (P1b),
    of (1, 64, 64, 64, 64) axes 1-4 (K18, K16; P2), of (10, 128, 128, 128)
    (K18, K17; P3), of (16, 64, 128, 256) (K18, K19, K20; P4), and
    transform-major plans of (1000000, 93) along its minor axis (K2 on the
    physical (93, 1000000); T1) and of (1, 25, 160, 160, 48) axes 1-4 (the
    natural rules on (1, 25, 48, 160, 160): K3, K6, K1; T2), each against
    ``np.fft`` on a few unpacked slices and through its inverse plan, and
    the backward of P1;
23. times: each layout path, ``pack`` and ``unpack``, the natural-layout
    plan on the same logical data, cuFFT (a yardstick only) and the copy
    floor; each fused kernel alone at its path's shape beside its
    split-plane sibling on the same data (K5, K4, K3, K2, K1), its plain
    version and one ``torch.fft`` call of the same function (K16 and its
    bf16 form also beside K3 + K4 on the same data; K18 and K19 with their
    form); and K18
    against K3 on the same 268 MB for halves L = 2 to 64, where a half is
    shorter than a 32-byte sector;
24. the multirate, IIR, sigtools and ndimage paths at full size, each
    call driven with every count set to 0 just before it and read just
    after (no plain version may run; the FFT-convolution paths must launch
    kernels): ``decimate(x, 4)`` (the IIR zero-phase path: Chebyshev-I
    sections on the log-depth scan, forward and backward) and
    ``decimate(x, 4, ftype="fir")``, ``resample_poly(x, 3, 2)``,
    ``lfilter(*butter(2, 0.2), x, zi=...)`` (the companion scan) and
    ``lfilter(firwin(101, 0.2), 1, x)`` (one FFT convolution),
    ``savgol_filter(x, 101, 3)`` on (64, 1048576) f32; ``wiener`` on a
    (4096, 4096) f32 image; ``medfilt2d`` on a (2048, 2048) f32 tensor
    (``unfold`` and ``kthvalue`` on the card); and ``fourier_gaussian``
    between ``rfftn`` and ``irfftn`` of (100, 640, 480), each against
    scipy in float64 (4 rows of the signals, the whole images, 4 of the
    volumes; limit 1e-3), with its launches per kernel, its time (CUDA
    events, median of 5 after a warm-up), its peak device memory above
    what was allocated before the call, and the byte floor of reading its
    input and writing its output once at the copy rate;
25. the design, LTI and waveform paths at full size, each call driven with
    every count set to 0 just before it and read just after, with a
    tensor's ``cpu``/``numpy``/``item``/``tolist`` refused during the call
    (no host copy): ``freqz`` of ``firwin(101, 0.2)`` as a CUDA f32 tensor
    at ``worN=2048`` (n_fft 4096: K9 once), of a (129, 16384) bank of taps
    along axis 0 at ``worN=1024`` (K2) and of one (65537,) FIR at
    ``worN=2**20`` (n_fft 2**21: the two-pass split, K3 + K2), each against
    scipy's float64 ``freqz`` (4 filters of the bank; limit 1e-5 of the
    response's size); ``dlsim`` of a seeded stable 8-state, 4-input,
    2-output system (``cont2discrete``, zoh) on a (1048576, 4) f32 input
    with ``x0`` (the log-depth scan, no kernel) against scipy's float64
    ``dlsim`` (limit 1e-3); and ``chirp`` (linear, logarithmic, complex),
    ``sweep_poly``, ``gausspulse(retquad=True, retenv=True)``, ``sawtooth``
    and ``square`` on a (64, 1048576) f32 time grid (no kernel) against
    scipy on 4 rows, every phase under 2 pi 100 rad, so the limit is 8 f32
    epsilons of that (6e-4), and for the square wave the share of samples
    on the other side of an edge (limit 1e-3); each timed (median of 5)
    with its peak device memory and byte floor, as in phase 24. Phase 25
    runs alone after the build with
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build();
    c.phase_design_paths(c._copy_rate())"``;
26. peak finding and the B-spline filters at full size, each call driven
    with every count set to 0 just before it and read just after, no
    plain version and no host copy allowed (``find_peaks``' tie order
    among equal heights within the distance and ``find_peaks_cwt``'s
    maxima coordinates may copy once; the copies are counted and their
    bytes printed): ``find_peaks`` with all seven conditions
    (``wlen=1001``) and with ``prominence=0.02`` alone (unbounded walks)
    on a (16777216,) f32 spectrum of ~20000 Gaussian lines on a slow
    baseline with white noise, rounded to multiples of 2**-10 (plateaus
    and equal heights), against scipy in float64 (indices equal,
    properties within 1e-12 of their size), with the thinning's rounds;
    ``argrelmax(axis=1, order=5)`` and ``argrelmin(..., mode="wrap")`` on
    (64, 1048576) f32 (index tuples equal to scipy's);
    ``find_peaks_cwt(x, np.arange(1, 33))`` on a (131072,) f32 spectrum of
    the same kind (indices equal; the copy's bytes and the host ridge
    walk's time); ``cspline1d``, ``qspline1d``, ``symiirorder1(x, 1,
    -2 + sqrt(3))``, ``cspline1d(x, 2.5)`` and ``symiirorder2(x, 0.5,
    pi/4)`` on (16777216,) f32 against scipy in float64 (1e-5 of the
    output's size; for the last two away from 64 samples of each end,
    plus the folded taps applied to the result giving x back everywhere,
    1e-5 of x's size); ``cspline1d_eval`` at 4194304 points over
    [-N/2, 3N/2] (1e-5); ``cspline2d``, ``qspline2d``, ``sepfir2d`` with a
    7-tap and a 5-tap kernel and ``spline_filter`` at 3.0 (interior
    [4:-4, 4:-4], 1e-3) and at 5.0 (where scipy raises: the defining
    equations, 1e-5) on a (4096, 4096) f32 image. Each line prints the
    error, the launches per kernel (none), the torch kernels of one
    profiled call and the device's idle share in it, the time (median of
    5), the peak memory above the inputs and the byte floor, beside the
    card's name and power limit. Phase 26 runs alone after the build with
    ``python3 -c "import chip_smoke as c; c.phase_device(); c.phase_build();
    c.phase_peaks_spline_paths(c._copy_rate())"``;
27. the scipy.fft backend, the native host engine and the sharded
    four-step at full size, each call driven with every count set to 0
    just before it and read just after, no plain version allowed, against
    scipy in complex128/float64 on the host (normalized 1e-3 for c64,
    1e-6 for c128): ``scipy.fft.fft(workers=2)``, ``rfft`` and
    ``dct(type=2)`` under ``set_backend(tpufft_torch.scipy_backend())`` on
    numpy (100000, 1024) c64 / f32 / f32 (K1, K7, K12) and ``fft`` on a
    CUDA tensor (its result stays on the card); ``native.fft``/``ifft`` in
    c64 and c128 on (100000, 1024) and (1000000, 93) and ``native.fftn`` on
    (16, 256, 256) (no launch; host times beside the CPU's model and
    ``native.num_threads()``), and a CUDA tensor refused; and
    ``tpufft_torch.parallel`` in worlds of processes on cuda:0
    (``tools/chip_ranks.py``, each with a 600 s timeout): d = 1 over
    NCCL (``fft_distributed``, ``filter_distributed``, ``rfft_distributed``
    + ``irfft_distributed`` on (4, 2**24): the two-pass split, K3 + K2),
    and d = 4 over gloo, whose collectives stage CUDA tensors through the
    host (the same paths on (4, 2**22) a rank, ``permuted_out`` ->
    ``permuted_in``, the all-gather fallback at n = 4 * 3**12,
    ``fftn_distributed`` on (8, 1024, 4096) and ``fft_batch_sharded`` on
    (128, 640, 480): K2 + K1 a rank, K3 + K2 for the fallback), every
    rank's kernels, plain versions, exchanges (the module's contract) and
    placement checked and the blocks assembled against scipy. Each line
    prints the time (median of 5, CUDA events; the numpy paths include
    their copies, the slowest rank for d = 4), launches, peak memory and
    byte floor, and for each rank the local FFTs' and the exchanges' time
    in one instrumented call; the exchange route is printed (if gloo
    refuses CUDA tensors, d = 4 runs on CPU blocks and says so). Phase 27
    runs alone after the build with ``python3 -c "import chip_smoke as c;
    c.phase_device(); c.phase_build();
    c.phase_native_parallel_paths(c._copy_rate())"``.

28. the mixed-radix line forms (3, 5 and 15 times a power of two, 93,
    1000, 1080, 2160 for K1; 15 times a power of two, 25, 93 and 1080 for
    the strided kernel): K1 alone at (1000000, 93), (64000, 480), (19200,
    1080) and (3840, 2160), K2 alone on (1, 93, 1000000) (T1's axis) and
    (10, 1920, 1080), each beside its stage form (``stages=True``, kept in
    the library; in turns), its plain version, ``torch.fft.fft`` and the
    copy floor of its bytes; and ``fft2`` on the survey's (10, 1920,
    1080) and (1, 3840, 2160) (bench_suite.py) with every count set to 0
    just before and read just after, against ``np.fft.fft2`` and through
    the round trip, beside ``torch.fft.fft2`` and the floor of its two
    passes.

29. K1's three-factor line form above 4096 (n = N1 N2 N3, two passes
    through the tile): K1 alone at (10000, 8320) (Bluestein's padded
    length at n = 4099), (10000, 8192), (5000, 16384) and (10000, 7680),
    each beside its stage form (in turns), its plain version,
    ``torch.fft.fft`` and the copy floor; K9 at (10000, 5000 -> 8192)
    beside its stage form and ``torch.fft.fft(x, n)``; K20 at (5, 2 x
    16384) and (5000, 2 x 16384) beside its split-plane sibling; and the
    Bluestein ``fft`` on (10000, 4099) as a path, every count set to 0
    just before it and read just after (K1 twice, on the three-factor
    form), against ``np.fft.fft`` on a few rows and through the round
    trip, beside ``torch.fft.fft``.

30. the strided kernel's cluster form above 2048 (bf16 from 1080; a unit
    of 16 columns spread over a thread-block cluster): K2 alone at (1,
    3840, 2160), (1, 8192, 8192) and (2, 16384, 2048) in f32 and (8,
    2048, 2048) in bf16, and K3 with the two-pass twiddle on the (4 x
    4096, 4096, 1) view of ``fft`` (4, 2**24), in the natural order and
    with the swapped store, each beside its stage form
    (in turns), its plain version, ``torch.fft.fft`` and the copy floor;
    K18 on fused (1, 3840, 8, 2 x 270) and K19 on (1, 8192, 2 x 8192)
    beside their plain versions, ``torch.fft.fft`` and the floor;
    then ``fft2`` (1, 3840, 2160) and ``fft`` (4, 2**24) as paths, every
    count set to 0 just before each and read just after (K2 and K1 once a
    transform; K3 and K2 once a transform), against ``np.fft`` on a row
    and through the round trip, beside ``torch.fft``. Phases 6 and 21 hold
    K2, K3, K18 and K19 at every length of the cluster form against their
    plain versions (``STRIDED_LINE_NS``).

31. K7's and K8's mixed-radix line form (K1's four-step at the half m of
    an even n on K1's lists, or at odd n = 93 itself): K7 and K8 alone at
    (1000000, 93) and (64000, 480), K7 at (50000, 1920) and (25000, 7680),
    each beside its stage form (in turns), its plain version,
    ``torch.fft.rfft`` / ``irfft`` and the copy floor; then ``rfft``
    (1000000, 93) and ``rfft2`` / ``irfft2`` (100, 640, 480) as paths,
    every count set to 0 just before each and read just after (K7 once;
    K7 and K2; K2 and K8), against ``np.fft`` on a few rows and through
    the round trip, beside ``torch.fft``.

32. K6's generic-radix line form (axes r 2^a, r in 1, 3, 5, 7, 15, up to
    240, and 256; ``csrc/mid_line.cuh``): K6 alone at (25, 160, 160, 48),
    (25, 160, 160, 128), (32, 56, 56, 256), (16, 256, 128, 32) and T2's
    own K6 call (25, 48, 160, 160), each beside its stage form (in turns),
    its plain version, ``torch.fft.fftn(dim=(1, 2))``, the copy floor and
    the K3 + K2 route; then the T2 path (transform-major (1, 25, 160, 160,
    48) over axes 1-4) with every count set to 0 just before it and read
    just after (K3, K6 and K1 once a transform), against ``np.fft.fftn``
    and through its inverse plan, beside the natural layout and
    ``torch.fft.fftn``. Phase 18 holds the form against its plain version
    at every family (``MID_PAIRS``).

33. the two-pass split (K3 with the twiddle and the digit swap in its
    store, then K2) at (16, 2**20) and (4, 2**24): ``fft`` and ``ifft``
    with every count set to 0 just before and read just after (K3 and K2
    once a transform, nothing else), against ``np.fft`` on a row and
    through the round trip, one call under ``torch.profiler`` in a fresh
    process (tools/kernel_profile.py: exactly two CUDA kernels, both the
    strided kernel's: no copy); then the path, the
    three-step it replaced (K3 natural, K1, the transpose copy; one call
    and ten back to back), pass 1
    (the swapped store) beside its natural store and its stage form, pass
    2 beside its stage form, each pass's plain version and
    ``torch.fft.fft``, the three-step's K1 and copy, cuFFT and the floor
    of two passes, and every split of ``TWO_PASS_SPLITS`` (pass 1 over a,
    pass 2 over b) in two turns.

Every kernel's bound is the larger of the bytes it must move (each input
read once, each output written once) over the copy rate measured here and
its flops over the FP32 peak (SMs x 128 lanes x 2 x the maximum SM
clock ``nvidia-smi`` reports); for K11/K12 on the tensor-core body, three
TF32 products over the 495 TFLOP/s TF32 peak (their entries also give
``form``, ``bound_fp32_ms`` and ``bound_tf32x3_ms``). The line before the
last is one JSON object describing every kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.fft
import scipy.signal
import torch

import tpufft_torch
from tpufft_torch import (_build, execute, parallel, realtrans, signal,
                          spectral)
from tpufft_torch.convert import split_from_numpy
from tpufft_torch.kernels import (cube_fft, dense_mm, fused_fft, inner_fft,
                                  mid_pair_fft, minor_fft, pair_fft, real_fft,
                                  stft_mm)

F32_TOL = 1e-5   # kernel vs plain version, f32 storage: both compute in f32
BF16_TOL = 8e-3  # bf16 storage: both round to bf16 (2^-8 relative) at the store
NP_TOL = 1e-3    # main path vs np.fft.fft, the check bench.py makes
SPECTRAL_TOL = 1e-4  # f32 spectral paths vs scipy in float64
# K1: the power-of-two line form, the mixed-radix line form (every length
# of minor_fft._MIXED_STEP: 3, 5 and 15 times a power of two, 93, 1000,
# 1080, 2160), the three-factor form above 4096 (every length of
# minor_fft._LONG_STEP) and the stage form's classes (127, 1792, 4100)
KERNEL_NS = tuple(sorted(
    {2, 4, 8, 16, 32, 64, 93, 127, 128, 256, 512, 960, 1024, 1792, 2048,
     4096, 4100} | set(minor_fft._MIXED_STEP) | set(minor_fft._LONG_STEP)))
MAIN_SHAPES = ((100_000, 1024), (1_000_000, 93))
REPS = 20
# TF32 on the tensor cores, dense: NVIDIA's data sheet for the H100 SXM at
# 700 W. K11/K12's tensor-core body does three TF32 products per f32 one.
TF32_PEAK = 495e12
STRIDED_NS = (8, 93, 127, 128, 960, 1024, 4096, 16384)
# the strided kernel's cluster form (csrc/strided_long.cuh): f32 from 2160,
# bf16 from 1080 (below 2160 f32 runs the four-step line form)
STRIDED_CLUSTER_NS = (1080, 1280, 1536, 1920, 2048, 2160, 2560, 3072, 3840,
                      4096, 4320, 5120, 6144, 7680, 8192, 8320, 10240,
                      12288, 15360, 16384)
# the strided kernel's line forms: n = r 2^a, r in {1, 3, 5}, 8 to 2048;
# 15 2^a, 30 to 1920; 25, 93 and 1080; and the cluster form's lengths
STRIDED_LINE_NS = tuple(sorted(
    {r * 2 ** a for r in (1, 3, 5) for a in range(12)
     if 8 <= r * 2 ** a <= 2048}
    | {15 * 2 ** a for a in range(1, 8)} | {25, 93, 1080}
    | set(STRIDED_CLUSTER_NS)))
# phase 28: K1 and the strided kernel's mixed-radix line forms beside their
# stage forms, and the survey's fft2 shapes (bench_suite.py)
MIXED_K1_SHAPES = ((1_000_000, 93), (64_000, 480), (19_200, 1080),
                   (3840, 2160))
MIXED_K2_SHAPES = ((1, 93, 1_000_000), (10, 1920, 1080))
SURVEY_FFT2 = ((10, 1920, 1080), (1, 3840, 2160))
# phase 29: K1's three-factor form at ~1.3 GB a call
LONG_K1_SHAPES = ((10_000, 8320), (10_000, 8192), (5000, 16384),
                  (10_000, 7680))
# phase 30: the strided cluster form: K2 at the survey's 4K UHD frame axis,
# 8192² and a long axis in f32, and bf16 at 2048 (pre, n, post); K3 with the
# two-pass twiddle as fft (4, 2**24) runs it; the two paths
CLUSTER_K2_SHAPES = (((1, 3840, 2160), torch.float32),
                     ((1, 8192, 8192), torch.float32),
                     ((2, 16384, 2048), torch.float32),
                     ((8, 2048, 2048), torch.bfloat16))
TWO_PASS_LONG = (4, 1 << 24)   # split 1024 x 16384: K3 swapped, then K2
# phase 33: the two-pass split's route (K3 with the twiddle and the swapped
# store, then K2) at its two shapes, and the splits the sweep times (pass 1
# over a, pass 2 over b)
TWO_PASS_SHAPES = ((16, 1 << 20), TWO_PASS_LONG)
TWO_PASS_SPLITS = {1 << 24: ((4096, 4096), (8192, 2048), (2048, 8192),
                             (16384, 1024), (1024, 16384)),
                   1 << 20: ((1024, 1024), (2048, 512), (512, 2048))}
# phase 32: K6's generic-radix form (pre, n1, n2, L): the four timed
# shapes (the aligned 5-D of tpufft's docstring, (25, 160, 160, 128), a
# channels-last 56^2 map and an axis of 256 among them) and the K6 call of
# the T2 path, whose physical (1, 25, 48, 160, 160) pairs (48, 160) at
# L = 160; then the T2 path itself
MIXED_K6_SHAPES = ((25, 160, 160, 48), (25, 160, 160, 128),
                   (32, 56, 56, 256), (16, 256, 128, 32), (25, 48, 160, 160))
T2_SHAPE = (1, 25, 160, 160, 48)
PAIRS = ((8, 93), (64, 64), (128, 128), (160, 48))
KERNELS = ("minor", "inner", "inner_nd", "pair")
REAL_KERNELS = ("r2c", "c2r", "minor_padded", "pair_padded")
DENSE_KERNELS = ("complex", "real", "r2r")
STFT_KERNELS = ("stft", "istft", "welch", "csd")
CLUSTER_KERNELS = ("cube", "mid_pair")
FUSED_KERNELS = tuple(f"fused_{k}" for k in fused_fft.launches)
ALL_KERNELS = (KERNELS + REAL_KERNELS + DENSE_KERNELS + STFT_KERNELS
               + CLUSTER_KERNELS + FUSED_KERNELS)
# the power-of-two line form, the stage form's classes, and every
# mixed-radix half of K7's and K8's line form (real_fft._REAL_STEP)
REAL_EVEN_NS = ((2, 8, 128, 256, 512, 1024, 2048, 4096, 8192, 32768)
                + tuple(sorted(2 * m for m in real_fft._REAL_STEP)))
# K7 alone beside torch.fft.rfft at the line form's shortest and longest
# rows, ~100 MB of input each (the (100000, 1024) row is the rfft path's)
REAL_LINE_SHAPES = ((400_000, 256), (12_500, 8192))
REAL_ODD_NS = (3, 93, 127, 16383)
# phase 31: K7/K8 (rows, n, kernels) beside their stage forms, and the
# paths rfft (10^6, 93) and rfft2/irfft2 (100, 640, 480)
MIXED_REAL_SHAPES = ((1_000_000, 93, "K7 K8"), (64_000, 480, "K7 K8"),
                     (50_000, 1920, "K7"), (25_000, 7680, "K7"))
# K9's pads: its line form at power-of-two n up to 4096 (n_in = 1, n/2,
# odd), at 384 and above 4096 (8192, Bluestein's 8320), its stage form at
# 4100
PADS = ((1, 2), (33, 64), (93, 128), (1000, 1024), (1024, 2048),
        (2047, 4096), (300, 384), (5000, 8192), (4099, 8320),
        (3000, 4100)) + tuple(
    # K9 at every mixed-radix and three-factor length, n_in = n - 1
    (n - 1, n) for n in sorted({*minor_fft._MIXED_STEP,
                                *minor_fft._LONG_STEP} - {384}))
# K9 timed beside its stage form and torch.fft.fft(x, n): the paths'
# shapes (fft(n="fast-aligned"), czt, envelope)
PAD_SHAPES = ((1_000_000, 93, 128), (100_000, 1024, 2048),
              (10_000, 2047, 4096))
PAIR_PADS = ((64, 93, 128), (120, 100, 128))
DENSE_SHAPES = ((2, 2), (7, 7), (64, 64), (93, 93), (100, 100), (128, 128),
                (512, 512), (93, 128), (128, 93), (36, 100))
R2R_NS = (2, 3, 93, 128, 1000, 1024)
R2R_NORMS = ("backward", "ortho", "forward")
CROSSOVER_NS = (64, 128, 256, 512)
# clusters of 1, 2, 4, 8, 16, 16, 16 and 8 blocks (the last three of 8192,
# 16384 and 6720 elements); of 1, 2, 4, 16, 16, 8, 16 and 16
CUBES = ((8, 8, 8), (8, 16, 32), (16, 16, 32), (16, 32, 32), (16, 32, 64),
         (32, 64, 64), (64, 64, 64), (24, 40, 56))
# K6: the power-of-two line form, the generic-radix form (csrc/mid_line.cuh:
# every family of r 2^a on each axis, the 56- and 60-value lines 224, 120
# and 240, and 256; (40, 64) among them) and the stage form (128, 512)
MID_PAIRS = ((8, 16, 128), (16, 64, 24), (32, 64, 16), (64, 128, 8),
             (64, 128, 37), (40, 64, 256), (128, 128, 9), (128, 512, 3),
             (160, 160, 12), (48, 160, 37), (56, 56, 9), (256, 128, 5),
             (240, 120, 3), (224, 128, 16), (128, 240, 7), (12, 15, 5),
             (14, 28, 8), (40, 7, 3), (30, 60, 10), (96, 192, 4),
             (3, 224, 8), (120, 5, 11))
MID_PAIR_SWEEP_LS = (1, 2, 4, 8, 32, 128, 512)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def norm_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max(1, max |ref|), in f32."""
    got, ref = got.float(), ref.float()
    scale = max(1.0, ref.abs().max().item())
    return (got - ref).abs().max().item() / scale


def pair_err(got, ref) -> float:
    return max(norm_err(got[0], ref[0]), norm_err(got[1], ref[1]))


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> tuple[str, float]:
    """The card's name, and its FP32 peak in FLOP/s: SMs x 128 FP32 lanes
    x 2 (an FMA) x the maximum SM clock."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this script runs "
                           "only on the GPU")
    print(_smi("name,power.limit"))
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    # the plain versions and the yardsticks run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}")
    mhz = float(_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak = sms * 128 * 2 * mhz * 1e6
    print(f"FP32 peak: {sms} SMs x 128 lanes x 2 x {mhz:.0f} MHz = "
          f"{peak / 1e12:.2f} TFLOP/s")
    return name, peak


def phase_build() -> None:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib_path.name})")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or line.startswith("nvcc ")):
                print("  ptxas:", line.strip())


def _planes(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    re = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    im = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    return re.to("cuda", dtype), im.to("cuda", dtype)


def phase_kernel() -> None:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for n in KERNEL_NS:
        at_n = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for dtype in (torch.float32, torch.bfloat16):
            xr, xi = _planes((257, n), dtype, seed=n)
            for inverse in (False, True):
                for scale in (1.0, 1.0 / n):
                    got = minor_fft.fft_minor(xr, xi, inverse=inverse,
                                              scale=scale)
                    ref = minor_fft.fft_minor_reference(
                        xr, xi, inverse=inverse, scale=scale)
                    check(got[0].dtype == dtype and got[0].shape == (257, n),
                          f"kernel output {got[0].dtype} {got[0].shape}")
                    err = pair_err(got, ref)
                    worst[dtype] = max(worst[dtype], err)
                    at_n[dtype] = max(at_n[dtype], err)
                    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
                    check(err < tol,
                          f"kernel vs plain n={n} {dtype} inverse={inverse} "
                          f"scale={scale}: {err:.3e} >= {tol}")
        print(f"  n={n} ({minor_fft.form(n)} form): max normalized error "
              f"f32 {at_n[torch.float32]:.3e}, bf16 "
              f"{at_n[torch.bfloat16]:.3e}")
    torch.cuda.synchronize()
    print(f"kernel vs plain, batch 257, n in {KERNEL_NS}: max normalized "
          f"error f32 {worst[torch.float32]:.3e} (tol {F32_TOL}), "
          f"bf16 {worst[torch.bfloat16]:.3e} (tol {BF16_TOL})")


def reset_counts() -> None:
    for m in (minor_fft, inner_fft, pair_fft, real_fft, dense_mm, stft_mm,
              cube_fft, mid_pair_fft, fused_fft):
        m.reset_counts()


def counts() -> tuple[dict, int]:
    """Launches per kernel, and plain-version runs on CUDA tensors."""
    return ({"minor": minor_fft.launches, **inner_fft.launches,
             "pair": pair_fft.launches, **real_fft.launches,
             "minor_padded": minor_fft.padded_launches,
             "pair_padded": pair_fft.padded_launches, **dense_mm.launches,
             **stft_mm.launches, "cube": cube_fft.launches,
             "mid_pair": mid_pair_fft.launches,
             **{f"fused_{k}": v for k, v in fused_fft.launches.items()}},
            minor_fft.reference_cuda_calls + inner_fft.reference_cuda_calls
            + pair_fft.reference_cuda_calls + real_fft.reference_cuda_calls
            + dense_mm.reference_cuda_calls + stft_mm.reference_cuda_calls
            + cube_fft.reference_cuda_calls
            + mid_pair_fft.reference_cuda_calls
            + fused_fft.reference_cuda_calls)


def phase_main_path() -> int:
    total = 0
    for batch, n in MAIN_SHAPES:
        rng = np.random.default_rng(0)
        re = rng.standard_normal((batch, n)).astype(np.float32)
        im = rng.standard_normal((batch, n)).astype(np.float32)
        x = split_from_numpy(re, im, "cuda")
        plan = tpufft_torch.plan_fft((batch, n), torch.complex64, axes=(-1,))
        torch.cuda.synchronize()
        reset_counts()
        y = plan(x)
        y_fn = tpufft_torch.fft(x)
        back = tpufft_torch.ifft(y)
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        launches = by_kernel["minor"]
        check(by_kernel == {k: 3 if k == "minor" else 0
                            for k in ALL_KERNELS},
              f"({batch}, {n}): kernel launches {by_kernel}, expected "
              "minor 3 (plan, fft, ifft)")
        check(plain == 0, f"({batch}, {n}): plain version ran {plain} times "
              "on CUDA tensors")
        total += launches
        check(isinstance(y, tpufft_torch.SplitComplex)
              and y.shape == (batch, n) and y.dtype == torch.float32
              and y.re.is_cuda, f"({batch}, {n}): output form {type(y)}")
        check(bool(torch.isfinite(y.re).all() and torch.isfinite(y.im).all()),
              f"({batch}, {n}): non-finite output")
        check(torch.equal(y.re, y_fn.re) and torch.equal(y.im, y_fn.im),
              f"({batch}, {n}): plan(x) and fft(x) differ")
        got = y.re[:4].cpu().numpy() + 1j * y.im[:4].cpu().numpy()
        ref = np.fft.fft(re[:4].astype(np.float64) + 1j * im[:4])
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err < NP_TOL, f"({batch}, {n}): vs np.fft.fft {err:.3e}")
        rt = pair_err(back, x)
        check(rt < NP_TOL, f"({batch}, {n}): ifft(fft(x)) error {rt:.3e}")
        launched = minor_fft.launched_geometry(n)
        check(launched["form"] == minor_fft.form(n) == "lines",
              f"({batch}, {n}): K1 launched its {launched['form']} form, the "
              f"wrapper names {minor_fft.form(n)}; the line form expected")
        print(f"main path ({batch}, {n}) c64: 4 rows vs np.fft.fft "
              f"{err:.3e}, round trip {rt:.3e}, kernel launches {launches} "
              f"(K1's {launched['form']} form, split "
              f"{minor_fft.line_split(n)}), plain-version CUDA calls {plain}")
        del x, y, y_fn, back
    return total


def _twiddle(n: int, m: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, (n, m))
    return torch.from_numpy(np.stack([np.cos(th), np.sin(th)], -1)
                            .astype(np.float32)).to("cuda")


def phase_new_kernels() -> None:
    """K2, K3 (with and without the twiddle) and K4 against their plain
    versions, printing the worst normalized error per kernel and dtype."""
    worst = {(k, d): 0.0 for k in KERNELS[1:]
             for d in (torch.float32, torch.bfloat16)}

    def hold(kernel, dtype, got, ref, what):
        err = pair_err(got, ref)
        worst[(kernel, dtype)] = max(worst[(kernel, dtype)], err)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        check(got[0].dtype == dtype and got[0].shape == ref[0].shape,
              f"{kernel} {what}: output {got[0].dtype} {got[0].shape}")
        check(err < tol, f"{kernel} vs plain {what}: {err:.3e} >= {tol}")

    for n in STRIDED_NS:
        tw_cache = {}
        for dtype in (torch.float32, torch.bfloat16):
            # ragged pre (11 slices against tiles of up to 8 for short n)
            # and ragged post (37 and 300 columns against power-of-two tiles)
            for pre, M, L in ((11, 37, 1), (2, 12, 25)):
                xr, xi = _planes((pre, n, M * L), dtype, seed=n + M)
                tw = tw_cache.setdefault(M, _twiddle(n, M, seed=n))
                v = (pre * n, M, L)
                for inverse in (False, True):
                    for scale in (1.0, 1.0 / n):
                        what = (f"n={n} {(pre, n, M * L)} {dtype} "
                                f"inverse={inverse} scale={scale}")
                        hold("inner", dtype,
                             inner_fft.fft_inner(xr, xi, inverse=inverse,
                                                 scale=scale),
                             inner_fft.fft_inner_reference(
                                 xr, xi, inverse=inverse, scale=scale), what)
                        for twiddle in (None, tw):
                            kw = dict(n=n, inverse=inverse, scale=scale,
                                      twiddle=twiddle)
                            hold("inner_nd", dtype,
                                 inner_fft.fft_inner_nd(
                                     xr.reshape(v), xi.reshape(v), **kw),
                                 inner_fft.fft_inner_nd_reference(
                                     xr.reshape(v), xi.reshape(v), **kw),
                                 f"{what} with_tw={twiddle is not None}")
    for n in STRIDED_LINE_NS:
        # a ragged post of 241 columns (units of 8 to 32 columns, the last
        # one ragged; rows not on 32-byte sectors) and a ragged pre of 3
        at = {torch.float32: 0.0, torch.bfloat16: 0.0}
        for dtype in (torch.float32, torch.bfloat16):
            xr, xi = _planes((3, n, 241), dtype, seed=n)
            tw = _twiddle(n, 241, seed=n)
            v = (3 * n, 241, 1)
            for inverse, scale in ((False, 1.0), (True, 1.0 / n)):
                what = (f"n={n} (3, {n}, 241) {dtype} inverse={inverse} "
                        f"scale={scale}")
                kw = dict(inverse=inverse, scale=scale)
                for kernel, got, ref in (
                        ("inner", inner_fft.fft_inner(xr, xi, **kw),
                         inner_fft.fft_inner_reference(xr, xi, **kw)),
                        ("inner_nd", inner_fft.fft_inner_nd(
                            xr.reshape(v), xi.reshape(v), n=n, twiddle=tw,
                            **kw),
                         inner_fft.fft_inner_nd_reference(
                             xr.reshape(v), xi.reshape(v), n=n, twiddle=tw,
                             **kw))):
                    hold(kernel, dtype, got, ref, what)
                    at[dtype] = max(at[dtype], pair_err(got, ref))
        print(f"  strided n={n} (3, {n}, 241): f32 "
              f"{inner_fft.form(n, 241, torch.float32)} form, bf16 "
              f"{inner_fft.form(n, 241, torch.bfloat16)} form; max "
              f"normalized error f32 {at[torch.float32]:.3e}, bf16 "
              f"{at[torch.bfloat16]:.3e}")
    for n1, n2 in PAIRS:
        for dtype in (torch.float32, torch.bfloat16):
            xr, xi = _planes((13, n1, n2), dtype, seed=n1 * n2)
            for inverse in (False, True):
                for scale in (1.0, 1.0 / (n1 * n2)):
                    hold("pair", dtype,
                         pair_fft.fft_pair(xr, xi, inverse=inverse,
                                           scale=scale),
                         pair_fft.fft_pair_reference(xr, xi, inverse=inverse,
                                                     scale=scale),
                         f"({n1}, {n2}) {dtype} inverse={inverse} "
                         f"scale={scale}")
    torch.cuda.synchronize()
    for k in KERNELS[1:]:
        print(f"{k} vs plain: max normalized error f32 "
              f"{worst[(k, torch.float32)]:.3e} (tol {F32_TOL}), bf16 "
              f"{worst[(k, torch.bfloat16)]:.3e} (tol {BF16_TOL})")


def _device_planes(shape, seed):
    """f32 planes made on the card from a seeded generator."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda"),
            torch.randn(shape, generator=g, device="cuda"))


# The new paths at full size: name, shape, what runs, and the launches of
# ONE transform per kernel.
NEW_PATHS = (
    ("nd_strided", (100, 640, 480),
     lambda x, inv: (tpufft_torch.ifft2 if inv else tpufft_torch.fft2)(x),
     {"inner": 1, "minor": 1}),
    ("nd_pair", (10, 128, 128, 128),
     lambda x, inv: (tpufft_torch.ifftn if inv else tpufft_torch.fftn)(
         x, axes=(1, 2, 3)),
     {"inner_nd": 1, "pair": 1}),
    ("two_pass", (16, 1_048_576),
     lambda x, inv: (tpufft_torch.ifft if inv else tpufft_torch.fft)(x),
     {"inner_nd": 1, "inner": 1}),
    ("bluestein", (10_000, 4099),
     lambda x, inv: (tpufft_torch.ifft if inv else tpufft_torch.fft)(x),
     {"minor": 2}),
)


def _np_ref(name, xr, xi):
    """np.fft on the first slices of the path's input, in float64."""
    k = 2 if name != "bluestein" else 4
    x = (xr[:k].cpu().numpy().astype(np.float64)
         + 1j * xi[:k].cpu().numpy())
    if name == "nd_strided":
        return np.fft.fft2(x)
    if name == "nd_pair":
        return np.fft.fftn(x, axes=(1, 2, 3))
    return np.fft.fft(x)


def phase_new_paths() -> dict:
    """Each new path once forward and once back, with every count set to 0
    just before and read just after; returns the launches per kernel."""
    total = dict.fromkeys(KERNELS, 0)
    for name, shape, run, per_call in NEW_PATHS:
        xr, xi = _device_planes(shape, seed=len(name))
        x = tpufft_torch.SplitComplex(xr, xi)
        torch.cuda.synchronize()
        reset_counts()
        y = run(x, False)
        back = run(y, True)
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        want = {k: 2 * per_call.get(k, 0) for k in ALL_KERNELS}
        check(by_kernel == want,
              f"{name}: kernel launches {by_kernel}, expected {want}")
        check(plain == 0,
              f"{name}: plain versions ran {plain} times on CUDA tensors")
        for k in KERNELS:
            total[k] += by_kernel[k]
        check(y.shape == shape and y.dtype == torch.float32 and y.re.is_cuda,
              f"{name}: output {y.shape} {y.dtype}")
        check(bool(torch.isfinite(y.re).all() and torch.isfinite(y.im).all()),
              f"{name}: non-finite output")
        ref = _np_ref(name, xr, xi)
        k = ref.shape[0]
        got = y.re[:k].cpu().numpy() + 1j * y.im[:k].cpu().numpy()
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err < NP_TOL, f"{name}: vs np.fft {err:.3e}")
        rt = pair_err(back, x)
        check(rt < NP_TOL, f"{name}: round trip error {rt:.3e}")
        print(f"path {name} {shape} c64: {k} slices vs np.fft {err:.3e}, "
              f"round trip {rt:.3e}, launches {by_kernel}, plain-version "
              f"CUDA calls {plain}")
        del x, y, back, xr, xi
    return total


def _movedim_route(xr, xi):
    """PR 1's route for a strided axis 1 of (pre, n, post) planes, the
    baseline the strided kernel replaces: move the axis minor (a copy),
    K1, and move it back (a copy)."""
    pre, n, post = xr.shape
    yr, yi = minor_fft.fft_minor(
        xr.transpose(1, 2).reshape(-1, n).contiguous(),
        xi.transpose(1, 2).reshape(-1, n).contiguous(),
        inverse=False, scale=1.0)
    return (yr.reshape(pre, post, n).transpose(1, 2).contiguous(),
            yi.reshape(pre, post, n).transpose(1, 2).contiguous())


def _pass_gb(shape) -> float:
    return 2 * 2 * 4 * float(np.prod(shape)) / 1e9   # planes in + out, f32


def phase_new_times() -> dict:
    """Times at the new paths' shapes; returns, per kernel, its time and
    its plain version's at the shape timed for the JSON line, and the
    largest absolute error against the plain version at full size."""
    out = {}

    def kernel_row(key, shape, kernel, plain, gb, flops=None, library=None):
        got, ref = kernel(), plain()
        abs_err = max((got[0] - ref[0]).abs().max().item(),
                      (got[1] - ref[1]).abs().max().item())
        err = pair_err(got, ref)
        check(err < F32_TOL, f"{key} {shape}: kernel vs plain {err:.3e}")
        del got, ref
        t_k, t_p = _time_ms(kernel), _time_ms(plain)
        t_l = None if library is None else _time_ms(library)
        print(f"  {key} alone {shape}: kernel {t_k:.4f} ms "
              f"({gb / (t_k * 1e-3):.0f} GB/s), plain {t_p:.4f} ms"
              + ("" if t_l is None else f", torch.fft {t_l:.4f} ms")
              + f"; vs plain max abs {abs_err:.3e}, normalized {err:.3e}")
        row = out.setdefault(key, {"ms": t_k, "plain_ms": t_p,
                                   "library_ms": t_l, "bytes": gb * 1e9,
                                   "flops": flops, "max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        return t_k

    for name, shape, run, _ in NEW_PATHS:
        xr, xi = _device_planes(shape, seed=1)
        x = tpufft_torch.SplitComplex(xr, xi)
        xc = torch.complex(xr, xi)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        gb = _pass_gb(shape)

        def copy():
            yr.copy_(xr)
            yi.copy_(xi)

        if name == "nd_strided":
            cufft = lambda: torch.fft.fft2(xc)  # noqa: E731
        elif name == "nd_pair":
            cufft = lambda: torch.fft.fftn(xc, dim=(1, 2, 3))  # noqa: E731
        else:
            cufft = lambda: torch.fft.fft(xc, dim=-1)  # noqa: E731
        t = {"path": _time_ms(lambda: run(x, False)),
             "torch_fft": _time_ms(cufft), "copy": _time_ms(copy)}
        print(f"times {name} {shape} c64, median of {REPS} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f"; one pass {gb:.4f} GB, copy "
              f"{gb / (t['copy'] * 1e-3):.0f} GB/s")
        if name == "nd_strided":
            pre, n, post = shape
            kernel_row("inner", shape,
                       lambda: inner_fft.fft_inner(xr, xi, inverse=False,
                                                   scale=1.0),
                       lambda: inner_fft.fft_inner_reference(
                           xr, xi, inverse=False, scale=1.0), gb,
                       flops=_fft_flops(n, pre * post),
                       library=lambda: torch.fft.fft(xc, dim=1))
            print(f"  K2 {shape}: {inner_fft.form(n, post, torch.float32)} "
                  f"form, {inner_fft.line_geometry(n, post, torch.float32)}")
            # K2 on rfft2's half spectrum: 241 columns, rows unaligned
            h = (pre, n, post // 2 + 1)
            hr, hi = _device_planes(h, seed=4)
            hc = torch.complex(hr, hi)
            kernel_row("inner_241", h,
                       lambda: inner_fft.fft_inner(hr, hi, inverse=False,
                                                   scale=1.0),
                       lambda: inner_fft.fft_inner_reference(
                           hr, hi, inverse=False, scale=1.0), _pass_gb(h),
                       flops=_fft_flops(n, pre * h[2]),
                       library=lambda: torch.fft.fft(hc, dim=1))
            print(f"  K2 {h}: {inner_fft.form(n, h[2], torch.float32)} form, "
                  f"{inner_fft.line_geometry(n, h[2], torch.float32)}")
            del hr, hi, hc
            moved = _time_ms(lambda: _movedim_route(xr, xi))
            print(f"  movedim route of axis 1 {shape} (copy, K1, copy "
                  f"back): {moved:.4f} ms")
            r2, i2 = xr.reshape(-1, post), xi.reshape(-1, post)
            kernel_row("minor", (pre * n, post),
                       lambda: minor_fft.fft_minor(r2, i2, inverse=False,
                                                   scale=1.0),
                       lambda: minor_fft.fft_minor_reference(
                           r2, i2, inverse=False, scale=1.0), gb)
        elif name == "nd_pair":
            pre, n1, n2, n3 = shape
            v = (pre * n1, n2, n3)
            r3, i3 = xr.reshape(v), xi.reshape(v)
            kernel_row("inner_nd", v,
                       lambda: inner_fft.fft_inner_nd(
                           r3, i3, n=n1, inverse=False, scale=1.0),
                       lambda: inner_fft.fft_inner_nd_reference(
                           r3, i3, n=n1, inverse=False, scale=1.0), gb,
                       flops=_fft_flops(n1, pre * n2 * n3),
                       library=lambda: torch.fft.fft(xc, dim=1))
            print(f"  K3 {v}, n = {n1}: "
                  f"{inner_fft.form(n1, n2 * n3, torch.float32)} form, "
                  f"{inner_fft.line_geometry(n1, n2 * n3, torch.float32)}")
            c3 = xc.reshape(v)
            kernel_row("pair", v,
                       lambda: pair_fft.fft_pair(r3, i3, inverse=False,
                                                 scale=1.0),
                       lambda: pair_fft.fft_pair_reference(
                           r3, i3, inverse=False, scale=1.0), gb,
                       flops=_fft_flops(n2 * n3, pre * n1),
                       library=lambda: torch.fft.fft2(c3))
            del c3
            # K4's packed form: five (8, 93) slices a block
            pk = (200_000, 8, 93)
            pr, pi = _device_planes(pk, seed=3)
            cp = torch.complex(pr, pi)
            kernel_row("pair_packed", pk,
                       lambda: pair_fft.fft_pair(pr, pi, inverse=False,
                                                 scale=1.0),
                       lambda: pair_fft.fft_pair_reference(
                           pr, pi, inverse=False, scale=1.0), _pass_gb(pk),
                       flops=_fft_flops(8 * 93, pk[0]),
                       library=lambda: torch.fft.fft2(cp))
            print(f"  copy floor {pk}: "
                  f"{_copy_floor_ms(_pass_gb(pk) * 1e9):.4f} ms")
            del pr, pi, cp
        elif name == "two_pass":
            rows, n = shape
            a, b = execute._split_large(n)
            v = (rows * a, b, 1)
            r3, i3 = xr.reshape(v), xi.reshape(v)
            tw = execute._device_two_pass_twiddle(a, b, False, xr.device)
            print(f"  split {n} = {a} * {b}")
            swap = dict(n=a, inverse=False, scale=1.0, twiddle=tw, swap=True)
            kernel_row("inner_nd_tw", v,
                       lambda: inner_fft.fft_inner_nd(r3, i3, **swap),
                       lambda: inner_fft.fft_inner_nd_reference(
                           r3, i3, **swap), gb,
                       library=lambda: torch.fft.fft(
                           xc.reshape(rows, a, b), dim=1))
            print(f"  K3 + twiddle, swapped store {v}, n = {a}: "
                  f"{inner_fft.form(a, b, torch.float32)} form, "
                  f"{inner_fft.line_geometry(a, b, torch.float32)}")
            r2, i2 = xr.reshape(rows * a, b), xi.reshape(rows * a, b)
            kernel_row("minor", (rows * a, b),
                       lambda: minor_fft.fft_minor(r2, i2, inverse=False,
                                                   scale=1.0),
                       lambda: minor_fft.fft_minor_reference(
                           r2, i2, inverse=False, scale=1.0), gb)
            swap = _time_ms(lambda: [
                t.reshape(rows, a, b).transpose(1, 2).contiguous()
                for t in (xr, xi)])
            print(f"  the three-step's K1 above and its digit swap copy: "
                  f"{swap:.4f} ms")
        else:
            rows, n = shape
            m = tpufft_torch.next_fast_len(2 * n - 1, aligned=True)
            pr, pi = _device_planes((rows, m), seed=2)
            kernel_row("minor", (rows, m),
                       lambda: minor_fft.fft_minor(pr, pi, inverse=False,
                                                   scale=1.0),
                       lambda: minor_fft.fft_minor_reference(
                           pr, pi, inverse=False, scale=1.0),
                       _pass_gb((rows, m)))
            del pr, pi
        del x, xc, xr, xi, yr, yi
        torch.cuda.synchronize()
    return out


def _fft_flops(n: int, count: int, real: bool = False) -> float:
    """The conventional flop count of ``count`` length-n FFTs: 5 n log2 n
    each, half that for a real transform."""
    return (2.5 if real else 5.0) * n * math.log2(n) * count


def _hold(worst, key, dtype, got, ref, what):
    """Check one kernel result against its plain version's; keep the worst
    normalized error per (kernel, dtype)."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(norm_err(g, r) for g, r in zip(got, ref))
    worst[(key, dtype)] = max(worst.get((key, dtype), 0.0), err)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    check(all(g.dtype == dtype and g.shape == r.shape
              for g, r in zip(got, ref)),
          f"{key} {what}: output {got[0].dtype} {tuple(got[0].shape)}")
    check(err < tol, f"{key} vs plain {what}: {err:.3e} >= {tol}")


def phase_real_kernels() -> None:
    """K7, K8, K9 and K4 with n2_in against their plain versions."""
    worst = {}
    dtypes = (torch.float32, torch.bfloat16)
    for n in REAL_EVEN_NS + REAL_ODD_NS:
        m1 = n // 2 + 1
        at_n = {(k, d): 0.0 for k in ("r2c", "c2r") for d in dtypes}
        for dtype in dtypes:
            x, _ = _planes((257, n), dtype, seed=n)
            br, bi = _planes((257, m1), dtype, seed=n + 1)
            for scale in (1.0, 1.0 / n):
                what = f"n={n} {dtype} scale={scale}"
                got = real_fft.rfft_minor(x, scale=scale)
                ref = real_fft.rfft_minor_reference(x, scale=scale)
                _hold(worst, "r2c", dtype, got, ref, what)
                at_n["r2c", dtype] = max(at_n["r2c", dtype],
                                         pair_err(got, ref))
                got = real_fft.irfft_minor(br, bi, n=n, scale=scale)
                ref = real_fft.irfft_minor_reference(br, bi, n=n,
                                                     scale=scale)
                _hold(worst, "c2r", dtype, got, ref, what)
                at_n["c2r", dtype] = max(at_n["c2r", dtype],
                                         norm_err(got, ref))
        print(f"  r2c and c2r n={n} ({real_fft.form(n)} form): max "
              "normalized error " + ", ".join(
                  f"{k} {str(d)[6:]} {at_n[k, d]:.3e}" for k, d in at_n))
    for n_in, n in PADS:
        at_pad = dict.fromkeys(dtypes, 0.0)
        for dtype in dtypes:
            xr, xi = _planes((257, n_in), dtype, seed=n_in)
            for inverse in (False, True):
                for scale in (1.0, 1.0 / n):
                    kw = dict(n=n, inverse=inverse, scale=scale)
                    got = minor_fft.fft_minor_padded(xr, xi, **kw)
                    ref = minor_fft.fft_minor_padded_reference(xr, xi, **kw)
                    _hold(worst, "minor_padded", dtype, got, ref,
                          f"({n_in} -> {n}) {dtype} inverse={inverse} "
                          f"scale={scale}")
                    at_pad[dtype] = max(at_pad[dtype], pair_err(got, ref))
        print(f"  minor_padded ({n_in} -> {n}) ({minor_fft.form(n, n_in)} "
              "form): max normalized error " + ", ".join(
                  f"{str(d)[6:]} {e:.3e}" for d, e in at_pad.items()))
    for n1, n2_in, n2 in PAIR_PADS:
        for dtype in dtypes:
            xr, xi = _planes((13, n1, n2_in), dtype, seed=n1 + n2_in)
            for inverse in (False, True):
                for scale in (1.0, 1.0 / (n1 * n2)):
                    kw = dict(n2=n2, inverse=inverse, scale=scale)
                    _hold(worst, "pair_padded", dtype,
                          pair_fft.fft_pair_padded(xr, xi, **kw),
                          pair_fft.fft_pair_padded_reference(xr, xi, **kw),
                          f"({n1}, {n2_in} -> {n2}) {dtype} "
                          f"inverse={inverse} scale={scale}")
    torch.cuda.synchronize()
    for k in REAL_KERNELS:
        print(f"{k} vs plain: max normalized error f32 "
              f"{worst[(k, torch.float32)]:.3e} (tol {F32_TOL}), bf16 "
              f"{worst[(k, torch.bfloat16)]:.3e} (tol {BF16_TOL})")


def _np_slices(x, k: int = 4) -> np.ndarray:
    """The first k slices of a tensor, SplitComplex or numpy array, as a
    float64 / complex128 numpy array."""
    if isinstance(x, tpufft_torch.SplitComplex):
        return (x.re[:k].double().cpu().numpy()
                + 1j * x.im[:k].double().cpu().numpy())
    x = x[:k].detach().cpu()
    return (x.to(torch.complex128) if x.is_complex() else x.double()).numpy()


# The real and padded paths at full size: name, input shape, whether the
# input is real, the call, the launches of that ONE call, np.fft on the
# input's first slices, and the round trip back to the input.
REAL_PATHS = (
    ("rfft", (100_000, 1024), True,
     lambda x: tpufft_torch.rfft(x), {"r2c": 1},
     lambda a: np.fft.rfft(a), lambda y: tpufft_torch.irfft(y, n=1024)),
    ("rfft_odd", (1_000_000, 93), True,
     lambda x: tpufft_torch.rfft(x), {"r2c": 1},
     lambda a: np.fft.rfft(a), lambda y: tpufft_torch.irfft(y, n=93)),
    ("rfft2", (100, 640, 480), True,
     lambda x: tpufft_torch.rfft2(x), {"r2c": 1, "inner": 1},
     lambda a: np.fft.rfft2(a),
     lambda y: tpufft_torch.irfft2(y, s=(640, 480))),
    ("fft_fast_aligned", (1_000_000, 93), False,
     lambda x: tpufft_torch.fft(x, n="fast-aligned"), {"minor_padded": 1},
     lambda a: np.fft.fft(a, 128), lambda y: tpufft_torch.ifft(y)),
    ("fft2_pair_pad", (10_000, 64, 93), False,
     lambda x: tpufft_torch.fft2(x, s=(64, 128)), {"pair_padded": 1},
     lambda a: np.fft.fft2(a, s=(64, 128)), lambda y: tpufft_torch.ifft2(y)),
)
# The inverse calls at full size, the round trips of the real paths: name,
# the launches of that ONE call.
REAL_INVERSES = {"rfft": ("irfft", {"c2r": 1}),
                 "rfft_odd": ("irfft_odd", {"c2r": 1}),
                 "rfft2": ("irfft2", {"inner": 1, "c2r": 1})}


def _real_input(shape, real: bool, seed: int):
    xr, xi = _device_planes(shape, seed)
    return xr if real else tpufft_torch.SplitComplex(xr, xi)


def _counted(fn, arg, name, per_call, total):
    """fn(arg) with every count set to 0 just before and read just after;
    checks that exactly the kernels of per_call ran, and no plain version."""
    torch.cuda.synchronize()
    reset_counts()
    out = fn(arg)
    torch.cuda.synchronize()
    by_kernel, plain = counts()
    want = {k: per_call.get(k, 0) for k in ALL_KERNELS}
    check(by_kernel == want,
          f"{name}: kernel launches {by_kernel}, expected {want}")
    check(plain == 0, f"{name}: plain versions ran {plain} times on CUDA "
          "tensors")
    for k in ALL_KERNELS:
        total[k] += by_kernel[k]
    return out


def phase_real_paths() -> dict:
    """Each real or padded path once, and its round trip; returns the
    launches per kernel."""
    total = dict.fromkeys(ALL_KERNELS, 0)
    for name, shape, real, run, per_call, ref_fn, back_fn in REAL_PATHS:
        x = _real_input(shape, real, seed=len(name))
        y = _counted(run, x, name, per_call, total)
        if name in REAL_INVERSES:
            back = _counted(back_fn, y, REAL_INVERSES[name][0],
                            REAL_INVERSES[name][1], total)
        else:
            back = back_fn(y)
        torch.cuda.synchronize()
        yc = y if real else y.complex()
        check(yc.is_cuda and yc.is_complex() and bool(torch.isfinite(
            torch.view_as_real(yc)).all()), f"{name}: output {yc.dtype}")
        ref = ref_fn(_np_slices(x))
        check(tuple(yc.shape[1:]) == ref.shape[1:],
              f"{name}: output shape {tuple(yc.shape)}, np.fft {ref.shape}")
        got = _np_slices(yc, ref.shape[0])
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err < NP_TOL, f"{name}: vs np.fft {err:.3e}")
        if real:
            rt = norm_err(back, x)
        else:   # the inverse gives back the input zero-padded to y's width
            pad = (0, y.shape[-1] - shape[-1])
            rt = pair_err(tuple(p[:4] for p in back),
                          tuple(torch.nn.functional.pad(p[:4], pad)
                                for p in x))
        check(rt < NP_TOL, f"{name}: round trip error {rt:.3e}")
        print(f"path {name} {shape} {'f32 real' if real else 'c64'} -> "
              f"{tuple(yc.shape)}: {ref.shape[0]} slices vs np.fft "
              f"{err:.3e}, round trip {rt:.3e}")
        del x, y, yc, back
    print(f"real and padded paths, launches {total}, plain-version CUDA "
          "calls 0")
    return total


def _copy_floor_ms(nbytes: float) -> float:
    """A device copy that reads and writes nbytes / 2 each: the floor of a
    pass that reads its input and writes its output once."""
    src = torch.empty(int(nbytes // 8), device="cuda")
    dst = torch.empty_like(src)
    t = _time_ms(lambda: dst.copy_(src))
    del src, dst
    return t


def phase_real_times(k1_ms: float) -> dict:
    """Times at the real and padded paths' shapes; returns, per new kernel,
    its time, its plain version's and its largest absolute error against
    the plain version at full size."""
    out = {}

    def kernel_row(key, shape, kernel, plain, nbytes, flops=None,
                   library=None):
        got, ref = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        abs_err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
        err = max(norm_err(g, r) for g, r in zip(got, ref))
        check(err < F32_TOL, f"{key} {shape}: kernel vs plain {err:.3e}")
        del got, ref
        t_k, t_p = _time_ms(kernel), _time_ms(plain)
        t_l = None if library is None else _time_ms(library)
        print(f"  {key} alone {shape}: kernel {t_k:.4f} ms "
              f"({nbytes / 1e9 / (t_k * 1e-3):.0f} GB/s), plain {t_p:.4f} ms"
              + ("" if t_l is None else f", torch.fft {t_l:.4f} ms")
              + f"; vs plain max abs {abs_err:.3e}, normalized {err:.3e}")
        if key not in out:
            out[key] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                        "bytes": nbytes, "flops": flops,
                        "max_abs_err": abs_err}
        out[key]["max_abs_err"] = max(out[key]["max_abs_err"], abs_err)

    f32 = 4
    # rfft / irfft (100000, 1024)
    rows, n = 100_000, 1024
    m1 = n // 2 + 1
    x, _ = _device_planes((rows, n), seed=1)
    xc = torch.complex(*_device_planes((rows, m1), seed=2))
    hr, hi = xc.real.contiguous(), xc.imag.contiguous()
    nb = f32 * (rows * n + 2 * rows * m1)
    t = {"rfft_path": _time_ms(lambda: tpufft_torch.rfft(x)),
         "irfft_path": _time_ms(lambda: tpufft_torch.irfft(xc, n=n)),
         "torch_rfft": _time_ms(lambda: torch.fft.rfft(x)),
         "torch_irfft": _time_ms(lambda: torch.fft.irfft(xc, n=n)),
         "copy_floor": _copy_floor_ms(nb)}
    print(f"times real ({rows}, {n}), median of {REPS} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f"; K1 C2C at this shape {k1_ms:.4f}; one pass {nb / 1e9:.4f} "
          "GB")
    rfft_path = t["rfft_path"]
    kernel_row("r2c", (rows, n),
               lambda: real_fft.rfft_minor(x, scale=1.0),
               lambda: real_fft.rfft_minor_reference(x, scale=1.0), nb,
               flops=_fft_flops(n, rows, real=True),
               library=lambda: torch.fft.rfft(x))
    kernel_row("c2r", (rows, n),
               lambda: real_fft.irfft_minor(hr, hi, n=n, scale=1.0 / n),
               lambda: real_fft.irfft_minor_reference(hr, hi, n=n,
                                                      scale=1.0 / n), nb,
               flops=_fft_flops(n, rows, real=True),
               library=lambda: torch.fft.irfft(xc, n=n))
    t_stage = _time_ms(lambda: real_fft.irfft_minor(
        hr, hi, n=n, scale=1.0 / n, stages=True))
    print(f"  c2r ({rows}, {n}): {real_fft.form(n)} form "
          f"{out['c2r']['ms']:.4f} ms, the stage form (kept in the library) "
          f"{t_stage:.4f} ms, ratio {out['c2r']['ms'] / t_stage:.3f}")
    out["r2c"]["vs_k1"] = out["r2c"]["ms"] / k1_ms
    yr, yi = real_fft.rfft_minor(x, scale=1.0)
    inter = _time_ms(lambda: torch.complex(yr, yi))
    deinter = _time_ms(lambda: (xc.real.contiguous(), xc.imag.contiguous()))
    print(f"  around the kernels: interleave of K7's planes into the complex "
          f"output {inter:.4f} ms, de-interleave of irfft's complex input "
          f"{deinter:.4f} ms")
    print(f"  rfft path ({rows}, {n}) {rfft_path:.4f} ms = K7 "
          f"({real_fft.form(n)} form) {out['r2c']['ms']:.4f} ms + interleave "
          f"{inter:.4f} ms + {rfft_path - out['r2c']['ms'] - inter:.4f} ms "
          "of the call layer; back to back (10 calls an event pair, ms a "
          f"call): path "
          f"{_back_to_back_ms(lambda: tpufft_torch.rfft(x)):.4f}, K7 "
          f"{_back_to_back_ms(lambda: real_fft.rfft_minor(x, scale=1.0)):.4f}"
          f"; host time to queue one call: path "
          f"{_host_ms(lambda: tpufft_torch.rfft(x)):.4f}, K7 "
          f"{_host_ms(lambda: real_fft.rfft_minor(x, scale=1.0)):.4f}")
    del yr, yi
    xt = x.reshape(n, rows)   # the same bytes, rfft along axis 0
    moved = _time_ms(lambda: tpufft_torch.rfft(xt, axis=0))
    print(f"  rfft along axis 0 of ({n}, {rows}) (movedim + K7 + movedim "
          f"back): {moved:.4f} ms")
    del x, xc, hr, hi, xt
    # K7 alone at the line form's shortest and longest rows
    for rows, n in REAL_LINE_SHAPES:
        x, _ = _device_planes((rows, n), seed=n)
        got = real_fft.rfft_minor(x, scale=1.0)
        ref = real_fft.rfft_minor_reference(x, scale=1.0)
        err = max(norm_err(g, r) for g, r in zip(got, ref))
        check(err < F32_TOL, f"r2c ({rows}, {n}): kernel vs plain {err:.3e}")
        del got, ref
        nb = f32 * (rows * n + 2 * rows * (n // 2 + 1))
        t_k = _time_ms(lambda: real_fft.rfft_minor(x, scale=1.0))
        t_l = _time_ms(lambda: torch.fft.rfft(x))
        t_c = _copy_floor_ms(nb)
        print(f"  r2c alone ({rows}, {n}) ({real_fft.form(n)} form): kernel "
              f"{t_k:.4f} ms ({nb / 1e9 / (t_k * 1e-3):.0f} GB/s), "
              f"torch.fft.rfft {t_l:.4f} ms, copy floor {t_c:.4f} ms; vs "
              f"plain normalized {err:.3e}")
        del x
    # K8 alone at the same rows: the line form, its stage form, irfft
    for rows, n in REAL_LINE_SHAPES:
        hr, hi = _device_planes((rows, n // 2 + 1), seed=n + 1)
        hc = torch.complex(hr, hi)
        got = real_fft.irfft_minor(hr, hi, n=n, scale=1.0 / n)
        ref = real_fft.irfft_minor_reference(hr, hi, n=n, scale=1.0 / n)
        err = norm_err(got, ref)
        check(err < F32_TOL, f"c2r ({rows}, {n}): kernel vs plain {err:.3e}")
        del got, ref
        nb = f32 * (rows * n + 2 * rows * (n // 2 + 1))
        t_k = _time_ms(lambda: real_fft.irfft_minor(hr, hi, n=n,
                                                    scale=1.0 / n))
        t_s = _time_ms(lambda: real_fft.irfft_minor(hr, hi, n=n,
                                                    scale=1.0 / n,
                                                    stages=True))
        t_l = _time_ms(lambda: torch.fft.irfft(hc, n=n))
        print(f"  c2r alone ({rows}, {n}) ({real_fft.form(n)} form): kernel "
              f"{t_k:.4f} ms ({nb / 1e9 / (t_k * 1e-3):.0f} GB/s), stage "
              f"form {t_s:.4f} ms, torch.fft.irfft {t_l:.4f} ms, copy floor "
              f"{_copy_floor_ms(nb):.4f} ms; vs plain normalized {err:.3e}")
        del hr, hi, hc
    # rfft (1000000, 93), odd n
    rows, n = 1_000_000, 93
    m1 = n // 2 + 1
    x, _ = _device_planes((rows, n), seed=3)
    nb = f32 * (rows * n + 2 * rows * m1)
    t = {"rfft_path": _time_ms(lambda: tpufft_torch.rfft(x)),
         "torch_rfft": _time_ms(lambda: torch.fft.rfft(x)),
         "copy_floor": _copy_floor_ms(nb)}
    print(f"times real ({rows}, {n}), median of {REPS} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    kernel_row("r2c", (rows, n),
               lambda: real_fft.rfft_minor(x, scale=1.0),
               lambda: real_fft.rfft_minor_reference(x, scale=1.0), nb)
    del x
    # rfft2 / irfft2 (100, 640, 480)
    shape = (100, 640, 480)
    x, _ = _device_planes(shape, seed=4)
    y = tpufft_torch.rfft2(x)
    nb = f32 * (x.numel() + 2 * y.numel())
    rows = x.reshape(-1, shape[2])
    pr, pi = real_fft.rfft_minor(rows, scale=1.0)
    pr, pi = pr.reshape(y.shape), pi.reshape(y.shape)
    t_k7 = _time_ms(lambda: real_fft.rfft_minor(rows, scale=1.0))
    t_k2 = _time_ms(lambda: inner_fft.fft_inner(pr, pi, inverse=False,
                                                 scale=1.0))
    print(f"  inside rfft2 {shape}: K7 on {tuple(rows.shape)} {t_k7:.4f} ms, "
          f"K2 on {tuple(pr.shape)} {t_k2:.4f} ms")
    del rows, pr, pi
    t = {"rfft2_path": _time_ms(lambda: tpufft_torch.rfft2(x)),
         "irfft2_path": _time_ms(lambda: tpufft_torch.irfft2(y, s=shape[1:])),
         "torch_rfft2": _time_ms(lambda: torch.fft.rfft2(x)),
         "torch_irfft2": _time_ms(lambda: torch.fft.irfft2(y, s=shape[1:])),
         "copy_floor_per_pass": _copy_floor_ms(nb)}
    print(f"times real {shape}, median of {REPS} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    del x, y
    # fft(n="fast-aligned") (1000000, 93) -> 128
    rows, n_in, n = 1_000_000, 93, 128
    xr, xi = _device_planes((rows, n_in), seed=5)
    xs = tpufft_torch.SplitComplex(xr, xi)
    xc = torch.complex(xr, xi)
    nb = 2 * f32 * (rows * n_in + rows * n)
    t = {"path": _time_ms(lambda: tpufft_torch.fft(xs, n="fast-aligned")),
         "pad_then_K1": _time_ms(lambda: minor_fft.fft_minor(
             torch.nn.functional.pad(xr, (0, n - n_in)),
             torch.nn.functional.pad(xi, (0, n - n_in)),
             inverse=False, scale=1.0)),
         "torch_fft_n128": _time_ms(lambda: torch.fft.fft(xc, n=n)),
         "copy_floor": _copy_floor_ms(nb)}
    print(f"times pad ({rows}, {n_in} -> {n}) c64, median of {REPS} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    kernel_row("minor_padded", (rows, n_in, n),
               lambda: minor_fft.fft_minor_padded(xr, xi, n=n, inverse=False,
                                                  scale=1.0),
               lambda: minor_fft.fft_minor_padded_reference(
                   xr, xi, n=n, inverse=False, scale=1.0), nb,
               flops=_fft_flops(n, rows),
               library=lambda: torch.fft.fft(xc, n=n))
    del xr, xi, xs, xc
    # K9 alone at the paths' shapes: its form, the stage form (kept in the
    # library), torch.fft.fft(x, n) and the copy floor
    for rows, n_in, n in PAD_SHAPES:
        xr, xi = _device_planes((rows, n_in), seed=n_in)
        xc = torch.complex(xr, xi)
        kw = dict(n=n, inverse=False, scale=1.0)
        err = pair_err(minor_fft.fft_minor_padded(xr, xi, **kw),
                       minor_fft.fft_minor_padded(xr, xi, stages=True, **kw))
        check(err < F32_TOL, f"minor_padded ({rows}, {n_in} -> {n}): "
              f"{minor_fft.form(n, n_in)} form vs stage form {err:.3e}")
        nb = 2 * f32 * rows * (n_in + n)
        t_k = _time_ms(lambda: minor_fft.fft_minor_padded(xr, xi, **kw))
        t_s = _time_ms(lambda: minor_fft.fft_minor_padded(xr, xi,
                                                          stages=True, **kw))
        t_l = _time_ms(lambda: torch.fft.fft(xc, n=n))
        t_c = _copy_floor_ms(nb)
        print(f"  minor_padded alone ({rows}, {n_in} -> {n}) "
              f"({minor_fft.form(n, n_in)} form): kernel {t_k:.4f} ms "
              f"({nb / 1e9 / (t_k * 1e-3):.0f} GB/s, {t_c / t_k:.3f} of the "
              f"copy floor), stage form {t_s:.4f} ms (ratio "
              f"{t_k / t_s:.3f}), torch.fft.fft(x, n={n}) {t_l:.4f} ms, copy "
              f"floor {t_c:.4f} ms; vs stage form normalized {err:.3e}")
        del xr, xi, xc
    # fft2(s=(64, 128)) on (10000, 64, 93)
    shape, n2 = (10_000, 64, 93), 128
    xr, xi = _device_planes(shape, seed=6)
    xs = tpufft_torch.SplitComplex(xr, xi)
    xc = torch.complex(xr, xi)
    nb = 2 * f32 * (xr.numel() * (1 + n2 / shape[2]))
    t = {"path": _time_ms(lambda: tpufft_torch.fft2(xs, s=(64, n2))),
         "torch_fft2_s": _time_ms(lambda: torch.fft.fft2(xc, s=(64, n2))),
         "copy_floor": _copy_floor_ms(nb)}
    print(f"times pair pad {shape} -> (64, {n2}) c64, median of {REPS} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    kernel_row("pair_padded", shape + (n2,),
               lambda: pair_fft.fft_pair_padded(xr, xi, n2=n2, inverse=False,
                                                scale=1.0),
               lambda: pair_fft.fft_pair_padded_reference(
                   xr, xi, n2=n2, inverse=False, scale=1.0), nb)
    del xr, xi, xs, xc
    torch.cuda.synchronize()
    print(f"rfft (100000, 1024) on K7 ({real_fft.form(1024)} form) "
          f"{out['r2c']['ms']:.4f} ms against K1's C2C {k1_ms:.4f} ms: "
          f"ratio {out['r2c']['vs_k1']:.3f}")
    return out


def _edge_rows(x: torch.Tensor) -> torch.Tensor:
    """x with edge values in its first rows: +Inf, -Inf, NaN, 3.4e38 and
    FLT_MAX each at one place, rows scaled by 1e-20 and by 1e18."""
    x = x.clone()
    n = x.shape[1]
    x[0, 5 % n] = float("inf")
    x[1, 7 % n] = float("-inf")
    x[2, 3 % n] = float("nan")
    x[3, 9 % n] = 3.4e38
    x[4, 11 % n] = torch.finfo(torch.float32).max
    x[5] *= 1e-20
    x[6] *= 1e18
    return x


def _hold_edges(worst, key, got, ref, what):
    """Inf and NaN where the plain version has them, and the finite
    entries within F32_TOL of it, each row relative to its own magnitude
    (the 1e-20 row is held to its scale, not to 1)."""
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        check(torch.equal(test(got), test(ref)),
              f"{key} edge rows {what}: {test.__name__} pattern differs")
    fin = torch.isfinite(ref)
    scale = torch.where(fin, ref.abs(), 0).amax(1, keepdim=True).clamp_min(
        1e-30)
    err = (torch.where(fin, (got - ref).abs(), 0) / scale).max().item()
    worst[(key, "edges")] = max(worst.get((key, "edges"), 0.0), err)
    check(err < F32_TOL, f"{key} edge rows {what}: {err:.3e} >= {F32_TOL}")


DENSE_BATCHES = (1, 127, 129, 257)   # rows ending mid-tile, and a few tiles


def phase_dense_kernels() -> None:
    """K10, K11 and K12 against their plain versions (f32 matmuls, TF32
    off), each on its body (``dense_mm.form``: the 3xTF32 tensor-core body,
    else the FMA loop) at batches of 1 to 257 rows and on edge-value rows,
    whose Inf and NaN must fall where the plain version's do (K10: the
    edge values in xr)."""
    worst = {}
    f32 = torch.float32
    forms = collections.defaultdict(list)
    for m_in, m_out in DENSE_SHAPES:
        xr, xi = _planes((257, m_in), f32, seed=m_in)
        wr, wi = _planes((m_in, m_out), f32, seed=m_out + 7)
        wb = dense_mm.block_table(wr, wi).contiguous()
        what = f"({m_in} -> {m_out})"
        forms[dense_mm.form(m_in, m_out)].append(what)
        for batch in DENSE_BATCHES:
            _hold(worst, "complex", f32,
                  dense_mm.dense_mm_complex(xr[:batch], xi[:batch], wr, wi,
                                            wb),
                  dense_mm.dense_mm_complex_reference(xr[:batch], xi[:batch],
                                                      wr, wi),
                  f"{what} batch {batch}")
        edge = _edge_rows(xr)
        for got, ref in zip(
                dense_mm.dense_mm_complex(edge, xi, wr, wi, wb),
                dense_mm.dense_mm_complex_reference(edge, xi, wr, wi)):
            _hold_edges(worst, "complex", got, ref, what)
        for batch in DENSE_BATCHES:
            _hold(worst, "real", f32, dense_mm.dense_mm_real(xr[:batch], wr),
                  dense_mm.dense_mm_real_reference(xr[:batch], wr),
                  f"{what} batch {batch}")
        edge = _edge_rows(xr)
        _hold_edges(worst, "real", dense_mm.dense_mm_real(edge, wr),
                    dense_mm.dense_mm_real_reference(edge, wr), what)
    for n in R2R_NS:
        x, _ = _planes((257, n), f32, seed=n)
        edge = _edge_rows(x)
        forms[dense_mm.form(n, n)].append(f"r2r n={n}")
        for kind in ("dct", "dst"):
            for type_ in (1, 2, 3, 4):
                for norm in R2R_NORMS:
                    for inverse in (False, True):
                        w = realtrans._table((kind, type_, n, norm, inverse),
                                             x.device)
                        what = f"{kind}{type_} n={n} {norm} inverse={inverse}"
                        _hold(worst, "r2r", f32, dense_mm.r2r_minor(x, w),
                              dense_mm.r2r_minor_reference(x, w), what)
                        if norm != "backward" or inverse:
                            continue
                        for batch in DENSE_BATCHES[:-1]:
                            _hold(worst, "r2r", f32,
                                  dense_mm.r2r_minor(x[:batch], w),
                                  dense_mm.r2r_minor_reference(x[:batch], w),
                                  f"{what} batch {batch}")
                        _hold_edges(worst, "r2r", dense_mm.r2r_minor(edge, w),
                                    dense_mm.r2r_minor_reference(edge, w),
                                    what)
    torch.cuda.synchronize()
    for body, shapes in forms.items():
        print(f"dense kernels (K10, K11, K12) body {body}: "
              f"{', '.join(shapes)}")
    for k in DENSE_KERNELS:
        print(f"{k} vs plain: max normalized error f32 "
              f"{worst[(k, f32)]:.3e} (tol {F32_TOL}); edge rows (+-Inf, "
              f"NaN, 3.4e38, FLT_MAX, x1e-20, x1e18): Inf/NaN pattern "
              f"equal, finite entries {worst[(k, 'edges')]:.3e}")


def _lowpass(n: int) -> np.ndarray:
    """A Hermitian 0/1 low-pass response (bins |k| <= n/8): its impulse is
    real, so on real rows the filter is one real product (K11)."""
    k = np.minimum(np.arange(n), n - np.arange(n))
    return (k <= n // 8).astype(np.float64)


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    check(got.shape == ref.shape, f"shape {got.shape} vs {ref.shape}")
    return float(np.max(np.abs(got - ref)) / max(1.0, np.max(np.abs(ref))))


def _host(t: torch.Tensor, k: int = 4) -> np.ndarray:
    """The first k rows of a tensor as float64 / complex128 numpy."""
    t = t[:k].detach().cpu()
    return (t.to(torch.complex128) if t.is_complex() else t.double()).numpy()


CZT_W = np.exp(-2j * np.pi * 0.25 / 1024)   # a quarter of the circle ...
CZT_A = np.exp(2j * np.pi * 0.1)            # ... from a tenth of a turn on


@functools.lru_cache(maxsize=None)
def _lowpass_plan():
    return tpufft_torch.plan_filter(512, response=_lowpass(512))


def _lowpass_f64(x: np.ndarray) -> np.ndarray:
    return np.fft.ifft(np.fft.fft(x) * _lowpass(512))


def _envelope_f64(x: np.ndarray) -> np.ndarray:
    """scipy's envelope (scipy >= 1.16), else the port's own in f64 on the
    CPU, which the CPU tests hold to scipy's at 1e-10."""
    if hasattr(scipy.signal, "envelope"):
        return scipy.signal.envelope(x)
    return tpufft_torch.envelope(x, device="cpu")


# The dense-kernel and filtering paths at full size: name, input shape,
# whether the input is complex, the second operand's shape, the call (of
# the input and the second operand), the launches of that ONE call,
# scipy/numpy in float64 on the input's first rows, and the inverse call
# with its launches where the path has a round trip.
DENSE_PATHS = (
    ("hilbert", (100_000, 512), False, None,
     lambda x, _: tpufft_torch.hilbert(x), {"complex": 1},
     lambda a, _: scipy.signal.hilbert(a), None, None),
    ("filter_real", (100_000, 512), False, None,
     lambda x, _: _lowpass_plan()(x), {"real": 1},
     lambda a, _: _lowpass_f64(a).real,
     lambda y: _lowpass_plan()(y), {"real": 1}),
    ("filter_complex", (100_000, 512), True, None,
     lambda x, _: _lowpass_plan()(x), {"complex": 1},
     lambda a, _: _lowpass_f64(a),
     lambda y: _lowpass_plan()(y), {"complex": 1}),
    ("dct", (100_000, 1024), False, None,
     lambda x, _: tpufft_torch.dct(x), {"r2r": 1},
     lambda a, _: scipy.fft.dct(a),
     lambda y: tpufft_torch.idct(y), {"r2r": 1}),
    ("dst4", (100_000, 93), False, None,
     lambda x, _: tpufft_torch.dst(x, type=4), {"r2r": 1},
     lambda a, _: scipy.fft.dst(a, type=4),
     lambda y: tpufft_torch.idst(y, type=4), {"r2r": 1}),
    ("fftconvolve", (100, 640, 480), False, (1, 31, 31),
     lambda x, k: tpufft_torch.fftconvolve(x, k, mode="same", axes=(1, 2)),
     {"r2c": 2, "inner": 3, "c2r": 1},
     lambda a, k: scipy.signal.fftconvolve(a, k, mode="same", axes=(1, 2)),
     None, None),
    ("oaconvolve", (16, 2_000_000), False, (1, 1025),
     lambda x, k: tpufft_torch.oaconvolve(x, k, axes=-1),
     {"r2c": 2, "c2r": 1},
     lambda a, k: scipy.signal.oaconvolve(a, k, axes=-1), None, None),
    ("resample", (10_000, 4800), False, None,
     lambda x, _: tpufft_torch.resample(x, 4410, axis=-1), {"minor": 2},
     lambda a, _: scipy.signal.resample(a, 4410, axis=-1), None, None),
    ("envelope", (10_000, 4096), False, None,
     lambda x, _: tpufft_torch.envelope(x),
     {"r2c": 1, "minor_padded": 1, "c2r": 1},
     lambda a, _: _envelope_f64(a), None, None),
    ("czt", (100_000, 1024), False, None,
     lambda x, _: tpufft_torch.czt(x, 1024, CZT_W, CZT_A),
     {"minor_padded": 1, "minor": 1},
     lambda a, _: scipy.signal.czt(a, 1024, CZT_W, CZT_A), None, None),
    ("fht", (100_000, 1024), False, None,
     lambda x, _: tpufft_torch.fht(x, 0.05, 0.5), {"r2c": 1, "c2r": 1},
     lambda a, _: scipy.fft.fht(a, 0.05, 0.5),
     lambda y: tpufft_torch.ifht(y, 0.05, 0.5), {"r2c": 1, "c2r": 1}),
)


def _dense_path_inputs(shape, is_complex: bool, kshape, seed: int):
    """A path's input at full size, made on the card from a seed, and its
    second operand where it has one."""
    xr, xi = _device_planes(shape, seed)
    x = torch.complex(xr, xi) if is_complex else xr
    return x, None if kshape is None else _device_planes(kshape, seed + 1)[0]


def phase_dense_paths() -> dict:
    """Each path once at full size, and its round trip, with every count
    set to 0 just before each call and read just after; returns the
    launches per kernel."""
    total = dict.fromkeys(ALL_KERNELS, 0)
    for seed, (name, shape, is_complex, kshape, run, per_call, ref_fn,
               back_fn, back_call) in enumerate(DENSE_PATHS):
        x, k = _dense_path_inputs(shape, is_complex, kshape, seed)
        y = _counted(lambda a: run(a, k), x, name, per_call, total)
        rows = 2 if x.ndim == 3 else (1 if name == "oaconvolve" else 4)
        check(y.device == x.device and bool(torch.isfinite(
            torch.view_as_real(y) if y.is_complex() else y).all()),
            f"{name}: output {y.dtype} on {y.device}")
        xk = None if k is None else k.double().cpu().numpy()
        ref = ref_fn(_host(x, rows), xk)
        if name == "envelope":   # rows of the stacked (envelope, residual)
            got = y[:, :rows].double().cpu().numpy()
        else:
            got = _host(y, rows)
        err = _rel(got, ref)
        check(err < NP_TOL, f"{name}: vs scipy/numpy in f64 {err:.3e}")
        line = (f"path {name} {tuple(x.shape)} -> {tuple(y.shape)} "
                f"{y.dtype}: {rows} rows vs scipy/numpy f64 {err:.3e}")
        if back_fn is not None:
            back = _counted(back_fn, y, f"{name} back", back_call, total)
            # the inverse gives back the input; a low-pass is a projection,
            # so filtering twice gives the first result back
            want = y if name.startswith("filter") else x
            rt = norm_err(torch.view_as_real(back) if back.is_complex()
                          else back,
                          torch.view_as_real(want) if want.is_complex()
                          else want)
            check(rt < NP_TOL, f"{name}: round trip error {rt:.3e}")
            line += f", round trip {rt:.3e}"
            del back
        elif name == "hilbert":   # the analytic signal's real part is x
            rt = norm_err(y.real, x)
            check(rt < NP_TOL, f"{name}: real part vs input {rt:.3e}")
            line += f", real part vs input {rt:.3e}"
        print(line)
        del x, k, y
        torch.cuda.synchronize()
    print(f"dense and filtering paths, launches {total}, plain-version CUDA "
          "calls 0")
    return total


def _real_body_lines(key: str, x: torch.Tensor, w: torch.Tensor) -> None:
    """K11/K12's other body on the same operands, and one TF32 product
    (torch.matmul with allow_tf32, informational: it fails the 1e-5
    check the kernel is held to)."""
    lib = _build.load()
    y = torch.empty(x.shape[0], w.shape[1], device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    ref = dense_mm.dense_mm_real_reference(x, w)

    def fma():   # the FMA body, called through the C entry point
        check(lib.tpufft_dense_mm_real(x.data_ptr(), w.data_ptr(),
                                       y.data_ptr(), x.shape[0], x.shape[1],
                                       w.shape[1], 0, stream) == 0,
              f"{key}: the FMA body did not launch")

    fma()
    err_fma = norm_err(y, ref)
    check(err_fma < F32_TOL, f"{key}: FMA body vs plain {err_fma:.3e}")
    t_fma = _time_ms(fma)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        err_tf32 = norm_err(torch.matmul(x, w), ref)
        t_tf32 = _time_ms(lambda: torch.matmul(x, w))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  {key} {tuple(x.shape)} x {tuple(w.shape)}: the FMA body "
          f"{t_fma:.4f} ms (vs plain {err_fma:.3e}); torch.matmul with "
          f"allow_tf32 (one TF32 product, informational) {t_tf32:.4f} ms, "
          f"vs plain {err_tf32:.3e}: "
          f"{'FAILS' if err_tf32 >= F32_TOL else 'passes'} the {F32_TOL} "
          f"check")
    del y, ref


def _complex_fma_line(xr, xi, wr, wi, row: dict) -> None:
    """K10's FMA body (its only body before the tensor-core one) on the
    same operands, through the C entry point: its time beside the
    tensor-core body's in this run."""
    lib = _build.load()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    stream = torch.cuda.current_stream().cuda_stream

    def fma():
        check(lib.tpufft_dense_mm_complex(
            xr.data_ptr(), xi.data_ptr(), wr.data_ptr(), wi.data_ptr(), 0,
            yr.data_ptr(), yi.data_ptr(), xr.shape[0], xr.shape[1],
            wr.shape[1], 0, stream) == 0,
            "complex: the FMA body did not launch")

    fma()
    ref = dense_mm.dense_mm_complex_reference(xr, xi, wr, wi)
    err = max(norm_err(yr, ref[0]), norm_err(yi, ref[1]))
    check(err < F32_TOL, f"complex: FMA body vs plain {err:.3e}")
    row["fma_ms"] = _time_ms(fma)
    print(f"  complex {tuple(xr.shape)} x {tuple(wr.shape)}: the FMA body "
          f"{row['fma_ms']:.4f} ms (vs plain {err:.3e}); the "
          f"{dense_mm.form(xr.shape[1], wr.shape[1])} body {row['ms']:.4f} "
          f"ms, ratio {row['ms'] / row['fma_ms']:.3f}")
    del yr, yi, ref


def phase_dense_times(peak: float) -> dict:
    """Times of the paths and of K10, K11 and K12 alone at their paths'
    shapes; returns, per dense kernel, its time, its plain version's,
    torch.matmul's on the same operands, its bytes and flops, and its
    largest absolute error against the plain version; for K11 and K12 also
    the body that ran and its operations bound on the FP32 cores (one f32
    product at ``peak``) and as 3xTF32 on the tensor cores."""
    for seed, (name, shape, is_complex, kshape, run, *_) in enumerate(
            DENSE_PATHS):
        x, k = _dense_path_inputs(shape, is_complex, kshape, seed)
        print(f"times path {name} {shape}, median of {REPS}: "
              f"{_time_ms(lambda: run(x, k)):.4f} ms")
        del x, k
    torch.cuda.synchronize()
    out = {}

    def kernel_row(key, shape, kernel, plain, library, nbytes, flops):
        got, ref = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        abs_err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        err = max(norm_err(g, r) for g, r in zip(got, ref))
        check(err < F32_TOL, f"{key} {shape}: kernel vs plain {err:.3e}")
        del got, ref
        t_k, t_p, t_l = _time_ms(kernel), _time_ms(plain), _time_ms(library)
        print(f"  {key} alone {shape}: kernel {t_k:.4f} ms "
              f"({flops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{nbytes / 1e9 / (t_k * 1e-3):.0f} GB/s), plain {t_p:.4f} "
              f"ms, torch.matmul {t_l:.4f} ms; vs plain max abs "
              f"{abs_err:.3e}, normalized {err:.3e}")
        out[key] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                    "bytes": nbytes, "flops": flops, "max_abs_err": abs_err,
                    "mkn": shape}

    f32 = 4
    rows, n = 100_000, 512
    xr, xi = _device_planes((rows, n), seed=32)
    dev = xr.device
    hplan = signal._hilbert_plan(n, 1, None)
    wr, wi = hplan._table("cr", dev), hplan._table("ci", dev)
    wb = hplan._table("block", dev)
    xc, wc = torch.complex(xr, xi), torch.complex(wr, wi)
    kernel_row("complex", (rows, n, n),
               lambda: dense_mm.dense_mm_complex(xr, xi, wr, wi, wb),
               lambda: dense_mm.dense_mm_complex_reference(xr, xi, wr, wi),
               lambda: torch.matmul(xc, wc),
               f32 * (4 * rows * n + 2 * n * n), 8.0 * rows * n * n)
    _complex_fma_line(xr, xi, wr, wi, out["complex"])
    del xc, wc
    w = _lowpass_plan()._table("cr", dev)
    kernel_row("real", (rows, n, n), lambda: dense_mm.dense_mm_real(xr, w),
               lambda: dense_mm.dense_mm_real_reference(xr, w),
               lambda: torch.matmul(xr, w),
               f32 * (2 * rows * n + n * n), 2.0 * rows * n * n)
    _real_body_lines("real", xr, w)
    del xr, xi
    n = 1024
    x, _ = _device_planes((rows, n), seed=33)
    w = realtrans._table(("dct", 2, n, "backward", False), dev)
    kernel_row("r2r", (rows, n, n), lambda: dense_mm.r2r_minor(x, w),
               lambda: dense_mm.r2r_minor_reference(x, w),
               lambda: torch.matmul(x, w),
               f32 * (2 * rows * n + n * n), 2.0 * rows * n * n)
    _real_body_lines("r2r", x, w)
    del x
    for key in DENSE_KERNELS:
        row = out[key]
        row["form"] = dense_mm.form(*row["mkn"][1:])
        row["bound_fp32_ms"] = row["flops"] / peak * 1e3
        row["bound_tf32x3_ms"] = 3 * row["flops"] / TF32_PEAK * 1e3
        print(f"  {key} {row['mkn']}: body {row['form']}, kernel "
              f"{row['ms']:.4f} ms; operations bound on the FP32 cores "
              f"{row['bound_fp32_ms']:.4f} ms, as 3xTF32 on the tensor "
              f"cores {row['bound_tf32x3_ms']:.4f} ms (3 x "
              f"{row['flops'] / 1e9:.1f} GFLOP at {TF32_PEAK / 1e12:.0f} "
              f"TFLOP/s); torch.matmul {row['library_ms']:.4f} ms, kernel / "
              f"matmul {row['ms'] / row['library_ms']:.3f}")
    # the filter's two routes on (100000, n): one K10 pass against K1,
    # the pointwise response, K1 (and cuFFT's composition, a yardstick)
    rng = np.random.default_rng(34)
    for n in CROSSOVER_NS:
        H = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        plan = tpufft_torch.plan_filter(n, response=H)
        xr, xi = _device_planes((rows, n), seed=n)
        xc = torch.complex(xr, xi)
        Hc = torch.as_tensor(H, dtype=torch.complex64, device=dev)
        t = {"dense_K10": _time_ms(lambda: plan._dense_complex(
                 xr, xi, adjoint=False)),
             "composed_K1": _time_ms(lambda: plan._composed(xr, xi)),
             "cufft_composed": _time_ms(lambda: torch.fft.ifft(
                 torch.fft.fft(xc) * Hc))}
        print(f"crossover filter ({rows}, {n}) c64, median of {REPS} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f"; dense / composed {t['dense_K10'] / t['composed_K1']:.3f}")
        del xr, xi, xc
    torch.cuda.synchronize()
    return out


# ----------------------------------------------------------------------------
# The short-time Fourier kernels K13, K14, K15 and the spectral paths
# ----------------------------------------------------------------------------

# (batch, nperseg, hop, nfft, nseg, detrend): hops 128, 64 and 32, nperseg
# 128 to 1024, nfft > nperseg, the three foldable detrends, a batch of 1
# and ragged batches and segment counts
STFT_KERNEL_CASES = ((3, 256, 128, 256, 300, False),
                     (1, 128, 64, 128, 1000, "constant"),
                     (70, 128, 64, 200, 131, "linear"),
                     (3, 1024, 256, 1024, 37, "constant"),
                     (5, 256, 128, 512, 129, "linear"),
                     (2, 128, 32, 128, 500, False))
SIG = (64, 1_048_576)   # the spectral paths' signals


# K13's and K15's frame FFT beyond those: odd nfft (255, 93), a hop longer
# than a frame, hop 1 (4096 frames a block); for K13 ShortTimeFFT's
# operands (below)
K13_CASES = ((4, 128, 64, 255, 1001, "linear"),
             (2, 93, 31, 93, 400, "constant"),
             (3, 64, 100, 64, 250, False),
             (2, 2, 1, 2, 9000, "linear"))


def _sft_k13():
    """A ShortTimeFFT with a phase shift, onesided2X and psd scaling."""
    return tpufft_torch.ShortTimeFFT(
        scipy.signal.get_window("hann", 128), 64, 48000.0,
        fft_mode="onesided2X", mfft=200, phase_shift=5, scale_to="psd")


def phase_stft_kernels() -> None:
    """K13, K14 and K15 (welch and csd) against their plain versions."""
    worst = {}
    cuda = torch.device("cuda")

    def hold(key, what, got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(norm_err(g, r) for g, r in zip(got, ref))
        worst[key] = max(worst.get(key, 0.0), err)
        check(all(g.dtype == torch.float32 and g.shape == r.shape
                  for g, r in zip(got, ref)),
              f"{key} {what}: output {got[0].dtype} {tuple(got[0].shape)}")
        check(err < F32_TOL, f"{key} vs plain {what}: {err:.3e} >= {F32_TOL}")

    def hold_k15(what, x, y, w, nfft, detrend, hop):
        """welch and csd against their plain versions; a second run gives
        the same bits."""
        for key, other in (("welch", None), ("csd", y)):
            got = stft_mm.welch_accum(x, w, nfft, detrend, hop, other)
            again = stft_mm.welch_accum(x, w, nfft, detrend, hop, other)
            check(all(torch.equal(a, b) for a, b in zip(
                got if other is not None else (got,),
                again if other is not None else (again,))),
                f"{key} {what}: two runs differ")
            hold(key, what, got, stft_mm.welch_accum_reference(
                x, w, nfft, detrend, hop, other))

    frame_cases = []
    for batch, nperseg, hop, nfft, nseg, detrend in STFT_KERNEL_CASES:
        win = scipy.signal.get_window("hann", nperseg)
        frame_cases.append((batch, hop, nseg, detrend, nfft,
                            spectral._frame_tables(win, nfft, 0.5, cuda)))
        w = spectral._frame_tables(win, nfft, 1.0, cuda)[0]
        # K14's operands: the window and c = 0.5; the dense body's matrix
        syn = spectral._frame_tables(win, nfft, 0.5, cuda)
        ar, ai = spectral._tables("istft", win, nperseg, nfft, 0.5, cuda)
        m1 = nfft // 2 + 1
        n_sig = (nseg - 1) * hop + nperseg + hop - 1
        for dtype in (torch.float32, torch.bfloat16):
            x, y = _planes((batch, n_sig), dtype, seed=nperseg + nseg)
            zr, zi = _planes((batch, nseg, m1), dtype, seed=m1)
            what = (f"batch {batch} nperseg {nperseg} hop {hop} nfft {nfft} "
                    f"nseg {nseg} detrend {detrend} {dtype}")
            # both sides read the same (bf16: the same rounded) values and
            # compute in f32: the f32 limit holds for either storage
            hold_k15(what, x, y, w, nfft, detrend, hop)
            ref = stft_mm.istft_frames_reference(zr, zi, *syn, nfft, hop)
            got = stft_mm.istft_frames(zr, zi, *syn, nfft, hop)
            again = stft_mm.istft_frames(zr, zi, *syn, nfft, hop)
            check(torch.equal(got, again), f"istft {what}: two runs differ")
            hold("istft", what, got, ref)
            err = norm_err(stft_mm.istft_ola(zr, zi, ar, ai, hop), ref)
            worst["istft_dense"] = max(worst.get("istft_dense", 0.0), err)
            check(err < F32_TOL, f"istft dense body {what}: {err:.3e}")
        print(f"  istft (K14) batch {batch} nperseg {nperseg} hop {hop} nfft "
              f"{nfft} nseg {nseg}: {stft_mm.istft_form(nfft)} form, and "
              "the dense body, vs plain")
    for batch, nperseg, hop, nfft, nseg, detrend in K13_CASES:
        win = scipy.signal.get_window("hann", nperseg)
        frame_cases.append((batch, hop, nseg, detrend, nfft,
                            spectral._frame_tables(win, nfft, 1.0, cuda)))
    sft = _sft_k13()
    frame_cases.append((3, 64, 700, "constant", 200, sft._frame_tables(cuda)))
    k15_cases = len(STFT_KERNEL_CASES) + len(K13_CASES)
    for i, (batch, hop, nseg, detrend, nfft, (w, cr, ci)) in enumerate(
            frame_cases):
        nperseg = w.shape[0]
        args = (w, cr, ci, nfft, detrend, hop, nseg)
        n_sig = (nseg - 1) * hop + nperseg + hop - 1
        for dtype in (torch.float32, torch.bfloat16):
            x, y = _planes((batch, n_sig), dtype, seed=nperseg + nseg)
            what = (f"batch {batch} nperseg {nperseg} hop {hop} nfft "
                    f"{nfft} nseg {nseg} detrend {detrend} {dtype}")
            hold("stft", what, stft_mm.stft_frames(x, *args),
                 stft_mm.stft_frames_reference(x, *args))
            if len(STFT_KERNEL_CASES) <= i < k15_cases:
                # K15 on K13's cases (the window the stft case's, c = 1)
                hold_k15(what, x, y, w, nfft, detrend, hop)
    torch.cuda.synchronize()
    for k in STFT_KERNELS + ("istft_dense",):
        print(f"{k} vs plain (f32 and bf16 signals): max normalized error "
              f"{worst[k]:.3e} (tol {F32_TOL})")
    print(f"stft (K13) cases: {len(frame_cases)} x f32/bf16, among them odd "
          f"nfft 255 and 93 and ShortTimeFFT(onesided2X, mfft 200, "
          f"phase_shift 5, psd); welch and csd (K15) cases: {k15_cases} x "
          f"f32/bf16, each run twice to the same bits")


def _sft128():
    return tpufft_torch.ShortTimeFFT(scipy.signal.get_window("hann", 128),
                                     64, 48000.0)


def phase_spectral_paths() -> dict:
    """Each spectral path once at full size with every count set to 0 just
    before each call and read just after, against scipy in float64 on a
    few rows; returns the launches per kernel."""
    total = dict.fromkeys(ALL_KERNELS, 0)
    x, y = _device_planes(SIG, seed=51)
    xh = x[:2].double().cpu().numpy()
    yh = y[:2].double().cpu().numpy()
    n = SIG[1]
    lines = []

    def run(name, fn, per_call, ref, got_rows=lambda r: r[:2]):
        out = _counted(lambda _: fn(), None, name, per_call, total)
        res = out[-1] if isinstance(out, tuple) else out
        check(res.is_cuda and bool(torch.isfinite(
            torch.view_as_real(res) if res.is_complex() else res).all()),
            f"{name}: output {res.dtype} on {res.device}")
        err = _rel(got_rows(res).cpu().numpy(), ref)
        check(err < SPECTRAL_TOL, f"{name}: vs scipy in f64 {err:.3e}")
        lines.append(f"path {name} {SIG} f32 -> {tuple(res.shape)} "
                     f"{res.dtype}: 2 rows vs scipy f64 {err:.3e}, "
                     f"launches {per_call}")
        return out

    _, _, Z = run("stft", lambda: tpufft_torch.stft(x, nperseg=256),
                  {"stft": 1}, scipy.signal.stft(xh, nperseg=256)[2])
    _, back = run("istft", lambda: tpufft_torch.istft(Z), {"istft": 1},
                  scipy.signal.istft(Z[:2].cpu().numpy().astype(
                      np.complex128))[1])
    rt = norm_err(back[:, :n], x)
    check(rt < SPECTRAL_TOL, f"istft(stft(x)) round trip {rt:.3e}")
    lines.append(f"  stft -> istft round trip {rt:.3e}")
    del Z, back
    run("welch", lambda: tpufft_torch.welch(x), {"welch": 1},
        scipy.signal.welch(xh)[1])
    run("csd", lambda: tpufft_torch.csd(x, y), {"csd": 1},
        scipy.signal.csd(xh, yh)[1])
    run("coherence", lambda: tpufft_torch.coherence(x, y),
        {"welch": 2, "csd": 1}, scipy.signal.coherence(xh, yh)[1])
    run("spectrogram", lambda: tpufft_torch.spectrogram(
        x, nperseg=256, noverlap=128), {"stft": 1},
        scipy.signal.spectrogram(xh, nperseg=256, noverlap=128)[2])
    sft, sft_ref = _sft128(), scipy.signal.ShortTimeFFT(
        scipy.signal.get_window("hann", 128), 64, 48000.0)
    S = run("ShortTimeFFT.stft hop 64", lambda: sft.stft(x), {"stft": 1},
            sft_ref.stft(xh))
    back = run("ShortTimeFFT.istft hop 64", lambda: sft.istft(S, k1=n),
               {"istft": 1}, sft_ref.istft(
                   S[:2].cpu().numpy().astype(np.complex128), k1=n))
    rt = norm_err(back, x)
    check(rt < SPECTRAL_TOL, f"ShortTimeFFT round trip {rt:.3e}")
    lines.append(f"  ShortTimeFFT stft -> istft round trip {rt:.3e}, "
                 f"{S.shape[-1]} slices a row")
    del S, back
    xs = x[:, :16384]
    run("periodogram", lambda: tpufft_torch.periodogram(xs), {"r2c": 1},
        scipy.signal.periodogram(xh[:, :16384])[1])
    g = np.random.default_rng(52)
    t_ls = np.sort(g.uniform(0, 100, 20000))
    y_ls = np.sin(2.1 * t_ls) + 0.3 * g.standard_normal(20000)
    f_ls = np.linspace(0.01, 10, 4000)
    dev = [torch.as_tensor(v, device="cuda") for v in (t_ls, y_ls, f_ls)]
    run("lombscargle", lambda: tpufft_torch.lombscargle(
        *dev, normalize=True), {},
        scipy.signal.lombscargle(t_ls, y_ls, f_ls, normalize=True),
        got_rows=lambda r: r)
    for line in lines:
        print(line)
    print(f"spectral paths, launches {total}, plain-version CUDA calls 0")
    return total


def phase_spectral_times() -> dict:
    """Times of the spectral paths and of K13, K14 and K15 alone at their
    paths' shapes; returns, per kernel, its time, its plain version's, the
    PyTorch yardstick's, its bytes and flops and its largest absolute
    error against the plain version."""
    out = {}
    f32 = 4

    def kernel_row(key, shape, kernel, plain, library, nbytes, flops,
                   lib_name):
        got, ref = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        abs_err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        err = max(norm_err(g, r) for g, r in zip(got, ref))
        check(err < F32_TOL, f"{key} {shape}: kernel vs plain {err:.3e}")
        del got, ref
        t_k, t_p, t_l = _time_ms(kernel), _time_ms(plain), _time_ms(library)
        print(f"  {key} alone {shape}: kernel {t_k:.4f} ms "
              f"({flops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s, "
              f"{nbytes / 1e9 / (t_k * 1e-3):.0f} GB/s), plain {t_p:.4f} "
              f"ms, {lib_name} {t_l:.4f} ms; vs plain max abs "
              f"{abs_err:.3e}, normalized {err:.3e}")
        out[key] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                    "bytes": nbytes, "flops": flops, "max_abs_err": abs_err}

    x, y = _device_planes(SIG, seed=53)
    batch, n = SIG
    sft = _sft128()
    _, _, Z = tpufft_torch.stft(x, nperseg=256)
    S = sft.stft(x)
    t = {"stft": _time_ms(lambda: tpufft_torch.stft(x, nperseg=256)),
         "istft": _time_ms(lambda: tpufft_torch.istft(Z)),
         "welch": _time_ms(lambda: tpufft_torch.welch(x)),
         "csd": _time_ms(lambda: tpufft_torch.csd(x, y)),
         "coherence": _time_ms(lambda: tpufft_torch.coherence(x, y)),
         "spectrogram_hop128": _time_ms(lambda: tpufft_torch.spectrogram(
             x, nperseg=256, noverlap=128)),
         "ShortTimeFFT_stft_hop64": _time_ms(lambda: sft.stft(x)),
         "ShortTimeFFT_istft_hop64": _time_ms(lambda: sft.istft(S, k1=n))}
    print(f"times spectral paths {SIG} f32, median of {REPS} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    del Z, S
    torch.cuda.synchronize()

    win = torch.hann_window(256, device="cuda", dtype=torch.float64)
    win32 = win.float()
    nperseg, hop, m1 = 256, 128, 129
    # K13 at the stft path's shape: the signal as the path gives it
    # (extended by nperseg / 2 a side and padded to whole segments)
    xe = torch.nn.functional.pad(x, (nperseg // 2, nperseg // 2))
    nseg = 1 + (xe.shape[1] - nperseg) // hop
    fold = math.sqrt(1.0 / win.sum().item() ** 2)
    out_floats = 2 * batch * nseg * m1
    frame_args = spectral._frame_tables(win.cpu().numpy(), nperseg, fold,
                                        torch.device("cuda")) + (
        nperseg, None, hop, nseg)
    # least work: the signal read once, the planes written once; the FFT's
    # flops (~2.5 nfft log2 nfft a real frame) are far below the bytes
    kernel_row("stft", (batch, xe.shape[1], nperseg, hop),
               lambda: stft_mm.stft_frames(xe, *frame_args),
               lambda: stft_mm.stft_frames_reference(xe, *frame_args),
               lambda: torch.stft(xe, 256, hop, window=win32, center=False,
                                  return_complex=True),
               f32 * (xe.numel() + out_floats),
               _fft_flops(nperseg, nseg * batch, real=True),
               "torch.stft(center=False)")
    # K14 at the istft path's shape, with the path's operands (the window,
    # c = the stft unscale, nfft)
    zr, zi = stft_mm.stft_frames(xe, *frame_args)
    zc = torch.complex(zr, zi).transpose(1, 2)
    unscale = float(win.sum().item())
    syn = spectral._frame_tables(win.cpu().numpy(), nperseg, unscale,
                                 torch.device("cuda"))
    ar, ai = spectral._tables("istft", win.cpu().numpy(), nperseg, nperseg,
                              unscale, torch.device("cuda"))
    n_out = (nseg - 1) * hop + nperseg
    # least work: the planes read once, the signal written once; an
    # inverse real FFT a segment, its window and its overlap-add (2 flops a
    # sample), far below the bytes
    kernel_row("istft", (batch, nseg, m1, hop),
               lambda: stft_mm.istft_frames(zr, zi, *syn, nperseg, hop),
               lambda: stft_mm.istft_frames_reference(zr, zi, *syn, nperseg,
                                                      hop),
               lambda: torch.istft(zc, 256, hop, window=win32, center=True),
               f32 * (out_floats + batch * n_out),
               _fft_flops(nperseg, nseg * batch, real=True)
               + 2.0 * nperseg * nseg * batch,
               "torch.istft(center=True)")
    t_dense = _time_ms(lambda: stft_mm.istft_ola(zr, zi, ar, ai, hop))
    print(f"  istft (K14) {(batch, nseg, m1, hop)}: "
          f"{stft_mm.istft_form(nperseg)} form {out['istft']['ms']:.4f} ms, "
          f"the dense body (kept in the library) {t_dense:.4f} ms, ratio "
          f"{out['istft']['ms'] / t_dense:.3f}")
    del zr, zi, zc
    # K15 at welch's shape (x as it is: no extension, no padding); least
    # work: the signal(s) read once, a real FFT a frame (two for csd) and a
    # few flops a bin, far below the bytes
    nseg_w = 1 + (n - nperseg) // hop
    k15 = (win32, nperseg, "constant", hop)
    fft_w = _fft_flops(nperseg, nseg_w * batch, real=True)

    def stft_sq():
        return torch.stft(x, 256, hop, window=win32, center=False,
                          return_complex=True).abs().pow(2).sum(-1)

    kernel_row("welch", (batch, n, nperseg, hop),
               lambda: stft_mm.welch_accum(x, *k15),
               lambda: stft_mm.welch_accum_reference(x, *k15),
               stft_sq, f32 * (x.numel() + batch * m1),
               fft_w + 3.0 * m1 * nseg_w * batch,
               "torch.stft, abs()**2, sum")

    def stft_cross():
        a = torch.stft(x, 256, hop, window=win32, center=False,
                       return_complex=True)
        b = torch.stft(y, 256, hop, window=win32, center=False,
                       return_complex=True)
        return (a.conj() * b).sum(-1)

    kernel_row("csd", (batch, n, nperseg, hop),
               lambda: stft_mm.welch_accum(x, *k15, y),
               lambda: stft_mm.welch_accum_reference(x, *k15, y),
               stft_cross, f32 * (2 * x.numel() + 2 * batch * m1),
               2 * fft_w + 8.0 * m1 * nseg_w * batch,
               "torch.stft twice, conj product, sum")
    # K13 and K14 at ShortTimeFFT's hop 64, m_num 128
    xp = torch.nn.functional.pad(x, (64, 64))
    sft_args = sft._frame_tables(x.device) + (
        128, None, 64, 1 + (xp.shape[1] - 128) // 64)
    yr, yi = stft_mm.stft_frames(xp, *sft_args)
    t64 = {"K13": _time_ms(lambda: stft_mm.stft_frames(xp, *sft_args))}
    sft_syn = sft._synthesis_tables(x.device)

    def sft_matrix():
        return sft._device_tables(("istft",), sft._fused_istft_matrix,
                                  x.device)

    t64["K14"] = _time_ms(lambda: stft_mm.istft_frames(
        yr, yi, *sft_syn, sft._mfft, 64, sft_matrix))
    t64["K14 form"] = stft_mm.istft_form(sft._mfft)
    print(f"  hop 64, m_num 128 on {tuple(xp.shape)} ({yr.shape[1]} "
          f"slices): " + ", ".join(
              f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
              for k, v in t64.items()))
    del yr, yi, xp, xe, x, y
    torch.cuda.synchronize()
    return out


def phase_cluster_kernels() -> None:
    """K5 and K6 against their plain versions; prints how many clusters of
    each the card holds at once."""
    worst = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for cube in CUBES:
        c = cube_fft.cluster_size(*cube)
        active = cube_fft.active_clusters(*cube, False, 0)
        print(f"K5 cube {cube}: {cube_fft.form(*cube)} form, clusters of "
              f"{c} blocks, {active} at once ({active * c} blocks on the "
              f"{sms} SMs)")
        check(active > 0, f"K5 {cube}: no cluster fits")
        for dtype in (torch.float32, torch.bfloat16):
            for pre in (3, 5):
                xr, xi = _planes((pre,) + cube, dtype, seed=sum(cube) + pre)
                for inverse in (False, True):
                    for scale in (1.0, 1.0 / math.prod(cube)):
                        kw = dict(inverse=inverse, scale=scale)
                        _hold(worst, "cube", dtype,
                              cube_fft.fft_cube(xr, xi, **kw),
                              cube_fft.fft_cube_reference(xr, xi, **kw),
                              f"{(pre,) + cube} {dtype} inverse={inverse} "
                              f"scale={scale}")
    for n1, n2, L in MID_PAIRS:
        c = mid_pair_fft.cluster_size(n1, n2)
        active = mid_pair_fft.active_clusters(n1, n2, False, 0)
        print(f"K6 pair ({n1}, {n2}) L {L}: {mid_pair_fft.form(n1, n2, L)} "
              f"form, tiles of {mid_pair_fft.lanes(n1, n2)} lanes of L, "
              f"clusters of {c} blocks, {active} at once ({active * c} "
              f"blocks on the {sms} SMs)")
        check(active > 0, f"K6 {(n1, n2)}: no cluster fits")
        for dtype in (torch.float32, torch.bfloat16):
            for pre in (3, 5):
                xr, xi = _planes((pre, n1, n2, L), dtype, seed=n1 + L + pre)
                for inverse in (False, True):
                    for scale in (1.0, 1.0 / (n1 * n2)):
                        kw = dict(inverse=inverse, scale=scale)
                        _hold(worst, "mid_pair", dtype,
                              mid_pair_fft.fft_mid_pair(xr, xi, **kw),
                              mid_pair_fft.fft_mid_pair_reference(xr, xi,
                                                                  **kw),
                              f"{(pre, n1, n2, L)} {dtype} "
                              f"inverse={inverse} scale={scale}")
    torch.cuda.synchronize()
    for k in CLUSTER_KERNELS:
        print(f"{k} vs plain: max normalized error f32 "
              f"{worst[(k, torch.float32)]:.3e} (tol {F32_TOL}), bf16 "
              f"{worst[(k, torch.bfloat16)]:.3e} (tol {BF16_TOL})")


CUBE_SHAPE = (100, 64, 64, 64)
CUBE_5D_SHAPE = (1, 64, 64, 64, 64)
MID_SHAPE = (32, 64, 128, 128)   # channels-last (B, H, W, C)
# The ND paths at full size: name, shape, axes, the launches of ONE
# transform per kernel.
ND_PATHS = (
    ("cube_last", CUBE_SHAPE, (1, 2, 3), {"cube": 1}),
    ("cube_5d", CUBE_5D_SHAPE, None, {"inner_nd": 1, "cube": 1}),
    ("mid_pair", MID_SHAPE, (1, 2), {"mid_pair": 1}),
)


def phase_nd_paths() -> dict:
    """Each ND path once forward and once back, counts reset around each
    call; the backward of the cube path; returns the launches per
    kernel."""
    total = dict.fromkeys(ALL_KERNELS, 0)
    for name, shape, axes, per_call in ND_PATHS:
        xr, xi = _device_planes(shape, seed=len(name))
        x = tpufft_torch.SplitComplex(xr, xi)
        y = _counted(lambda v: tpufft_torch.fftn(v, axes=axes), x, name,
                     per_call, total)
        back = _counted(lambda v: tpufft_torch.ifftn(v, axes=axes), y,
                        f"{name} inverse", per_call, total)
        check(y.shape == shape and y.dtype == torch.float32 and y.re.is_cuda,
              f"{name}: output {y.shape} {y.dtype}")
        check(bool(torch.isfinite(y.re).all() and torch.isfinite(y.im).all()),
              f"{name}: non-finite output")
        if axes is None:   # every axis: np.fft of the whole array
            k = shape[0]
            ref = np.fft.fftn(_np_slices(x, k))
        else:              # axis 0 is a batch: np.fft of two slices
            k = 2
            ref = np.fft.fftn(_np_slices(x, k), axes=axes)
        got = _np_slices(y, k)
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err < NP_TOL, f"{name}: vs np.fft {err:.3e}")
        rt = pair_err(back, x)
        check(rt < NP_TOL, f"{name}: round trip error {rt:.3e}")
        print(f"path {name} {shape} c64 axes {axes}: {k} slices vs np.fft "
              f"{err:.3e}, round trip {rt:.3e}, launches {per_call} a call, "
              "plain-version CUDA calls 0")
        del x, y, back, xr, xi
    # the backward on the card: L = sum(re^2) + 2 sum(im^2) of y = F x has
    # the gradient N ifftn(2 re + 4i im) (the opposite-sign transform)
    xr, xi = _device_planes(CUBE_SHAPE, seed=7)
    xr.requires_grad_(True)
    xi.requires_grad_(True)

    def loss_backward(x):
        out = tpufft_torch.fftn(x, axes=(1, 2, 3))
        (out.re.square().sum() + 2.0 * out.im.square().sum()).backward()
        return out

    out = _counted(loss_backward, tpufft_torch.SplitComplex(xr, xi),
                   "cube_last backward", {"cube": 2}, total)
    g = (2.0 * out.re[:2].detach().double().cpu().numpy()
         + 4.0j * out.im[:2].detach().double().cpu().numpy())
    want = np.fft.ifftn(g, axes=(1, 2, 3)) * math.prod(CUBE_SHAPE[1:])
    got = (xr.grad[:2].double().cpu().numpy()
           + 1j * xi.grad[:2].double().cpu().numpy())
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    check(err < NP_TOL, f"cube_last backward vs numpy {err:.3e}")
    print(f"backward of cube_last {CUBE_SHAPE}: K5 twice (forward and "
          f"backward), 2 slices of the gradient vs numpy {err:.3e}")
    del xr, xi, out
    print(f"ND paths, launches {total}, plain-version CUDA calls 0")
    return total


def _axes_1_2(xr, xi):
    """The route K6 replaces: axes 1 and 2 of (pre, n1, n2, L) planes one
    at a time, each on the kernel its layout picks (K3 then K2; K3 then K1
    when L = 1)."""
    yr, yi = execute._kernel_axis(xr, xi, 1, inverse=False, scale=1.0)
    return execute._kernel_axis(yr, yi, 2, inverse=False, scale=1.0)


def _mid_stage_form(xr, xi):
    """K6's stage form (its only form before the line form) on the same
    planes, through the C entry point: 4 lanes of L a tile, which the
    entry point runs on the stage form. Returns a call that launches it
    and the output planes it writes."""
    lib = _build.load()
    _, n1, n2, L = xr.shape
    c = cube_fft.pick_cluster(n1, n2 * mid_pair_fft.LANES)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    rad1, rad2 = minor_fft.radices(n1), minor_fft.radices(n2)
    arr1 = (ctypes.c_int * len(rad1))(*rad1)
    arr2 = (ctypes.c_int * len(rad2))(*rad2)
    tw1 = minor_fft._device_twiddles(n1, False, xr.device)
    tw2 = minor_fft._device_twiddles(n2, False, xr.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        check(lib.tpufft_mid_pair_fft(
            xr.data_ptr(), xi.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tw1.data_ptr(), tw2.data_ptr(), xr.shape[0], n1, n2, L,
            mid_pair_fft.LANES, c, arr1, len(rad1), arr2, len(rad2), 0, 1.0,
            0, stream) == 0, "mid_pair: the stage form did not launch")

    return run, (yr, yi)


def phase_nd_times() -> dict:
    """Times of the ND paths and of K5 and K6 alone at their paths' shapes,
    against their plain versions, cuFFT, the routes they replace and the
    copy floor; the L sweep of K6 against the two strided passes. Returns,
    per kernel, its time, its plain version's, cuFFT's, its bytes and
    flops and its largest absolute error against its plain version."""
    out = {}
    f32 = 4

    def kernel_row(key, shape, kernel, plain, library, nbytes, flops):
        got, ref = kernel(), plain()
        abs_err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        err = pair_err(got, ref)
        check(err < F32_TOL, f"{key} {shape}: kernel vs plain {err:.3e}")
        del got, ref
        t_k, t_p, t_l = _time_ms(kernel), _time_ms(plain), _time_ms(library)
        print(f"  {key} alone {shape}: kernel {t_k:.4f} ms "
              f"({nbytes / 1e9 / (t_k * 1e-3):.0f} GB/s), plain {t_p:.4f} "
              f"ms, torch.fft.fftn {t_l:.4f} ms; vs plain max abs "
              f"{abs_err:.3e}, normalized {err:.3e}")
        out[key] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                    "bytes": nbytes, "flops": flops, "max_abs_err": abs_err}

    # the cube (100, 64, 64, 64)
    pre, n1, n2, n3 = CUBE_SHAPE
    xr, xi = _device_planes(CUBE_SHAPE, seed=1)
    x = tpufft_torch.SplitComplex(xr, xi)
    xc = torch.complex(xr, xi)
    nb = 2 * 2 * f32 * xr.numel()
    v3 = (pre * n1, n2, n3)

    def old_cube():
        yr, yi = inner_fft.fft_inner_nd(xr.reshape(v3), xi.reshape(v3), n=n1,
                                        inverse=False, scale=1.0)
        return pair_fft.fft_pair(yr, yi, inverse=False, scale=1.0)

    t = {"path": _time_ms(lambda: tpufft_torch.fftn(x, axes=(1, 2, 3))),
         "old_route_K3_K4": _time_ms(old_cube),
         "torch_fftn": _time_ms(lambda: torch.fft.fftn(xc, dim=(1, 2, 3))),
         "copy_floor": _copy_floor_ms(nb)}
    print(f"times cube_last {CUBE_SHAPE} c64, median of {REPS} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f"; one pass {nb / 1e9:.4f} GB")
    kernel_row("cube", CUBE_SHAPE,
               lambda: cube_fft.fft_cube(xr, xi, inverse=False, scale=1.0),
               lambda: cube_fft.fft_cube_reference(xr, xi, inverse=False,
                                                   scale=1.0),
               lambda: torch.fft.fftn(xc, dim=(1, 2, 3)), nb,
               _fft_flops(n1 * n2 * n3, pre))
    print(f"  K5 {CUBE_SHAPE}: {cube_fft.form(n1, n2, n3)} form, clusters "
          f"of {cube_fft.cluster_size(n1, n2, n3)} blocks, "
          f"{cube_fft.active_clusters(n1, n2, n3, False, 0)} at once: K5 "
          f"{out['cube']['ms']:.4f} ms, K3 + K4 {t['old_route_K3_K4']:.4f} "
          f"ms, cuFFT {t['torch_fftn']:.4f} ms")
    del x, xc, xr, xi
    # every axis of (1, 64, 64, 64, 64): K3 along axis 1, then K5
    xr, xi = _device_planes(CUBE_5D_SHAPE, seed=2)
    x = tpufft_torch.SplitComplex(xr, xi)
    xc = torch.complex(xr, xi)
    nb = 2 * 2 * f32 * xr.numel()
    t = {"path": _time_ms(lambda: tpufft_torch.fftn(x)),
         "torch_fftn": _time_ms(lambda: torch.fft.fftn(xc)),
         "copy_floor_per_pass": _copy_floor_ms(nb)}
    print(f"times cube_5d {CUBE_5D_SHAPE} c64, median of {REPS} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    del x, xc, xr, xi
    # the mid pair (32, 64, 128, 128)
    pre, n1, n2, L = MID_SHAPE
    xr, xi = _device_planes(MID_SHAPE, seed=3)
    x = tpufft_torch.SplitComplex(xr, xi)
    xc = torch.complex(xr, xi)
    nb = 2 * 2 * f32 * xr.numel()
    t = {"path": _time_ms(lambda: tpufft_torch.fftn(x, axes=(1, 2))),
         "old_route_K3_K2": _time_ms(lambda: _axes_1_2(xr, xi)),
         "torch_fftn": _time_ms(lambda: torch.fft.fftn(xc, dim=(1, 2))),
         "copy_floor": _copy_floor_ms(nb)}
    print(f"times mid_pair {MID_SHAPE} c64, median of {REPS} ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f"; one pass {nb / 1e9:.4f} GB")
    kernel_row("mid_pair", MID_SHAPE,
               lambda: mid_pair_fft.fft_mid_pair(xr, xi, inverse=False,
                                                 scale=1.0),
               lambda: mid_pair_fft.fft_mid_pair_reference(
                   xr, xi, inverse=False, scale=1.0),
               lambda: torch.fft.fftn(xc, dim=(1, 2)), nb,
               _fft_flops(n1 * n2, pre * L))
    stage, planes = _mid_stage_form(xr, xi)
    stage()
    err = pair_err(planes, mid_pair_fft.fft_mid_pair_reference(
        xr, xi, inverse=False, scale=1.0))
    check(err < F32_TOL, f"mid_pair stage form vs plain {err:.3e}")
    out["mid_pair"]["stage_ms"] = t_stage = _time_ms(stage)
    print(f"  K6 {MID_SHAPE}: {mid_pair_fft.form(n1, n2, L)} form, tiles "
          f"of {mid_pair_fft.lanes(n1, n2)} lanes, clusters of "
          f"{mid_pair_fft.cluster_size(n1, n2)} blocks, "
          f"{mid_pair_fft.active_clusters(n1, n2, False, 0)} at once: K6 "
          f"{out['mid_pair']['ms']:.4f} ms, the stage form (4 lanes) "
          f"{t_stage:.4f} ms (vs plain {err:.3e}), K3 + K2 "
          f"{t['old_route_K3_K2']:.4f} ms, torch.fft.fftn "
          f"{t['torch_fftn']:.4f} ms")
    del x, xc, xr, xi, stage, planes
    # the L sweep: K6 (its form, and the stage form) against the two axis
    # passes on (pre, 64, 128, L) planes of about 268 MB
    for L in MID_PAIR_SWEEP_LS:
        pre = 4096 // L
        shape = (pre, n1, n2, L)
        xr, xi = _device_planes(shape, seed=L)
        t_k6 = _time_ms(lambda: mid_pair_fft.fft_mid_pair(
            xr, xi, inverse=False, scale=1.0))
        stage, _ = _mid_stage_form(xr, xi)
        t_stage = _time_ms(stage)
        t_two = _time_ms(lambda: _axes_1_2(xr, xi))
        print(f"  L sweep {shape} ({2 * f32 * xr.numel() / 1e6:.0f} MB): "
              f"K6 {mid_pair_fft.form(n1, n2, L)} form {t_k6:.4f} ms, stage "
              f"form {t_stage:.4f} ms, two strided passes {t_two:.4f} ms, "
              f"K6 / two passes {t_k6 / t_two:.3f}")
        del xr, xi, stage
    torch.cuda.synchronize()
    return out


# ----------------------------------------------------------------------------
# Phases 21-23: the fused-storage kernels (K16-K20) and the layouts
# ----------------------------------------------------------------------------

# kernel, logical shape of a fused array whose last dim is the half h:
# halves 8 to 16384 (93 and every mixed-radix and three-factor length of
# K1's line form among them), ragged pre, B and M, and the cubes of phase
# 18 (clusters of 1 to 16 blocks)
FUSED_CASES = tuple(
    ("minor", (257, n)) for n in (2, 4, 8, 16, 32, 64, 128, 256, 512, 2048,
                                  4096)) + tuple(
    # K20 at every mixed-radix and three-factor length of K1's line form
    ("minor", (37, n)) for n in sorted({*minor_fft._MIXED_STEP,
                                        *minor_fft._LONG_STEP} - {93, 16384})
    ) + (
    ("minor", (257, 93)), ("minor", (37, 1024)), ("minor", (5, 16384)),
    ("inner", (3, 64, 37, 93)), ("inner", (11, 128, 3, 256)),
    ("inner", (2, 16, 5, 8)), ("inner", (1, 2048, 3, 8)),
    ("inner_m1", (5, 128, 93)), ("inner_m1", (3, 8, 16384)),
    ("inner_m1", (13, 93, 64)),
) + tuple(
    # K18/K19 at every length of the strided line form, halves L = 2 to
    # 256 (a unit's columns spanning several m; L < 8 takes 8 columns
    # of several halves)
    case for i, n in enumerate(STRIDED_LINE_NS) if n <= 2048 for case in (
        ("inner", (3, n, 5, (2, 8, 64, 256)[i % 4])),
        ("inner_m1", (3, n, (256, 64, 8, 16)[i % 4])))) + tuple(
    # and at every length of its cluster form, on narrower arrays
    case for i, n in enumerate(STRIDED_CLUSTER_NS) for case in (
        ("inner", (2, n, 3, (8, 40)[i % 2])),
        ("inner_m1", (2, n, (40, 16)[i % 2])))) + (
    ("pair", (13, 64, 64)), ("pair", (13, 8, 93)), ("pair", (5, 128, 128)),
    ("pair", (7, 160, 48)),
) + tuple(("cube", (3,) + c) for c in CUBES)
FUSED_CALLS = {
    "minor": (fused_fft.fft_minor_fused, fused_fft.fft_minor_fused_reference),
    "inner": (fused_fft.fft_inner_fused, fused_fft.fft_inner_fused_reference),
    "inner_m1": (fused_fft.fft_inner_fused,
                 fused_fft.fft_inner_fused_reference),
    "pair": (fused_fft.fft_pair_fused, fused_fft.fft_pair_fused_reference),
    "cube": (fused_fft.fft_cube_fused, fused_fft.fft_cube_fused_reference),
}


def _fused_array(shape, dtype, seed):
    """A fused (..., 2 * shape[-1]) array on the card, rows [re | im]."""
    re, im = _planes(shape, torch.float32, seed)
    return torch.cat([re, im], -1).to(dtype)


def _halves(st):
    h = st.shape[-1] // 2
    return st[..., :h], st[..., h:]


def phase_fused_kernels() -> None:
    """K16-K20 against their plain versions; prints the worst normalized
    error per kernel and dtype."""
    worst = {}
    for key, shape in FUSED_CASES:
        kernel, plain = FUSED_CALLS[key]
        n_total = math.prod(shape[1:] if key in ("cube", "pair")
                            else shape[1:2])
        if key == "cube":
            active = cube_fft.active_clusters(*shape[1:], False, 0,
                                              fused=True)
            check(active > 0, f"K16 {shape[1:]}: no cluster fits")
        at = {}
        for dtype in (torch.float32, torch.bfloat16):
            st = _fused_array(shape, dtype, seed=sum(shape))
            for inverse in (False, True):
                for scale in (1.0, 1.0 / n_total):
                    kw = dict(inverse=inverse, scale=scale)
                    _hold(at, key, dtype, _halves(kernel(st, **kw)),
                          _halves(plain(st, **kw)),
                          f"{shape} {dtype} inverse={inverse} scale={scale}")
        for k, v in at.items():
            worst[k] = max(worst.get(k, 0.0), v)
        if key in ("inner", "inner_m1") and shape[1] in STRIDED_LINE_NS:
            M, L = (shape[2], shape[3]) if key == "inner" else (1, shape[2])
            print(f"  {'K18' if key == 'inner' else 'K19'} {shape}: f32 "
                  f"{fused_fft.inner_form(shape[1], M, L, torch.float32)} "
                  f"form, bf16 "
                  f"{fused_fft.inner_form(shape[1], M, L, torch.bfloat16)} "
                  f"form; max normalized error f32 "
                  f"{at[(key, torch.float32)]:.3e}, bf16 "
                  f"{at[(key, torch.bfloat16)]:.3e}")
        if key == "minor":
            print(f"  K20 {shape} ({fused_fft.minor_form(shape[1])} form): "
                  f"max normalized error f32 {at[(key, torch.float32)]:.3e}, "
                  f"bf16 {at[(key, torch.bfloat16)]:.3e}")
    torch.cuda.synchronize()
    for k in FUSED_CALLS:
        print(f"fused {k} vs plain: max normalized error f32 "
              f"{worst[(k, torch.float32)]:.3e} (tol {F32_TOL}), bf16 "
              f"{worst[(k, torch.bfloat16)]:.3e} (tol {BF16_TOL})")


# The layout paths at full size: name, logical shape, axes, layout, the
# PlanConfig profile, and the launches of ONE call per kernel.
LAYOUT_PATHS = (
    ("P1", CUBE_SHAPE, (1, 2, 3), "lane-fused", None, {"fused_cube": 1}),
    ("P1b", CUBE_SHAPE, (1, 2, 3), "lane-fused", "fast", {"fused_cube": 1}),
    ("P2", CUBE_5D_SHAPE, (1, 2, 3, 4), "lane-fused", None,
     {"fused_inner": 1, "fused_cube": 1}),
    ("P3", (10, 128, 128, 128), (1, 2, 3), "lane-fused", None,
     {"fused_inner": 1, "fused_pair": 1}),
    ("P4", (16, 64, 128, 256), (1, 2, 3), "lane-fused", None,
     {"fused_inner": 1, "fused_inner_m1": 1, "fused_minor": 1}),
    ("T1", (1_000_000, 93), (-1,), "transform-major", None, {"inner": 1}),
    ("T2", (1, 25, 160, 160, 48), (1, 2, 3, 4), "transform-major", None,
     {"inner_nd": 1, "mid_pair": 1, "minor": 1}),
)


def _layout_plans(shape, axes, layout, profile):
    """The forward and inverse plans of a layout path, and the forward
    natural-layout plan of the same logical data."""
    cfg = None if profile is None else tpufft_torch.PlanConfig(
        profile=profile)
    kw = dict(axes=axes, config=cfg)
    return (tpufft_torch.plan_fft(shape, layout=layout, **kw),
            tpufft_torch.plan_fft(shape, layout=layout, inverse=True, **kw),
            tpufft_torch.plan_fft(shape, **kw))


def phase_layout_paths() -> dict:
    """Each layout path once forward and once back through its inverse
    plan, counts reset around each call; the backward of P1; returns the
    launches per kernel."""
    total = dict.fromkeys(ALL_KERNELS, 0)
    for name, shape, axes, layout, profile, per_call in LAYOUT_PATHS:
        xr, xi = _device_planes(shape, seed=len(shape) + shape[-1])
        x = tpufft_torch.SplitComplex(xr, xi)
        fwd, inv, _ = _layout_plans(shape, axes, layout, profile)
        packed = fwd.pack(x)
        y = _counted(fwd, packed, name, per_call, total)
        back = _counted(inv, y, f"{name} inverse", per_call, total)
        out, rt_planes = fwd.unpack(y), inv.unpack(back)
        check(out.shape == shape and out.re.is_cuda and bool(
            torch.isfinite(out.re).all() and torch.isfinite(out.im).all()),
            f"{name}: output {out.shape}")
        dims = tuple(a % len(shape) for a in axes)
        k = shape[0] if 0 in dims else (4 if len(shape) == 2 else 2)
        ref = np.fft.fftn(_np_slices(x, k), axes=dims)
        got = _np_slices(out, k)
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        tol = BF16_TOL if profile else NP_TOL
        check(err < tol, f"{name}: vs np.fft {err:.3e} >= {tol}")
        rt = pair_err(rt_planes, x)
        check(rt < tol, f"{name}: round trip error {rt:.3e} >= {tol}")
        print(f"path {name} {layout} {shape} axes {axes}"
              + (f" profile={profile}" if profile else "")
              + f": physical {tuple(y.shape)} {y.dtype}, {k} slices vs "
              f"np.fft {err:.3e}, round trip {rt:.3e}, launches {per_call} "
              "a call, plain-version CUDA calls 0")
        del x, xr, xi, packed, y, back, out, rt_planes
    # the backward of P1: L = <plan(st), w> has the gradient A^T w, the
    # opposite-sign pass: N ifftn of w's complex value
    fwd, _, _ = _layout_plans(CUBE_SHAPE, (1, 2, 3), "lane-fused", None)
    st = fwd.pack(tpufft_torch.SplitComplex(*_device_planes(CUBE_SHAPE, 7)))
    st.requires_grad_(True)
    w = torch.cat(_device_planes(CUBE_SHAPE, 8), -1)

    def loss_backward(v):
        out = fwd(v)
        (out * w).sum().backward()
        return out

    _counted(loss_backward, st, "P1 backward", {"fused_cube": 2}, total)
    wc = _np_slices(tpufft_torch.SplitComplex(*_halves(w)), 2)
    want = np.fft.ifftn(wc, axes=(1, 2, 3)) * math.prod(CUBE_SHAPE[1:])
    got = _np_slices(tpufft_torch.SplitComplex(*_halves(st.grad)), 2)
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    check(err < NP_TOL, f"P1 backward vs numpy {err:.3e}")
    print(f"backward of P1 {CUBE_SHAPE}: K16 twice (forward and backward), "
          f"2 slices of the gradient vs numpy {err:.3e}")
    del st, w
    print(f"layout paths, launches {total}, plain-version CUDA calls 0")
    return total


def phase_layout_times() -> dict:
    """Times of the layout paths, pack, unpack, the natural-layout plan,
    cuFFT and the copy floor; each fused kernel alone beside its
    split-plane sibling on the same data, its plain version and a
    ``torch.fft`` call of the same function. Returns, per kernel row, its
    time, plain and library times, bytes, flops and largest absolute error
    against its plain version."""
    out = {}

    def kernel_row(key, what, kernel, plain, sibling, library, nbytes,
                   flops, tol=F32_TOL):
        got, ref = kernel(), plain()
        abs_err = (got.float() - ref.float()).abs().max().item()
        err = pair_err(_halves(got), _halves(ref))
        check(err < tol, f"{key} {what}: kernel vs plain {err:.3e}")
        del got, ref
        t_k, t_s = _time_ms(kernel), _time_ms(sibling)
        t_p, t_l = _time_ms(plain), _time_ms(library)
        print(f"  {key} alone {what}: kernel {t_k:.4f} ms "
              f"({nbytes / 1e9 / (t_k * 1e-3):.0f} GB/s), split-plane "
              f"sibling {t_s:.4f} ms, plain {t_p:.4f} ms, torch.fft "
              f"{t_l:.4f} ms; vs plain max abs {abs_err:.3e}, normalized "
              f"{err:.3e}")
        out[key] = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                    "sibling_ms": t_s, "bytes": nbytes, "flops": flops,
                    "max_abs_err": abs_err}

    for name, shape, axes, layout, profile, _ in LAYOUT_PATHS:
        xr, xi = _device_planes(shape, seed=1)
        x = tpufft_torch.SplitComplex(xr, xi)
        xc = torch.complex(xr, xi)
        fwd, _, nat = _layout_plans(shape, axes, layout, profile)
        packed = fwd.pack(x)
        y = fwd(packed)
        dims = tuple(a % len(shape) for a in axes)
        elem = 2 if profile else 4
        nb = 2 * 2 * elem * xr.numel()
        t = {"path": _time_ms(lambda: fwd(packed)),
             "pack": _time_ms(lambda: fwd.pack(x)),
             "unpack": _time_ms(lambda: fwd.unpack(y)),
             "natural": _time_ms(lambda: nat(x)),
             "torch_fftn": _time_ms(lambda: torch.fft.fftn(xc, dim=dims)),
             "copy_floor": _copy_floor_ms(nb)}
        print(f"times {name} {layout} {shape} axes {axes}"
              + (f" profile={profile}" if profile else "")
              + f", median of {REPS} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f"; one pass {nb / 1e9:.4f} GB")
        if name in ("P1", "P1b"):
            dt = torch.bfloat16 if profile else torch.float32
            st, ar, ai = packed.to(dt), xr.to(dt), xi.to(dt)
            kw = dict(inverse=False, scale=1.0)
            kernel_row("K16" if dt == torch.float32 else "K16_bf16",
                       f"{shape} {dt}",
                       lambda: fused_fft.fft_cube_fused(st, **kw),
                       lambda: fused_fft.fft_cube_fused_reference(st, **kw),
                       lambda: cube_fft.fft_cube(ar, ai, **kw),
                       lambda: torch.fft.fftn(xc, dim=dims), nb,
                       _fft_flops(math.prod(shape[1:]), shape[0]),
                       F32_TOL if dt == torch.float32 else BF16_TOL)
            key = "K16" if dt == torch.float32 else "K16_bf16"
            n1, n2, n3 = shape[1:]
            v3 = (shape[0] * n1, n2, n3)

            def old_cube():
                yr, yi = inner_fft.fft_inner_nd(ar.reshape(v3),
                                                ai.reshape(v3), n=n1, **kw)
                return pair_fft.fft_pair(yr, yi, **kw)

            t_old = _time_ms(old_cube)
            active = cube_fft.active_clusters(
                n1, n2, n3, dt == torch.bfloat16, 0, fused=True)
            print(f"  {key} {shape} {dt}: {cube_fft.form(n1, n2, n3)} form, "
                  f"clusters of {cube_fft.cluster_size(n1, n2, n3)} blocks, "
                  f"{active} at once: K16 {out[key]['ms']:.4f} ms, K5 "
                  f"{out[key]['sibling_ms']:.4f} ms, K3 + K4 {t_old:.4f} ms, "
                  f"cuFFT {out[key]['library_ms']:.4f} ms")
            del st, ar, ai
        elif name in ("P2", "P3", "P4"):
            pre, n, M = shape[0], shape[1], math.prod(shape[2:-1])
            v4 = (pre, n, M, 2 * shape[-1])
            v3 = (pre * n, M, shape[-1])
            kw = dict(inverse=False, scale=1.0)
            kernel_row(f"K18_{name}", str(v4),
                       lambda: fused_fft.fft_inner_fused(
                           packed.reshape(v4), **kw),
                       lambda: fused_fft.fft_inner_fused_reference(
                           packed.reshape(v4), **kw),
                       lambda: inner_fft.fft_inner_nd(
                           xr.reshape(v3), xi.reshape(v3), n=n, **kw),
                       lambda: torch.fft.fft(xc, dim=1), nb,
                       _fft_flops(n, xr.numel() // n))
            print(f"  K18_{name} {v4}: "
                  f"{fused_fft.inner_form(n, M, shape[-1], torch.float32)} "
                  "form")
            if name == "P3":
                n2, n3 = shape[-2:]
                v = (-1, n2, 2 * n3)
                c3 = xc.reshape(-1, n2, n3)
                kernel_row("K17", str(tuple(packed.reshape(v).shape)),
                           lambda: fused_fft.fft_pair_fused(
                               packed.reshape(v), **kw),
                           lambda: fused_fft.fft_pair_fused_reference(
                               packed.reshape(v), **kw),
                           lambda: pair_fft.fft_pair(
                               xr.reshape(c3.shape), xi.reshape(c3.shape),
                               **kw),
                           lambda: torch.fft.fft2(c3), nb,
                           _fft_flops(n2 * n3, c3.shape[0]))
                del c3
            if name == "P4":
                n2, n3 = shape[-2:]
                v4 = (pre * n, n2, 1, 2 * n3)
                c3 = xc.reshape(pre * n, n2, n3)
                kernel_row("K19", str(v4),
                           lambda: fused_fft.fft_inner_fused(
                               packed.reshape(v4), **kw),
                           lambda: fused_fft.fft_inner_fused_reference(
                               packed.reshape(v4), **kw),
                           lambda: inner_fft.fft_inner(
                               xr.reshape(c3.shape), xi.reshape(c3.shape),
                               **kw),
                           lambda: torch.fft.fft(c3, dim=1), nb,
                           _fft_flops(n2, xr.numel() // n2))
                print(f"  K19 {v4}: "
                      f"{fused_fft.inner_form(n2, 1, n3, torch.float32)} "
                      "form")
                v2 = (-1, 2 * n3)
                r2, i2 = xr.reshape(-1, n3), xi.reshape(-1, n3)
                kernel_row("K20", str(tuple(packed.reshape(v2).shape)),
                           lambda: fused_fft.fft_minor_fused(
                               packed.reshape(v2), **kw),
                           lambda: fused_fft.fft_minor_fused_reference(
                               packed.reshape(v2), **kw),
                           lambda: minor_fft.fft_minor(r2, i2, **kw),
                           lambda: torch.fft.fft(c3, dim=-1), nb,
                           _fft_flops(n3, xr.numel() // n3))
                del c3, r2, i2
        elif name == "T1":
            pr, pi = packed
            t_k2 = _time_ms(lambda: inner_fft.fft_inner(
                pr.reshape(1, *pr.shape), pi.reshape(1, *pi.shape),
                inverse=False, scale=1.0))
            t_k1 = _time_ms(lambda: minor_fft.fft_minor(
                xr, xi, inverse=False, scale=1.0))
            print(f"  K2 on the physical {tuple(pr.shape)}: {t_k2:.4f} ms "
                  f"({nb / 1e9 / (t_k2 * 1e-3):.0f} GB/s); K1 on the natural "
                  f"{shape}: {t_k1:.4f} ms")
        del x, xc, xr, xi, packed, y
        torch.cuda.synchronize()
    # small halves: a half of L f32 values is a run of 4L bytes, part of a
    # 32-byte sector below L = 8; K18 against K3 on the same 268 MB
    for L in (2, 4, 8, 16, 64):
        xr, xi = _device_planes((64, 262144 // L, L), seed=L)
        st = torch.cat([xr, xi], -1).reshape(1, 64, 262144 // L, 2 * L)
        kw = dict(inverse=False, scale=1.0)
        t_f = _time_ms(lambda: fused_fft.fft_inner_fused(st, **kw))
        t_s = _time_ms(lambda: inner_fft.fft_inner_nd(xr, xi, n=64, **kw))
        print(f"  small halves: K18 on {tuple(st.shape)} {t_f:.4f} ms, K3 on "
              f"its planes {t_s:.4f} ms, ratio {t_f / t_s:.3f}")
        del xr, xi, st
    return out


# ----------------------------------------------------------------------------
# Phase 24: the multirate, IIR, sigtools and ndimage paths
# ----------------------------------------------------------------------------

MULTIRATE_TOL = 1e-3   # f32 paths vs scipy in float64 (bench.py's check)
MULTIRATE_REPS = 5
IMAGE = (4096, 4096)          # wiener's image
MEDIAN_IMAGE = (2048, 2048)   # medfilt2d's
BLUR = (100, 640, 480)        # fourier_gaussian between rfftn and irfftn


def _time_peak(fn) -> tuple[float, float]:
    """Median of MULTIRATE_REPS CUDA-event times of fn after one warm-up
    call, and one call's peak device memory above what was allocated
    before it, in GB."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(MULTIRATE_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (statistics.median(times),
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def phase_multirate_paths(rate: float) -> dict:
    """Each multirate, IIR, sigtools and ndimage path once at full size with
    every count set to 0 just before it and read just after, against scipy
    in float64, then timed; returns the launches per kernel."""
    import scipy.ndimage

    from tpufft_torch import ndimage

    total = dict.fromkeys(ALL_KERNELS, 0)
    x, _ = _device_planes(SIG, seed=61)
    xh = x[:4].double().cpu().numpy()
    b2, a2 = tpufft_torch.butter(2, 0.2)
    zi1 = tpufft_torch.lfilter_zi(b2, a2)
    zi = torch.as_tensor(zi1, dtype=torch.float32, device="cuda") * x[:, :1]
    fir = tpufft_torch.firwin(101, 0.2)
    img = _device_planes(IMAGE, seed=62)[0]
    med = _device_planes(MEDIAN_IMAGE, seed=63)[0]
    vol = _device_planes(BLUR, seed=64)[0]
    vh = vol[:4].double().cpu().numpy()
    sig = 4 * math.prod(SIG)

    def blur():
        spec = tpufft_torch.rfftn(vol, axes=(1, 2))
        spec = ndimage.fourier_gaussian(spec, (0.0, 2.0, 2.0), n=BLUR[2],
                                        axis=-1)
        return tpufft_torch.irfftn(spec, s=BLUR[1:], axes=(1, 2))

    def blur_f64():
        spec = scipy.ndimage.fourier_gaussian(
            np.fft.rfftn(vh, axes=(1, 2)), (0.0, 2.0, 2.0), n=BLUR[2],
            axis=-1)
        return np.fft.irfftn(spec, s=BLUR[1:], axes=(1, 2))

    # name, call, whether it runs an FFT convolution (kernels must launch),
    # the result's rows to compare, scipy in float64 on those rows, and the
    # bytes of the input read and the output written once
    paths = (
        ("decimate iir q=4", lambda: tpufft_torch.decimate(x, 4), False,
         lambda y: y[:4], lambda: scipy.signal.decimate(xh, 4),
         sig * 1.25),
        ("decimate fir q=4",
         lambda: tpufft_torch.decimate(x, 4, ftype="fir"), True,
         lambda y: y[:4],
         lambda: scipy.signal.decimate(xh, 4, ftype="fir"), sig * 1.25),
        ("resample_poly 3/2",
         lambda: tpufft_torch.resample_poly(x, 3, 2, axis=-1), True,
         lambda y: y[:4],
         lambda: scipy.signal.resample_poly(xh, 3, 2, axis=-1), sig * 2.5),
        ("lfilter butter(2) zi",
         lambda: tpufft_torch.lfilter(b2, a2, x, zi=zi), False,
         lambda y: torch.cat([y[0][:4], y[1][:4]], -1),
         lambda: np.concatenate(scipy.signal.lfilter(
             b2, a2, xh, zi=zi1[None, :] * xh[:, :1]), -1), sig * 2),
        ("lfilter firwin(101)", lambda: tpufft_torch.lfilter(fir, 1.0, x),
         True, lambda y: y[:4], lambda: scipy.signal.lfilter(fir, 1.0, xh),
         sig * 2),
        ("savgol_filter 101/3",
         lambda: tpufft_torch.savgol_filter(x, 101, 3), True,
         lambda y: y[:4], lambda: scipy.signal.savgol_filter(xh, 101, 3),
         sig * 2),
        (f"wiener {IMAGE}", lambda: tpufft_torch.wiener(img), True,
         lambda y: y, lambda: scipy.signal.wiener(
             img.double().cpu().numpy()), 8 * math.prod(IMAGE)),
        (f"medfilt2d {MEDIAN_IMAGE}", lambda: tpufft_torch.medfilt2d(med),
         False, lambda y: y,
         lambda: scipy.signal.medfilt2d(med.cpu().numpy()),
         8 * math.prod(MEDIAN_IMAGE)),
        (f"fourier_gaussian {BLUR}", blur, True, lambda y: y[:4], blur_f64,
         8 * math.prod(BLUR)),
    )
    for name, fn, convolves, rows, ref, nbytes in paths:
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        check(plain == 0, f"{name}: plain versions ran {plain} times on "
              "CUDA tensors")
        launched = {k: v for k, v in by_kernel.items() if v}
        check(bool(launched) == convolves,
              f"{name}: kernel launches {launched}")
        for k, v in by_kernel.items():
            total[k] += v
        res = out[0] if isinstance(out, tuple) else out
        check(res.is_cuda and res.dtype == torch.float32
              and bool(torch.isfinite(res).all()),
              f"{name}: output {res.dtype} on {res.device}")
        err = _rel(rows(out).double().cpu().numpy(), ref())
        check(err < MULTIRATE_TOL, f"{name}: vs scipy in f64 {err:.3e}")
        shape = tuple(res.shape)
        del out, res
        ms, peak = _time_peak(fn)
        print(f"path {name} -> {shape} f32: vs scipy f64 {err:.3e}, "
              f"launches {launched}, plain-version CUDA calls {plain}; "
              f"median of {MULTIRATE_REPS} {ms:.3f} ms, peak "
              f"{peak:.3f} GB above the inputs, byte floor "
              f"{nbytes / rate * 1e3:.4f} ms")
    del x, zi, img, med, vol
    print(f"multirate/IIR/sigtools/ndimage paths, launches "
          f"{ {k: v for k, v in total.items() if v} }, plain-version CUDA "
          "calls 0")
    return total


# ----------------------------------------------------------------------------
# Phase 25: the design, LTI and waveform paths
# ----------------------------------------------------------------------------

FREQZ_TOL = 1e-5      # f32 FFT of the padded taps vs scipy's f64 response
DLSIM_TOL = 1e-3      # the f32 scan vs scipy's f64 loop, of the output's size
FREQZ_BANK = (129, 16384)   # taps, filters: a sweep of candidate designs
FREQZ_LONG = 65537          # one long equalizer, on a 2**20-point grid
DLSIM_SHAPE = (1_048_576, 4)
DLSIM_SYSTEM = (8, 4, 2)    # states, inputs, outputs
WAVE_SHAPE = (64, 1_048_576)


class _NoHostCopies:
    """Within the block, a CUDA tensor's ``cpu``, ``numpy``, ``item`` and
    ``tolist`` raise: the device paths must not copy to the host. Up to
    ``allow`` calls of ``cpu`` go through, counted in ``copies`` with
    their bytes in ``nbytes``."""

    NAMES = ("cpu", "numpy", "item", "tolist")

    def __init__(self, allow: int = 0):
        self.allow = allow
        self.copies = 0
        self.nbytes = 0

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}

        def refuse(name):
            def method(t, *args, **kwargs):
                if not t.is_cuda:
                    return self.saved[name](t, *args, **kwargs)
                if name == "cpu" and self.copies < self.allow:
                    self.copies += 1
                    self.nbytes += t.numel() * t.element_size()
                    return self.saved[name](t, *args, **kwargs)
                raise RuntimeError(f"host copy ({name}) on a device path")
            return method

        for n in self.NAMES:
            setattr(torch.Tensor, n, refuse(n))
        return self

    def __exit__(self, *exc):
        for n, m in self.saved.items():
            setattr(torch.Tensor, n, m)
        return False


def _dlsim_system():
    """A seeded stable 8-state, 4-input, 2-output continuous system,
    discretized by zero-order hold at dt = 0.01."""
    nst, nin, nout = DLSIM_SYSTEM
    rng = np.random.default_rng(25)
    A = rng.standard_normal((nst, nst))
    A -= (np.max(np.real(np.linalg.eigvals(A))) + 0.5) * np.eye(nst)
    return tpufft_torch.cont2discrete(
        (A, rng.standard_normal((nst, nin)), rng.standard_normal((nout, nst)),
         rng.standard_normal((nout, nin))), 0.01)


def _wave_grid() -> torch.Tensor:
    """(64, 1048576) f32 times: row r holds r / 100 + k / 1048576, so every
    phase below stays under 2 pi 100 (f32 keeps it to ~4e-5 rad)."""
    rows, n = WAVE_SHAPE
    t = (torch.arange(n, dtype=torch.float64, device="cuda") / n)[None] + \
        torch.arange(rows, dtype=torch.float64, device="cuda")[:, None] / 100
    return t.float()


def phase_design_paths(rate: float) -> dict:
    """freqz's three FFT routes, dlsim's scan and the waveforms once at full
    size with every count set to 0 just before each call and read just
    after, against scipy in float64, then timed (median of 5) with their
    peak memory; returns the launches per kernel."""
    total = dict.fromkeys(ALL_KERNELS, 0)
    fir = tpufft_torch.firwin(101, 0.2)
    row = torch.as_tensor(fir, dtype=torch.float32, device="cuda")
    bank = _device_planes(FREQZ_BANK, seed=71)[0]
    long = _device_planes((FREQZ_LONG,), seed=72)[0]
    bank_h = bank[:, :4].double().cpu().numpy()
    long_h = long.double().cpu().numpy()
    system = _dlsim_system()
    u = _device_planes(DLSIM_SHAPE, seed=73)[0]
    x0 = np.linspace(-1.0, 1.0, DLSIM_SYSTEM[0])
    u_h = u.double().cpu().numpy()
    t = _wave_grid()
    t_h = t[:4].double().cpu().numpy()
    wave_phase = 2 * math.pi * 100
    wave_tol = 8 * np.finfo(np.float32).eps * wave_phase + 1e-6

    def freqz_bank_f64():
        return np.stack([scipy.signal.freqz(bank_h[:, j], worN=1024)[1]
                         for j in range(4)], 1)

    def gauss(tt):
        return tpufft_torch.gausspulse(tt - 0.3, fc=50.0, retquad=True,
                                       retenv=True)

    def gauss_f64():
        return np.stack(scipy.signal.gausspulse(t_h - 0.3, fc=50.0,
                                                retquad=True, retenv=True))

    n_wave = math.prod(WAVE_SHAPE)
    # name, call, the kernels it must launch, the result's part to compare,
    # scipy in float64 on that part, the tolerance, bytes read and written
    paths = (
        ("freqz firwin(101) worN=2048", lambda: tpufft_torch.freqz(
            row, worN=2048)[1], {"minor_padded"}, lambda h: h,
         lambda: scipy.signal.freqz(fir, worN=2048)[1], FREQZ_TOL,
         4 * 101 + 8 * 2048),
        (f"freqz bank {FREQZ_BANK} worN=1024", lambda: tpufft_torch.freqz(
            bank, worN=1024)[1], {"inner"}, lambda h: h[:, :4],
         freqz_bank_f64, FREQZ_TOL,
         4 * math.prod(FREQZ_BANK) + 8 * 1024 * FREQZ_BANK[1]),
        (f"freqz ({FREQZ_LONG},) worN=2**20", lambda: tpufft_torch.freqz(
            long, worN=2 ** 20)[1], {"inner_nd", "inner"}, lambda h: h,
         lambda: scipy.signal.freqz(long_h, worN=2 ** 20)[1], FREQZ_TOL,
         4 * FREQZ_LONG + 8 * 2 ** 20),
        (f"dlsim {DLSIM_SYSTEM} u {DLSIM_SHAPE}",
         lambda: tpufft_torch.dlsim(system, u, x0=x0), set(),
         lambda out: torch.cat([out[1], out[2]], 1),
         lambda: np.concatenate(scipy.signal.dlsim(system, u_h, x0=x0)[1:],
                                1), DLSIM_TOL,
         4 * math.prod(DLSIM_SHAPE) + 4 * DLSIM_SHAPE[0] * (
             DLSIM_SYSTEM[0] + DLSIM_SYSTEM[2])),
        ("chirp linear", lambda: tpufft_torch.chirp(t, 5.0, 1.0, 20.0),
         set(), lambda y: y[:4],
         lambda: scipy.signal.chirp(t_h, 5.0, 1.0, 20.0), wave_tol,
         8 * n_wave),
        ("chirp logarithmic", lambda: tpufft_torch.chirp(
            t, 5.0, 1.0, 20.0, "logarithmic"), set(), lambda y: y[:4],
         lambda: scipy.signal.chirp(t_h, 5.0, 1.0, 20.0, "logarithmic"),
         wave_tol, 8 * n_wave),
        ("chirp complex", lambda: tpufft_torch.chirp(
            t, 5.0, 1.0, 20.0, complex=True), set(), lambda y: y[:4],
         lambda: scipy.signal.chirp(t_h, 5.0, 1.0, 20.0, complex=True),
         wave_tol, 12 * n_wave),
        ("sweep_poly", lambda: tpufft_torch.sweep_poly(t, [6.0, -2.0, 5.0]),
         set(), lambda y: y[:4],
         lambda: scipy.signal.sweep_poly(t_h, [6.0, -2.0, 5.0]), wave_tol,
         8 * n_wave),
        ("gausspulse retquad retenv", lambda: gauss(t), set(),
         lambda y: torch.stack(y)[:, :4], gauss_f64, wave_tol, 16 * n_wave),
        ("sawtooth width 0.3", lambda: tpufft_torch.sawtooth(
            2 * math.pi * 60 * t, 0.3), set(), lambda y: y[:4],
         lambda: scipy.signal.sawtooth(2 * math.pi * 60 * t_h, 0.3),
         wave_tol, 8 * n_wave),
        ("square duty 0.2", lambda: tpufft_torch.square(
            2 * math.pi * 60 * t, 0.2), set(), lambda y: y[:4],
         lambda: scipy.signal.square(2 * math.pi * 60 * t_h, 0.2), None,
         8 * n_wave),
    )
    for name, fn, kernels, part, ref, tol, nbytes in paths:
        torch.cuda.synchronize()
        reset_counts()
        with _NoHostCopies():
            out = fn()
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        check(plain == 0, f"{name}: plain versions ran {plain} times on "
              "CUDA tensors")
        launched = {k: v for k, v in by_kernel.items() if v}
        check(set(launched) == kernels, f"{name}: kernel launches "
              f"{launched}, expected {sorted(kernels)}")
        for k, v in by_kernel.items():
            total[k] += v
        res = part(out)
        check(res.is_cuda and res.dtype in (torch.float32, torch.complex64)
              and bool(torch.isfinite(res).all()),
              f"{name}: output {res.dtype} on {res.device}")
        got = _host(res, res.shape[0])
        want = ref()
        if tol is None:
            # a square wave flips where f32 and f64 disagree on which side
            # of an edge a sample lies: count those samples
            err = float(np.mean(got != want))
            check(set(np.unique(got)) <= {-1.0, 1.0} and err < 1e-3,
                  f"{name}: {err:.3e} of the samples differ from scipy")
            what = f"share differing from scipy f64 {err:.3e}"
        else:
            err = _rel(got, want)
            check(err < tol, f"{name}: vs scipy in f64 {err:.3e} (limit "
                  f"{tol:.1e})")
            what = f"vs scipy f64 {err:.3e} (limit {tol:.1e})"
        shape = tuple(res.shape)
        del out, res
        ms, peak = _time_peak(fn)
        print(f"path {name} -> {shape}: {what}, launches {launched}, "
              f"plain-version CUDA calls {plain}, host copies 0; median of "
              f"{MULTIRATE_REPS} {ms:.3f} ms, peak {peak:.3f} GB above the "
              f"inputs, byte floor {nbytes / rate * 1e3:.4f} ms")
    del row, bank, long, u, t
    print(f"design/ltisys/waveform paths, launches "
          f"{ {k: v for k, v in total.items() if v} }, plain-version CUDA "
          "calls 0")
    return total


# ----------------------------------------------------------------------------
# Phase 26: peak finding and the B-spline filters
# ----------------------------------------------------------------------------

PEAK_N = 1 << 24            # samples of find_peaks' spectrum
PEAK_LINES = 20000          # Gaussian lines in PEAK_N samples
PEAK_QUANTUM = 2.0 ** -10   # find_peaks' spectrum is rounded to it
PEAK_TOL = 1e-12            # find_peaks' properties vs scipy, of their size
FIND_PEAKS_KW = dict(height=(0.2, 1.5), threshold=(0.0, 0.05), distance=25,
                     prominence=(0.02, None), width=(2.0, 200.0), wlen=1001,
                     plateau_size=(1, 4))
ARGREL_SHAPE = (64, 1_048_576)
CWT_N = 131_072
CWT_WIDTHS = np.arange(1, 33)
SPLINE_N = 1 << 24
EVAL_POINTS = 4_194_304
SPLINE_IMAGE = (4096, 4096)
SEPFIR_ROWS = np.array([-0.05, 0.1, 0.25, 0.4, 0.25, 0.1, -0.05])
SEPFIR_COLS = np.array([0.1, 0.2, 0.4, 0.2, 0.1])
Z1_CUBIC = -2 + math.sqrt(3)   # the cubic spline's own pole
SPLINE_TOL = 1e-5          # f32 solves vs scipy in f64, of the output's size
SPLINE_FILTER_TOL = 1e-3   # spline_filter(3.0)'s interior, as tpufft's test
SPLINE_EDGE = 64           # samples that carry scipy's truncated startup
# the float64 smoothing solve's residual (spline_filter at 5.0): the f32
# result's own rounding times the 2-D operator's norm (~80^2) is ~4e-5 of
# the image, so the defining equations are held on the float64 solve
SPLINE_F64_TOL = 1e-9


def _spectrum(n: int, seed: int, quantum: float | None = None):
    """(n,) f32 on the card: PEAK_LINES lines a PEAK_N samples, Gaussians
    of standard deviation 3-30 samples and height 0.05-1, on the baseline
    0.3 + 0.2 sin(6 pi k / n), with white noise of 0.01; rounded to
    multiples of ``quantum`` when given (plateaus, equal heights)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    f64 = dict(generator=g, device="cuda", dtype=torch.float64)
    lines = max(1, PEAK_LINES * n // PEAK_N)
    k = torch.arange(n, device="cuda", dtype=torch.float64)
    x = 0.3 + 0.2 * torch.sin(6 * math.pi * k / n) + 0.01 * torch.randn(
        n, **f64)
    pos = torch.rand(lines, **f64) * n
    height = 0.05 + 0.95 * torch.rand(lines, **f64)
    sd = 3 + 27 * torch.rand(lines, **f64)
    idx = pos.long()[:, None] + torch.arange(-150, 151, device="cuda")
    val = height[:, None] * torch.exp(
        -0.5 * ((idx - pos[:, None]) / sd[:, None]) ** 2)
    inside = (idx >= 0) & (idx < n)
    x.index_add_(0, idx[inside], val[inside])
    if quantum is not None:
        x = torch.round(x / quantum) * quantum
    return x.float()


def _folded(c: np.ndarray, taps: dict, axis: int = -1) -> np.ndarray:
    """The taps applied to c along ``axis`` with the half-sample mirror
    (what a prefilter's solve inverts), in float64 on the host."""
    n = c.shape[axis]
    k = np.arange(n)
    out = np.zeros_like(c)
    for d, v in taps.items():
        j = k + d
        j = np.where(j < 0, -j - 1, j)
        j = np.where(j > n - 1, 2 * n - 1 - j, j)
        out += v * np.take(c, j, axis=axis)
    return out


def _device_us(event) -> float:
    """A kernel event's device time, microseconds (``device_time`` in
    recent PyTorch, ``cuda_time`` before it)."""
    for attr in ("device_time", "cuda_time"):
        value = getattr(event, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def _profiled(fn) -> dict:
    """One call of fn under torch.profiler (CPU and CUDA activities),
    synchronized at both ends: its device kernels' count and summed time,
    the wall time on the host clock, the torch ops' summed self CPU time
    and the device time by kernel name (ms)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + _device_us(e) / 1e3
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU]
    return {"kernels": len(kernels), "device_ms": sum(by_name.values()),
            "wall_ms": wall,
            "op_cpu_ms": sum(e.self_cpu_time_total for e in ops) / 1e3,
            "by_name": by_name}


def _cuda_kernels(fn) -> list:
    """The CUDA kernels one call of fn ran, as (name, device ms), under
    torch.profiler with the CUDA activity alone, in this process. After an
    earlier profiler session in the same process it listed none of the
    ctypes wrappers' launches, so a check of them runs in a fresh process
    (``_fresh_fft_kernels``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, _device_us(e) / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _fresh_fft_kernels(shapes) -> dict:
    """{shape: [(name, device ms), ...]}: the CUDA kernels that one
    ``tpufft_torch.fft`` of each (rows, n) shape runs, profiled by
    tools/kernel_profile.py in a process of its own (its first profiler
    session); the process is stopped if it outlives RANK_TIMEOUT."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=root, OMP_NUM_THREADS="2")
    try:
        done = subprocess.run(
            [sys.executable, os.path.join(root, "tools", "kernel_profile.py"),
             *(f"{r},{n}" for r, n in shapes)], cwd=root, env=env,
            capture_output=True, text=True, timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        check(False, f"tools/kernel_profile.py ran out of its "
              f"{RANK_TIMEOUT} s")
    check(done.returncode == 0, f"tools/kernel_profile.py exited "
          f"{done.returncode}:\n{done.stderr[-3000:]}")
    out = {}
    for line in done.stdout.splitlines():
        row = json.loads(line)
        out[tuple(row["shape"])] = [tuple(k) for k in row["kernels"]]
    check(set(out) == set(shapes), f"tools/kernel_profile.py: shapes "
          f"{sorted(out)}, expected {sorted(shapes)}")
    return out


def _on_card(value) -> bool:
    if isinstance(value, dict):
        return all(_on_card(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return all(_on_card(v) for v in value)
    return isinstance(value, torch.Tensor) and value.is_cuda


def _hold_peaks(got, ref) -> str:
    """find_peaks' result against scipy's: indices equal, the same
    properties, each within PEAK_TOL of its size."""
    (peaks, props), (ref_peaks, ref_props) = got, ref
    check(np.array_equal(peaks.cpu().numpy(), ref_peaks),
          f"peaks: {peaks.numel()} against scipy's {ref_peaks.size}")
    check(set(props) == set(ref_props),
          f"properties {sorted(props)} against {sorted(ref_props)}")
    worst = 0.0
    for key, want in ref_props.items():
        have = props[key].cpu().numpy()
        check(have.shape == want.shape, f"{key}: shape {have.shape}")
        if want.size:
            worst = max(worst, float(np.max(np.abs(have - want))) / max(
                1.0, float(np.max(np.abs(want)))))
    check(worst <= PEAK_TOL, f"properties vs scipy {worst:.3e}")
    return (f"{ref_peaks.size} peaks equal to scipy's, {len(ref_props)} "
            f"properties within {worst:.1e} (limit {PEAK_TOL:.0e})")


def _hold_indices(got, ref) -> str:
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    check(len(got) == len(ref) and all(
        np.array_equal(g.cpu().numpy(), np.asarray(r))
        for g, r in zip(got, ref)), "indices differ from scipy's")
    return f"{np.asarray(ref[0]).size} indices equal to scipy's"


def _hold_close(got: torch.Tensor, ref: np.ndarray, tol: float,
                cut=slice(None), what: str = "scipy f64") -> str:
    err = _rel(got.double().cpu().numpy()[cut], ref[cut])
    check(err <= tol, f"vs {what} {err:.3e} (limit {tol:.0e})")
    return f"vs {what} {err:.3e} (limit {tol:.0e})"


def _hold_residual(coeffs: torch.Tensor, taps: dict, x: np.ndarray,
                   axes=(-1,), tol: float = SPLINE_TOL) -> str:
    """The folded taps applied to the coefficients along ``axes`` give x
    back, within ``tol`` of x's size."""
    out = coeffs.double().cpu().numpy()
    for axis in axes:
        out = _folded(out, taps, axis)
    err = _rel(out, x)
    check(err <= tol, f"residual {err:.3e} (limit {tol:.0e})")
    return f"residual {err:.3e} (limit {tol:.0e})"


def _peak_spline_inputs() -> dict:
    """Phase 26's inputs, made on the card from seeds."""
    from tpufft_torch import bsplines

    sig = _device_planes((SPLINE_N,), seed=84)[0]
    return {"spec": _spectrum(PEAK_N, 81, PEAK_QUANTUM),
            "grid": _device_planes(ARGREL_SHAPE, seed=82)[0],
            "line": _spectrum(CWT_N, 83), "sig": sig,
            "coeffs": bsplines.cspline1d(sig),
            "newx": torch.linspace(-SPLINE_N / 2, 1.5 * SPLINE_N,
                                   EVAL_POINTS, device="cuda",
                                   dtype=torch.float64),
            "img": _device_planes(SPLINE_IMAGE, seed=85)[0]}


def _peak_spline_calls(inp: dict) -> dict:
    """Phase 26's calls on ``inp``, by name."""
    t = tpufft_torch
    spec, grid, line, sig, img = (inp[k] for k in ("spec", "grid", "line",
                                                   "sig", "img"))
    return {
        "find_peaks, seven conditions": lambda: t.find_peaks(
            spec, **FIND_PEAKS_KW),
        "find_peaks prominence=0.02": lambda: t.find_peaks(
            spec, prominence=0.02),
        f"argrelmax {ARGREL_SHAPE} axis=1 order=5": lambda: t.argrelmax(
            grid, axis=1, order=5),
        f"argrelmin {ARGREL_SHAPE} axis=1 order=5 wrap": lambda: t.argrelmin(
            grid, axis=1, order=5, mode="wrap"),
        f"find_peaks_cwt ({CWT_N},) widths 1..32": lambda: t.find_peaks_cwt(
            line, CWT_WIDTHS),
        "cspline1d": lambda: t.cspline1d(sig),
        "qspline1d": lambda: t.qspline1d(sig),
        "symiirorder1 c0=1 z1=-2+sqrt(3)": lambda: t.symiirorder1(
            sig, 1.0, Z1_CUBIC),
        "cspline1d lamb=2.5": lambda: t.cspline1d(sig, 2.5),
        "symiirorder2 r=0.5 omega=pi/4": lambda: t.symiirorder2(
            sig, 0.5, math.pi / 4),
        f"cspline1d_eval {EVAL_POINTS} points over [-N/2, 3N/2]":
            lambda: t.cspline1d_eval(inp["coeffs"], inp["newx"]),
        f"cspline2d {SPLINE_IMAGE}": lambda: t.cspline2d(img),
        f"qspline2d {SPLINE_IMAGE}": lambda: t.qspline2d(img),
        "sepfir2d 7-tap rows, 5-tap columns": lambda: t.sepfir2d(
            img, SEPFIR_ROWS, SEPFIR_COLS),
        "spline_filter lmbda=3": lambda: t.spline_filter(img, 3.0),
        "spline_filter lmbda=5": lambda: t.spline_filter(img, 5.0),
    }


def phase_peaks_spline_paths(rate: float) -> dict:
    """find_peaks, argrel*, find_peaks_cwt and the B-spline filters once at
    full size with every count set to 0 just before each call and read
    just after, against scipy in float64 (or the defining equations), each
    profiled once and timed (median of 5) with its peak memory; returns
    the launches per kernel."""
    from tpufft_torch import bsplines, peaks

    card = _smi("name,power.limit")
    total = dict.fromkeys(ALL_KERNELS, 0)
    inp = _peak_spline_inputs()
    calls = _peak_spline_calls(inp)
    spec_h = inp["spec"].double().cpu().numpy()
    grid_h = inp["grid"].cpu().numpy()
    line_h = inp["line"].double().cpu().numpy()
    sig_h = inp["sig"].double().cpu().numpy()
    img_h = inp["img"].double().cpu().numpy()
    smooth5 = bsplines.cspline2d(inp["img"].double(), 5.0)
    b3 = np.array([1.0, 4.0, 1.0]) / 6.0
    n_spec, n_sig, n_img = 4 * PEAK_N, 4 * SPLINE_N, 4 * math.prod(
        SPLINE_IMAGE)
    edges = slice(SPLINE_EDGE, -SPLINE_EDGE)

    def smooth_1d(out, ref, taps):
        return _hold_close(out, ref, SPLINE_TOL, edges) + ", " + \
            _hold_residual(out, taps, sig_h)

    # name, host copies allowed, the check of its result (a line of text),
    # bytes read and written once
    paths = (
        ("find_peaks, seven conditions", 1, lambda out: _hold_peaks(
            out, scipy.signal.find_peaks(spec_h, **FIND_PEAKS_KW)), n_spec),
        ("find_peaks prominence=0.02", 0, lambda out: _hold_peaks(
            out, scipy.signal.find_peaks(spec_h, prominence=0.02)), n_spec),
        (f"argrelmax {ARGREL_SHAPE} axis=1 order=5", 0,
         lambda out: _hold_indices(out, scipy.signal.argrelmax(
             grid_h, axis=1, order=5)), 4 * math.prod(ARGREL_SHAPE)),
        (f"argrelmin {ARGREL_SHAPE} axis=1 order=5 wrap", 0,
         lambda out: _hold_indices(out, scipy.signal.argrelmin(
             grid_h, axis=1, order=5, mode="wrap")),
         4 * math.prod(ARGREL_SHAPE)),
        (f"find_peaks_cwt ({CWT_N},) widths 1..32", 1,
         lambda out: _hold_indices(out, scipy.signal.find_peaks_cwt(
             line_h, CWT_WIDTHS)), 4 * CWT_N),
        ("cspline1d", 0, lambda out: _hold_close(
            out, scipy.signal.cspline1d(sig_h), SPLINE_TOL), 2 * n_sig),
        ("qspline1d", 0, lambda out: _hold_close(
            out, scipy.signal.qspline1d(sig_h), SPLINE_TOL), 2 * n_sig),
        ("symiirorder1 c0=1 z1=-2+sqrt(3)", 0, lambda out: _hold_close(
            out, scipy.signal.symiirorder1(sig_h, 1.0, Z1_CUBIC),
            SPLINE_TOL), 2 * n_sig),
        ("cspline1d lamb=2.5", 0, lambda out: smooth_1d(
            out, scipy.signal.cspline1d(sig_h, 2.5),
            bsplines._spline_taps("cubic", 2.5)), 2 * n_sig),
        ("symiirorder2 r=0.5 omega=pi/4", 0, lambda out: smooth_1d(
            out, scipy.signal.symiirorder2(sig_h, 0.5, math.pi / 4),
            bsplines._order2_taps(0.5, math.pi / 4)), 2 * n_sig),
        (f"cspline1d_eval {EVAL_POINTS} points over [-N/2, 3N/2]", 0,
         lambda out: _hold_close(out, scipy.signal.cspline1d_eval(
             inp["coeffs"].double().cpu().numpy(),
             inp["newx"].cpu().numpy()), SPLINE_TOL),
         4 * SPLINE_N + 12 * EVAL_POINTS),
        (f"cspline2d {SPLINE_IMAGE}", 0, lambda out: _hold_close(
            out, scipy.signal.cspline2d(img_h), SPLINE_TOL), 2 * n_img),
        (f"qspline2d {SPLINE_IMAGE}", 0, lambda out: _hold_close(
            out, scipy.signal.qspline2d(img_h), SPLINE_TOL), 2 * n_img),
        ("sepfir2d 7-tap rows, 5-tap columns", 0, lambda out: _hold_close(
            out, scipy.signal.sepfir2d(img_h, SEPFIR_ROWS, SEPFIR_COLS),
            SPLINE_TOL), 2 * n_img),
        ("spline_filter lmbda=3", 0, lambda out: _hold_close(
            out, scipy.signal.spline_filter(img_h, 3.0), SPLINE_FILTER_TOL,
            (slice(4, -4), slice(4, -4))), 2 * n_img),
        ("spline_filter lmbda=5", 0, lambda out: "f64 solve "
         + _hold_residual(smooth5, bsplines._spline_taps("cubic", 5.0),
                          img_h, (0, 1), SPLINE_F64_TOL) + ", "
         + _hold_close(out, scipy.signal.sepfir2d(
             smooth5.cpu().numpy(), b3, b3), SPLINE_TOL,
             what="scipy's sepfir2d of the f64 solve"), 2 * n_img),
    )
    check([p[0] for p in paths] == list(calls), "phase 26's paths")
    for name, allow, hold, nbytes in paths:
        fn = calls[name]
        torch.cuda.synchronize()
        reset_counts()
        guard = _NoHostCopies(allow)
        with guard:
            out = fn()
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        check(plain == 0, f"{name}: plain versions ran {plain} times on "
              "CUDA tensors")
        launched = {k: v for k, v in by_kernel.items() if v}
        check(not launched, f"{name}: kernel launches {launched}")
        check(_on_card(out), f"{name}: a result left the card")
        rounds = peaks.distance_rounds
        t0 = time.perf_counter()
        held = hold(out)
        check_s = time.perf_counter() - t0
        del out
        ms, peak = _time_peak(fn)
        prof = _profiled(fn)
        idle = 1 - prof["device_ms"] / prof["wall_ms"]
        print(f"path {name}: {held} (check {check_s:.1f} s); launches "
              f"{launched}, plain-version CUDA calls {plain}, host copies "
              f"{guard.copies} ({guard.nbytes} B); median of "
              f"{MULTIRATE_REPS} {ms:.3f} ms, peak {peak:.3f} GB above the "
              f"inputs, byte floor {nbytes / rate * 1e3:.4f} ms; profiled "
              f"call {prof['kernels']} torch kernels, device "
              f"{prof['device_ms']:.3f} of {prof['wall_ms']:.3f} ms, idle "
              f"share {idle:.3f}; {card}")
        if name.startswith("find_peaks, seven"):
            print(f"  distance=25 thinning: {rounds} rounds")
    rows = peaks._cwt(inp["line"].double(), peaks._ricker, CWT_WIDTHS)
    maxima = torch.nonzero(peaks._extrema_mask(rows, torch.gt, 1, 1,
                                               "clip")).cpu().numpy()
    walk_ms = _host_ms(lambda: peaks._ridge_lines(
        maxima, len(CWT_WIDTHS), CWT_WIDTHS / 4.0, np.ceil(CWT_WIDTHS[0])))
    print(f"  find_peaks_cwt: {maxima.shape[0]} maxima, their coordinates "
          f"{maxima.nbytes} B to the host, host ridge walk {walk_ms:.3f} ms "
          f"(median of {REPS}); {card}")
    del inp, calls, smooth5, rows
    print(f"peak and spline paths, launches "
          f"{ {k: v for k, v in total.items() if v} }, plain-version CUDA "
          "calls 0")
    return total


# ----------------------------------------------------------------------------
# Phase 27: the scipy backend, the native host engine and the sharded
# four-step
# ----------------------------------------------------------------------------

BACKEND_SHAPE = (100_000, 1024)
NATIVE_SHAPES = ((100_000, 1024), (1_000_000, 93))
NATIVE_ND = (16, 256, 256)
C64_TOL, C128_TOL = 1e-3, 1e-6   # assert_spectrum_close's rule
RANK_TIMEOUT = 600
DIST_WORLD = 4
# the kernels each rank's paths must launch (chip_smoke's counter names)
D1_KERNELS = ("inner_nd", "inner")      # the two-pass split at 2**24
D4_KERNELS = {"fft_distributed": ("inner", "minor"),
              "filter_distributed": ("inner", "minor"),
              "rfft_distributed": ("inner", "minor"),
              "irfft_distributed": ("inner", "minor"),
              "permuted_out": ("inner", "minor"),
              "permuted_in": ("inner", "minor"),
              "gather_fallback": ("inner_nd", "inner"),
              "fftn_distributed": ("inner", "minor"),
              "fft_batch_sharded": ("inner", "minor")}
# calls of parallel._a2a per call (the module's contract)
D4_EXCHANGES = {"fft_distributed": 3, "filter_distributed": 4,
                "rfft_distributed": 4, "irfft_distributed": 4,
                "permuted_out": 2, "permuted_in": 2, "gather_fallback": 0,
                "fftn_distributed": 3, "fft_batch_sharded": 0}


def _host_cpu() -> str:
    """The host CPU's model name from /proc/cpuinfo, else its vendor,
    family and model numbers."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields.setdefault(key.strip(), value.strip())
    name = fields.get("model name", "")
    if name and name != "unknown":
        return name
    return (f"{fields.get('vendor_id', 'unknown vendor')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')}"
            f" (model name {name or 'absent'})")


def _wall_ms(fn) -> float:
    """Median of MULTIRATE_REPS host-clock times (the caller has run fn
    once already, as its check)."""
    times = []
    for _ in range(MULTIRATE_REPS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _run_ranks(world: int, backend: str, tmp: str) -> list[dict]:
    """Start ``world`` processes of tools/chip_ranks.py on cuda:0 and wait
    for them (RANK_TIMEOUT from their start); a rank that fails or runs out
    of time fails the phase, and every process is stopped."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, f"{backend}{world}")
    os.makedirs(out)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=root, LOCAL_RANK="0", OMP_NUM_THREADS="2")
    logs = [os.path.join(out, f"rank{r}.log") for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(root, "tools", "chip_ranks.py"),
                 str(r), str(world), backend, os.path.join(out, "store"),
                 out], cwd=root, env=env, stdout=subprocess.DEVNULL,
                stderr=f))
    failed = []
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {r} ran out of its {RANK_TIMEOUT} s")
                break
            if p.returncode != 0:
                with open(logs[r]) as f:
                    failed.append(f"rank {r} exited {p.returncode}:\n"
                                  f"{f.read()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(not failed, f"{backend} world of {world}: " + "\n".join(failed))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
            for r in range(world)]


def _backend_calls(xc: np.ndarray, xr: np.ndarray, xt: torch.Tensor):
    """Phase 27's scipy.fft calls under ``scipy_backend()``: name, call,
    the kernel it must launch, bytes read and written once."""
    backend = tpufft_torch.scipy_backend()

    def under(f):
        def run():
            with scipy.fft.set_backend(backend):
                return f()
        return run

    return (
        (f"scipy.fft.fft numpy c64 {BACKEND_SHAPE} workers=2",
         under(lambda: scipy.fft.fft(xc, workers=2)), "minor",
         2 * xc.nbytes),
        (f"scipy.fft.rfft numpy f32 {BACKEND_SHAPE}",
         under(lambda: scipy.fft.rfft(xr)), "r2c",
         xr.nbytes + 8 * xr.shape[0] * (xr.shape[1] // 2 + 1)),
        (f"scipy.fft.dct type=2 numpy f32 {BACKEND_SHAPE}",
         under(lambda: scipy.fft.dct(xr, type=2)), "r2r", 2 * xr.nbytes),
        (f"scipy.fft.fft CUDA c64 tensor {BACKEND_SHAPE} workers=2",
         under(lambda: scipy.fft.fft(xt, workers=2)), "minor",
         2 * xc.nbytes),
    )


def _phase27_backend(rate: float, card: str, total: dict) -> None:
    rng = np.random.default_rng(2701)
    xc = (rng.standard_normal(BACKEND_SHAPE, dtype=np.float32) + 1j
          * rng.standard_normal(BACKEND_SHAPE, dtype=np.float32)).astype(
              np.complex64)
    xr = rng.standard_normal(BACKEND_SHAPE, dtype=np.float32)
    xt = torch.from_numpy(xc).to("cuda")
    workers = os.cpu_count()
    ref_fft = scipy.fft.fft(xc.astype(np.complex128), workers=workers)
    refs = (ref_fft, scipy.fft.rfft(xr.astype(np.float64), workers=workers),
            scipy.fft.dct(xr.astype(np.float64), type=2, workers=workers),
            ref_fft)
    for (name, fn, kernel, nbytes), ref in zip(
            _backend_calls(xc, xr, xt), refs):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        launched = {k: v for k, v in by_kernel.items() if v}
        check(plain == 0, f"{name}: plain versions ran {plain} times")
        check(launched.get(kernel, 0) > 0,
              f"{name}: {kernel} never launched ({launched})")
        if name.startswith("scipy.fft.fft CUDA"):
            check(isinstance(out, torch.Tensor) and out.is_cuda,
                  f"{name}: the result left the card")
            got = out.cpu().numpy()
        else:
            check(isinstance(out, np.ndarray), f"{name}: {type(out)} out")
            got = out
        err = _rel(got, ref)
        check(err < C64_TOL, f"{name}: {err:.3e} against scipy in f64")
        for k, v in launched.items():
            total[k] += v
        del out, got
        ms, peak = _time_peak(fn)
        print(f"path {name}: vs scipy f64 {err:.3e} (limit {C64_TOL:.0e}); "
              f"launches {launched}, plain-version CUDA calls {plain}; median "
              f"of {MULTIRATE_REPS} {ms:.3f} ms (numpy paths: the copies to "
              f"and from the card included), peak {peak:.3f} GB, byte floor "
              f"{nbytes / rate * 1e3:.4f} ms; {card}")
    del xt, ref_fft, refs


def _phase27_native(card: str) -> None:
    from tpufft_torch import native

    check(native.available(), "native: the engine did not build (no g++?)")
    cpu, threads = _host_cpu(), native.num_threads()
    rng = np.random.default_rng(2702)
    workers = os.cpu_count()
    for shape in NATIVE_SHAPES:
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        fwd = scipy.fft.fft(x, workers=workers)
        inv = scipy.fft.ifft(x, workers=workers)
        for dt, tol in ((np.complex64, C64_TOL), (np.complex128, C128_TOL)):
            xd = x.astype(dt)
            kw = {"dtype": np.float32 if dt == np.complex64 else np.float64}
            for name, fn, ref in (("fft", native.fft, fwd),
                                  ("ifft", native.ifft, inv)):
                reset_counts()
                got = fn(xd, **kw)
                check(not any(counts()[0].values()), "native launched")
                err = _rel(got, ref)
                check(err < tol, f"native.{name} {shape} {np.dtype(dt)}: "
                      f"{err:.3e}")
                ms = _wall_ms(lambda: fn(xd, **kw))
                print(f"path native.{name} {shape} {np.dtype(dt).name}: vs "
                      f"scipy f64 {err:.3e} (limit {tol:.0e}); no launch; "
                      f"median of {MULTIRATE_REPS} {ms:.3f} ms on the host "
                      f"({cpu}, {threads} threads)")
    x = (rng.standard_normal(NATIVE_ND) + 1j * rng.standard_normal(
        NATIVE_ND)).astype(np.complex64)
    got = native.fftn(x)
    err = _rel(got, scipy.fft.fftn(x.astype(np.complex128), axes=(1, 2),
                                   workers=workers))
    check(err < C64_TOL, f"native.fftn {NATIVE_ND}: {err:.3e}")
    ms = _wall_ms(lambda: native.fftn(x))
    print(f"path native.fftn {NATIVE_ND} complex64: vs scipy f64 {err:.3e} "
          f"(limit {C64_TOL:.0e}); no launch; median of {MULTIRATE_REPS} "
          f"{ms:.3f} ms on the host ({cpu}, {threads} threads)")
    try:
        native.fft(torch.zeros((4, 64), dtype=torch.complex64, device="cuda"))
    except ValueError as e:
        print(f"native.fft of a CUDA tensor: ValueError ({e})")
    else:
        check(False, "native.fft took a CUDA tensor")


def _chip_ranks():
    """tools/chip_ranks.py, the ranks' module (its inputs and sizes)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import chip_ranks
    return chip_ranks


def _phase27_refs(device: torch.device) -> dict:
    """The global inputs of tools/chip_ranks.py on the host in complex128,
    and each path's reference from scipy in float64."""
    chip_ranks = _chip_ranks()
    g = chip_ranks.global_inputs(device)
    host = {k: (re.double().cpu().numpy() + 1j * im.double().cpu().numpy())
            for k, (re, im) in g.items()}
    del g
    w = os.cpu_count()
    x = host["x"]
    X = scipy.fft.fft(x, workers=w)
    A, B = parallel.split_n(chip_ranks.N, DIST_WORLD)
    H = chip_ranks.response()
    return {
        "fft_distributed": X,
        "filter_distributed": scipy.fft.ifft(X * H, workers=w),
        "rfft_distributed": scipy.fft.rfft(x.real, workers=w),
        "irfft_distributed": x.real,
        "permuted_out": X.reshape(chip_ranks.ROWS, B, A).swapaxes(
            1, 2).reshape(chip_ranks.ROWS, chip_ranks.N),
        "permuted_in": x,
        "gather_fallback": scipy.fft.fft(host["gather"], workers=w),
        "fftn_distributed": scipy.fft.fft2(host["fftn"], axes=(1, 2),
                                           workers=w),
        "fft_batch_sharded": scipy.fft.fft2(host["batch"], axes=(1, 2),
                                            workers=w),
    }


def _phase27_bytes(name: str) -> float:
    """Bytes a path reads and writes once, over all ranks."""
    chip_ranks = _chip_ranks()
    rows, n = chip_ranks.ROWS, chip_ranks.N
    c64 = 8 * rows * n
    half = 8 * rows * (n // 2 + 1)
    return {"fft_distributed": 2 * c64, "filter_distributed": 2 * c64,
            "rfft_distributed": c64 / 2 + half,
            "irfft_distributed": half + c64 / 2,
            "permuted_out": 2 * c64, "permuted_in": 2 * c64,
            "gather_fallback": 16 * rows * chip_ranks.GATHER_N,
            "fftn_distributed": 16 * math.prod(chip_ranks.FFTN_SHAPE),
            "fft_batch_sharded": 16 * math.prod(chip_ranks.BATCH_SHAPE)}[name]


def _phase27_world(ranks: list[dict], refs: dict, rate: float, card: str,
                   total: dict, label: str) -> None:
    """Assemble each path's blocks, hold them against the reference, and
    check every rank's launches, exchanges and placement."""
    world = len(ranks)
    on_cpu = ranks[0]["route"]["device"] == "cpu"
    axes = {"fftn_distributed": 2, "fft_batch_sharded": 0}
    for name in ranks[0]["results"]:
        res = [rk["results"][name] for rk in ranks]
        got = torch.cat([r["out"] for r in res],
                        dim=axes.get(name, -1)).numpy()
        ref = refs[name]
        check(got.shape == ref.shape, f"{label} {name}: {got.shape}")
        err = _rel(got, ref)
        check(err < C64_TOL, f"{label} {name}: {err:.3e} against scipy f64")
        want = D1_KERNELS if world == 1 else D4_KERNELS[name]
        exchanges = 0 if world == 1 else D4_EXCHANGES[name]
        for r, rr in enumerate(res):
            check(rr["plain"] == 0, f"{label} {name} rank {r}: plain "
                  f"versions ran {rr['plain']} times")
            check(rr["a2a"] == exchanges, f"{label} {name} rank {r}: "
                  f"{rr['a2a']} exchanges, the contract is {exchanges}")
            if not on_cpu:
                check(rr["on_card"], f"{label} {name} rank {r}: a result "
                      "left the card")
                check(all(rr["launches"].get(k, 0) > 0 for k in want),
                      f"{label} {name} rank {r}: {rr['launches']}, needs "
                      f"{want}")
            for k, v in rr["launches"].items():
                total[k] += v
        ms = max(rr["ms"] for rr in res)
        peak = max(rr["peak_gb"] for rr in res)
        floor = _phase27_bytes(name) / world / rate * 1e3
        print(f"path {label} {name}: vs scipy f64 {err:.3e} (limit "
              f"{C64_TOL:.0e}); per rank: launches {res[0]['launches']}, "
              f"plain-version CUDA calls 0, exchanges {res[0]['a2a']}, "
              f"all-gathers {res[0]['gather']}; slowest rank's median of 5 "
              f"{ms:.3f} ms, peak {peak:.3f} GB, one rank's byte floor "
              f"{floor:.4f} ms; {card}")
        for r, rr in enumerate(res):
            rest = rr["instrumented_ms"] - rr["fft_ms"] - rr["exchange_ms"]
            print(f"  rank {r}: instrumented call {rr['instrumented_ms']:.3f}"
                  f" ms = local FFTs {rr['fft_ms']:.3f} + exchanges "
                  f"{rr['exchange_ms']:.3f} + the rest {rest:.3f}")


def phase_native_parallel_paths(rate: float) -> dict:
    """The scipy.fft backend, the native host engine and the sharded
    four-step at full size: every call driven with every count set to 0
    just before it and read just after, against scipy in float64, timed;
    returns the launches per kernel, the ranks' included."""
    import tempfile

    card = _smi("name,power.limit")
    total = dict.fromkeys(ALL_KERNELS, 0)
    t0 = time.perf_counter()
    _phase27_backend(rate, card, total)
    t1 = time.perf_counter()
    _phase27_native(card)
    t2 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        d1 = _run_ranks(1, "nccl", tmp)
        d4 = _run_ranks(DIST_WORLD, "gloo", tmp)
        t3 = time.perf_counter()
        route = d4[0]["route"]
        if route["refused"]:
            print(f"exchange route: gloo refused CUDA tensors for "
                  f"all_to_all_single ({route['refused']}); d = 4 ran on CPU "
                  "blocks in the ranks, d = 1 on the card over NCCL")
        else:
            print(f"exchange route: d = 4 over gloo on CUDA tensors, staged "
                  f"through the host, {DIST_WORLD} ranks on one GPU ({card}); "
                  "d = 1 over NCCL, one rank")
        refs = _phase27_refs(torch.device("cuda"))
        _phase27_world(d1, refs, rate, card, total, "d=1 nccl")
        if route["refused"]:
            refs = _phase27_refs(torch.device("cpu"))
        _phase27_world(d4, refs, rate, card, total,
                       f"d={DIST_WORLD} gloo")
        del d1, d4, refs
    print(f"phase 27 wall time: backend {t1 - t0:.1f} s, native "
          f"{t2 - t1:.1f} s, the ranks {t3 - t2:.1f} s, the parent's "
          f"references and checks {time.perf_counter() - t3:.1f} s")
    print(f"backend, native and parallel paths, launches "
          f"{ {k: v for k, v in total.items() if v} }, plain-version CUDA "
          "calls 0")
    return total


def _ab_line(what: str, line, stages, plain, library, nbytes: float,
             rate: float, tol: float = F32_TOL) -> dict:
    """One line form beside its stage form, its plain version, the library
    call and the copy floor of its bytes: the line form held against its
    stage form and its plain version on the same inputs (``tol``: f32
    1e-5), each timed (median of REPS), the two forms in turns line,
    stages, stages, line; returns the medians."""
    got = line()
    err = pair_err(got, stages())
    check(err < tol, f"{what}: line form vs stage form {err:.3e}")
    err_plain = pair_err(got, plain())
    check(err_plain < tol,
          f"{what}: line form vs plain version {err_plain:.3e}")
    del got
    a, b = _time_ms(line), _time_ms(stages)
    b, a = (b + _time_ms(stages)) / 2, (a + _time_ms(line)) / 2
    t = {"line": a, "stages": b, "plain": _time_ms(plain),
         "library": _time_ms(library), "floor": nbytes / rate * 1e3}
    print(f"  {what}: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
          + f" ms; line / stages {a / b:.3f}, floor / line "
          f"{t['floor'] / a:.3f}; line vs stages {err:.3e}, vs plain "
          f"{err_plain:.3e}")
    return t


def phase_mixed_times(rate: float) -> dict:
    """Phase 28: K1's mixed-radix line form at MIXED_K1_SHAPES and the
    strided one at MIXED_K2_SHAPES, each beside its stage form
    (``stages=True``), its plain version, ``torch.fft.fft`` and the copy
    floor; then the
    survey's ``fft2`` shapes (SURVEY_FFT2) as paths, each driven with every
    count set to 0 just before it and read just after, against
    ``np.fft.fft2`` on one slice and through the round trip, timed beside
    ``torch.fft.fft2`` and the floor of its two passes. Returns the paths'
    launches."""
    card = _smi("name,power.limit")
    print(f"phase 28, mixed-radix line forms [{card}], ms (median of {REPS}):")
    for rows, n in MIXED_K1_SHAPES:
        xr, xi = _device_planes((rows, n), seed=n)
        xc = torch.complex(xr, xi)
        check(minor_fft.launched_geometry(n)["form"] == "lines",
              f"K1 at {n}: the library's form is not the line form")
        _ab_line(f"K1 ({rows}, {n}) {minor_fft.line_split(n)}",
                 lambda: minor_fft.fft_minor(xr, xi, inverse=False,
                                             scale=1.0),
                 lambda: minor_fft.fft_minor(xr, xi, inverse=False,
                                             scale=1.0, stages=True),
                 lambda: minor_fft.fft_minor_reference(xr, xi, inverse=False,
                                                       scale=1.0),
                 lambda: torch.fft.fft(xc), 16.0 * rows * n, rate)
        del xr, xi, xc
    for pre, n, post in MIXED_K2_SHAPES:
        xr, xi = _device_planes((pre, n, post), seed=n)
        xc = torch.complex(xr, xi)
        check(inner_fft.form(n, post, torch.float32) == "lines",
              f"K2 at {n}: the library's form is not the line form")
        _ab_line(f"K2 {(pre, n, post)} "
                 f"{inner_fft.line_geometry(n, post, torch.float32)}",
                 lambda: inner_fft.fft_inner(xr, xi, inverse=False,
                                             scale=1.0),
                 lambda: inner_fft.fft_inner(xr, xi, inverse=False,
                                             scale=1.0, stages=True),
                 lambda: inner_fft.fft_inner_reference(xr, xi, inverse=False,
                                                       scale=1.0),
                 lambda: torch.fft.fft(xc, dim=1), 16.0 * pre * n * post,
                 rate)
        del xr, xi, xc
    total = collections.Counter()
    for shape in SURVEY_FFT2:
        xr, xi = _device_planes(shape, seed=sum(shape))
        x = tpufft_torch.SplitComplex(xr, xi)
        torch.cuda.synchronize()
        reset_counts()
        y = tpufft_torch.fft2(x)
        back = tpufft_torch.ifft2(y)
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        check(plain == 0, f"fft2 {shape}: plain versions ran {plain} times")
        check(by_kernel["minor"] == 2 and by_kernel["inner"] == 2,
              f"fft2 {shape}: launches {by_kernel}, expected K2 and K1 "
              "once a transform")
        total.update(by_kernel)
        ref = np.fft.fft2(xr[0].cpu().numpy().astype(np.float64)
                          + 1j * xi[0].cpu().numpy())
        got = y.re[0].cpu().numpy() + 1j * y.im[0].cpu().numpy()
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err < NP_TOL, f"fft2 {shape}: vs np.fft.fft2 {err:.3e}")
        rt = pair_err(back, x)
        check(rt < NP_TOL, f"fft2 {shape}: round trip {rt:.3e}")
        del y, back
        xc = torch.complex(xr, xi)
        _, n1, n2 = shape
        t = {"path": _time_ms(lambda: tpufft_torch.fft2(x)),
             "torch_fft2": _time_ms(lambda: torch.fft.fft2(xc)),
             "floor": 2 * 16.0 * xr.numel() / rate * 1e3}
        print(f"  path fft2 {shape} c64: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f" ms; K2 at {n1} "
              f"{inner_fft.form(n1, n2, torch.float32)} form, K1 at {n2} "
              f"{minor_fft.form(n2)} form; vs np.fft.fft2 {err:.3e}, round "
              f"trip {rt:.3e}, launches "
              f"{ {k: v for k, v in by_kernel.items() if v} }")
        del x, xr, xi, xc
    torch.cuda.synchronize()
    return dict(total)


def phase_mixed_real_times(rate: float) -> dict:
    """Phase 31: K7 and K8 on their mixed-radix line form at
    MIXED_REAL_SHAPES, each beside its stage form (``stages=True``, in
    turns), its plain version, ``torch.fft.rfft`` / ``irfft`` and the copy
    floor; then ``rfft`` (1000000, 93) and ``rfft2`` / ``irfft2`` (100,
    640, 480) as paths, each call driven with every count set to 0 just
    before it and read just after, against ``np.fft`` on a few rows and
    through the round trip, timed beside ``torch.fft``. Returns the paths'
    launches."""
    card = _smi("name,power.limit")
    print(f"phase 31, K7/K8 mixed-radix line form [{card}], ms (median of "
          f"{REPS}):")
    f32 = 4
    for rows, n, which in MIXED_REAL_SHAPES:
        check(real_fft.launched_geometry(n) == {
            "form": "lines", **real_fft.line_geometry(n)},
            f"K7/K8 at {n}: the library's form is not the line form")
        x, _ = _device_planes((rows, n), seed=n)
        hr, hi = real_fft.rfft_minor(x, scale=1.0)
        hc = torch.complex(hr, hi)
        nb = f32 * (rows * n + 2 * rows * (n // 2 + 1))
        geo = real_fft.line_geometry(n)
        split = (geo["n1"], geo["n2"])
        if "K7" in which:
            _ab_line(f"K7 ({rows}, {n}) {split}",
                     lambda: real_fft.rfft_minor(x, scale=1.0),
                     lambda: real_fft.rfft_minor(x, scale=1.0, stages=True),
                     lambda: real_fft.rfft_minor_reference(x, scale=1.0),
                     lambda: torch.fft.rfft(x), nb, rate)
        if "K8" in which:
            def pair(y):
                return y, y
            _ab_line(f"K8 ({rows}, {n}) {split}",
                     lambda: pair(real_fft.irfft_minor(hr, hi, n=n,
                                                       scale=1.0 / n)),
                     lambda: pair(real_fft.irfft_minor(hr, hi, n=n,
                                                       scale=1.0 / n,
                                                       stages=True)),
                     lambda: pair(real_fft.irfft_minor_reference(
                         hr, hi, n=n, scale=1.0 / n)),
                     lambda: torch.fft.irfft(hc, n=n), nb, rate)
        del x, hr, hi, hc
    total = collections.Counter()

    def driven(name, fn, arg, want):
        torch.cuda.synchronize()
        reset_counts()
        out = fn(arg)
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        check(plain == 0, f"{name}: plain versions ran {plain} times")
        got = {k: v for k, v in by_kernel.items() if v}
        check(got == want, f"{name}: launches {got}, expected {want}")
        total.update(by_kernel)
        return out, got

    # rfft (1000000, 93): K7 at odd n on K1's 31 x 3
    rows, n = 1_000_000, 93
    x, _ = _device_planes((rows, n), seed=31)
    y, got = driven("rfft", tpufft_torch.rfft, x, {"r2c": 1})
    back, got_b = driven("irfft", lambda v: tpufft_torch.irfft(v, n=n), y,
                         {"c2r": 1})
    ref = np.fft.rfft(x[:4].double().cpu().numpy())
    err = float(np.max(np.abs(y[:4].cpu().numpy() - ref))
                / np.max(np.abs(ref)))
    rt = norm_err(back, x)
    check(err < NP_TOL and rt < NP_TOL,
          f"rfft {(rows, n)}: vs np.fft.rfft {err:.3e}, round trip {rt:.3e}")
    t = {"path": _time_ms(lambda: tpufft_torch.rfft(x)),
         "irfft_path": _time_ms(lambda: tpufft_torch.irfft(y, n=n)),
         "torch_rfft": _time_ms(lambda: torch.fft.rfft(x)),
         "torch_irfft": _time_ms(lambda: torch.fft.irfft(y, n=n)),
         "floor": f32 * (rows * n + 2 * rows * (n // 2 + 1)) / rate * 1e3}
    print(f"  path rfft {(rows, n)} f32 -> c64: " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items()) + f" ms; K7 "
          f"{real_fft.form(n)} form; vs np.fft.rfft {err:.3e}, round trip "
          f"{rt:.3e}, launches {got} and {got_b}")
    del x, y, back
    # rfft2 / irfft2 (100, 640, 480): K7 at 480, K2 at 640 (and back)
    shape = (100, 640, 480)
    x, _ = _device_planes(shape, seed=640)
    y, got = driven("rfft2", tpufft_torch.rfft2, x, {"r2c": 1, "inner": 1})
    back, got_b = driven("irfft2",
                         lambda v: tpufft_torch.irfft2(v, s=shape[1:]), y,
                         {"c2r": 1, "inner": 1})
    ref = np.fft.rfft2(x[:2].double().cpu().numpy())
    err = float(np.max(np.abs(y[:2].cpu().numpy() - ref))
                / np.max(np.abs(ref)))
    rt = norm_err(back, x)
    check(err < NP_TOL and rt < NP_TOL,
          f"rfft2 {shape}: vs np.fft.rfft2 {err:.3e}, round trip {rt:.3e}")
    nb = f32 * (x.numel() + 2 * y.numel())
    t = {"path": _time_ms(lambda: tpufft_torch.rfft2(x)),
         "irfft2_path": _time_ms(
             lambda: tpufft_torch.irfft2(y, s=shape[1:])),
         "torch_rfft2": _time_ms(lambda: torch.fft.rfft2(x)),
         "torch_irfft2": _time_ms(lambda: torch.fft.irfft2(y, s=shape[1:])),
         "floor": (nb + f32 * 4 * y.numel()) / rate * 1e3}
    print(f"  path rfft2 {shape} f32 -> c64: " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items()) + f" ms; K7 at 480 "
          f"{real_fft.form(480)} form; vs np.fft.rfft2 {err:.3e}, round "
          f"trip {rt:.3e}, launches {got} and {got_b}")
    del x, y, back
    torch.cuda.synchronize()
    return dict(total)


def phase_long_times(rate: float) -> dict:
    """Phase 29: K1's three-factor line form at LONG_K1_SHAPES, each beside
    its stage form, its plain version, ``torch.fft.fft`` and the copy
    floor; K9 at (10000, 5000 -> 8192) and K20 at (5, 2 x 16384) and (5000,
    2 x 16384) on it; then the Bluestein ``fft`` of (10000, 4099) (K1 twice
    at m = 8320) as a path, every count set to 0 just before it and read
    just after, against ``np.fft.fft`` on four rows and through the round
    trip, timed beside ``torch.fft.fft``. Returns the path's launches."""
    card = _smi("name,power.limit")
    print(f"phase 29, the three-factor line form [{card}], ms (median of "
          f"{REPS}):")
    kw = dict(inverse=False, scale=1.0)
    for rows, n in LONG_K1_SHAPES:
        xr, xi = _device_planes((rows, n), seed=n)
        xc = torch.complex(xr, xi)
        launched = minor_fft.launched_geometry(n)
        check(launched == {"form": "lines", **minor_fft.line_geometry(n)},
              f"K1 at {n}: the library launches {launched}")
        _ab_line(f"K1 ({rows}, {n}) {minor_fft.line_split(n)}",
                 lambda: minor_fft.fft_minor(xr, xi, **kw),
                 lambda: minor_fft.fft_minor(xr, xi, stages=True, **kw),
                 lambda: minor_fft.fft_minor_reference(xr, xi, **kw),
                 lambda: torch.fft.fft(xc), 16.0 * rows * n, rate)
        del xr, xi, xc
    xr, xi = _device_planes((10_000, 5000), seed=5000)
    xc = torch.complex(xr, xi)
    pad = dict(kw, n=8192)
    _ab_line("K9 (10000, 5000 -> 8192)",
             lambda: minor_fft.fft_minor_padded(xr, xi, **pad),
             lambda: minor_fft.fft_minor_padded(xr, xi, stages=True, **pad),
             lambda: minor_fft.fft_minor_padded_reference(xr, xi, **pad),
             lambda: torch.fft.fft(xc, n=8192), 8.0 * 10_000 * (5000 + 8192),
             rate)
    del xr, xi, xc
    for rows in (5, 5000):
        st = torch.randn(rows, 2 * 16384, device="cuda")
        xr, xi = st[:, :16384].contiguous(), st[:, 16384:].contiguous()
        out = fused_fft.fft_minor_fused(st, **kw)
        ref = fused_fft.fft_minor_fused_reference(st, **kw)
        err = pair_err((out[:, :16384], out[:, 16384:]),
                       (ref[:, :16384], ref[:, 16384:]))
        check(err < F32_TOL, f"K20 ({rows}, 2 x 16384): {err:.3e}")
        t = {"fused": _time_ms(lambda: fused_fft.fft_minor_fused(st, **kw)),
             "split_plane": _time_ms(lambda: minor_fft.fft_minor(xr, xi,
                                                                 **kw)),
             "plain": _time_ms(
                 lambda: fused_fft.fft_minor_fused_reference(st, **kw)),
             "floor": 16.0 * rows * 16384 / rate * 1e3}
        print(f"  K20 ({rows}, 2 x 16384) f32: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f" ms; vs plain "
              f"{err:.3e}")
        del st, xr, xi, out, ref
    xr, xi = _device_planes((10_000, 4099), seed=4099)
    x = tpufft_torch.SplitComplex(xr, xi)
    torch.cuda.synchronize()
    reset_counts()
    y = tpufft_torch.fft(x)
    back = tpufft_torch.ifft(y)
    torch.cuda.synchronize()
    by_kernel, plain = counts()
    want = {k: 4 if k == "minor" else 0 for k in ALL_KERNELS}
    check(by_kernel == want and plain == 0,
          f"Bluestein (10000, 4099): launches {by_kernel}, plain {plain}, "
          f"expected {want}")
    check(minor_fft.form(8320) == "lines",
          "Bluestein's m = 8320 is not on the line form")
    ref = np.fft.fft(xr[:4].cpu().numpy().astype(np.float64)
                     + 1j * xi[:4].cpu().numpy())
    got = y.re[:4].cpu().numpy() + 1j * y.im[:4].cpu().numpy()
    err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
    check(err < NP_TOL, f"Bluestein (10000, 4099): vs np.fft.fft {err:.3e}")
    rt = pair_err(back, x)
    check(rt < NP_TOL, f"Bluestein (10000, 4099): round trip {rt:.3e}")
    del y, back
    xc = torch.complex(xr, xi)
    t = {"path": _time_ms(lambda: tpufft_torch.fft(x)),
         "torch_fft": _time_ms(lambda: torch.fft.fft(xc)),
         "floor": 16.0 * xr.numel() / rate * 1e3}
    print(f"  path Bluestein fft (10000, 4099) c64: " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items()) + f" ms; K1 at m = 8320 on "
          f"the three-factor form {minor_fft.line_split(8320)}; vs "
          f"np.fft.fft {err:.3e}, round trip {rt:.3e}, launches "
          f"{ {k: v for k, v in by_kernel.items() if v} }")
    del x, xr, xi, xc
    torch.cuda.synchronize()
    return {k: v for k, v in by_kernel.items() if v}


def phase_cluster_times(rate: float) -> dict:
    """Phase 30: the strided kernel's cluster form at CLUSTER_K2_SHAPES (K2)
    and K3 with the two-pass twiddle on the (4 x 4096, 4096, 1) view of
    ``fft`` TWO_PASS_LONG, each beside its stage form (in turns), its plain
    version, ``torch.fft.fft`` and the copy floor; K18 and K19 beside their
    plain versions, ``torch.fft.fft`` and the floor; then the paths ``fft2``
    (1, 3840, 2160) (K2 at 3840, K1 at 2160) and ``fft`` TWO_PASS_LONG (K3
    with the swapped store, then K2), each driven with every count set
    to 0 just before it and read just after, against ``np.fft`` on a few
    rows and through the round trip, timed beside ``torch.fft``. Returns
    the paths' launches."""
    card = _smi("name,power.limit")
    print(f"phase 30, the strided cluster form [{card}], ms (median of "
          f"{REPS}):")
    kw = dict(inverse=False, scale=1.0)
    for shape, dtype in CLUSTER_K2_SHAPES:
        pre, n, post = shape
        xr, xi = _device_planes(shape, seed=n)
        xr, xi = xr.to(dtype), xi.to(dtype)
        xc = torch.complex(xr.float(), xi.float())
        geo = inner_fft.line_geometry(n, post, dtype)
        check(geo is not None and "q" in geo,
              f"K2 at {n} {dtype}: not on the cluster form ({geo})")
        _ab_line(f"K2 {shape} {str(dtype)[6:]} {geo}",
                 lambda: inner_fft.fft_inner(xr, xi, **kw),
                 lambda: inner_fft.fft_inner(xr, xi, stages=True, **kw),
                 lambda: inner_fft.fft_inner_reference(xr, xi, **kw),
                 lambda: torch.fft.fft(xc, dim=1),
                 4.0 * xr.element_size() * xr.numel(), rate,
                 F32_TOL if dtype == torch.float32 else BF16_TOL)
        del xr, xi, xc
    # K3 with the twiddle on the cluster form: the balanced split of
    # TWO_PASS_LONG, 4096 x 4096 (the split's rule runs 1024 x 16384)
    batch, n = TWO_PASS_LONG
    a, b = 4096, n // 4096
    xr, xi = _device_planes((batch * a, b, 1), seed=a)
    tw = execute._device_two_pass_twiddle(a, b, False, xr.device)
    nd = dict(kw, n=a, twiddle=tw)
    xc = torch.complex(xr, xi).reshape(batch, a, b)
    check("q" in inner_fft.line_geometry(a, b, torch.float32),
          f"K3 at {a}: not on the cluster form")
    _ab_line(f"K3 + twiddle {(batch * a, b, 1)} "
             f"{inner_fft.line_geometry(a, b, torch.float32)}",
             lambda: inner_fft.fft_inner_nd(xr, xi, **nd),
             lambda: inner_fft.fft_inner_nd(xr, xi, stages=True, **nd),
             lambda: inner_fft.fft_inner_nd_reference(xr, xi, **nd),
             lambda: torch.fft.fft(xc, dim=1), 16.0 * xr.numel(), rate)
    _ab_line(f"K3 + twiddle, swapped store {(batch * a, b, 1)}",
             lambda: inner_fft.fft_inner_nd(xr, xi, swap=True, **nd),
             lambda: inner_fft.fft_inner_nd(xr, xi, swap=True, stages=True,
                                            **nd),
             lambda: inner_fft.fft_inner_nd_reference(xr, xi, swap=True,
                                                      **nd),
             lambda: torch.fft.fft(xc, dim=1), 16.0 * xr.numel(), rate)
    del xr, xi, xc, tw
    # K18 and K19 on the cluster form: a 4K frame's axis 3840 over 8
    # channels of 270 (fused halves), and the 8192² plane as one fused row
    for key, shape in (("inner", (1, 3840, 8, 270)),
                       ("inner_m1", (1, 8192, 8192))):
        st = _fused_array(shape, torch.float32, seed=shape[1])
        h = shape[-1]
        xc = torch.complex(st[..., :h], st[..., h:])
        out = fused_fft.fft_inner_fused(st, **kw)
        ref = fused_fft.fft_inner_fused_reference(st, **kw)
        err = pair_err(_halves(out), _halves(ref))
        check(err < F32_TOL, f"K18/K19 {shape}: vs plain {err:.3e}")
        t = {"fused": _time_ms(lambda: fused_fft.fft_inner_fused(st, **kw)),
             "plain": _time_ms(
                 lambda: fused_fft.fft_inner_fused_reference(st, **kw)),
             "library": _time_ms(lambda: torch.fft.fft(xc, dim=1)),
             "floor": 8.0 * st.numel() / rate * 1e3}
        print(f"  {'K18' if key == 'inner' else 'K19'} {shape} (x 2 halves)"
              f" f32: " + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f" ms; vs plain {err:.3e}")
        del st, xc, out, ref
    total = collections.Counter()
    for shape, call, back_call, ref_call, want in (
            ((1, 3840, 2160), tpufft_torch.fft2, tpufft_torch.ifft2,
             torch.fft.fft2, {"inner": 2, "minor": 2}),
            (TWO_PASS_LONG, tpufft_torch.fft, tpufft_torch.ifft,
             torch.fft.fft, {"inner_nd": 2, "inner": 2})):
        xr, xi = _device_planes(shape, seed=sum(shape))
        x = tpufft_torch.SplitComplex(xr, xi)
        torch.cuda.synchronize()
        reset_counts()
        y = call(x)
        back = back_call(y)
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        want = {k: want.get(k, 0) for k in ALL_KERNELS}
        check(by_kernel == want and plain == 0,
              f"{call.__name__} {shape}: launches {by_kernel}, plain "
              f"{plain}, expected {want}")
        total.update(by_kernel)
        x0 = xr[:1].cpu().numpy().astype(np.float64) + 1j * xi[:1].cpu(
            ).numpy()
        ref = np.fft.fft2(x0) if len(shape) == 3 else np.fft.fft(x0)
        got = y.re[:1].cpu().numpy() + 1j * y.im[:1].cpu().numpy()
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err < NP_TOL, f"{call.__name__} {shape}: vs np.fft {err:.3e}")
        rt = pair_err(back, x)
        check(rt < NP_TOL, f"{call.__name__} {shape}: round trip {rt:.3e}")
        del y, back
        xc = torch.complex(xr, xi)
        t = {"path": _time_ms(lambda: call(x)),
             "torch_fft": _time_ms(lambda: ref_call(xc)),
             "floor": 2 * 16.0 * xr.numel() / rate * 1e3}
        print(f"  path {call.__name__} {shape} c64: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + f" ms; vs np.fft "
              f"{err:.3e}, round trip {rt:.3e}, launches "
              f"{ {k: v for k, v in by_kernel.items() if v} }")
        del x, xr, xi, xc
    torch.cuda.synchronize()
    return dict(total)


def phase_two_pass_times(rate: float) -> dict:
    """Phase 33: the two-pass split at TWO_PASS_SHAPES. Each ``fft`` is
    driven forward and back with every count set to 0 just before and read
    just after (K3 with the twiddle and the swapped store, then K2, once a
    transform; no K1, no plain version), held against ``np.fft`` on a row
    and through the round trip, and one call profiled in a fresh process
    by tools/kernel_profile.py (exactly two CUDA kernels, both the strided
    kernel's: no copy). Then, timed: the path
    (one call, and per call of ten back to back, which hides the host's
    time before the launches), the three-step it replaced
    (``_three_step``: K3 in the natural order, K1, the transpose copy;
    the same two ways), pass 1 (K3 swapped) beside its natural store
    and its stage form, pass 2 (K2) alone, the three-step's K1 and copy,
    ``torch.fft.fft`` and the floor of two passes; then every split of
    TWO_PASS_SPLITS, in turns. Returns the paths' launches."""
    card = _smi("name,power.limit")
    print(f"phase 33, the two-pass split [{card}], ms (median of {REPS}):")
    total = collections.Counter()
    kw = dict(inverse=False, scale=1.0)
    fresh = _fresh_fft_kernels(TWO_PASS_SHAPES)
    for shape in TWO_PASS_SHAPES:
        rows, n = shape
        a, b = execute._split_large(n)
        xr, xi = _device_planes(shape, seed=n % 997)
        x = tpufft_torch.SplitComplex(xr, xi)
        torch.cuda.synchronize()
        reset_counts()
        y = tpufft_torch.fft(x)
        back = tpufft_torch.ifft(y)
        torch.cuda.synchronize()
        by_kernel, plain = counts()
        want = {k: 0 for k in ALL_KERNELS}
        want.update(inner_nd=2, inner=2)
        check(by_kernel == want and plain == 0,
              f"two-pass fft {shape}: launches {by_kernel}, plain {plain}, "
              f"expected {want}")
        total.update(by_kernel)
        x0 = xr[:1].double().cpu().numpy() + 1j * xi[:1].cpu().numpy()
        ref = np.fft.fft(x0)
        got = y.re[:1].cpu().numpy() + 1j * y.im[:1].cpu().numpy()
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err < NP_TOL, f"two-pass fft {shape}: vs np.fft {err:.3e}")
        rt = pair_err(back, x)
        check(rt < NP_TOL, f"two-pass fft {shape}: round trip {rt:.3e}")
        del y, back
        ran = fresh[shape]
        names = [k.split("(")[0].split("<")[0].split()[-1] for k, _ in ran]
        check(len(ran) == 2 and all("strided" in k for k, _ in ran),
              f"two-pass fft {shape}: {len(ran)} CUDA kernels {names}, "
              f"expected the strided kernel twice and no copy")
        here = _cuda_kernels(lambda: tpufft_torch.fft(x))
        print(f"  profiled in this process (after earlier profiler "
              f"sessions): {len(here)} CUDA kernels; in a fresh process: "
              f"{len(ran)}")
        print(f"  path fft {shape} = {a} x {b}: vs np.fft {err:.3e}, round "
              f"trip {rt:.3e}, launches "
              f"{ {k: v for k, v in by_kernel.items() if v} }; profiled: "
              f"{len(ran)} CUDA kernels, " + ", ".join(
                  f"{k} {ms:.4f} ms" for k, (_, ms) in zip(names, ran)))
        tw = execute._device_two_pass_twiddle(a, b, False, xr.device)
        v = (rows * a, b, 1)
        r3, i3 = xr.reshape(v), xi.reshape(v)
        nd = dict(kw, n=a, twiddle=tw)
        xc = torch.complex(xr, xi)
        p1 = _ab_line(f"pass 1, K3 + twiddle, swapped store {v} "
                      f"{inner_fft.line_geometry(a, b, torch.float32)}",
                      lambda: inner_fft.fft_inner_nd(r3, i3, swap=True,
                                                     **nd),
                      lambda: inner_fft.fft_inner_nd(
                          r3, i3, swap=True, stages=True, **nd),
                      lambda: inner_fft.fft_inner_nd_reference(
                          r3, i3, swap=True, **nd),
                      lambda: torch.fft.fft(xc.reshape(rows, a, b), dim=1),
                      16.0 * xr.numel() + 8.0 * a * b, rate)
        sr, si = inner_fft.fft_inner_nd(r3, i3, swap=True, **nd)
        mid = (rows, b, a)
        sr, si = sr.reshape(mid), si.reshape(mid)
        sc = torch.complex(sr, si)
        p2 = _ab_line(f"pass 2, K2 {mid} "
                      f"{inner_fft.line_geometry(b, a, torch.float32)}",
                      lambda: inner_fft.fft_inner(sr, si, **kw),
                      lambda: inner_fft.fft_inner(sr, si, stages=True, **kw),
                      lambda: inner_fft.fft_inner_reference(sr, si, **kw),
                      lambda: torch.fft.fft(sc, dim=1), 16.0 * xr.numel(),
                      rate)
        del sc
        m2 = (rows * a, b)
        t = {"path": _time_ms(lambda: tpufft_torch.fft(x)),
             "path_back_to_back": _back_to_back_ms(
                 lambda: tpufft_torch.fft(x)),
             "three_step": _time_ms(lambda: execute._fft_axis_two_pass(
                 xr, xi, 1, a, b, _three_step=True, **kw)),
             "three_step_back_to_back": _back_to_back_ms(
                 lambda: execute._fft_axis_two_pass(
                     xr, xi, 1, a, b, _three_step=True, **kw)),
             "pass1": p1["line"], "pass1_natural": _time_ms(
                 lambda: inner_fft.fft_inner_nd(r3, i3, **nd)),
             "pass2": p2["line"],
             "k1": _time_ms(lambda: minor_fft.fft_minor(
                 xr.reshape(m2), xi.reshape(m2), **kw)),
             "swap_copy": _time_ms(lambda: [
                 p.reshape(rows, a, b).transpose(1, 2).contiguous()
                 for p in (xr, xi)]),
             "torch_fft": _time_ms(lambda: torch.fft.fft(xc, dim=-1)),
             "floor": 2 * 16.0 * xr.numel() / rate * 1e3}
        print(f"  fft {shape} = {a} x {b}: " + ", ".join(
            f"{k} {val:.4f}" for k, val in t.items()) + " ms; path / floor "
            f"{t['path'] / t['floor']:.3f}, path / torch_fft "
            f"{t['path'] / t['torch_fft']:.3f}")
        splits = TWO_PASS_SPLITS[n]
        sweep = {s: 0.0 for s in splits}
        for turn in range(2):
            for s in (splits if turn == 0 else splits[::-1]):
                e = pair_err(execute._fft_axis_two_pass(xr, xi, 1, *s, **kw),
                             (execute._fft_axis_two_pass(xr, xi, 1, a, b,
                                                         **kw)))
                check(e < 1e-4,
                      f"split {s} of {shape}: vs the rule's {e:.3e}")
                sweep[s] += _time_ms(lambda: execute._fft_axis_two_pass(
                    xr, xi, 1, *s, **kw)) / 2
        print(f"  sweep {shape}, pass 1 over a x pass 2 over b, mean of two "
              f"turns: " + ", ".join(f"{p} x {q} {val:.4f}"
                                     for (p, q), val in sweep.items()) + " ms")
        del x, xr, xi, xc, r3, i3, sr, si
        torch.cuda.empty_cache()
    return dict(total)


def phase_mid_pair_times(rate: float) -> dict:
    """Phase 32: K6's generic-radix form at MIXED_K6_SHAPES, each through
    ``_ab_line`` beside its stage form (4 lanes of L, in turns), its plain
    version, ``torch.fft.fftn(dim=(1, 2))`` and the copy floor, and beside
    the K3 + K2 route it replaces; then the transform-major T2 path
    (T2_SHAPE over axes 1-4: K3 at 25, K6 at (48, 160), K1 at 160) with
    every count set to 0 just before it and read just after, against
    ``np.fft.fftn`` and through its inverse plan, timed beside the natural
    layout and ``torch.fft.fftn``. Returns the path's launches."""
    card = _smi("name,power.limit")
    print(f"phase 32, K6's generic-radix form [{card}], ms (median of "
          f"{REPS}):")
    kw = dict(inverse=False, scale=1.0)
    for shape in MIXED_K6_SHAPES:
        _, n1, n2, L = shape
        check(mid_pair_fft.form(n1, n2, L) == "mixed",
              f"K6 {shape}: not on the generic-radix form")
        xr, xi = _device_planes(shape, seed=n1 + L)
        xc = torch.complex(xr, xi)
        stage, planes = _mid_stage_form(xr, xi)
        c = mid_pair_fft.cluster_size(n1, n2)
        _ab_line(f"K6 {shape} clusters of {c}, "
                 f"{mid_pair_fft.active_clusters(n1, n2, False, 0)} at once",
                 lambda: mid_pair_fft.fft_mid_pair(xr, xi, **kw),
                 lambda: (stage(), planes)[1],
                 lambda: mid_pair_fft.fft_mid_pair_reference(xr, xi, **kw),
                 lambda: torch.fft.fftn(xc, dim=(1, 2)),
                 16.0 * xr.numel(), rate)
        print(f"    K3 + K2 {_time_ms(lambda: _axes_1_2(xr, xi)):.4f} ms")
        del xr, xi, xc, stage, planes
    shape = T2_SHAPE
    axes = (1, 2, 3, 4)
    xr, xi = _device_planes(shape, seed=2)
    x = tpufft_torch.SplitComplex(xr, xi)
    fwd, inv, nat = _layout_plans(shape, axes, "transform-major", None)
    packed = fwd.pack(x)
    torch.cuda.synchronize()
    reset_counts()
    y = fwd(packed)
    back = inv(y)
    torch.cuda.synchronize()
    by_kernel, plain = counts()
    want = {k: 0 for k in ALL_KERNELS}
    want.update(inner_nd=2, mid_pair=2, minor=2)
    check(by_kernel == want and plain == 0,
          f"T2 {shape}: launches {by_kernel}, plain {plain}, expected {want}"
          " (one K6 launch a transform)")
    out = fwd.unpack(y)
    ref = np.fft.fftn(_np_slices(x, 1), axes=axes)
    err = float(np.max(np.abs(_np_slices(out, 1) - ref)) / np.max(np.abs(
        ref)))
    check(err < NP_TOL, f"T2 {shape}: vs np.fft.fftn {err:.3e}")
    rt = pair_err(inv.unpack(back), x)
    check(rt < NP_TOL, f"T2 {shape}: round trip {rt:.3e}")
    del y, back, out
    xc = torch.complex(xr, xi)
    t = {"path": _time_ms(lambda: fwd(packed)),
         "natural": _time_ms(lambda: nat(x)),
         "torch_fftn": _time_ms(lambda: torch.fft.fftn(xc, dim=axes)),
         "floor": 3 * 16.0 * xr.numel() / rate * 1e3}
    print(f"  path T2 transform-major {shape} c64 (physical "
          f"{tuple(packed.shape)}): " + ", ".join(
              f"{k} {v:.4f}" for k, v in t.items()) + f" ms; K6 at (48, 160)"
          f" {mid_pair_fft.form(48, 160, 160)} form; vs np.fft.fftn "
          f"{err:.3e}, round trip {rt:.3e}, launches "
          f"{ {k: v for k, v in by_kernel.items() if v} }")
    del x, xr, xi, xc, packed
    torch.cuda.synchronize()
    return {k: v for k, v in by_kernel.items() if v}


def _copy_rate() -> float:
    """Bytes per second of a 2 GB device copy (1 GB read, 1 GB written)."""
    nbytes = 2e9
    rate = nbytes / (_copy_floor_ms(nbytes) * 1e-3)
    print(f"copy rate {rate / 1e9:.0f} GB/s (a 1 GB device copy)")
    return rate


def _bound(row: dict, rate: float, peak: float) -> tuple[float, str]:
    """The least time for a kernel's work, ms, and which term sets it."""
    t_bytes = row["bytes"] / rate * 1e3
    t_ops = row["flops"] / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn) -> float:
    """Median of REPS CUDA-event timings after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _back_to_back_ms(fn, launches: int = 10) -> float:
    """Median over REPS event pairs of ``launches`` calls each, per call:
    the device time of a call without the host's time before its launch,
    where the call takes longer on the device than on the host."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _host_ms(fn) -> float:
    """Median of REPS host-clock times of one call, from its start until it
    returns with its work queued (the device idle before each call)."""
    fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def phase_times() -> dict:
    rows = {}
    for batch, n in MAIN_SHAPES:
        xr, xi = _planes((batch, n), torch.float32, seed=1)
        x = tpufft_torch.SplitComplex(xr, xi)
        xc = torch.complex(xr, xi)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        plan = tpufft_torch.plan_fft((batch, n), torch.complex64, axes=(-1,))

        got = minor_fft.fft_minor(xr, xi, inverse=False, scale=1.0)
        ref = minor_fft.fft_minor_reference(xr, xi, inverse=False, scale=1.0)
        abs_err = max((got[0] - ref[0]).abs().max().item(),
                      (got[1] - ref[1]).abs().max().item())
        err = pair_err(got, ref)
        check(err < F32_TOL, f"({batch}, {n}): kernel vs plain {err:.3e}")
        del got, ref

        def copy():
            yr.copy_(xr)
            yi.copy_(xi)

        t = {
            "main_path": _time_ms(lambda: plan(x)),
            "kernel": _time_ms(lambda: minor_fft.fft_minor(
                xr, xi, inverse=False, scale=1.0)),
            "plain": _time_ms(lambda: minor_fft.fft_minor_reference(
                xr, xi, inverse=False, scale=1.0)),
            "torch_fft": _time_ms(lambda: torch.fft.fft(xc, dim=-1)),
            "copy": _time_ms(copy),
            "stage_form": _time_ms(lambda: minor_fft.fft_minor(
                xr, xi, inverse=False, scale=1.0, stages=True)),
        }
        gbytes = 2 * 2 * 4 * batch * n / 1e9   # planes in + out, f32
        print(f"times ({batch}, {n}) c64, {minor_fft.form(n)} form, median "
              f"of {REPS} ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
              + f"; kernel {gbytes / (t['kernel'] * 1e-3):.0f} GB/s, "
              f"copy {gbytes / (t['copy'] * 1e-3):.0f} GB/s; kernel vs plain "
              f"max abs {abs_err:.3e}, normalized {err:.3e}")
        rows[(batch, n)] = dict(t, max_abs_err=abs_err, bytes=gbytes * 1e9,
                                flops=_fft_flops(n, batch))
        del x, xc, xr, xi, yr, yi
    torch.cuda.synchronize()
    return rows


def _entry(name: str, source: str, replaces: str, launches: int,
           row: dict, rate: float, peak: float) -> dict:
    bound_ms, bound_by = _bound(row, rate, peak)
    return {"name": name, "route": "cuda",
            "source": f"tpufft_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": row["library_ms"]}


def _dense_entry(name: str, replaces: str, launches: int, row: dict,
                 rate: float, peak: float) -> dict:
    """K10/K11/K12's entry: the bound of the body that ran (the tensor-core
    body does three TF32 products at TF32_PEAK, the FMA body one f32
    product at the FP32 peak), both operations bounds, and the body."""
    tf32x3 = row["form"] == "tf32x3"
    entry = _entry(name, "dense_mm.cu", replaces, launches,
                   dict(row, flops=3 * row["flops"]) if tf32x3 else row,
                   rate, TF32_PEAK if tf32x3 else peak)
    entry.update(form=row["form"], bound_tf32x3_ms=row["bound_tf32x3_ms"],
                 bound_fp32_ms=row["bound_fp32_ms"])
    return entry


def main() -> None:
    name, peak = phase_device()
    phase_build()
    phase_kernel()
    launches = phase_main_path()
    rows = phase_times()
    phase_new_kernels()
    path_launches = phase_new_paths()
    new_rows = phase_new_times()
    head = rows[MAIN_SHAPES[0]]
    phase_real_kernels()
    real_launches = phase_real_paths()
    real_rows = phase_real_times(head["kernel"])
    phase_dense_kernels()
    dense_launches = phase_dense_paths()
    dense_rows = phase_dense_times(peak)
    phase_stft_kernels()
    stft_launches = phase_spectral_paths()
    stft_rows = phase_spectral_times()
    phase_cluster_kernels()
    nd_launches = phase_nd_paths()
    nd_rows = phase_nd_times()
    phase_fused_kernels()
    layout_launches = phase_layout_paths()
    layout_rows = phase_layout_times()
    rate = _copy_rate()
    multirate_launches = phase_multirate_paths(rate)
    design_launches = phase_design_paths(rate)
    peak_launches = phase_peaks_spline_paths(rate)
    parallel_launches = phase_native_parallel_paths(rate)
    mixed_launches = phase_mixed_times(rate)
    long_launches = phase_long_times(rate)
    cluster_launches = phase_cluster_times(rate)
    real_mixed_launches = phase_mixed_real_times(rate)
    mid_launches = phase_mid_pair_times(rate)
    two_pass_launches = phase_two_pass_times(rate)
    total = collections.Counter()
    for part in (path_launches, real_launches, dense_launches,
                 stft_launches, nd_launches, layout_launches,
                 multirate_launches, design_launches, peak_launches,
                 parallel_launches, mixed_launches, long_launches,
                 cluster_launches, real_mixed_launches, mid_launches,
                 two_pass_launches):
        total.update(part)
    total["minor"] += launches
    k1 = {"ms": head["kernel"], "plain_ms": head["plain"],
          "library_ms": head["torch_fft"], "bytes": head["bytes"],
          "flops": head["flops"],
          "max_abs_err": max([r["max_abs_err"] for r in rows.values()]
                             + [new_rows["minor"]["max_abs_err"]])}
    new_rows["inner_nd"]["max_abs_err"] = max(
        new_rows["inner_nd"]["max_abs_err"],
        new_rows["inner_nd_tw"]["max_abs_err"])
    layout_rows["K18_P3"]["max_abs_err"] = max(
        layout_rows[f"K18_{p}"]["max_abs_err"] for p in ("P2", "P3", "P4"))
    mx = "tpufft/kernels/mxu_fft.py"
    entries = [
        _entry("minor_fft", "minor_fft.cu", f"{mx}:1282", total["minor"], k1,
               rate, peak),
        _entry("inner_fft (K2)", "strided_fft.cu", f"{mx}:1341",
               total["inner"], new_rows["inner"], rate, peak),
        _entry("inner_nd_fft (K3)", "strided_fft.cu", f"{mx}:1427",
               total["inner_nd"], new_rows["inner_nd"], rate, peak),
        _entry("pair_fft (K4)", "pair_fft.cu", f"{mx}:1686",
               total["pair"] + total["pair_padded"], new_rows["pair"], rate,
               peak),
        _entry("cube_fft (K5)", "cluster_fft.cu", f"{mx}:2006",
               total["cube"], nd_rows["cube"], rate, peak),
        _entry("mid_pair_fft (K6)", "cluster_fft.cu", f"{mx}:1496",
               total["mid_pair"], nd_rows["mid_pair"], rate, peak),
        _entry("rfft_minor (K7)", "real_fft.cu", f"{mx}:418", total["r2c"],
               real_rows["r2c"], rate, peak),
        _entry("irfft_minor (K8)", "real_fft.cu", f"{mx}:474", total["c2r"],
               real_rows["c2r"], rate, peak),
        _entry("minor_fft_padded (K9)", "minor_fft.cu", f"{mx}:551",
               total["minor_padded"], real_rows["minor_padded"], rate, peak),
        _dense_entry("dense_mm_complex (K10)", f"{mx}:606",
                     total["complex"], dense_rows["complex"], rate, peak),
        _dense_entry("dense_mm_real (K11)", f"{mx}:658", total["real"],
                     dense_rows["real"], rate, peak),
        _dense_entry("r2r_minor (K12)", "tpufft/realtrans.py:177",
                     total["r2r"], dense_rows["r2r"], rate, peak),
        _entry("stft_frames (K13)", "stft_mm.cu", f"{mx}:755",
               total["stft"], stft_rows["stft"], rate, peak),
        _entry("istft_frames (K14)", "stft_mm.cu", f"{mx}:884",
               total["istft"], stft_rows["istft"], rate, peak),
        _entry("welch_accum (K15)", "stft_mm.cu", f"{mx}:1008",
               total["welch"] + total["csd"], stft_rows["welch"], rate,
               peak),
        _entry("cube_fft_fused (K16)", "cluster_fft.cu", f"{mx}:2105",
               total["fused_cube"], layout_rows["K16"], rate, peak),
        _entry("pair_fft_fused (K17)", "pair_fft.cu", f"{mx}:2337",
               total["fused_pair"], layout_rows["K17"], rate, peak),
        _entry("inner_fft_fused (K18)", "strided_fft.cu", f"{mx}:2154",
               total["fused_inner"], layout_rows["K18_P3"], rate, peak),
        _entry("inner_fft_fused_m1 (K19)", "strided_fft.cu", f"{mx}:2203",
               total["fused_inner_m1"], layout_rows["K19"], rate, peak),
        _entry("minor_fft_fused (K20)", "minor_fft.cu", f"{mx}:2257",
               total["fused_minor"], layout_rows["K20"], rate, peak),
    ]
    for key in ("K16_bf16", "K18_P2", "K18_P4"):
        b = _bound(layout_rows[key], rate, peak)[0]
        print(f"bound {key}: {b:.4f} ms, kernel {layout_rows[key]['ms']:.4f}"
              f" ms, {b / layout_rows[key]['ms']:.3f} of it")
    for key, row in layout_rows.items():
        print(f"{key}: kernel {row['ms']:.4f} ms against its split-plane "
              f"sibling {row['sibling_ms']:.4f} ms, ratio "
              f"{row['ms'] / row['sibling_ms']:.3f}")
    check(stft_launches["csd"] > 0,
          "welch_accum (K15) with two signals never ran on the main paths")
    csd_bound = _bound(stft_rows["csd"], rate, peak)[0]
    print(f"bound welch_accum (K15) csd: {csd_bound:.4f} ms, kernel "
          f"{stft_rows['csd']['ms']:.4f} ms, "
          f"{csd_bound / stft_rows['csd']['ms']:.3f} of it")
    check(real_launches["pair_padded"] > 0,
          "pair_fft (K4) with n2_in never ran on the main paths")
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} never ran on the main paths")
        print(f"bound {e['name']}: {e['bound_ms']:.4f} ms ({e['bound_by']}), "
              f"kernel {e['ms']:.4f} ms, {e['bound_ms'] / e['ms']:.3f} of it")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
