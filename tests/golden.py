"""Golden NumPy reference implementations of the DoA math.

These play the role of the reference repo's offline-generated golden vectors
(SURVEY.md §4: upstream qa_*.py tests compare against hardcoded arrays
generated MATLAB-style). Every doa_tpu op must match these to tolerance.
All conventions (steering-vector sign, normalization, FB averaging, root
selection) are pinned HERE; doa_tpu implements the same math on device.

Conventions (documented in doa_tpu.ops.steering as well):
  * ULA with element positions p_k = k * d (k = 0..N-1), d = norm_spacing
    in wavelengths; theta measured from the array axis (endfire),
    theta ∈ [0°, 180°], broadside = 90°.
  * a(theta)_k = exp(-1j * 2*pi * d * k * cos(theta))
  * R = E[x x^H]: R_ij = (1/S) Σ_s x_si conj(x_sj)  for X: (S, N)
    (standard array-processing covariance; the signal subspace then
    contains a(theta) itself, not its conjugate).
  * Forward-backward: R_fb = (R + J conj(R) J) / 2, J = exchange matrix.
  * MUSIC: P(theta) = 1 / || E_n^H a(theta) ||^2, max-normalized.
  * Capon: P(theta) = 1 / Re(a^H R^-1 a), max-normalized.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Steering
# ---------------------------------------------------------------------------

def ula_steering(theta_deg, num_elements: int, norm_spacing: float):
    """a(theta): (..., N) complex128 steering vectors for a ULA."""
    theta = np.deg2rad(np.asarray(theta_deg, dtype=np.float64))
    k = np.arange(num_elements)
    phase = -2.0 * np.pi * norm_spacing * np.cos(theta)[..., None] * k
    return np.exp(1j * phase)


def ura_steering(az_deg, el_deg, shape, norm_spacing: float):
    """Planar (URA) steering for direction (az, el).

    Elements on a (nx, ny) grid in the x-y plane at positions
    (ix*d, iy*d). Unit direction vector u = (cos el * sin az,
    cos el * cos az, sin el); phase = -2π d (ix*u_x + iy*u_y).
    Returns (..., nx*ny) complex128 (x-major flattening).
    """
    az = np.deg2rad(np.asarray(az_deg, dtype=np.float64))
    el = np.deg2rad(np.asarray(el_deg, dtype=np.float64))
    ux = np.cos(el) * np.sin(az)
    uy = np.cos(el) * np.cos(az)
    nx, ny = shape
    ix = np.arange(nx)[:, None]  # (nx, 1)
    iy = np.arange(ny)[None, :]  # (1, ny)
    phase = -2.0 * np.pi * norm_spacing * (
        ux[..., None, None] * ix + uy[..., None, None] * iy
    )
    return np.exp(1j * phase).reshape(*np.shape(az), nx * ny)


# ---------------------------------------------------------------------------
# Covariance
# ---------------------------------------------------------------------------

def frame_samples(x, snapshot_size: int, overlap: int):
    """x: (T, N) → frames (B, S, N) with hop = S - overlap.

    Matches reference autocorrelate's sliding-window semantics: window b
    covers samples [b*hop, b*hop + S). Trailing samples that don't fill a
    window are dropped.
    """
    x = np.asarray(x)
    S = snapshot_size
    hop = S - overlap
    T = x.shape[0]
    B = 0 if T < S else (T - S) // hop + 1
    return np.stack([x[b * hop : b * hop + S] for b in range(B)], axis=0)


def sample_covariance(frames, fb_average: bool = False):
    """frames: (B, S, N) → R: (B, N, N), R_ij = (1/S) Σ_s x_si conj(x_sj).

    fb_average applies forward-backward averaging
    (reference autocorrelate avg_method=1).
    """
    frames = np.asarray(frames)
    S = frames.shape[1]
    R = np.einsum("bsi,bsj->bij", frames, frames.conj()) / S
    if fb_average:
        R = forward_backward(R)
    return R


def forward_backward(R):
    """R_fb = (R + J conj(R) J) / 2 with J the exchange (flip) matrix."""
    Rb = np.conj(R[..., ::-1, ::-1])
    return 0.5 * (R + Rb)


def spatial_smooth(R, subarray_size: int):
    """Forward spatial smoothing: average the (N-L+1) L×L principal
    submatrices along the diagonal of R. R: (..., N, N) → (..., L, L)."""
    N = R.shape[-1]
    L = subarray_size
    M = N - L + 1
    out = np.zeros(R.shape[:-2] + (L, L), dtype=R.dtype)
    for m in range(M):
        out += R[..., m : m + L, m : m + L]
    return out / M


# ---------------------------------------------------------------------------
# Subspace + spectra
# ---------------------------------------------------------------------------

def noise_subspace(R, num_sources: int):
    """Hermitian eig → noise subspace E_n: (..., N, N-K) for the N-K
    smallest eigenvalues (ascending order, numpy.linalg.eigh convention)."""
    w, v = np.linalg.eigh(R)
    N = R.shape[-1]
    return v[..., :, : N - num_sources]


def music_spectrum(R, steering_mat, num_sources: int, normalize: bool = True):
    """MUSIC pseudospectrum.

    R: (B, N, N); steering_mat: (G, N) → P: (B, G) float64.
    P = 1 / ||E_n^H a||²; per-snapshot max-normalized when normalize=True
    (reference MUSIC_lin_array normalizes the output to its maximum).
    """
    En = noise_subspace(R, num_sources)           # (B, N, M)
    proj = np.einsum("bnm,gn->bgm", En.conj(), steering_mat)  # E_n^H a
    den = np.sum(np.abs(proj) ** 2, axis=-1)
    P = 1.0 / den
    if normalize:
        P = P / P.max(axis=-1, keepdims=True)
    return P


def min_norm_weight(R, num_sources: int):
    """Kumaresan–Tufts minimum-norm vector: w = Pn e1 / (e1^H Pn e1),
    Pn = E_n E_n^H. R: (B, N, N) → w: (B, N) complex, w[:, 0] = 1."""
    En = noise_subspace(R, num_sources)
    Pn = np.einsum("bnm,bkm->bnk", En, En.conj())
    d = Pn[..., :, 0]
    return d / np.maximum(d[..., :1].real, 1e-30)


def min_norm_spectrum(R, steering_mat, num_sources: int,
                      normalize: bool = True):
    """Min-Norm pseudospectrum P = 1 / |a^H w|², max-normalized like
    MUSIC. R: (B, N, N); steering_mat: (G, N) → P: (B, G)."""
    w = min_norm_weight(R, num_sources)
    s = np.einsum("gn,bn->bg", steering_mat.conj(), w)
    P = 1.0 / np.maximum(np.abs(s) ** 2, 1e-300)
    if normalize:
        P = P / P.max(axis=-1, keepdims=True)
    return P


def root_min_norm(R, num_sources: int, norm_spacing: float):
    """Grid-free Min-Norm for a ULA: roots of W(z) = Σ w_n z^n (degree
    N−1), K roots closest to |z| = 1; cosθ = +arg(z)/(2πd) under the
    pinned steering sign. → (B, K) degrees, ascending."""
    w = min_norm_weight(R, num_sources)
    out = []
    for b in range(w.shape[0]):
        roots = np.roots(w[b][::-1])                 # np.roots: descending
        score = np.abs(1.0 - np.abs(roots))
        sel = roots[np.argsort(score)[:num_sources]]
        cos_t = np.clip(np.angle(sel) / (2 * np.pi * norm_spacing),
                        -1.0, 1.0)
        out.append(np.sort(np.degrees(np.arccos(cos_t))))
    return np.stack(out, axis=0)


def capon_spectrum(R, steering_mat, diag_load: float = 0.0, normalize: bool = True):
    """Capon-MVDR: P = 1 / (a^H R⁻¹ a), optional diagonal loading of
    diag_load * tr(R)/N."""
    N = R.shape[-1]
    if diag_load > 0:
        tr = np.trace(R, axis1=-2, axis2=-1).real / N
        R = R + (diag_load * tr)[..., None, None] * np.eye(N)
    Rinv = np.linalg.inv(R)
    den = np.einsum("gn,bnm,gm->bg", steering_mat.conj(), Rinv, steering_mat).real
    P = 1.0 / den
    if normalize:
        P = P / P.max(axis=-1, keepdims=True)
    return P


def bartlett_spectrum(R, steering_mat, normalize: bool = True):
    """Conventional (Bartlett) beamformer spectrum P = Re(a^H R a),
    per-snapshot max-normalized like MUSIC/Capon. R: (B, N, N);
    steering_mat: (G, N) → P: (B, G). (Unit-modulus steering: a^H a = N
    is constant across the grid, so the classic 1/N² scaling is absorbed
    by the normalization.)"""
    P = np.einsum("gn,bnm,gm->bg", steering_mat.conj(), R,
                  steering_mat).real
    if normalize:
        P = P / P.max(axis=-1, keepdims=True)
    return P


def root_music(R, num_sources: int, norm_spacing: float):
    """Root-MUSIC for a ULA. R: (B, N, N) → theta: (B, K) degrees, sorted.

    C = E_n E_n^H; c_l = sum of l-th diagonal of C; roots of
    sum_l c_l z^{l+N-1}; keep roots strictly inside the unit circle closest
    to it; with a_k = z^k and z = exp(-j 2π d cosθ) on the signal circle,
    theta = acos(-arg(z) / (2π d)).
    """
    R = np.asarray(R)
    B, N, _ = R.shape
    K = num_sources
    out = np.zeros((B, K), dtype=np.float64)
    for b in range(B):
        En = noise_subspace(R[b], K)
        C = En @ En.conj().T
        # coeffs[l + N - 1] = sum of l-th diagonal, l = -(N-1)..(N-1)
        coeffs = np.array(
            [np.trace(C, offset=l) for l in range(-(N - 1), N)]
        )
        # numpy.roots wants highest degree first: poly sum c_l z^{l+N-1}
        roots = np.roots(coeffs[::-1])
        inside = roots[np.abs(roots) < 1.0]
        order = np.argsort(np.abs(np.abs(inside) - 1.0))
        sel = inside[order[:K]]
        cos_theta = np.clip(-np.angle(sel) / (2 * np.pi * norm_spacing), -1, 1)
        out[b] = np.sort(np.rad2deg(np.arccos(cos_theta)))
    return out


# ---------------------------------------------------------------------------
# Peaks
# ---------------------------------------------------------------------------

def unitary_q(N: int):
    """Left-Π-real unitary transform Q_N (Haardt–Nossek): Qᴴ M Q is real
    for centro-Hermitian M. Even N = 2m: Q = [[I, jI], [Π, −jΠ]]/√2;
    odd N = 2m+1 gains the middle row [0ᵀ, √2, 0ᵀ]."""
    m = N // 2
    I = np.eye(m)
    P = I[::-1]
    if N % 2 == 0:
        top = np.concatenate([I, 1j * I], axis=1)
        bot = np.concatenate([P, -1j * P], axis=1)
        return np.concatenate([top, bot], axis=0) / np.sqrt(2)
    z = np.zeros((m, 1))
    top = np.concatenate([I, z, 1j * I], axis=1)
    mid = np.concatenate([z.T, [[np.sqrt(2)]], z.T], axis=1)
    bot = np.concatenate([P, z, -1j * P], axis=1)
    return np.concatenate([top, mid, bot], axis=0) / np.sqrt(2)


def unitary_esprit(R, num_sources: int, norm_spacing: float):
    """Unitary (real-valued) ESPRIT for a ULA (Haardt–Nossek).

    C = Re(Q_Nᴴ R Q_N) is the real forward-backward covariance (FB
    averaging is IMPLICIT — one coherent pair decorrelates for free);
    real signal subspace Es from eigh(C); real invariance
    K1 Es Υ ≈ K2 Es with [K1 | K2] = 2·[Re | Im](Q_{N−1}ᴴ J2 Q_N),
    J2 = last-(N−1)-rows selection; eigenvalues ω of Υ give
    μ = −2·arctan(ω) (the sign matches the pinned steering
    a_n = exp(−j·2πd·cosθ·n); Haardt's papers use exp(+jμn)), and
    θ = acos(μ / (2πd)). → (B, K) degrees, ascending."""
    N = R.shape[-1]
    QN = unitary_q(N)
    QN1 = unitary_q(N - 1)
    C = np.real(np.einsum("nm,bmk,kl->bnl", QN.conj().T, R, QN))
    _, v = np.linalg.eigh(C)
    Es = v[..., :, -num_sources:]                # (B, N, K) real
    J2 = np.zeros((N - 1, N))
    J2[np.arange(N - 1), np.arange(1, N)] = 1.0
    M = QN1.conj().T @ J2 @ QN
    K1, K2 = 2 * M.real, 2 * M.imag
    out = []
    for b in range(R.shape[0]):
        A1 = K1 @ Es[b]
        A2 = K2 @ Es[b]
        Ups, *_ = np.linalg.lstsq(A1, A2, rcond=None)
        lam = np.linalg.eigvals(Ups)
        mu = -2.0 * np.arctan(np.real(lam))
        ct = np.clip(mu / (2 * np.pi * norm_spacing), -1.0, 1.0)
        out.append(np.sort(np.degrees(np.arccos(ct))))
    return np.stack(out, axis=0)


def find_local_max(P, num_max_vals: int, x_min: float, x_max: float):
    """Reference find_local_max: interior local maxima of each row of
    P: (B, G), top num_max_vals by value. Returns (values, locations) each
    (B, num_max_vals); locations linearly map bin→[x_min, x_max].
    Rows with fewer maxima pad with the global max (value) / its location."""
    P = np.asarray(P)
    B, G = P.shape
    vals = np.zeros((B, num_max_vals))
    locs = np.zeros((B, num_max_vals))
    x = x_min + np.arange(G) * (x_max - x_min) / (G - 1)
    for b in range(B):
        p = P[b]
        is_max = np.zeros(G, dtype=bool)
        is_max[1:-1] = (p[1:-1] > p[:-2]) & (p[1:-1] >= p[2:])
        idx = np.nonzero(is_max)[0]
        if len(idx) == 0:
            idx = np.array([int(np.argmax(p))])
        order = np.argsort(p[idx])[::-1]
        idx = idx[order]
        take = min(num_max_vals, len(idx))
        vals[b, :take] = p[idx[:take]]
        locs[b, :take] = x[idx[:take]]
        if take < num_max_vals:  # pad with best peak
            vals[b, take:] = vals[b, 0]
            locs[b, take:] = locs[b, 0]
    return vals, locs


def subband_covariances(x, num_subbands: int, snapshot_size: int,
                        overlap: int = 0):
    """Wideband channelizer + per-subband covariances: F-point DFT of
    each F-sample frame (W[f, t] = exp(-2πj f t / F)), then windowed
    covariances of every subband stream with S/F samples per window and
    the overlap scaled by 1/F → (F, B, N, N)."""
    x = np.asarray(x)
    F = num_subbands
    M = x.shape[0] // F
    xs = np.fft.fft(x[: M * F].reshape(M, F, -1), axis=1)   # (M, F, N)
    S_sub = snapshot_size // F
    hop_sub = max(S_sub - overlap // F, 1)
    return np.stack([sample_covariance(frame_samples(
        xs[:, f], S_sub, S_sub - hop_sub)) for f in range(F)])


def wideband_music_spectrum(R_sub, A_stack, num_sources: int):
    """Incoherent wideband MUSIC: mean over subbands of the
    max-normalized per-subband spectra. R_sub (F, B, N, N), A_stack
    (F, G, N) → (B, G)."""
    return np.mean([music_spectrum(R_sub[f], A_stack[f], num_sources)
                    for f in range(len(R_sub))], axis=0)


def _refine_frac(prof, i: int) -> float:
    """Bin index i of a positive 1-D profile + the sub-bin offset of the
    parabola through its three reciprocals (clipped to ±0.5; edge bins
    are not refined)."""
    G = len(prof)
    if i == 0 or i == G - 1:
        return float(i)
    tiny = np.finfo(np.float32).tiny
    qm, q0, qp = (1.0 / max(float(prof[j]), tiny) for j in (i - 1, i, i + 1))
    den = qm - 2.0 * q0 + qp
    d = 0.5 * (qm - qp) / den if den != 0 else 0.0
    return i + float(np.clip(d, -0.5, 0.5))


def find_local_max_2d(P, num_max_vals: int, az_rng, el_rng,
                      refine: bool = False):
    """Reference 2-D peak extraction over P: (B, G_az, G_el).

    A bin is a peak iff it exceeds its up/left neighbours and is >= its
    down/right ones (edges excluded). Peaks are ranked by value, ties by
    flat index; rows with fewer peaks pad with the best one, rows with
    none take the global argmax. refine: separable reciprocal-space
    parabola along az (the column) and el (the row) through each peak.
    → (values, az, el) each (B, num_max_vals)."""
    P = np.asarray(P, np.float64)
    B, Ga, Ge = P.shape
    k = num_max_vals
    vals, az, el = (np.zeros((B, k)) for _ in range(3))
    da = (az_rng[1] - az_rng[0]) / (Ga - 1)
    de = (el_rng[1] - el_rng[0]) / (Ge - 1)
    for b in range(B):
        p = P[b]
        c = p[1:-1, 1:-1]
        is_max = np.zeros((Ga, Ge), dtype=bool)
        is_max[1:-1, 1:-1] = ((c > p[:-2, 1:-1]) & (c >= p[2:, 1:-1])
                              & (c > p[1:-1, :-2]) & (c >= p[1:-1, 2:]))
        flat = np.flatnonzero(is_max)
        if len(flat) == 0:
            flat = np.array([int(np.argmax(p))])
        flat = flat[np.argsort(-p.ravel()[flat], kind="stable")]
        flat = np.concatenate([flat[:k], np.repeat(flat[:1], k)])[:k]
        for j, f in enumerate(flat):
            ia, ie = divmod(int(f), Ge)
            vals[b, j] = p[ia, ie]
            fa = _refine_frac(p[:, ie], ia) if refine else ia
            fe = _refine_frac(p[ia, :], ie) if refine else ie
            az[b, j] = az_rng[0] + fa * da
            el[b, j] = el_rng[0] + fe * de
    return vals, az, el


# ---------------------------------------------------------------------------
# Wideband TOPS (Yoon/Kaplan/McClellan 2006) — textbook formulation
# ---------------------------------------------------------------------------

def tops_spectrum(R_sub, A_stack, num_sources: int, ref_band: int = 0,
                  normalize: bool = True):
    """Reference TOPS pseudospectrum, straight from the paper's matrices
    (loops over windows/angles/bands — the device path's scan/einsum
    algebra must match this to f32 accuracy).

    R_sub: (F, B, N, N) per-subband covariances; A_stack: (F, G, N)
    per-subband steering → P: (B, G) float64.

    Per (b, θ): U_f = Φ_f(θ)·S_r with Φ_f = diag(a_f(θ) ⊙ conj(a_r(θ)))
    (the diagonal manifold transform), projection-corrected
    U'_f = (I − â_fâ_fᴴ)U_f, D = [W_1ᴴU'_1 | …] over non-reference
    bands (W_f = noise subspace), P = 1/σ_min(D)."""
    R_sub = np.asarray(R_sub)
    A_stack = np.asarray(A_stack)
    F, B, N, _ = R_sub.shape
    K = num_sources
    _, v = np.linalg.eigh(R_sub)
    S = v[..., :, N - K:]                       # (F, B, N, K) signal
    Wn = v[..., :, : N - K]                     # (F, B, N, N-K) noise
    G = A_stack.shape[1]
    A_r = A_stack[ref_band]
    P = np.zeros((B, G))
    for b in range(B):
        for g in range(G):
            rows = []
            for f in range(F):
                if f == ref_band:
                    continue
                phi = A_stack[f, g] * np.conj(A_r[g])
                U = phi[:, None] * S[ref_band, b]          # (N, K)
                ah = A_stack[f, g] / np.linalg.norm(A_stack[f, g])
                Up = U - np.outer(ah, ah.conj() @ U)
                rows.append(Wn[f, b].conj().T @ Up)        # (N-K, K)
            D = np.concatenate(rows, axis=0)
            smin = np.linalg.svd(D, compute_uv=False)[-1]
            P[b, g] = 1.0 / max(smin ** 2, np.finfo(np.float64).tiny)
    if normalize:
        P = P / P.max(axis=-1, keepdims=True)
    return P


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def element_calibration(R, pilot_theta_deg: float, norm_spacing: float):
    """Reference calibrate_lin_array: principal eigenvector v1 of R (pilot at
    a known angle) vs ideal steering a(pilot): correction c_k = a_k / v1_k,
    normalized so element 0 has correction 1. R: (..., N, N) → c: (..., N)."""
    w, v = np.linalg.eigh(R)
    v1 = v[..., :, -1]  # principal eigenvector (largest eigenvalue)
    N = R.shape[-1]
    a = ula_steering(pilot_theta_deg, N, norm_spacing)
    c = a / v1
    return c / c[..., :1]


def phase_offset_est(x, ref_channel: int = 0):
    """Reference stage-1 calibration: per-channel phase offset vs channel 0
    while all channels receive a common tone. x: (T, N) → phi: (N,) radians.
    phi_k = arg(mean(x_k * conj(x_0)))."""
    x = np.asarray(x)
    ref = x[:, ref_channel : ref_channel + 1]
    return np.angle(np.mean(x * np.conj(ref), axis=0))


def apply_phase_correction(x, phi):
    """Multiply channel k by exp(-1j*phi_k) (reference phase_correct_hier)."""
    return x * np.exp(-1j * np.asarray(phi))


def apply_antenna_correction(x, c):
    """Multiply channel k by correction c_k (reference antenna_correction)."""
    return x * np.asarray(c)


# ---------------------------------------------------------------------------
# Synthetic signal model (reference simulation flowgraph, SURVEY §3.2)
# ---------------------------------------------------------------------------

def synthetic_ula_iq(
    theta_deg,
    num_elements: int,
    norm_spacing: float,
    num_samples: int,
    snr_db: float = 10.0,
    freqs_norm=None,
    seed: int = 0,
    correlated_pairs=(),
    amplitudes=None,
):
    """Synthesize coherent N-channel IQ: sum of complex tones arriving from
    theta_deg (list of K angles) + AWGN. Returns (T, N) complex64.

    Each source k is a unit-amplitude complex exponential at normalized
    frequency freqs_norm[k] (default: spread in (0.05, 0.45)), multiplied by
    the steering vector. snr_db is per-source per-channel SNR.
    `correlated_pairs`: list of (i, j) source index pairs forced fully
    coherent (same waveform) — for the spatial-smoothing config.
    """
    rng = np.random.default_rng(seed)
    theta = np.atleast_1d(np.asarray(theta_deg, dtype=np.float64))
    K = len(theta)
    if freqs_norm is None:
        freqs_norm = 0.05 + 0.4 * np.arange(K) / max(K - 1, 1)
    freqs_norm = np.atleast_1d(np.asarray(freqs_norm, dtype=np.float64))
    if amplitudes is None:
        amplitudes = np.ones(K)
    t = np.arange(num_samples)
    phases = rng.uniform(0, 2 * np.pi, size=K)
    wave = np.exp(1j * (2 * np.pi * freqs_norm[None, :] * t[:, None]
                        + phases[None, :]))  # (T, K)
    for (i, j) in correlated_pairs:
        wave[:, j] = wave[:, i]
    wave = wave * np.asarray(amplitudes)[None, :]
    A = ula_steering(theta, num_elements, norm_spacing)  # (K, N)
    clean = wave @ A  # (T, N)
    noise_power = 10.0 ** (-snr_db / 10.0)
    noise = rng.standard_normal((num_samples, num_elements)) + 1j * rng.standard_normal(
        (num_samples, num_elements)
    )
    noise *= np.sqrt(noise_power / 2.0)
    return (clean + noise).astype(np.complex64)
