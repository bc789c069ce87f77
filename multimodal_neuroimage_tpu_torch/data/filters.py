"""Host-side (numpy/scipy) fMRI preprocessing: FIR band split, zscore, pad.

Reimplements the behavior the reference obtains from nitime's FilterAnalyzer /
SpectralAnalyzer at data-load time (reference datasets.py:233-307):

 * ``FilterAnalyzer(TimeSeries(y, sampling_interval=0.8), lb=0.0035)``:
   zero-phase (filtfilt) FIR **highpass** at ``lb`` Hz, order 64 (65 taps),
   hamming window.  The "low" band is the filtered (>= lb Hz) signal; the
   "ultralow" band is the residual ``raw - low`` (< lb Hz)
   (datasets.py:276-283).
 * ``Boxcar`` variant: iterated moving-average smoothing; highpass is
   ``raw - smoothed`` (datasets.py:281-283; nitime boxcar_filter semantics).
 * per-ROI zscore (axis=1) for band outputs, global zscore (axis=None) for the
   plain timeseries mode (datasets.py:228, 277-283).
 * symmetric zero padding of the time axis to the static sequence length
   (``pad//2`` front, rest back — datasets.py:222-229), then transpose to
   (time, ROI).

The port's own copy of multimodal_neuroimage_tpu/data/filters.py (numpy and
scipy only); tests/test_torch_hcp.py holds ``preprocess_fmri_host`` equal to
the JAX package's for every ``fmri_type``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, Optional

import numpy as np
from scipy import signal


@lru_cache(maxsize=16)
def design_highpass_fir(order: int = 64, lb_hz: float = 0.0035,
                        fs_hz: float = 1.25, window: str = "hamming") -> np.ndarray:
    """65-tap linear-phase FIR highpass at ``lb_hz`` (nitime FilterAnalyzer.fir
    semantics with ub=None: only the low-cut is applied)."""
    nyq = fs_hz / 2.0
    taps = signal.firwin(order + 1, lb_hz / nyq, window=window, pass_zero=False)
    return taps.astype(np.float64)


def filtfilt_fir(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Zero-phase FIR filtering along the last axis (scipy filtfilt defaults:
    odd-extension padding, padlen = 3 * ntaps)."""
    return signal.filtfilt(taps, [1.0], x, axis=-1, padlen=3 * len(taps))


def boxcar_smooth(x: np.ndarray, n_points: int, iterations: int = 2) -> np.ndarray:
    """Iterated moving-average lowpass (nitime boxcar_filter).

    The window is clamped to the series length: at the default 0.0035 Hz
    cutoff the one-period window is 357 samples, LONGER than typical ABCD
    series (350-361) — ``np.convolve(mode='same')`` would then return the
    kernel's length and crash the band split."""
    n_points = max(min(int(n_points), x.shape[-1]), 1)
    kern = np.ones(n_points) / n_points
    out = x
    for _ in range(iterations):
        out = np.apply_along_axis(
            lambda m: np.convolve(m, kern, mode="same"), -1, out)
    return out


def zscore(x: np.ndarray, axis: Optional[int] = None, eps: float = 0.0) -> np.ndarray:
    """scipy.stats.zscore semantics (ddof=0)."""
    mean = x.mean(axis=axis, keepdims=True)
    std = x.std(axis=axis, keepdims=True)
    return (x - mean) / (std + eps)


def pad_time_axis(x: np.ndarray, target_len: int) -> np.ndarray:
    """Symmetric zero pad of the last (time) axis to ``target_len``
    (datasets.py:222-229: front gets pad//2)."""
    pad = target_len - x.shape[-1]
    if pad < 0:
        raise ValueError(f"time axis {x.shape[-1]} exceeds target {target_len}")
    widths = [(0, 0)] * (x.ndim - 1) + [(pad // 2, pad - pad // 2)]
    return np.pad(x, widths, mode="constant")


def bandsplit(y: np.ndarray, filtering_type: str = "FIR", lb_hz: float = 0.0035,
              tr_seconds: float = 0.8, fir_order: int = 64) -> Dict[str, np.ndarray]:
    """Split a (ROI, T) series into raw / low (>=lb) / ultralow (<lb) bands,
    each per-ROI z-scored (datasets.py:272-283)."""
    fs = 1.0 / tr_seconds
    if filtering_type == "FIR":
        taps = design_highpass_fir(fir_order, lb_hz, fs)
        high = filtfilt_fir(y.astype(np.float64), taps)
    elif filtering_type == "Boxcar":
        # nitime boxcar highpass: subtract an iterated moving average whose
        # width is one low-cut period (fs / lb samples).
        high = y - boxcar_smooth(y.astype(np.float64), round(fs / lb_hz))
    else:
        raise ValueError(f"unknown filtering_type {filtering_type}")
    return {
        "raw": zscore(y.astype(np.float64), axis=1),
        "low": zscore(high, axis=1),
        "ultralow": zscore(y - high, axis=1),
        # un-zscored components: the frequency-domain modes FFT the raw
        # filtered signal, not the z-scored one (datasets.py:314-319,
        # 331-336) — returned here so they use the SAME configured filter
        # (a separate recompute once hardcoded FIR defaults regardless of
        # filtering_type/lb_hz/tr_seconds/fir_order)
        "low_unscored": high,
        "ultralow_unscored": y - high,
    }


def sinc_resample(x: np.ndarray, orig_freq: int = 3, new_freq: int = 1,
                  lowpass_filter_width: int = 6,
                  rolloff: float = 0.99) -> np.ndarray:
    """Polyphase windowed-sinc resampling along the last axis.

    Reimplements torchaudio's ``resample(..., resampling_method=
    'sinc_interpolation')`` semantics (used by the reference for the
    compressed ultralow stream, datasets.py:259-269: orig_freq=3, new_freq=1)
    without the torchaudio dependency: a Hann^2-windowed sinc lowpass at
    ``rolloff * min(freqs)``, evaluated per output phase.
    """
    from math import gcd
    g = gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    base_freq = min(orig, new) * rolloff
    width = int(np.ceil(lowpass_filter_width * orig / base_freq))

    idx = np.arange(-width, width + orig, dtype=np.float64) / orig
    t = (-np.arange(new)[:, None] / new + idx[None, :]) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t_pi = t * np.pi
    kernel = np.where(t_pi == 0, 1.0, np.sin(t_pi) / np.where(t_pi == 0, 1.0,
                                                              t_pi))
    kernel = kernel * window * (base_freq / orig)          # (new, K)

    T = x.shape[-1]
    num_out = int(np.ceil(T * new / orig))
    lead = x.reshape(-1, T)
    padded = np.pad(lead, ((0, 0), (width, width + orig)))
    out = np.zeros((lead.shape[0], num_out), dtype=np.float64)
    K = kernel.shape[1]
    for phase in range(new):
        conv = np.stack([padded[:, j * orig: j * orig + K] @ kernel[phase]
                         for j in range((num_out - phase + new - 1) // new)],
                        axis=1)
        out[:, phase::new] = conv[:, : out[:, phase::new].shape[1]]
    return out.reshape(*x.shape[:-1], num_out)


def spectrum_magnitude(y: np.ndarray, drop_dc: bool = False) -> np.ndarray:
    """|FFT| over time, positive frequencies only (nitime
    SpectralAnalyzer.spectrum_fourier — datasets.py:233-241, 308-341).

    Returns (ROI, T//2 + 1) or with the DC bin dropped when ``drop_dc``.
    """
    n = y.shape[-1]
    spec = np.abs(np.fft.fft(y, axis=-1)[..., : n // 2 + 1])
    return spec[..., 1:] if drop_dc else spec


def preprocess_fmri_host(
    y: np.ndarray,
    fmri_type: str,
    sequence_length: int = 368,
    filtering_type: str = "FIR",
    lb_hz: float = 0.0035,
    tr_seconds: float = 0.8,
    fir_order: int = 64,
    feature_map_gen: str = "no",
    feature_map_size: str = "same",
) -> Dict[str, np.ndarray]:
    """Full host preprocessing of one subject's (ROI, T) series for a given
    ``fmri_type``; returns float32 arrays shaped (sequence_length_or_184, ROI)
    keyed exactly like the reference's per-item dicts (datasets.py:227-365).

    ``feature_map_gen == 'resample'`` compresses the ultralow band 3:1 with
    windowed-sinc resampling and pads to 128 (datasets.py:258-269, 295-301;
    for divided_frequency only together with feature_map_size='different').
    """
    out: Dict[str, np.ndarray] = {}

    def _finish(arr: np.ndarray, target: int) -> np.ndarray:
        return pad_time_axis(arr, target).T.astype(np.float32)

    def _resample_ul(ul: np.ndarray) -> np.ndarray:
        return _finish(sinc_resample(ul, orig_freq=3, new_freq=1), 128)

    if fmri_type == "timeseries":
        out["fmri_sequence"] = _finish(zscore(y, axis=None), sequence_length)
    elif fmri_type == "frequency":
        spec = zscore(spectrum_magnitude(y), axis=None)
        out["fmri_sequence"] = _finish(spec, 184)
    elif fmri_type in ("time_domain_low", "time_domain_ultralow",
                       "divided_frequency"):
        bands = bandsplit(y, filtering_type, lb_hz, tr_seconds, fir_order)
        if fmri_type == "time_domain_low":
            out["fmri_sequence"] = _finish(bands["low"], sequence_length)
        elif fmri_type == "time_domain_ultralow":
            if feature_map_gen == "resample":
                out["fmri_sequence"] = _resample_ul(bands["ultralow"])
            else:
                out["fmri_sequence"] = _finish(bands["ultralow"],
                                               sequence_length)
        else:
            out["fmri_sequence"] = _finish(bands["raw"], sequence_length)
            out["fmri_lowfreq_sequence"] = _finish(bands["low"], sequence_length)
            if feature_map_gen == "resample" and feature_map_size == "different":
                out["fmri_ultralowfreq_sequence"] = _resample_ul(
                    bands["ultralow"])
            else:
                out["fmri_ultralowfreq_sequence"] = _finish(bands["ultralow"],
                                                            sequence_length)
    elif fmri_type == "frequency_domain_low":
        bands = bandsplit(y, filtering_type, lb_hz, tr_seconds, fir_order)
        low_unscored = bands["low_unscored"]
        out["fmri_sequence"] = _finish(spectrum_magnitude(low_unscored,
                                                          drop_dc=True), 184)
    elif fmri_type == "frequency_domain_ultralow":
        bands = bandsplit(y, filtering_type, lb_hz, tr_seconds, fir_order)
        ul_unscored = bands["ultralow_unscored"]
        out["fmri_sequence"] = _finish(spectrum_magnitude(ul_unscored,
                                                          drop_dc=True), 184)
    elif fmri_type == "timeseries_and_frequency":
        bands = bandsplit(y, filtering_type, lb_hz, tr_seconds, fir_order)
        out["fmri_lowfreq_sequence"] = _finish(bands["low"], sequence_length)
        ul_unscored = bands["ultralow_unscored"]
        out["fmri_ultralowfreq_sequence"] = _finish(
            spectrum_magnitude(ul_unscored, drop_dc=True), 184)
    else:
        raise ValueError(f"unknown fmri_type {fmri_type}")
    return out
