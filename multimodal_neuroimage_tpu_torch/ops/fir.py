"""The on-device FIR gear: band split, z-score and pad of a batch of raw fMRI
series (counterpart of multimodal_neuroimage_tpu/ops/fir.py
``fir_bandsplit_batch``).

The raw (ROI, T) series of a batch go to the device once, zero-filled to a
fixed ``t_max``, with their native lengths (350-361 TRs for ABCD), and one
program of plain tensor operations makes every band:

    odd extension -> zero-phase FIR (forward and backward valid
    correlations) -> residual split -> masked z-score -> symmetric pad

Variable lengths are handled with gathers and masks at static shapes, so
one set of shapes serves every subject. The result is
``scipy.signal.filtfilt`` (odd padding, padlen 3 * ntaps) of the host gear
(data/filters.py) to ~1e-5.

The JAX package computes this outside any Pallas kernel (XLA convolutions
and gathers), so the port runs it as plain PyTorch: ``conv1d`` for the two
correlations, never in TF32 (the JAX conv asks for ``Precision.HIGHEST``;
cuDNN would take TF32 by default).

Two departures from the JAX function, each where it disagrees with the host
gear it reproduces:

- The split runs in float64 (float32 in, float32 out). The ultralow band is
  the residual of the input minus two 65-tap passes, z-scored by its own
  small deviation, which multiplies the passes' float32 rounding: JAX's own
  float32 gear is 0.5-2.6e-4 off the host's float64 split on its test
  series (tests/test_filters.py's generator, seeds 0-7), float64 2e-5 at
  most. The two passes are ~70 MFLOP for a batch of four 84-ROI series.
- The whole-array z-score of ``global_zscore_raw`` counts the valid
  elements of every ROI (R * T). The JAX ``masked_zscore`` broadcasts its
  (1, t_max) mask over the ROIs in the sums of values only, so it divides
  by T and leaves the raw band of ``fmri_type="timeseries"`` off the host
  gear's by the factor R in its mean (ROADMAP F3).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.data.filters import design_highpass_fir


def masked_zscore(x: torch.Tensor, mask: torch.Tensor, dim,
                  eps: float = 1e-12) -> torch.Tensor:
    """z-score (ddof 0) over the True region of ``mask`` (broadcast to
    ``x``) along ``dim``."""
    m = mask.to(x.dtype).expand_as(x)
    n = m.sum(dim=dim, keepdim=True)
    mean = (x * m).sum(dim=dim, keepdim=True) / n
    var = ((x - mean) ** 2 * m).sum(dim=dim, keepdim=True) / n
    return (x - mean) * torch.rsqrt(var + eps)


def _correlate_valid(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation along the last axis of (B, R, L):
    y[j] = sum_k b[k] x[j + M - k], M = ntaps - 1 (an lfilter step whose
    first M samples act as initial conditions)."""
    B, R, L = x.shape
    y = F.conv1d(x.reshape(B * R, 1, L), taps.flip(0)[None, None, :])
    return y.reshape(B, R, -1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, r, idx[b, j]] for (B, R, L) x and (B, J) idx."""
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


def _filtfilt_fixed(x: torch.Tensor, T: torch.Tensor, taps: torch.Tensor,
                    t_max: int) -> torch.Tensor:
    """Zero-phase FIR filtering of (B, R, t_max) buffers whose first ``T``
    (B, 1) columns are valid: scipy.signal.filtfilt(b, 1, x) with odd
    extension, padlen = 3 * ntaps and steady-state initial conditions."""
    ntaps = taps.shape[0]
    m = ntaps - 1
    padlen = 3 * ntaps
    ext_len = t_max + 2 * padlen
    j = torch.arange(ext_len, device=x.device)[None, :]
    front = j < padlen
    mid = (j >= padlen) & (j < padlen + T)
    back = (j >= padlen + T) & (j < 2 * padlen + T)
    idx = torch.where(front, padlen - j,
                      torch.where(mid, j - padlen, T - 2 - (j - padlen - T)))
    vals = _take(x, idx.clamp(0, t_max - 1))                # (B, R, ext_len)
    x0 = x[:, :, 0:1]
    xlast = _take(x, (T - 1).clamp(0, t_max - 1))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ext = torch.where(front[:, None], 2.0 * x0 - vals,
                      torch.where(mid[:, None], vals,
                                  torch.where(back[:, None],
                                              2.0 * xlast - vals, zero)))
    l_valid = T + 2 * padlen
    inside = (j < l_valid)[:, None]
    ridx = (l_valid - 1 - j).clamp(0, ext_len - 1)
    # forward pass: steady-state initial conditions are m copies of ext[0]
    y = _correlate_valid(torch.cat([ext[:, :, :1].expand(-1, -1, m), ext],
                                   dim=2), taps)
    yr = torch.where(inside, _take(y, ridx), zero)          # reversed
    z = _correlate_valid(torch.cat([yr[:, :, :1].expand(-1, -1, m), yr],
                                   dim=2), taps)
    zf = torch.where(inside, _take(z, ridx), zero)
    return zf[:, :, padlen:padlen + t_max]


def _place_padded(band: torch.Tensor, T: torch.Tensor,
                  t_max: int) -> torch.Tensor:
    """(B, R, t_max) bands, first T valid, in the padded layout: (t_max - T)
    // 2 zeros in front, time-major (B, t_max, R)."""
    front = (t_max - T) // 2
    t = torch.arange(t_max, device=band.device)[None, :]
    valid = ((t >= front) & (t < front + T))[:, None].to(band.dtype)
    return (_take(band, (t - front).clamp(0, t_max - 1)) * valid).transpose(
        1, 2).contiguous()


def fir_bandsplit_batch(x: torch.Tensor, lengths: torch.Tensor,
                        t_max: int = 368, lb_hz: float = 0.0035,
                        tr_seconds: float = 0.8, fir_order: int = 64,
                        global_zscore_raw: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """Band-split a batch of raw series where they lie.

    x: (B, R, t_max), zero beyond each native length; lengths: (B,) native
    lengths. Returns {"raw", "low", "ultralow"}: (B, t_max, R) in x's dtype
    (computed in float64), each z-scored per ROI over the native extent
    (``raw`` over the whole valid array where ``global_zscore_raw``) and
    symmetrically zero-padded, as the host gear's per-item split."""
    out_dtype = x.dtype
    x = x.to(torch.float64)
    taps = torch.as_tensor(design_highpass_fir(fir_order, lb_hz,
                                               1.0 / tr_seconds),
                           dtype=torch.float64, device=x.device)
    T = lengths.to(device=x.device, dtype=torch.int64)[:, None]   # (B, 1)
    tmask = (torch.arange(t_max, device=x.device)[None, :] < T)[:, None]
    x = x * tmask.to(x.dtype)
    high = _filtfilt_fixed(x, T, taps, t_max)              # "low" (>= lb Hz)
    bands = {"raw": masked_zscore(x, tmask,
                                  (1, 2) if global_zscore_raw else 2),
             "low": masked_zscore(high, tmask, 2),
             "ultralow": masked_zscore(x - high, tmask, 2)}
    return {k: _place_padded(v, T, t_max).to(out_dtype)
            for k, v in bands.items()}
