"""Pan-Tompkins QRS (heartbeat) detection (paper SSV-B, Fig. 5).

The port of ``repro.apps.pan_tompkins``.  Stages: bandpass (cascaded
LP+HP integer filters) -> derivative -> *squaring* (variant multiplier)
-> moving-window integration (its mean's divide through the variant
divider, kernel K6 for the scheme variants) -> adaptive thresholding.

Every coefficient of the PT filters is a power of two (shifts on the
FPGA), so the filters run exactly, on the host in numpy as in the
reference; the approximate units sit where real multipliers/dividers
do: the squaring and the integration mean, on the device.  QoR: QRS
sensitivity/PPV against ground truth, and the PSNR of the integrated
signal against the accurate pipeline (paper gate: >= 28 dB).

The ECG is synthetic (numpy, from a seed): Gaussian-bump P-QRS-T
complexes with beat-to-beat jitter, baseline wander and noise, with
known R-peak locations.

``python -m repro_torch.apps.pan_tompkins [--device cpu]`` prints each
variant's scores, as the reference module does.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.apps.arith import VARIANTS, Variant, psnr
from repro_torch.device import resolve_device

__all__ = ["FS", "WINDOW", "synthetic_ecg", "integrate_energy", "detect_qrs",
           "find_peaks", "score", "run"]

FS = 200  # Hz, the original Pan-Tompkins design rate
WINDOW = int(0.15 * FS)  # ~150 ms integration window (30 samples)


def synthetic_ecg(n_beats: int = 60, seed: int = 0):
    """Returns (signal, r_peak_indices)."""
    rng = np.random.default_rng(seed)
    rr = rng.normal(0.85, 0.08, n_beats).clip(0.55, 1.3)  # seconds
    peaks = np.cumsum(rr * FS).astype(int) + FS
    n = int(peaks[-1] + 2 * FS)
    t = np.arange(n, dtype=np.float32)
    sig = np.zeros(n, np.float32)

    def bump(center, width, amp):
        return amp * np.exp(-0.5 * ((t - center) / width) ** 2)

    for p in peaks:
        a = rng.normal(1.0, 0.1)
        sig += bump(p - 0.04 * FS, 0.02 * FS, -0.15 * a)   # Q
        sig += bump(p, 0.012 * FS, 1.0 * a)                # R
        sig += bump(p + 0.05 * FS, 0.025 * FS, -0.2 * a)   # S
        sig += bump(p - 0.18 * FS, 0.04 * FS, 0.15 * a)    # P
        sig += bump(p + 0.3 * FS, 0.06 * FS, 0.3 * a)      # T
    sig += 0.1 * np.sin(2 * np.pi * 0.3 * t / FS)          # baseline wander
    sig += rng.normal(0, 0.03, n).astype(np.float32)       # noise
    return sig.astype(np.float32), peaks


def _bandpass_derivative(x: np.ndarray) -> np.ndarray:
    """PT LP+HP+derivative with power-of-two (shift) coefficients: exact."""
    n = len(x)
    lp = np.zeros(n, np.float64)
    for i in range(n):  # y = 2y1 - y2 + x - 2x6 + x12
        lp[i] = (2 * lp[i - 1] - lp[i - 2]) if i >= 2 else 0.0
        lp[i] += x[i]
        if i >= 6:
            lp[i] -= 2 * x[i - 6]
        if i >= 12:
            lp[i] += x[i - 12]
    hp = np.zeros(n, np.float64)
    for i in range(n):  # y = y1 - x/32 + x16 - x17 + x32/32
        hp[i] = hp[i - 1] if i >= 1 else 0.0
        hp[i] -= lp[i] / 32.0
        if i >= 16:
            hp[i] += lp[i - 16]
        if i >= 17:
            hp[i] -= lp[i - 17]
        if i >= 32:
            hp[i] += lp[i - 32] / 32.0
    der = np.zeros(n, np.float64)
    for i in range(n):  # (2x + x1 - x3 - 2x4)/8
        v = 2 * hp[i]
        if i >= 1:
            v += hp[i - 1]
        if i >= 3:
            v -= hp[i - 3]
        if i >= 4:
            v -= 2 * hp[i - 4]
        der[i] = v / 8.0
    return der.astype(np.float32)


def integrate_energy(der: torch.Tensor, variant: Variant) -> torch.Tensor:
    """Squaring through the variant multiplier, then the moving-window
    mean, whose divide runs the variant divider.

    The window sum has the reference's ``convolve(mode="same")``
    alignment for the even 30-tap window: output i sums the squares at
    i - 15 .. i + 14, so the signal is padded 15 on the left and 14 on
    the right.  Each sum runs over its 30 taps in one reduction (no
    cuDNN, so the same sums on every call).
    """
    sq = variant.mul(der, der)  # squaring -- the multiplier hot spot
    pad = torch.nn.functional.pad(sq, (WINDOW // 2, (WINDOW - 1) // 2))
    acc = pad.unfold(0, WINDOW, 1).sum(dim=-1)
    return variant.div(acc, torch.full_like(acc, float(WINDOW)))


def detect_qrs(sig: np.ndarray, variant: Variant, device=None):
    """Returns (detected_peak_indices, integrated_signal)."""
    der = _bandpass_derivative(sig)
    integ = integrate_energy(torch.as_tensor(der, device=resolve_device(device)),
                             variant)
    integ_np = integ.cpu().numpy()
    return find_peaks(integ_np), integ_np


def find_peaks(integ_np: np.ndarray) -> np.ndarray:
    """Adaptive threshold, refractory period and group-delay correction
    on the integrated signal (host, exact): the R-peak indices."""
    thr = 0.3 * np.median(np.sort(integ_np)[-max(len(integ_np) // 20, 1):])
    above = integ_np > thr
    peaks = []
    refractory = int(0.25 * FS)
    # cascade group delay: LP (12-1)/2 + HP (32-1)/2 + derivative 2 + MWI
    # peak skew -- constant for the fixed filter bank
    delay = 29
    i = 0
    while i < len(above):
        if above[i]:
            j = i
            while j < len(above) and above[j]:
                j += 1
            peaks.append(max(i + int(np.argmax(integ_np[i:j])) - delay, 0))
            i = j + refractory
        else:
            i += 1
    return np.asarray(peaks)


def score(det: np.ndarray, truth: np.ndarray, tol: float = 0.1):
    """Sensitivity and positive predictivity with +-tol s matching."""
    tol_n = int(tol * FS)
    used = np.zeros(len(det), bool)
    tp = 0
    for p in truth:
        if len(det) == 0:
            break
        d = np.abs(det - p)
        j = int(np.argmin(np.where(used, 10 ** 9, d)))
        if d[j] <= tol_n and not used[j]:
            used[j] = True
            tp += 1
    fn = len(truth) - tp
    fp = len(det) - tp
    return tp / max(tp + fn, 1), tp / max(tp + fp, 1)


def run(variants=("accurate", "rapid", "rapid5", "mitchell", "truncated"),
        n_beats: int = 40, seed: int = 0, device: Optional[str] = None) -> dict:
    sig, truth = synthetic_ecg(n_beats, seed)
    _, ref_integ = detect_qrs(sig, VARIANTS["accurate"], device)
    out = {}
    for name in variants:
        det, integ = detect_qrs(sig, VARIANTS[name], device)
        se, ppv = score(det, truth)
        p = psnr(ref_integ, integ, float(np.max(np.abs(ref_integ)) + 1e-9))
        out[name] = {"sensitivity": round(se, 4), "ppv": round(ppv, 4),
                     "psnr_vs_accurate_db": round(p, 2)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    for k, v in run(device=args.device).items():
        print(f"pan-tompkins {k:10s} {v}")


if __name__ == "__main__":
    main()
