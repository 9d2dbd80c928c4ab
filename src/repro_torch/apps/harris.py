"""Harris corner detection for UAV tracking (paper SSV-B, Fig. 7/9).

The port of ``repro.apps.harris``.  Stages: Sobel gradients
(shift-coefficient filters: exact, on the host) -> gradient products
Ixx/Iyy/Ixy (variant multiplier) -> 5x5 window sums -> the Noble measure
R = det / (trace + eps) through the variant divider (kernel K6 for the
scheme variants), all on the device.  Non-maximum suppression and the
top-N selection stay exact, on the host (comparisons only).

QoR (paper Fig. 9): the percentage of the accurate pipeline's corners
that the approximate one recovers within 2 px ("correct vectors"; >= 90%
is the paper's bar for tracking).

``python -m repro_torch.apps.harris [--device cpu]`` prints each
variant's correct-vector percentage, as the reference module does.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.apps.arith import VARIANTS, Variant
from repro_torch.device import resolve_device

__all__ = ["synthetic_scene", "harris_response", "normalized_gradients",
           "nms_top", "harris_corners", "match_fraction", "run"]


def synthetic_scene(size: int = 256, seed: int = 0) -> np.ndarray:
    """Blocks + rotated squares: plenty of unambiguous corners."""
    rng = np.random.default_rng(seed)
    img = rng.normal(0, 2.0, (size, size)).astype(np.float32)
    for _ in range(14):
        y, x = rng.integers(16, size - 48, 2)
        h, w = rng.integers(16, 40, 2)
        img[y: y + h, x: x + w] += rng.uniform(60, 160)
    img = np.clip(img, 0, 255)
    return img


def _sobel(img: np.ndarray):
    """Shift-coefficient Sobel (exact, like the PT filters)."""
    p = np.pad(img, 1, mode="edge").astype(np.float32)
    gx = (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[1:-1, :-2] - p[2:, :-2])
    gy = (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:]
          - p[:-2, :-2] - 2 * p[:-2, 1:-1] - p[:-2, 2:])
    return gx, gy


def _window_sum(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(2r+1)^2 box sums by a 2-D f32 cumsum difference, as the reference.

    torch's cumsum sums in its own order (sequential on the CPU, a scan
    on the card), XLA's in another: the sums agree to a few ulp of the
    running total, not bit for bit.
    """
    k = 2 * r + 1
    p = torch.nn.functional.pad(x, (r + 1, r, r + 1, r))
    out = torch.cumsum(torch.cumsum(p, 0), 1)
    return (out[k:, k:] - out[:-k, k:] - out[k:, :-k] + out[:-k, :-k])


def harris_response(gx: torch.Tensor, gy: torch.Tensor,
                    variant: Variant) -> torch.Tensor:
    """Products -> window sums -> Noble measure through the variant
    divider, on normalized gradients."""
    ixx = variant.mul(gx, gx)
    iyy = variant.mul(gy, gy)
    ixy = variant.mul(gx, gy)
    sxx = _window_sum(ixx)
    syy = _window_sum(iyy)
    sxy = _window_sum(ixy)
    det = variant.mul(sxx, syy) - variant.mul(sxy, sxy)
    trace = sxx + syy
    return variant.div(det, trace + 1e-3)  # Noble measure -- the div stage


def normalized_gradients(img: np.ndarray, device=None):
    """Sobel on the host, then the fixed-point rescale (a shift on the
    FPGA) on the device: (gx, gy) / 255."""
    gx, gy = _sobel(img)
    dev = resolve_device(device)
    return (torch.as_tensor(gx, device=dev) / 255.0,
            torch.as_tensor(gy, device=dev) / 255.0)


def nms_top(r: np.ndarray, n_max: int = 200) -> np.ndarray:
    """Exact 3x3 non-maximum suppression and top-N selection; [n, 2]
    (y, x) corners, strongest first."""
    rp = np.pad(r, 1, mode="constant", constant_values=-np.inf)
    is_max = np.ones_like(r, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == dx == 0:
                continue
            is_max &= r >= rp[1 + dy: 1 + dy + r.shape[0],
                              1 + dx: 1 + dx + r.shape[1]]
    cand = np.where(is_max & (r > 0.0), r, -np.inf).ravel()
    order = np.argsort(cand)[::-1][:n_max]
    order = order[np.isfinite(cand[order])]
    ys, xs = np.unravel_index(order, r.shape)
    return np.stack([ys, xs], 1)


def harris_corners(img: np.ndarray, variant: Variant, n_max: int = 200,
                   device=None) -> np.ndarray:
    gx, gy = normalized_gradients(img, device)
    return nms_top(harris_response(gx, gy, variant).cpu().numpy(), n_max)


def match_fraction(ref: np.ndarray, test: np.ndarray, tol: float = 2.0):
    if len(ref) == 0:
        return 1.0
    if len(test) == 0:
        return 0.0
    d2 = ((ref[:, None, :] - test[None, :, :]) ** 2).sum(-1)
    return float((d2.min(axis=1) <= tol * tol).mean())


def run(variants=("accurate", "rapid", "rapid5", "mitchell", "truncated"),
        n_images: int = 3, size: int = 192,
        device: Optional[str] = None) -> dict:
    out = {}
    scenes = [synthetic_scene(size, seed=s) for s in range(n_images)]
    refs = [harris_corners(img, VARIANTS["accurate"], device=device)
            for img in scenes]
    for name in variants:
        v = VARIANTS[name]
        fr = [match_fraction(ref, harris_corners(img, v, device=device))
              for img, ref in zip(scenes, refs)]
        out[name] = round(float(np.mean(fr)) * 100.0, 2)  # % correct vectors
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    for k, v in run(device=args.device).items():
        print(f"harris correct-vectors {k:10s} {v:.1f}%")


if __name__ == "__main__":
    main()
