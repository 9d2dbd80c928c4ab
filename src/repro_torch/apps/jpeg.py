"""JPEG compression pipeline (paper SSV-B, Fig. 6/8).

The port of ``repro.apps.jpeg``.  Stages: 8x8 blockwise 2D-DCT (matrix
form) with the variant multiplier, quantisation with the variant
*divider*, dequant with the variant multiplier, inverse DCT.
Zigzag/Huffman are lossless and excluded, as in the paper; they do not
affect PSNR.  Input images are procedural aerial-like terrain (numpy,
from a seed).

On the device: the four DCT products run as one batched K1 launch each
(``qmatmul_batched``), with the DCT basis broadcast over the blocks as a
stride-0 ``expand``, and the quantisation divide as one K6 launch.

``python -m repro_torch.apps.jpeg [--device cpu]`` prints each variant's
PSNR, as the reference module does.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.apps.arith import VARIANTS, Variant, psnr
from repro_torch.device import resolve_device

__all__ = ["QTABLE", "synthetic_aerial", "roundtrip_blocks", "jpeg_roundtrip",
           "run"]

# standard JPEG luminance quantisation table
QTABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)


def _dct_matrix(n: int = 8) -> np.ndarray:
    k = np.arange(n)
    c = np.sqrt(2.0 / n) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi
                                  / (2 * n))
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


def synthetic_aerial(size: int = 512, seed: int = 0) -> np.ndarray:
    """Procedural terrain: multi-octave value noise + roads/field edges."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size), np.float32)
    for octave in range(1, 6):
        n = min(2 ** octave * 4, size)
        coarse = rng.normal(size=(n, n))
        rep = -(-size // n)  # ceil: cover any size, then crop
        up = np.kron(coarse, np.ones((rep, rep)))
        img += up[:size, :size] / octave
    # field boundaries (straight lines) and a few bright structures
    for _ in range(12):
        o = rng.integers(0, size)
        if rng.random() < 0.5:
            img[o: o + 2, :] += 2.0
        else:
            img[:, o: o + 2] += 2.0
    for _ in range(20):
        y, x = rng.integers(16, size - 16, 2)
        img[y - 3: y + 3, x - 3: x + 3] += rng.uniform(2, 4)
    img = img - img.min()
    img = img / img.max() * 255.0
    return img.astype(np.float32)


def _blockify(img: np.ndarray, n: int = 8) -> np.ndarray:
    h, w = img.shape
    return (img.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)
            .reshape(-1, n, n))


def _unblockify(blocks: np.ndarray, h: int, w: int, n: int = 8) -> np.ndarray:
    return (blocks.reshape(h // n, w // n, n, n).transpose(0, 2, 1, 3)
            .reshape(h, w))


def roundtrip_blocks(blocks: torch.Tensor, variant: Variant,
                     q: torch.Tensor) -> torch.Tensor:
    """DCT -> quant -> dequant -> IDCT on [N, 8, 8] centred f32 blocks."""
    C = torch.as_tensor(_dct_matrix(), device=blocks.device)
    Ct = C.T.contiguous()  # so that its stride-0 broadcast needs no copy

    def mm(a, b):  # 2D DCT: C @ X @ C^T, through the variant multiplier
        return variant.matmul_batched(
            a, b.expand(a.shape[:-2] + b.shape[-2:]))

    nb = blocks.shape[:1]
    coef = mm(mm(C.expand(nb + C.shape), blocks), Ct)
    # quantisation: the division stage (paper: the div-included stage)
    quant = torch.round(variant.div(coef, q[None]))
    # dequant (multiplier)
    dq = variant.mul(quant, q[None])
    rec = mm(mm(Ct.expand(nb + C.shape), dq), C)
    return torch.clamp(rec + 128.0, 0, 255)


def jpeg_roundtrip(img: np.ndarray, variant: Variant,
                   quality_scale: float = 1.0, device=None) -> np.ndarray:
    """Compress + decompress with the variant's mul/div; returns the
    reconstructed image (numpy, f32)."""
    dev = resolve_device(device)
    q = torch.as_tensor(QTABLE * quality_scale, device=dev)
    blocks = torch.as_tensor(_blockify(img), device=dev) - 128.0
    rec = roundtrip_blocks(blocks, variant, q)
    return _unblockify(rec.cpu().numpy(), *img.shape)


def run(variants=("accurate", "rapid", "rapid5", "mitchell", "truncated"),
        n_images: int = 3, size: int = 256,
        device: Optional[str] = None) -> dict:
    """PSNR of each variant vs the original images (paper Fig. 8)."""
    out = {}
    imgs = [synthetic_aerial(size, seed=s) for s in range(n_images)]
    for name in variants:
        v = VARIANTS[name]
        vals = [psnr(img, jpeg_roundtrip(img, v, device=device), 255.0)
                for img in imgs]
        out[name] = float(np.mean(vals))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    for k, v in run(device=args.device).items():
        print(f"jpeg psnr {k:10s} {v:.2f} dB")


if __name__ == "__main__":
    main()
