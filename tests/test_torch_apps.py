"""The port's three applications against the JAX reference (CPU, plain
torch), on the same numpy inputs made from seeds.

Tolerances, and why:

* JPEG: PSNR within 0.05 dB of the reference per variant; >= 99.9% of
  reconstructed pixels equal for the log-domain and truncated variants
  (the log-domain arithmetic is bit-equal; the port's K1 sums one k at a
  time where the reference sums in chunks of 64, which for K = 8 is the
  same order), and within 1e-4 for the accurate variant, whose f32
  matmuls run in torch's order, not XLA's.
* Pan-Tompkins: the detected R peaks identical, sensitivity and PPV
  equal, the integrated signal's PSNR within 0.1 dB (the accurate
  variant stays ``inf``).  The window sums run in torch's order.
* Harris: per scene, the port's corners match the reference's at the
  app's 2-pixel tolerance on >= 98%, and the correct-vector percentage
  is within 1 point.  The window sums are f32 cumsum differences whose
  order differs between torch and XLA, which moves the response by up to
  ~2e-4 relative and can swap near-tied corners.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.apps import harris as jharris  # noqa: E402
from repro.apps import jpeg as jjpeg  # noqa: E402
from repro.apps import pan_tompkins as jpt  # noqa: E402
from repro.apps.arith import VARIANTS as JVARIANTS  # noqa: E402
from repro.apps.arith import psnr as jpsnr  # noqa: E402
from repro_torch.apps import harris, jpeg, pan_tompkins  # noqa: E402
from repro_torch.apps.arith import VARIANTS, psnr  # noqa: E402

ALL = ["accurate", "rapid", "rapid5", "mitchell", "truncated"]


# --------------------------------------------------------------------------
# JPEG
# --------------------------------------------------------------------------

def test_jpeg_host_helpers_copied():
    img = jjpeg.synthetic_aerial(64, seed=3)
    np.testing.assert_array_equal(jpeg.synthetic_aerial(64, seed=3), img)
    np.testing.assert_array_equal(jpeg._dct_matrix(), jjpeg._dct_matrix())
    np.testing.assert_array_equal(jpeg.QTABLE, jjpeg.QTABLE)
    blocks = jpeg._blockify(img)
    np.testing.assert_array_equal(blocks, jjpeg._blockify(img))
    np.testing.assert_array_equal(jpeg._unblockify(blocks, 64, 64), img)


@pytest.mark.parametrize("variant", ALL)
def test_jpeg_roundtrip_vs_reference(variant):
    for seed in (0, 1):
        img = jpeg.synthetic_aerial(128, seed=seed)
        ref = jjpeg.jpeg_roundtrip(img, JVARIANTS[variant])
        got = jpeg.jpeg_roundtrip(img, VARIANTS[variant], device="cpu")
        assert got.shape == ref.shape and got.dtype == np.float32
        if variant == "accurate":
            # float32 DCT matmuls in torch's order vs XLA's: pixels off
            # by a few ulp of 255 (3.1e-5 at most measured)
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        else:
            assert (got == ref).mean() >= 0.999, (got != ref).sum()
        p_ref = jpsnr(jnp.asarray(img), jnp.asarray(ref), 255.0)
        assert abs(psnr(img, got, 255.0) - p_ref) <= 0.05


def test_jpeg_round_half_to_even():
    """The quantised coefficient of an exact .5 rounds to even, as
    ``jnp.round`` does."""
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5])
    np.testing.assert_array_equal(torch.round(x).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(x.numpy()))))


# --------------------------------------------------------------------------
# Pan-Tompkins
# --------------------------------------------------------------------------

def test_pan_tompkins_host_helpers_copied():
    sig, peaks = jpt.synthetic_ecg(10, seed=4)
    tsig, tpeaks = pan_tompkins.synthetic_ecg(10, seed=4)
    np.testing.assert_array_equal(tsig, sig)
    np.testing.assert_array_equal(tpeaks, peaks)
    np.testing.assert_array_equal(pan_tompkins._bandpass_derivative(sig),
                                  jpt._bandpass_derivative(sig))
    det = np.array([210, 380, 900, 1205])
    assert pan_tompkins.score(det, peaks[:5]) == jpt.score(det, peaks[:5])


@pytest.mark.parametrize("at", [0, 50, 99])
def test_pan_tompkins_window_alignment_impulse(at):
    """The reference's convolve(mode="same") with the even 30-tap window:
    output i sums the squares at i - 15 .. i + 14 (an impulse at 50
    reaches outputs 36..65), edges included."""
    x = np.zeros(100, np.float32)
    x[at] = 1.0
    v = VARIANTS["accurate"]
    got = pan_tompkins.integrate_energy(torch.from_numpy(x), v).numpy()
    ref = np.asarray(jpt.integrate_energy(jnp.asarray(x), JVARIANTS["accurate"]))
    np.testing.assert_array_equal(np.nonzero(got)[0], np.nonzero(ref)[0])
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    if at == 50:
        assert (np.nonzero(got)[0][[0, -1]] == [36, 65]).all()


@pytest.fixture(scope="module")
def ecg():
    return jpt.synthetic_ecg(25, seed=0)


@pytest.fixture(scope="module")
def ecg_reference(ecg):
    sig, _ = ecg
    return jpt.detect_qrs(sig, JVARIANTS["accurate"])[1]


@pytest.mark.parametrize("variant", ALL)
def test_pan_tompkins_vs_reference(variant, ecg, ecg_reference):
    sig, truth = ecg
    ref_det, ref_integ = jpt.detect_qrs(sig, JVARIANTS[variant])
    det, integ = pan_tompkins.detect_qrs(sig, VARIANTS[variant], device="cpu")
    np.testing.assert_array_equal(det, ref_det)
    assert pan_tompkins.score(det, truth) == jpt.score(ref_det, truth)
    peak = float(np.max(np.abs(ecg_reference)) + 1e-9)
    p_ref = jpsnr(jnp.asarray(ecg_reference), jnp.asarray(ref_integ), peak)
    p_got = psnr(ecg_reference, integ, peak)
    if math.isinf(p_ref):
        # the accurate arm against the reference's accurate arm: the
        # window sums differ in order only
        assert variant == "accurate" and p_got > 100.0
        assert math.isinf(psnr(integ, integ, peak))
    else:
        assert abs(p_got - p_ref) <= 0.1


# --------------------------------------------------------------------------
# Harris
# --------------------------------------------------------------------------

def test_harris_host_helpers_copied(monkeypatch):
    img = jharris.synthetic_scene(96, seed=2)
    np.testing.assert_array_equal(harris.synthetic_scene(96, seed=2), img)
    for a, b in zip(harris._sobel(img), jharris._sobel(img)):
        np.testing.assert_array_equal(a, b)
    # the NMS and top-N selection on one response map: the reference's
    # harris_corners fed that map through its response function
    r = np.random.default_rng(0).standard_normal((96, 96)).astype(np.float32)
    r[10, 10:13] = 5.0  # a plateau: ties
    monkeypatch.setattr(jharris, "harris_response",
                        lambda gx, gy, v: jnp.asarray(r))
    for n_max in (30, 200):
        np.testing.assert_array_equal(
            harris.nms_top(r, n_max),
            jharris.harris_corners(img, JVARIANTS["rapid"], n_max))
    a = np.array([[1, 1], [10, 10]])
    assert harris.match_fraction(a, a + 1) == jharris.match_fraction(a, a + 1)


def test_harris_window_sum_within_ulps():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((50, 70)).astype(np.float32)
    ref = np.asarray(jharris._window_sum(jnp.asarray(x)))
    got = harris._window_sum(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    # a cumsum difference: the error scales with the running total
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-6 * float(np.abs(x).sum()))


@pytest.fixture(scope="module")
def scenes():
    imgs = [jharris.synthetic_scene(160, seed=s) for s in range(3)]
    refs = [jharris.harris_corners(img, JVARIANTS["accurate"]) for img in imgs]
    return imgs, refs


@pytest.mark.parametrize("variant", ALL)
def test_harris_vs_reference(variant, scenes):
    imgs, refs = scenes
    fr_ref, fr_got = [], []
    for img, ref_acc in zip(imgs, refs):
        ref = jharris.harris_corners(img, JVARIANTS[variant])
        got = harris.harris_corners(img, VARIANTS[variant], device="cpu")
        assert harris.match_fraction(ref, got, tol=2.0) >= 0.98
        fr_ref.append(jharris.match_fraction(ref_acc, ref))
        fr_got.append(harris.match_fraction(ref_acc, got))
    assert abs(np.mean(fr_got) - np.mean(fr_ref)) * 100.0 <= 1.0


# --------------------------------------------------------------------------
# the QoR gates of tests/test_apps_qor.py, on the port
# --------------------------------------------------------------------------

def test_port_jpeg_qor_gates():
    s = jpeg.run(("accurate", "rapid", "mitchell"), n_images=2, size=128,
                 device="cpu")
    assert s["rapid"] >= 28.0
    assert s["accurate"] - s["rapid"] < 2.5
    assert s["rapid"] > s["mitchell"] + 2.0


def test_port_pan_tompkins_qor_gates():
    res = pan_tompkins.run(("accurate", "rapid", "mitchell"), n_beats=25,
                           device="cpu")
    assert res["rapid"]["sensitivity"] >= 0.95
    assert res["rapid"]["ppv"] >= 0.95
    assert res["rapid"]["psnr_vs_accurate_db"] >= 28.0
    assert (res["rapid"]["psnr_vs_accurate_db"]
            > res["mitchell"]["psnr_vs_accurate_db"])


def test_port_harris_qor_gates():
    res = harris.run(("accurate", "rapid", "truncated"), n_images=2, size=128,
                     device="cpu")
    assert res["rapid"] >= 90.0
    assert res["rapid"] > res["truncated"]


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("app", ["jpeg", "harris", "pan_tompkins"])
def test_entry_points_default_to_cuda(app, monkeypatch):
    """``run()`` asks for ``cuda`` unless told otherwise; without a card
    that raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"jpeg": jpeg, "harris": harris, "pan_tompkins": pan_tompkins}[app]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run(("rapid",), **({"n_beats": 3} if app == "pan_tompkins"
                              else {"n_images": 1, "size": 96}))


def test_entry_point_prints_reference_lines(capsys):
    pan_tompkins.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["pan-tompkins", v]
                                                for v in ALL]
