"""The port's camera-motion compensation (`tamtr_torch/trackers/gmc.py`,
`tamtr_torch/data/imgproc.py`'s tensor pieces) against cv2 as the JAX
package calls it, and against `tamtr_tpu.trackers.bot_sort.GMC`, on the CPU.

Frames are 320x240 views of a seeded textured canvas, moved between frames
by a pan, a small rotation or a zoom (cv2.warpAffine of the canvas). The
pieces whose cv2 arithmetic is integer (gray, the 8-bit blurs, resize,
pyrDown, Scharr) are bitwise cv2's; the float ones agree to a few float32
ulps. Each method's map agrees with the JAX package's: sparseOptFlow and
ecc within 0.05 px (translation, in frame pixels) and 1e-3 (linear part),
orb and sift within 0.25 px and 5e-3 and within 0.5 px of the true motion
at the frame's centre.
"""

import cv2
import numpy as np
import pytest
import torch

from tamtr_torch.data import imgproc
from tamtr_torch.trackers import gmc
from torch_engine_data import one_thread  # noqa: F401

H0, W0 = 240, 320


def canvas(seed: int = 0, h: int = 480, w: int = 640) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    return cv2.add(img, rng.integers(0, 40, (h, w, 3), np.uint8))


CANVAS = canvas()


def view(k: int, dx: float, dy: float, rot: float = 0.0, zoom: float = 1.0) -> np.ndarray:
    """(2, 3) map from frame k's pixels to the canvas: k steps of the motion
    about the frame's centre, from an offset of (160, 120)."""
    a, s = np.deg2rad(rot * k), zoom ** k
    c = np.array([W0 / 2, H0 / 2])
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]) * s
    t = np.array([160 + dx * k, 120 + dy * k]) + c - R @ c
    return np.hstack([R, t[:, None]])


def frame(M: np.ndarray) -> np.ndarray:
    return cv2.warpAffine(CANVAS, M.astype(np.float32), (W0, H0), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)


def true_motion(M0: np.ndarray, M1: np.ndarray) -> np.ndarray:
    """The (2, 3) map from frame 0's pixels to frame 1's."""
    sq = lambda M: np.vstack([M, [0, 0, 1]])
    return (np.linalg.inv(sq(M1)) @ sq(M0))[:2]


def gray_of(M: np.ndarray, ds: int = 2) -> np.ndarray:
    g = cv2.cvtColor(frame(M), cv2.COLOR_BGR2GRAY)
    return cv2.resize(g, (W0 // ds, H0 // ds)) if ds > 1 else g


@pytest.mark.parametrize("shape", [(120, 160), (61, 83), (7, 5)])
def test_image_pieces_match_cv2(shape):
    rng = np.random.default_rng(shape[1])
    img = rng.integers(0, 256, shape + (3,), np.uint8)
    g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    tg = torch.from_numpy(g)
    np.testing.assert_array_equal(imgproc.cvt_bgr2gray(torch.from_numpy(img)).numpy(), g)
    np.testing.assert_array_equal(imgproc.gaussian_blur_u8(tg, 3, 1.5).numpy(), cv2.GaussianBlur(g, (3, 3), 1.5))
    np.testing.assert_array_equal(imgproc.gaussian_blur_u8(tg, 7, 2.0).numpy(), cv2.GaussianBlur(g, (7, 7), 2, 2))
    size = (max(shape[1] // 2, 1), max(shape[0] // 2, 1))
    np.testing.assert_array_equal(imgproc.resize_linear(tg, size).numpy(), cv2.resize(g, size))
    np.testing.assert_array_equal(imgproc.pyr_down_u8(tg).numpy(), cv2.pyrDown(g))
    sch = imgproc.scharr_i16(tg).numpy()
    np.testing.assert_array_equal(sch[..., 0], cv2.Scharr(g, cv2.CV_16S, 1, 0))
    np.testing.assert_array_equal(sch[..., 1], cv2.Scharr(g, cv2.CV_16S, 0, 1))
    for dx, dy in ((1, 0), (0, 1)):
        np.testing.assert_allclose(imgproc.sobel_f32(tg, dx, dy, 1 / 3060).numpy(),
                                   cv2.Sobel(g, cv2.CV_32F, dx, dy, ksize=3, scale=1 / 3060), rtol=0, atol=6e-8)
    f = g.astype(np.float32)
    M = np.array([[0.99, -0.05, 3.3], [0.05, 0.99, -2.2]], np.float32)
    dsize = (shape[1], shape[0])
    np.testing.assert_allclose(imgproc.warp_affine_f32(torch.from_numpy(f), torch.from_numpy(M), dsize).numpy(),
                               cv2.warpAffine(f, M, dsize, flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP),
                               rtol=0, atol=1e-2)
    ones = np.ones(shape, np.uint8)
    np.testing.assert_array_equal(
        imgproc.warp_affine_f32(torch.ones(shape), torch.from_numpy(M), dsize, nearest=True).numpy(),
        cv2.warpAffine(ones, M, dsize, flags=cv2.INTER_NEAREST | cv2.WARP_INVERSE_MAP))


@pytest.mark.parametrize("ds", [1, 2])
def test_corners_and_flow_match_cv2(ds):
    """goodFeaturesToTrack's corners in cv2's order (a difference only where
    cv2's responses tie), calcOpticalFlowPyrLK's points within 1e-2 px with
    equal status, and estimateAffinePartial2D on them."""
    M0, M1 = view(0, 5, 3, 0.3), view(1, 5, 3, 0.3)
    g0, g1 = gray_of(M0, ds), gray_of(M1, ds)
    eig = gmc.corner_min_eigen_val(torch.from_numpy(g0)).numpy()
    np.testing.assert_allclose(eig, cv2.cornerMinEigenVal(g0, 3, 3), rtol=1e-5, atol=1e-8)
    ref = cv2.goodFeaturesToTrack(g0, maxCorners=1000, qualityLevel=0.01, minDistance=1, blockSize=3).reshape(-1, 2)
    got = gmc.good_features_to_track(torch.from_numpy(g0)).numpy()
    assert got.shape == ref.shape
    ref_eig = cv2.cornerMinEigenVal(g0, 3, 3)
    differ = np.nonzero((got != ref).any(1))[0]
    print(f"ds {ds}: {len(ref)} corners, {len(differ)} in another order at a tie of cv2's response")
    for i in differ:
        assert ref_eig[int(ref[i, 1]), int(ref[i, 0])] == ref_eig[int(got[i, 1]), int(got[i, 0])]
    nxt, st = gmc.calc_optical_flow_pyr_lk(torch.from_numpy(g0), torch.from_numpy(g1), torch.from_numpy(ref))
    rn, rs, _ = cv2.calcOpticalFlowPyrLK(g0, g1, ref.reshape(-1, 1, 2), None)
    rs = rs.ravel() == 1
    np.testing.assert_array_equal(st.numpy(), rs)
    assert rs.sum() > 100
    np.testing.assert_allclose(nxt.numpy()[rs], rn.reshape(-1, 2)[rs], rtol=0, atol=1e-2)
    got_M = gmc.estimate_affine_partial_2d(ref[rs], rn.reshape(-1, 2)[rs])
    want_M, _ = cv2.estimateAffinePartial2D(ref[rs], rn.reshape(-1, 2)[rs], method=cv2.RANSAC)
    np.testing.assert_allclose(got_M, want_M, rtol=0, atol=1e-5)


def test_ransac_with_outliers_matches_cv2():
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 160, (300, 2)).astype(np.float32)
    dst = src + np.float32([2.5, -1.0]) + rng.normal(0, 0.8, (300, 2)).astype(np.float32)
    dst[:60] += rng.uniform(-20, 20, (60, 2)).astype(np.float32)
    want, _ = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC)
    np.testing.assert_allclose(gmc.estimate_affine_partial_2d(src, dst), want, rtol=0, atol=1e-5)
    assert gmc.estimate_affine_partial_2d(src[:1], dst[:1]) is None


def test_fast_and_orb_match_cv2():
    """FAST-9 keypoints (threshold 20, non-maximum suppression) in cv2's
    order, and ORB's descriptors of them bit for bit."""
    g = cv2.cvtColor(frame(view(0, 0, 0)), cv2.COLOR_BGR2GRAY)
    kp = cv2.FastFeatureDetector_create(20).detect(g)
    pts = gmc.fast_keypoints(torch.from_numpy(g))
    np.testing.assert_array_equal(pts.numpy(), np.array([k.pt for k in kp]).astype(np.int64))
    kp2, desc = cv2.ORB_create().compute(g, kp)
    kept, got = gmc.orb_descriptors(torch.from_numpy(g), pts)
    np.testing.assert_array_equal(kept.numpy(), np.array([k.pt for k in kp2]))
    np.testing.assert_array_equal(got.numpy(), desc)


MOTIONS = {"pan": (4, 2), "rotation": (2, -1, 0.5), "zoom": (1, 1, 0.0, 1.01)}
TOL = {"sparseOptFlow": (0.05, 1e-3), "ecc": (0.05, 1e-3), "orb": (0.25, 5e-3), "sift": (0.25, 5e-3)}


# ECC estimates a Euclidean map: no zoom for it
CASES = [(m, mo) for m in TOL for mo in MOTIONS if not (m == "ecc" and mo == "zoom")]


@pytest.mark.parametrize("ds", [1, 2])
@pytest.mark.parametrize("method,motion", CASES)
def test_gmc_matches_jax(method, motion, ds):
    from tamtr_tpu.trackers.bot_sort import GMC as JaxGMC

    args = MOTIONS[motion]
    port, jax_gmc = gmc.GMC(method, ds, device="cpu"), JaxGMC(method, ds)
    M0, M1 = view(0, *args), view(1, *args)
    for M in (M0, M1):
        f = frame(M)
        got, want = port.apply(f), jax_gmc.apply(f)
    assert got.dtype == np.float32 and got.shape == (2, 3)
    t_tol, lin_tol = TOL[method]
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=t_tol)
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=lin_tol)
    centre = np.array([W0 / 2, H0 / 2, 1.0])
    err = np.abs(got.astype(np.float64) @ centre - true_motion(M0, M1) @ centre).max()
    if method in ("orb", "sift"):
        assert err < 0.5, err
    assert not np.array_equal(got, np.eye(2, 3, dtype=np.float32))


def test_ecc_failure_is_identity_in_both():
    """Unrelated noise frames make cv2.findTransformECC raise; both GMCs
    return the identity, and the port's `find_transform_ecc` raises."""
    from tamtr_tpu.trackers.bot_sort import GMC as JaxGMC

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (H0, W0, 3), np.uint8) for _ in range(2)]
    port, jax_gmc = gmc.GMC("ecc", 2, device="cpu"), JaxGMC("ecc", 2)
    for f in frames:
        got, want = port.apply(f), jax_gmc.apply(f)
    np.testing.assert_array_equal(want, np.eye(2, 3, dtype=np.float32))
    np.testing.assert_array_equal(got, want)
    g = [torch.from_numpy(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)[:60, :80].copy()) for f in frames]
    with pytest.raises(gmc.ECCError, match="uncorrelated"):
        gmc.find_transform_ecc(g[0], g[1], np.eye(2, 3, dtype=np.float32))
