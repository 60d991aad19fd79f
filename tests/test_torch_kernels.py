"""The port's kernel modules on the CPU: each plain version against the JAX
package's function on the same numpy inputs.

- B1 `tamtr_torch.kernels.selective_scan` vs `ss2d_scan` (the Pallas kernel
  in interpret mode) and `ss2d_scan_xla`, within 1e-4.
- B2 `tamtr_torch.kernels.deform_scatter` vs `bilinear_gather` on the XLA
  path and on the Pallas path (`FORCE_PALLAS`), within 1e-5, with sample
  points in the last pixel cell, at x0 < 0 and on a level boundary; the
  pair form (`bilinear_gather_pairs_ref`, idx2 alone) against the Pallas
  path at 1, 2 and 4 points per level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tamtr_tpu.kernels.deform_scatter as jds
from tamtr_torch.kernels import _build
from tamtr_torch.kernels.deform_scatter import bilinear_gather, bilinear_gather_pairs_ref, bilinear_gather_ref
from tamtr_torch.kernels.selective_scan import (
    selective_scan_ref, ss2d_scan, ss2d_scan_fwd_combine, ss2d_scan_fwd_output, ss2d_scan_fwd_summaries,
    ss2d_scan_ref,
)
from tamtr_torch.nn.decoder import deform_sampling_pairs, ms_deform_attn_core


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ss2d_inputs(seed, B, H, W, D, N=16, R=4):
    rng = np.random.default_rng(seed)
    L = H * W
    xm = rng.standard_normal((B, H, W, D)).astype(np.float32)
    layouts = np.stack([xm.reshape(B, L, D), xm.transpose(0, 2, 1, 3).reshape(B, L, D)], 1)
    return (
        layouts,
        (rng.standard_normal((B, 2, 2, L, R)) * 0.5).astype(np.float32),
        (rng.standard_normal((4, D, R)) * 0.5).astype(np.float32),
        (rng.standard_normal((4, D)) * 0.1).astype(np.float32),
        -np.exp(np.log(np.arange(1, N + 1, dtype=np.float32)))[None, None].repeat(4, 0).repeat(D, 1),
        rng.standard_normal((B, 2, 2, L, N)).astype(np.float32),
        rng.standard_normal((B, 2, 2, L, N)).astype(np.float32),
        rng.standard_normal((4, D)).astype(np.float32),
    )


@pytest.mark.parametrize("jax_impl", ["pallas", "xla"])
@pytest.mark.parametrize("hw", [(4, 6), (5, 7)])
def test_ss2d_scan_plain_matches_jax(jax_impl, hw):
    """Odd 5x7 (L=35) is no multiple of either side's chunk, so both pad or
    run a ragged last chunk."""
    from tamtr_tpu.kernels.selective_scan import ss2d_scan as jax_ss2d_scan
    from tamtr_tpu.kernels.selective_scan import ss2d_scan_xla

    args = _ss2d_inputs(1, 2, *hw, D=16)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(
        jax_ss2d_scan(*jargs, 16) if jax_impl == "pallas" else ss2d_scan_xla(*jargs, chunk=8)
    )
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    np.testing.assert_allclose(ss2d_scan(*targs).numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ss2d_scan_ref(*targs, chunk=16).numpy(), want, atol=1e-4, rtol=1e-4)


def test_ss2d_scan_reads_split_views():
    """The scan takes dts_raw/Bs/Cs as views split from one x_proj result,
    as SS2D passes them."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _ss2d_inputs(2, 1, 3, 5, D=8)]
    layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds = args
    x_dbl = torch.cat([dts_raw, Bs, Cs], -1)
    views = x_dbl.split([dts_raw.shape[-1], 16, 16], -1)
    got = ss2d_scan(layouts, views[0], dt_w, dt_b, A, views[1], views[2], Ds)
    torch.testing.assert_close(got, ss2d_scan_ref(*args), rtol=0, atol=0)


def test_selective_scan_ref_matches_sequential_loop():
    rng = np.random.default_rng(3)
    G, L, D, N = 2, 37, 4, 3
    u = torch.from_numpy(rng.standard_normal((G, L, D)).astype(np.float32))
    dt = torch.from_numpy(np.abs(rng.standard_normal((G, L, D))).astype(np.float32) * 0.3)
    A = torch.from_numpy(-np.abs(rng.standard_normal((G, D, N))).astype(np.float32))
    Bs = torch.from_numpy(rng.standard_normal((G, L, N)).astype(np.float32))
    Cs = torch.from_numpy(rng.standard_normal((G, L, N)).astype(np.float32))
    h = torch.zeros(G, D, N)
    want = []
    for t in range(L):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[..., None] * Bs[:, t, None]
        want.append(torch.einsum("gdn,gn->gd", h, Cs[:, t]))
    torch.testing.assert_close(selective_scan_ref(u, dt, A, Bs, Cs, chunk=8), torch.stack(want, 1),
                               atol=1e-5, rtol=1e-5)


SHAPES = [(6, 7), (3, 4), (2, 3)]


def _deform_inputs(seed=5, B=2, Q=6, nh=2, c=8, P=4):
    rng = np.random.default_rng(seed)
    nl = len(SHAPES)
    Lv = sum(h * w for h, w in SHAPES)
    value = rng.standard_normal((B, Lv, nh, c)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Q, nh, nl, P, 2)).astype(np.float32)
    H2, W2 = SHAPES[2]
    # last pixel cell of the last level: the pair starts on the global last row
    loc[0, 0, 0, 2, 0] = [1 - 0.2 / W2, 1 - 0.2 / H2]
    loc[1, 3, 1, 2, 1] = [1 - 0.45 / W2, 1 - 0.01 / H2]
    # x0 < 0 with a valid right corner
    loc[0, 1, 1, 0, 2] = [0.2 / SHAPES[0][1], 0.5]
    # bottom-right cell of level 0: its second row is level 1's row 0
    loc[1, 2, 0, 0, 3] = [1 - 0.3 / SHAPES[0][1], 1 - 0.3 / SHAPES[0][0]]
    w_att = rng.random((B, Q, nh, nl, P)).astype(np.float32)
    w_att /= w_att.sum((-1, -2), keepdims=True)
    return value, loc, w_att, P * nl, Lv


def test_special_sample_points_reach_the_edge_cases():
    _, loc, w_att, _, Lv = _deform_inputs()
    idx4, w_pairs, idx2 = deform_sampling_pairs(SHAPES, torch.from_numpy(loc), torch.from_numpy(w_att))
    assert int(idx2.max()) == Lv - 1  # a pair that the last-row shift must move
    assert idx2.dtype == idx4.dtype == torch.int32
    # the level-0 bottom-right pair: start 6*7-1, second row = level 1's row 0
    assert (idx2 == SHAPES[0][0] * SHAPES[0][1] - 1).any()


@pytest.mark.parametrize("force_pallas", [False, True])
def test_bilinear_gather_plain_matches_jax(force_pallas, monkeypatch):
    monkeypatch.setattr(jds, "FORCE_PALLAS", force_pallas)
    value, loc, w_att, P, _ = _deform_inputs()
    idx4, w_pairs, idx2 = deform_sampling_pairs(SHAPES, torch.from_numpy(loc), torch.from_numpy(w_att))
    want = np.asarray(jds.bilinear_gather(
        jnp.asarray(value), jnp.asarray(idx4.numpy()), jnp.asarray(w_pairs.numpy()),
        jnp.asarray(idx2.numpy()), P,
    ))
    got = bilinear_gather(torch.from_numpy(value), idx4, w_pairs, idx2, P)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_bilinear_gather_pair_form_matches_jax(P, monkeypatch):
    """The plain pair form the kernel reads (pair starts and weight pairs,
    no idx4) against JAX's Pallas pair gather in interpret mode, with a pair
    on the global last row; ppq = 6 and 12 take the kernel's general path,
    24 its compile-time one."""
    monkeypatch.setattr(jds, "FORCE_PALLAS", True)
    value, loc, w_att, _, Lv = _deform_inputs(seed=13)
    loc, w_att, nlP = loc[..., :P, :], w_att[..., :P], len(SHAPES) * P  # point 0 holds the last-cell sample
    idx4, w_pairs, idx2 = deform_sampling_pairs(SHAPES, torch.from_numpy(loc), torch.from_numpy(w_att))
    assert int(idx2.max()) == Lv - 1
    want = np.asarray(jds.bilinear_gather(
        jnp.asarray(value), jnp.asarray(idx4.numpy()), jnp.asarray(w_pairs.numpy()),
        jnp.asarray(idx2.numpy()), nlP,
    ))
    got = bilinear_gather_pairs_ref(torch.from_numpy(value), idx2, w_pairs, 2 * nlP)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("force_pallas", [False, True])
def test_ms_deform_attn_core_matches_jax(force_pallas, monkeypatch):
    """Index/weight construction plus gather against the JAX core."""
    from tamtr_tpu.nn.decoder import ms_deform_attn_core as jax_core

    monkeypatch.setattr(jds, "FORCE_PALLAS", force_pallas)
    value, loc, w_att, _, _ = _deform_inputs(seed=9)
    want = np.asarray(jax_core(jnp.asarray(value), SHAPES, jnp.asarray(loc), jnp.asarray(w_att)))
    got = ms_deform_attn_core(torch.from_numpy(value), SHAPES, torch.from_numpy(loc), torch.from_numpy(w_att))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_bilinear_gather_plain_equals_grid_sample():
    """The gather computes what the reference's per-level `F.grid_sample`
    formulation computes (zeros padding, align_corners=False)."""
    import torch.nn.functional as F

    value, loc, w_att, _, _ = _deform_inputs(seed=11)
    v, lc, wa = torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(w_att)
    B, Lv, nh, c = v.shape
    _, Q, _, nl, P, _ = lc.shape
    levels = v.split([h * w for h, w in SHAPES], 1)
    sampled = []
    for lvl, (h, w) in enumerate(SHAPES):
        vl = levels[lvl].permute(0, 2, 3, 1).reshape(B * nh, c, h, w)
        grid = (2 * lc[:, :, :, lvl] - 1).transpose(1, 2).reshape(B * nh, Q, P, 2)
        sampled.append(F.grid_sample(vl, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
    s = torch.stack(sampled, -2).flatten(-2)  # (B*nh, c, Q, nl*P)
    wt = wa.transpose(1, 2).reshape(B * nh, 1, Q, nl * P)
    want = (s * wt).sum(-1).view(B, nh, c, Q).permute(0, 3, 1, 2)
    got = ms_deform_attn_core(v, SHAPES, lc, wa).view(B, Q, nh, c)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_wrappers_raise_on_devices_without_a_kernel():
    meta = torch.empty((1, 2, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan(meta, *([meta] * 7))
    with pytest.raises(RuntimeError, match="no kernel"):
        bilinear_gather(torch.empty((1, 4, 1, 8), device="meta"), None, None, None, 1)


def test_forward_segment_wrappers_raise_without_a_kernel():
    meta = torch.empty((1, 2, 4, 32), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan_fwd_summaries(meta, *([meta] * 6))
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan_fwd_combine(meta, meta, meta, 4)
    with pytest.raises(RuntimeError, match="no kernel"):
        ss2d_scan_fwd_output(meta, *([meta] * 8))


def test_plain_versions_do_not_count_launches():
    counters = (ss2d_scan, ss2d_scan_fwd_summaries, ss2d_scan_fwd_combine, ss2d_scan_fwd_output, bilinear_gather)
    before = [f.launches for f in counters]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _ss2d_inputs(4, 1, 2, 3, D=8)]
    ss2d_scan(*args)
    value, loc, w_att, P, _ = _deform_inputs()
    idx4, w_pairs, idx2 = deform_sampling_pairs(SHAPES, torch.from_numpy(loc), torch.from_numpy(w_att))
    bilinear_gather_ref(torch.from_numpy(value), idx4, w_pairs, idx2, P)
    bilinear_gather(torch.from_numpy(value), idx4, w_pairs, idx2, P)
    assert [f.launches for f in counters] == before


def test_build_knows_both_sources():
    assert {s.stem for s in _build.sources()} == {
        "ss2d_scan_fwd", "bilinear_gather_fwd", "ss2d_scan_bwd", "bilinear_gather_bwd", "auction",
        "selective_scan_fwd", "deform_scatter",
    }
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with pytest.raises(RuntimeError, match="no CUDA source"):
        _build.load("no_such_kernel")


def test_build_counts_a_library_older_than_a_header_as_stale(tmp_path, monkeypatch):
    """A source's library is rebuilt when any `csrc/*.cuh` is newer than it:
    the segment kernels of both scan sources include one header."""
    import os

    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    src, header, lib = csrc / "scan.cu", csrc / "shared.cuh", build / "libscan.so"
    for f, t in ((src, 100), (header, 100), (lib, 200)):
        f.write_text("")
        os.utime(f, (t, t))
    assert _build._is_fresh(src)
    os.utime(header, (300, 300))
    assert not _build._is_fresh(src)
    os.utime(lib, (300, 300))
    assert _build._is_fresh(src)
    os.utime(src, (400, 400))
    assert not _build._is_fresh(src)
    lib.unlink()
    assert not _build._is_fresh(src)
