"""Segment Anything's modules in the port (`tamtr_torch/models/sam/
modules.py`, `build.py`, `weights.py:from_jax_sam_variables`) against the
JAX package's on the CPU, one torch thread.

Each port module is built with seeded weights, every zero-initialised
tensor (pos_embed, rel_pos_*, attention_biases, biases) and every norm's
scale, bias and statistics given seeded random values (`spread_sam`), and
handed to the JAX module as flax variables (`sam_flax_variables_of`, the
inverse of the bridge): no JAX init is compiled. Inputs are seeded numpy
arrays.

Bounds: the encoders at 1e-4 relative to their output's scale (a ViT at a
size that needs window padding, the tiny SAM's, a TinyViT at the smallest
size its windows take, its BatchNorm statistics carried across), the
prompt encoder over every prompt combination at 1e-5, the mask decoder
(its transposed convs' kernels flipped) at 1e-5, `prompt_inference` at
1e-4; the variable trees and counts of sam_b and mobile_sam equal JAX's
(`jax.eval_shape` of the init).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tamtr_torch.models.sam import modules as M
from tamtr_torch.models.sam.build import build_mobile_sam, build_sam, build_sam_tiny_test, build_sam_vit_b
from tamtr_torch.weights import from_jax_sam_variables, init_sam_parameters

from torch_engine_data import one_thread, sam_flax_variables_of, spread_sam  # noqa: F401


def _bridged(**modules):
    """Port modules (seeded, spread) and their flax variables by name."""
    holder = nn.ModuleDict(modules)
    init_sam_parameters(holder, 0)
    spread_sam(holder, 1)
    return holder.eval(), {k: jax.tree.map(jnp.asarray, v) for k, v in sam_flax_variables_of(holder).items()}


def _close(got, want, rtol=1e-4, what=""):
    want = np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    print(f"{what}: max |port - JAX| / max |JAX| {err}")
    assert got.shape == want.shape and err < rtol, (what, err)


def test_image_encoder_vit_with_window_padding_matches_jax():
    """A 2-block ViT at 96 px (a 6x6 grid in windows of 4: padded to 8),
    block 1 global, then the tiny SAM's encoder (4x4 grid, windows of 14)."""
    from tamtr_tpu.models.sam.modules import ImageEncoderViT as J

    kw = dict(img_size=96, patch_size=16, embed_dim=32, depth=2, num_heads=2, out_chans=16, use_rel_pos=True,
              window_size=4, global_attn_indexes=(1,))
    holder, v = _bridged(image_encoder=M.ImageEncoderViT(**kw))
    x = np.random.default_rng(0).standard_normal((2, 96, 96, 3)).astype(np.float32)
    with torch.no_grad():
        got = holder["image_encoder"](torch.from_numpy(x)).numpy()
    _close(got, J(**kw).apply(v["image_encoder"], x), what="ViT 96 px, windows of 4")
    sam = spread_sam(build_sam_tiny_test(64), 2)
    tiny = sam_flax_variables_of(sam)["image_encoder"]
    from tamtr_tpu.models.sam.build import build_sam_tiny_test as jtiny

    x = np.random.default_rng(1).standard_normal((1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = sam.image_encoder(torch.from_numpy(x)).numpy()
    _close(got, jtiny(64).image_encoder.apply(tiny, x), what="tiny SAM encoder")


def test_tinyvit_encoder_matches_jax():
    """TinyViT at 64 px with windows (2, 3, 2, 4): stage 1 (8x8) padded to
    9, stage 3 one whole window; the BatchNorm statistics (spread) carried
    across, in eval."""
    from tamtr_tpu.models.sam.modules import TinyViTEncoder as J

    kw = dict(embed_dims=(8, 12, 16, 20), depths=(1, 1, 2, 1), num_heads=(1, 2, 2, 2), window_sizes=(2, 3, 2, 4),
              out_chans=16)
    holder, v = _bridged(image_encoder=M.TinyViTEncoder(**kw))
    assert "batch_stats" in v["image_encoder"]
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = holder["image_encoder"](torch.from_numpy(x)).numpy()
    _close(got, J(**kw).apply(v["image_encoder"], x), what="TinyViT")


PROMPTS = [(p, b, m) for p in (False, True) for b in (False, True) for m in (False, True)]


@pytest.mark.parametrize("points,boxes,masks", PROMPTS)
def test_prompt_encoder_combinations_match_jax(points, boxes, masks):
    """Sparse and dense embeddings of each prompt combination (points with
    labels 1, 0 and -1), and the dense PE grid, at 1e-5."""
    from tamtr_tpu.models.sam.modules import PromptEncoder as J

    kw = dict(embed_dim=32, image_embedding_size=(4, 5), input_image_size=(64, 80), mask_in_chans=16)
    holder, v = _bridged(prompt_encoder=M.PromptEncoder(**kw))
    rng = np.random.default_rng(3)
    pts = (rng.uniform(0, 64, (3, 2, 2)).astype(np.float32), np.array([[1, 0], [0, -1], [-1, 1]], np.int32))
    box = np.sort(rng.uniform(0, 64, (3, 2, 2)), 1).reshape(3, 4).astype(np.float32)
    msk = rng.standard_normal((3, 16, 20, 1)).astype(np.float32)
    args = dict(points=pts if points else None, boxes=box if boxes else None, masks=msk if masks else None)
    jm = J(**kw)
    want = jm.apply(v["prompt_encoder"], **{k: None if a is None else (tuple(map(jnp.asarray, a)) if k == "points"
                                                                      else jnp.asarray(a)) for k, a in args.items()})
    with torch.no_grad():
        pe = holder["prompt_encoder"]
        got = pe(**{k: None if a is None else (tuple(map(torch.from_numpy, a)) if k == "points"
                                               else torch.from_numpy(a)) for k, a in args.items()})
        grid = pe.get_dense_pe().numpy()
    for g, w, name in zip(got, want, ("sparse", "dense")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(grid, np.asarray(jm.apply(v["prompt_encoder"], method=jm.get_dense_pe)), atol=1e-5)


def test_mask_decoder_matches_jax():
    """The mask decoder (2 two-way blocks, transposed convs flipped) on a
    broadcast image embedding, 3 prompts of 3 tokens: masks and IoU
    predictions at 1e-5."""
    from tamtr_tpu.models.sam.modules import MaskDecoder as J

    kw = dict(transformer_dim=32, num_multimask_outputs=3, transformer_mlp_dim=64)
    holder, v = _bridged(mask_decoder=M.MaskDecoder(**kw))
    rng = np.random.default_rng(4)
    feats, pe = (rng.standard_normal((1, 4, 5, 32)).astype(np.float32) for _ in range(2))
    sparse = rng.standard_normal((3, 3, 32)).astype(np.float32)
    dense = rng.standard_normal((3, 4, 5, 32)).astype(np.float32)
    want = J(**kw).apply(v["mask_decoder"], feats, pe, sparse, dense)
    with torch.no_grad():
        got = holder["mask_decoder"](*map(torch.from_numpy, (feats, pe, sparse, dense)))
    assert got[0].shape == (3, 4, 16, 20) and got[1].shape == (3, 4)
    for g, w, name in zip(got, want, ("masks", "iou_pred")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def predictors():
    """(port `SAMPredictor`, JAX `SAMPredictor`) of the tiny SAM at 64 px
    on the same (spread) weights, each with one 48x72 image set."""
    from tamtr_tpu.models.sam.build import build_sam_tiny_test as jtiny
    from tamtr_tpu.models.sam.predict import SAMPredictor as JPredictor

    from tamtr_torch.models.sam.predict import SAMPredictor

    sam = spread_sam(build_sam_tiny_test(64), 5)
    js = jtiny(64)
    js.variables = jax.tree.map(jnp.asarray, sam_flax_variables_of(sam))
    port, jp = SAMPredictor(sam, conf=-1.0, device="cpu"), JPredictor(js, conf=-1.0)
    img = np.random.default_rng(6).integers(0, 255, (48, 72, 3), np.uint8)
    port.set_image(img)
    jp.set_image(img)
    return port, jp


def test_prompt_inference_matches_jax(predictors):
    """Boxes, multimask points, points with labels (one point set a prompt)
    and a mask prompt: low-res logits and scores at 1e-4 (the prompt
    batches of JAX padded to buckets, the port's not)."""
    port, jp = predictors
    np.testing.assert_allclose(port.features.numpy(), np.asarray(jp.features), atol=1e-4)
    rng = np.random.default_rng(7)
    cases = [dict(bboxes=np.array([[5, 5, 40, 30], [10, 10, 60, 45], [0, 0, 71, 47]])),
             dict(points=np.array([[20, 20], [40, 30], [10, 35]]), multimask_output=True),
             dict(points=np.array([[[20, 20], [30, 10]], [[5, 40], [60, 2]]]), labels=np.array([[1, 0], [1, 1]])),
             dict(bboxes=np.array([[5, 5, 40, 30]]), masks=rng.standard_normal((1, 16, 16)).astype(np.float32))]
    for kw in cases:
        want, got = jp.prompt_inference(**kw), port.prompt_inference(**kw)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def _count(tree):
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))


def _flat_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat_shapes(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): tuple(v.shape)})
    return out


@pytest.mark.parametrize("name", ["sam_b", "mobile_sam"])
def test_variable_trees_and_counts_equal_jax(name):
    """The port's SAM mapped to flax paths (`sam_flax_route`) gives JAX's
    variable tree, leaf for leaf and shape for shape (`jax.eval_shape` of
    the JAX init: no real init); `SAM(name).info()` counts as JAX counts."""
    from tamtr_tpu.models.sam.build import build_sam as jbuild

    from tamtr_torch import SAM
    from tamtr_torch.api import variable_count

    js = jbuild(name)
    s, (eh, ew), d = js.img_size, js.embed_size, 256  # the JAX SamModel's
    shapes = jax.eval_shape(lambda: {
        "image_encoder": js.image_encoder.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3))),
        "prompt_encoder": js.prompt_encoder.init(jax.random.PRNGKey(1), points=(jnp.zeros((1, 1, 2)),
                                                 jnp.zeros((1, 1), jnp.int32)), boxes=jnp.zeros((1, 4)),
                                                 masks=jnp.zeros((1, 4 * eh, 4 * ew, 1))),
        "mask_decoder": js.mask_decoder.init(jax.random.PRNGKey(2), jnp.zeros((1, eh, ew, d)),
                                             jnp.zeros((1, eh, ew, d)), jnp.zeros((1, 2, d)),
                                             jnp.zeros((1, eh, ew, d)))})
    sam = SAM(name, device="cpu")
    port = sam.predictor.sam
    assert _flat_shapes(sam_flax_variables_of(port)) == _flat_shapes(shapes)
    n = _count(shapes)
    assert variable_count(port) == n
    assert sam.info() == f"SAM({name}): {n / 1e6:.1f}M params, imgsz=1024"


def test_bridge_and_npz_load(tmp_path):
    """`from_jax_sam_variables` of a SAM's flax variables rebuilds its
    state dict exactly (report empty); `SamModel.load` reads the same
    variables from an .npz of `/`-joined flax keys, as the JAX package
    writes and reads them, and refuses a pickled flax tree."""
    sam = spread_sam(build_sam_tiny_test(64), 8)
    tree = sam_flax_variables_of(sam)
    sd, report = from_jax_sam_variables(tree, build_sam_tiny_test(64))
    assert not any(report.values()), report
    want = {k: v for k, v in sam.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in want)
    flat = {"/".join(p): v for p, v in _flat_items(tree)}
    np.savez(tmp_path / "tiny.npz", **flat)
    loaded = build_sam_tiny_test(64).load(tmp_path / "tiny.npz")
    assert loaded.loaded and all(torch.equal(loaded.state_dict()[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="msgpack"):
        build_sam_tiny_test(64).load(tmp_path / "tiny.msgpack")


def _flat_items(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_build_sam_ignores_a_checkpoint_in_the_name(tmp_path, monkeypatch):
    """The JAX package's `build_sam(name)` drops the path and returns the
    builder's model with no variables, so `SAMPredictor("my.npz")` runs
    seeded weights (ROADMAP queue C: a fault of the JAX package): shown
    here on JAX's side. The port's loads a file the name points at
    (an .npz; a pickled flax tree raises), warns for a path to no file and
    then seeds, as it does for a bare name (its builders seed at 0)."""
    from tamtr_tpu.models.sam.build import build_sam as jbuild
    from tamtr_torch.models.sam import build as B

    assert jbuild(str(tmp_path / "sam_b.npz")).variables is None  # the file need not even exist
    assert jbuild("weights/mobile_sam.pt").variables is None
    with pytest.warns(UserWarning, match="no checkpoint was read"):
        port = build_sam(str(tmp_path / "sam_b.npz"))
    assert isinstance(port.image_encoder, M.ImageEncoderViT) and port.image_encoder.embed_dim == 768
    assert not port.loaded
    monkeypatch.setitem(B.sam_model_map, "sam_tiny", build_sam_tiny_test)
    sam = spread_sam(build_sam_tiny_test(64), 8)
    np.savez(tmp_path / "my_sam_tiny.npz", **{"/".join(p): v for p, v in _flat_items(sam_flax_variables_of(sam))})
    loaded = build_sam(str(tmp_path / "my_sam_tiny.npz"))
    assert loaded.loaded
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in sam.state_dict().items())
    (tmp_path / "my_sam_tiny.pt").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="msgpack"):
        build_sam(str(tmp_path / "my_sam_tiny.pt"))
    assert all(torch.equal(a, b) for a, b in zip(port.state_dict().values(), build_sam_vit_b().state_dict().values()))
    assert isinstance(build_mobile_sam().image_encoder, M.TinyViTEncoder)
    with pytest.raises(FileNotFoundError):
        build_sam("nope.pt")
