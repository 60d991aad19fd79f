"""SAM builders (a port of the JAX package's `tamtr_tpu/models/sam/build.py`,
the reference's `ultralytics/models/sam/build.py`).

`SamModel` holds the image encoder, the prompt encoder and the mask decoder
(the reference's `Sam` container), so its state-dict keys are the
reference checkpoint's (`image_encoder.blocks.0.attn.qkv.weight`, ...).
A builder gives seeded weights (`weights.py:init_sam_parameters`, flax's
default initialisers) unless its `checkpoint=` names an `.npz` of the JAX
package's variables (`SamModel.load`). `build_sam(name)` picks the builder
by the name's end and loads the file the name points at; the JAX package's
ignores any path and runs seeded weights (`tamtr_tpu/models/sam/build.py:
180-191`; ROADMAP queue C).
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
from torch import nn

from tamtr_torch.models.sam.modules import ImageEncoderViT, MaskDecoder, PromptEncoder, TinyViTEncoder

PIXEL_MEAN = (123.675, 116.28, 103.53)  # RGB, the reference's `build.py:127`
PIXEL_STD = (58.395, 57.12, 57.375)


class SamModel(nn.Module):
    """Image encoder, prompt encoder and mask decoder at `img_size`."""

    def __init__(self, image_encoder: nn.Module, prompt_encoder: PromptEncoder, mask_decoder: MaskDecoder,
                 img_size: int = 1024, mask_threshold: float = 0.0):
        super().__init__()
        self.image_encoder, self.prompt_encoder, self.mask_decoder = image_encoder, prompt_encoder, mask_decoder
        self.img_size, self.mask_threshold = img_size, mask_threshold
        self.loaded = False  # True once weights came from a checkpoint

    def load(self, path: Union[str, Path]) -> "SamModel":
        """Weights from an `.npz` of the JAX package's variables: keys the
        `/`-joined flax paths (`image_encoder/params/blocks_0/attn/qkv/kernel`,
        ...), as `tamtr_tpu/models/sam/build.py:SamModel.load` reads them.
        Its other branch unpickles flax objects, which the port cannot
        read: any other suffix raises."""
        from tamtr_torch.weights import from_jax_sam_variables

        p = Path(path)
        if p.suffix != ".npz":
            raise ValueError(f"{p}: the port reads SAM weights from an .npz of flax variables; a pickled flax tree "
                             "(.msgpack) needs JAX to read")
        tree: Dict = {}
        with np.load(p, allow_pickle=False) as flat:
            for k in flat.files:
                node = tree
                *scopes, leaf = k.split("/")
                for s in scopes:
                    node = node.setdefault(s, {})
                node[leaf] = flat[k]
        sd, report = from_jax_sam_variables(tree, self)
        problems = {k: v for k, v in report.items() if v}
        if problems:
            raise ValueError(f"{p}: incomplete SAM weights: {problems}")
        self.load_state_dict(sd, strict=False)  # `num_batches_tracked` have no flax twin
        self.loaded = True
        return self


def _build_sam(encoder_embed_dim, encoder_depth, encoder_num_heads, encoder_global_attn_indexes,
               mobile_sam: bool = False, img_size: int = 1024, checkpoint: Optional[str] = None) -> SamModel:
    """A SAM of hd 256 and patch 16 at img_size: the ViT encoder of the
    given width, depth, heads and global blocks, or MobileSAM's TinyViT
    (lists of stage widths, depths and heads); weights from `checkpoint`,
    else seeded."""
    from tamtr_torch.weights import init_sam_parameters

    d, patch = 256, 16
    embed = img_size // patch
    if mobile_sam:
        enc = TinyViTEncoder(embed_dims=tuple(encoder_embed_dim), depths=tuple(encoder_depth),
                             num_heads=tuple(encoder_num_heads), window_sizes=(7, 7, 14, 7), out_chans=d)
    else:
        enc = ImageEncoderViT(img_size=img_size, patch_size=patch, embed_dim=encoder_embed_dim,
                              depth=encoder_depth, num_heads=encoder_num_heads, out_chans=d, use_rel_pos=True,
                              window_size=14, global_attn_indexes=tuple(encoder_global_attn_indexes or ()))
    sam = SamModel(enc, PromptEncoder(d, (embed, embed), (img_size, img_size), 16),
                   MaskDecoder(d, 3, 3, 256), img_size=img_size)
    init_sam_parameters(sam, 0)
    if checkpoint is not None:
        sam.load(checkpoint)
    return sam


def build_sam_vit_h(checkpoint=None) -> SamModel:
    """SAM ViT-H: width 1280, 32 blocks, 16 heads, global blocks 7, 15, 23, 31."""
    return _build_sam(1280, 32, 16, [7, 15, 23, 31], checkpoint=checkpoint)


def build_sam_vit_l(checkpoint=None) -> SamModel:
    """SAM ViT-L: width 1024, 24 blocks, 16 heads, global blocks 5, 11, 17, 23."""
    return _build_sam(1024, 24, 16, [5, 11, 17, 23], checkpoint=checkpoint)


def build_sam_vit_b(checkpoint=None) -> SamModel:
    """SAM ViT-B: width 768, 12 blocks, 12 heads, global blocks 2, 5, 8, 11."""
    return _build_sam(768, 12, 12, [2, 5, 8, 11], checkpoint=checkpoint)


def build_mobile_sam(checkpoint=None) -> SamModel:
    """MobileSAM: TinyViT-5M (64, 128, 160, 320 wide; 2, 2, 6, 2 deep)."""
    return _build_sam([64, 128, 160, 320], [2, 2, 6, 2], [2, 4, 5, 10], None, mobile_sam=True,
                      checkpoint=checkpoint)


def build_sam_tiny_test(img_size: int = 64, checkpoint=None) -> SamModel:
    """A SAM small enough for CPU tests: a 2-block ViT of width 32 (block 1
    global) at img_size."""
    return _build_sam(32, 2, 2, [1], img_size=img_size, checkpoint=checkpoint)


sam_model_map = {"sam_h": build_sam_vit_h, "sam_l": build_sam_vit_l, "sam_b": build_sam_vit_b,
                 "mobile_sam": build_mobile_sam}


def build_sam(model: str = "sam_b") -> SamModel:
    """The builder whose name ends the given name (a ".pt", ".npz" or
    ".msgpack" suffix dropped). When the name is a file, its weights are
    loaded (`SamModel.load`: an `.npz`, any other suffix raises); a bare
    name gives seeded weights, and a path to no file warns that no
    checkpoint was read."""
    stem = str(model)
    for suffix in (".pt", ".npz", ".msgpack"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
    for key, builder in sam_model_map.items():
        if stem.endswith(key):
            if Path(str(model)).is_file():
                return builder(checkpoint=model)
            if stem != str(model):
                warnings.warn(f"{model}: no such file, so no checkpoint was read; {key} runs seeded weights",
                              stacklevel=2)
            return builder()
    raise FileNotFoundError(f"{model} is not a supported SAM model. Available: {list(sam_model_map)}")

