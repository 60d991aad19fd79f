"""The training step of each DETR head variant of the port against the
JAX package's on the CPU, one torch thread: the heads of
`tests/test_torch_heads.py`, each alone on the nano model's features of two
seeded images, CDN noise and DropPath off on both sides, JAX's top-k order
and assignment given to the port (`torch_engine_data.py:
check_variant_train_step`; the nano init and each head's JAX init shared
across the head files, `session_cached`).

Bounds, the main path's (`tests/test_torch_train.py`): the loss at 1e-4,
the layers' boxes and scores at 2e-3 (the query order is JAX's), the whole
head gradient within 2% of JAX's and each tensor within 7.5%.

The locationManbaDecoder and DualRTDETRDecoder here (the cases of
`tests/test_torch_heads_step.py` split off).
"""

import pytest

from torch_engine_data import HEADS, check_variant_train_step, heads_base, no_cdn_noise, one_thread  # noqa: F401


@pytest.mark.parametrize("head", HEADS[4:])
def test_variant_train_step_matches_jax(head, heads_base, tmp_path_factory, no_cdn_noise, monkeypatch):
    """The head's training forward and gradient on the nano features, with
    JAX's top-k query order and assignment given to the port."""
    check_variant_train_step(head, heads_base, tmp_path_factory, monkeypatch)
