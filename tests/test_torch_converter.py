"""The port's dataset converters (`tamtr_torch/data/converter.py`,
`tools/convert_visdrone_torch.py`) against the JAX package's
(`tamtr_tpu/data/converter.py`) and `tools/get_visdrone.py:convert_split` /
`write_yaml` on the same synthetic trees, built as `tests/test_converter.py`
and `tests/test_visdrone_tool.py` build them (JPEG and PNG images, one
JPEG with an EXIF orientation): every file they write is byte-equal."""

import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from tamtr_torch.data import converter as port

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
from make_jpeg_fixtures_torch import exif_app1, splice_after_app0  # noqa: E402


def _tree_bytes(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _images(d: Path):
    """A PNG, a JPEG and an EXIF-rotated JPEG (orientation 6: w and h swap)."""
    d.mkdir(parents=True)
    cv2.imwrite(str(d / "a.png"), np.zeros((80, 100, 3), np.uint8))
    cv2.imwrite(str(d / "b.jpg"), np.full((48, 64, 3), 90, np.uint8))
    ok, buf = cv2.imencode(".jpg", np.full((30, 50, 3), 40, np.uint8))
    (d / "c.jpg").write_bytes(splice_after_app0(buf.tobytes(), exif_app1(6)))


def test_coco_roundtrip_matches_jax(tmp_path):
    from tamtr_tpu.data import converter as jax

    _images(tmp_path / "images")
    coco = {
        "images": [{"id": 7, "file_name": "a.png", "width": 100, "height": 80},
                   {"id": 8, "file_name": "b.jpg", "width": 64, "height": 48}],
        "annotations": [
            {"id": 0, "image_id": 7, "category_id": 3, "bbox": [10, 20, 30, 40], "area": 1200, "iscrowd": 0},
            {"id": 1, "image_id": 8, "category_id": 5, "bbox": [1, 2, 30, 20], "area": 600, "iscrowd": 0},
            {"id": 2, "image_id": 8, "category_id": 3, "bbox": [0, 0, 5, 5], "area": 25, "iscrowd": 1},
        ],
        "categories": [{"id": 3, "name": "car"}, {"id": 5, "name": "bus"}],
    }
    (tmp_path / "inst.json").write_text(json.dumps(coco))
    for name, mod in (("port", port), ("jax", jax)):
        mod.convert_coco(tmp_path / "inst.json", tmp_path / name / "labels")
        mod.convert_coco(tmp_path / "inst.json", tmp_path / name / "labels80", cls91to80=True)
        mod.yolo_to_coco(tmp_path / "images", tmp_path / name / "labels", ["car", "bus"], tmp_path / name / "back.json")
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    sizes = {im["file_name"]: (im["width"], im["height"])
             for im in json.loads((tmp_path / "port" / "back.json").read_text())["images"]}
    assert sizes == {"a.png": (100, 80), "b.jpg": (64, 48), "c.jpg": (30, 50)}
    assert port.coco91_to_coco80_class() == jax.coco91_to_coco80_class()


def test_voc_to_yolo_matches_jax(tmp_path):
    from tamtr_tpu.data import converter as jax

    xml = """<annotation><size><width>200</width><height>100</height></size>
    <object><name>dog</name><bndbox><xmin>50</xmin><ymin>25</ymin><xmax>150</xmax><ymax>75</ymax></bndbox></object>
    <object><name>unknown</name><bndbox><xmin>0</xmin><ymin>0</ymin><xmax>10</xmax><ymax>10</ymax></bndbox></object>
    </annotation>"""
    (tmp_path / "xml").mkdir()
    (tmp_path / "xml" / "x.xml").write_text(xml)
    (tmp_path / "xml" / "empty.xml").write_text(
        "<annotation><size><width>20</width><height>10</height></size></annotation>")
    port.voc_to_yolo(tmp_path / "xml", tmp_path / "port", ["cat", "dog"])
    jax.voc_to_yolo(tmp_path / "xml", tmp_path / "jax", ["cat", "dog"])
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")


def test_split_dataset_matches_jax(tmp_path):
    from tamtr_tpu.data import converter as jax

    imgs, labels = tmp_path / "images", tmp_path / "labels"
    imgs.mkdir(), labels.mkdir()
    for i in range(10):
        cv2.imwrite(str(imgs / f"{i}.png"), np.zeros((48, 64, 3), np.uint8))
        (labels / f"{i}.txt").write_text("0 0.5 0.5 0.2 0.2\n")
    got = port.split_dataset(imgs, labels, tmp_path / "port", (0.6, 0.2, 0.2), seed=3)
    want = jax.split_dataset(imgs, labels, tmp_path / "jax", (0.6, 0.2, 0.2), seed=3)
    assert got == want == {"train": 6, "val": 2, "test": 2}
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")


def _visdrone_split(root: Path, name: str):
    d = root / name
    (d / "annotations").mkdir(parents=True)
    _images(d / "images")
    rows = ("10,20,40,30,1,4,0,0\n"   # car (cat 4 -> cls 3)
            "0,0,50,50,0,1,0,0\n"     # score 0: an ignored region, dropped
            "5,5,10,10,1,0,0,0\n"     # cat 0 (ignored), dropped
            "1,1,5,5,1,11,0,0\n"      # cat 11 (others), dropped
            "3,4,7,9,1,10,0,0,\n")    # motor, trailing comma
    for stem in ("a", "b", "c", "missing"):
        (d / "annotations" / f"{stem}.txt").write_text(rows)


@pytest.mark.parametrize("split", ["VisDrone2019-DET-train", "VisDrone2019-DET-test-dev"])
def test_visdrone_conversion_matches_the_jax_tool(split, tmp_path):
    from get_visdrone import convert_split, write_yaml

    for name in ("port", "jax"):
        _visdrone_split(tmp_path / name, split)
    assert port.convert_split(tmp_path / "port" / split) == convert_split(tmp_path / "jax" / split) == 3
    port.write_yaml(tmp_path / "port")
    write_yaml(tmp_path / "jax")
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert got.pop("visdrone.yaml") == want.pop("visdrone.yaml").replace(b"/jax", b"/port")
    assert got == want


def test_convert_visdrone_tool_end_to_end(tmp_path):
    """`tools/convert_visdrone_torch.py --root` converts every split and
    writes a dataset file the port's `load_data_yaml` reads: 10 classes, val
    on test-dev."""
    import convert_visdrone_torch

    from tamtr_torch.config import load_data_yaml

    for split in ("VisDrone2019-DET-train", "VisDrone2019-DET-test-dev"):
        _visdrone_split(tmp_path, split)
    assert convert_visdrone_torch.main(["--root", str(tmp_path)]) == 0
    d = load_data_yaml(tmp_path / "visdrone.yaml")
    assert d["nc"] == 10 and d["names"] == port.VISDRONE_NAMES
    assert Path(d["train"]).is_dir() and "test-dev" in d["val"]
    assert convert_visdrone_torch.main(["--root", str(tmp_path / "none")]) == 1
