"""Dataset format converters (a port of the JAX package's
`tamtr_tpu/data/converter.py`, the reference's `ultralytics/data/converter.py`
and its `dataset/{xml2txt,yolo2coco,split_data}.py`), and the conversion half
of `tools/get_visdrone.py`. Host-side file utilities, no cv2:

- `convert_coco`   : COCO instances json -> YOLO txt labels
- `yolo_to_coco`   : YOLO labels dir -> COCO json (image sizes read from the
                     PNG / JPEG headers, not by decoding)
- `voc_to_yolo`    : Pascal-VOC XML dir -> YOLO txt
- `split_dataset`  : train/val/test split by ratio
- `convert_split`  : a VisDrone2019-DET split's annotations/ -> labels/
- `write_yaml`     : `<root>/visdrone.yaml`, val on test-dev (the
                     reference's protocol)

Run `python tools/convert_visdrone_torch.py --root DIR` on an extracted
VisDrone tree to make the dataset the port trains on.
"""

from __future__ import annotations

import json
import random
import shutil
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from tamtr_torch.data.image_io import image_shape

VISDRONE_SPLITS = ("VisDrone2019-DET-train", "VisDrone2019-DET-val", "VisDrone2019-DET-test-dev")
VISDRONE_NAMES = [
    "pedestrian", "people", "bicycle", "car", "van", "truck", "tricycle",
    "awning-tricycle", "bus", "motor",
]


def coco91_to_coco80_class() -> List[Optional[int]]:
    """COCO 91-index -> contiguous 80-index map (reference `converter.py:8-20`)."""
    x = [None] * 91
    i80 = 0
    # 11 removed category ids (reference map has 11 None slots incl. 91)
    missing = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83, 91}
    for i in range(91):
        if (i + 1) in missing:
            continue
        x[i] = i80
        i80 += 1
    return x


def convert_coco(
    labels_json: str | Path,
    save_dir: str | Path,
    use_segments: bool = False,
    cls91to80: bool = False,
) -> Path:
    """COCO instances json -> YOLO labels, one txt per image
    (reference `converter.py:convert_coco`)."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    with open(labels_json) as f:
        data = json.load(f)
    images = {im["id"]: im for im in data["images"]}
    cmap = coco91_to_coco80_class() if cls91to80 else None
    # category ids may be sparse; build a contiguous map when not remapping
    cat_ids = sorted(c["id"] for c in data.get("categories", []))
    cat_map = {cid: i for i, cid in enumerate(cat_ids)}
    per_image: Dict[int, List[str]] = defaultdict(list)
    for ann in data["annotations"]:
        if ann.get("iscrowd", 0):
            continue
        im = images[ann["image_id"]]
        w, h = im["width"], im["height"]
        cid = ann["category_id"]
        c = cmap[cid - 1] if cmap else cat_map[cid]
        if c is None:
            continue
        if use_segments and ann.get("segmentation"):
            seg = ann["segmentation"][0]
            pts = [
                f"{x / w:.6f} {y / h:.6f}"
                for x, y in zip(seg[0::2], seg[1::2])
            ]
            per_image[ann["image_id"]].append(f"{c} " + " ".join(pts))
        else:
            x, y, bw, bh = ann["bbox"]  # COCO ltwh
            cx, cy = (x + bw / 2) / w, (y + bh / 2) / h
            per_image[ann["image_id"]].append(
                f"{c} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}"
            )
    for img_id, lines in per_image.items():
        stem = Path(images[img_id]["file_name"]).stem
        (save_dir / f"{stem}.txt").write_text("\n".join(lines) + "\n")
    return save_dir


def yolo_to_coco(
    images_dir: str | Path,
    labels_dir: str | Path,
    names: Sequence[str],
    out_json: str | Path,
) -> Path:
    """YOLO labels -> COCO detection json (reference `dataset/yolo2coco.py`);
    image sizes from the files' headers (`image_io.image_shape`)."""
    images_dir, labels_dir = Path(images_dir), Path(labels_dir)
    images, annotations = [], []
    ann_id = 0
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
    for img_id, imf in enumerate(sorted(p for p in images_dir.rglob("*") if p.suffix.lower() in exts)):
        h, w = image_shape(imf)
        images.append({"id": img_id, "file_name": imf.name, "width": w, "height": h})
        lf = labels_dir / (imf.stem + ".txt")
        if not lf.exists():
            continue
        for line in lf.read_text().splitlines():
            parts = line.split()
            if len(parts) < 5:
                continue
            c, cx, cy, bw, bh = int(parts[0]), *(float(x) for x in parts[1:5])
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": img_id,
                    "category_id": c,
                    "bbox": [(cx - bw / 2) * w, (cy - bh / 2) * h, bw * w, bh * h],
                    "area": bw * w * bh * h,
                    "iscrowd": 0,
                }
            )
            ann_id += 1
    out = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i, "name": n} for i, n in enumerate(names)],
    }
    out_json = Path(out_json)
    out_json.parent.mkdir(parents=True, exist_ok=True)
    out_json.write_text(json.dumps(out))
    return out_json


def voc_to_yolo(
    xml_dir: str | Path, save_dir: str | Path, names: Sequence[str]
) -> Path:
    """Pascal-VOC XML annotations -> YOLO txt (reference `dataset/xml2txt.py`)."""
    import xml.etree.ElementTree as ET

    xml_dir, save_dir = Path(xml_dir), Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    name_to_id = {n: i for i, n in enumerate(names)}
    for xf in sorted(xml_dir.glob("*.xml")):
        root = ET.parse(xf).getroot()
        size = root.find("size")
        w = float(size.find("width").text)
        h = float(size.find("height").text)
        lines = []
        for obj in root.iter("object"):
            cname = obj.find("name").text
            if cname not in name_to_id:
                continue
            bb = obj.find("bndbox")
            x1, y1 = float(bb.find("xmin").text), float(bb.find("ymin").text)
            x2, y2 = float(bb.find("xmax").text), float(bb.find("ymax").text)
            cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
            bw, bh = (x2 - x1) / w, (y2 - y1) / h
            lines.append(f"{name_to_id[cname]} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
        (save_dir / f"{xf.stem}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
    return save_dir


def split_dataset(
    images_dir: str | Path,
    labels_dir: str | Path,
    out_dir: str | Path,
    ratios: Tuple[float, float, float] = (0.8, 0.1, 0.1),
    seed: int = 0,
) -> Dict[str, int]:
    """Random train/val/test split with copied files (reference `dataset/split_data.py`)."""
    images_dir, labels_dir, out_dir = Path(images_dir), Path(labels_dir), Path(out_dir)
    exts = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
    files = sorted(p for p in images_dir.rglob("*") if p.suffix.lower() in exts)
    rng = random.Random(seed)
    rng.shuffle(files)
    n = len(files)
    n_train = round(n * ratios[0])
    n_val = round(n * ratios[1])
    splits = {
        "train": files[:n_train],
        "val": files[n_train : n_train + n_val],
        "test": files[n_train + n_val :],
    }
    counts = {}
    for split, fs in splits.items():
        for sub in ("images", "labels"):
            (out_dir / split / sub).mkdir(parents=True, exist_ok=True)
        for f in fs:
            shutil.copy2(f, out_dir / split / "images" / f.name)
            lf = labels_dir / (f.stem + ".txt")
            if lf.exists():
                shutil.copy2(lf, out_dir / split / "labels" / lf.name)
        counts[split] = len(fs)
    return counts


def convert_split(split_dir: Path) -> int:
    """VisDrone annotations/ -> labels/ (YOLO normalized cxcywh), as
    `tools/get_visdrone.py:convert_split`; image sizes from the headers."""
    ann_dir = split_dir / "annotations"
    img_dir = split_dir / "images"
    lab_dir = split_dir / "labels"
    if not ann_dir.is_dir() or not img_dir.is_dir():
        return 0
    lab_dir.mkdir(exist_ok=True)
    n = 0
    for ann in sorted(ann_dir.glob("*.txt")):
        img = next(
            (img_dir / (ann.stem + ext) for ext in (".jpg", ".png", ".jpeg")
             if (img_dir / (ann.stem + ext)).exists()),
            None,
        )
        if img is None:
            continue
        h, w = image_shape(img)
        lines = []
        for row in ann.read_text().splitlines():
            vals = row.strip().strip(",").split(",")
            if len(vals) < 6:
                continue
            left, top, bw, bh, score, cat = (float(v) for v in vals[:6])
            # score==0 marks ignored regions; categories 0 (ignored) and 11
            # (others) are dropped; 1..10 -> class 0..9
            if score == 0 or not (1 <= cat <= 10) or bw <= 0 or bh <= 0:
                continue
            cx = (left + bw / 2) / w
            cy = (top + bh / 2) / h
            lines.append(
                f"{int(cat) - 1} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}"
            )
        (lab_dir / (ann.stem + ".txt")).write_text("\n".join(lines) + "\n")
        n += 1
    return n


def write_yaml(root: Path) -> Path:
    """`<root>/visdrone.yaml`: train on DET-train, val and test on
    DET-test-dev, 10 classes (`tools/get_visdrone.py:write_yaml`)."""
    out = root / "visdrone.yaml"
    # reference protocol: val key -> test-dev images (BASELINE.md caveat)
    out.write_text(
        "path: {root}\n"
        "train: VisDrone2019-DET-train/images\n"
        "val: VisDrone2019-DET-test-dev/images\n"
        "test: VisDrone2019-DET-test-dev/images\n"
        "nc: 10\n"
        "names: [{names}]\n".format(root=root.resolve(), names=", ".join(VISDRONE_NAMES))
    )
    return out
