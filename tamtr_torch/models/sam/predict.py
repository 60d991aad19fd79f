"""SAM predictor: promptable and automatic ("segment everything")
segmentation (a port of the JAX package's `tamtr_tpu/models/sam/predict.py`,
the reference's `ultralytics/models/sam/predict.py`).

- `set_image` encodes one image and keeps its embedding on the device, so
  prompts on that image only run the prompt encoder and the mask decoder.
- `prompt_inference` decodes one mask (or three, multimask) per prompt.
  The JAX package pads the prompt batch to a power of two so that each
  size compiles once; eager torch has no such need, and the real prompts'
  outputs are the same without it.
- `generate` scores, filters (conf, stability) and boxes every point
  prompt's masks at the decoder's low resolution, drops boxes on crop
  edges, runs NMS, and upscales the survivors into the image: the JAX
  package's order, on the host in numpy.

Image resizes are cv2's, rewritten in numpy (`data/imgproc.py`): the uint8
letterbox resize and mask resizes bitwise, the float32 ones (the crop
re-encode's 3-channel upscale, `_upscale_masks`) OpenCV's float path,
within an ulp or two of cv2's IPP path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tamtr_torch.data.imgproc import resize_linear, resize_linear_f32
from tamtr_torch.data.loaders import load_inference_source
from tamtr_torch.engine.results import Results
from tamtr_torch.models.sam import amg
from tamtr_torch.models.sam.build import PIXEL_MEAN, PIXEL_STD, SamModel, build_sam


def _nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float) -> np.ndarray:
    """Greedy NMS on the host (the JAX package's): indices kept, by score."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-9)
        order = order[1:][iou <= iou_thresh]
    return np.asarray(keep, np.int64)


class SAMPredictor:
    """Promptable segmentation over one `SamModel` on one device.

    Args:
      model: a `SamModel`, a builder name ("mobile_sam", "sam_b",
        "sam_l", "sam_h") or a weights file named after one
        (`build.build_sam`).
      conf, iou: `generate`'s defaults for the kept score and the crop NMS.
      seed: the seed of the weights when the model was not loaded from a
        checkpoint (the builders seed 0).
      device: "cuda" by default; "cpu" only when asked for.
    """

    def __init__(self, model: Union[str, SamModel] = "mobile_sam", imgsz: int = 1024, conf: float = 0.88,
                 iou: float = 0.7, seed: int = 0, device: Optional[Union[str, torch.device]] = None) -> None:
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        self.device = torch.device("cuda" if device is None else device)
        sam = model if isinstance(model, SamModel) else build_sam(model)
        if seed != 0 and not sam.loaded:
            from tamtr_torch.weights import init_sam_parameters

            init_sam_parameters(sam, seed)
        self.sam = sam.to(self.device).eval()
        self.imgsz = self.sam.img_size
        self.conf, self.iou = conf, iou
        self.mean, self.std = np.asarray(PIXEL_MEAN, np.float32), np.asarray(PIXEL_STD, np.float32)
        self.im: Optional[np.ndarray] = None  # the preprocessed (1, S, S, 3) image
        self.features: Optional[torch.Tensor] = None  # its (1, h, w, 256) embedding on the device
        self.prompts: Dict[str, Any] = {}
        self.segment_all = False
        self._src_shape: Optional[Tuple[int, int]] = None  # the image's own (h, w)
        self._ratio = 1.0
        self._img_path = "image"

    # ------------------------------------------------------------ image I/O
    def preprocess(self, img_bgr: np.ndarray) -> np.ndarray:
        """A BGR uint8 image letterboxed top-left to (S, S) (the resize
        cv2's, the fill 114), RGB, (x - mean) / std: (1, S, S, 3) float32."""
        h, w = img_bgr.shape[:2]
        r = min(self.imgsz / h, self.imgsz / w)
        nh, nw = round(h * r), round(w * r)
        canvas = np.full((self.imgsz, self.imgsz, 3), 114, np.uint8)
        canvas[:nh, :nw] = resize_linear(img_bgr, (nw, nh))
        rgb = canvas[..., ::-1].astype(np.float32)
        self._src_shape, self._ratio = (h, w), r
        return ((rgb - self.mean) / self.std)[None]

    @torch.inference_mode()
    def _encode(self, im: np.ndarray) -> torch.Tensor:
        return self.sam.image_encoder(torch.from_numpy(np.ascontiguousarray(im)).to(self.device))

    def set_image(self, image: Any) -> None:
        """Encode one image (an array, or the first of a path's images) and
        keep its embedding."""
        name, frame = next(load_inference_source(image))
        self._img_path = name
        self.im = self.preprocess(frame)
        self.features = self._encode(self.im)

    def reset_image(self) -> None:
        self.im = None
        self.features = None

    def set_prompts(self, prompts: Dict[str, Any]) -> None:
        self.prompts = prompts

    # -------------------------------------------------------------- prompts
    @torch.inference_mode()
    def prompt_inference(self, bboxes: Optional[np.ndarray] = None, points: Optional[np.ndarray] = None,
                         labels: Optional[np.ndarray] = None, masks: Optional[np.ndarray] = None,
                         multimask_output: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Masks from prompts in the image's own pixels (scaled by the
        letterbox ratio, or by 1 in segment-everything mode); one prompt
        a box, a point (N, 2) or a point set (N, P, 2), a mask (N, h, w).
        Returns (low-res mask logits (N * d, 4h, 4w), scores (N * d,)), d =
        3 with multimask_output (the decoder's outputs 1:), else 1 (output 0)."""
        assert self.features is not None, "call set_image() first"
        r = 1.0 if self.segment_all else self._ratio
        dev = self.device
        pts = box_t = mask_t = None
        if points is not None:
            p = np.asarray(points, np.float32) * r
            p = p[None] if p.ndim == 1 else p
            p = p[:, None, :] if p.ndim == 2 else p  # (N, 1, 2): one point a prompt
            lab = np.ones(p.shape[:2], np.int32) if labels is None else np.asarray(labels, np.int32).reshape(
                p.shape[:2])
            pts = (torch.from_numpy(p).to(dev), torch.from_numpy(lab).to(dev))
        if bboxes is not None:
            b = np.asarray(bboxes, np.float32) * r
            box_t = torch.from_numpy(b[None] if b.ndim == 1 else b).to(dev)
        if masks is not None:
            m = np.asarray(masks, np.float32)
            mask_t = torch.from_numpy(m[..., None] if m.ndim == 3 else m).to(dev)
        pe = self.sam.prompt_encoder
        sparse, dense = pe(points=pts, boxes=box_t, masks=mask_t)
        lowres, iou_pred = self.sam.mask_decoder(self.features, pe.get_dense_pe(), sparse, dense)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        lowres, scores = lowres[:, sl].cpu().numpy(), iou_pred[:, sl].cpu().numpy()
        return lowres.reshape(-1, *lowres.shape[2:]), scores.reshape(-1)

    # ------------------------------------------------------------- generate
    def generate(self, im: Optional[np.ndarray] = None, crop_n_layers: int = 0,
                 crop_overlap_ratio: float = 512 / 1500, crop_downscale_factor: int = 1,
                 point_grids: Optional[List[np.ndarray]] = None, points_stride: int = 32,
                 points_batch_size: int = 64, conf_thres: float = 0.88, stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 0.95,
                 crop_nms_thresh: float = 0.7) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Segment everything in the image of `set_image`: for each crop
        (the whole image, then `crop_n_layers` layers of overlapping crops,
        each re-encoded from its upscaled pixels) a grid of point prompts
        in batches, multimask; masks kept above `conf_thres` and
        `stability_score_thresh`, boxed at low resolution, off the crop's
        edges, NMS at `iou`; then upscaled into the image and, across
        crops, NMS preferring smaller crops. Returns (masks (N, S, S) bool,
        scores (N,), boxes (N, 4) xyxy) at the model's input size."""
        self.segment_all = True
        assert self.im is not None, "call set_image() first"
        S = self.imgsz
        canvas = None  # the image's pixels, for the crops' re-encoding
        crop_regions, layer_idxs = amg.generate_crop_boxes((S, S), crop_n_layers, crop_overlap_ratio)
        if point_grids is None:
            point_grids = amg.build_all_layer_point_grids(points_stride, crop_n_layers, crop_downscale_factor)
        all_masks, all_scores, all_boxes, region_areas = [], [], [], []
        for crop_region, layer_idx in zip(crop_regions, layer_idxs):
            x1, y1, x2, y2 = crop_region
            w, h = x2 - x1, y2 - y1
            saved = None
            if (x1, y1, x2, y2) == (0, 0, S, S):
                if self.features is None:
                    self.features = self._encode(self.im)
            else:  # re-encode the upscaled crop
                if canvas is None:
                    canvas = (self.im[0] * self.std + self.mean).astype(np.float32)
                crop = resize_linear_f32(np.ascontiguousarray(canvas[y1:y2, x1:x2]), (S, S))
                saved, self.features = self.features, self._encode(((crop - self.mean) / self.std)[None])
            points_for_image = point_grids[layer_idx] * np.array([[w, h]], np.float32)
            crop_masks, crop_scores = [], []
            for (pts,) in amg.batch_iterator(points_batch_size, points_for_image):
                lowres, score = self.prompt_inference(points=pts, multimask_output=True)
                keep = score > conf_thres
                lowres, score = lowres[keep], score[keep]
                if len(lowres):
                    keep = amg.calculate_stability_score(lowres, self.sam.mask_threshold,
                                                         stability_score_offset) > stability_score_thresh
                    lowres, score = lowres[keep], score[keep]
                if len(lowres):
                    crop_masks.append(lowres > self.sam.mask_threshold)
                    crop_scores.append(score)
            if crop_masks:
                masks_lr, scores = np.concatenate(crop_masks), np.concatenate(crop_scores)
                hl, wl = masks_lr.shape[-2:]
                boxes_px = amg.batched_mask_to_box(masks_lr).astype(np.float32) * np.array(
                    [w / wl, h / hl, w / wl, h / hl], np.float32)
                edge = amg.is_box_near_crop_edge(boxes_px, crop_region, [0, 0, S, S])
                masks_lr, boxes_px, scores = masks_lr[~edge], boxes_px[~edge], scores[~edge]
                keep = _nms_numpy(boxes_px, scores, self.iou)
                for m, b, s in zip(masks_lr[keep], boxes_px[keep], scores[keep]):
                    full = np.zeros((S, S), bool)
                    full[y1:y2, x1:x2] = resize_linear(m.astype(np.uint8), (w, h)).astype(bool)
                    all_masks.append(full)
                    all_boxes.append(b + np.array([x1, y1, x1, y1], np.float32))
                    all_scores.append(float(s))
                    region_areas.append(float(w * h))
            if saved is not None:
                self.features = saved
        if not all_masks:
            return np.zeros((0, S, S), bool), np.zeros((0,)), np.zeros((0, 4), np.float32)
        masks, boxes, scores = np.stack(all_masks), np.stack(all_boxes), np.asarray(all_scores, np.float32)
        if len(crop_regions) > 1:  # prefer the masks of smaller crops
            keep = _nms_numpy(boxes, 1.0 / np.asarray(region_areas, np.float32), crop_nms_thresh)
            masks, boxes, scores = masks[keep], boxes[keep], scores[keep]
        return masks, scores, boxes

    # ----------------------------------------------------------- full runs
    def __call__(self, source: Any = None, bboxes=None, points=None, labels=None, masks=None,
                 multimask_output: bool = False, **generate_kwargs: Any) -> List[Results]:
        """One `Results` per image of `source` (or the image already set):
        promptable segmentation when a prompt is given (prompts of
        `set_prompts` first), else `generate`; masks and boxes in the
        image's own pixels."""
        bboxes = self.prompts.pop("bboxes", bboxes)
        points = self.prompts.pop("points", points)
        masks = self.prompts.pop("masks", masks)
        frames = load_inference_source(source) if source is not None else [(self._img_path, None)]
        results: List[Results] = []
        for name, frame in frames:
            if frame is not None:
                self.im = self.preprocess(frame)
                self._img_path = name
                self.features = self._encode(self.im)
            if bboxes is None and points is None and masks is None:
                results.append(self._to_results(name, *self.generate(**generate_kwargs)))
            else:
                lowres, score = self.prompt_inference(bboxes, points, labels, masks, multimask_output)
                m_full = self._upscale_masks(lowres)
                results.append(self._to_results(name, m_full, score,
                                                amg.batched_mask_to_box(m_full).astype(np.float32)))
            self.segment_all = False
        return results

    def _upscale_masks(self, lowres: np.ndarray) -> np.ndarray:
        """Low-res logits -> bool masks at the model's input size (a float32
        bilinear resize, thresholded)."""
        S = self.imgsz
        out = np.zeros((len(lowres), S, S), bool)
        for i, m in enumerate(lowres):
            out[i] = resize_linear_f32(m.astype(np.float32), (S, S)) > self.sam.mask_threshold
        return out

    def _to_results(self, path: str, masks: np.ndarray, scores: np.ndarray, boxes: np.ndarray) -> Results:
        """Masks and boxes from the model's input size to the image's own:
        the letterboxed part of each mask resized (uint8, as cv2), boxes
        divided by the ratio and clipped; labels 0..N-1 named by index."""
        oh, ow = self._src_shape if self._src_shape else (self.imgsz, self.imgsz)
        r = self._ratio
        nh, nw = round(oh * r), round(ow * r)
        out_masks = np.zeros((len(masks), oh, ow), bool)
        for i, m in enumerate(masks):
            out_masks[i] = resize_linear(m[:nh, :nw].astype(np.uint8), (ow, oh)).astype(bool)
        out_boxes = boxes / r
        out_boxes[:, [0, 2]] = out_boxes[:, [0, 2]].clip(0, ow)
        out_boxes[:, [1, 3]] = out_boxes[:, [1, 3]].clip(0, oh)
        return Results(path=path, boxes=out_boxes, scores=np.asarray(scores, np.float32),
                       labels=np.arange(len(masks)), names=[str(i) for i in range(len(masks))],
                       orig_shape=(oh, ow), masks=out_masks.astype(np.float32))

    @staticmethod
    def remove_small_regions(masks: np.ndarray, min_area: int = 0,
                             nms_thresh: float = 0.7) -> Tuple[np.ndarray, np.ndarray]:
        """Each mask's holes and islands below min_area removed
        (`amg.remove_small_regions`), then NMS preferring the masks that
        did not change; (masks, kept indices)."""
        if len(masks) == 0:
            return masks, np.zeros((0,), np.int64)
        new_masks, scores = [], []
        for mask in masks:
            m, changed_h = amg.remove_small_regions(mask.astype(np.uint8), min_area, mode="holes")
            m, changed_i = amg.remove_small_regions(m, min_area, mode="islands")
            new_masks.append(m)
            scores.append(float(not changed_h and not changed_i))
        new_masks = np.stack(new_masks)
        boxes = amg.batched_mask_to_box(new_masks).astype(np.float32)
        keep = _nms_numpy(boxes, np.asarray(scores, np.float32), nms_thresh)
        return new_masks[keep], keep
