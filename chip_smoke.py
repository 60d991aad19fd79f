"""Smoke run of the PyTorch port (`tamtr_torch`) on one NVIDIA H100.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions. Without a card the script exits non-zero and prints no result.
2. build: nvcc over `tamtr_torch/csrc/*.cu` (one process per source, all
   started together); prints the seconds and the ptxas register lines.
3. kernels: each hand-written kernel against its plain PyTorch version at the
   640 px main-path shapes: the SS2D scan forward (B1: segment summaries,
   the combine across segments, the output pass) at its three levels, B=1
   and B=4 (1e-4), two calls bitwise equal, the call and each launch timed
   and bounded with its resident blocks per SM; the bilinear pair gather (B2)
   at value (1, 33600, 8, 64), Q=100, and (4, 33600, 8, 64), Q=700 (1e-5),
   two calls bitwise equal, timed (CUDA events, and device time by
   torch.profiler) and bounded at both (and again in the train phase on the
   training step's own pairs); the scan backward (B3a
   segment summaries, the combine across segments, B3b segment walk) at the
   three levels, B=4, all eight gradients (2e-3), two calls bitwise equal,
   each launch timed and bounded on its own with its resident blocks per SM;
   the gather backward (B4: pair buckets, then the row-owned pass) at value
   (4, 33600, 8, 64), Q=700, dvalue, dw and the gradient to sampling
   locations and attention weights (1e-5), the buckets equal to their plain
   version, dvalue bitwise over two calls and equal to the plain row-owned
   version, also on a row of 1440 terms, each launch timed (and again in
   the train phase on the training step's own pairs: hundreds of terms on
   a row); the matcher's
   assignment (B5, `auction_assignment`, one launch) at cost (16, 100, 300)
   from the matcher's cost over a VisDrone-like batch with an over-full and a
   contested image, identical to the CPU's, with no host sync, and
   `auction_match` (two launches) identical to its plain version. Times
   from CUDA events, warm; the bound from this run's bytes and operations.
   Then the kernels of the one-direction scan and the scatters, and the
   auction at any size: B6 `selective_scan` (segment summaries, the combine
   across segments, the output pass) at G = 4 (one image x 4 directions)
   and (L, Din) = (25600, 256), (6400, 512), (1600, 1024), N = 16, and at a
   ragged L = 1619, Din = 1000 without D (1e-4), two calls bitwise equal,
   three launches a call, the call and each launch timed and bounded with
   its resident blocks per SM; B7 `scatter_acc` (the value gradient of
   `weighted_gather`: buckets, then the rows pass) at value
   (4, 33600, 8, 64), Q = 700, p4 = 48, and B8 `scatter_acc_pairs` (the
   same two launches) at G = 32, L2 = 33600, c = 64, Q = 700, 24 pairs per
   query, each on uniform and on clustered sampling points: 1e-5 from the
   plain version (uniform), bitwise over two calls and bitwise the plain
   row-owned version, the buckets equal to theirs, within each row's fp32
   summation bound of the fp64 sum; the call and the buckets launch timed,
   beside `scatter_add_` of the same updates; B5 (`auction_assignment` and
   `auction_match`) at 160 problems of (100, 300) and 16 of (100, 600),
   beyond a block's shared memory, over-full problems in both (identical
   assignments). At RT-DETR's shapes: B2 at value (1, 33600, 8,
   32), Q = 300 and B2 and B4 at (4, 33600, 8, 32), Q = 900 (head width
   32: half of a row's lanes idle), with the same checks; B5 at cost (28,
   300, 300), 7 matched layers x 4 images, the global-memory value path.
4. ops: the public ops off the model paths, with every launch counter
   zeroed just before and read just after: `nn.ssm.selective_scan` forward
   (one call, three launches) and backward at the three level shapes, `weighted_gather` forward and
   backward and `scatter_acc_pairs` at the decoder shapes, `auction_match`
   (batch-wide stop, row mask) on the transposed train cost. Each of B6-B8
   and `auction_match` must have launched; serve and train count 0 for
   them.
4a. sp_blocks: the sequence-parallel scans (`tamtr_torch/parallel/
   seq_scan.py`) with their n blocks in this process (`LocalBlocks`, the
   all-gather a stack) at the three 640 px levels, batch 4, n = 2 and 4:
   `ss2d_scan_sp` forward and all eight gradients against `ss2d_scan` and
   `ss2d_scan_bwd` (1e-4, 2e-3), `selective_scan_sp` against
   `selective_scan` at G = 4 (1e-4; the backward, plain torch in both,
   2e-3), each bitwise over two calls; at the middle level both also
   against their plain blocked versions (`ss2d_scan_sp_ref`,
   `selective_scan_sp_ref`, the plain seeded scans on the same card
   tensors) at the same bounds. The launch counters, zeroed before each
   of the two blocked calls and read after it, must show per block the summaries,
   the combine twice (a dry run for the block's summary, then seeded with
   the state entering it) and the output (or B3's combine twice and the
   walk). The blocked calls timed beside the unsplit ones, and the dry and
   seeded combines of B1, B3 and B6 alone, one block of 2, with bounds.
4b. ss2d_pieces: `ss2d_scan` at state sizes 8 and 24 and width 96 (not a
   multiple of 32), on the pieces of `ss2d_pieces`: forward (1e-4) and all
   eight gradients (2e-3) against the plain scan; B1 and B3 once a piece.
4c. jpeg: every committed JPEG fixture (`tests/torch_data/jpeg`, written by
   `tools/make_jpeg_fixtures_torch.py`: baseline and progressive) decoded by
   the host C++ decoder to the sha256 digest cv2 gave (the machine has no
   cv2), and its decode encoded by the host C++ encoder
   (`csrc/jpeg_encode.cpp`) to the sha256 of `cv2.imencode`'s bytes; host
   decode and encode ms per megapixel. The WebP and TIFF fixtures
   (`tests/torch_data/webp`, `tests/torch_data/tiff`, written by
   `tools/make_image_fixtures_torch.py`) decoded by `imread`
   (`csrc/webp_decode.cpp`, `csrc/tiff_decode.cpp`) to their cv2 digests,
   `image_shape` from their headers; host decode ms per megapixel. The
   writers: each decode, the 1360x765 JPEG fixture's and a plot drawn over
   it (`tests/torch_data/encode/expected.json`) encoded by `encode_tiff`
   (`csrc/tiff_encode.cpp`) to the sha256 of `cv2.imencode(".tif")`'s
   bytes and by `encode_webp` (`csrc/webp_encode.cpp`) to a lossless WebP
   that `decode_webp` gives back exactly, in at most 1.5x cv2's bytes; host
   encode ms per megapixel of each writer.
5. parity: the full-width `tamtr.yaml` model (nc=10) at 128 px, batch 2,
   on the card and on the CPU with the same state dict, compared as a
   tie-robust set at 1e-3. The whole run keeps TF32 off (full fp32).
6. train parity: the same model at 128 px, batch 2, max_gt 8, CDN noise
   and DropPath off: loss components, assignments, gradients and the
   parameters after one `Trainer.step`, card against CPU; the gradients with
   the CPU's assignment and top-k order held fixed, bounded against the fp32
   noise floor a CPU fp64 pass measures (`check_train_parity`).
7. serve: `TAMTR("tamtr.yaml", nc=10)` on the card answers a warm-up
   request at batch 1 and at batch 4, then 5 batch-1 requests and one
   batch-4 request of 1360x765 uint8 images (resized to 640 px on the card).
   Every launch counter is zeroed just before and read just after: each
   must equal `FORWARD_LAUNCHES` times the forwards.
7b. predict_files: `TAMTR.predict(<the fixture directory>)` of the same
   full-width model (nc 10, `spread_scores` weights, unit-norm random text
   rows as its classes) at 640 px, without and with TTA (640, 544 flipped,
   416): launches counted per run; two fixtures predicted on the card and
   on the CPU (one of them with TTA too), each forward compared as a set
   at 1e-3 and each image's detections; ms per image at both settings.
7c. serve_http: `ModelServer` on 127.0.0.1 over `AutoBackend` of that
   model (called from the server's one model thread); through
   `RemoteModel` batch 1 five times, batch 4 twice and 4 concurrent
   batch-1 requests, each reply bitwise the in-process forward; ms over
   HTTP beside the in-process ms.
7d. track: 12 generated 1360x765 frames (coloured boxes moving across
   noise, two crossing) written as JPEG by the host encoder and read back
   by the decoder; `TAMTR.track(<directory>)` of the same model at 640 px
   with `bytetrack` and with `botsort` (gmc_method="none", ReID): B1 and
   B2 once per forward, one forward per frame and tracker; the track ids
   equal, and the normalized boxes within 1e-3 of, those of the CPU's
   forward of each of the first TRACK_CPU_FRAMES frames fed to the same
   trackers (`update_result_with_tracks`); ms per frame split into read,
   model and tracker host time. Then a panned sequence (`pan_sequence`:
   TRACK_PAN_FRAMES frames of TRACK_HW cut from a smooth textured canvas
   moved by TRACK_PAN per frame, small boxes moving on it):
   `TAMTR.track(<directory>, tracker="botsort", with_reid=True)` with its
   default camera-motion compensation (sparseOptFlow) on the card, B1 and
   B2 once per forward; the card's detections of the first
   TRACK_CPU_FRAMES frames through a CPU BOTSORT (GMC on the CPU) give the
   same ids and boxes within 1e-3; each GMC method (`trackers/gmc.py`:
   sparseOptFlow, orb, sift, ecc) on the card over every frame, its map
   within 0.5 px of the pan at the frame's centre, and on the card and the
   CPU over the middle quarter of the first two frames, the card's map
   within the CPU tests' tolerances of the CPU's; GMC ms per frame on the
   card and on the CPU (all frames on the card, frames 2 and 3 on the CPU),
   per method.
7d-video. video: every committed video fixture (`tests/torch_data/video`,
   written by cv2.VideoWriter: `mp4v` in MP4 / MOV / M4V, `XVID` and
   `DIVX` in AVI, `MJPG` in AVI and MOV, one 94x70) read by
   `data/video_io.py:VideoReader` on this machine, without cv2: packets,
   fps, frame count and size, and each frame's BGR (and, for MPEG-4, luma)
   sha256, equal to cv2's as `expected.json` records them (MJPEG: to
   `cv2.imdecode` of each packet). The track phase's 12 frames written as
   an `.mp4` by the port's writer (`VideoWriter`, MPEG-4 Part 2; 1360x764,
   the odd last row dropped as cv2.VideoWriter drops it) and read back: the
   decoder's frames equal the encoder's reconstruction; host ms per frame
   of encoding and decoding and bytes per frame.
   `TAMTR.track(<that .mp4>, save=True)` (bytetrack) on the card: B1 and
   B2 once per forward, one forward per frame; its ids and normalized boxes
   (within 1e-6) equal those of tracking the decoded frames passed as
   arrays; the annotated `.mp4` reads back with 12 frames of 1360x764.
   `TAMTR.predict(<the .mp4>, vid_stride=2)`: frames #0, #2, ..., one
   forward each.
7e. fuse: the deploy fuse (`nn/fuse.py`, `fuse=True`) on the serve model
   of 7b at 640 px: the fused twin's pred against the unfused model's at
   batch 1 and 4 (1e-4 as a tie-robust set), B1 and B2 launched as often
   per forward by both; the aten convolution and batch_norm ops per forward
   and the CUDA kernels they launch (torch.profiler), unfused and fused;
   serve requests (`TAMTR.predict(images, text, fuse=...)`) at batch 1 and
   4 timed in rounds of unfused, fused, fused, unfused; `TAMTR.predict(<the
   fixture directory>, fuse=True)` against fuse=False (1e-4, the same
   labels).
7f. autobatch: `batch=-1`'s probes (`utils/autobatch.py`) for `tamtr.yaml`
   at 640 px, max_gt 300 with every slot a box: one training step at batch
   1 and at 2 and their peak memory, the fitted batch (0.60 of the card's
   memory), then one step at that batch: its loss finite and its peak
   0.60 +- 0.10 of the card's memory, or the run fails.
8. train: `TAMTR(...).trainer()` on `tamtr.yaml` at 640 px, batch 4,
   max_gt 300, accumulate 1, seeded synthetic batches (uint8 frames, 10
   classes, 30-250 valid gts per image, one over-full image); 2 warm-up
   steps, then every launch counter is zeroed, 5 timed steps run, and the
   counters must equal `TRAIN_LAUNCHES_PER_STEP` times 5.
9. fit: the dataset path. `Engine.train` on the generated dataset of
   `tools/smoke_train_torch.py` (640 px PNGs, 16 train and 8 val images,
   max_gt 32) with `tamtr.yaml` (nc 3): FIT_EPOCHS epochs at batch 4, 2
   loader workers, warmup 4, val and `last` each epoch; then
   `resume=True` for one epoch more, and `Engine.val` on `best`. Losses
   finite, metrics in [0, 1], FIT_EPOCHS + 1 rows in results.csv, the
   resumed run's epoch, ni, count and
   generator those of the checkpoint; the launch counters (zeroed before
   train and before val) equal the per-step and per-forward counts times
   the steps and forwards; the card's val forward on 2 val images equal to
   the CPU's with the same EMA weights (`same_set`). One JSON line: step ms,
   loader wait, val images/s, mAP, peak memory. plots=True: the run
   directory must hold `results.png`, `train_batch0-2.jpg` and
   `confusion_matrix.png`, each readable.
9-bf16. bf16: the compute path of `TAMTRModel.dtype` = bf16. The kernels
   B1 and B3 at the three 640 px levels, batch 4, and B2 and B4 at value
   (4, 33600, 8, 64), Q = 700, on bf16 sequence / value I/O against their
   plain bf16 versions (y within one bf16 step, the scan's bf16 gradients
   2e-2 and fp32 ones 2e-3, out 2e-2, dvalue bitwise the plain row-owned
   version and 3e-2 of the scatter-add form), two calls bitwise equal,
   the ms at bf16 beside the fp32 kernel's in turns, the bounds at bf16
   bytes; B6 at the three levels and B7 and B8 at the decoder's shapes at
   bf16 I/O beside fp32 (no model path runs them); then serve
   (`TAMTR.predict` at batch 1 and 4 with half=True and
   with fuse=True too, beside fp32, in turns; the card's bf16 output
   against its fp32 output and against the CPU's bf16, RMS over rows
   paired as sets), train (`Trainer.step` computing in bf16 beside fp32 at
   640 px, batch 4, max_gt 300: warm step ms, peak memory, busy share; the
   loss finite, every weight fp32) and fit (`Engine.train(bf16=True)` for
   one epoch of the fit dataset, its checkpoint fp32, then `Engine.val`
   with half=True), each with its launch counters zeroed before and read
   after. The kernels line carries the bf16 numbers (and the main path's
   bf16 launches for B1-B4) under `bf16` in the entries of B1-B4 and B6-B8.
9-variants. loss_variants: one full-width TAM-TR `Trainer.step` at 640 px,
   batch 4, max_gt 300 for each `DETRLossConfig` switch (`use_sl`,
   `use_svfl`, `nwd_loss`, `use_wiseiou`): finite, B1-B5 launched as
   `TRAIN_LAUNCHES_PER_STEP`, the loss equal to the CPU's on the same head
   outputs, targets and assignment (1e-5 relative).
9-yolo. yolo: `yolo-gelan.yaml` (nc 10, full width, seeded, heads spread):
   eval at 640 px, batch 1 and 4, of the serve frames, card = CPU (1e-3);
   fuse=True (1e-4) and half=True beside it; one training step card
   against CPU at 320 px, batch 2 (TAL tensors
   (2, 300, 2100): the assignment's moved anchors
   counted, at most 1% of the foreground; given the CPU's assignment the
   loss items and the gradient within 2x the CPU's fp32-vs-fp64 distance);
   `Trainer.step` timed (ms, peak, busy share); `Engine.train` 1 epoch of
   the fit dataset, val square and rect; predict of the JPEG fixtures with
   and without TTA; track of the track phase's frames (bytetrack); serve
   ms at batch 1 and 4. The launch counters, zeroed before, read after:
   no kernel runs on the Detect path.
9-rtdetr. rtdetr: `rtdetr.yaml` (AIFI, RTDETRDecoder; nc 10, full width,
   seeded, head spread): eval at 640 px, batch 1 and 4, card = CPU as a set
   (1e-3), `fuse=True` (1e-4) and `half=True` (RMS) beside it; serve ms at
   batch 1 and 4; one training step card against CPU at 320 px, batch 2,
   max_gt 300 (`detr_train_parity` of the whole model and of the head
   alone on its eval features: the assignments' agreeing share, and given
   the CPU's assignment and top-k order the gradient within 2x the CPU's
   fp32-vs-fp64 distance); `Trainer.step` timed (ms, device ms,
   peak, busy share); `Engine.train` one epoch of the fit dataset and
   `Engine.val` on its best; predict of the JPEG fixtures with and
   without TTA; track of the track frames. Each part's launch counters
   zeroed before and read after: B2 6 a forward and no scan; a step B2 6,
   pair_buckets 6, B4 6, `auction_assignment` 1.
9-heads. heads: ManbaDecoder, DecouplingManbaWorldDecoder,
   DecouplingDFLManbaWorldDecoder, locationManbaDecoder and
   DualRTDETRDecoder (levels [32, 36, 32, 36]) on `tamtr.yaml`'s wiring,
   full width, 160 px, batch 2: eval card = CPU (1e-3), one whole step
   on the card (finite), the head's step card vs CPU on the model's eval
   features given the CPU's assignment (`detr_train_parity`), the launches
   counted per head (`HEAD_VARIANTS`: B1 3 a forward but for Dual; B2 3 or
   6; a Dual step's B4 3).
9-classify. classify: `classify-gelan.yaml` (nc 10, full width, seeded,
   every BatchNorm calibrated): eval at 224 px, batch 1 and 16, card = CPU
   (1e-3 on logits and probabilities); `YOLO.predict` of the JPEG
   fixtures; one cross-entropy step card vs CPU at 224 px, batch 8 (the
   loss and the whole gradient within 2x the CPU's fp32-vs-fp64 distance);
   a timed step at batch 16 (ms, device ms, busy share, peak); one epoch of
   `YOLO.train` on a generated 3-class ImageFolder and val, `best.pt`
   reloaded. No kernel runs on the path.
9-sam. sam: seeded mobile_sam and sam_b at 1024 px, their zero tensors and
   norms spread, on the 1360x765 fixture, card vs CPU: the embedding
   (1e-3), 4 boxes, 4 multimask points and generate's batch of 64 grid
   points (logits 1e-3, scores 1e-4), `generate` on that 8x8 grid with
   conf -10, stability -1 and NMS IoU 1 (all 192 masks: the same count,
   sorted scores 1e-4, IoU >= 0.99 each), timed on the card; sam_l and sam_h one encode and one prompt batch on
   the card, timed, peak memory; FastSAM (`yolo-seg-gelan.yaml`) predict
   card vs CPU and its box and point prompts equal but for threshold ties;
   `auto_annotate` of the fixtures with a seeded yolo-gelan and mobile_sam,
   every label line a segment. No kernel runs on these paths.
9a. parallel: in a process of its own, `torch.distributed` over NCCL with
   a world of one rank on the card, deterministic algorithms on: one
   `Trainer.step` of `tamtr.yaml` at 640 px, batch 4, max_gt 300 under the
   data group, plain and with ZeRO, each bitwise the ungrouped step (an
   all-reduce over one rank is the identity; the ungrouped step bitwise
   its own repeat); then `Engine.train(fsdp=2)` for one epoch of the fit
   dataset and `Engine.val` under the group, the launch counters zeroed
   before each: B1-B5 must have launched. Several cards are not reached
   here: NCCL across cards is not measured.
9b. cli: `python -m tamtr_torch predict model=<fit's best.pt>
   source=<fixtures> save=True` in a subprocess (the JPEG fixtures and a
   lossless WebP, then a TIFF fixture as the source of a second predict in
   the same process), which prints its launch counters: exit 0, one line
   and one plot per image, written under the image's own name in its
   format (JPEG, lossless WebP, LZW TIFF), each read back.
9c. info: `TAMTR("tamtr.yaml").load(<fit's best.pt>).info()` on the card:
   its layers, params and GFLOPs at 640 px those of the same model on the
   CPU, the operation counts (`utils/profiler.py:flops_of`) equal exactly.
9d. export: the exporter (`engine/exporter.py`) and `AutoBackend`'s load
   side on the card (`export_phase`): `benchmark()` of the serve model
   (`serve_model`, tamtr.yaml, 640 px, b1) in the port's three formats
   (`torch`, `npz`, `torch_export`), each row `parity_ok`; that model and
   `yolo-gelan.yaml` (full width, nc 10, heads spread, BatchNorms calibrated)
   exported fp32 and half=True and loaded back, on two seeded inputs unlike
   the zeros traced: fp32 artifacts within 1e-5 of the live forward, half
   ones within 1e-5 of the live forward of the weights as they load (bf16-
   or float16-rounded; the half program against `program_of(model,
   half=True)`, JAX's half computation), each half artifact at most 0.55 of
   its fp32 one's size; the tamtr.yaml `.pt2` loaded in a fresh process,
   whose one forward launches B1 and B2 (through the `tamtr::` ops) as the
   live forward does (`launches_export` in the kernels line); b1 request ms
   of the live model and the `.pt2` in turns; `profile_model` at 320 and
   640 px; `Engine.tune(iterations=2, epochs=1)` on the fit dataset at 320
   px in this process and isolated (two finite rows each); `ensemble_predict` of two
   seeded models over 4 fixtures (each merged row a model's own).
9e. clip_text: a seeded full-width ViT-B/32 text tower of the port
   (`nn/clip_text.py`: 12 x 512, 8 heads, vocab 49408, 77 positions,
   projection 512) on the card against itself on the CPU (TF32 off) on 16
   seeded rows of ids with the end token at ragged places and its padding
   mask, under both pooling branches (first end token, argmax): embeddings
   and unit rows within 1e-4; the tower's forward timed by CUDA events on
   VisDrone's 10 names + "" and on 80 texts of 77 tokens (CPU ms beside);
   the tower written as a transformers directory (safetensors by
   `weight_files.write_safetensors`, a byte-level BPE vocabulary learnt by
   `train_byte_bpe`) in a temporary directory, and the class table made
   from it by `tools/encode_texts_torch.py` (`main`, `--data` a VisDrone
   names yaml, on the card): the 11 texts, unit rows within 1e-4 of
   `data/text.py:encode_texts(clip_model=..., device="cpu")`; then
   `tamtr.yaml` predict of the two parity fixtures with that table read
   as `text_embeddings` reads it (`class_text_embeddings(npz_path=...)`):
   B1 and B2 3 launches a forward. No kernel of the port runs in the
   tower.
9f. reference_ckpt: the reference's own checkpoint (`weight_files.py:
   read_reference_checkpoint`): a full-width `tamtr.yaml` (nc 10, the
   VisDrone names, `spread_scores` weights) written as ultralytics 8.0.201
   writes `last.pt` (`tools/make_reference_ckpt_torch.py`, the training
   layout: a half EMA module of the reference's classes) into a temporary
   directory; `TAMTR("tamtr.yaml").load(<file>)` with no device (the card),
   its nc and names the file's; predict of the two parity fixtures (B1 and
   B2 3 launches a forward: `launches_reference_ckpt` in the kernels line),
   equal within 1e-6 to the same fp16-rounded weights converted to the
   port's own layout (`tools/port_torch_weights_torch.py`) and loaded, and
   within 1e-3 (`same_results`) to `RTDETRWorld(<file>, device="cpu")`;
   `AutoBackend(<converted file>)` on the card equal within 1e-6 to the
   loaded model's forward; `python -m tamtr_torch predict model=<file>` in
   this process on one fixture (3 launches each); the load seconds, the
   file's bytes and the keys read.
The parallel phase's process runs beside the heads phase, and the cli
phase's beside info (for the script's time): neither of the
two in this process times anything, and each process counts its own
launches; the parallel phase's step times are then taken beside another
process's work on the card. In the export phase the fresh process and
the isolated tune trials run beside the yolo-gelan checks.
Every phase from 4b on zeroes the launch counters before it runs and checks
after it that B1 and B2 ran `FORWARD_LAUNCHES` times its forwards, and no
other kernel ran (B1 and B3 once a piece in ss2d_pieces).
The autobatch phase checks instead that its three steps launched each
kernel `TRAIN_LAUNCHES_PER_STEP` times three.
The fits after the fit phase's (bf16, yolo, rtdetr, parallel) load their
batches in the trainer's process (workers=0): the fit phase alone starts
loader worker processes, and measures their wait.
Each result line ends with the card's name and power limit in brackets,
and each phase's wall seconds follow it on a line "phase <name>: <s> s".
10. One JSON line of each phase's seconds (`phase_s`) and of how each
   kernel's device ms was taken (`device_ms_by`: torch.profiler, or CUDA
   events behind a spin kernel where the profiler recorded no kernel).
   One JSON line of the export phase's summary. One JSON line of per-kernel
   numbers (`launches_fit`: the fit phase's; `launches_video` and
   `launches_video_predict`: the video phase's track and predict;
   `launches_export`: the
   exported program's forward in a fresh process;
   `launches_yolo`, `launches_loss_variants`, `launches_rtdetr`,
   `launches_heads`, `launches_seg_pose`, `launches_classify`,
   `launches_sam`: those phases'; B2's, B4's and B5's RT-DETR shape
   rows), then the result line `{"ok": true, "device": {...}}` last.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the model's per-level shapes at 640 px: (H, W) and channels of the SS2D mixers
LEVELS_640 = [(160, 160, 128), (80, 80, 256), (40, 40, 512)]
# the training path: 4 images of 640 px, 300 gt slots; image 0 holds more
# valid gts than the 100 queries (over-full), image 1 >= 70 (contested)
TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT = 4, 640, 300
TRAIN_VALID = (250, 80, 30, 60)
WARMUP_STEPS, TIMED_STEPS = 2, 5
# launches per forward of the model: the scan (`ss2d_scan`, one a call, and
# its three launches: summaries, combine, output) once per VSS level, the
# gather once per decoder layer
FORWARD_LAUNCHES = {
    "ss2d_scan_fwd": 3, "ss2d_scan_fwd_summaries": 3, "ss2d_scan_fwd_combine": 3, "ss2d_scan_fwd_output": 3,
    "bilinear_gather_fwd": 3,
}
# launches per training step: the forward's, and the backward kernels of the
# scan (summaries, combine, walk) and the gather (buckets, rows) once per VSS
# level / decoder layer; the assignment once for the 4 matched layers x 4
# images in one launch (the over-full image solved transposed in it)
TRAIN_LAUNCHES_PER_STEP = {
    **FORWARD_LAUNCHES, "ss2d_scan_carriers": 3, "ss2d_scan_combine": 3, "ss2d_scan_bwd_walk": 3,
    "pair_buckets": 3, "bilinear_gather_bwd": 3, "auction_assignment": 1, "auction_match": 0,
    "selective_scan_fwd": 0, "selective_scan_fwd_summaries": 0, "selective_scan_fwd_combine": 0,
    "selective_scan_fwd_output": 0, "scatter_acc_buckets": 0, "scatter_acc": 0, "scatter_acc_pairs_buckets": 0,
    "scatter_acc_pairs": 0,
}
# calls of the ops phase: the scan at the three levels (one a call, and its
# three launches: summaries, combine, output), one weighted gather's
# backward and one pair scatter (each two launches: buckets, rows), one
# `auction_match` (two launches)
OPS_LAUNCHES = {"selective_scan_fwd": 3, "selective_scan_fwd_summaries": 3, "selective_scan_fwd_combine": 3,
                "selective_scan_fwd_output": 3, "scatter_acc_buckets": 1, "scatter_acc": 1,
                "scatter_acc_pairs_buckets": 1, "scatter_acc_pairs": 1, "auction_match": 1}
# the fit phase: the generated dataset of tools/smoke_train_torch.py
FIT_TRAIN, FIT_VAL, FIT_MAX_GT = 16, 8, 32
FIT_EPOCHS = 1  # the fit phase's first run (one epoch: the script's time); resume adds one
# the decoder's sampling at 640 px: batch 4, Q = 700 (dn queries included)
DEFORM_B, DEFORM_Q = 4, 700


CARD = ""  # the card's name and power limit as nvidia-smi prints them, set by main


def say(*args, **_):
    """A result line, with the card it ran on."""
    print(*args, f"[{CARD}]", flush=True)


def launch_counters():
    """Every kernel wrapper of the port, by kernel name."""
    from tamtr_torch.kernels.auction import auction_assignment, auction_match
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather, bilinear_gather_bwd, pair_buckets, scatter_acc, scatter_acc_buckets, scatter_acc_pairs,
        scatter_acc_pairs_buckets,
    )
    from tamtr_torch.kernels.selective_scan import (
        selective_scan, selective_scan_fwd_combine, selective_scan_fwd_output, selective_scan_fwd_summaries,
        ss2d_scan, ss2d_scan_bwd_walk, ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_fwd_combine,
        ss2d_scan_fwd_output, ss2d_scan_fwd_summaries,
    )

    return {"ss2d_scan_fwd": ss2d_scan, "ss2d_scan_fwd_summaries": ss2d_scan_fwd_summaries,
            "ss2d_scan_fwd_combine": ss2d_scan_fwd_combine, "ss2d_scan_fwd_output": ss2d_scan_fwd_output,
            "bilinear_gather_fwd": bilinear_gather,
            "ss2d_scan_carriers": ss2d_scan_carriers, "ss2d_scan_combine": ss2d_scan_combine,
            "ss2d_scan_bwd_walk": ss2d_scan_bwd_walk,
            "pair_buckets": pair_buckets, "bilinear_gather_bwd": bilinear_gather_bwd,
            "auction_assignment": auction_assignment, "auction_match": auction_match,
            "selective_scan_fwd": selective_scan, "selective_scan_fwd_summaries": selective_scan_fwd_summaries,
            "selective_scan_fwd_combine": selective_scan_fwd_combine,
            "selective_scan_fwd_output": selective_scan_fwd_output, "scatter_acc_buckets": scatter_acc_buckets,
            "scatter_acc": scatter_acc, "scatter_acc_pairs_buckets": scatter_acc_pairs_buckets,
            "scatter_acc_pairs": scatter_acc_pairs}


def zero_counters():
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    return counters


def synthetic_batch(seed: int, B: int, imgsz: int, M: int, n_valid, nc: int = 10, hd: int = 512):
    """A seeded VisDrone-like training batch: uint8 frames, small boxes
    (cxcywh, normalized), nc classes, n_valid[i] valid gts of M slots,
    unit-norm class text embeddings."""
    rng = np.random.default_rng(seed)
    mask = np.arange(M)[None] < np.asarray(n_valid)[:, None]
    boxes = np.concatenate([rng.uniform(0.03, 0.97, (B, M, 2)), rng.uniform(0.005, 0.08, (B, M, 2))], -1)
    txt = rng.standard_normal((1, nc, hd)).astype(np.float32)
    return {"img": rng.integers(0, 256, (B, imgsz, imgsz, 3), dtype=np.uint8),
            "txt_feats": txt / np.linalg.norm(txt, axis=-1, keepdims=True),
            "cls": rng.integers(0, nc, (B, M)).astype(np.int32),
            "bboxes": (boxes * mask[..., None]).astype(np.float32), "mask": mask}


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean ms of `fn` over `iters` back-to-back launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_MS_BY = {"profiler": 0, "events behind a spin": 0}  # how each `device_ms` was taken, counted
PHASE_S: dict = {}  # each phase's wall seconds, by name, as `timed` took them
T0 = time.perf_counter()  # the run's start


def device_ms(fn, iters: int) -> float:
    """Device ms per call of the CUDA kernels `fn` launches, summed, by
    torch.profiler: the launches' own time, without the host's enqueue
    (which CUDA events over back-to-back calls include once a kernel is
    shorter than its wrapper's host time). Where three sessions in a row
    record no kernel, as CUPTI now and then does, the calls are timed by
    `spin_events_ms` instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            DEVICE_MS_BY["profiler"] += 1
            return total / 1e3 / iters
    DEVICE_MS_BY["events behind a spin"] += 1
    return spin_events_ms(fn, iters)


def spin_events_ms(fn, iters: int) -> float:
    """Device ms per call of `fn` by CUDA events, the calls enqueued behind
    a spin kernel that lasts twice their host time: the card then runs
    them back to back, so the events time the device's work and not the
    host's enqueue. A call that waits for the card inside gets the host's
    time back, as `cuda_ms` has it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * max(host_s, 1e-3) * 2e9))  # cycles at up to 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_kernel_ms(prof):
    """The summed device ms of the CUDA kernels a profiler session
    recorded, or None where it recorded none (CUPTI now and then gives a
    session nothing): a step's busy time is then not measured."""
    total = sum(e.device_time for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return total or None


def timed(name: str, fn, *args, **kw):
    """`fn(*args, **kw)`, its wall seconds kept in PHASE_S[name] and printed."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_S[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {PHASE_S[name]} s", flush=True)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_inputs(g, B, H, W, C, dev):
    """Scan inputs at one level as SS2D passes them (dts_raw/Bs/Cs split
    from one x_proj result), with the model's init for dt_b, A and Ds, and a
    random dy for the backward."""
    from tamtr_torch.weights import dt_bias_init

    L, D, R, N = H * W, 2 * C, math.ceil(C / 16), 16
    layouts = torch.randn(B, 2, L, D, generator=g)
    x_dbl = torch.randn(B, 2, 2, L, R + 2 * N, generator=g) * 0.6
    dt_w = (torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5
    dt_b = dt_bias_init((4, D), g)
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(4, D, N).contiguous()
    Ds = torch.ones(4, D)
    dy = torch.randn(B, 4, L, D, generator=g)
    dts_raw, Bs, Cs = x_dbl.to(dev).split([R, N, N], -1)
    return [layouts.to(dev), dts_raw, dt_w.to(dev), dt_b.to(dev), A.to(dev), Bs, Cs, Ds.to(dev)], dy.to(dev)


def deform_inputs(g, B, Q, shapes, dev, nh=8, c=64, nl=3, P=4):
    """value, sampling locations and attention weights at the decoder's
    shapes, with a point in the global last pixel cell, one at x0 < 0 and
    one on a level boundary."""
    Lv = sum(h * w for h, w in shapes)
    value = torch.randn(B, Lv, nh, c, generator=g)
    loc = torch.rand(B, Q, nh, nl, P, 2, generator=g) * 1.1 - 0.05
    H2, W2 = shapes[2]
    loc[0, 0, 0, 2, 0] = torch.tensor([1 - 0.2 / W2, 1 - 0.2 / H2])  # last pixel cell of level 2
    loc[0, 1, 1, 0, 2] = torch.tensor([0.2 / shapes[0][1], 0.5])  # x0 < 0
    loc[0, 2, 0, 0, 3] = torch.tensor([1 - 0.3 / shapes[0][1], 1 - 0.3 / shapes[0][0]])  # level boundary
    w_att = torch.rand(B, Q, nh, nl, P, generator=g)
    w_att = w_att / w_att.sum((-1, -2), keepdim=True)
    return value.to(dev), loc.to(dev), w_att.to(dev)


def check_ss2d_scan(dev, batches=(1, TRAIN_BATCH)):
    """Kernel B1 vs its plain version at the three 640 px levels, batch 1 and
    4: within 1e-4, and a second call bitwise equal to the first. The call
    and each of its launches (segment summaries, the combine across
    segments, the output pass) timed alone, with their bounds and resident
    blocks per SM."""
    from tamtr_torch.kernels.selective_scan import (
        SEG_STEPS, fwd_occupancy, ss2d_scan, ss2d_scan_fwd_combine, ss2d_scan_fwd_output, ss2d_scan_fwd_summaries,
        ss2d_scan_ref,
    )

    g = torch.Generator().manual_seed(1)
    rows, err = [], 0.0
    for B in batches:
        for H, W, C in LEVELS_640:
            args, _ = scan_inputs(g, B, H, W, C, dev)
            L, D, R, N = H * W, 2 * C, args[2].shape[-1], 16
            S = -(-L // SEG_STEPS)
            y, again, want = ss2d_scan(*args), ss2d_scan(*args), ss2d_scan_ref(*args)
            torch.cuda.synchronize()
            e = (y - want).abs().max().item()
            ok = torch.allclose(y, want, atol=1e-4, rtol=1e-4) and bool(torch.isfinite(y).all())
            bitwise = torch.equal(y, again)
            del y, again, want
            ms = cuda_ms(lambda: ss2d_scan(*args), iters=5)
            plain = cuda_ms(lambda: ss2d_scan_ref(*args), iters=2) if B == 1 else \
                cuda_ms(lambda: ss2d_scan_ref(*args), iters=1, warmup=0)
            h_loc, sdt = ss2d_scan_fwd_summaries(*args[:7])
            ms_sum = cuda_ms(lambda: ss2d_scan_fwd_summaries(*args[:7]), iters=5)
            copies = iter([h_loc.clone() for _ in range(6)])  # the combine works in place
            ms_comb = cuda_ms(lambda: ss2d_scan_fwd_combine(args[4], next(copies), sdt, L), iters=5)
            h_in = ss2d_scan_fwd_combine(args[4], h_loc, sdt, L)
            ms_out = cuda_ms(lambda: ss2d_scan_fwd_output(*args, h_in), iters=5)
            occ = fwd_occupancy(R)
            del copies, h_loc, h_in, sdt
            # The function: layouts, x_dbl's dts_raw, B and C and the weights
            # read once, y written once; per (b, k, l, d) the dt projection
            # and softplus, per state lane the exp, the state update and C h,
            # and the D skip.
            x_in = 2 * B * L * D + 4 * B * L * (R + 2 * N) + 4 * D * (R + N + 2)
            b_fn = bound(4 * (x_in + 4 * B * L * D), 4 * B * L * D * (2 * R + 8 * N + 3))
            # Each launch alone, with the segment design's own traffic, the
            # (B, 4, S, D, 16) states and (B, 4, S, D) sums of dt. The
            # summaries read u, dts_raw, B and the weights and write both;
            # the combine reads both and rewrites the states; the output reads
            # the inputs and the states and writes y. Operations per (b, k, l,
            # d): the dt projection and softplus (2R + 5) in both passes; per
            # state lane the exp and ~4 in the summaries, ~6 in the output (C h
            # too); ~4 per (b, k, segment, d, n) in the combine.
            states, sums = 4 * B * S * D * N, 4 * B * S * D
            b_sum = bound(4 * (2 * B * L * D + 4 * B * L * (R + N) + 4 * D * (R + N + 1) + states + sums),
                          4 * B * L * D * (2 * R + 7 + 5 * N))
            b_comb = bound(4 * (2 * states + sums), 4 * states)
            b_out = bound(4 * (x_in + states + 4 * B * L * D), 4 * B * L * D * (2 * R + 10 + 7 * N))
            rows.append(dict(B=B, L=L, D=D, S=S, ms=ms, ms_summaries=ms_sum, ms_combine=ms_comb, ms_output=ms_out,
                             plain_ms=plain, bound_ms=b_fn[0], bound_by=b_fn[1], bound_summaries_ms=b_sum[0],
                             bound_summaries_by=b_sum[1], bound_combine_ms=b_comb[0], bound_combine_by=b_comb[1],
                             bound_output_ms=b_out[0], bound_output_by=b_out[1], blocks_per_sm=occ,
                             max_abs_err=e, bitwise_repeat=bitwise))
            say(f"ss2d_scan_fwd B={B} L={L} D={D} R={R} segments={S}: max_abs_err={e:.3g} bitwise repeat {bitwise} "
                  f"ms={ms:.4f} (summaries {ms_sum:.4f} + combine {ms_comb:.4f} + output {ms_out:.4f}) "
                  f"plain_ms={plain:.3f} bound_ms={b_fn[0]:.4f} ({b_fn[1]}); each launch with the segment states' "
                  f"traffic: summaries {b_sum[0]:.4f} ({b_sum[1]}) combine {b_comb[0]:.4f} ({b_comb[1]}) output "
                  f"{b_out[0]:.4f} ({b_out[1]}); blocks/SM {occ}", flush=True)
            if not (ok and bitwise):
                raise AssertionError(f"ss2d_scan kernel at B={B}, L={L}: max error {e}, bitwise repeat {bitwise}")
            err = max(err, e)
            del args
    return rows, err


def grid_sample_deform(value, shapes, loc, w_att):
    """The reference's per-level `F.grid_sample` formulation of the same
    gather (zeros padding, align_corners=False); a yardstick only."""
    import torch.nn.functional as F

    B, _, nh, c = value.shape
    _, Q, _, nl, P, _ = loc.shape
    levels = value.split([h * w for h, w in shapes], 1)
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        vl = levels[lvl].permute(0, 2, 3, 1).reshape(B * nh, c, h, w)
        grid = (2 * loc[:, :, :, lvl] - 1).transpose(1, 2).reshape(B * nh, Q, P, 2)
        sampled.append(F.grid_sample(vl, grid, mode="bilinear", padding_mode="zeros", align_corners=False))
    s = torch.stack(sampled, -2).flatten(-2)
    wt = w_att.transpose(1, 2).reshape(B * nh, 1, Q, nl * P)
    return (s * wt).sum(-1).view(B, nh, c, Q).permute(0, 3, 1, 2)


def gather_fwd_bound(value, idx2, w_pairs, Q: int):
    """B2's bound on these inputs: the value rows the pairs touch (after the
    last-row shift), idx2 and w_pairs read once, the output written once;
    two multiply-adds per pair and channel."""
    B, Lv, nh, c = value.shape
    rows = torch.cat([idx2.clamp(max=Lv - 2), idx2.clamp(max=Lv - 2) + 1], 1).long()
    touched = torch.unique((torch.arange(B, device=value.device)[:, None, None] * Lv + rows) * nh
                           + torch.arange(nh, device=value.device)).numel()
    nbytes = touched * c * 4 + idx2.numel() * 4 + w_pairs.numel() * 4 + B * Q * nh * c * 4
    return bound(nbytes, idx2.numel() * c * 4)


def time_gather_fwd(value, idx2, w_pairs, Q: int, plain, iters: int = 50):
    """B2 on (value, idx2, w_pairs): two calls bitwise equal, within 1e-5 of
    `plain()`; `ms`, the mean of back-to-back `bilinear_gather` calls by
    CUDA events (the host's enqueue included), as for every kernel;
    `ms_device`, the kernel's own time by the profiler; the plain version's
    ms and the bound."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather

    P = idx2.shape[1] // Q // 2
    call = lambda: bilinear_gather(value, None, w_pairs, idx2, P)  # noqa: E731 (idx4 is the CPU's)
    out, again, want = call(), call(), plain()
    torch.cuda.synchronize()
    e = (out - want).abs().max().item()
    ok = torch.allclose(out, want, atol=1e-5, rtol=1e-5) and bool(torch.isfinite(out).all())
    bitwise = torch.equal(out, again)
    del out, again, want
    ms = cuda_ms(call, iters=iters)
    ms_device = device_ms(call, iters=iters)
    plain_ms = cuda_ms(plain, iters=max(iters // 10, 2))
    b_ms, b_by = gather_fwd_bound(value, idx2, w_pairs, Q)
    return dict(ms=ms, ms_device=ms_device, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=e,
                bitwise_repeat=bitwise), ok and bitwise


def check_bilinear_gather(dev, Q: int = 100, c: int = 64):
    """Kernel B2 vs its plain version at the 640 px serve shape, value
    (1, 33600, 8, c), Q queries (1e-5): TAM-TR's c = 64, Q = 100, and
    RT-DETR's c = 32 (hd 256 over 8 heads), Q = 300; two calls bitwise
    equal, and the per-level `F.grid_sample` formulation beside it. At this
    size `ms` (CUDA events over back-to-back calls) is the wrapper's host
    time; the kernel's own is `ms_device` (profiler)."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather_ref
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(h, w) for h, w, _ in LEVELS_640]
    B, nl, P = 1, 3, 4
    Lv = sum(h * w for h, w in shapes)
    value, loc, w_att = deform_inputs(torch.Generator().manual_seed(2), B, Q, shapes, dev, c=c)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    if int(idx2.max()) != Lv - 1:
        raise AssertionError("the last-cell sample point did not reach the global last row")
    row, ok = time_gather_fwd(value, idx2, w_pairs, Q, lambda: bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P))
    lib = grid_sample_deform(value, shapes, loc, w_att)
    e_lib = (bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P) - lib).abs().max().item()
    lib_ms = cuda_ms(lambda: grid_sample_deform(value, shapes, loc, w_att), iters=20)
    say(f"bilinear_gather_fwd B={B} Lv={Lv} c={c} Q={Q}: max_abs_err={row['max_abs_err']:.3g} (plain vs grid_sample "
          f"{e_lib:.3g}), bitwise over two calls {row['bitwise_repeat']}; ms={row['ms']:.4f} (events over "
          f"back-to-back calls) ms_device={row['ms_device']:.5f} (profiler) plain_ms={row['plain_ms']:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={row['bound_ms']:.5f} ({row['bound_by']}; one launch costs more)",
          flush=True)
    if not (ok and e_lib < 1e-4):
        raise AssertionError(f"bilinear_gather kernel disagrees: {row} (grid_sample {e_lib})")
    return dict(**row, library_ms=lib_ms)


def check_ss2d_scan_bwd(dev, B: int = TRAIN_BATCH, levels=LEVELS_640):
    """Kernels B3a (segment summaries), the combine and B3b (segment walk)
    vs the plain backward at the three 640 px levels, batch 4: all eight
    gradients within 2e-3 (the JAX package's bound for its Pallas backward,
    `tests/test_pallas_scan.py:163-165`), and a second call bitwise equal to
    the first. Each launch is timed alone, with its resident blocks per SM."""
    from tamtr_torch.kernels.selective_scan import (
        SEG_STEPS, bwd_occupancy, ss2d_scan_bwd, ss2d_scan_bwd_ref, ss2d_scan_bwd_walk, ss2d_scan_carriers,
        ss2d_scan_combine,
    )

    g = torch.Generator().manual_seed(11)
    rows, err = [], 0.0
    for H, W, C in levels:
        args, dy = scan_inputs(g, B, H, W, C, dev)
        L, D, R, N = H * W, 2 * C, args[2].shape[-1], 16
        S = -(-L // SEG_STEPS)
        got = ss2d_scan_bwd(*args, dy)
        again = ss2d_scan_bwd(*args, dy)
        want = ss2d_scan_bwd_ref(*args, dy, chunk=512)  # 512-step chunks: fewer launches, same sums
        torch.cuda.synchronize()
        e = max((a - b).abs().max().item() for a, b in zip(got, want))
        ok = all(torch.allclose(a, b, atol=2e-3, rtol=2e-3) and bool(torch.isfinite(a).all())
                 for a, b in zip(got, want))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        plain = cuda_ms(lambda: ss2d_scan_bwd_ref(*args, dy, chunk=512), iters=1, warmup=0)
        layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, _ = args
        summ = ss2d_scan_carriers(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dy)
        ms_sum = cuda_ms(lambda: ss2d_scan_carriers(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dy), iters=3)
        copies = iter([[t.clone() for t in summ[:2]] for _ in range(4)])  # the combine works in place
        ms_comb = cuda_ms(lambda: ss2d_scan_combine(A, *next(copies), summ[2], L), iters=3)
        h_in, carry = ss2d_scan_combine(A, *summ, L)
        ms_walk = cuda_ms(lambda: ss2d_scan_bwd_walk(layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, dy, h_in, carry),
                          iters=3)
        whole = cuda_ms(lambda: ss2d_scan_bwd(*args, dy), iters=3)
        occ = bwd_occupancy(R)
        # The function's bound, for the kernels' pair: layouts,
        # x_dbl, dy and the weights read once; du, dz, dB, dC, dA written once.
        # Operations per (b, k, l, d): the dt projection and softplus in both
        # passes, and per state lane two exps and ~26 multiply-adds (state
        # update twice, g, ddA, dA, the four sums).
        x_in = 2 * B * L * D + 4 * B * L * (R + 2 * N) + 4 * B * L * D + 4 * D * (R + N + 2)
        grads = 2 * 4 * B * L * D + 2 * 4 * B * L * N + 4 * D * N
        b_fn = bound(4 * (x_in + grads), 4 * B * L * D * (4 * R + 28 * N + 10))
        # Each launch alone, with the segment design's own traffic: the
        # (B, 4, S, D, 16) summaries h_loc and r. B3a + combine read the
        # inputs and write the summaries (the combine's in-place pass counted
        # once); B3b reads the inputs and the summaries and writes the
        # gradients. Operations per (b, k, l, d): the dt projection and
        # softplus (2R + 5) in each; per state lane, B3a one exp and ~8
        # (state update, prod a, r), B3b one exp and ~18 (the state update,
        # g, ddA, dA, the four sums); the combine ~4 per (b, k, segment, d, n).
        summaries = 2 * 4 * B * S * D * N
        b_a = bound(4 * (x_in + summaries), 4 * B * L * D * (2 * R + 5 + 9 * N) + 4 * summaries)
        b_b = bound(4 * (x_in + summaries + grads), 4 * B * L * D * (2 * R + 10 + 19 * N))
        rows.append(dict(L=L, D=D, S=S, ms=ms_sum + ms_comb + ms_walk, ms_summaries=ms_sum, ms_combine=ms_comb,
                         ms_walk=ms_walk, ms_with_assembly=whole, plain_ms=plain, blocks_per_sm=occ,
                         bound_ms=b_fn[0], bound_by=b_fn[1], bound_b3a_ms=b_a[0], bound_b3a_by=b_a[1],
                         bound_b3b_ms=b_b[0], bound_b3b_by=b_b[1], max_abs_err=e, bitwise_repeat=bitwise))
        say(f"ss2d_scan_bwd B={B} L={L} D={D} R={R} segments={S}: max_abs_err={e:.3g} bitwise repeat {bitwise} "
              f"ms={ms_sum + ms_comb + ms_walk:.4f} (B3a summaries {ms_sum:.4f} + combine {ms_comb:.4f}, "
              f"B3b walk {ms_walk:.4f}; with the torch assembly {whole:.4f}) plain_ms={plain:.3f} "
              f"bound_ms {b_fn[0]:.4f} ({b_fn[1]}); each launch with the summaries' traffic: "
              f"B3a {b_a[0]:.4f} ({b_a[1]}) B3b {b_b[0]:.4f} ({b_b[1]}); blocks/SM {occ}", flush=True)
        if not (ok and bitwise):
            raise AssertionError(f"ss2d_scan backward kernels at L={L}: max error {e}, bitwise repeat {bitwise}")
        err = max(err, e)
        del args, dy, got, want, summ, h_in, carry
    return rows, err


def check_bilinear_gather_bwd(dev, B: int = TRAIN_BATCH, Q: int = 700, c: int = 64):
    """Kernel B4's two launches (`pair_buckets`, then the rows pass) vs the
    plain backward at the 640 px training shape (dn queries included):
    dvalue and dw within 1e-5 of the scatter-add form; the buckets equal
    `pair_buckets_ref`; dvalue bitwise equal over two calls and to the plain
    row-owned version (the same multiply and add per term in pair order),
    here and on a hot row (all pairs of one image and head on one start
    row, 1440 terms); the gradient to value, sampling locations and attention weights
    through `ms_deform_attn_core` against autodiff of the plain 4-corner
    gather within 1e-5 of each tensor's largest entry. The forward kernel B2
    is held against its plain version at this shape first (1e-5, two calls
    bitwise equal), which covers its per-image offsets, and timed and
    bounded there. Each launch timed and bounded alone. TAM-TR's head width
    c = 64 at Q = 700; RT-DETR's c = 32 (half of a warp's 16 lanes of a row
    idle) at Q = 900 (300 queries and 600 CDN queries at max_gt 300)."""
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_bwd_rows_ref, bilinear_gather_ref,
        pair_buckets, pair_buckets_ref,
    )
    from tamtr_torch.nn.decoder import deform_sampling_pairs, ms_deform_attn_core

    shapes = [(h, w) for h, w, _ in LEVELS_640]
    nh, nl, P = 8, 3, 4
    Lv = sum(h * w for h, w in shapes)
    g = torch.Generator().manual_seed(12)
    value, loc, w_att = deform_inputs(g, B, Q, shapes, dev, c=c)
    dout = torch.randn(B, Q, nh, c, generator=g).to(dev)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    if int(idx2.max()) != Lv - 1:
        raise AssertionError("the last-cell sample point did not reach the global last row")
    b2, b2_ok = time_gather_fwd(value, idx2, w_pairs, Q, lambda: bilinear_gather_ref(value, idx4, w_pairs, idx2, nl * P),
                                iters=20)
    b2["library_ms"] = cuda_ms(lambda: grid_sample_deform(value, shapes, loc, w_att), iters=5)
    say(f"bilinear_gather_fwd B={B} Lv={Lv} c={c} Q={Q}: max_abs_err={b2['max_abs_err']:.3g}, bitwise over two calls "
          f"{b2['bitwise_repeat']}; ms={b2['ms']:.4f} (events) ms_device={b2['ms_device']:.5f} (profiler) "
          f"plain_ms={b2['plain_ms']:.4f} library_ms={b2['library_ms']:.4f} (F.grid_sample) "
          f"bound_ms={b2['bound_ms']:.5f} ({b2['bound_by']})", flush=True)
    if not b2_ok:
        raise AssertionError(f"bilinear_gather kernel disagrees with its plain version at B={B}, Q={Q}: {b2}")
    dv, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    dv2, dw2 = bilinear_gather_bwd(value, idx2, w_pairs, dout)
    dv_ref, dw_ref = bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
    buckets, buckets_ref = pair_buckets(idx2, w_pairs, Lv), pair_buckets_ref(idx2, w_pairs, Lv)
    dv_rows = bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout)[0]
    repeat = torch.equal(dv, dv2) and torch.equal(dw, dw2)
    same_buckets = all(torch.equal(a, b) for a, b in zip(buckets, buckets_ref))
    rows_bitwise = torch.equal(dv, dv_rows)
    del dv2, dw2, dv_rows
    hot = idx2.clone()
    hot[1, :1440, 5] = 12345  # the pairs of 60 queries on one start row: 1440 terms
    dv_hot = bilinear_gather_bwd(value, hot, w_pairs, dout)[0]
    hot_repeat = torch.equal(dv_hot, bilinear_gather_bwd(value, hot, w_pairs, dout)[0])
    hot_rows = torch.equal(dv_hot, bilinear_gather_bwd_rows_ref(value, hot, w_pairs, dout)[0])
    del dv_hot, hot

    def grads(kernel: bool):
        ts = [t.detach().clone().requires_grad_() for t in (value, loc, w_att)]
        if kernel:
            out = ms_deform_attn_core(ts[0], shapes, ts[1], ts[2]).view(B, Q, nh, c)
        else:
            i4, wp, i2 = deform_sampling_pairs(shapes, ts[1], ts[2])
            out = bilinear_gather_ref(ts[0], i4, wp, i2, nl * P)
        return torch.autograd.grad(out, ts, dout)

    g_kernel, g_plain = grads(True), grads(False)
    torch.cuda.synchronize()
    e = max((a - b).abs().max().item() for a, b in ((dv, dv_ref), (dw, dw_ref)))
    ok = torch.allclose(dv, dv_ref, atol=1e-5, rtol=1e-5) and torch.allclose(dw, dw_ref, atol=1e-5, rtol=1e-5)
    # the location gradient sums the four corners' terms with opposite signs
    # (each up to W x |dw|): its error is bounded relative to the tensor's
    # largest entry, not entry by entry
    chain = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in zip(g_kernel, g_plain)]
    ok = ok and max(chain) < 1e-5 and repeat and same_buckets and rows_bitwise and hot_repeat and hot_rows
    ms = cuda_ms(lambda: bilinear_gather_bwd(value, idx2, w_pairs, dout), iters=20)
    ms_buckets = cuda_ms(lambda: pair_buckets(idx2, w_pairs, Lv), iters=20)
    # the buckets wrapper's host time exceeds its kernel's: device time too
    ms_device = device_ms(lambda: bilinear_gather_bwd(value, idx2, w_pairs, dout), iters=20)
    ms_buckets_device = device_ms(lambda: pair_buckets(idx2, w_pairs, Lv), iters=20)
    plain = cuda_ms(lambda: bilinear_gather_bwd_ref(value, idx2, w_pairs, dout), iters=5)
    lib_in = [t.detach().clone().requires_grad_() for t in (value, loc, w_att)]
    lib_out = grid_sample_deform(lib_in[0], shapes, lib_in[1], lib_in[2])
    lib_g = torch.autograd.grad(lib_out, lib_in, dout, retain_graph=True)
    e_lib = (lib_g[0] - g_plain[0]).abs().max().item()
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, dout, retain_graph=True), iters=5)
    b_ms, b_by, b_buckets, b_rows = gather_bwd_bounds(value, idx2, w_pairs, dout, buckets)
    say(f"bilinear_gather_bwd B={B} Lv={Lv} c={c} Q={Q}: max_abs_err={e:.3g} (dvalue, dw); buckets equal the plain "
          f"version {same_buckets}; dvalue bitwise over two calls {repeat}, bitwise the plain row-owned version "
          f"{rows_bitwise}; hot row: bitwise over two calls {hot_repeat}, the plain row-owned version {hot_rows}; "
          f"through the core, max error / max entry of d(value, loc, w_att) {[float(f'{c:.3g}') for c in chain]}; "
          f"dvalue vs grid_sample {e_lib:.3g}; ms={ms:.4f} (events; buckets alone {ms_buckets:.4f}) ms_device="
          f"{ms_device:.4f} (profiler; buckets {ms_buckets_device:.4f} bound {b_buckets:.5f}, rows "
          f"{ms_device - ms_buckets_device:.4f} bound {b_rows:.5f}) plain_ms={plain:.4f} library_ms={lib_ms:.4f} "
          f"(F.grid_sample backward) bound_ms={b_ms:.5f} ({b_by})", flush=True)
    if not ok:
        raise AssertionError(f"bilinear_gather backward kernel disagrees: {e}, repeat {repeat}, buckets "
                             f"{same_buckets}, rows {rows_bitwise}, hot {hot_repeat} {hot_rows}")
    return dict(ms=ms, ms_buckets=ms_buckets, ms_device=ms_device, ms_buckets_device=ms_buckets_device,
                ms_rows_device=ms_device - ms_buckets_device, plain_ms=plain, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bound_buckets_ms=b_buckets, bound_rows_ms=b_rows,
                max_abs_err=e, bitwise_repeat=repeat and hot_repeat), b2


def gather_bwd_bounds(value, idx2, w_pairs, dout, buckets):
    """B4's bound on these inputs, and each launch's alone: the function
    reads the touched value rows, dout, idx2 and w_pairs and writes dvalue
    and dw; the buckets read idx2 and w_pairs and write the offsets, the
    sorted ids and their weights; the rows pass reads those besides the
    function's own bytes."""
    B, Lv, nh, c = value.shape
    Q = dout.shape[1]
    rows = torch.cat([idx2.clamp(max=Lv - 2), idx2.clamp(max=Lv - 2) + 1], 1).long()
    touched = torch.unique((torch.arange(B, device=value.device)[:, None, None] * Lv + rows) * nh
                           + torch.arange(nh, device=value.device)).numel()
    nbytes = (touched * c * 4 + dout.numel() * 4 + idx2.numel() * 4 + w_pairs.numel() * 4
              + value.numel() * 4 + w_pairs.numel() * 4)
    flops = B * Q * nh * (idx2.shape[1] // Q) * c * 8
    b_ms, b_by = bound(nbytes, flops)
    bucket_bytes = sum(t.numel() * 4 for t in buckets)
    return (b_ms, b_by, bound(idx2.numel() * 4 + w_pairs.numel() * 4 + bucket_bytes, 0)[0],
            bound(nbytes + bucket_bytes, flops)[0])


def most_terms_on_a_row(idx2, Lv: int) -> int:
    """The most terms a dvalue row of one (b, h) sums: the pairs starting on
    it and on the row above (after the last-row shift)."""
    s = torch.where(idx2 >= Lv - 1, Lv - 2, idx2).long()
    n = torch.zeros((idx2.shape[0], Lv + 1, idx2.shape[2]), device=idx2.device).scatter_add_(
        1, s, torch.ones_like(s, dtype=torch.float32))
    return int((n[:, 1:] + n[:, :-1]).max())


@contextlib.contextmanager
def recording_gather_bwd(calls: list):
    """Inside, every call of the gather backward (B4) appends its arguments
    to `calls` and goes on to the kernel; its launch counter counts as
    before."""
    from tamtr_torch.kernels import deform_scatter as ds

    bwd = ds.bilinear_gather_bwd

    def record(*args):
        calls.append(args)
        return bwd(*args)

    record.launches = bwd.launches  # the wrapper counts through its module's name
    ds.bilinear_gather_bwd = record
    try:
        yield
    finally:
        ds.bilinear_gather_bwd = bwd
        bwd.launches = record.launches


def check_gather_fwd_step(calls):
    """B2 on the training step's own pairs (the forward inputs of the three
    decoder layers' gathers, as `train` records them for B4): within 1e-5 of
    the plain pair form, two calls bitwise equal; per call, the CUDA-event
    ms, the device ms, the plain version's and the bound, on these inputs."""
    from tamtr_torch.kernels.deform_scatter import bilinear_gather_pairs_ref

    rows, ok = [], True
    for value, idx2, w_pairs, dout in calls:
        Q = dout.shape[1]
        row, good = time_gather_fwd(value, idx2, w_pairs, Q,
                                    lambda: bilinear_gather_pairs_ref(value, idx2, w_pairs, idx2.shape[1] // Q), iters=20)
        rows.append(row)
        ok &= good
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in ("ms", "ms_device", "plain_ms", "bound_ms")}
    err = max(r["max_abs_err"] for r in rows)
    say(f"bilinear_gather_fwd on the training step's pairs ({len(rows)} calls): max_abs_err={err:.3g}, bitwise "
          f"over two calls {all(r['bitwise_repeat'] for r in rows)}; per call ms={mean['ms']:.4f} (events) ms_device="
          f"{mean['ms_device']:.5f} (profiler) plain_ms={mean['plain_ms']:.4f} bound_ms={mean['bound_ms']:.5f}", flush=True)
    if not ok:
        raise AssertionError(f"bilinear_gather kernel disagrees on the step's pairs: {rows}")
    return {f"{k}_step": v for k, v in mean.items()} | dict(max_abs_err_step=err)


def check_gather_bwd_step(calls):
    """B4 on the training step's own pairs (`train` records the three
    decoder layers' calls of one step): dvalue bitwise over two calls and
    equal to the plain row-owned version, dvalue and dw within 1e-5 of the
    scatter-add form; per call, the kernel's ms (and its buckets'), the
    plain form's and the bound, on these inputs."""
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_bwd_rows_ref, pair_buckets,
    )

    err, ok, most = 0.0, True, 0
    bounds = [0.0, 0.0, 0.0]
    for value, idx2, w_pairs, dout in calls:
        Lv = value.shape[1]
        dv, dw = bilinear_gather_bwd(value, idx2, w_pairs, dout)
        ok &= torch.equal(dv, bilinear_gather_bwd(value, idx2, w_pairs, dout)[0])
        ok &= torch.equal(dv, bilinear_gather_bwd_rows_ref(value, idx2, w_pairs, dout)[0])
        dv_ref, dw_ref = bilinear_gather_bwd_ref(value, idx2, w_pairs, dout)
        ok &= torch.allclose(dv, dv_ref, atol=1e-5, rtol=1e-5) and torch.allclose(dw, dw_ref, atol=1e-5, rtol=1e-5)
        err = max(err, (dv - dv_ref).abs().max().item(), (dw - dw_ref).abs().max().item())
        most = max(most, most_terms_on_a_row(idx2, Lv))
        b = gather_bwd_bounds(value, idx2, w_pairs, dout, pair_buckets(idx2, w_pairs, Lv))
        bounds = [x + y / len(calls) for x, y in zip(bounds, (b[0], b[2], b[3]))]
        del dv, dw, dv_ref, dw_ref
    every = lambda fn: lambda: [fn(*args) for args in calls]  # noqa: E731
    n = len(calls)
    ms = cuda_ms(every(bilinear_gather_bwd), iters=20) / n
    ms_buckets = cuda_ms(every(lambda v, i, w, d: pair_buckets(i, w, v.shape[1])), iters=20) / n
    ms_device = device_ms(every(bilinear_gather_bwd), iters=20) / n
    ms_buckets_device = device_ms(every(lambda v, i, w, d: pair_buckets(i, w, v.shape[1])), iters=20) / n
    plain = cuda_ms(every(bilinear_gather_bwd_ref), iters=5) / n
    say(f"bilinear_gather_bwd on the training step's pairs ({n} calls, up to {most} terms on a row): "
          f"max_abs_err={err:.3g}; dvalue bitwise over two calls and equal to the plain row-owned version {ok}; "
          f"ms per call {ms:.4f} (events; buckets alone {ms_buckets:.4f}) ms_device {ms_device:.4f} (profiler; "
          f"buckets {ms_buckets_device:.4f} bound {bounds[1]:.5f}, rows {ms_device - ms_buckets_device:.4f} bound "
          f"{bounds[2]:.5f}) plain_ms={plain:.4f} bound_ms={bounds[0]:.5f}", flush=True)
    if not ok:
        raise AssertionError(f"bilinear_gather backward kernel disagrees on the step's pairs: {err}")
    return dict(ms_step=ms, ms_buckets_step=ms_buckets, ms_device_step=ms_device,
                ms_buckets_device_step=ms_buckets_device, ms_rows_device_step=ms_device - ms_buckets_device,
                plain_ms_step=plain, bound_ms_step=bounds[0], bound_buckets_ms_step=bounds[1], bound_rows_ms_step=bounds[2],
                max_abs_err_step=err, most_terms_on_a_row_step=most)


def matcher_costs(seed: int, n_images: int, M: int, n_valid, dev, nq: int = 100, layers: int = 4):
    """The matcher's cost (layers n_images, nq, M) for `layers` matched
    layers (TAM-TR's 4: the encoder and 3 decoder layers; RT-DETR's 7) over
    a VisDrone-like batch of n_images (random predictions, M gt slots,
    n_valid[i] valid), and its gt mask."""
    from tamtr_torch.losses.matcher import match_cost

    batch = synthetic_batch(seed, n_images, 64, M, n_valid)
    g = torch.Generator().manual_seed(seed)
    n = layers * n_images
    pred_b = torch.cat([torch.rand(n, nq, 2, generator=g), torch.rand(n, nq, 2, generator=g) * 0.1 + 0.005], -1)
    pred_s = torch.randn(n, nq, 10, generator=g) * 2 - 3
    gt = {k: torch.from_numpy(batch[k]).repeat(layers, *([1] * (batch[k].ndim - 1))) for k in ("bboxes", "cls", "mask")}
    C = match_cost(pred_b.to(dev), pred_s.to(dev), gt["bboxes"].to(dev), gt["cls"].to(dev))
    return C, gt["mask"].to(dev)


def check_auction(dev, layers: int = 4, nq: int = 100):
    """Kernel B5 on the matcher's cost over a VisDrone-like batch (4 matched
    layers x 4 images: cost (16, 100, 300), one over-full and one contested
    image; RT-DETR's 7 layers x 4 images of 300 queries: (28, 300, 300),
    whose value block exceeds a block's opt-in shared memory, the kernel's
    second path): `auction_assignment` in one launch identical to the CPU's
    (`auction_assignment_ref`, JAX's assignment) and to the plain version on
    the card, with no host sync (`torch.cuda.set_sync_debug_mode("error")`);
    `auction_match` (two launches, batch-wide stop) identical to
    `auction_match_ref` on the forward and the transposed solve."""
    from tamtr_torch.kernels.auction import (
        _oriented_setup, _rounds_ref, auction_assignment, auction_assignment_ref, auction_match, auction_match_ref,
    )

    n = layers * TRAIN_BATCH
    C, mask = matcher_costs(13, TRAIN_BATCH, TRAIN_MAX_GT, TRAIN_VALID, dev, nq=nq, layers=layers)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = auction_assignment(C, mask)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want_cpu = auction_assignment_ref(C.cpu(), mask.cpu())
    want = auction_assignment_ref(C, mask)
    qmask = torch.ones((n, nq), dtype=torch.bool, device=dev)
    Ct = C.transpose(1, 2).contiguous()
    solves = [(C, mask, None), (Ct, qmask, mask)]
    match_same = all(torch.equal(auction_match(c, m, row_mask=r), auction_match_ref(c, m, row_mask=r))
                     for c, m, r in solves)
    same = torch.equal(got.cpu(), want_cpu) and torch.equal(got, want) and match_same
    e = float(int((got.cpu() != want_cpu).sum()))
    ms = cuda_ms(lambda: auction_assignment(C, mask), iters=20)
    ms_match = sum(cuda_ms(lambda sv=sv: auction_match(sv[0], sv[1], row_mask=sv[2]), iters=5) for sv in solves)
    plain = cuda_ms(lambda: auction_assignment_ref(C, mask), iters=1)
    # bytes: the cost and mask read once, the assignment written once;
    # operations: per round every bidder scans its objects (subtract, two
    # compares), for the rounds each image's own solve needed in this run
    overfull = mask.sum(1) > nq
    rounds = []
    for b in range(n):
        value, pv, eps, target = _oriented_setup(C[b:b + 1], mask[b:b + 1], bool(overfull[b]))
        rounds.append(_rounds_ref(value.transpose(1, 2), eps, pv, target, 300, own_stop=True)[1])
    nbytes = C.numel() * 4 + mask.numel() + got.numel() * 4
    flops = sum(r * nq * TRAIN_MAX_GT * 3 for r in rounds)
    b_ms, b_by = bound(nbytes, flops)
    say(f"auction_assignment cost {tuple(C.shape)}: valid {TRAIN_VALID} x {layers} layers, rounds per image {rounds}, "
          f"assignments identical to the CPU's and the plain version's {same} (differing entries {e:.0f}), "
          f"no host sync (sync debug mode error), assigned per image {(got[:4] >= 0).sum(1).tolist()}, "
          f"ms={ms:.4f} (one launch) plain_ms={plain:.3f} bound_ms={b_ms:.5f} ({b_by}); "
          f"auction_match forward + transposed ms={ms_match:.4f}, identical {match_same}", flush=True)
    if not same:
        raise AssertionError("auction kernel assignments differ from the plain auction's")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=e,
                rounds=rounds, ms_auction_match_fwd_and_transposed=ms_match)


def check_auction_any_size(dev):
    """Kernel B5 at more problems than the card has SMs, 160 images of
    (100, 300) (4 matched layers x 40 images), and at 16 of (100, 600),
    whose value block exceeds a block's shared memory; over-full images in
    both. `auction_assignment` identical to the CPU's; `auction_match`
    (over-full problems run on to the batch's stop) identical to the plain
    auction on the same inputs."""
    from tamtr_torch.kernels.auction import auction_assignment, auction_assignment_ref, auction_match, auction_match_ref

    rows = {}
    for name, n_images, M, valid in (("problems160_m300", 40, 300, TRAIN_VALID * 10),
                                     ("problems16_m600", 4, 600, (560, 80, 30, 60))):
        C, mask = matcher_costs(15, n_images, M, valid, dev)
        got, want = auction_assignment(C, mask), auction_assignment_ref(C.cpu(), mask.cpu())
        got_m, want_m = auction_match(C, mask), auction_match_ref(C, mask)
        torch.cuda.synchronize()
        differ = int((got.cpu() != want).sum()) + int((got_m != want_m).sum())
        ms = cuda_ms(lambda: auction_assignment(C, mask), iters=3)
        ms_match = cuda_ms(lambda: auction_match(C, mask), iters=3)
        plain = cuda_ms(lambda: auction_assignment_ref(C, mask), iters=1, warmup=0)
        say(f"auction cost {tuple(C.shape)}: auction_assignment and auction_match identical to the plain "
              f"versions {differ == 0} (differing entries {differ}), assigned per problem min "
              f"{int((got >= 0).sum(1).min())} max {int((got >= 0).sum(1).max())}, auction_assignment ms={ms:.4f} "
              f"plain_ms={plain:.3f}, auction_match ms={ms_match:.4f}", flush=True)
        if differ:
            raise AssertionError(f"auction kernel assignments differ from the plain auction's at {tuple(C.shape)}")
        rows[name] = dict(shape=list(C.shape), ms=ms, plain_ms=plain, ms_auction_match=ms_match, differing=differ)
    return rows


def scan1d_inputs(g, L: int, Din: int, dev, G: int = 4, N: int = 16):
    """One-direction scan inputs at one level: G = one image x 4 directions,
    delta from the model's dt init (softplus of dt_b plus a small
    projection), A and D as the model initialises them; and a dy."""
    from tamtr_torch.kernels.selective_scan import softplus
    from tamtr_torch.weights import dt_bias_init

    u = torch.randn(G, L, Din, generator=g)
    delta = softplus(torch.randn(G, L, Din, generator=g) * 0.1 + dt_bias_init((G, 1, Din), g))
    A = -torch.arange(1, N + 1, dtype=torch.float32).expand(G, Din, N).contiguous()
    Bs, Cs = torch.randn(G, L, N, generator=g), torch.randn(G, L, N, generator=g)
    dy = torch.randn(G, L, Din, generator=g)
    return [t.to(dev) for t in (u, delta, A, Bs, Cs, torch.ones(G, Din))], dy.to(dev)


def check_selective_scan(dev):
    """Kernel B6 (segment summaries, the combine across segments, the output
    pass) vs the plain one-direction scan at the three 640 px levels, G = 4,
    N = 16, and at a ragged L and Din (L = 1619, Din = 1000, D None): within
    1e-4, a second call bitwise equal to the first, three launches a call.
    The call and each launch timed alone, with their bounds and resident
    blocks per SM."""
    from tamtr_torch.kernels.selective_scan import (
        SEG_STEPS, scan1d_occupancy, selective_scan, selective_scan_fwd_combine, selective_scan_fwd_output,
        selective_scan_fwd_summaries, selective_scan_ref,
    )

    phases = (selective_scan_fwd_summaries, selective_scan_fwd_combine, selective_scan_fwd_output)
    g = torch.Generator().manual_seed(16)
    rows, err = [], 0.0
    for L, Din, with_d in [(H * W, 2 * C, True) for H, W, C in LEVELS_640] + [(1619, 1000, False)]:
        args, _ = scan1d_inputs(g, L, Din, dev)
        if not with_d:
            args[5] = None
        u, delta, A, Bs, Cs, D = args
        G, N = u.shape[0], A.shape[-1]
        S = -(-L // SEG_STEPS)
        before = [f.launches for f in (selective_scan, *phases)]
        y, again = selective_scan(*args), selective_scan(*args)
        launches = [f.launches - b for f, b in zip((selective_scan, *phases), before)]
        want = selective_scan_ref(*args)
        torch.cuda.synchronize()
        e = (y - want).abs().max().item()
        ok = torch.allclose(y, want, atol=1e-4, rtol=1e-4) and bool(torch.isfinite(y).all())
        bitwise = torch.equal(y, again)
        del y, again, want
        ms = cuda_ms(lambda: selective_scan(*args), iters=5)
        plain = cuda_ms(lambda: selective_scan_ref(*args), iters=2)
        h_loc, sdt = selective_scan_fwd_summaries(u, delta, A, Bs)
        ms_sum = cuda_ms(lambda: selective_scan_fwd_summaries(u, delta, A, Bs), iters=5)
        copies = iter([h_loc.clone() for _ in range(6)])  # the combine works in place
        ms_comb = cuda_ms(lambda: selective_scan_fwd_combine(A, next(copies), sdt, L), iters=5)
        h_in = selective_scan_fwd_combine(A, h_loc, sdt, L)
        ms_out = cuda_ms(lambda: selective_scan_fwd_output(u, delta, A, Bs, Cs, D, h_in), iters=5)
        occ = scan1d_occupancy(N)
        del copies, h_loc, h_in, sdt
        # The function: u, delta, B, C, A and D read once, y written once;
        # per (g, t, d, n) dt A, the exp, a h, (dt u) B, the add, C h and the
        # sum over n; per (g, t, d) dt u and the D skip.
        x, bc, states, sums = G * L * Din, G * L * N, G * S * Din * N, G * S * Din
        w = G * Din * N + (G * Din if D is not None else 0)
        b_fn = bound(4 * (3 * x + 2 * bc + w), x * (7 * N + 3))
        # Each launch alone, with the segment design's own traffic, the
        # (G, S, Din, N) states and (G, S, Din) sums of delta: the summaries
        # read u, delta, B and A and write both (per (g, t, d, n) the exp and
        # ~3); the combine reads both and A and rewrites the states (~4 per
        # (g, segment, d, n)); the output reads the inputs and the states and
        # writes y (per (g, t, d, n) the exp and ~5, C h too).
        b_sum = bound(4 * (2 * x + bc + G * Din * N + states + sums), x * (4 * N + 2))
        b_comb = bound(4 * (2 * states + sums + G * Din * N), 4 * states)
        b_out = bound(4 * (3 * x + 2 * bc + w + states), x * (6 * N + 3))
        rows.append(dict(G=G, L=L, Din=Din, N=N, D=D is not None, S=S, ms=ms, ms_summaries=ms_sum,
                         ms_combine=ms_comb, ms_output=ms_out, plain_ms=plain, bound_ms=b_fn[0], bound_by=b_fn[1],
                         bound_summaries_ms=b_sum[0], bound_summaries_by=b_sum[1], bound_combine_ms=b_comb[0],
                         bound_combine_by=b_comb[1], bound_output_ms=b_out[0], bound_output_by=b_out[1],
                         blocks_per_sm=occ, launches_per_call=launches[0] / 2,
                         phase_launches_per_call=[n / 2 for n in launches[1:]], max_abs_err=e,
                         bitwise_repeat=bitwise))
        say(f"selective_scan_fwd G={G} L={L} Din={Din} N={N} D {D is not None} segments={S}: max_abs_err={e:.3g} "
              f"bitwise repeat {bitwise}, launches per call {launches[0] / 2} (phases "
              f"{[n / 2 for n in launches[1:]]}); ms={ms:.4f} (summaries {ms_sum:.4f} + combine {ms_comb:.4f} + "
              f"output {ms_out:.4f}) plain_ms={plain:.3f} bound_ms={b_fn[0]:.4f} ({b_fn[1]}); each launch with the "
              f"segment states' traffic: summaries {b_sum[0]:.4f} ({b_sum[1]}) combine {b_comb[0]:.4f} "
              f"({b_comb[1]}) output {b_out[0]:.4f} ({b_out[1]}); blocks/SM {occ}", flush=True)
        if not (ok and bitwise and launches == [2, 2, 2, 2]):
            raise AssertionError(f"selective_scan kernel at L={L}, Din={Din}: max error {e}, bitwise repeat "
                                 f"{bitwise}, launches over two calls {launches}")
        err = max(err, e)
        del args, u, delta, A, Bs, Cs, D
    return rows, err


def decoder_scatter_inputs(seed: int, dev, clustered: bool = False):
    """value (4, 33600, 8, 64) and the decoder's sampling at 640 px, Q = 700,
    with a dout: the generic gather's corner indices and weights (idx4, w4,
    p4 = 48) and the pair scatter's (idx2, wa, wb) (32, 16800) with dout
    (32, 700, 64), its pairs moved off the global last row as the callers of
    `_scatter_acc_pairs` do. `clustered` snaps the last level's points to
    3 x 3 cell centres (hundreds of updates on a row, as a training step's
    decoder at initialisation gives), the last-cell point kept."""
    from tamtr_torch.kernels.deform_scatter import _shift_last_row
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(h, w) for h, w, _ in LEVELS_640]
    Lv = sum(h * w for h, w in shapes)
    g = torch.Generator().manual_seed(seed)
    value, loc, w_att = deform_inputs(g, DEFORM_B, DEFORM_Q, shapes, dev)
    if clustered:
        last = loc[0, 0, 0, 2, 0].clone()
        loc[:, :, :, 2] = (torch.floor(loc[:, :, :, 2].clamp(0, 0.999) * 3) + 0.5) / 3
        loc[0, 0, 0, 2, 0] = last
    _, _, nh, c = value.shape
    dout = torch.randn(DEFORM_B, DEFORM_Q, nh, c, generator=g).to(dev)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    nU, nU2 = idx4.shape[1], idx2.shape[1]
    w4 = w_pairs.transpose(2, 3).reshape(DEFORM_B, nU, nh).contiguous()
    i2, wp, _ = _shift_last_row(idx2, w_pairs, Lv)
    G = DEFORM_B * nh
    per_g = lambda t: t.transpose(1, 2).reshape(G, nU2).contiguous()  # noqa: E731
    pairs = (per_g(i2).to(torch.int32), per_g(wp[..., 0]), per_g(wp[..., 1]),
             dout.transpose(1, 2).reshape(G, DEFORM_Q, c).contiguous())
    if int(pairs[0].max()) != Lv - 2:
        raise AssertionError("no pair starts at L2 - 2: the last-cell sample point is missing")
    return value, (idx4, w4, dout), pairs, Lv


def within_sum_bound(got, rows, upd):
    """got (fp32, (..., c)) against the fp64 sum of the updates `upd` (n, c)
    added to rows `rows` (n,) of its (rows, c) view: whether every entry is
    within its row's fp32 summation bound n_row 2^-24 sum |update| (any
    order of adds meets it), and the most updates on a row."""
    c = got.shape[-1]
    n_rows = got.numel() // c
    ref = torch.zeros(n_rows, c, dtype=torch.float64, device=got.device).index_add_(0, rows, upd.double())
    mag = torch.zeros_like(ref).index_add_(0, rows, upd.double().abs())
    count = torch.zeros(n_rows, dtype=torch.float64, device=got.device).index_add_(
        0, rows, torch.ones_like(rows, dtype=torch.float64))
    err = (got.reshape(n_rows, c).double() - ref).abs()
    return bool((err <= count[:, None] * 2.0**-24 * mag).all()), int(count.max())


def scatter_case(kernel, buckets, buckets_ref, plain, rows_ref, rows, upd, library):
    """One input of B7 or B8: the kernel (two launches) against its plain
    version (max error, 1e-5), against itself over two calls and against the
    plain row-owned transcription (bitwise), and against the fp64 sum within
    each row's fp32 summation bound; its buckets against theirs (bitwise);
    then the call, the buckets launch alone, the plain version and the
    library call timed (CUDA events), and the call's and the buckets
    launch's device time (torch.profiler: the buckets wrapper's host time
    exceeds its kernel's, so CUDA events over back-to-back launches time
    the host there)."""
    got, again = kernel(), kernel()
    want = plain()
    res = dict(bitwise_repeat=torch.equal(got, again), rows_bitwise=torch.equal(got, rows_ref()),
               buckets_equal=all(torch.equal(a, b) for a, b in zip(buckets(), buckets_ref())),
               max_abs_err=(got - want).abs().max().item(),
               within_1e5=torch.allclose(got, want, atol=1e-5, rtol=1e-5))
    res["within_sum_bound"], res["most_terms_on_a_row"] = within_sum_bound(got, rows, upd)
    lib = library()
    res["library_err"] = (lib - want).abs().max().item()
    del got, again, want, lib
    torch.cuda.synchronize()
    res.update(ms=cuda_ms(kernel, iters=20), ms_buckets=cuda_ms(buckets, iters=20), plain_ms=cuda_ms(plain, iters=5),
               library_ms=cuda_ms(library, iters=5), ms_device=device_ms(kernel, iters=20),
               ms_buckets_device=device_ms(buckets, iters=20))
    res["ms_rows_device"] = res["ms_device"] - res["ms_buckets_device"]
    return res


def scatter_bounds(nbytes: float, flops: float, in_bytes: float, out_bytes: float, buckets):
    """B7's or B8's bound (the function's bytes and operations), and each
    launch's alone: the buckets read the indices and weights (`in_bytes`)
    and write the offsets, the sorted ids and their weights; the rows pass
    reads those and dout and writes the output (`out_bytes`: dout read and
    output written)."""
    bucket_bytes = sum(t.numel() * 4 for t in buckets)
    return (*bound(nbytes, flops), bound(in_bytes + bucket_bytes, 0)[0],
            bound(out_bytes + bucket_bytes, flops)[0])


def report_scatter(name: str, shape: str, rows: dict, b_fn, b_buckets, b_rows, lib_name: str) -> dict:
    """Print B7's or B8's line; fail unless every input passed: bitwise over
    two calls, bitwise the transcription, buckets equal, the fp32 sum bound,
    and on uniform points 1e-5 from the plain version (the library call
    within 1e-4 of it)."""
    for case, r in rows.items():
        say(f"{name} {shape} {case}: max_abs_err={r['max_abs_err']:.3g} (within 1e-5 {r['within_1e5']}, "
              f"{lib_name} vs plain {r['library_err']:.3g}); bitwise over two calls {r['bitwise_repeat']}, bitwise "
              f"the plain row-owned version {r['rows_bitwise']}; buckets equal the plain version "
              f"{r['buckets_equal']}; up to {r['most_terms_on_a_row']} terms on a row, within the fp32 sum bound "
              f"{r['within_sum_bound']}; ms={r['ms']:.4f} (events; buckets alone {r['ms_buckets']:.4f}) "
              f"ms_device={r['ms_device']:.4f} (profiler; buckets {r['ms_buckets_device']:.4f} bound "
              f"{b_buckets[case]:.5f}, rows {r['ms_rows_device']:.4f} bound {b_rows[case]:.5f}) "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} ({lib_name}) "
              f"bound_ms={b_fn[case][0]:.5f} ({b_fn[case][1]})", flush=True)
    u = rows["uniform"]
    ok = u["within_1e5"] and u["library_err"] < 1e-4 and all(
        r["bitwise_repeat"] and r["rows_bitwise"] and r["buckets_equal"] and r["within_sum_bound"]
        for r in rows.values())
    if not ok:
        raise AssertionError(f"{name} kernel disagrees: {rows}")
    return dict(ms=u["ms"], ms_buckets=u["ms_buckets"], ms_device=u["ms_device"],
                ms_buckets_device=u["ms_buckets_device"], ms_rows_device=u["ms_rows_device"],
                plain_ms=u["plain_ms"], library_ms=u["library_ms"], bound_ms=b_fn["uniform"][0], bound_by=b_fn["uniform"][1],
                bound_buckets_ms=b_buckets["uniform"], bound_rows_ms=b_rows["uniform"],
                max_abs_err=max(r["max_abs_err"] for r in rows.values()), bitwise_repeat=True,
                clustered={**rows["clustered"], "bound_ms": b_fn["clustered"][0],
                           "bound_buckets_ms": b_buckets["clustered"], "bound_rows_ms": b_rows["clustered"]},
                most_terms_on_a_row_uniform=u["most_terms_on_a_row"])


def check_scatter_acc(dev, value, cases: dict, Lv: int):
    """Kernel B7's two launches (`scatter_acc_buckets`, then the rows pass;
    the value gradient of `weighted_gather`) at the decoder shape, on
    uniform and on clustered sampling points (`scatter_case`), beside
    `scatter_add_` of the same updates."""
    from tamtr_torch.kernels.deform_scatter import (
        scatter_acc, scatter_acc_buckets, scatter_acc_buckets_ref, scatter_acc_ref, scatter_acc_rows_ref,
    )

    rows, b_fn, b_buckets, b_rows = {}, {}, {}, {}
    for case, (idx4, w4, dout) in cases.items():
        B, nU, nh = idx4.shape
        c = dout.shape[-1]
        upd = w4[..., None] * dout.repeat_interleave(nU // DEFORM_Q, 1)
        index = idx4.long()[..., None].expand(B, nU, nh, c)
        flat = ((torch.arange(B, device=dev)[:, None, None] * Lv + idx4.long()) * nh
                + torch.arange(nh, device=dev)).reshape(-1)
        rows[case] = scatter_case(
            lambda: scatter_acc(idx4, w4, dout, Lv), lambda: scatter_acc_buckets(idx4, w4, Lv),
            lambda: scatter_acc_buckets_ref(idx4, w4, Lv), lambda: scatter_acc_ref(idx4, w4, dout, Lv),
            lambda: scatter_acc_rows_ref(idx4, w4, dout, Lv), flat, upd.reshape(-1, c),
            lambda: torch.zeros_like(value).scatter_add_(1, index, upd))
        # bytes: dvalue written once (all of it), dout, idx and w read once;
        # operations: a multiply and an add per update and channel
        in_bytes = 4 * (idx4.numel() + w4.numel())
        out_bytes = 4 * (value.numel() + dout.numel())
        b = scatter_bounds(in_bytes + out_bytes, 2 * B * nU * nh * c, in_bytes, out_bytes,
                           scatter_acc_buckets(idx4, w4, Lv))
        b_fn[case], b_buckets[case], b_rows[case] = b[:2], b[2], b[3]
        del upd, index, flat
    idx4 = cases["uniform"][0]
    return report_scatter("scatter_acc", f"value {tuple(value.shape)} Q={DEFORM_Q} p4={idx4.shape[1] // DEFORM_Q}",
                          rows, b_fn, b_buckets, b_rows, "scatter_add_")


def check_scatter_acc_pairs(dev, cases: dict, L2: int):
    """Kernel B8's two launches (`scatter_acc_pairs_buckets`, then the rows
    pass) at G = 32, L2 = 33600, c = 64, Q = 700, on uniform and on
    clustered sampling points (`scatter_case`), beside the two
    `scatter_add_`s of the same updates."""
    from tamtr_torch.kernels.deform_scatter import (
        scatter_acc_pairs, scatter_acc_pairs_buckets, scatter_acc_pairs_buckets_ref, scatter_acc_pairs_ref,
        scatter_acc_pairs_rows_ref,
    )

    rows, b_fn, b_buckets, b_rows = {}, {}, {}, {}
    for case, (idx2, wa, wb, dout) in cases.items():
        G, nU2 = idx2.shape
        c = dout.shape[-1]
        d = dout.repeat_interleave(nU2 // DEFORM_Q, 1)
        ua, ub = wa[..., None] * d, wb[..., None] * d
        ia = idx2.long()[..., None].expand(G, nU2, c)
        gi = torch.arange(G, device=dev)[:, None] * L2
        flat = torch.cat([gi + idx2.long(), gi + idx2.long() + 1], 1).reshape(-1)
        upd = torch.cat([ua, ub], 1).reshape(-1, c)
        rows[case] = scatter_case(
            lambda: scatter_acc_pairs(idx2, wa, wb, dout, L2), lambda: scatter_acc_pairs_buckets(idx2, wa, wb, L2),
            lambda: scatter_acc_pairs_buckets_ref(idx2, wa, wb, L2),
            lambda: scatter_acc_pairs_ref(idx2, wa, wb, dout, L2),
            lambda: scatter_acc_pairs_rows_ref(idx2, wa, wb, dout, L2), flat, upd,
            lambda: torch.zeros(G, L2, c, device=dev).scatter_add_(1, ia, ua).scatter_add_(1, ia + 1, ub))
        # bytes: the output written once (all of it), dout, idx2, wa and wb
        # read once; operations: two multiplies and two adds per pair and channel
        in_bytes = 4 * 3 * G * nU2
        out_bytes = 4 * (G * L2 * c + dout.numel())
        b = scatter_bounds(in_bytes + out_bytes, 4 * G * nU2 * c, in_bytes, out_bytes,
                           scatter_acc_pairs_buckets(idx2, wa, wb, L2))
        b_fn[case], b_buckets[case], b_rows[case] = b[:2], b[2], b[3]
        del d, ua, ub, ia, flat, upd
    G, nU2 = cases["uniform"][0].shape
    return report_scatter("scatter_acc_pairs", f"G={G} L2={L2} c={cases['uniform'][3].shape[-1]} Q={DEFORM_Q} "
                          f"pairs/query={nU2 // DEFORM_Q}", rows, b_fn, b_buckets, b_rows, "2 x scatter_add_")


def drive_ops(dev):
    """The public ops off the model paths, through the entry points a user
    calls, at the 640 px shapes: the ops that reach B6-B8, and
    `auction_match` (B5 with the batch-wide stop and a row mask) on the
    transposed train cost. Inputs are made first; every launch counter is
    zeroed just before the ops run and read just after."""
    from tamtr_torch.kernels.auction import auction_match
    from tamtr_torch.kernels.deform_scatter import scatter_acc_pairs, weighted_gather
    from tamtr_torch.nn.ssm import selective_scan

    g = torch.Generator().manual_seed(21)
    scans = [scan1d_inputs(g, H * W, 2 * C, dev) for H, W, C in LEVELS_640]
    value, (idx4, w4, dout), pairs, Lv = decoder_scatter_inputs(22, dev)
    C, mask = matcher_costs(23, TRAIN_BATCH, TRAIN_MAX_GT, TRAIN_VALID, dev)
    Ct, qmask = C.transpose(1, 2).contiguous(), torch.ones(C.shape[:2], dtype=torch.bool, device=dev)
    leaves = [[t.requires_grad_() for t in args] for args, _ in scans]
    v, w = value.requires_grad_(), w4.requires_grad_()
    counters = zero_counters()
    outs = []
    for ts, (_, dy) in zip(leaves, scans):
        y = selective_scan(*ts)
        outs += [y, *torch.autograd.grad(y, ts, dy)]
    out = weighted_gather(v, idx4, w, idx4.shape[1] // DEFORM_Q)
    outs += [out, *torch.autograd.grad(out, (v, w), dout)]
    outs.append(scatter_acc_pairs(*pairs, Lv))
    per_query = auction_match(Ct, qmask, row_mask=mask)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    want = {k: OPS_LAUNCHES.get(k, 0) for k in counters}
    finite = all(bool(torch.isfinite(t).all()) for t in outs)
    shapes = ([tuple(t.shape) for t in outs[-4:-1]] == [(DEFORM_B, DEFORM_Q, 8, 64), tuple(value.shape), tuple(w4.shape)]
              and tuple(outs[-1].shape) == (pairs[0].shape[0], Lv, 64))
    # every query of an image with at least nq valid gts holds a distinct valid gt
    full = mask.sum(1) >= C.shape[1]
    matched = per_query[full]
    assigned = bool((matched >= 0).all()) and all(len(set(r.tolist())) == len(r) for r in matched.cpu())
    say(f"ops: selective_scan fwd+bwd at 3 levels, weighted_gather fwd+bwd, scatter_acc_pairs, auction_match "
          f"(transposed, row mask): outputs finite {finite}, shapes {shapes}, full images fully assigned "
          f"{assigned}, launches {launches}", flush=True)
    shapes = shapes and assigned
    if not (finite and shapes and launches == want):
        raise AssertionError(f"ops path: finite {finite}, shapes {shapes}, launches {launches}; want {want}")
    return launches


@torch.no_grad()
def spread_scores(model, seed: int):
    """Give the zero-initialised head layers small random values and the
    score heads a zero bias, so that boxes and scores vary across queries
    and the comparison and postprocess see real work. Any DETR head: every
    deformable attention of its decoder (both of a decoupled layer), and
    the 2-D text scores of the locationManbaDecoder."""
    from tamtr_torch.nn.decoder import MSDeformAttn

    g = torch.Generator().manual_seed(seed)
    head = model.model[-1]
    for mlp in [head.enc_bbox_head, *head.dec_bbox_head]:
        mlp.layers[-1].weight.copy_(torch.randn(mlp.layers[-1].weight.shape, generator=g) * 0.05)
    for attn in (m for m in head.decoder["layers"].modules() if isinstance(m, MSDeformAttn)):
        for lin in (attn.sampling_offsets, attn.attention_weights):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g) * 0.05)
    for sh in [*getattr(head, "dec_score_head", []), *getattr(head, "cv4", [])]:
        sh.bias.zero_()


def same_set(got: np.ndarray, want: np.ndarray, tol: float = 1e-3):
    """Eval outputs (B, nq, 4 + nc), card against CPU, as a tie-robust set:
    rows paired by a min-cost assignment on their largest difference, each
    pair within `tol`; at most 2 unpaired rows an image (near-tied queries
    the top-k selection swaps), whose best scores agree at 5e-3. Returns the
    worst paired difference and the unpaired count."""
    from scipy.optimize import linear_sum_assignment

    worst, unmatched = 0.0, 0
    for b in range(got.shape[0]):
        dist = np.abs(got[b][:, None] - want[b][None]).max(-1)
        r, c = linear_sum_assignment(dist)
        matched = dist[r, c] < tol
        unmatched += int((~matched).sum())
        worst = max(worst, float(dist[r, c][matched].max()))
        if (~matched).sum() > 2:
            raise AssertionError(f"GPU vs CPU: {(~matched).sum()} unmatched rows, {np.sort(dist[r, c])[-3:]}")
        if not matched.all():
            np.testing.assert_allclose(np.sort(got[b][r[~matched], 4:].max(-1)),
                                       np.sort(want[b][c[~matched], 4:].max(-1)), atol=5e-3)
    return worst, unmatched


def check_parity(dev):
    """Full-width model on the card vs on the CPU, same weights, TF32 off."""
    import copy

    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    cpu_model = TAMTRModel.from_cfg("tamtr.yaml", nc=10)
    init_parameters(cpu_model, seed=0)
    spread_scores(cpu_model, seed=0)
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((2, 128, 128, 3), dtype=np.float32))
    txt = torch.from_numpy(rng.standard_normal((1, 10, 512)).astype(np.float32))
    txt = txt / txt.norm(dim=-1, keepdim=True)
    with torch.inference_mode():
        got = gpu_model(img.to(dev), txt.to(dev))["pred"].cpu().numpy()
        t0 = time.perf_counter()
        want = cpu_model(img, txt)["pred"].numpy()
        cpu_s = time.perf_counter() - t0
    worst, unmatched = same_set(got, want)
    if not np.isfinite(got).all() or want[..., 4:].std() < 0.05:
        raise AssertionError("parity outputs are not finite or carry no score spread")
    say(f"parity tamtr.yaml 128px b2: worst matched row diff {worst:.3g}, unmatched {unmatched}, "
          f"cpu forward {cpu_s:.2f} s", flush=True)
    return worst


@contextlib.contextmanager
def pinned_topk(record: list, replay=None):
    """Records the indices of every `Tensor.topk` call (the decoder's
    encoder-query selection), or, given `replay`, returns those instead: two
    runs then select the same queries in the same order, which near-tied
    scores need not do across devices and precisions."""
    orig, calls = torch.Tensor.topk, iter(replay or [])

    def topk(self, *a, **kw):
        if replay is None:
            res = orig(self, *a, **kw)
            record.append(res.indices.cpu())
            return res
        idx = next(calls).to(self.device)
        return torch.return_types.topk((self.gather(1, idx), idx))

    torch.Tensor.topk = topk
    try:
        yield
    finally:
        torch.Tensor.topk = orig


def check_train_parity(dev):
    """One training step of the full-width model, card against CPU, from one
    state dict: 128 px, batch 2, max_gt 8, CDN noise and DropPath off.

    Two discrete choices sit in the step: the auction (a discontinuous
    function of the cost) and the order of the top-k encoder queries (near
    ties order differently under other rounding); either moves whole terms
    of the gradient. So the forward and backward are compared twice:
      - as each device runs them: assignments identical in >= 90% of the
        valid (layer, gt) pairs, loss components within 1e-2 relative (a
        moved assignment moves its pair's loss);
      - with the CPU's assignment and top-k order given to the card and to a
        CPU fp64 pass, against the fp32 noise floor that pass measures (two
        independent fp32 roundings lie ~1.4x one rounding apart): the
        largest relative loss-component difference card vs CPU <= 2x the
        largest CPU vs fp64, and |g_card - g_cpu| <= 2 |g_cpu - g_fp64| over
        the whole gradient and over the VSSBlocks and `cross_attn.value_proj`
        tensors together, each of which must have a non-zero gradient on the
        card. Train-mode BatchNorm over 2 images down to 4x4 maps amplifies
        rounding: that floor is ~1e-3 on the losses and a few percent on the
        gradient, where the eval-mode forward of `check_parity` agrees at
        ~1e-6;
      - after `Trainer.step` (as each device runs it), every parameter within
        1e-6 + 2% of its CPU step, except elements whose gradient sign the
        noise flips: <= 3% of the moved elements."""
    import copy

    from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import Trainer, TrainConfig
    from tamtr_torch.weights import init_parameters

    M = 8
    base = TAMTRModel.from_cfg("tamtr.yaml", nc=10, max_gt=M, vss_drop_path=0.0,
                               label_noise_ratio=0.0, box_noise_scale=0.0)
    init_parameters(base, seed=0)
    spread_scores(base, seed=0)
    batch = synthetic_batch(14, 2, 128, M, (5, 8))
    probe = lambda k: "VSSBlocks" in k or "cross_attn.value_proj" in k  # noqa: E731

    def grads_on(d, dtype=torch.float32, match=None, topk=None):
        model = copy.deepcopy(base).to(d, dtype).train()
        t = {"cls": torch.from_numpy(batch["cls"]).to(d), "mask": torch.from_numpy(batch["mask"]).to(d),
             "bboxes": torch.from_numpy(batch["bboxes"]).to(d, dtype)}
        img = torch.from_numpy(batch["img"]).to(d, dtype) / 255.0
        record = []
        with pinned_topk(record, topk):
            out = model(img, torch.from_numpy(batch["txt_feats"]).to(d, dtype), t)
        loss, items = rtdetr_detection_loss(out, t, DETRLossConfig(nc=10), match=match)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().double()
                 for k, p in model.named_parameters()}
        return {k: float(v.detach()) for k, v in items.items() if v.ndim == 0}, items["match"].cpu(), grads, record

    rel = lambda a, b: max(abs(a[k] - v) / max(abs(v), 1e-6) for k, v in b.items())  # noqa: E731
    t0 = time.perf_counter()
    cpu_items, cpu_match, cpu_g, cpu_topk = grads_on(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    if len(cpu_topk) != 1:
        raise AssertionError(f"expected one top-k query selection per forward, saw {len(cpu_topk)}")
    gpu_items, gpu_match, _, _ = grads_on(dev)
    fix_items, _, gpu_g, _ = grads_on(dev, match=cpu_match, topk=cpu_topk)
    exact_items, _, exact, _ = grads_on(torch.device("cpu"), torch.float64, match=cpu_match, topk=cpu_topk)
    worst_item, worst_fixed, item_noise = rel(gpu_items, cpu_items), rel(fix_items, cpu_items), rel(cpu_items, exact_items)
    valid = torch.from_numpy(batch["mask"])[None].expand_as(cpu_match)
    agree = float((gpu_match == cpu_match)[valid].float().mean())
    flat = lambda g, sel=lambda k: True: torch.cat([v.flatten() for k, v in g.items() if sel(k)])  # noqa: E731
    d_card = (flat(gpu_g) - flat(cpu_g)).norm().item()
    d_noise = (flat(cpu_g) - flat(exact)).norm().item()
    p_card = (flat(gpu_g, probe) - flat(cpu_g, probe)).norm().item()
    p_noise = (flat(cpu_g, probe) - flat(exact, probe)).norm().item()
    zero = [k for k, g in gpu_g.items() if probe(k) and g.abs().max().item() == 0 and exact[k].abs().max() > 0]

    steps = []
    for d in (dev, torch.device("cpu")):
        tr = Trainer(copy.deepcopy(base), TrainConfig(batch_size=2, accumulate=1), device=d)
        loss = tr.step(batch)["loss"]
        steps.append(({k: p.detach().cpu() for k, p in tr.model.named_parameters()}, loss))
    top = max(g.norm().item() for g in cpu_g.values())
    flips = moved = 0
    before = dict(base.named_parameters())
    for k, g in cpu_g.items():
        live = g.abs() > 1e-3 * g.abs().max() if g.norm().item() > 1e-6 * top else torch.zeros_like(g, dtype=torch.bool)
        step = (steps[1][0][k] - before[k].detach()).abs()
        flips += int((live & ((steps[0][0][k] - steps[1][0][k]).abs() > 1e-6 + 0.02 * step)).sum())
        moved += int((live & (step > 0)).sum())
    say(f"train parity tamtr.yaml 128px b2: loss card {steps[0][1]:.6f} cpu {steps[1][1]:.6f}; as run: "
          f"worst loss-component rel diff {worst_item:.3g}, assignments agree {agree:.4f}; with the cpu's "
          f"assignment and top-k: worst loss-component rel diff {worst_fixed:.3g} vs fp32 noise {item_noise:.3g}, gradient |card - cpu| / "
          f"|cpu| {d_card / flat(cpu_g).norm().item():.3g} vs fp32 noise |cpu - fp64| / |cpu| "
          f"{d_noise / flat(cpu_g).norm().item():.3g}; VSSBlocks + value_proj {p_card / flat(cpu_g, probe).norm().item():.3g}"
          f" vs {p_noise / flat(cpu_g, probe).norm().item():.3g}; step flips {flips}/{moved}; cpu forward+backward "
          f"{cpu_s:.2f} s", flush=True)
    if not (worst_item < 1e-2 and agree >= 0.9 and worst_fixed <= 2 * item_noise and d_card <= 2 * d_noise
            and p_card <= 2 * p_noise and not zero and moved > 0 and flips <= 0.03 * moved):
        raise AssertionError(f"train parity failed (zero-gradient tensors on the card: {zero[:5]})")
    return d_card / flat(cpu_g).norm().item()


def train(dev):
    """The slice's path: `TAMTR(...).trainer().step` on `tamtr.yaml` at
    640 px, batch 4, max_gt 300, accumulate 1."""
    from tamtr_torch import TAMTR
    from tamtr_torch.train.trainer import TrainConfig

    det = TAMTR("tamtr.yaml", nc=10, device=dev, seed=0, max_gt=TRAIN_MAX_GT)
    tr = det.trainer(TrainConfig(batch_size=TRAIN_BATCH, accumulate=1), seed=0)
    p0 = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    batches = [synthetic_batch(100 + i, TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT, TRAIN_VALID)
               for i in range(WARMUP_STEPS + TIMED_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:WARMUP_STEPS]:  # first steps pick cuDNN algorithms
        tr.step(b)
    counters = zero_counters()
    times, logs = [], []
    for b in batches[WARMUP_STEPS:]:
        t0 = time.perf_counter()
        m = tr.step(b)  # ends in host reads of the metrics: the device has finished
        times.append((time.perf_counter() - t0) * 1e3)
        logs.append(m)
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * TIMED_STEPS for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    finite = all(math.isfinite(v) for m in logs for v in m.values())
    moved = any(not torch.equal(p0[k], v) for k, v in tr.model.state_dict().items() if v.is_floating_point())
    ema_moved = any(not torch.equal(p0[k], v) for k, v in tr.ema.state_dict().items() if v.is_floating_point())
    say(f"train tamtr.yaml {TRAIN_IMGSZ}px b{TRAIN_BATCH} max_gt {TRAIN_MAX_GT}: step ms "
          f"{[round(t, 3) for t in times]}, loss {[round(m['loss'], 4) for m in logs]}, giou/class/bbox "
          f"{[(round(m['giou'], 3), round(m['class'], 3), round(m['bbox'], 3)) for m in logs]}, grad_norm "
          f"{[round(m['grad_norm'], 2) for m in logs]}, max_memory_allocated {peak / 2**20:.1f} MiB, "
          f"launches {launches} over {TIMED_STEPS} steps", flush=True)
    if not (finite and moved and ema_moved and all(m["stepped"] == 1.0 for m in logs)):
        raise AssertionError(f"training step: finite {finite}, params moved {moved}, EMA moved {ema_moved}")
    if launches != want:
        raise AssertionError(f"launches {launches} over {TIMED_STEPS} steps; want {want}")
    # one more step, its B4 inputs kept for `check_gather_bwd_step` (after the
    # counts and the peak are read: keeping them raises the peak)
    b4_calls = []
    with recording_gather_bwd(b4_calls):
        tr.step(batches[-1])
    return launches, times, peak, [tuple(t.detach() for t in args) for args in b4_calls]


def serve(dev):
    """The main path: predict requests through the public entry point."""
    from tamtr_torch import TAMTR

    det = TAMTR("tamtr.yaml", nc=10, seed=0)
    spread_scores(det.model, seed=1)
    rng = np.random.default_rng(4)
    text = rng.standard_normal((10, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(4)]
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    forwards, times = 0, {"b1": [], "b4": []}

    def request(images, key=None):
        nonlocal forwards
        t0 = time.perf_counter()
        res = det.predict(images, text)  # ends in host copies: the device has finished
        dt = (time.perf_counter() - t0) * 1e3
        forwards += 1
        if key:
            times[key].append(dt)
        for r in res:
            n = len(r["scores"])
            if r["boxes"].shape != (n, 4) or r["labels"].shape != (n,) or not np.isfinite(r["boxes"]).all():
                raise AssertionError("malformed predict result")
        return res

    request(frames[0])  # warm-up at both batch sizes: first calls pick conv algorithms
    request(frames)
    for i in range(5):
        res = request(frames[i % 4], "b1")
    res4 = request(frames, "b4")
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {k: FORWARD_LAUNCHES.get(k, 0) * forwards for k in counters}
    if len(res4) != 4 or launches != want:
        raise AssertionError(f"launches {launches} after {forwards} forwards; want {want}")
    say(f"serve tamtr.yaml 640px: batch-1 ms {[round(t, 3) for t in times['b1']]}, "
          f"batch-4 ms {[round(t, 3) for t in times['b4']]}, detections/image {len(res[0]['scores'])}, "
          f"max_memory_allocated {peak / 2**20:.1f} MiB, forwards {forwards}, launches {launches}",
          flush=True)
    return launches


def fit(dev):
    """The dataset path: `Engine.train` on the generated dataset of
    `tools/smoke_train_torch.py` (640 px, 16 train and 8 val images, max_gt
    32) with the full-width `tamtr.yaml` (nc 3): FIT_EPOCHS epochs at batch
    4, 2 loader workers, val after each epoch, `last` saved each epoch;
    then `resume=True` for one epoch more from `last`, and `Engine.val` on
    `best`.
    Every launch counter is zeroed before train and before val and read
    after each; the card's val forward on the first 2 val images is held
    against the CPU's with the same EMA weights (`same_set`)."""
    import copy
    import csv
    import shutil
    from pathlib import Path

    from tamtr_torch.engine.model import Engine
    from tools.smoke_train_torch import make_dataset

    root = Path("build/fit")
    shutil.rmtree(root, ignore_errors=True)
    data = str(make_dataset(root, FIT_TRAIN, FIT_VAL, TRAIN_IMGSZ))
    args = dict(data=data, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, max_gt=FIT_MAX_GT, workers=2, warmup_epochs=4,
                val_interval=1, save_interval=1, conf=0.05, plots=True, project=str(root / "runs"), name="fit")
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    t0 = time.perf_counter()
    first = Engine("tamtr.yaml")
    first.train(epochs=FIT_EPOCHS, **args)
    seen = {}
    resumed = Engine("tamtr.yaml")
    resumed.callbacks.add("on_train_start", lambda e: seen.update(
        ni=e.trainer.ni, count=e.trainer.count, generator=e.trainer.generator.get_state().clone()))
    resumed.callbacks.add("on_train_epoch_start", lambda e, epoch: seen.setdefault("epoch", epoch))
    res = resumed.train(epochs=FIT_EPOCHS + 1, resume=True, **args)
    train_s = time.perf_counter() - t0
    train_launches = {k: f.launches for k, f in counters.items()}
    steps = len(first.timing["step_ms"]) + len(resumed.timing["step_ms"])
    val_forwards = (FIT_EPOCHS + 1) * math.ceil(FIT_VAL / TRAIN_BATCH)
    want = {k: TRAIN_LAUNCHES_PER_STEP[k] * steps + FORWARD_LAUNCHES.get(k, 0) * val_forwards for k in counters}
    with open(root / "runs" / "fit" / "results.csv") as f:
        rows = list(csv.DictReader(f))
    restored = (seen.get("epoch") == FIT_EPOCHS and seen.get("ni") == first.trainer.ni and seen.get("count") == first.trainer.count
                and torch.equal(seen.get("generator", torch.empty(0)), first.trainer.generator.get_state()))
    from tamtr_torch.data.image_io import imread

    plots = ["results.png", "train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg", "confusion_matrix.png"]
    unreadable = [f for f in plots if imread(root / "runs" / "fit" / f) is None]

    counters = zero_counters()
    best = Engine("tamtr.yaml").load(root / "runs" / "fit" / "weights" / "best.pt")
    val = best.val(**args)
    val_launches = {k: f.launches for k, f in counters.items()}
    val_want = {k: FORWARD_LAUNCHES.get(k, 0) * math.ceil(FIT_VAL / TRAIN_BATCH) for k in counters}
    peak = torch.cuda.max_memory_allocated()

    from tamtr_torch.data.dataset import DetectionDataset

    ds = DetectionDataset(Path(data).parent / "val" / "images", imgsz=TRAIN_IMGSZ)
    img = torch.from_numpy(np.stack([ds.get_val(i)[0] for i in range(2)]))
    txt = torch.as_tensor(best.txt_feats[None], dtype=torch.float32)
    cpu_model = copy.deepcopy(best.model).cpu()
    with torch.inference_mode():
        got = best.model(img.to(dev), txt.to(dev))["pred"].cpu().numpy()
        want_cpu = cpu_model(img, txt)["pred"].numpy()
    worst, unmatched = same_set(got, want_cpu)

    step_ms = np.asarray(first.timing["step_ms"][2:] + resumed.timing["step_ms"][1:])
    wait_ms = np.asarray(first.timing["wait_ms"][2:] + resumed.timing["wait_ms"][1:])
    losses = [float(r["loss"]) for r in rows]
    in_range = all(0.0 <= m[k] <= 1.0 for m in (res, val) for k in ("mAP50", "mAP50-95", "precision", "recall"))
    summary = dict(step_ms_median=float(np.median(step_ms)), loader_wait_ms_mean=float(wait_ms.mean()),
                   loader_wait_ms_median=float(np.median(wait_ms)),
                   loader_wait_share=float(wait_ms.sum() / (wait_ms.sum() + step_ms.sum())),
                   val_images_per_sec=val["images_per_sec"], mAP50=val["mAP50"], mAP50_95=val["mAP50-95"],
                   max_memory_allocated_mib=peak / 2**20, train_and_resume_s=train_s, steps=steps,
                   timed_steps=len(step_ms), val_parity_worst=worst, val_parity_unmatched=unmatched)
    say(f"fit tamtr.yaml {TRAIN_IMGSZ}px b{TRAIN_BATCH} on {FIT_TRAIN}+{FIT_VAL} generated images: "
          f"{json.dumps(summary)}; results.csv losses {[round(x, 4) for x in losses]}; resume restored epoch, ni, "
          f"count and generator: {restored}; plots {plots} read back; launches train {train_launches}, "
          f"val {val_launches}", flush=True)
    if not (len(rows) == FIT_EPOCHS + 1 and all(math.isfinite(x) for x in losses) and in_range and restored
            and not unreadable):
        raise AssertionError(f"fit: rows {len(rows)}, losses {losses}, metrics in [0, 1] {in_range}, "
                             f"resume restored {restored} ({ {k: v for k, v in seen.items() if k != 'generator'} }), "
                             f"plots missing or unreadable {unreadable}")
    if train_launches != want or val_launches != val_want:
        raise AssertionError(f"fit launches: train {train_launches} (want {want}), val {val_launches} "
                             f"(want {val_want})")
    return {k: train_launches[k] + val_launches[k] for k in counters}, summary



# ---------------------------------------------------------------------------
# bf16: the compute path of `TAMTRModel.dtype` = bf16 (`half=True`, `bf16=True`)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16


def bf16_seq(args):
    """The scan's sequence tensors (layouts, dts_raw, Bs, Cs) in bf16, the
    parameters fp32, as SS2D passes them at bf16."""
    return [t.to(BF16) if i in (0, 1, 5, 6) else t for i, t in enumerate(args)]


def bf16_steps(got, want, floor: float) -> float:
    """The largest |got - want| in bf16 steps (2^-7 of the larger
    magnitude's power of two) beyond an absolute `floor`."""
    got, want = got.float(), want.float()
    unit = torch.exp2(torch.floor(torch.log2(torch.maximum(got.abs(), want.abs()).clamp(min=1e-30))) - 7)
    return float(((got - want).abs() - floor).clamp(min=0).div(unit).max())


def rms_set(got: np.ndarray, want: np.ndarray, spare: int = 2) -> float:
    """Two eval outputs (B, nq, 4 + nc) as sets of rows (paired by the least
    max-abs distance, the `spare` worst pairs of an image left out as
    near-tied top-k picks): the root mean square of the pairs' differences
    (`tests/test_torch_bf16.py:set_distance`)."""
    from scipy.optimize import linear_sum_assignment

    errs = []
    for b in range(got.shape[0]):
        dist = np.abs(got[b][:, None] - want[b][None]).max(-1)
        r, c = linear_sum_assignment(dist)
        keep = np.argsort(dist[r, c])[:len(r) - spare]
        errs.append((got[b][r[keep]] - want[b][c[keep]]).ravel())
    e = np.concatenate(errs)
    return float(np.sqrt(np.mean(e * e)))


def in_turns(fns: dict, rounds: int, iters: int) -> dict:
    """ms of each of `fns` (CUDA events, `iters` calls), the functions in
    turn for `rounds` rounds; each one's median."""
    got = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            got[k].append(cuda_ms(fn, iters=iters))
    return {k: float(np.median(v)) for k, v in got.items()}


def bf16_scan_rows(dev):
    """B1 and B3 at bf16 sequence I/O at the three 640 px levels, batch 4,
    against their plain bf16 versions (y within one bf16 step beyond 2^-10;
    the bf16 gradients within 2e-2, the fp32 ones within 2e-3; every
    gradient in its primal's dtype), two calls bitwise equal; the ms of the
    launches at bf16 and at fp32 in turns, and the bound at bf16 bytes."""
    from tamtr_torch.kernels.selective_scan import (
        SEG_STEPS, ss2d_scan, ss2d_scan_bwd, ss2d_scan_bwd_ref, ss2d_scan_bwd_walk, ss2d_scan_carriers,
        ss2d_scan_combine, ss2d_scan_ref,
    )

    def bwd_launches(a, d):
        summ = ss2d_scan_carriers(*a[:7], d)
        h_in, carry = ss2d_scan_combine(a[4], *summ, a[0].shape[2])
        return ss2d_scan_bwd_walk(*a[:7], d, h_in, carry)

    g = torch.Generator().manual_seed(21)
    fwd, bwd = [], []
    for H, W, C in LEVELS_640:
        args, dy = scan_inputs(g, TRAIN_BATCH, H, W, C, dev)
        a16, dy16 = bf16_seq(args), dy.to(BF16)
        B, L, D, R, N = TRAIN_BATCH, H * W, 2 * C, args[2].shape[-1], 16
        S = -(-L // SEG_STEPS)
        y, again, want = ss2d_scan(*a16), ss2d_scan(*a16), ss2d_scan_ref(*a16)
        steps, bitwise = bf16_steps(y, want, 2.0**-10), torch.equal(y, again)
        e = (y.float() - want.float()).abs().max().item()
        ok = y.dtype == BF16 and steps <= 1.0 and bitwise and bool(torch.isfinite(y.float()).all())
        del y, again, want
        ms = in_turns({"fp32": lambda: ss2d_scan(*args), "bf16": lambda: ss2d_scan(*a16)}, rounds=2, iters=5)
        plain = cuda_ms(lambda: ss2d_scan_ref(*a16), iters=1, warmup=0)
        # the function at bf16 bytes: the sequence inputs and y 2 bytes, the
        # weights 4; the operations as at fp32 (`check_ss2d_scan`)
        seq_in = 2 * B * L * D + 4 * B * L * (R + 2 * N)
        b_fn = bound(2 * (seq_in + 4 * B * L * D) + 4 * 4 * D * (R + N + 2), 4 * B * L * D * (2 * R + 8 * N + 3))
        fwd.append(dict(B=B, L=L, D=D, S=S, ms=ms["bf16"], ms_fp32=ms["fp32"], plain_ms=plain, bound_ms=b_fn[0],
                        bound_by=b_fn[1], max_abs_err=e, bf16_steps=steps, bitwise_repeat=bitwise))
        say(f"bf16 ss2d_scan_fwd B={B} L={L} D={D}: {steps} bf16 steps from the plain bf16 scan (max_abs_err {e:.3g}), "
            f"bitwise repeat {bitwise}; ms bf16 {ms['bf16']:.4f} fp32 {ms['fp32']:.4f} (in turns), plain_ms "
            f"{plain:.3f}, bound_ms at bf16 bytes {b_fn[0]:.4f} ({b_fn[1]})", flush=True)
        if not ok:
            raise AssertionError(f"bf16 ss2d_scan at L={L}: {steps} steps, bitwise {bitwise}")
        got, again = ss2d_scan_bwd(*a16, dy16), ss2d_scan_bwd(*a16, dy16)
        want = ss2d_scan_bwd_ref(*a16, dy16, chunk=512)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(x, z) for x, z in zip(got, again))
        dtypes = all(x.dtype == w.dtype == p.dtype for x, w, p in zip(got, want, a16))
        close = all(torch.allclose(x.float(), w.float(), atol=2e-2 if x.dtype == BF16 else 2e-3,
                                   rtol=2e-2 if x.dtype == BF16 else 2e-3) and bool(torch.isfinite(x.float()).all())
                    for x, w in zip(got, want))
        e = max((x.float() - w.float()).abs().max().item() for x, w in zip(got, want))
        del got, again, want
        ms = in_turns({"fp32": lambda: bwd_launches(args, dy), "bf16": lambda: bwd_launches(a16, dy16)},
                      rounds=2, iters=3)
        whole = in_turns({"fp32": lambda: ss2d_scan_bwd(*args, dy), "bf16": lambda: ss2d_scan_bwd(*a16, dy16)},
                         rounds=1, iters=3)
        plain = cuda_ms(lambda: ss2d_scan_bwd_ref(*a16, dy16, chunk=512), iters=1, warmup=0)
        # at bf16 bytes: layouts, x_dbl and dy in, du, d_dts, dB and dC out
        # 2 bytes; the weights, dz and dA 4 (`check_ss2d_scan_bwd`)
        seq = seq_in + 4 * B * L * D + 4 * B * L * D + 2 * 4 * B * L * N
        b_fn = bound(2 * seq + 4 * (4 * D * (R + N + 2) + 4 * B * L * D + 4 * D * N),
                     4 * B * L * D * (4 * R + 28 * N + 10))
        bwd.append(dict(B=B, L=L, D=D, S=S, ms=ms["bf16"], ms_fp32=ms["fp32"], ms_with_assembly=whole["bf16"],
                        ms_with_assembly_fp32=whole["fp32"], plain_ms=plain, bound_ms=b_fn[0], bound_by=b_fn[1],
                        max_abs_err=e, bitwise_repeat=bitwise))
        say(f"bf16 ss2d_scan_bwd B={B} L={L} D={D}: max_abs_err {e:.3g} (bf16 gradients 2e-2, fp32 2e-3), "
            f"cotangent dtypes {dtypes}, bitwise repeat {bitwise}; launches ms bf16 {ms['bf16']:.4f} fp32 "
            f"{ms['fp32']:.4f}, with the torch assembly bf16 {whole['bf16']:.4f} fp32 {whole['fp32']:.4f} (in "
            f"turns), plain_ms {plain:.3f}, bound_ms at bf16 bytes {b_fn[0]:.4f} ({b_fn[1]})", flush=True)
        if not (bitwise and dtypes and close):
            raise AssertionError(f"bf16 ss2d_scan_bwd at L={L}: close {close}, dtypes {dtypes}, bitwise {bitwise}")
        del args, dy, a16, dy16
    return fwd, bwd


def bf16_gather_rows(dev):
    """B2 and B4 on bf16 value (and dout) at value (4, 33600, 8, 64), Q =
    700: out within 2e-2 of the plain bf16 gather, dvalue bitwise the plain
    row-owned version at bf16 and within 3e-2 of the scatter-add form, dw
    fp32 within 1e-4; two calls bitwise equal; ms at bf16 and fp32 in turns
    and the bounds at bf16 bytes."""
    from tamtr_torch.kernels.deform_scatter import (
        bilinear_gather, bilinear_gather_bwd, bilinear_gather_bwd_ref, bilinear_gather_bwd_rows_ref,
        bilinear_gather_ref,
    )
    from tamtr_torch.nn.decoder import deform_sampling_pairs

    shapes = [(h, w) for h, w, _ in LEVELS_640]
    B, Q, nl, P = DEFORM_B, DEFORM_Q, 3, 4
    value, loc, w_att = deform_inputs(torch.Generator().manual_seed(22), B, Q, shapes, dev)
    idx4, w_pairs, idx2 = deform_sampling_pairs(shapes, loc, w_att)
    v16 = value.to(BF16)
    _, Lv, nh, c = value.shape
    call = lambda v: bilinear_gather(v, None, w_pairs, idx2, nl * P)  # noqa: E731
    out, again, want = call(v16), call(v16), bilinear_gather_ref(v16, idx4, w_pairs, idx2, nl * P)
    e = (out.float() - want.float()).abs().max().item()
    ok = out.dtype == BF16 and e < 2e-2 and torch.equal(out, again)
    del out, again, want
    ms = in_turns({"fp32": lambda: call(value), "bf16": lambda: call(v16)}, rounds=3, iters=20)
    dev_ms = {k: device_ms(lambda: call(v), iters=20) for k, v in (("fp32", value), ("bf16", v16), ("fp32 ", value))}
    plain = cuda_ms(lambda: bilinear_gather_ref(v16, idx4, w_pairs, idx2, nl * P), iters=3)
    lib = cuda_ms(lambda: grid_sample_deform(v16, shapes, loc.to(BF16), w_att.to(BF16)), iters=5)
    rows = torch.cat([idx2.clamp(max=Lv - 2), idx2.clamp(max=Lv - 2) + 1], 1).long()
    touched = torch.unique((torch.arange(B, device=dev)[:, None, None] * Lv + rows) * nh
                           + torch.arange(nh, device=dev)).numel()
    b_f = bound(touched * c * 2 + idx2.numel() * 4 + w_pairs.numel() * 4 + B * Q * nh * c * 2, idx2.numel() * c * 4)
    fwd = dict(ms=ms["bf16"], ms_fp32=ms["fp32"], ms_device=dev_ms["bf16"],
               ms_device_fp32=[dev_ms["fp32"], dev_ms["fp32 "]], plain_ms=plain, library_ms=lib,
               library="F.grid_sample at bf16", bound_ms=b_f[0], bound_by=b_f[1], max_abs_err=e, bitwise_repeat=ok)
    say(f"bf16 bilinear_gather_fwd value ({B}, {Lv}, {nh}, {c}) Q={Q}: max_abs_err {e:.3g}, ok {ok}; ms bf16 "
        f"{ms['bf16']:.4f} fp32 {ms['fp32']:.4f} (in turns), device ms (profiler) fp32 {dev_ms['fp32']:.5f}, bf16 "
        f"{dev_ms['bf16']:.5f}, fp32 {dev_ms['fp32 ']:.5f}; plain_ms {plain:.4f}, library_ms {lib:.4f}, bound_ms "
        f"at bf16 bytes {b_f[0]:.5f} ({b_f[1]})", flush=True)
    if not ok:
        raise AssertionError(f"bf16 bilinear_gather: max error {e}")
    dout = torch.randn(B, Q, nh, c, generator=torch.Generator().manual_seed(23)).to(dev)
    d16 = dout.to(BF16)
    dv, dw = bilinear_gather_bwd(v16, idx2, w_pairs, d16)
    dv2, dw2 = bilinear_gather_bwd(v16, idx2, w_pairs, d16)
    dv_rows, dw_rows = bilinear_gather_bwd_rows_ref(v16, idx2, w_pairs, d16)
    dv_ref, dw_ref = bilinear_gather_bwd_ref(v16, idx2, w_pairs, d16)
    torch.cuda.synchronize()
    e_dv, e_dw = (dv.float() - dv_ref.float()).abs().max().item(), (dw - dw_ref).abs().max().item()
    ok = (dv.dtype == BF16 and dw.dtype == torch.float32 and torch.equal(dv, dv2) and torch.equal(dw, dw2)
          and torch.equal(dv, dv_rows) and e_dv < 3e-2 and torch.allclose(dw, dw_ref, atol=1e-4, rtol=1e-4))
    del dv, dw, dv2, dw2, dv_rows, dw_rows, dv_ref, dw_ref
    ms = in_turns({"fp32": lambda: bilinear_gather_bwd(value, idx2, w_pairs, dout),
                   "bf16": lambda: bilinear_gather_bwd(v16, idx2, w_pairs, d16)}, rounds=3, iters=5)
    plain = cuda_ms(lambda: bilinear_gather_bwd_ref(v16, idx2, w_pairs, d16), iters=2)
    b_b = bound(touched * c * 2 + d16.numel() * 2 + idx2.numel() * 4 + w_pairs.numel() * 4 + v16.numel() * 2
                + w_pairs.numel() * 4, B * Q * nh * (idx2.shape[1] // Q) * c * 8)
    bwd = dict(ms=ms["bf16"], ms_fp32=ms["fp32"], plain_ms=plain, library_ms=None, bound_ms=b_b[0], bound_by=b_b[1],
               max_abs_err=max(e_dv, e_dw), bitwise_repeat=ok)
    say(f"bf16 bilinear_gather_bwd: dvalue bitwise the rows version and repeat, within {e_dv:.3g} of the "
        f"scatter-add form, dw {e_dw:.3g}; ok {ok}; ms bf16 {ms['bf16']:.4f} fp32 {ms['fp32']:.4f} (in turns), "
        f"plain_ms {plain:.4f}, bound_ms at bf16 bytes {b_b[0]:.5f} ({b_b[1]})", flush=True)
    if not ok:
        raise AssertionError(f"bf16 bilinear_gather_bwd: dvalue {e_dv}, dw {e_dw}")
    return fwd, bwd


def bf16_offpath_rows(dev):
    """B6, B7 and B8 (on no model path) at bf16 I/O: B6 at the three 640 px
    levels, G = 4, y within one bf16 step beyond 2^-10 of the plain scan on
    the same values, two calls bitwise equal; B7 and B8 on a bf16 dout at
    the decoder's shapes (value (4, 33600, 8, 64), Q = 700), bitwise their
    plain rows versions and over two calls; each one's ms at bf16 and fp32
    in turns."""
    from tamtr_torch.kernels.deform_scatter import (
        scatter_acc, scatter_acc_pairs, scatter_acc_pairs_rows_ref, scatter_acc_rows_ref,
    )
    from tamtr_torch.kernels.selective_scan import selective_scan, selective_scan_ref

    g = torch.Generator().manual_seed(25)
    rows = {"selective_scan_fwd": [], "scatter_acc": None, "scatter_acc_pairs": None}
    for H, W, C in LEVELS_640:
        (u, delta, A, Bs, Cs, D), _ = scan1d_inputs(g, H * W, 2 * C, dev)
        s16 = [t.to(BF16) for t in (u, delta, Bs, Cs)]
        call16 = lambda: selective_scan(s16[0], s16[1], A, s16[2], s16[3], D)  # noqa: E731
        y, again = call16(), call16()
        want = selective_scan_ref(*(t.float() for t in s16[:2]), A, *(t.float() for t in s16[2:]), D).to(BF16)
        steps, bitwise = bf16_steps(y, want, 2.0**-10), torch.equal(y, again)
        ms = in_turns({"fp32": lambda: selective_scan(u, delta, A, Bs, Cs, D), "bf16": call16}, rounds=2, iters=3)
        rows["selective_scan_fwd"].append(dict(L=H * W, Din=2 * C, ms=ms["bf16"], ms_fp32=ms["fp32"],
                                               bf16_steps=steps, bitwise_repeat=bitwise))
        if not (y.dtype == BF16 and steps <= 1.0 and bitwise):
            raise AssertionError(f"bf16 selective_scan at L={H * W}: {steps} steps, bitwise {bitwise}")
        del u, delta, Bs, Cs, s16, y, again, want
    _, (idx4, w4, dout), pairs, Lv = decoder_scatter_inputs(26, dev)
    idx = idx4.to(torch.int32)
    d16, p16 = dout.to(BF16), pairs[3].to(BF16)
    checks = {"scatter_acc": (lambda d: scatter_acc(idx, w4, d, Lv), lambda: scatter_acc_rows_ref(idx, w4, d16, Lv),
                              dout, d16),
              "scatter_acc_pairs": (lambda d: scatter_acc_pairs(*pairs[:3], d, Lv),
                                    lambda: scatter_acc_pairs_rows_ref(*pairs[:3], p16, Lv), pairs[3], p16)}
    for name, (kernel, rows_ref, d32, d_16) in checks.items():
        out, again, want = kernel(d_16), kernel(d_16), rows_ref()
        ok = out.dtype == BF16 and torch.equal(out, again) and torch.equal(out, want)
        del out, again, want
        ms = in_turns({"fp32": lambda: kernel(d32), "bf16": lambda: kernel(d_16)}, rounds=2, iters=5)
        rows[name] = dict(ms=ms["bf16"], ms_fp32=ms["fp32"], bitwise_rows_ref=ok)
        if not ok:
            raise AssertionError(f"bf16 {name}: not bitwise its rows version or its repeat")
    say(f"bf16 off-path kernels: {json.dumps(rows)}", flush=True)
    return rows


def bf16_serve(dev):
    """`TAMTR.predict(images, text)` with half=True, and with fuse=True too,
    beside fp32: batch 1 and 4 requests in turns; the launches of the bf16
    requests and, apart, of the fp32 ones, each request's read before and
    after it; the card's bf16 output against its fp32 output and against the
    CPU's bf16 output (128 px, batch 2), as RMS over rows paired as sets."""
    import copy

    from tamtr_torch import TAMTR

    det = TAMTR("tamtr.yaml", nc=10, seed=0)
    spread_scores(det.model, seed=1)
    rng = np.random.default_rng(24)
    text = rng.standard_normal((10, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(4)]
    modes = {"fp32": {}, "half": {"half": True}, "fuse+half": {"half": True, "fuse": True}}
    for kw in modes.values():  # warm-up: conv algorithms, the twins
        det.predict(frames[0], text, **kw)
        det.predict(frames, text, **kw)
    times = {f"{m}_b{b}": [] for m in modes for b in (1, 4)}
    counters = zero_counters()
    counted = {"fp32": dict.fromkeys(counters, 0), "bf16": dict.fromkeys(counters, 0)}
    forwards = {"fp32": 0, "bf16": 0}
    for i in range(5):
        for m, kw in modes.items():
            for b, images in ((1, frames[i % 4]), (4, frames)):
                side = "fp32" if m == "fp32" else "bf16"
                before = {k: f.launches for k, f in counters.items()}
                t0 = time.perf_counter()
                det.predict(images, text, **kw)  # ends in host copies: the device has finished
                times[f"{m}_b{b}"].append((time.perf_counter() - t0) * 1e3)
                for k, f in counters.items():  # each request's own launches, read before and after it
                    counted[side][k] += f.launches - before[k]
                forwards[side] += 1
    for side, launches in counted.items():
        want = {k: FORWARD_LAUNCHES.get(k, 0) * forwards[side] for k in counters}
        if launches != want:
            raise AssertionError(f"{side} serve launches {launches}, want {want}")
    launches = counted["bf16"]
    img = torch.from_numpy(rng.random((4, 640, 640, 3), dtype=np.float32)).to(dev)
    txt = torch.from_numpy(text[None]).to(dev)
    model = det.model.eval()
    with torch.inference_mode():
        p32 = model(img, txt)["pred"].cpu().numpy()
        p16 = model.with_dtype(BF16)(img, txt)["pred"].cpu().numpy()
        small = torch.from_numpy(rng.random((2, 128, 128, 3), dtype=np.float32))
        c16 = model.with_dtype(BF16)(small.to(dev), txt)["pred"].cpu().numpy()
        cpu = copy.deepcopy(model).cpu().with_dtype(BF16)
        h16 = cpu(small, txt.cpu())["pred"].numpy()
        c32 = model(small.to(dev), txt)["pred"].cpu().numpy()
    summary = {k: float(np.median(v)) for k, v in times.items()}
    summary.update(rms_card_bf16_vs_fp32_640_b4=rms_set(p16, p32), rms_card_bf16_vs_cpu_bf16_128_b2=rms_set(c16, h16),
                   rms_card_bf16_vs_card_fp32_128_b2=rms_set(c16, c32), launches=launches,
                   fp32_launches=counted["fp32"])
    say(f"bf16 serve tamtr.yaml 640px (medians of 5, modes in turns): {json.dumps(summary)}", flush=True)
    if not (np.isfinite(p16).all() and np.isfinite(c16).all()):
        raise AssertionError("bf16 serve outputs are not finite")
    return summary, launches


def bf16_train(dev):
    """`Trainer.step` of `tamtr.yaml` computing in bf16 beside fp32: 640 px,
    batch 4, max_gt 300, accumulate 1; each dtype's warm step ms (median of
    its timed steps), peak memory and busy share (the step's kernel time by
    torch.profiler over its wall time); the loss finite and every parameter
    and EMA tensor fp32 after the bf16 steps."""
    from torch.profiler import ProfilerActivity, profile

    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import Trainer, TrainConfig
    from tamtr_torch.weights import init_parameters

    batches = [synthetic_batch(300 + i, TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT, TRAIN_VALID) for i in range(5)]
    out, launches = {}, None
    for name, dtype in (("fp32", torch.float32), ("bf16", BF16)):
        model = TAMTRModel.from_cfg("tamtr.yaml", nc=10, max_gt=TRAIN_MAX_GT, dtype=dtype)
        init_parameters(model, 0)
        tr = Trainer(model, TrainConfig(batch_size=TRAIN_BATCH, accumulate=1), device=dev, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for b in batches[:2]:
            tr.step(b)
        counters = zero_counters()
        times, logs = [], []
        for b in batches[2:]:
            t0 = time.perf_counter()
            logs.append(tr.step(b))
            times.append((time.perf_counter() - t0) * 1e3)
        if dtype == BF16:
            launches = {k: f.launches for k, f in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.step(batches[-1])
            wall = (time.perf_counter() - t0) * 1e3
        busy = profiled_kernel_ms(prof)
        fp32 = all(t.dtype == torch.float32 for sd in (tr.model.state_dict(), tr.ema.state_dict())
                   for t in sd.values() if t.is_floating_point())
        finite = all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in logs)
        out[name] = dict(step_ms_median=float(np.median(times)), step_ms=times, max_memory_allocated_mib=peak / 2**20,
                         busy_share=busy and busy / wall, device_ms=busy, losses=[m["loss"] for m in logs],
                         weights_fp32=fp32)
        say(f"bf16 phase train {name} tamtr.yaml {TRAIN_IMGSZ}px b{TRAIN_BATCH} max_gt {TRAIN_MAX_GT}: "
            f"{json.dumps(out[name])}", flush=True)
        if not (finite and fp32 and all(m["stepped"] == 1.0 for m in logs)):
            raise AssertionError(f"{name} training step: finite {finite}, weights fp32 {fp32}")
        del tr, model
        torch.cuda.empty_cache()
    want = {k: v * 3 for k, v in TRAIN_LAUNCHES_PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"bf16 train launches {launches}, want {want}")
    return out, launches


def bf16_fit(dev, data: str):
    """`Engine.train(bf16=True)` for one epoch of the fit phase's dataset
    (val after it at the model's bf16), the checkpoint's weights fp32, then
    `Engine.val(half=True)` on its `best`; launches counted apart."""
    from pathlib import Path

    from tamtr_torch.engine.model import Engine

    root = Path("build/fit/runs")
    args = dict(data=data, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, max_gt=FIT_MAX_GT, workers=0, warmup_epochs=4,
                conf=0.05, plots=False, project=str(root), name="fit_bf16", exist_ok=True)
    counters = zero_counters()
    eng = Engine("tamtr.yaml")
    res = eng.train(epochs=1, bf16=True, **args)
    train_launches = {k: f.launches for k, f in counters.items()}
    steps = len(eng.timing["step_ms"])
    want = {k: TRAIN_LAUNCHES_PER_STEP[k] * steps + FORWARD_LAUNCHES.get(k, 0) * math.ceil(FIT_VAL / TRAIN_BATCH)
            for k in counters}
    ckpt = torch.load(root / "fit_bf16" / "weights" / "best.pt", weights_only=False)["trainer"]
    fp32 = all(t.dtype == torch.float32 for part in ("model", "ema") for t in ckpt[part].values()
               if t.is_floating_point())
    counters = zero_counters()
    best = Engine("tamtr.yaml").load(root / "fit_bf16" / "weights" / "best.pt")
    val = best.val(half=True, **args)
    val_launches = {k: f.launches for k, f in counters.items()}
    val_want = {k: FORWARD_LAUNCHES.get(k, 0) * math.ceil(FIT_VAL / TRAIN_BATCH) for k in counters}
    summary = dict(steps=steps, step_ms_median=float(np.median(eng.timing["step_ms"][1:] or eng.timing["step_ms"])),
                   train_mAP50=res["mAP50"], val_half_mAP50=val["mAP50"], val_half_images_per_sec=val["images_per_sec"],
                   model_dtype=str(eng.model.dtype), checkpoint_fp32=fp32)
    say(f"bf16 fit tamtr.yaml {TRAIN_IMGSZ}px b{TRAIN_BATCH}, one epoch on {FIT_TRAIN}+{FIT_VAL} images: "
        f"{json.dumps(summary)}; launches train {train_launches}, val {val_launches}", flush=True)
    in_range = all(0.0 <= m[k] <= 1.0 for m in (res, val) for k in ("mAP50", "mAP50-95"))
    if not (fp32 and in_range and eng.model.dtype == BF16 and best.model.dtype == torch.float32):
        raise AssertionError(f"bf16 fit: checkpoint fp32 {fp32}, metrics in [0, 1] {in_range}")
    if train_launches != want or val_launches != val_want:
        raise AssertionError(f"bf16 fit launches: train {train_launches} (want {want}), val {val_launches} "
                             f"(want {val_want})")
    return summary, {k: train_launches[k] + val_launches[k] for k in counters}


def bf16_phase(dev, data: str):
    """The bf16 compute path: the kernels B1-B4 at bf16 I/O, then the main
    path at bf16 (serve, train, fit), every launch counter zeroed before
    each and read after; returns the kernels' bf16 rows, the summaries and
    the main path's bf16 launches."""
    scan_fwd, scan_bwd = bf16_scan_rows(dev)
    gather_fwd, gather_bwd = bf16_gather_rows(dev)
    offpath = bf16_offpath_rows(dev)
    serve_summary, serve_launches = bf16_serve(dev)
    train_summary, train_launches = bf16_train(dev)
    fit_summary, fit_launches = bf16_fit(dev, data)
    launches = {k: serve_launches[k] + train_launches[k] + fit_launches[k] for k in serve_launches}
    for k in ("ss2d_scan_fwd", "bilinear_gather_fwd", "ss2d_scan_carriers", "ss2d_scan_bwd_walk", "bilinear_gather_bwd"):
        if launches[k] == 0:
            raise AssertionError(f"the bf16 main path launched no {k}")
    return dict(scan_fwd=scan_fwd, scan_bwd=scan_bwd, gather_fwd=gather_fwd, gather_bwd=gather_bwd, offpath=offpath,
                serve=serve_summary, train=train_summary, fit=fit_summary, launches=launches)

# the JPEG fixtures of tools/make_jpeg_fixtures_torch.py, with their cv2 digests
JPEG_FIXTURES = "tests/torch_data/jpeg"
VIDEO_FIXTURES = "tests/torch_data/video"
# predict_files: the fixtures whose forwards are also run on the CPU
PARITY_FIXTURES = ("exif6_q90.jpg", "visdrone_1360x765_q85.jpg")
PARITY_TTA_FIXTURES = PARITY_FIXTURES[1:]  # with TTA: three CPU forwards an image
# track: the generated sequence (VisDrone's frame size) and the trackers run over it
TRACK_FRAMES, TRACK_HW = 12, (765, 1360)
TRACK_CPU_FRAMES = 2  # the sequence's head that the CPU predicts: a frame's tracks depend on no later frame
TRACKERS = {"bytetrack": {}, "botsort": {"gmc_method": "none", "with_reid": True}}
# track, the panned sequence: frames and the background's shift (x, y) in pixels per frame
TRACK_PAN_FRAMES, TRACK_PAN = 8, (4, 2)
# GMC card against CPU: (translation px, linear part), as tests/test_torch_gmc.py holds the port to JAX
GMC_TOL = {"sparseOptFlow": (0.05, 1e-3), "orb": (0.25, 5e-3), "sift": (0.25, 5e-3), "ecc": (0.05, 1e-3)}
# the WebP and TIFF fixtures of tools/make_image_fixtures_torch.py, with their cv2 digests
IMAGE_FIXTURES = ("tests/torch_data/webp", "tests/torch_data/tiff")
# the writers' oracles of tools/make_image_fixtures_torch.py: cv2's TIFF sha256 and lossless WebP size of
# each WebP and TIFF fixture's decode, of the 1360x765 JPEG fixture's and of a plot drawn over it
ENCODE_FIXTURES = "tests/torch_data/encode/expected.json"
WEBP_SIZE_RATIO = 1.5  # the port's lossless WebP at most this many times cv2's bytes
# the WebP and TIFF fixtures the cli phase predicts with save=True beside the JPEG ones
CLI_WEBP, CLI_TIFF = "lossless.webp", "lzw_bgr.tif"


def check_counts(phase: str, counters, forwards: int, extra=None):
    """Every launch counter read after `phase`: B1 and B2 ran
    FORWARD_LAUNCHES times `forwards`, `extra` the counts of any other
    kernel, and no kernel else."""
    launches = {k: f.launches for k, f in counters.items()}
    want = {k: FORWARD_LAUNCHES.get(k, 0) * forwards + (extra or {}).get(k, 0) for k in counters}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, want {want}")
    print(f"  {phase}: launches as counted, {time.perf_counter() - T0:.1f} s into the run", flush=True)
    return launches


def check_ss2d_pieces(dev):
    """The fused scan at state sizes and widths B1 and B3 are not compiled
    for (N in 8, 24; D = 96, not a multiple of 32), on the pieces of
    `ss2d_pieces` (one piece per group of 16 state lanes): forward within
    1e-4 and all eight gradients within 2e-3 of the plain scan and its
    plain backward, on the card. B1 and B3 launch once per piece."""
    from tamtr_torch.kernels.selective_scan import ss2d_scan, ss2d_scan_bwd_ref, ss2d_scan_ref

    g = torch.Generator().manual_seed(21)
    counters = zero_counters()
    err_f = err_b = 0.0
    pieces = 0
    for N in (8, 24):
        D, L, B = 96, 40 * 40, 2
        R = math.ceil(D / 32)
        args = [torch.randn(B, 2, L, D, generator=g), torch.randn(B, 2, 2, L, R, generator=g) * 0.6,
                (torch.rand(4, D, R, generator=g) * 2 - 1) * R**-0.5, torch.rand(4, D, generator=g) * -2 - 2,
                -torch.exp(torch.rand(4, D, N, generator=g) * 1.5), torch.randn(B, 2, 2, L, N, generator=g) * 0.6,
                torch.randn(B, 2, 2, L, N, generator=g) * 0.6, torch.randn(4, D, generator=g)]
        args = [t.to(dev) for t in args]
        dy = torch.randn(B, 4, L, D, generator=g).to(dev)
        ts = [t.clone().requires_grad_(True) for t in args]
        y = ss2d_scan(*ts)
        y.backward(dy)
        pieces += -(-N // 16)
        err_f = max(err_f, (y.detach() - ss2d_scan_ref(*args)).abs().max().item())
        for t, want in zip(ts, ss2d_scan_bwd_ref(*args, dy)):
            if not torch.allclose(t.grad, want, atol=2e-3, rtol=2e-3):
                raise AssertionError(f"ss2d_pieces N={N} D={D}: a gradient off by {(t.grad - want).abs().max()}")
            err_b = max(err_b, (t.grad - want).abs().max().item())
    if err_f > 1e-4:
        raise AssertionError(f"ss2d_pieces: forward off by {err_f}")
    per_piece = {"ss2d_scan_fwd": 1, "ss2d_scan_fwd_summaries": 1, "ss2d_scan_fwd_combine": 1,
                 "ss2d_scan_fwd_output": 1, "ss2d_scan_carriers": 1, "ss2d_scan_combine": 1, "ss2d_scan_bwd_walk": 1}
    launches = check_counts("ss2d_pieces", counters, 0, {k: v * pieces for k, v in per_piece.items()})
    say(f"ss2d_pieces N in (8, 24), D=96, L=1600, B=2: forward max_abs_err {err_f:.3g}, backward {err_b:.3g}; "
          f"launches {launches}", flush=True)
    return {"max_abs_err_fwd": err_f, "max_abs_err_bwd": err_b, "pieces": pieces}


def check_jpeg():
    """Every committed JPEG fixture (baseline and progressive) decoded on
    this machine (the host C++ decoder, `csrc/jpeg_decode.cpp`) to the
    sha256 digest cv2 gave when it was written, and that decode encoded (the
    host C++ encoder, `csrc/jpeg_encode.cpp`, quality 95) to the sha256 of
    `cv2.imencode`'s bytes; the host decode and encode times per
    megapixel."""
    import hashlib
    from pathlib import Path

    from tamtr_torch.data.image_io import encode_jpeg, imread, jpeg_shape

    counters = zero_counters()
    root = Path(JPEG_FIXTURES)
    expected = json.loads((root / "expected.json").read_text())
    encode_jpeg(imread(root / next(iter(expected))))  # builds the decoder and the encoder
    decode_ms, encode_ms = {}, {}
    for name, want in expected.items():
        t0 = time.perf_counter()
        for _ in range(3):
            img = imread(root / name)
        t1 = time.perf_counter()
        for _ in range(3):
            data = encode_jpeg(img)
        t2 = time.perf_counter()
        if list(img.shape) != want["shape"] or tuple(jpeg_shape(root / name)) != img.shape[:2] \
                or hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"]:
            raise AssertionError(f"jpeg: {name} does not decode to its cv2 digest")
        if hashlib.sha256(data).hexdigest() != want["imencode_sha256"]:
            raise AssertionError(f"jpeg: the encode of {name}'s decode is not cv2.imencode's bytes")
        mp = img.shape[0] * img.shape[1] / 1e6
        decode_ms[name] = (t1 - t0) / 3 * 1e3 / mp
        encode_ms[name] = (t2 - t1) / 3 * 1e3 / mp
    formats_ms = check_image_formats()
    check_counts("jpeg", counters, 0)
    say(f"jpeg: {len(expected)} fixtures equal their cv2 sha256 digests, decoded and encoded; host ms per "
          f"megapixel (host time on the card's machine): decode {json.dumps({k: round(v, 3) for k, v in decode_ms.items()})}"
          f"; encode {json.dumps({k: round(v, 3) for k, v in encode_ms.items()})}", flush=True)
    return decode_ms, encode_ms, formats_ms


def check_image_formats():
    """Every committed WebP and TIFF fixture decoded by `imread` (the host
    C++ decoders `csrc/webp_decode.cpp` and `csrc/tiff_decode.cpp`) to the
    sha256 digest of cv2's decode, `image_shape` equal to its shape; the
    host decode ms per megapixel of each (the best of 3)."""
    import hashlib
    from pathlib import Path

    from tamtr_torch.data.image_io import image_shape, imread

    ms, sums = {}, {}
    for folder in IMAGE_FIXTURES:
        root = Path(folder)
        for name, want in json.loads((root / "expected.json").read_text()).items():
            img = imread(root / name)  # the first read builds the decoder
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                img = imread(root / name)
                times.append(time.perf_counter() - t0)
            if list(img.shape) != want["shape"] or tuple(image_shape(root / name)) != img.shape[:2] \
                    or hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"]:
                raise AssertionError(f"image formats: {folder}/{name} does not decode to its cv2 digest")
            mp = img.shape[0] * img.shape[1] / 1e6
            ms[name] = min(times) * 1e3 / mp
            kind = "webp_" + name.split("_")[0].split(".")[0] if name.endswith(".webp") else "tiff"
            t, m = sums.get(kind, (0.0, 0.0))
            sums[kind] = (t + min(times) * 1e3, m + mp)
    overall = {k: t / m for k, (t, m) in sums.items()}
    say(f"image formats: {len(ms)} WebP and TIFF fixtures equal their cv2 sha256 digests; host decode ms per "
        f"megapixel (host time on the card's machine), over all the fixtures of a kind: "
        f"{json.dumps({k: round(v, 3) for k, v in overall.items()})}; per file: "
        f"{json.dumps({k: round(v, 3) for k, v in ms.items()})}", flush=True)
    return {"overall": overall, "per_file": ms, "encode": check_image_writers()}


def check_image_writers():
    """Each entry of `ENCODE_FIXTURES` (the decode of every WebP and TIFF
    fixture, of the 1360x765 JPEG fixture, and the plot `annotate_image`
    draws over it from the boxes stored with the entry) encoded by the host
    C++ writers: `encode_tiff` (`csrc/tiff_encode.cpp`) to the sha256 of
    `cv2.imencode(".tif")`'s bytes, `encode_webp` (`csrc/webp_encode.cpp`)
    to a lossless WebP that `decode_webp` gives back exactly, in at most
    `WEBP_SIZE_RATIO` x cv2's bytes. Host encode ms per megapixel of each
    writer (the best of 2 runs), over all the entries and per entry."""
    import hashlib
    from pathlib import Path

    from tamtr_torch.data.image_io import decode_webp, encode_tiff, encode_webp, imread
    from tamtr_torch.utils.plotting import annotate_image

    expected = json.loads(Path(ENCODE_FIXTURES).read_text())
    root = Path(ENCODE_FIXTURES).parent.parent
    tiny = np.zeros((1, 1, 3), np.uint8)
    encode_tiff(tiny), encode_webp(tiny)  # builds both writers
    per, ratio, sums = {}, {}, {"tiff": [0.0, 0.0], "webp": [0.0, 0.0]}
    for key, want in expected.items():
        img = imread(root / want["source"])
        if "plot" in want:
            p = want["plot"]
            img = annotate_image(img, np.asarray(p["boxes"], np.float32), np.asarray(p["scores"], np.float32),
                                 np.asarray(p["labels"]), p["names"])
        if hashlib.sha256(img.tobytes()).hexdigest() != want["sha256"]:
            raise AssertionError(f"image writers: the input of {key} is not the one its oracle was made from")
        times = {"tiff": [], "webp": []}
        for _ in range(2):
            t0 = time.perf_counter()
            tif = encode_tiff(img)
            t1 = time.perf_counter()
            webp = encode_webp(img)
            times["tiff"].append(t1 - t0)
            times["webp"].append(time.perf_counter() - t1)
        if hashlib.sha256(tif).hexdigest() != want["tiff_sha256"]:
            raise AssertionError(f"image writers: encode_tiff of {key} is not cv2.imencode's bytes")
        if not np.array_equal(decode_webp(webp), img):
            raise AssertionError(f"image writers: encode_webp of {key} does not decode back to it")
        ratio[key] = len(webp) / want["webp_bytes"]
        if ratio[key] > WEBP_SIZE_RATIO:
            raise AssertionError(f"image writers: encode_webp of {key} is {ratio[key]:.3f}x cv2's bytes")
        mp = img.shape[0] * img.shape[1] / 1e6
        per[key] = {k: min(v) * 1e3 / mp for k, v in times.items()}
        for k, v in times.items():
            sums[k][0] += min(v) * 1e3
            sums[k][1] += mp
    overall = {k: t / m for k, (t, m) in sums.items()}
    big = {k: {w: round(v, 3) for w, v in per[k].items()} for k in per if k.startswith("jpeg/")}
    say(f"image writers: {len(per)} images: encode_tiff equals cv2's sha256 on each, encode_webp decodes back "
        f"exactly at {min(ratio.values()):.3f}-{max(ratio.values()):.3f}x cv2's bytes (limit {WEBP_SIZE_RATIO}); "
        f"host encode ms per megapixel (host time on the card's machine), over all: "
        f"{json.dumps({k: round(v, 3) for k, v in overall.items()})}; the 1360x765 images: {json.dumps(big)}",
        flush=True)
    return {"overall": overall, "per_image": per, "webp_size_ratio": ratio}


def serve_model(seed: int = 1):
    """The full-width `tamtr.yaml` detector (nc 10, `spread_scores`
    weights) with 10 unit-norm random class text rows set as its classes."""
    from tamtr_torch import TAMTR

    det = TAMTR("tamtr.yaml", nc=10, seed=0)
    spread_scores(det.model, seed=seed)
    text = np.random.default_rng(4).standard_normal((10, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    det.set_classes([f"class{i}" for i in range(10)], text)
    return det


@contextlib.contextmanager
def recording_forwards(model, calls: list):
    """Keeps each forward's (img, text, pred) on the CPU."""
    h = model.register_forward_hook(lambda m, a, out: calls.append(
        (a[0].detach().cpu(), a[1].detach().cpu(), out["pred"].detach().cpu())))
    try:
        yield
    finally:
        h.remove()


def same_results(got, want, tol: float = 1e-3):
    """Two predict results of one image as a set: rows of normalized box
    and score paired by a min-cost assignment, each pair within `tol` with
    the same label; the worst paired difference and the unpaired count."""
    from scipy.optimize import linear_sum_assignment

    def rows(r):
        oh, ow = r.orig_shape
        return np.concatenate([r.boxes.xyxy / np.array([ow, oh, ow, oh], np.float32), r.boxes.conf[:, None]], 1)

    g, w = rows(got), rows(want)
    if not len(g) or not len(w):
        return 0.0, len(g) + len(w)
    dist = np.abs(g[:, None] - w[None]).max(-1)
    r, c = linear_sum_assignment(dist)
    ok = (dist[r, c] < tol) & (got.boxes.cls[r] == want.boxes.cls[c])
    return float(dist[r, c][ok].max(initial=0.0)), int(len(g) + len(w) - 2 * ok.sum())


def predict_files(dev):
    """`TAMTR.predict(<fixture directory>)` on the card at 640 px, without
    and with TTA (3 passes: 640, 544 flipped, 416), each image read by the
    host JPEG decoder and resized as cv2 resizes. Each launch counter is
    zeroed before and read after: B1 and B2 ran once per forward, nothing
    else. Two fixtures are predicted again on the card and on the CPU
    (`Engine.predict`, the same weights and classes), and one of them with
    TTA too: each forward's input
    is bitwise the card's, its output equal to the card's as a tie-robust
    set at 1e-3 (`same_set`), and each image's detections too
    (`same_results`)."""
    import copy

    from tamtr_torch.engine.model import Engine

    det = serve_model()
    n = len(json.loads(open(f"{JPEG_FIXTURES}/expected.json").read()))
    det.predict(JPEG_FIXTURES, augment=True)  # warm-up: conv algorithms at the three sizes
    out, ms, launches = {}, {}, {}
    for augment in (False, True):
        counters = zero_counters()
        t0 = time.perf_counter()
        res = det.predict(JPEG_FIXTURES, augment=augment)
        ms[augment] = (time.perf_counter() - t0) * 1e3 / len(res)
        run = check_counts(f"predict_files augment={augment}", counters, n * (3 if augment else 1))
        launches = {k: launches.get(k, 0) + v for k, v in run.items()}
        if len(res) != n or not all(np.isfinite(r.boxes.xyxy).all() for r in res):
            raise AssertionError(f"predict_files: {len(res)} results for {n} images, or boxes not finite")
        out[augment] = res
    cpu = Engine("tamtr.yaml", device="cpu")
    cpu.model = copy.deepcopy(det.model).cpu()
    cpu.set_classes(det._engine.names, det._engine.txt_feats)
    card_calls, cpu_calls = [], []
    t0 = time.perf_counter()
    with recording_forwards(det.model, card_calls), recording_forwards(cpu.model, cpu_calls):
        pairs = []
        for a, names in ((False, PARITY_FIXTURES), (True, PARITY_TTA_FIXTURES)):
            paths = [f"{JPEG_FIXTURES}/{f}" for f in names]
            pairs += [(g, c, a) for g, c in zip(det.predict(paths, augment=a),
                                                 cpu.predict(paths, imgsz=det.imgsz, augment=a))]
    cpu_s = time.perf_counter() - t0
    worst = unmatched = worst_r = unpaired = 0
    for (img, _, pred), (img_c, _, pred_c) in zip(card_calls, cpu_calls, strict=True):
        if not torch.equal(img, img_c):
            raise AssertionError("predict_files: the card's and the CPU's inputs differ")
        w, u = same_set(pred.numpy(), pred_c.numpy())
        worst, unmatched = max(worst, w), unmatched + u
    for g, c, a in pairs:
        w, u = same_results(g, c)
        if u > 2:
            raise AssertionError(f"predict_files: {g.path} augment={a}: {u} detections unpaired with the CPU's")
        worst_r, unpaired = max(worst_r, w), unpaired + u
    summary = dict(images=n, ms_per_image=ms[False], ms_per_image_tta=ms[True],
                   detections=[len(r) for r in out[False]], detections_tta=[len(r) for r in out[True]],
                   parity_forwards=len(card_calls), parity_worst=worst, parity_unmatched=unmatched,
                   results_worst=worst_r, results_unpaired=unpaired)
    say(f"predict_files tamtr.yaml 640px on {n} JPEG fixtures: {json.dumps(summary)}; card and cpu predict of "
          f"{len(paths)} fixtures {cpu_s:.1f} s; launches {launches}", flush=True)
    return summary, det, launches


def serve_http(det):
    """`ModelServer` on 127.0.0.1 (a free port) over `AutoBackend` of the
    predict model; through `RemoteModel`: batch 1 five times, batch 4 twice,
    then 4 batch-1 requests at once. Each reply's pred equals, bitwise, the
    in-process forward of the same inputs; request ms over HTTP beside the
    in-process ms. The counters: B1 and B2 once per forward, in-process
    ones included."""
    from concurrent.futures import ThreadPoolExecutor

    from tamtr_torch.data.image_io import imread
    from tamtr_torch.data.imgproc import resize_linear
    from tamtr_torch.nn.autobackend import AutoBackend
    from tamtr_torch.serve import ModelServer, RemoteModel

    backend = AutoBackend(det.model, imgsz=det.imgsz, device=det.device)
    names = sorted(json.loads(open(f"{JPEG_FIXTURES}/expected.json").read()))
    sz = (det.imgsz, det.imgsz)
    frames = np.stack([resize_linear(imread(f"{JPEG_FIXTURES}/{f}"), sz)[..., ::-1] for f in names[:4]])
    frames = frames.astype(np.float32) / 255.0
    txt = det._engine.txt_feats[None].astype(np.float32)
    backend(frames[:1], txt), backend(frames, txt)  # warm-up at both batch sizes
    srv = ModelServer(backend, meta={"nc": 10}).start()
    try:
        rm = RemoteModel(srv.url)
        rm(frames[:1], txt), rm(frames, txt)
        counters = zero_counters()
        reqs = [frames[i % 4][None].copy() for i in range(5)] + [frames, frames]  # whole arrays, as a request's
        http_ms, local_ms, mismatched = [], [], 0
        for x in reqs:
            t0 = time.perf_counter()
            (got,) = rm(x, txt)
            t1 = time.perf_counter()
            want = backend(x, txt)
            t2 = time.perf_counter()
            http_ms.append((t1 - t0) * 1e3)
            local_ms.append((t2 - t1) * 1e3)
            mismatched += int(not np.array_equal(got, want))
        singles = [frames[i][None].copy() for i in range(4)]
        with ThreadPoolExecutor(4) as pool:
            par = list(pool.map(lambda x: rm(x, txt)[0], singles))
        mismatched += sum(int(not np.array_equal(p, backend(x, txt))) for p, x in zip(par, singles))
        forwards = 2 * (len(reqs) + len(singles))
        launches = check_counts("serve_http", counters, forwards)
    finally:
        srv.stop()
    if mismatched:
        raise AssertionError(f"serve_http: {mismatched} replies differ from the in-process forward")
    summary = dict(http_ms_b1=http_ms[:5], local_ms_b1=local_ms[:5], http_ms_b4=http_ms[5:], local_ms_b4=local_ms[5:],
                   concurrent=len(singles), forwards=forwards)
    say(f"serve_http tamtr.yaml 640px: {json.dumps(summary)}; launches {launches}", flush=True)
    return summary, launches


def track_sequence(root, seed: int = 31):
    """TRACK_FRAMES frames of TRACK_HW (VisDrone's frame size): 6 boxes of
    their own colours moving at constant velocity across noise, two of them
    crossing, written as JPEG by the host encoder (quality 95) under `root`
    and read back by the host decoder: each decode within 4 levels mean of
    its frame. Returns the encode ms per frame."""
    from tamtr_torch.data.image_io import imread, imwrite

    H, W = TRACK_HW
    rng = np.random.default_rng(seed)
    start = rng.uniform([60, 60], [W - 400, H - 300], (6, 2))
    start[0], start[1] = (150, 300), (1100, 330)
    vel = rng.uniform(-15, 15, (6, 2))
    vel[0], vel[1] = (45, 2), (-45, 0)
    size = rng.uniform([60, 50], [220, 160], (6, 2))
    colours = rng.integers(80, 256, (6, 3))
    ms = []
    for f in range(TRACK_FRAMES):
        frame = rng.integers(30, 46, (H, W, 3), dtype=np.uint8)
        for (x, y), (w, h), c in zip((start + vel * f).astype(int), size.astype(int), colours):
            frame[max(y, 0):max(y + h, 0), max(x, 0):max(x + w, 0)] = c
        t0 = time.perf_counter()
        imwrite(root / f"{f:04d}.jpg", frame)
        ms.append((time.perf_counter() - t0) * 1e3)
        back = imread(root / f"{f:04d}.jpg")
        err = np.abs(back.astype(np.int16) - frame).mean()
        if back.shape != frame.shape or err > 4:
            raise AssertionError(f"track: frame {f} reads back as {back.shape}, mean error {err}")
    return ms


def track(det):
    """`TAMTR.track(<a generated JPEG sequence>)` on the card with each
    tracker of TRACKERS, every launch counter zeroed before and read after:
    B1 and B2 once per forward, one forward per frame and tracker, nothing
    else. The CPU's forward of each frame (`Engine.predict`, the same
    weights and classes) of the first TRACK_CPU_FRAMES frames, fed to the
    same trackers (`update_result_with_tracks`), gives the same track ids
    and boxes within 1e-3 (normalized) on those frames. Ms per frame: read, model and tracker host time."""
    import copy
    import shutil
    from pathlib import Path

    from tamtr_torch.data.image_io import imread
    from tamtr_torch.engine.model import Engine
    from tamtr_torch.trackers.byte_tracker import Track
    from tamtr_torch.trackers.track import make_tracker, update_result_with_tracks

    root = Path("build/track")
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    encode_ms = track_sequence(root)
    counters = zero_counters()
    card, timing = {}, {}
    for name, kw in TRACKERS.items():
        Track.reset_id()
        card[name] = det.track(str(root), tracker=name, **kw)
        timing[name] = {k: float(np.median(v)) for k, v in det._engine.timing.items()}
    launches = check_counts("track", counters, TRACK_FRAMES * len(TRACKERS))
    cpu = Engine("tamtr.yaml", device="cpu")
    cpu.model = copy.deepcopy(det.model).cpu()
    cpu.set_classes(det._engine.names, det._engine.txt_feats)
    t0 = time.perf_counter()
    head = [str(f) for f in sorted(root.glob("*.jpg"))[:TRACK_CPU_FRAMES]]
    detections = cpu.predict(head, imgsz=det.imgsz, conf=0.25, iou=0.7, max_det=300)
    cpu_s = time.perf_counter() - t0
    worst, ids = 0.0, {}
    for name, kw in TRACKERS.items():
        Track.reset_id()
        tracker = make_tracker(name, **kw)
        for g, r in zip(card[name][:TRACK_CPU_FRAMES], detections, strict=True):
            want = copy.deepcopy(r)
            update_result_with_tracks(want, tracker, frame=imread(r.path))
            if g.path != want.path or not np.array_equal(g.track_ids, want.track_ids):
                raise AssertionError(f"track {name}: {g.path}: ids {g.track_ids} on the card, {want.track_ids} "
                                     "on the CPU")
            scale = np.array([TRACK_HW[1], TRACK_HW[0]] * 2, np.float32)
            if len(g.track_ids):
                worst = max(worst, float(np.abs(g.boxes.xyxy / scale - want.boxes.xyxy / scale).max()))
        ids[name] = sorted({int(i) for r in card[name] for i in r.track_ids})
    scores = np.concatenate([r.boxes.conf for r in detections])
    quantiles = np.quantile(scores, [0, 0.5, 0.9, 1]).tolist() if len(scores) else []
    if not all(ids.values()):
        raise AssertionError(f"track: ids {ids} on {TRACK_FRAMES} frames; detection score quantiles {quantiles}")
    if worst > 1e-3:
        raise AssertionError(f"track: boxes off the CPU's by {worst}")
    summary = dict(frames=TRACK_FRAMES, ms_per_frame={k: {**v, "total": sum(v.values())} for k, v in timing.items()},
                   encode_ms_per_frame=float(np.median(encode_ms)), ids={k: len(v) for k, v in ids.items()},
                   tracks_per_frame={k: [len(r.track_ids) for r in v] for k, v in card.items()},
                   boxes_worst=worst, cpu_frames=TRACK_CPU_FRAMES, detection_score_quantiles=quantiles,
                   cpu_predict_s=cpu_s)
    say(f"track tamtr.yaml {det.imgsz}px on {TRACK_FRAMES} generated {TRACK_HW[1]}x{TRACK_HW[0]} JPEG frames: "
          f"{json.dumps(summary)}; launches {launches}", flush=True)
    summary["pan"], pan_launches = track_pan(det)
    return summary, launches, pan_launches


def video_phase(det):
    """The video phase (7d-video): the fixtures decoded to cv2's digests,
    the track phase's frames through the port's writer and reader, then
    track and predict on that `.mp4` on the card. Returns the summary and
    the launches of track (save=True) and of predict."""
    import hashlib
    import shutil
    from pathlib import Path

    from tamtr_torch.data.image_io import imread
    from tamtr_torch.data.video_io import VideoReader, VideoWriter
    from tamtr_torch.trackers.byte_tracker import Track

    sha = lambda b: hashlib.sha256(bytes(b)).hexdigest()  # noqa: E731
    root = Path(VIDEO_FIXTURES)
    expected = json.loads((root / "expected.json").read_text())
    counters = zero_counters()
    fixtures = {}
    for name, want in expected.items():
        if not isinstance(want, dict) or "fps" not in want:
            continue
        t0 = time.perf_counter()
        with VideoReader(root / name) as r:
            packets = list(r.packets())
            if [{"size": len(p), "sha256": sha(p)} for p in packets] != want["packets"] or r.fps != want["fps"] \
                    or r.frame_count != want["frame_count"] or list(r.size) != want["size"]:
                raise AssertionError(f"video: {name}: packets, fps, count or size differ from cv2's")
            if r.codec == "mjpeg":
                got = [sha(f.tobytes()) for f in r]
                if got != want["imdecode_sha256"]:
                    raise AssertionError(f"video: {name}: frames differ from cv2.imdecode of their packets")
            else:
                dec, luma, bgr = r.decoder(), [], []
                for p in packets:
                    if dec.decode(p):
                        luma.append(sha(dec.planes()[0].tobytes()))
                        bgr.append(sha(dec.bgr().tobytes()))
                if luma != want["luma_sha256"] or bgr != want["bgr_sha256"]:
                    raise AssertionError(f"video: {name}: frames differ from cv2's decode")
        fixtures[name] = round((time.perf_counter() - t0) * 1e3, 3)
    check_counts("video fixtures", counters, 0)
    out = Path("build/video")
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    frames = [imread(f) for f in sorted(Path("build/track").glob("*.jpg"))]
    H, W = TRACK_HW
    H2, W2 = H & ~1, W & ~1  # an odd last row or column is not encoded, as by cv2.VideoWriter
    path = out / "track.mp4"
    enc_ms, recon = [], []
    with VideoWriter(path, 30.0, (W, H)) as w:
        for f in frames:
            t0 = time.perf_counter()
            w.write(f)
            enc_ms.append((time.perf_counter() - t0) * 1e3)
            recon.append(w.reconstruction())
    dec_ms, decoded = [], []
    with VideoReader(path) as r:
        it = iter(r)
        while True:
            t0 = time.perf_counter()
            f = next(it, None)
            if f is None:
                break
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            decoded.append(f)
        if (r.frame_count, r.size, r.fps) != (TRACK_FRAMES, (W2, H2), 30.0):
            raise AssertionError(f"video: {path} reads as {r.frame_count} frames of {r.size} at {r.fps} fps")
    if len(decoded) != TRACK_FRAMES or any(not np.array_equal(a, b) for a, b in zip(decoded, recon)):
        raise AssertionError("video: the decoded frames differ from the encoder's reconstruction")
    psnr = float(10 * np.log10(255.0 ** 2 / np.mean((np.stack(decoded).astype(np.float64)
                                                     - np.stack(frames)[:, :H2, :W2].astype(np.float64)) ** 2)))
    counters = zero_counters()
    Track.reset_id()
    t0 = time.perf_counter()
    got = det.track(str(path), save=True, project=str(out), name="track")
    track_s = time.perf_counter() - t0
    track_launches = check_counts("video track", counters, TRACK_FRAMES)
    Track.reset_id()
    want = det.track(decoded)
    worst, scale = 0.0, np.array([W2, H2, W2, H2], np.float32)
    for g, a in zip(got, want, strict=True):
        if not np.array_equal(g.track_ids, a.track_ids):
            raise AssertionError(f"video: {g.path}: ids {g.track_ids}, {a.track_ids} from the decoded arrays")
        if len(g.track_ids):
            worst = max(worst, float(np.abs(g.boxes.xyxy / scale - a.boxes.xyxy / scale).max()))
    if worst > 1e-6 or not any(len(g.track_ids) for g in got):
        raise AssertionError(f"video: tracks off those of the decoded arrays by {worst} (normalized), or no track")
    with VideoReader(out / "track" / "track.mp4") as r:
        if (r.frame_count, r.size) != (TRACK_FRAMES, (W2, H2)):
            raise AssertionError(f"video: the annotated .mp4 reads as {r.frame_count} frames of {r.size}")
    counters = zero_counters()
    pred = det.predict(str(path), vid_stride=2)
    predict_launches = check_counts("video predict", counters, (TRACK_FRAMES + 1) // 2)
    if [r.path for r in pred] != [f"{path}#{i}" for i in range(0, TRACK_FRAMES, 2)]:
        raise AssertionError(f"video: predict with vid_stride 2 gave {[r.path for r in pred]}")
    summary = dict(fixtures_ms=fixtures, frames=TRACK_FRAMES, size=[W, H], encoded_size=[W2, H2],
                   host_encode_ms_per_frame=float(np.median(enc_ms)),
                   host_decode_ms_per_frame=float(np.median(dec_ms)),
                   bytes_per_frame=path.stat().st_size / TRACK_FRAMES, psnr_db=psnr,
                   track_s=track_s, track_ids=len({int(i) for r in got for i in r.track_ids}),
                   boxes_worst_normalized=worst, predict_frames=len(pred))
    say(f"video: {len(fixtures)} fixtures equal cv2's digests; tamtr.yaml {det.imgsz}px track and predict on "
        f"the port's {W2}x{H2} .mp4: {json.dumps(summary)}; launches track {track_launches}, "
        f"predict {predict_launches}", flush=True)
    return summary, track_launches, predict_launches


def pan_sequence(root, seed: int = 37):
    """TRACK_PAN_FRAMES frames of TRACK_HW under `root` (JPEG, the host
    encoder): a smooth textured canvas (noise at 1/16 of the size, resized
    as cv2 resizes) cut at an offset that moves by TRACK_PAN per frame, and
    6 small boxes of their own colours moving across it. Returns the frames
    as read back by the host decoder."""
    from tamtr_torch.data.image_io import imread, imwrite
    from tamtr_torch.data.imgproc import resize_linear

    H, W = TRACK_HW
    dx, dy = TRACK_PAN
    rng = np.random.default_rng(seed)
    ch, cw = H + dy * TRACK_PAN_FRAMES + 40, W + dx * TRACK_PAN_FRAMES + 40
    canvas = resize_linear(rng.integers(0, 256, (ch // 16 + 1, cw // 16 + 1, 3), dtype=np.uint8), (cw, ch))
    start = rng.uniform([100, 100], [W - 200, H - 150], (6, 2))
    vel = rng.uniform(-12, 12, (6, 2))
    size = rng.uniform([30, 25], [80, 60], (6, 2))
    colours = rng.integers(0, 256, (6, 3))
    frames = []
    for f in range(TRACK_PAN_FRAMES):
        frame = canvas[20 + dy * f:20 + dy * f + H, 20 + dx * f:20 + dx * f + W].copy()
        for (x, y), (w, h), c in zip((start + vel * f).astype(int), size.astype(int), colours):
            frame[max(y, 0):max(y + h, 0), max(x, 0):max(x + w, 0)] = c
        imwrite(root / f"{f:04d}.jpg", frame)
        frames.append(imread(root / f"{f:04d}.jpg"))
    return frames


def track_pan(det):
    """The panned sequence (`pan_sequence`) through `TAMTR.track` with
    BoT-SORT and its default GMC (sparseOptFlow) on the card: B1 and B2
    once per forward; the card's detections of the first TRACK_CPU_FRAMES
    frames through a CPU BOTSORT give the same ids and boxes within 1e-3
    (normalized). Then each GMC method on the card (every frame: the map
    within 0.5 px of the pan at the frame's centre; ms per frame, the
    median after the first), and on the card and the CPU over the middle
    quarter of the first two frames: the card's map within GMC_TOL of the
    CPU's. The CPU's ms per frame, the median of frames 2 and 3 (SIFT
    takes seconds a frame there), stand beside the card's."""
    import copy
    import shutil
    from pathlib import Path

    from tamtr_torch.trackers.byte_tracker import Track
    from tamtr_torch.trackers.gmc import GMC
    from tamtr_torch.trackers.track import make_tracker, update_result_with_tracks

    root = Path("build/track_pan")
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    frames = pan_sequence(root)
    counters = zero_counters()
    Track.reset_id()
    card = det.track(str(root), tracker="botsort", with_reid=True)
    timing = {k: float(np.median(v)) for k, v in det._engine.timing.items()}
    launches = check_counts("track_pan", counters, TRACK_PAN_FRAMES)
    if det._engine._tracker.gmc.method != "sparseOptFlow" or det._engine._tracker.gmc.device.type != "cuda":
        raise AssertionError("track_pan: BOTSORT's default GMC did not run sparseOptFlow on the card")
    head = [str(f) for f in sorted(root.glob("*.jpg"))[:TRACK_CPU_FRAMES]]
    detections = det._engine.predict(head, imgsz=det.imgsz, conf=0.25, iou=0.7, max_det=300)
    Track.reset_id()
    tracker = make_tracker("botsort", device="cpu", with_reid=True)
    worst = 0.0
    scale = np.array([TRACK_HW[1], TRACK_HW[0]] * 2, np.float32)
    for g, r, frame in zip(card[:TRACK_CPU_FRAMES], detections, frames, strict=False):
        want = copy.deepcopy(r)
        update_result_with_tracks(want, tracker, frame=frame)
        if not np.array_equal(g.track_ids, want.track_ids):
            raise AssertionError(f"track_pan: {g.path}: ids {g.track_ids} on the card, {want.track_ids} with the "
                                 "CPU's GMC")
        if len(g.track_ids):
            worst = max(worst, float(np.abs(g.boxes.xyxy / scale - want.boxes.xyxy / scale).max()))
    if worst > 1e-3:
        raise AssertionError(f"track_pan: boxes off the CPU tracker's by {worst}")
    centre = np.array([TRACK_HW[1] / 2, TRACK_HW[0] / 2, 1.0])
    truth = np.array([-TRACK_PAN[0], -TRACK_PAN[1]], np.float64)
    gmc_ms, gmc_cpu_ms, gmc_err, gmc_vs_cpu = {}, {}, {}, {}
    for method, (t_tol, lin_tol) in GMC_TOL.items():
        on_card, on_cpu = GMC(method, 2, device="cuda"), GMC(method, 2, device="cpu")
        maps, ms = [], []
        for frame in frames:
            t0 = time.perf_counter()
            maps.append(on_card.apply(frame))
            ms.append((time.perf_counter() - t0) * 1e3)
        # card against CPU on the middle quarter of the first two frames (the CPU's SIFT takes seconds a frame)
        crop = [np.ascontiguousarray(f[TRACK_HW[0] // 4:3 * TRACK_HW[0] // 4, TRACK_HW[1] // 4:3 * TRACK_HW[1] // 4])
                for f in frames[:2]]
        on_card_crop = GMC(method, 2, device="cuda")
        card_crop, cpu_map = ([g.apply(f) for f in crop][1] for g in (on_card_crop, on_cpu))
        err = max(float(np.abs(M.astype(np.float64) @ centre - centre[:2] - truth).max()) for M in maps[1:])
        dt = float(np.abs(card_crop[:, 2] - cpu_map[:, 2]).max())
        dlin = float(np.abs(card_crop[:, :2] - cpu_map[:, :2]).max())
        if err > 0.5 or dt > t_tol or dlin > lin_tol:
            raise AssertionError(f"track_pan: GMC {method}: {err} px from the pan, card against CPU {dt} px "
                                 f"and {dlin}")
        gmc_ms[method] = float(np.median(ms[1:]))
        cpu_ms, full_cpu = [], GMC(method, 2, device="cpu")
        for frame in frames[:3]:
            t0 = time.perf_counter()
            full_cpu.apply(frame)
            cpu_ms.append((time.perf_counter() - t0) * 1e3)
        gmc_cpu_ms[method] = float(np.median(cpu_ms[1:]))
        gmc_err[method] = err
        gmc_vs_cpu[method] = [dt, dlin]
    check_counts("track_pan gmc", counters, TRACK_PAN_FRAMES + len(head))
    summary = dict(frames=TRACK_PAN_FRAMES, pan_px=TRACK_PAN, ms_per_frame={**timing, "total": sum(timing.values())},
                   tracks_per_frame=[len(r.track_ids) for r in card], boxes_worst_vs_cpu_gmc=worst,
                   gmc_ms_per_frame_card=gmc_ms, gmc_ms_per_frame_cpu=gmc_cpu_ms, gmc_px_from_pan=gmc_err,
                   gmc_card_vs_cpu=gmc_vs_cpu)
    say(f"track_pan botsort (sparseOptFlow) tamtr.yaml {det.imgsz}px on {TRACK_PAN_FRAMES} panned "
        f"{TRACK_HW[1]}x{TRACK_HW[0]} JPEG frames: {json.dumps(summary)}; launches {launches}", flush=True)
    return summary, launches


def cli(best: str):
    """`python -m tamtr_torch predict model=<best.pt> source=<dir>
    save=True` in a subprocess on the card, over a copy of the JPEG
    fixtures and one lossless WebP fixture, then, in the same process, with
    `source=` a TIFF fixture (a directory's predict takes no .tif, as the
    JAX engine's); the process then prints its launch counters: exit 0,
    one line and one plot per image under the image's own name (each plot
    read back by `imread`: JPEG, the lossless WebP through `decode_webp`,
    the LZW TIFF through `decode_tiff`), B1 and B2 once per forward and
    nothing else."""
    import shutil
    from pathlib import Path

    from tamtr_torch.data.image_io import imread

    out, src = Path("build/cli"), Path("build/cli_src")
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(JPEG_FIXTURES, src, ignore=shutil.ignore_patterns("*.json"))
    shutil.copy(f"{IMAGE_FIXTURES[0]}/{CLI_WEBP}", src / CLI_WEBP)
    tif = Path(IMAGE_FIXTURES[1]) / CLI_TIFF
    names = sorted([*json.loads(open(f"{JPEG_FIXTURES}/expected.json").read()), CLI_WEBP, CLI_TIFF])
    n = len(names)
    argvs = [["tamtr_torch", "predict", f"model={best}", f"source={s}", "save=True", f"project={out}"]
             for s in (src, tif)]
    code = ("import json, runpy, sys\n"
            "torch = __import__('torch'); torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "from chip_smoke import zero_counters\n"
            "counters = zero_counters()\n"
            f"for argv in {argvs!r}:\n"
            "    sys.argv = argv\n"
            "    runpy.run_module('tamtr_torch', run_name='__main__')\n"
            "print(json.dumps({k: f.launches for k, f in counters.items()}))\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0:
        raise AssertionError(f"cli: exit {res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    preds = [ln for ln in lines[:-1] if ln.endswith(" detections")]
    plots = sorted(p.name for p in (out / "predict").iterdir())
    if plots != names or any(imread(out / "predict" / f) is None for f in plots):
        raise AssertionError(f"cli: wrote {plots}, want readable plots named {names}")
    for f in (CLI_WEBP, CLI_TIFF):
        data = (out / "predict" / f).read_bytes()
        if (f.endswith(".webp") and data[12:16] != b"VP8L") or (f.endswith(".tif") and data[:4] != b"II*\0"):
            raise AssertionError(f"cli: the plot of {f} is not a lossless WebP / little-endian TIFF")
    launches = json.loads(lines[-1])
    want = {k: FORWARD_LAUNCHES.get(k, 0) * n for k in launches}
    if len(preds) != n or launches != want:
        raise AssertionError(f"cli: {len(preds)} lines for {n} images; launches {launches}, want {want}")
    say(f"cli: python -m tamtr_torch predict on {n} fixtures ({CLI_WEBP} and {CLI_TIFF} among them): exit 0, "
        f"{len(preds)} lines, {len(plots)} plots, {wall:.1f} s wall (process start, model load twice, kernels "
        f"loaded from build/); launches {launches}", flush=True)
    return launches

# the fuse phase: serve requests timed in rounds of unfused, fused, fused,
# unfused, this many requests a turn
FUSE_ROUNDS, FUSE_REQUESTS = 2, 4


def profiled_ops(model, img, txt):
    """One eval forward under torch.profiler: the count of the aten
    convolution and batch_norm ops, the CUDA kernels those ops launched, all
    CUDA kernels of the forward and their summed device time (None where
    CUPTI gave the session no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(img, txt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(img, txt)
            torch.cuda.synchronize()
    events = prof.events()

    def kernels(e):
        return len(e.kernels) + sum(kernels(c) for c in e.cpu_children)

    out = {}
    for op in ("convolution", "batch_norm"):
        top = [e for e in events if e.name == f"aten::{op}"]
        out[op] = len(top)
        out[f"{op}_kernels"] = sum(kernels(e) for e in top)
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    out["kernels"] = len(device)
    out["device_ms"] = sum(e.device_time for e in device) / 1e3 or None  # None: the session recorded no kernel
    return out


def fuse(dev):
    """`fuse=True`, the deploy fuse, on the full-width serve model at 640 px:
    the fused twin's pred against the unfused model's at batch 1 and 4
    (1e-4, `same_set`), with B1 and B2 launched as often per forward; the
    convolution and batch_norm ops and their kernels per forward
    (torch.profiler) before and after fusing; serve requests at batch 1 and
    4 timed fused and unfused in turns; `TAMTR.predict(<fixtures>,
    fuse=True)` against fuse=False (1e-4, the same labels). Every launch
    counter is zeroed before and read after: B1 and B2 once per forward."""
    from tamtr_torch.config import get_cfg

    det = serve_model()
    rng = np.random.default_rng(4)
    text = det._engine.txt_feats
    frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(4)]
    n_fix = len(json.loads(open(f"{JPEG_FIXTURES}/expected.json").read()))
    counters = zero_counters()
    forwards = 0
    plain = det.model
    fused = det._engine._eval_model(plain, get_cfg(overrides={"fuse": True}))
    txt = torch.as_tensor(text[None], device=dev)
    parity, per_forward = {}, {}
    for b in (1, 4):
        img = torch.from_numpy(rng.random((b, TRAIN_IMGSZ, TRAIN_IMGSZ, 3), dtype=np.float32)).to(dev)
        preds = {}
        for name, model in (("unfused", plain), ("fused", fused)):
            before = {k: f.launches for k, f in counters.items()}
            with torch.inference_mode():
                preds[name] = model(img, txt)["pred"].cpu().numpy()
            forwards += 1
            per_forward[(b, name)] = {k: f.launches - before[k] for k, f in counters.items() if f.launches - before[k]}
        if per_forward[(b, "unfused")] != per_forward[(b, "fused")]:
            raise AssertionError(f"fuse b{b}: launches per forward {per_forward}")
        parity[f"b{b}_worst"], parity[f"b{b}_unmatched"] = same_set(preds["fused"], preds["unfused"], tol=1e-4)
    img1 = torch.from_numpy(rng.random((1, TRAIN_IMGSZ, TRAIN_IMGSZ, 3), dtype=np.float32)).to(dev)
    ops = {name: profiled_ops(model, img1, txt) for name, model in (("unfused", plain), ("fused", fused))}
    forwards += 4
    if ops["fused"]["batch_norm"] != 0 or ops["fused"]["convolution"] >= ops["unfused"]["convolution"]:
        raise AssertionError(f"fuse: ops per forward {ops}")

    times = {(b, f): [] for b in (1, 4) for f in (False, True)}

    def request(b, f):
        t0 = time.perf_counter()
        res = det.predict(frames[0] if b == 1 else frames, text, fuse=f)  # ends in host copies
        dt = (time.perf_counter() - t0) * 1e3
        if len(res) != b:
            raise AssertionError("fuse: malformed predict result")
        return dt

    for b in (1, 4):
        for f in (False, True):  # warm-up: conv algorithms of both models
            request(b, f)
            forwards += 1
    for _ in range(FUSE_ROUNDS):
        for b in (1, 4):
            for f in (False, True, True, False):
                for _ in range(FUSE_REQUESTS):
                    times[(b, f)].append(request(b, f))
                    forwards += 1
    files = {f: det.predict(JPEG_FIXTURES, fuse=f) for f in (False, True)}
    forwards += 2 * n_fix
    worst_r = unpaired = 0
    for g, w in zip(files[True], files[False], strict=True):
        wr, u = same_results(g, w, tol=1e-4)
        if u > 2:
            raise AssertionError(f"fuse: {g.path}: {u} detections unpaired with fuse=False's")
        worst_r, unpaired = max(worst_r, wr), unpaired + u
    launches = check_counts("fuse", counters, forwards)
    med = {f"{'fused' if f else 'unfused'}_b{b}_ms_median": float(np.median(t)) for (b, f), t in times.items()}
    summary = dict(card=CARD, **parity, results_worst=worst_r, results_unpaired=unpaired,
                   ops_per_forward=ops, **med,
                   ms={f"{'fused' if f else 'unfused'}_b{b}": [round(x, 3) for x in t] for (b, f), t in times.items()})
    say(f"fuse tamtr.yaml 640px: {json.dumps(summary)}; launches {launches}", flush=True)
    return summary, launches


def autobatch_phase(dev):
    """`batch=-1`: the probe training steps of `autobatch_train` for
    `tamtr.yaml` at 640 px, max_gt 300 (every slot a box), at batch 1 and 2,
    their peaks, the fitted batch, then one `Trainer.step` at that batch:
    its loss finite and its peak 0.60 +- 0.10 of the card's memory. Every
    launch counter is zeroed before and read after: three training steps."""
    import gc

    from tamtr_torch.utils.autobatch import DEFAULT_FRACTION, autobatch, device_memory_bytes, train_step_peak

    gc.collect()
    torch.cuda.empty_cache()
    counters = zero_counters()
    limit = device_memory_bytes(dev)
    peaks = {}

    def probe(b):
        peaks[b], _ = train_step_peak("tamtr.yaml", 10, TRAIN_IMGSZ, TRAIN_MAX_GT, b, dev)
        return peaks[b]

    t0 = time.perf_counter()
    fit = autobatch(probe, limit)
    probe_s = time.perf_counter() - t0
    peak, m = train_step_peak("tamtr.yaml", 10, TRAIN_IMGSZ, TRAIN_MAX_GT, fit, dev)
    share = peak / limit
    launches = check_counts("autobatch", counters, 0, {k: 3 * v for k, v in TRAIN_LAUNCHES_PER_STEP.items()})
    summary = dict(card=CARD, memory_bytes=limit, probe_peak_bytes={str(b): v for b, v in peaks.items()},
                   fitted_batch=fit, step_peak_bytes=peak, step_peak_share=share, loss=m["loss"],
                   probes_s=probe_s)
    say(f"autobatch tamtr.yaml {TRAIN_IMGSZ}px max_gt {TRAIN_MAX_GT}: {json.dumps(summary)}; launches {launches}",
          flush=True)
    if not (math.isfinite(m["loss"]) and abs(share - DEFAULT_FRACTION) <= 0.10):
        raise AssertionError(f"autobatch: batch {fit}, loss {m['loss']}, peak share {share:.3f} "
                             f"(want {DEFAULT_FRACTION} +- 0.10)")
    return summary, launches


def info(best: str):
    """`TAMTR("tamtr.yaml").load(<fit's best.pt>).info()` on the card: its
    params and GFLOPs those of the same model on the CPU (`variable_count`,
    `flops_of`: the operation counts equal exactly). Every launch counter
    is zeroed before and read after: two forwards on the card."""
    from tamtr_torch import TAMTR
    from tamtr_torch.api import variable_count
    from tamtr_torch.utils.profiler import flops_of

    counters = zero_counters()
    det = TAMTR("tamtr.yaml").load(best)
    line = det.info(imgsz=TRAIN_IMGSZ)
    model = det.model
    txt = torch.zeros(1, model.nc, model.model[-1].hd)
    img = torch.zeros(1, TRAIN_IMGSZ, TRAIN_IMGSZ, 3)
    card = flops_of(model, img.cuda(), txt.cuda())
    launches = check_counts("info", counters, 2)
    cpu_model = TAMTR("tamtr.yaml", device="cpu").load(best).model
    t0 = time.perf_counter()
    cpu = flops_of(cpu_model, img, txt)
    cpu_s = time.perf_counter() - t0
    want = (f"TAMTR(tamtr.yaml): {len(cpu_model.specs) + 1} layers, {variable_count(cpu_model) / 1e6:.1f}M params, "
            f"{cpu['gflops']:.1f} GFLOPs @ {TRAIN_IMGSZ}px")
    say(f"info: {line!r}; flops card {card}, cpu {cpu} ({cpu_s:.1f} s); launches {launches}", flush=True)
    if line != want or card != cpu:
        raise AssertionError(f"info: card {line!r} {card}, cpu {want!r} {cpu}")
    return launches


# ---------------------------------------------------------------------------
# The YOLO Detect family (`yolo-gelan.yaml`) and the DETR loss variants
# ---------------------------------------------------------------------------

YOLO_NC = 10
YOLO_STEPS = 3  # timed Trainer.steps, after two warm-up steps
VARIANTS = {"use_sl": dict(use_sl=True), "use_svfl": dict(use_svfl=True), "nwd_loss": dict(nwd_loss=True),
            "use_wiseiou": dict(use_wiseiou=True)}


def spread_detect(model):
    """A fresh Detect head that assigns and detects: class biases 0 (scores
    near 0.5, not the prior's 1e-4) and box biases that put each side's DFL
    mass on bins 1 and 2 (boxes of about 3 cells, not 15)."""
    head = model.model[-1]
    with torch.no_grad():
        for b, c in zip(head.cv2, head.cv3):
            b[2].bias.copy_((-2.0 * (torch.arange(head.reg_max, dtype=torch.float32) - 1.5).abs()).repeat(4))
            c[2].bias.zero_()


@torch.no_grad()
def calibrate_detect_head(model, img, txt):
    """The eval-mode head normalising `img`'s features with their own
    statistics (`tests/torch_engine_data.py:calibrated_head`): each head
    BatchNorm takes its input's batch moments, and the first of each branch
    a scale of sqrt((var + eps) / var), which undoes BatchNorm's eps. At
    init SiLU shrinks the activations to ~1e-4 at the head (~3e-7 at its
    deepest level), far under eps (1e-3): the head's outputs would be its
    biases alone, the same for every image."""
    feats = []
    head = model.model[-1]
    hook = head.register_forward_pre_hook(lambda m, a: feats.append(a[0]))
    model.eval()(img, txt)
    hook.remove()
    for f, branches in zip(feats[0], zip(head.cv2, head.cv3)):
        for br in branches:
            x = f
            for j, cb in enumerate(br[:2]):
                var, mean = torch.var_mean(cb.conv(x), (0, 2, 3), unbiased=False)
                cb.bn.running_mean.copy_(mean)
                cb.bn.running_var.copy_(var)
                if j == 0:
                    cb.bn.weight.mul_(torch.where(var > 0, torch.sqrt((var + cb.bn.eps) / var.clamp(min=1e-30)), 1.0))
                x = cb(x)


def yolo_train_parity(dev, batch, imgsz: int):
    """One training step of the full-width yolo-gelan (nc 10, the heads
    spread) on `batch` at `imgsz` px, max_gt 300, card against CPU from one
    state dict. TAL's assignment, a discrete function of the predictions, on the
    card against the CPU's: the anchors whose foreground flag or gt differ
    are counted and printed, at most 1% of the CPU's foreground. Then with
    the CPU's assignment given to the card and to a CPU fp64 pass: the
    largest relative loss-item difference card vs CPU <= 2x the CPU's vs
    fp64 (or 2e-6, twice the rounding of an fp32 sum over the B * A * nc =
    336000 terms of the class BCE at 640 px b4, should the fp64 pass come
    closer), and
    |g_card - g_cpu| <= 2 |g_cpu - g_fp64| over the whole gradient
    (`check_train_parity`'s rule). Returns the summary."""
    import copy

    from tamtr_torch.losses.v8_loss import V8LossConfig, v8_detection_loss
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters

    base = TAMTRModel.from_cfg("yolo-gelan.yaml", nc=YOLO_NC, max_gt=TRAIN_MAX_GT)
    init_parameters(base, 0)
    spread_detect(base)
    cfg = V8LossConfig(nc=YOLO_NC, imgsz=imgsz)

    def grads_on(d, dtype=torch.float32, assign=None):
        model = copy.deepcopy(base).to(d, dtype).train()
        t = {"cls": torch.from_numpy(batch["cls"]).to(d), "mask": torch.from_numpy(batch["mask"]).to(d),
             "bboxes": torch.from_numpy(batch["bboxes"]).to(d, dtype)}
        out = model(torch.from_numpy(batch["img"]).to(d, dtype) / 255.0, torch.from_numpy(batch["txt_feats"]).to(d))
        loss, items = v8_detection_loss(out, t, cfg, assign=None if assign is None else
                                        {k: v.to(d) for k, v in assign.items()})
        loss.backward()
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).detach().flatten().cpu().double()
                           for p in model.parameters()])
        vals = {"loss": float(loss.detach()), **{k: float(items[k].detach()) for k in ("box", "cls", "dfl")}}
        return vals, {k: v.cpu() for k, v in items["assign"].items()}, grads

    t0 = time.perf_counter()
    cpu_items, cpu_assign, cpu_g = grads_on(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    _, gpu_assign, gpu_own_g = grads_on(dev)
    fg, gfg = cpu_assign["fg_mask"], gpu_assign["fg_mask"]
    moved = int((fg != gfg).sum() + ((cpu_assign["target_gt"] != gpu_assign["target_gt"]) & fg & gfg).sum())
    fix_items, _, gpu_g = grads_on(dev, assign=cpu_assign)
    exact_items, _, exact_g = grads_on(torch.device("cpu"), torch.float64, assign=cpu_assign)
    rel = lambda a, b: max(abs(a[k] - v) / max(abs(v), 1e-12) for k, v in b.items())  # noqa: E731
    worst_fixed, item_noise = rel(fix_items, cpu_items), rel(cpu_items, exact_items)
    d_card, d_noise = (gpu_g - cpu_g).norm().item(), (cpu_g - exact_g).norm().item()
    finite = bool(torch.isfinite(gpu_own_g).all()) and all(math.isfinite(v) for v in fix_items.values())
    summary = dict(fg_cpu=int(fg.sum()), tal_anchors_moved=moved, items_cpu=cpu_items, items_card=fix_items,
                   worst_item_rel=worst_fixed, item_noise_rel=item_noise,
                   grad_rel=d_card / cpu_g.norm().item(), grad_noise_rel=d_noise / cpu_g.norm().item(),
                   cpu_fwd_bwd_s=cpu_s)
    B = batch["img"].shape[0]
    say(f"yolo train parity yolo-gelan {imgsz}px b{B} max_gt {TRAIN_MAX_GT}, TAL tensors "
        f"({B}, {TRAIN_MAX_GT}, {fg.shape[1]}): {json.dumps(summary)}", flush=True)
    if not (finite and fg.sum() > 0 and moved <= 0.01 * int(fg.sum()) and worst_fixed <= 2 * max(item_noise, 1e-6)
            and d_card <= 2 * d_noise):
        raise AssertionError(f"yolo train parity failed: {summary}")
    return summary


def yolo(dev, data: str):
    """The YOLO Detect family on the card: `yolo-gelan.yaml` at nc 10, full
    width, seeded weights with its heads spread, every launch counter zeroed
    before and read after: no kernel of the port runs on this path.
      - eval at 640 px, batch 1 and 4, of the serve phase's 1360x765 frames
        (resized on the card), its head calibrated on them
        (`calibrate_detect_head`): pred, boxes over the input size, equal to
        the CPU's on the same weights within 1e-3; `TAMTR.predict(images,
        text)` timed at batch 1 and 4, and the forward alone;
      - `fuse=True` against the fp32 unfused forward at batch 4 (1e-4),
        `half=True` and both (bf16: finite, the distance reported);
      - one training step card against CPU (`yolo_train_parity`), then
        `Trainer.step` timed: two warm-up and YOLO_STEPS timed steps, peak
        memory, busy share (a step's kernel time by torch.profiler over its
        wall);
      - `Engine.train` for 1 epoch of the fit dataset with val after it,
        then `Engine.val` square and rect on its `best.pt`;
      - `TAMTR.predict` of the JPEG fixtures with and without TTA, and
        `TAMTR.track` of the track phase's frames with `bytetrack`."""
    import copy
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from tamtr_torch import TAMTR
    from tamtr_torch.config import get_cfg
    from tamtr_torch.engine.model import Engine, normalized_pred
    from tamtr_torch.train.trainer import TrainConfig

    counters = zero_counters()
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(4)]
    text = rng.standard_normal((YOLO_NC, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    det = TAMTR("yolo-gelan.yaml", nc=YOLO_NC, seed=0)
    spread_detect(det.model)
    img, _ = det._to_batch(frames)
    txt = torch.from_numpy(text[None]).to(dev)
    calibrate_detect_head(det.model, img, txt)
    det.set_classes([f"class{i}" for i in range(YOLO_NC)], text)
    cpu_model = copy.deepcopy(det.model).cpu()
    hw = img.shape[1:3]
    out = {}
    with torch.inference_mode():
        for b in (1, TRAIN_BATCH):
            got = normalized_pred(det.model, det.model(img[:b], txt)["pred"], hw).cpu().numpy()
            want = normalized_pred(cpu_model, cpu_model(img[:b].cpu(), txt.cpu())["pred"], hw).numpy()
            out[f"eval_b{b}_worst"] = float(np.abs(got - want).max())
            out[f"eval_b{b}_score_std"] = float(want[..., 4:].std())
            if not np.isfinite(got).all() or out[f"eval_b{b}_worst"] > 1e-3 or want[..., 4:].std() < 0.05:
                raise AssertionError(f"yolo eval b{b}: card vs cpu {out}")
        base = normalized_pred(det.model, det.model(img, txt)["pred"], hw)
        for name, kw in (("fuse", dict(fuse=True)), ("half", dict(half=True)), ("fuse_half", dict(fuse=True,
                                                                                                   half=True))):
            twin = det._engine._eval_model(det.model, get_cfg(overrides=kw))
            p = normalized_pred(twin, twin(img, txt)["pred"], hw)
            out[f"{name}_worst"] = float((p - base).abs().max())
            out[f"{name}_rms"] = float((p - base).square().mean().sqrt())
            if not torch.isfinite(p).all() or p.dtype != torch.float32:
                raise AssertionError(f"yolo {name}: pred not finite fp32")
        if out["fuse_worst"] > 1e-4:
            raise AssertionError(f"yolo fuse: {out['fuse_worst']} from the unfused forward")
    times = {"b1": [], "b4": []}
    for key, images in (("b1", frames[0]), ("b4", frames)):
        det.predict(images, text)  # warm-up: conv algorithms
        for _ in range(5):
            t0 = time.perf_counter()
            res = det.predict(images, text)  # ends in host copies: the device has finished
            times[key].append((time.perf_counter() - t0) * 1e3)
            if not all(np.isfinite(r["boxes"]).all() for r in res):
                raise AssertionError("yolo serve: boxes not finite")
    out["serve_ms"] = times
    out["serve_ms_median"] = {k: float(np.median(v)) for k, v in times.items()}
    forward = {}
    with torch.inference_mode():
        for b in (1, TRAIN_BATCH):  # the eval forward alone, its boxes decoded: the rest of a request is host work
            ts = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                det.model(img[:b], txt)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            forward[f"b{b}"] = float(np.median(ts))
    out["forward_ms_median"] = forward

    batches = [synthetic_batch(100 + i, TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT, TRAIN_VALID, nc=YOLO_NC)
               for i in range(2 + YOLO_STEPS)]
    px, pb = SEG_POSE_PARITY  # the seg_pose parity's size: the CPU's fp32 and fp64 passes at 640 b4 cost ~4x
    out["train_parity"] = yolo_train_parity(dev, synthetic_batch(100, pb, px, TRAIN_MAX_GT, TRAIN_VALID[:pb],
                                                                 nc=YOLO_NC), px)
    trainer_det = TAMTR("yolo-gelan.yaml", nc=YOLO_NC, seed=0, max_gt=TRAIN_MAX_GT)
    spread_detect(trainer_det.model)
    tr = trainer_det.trainer(TrainConfig(batch_size=TRAIN_BATCH, accumulate=1), seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:2]:
        tr.step(b)
    steps, logs = [], []
    for b in batches[2:]:
        t0 = time.perf_counter()
        logs.append(tr.step(b))  # ends in host reads of the metrics
        steps.append((time.perf_counter() - t0) * 1e3)
    out["step_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(batches[-1])
        wall = (time.perf_counter() - t0) * 1e3
    busy = profiled_kernel_ms(prof)
    out.update(step_ms=steps, step_ms_median=float(np.median(steps)), step_device_ms=busy,
               step_busy_share=busy and busy / wall, step_items=[{k: m[k] for k in ("loss", "box", "cls", "dfl")} for m in logs])
    if not all(math.isfinite(m[k]) for m in logs for k in ("loss", "box", "cls", "dfl", "grad_norm")) \
            or not all(m["stepped"] == 1.0 for m in logs) or not all(m["box"] > 0 for m in logs):
        raise AssertionError(f"yolo steps: {logs}")
    del tr, trainer_det
    torch.cuda.empty_cache()

    root = Path("build/yolo")
    eng = Engine("yolo-gelan.yaml")
    fit = eng.train(data=data, epochs=1, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, max_gt=FIT_MAX_GT, workers=0,
                    warmup_epochs=4, val_interval=1, conf=0.05, plots=False, project=str(root), name="fit",
                    exist_ok=True)
    best = Engine("yolo-gelan.yaml").load(root / "fit" / "weights" / "best.pt")
    vals = {rect: best.val(data=data, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, conf=0.05, rect=rect, plots=False)
            for rect in (False, True)}
    out["fit"] = dict(step_ms_median=float(np.median(eng.timing["step_ms"][1:])), mAP50=fit["mAP50"],
                      val={("rect" if r else "square"): {k: v[k] for k in ("mAP50", "mAP50-95", "images_per_sec")}
                           for r, v in vals.items()})
    if not all(0.0 <= v[k] <= 1.0 for v in (fit, *vals.values()) for k in ("mAP50", "mAP50-95")):
        raise AssertionError(f"yolo fit: {out['fit']}")

    n = len(json.loads(open(f"{JPEG_FIXTURES}/expected.json").read()))
    for augment in (False, True):
        t0 = time.perf_counter()
        res = det.predict(JPEG_FIXTURES, augment=augment)
        out[f"predict_files_ms_per_image{'_tta' if augment else ''}"] = (time.perf_counter() - t0) * 1e3 / n
        if len(res) != n or not all(len(r) and np.isfinite(r.boxes.xyxy).all() for r in res):
            raise AssertionError(f"yolo predict augment={augment}: {[len(r) for r in res]}")
    tracked = det.track("build/track", tracker="bytetrack")
    out["track"] = dict(frames=len(tracked), tracks_per_frame=[len(r.track_ids) for r in tracked],
                        ms_per_frame={k: float(np.median(v)) for k, v in det._engine.timing.items()})
    if len(tracked) != TRACK_FRAMES or not any(len(r.track_ids) for r in tracked):
        raise AssertionError(f"yolo track: {out['track']}")
    launches = check_counts("yolo", counters, 0)
    say(f"yolo yolo-gelan {TRAIN_IMGSZ}px nc {YOLO_NC}: {json.dumps(out)}; launches {launches}", flush=True)
    return out, launches


SEG_POSE = {"segment": "yolo-seg-gelan.yaml", "pose": "yolo-pose-gelan.yaml"}
SEG_POSE_PARITY = (320, 2)  # the train parity's px and batch: the CPU's fp32 and fp64 passes at 640 b4 cost ~4x
SEG_POSE_STEPS = 3  # timed Trainer.steps at 640 px, batch 4, after two warm-up steps


@torch.no_grad()
def calibrate_task_head(model, img, txt):
    """`calibrate_detect_head` for any YOLO head (Detect, Segment, Pose;
    `tests/torch_engine_data.py:calibrate_yolo_head`): every head BatchNorm,
    the mask coefficients', keypoints' and Proto's too, takes its input's
    batch moments (the head run once in train mode from zeroed statistics,
    which then hold BN_MOMENTUM of the batch's), and the first of each
    branch and the Proto's first a scale of sqrt((var + eps) / var)."""
    from tamtr_torch.nn.layers import BN_MOMENTUM

    feats = []
    head = model.model[-1]
    hook = head.register_forward_pre_hook(lambda m, a: feats.append(a[0]))
    model.eval()(img, txt)
    hook.remove()
    bns = [m for m in head.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    firsts = [br[0].bn for name in ("cv2", "cv3", "cv4") for br in getattr(head, name, [])]
    if hasattr(head, "proto"):
        firsts.append(head.proto.cv1.bn)

    def take_stats():
        for bn in bns:
            bn.running_mean.zero_()
            bn.running_var.zero_()
        head.train()(feats[0])
        head.eval()
        for bn in bns:
            bn.running_mean.div_(BN_MOMENTUM)
            bn.running_var.div_(BN_MOMENTUM)

    take_stats()
    for bn in firsts:
        var = bn.running_var
        bn.weight.mul_(torch.where(var > 0, torch.sqrt((var + bn.eps) / var.clamp(min=1e-30)), 1.0))
    take_stats()


def task_batch(task: str, seed: int, B: int, imgsz: int, M: int, n_valid):
    """`synthetic_batch` with the task's labels: each valid gt's mask, an
    ellipse polygon of 12 points in its box filled at imgsz / 4 as `collate`
    fills it (segment), or 17 keypoints in its box, about a fifth invisible,
    in pixels (pose)."""
    from tamtr_torch.data.imgproc import fill_poly

    batch = synthetic_batch(seed, B, imgsz, M, n_valid, nc=YOLO_NC)
    rng = np.random.default_rng(seed + 1)
    box = batch["bboxes"]
    if task == "segment":
        hm = imgsz // 4
        masks = np.zeros((B, M, hm, hm), np.float32)
        a = np.linspace(0, 2 * np.pi, 12, endpoint=False)
        for b, j in zip(*np.nonzero(batch["mask"])):
            cx, cy, w, h = box[b, j] * hm
            fill_poly(masks[b, j], np.stack([cx + w / 2 * np.cos(a), cy + h / 2 * np.sin(a)], 1).astype(np.int32), 1.0)
        batch["masks"] = masks
    else:
        xy = (box[:, :, None, :2] + box[:, :, None, 2:] * rng.uniform(-0.5, 0.5, (B, M, 17, 2))) * imgsz
        vis = np.where(rng.random((B, M, 17, 1)) < 0.2, 0.0, 2.0)
        batch["keypoints"] = (np.concatenate([xy, vis], -1) * batch["mask"][..., None, None]).astype(np.float32)
    return batch


def task_dataset(data: str, task: str, root) -> str:
    """The fit dataset (`tools/smoke_train_torch.py` layout under `data`'s
    directory) copied under `root` with each box label turned to the task's
    row: a 12-point ellipse polygon in the box (segment), or the box and 17
    keypoints in it, about a fifth invisible (pose). Returns the data.json."""
    import shutil
    from pathlib import Path

    src, root = Path(data).parent, Path(root)
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(7)
    a = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    for split in ("train", "val"):
        shutil.copytree(src / split / "images", root / split / "images")
        (root / split / "labels").mkdir(parents=True)
        for lf in sorted((src / split / "labels").glob("*.txt")):
            rows = []
            for line in lf.read_text().splitlines():
                c, cx, cy, w, h = line.split()
                cx, cy, w, h = float(cx), float(cy), float(w), float(h)
                if task == "segment":
                    pts = np.stack([cx + w / 2 * np.cos(a), cy + h / 2 * np.sin(a)], 1).clip(0, 1)
                    rows.append(" ".join([c] + [f"{v:.5f}" for v in pts.ravel()]))
                else:
                    xy = np.stack([cx + w * rng.uniform(-0.45, 0.45, 17), cy + h * rng.uniform(-0.45, 0.45, 17)], 1)
                    kp = np.concatenate([xy.clip(0, 1), np.where(rng.random((17, 1)) < 0.2, 0.0, 2.0)], 1)
                    rows.append(" ".join([c, f"{cx:.5f} {cy:.5f} {w:.5f} {h:.5f}"] + [f"{v:.5f}" for v in kp.ravel()]))
            (root / split / "labels" / lf.name).write_text("\n".join(rows))
    meta = json.loads(Path(data).read_text())
    out = root / "data.json"
    out.write_text(json.dumps({**meta, "path": str(root)}))
    return str(out)


def task_train_parity(dev, task: str, batch):
    """One training step of the full-width segment or pose model (nc 10,
    heads spread) card against CPU from one state dict, by
    `yolo_train_parity`'s rule: TAL's anchors moved <= 1% of the CPU's
    foreground; given the CPU's assignment, the loss items within 2x the
    CPU's fp32-vs-fp64 distance (or 2e-6), the whole gradient within 2x the
    same distance. Returns the summary."""
    import copy

    from tamtr_torch.losses import v8_pose_loss, v8_seg_loss
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import head_loss, loss_config_for
    from tamtr_torch.weights import init_parameters

    imgsz = batch["img"].shape[1]
    base = TAMTRModel.from_cfg(SEG_POSE[task], nc=YOLO_NC, max_gt=TRAIN_MAX_GT)
    init_parameters(base, 0)
    spread_detect(base)
    cfg = loss_config_for(base, imgsz=imgsz)
    keys = ("loss", "box", "cls", "dfl") + (("seg",) if task == "segment" else ("pose", "kobj"))
    extra = "masks" if task == "segment" else "keypoints"

    def grads_on(d, dtype=torch.float32, assign=None):
        model = copy.deepcopy(base).to(d, dtype).train()
        t = {"cls": torch.from_numpy(batch["cls"]).to(d), "mask": torch.from_numpy(batch["mask"]).to(d),
             "bboxes": torch.from_numpy(batch["bboxes"]).to(d, dtype),
             extra: torch.from_numpy(batch[extra]).to(d, dtype)}
        out = model(torch.from_numpy(batch["img"]).to(d, dtype) / 255.0, torch.from_numpy(batch["txt_feats"]).to(d))
        if assign is None:
            loss, items = head_loss(out, t, cfg)
        else:
            fn = v8_seg_loss.v8_segmentation_loss if task == "segment" else v8_pose_loss.v8_pose_loss
            loss, items = fn(out, t, cfg, assign={k: v.to(d) for k, v in assign.items()})
        loss.backward()
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).detach().flatten().cpu().double()
                           for p in model.parameters()])
        vals = {"loss": float(loss.detach()), **{k: float(items[k].detach()) for k in keys[1:]}}
        return vals, {k: v.cpu() for k, v in items["assign"].items()}, grads

    t0 = time.perf_counter()
    cpu_items, cpu_assign, cpu_g = grads_on(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    _, gpu_assign, gpu_own_g = grads_on(dev)
    fg, gfg = cpu_assign["fg_mask"], gpu_assign["fg_mask"]
    moved = int((fg != gfg).sum() + ((cpu_assign["target_gt"] != gpu_assign["target_gt"]) & fg & gfg).sum())
    fix_items, _, gpu_g = grads_on(dev, assign=cpu_assign)
    exact_items, _, exact_g = grads_on(torch.device("cpu"), torch.float64, assign=cpu_assign)
    rel = lambda a, b: max(abs(a[k] - v) / max(abs(v), 1e-12) for k, v in b.items())  # noqa: E731
    worst_fixed, item_noise = rel(fix_items, cpu_items), rel(cpu_items, exact_items)
    d_card, d_noise = (gpu_g - cpu_g).norm().item(), (cpu_g - exact_g).norm().item()
    finite = bool(torch.isfinite(gpu_own_g).all()) and all(math.isfinite(v) for v in fix_items.values())
    summary = dict(px=imgsz, batch=len(batch["img"]), fg_cpu=int(fg.sum()), tal_anchors_moved=moved,
                   items_cpu=cpu_items, items_card=fix_items, worst_item_rel=worst_fixed, item_noise_rel=item_noise,
                   grad_rel=d_card / cpu_g.norm().item(), grad_noise_rel=d_noise / cpu_g.norm().item(),
                   cpu_fwd_bwd_s=cpu_s)
    if not (finite and fg.sum() > 0 and moved <= 0.01 * int(fg.sum()) and worst_fixed <= 2 * max(item_noise, 1e-6)
            and d_card <= 2 * d_noise and fix_items[keys[-1]] > 0):
        raise AssertionError(f"seg_pose {task} train parity failed: {summary}")
    return summary


def seg_pose(dev, data: str):
    """The YOLO segment and pose families on the card: `yolo-seg-gelan.yaml`
    and `yolo-pose-gelan.yaml` at nc 10, full width, seeded weights with the
    heads spread, every launch counter zeroed before and read after: no
    kernel of the port runs on these paths. For each:
      - eval at 640 px, batch 1 and 4, of the serve phase's 1360x765 frames
        (resized on the card), the head calibrated on them
        (`calibrate_task_head`): pred (boxes over the input size), and the
        mask coefficients and protos or the keypoints (over the input
        size), card against the CPU on one state dict within 1e-3;
        `TAMTR.predict(images, text)` timed at batch 1 and 4 (host clock),
        beside the forward alone; `TAMTR.predict` of the JPEG fixtures
        (a segment model's `Results` with masks);
      - one training step card against CPU at SEG_POSE_PARITY px and batch
        (`task_train_parity`), then `Trainer.step` at 640 px, batch 4,
        max_gt 300, two warm-up and SEG_POSE_STEPS timed steps: device ms,
        busy share, peak memory;
      - `Engine.train` for 1 epoch of the fit dataset relabelled for the
        task (`task_dataset`, workers 0) with val after it (mask_mAP50-95
        or pose_mAP50-95), then `best.pt` reloaded."""
    import copy
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from tamtr_torch import TAMTR
    from tamtr_torch.engine.model import Engine, normalized_pred
    from tamtr_torch.train.trainer import TrainConfig

    counters = zero_counters()
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(4)]
    text = rng.standard_normal((YOLO_NC, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    out = {}
    for task, cfg_name in SEG_POSE.items():
        res = {}
        det = TAMTR(cfg_name, nc=YOLO_NC, seed=0)
        spread_detect(det.model)
        img, _ = det._to_batch(frames)
        txt = torch.from_numpy(text[None]).to(dev)
        calibrate_task_head(det.model, img, txt)
        det.set_classes([f"class{i}" for i in range(YOLO_NC)], text)
        cpu_model = copy.deepcopy(det.model).cpu()
        hw = img.shape[1:3]
        extras = ("mask_coefs", "protos") if task == "segment" else ("keypoints",)
        with torch.inference_mode():
            for b in (1, TRAIN_BATCH):
                g, w = det.model(img[:b], txt), cpu_model(img[:b].cpu(), txt.cpu())
                worst = {"pred": float((normalized_pred(det.model, g["pred"], hw).cpu()
                                        - normalized_pred(cpu_model, w["pred"], hw)).abs().max())}
                for k in extras:
                    scale = torch.tensor([hw[1], hw[0], 1.0]) if k == "keypoints" else 1.0
                    worst[k] = float(((g[k].cpu() - w[k]) / scale).abs().max())
                    if not torch.isfinite(g[k]).all() or w[k].std() < 0.05:
                        raise AssertionError(f"seg_pose {task} eval b{b}: {k} not finite or not spread")
                res[f"eval_b{b}_worst"] = worst
                if not torch.isfinite(g["pred"]).all() or max(worst.values()) > 1e-3:
                    raise AssertionError(f"seg_pose {task} eval b{b}: card vs cpu {worst}")
        times = {"b1": [], "b4": []}
        for key, images in (("b1", frames[0]), ("b4", frames)):
            det.predict(images, text)  # warm-up: conv algorithms
            for _ in range(5):
                t0 = time.perf_counter()
                r = det.predict(images, text)  # ends in host copies: the device has finished
                times[key].append((time.perf_counter() - t0) * 1e3)
                if not all(np.isfinite(x["boxes"]).all() for x in r):
                    raise AssertionError(f"seg_pose {task} serve: boxes not finite")
        res["serve_ms_median"] = {k: float(np.median(v)) for k, v in times.items()}
        forward = {}
        with torch.inference_mode():
            for b in (1, TRAIN_BATCH):
                ts = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    det.model(img[:b], txt)
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t0) * 1e3)
                forward[f"b{b}"] = float(np.median(ts))
        res["forward_ms_median"] = forward
        n = len(json.loads(open(f"{JPEG_FIXTURES}/expected.json").read()))
        t0 = time.perf_counter()
        files = det.predict(JPEG_FIXTURES)
        res["predict_files_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / n
        masks_ok = all((r.masks is not None and r.masks.shape == (len(r), TRAIN_IMGSZ // 4, TRAIN_IMGSZ // 4)
                        and np.isfinite(r.masks).all()) if task == "segment" else r.masks is None for r in files)
        if len(files) != n or not all(len(r) and np.isfinite(r.boxes.xyxy).all() for r in files) or not masks_ok:
            raise AssertionError(f"seg_pose {task} predict files: {[len(r) for r in files]}, masks {masks_ok}")
        del det, cpu_model, img

        px, pb = SEG_POSE_PARITY
        res["train_parity"] = task_train_parity(dev, task, task_batch(task, 300, pb, px, TRAIN_MAX_GT,
                                                                      TRAIN_VALID[:pb]))
        batch = task_batch(task, 301, TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT, TRAIN_VALID)
        trainer_det = TAMTR(cfg_name, nc=YOLO_NC, seed=0, max_gt=TRAIN_MAX_GT)
        spread_detect(trainer_det.model)
        tr = trainer_det.trainer(TrainConfig(batch_size=TRAIN_BATCH, accumulate=1), seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            tr.step(batch)
        steps, logs = [], []
        for _ in range(SEG_POSE_STEPS):
            t0 = time.perf_counter()
            logs.append(tr.step(batch))  # ends in host reads of the metrics
            steps.append((time.perf_counter() - t0) * 1e3)
        res["step_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.step(batch)
            wall = (time.perf_counter() - t0) * 1e3
        busy = profiled_kernel_ms(prof)
        item_keys = [k for k in ("loss", "box", "cls", "dfl", "seg", "pose", "kobj") if k in logs[0]]
        res.update(step_ms_median=float(np.median(steps)), step_device_ms=busy, step_busy_share=busy and busy / wall,
                   step_items=[{k: m[k] for k in item_keys} for m in logs])
        if not all(math.isfinite(m[k]) for m in logs for k in item_keys + ["grad_norm"]) \
                or not all(m["stepped"] == 1.0 for m in logs) or not all(m["box"] > 0 for m in logs):
            raise AssertionError(f"seg_pose {task} steps: {logs}")
        del tr, trainer_det, batch
        torch.cuda.empty_cache()

        root = Path("build/seg_pose") / task
        task_data = task_dataset(data, task, root / "data")
        eng = Engine(cfg_name)
        fit = eng.train(data=task_data, epochs=1, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, max_gt=FIT_MAX_GT,
                        workers=0, warmup_epochs=4, val_interval=1, conf=0.05, plots=False, project=str(root),
                        name="fit", exist_ok=True)
        best = Engine(cfg_name).load(root / "fit" / "weights" / "best.pt")
        name = "mask" if task == "segment" else "pose"
        res["fit"] = dict(step_ms_median=float(np.median(eng.timing["step_ms"][1:])),
                          **{k: fit[k] for k in ("mAP50", "mAP50-95", f"{name}_mAP50", f"{name}_mAP50-95")})
        if best.model.head_type != ("Segment" if task == "segment" else "Pose") or not all(
                0.0 <= fit[k] <= 1.0 for k in ("mAP50-95", f"{name}_mAP50-95")):
            raise AssertionError(f"seg_pose {task} fit: {res['fit']}")
        del eng, best
        torch.cuda.empty_cache()
        out[task] = res
        say(f"seg_pose {cfg_name} {TRAIN_IMGSZ}px nc {YOLO_NC}: {json.dumps(res)}", flush=True)
    launches = check_counts("seg_pose", counters, 0)
    return out, launches


CLS_NC, CLS_IMGSZ = 10, 224
CLS_PARITY_BATCH = 8  # the train parity's batch: the CPU's fp32 and fp64 passes over classify-gelan at 224 px
CLS_STEP_BATCH, CLS_STEPS = 16, 3  # the timed step: two warm-up steps, then CLS_STEPS timed and one profiled


def calibrate_bn(model, img):
    """Every BatchNorm of `model` holding its input's batch moments over
    `img` in one train-mode forward (`tests/torch_engine_data.py:
    calibrate_bn`): in eval the model then computes that forward, its
    activations of order 1 at every layer (at init SiLU shrinks them to
    ~1e-4 at a GELAN's last map, and the logits would be the Dense biases)."""
    from tamtr_torch.nn.layers import BN_MOMENTUM

    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.running_mean.zero_()
            bn.running_var.zero_()
        model.train()(img, torch.zeros(img.shape[0], 1, 512, device=img.device))
        for bn in bns:
            bn.running_mean.div_(BN_MOMENTUM)
            bn.running_var.div_(BN_MOMENTUM)
    return model.eval()


def classify_train_parity(dev, base, batch):
    """One cross-entropy training step of `base` (a Classify model) card
    against CPU from one state dict, by `yolo_train_parity`'s rule: the loss
    within 2x the CPU's fp32-vs-fp64 distance (or 1e-6), the whole gradient
    within 2x the same distance. Returns the summary."""
    import copy

    from tamtr_torch.train.trainer import ce_loss

    def grads_on(d, dtype=torch.float32):
        model = copy.deepcopy(base).to(d, dtype).train()
        out = model(torch.from_numpy(batch["img"]).to(d, dtype), torch.zeros(1, 1, 512, device=d, dtype=dtype))
        loss, items = ce_loss(out, {"cls": torch.from_numpy(batch["cls"]).to(d)})
        loss.backward()
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).detach().flatten().cpu().double()
                           for p in model.parameters()])
        return {"loss": float(loss.detach()), "top1": float(items["top1"])}, grads

    t0 = time.perf_counter()
    cpu_items, cpu_g = grads_on(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    card_items, card_g = grads_on(dev)
    exact_items, exact_g = grads_on(torch.device("cpu"), torch.float64)
    rel = lambda a, b: abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-12)  # noqa: E731
    worst, noise = rel(card_items, cpu_items), rel(cpu_items, exact_items)
    d_card, d_noise = (card_g - cpu_g).norm().item(), (cpu_g - exact_g).norm().item()
    summary = dict(px=batch["img"].shape[1], batch=len(batch["img"]), loss_cpu=cpu_items["loss"],
                   loss_card=card_items["loss"], loss_rel=worst, loss_noise_rel=noise,
                   grad_rel=d_card / cpu_g.norm().item(), grad_noise_rel=d_noise / cpu_g.norm().item(),
                   cpu_fwd_bwd_s=cpu_s)
    if not (bool(torch.isfinite(card_g).all()) and math.isfinite(card_items["loss"])
            and worst <= 2 * max(noise, 1e-6) and d_card <= 2 * d_noise):
        raise AssertionError(f"classify train parity failed: {summary}")
    return summary


def image_folder(root, classes=("red", "green", "blue"), n=(8, 4), seed: int = 0) -> str:
    """An ImageFolder `root/{train,val}/<class>/*.png` written by the port's
    PNG encoder: n[0] and n[1] images a class of 200-300 px sides, noise
    with the class's colour channel raised; returns root."""
    from pathlib import Path

    from tamtr_torch.data.image_io import imwrite

    rng = np.random.default_rng(seed)
    for split, k in zip(("train", "val"), n):
        for ci, c in enumerate(classes):
            d = Path(root) / split / c
            d.mkdir(parents=True, exist_ok=True)
            for i in range(k):
                img = rng.integers(0, 80, (int(rng.integers(200, 300)), int(rng.integers(200, 300)), 3),
                                   dtype=np.uint8)
                img[..., 2 - ci] += 150  # BGR: the class's colour
                imwrite(d / f"{i}.png", img)
    return str(root)


def classify_phase(dev):
    """`classify-gelan.yaml` at full width (nc 10, seeded weights, every
    BatchNorm calibrated on 16 random images: `calibrate_bn`) on the card,
    every launch counter zeroed before and read after (no kernel of the
    port runs on this path):
      - eval at 224 px, batch 1 and 16: logits and probabilities card
        against the CPU on one state dict within 1e-3; `Engine.predict`
        (`YOLO.predict`) of the JPEG fixtures: one dict an image, its
        probabilities a distribution; the b1 forward's ms beside a
        one-file request's (host clock);
      - one cross-entropy step card vs CPU at 224 px, batch
        CLS_PARITY_BATCH (`classify_train_parity`), then `Trainer.step` at
        224 px, batch 16: two warm-up steps, CLS_STEPS timed, one profiled
        (wall, device ms, busy share), peak memory;
      - `YOLO.train` for one epoch (workers 0) on a generated ImageFolder
        of 3 classes and val after it: top-1 and top-5 printed; `best.pt`
        reloaded gives the trained model's probabilities."""
    import copy
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from tamtr_torch import YOLO
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import TrainConfig
    from tamtr_torch.weights import init_parameters

    counters = zero_counters()
    out = {}
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.random((CLS_STEP_BATCH, CLS_IMGSZ, CLS_IMGSZ, 3), dtype=np.float32)).to(dev)
    model = TAMTRModel.from_cfg("classify-gelan.yaml", nc=CLS_NC)
    init_parameters(model, 0)
    model = calibrate_bn(model.to(dev), img)
    cpu_model = copy.deepcopy(model).cpu()
    x = torch.from_numpy(rng.random((CLS_STEP_BATCH, CLS_IMGSZ, CLS_IMGSZ, 3), dtype=np.float32))
    txt = torch.zeros(1, 1, 512)
    with torch.inference_mode():
        for b in (1, CLS_STEP_BATCH):
            g, w = model(x[:b].to(dev), txt.to(dev)), cpu_model(x[:b], txt)
            worst = {k: float((g[k].cpu() - w[k]).abs().max()) for k in ("logits", "pred")}
            out[f"eval_b{b}_worst"] = worst
            out[f"eval_b{b}_logit_std"] = float(w["logits"].std())
            if not torch.isfinite(g["logits"]).all() or max(worst.values()) > 1e-3 or w["logits"].std() < 0.1:
                raise AssertionError(f"classify eval b{b}: card vs cpu {worst}, logit std {float(w['logits'].std())}")
        ts = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x[:1].to(dev), txt.to(dev))
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out["forward_b1_ms_median"] = float(np.median(ts[1:]))
    det = YOLO("classify-gelan.yaml", nc=CLS_NC, imgsz=CLS_IMGSZ, device=dev)
    det._lazy_engine().model = model
    det._engine.names = [f"class{i}" for i in range(CLS_NC)]
    n = len(json.loads(open(f"{JPEG_FIXTURES}/expected.json").read()))
    t0 = time.perf_counter()
    res = det.predict(JPEG_FIXTURES)
    out["predict_files_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / n
    one = f"{JPEG_FIXTURES}/{PARITY_FIXTURES[1]}"
    ts = []
    for _ in range(6):
        t0 = time.perf_counter()
        det.predict(one)
        ts.append((time.perf_counter() - t0) * 1e3)
    out["request_b1_ms_median"] = float(np.median(ts[1:]))
    if len(res) != n or not all(r["probs"].shape == (CLS_NC,) and abs(float(r["probs"].sum()) - 1) < 1e-4
                                and len(r["top5"]) == 5 for r in res):
        raise AssertionError(f"classify predict files: {[r['probs'].shape for r in res]}")
    del det, cpu_model

    batch = {"img": rng.random((CLS_PARITY_BATCH, CLS_IMGSZ, CLS_IMGSZ, 3), dtype=np.float32),
             "cls": rng.integers(0, CLS_NC, (CLS_PARITY_BATCH, 1)).astype(np.int32)}
    out["train_parity"] = classify_train_parity(dev, copy.deepcopy(model).cpu(), batch)
    step_batch = {"img": rng.integers(0, 256, (CLS_STEP_BATCH, CLS_IMGSZ, CLS_IMGSZ, 3), dtype=np.uint8),
                  "txt_feats": np.zeros((1, 1, 512), np.float32),
                  "cls": rng.integers(0, CLS_NC, (CLS_STEP_BATCH, 1)).astype(np.int32),
                  "bboxes": np.zeros((CLS_STEP_BATCH, 1, 4), np.float32), "mask": np.zeros((CLS_STEP_BATCH, 1), bool)}
    trainer_det = YOLO("classify-gelan.yaml", nc=CLS_NC, seed=0, max_gt=1, imgsz=CLS_IMGSZ, device=dev)
    tr = trainer_det.trainer(TrainConfig(batch_size=CLS_STEP_BATCH, accumulate=1), seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        tr.step(step_batch)
    steps, logs = [], []
    for _ in range(CLS_STEPS):
        t0 = time.perf_counter()
        logs.append(tr.step(step_batch))  # ends in host reads of the metrics
        steps.append((time.perf_counter() - t0) * 1e3)
    out["step_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(step_batch)
        wall = (time.perf_counter() - t0) * 1e3
    busy = profiled_kernel_ms(prof)
    out.update(step_ms=steps, step_ms_median=float(np.median(steps)), step_wall_profiled_ms=wall,
               step_device_ms=busy, step_busy_share=busy and busy / wall,
               step_items=[{k: m[k] for k in ("loss", "cls", "top1")} for m in logs])
    if not all(math.isfinite(m[k]) for m in logs for k in ("loss", "grad_norm")) \
            or not all(m["stepped"] == 1.0 for m in logs):
        raise AssertionError(f"classify steps: {logs}")
    del tr, trainer_det, model
    torch.cuda.empty_cache()

    root = Path("build/classify")
    data = image_folder(root / "data")
    fitter = YOLO("classify-gelan.yaml", imgsz=CLS_IMGSZ, device=dev)
    t0 = time.perf_counter()
    fit = fitter.train(data=data, epochs=1, batch=8, imgsz=CLS_IMGSZ, workers=0, warmup_epochs=0, lr0=1e-3,
                       plots=False, project=str(root), name="fit", exist_ok=True)
    fit_s = time.perf_counter() - t0
    val = fitter.val(data=data, batch=8)
    best = YOLO("classify-gelan.yaml", imgsz=CLS_IMGSZ, device=dev).load(root / "fit" / "weights" / "best.pt")
    src = f"{data}/val/red"
    diff = max(float(np.abs(a["probs"] - b["probs"]).max()) for a, b in zip(best.predict(src), fitter.predict(src)))
    out["fit"] = dict(fit, seconds=fit_s, val=val, best_reload_probs_worst=diff,
                      step_ms_median=float(np.median(fitter._engine.timing["step_ms"])))
    if best.model.head_type != "Classify" or val != fit or diff > 1e-5 or not 0.0 <= fit["top1"] <= 1.0:
        raise AssertionError(f"classify fit: {out['fit']}")
    del fitter, best
    torch.cuda.empty_cache()
    say(f"classify classify-gelan.yaml {CLS_IMGSZ}px nc {CLS_NC}: {json.dumps(out)}", flush=True)
    return out, check_counts("classify", counters, 0)


SAM_POINTS_STRIDE = 8  # generate's point grid: 8 x 8 prompts, one batch of 64 (the CPU side's cost)
SAM_GENERATE = dict(points_stride=SAM_POINTS_STRIDE, conf_thres=-10.0, stability_score_thresh=-1.0)
SAM_PARITY_PX = {"mobile_sam": 1024, "sam_b": 1024}  # the card-vs-CPU size of each model
SAM_FIXTURE = f"{JPEG_FIXTURES}/{PARITY_FIXTURES[1]}"  # the 1360x765 fixture
# Seeded weights give every low-res mask a box of the whole letterboxed input (0.984-0.992 of its area on
# the card, mobile_sam and sam_b, spread or not), so NMS at any IoU below 1 keeps one mask of the 192 (64
# points x 3). The parity's NMS drops only boxes of IoU above 1: every mask goes through the filters, the
# boxes, the sort and the upscale into the comparison.
SAM_NMS_IOU = 1.0
SAM_MIN_MASKS = 4  # generate must keep at least this many masks


@torch.no_grad()
def spread_sam(sam, seed: int = 0, scale: float = 0.2):
    """A SAM with its zero-initialised tensors (pos_embed, rel_pos_*,
    attention_biases, the biases) and its norms' and BatchNorms' scales,
    biases and statistics given seeded random values, so that every
    parameter moves the output and segment-everything keeps many masks
    (the CPU tests' `tests/torch_engine_data.py:spread_sam`)."""
    g = torch.Generator().manual_seed(seed)
    for name, t in sam.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith("running_var"):
            t.copy_(torch.rand(t.shape, generator=g) + 0.5)
        elif name.endswith(("bias", "running_mean", "pos_embed", "rel_pos_h", "rel_pos_w", "attention_biases")):
            t.copy_(torch.randn(t.shape, generator=g) * scale)
        elif t.ndim == 1 and name.endswith("weight"):  # LayerNorm and BatchNorm scales
            t.copy_(1.0 + torch.randn(t.shape, generator=g) * scale)
    return sam


def sam_parity(dev, name: str, img):
    """A seeded SAM (`build_sam(name)`, or at SAM_PARITY_PX[name] through
    `_build_sam`), spread (`spread_sam`), card against CPU on one state
    dict: the image embedding within 1e-3, `prompt_inference` with 4 boxes
    and with 4 points (multimask), and with generate's own batch of 64 grid
    points before its filters: the low-res logits within 1e-3 and the
    scores within 1e-4; `generate` (SAM_GENERATE: every mask kept up to
    the NMS, SAM_NMS_IOU): at least SAM_MIN_MASKS masks, the same number on
    both, their sorted scores within 1e-4, each card mask of IoU >= 0.99
    with the CPU's (in order, or with its best CPU match where near-equal
    scores ordered them apart).
    The card's set_image and generate timed. Returns (summary, the card's
    predictor)."""
    import copy

    from tamtr_torch.models.sam import amg
    from tamtr_torch.models.sam.build import _build_sam, build_sam
    from tamtr_torch.models.sam.predict import SAMPredictor

    px = SAM_PARITY_PX[name]
    sam = spread_sam(build_sam(name) if px == 1024 else _build_sam(768, 12, 12, [2, 5, 8, 11], img_size=px))
    cpu = SAMPredictor(copy.deepcopy(sam), iou=SAM_NMS_IOU, device="cpu")
    card = SAMPredictor(sam, iou=SAM_NMS_IOU, device=dev)
    res = {"px": px}
    t0 = time.perf_counter()
    cpu.set_image(img)
    t1 = time.perf_counter()
    card.set_image(img)  # the first: cuDNN and cuBLAS pick their algorithms
    ts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        card.set_image(img)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t2) * 1e3)
    res.update(cpu_set_image_s=t1 - t0, set_image_ms_median=float(np.median(ts)),
               embedding_worst=float((card.features.cpu() - cpu.features).abs().max()),
               embedding_std=float(cpu.features.std()))
    h, w = img.shape[:2]
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, [w * 0.6, h * 0.6], (4, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(80, 300, (4, 2))], 1)
    points = rng.uniform(0, [w, h], (4, 2))
    grid = amg.build_all_layer_point_grids(SAM_POINTS_STRIDE, 0, 1)[0] * np.float32(px)  # generate's first batch
    for key, kw in (("boxes", dict(bboxes=boxes)), ("points", dict(points=points, multimask_output=True)),
                    ("grid", dict(points=grid, multimask_output=True))):
        card.segment_all = cpu.segment_all = key == "grid"  # grid points are in the input's pixels, as generate's
        (gl, gs), (wl, ws) = card.prompt_inference(**kw), cpu.prompt_inference(**kw)
        res[f"{key}_logits_worst"], res[f"{key}_scores_worst"] = float(np.abs(gl - wl).max()), float(
            np.abs(gs - ws).max())
        if gl.shape != wl.shape or not np.isfinite(gl).all() or res[f"{key}_logits_worst"] > 1e-3 \
                or res[f"{key}_scores_worst"] > 1e-4:
            raise AssertionError(f"sam {name} {key}: {res}")
    t0 = time.perf_counter()
    cm, cs, cb = cpu.generate(**SAM_GENERATE)
    res["cpu_generate_s"] = time.perf_counter() - t0
    card.generate(**SAM_GENERATE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gm, gs, gb = card.generate(**SAM_GENERATE)
    res["generate_ms"] = (time.perf_counter() - t0) * 1e3
    card.segment_all = cpu.segment_all = False
    iou = lambda a, b: float((a & b).sum() / max((a | b).sum(), 1))  # noqa: E731
    ious = [iou(a, b) for a, b in zip(gm, cm)]
    if len(gm) == len(cm) and min(ious, default=1.0) < 0.99:  # near-equal scores may order them apart
        ious = [max(iou(a, b) for b in cm) for a in gm]
    res.update(masks_card=len(gm), masks_cpu=len(cm), worst_mask_iou=min(ious, default=1.0),
               generate_scores_worst=float(np.abs(np.sort(gs) - np.sort(cs)).max()) if len(gs) == len(cs) else None)
    if len(gm) != len(cm) or len(gm) < SAM_MIN_MASKS or min(ious) < 0.99 or gm.shape[1:] != (px, px) \
            or res["generate_scores_worst"] > 1e-4:
        raise AssertionError(f"sam {name} generate: {res}")
    if res["embedding_worst"] > 1e-3:
        raise AssertionError(f"sam {name} embedding: {res}")
    return res, card


def fastsam_check(dev, img_path: str):
    """`FastSAM()` (`yolo-seg-gelan.yaml`, nc 10, seeded, heads spread and
    calibrated on the fixture) predicts the fixture on the card and on the
    CPU from one state dict: the same rows (labels equal, boxes within 1e-3
    of the image's size); then `FastSAM.prompt` by box and by points
    (one negative) on each `Results`: the masks equal but for pixels where
    the CPU's mask probability at the image's size lies within 1e-4 of
    0.5 (ties of the threshold)."""
    import copy

    from tamtr_torch import FastSAM
    from tamtr_torch.data.image_io import imread
    from tamtr_torch.data.imgproc import resize_linear_f32

    rng = np.random.default_rng(9)
    text = rng.standard_normal((YOLO_NC, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    im0 = imread(img_path)
    fs = FastSAM(nc=YOLO_NC, seed=0, device=dev)
    spread_detect(fs.model)
    x, _ = fs._to_batch([im0])
    calibrate_task_head(fs.model, x, torch.from_numpy(text[None]).to(dev))
    fs.set_classes([f"class{i}" for i in range(YOLO_NC)], text)
    cpu = FastSAM(nc=YOLO_NC, device="cpu")
    cpu._lazy_engine().model = copy.deepcopy(fs.model).cpu()
    cpu.set_classes([f"class{i}" for i in range(YOLO_NC)], text)
    (g,), (w,) = fs.predict(img_path, conf=0.25, max_det=20), cpu.predict(img_path, conf=0.25, max_det=20)
    oh, ow = im0.shape[:2]
    box_worst = float(np.abs(g.boxes.xyxy - w.boxes.xyxy).max() / max(oh, ow)) if len(g) == len(w) else None
    if len(g) != len(w) or not len(g) or not np.array_equal(g.boxes.cls, w.boxes.cls) or box_worst > 1e-3:
        raise AssertionError(f"fastsam rows: card {len(g)}, cpu {len(w)}, boxes {box_worst}")
    res = {"rows": len(g), "box_worst": box_worst, "mask_prob_worst": float(np.abs(g.masks - w.masks).max())}
    b = g.boxes.xyxy[0]
    prompts = {"box": dict(bboxes=b + [-5, -5, 5, 5]),
               "points": dict(points=[[(b[0] + b[2]) / 2, (b[1] + b[3]) / 2], [5, 5]], labels=[1, 0])}
    for key, kw in prompts.items():
        gm, wm = FastSAM.prompt(g, **kw), FastSAM.prompt(w, **kw)
        full = np.stack([resize_linear_f32(m.astype(np.float32), (ow, oh)) for m in w.masks])
        ties = (np.abs(full - 0.5) <= 1e-4).any(0)
        res[f"{key}_pixels"], res[f"{key}_differ"] = int(gm.sum()), int((gm != wm).sum())
        if gm.shape != (oh, ow) or ((gm != wm) & ~ties).any():
            raise AssertionError(f"fastsam {key}: {res}")
    if not res["box_pixels"] + res["points_pixels"]:
        raise AssertionError(f"fastsam: both prompts selected empty masks: {res}")
    return res


class _FewDetections:
    """A detector's predict capped at `max_det` boxes an image (a seeded
    detector finds hundreds at a low conf)."""

    def __init__(self, det, max_det: int):
        self.det, self.max_det = det, max_det

    def predict(self, source, conf: float = 0.25):
        return self.det.predict(source, conf=conf, max_det=self.max_det)


def annotate_check(dev, sam_predictor, root):
    """`auto_annotate` of the JPEG fixtures with a seeded `yolo-gelan.yaml`
    detector at conf 1e-6, 3 boxes an image, and the card's mobile_sam:
    every written line parses as a segment label
    (`DetectionDataset._parse_label_file`, task segment: one polygon a
    line, in [0, 1])."""
    import types
    from pathlib import Path

    from tamtr_torch import YOLO
    from tamtr_torch.data.annotator import auto_annotate
    from tamtr_torch.data.dataset import DetectionDataset

    det = YOLO("yolo-gelan.yaml", nc=YOLO_NC, seed=0, device=dev)
    det.set_classes([f"class{i}" for i in range(YOLO_NC)])
    t0 = time.perf_counter()
    out = auto_annotate(JPEG_FIXTURES, _FewDetections(det, 3), sam_model=sam_predictor, conf=1e-6,
                        output_dir=Path(root) / "labels")
    seconds = time.perf_counter() - t0
    parser = types.SimpleNamespace(task="segment", kpt_shape=(17, 3))
    files = sorted(out.glob("*.txt"))
    lines = segments = 0
    for f in files:
        n = len(f.read_text().splitlines())
        lab = DetectionDataset._parse_label_file(parser, str(f))
        lines, segments = lines + n, segments + len(lab["segments"])
        if len(lab["segments"]) != n or not all(((s >= 0) & (s <= 1)).all() for s in lab["segments"]):
            raise AssertionError(f"auto_annotate {f.name}: {n} lines, {len(lab['segments'])} segments")
    if not files:
        raise AssertionError("auto_annotate wrote no label")
    return dict(files=len(files), lines=lines, segments=segments, seconds=seconds)


def sam_phase(dev):
    """Segment Anything on the card with seeded weights (TF32 off, as the
    whole run), every launch counter zeroed before and read after (no
    kernel of the port runs on these paths): `sam_parity` of mobile_sam
    and sam_b at 1024 px on the 1360x765 fixture; sam_l and sam_h: one
    encode and one prompt batch of 4 boxes on the card alone, timed, peak
    memory, finite, shapes those of the JAX package's (64x64x256
    embedding, 256x256 logits); `fastsam_check`; `annotate_check` with
    mobile_sam."""
    from tamtr_torch.api import variable_count
    from tamtr_torch.data.image_io import imread
    from tamtr_torch.models.sam.build import build_sam
    from tamtr_torch.models.sam.predict import SAMPredictor

    counters = zero_counters()
    img = imread(SAM_FIXTURE)
    out = {}
    mobile = None
    for name in SAM_PARITY_PX:
        out[name], pred = sam_parity(dev, name, img)
        if name == "mobile_sam":
            mobile = pred
        else:
            del pred
        say(f"sam {name}: {json.dumps(out[name])}", flush=True)
    for name in ("sam_l", "sam_h"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pred = SAMPredictor(build_sam(name), device=dev)
        pred.set_image(img)  # cuDNN and cuBLAS pick their algorithms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.set_image(img)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t0) * 1e3
        boxes = np.array([[100, 100, 500, 400], [600, 200, 900, 700], [0, 0, 1359, 764], [300, 300, 350, 340]])
        t0 = time.perf_counter()
        lowres, scores = pred.prompt_inference(bboxes=boxes)
        dec_ms = (time.perf_counter() - t0) * 1e3
        res = dict(set_image_ms=enc_ms, prompt_ms=dec_ms, peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                   embedding_shape=list(pred.features.shape), logits_shape=list(lowres.shape),
                   params_m=variable_count(pred.sam) / 1e6)
        if res["embedding_shape"] != [1, 64, 64, 256] or res["logits_shape"] != [4, 256, 256] \
                or not (np.isfinite(lowres).all() and np.isfinite(scores).all()
                        and bool(torch.isfinite(pred.features).all())):
            raise AssertionError(f"sam {name}: {res}")
        out[name] = res
        say(f"sam {name}: {json.dumps(res)}", flush=True)
        del pred
    torch.cuda.empty_cache()
    out["fastsam"] = fastsam_check(dev, SAM_FIXTURE)
    say(f"sam fastsam: {json.dumps(out['fastsam'])}", flush=True)
    out["auto_annotate"] = annotate_check(dev, mobile, "build/annotate")
    say(f"sam auto_annotate: {json.dumps(out['auto_annotate'])}", flush=True)
    return out, check_counts("sam", counters, 0)


def loss_variants(dev):
    """One full-width TAM-TR `Trainer.step` at 640 px, batch 4, max_gt 300
    for each DETR loss switch (`use_sl`, `use_svfl`, `nwd_loss`,
    `use_wiseiou`), the launch counters zeroed before and read after each:
    B1-B5 as `TRAIN_LAUNCHES_PER_STEP`. Each step is finite, and its loss
    equals the CPU's loss of the same head outputs and targets (the card's
    assignment given) within 1e-5 relative; the CPU's own assignment of
    those outputs is counted against the card's. A step with the default
    loss runs first, uncounted and untimed (cuDNN picks its algorithms)."""
    import tamtr_torch.train.trainer as trainer_mod
    from tamtr_torch import TAMTR
    from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
    from tamtr_torch.train.trainer import TrainConfig, Trainer

    det = TAMTR("tamtr.yaml", nc=10, seed=0, max_gt=TRAIN_MAX_GT)
    batch = synthetic_batch(200, TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT, TRAIN_VALID)
    seen = []

    def recording(out, targets, cfg, **kw):
        loss, items = rtdetr_detection_loss(out, targets, cfg, **kw)
        seen.append(({k: v.detach().cpu() if torch.is_tensor(v) else v for k, v in out.items()},
                     {k: v.cpu() for k, v in targets.items()}, cfg, float(loss.detach()), items["match"].cpu()))
        return loss, items

    Trainer(det.model, TrainConfig(batch_size=TRAIN_BATCH, accumulate=1), device=dev, seed=0).step(
        synthetic_batch(199, TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT, TRAIN_VALID))  # warm-up: conv algorithms
    trainer_mod.rtdetr_detection_loss = recording
    out, total = {}, {}
    try:
        for name, kw in VARIANTS.items():
            tr = Trainer(det.model, TrainConfig(batch_size=TRAIN_BATCH, accumulate=1),
                         loss_cfg=DETRLossConfig(nc=10, **kw), device=dev, seed=0)
            counters = zero_counters()
            t0 = time.perf_counter()
            m = tr.step(batch)
            ms = (time.perf_counter() - t0) * 1e3
            launches = check_counts(f"loss_variants {name}", counters, 0, TRAIN_LAUNCHES_PER_STEP)
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
            outs, targets, cfg, card_loss, match = seen[-1]
            cpu_loss, cpu_items = rtdetr_detection_loss(outs, targets, cfg, match=match)
            _, own_items = rtdetr_detection_loss(outs, targets, cfg)
            valid = targets["mask"].bool()[None].expand_as(match)
            agree = float((own_items["match"] == match)[valid].float().mean())
            rel = abs(card_loss - float(cpu_loss)) / abs(float(cpu_loss))
            out[name] = dict(loss=m["loss"], giou=m["giou"], cls=m["class"], bbox=m["bbox"], ms=ms,
                             cpu_loss=float(cpu_loss), rel=rel, cpu_own_assignment_agrees=agree)
            if not (all(math.isfinite(m[k]) for k in ("loss", "grad_norm")) and rel <= 1e-5):
                raise AssertionError(f"loss_variants {name}: {out[name]}")
            del tr
    finally:
        trainer_mod.rtdetr_detection_loss = rtdetr_detection_loss
    say(f"loss_variants tamtr.yaml {TRAIN_IMGSZ}px b{TRAIN_BATCH} max_gt {TRAIN_MAX_GT}: {json.dumps(out)}; "
        f"launches {total}", flush=True)
    return out, total


def fwd_bwd(fn, args, dy):
    """y of `fn(*args)` and the gradients of every input given dy."""
    ts = [a.detach().requires_grad_() for a in args]
    y = fn(*ts)
    return y.detach(), torch.autograd.grad(y, ts, dy)


def seeded_combine_rows(args, L: int):
    """The combines of one block of 2 at one level (the first half of the
    tokens), each launch alone: B1's dry run (the block's decay and leaving
    state) and its seeded run, B3's dry run (decay and leaving carry) and
    its run seeded with the state and the carry; times and bounds."""
    from tamtr_torch.kernels.selective_scan import (
        SEG_STEPS, ss2d_scan_carriers, ss2d_scan_combine, ss2d_scan_fwd_combine, ss2d_scan_fwd_summaries,
    )

    layouts, dts_raw, dt_w, dt_b, A, Bs, Cs, Ds = args
    Lb = L // 2
    blk = [layouts[:, :, :Lb].contiguous(), dts_raw[..., :Lb, :].contiguous(), dt_w, dt_b, A,
           Bs[..., :Lb, :].contiguous(), Cs[..., :Lb, :].contiguous()]
    B, D, N = layouts.shape[0], A.shape[1], A.shape[2]
    S = -(-Lb // SEG_STEPS)
    dy = torch.randn(B, 4, Lb, D, device=layouts.device)
    h_loc, sdt = ss2d_scan_fwd_summaries(*blk)
    seed = torch.randn(B, 4, D, N, device=layouts.device) * 0.1
    ms_dry = cuda_ms(lambda: ss2d_scan_fwd_combine(A, h_loc, sdt, Lb, dry=True), iters=5)
    copies = iter([h_loc.clone() for _ in range(6)])
    ms_seeded = cuda_ms(lambda: ss2d_scan_fwd_combine(A, next(copies), sdt, Lb, seed=seed), iters=5)
    summ = ss2d_scan_carriers(*blk, dy)
    ms_dry_bwd = cuda_ms(lambda: ss2d_scan_combine(A, *summ, Lb, dry=True), iters=5)
    copies = iter([[t.clone() for t in summ[:2]] for _ in range(6)])
    ms_seeded_bwd = cuda_ms(lambda: ss2d_scan_combine(A, *next(copies), summ[2], Lb, seed_h=seed, seed_c=seed),
                            iters=5)
    # bytes: the (B, 4, S, D, N) states (read; rewritten by a seeded run),
    # the sums of dt and A read, the (B, 4, D, N) seeds read and ends
    # written; ~4 operations per (b, k, segment, d, n) on each chain
    states, sums, ends = 4 * B * S * D * N, 4 * B * S * D, 4 * B * D * N
    rows = dict(L_block=Lb, S=S, ms_fwd_dry=ms_dry, ms_fwd_seeded=ms_seeded, ms_bwd_dry=ms_dry_bwd,
                ms_bwd_seeded=ms_seeded_bwd)
    for name, nbytes, ops in (("fwd_dry", states + sums + 2 * ends, states),
                              ("fwd_seeded", 2 * states + sums + ends, states),
                              ("bwd_dry", 2 * states + sums + 2 * ends, 2 * states),
                              ("bwd_seeded", 4 * states + sums + 2 * ends, 2 * states)):
        b = bound(4 * nbytes, 4 * ops)
        rows[f"bound_{name}_ms"], rows[f"bound_{name}_by"] = b
    return rows


def counted(fn):
    """(fn(), the launches it made): every launch counter zeroed just
    before the call and read just after it."""
    counters = zero_counters()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: f.launches for k, f in counters.items() if f.launches}


def sp_blocks(dev, ns=(2, 4), plain_level=LEVELS_640[1]):
    """The sequence-parallel scans with their blocks in this process
    (`LocalBlocks`: the exchange a stack), at the three 640 px levels, batch
    4: `ss2d_scan_sp` forward and all eight gradients against `ss2d_scan`
    and `ss2d_scan_bwd` (1e-4, 2e-3), bitwise over two calls, at n = 2 and
    4 blocks; `selective_scan_sp` against `selective_scan` at G = 4 the same
    way. At `plain_level` both are also held against their plain blocked
    versions (`ss2d_scan_sp_ref`, `selective_scan_sp_ref`: the plain seeded
    scans on the same card tensors) at the same bounds. Every launch
    counter is zeroed before each of the two blocked calls and read after
    it: per block the summaries, the combine twice (dry, then seeded) and
    the output or walk, and no unsplit call; the totals are the sums of
    those readings. Times of the blocked calls (all n blocks in turn on
    this card) beside the unsplit scan's, and each seeded combine alone."""
    from tamtr_torch.kernels.selective_scan import selective_scan, ss2d_scan, ss2d_scan_bwd
    from tamtr_torch.parallel.seq_scan import (
        LocalBlocks, selective_scan_sp, selective_scan_sp_ref, ss2d_scan_sp, ss2d_scan_sp_ref,
    )

    def close(y, grads, want_y, want_g):
        e_f = (y - want_y).abs().max().item()
        e_b = max((a - b).abs().max().item() for a, b in zip(grads, want_g))
        ok = torch.allclose(y, want_y, rtol=1e-4, atol=1e-4) and all(
            torch.allclose(a, b, rtol=2e-3, atol=2e-3) and bool(torch.isfinite(a).all()) for a, b in zip(grads, want_g))
        return e_f, e_b, ok

    g = torch.Generator().manual_seed(23)
    rows, rows1d = [], []
    err = {"fwd": 0.0, "bwd": 0.0, "fwd_1d": 0.0, "bwd_1d": 0.0, "fwd_plain": 0.0, "bwd_plain": 0.0,
           "fwd_1d_plain": 0.0, "bwd_1d_plain": 0.0}
    total = {k: 0 for k in launch_counters()}
    for H, W, C in LEVELS_640:
        args, dy = scan_inputs(g, TRAIN_BATCH, H, W, C, dev)
        L, D = H * W, 2 * C
        want_y, want_g = ss2d_scan(*args), ss2d_scan_bwd(*args, dy)
        ms_fwd = cuda_ms(lambda: ss2d_scan(*args), iters=3)
        ms_bwd = cuda_ms(lambda: ss2d_scan_bwd(*args, dy), iters=3)
        row = dict(L=L, D=D, ms_unsplit_fwd=ms_fwd, ms_unsplit_bwd=ms_bwd, combines=seeded_combine_rows(args, L))
        for n in ns:
            sp = lambda *a: ss2d_scan_sp(*a, LocalBlocks(n))  # noqa: E731
            (y, grads), launches = counted(lambda: fwd_bwd(sp, args, dy))
            (y2, grads2), launches2 = counted(lambda: fwd_bwd(sp, args, dy))
            want_launches = {"ss2d_scan_fwd_summaries": n, "ss2d_scan_fwd_combine": 2 * n, "ss2d_scan_fwd_output": n,
                             "ss2d_scan_carriers": n, "ss2d_scan_combine": 2 * n, "ss2d_scan_bwd_walk": n}
            e_f, e_b, ok = close(y, grads, want_y, want_g)
            bitwise = torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
            plain = ""
            if (H, W, C) == plain_level:
                e_pf, e_pb, ok_plain = close(y, grads, *fwd_bwd(lambda *a: ss2d_scan_sp_ref(*a, LocalBlocks(n)),
                                                                args, dy))
                ok = ok and ok_plain
                row[f"n{n}_plain"] = dict(max_abs_err_fwd=e_pf, max_abs_err_bwd=e_pb)
                err["fwd_plain"], err["bwd_plain"] = max(err["fwd_plain"], e_pf), max(err["bwd_plain"], e_pb)
                plain = f"; against the plain blocks fwd {e_pf:.3g} bwd {e_pb:.3g}"
            del y, y2, grads, grads2
            for reading in (launches, launches2):
                for k, v in reading.items():
                    total[k] += v
            ms_sp = cuda_ms(lambda: ss2d_scan_sp(*args, LocalBlocks(n)), iters=3)
            ms_sp_both = cuda_ms(lambda: fwd_bwd(sp, args, dy), iters=2)
            row[f"n{n}"] = dict(max_abs_err_fwd=e_f, max_abs_err_bwd=e_b, bitwise_repeat=bitwise, launches=launches,
                                launches_repeat=launches2, ms_fwd=ms_sp, ms_fwd_bwd=ms_sp_both)
            err["fwd"], err["bwd"] = max(err["fwd"], e_f), max(err["bwd"], e_b)
            say(f"sp_blocks ss2d_scan_sp B={TRAIN_BATCH} L={L} D={D} n={n}: max_abs_err fwd {e_f:.3g} bwd {e_b:.3g}"
                f"{plain}; bitwise repeat {bitwise}; launches {launches}, on the repeat {launches2}; ms fwd "
                f"{ms_sp:.4f} fwd+bwd {ms_sp_both:.4f} (unsplit fwd {ms_fwd:.4f}, bwd {ms_bwd:.4f}; the n blocks in "
                f"turn on one card)", flush=True)
            if not (ok and bitwise and launches == want_launches == launches2):
                raise AssertionError(f"ss2d_scan_sp at L={L}, n={n}: errors {e_f}, {e_b}{plain}, bitwise {bitwise}, "
                                     f"launches {launches}, {launches2} (want {want_launches})")
        say(f"sp_blocks seeded combines alone, one block of 2 at L={L}: {json.dumps(row['combines'])}", flush=True)
        rows.append(row)
        del args, dy, want_y, want_g
        a1, dy1 = scan1d_inputs(g, L, D, dev)
        want_y, want_g = fwd_bwd(lambda *a: selective_scan(*a, chunk=512), a1, dy1)
        ms_1d = cuda_ms(lambda: selective_scan(*a1), iters=3)
        row1 = dict(G=4, L=L, Din=D, ms_unsplit_fwd=ms_1d)
        for n in ns:
            sp = lambda *a: selective_scan_sp(*a, LocalBlocks(n), chunk=512)  # noqa: E731
            (y, grads), launches = counted(lambda: fwd_bwd(sp, a1, dy1))
            (y2, grads2), launches2 = counted(lambda: fwd_bwd(sp, a1, dy1))
            want_launches = {"selective_scan_fwd_summaries": n, "selective_scan_fwd_combine": 2 * n,
                             "selective_scan_fwd_output": n}
            e_f, e_b, ok = close(y, grads, want_y, want_g)
            bitwise = torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
            plain = ""
            if (H, W, C) == plain_level:
                e_pf, e_pb, ok_plain = close(y, grads, *fwd_bwd(
                    lambda *a: selective_scan_sp_ref(*a, LocalBlocks(n), chunk=512), a1, dy1))
                ok = ok and ok_plain
                row1[f"n{n}_plain"] = dict(max_abs_err_fwd=e_pf, max_abs_err_bwd=e_pb)
                err["fwd_1d_plain"] = max(err["fwd_1d_plain"], e_pf)
                err["bwd_1d_plain"] = max(err["bwd_1d_plain"], e_pb)
                plain = f"; against the plain blocks fwd {e_pf:.3g} bwd {e_pb:.3g}"
            del y, y2, grads, grads2
            for reading in (launches, launches2):
                for k, v in reading.items():
                    total[k] += v
            ms_sp = cuda_ms(lambda: selective_scan_sp(*a1, LocalBlocks(n)), iters=3)
            row1[f"n{n}"] = dict(max_abs_err_fwd=e_f, max_abs_err_bwd=e_b, bitwise_repeat=bitwise,
                                 launches=launches, launches_repeat=launches2, ms_fwd=ms_sp)
            err["fwd_1d"], err["bwd_1d"] = max(err["fwd_1d"], e_f), max(err["bwd_1d"], e_b)
            say(f"sp_blocks selective_scan_sp G=4 L={L} Din={D} n={n}: max_abs_err fwd {e_f:.3g} bwd {e_b:.3g} "
                f"(the backward plain torch in both){plain}; bitwise repeat {bitwise}; launches {launches}, on the "
                f"repeat {launches2}; ms fwd {ms_sp:.4f} (unsplit {ms_1d:.4f})", flush=True)
            if not (ok and bitwise and launches == want_launches == launches2):
                raise AssertionError(f"selective_scan_sp at L={L}, n={n}: errors {e_f}, {e_b}{plain}, bitwise "
                                     f"{bitwise}, launches {launches}, {launches2} (want {want_launches})")
        # the seeded B6 combine alone, one block of 2
        from tamtr_torch.kernels.selective_scan import (
            SEG_STEPS, selective_scan_fwd_combine, selective_scan_fwd_summaries,
        )

        u, delta, A, Bs = a1[0][:, :L // 2].contiguous(), a1[1][:, :L // 2].contiguous(), a1[2], a1[3][:, :L // 2]
        h_loc, sdt = selective_scan_fwd_summaries(u, delta, A, Bs.contiguous())
        seed = torch.randn(4, D, 16, device=dev) * 0.1
        row1["ms_combine_dry"] = cuda_ms(lambda: selective_scan_fwd_combine(A, h_loc, sdt, L // 2, dry=True),
                                            iters=5)
        copies = iter([h_loc.clone() for _ in range(6)])
        row1["ms_combine_seeded"] = cuda_ms(lambda: selective_scan_fwd_combine(A, next(copies), sdt, L // 2, seed=seed),
                                            iters=5)
        S = -(-(L // 2) // SEG_STEPS)
        states, sums, ends = 4 * S * D * 16, 4 * S * D, 4 * D * 16
        row1["bound_combine_dry_ms"], row1["bound_combine_dry_by"] = bound(4 * (states + sums + 3 * ends), 4 * states)
        row1["bound_combine_seeded_ms"], row1["bound_combine_seeded_by"] = bound(4 * (2 * states + sums + 2 * ends),
                                                                               4 * states)
        rows1d.append(row1)
        del a1, dy1, want_y, want_g, h_loc, sdt
    return rows, rows1d, err, total



def trainer_state(tr) -> dict:
    """A trainer's model, EMA and optimizer moments, on the CPU."""
    out = {f"model.{k}": v.cpu() for k, v in tr.model.state_dict().items()}
    out.update({f"ema.{k}": v.cpu() for k, v in tr.ema.state_dict().items()})
    opt = getattr(tr.optimizer, "optim", tr.optimizer)  # ZeRO's local AdamW holds every shard at world 1
    for i, p in enumerate(tr.params):
        for k, v in opt.state.get(p, {}).items():
            out[f"opt.{i}.{k}"] = v.cpu()
    return out


def parallel_phase(data: str) -> dict:
    """Run in a process of its own (`--parallel`): `torch.distributed` over
    NCCL with a world of one rank on this card, deterministic kernels on.
    One `Trainer.step` of `tamtr.yaml` at 640 px, batch 4, max_gt 300 under
    the data group (`make_groups(1)`), plain and with ZeRO (`zero=True`),
    each bitwise the ungrouped step (and the ungrouped step bitwise its own
    repeat): an all-reduce over one rank is the identity. Then each kind of
    step (ungrouped, grouped, ZeRO, and ungrouped with the deterministic
    algorithms off) is timed in turn, a fresh trainer's first step apart
    from the median of its next two. Then
    `Engine.train` (fsdp=2) for one epoch of the fit dataset and
    `Engine.val` under the group, every launch counter zeroed before each
    and read after."""
    import copy

    import torch.distributed as dist

    from tamtr_torch.engine.model import Engine
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.parallel.dist import free_port, make_groups
    from tamtr_torch.train.trainer import Trainer, TrainConfig
    from tamtr_torch.weights import init_parameters

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        groups = make_groups(1)
        model = TAMTRModel.from_cfg("tamtr.yaml", nc=10, max_gt=TRAIN_MAX_GT)
        init_parameters(model, 0)
        batch = synthetic_batch(5, TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT, TRAIN_VALID)
        cfg = TrainConfig(batch_size=TRAIN_BATCH, accumulate=1, warmup_iters=1)

        def step(**kw):
            tr = Trainer(copy.deepcopy(model), cfg, device=dev, seed=1, **kw)
            return tr.step(batch), trainer_state(tr)

        def step_ms(warm: int = 2, deterministic: bool = True, **kw):
            """ms of each `Trainer.step` of one fresh trainer: its first,
            then `warm` more on the same batch (each synchronised)."""
            torch.backends.cudnn.deterministic = deterministic
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            tr, out = Trainer(copy.deepcopy(model), cfg, device=dev, seed=1, **kw), []
            for _ in range(1 + warm):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.step(batch)
                torch.cuda.synchronize()
                out.append(1e3 * (time.perf_counter() - t0))
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True, warn_only=True)
            return out

        ref, again = step(), step()
        counters = zero_counters()
        grouped = step(groups=groups)
        zero = step(groups=groups, zero=True)
        step_launches = {k: f.launches for k, f in counters.items()}
        # the world-1 cost of the data group and of ZeRO, and of the
        # deterministic algorithms (the fit phase runs the default ones):
        # each kind in turn, the first step apart from the warm ones
        kinds = (("ungrouped", {}), ("data_group", dict(groups=groups)), ("zero", dict(groups=groups, zero=True)),
                 ("ungrouped_nondeterministic", dict(deterministic=False)))
        timing = {k: {"first_ms": [], "warm_ms_median": []} for k, _ in kinds}
        for kind, kw in kinds:
            ms = step_ms(**kw)
            timing[kind]["first_ms"].append(ms[0])
            timing[kind]["warm_ms_median"].append(float(np.median(ms[1:])))

        def same(a, b):
            return a[0] == b[0] and a[1].keys() == b[1].keys() and all(torch.equal(a[1][k], b[1][k]) for k in a[1])

        bitwise = dict(repeat=same(ref, again), data_group=same(grouped, ref), zero=same(zero, ref))
        counters = zero_counters()
        t0 = time.perf_counter()
        eng = Engine("tamtr.yaml")
        res = eng.train(data=data, epochs=1, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, max_gt=FIT_MAX_GT, workers=0,
                        warmup_epochs=4, fsdp=2, conf=0.05, plots=False, project="build/parallel/runs", name="dp",
                        exist_ok=True)
        train_s = time.perf_counter() - t0
        train_launches = {k: f.launches for k, f in counters.items()}
        counters = zero_counters()
        val = eng.val(data=data, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, conf=0.05, plots=False)
        val_launches = {k: f.launches for k, f in counters.items()}
        steps = len(eng.timing["step_ms"])
    finally:
        dist.destroy_process_group()
    in_range = all(0.0 <= m[k] <= 1.0 for m in (res, val) for k in ("mAP50", "mAP50-95", "precision", "recall"))
    path = ("ss2d_scan_fwd", "ss2d_scan_carriers", "ss2d_scan_bwd_walk", "bilinear_gather_fwd", "bilinear_gather_bwd",
            "auction_assignment")
    unlaunched = [k for k in path if not (step_launches[k] and train_launches[k])] + \
        [k for k in ("ss2d_scan_fwd", "bilinear_gather_fwd") if not val_launches[k]]
    out = dict(backend="nccl", world=1, step_loss=ref[0]["loss"], bitwise=bitwise, step_ms=timing,
               engine_steps=steps, engine_step_ms_median=float(np.median(eng.timing["step_ms"])),
               engine_train_s=train_s, val_mAP50=val["mAP50"], val_mAP50_95=val["mAP50-95"],
               launches_steps=step_launches, launches_train=train_launches, launches_val=val_launches)
    say(f"parallel NCCL world 1: {json.dumps(out)}", flush=True)
    if not (all(bitwise.values()) and in_range and math.isfinite(ref[0]["loss"]) and not unlaunched):
        raise AssertionError(f"parallel: bitwise {bitwise}, metrics in [0, 1] {in_range}, "
                             f"kernels not launched {unlaunched}")
    return out


def parallel(data: str) -> dict:
    """`parallel_phase` in a process of its own (its NCCL group and the
    deterministic algorithms stay out of this process); its result line."""
    import os

    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    run = subprocess.run([sys.executable, __file__, "--parallel", data], env=env, capture_output=True, text=True,
                         timeout=900)
    print(run.stdout, end="", flush=True)
    if run.returncode != 0:
        raise AssertionError(f"parallel phase failed (exit {run.returncode}):\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])




# ---------------------------------------------------------------------------
# The DETR head family: rtdetr.yaml (AIFI, RTDETRDecoder) and the variant heads
# ---------------------------------------------------------------------------

RTDETR_NC = 10
RTDETR_STEPS = 3  # timed Trainer.steps, after two warm-up steps
RTDETR_PARITY = (320, 2)  # the train parity's px and batch: its CPU fp32 and fp64 passes at 640 b4 took ~80 s
# launches per forward of rtdetr.yaml: the gather once per decoder layer (6),
# no scan (no VSS mixers); per training step also the gather's backward
# (buckets, rows) per layer and the assignment of the 7 matched layers x 4
# images in one launch
RTDETR_FORWARD = {"bilinear_gather_fwd": 6}
RTDETR_STEP = {"bilinear_gather_fwd": 6, "pair_buckets": 6, "bilinear_gather_bwd": 6, "auction_assignment": 1}
SCAN_FWD = {k: 3 for k in ("ss2d_scan_fwd", "ss2d_scan_fwd_summaries", "ss2d_scan_fwd_combine", "ss2d_scan_fwd_output")}
SCAN_BWD = {k: 3 for k in ("ss2d_scan_carriers", "ss2d_scan_combine", "ss2d_scan_bwd_walk")}
# the variant heads on tamtr.yaml's wiring: (levels, extra head args, launches
# per forward, the gather's backward launches per step); B1 once per VSS level,
# B2 once per deformable attention (two a decoupled layer, the Dual core on
# each half); in a Dual step only the first half's outputs carry loss
HEAD_VARIANTS = {
    "ManbaDecoder": ([32, 36, 40], [], {**SCAN_FWD, "bilinear_gather_fwd": 3}, 3),
    "DecouplingManbaWorldDecoder": ([32, 36, 40], [True], {**SCAN_FWD, "bilinear_gather_fwd": 6}, 6),
    "DecouplingDFLManbaWorldDecoder": ([32, 36, 40], [True], {**SCAN_FWD, "bilinear_gather_fwd": 6}, 6),
    "locationManbaDecoder": ([32, 36, 40], [], {**SCAN_FWD, "bilinear_gather_fwd": 3}, 3),
    "DualRTDETRDecoder": ([32, 36, 32, 36], [], {"bilinear_gather_fwd": 6}, 3),
}
HEADS_IMGSZ, HEADS_BATCH, HEADS_MAX_GT = 160, 2, 32  # at 256 px a head took ~40 s, mostly the CPU side


def launches_of(*parts):
    """The launch counts of `parts`, (per-unit counts, units) pairs, summed."""
    out = {}
    for per, n in parts:
        for k, v in per.items():
            out[k] = out.get(k, 0) + v * n
    return out


def expect_launches(phase: str, counters, want: dict):
    """Every launch counter read after `phase`: `want`'s counts, and 0 for
    every other kernel."""
    launches = {k: f.launches for k, f in counters.items()}
    full = {k: want.get(k, 0) for k in counters}
    if launches != full:
        raise AssertionError(f"{phase}: launches {launches}, want {full}")
    print(f"  {phase}: launches as counted, {time.perf_counter() - T0:.1f} s into the run", flush=True)
    return launches


def step_launches(forward: dict, bwd_gathers: int, auction: int = 1) -> dict:
    """A training step's launches: the forward's, the scan's backward where
    the forward scans, the gather's backward (buckets and rows) for
    `bwd_gathers` deformable attentions, and `auction` assignments."""
    out = dict(forward, pair_buckets=bwd_gathers, bilinear_gather_bwd=bwd_gathers, auction_assignment=auction)
    if forward.get("ss2d_scan_fwd"):
        out.update(SCAN_BWD)
    return out


def detr_train_parity(label: str, base, batch, nc: int, dev, feats=None):
    """One DETR training forward and backward of `base` (CDN noise and
    DropPath off), card against CPU from one state dict, as
    `check_train_parity` holds TAM-TR's: as each device runs it, the share
    of valid (layer, gt) assignments that agree, reported; with the CPU's
    assignment and top-k order given to the card and to a CPU fp64 pass,
    the largest relative loss-item difference card vs CPU <= 2x the CPU's
    vs fp64, and |g_card - g_cpu| <= 2 |g_cpu - g_fp64| over the whole
    gradient, or 1e-5 and 1e-3 of |g_cpu| where that floor lies below them;
    every output and gradient finite. Given `feats` (the model's eval
    features of the batch, on the CPU), `base` is the head alone, run in
    train mode on them. Two card runs: one with its own assignment (one
    `auction_assignment`), one with the CPU's.

    The minimums: a head's step alone is well conditioned, and without VSS
    mixers (the Dual core) its fp32-vs-fp64 distance was 3.3e-6 of the
    gradient's norm, while card against CPU the heads' steps lay 9.4e-5 to
    1.6e-3 apart (measured on one H100), the cross-device rounding of cuBLAS
    against the CPU's GEMMs moving a few sampling points across a pixel
    edge. The whole model's step at a batch of 2-4 is the opposite,
    chaotic in fp32 (train-mode BatchNorm through 40 layers): one CPU
    thread against eight moved a 256 px head variant's gradient by 8-70%
    (measured on the CPU), and rtdetr.yaml's fp32 gradient at 640 px, batch 4 lay
    3.5x its norm from the fp64 one (measured on one H100)."""
    import copy

    from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss

    def grads_on(d, dtype=torch.float32, match=None, topk=None):
        model = copy.deepcopy(base).to(d, dtype).train()
        t = {"cls": torch.from_numpy(batch["cls"]).to(d), "mask": torch.from_numpy(batch["mask"]).to(d),
             "bboxes": torch.from_numpy(batch["bboxes"]).to(d, dtype)}
        record = []
        txt = torch.from_numpy(batch["txt_feats"]).to(d, dtype)
        with pinned_topk(record, topk):
            if feats is None:
                out = model(torch.from_numpy(batch["img"]).to(d, dtype) / 255.0, txt, t)
            else:
                out = model([f.to(d, dtype) for f in feats], txt.expand(len(batch["img"]), -1, -1), t)
        loss, items = rtdetr_detection_loss(out, t, DETRLossConfig(nc=nc), match=match)
        loss.backward()
        g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).detach().flatten().cpu().double()
                       for p in model.parameters()])
        vals = {"loss": float(loss.detach()), **{k: float(v.detach()) for k, v in items.items() if v.ndim == 0}}
        return vals, items["match"].cpu(), g, record

    t0 = time.perf_counter()
    cpu_items, cpu_match, cpu_g, cpu_topk = grads_on(torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    _, gpu_match, gpu_own_g, _ = grads_on(dev)
    fix_items, _, gpu_g, _ = grads_on(dev, match=cpu_match, topk=cpu_topk)
    exact_items, _, exact_g, _ = grads_on(torch.device("cpu"), torch.float64, match=cpu_match, topk=cpu_topk)
    rel = lambda a, b: max(abs(a[k] - v) / max(abs(v), 1e-12) for k, v in b.items())  # noqa: E731
    worst_fixed, item_noise = rel(fix_items, cpu_items), rel(cpu_items, exact_items)
    valid = torch.from_numpy(batch["mask"])[None].expand_as(cpu_match)
    agree = float((gpu_match == cpu_match)[valid].float().mean())
    norm = cpu_g.norm().item()
    d_card, d_noise = (gpu_g - cpu_g).norm().item(), (cpu_g - exact_g).norm().item()
    finite = bool(torch.isfinite(gpu_own_g).all() & torch.isfinite(gpu_g).all()) and all(
        math.isfinite(v) for v in fix_items.values())
    summary = dict(assignments_agree=agree, loss_cpu=cpu_items["loss"], loss_card=fix_items["loss"],
                   worst_item_rel=worst_fixed, item_noise_rel=item_noise, grad_rel=d_card / norm,
                   grad_noise_rel=d_noise / norm, topk_calls=len(cpu_topk), cpu_fwd_bwd_s=cpu_s)
    if not (finite and worst_fixed <= max(2 * item_noise, 1e-5) and d_card <= max(2 * d_noise, 1e-3 * norm)):
        raise AssertionError(f"{label} train parity failed: finite {finite}, {summary}")
    return summary


def profiled_step(tr, batch):
    """One `Trainer.step` under torch.profiler: (wall ms, the kernels' device ms or None)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step(batch)
        wall = (time.perf_counter() - t0) * 1e3
    busy = profiled_kernel_ms(prof)
    return wall, busy


def rtdetr(dev, data: str):
    """`rtdetr.yaml` (AIFI, RTDETRDecoder) on the card at full width, nc 10,
    seeded weights with the head spread (`spread_scores`), each part with
    its launch counters zeroed before and read after:
      - eval at 640 px, batch 1 and 4, of the serve frames (resized on the
        card): card = CPU as a set (`same_set`, 1e-3); fuse=True against the
        unfused forward (1e-4, as a set), half=True (bf16) beside fp32 (RMS
        over paired rows); B2 6 a forward, no scan;
      - serve: `TAMTR.predict(images, text)` at batch 1 and 4, ms;
      - one training step card vs CPU at RTDETR_PARITY px and batch,
        max_gt 300, TRAIN_VALID's first images (`detr_train_parity`: the
        whole model, whose fp32 gradient lies a few times its norm from the
        fp64 one at this batch (chaotic), and the head alone on the model's
        eval features, whose floor is ~1%), then `Trainer.step` timed at
        640 px, batch 4: two
        warm-up steps, RTDETR_STEPS timed, one profiled (device ms, busy
        share), peak memory; B2, pair_buckets and B4 6 a step,
        `auction_assignment` 1;
      - `Engine.train` for 1 epoch of the fit dataset (val after it), then
        `Engine.val` on its `best.pt`;
      - `TAMTR.predict` of the JPEG fixtures with and without TTA, and
        `TAMTR.track` of the track phase's frames (bytetrack)."""
    import copy
    from pathlib import Path

    from tamtr_torch import TAMTR
    from tamtr_torch.config import get_cfg
    from tamtr_torch.engine.model import Engine
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.train.trainer import TrainConfig
    from tamtr_torch.weights import init_parameters

    total, out = {}, {}

    def part(name, want):
        nonlocal total
        got = expect_launches(f"rtdetr {name}", counters, want)
        total = {k: total.get(k, 0) + v for k, v in got.items()}

    counters = zero_counters()
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, TRACK_HW + (3,), dtype=np.uint8) for _ in range(4)]
    text = rng.standard_normal((RTDETR_NC, 512)).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    det = TAMTR("rtdetr.yaml", nc=RTDETR_NC, seed=0)
    spread_scores(det.model, seed=1)
    det.set_classes([f"class{i}" for i in range(RTDETR_NC)], text)
    img, _ = det._to_batch(frames)
    txt = torch.from_numpy(text[None]).to(dev)
    cpu_model = copy.deepcopy(det.model).cpu()
    with torch.inference_mode():
        want_all = cpu_model(img.cpu(), txt.cpu())["pred"].numpy()  # one CPU forward: each image's rows its own
        for b in (1, TRAIN_BATCH):
            got = det.model(img[:b], txt)["pred"].cpu().numpy()
            want = want_all[:b]
            if not np.isfinite(got).all() or want[..., 4:].std() < 0.05:
                raise AssertionError(f"rtdetr eval b{b}: not finite or no score spread")
            out[f"eval_b{b}_worst"], out[f"eval_b{b}_unmatched"] = same_set(got, want)
        base = det.model(img, txt)["pred"]
        fused = det._engine._eval_model(det.model, get_cfg(overrides=dict(fuse=True)))
        out["fuse_worst"], out["fuse_unmatched"] = same_set(fused(img, txt)["pred"].cpu().numpy(),
                                                            base.cpu().numpy(), tol=1e-4)
        half = det._engine._eval_model(det.model, get_cfg(overrides=dict(half=True)))
        p = half(img, txt)["pred"]
        if not torch.isfinite(p).all() or p.dtype != torch.float32:
            raise AssertionError("rtdetr half: pred not finite fp32")
        out["half_rms"] = rms_set(p.cpu().numpy(), base.cpu().numpy())
    part("eval", launches_of((RTDETR_FORWARD, 5)))

    counters = zero_counters()
    times = {"b1": [], "b4": []}
    for key, images in (("b1", frames[0]), ("b4", frames)):
        det.predict(images, text)  # warm-up: conv algorithms
        for _ in range(5):
            t0 = time.perf_counter()
            res = det.predict(images, text)  # ends in host copies: the device has finished
            times[key].append((time.perf_counter() - t0) * 1e3)
            if not all(np.isfinite(r["boxes"]).all() for r in res):
                raise AssertionError("rtdetr serve: boxes not finite")
    out["serve_ms"] = times
    out["serve_ms_median"] = {k: float(np.median(v)) for k, v in times.items()}
    part("serve", launches_of((RTDETR_FORWARD, 12)))

    counters = zero_counters()
    batches = [synthetic_batch(100 + i, TRAIN_BATCH, TRAIN_IMGSZ, TRAIN_MAX_GT, TRAIN_VALID, nc=RTDETR_NC)
               for i in range(3 + RTDETR_STEPS)]
    base_model = TAMTRModel.from_cfg("rtdetr.yaml", nc=RTDETR_NC, max_gt=TRAIN_MAX_GT, vss_drop_path=0.0,
                                     label_noise_ratio=0.0, box_noise_scale=0.0)
    init_parameters(base_model, 0)
    spread_scores(base_model, seed=1)
    px, pb = RTDETR_PARITY
    pbatch = synthetic_batch(100, pb, px, TRAIN_MAX_GT, TRAIN_VALID[:pb], nc=RTDETR_NC)
    out["train_parity"] = detr_train_parity("rtdetr", base_model, pbatch, RTDETR_NC, dev)
    feats = []
    hook = base_model.model[-1].register_forward_pre_hook(lambda m, a: feats.append(a[0]))
    with torch.no_grad():
        base_model.eval()(torch.from_numpy(pbatch["img"]).float() / 255.0, torch.from_numpy(pbatch["txt_feats"]))
    hook.remove()
    out["head_train_parity"] = detr_train_parity("rtdetr head", base_model.model[-1], pbatch, RTDETR_NC, dev,
                                                 feats=[f.clone() for f in feats[0]])
    say(f"rtdetr train parity rtdetr.yaml {px}px b{pb} max_gt {TRAIN_MAX_GT}: whole model "
        f"{json.dumps(out['train_parity'])}; the head alone on the eval features "
        f"{json.dumps(out['head_train_parity'])}", flush=True)
    del base_model, feats
    part("train parity", launches_of((RTDETR_STEP, 4), ({"auction_assignment": -1}, 2)))

    counters = zero_counters()
    trainer_det = TAMTR("rtdetr.yaml", nc=RTDETR_NC, seed=0, max_gt=TRAIN_MAX_GT)
    spread_scores(trainer_det.model, seed=1)
    tr = trainer_det.trainer(TrainConfig(batch_size=TRAIN_BATCH, accumulate=1), seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in batches[1:3]:
        tr.step(b)
    steps, logs = [], []
    for b in batches[3:]:
        t0 = time.perf_counter()
        logs.append(tr.step(b))  # ends in host reads of the metrics
        steps.append((time.perf_counter() - t0) * 1e3)
    out["step_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    wall, busy = profiled_step(tr, batches[-1])
    out.update(step_ms=steps, step_ms_median=float(np.median(steps)), step_device_ms=busy,
               step_busy_share=busy and busy / wall, step_items=[{k: m[k] for k in ("loss", "giou", "class", "bbox")}
                                                        for m in logs])
    if not all(math.isfinite(m[k]) for m in logs for k in ("loss", "giou", "class", "bbox", "grad_norm")) \
            or not all(m["stepped"] == 1.0 for m in logs):
        raise AssertionError(f"rtdetr steps: {logs}")
    del tr, trainer_det
    torch.cuda.empty_cache()
    part("steps", launches_of((RTDETR_STEP, 3 + RTDETR_STEPS)))

    counters = zero_counters()
    root = Path("build/rtdetr")
    eng = Engine("rtdetr.yaml")
    fit_res = eng.train(data=data, epochs=1, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, max_gt=FIT_MAX_GT, workers=0,
                        warmup_epochs=4, val_interval=1, conf=0.05, plots=False, project=str(root), name="fit",
                        exist_ok=True)
    val = Engine("rtdetr.yaml").load(root / "fit" / "weights" / "best.pt").val(
        data=data, batch=TRAIN_BATCH, imgsz=TRAIN_IMGSZ, conf=0.05, plots=False)
    out["fit"] = dict(step_ms_median=float(np.median(eng.timing["step_ms"][1:])), mAP50=val["mAP50"], mAP50_95=val["mAP50-95"], val_images_per_sec=val["images_per_sec"])
    if not all(0.0 <= m[k] <= 1.0 for m in (fit_res, val) for k in ("mAP50", "mAP50-95")):
        raise AssertionError(f"rtdetr fit: {out['fit']}")
    val_forwards = math.ceil(FIT_VAL / TRAIN_BATCH)
    part("fit", launches_of((RTDETR_STEP, FIT_TRAIN // TRAIN_BATCH), (RTDETR_FORWARD, 2 * val_forwards)))

    counters = zero_counters()
    n = len(json.loads(open(f"{JPEG_FIXTURES}/expected.json").read()))
    for augment in (False, True):
        t0 = time.perf_counter()
        res = det.predict(JPEG_FIXTURES, augment=augment)
        out[f"predict_files_ms_per_image{'_tta' if augment else ''}"] = (time.perf_counter() - t0) * 1e3 / n
        if len(res) != n or not all(np.isfinite(r.boxes.xyxy).all() for r in res):
            raise AssertionError(f"rtdetr predict augment={augment}: {[len(r) for r in res]}")
    tracked = det.track("build/track", tracker="bytetrack")
    out["track"] = dict(frames=len(tracked), tracks_per_frame=[len(r.track_ids) for r in tracked],
                        ms_per_frame={k: float(np.median(v)) for k, v in det._engine.timing.items()})
    if len(tracked) != TRACK_FRAMES or not any(len(r.track_ids) for r in tracked):
        raise AssertionError(f"rtdetr track: {out['track']}")
    part("predict and track", launches_of((RTDETR_FORWARD, 4 * n + TRACK_FRAMES)))
    say(f"rtdetr rtdetr.yaml {TRAIN_IMGSZ}px nc {RTDETR_NC}: {json.dumps(out)}; launches {total}", flush=True)
    return out, total


def heads(dev):
    """The variant heads on `tamtr.yaml`'s wiring, each at full width with
    its head row swapped (`HEAD_VARIANTS`; Dual on the levels [32, 36, 32,
    36]), nc 10, seeded weights with the head spread, at HEADS_IMGSZ px, batch 2:
    eval card = CPU as a set (1e-3; each of Dual's two predictions); one
    training step of the whole model on the card (its own assignment),
    finite; and the head's training step card vs CPU given the CPU's
    assignment and top-k order (`detr_train_parity` of the head alone on
    the model's eval features: the whole step's fp32 rounding is chaotic
    at this batch and size, see there). The launch counters are zeroed
    before each head and read after: the forward's per `HEAD_VARIANTS`,
    and per step the scan's and the gather's backward."""
    import copy

    from tamtr_torch.losses.detr_loss import DETRLossConfig, rtdetr_detection_loss
    from tamtr_torch.nn.graph import TAMTRModel, load_model_cfg
    from tamtr_torch.weights import init_parameters

    out, total = {}, {}
    for head, (froms, extra, fwd, bwd_gathers) in HEAD_VARIANTS.items():
        counters = zero_counters()
        cfg = load_model_cfg("tamtr.yaml")
        row = cfg["head"][-1]
        cfg["head"][-1] = [froms, 1, head, row[3][:6] + extra]
        model = TAMTRModel(cfg, nc=10, max_gt=HEADS_MAX_GT, vss_drop_path=0.0, label_noise_ratio=0.0,
                           box_noise_scale=0.0)
        init_parameters(model, 0)
        spread_scores(model, seed=1)
        batch = synthetic_batch(200, HEADS_BATCH, HEADS_IMGSZ, HEADS_MAX_GT, (HEADS_MAX_GT - 4, 9),
                                hd=model.text_width)
        img = torch.from_numpy(batch["img"]).float() / 255.0
        txt = torch.from_numpy(batch["txt_feats"])
        tg = {"cls": torch.from_numpy(batch["cls"]).to(dev), "mask": torch.from_numpy(batch["mask"]).to(dev),
              "bboxes": torch.from_numpy(batch["bboxes"]).to(dev)}
        card = copy.deepcopy(model).to(dev).eval()
        feats = []
        hook = model.model[-1].register_forward_pre_hook(lambda m, a: feats.append(a[0]))
        with torch.inference_mode():
            got, want = card(img.to(dev), txt.to(dev))["pred"], model.eval()(img, txt)["pred"]
        hook.remove()
        pairs = list(zip(got, want)) if isinstance(got, list) else [(got, want)]
        res = {"eval": [same_set(g.cpu().numpy(), w.numpy()) for g, w in pairs]}
        if not all(torch.isfinite(g).all() for g, _ in pairs):
            raise AssertionError(f"heads {head}: eval not finite")
        card.train()
        loss = rtdetr_detection_loss(card(img.to(dev), txt.to(dev), tg), tg, DETRLossConfig(nc=10))[0]
        loss.backward()
        finite = math.isfinite(float(loss)) and all(torch.isfinite(p.grad).all() for p in card.parameters()
                                                    if p.grad is not None)
        res["step_loss"] = float(loss)
        if not finite:
            raise AssertionError(f"heads {head}: the step's loss or gradient is not finite")
        del card
        with torch.no_grad():
            feats = [f.clone() for f in feats[0]]
        res["head_train"] = detr_train_parity(head, model.model[-1], batch, 10, dev, feats=feats)
        fwd_bwd = step_launches(fwd, bwd_gathers)
        got_l = expect_launches(f"heads {head}", counters, launches_of((fwd, 1), (fwd_bwd, 3),
                                                                       ({"auction_assignment": -1}, 1)))
        total = {k: total.get(k, 0) + v for k, v in got_l.items()}
        res["launches"] = {k: v for k, v in got_l.items() if v}
        out[head] = res
        say(f"heads {head} tamtr.yaml wiring {HEADS_IMGSZ}px b{HEADS_BATCH}: {json.dumps(res)}", flush=True)
    return out, total


# ---------------------------------------------------------------------------
# Export and load back (`engine/exporter.py`, `nn/autobackend.py`), benchmark,
# profile, tune and ensemble
# ---------------------------------------------------------------------------

EXPORT_FORMATS = ("torch", "npz", "torch_export")
EXPORT_ROUNDS, EXPORT_REQUESTS = 2, 5  # b1 requests of the live model and of the artifact, timed in turns
# the tune trials at 320 px: the loop under test, not the step (a 640 px isolated trial took 34 s, mostly its
# process's start and first steps)
TUNE_ARGS = dict(iterations=2, epochs=1, batch=TRAIN_BATCH, imgsz=320, max_gt=FIT_MAX_GT, workers=0, warmup_epochs=1)
ENSEMBLE_FIXTURES = ("s420_q75.jpg", "gray_q85.jpg", "exif6_q90.jpg", "visdrone_1360x765_q85.jpg")
HALF_SHARE_MAX = 0.55  # a half artifact's size over its fp32 one's, at most


def export_inputs(model, seed: int):
    """Two b1 inputs at 640 px unlike the zeros the programs are traced on:
    seeded images, and unit text rows (the model's classes' first)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        img = rng.random((1, TRAIN_IMGSZ, TRAIN_IMGSZ, 3), dtype=np.float32)
        txt = rng.standard_normal((1, model.nc, model.text_width)).astype(np.float32)
        out.append((img, txt / np.linalg.norm(txt, axis=-1, keepdims=True)))
    return out


@torch.no_grad()
def rounded(model, dtype):
    """A copy of `model` with its float weights rounded to `dtype` and back:
    what the "torch" (bf16) and "npz" (float16) half artifacts load as."""
    import copy

    twin = copy.deepcopy(model)
    for t in twin.state_dict().values():
        if t.is_floating_point():
            t.copy_(t.to(dtype).float())
    return twin.eval()


def pt2_in_fresh_process(path, inputs, dev):
    """A `.pt2` loaded by `AutoBackend` in a new Python process, which shares
    nothing with this one's model: the launch counters zeroed just before
    its first forward and read just after, then its pred on both inputs."""
    import tempfile
    from types import SimpleNamespace

    with tempfile.TemporaryDirectory() as tmp:
        np.savez(f"{tmp}/in.npz", **{f"{k}{i}": a for i, inp in enumerate(inputs) for k, a in zip("it", inp)})
        code = ("import json, sys\nimport numpy as np, torch\n"
                "torch.backends.cuda.matmul.allow_tf32 = False\ntorch.backends.cudnn.allow_tf32 = False\n"
                "from chip_smoke import zero_counters\nfrom tamtr_torch.nn.autobackend import AutoBackend\n"
                "ab = AutoBackend(sys.argv[1], device=sys.argv[4])\ninp = np.load(sys.argv[2])\n"
                "counters = zero_counters()\npred0 = ab(inp['i0'], inp['t0'])\n"
                "launches = {k: f.launches for k, f in counters.items()}\n"
                "np.savez(sys.argv[3], pred0=pred0, pred1=ab(inp['i1'], inp['t1']))\n"
                "print(json.dumps(launches))\n")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", code, str(path), f"{tmp}/in.npz", f"{tmp}/out.npz", dev.type],
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"export: the fresh process exit {res.returncode}\n{res.stderr[-4000:]}")
        with np.load(f"{tmp}/out.npz") as out:
            preds = [out["pred0"], out["pred1"]]
    launches = json.loads(res.stdout.strip().splitlines()[-1])
    counted = expect_launches("export: the tamtr.yaml .pt2, one forward in a fresh process",
                              {k: SimpleNamespace(launches=v) for k, v in launches.items()}, FORWARD_LAUNCHES)
    return preds, counted, wall


def export_model_checks(name: str, model, dev, root, meta: dict, per_fwd: dict, fp32_paths=None):
    """`model` exported in the three port formats, fp32 and half=True, on
    the card (fp32 artifacts given in `fp32_paths` are not made again), and
    each loaded back through `AutoBackend`: on both inputs the fp32
    artifacts within 1e-5 of the live eval forward, the half ones within
    1e-5 of the live forward of the same weights as they load (the weights
    rounded to bf16, or float16 for npz; for the program JAX's half
    computation, `program_of(model, half=True)`, whose distance from the
    plain rounded forward is reported). Every launch counter is zeroed
    before each load and forward and read after: B1 and B2 as the live
    forward's (`per_fwd` a forward). Returns each artifact's export s,
    size, max error and bitwise equality, the loaded backends, the inputs
    and the live forwards' preds."""
    from tamtr_torch.engine.exporter import export_model, program_of
    from tamtr_torch.nn.autobackend import AutoBackend

    inputs = export_inputs(model, seed=len(name))
    live = {}
    with torch.inference_mode():
        for key, mod in (("fp32", program_of(model)), ("torch", program_of(rounded(model, torch.bfloat16))),
                         ("npz", program_of(rounded(model, torch.float16))),
                         ("torch_export", program_of(model, half=True))):
            counters = zero_counters()
            live[key] = [mod(torch.from_numpy(i).to(dev), torch.from_numpy(t).to(dev)).cpu().numpy() for i, t in inputs]
            expect_launches(f"export {name}: live forward ({key})", counters, launches_of((per_fwd, 2)))
    rows, backends = {}, {}
    for fmt in EXPORT_FORMATS:
        for half in (False, True):
            t0 = time.perf_counter()
            path = (fp32_paths or {}).get(fmt) if not half else None
            path = path or export_model(model, TRAIN_IMGSZ, model.nc, root / f"{fmt}{int(half)}", fmt, half=half,
                                        meta=meta)
            export_s = time.perf_counter() - t0
            counters = zero_counters()
            ab = AutoBackend(path, model_cfg=meta["model_cfg"], nc=model.nc, device=dev)
            got = [ab(i, t) for i, t in inputs]  # numpy out: the forwards have ended
            expect_launches(f"export {name}: {fmt} half={half} loaded, two forwards", counters,
                            launches_of((per_fwd, 2)))
            want = live["fp32" if not half else fmt]
            err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            row = dict(export_s=round(export_s, 2), bytes=path.stat().st_size, max_abs_err=err,
                       bitwise=all(np.array_equal(g, w) for g, w in zip(got, want)))
            if half and fmt == "torch_export":  # JAX's half semantics against the plain rounded-weights forward
                row["from_rounded_fp32"] = max(float(np.abs(g - w).max()) for g, w in zip(got, live["torch"]))
            if err > 1e-5 or not all(np.isfinite(g).all() for g in got):
                raise AssertionError(f"export {name}: {fmt} half={half} off the live forward by {err}")
            rows[f"{fmt}{'_half' if half else ''}"] = row
            backends[fmt, half] = ab
    for fmt in EXPORT_FORMATS:
        share = rows[f"{fmt}_half"]["bytes"] / rows[fmt]["bytes"]
        rows[f"{fmt}_half"]["size_share"] = round(share, 4)
        if share > HALF_SHARE_MAX:
            raise AssertionError(f"export {name}: the {fmt} half artifact is {share:.3f} of its fp32 one")
    say(f"export {name}: {json.dumps(rows)}")
    return rows, backends, inputs, live


def export_phase(dev, data: str):
    """Export and load back, the benchmark and profile, tune and ensemble:
      - `benchmark()` of the serve phase's `tamtr.yaml` model (`serve_model`,
        640 px, b1) in the three port formats: every row `parity_ok`; its
        artifacts are the fp32 ones of the next step;
      - `export_model_checks` on that model and on `yolo-gelan.yaml` at full
        width (nc 10, heads spread, every BatchNorm calibrated on 4 frames);
      - the tamtr.yaml `.pt2` loaded in a fresh process
        (`pt2_in_fresh_process`): its first forward launches B1 and B2 as
        the live forward, through `expect_launches`, and its pred on both
        inputs is the live forward's within 1e-5;
      - b1 request ms (`AutoBackend.__call__`, numpy in and out) of the live
        model and of the loaded `.pt2`, in turns;
      - `profile_model` at 320 and 640 px;
      - `Engine.tune(iterations=2, epochs=1)` of tamtr.yaml on the fit
        dataset at 320 px, in this process and with isolate=True: two
        finite rows in each `tune_results.csv`, each trial trained to its
        end (its results.csv);
      - `ensemble_predict` of two seeded models over 4 JPEG fixtures: every
        merged row is a row of one model's own results.
    Launches are counted per part; the part that runs no forward of
    tamtr.yaml (yolo) launches none. Returns the summary and the launches of
    the fresh process's forward."""
    import csv
    import shutil
    from pathlib import Path

    from tamtr_torch import TAMTR
    from tamtr_torch.engine.ensemble import ensemble_predict
    from tamtr_torch.engine.model import Engine
    from tamtr_torch.nn.autobackend import AutoBackend
    from tamtr_torch.utils.benchmarks import benchmark, profile_model

    root = Path("build/export")
    shutil.rmtree(root, ignore_errors=True)
    det = serve_model()
    eng = det._lazy_engine()
    model = det.model.eval()
    meta = {"nc": model.nc, "names": eng.names, "model_cfg": str(eng.model_cfg), "imgsz": TRAIN_IMGSZ,
            "max_gt": 128}
    t0 = time.perf_counter()
    bench = benchmark(eng, imgsz=TRAIN_IMGSZ, formats=list(EXPORT_FORMATS), out_dir=str(root / "bench"), n_iter=2)
    bench_s = time.perf_counter() - t0
    say(f"export: benchmark() of tamtr.yaml at 640 px b1, {bench_s:.1f} s: {json.dumps(bench)}")
    if not all(r.get("parity_ok") for r in bench):
        raise AssertionError(f"export: benchmark rows without parity: {bench}")
    fp32_paths = {r["format"]: Path(r["path"]) for r in bench if "path" in r}
    tam_rows, tam_ab, inputs, live = export_model_checks("tamtr.yaml", model, dev, root / "tamtr", meta,
                                                         FORWARD_LAUNCHES, fp32_paths)

    live_ab = AutoBackend(model, device=dev)
    img, txt = inputs[0]
    ms = in_turns({"live": lambda: live_ab(img, txt), "pt2": lambda: tam_ab["torch_export", False](img, txt),
                   "pt2_half": lambda: tam_ab["torch_export", True](img, txt)}, EXPORT_ROUNDS, EXPORT_REQUESTS)
    say(f"export: b1 request ms (AutoBackend, numpy in and out, in turns): {json.dumps(ms)}")
    del tam_ab, live_ab

    def tune_run(isolate: bool) -> dict:
        project = root / f"tune{int(isolate)}"
        t0 = time.perf_counter()
        best = Engine("tamtr.yaml", device=dev).tune(isolate=isolate, data=data, project=str(project), **TUNE_ARGS)
        with open(project / "tune" / "tune_results.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        fits = [float(r["fitness"]) for r in rows]
        if len(rows) != 2 or not np.isfinite(fits).all() or len(list(project.glob("train*/results.csv"))) != 2:
            raise AssertionError(f"export: tune isolate={isolate} wrote {rows}")
        return dict(s=round(time.perf_counter() - t0, 1), fitness=fits, best_lr0=best["lr0"])

    # the work of other processes (the .pt2 in a fresh process, the isolated tune trials) runs beside the
    # yolo checks, which time nothing that counts and launch no kernel of this process
    with ThreadPoolExecutor(2) as pool:
        fresh = pool.submit(pt2_in_fresh_process, fp32_paths["torch_export"], inputs, dev)
        isolated = pool.submit(tune_run, True)
        yolo_det = TAMTR("yolo-gelan.yaml", nc=YOLO_NC, seed=0, device=dev)
        spread_detect(yolo_det.model)
        rng = np.random.default_rng(4)
        frames = [rng.integers(0, 256, (765, 1360, 3), dtype=np.uint8) for _ in range(4)]
        yimg, _ = yolo_det._to_batch(frames)
        calibrate_bn(yolo_det.model, yimg)  # no head rescale: its weights stay in float16's range (npz half)
        ymeta = {"nc": YOLO_NC, "names": [f"class{i}" for i in range(YOLO_NC)], "model_cfg": "yolo-gelan.yaml",
                 "imgsz": TRAIN_IMGSZ, "max_gt": 128}
        yolo_rows, _, _, _ = export_model_checks("yolo-gelan.yaml", yolo_det.model.eval(), dev, root / "yolo", ymeta,
                                                 {})
        del yolo_det
        preds, fresh_launches, fresh_s = fresh.result()
        tune = {"isolate=True": isolated.result()}
    fresh_err = max(float(np.abs(p - w).max()) for p, w in zip(preds, live["fp32"]))
    say(f"export: the .pt2 in a fresh process: {fresh_s:.1f} s wall, max error {fresh_err}, launches "
        f"{fresh_launches}")
    if fresh_err > 1e-5:
        raise AssertionError(f"export: the .pt2 in a fresh process off the live forward by {fresh_err}")

    counters = zero_counters()
    profile = profile_model(eng, imgsz_list=[320, TRAIN_IMGSZ])
    # a size: flops_of's forward, the warm-up, 8 timed
    expect_launches("export: profile_model", counters, launches_of((FORWARD_LAUNCHES, 2 * (2 + 8))))
    say(f"export: profile_model: {json.dumps(profile)}")
    tune["isolate=False"] = tune_run(False)
    say(f"export: Engine.tune(iterations=2, epochs=1) on {data}: {json.dumps(tune)}")

    other = serve_model(seed=5)
    sources = [f"{JPEG_FIXTURES}/{f}" for f in ENSEMBLE_FIXTURES]
    counters = zero_counters()
    merged = ensemble_predict([det, other], sources, iou=0.5, conf=0.05)
    singles = [m.predict(sources, conf=0.05) for m in (det, other)]
    expect_launches("export: ensemble_predict", counters, launches_of((FORWARD_LAUNCHES, 4 * len(sources))))
    rows_of = lambda r: np.concatenate([r.boxes.xyxy, r.boxes.conf[:, None], r.boxes.cls[:, None]], 1)  # noqa: E731
    n_rows = 0
    for i, r in enumerate(merged):
        own = np.concatenate([rows_of(s[i]) for s in singles])
        if not all((own == row).all(-1).any() for row in rows_of(r)):
            raise AssertionError(f"export: ensemble row of {r.path} is no model's row")
        n_rows += len(r)
    say(f"export: ensemble_predict of 2 models over {len(sources)} fixtures: {n_rows} merged rows, of "
        f"{sum(len(r) for s in singles for r in s)}, each a model's own")
    return dict(benchmark=bench, tamtr=tam_rows, yolo=yolo_rows, b1_request_ms=ms, fresh_process_s=round(fresh_s, 1),
                fresh_process_max_abs_err=fresh_err, profile=profile, tune=tune, ensemble_rows=n_rows), fresh_launches



VISDRONE_NAMES = ["pedestrian", "people", "bicycle", "car", "van", "truck", "tricycle", "awning-tricycle", "bus",
                  "motor"]


def clip_id_rows(rng, rows: int, lengths, eos: int = 49407, bos: int = 49406):
    """(rows, 77) CLIP ids: start token, seeded ids below it, the end token
    at position length - 1 and as padding after it; and the padding mask."""
    ids = np.full((rows, 77), eos, np.int64)
    ids[:, 0] = bos
    for r, n in enumerate(lengths):
        ids[r, 1:n - 1] = rng.integers(0, bos, n - 2)
    mask = np.arange(77)[None] < np.asarray(lengths)[:, None]
    return torch.from_numpy(ids), torch.from_numpy(mask.astype(np.int64))


@torch.no_grad()
def clip_text_phase(dev):
    """The CLIP text source on the card (phase 9e of the module docstring)."""
    import copy
    import tempfile

    from tamtr_torch.data.clip_tokenizer import CLIPTokenizer, train_byte_bpe, write_vocab
    from tamtr_torch.data.text import class_text_embeddings, encode_texts
    from tamtr_torch.nn.clip_text import CLIPTextConfig, CLIPTextTower, transformers_state
    from tamtr_torch.weight_files import write_safetensors
    from tools import encode_texts_torch

    t0 = time.perf_counter()
    cpu = CLIPTextTower(CLIPTextConfig()).reset_parameters(seed=23).eval()
    card = copy.deepcopy(cpu).to(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(23)
    lengths = [2, 77, *rng.integers(3, 77, 14)]
    ids, mask = clip_id_rows(rng, 16, lengths)
    err, unit_err = {}, {}
    unit = torch.nn.functional.normalize
    for branch, eos in (("first_end_token", 49407), ("argmax", 2)):  # transformers' two pooling branches
        cpu.config.eos_token_id = card.config.eos_token_id = eos
        want, got = cpu(ids, mask), card(ids.to(dev), mask.to(dev)).cpu()
        err[branch] = float((got - want).abs().max())
        unit_err[branch] = float((unit(got, dim=-1) - unit(want, dim=-1)).abs().max())
    cpu.config.eos_token_id = card.config.eos_token_id = 49407
    if max(err.values()) > 1e-4 or max(unit_err.values()) > 1e-4 or not torch.isfinite(want).all():
        raise AssertionError(f"clip_text: card vs CPU {err}, unit rows {unit_err} (bound 1e-4)")
    long_ids, long_mask = clip_id_rows(rng, 80, [77] * 80)
    ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = VISDRONE_NAMES + ["a photo of a " + n for n in VISDRONE_NAMES] + ["it's 2 cars, they're vans"]
        write_vocab(tmp, *train_byte_bpe(corpus, 300, special_ids=(49406, 49407)))
        with open(f"{tmp}/config.json", "w") as f:
            json.dump(cpu.config.to_dict(), f)
        write_safetensors(transformers_state(cpu), f"{tmp}/model.safetensors", metadata={"format": "pt"})
        names = CLIPTokenizer.from_pretrained(tmp)(VISDRONE_NAMES + [""], padding=True)
        for label, (x, mk) in (("names_11", (names["input_ids"], names["attention_mask"])),
                               ("texts_80x77", (long_ids, long_mask))):
            xd, md = x.to(dev), mk.to(dev)
            ms[label] = cuda_ms(lambda: card(xd, md), iters=20, warmup=2)
            t1 = time.perf_counter()
            cpu(x, mk)
            ms[f"{label}_cpu"] = (time.perf_counter() - t1) * 1e3
        data = f"{tmp}/visdrone_names.yaml"
        with open(data, "w") as f:
            f.write("train: images\nval: images\nnames:\n" + "".join(f"  {i}: {n}\n"
                                                                     for i, n in enumerate(VISDRONE_NAMES)))
        table = f"{tmp}/visdrone_clip.npz"
        t1 = time.perf_counter()
        rc = encode_texts_torch.main(["--data", data, "--model", tmp, "--device", str(dev), "--out", table])
        table_s = time.perf_counter() - t1
        if rc != 0:
            raise AssertionError(f"clip_text: tools/encode_texts_torch.py exited {rc}")
        z = np.load(table, allow_pickle=True)
        texts, emb = [str(t) for t in z["texts"]], z["embeddings"]
        cpu_rows = encode_texts(texts, clip_model=tmp, device="cpu")
        table_err = float(np.abs(emb - cpu_rows).max())
        if texts != VISDRONE_NAMES + [""] or emb.shape != (11, 512) or table_err > 1e-4 \
                or not np.allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5):
            raise AssertionError(f"clip_text: table texts {texts}, shape {emb.shape}, "
                                 f"card vs CPU {table_err}")
        txt = class_text_embeddings(VISDRONE_NAMES, npz_path=table, dim=512)  # as cfg.text_embeddings is read
        if np.abs(txt - emb[:10]).max() > 1e-6:  # the reader normalises the rows again
            raise AssertionError("clip_text: the engine's read of the table is not its rows")
    det = serve_model()
    det.set_classes(VISDRONE_NAMES, txt)
    paths = [f"{JPEG_FIXTURES}/{f}" for f in PARITY_FIXTURES]
    det.predict(paths)  # warm-up
    counters = zero_counters()
    t1 = time.perf_counter()
    res = det.predict(paths)
    predict_ms = (time.perf_counter() - t1) * 1e3 / len(paths)
    launches = check_counts("clip_text predict", counters, len(paths))
    if len(res) != len(paths) or not all(np.isfinite(r.boxes.xyxy).all() for r in res):
        raise AssertionError("clip_text: predict gave no finite boxes")
    summary = dict(max_abs_err=err, unit_max_abs_err=unit_err, table_max_abs_err=table_err,
                   ms_of="the tower's forward on the card, CUDA events over 20 calls, warm; _cpu one CPU call",
                   ms=ms, table_s=table_s, init_s=init_s, predict_ms_per_image=predict_ms,
                   detections=[len(r) for r in res], launches={k: v for k, v in launches.items() if v})
    say(f"clip_text ViT-B/32 text tower 12x512 card vs CPU: {json.dumps(summary)}")
    return summary


@torch.no_grad()
def reference_ckpt_phase(dev):
    """The reference's own checkpoint on the card (phase 9f of the module
    docstring)."""
    import io
    import tempfile

    from tamtr_torch import TAMTR, RTDETRWorld
    from tamtr_torch.cli import main as cli_main
    from tamtr_torch.nn.autobackend import AutoBackend
    from tamtr_torch.nn.graph import TAMTRModel
    from tamtr_torch.weights import init_parameters
    from tools import port_torch_weights_torch
    from tools.make_reference_ckpt_torch import write_reference_checkpoint

    model = TAMTRModel.from_cfg("tamtr.yaml", nc=10)
    init_parameters(model, 0)
    spread_scores(model, seed=1)
    paths = [f"{JPEG_FIXTURES}/{f}" for f in PARITY_FIXTURES]

    def rows(res):
        return [np.concatenate([r.boxes.xyxy, r.boxes.conf[:, None], r.boxes.cls[:, None]], 1) for r in res]

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = write_reference_checkpoint(f"{tmp}/last.pt", model, VISDRONE_NAMES)
        write_s = time.perf_counter() - t0
        del model
        t0 = time.perf_counter()
        det = TAMTR("tamtr.yaml").load(ref)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        keys = sum(not k.endswith("num_batches_tracked") for k in det.model.state_dict())  # the file's keys
        eng = det._engine
        if det.nc != 10 or eng.names != VISDRONE_NAMES or next(det.model.parameters()).device.type != "cuda":
            raise AssertionError(f"reference_ckpt: nc {det.nc}, names {eng.names}, device "
                                 f"{next(det.model.parameters()).device}")
        det.predict(paths)  # warm-up
        counters = zero_counters()
        t0 = time.perf_counter()
        res = det.predict(paths)
        predict_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
        launches = check_counts("reference_ckpt predict", counters, len(paths))
        if len(res) != len(paths) or not all(len(r) and np.isfinite(r.boxes.xyxy).all() for r in res):
            raise AssertionError(f"reference_ckpt: detections {[len(r) for r in res]}, or boxes not finite")
        port = port_torch_weights_torch.port(ref, f"{tmp}/port.pt")
        same = TAMTR("tamtr.yaml").load(port)
        port_err = 0.0
        for a, b in zip(rows(res), rows(same.predict(paths)), strict=True):
            if a.shape != b.shape:
                raise AssertionError(f"reference_ckpt: {len(a)} detections, {len(b)} from the port's layout")
            port_err = max(port_err, float(np.abs(a - b).max(initial=0.0)))
        cpu_res = RTDETRWorld(str(ref), device="cpu").predict(paths)
        cpu_worst, cpu_unpaired = 0.0, 0
        for g, c in zip(res, cpu_res, strict=True):
            w, u = same_results(g, c)
            cpu_worst, cpu_unpaired = max(cpu_worst, w), cpu_unpaired + u
        ab = AutoBackend(str(port))
        img = torch.rand(1, 640, 640, 3, generator=torch.Generator().manual_seed(5))
        txt = eng.txt_feats[None]
        ab_err = float(np.abs(ab(img.numpy(), txt) -
                              det.model(img.to(dev), torch.from_numpy(txt).to(dev))["pred"].cpu().numpy()).max())
        if port_err > 1e-6 or ab_err > 1e-6 or cpu_worst > 1e-3 or cpu_unpaired > 2:
            raise AssertionError(f"reference_ckpt: port layout {port_err}, AutoBackend {ab_err} (bound 1e-6); "
                                 f"card vs CPU {cpu_worst} (bound 1e-3), {cpu_unpaired} unpaired")
        counters = zero_counters()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main(["predict", f"model={ref}", f"source={paths[0]}"])
        cli_launches = check_counts("reference_ckpt cli", counters, 1)
        if not out.getvalue().strip().endswith(f"{PARITY_FIXTURES[0]}: {len(res[0])} detections"):
            raise AssertionError(f"reference_ckpt: the CLI printed {out.getvalue()!r}")
        nbytes = ref.stat().st_size
    summary = dict(file_bytes=nbytes, keys_read=keys, write_s=write_s, load_s=load_s,
                   load_of="TAMTR('tamtr.yaml').load(<file>): read on the CPU, build, load, move to the card",
                   predict_ms_per_image=predict_ms, detections=[len(r) for r in res],
                   port_layout_max_abs_err=port_err, autobackend_max_abs_err=ab_err, cpu_results_worst=cpu_worst,
                   cpu_results_unpaired=cpu_unpaired, launches={k: v for k, v in launches.items() if v},
                   cli_launches={k: v for k, v in cli_launches.items() if v})
    say(f"reference_ckpt tamtr.yaml as ultralytics 8.0.201's last.pt: {json.dumps(summary)}")
    return summary, launches


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--parallel"]:  # the parallel phase's own process
        CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps(parallel_phase(sys.argv[2])))
        return 0
    from tamtr_torch.kernels import _build

    dev = torch.device("cuda")
    # full fp32 throughout, as the reference ships: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    CARD = smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    log = timed("build", _build.build_all)  # a fresh checkout has no build/: this compiles every source
    print(f"build: {log['seconds']:.1f} s", flush=True)
    for line in log["ptxas"]:
        print(f"  {line}")

    scan_rows, scan_err = timed("ss2d_scan", check_ss2d_scan, dev)
    gather = timed("bilinear_gather", check_bilinear_gather, dev)
    bwd_rows, bwd_err = timed("ss2d_scan_bwd", check_ss2d_scan_bwd, dev)
    gather_bwd, gather_train = timed("bilinear_gather_bwd", check_bilinear_gather_bwd, dev)
    auction = timed("auction", check_auction, dev)
    auction_any = timed("auction_any_size", check_auction_any_size, dev)
    # RT-DETR's shapes: head width c = 32 (hd 256 over 8 heads), Q = 300 at
    # eval and 900 in training; the assignment of 7 matched layers x 4
    # images of 300 queries
    gather_c32 = timed("bilinear_gather_c32", check_bilinear_gather, dev, Q=300, c=32)
    gather_bwd_c32, gather_c32_train = timed("bilinear_gather_bwd_c32", check_bilinear_gather_bwd, dev, Q=900, c=32)
    auction_rtdetr = timed("auction_28_300_300", check_auction, dev, layers=7, nq=300)
    scan1d_rows, scan1d_err = timed("selective_scan", check_selective_scan, dev)
    value, gather_args, pairs, Lv = decoder_scatter_inputs(17, dev)
    _, gather_clustered, pairs_clustered, _ = decoder_scatter_inputs(18, dev, clustered=True)
    scatter = timed("scatter_acc", check_scatter_acc, dev, value,
                    dict(uniform=gather_args, clustered=gather_clustered), Lv)
    scatter_pairs = timed("scatter_acc_pairs", check_scatter_acc_pairs, dev,
                          dict(uniform=pairs, clustered=pairs_clustered), Lv)
    del value, gather_args, pairs, gather_clustered, pairs_clustered
    ops_launches = timed("drive_ops", drive_ops, dev)
    sp_rows, sp_rows1d, sp_err, sp_launches = timed("sp_blocks", sp_blocks, dev)
    pieces = timed("ss2d_pieces", check_ss2d_pieces, dev)
    jpeg_ms_per_mp, jpeg_encode_ms_per_mp, formats_ms_per_mp = timed("jpeg", check_jpeg)
    timed("parity", check_parity, dev)
    timed("train_parity", check_train_parity, dev)
    launches = timed("serve", serve, dev)
    predict_summary, det, predict_launches = timed("predict_files", predict_files, dev)
    http_summary, http_launches = timed("serve_http", serve_http, det)
    track_summary, track_launches, track_pan_launches = timed("track", track, det)
    video_summary, video_launches, video_predict_launches = timed("video", video_phase, det)
    del det
    fuse_summary, fuse_launches = timed("fuse", fuse, dev)
    autobatch_summary, autobatch_launches = timed("autobatch", autobatch_phase, dev)
    train_launches, _, _, b4_calls = timed("train", train, dev)
    gather_bwd.update(timed("gather_bwd_step", check_gather_bwd_step, b4_calls))
    gather_step = timed("gather_fwd_step", check_gather_fwd_step, b4_calls)
    del b4_calls
    fit_launches, fit_summary = timed("fit", fit, dev)
    bf16 = timed("bf16_phase", bf16_phase, dev, "build/fit/data.json")
    variants_summary, variants_launches = timed("loss_variants", loss_variants, dev)
    yolo_summary, yolo_launches = timed("yolo", yolo, dev, "build/fit/data.json")
    seg_pose_summary, seg_pose_launches = timed("seg_pose", seg_pose, dev, "build/fit/data.json")
    classify_summary, classify_launches = timed("classify", classify_phase, dev)
    sam_summary, sam_launches = timed("sam", sam_phase, dev)
    rtdetr_summary, rtdetr_launches = timed("rtdetr", rtdetr, dev, "build/fit/data.json")
    # the phases that run in processes of their own (parallel, cli) go beside one of this process's that
    # times nothing (heads, info): their launches are counted in their own processes
    with ThreadPoolExecutor(1) as pool:
        par = pool.submit(timed, "parallel", parallel, "build/fit/data.json")
        heads_summary, heads_launches = timed("heads", heads, dev)
        parallel_summary = par.result()
        cli_run = pool.submit(timed, "cli", cli, "build/fit/runs/fit/weights/best.pt")
        info_launches = timed("info", info, "build/fit/runs/fit/weights/best.pt")
        cli_launches = cli_run.result()
    export_summary, export_launches = timed("export", export_phase, dev, "build/fit/data.json")
    clip_summary = timed("clip_text", clip_text_phase, dev)
    reference_summary, reference_launches = timed("reference_ckpt", reference_ckpt_phase, dev)

    def slice3(name, reached_through):
        return dict(launches=ops_launches[name], launches_serve=launches[name],
                    launches_train=train_launches[name], launches_fit=fit_launches[name],
                    reached_through=reached_through)

    fwd1, fwd4 = ([r for r in scan_rows if r["B"] == b] for b in (1, TRAIN_BATCH))

    def bf16_of(rows, launch_key, of):
        return dict(launches=bf16["launches"][launch_key], ms=sum(r["ms"] for r in rows),
                    ms_fp32=sum(r["ms_fp32"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
                    bound_ms=sum(r["bound_ms"] for r in rows), bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
                    max_abs_err=max(r["max_abs_err"] for r in rows), library_ms=None, of=of, per_level=rows)

    levels1d = scan1d_rows[:len(LEVELS_640)]
    kernels = [
        dict(name="ss2d_scan_fwd", route="cuda", source="tamtr_torch/csrc/ss2d_scan_fwd.cu",
             replaces="tamtr_tpu/kernels/selective_scan.py:448", launches=launches["ss2d_scan_fwd"],
             **{f"launches_{p}": launches[f"ss2d_scan_fwd_{p}"] for p in ("summaries", "combine", "output")},
             launches_train=train_launches["ss2d_scan_fwd"], launches_fit=fit_launches["ss2d_scan_fwd"],
             max_abs_err=scan_err,
             **{k: sum(r[k] for r in fwd1) for k in ("ms", "ms_summaries", "ms_combine", "ms_output", "plain_ms",
                                                        "bound_ms", "bound_summaries_ms", "bound_combine_ms",
                                                        "bound_output_ms")},
             bound_by=max(fwd1, key=lambda r: r["bound_ms"])["bound_by"], library_ms=None,
             launches_predict_files=predict_launches["ss2d_scan_fwd"],
             launches_serve_http=http_launches["ss2d_scan_fwd"], launches_cli=cli_launches["ss2d_scan_fwd"],
             launches_track=track_launches["ss2d_scan_fwd"], launches_track_pan=track_pan_launches["ss2d_scan_fwd"],
             launches_video=video_launches["ss2d_scan_fwd"],
             launches_video_predict=video_predict_launches["ss2d_scan_fwd"],
             launches_fuse=fuse_launches["ss2d_scan_fwd"],
             launches_info=info_launches["ss2d_scan_fwd"], launches_autobatch=autobatch_launches["ss2d_scan_fwd"],
             launches_export={k: export_launches[k] for k in ("ss2d_scan_fwd", "ss2d_scan_fwd_summaries",
                                                             "ss2d_scan_fwd_combine", "ss2d_scan_fwd_output")},
             launches_export_of="one forward of the exported tamtr.yaml .pt2 in a fresh process (tamtr::ss2d_scan_fwd)",
             ss2d_pieces=pieces,
             launches_sp_blocks={k: sp_launches[k] for k in ("ss2d_scan_fwd_summaries", "ss2d_scan_fwd_combine",
                                                              "ss2d_scan_fwd_output")},
             sp_blocks_max_abs_err=sp_err["fwd"], sp_blocks_max_abs_err_plain=sp_err["fwd_plain"], sp_blocks=sp_rows,
             launches_parallel=parallel_summary["launches_train"]["ss2d_scan_fwd"],
             batch=1, ms_b4=sum(r["ms"] for r in fwd4), plain_ms_b4=sum(r["plain_ms"] for r in fwd4),
             bound_ms_b4=sum(r["bound_ms"] for r in fwd4),
             bound_of_launches="each launch alone, the segment states it writes or reads included",
             per_level=scan_rows,
             bf16=bf16_of(bf16["scan_fwd"], "ss2d_scan_fwd", "the three 640 px levels, B=4, bf16 sequence I/O")),
        dict(name="bilinear_gather_fwd", route="cuda", source="tamtr_torch/csrc/bilinear_gather_fwd.cu",
             replaces="tamtr_tpu/kernels/deform_scatter.py:195", launches=launches["bilinear_gather_fwd"],
             launches_train=train_launches["bilinear_gather_fwd"], launches_fit=fit_launches["bilinear_gather_fwd"],
             launches_predict_files=predict_launches["bilinear_gather_fwd"],
             launches_serve_http=http_launches["bilinear_gather_fwd"],
             launches_cli=cli_launches["bilinear_gather_fwd"], launches_track=track_launches["bilinear_gather_fwd"],
             launches_track_pan=track_pan_launches["bilinear_gather_fwd"],
             launches_video=video_launches["bilinear_gather_fwd"],
             launches_video_predict=video_predict_launches["bilinear_gather_fwd"],
             launches_fuse=fuse_launches["bilinear_gather_fwd"], launches_info=info_launches["bilinear_gather_fwd"],
             launches_autobatch=autobatch_launches["bilinear_gather_fwd"],
             launches_export=export_launches["bilinear_gather_fwd"],
             launches_export_of="one forward of the exported tamtr.yaml .pt2 in a fresh process "
                                "(tamtr::bilinear_gather_fwd)",
             launches_parallel=parallel_summary["launches_train"]["bilinear_gather_fwd"],
             **{**gather, "max_abs_err": max(gather["max_abs_err"], gather_train["max_abs_err"],
                                             gather_step["max_abs_err_step"])},
             ms_of="CUDA events over back-to-back calls, as for every kernel; ms_device: the kernel's own "
                   "time per call (torch.profiler)",
             shape="value (1, 33600, 8, 64), Q = 100", train_b4_q700={**gather_train, "shape": "value (4, 33600, "
                                                                    "8, 64), Q = 700, uniform pairs"},
             **gather_step,
             bf16=dict(launches=bf16["launches"]["bilinear_gather_fwd"], **bf16["gather_fwd"],
                       of="value (4, 33600, 8, 64) bf16, Q = 700")),
        dict(name="ss2d_scan_carriers (B3a segment summaries + ss2d_scan_combine)", route="cuda",
             source="tamtr_torch/csrc/ss2d_scan_bwd.cu", replaces="tamtr_tpu/kernels/selective_scan.py:663",
             launches=train_launches["ss2d_scan_carriers"], launches_combine=train_launches["ss2d_scan_combine"],
             launches_fit=fit_launches["ss2d_scan_carriers"], launches_fit_combine=fit_launches["ss2d_scan_combine"],
             launches_autobatch=autobatch_launches["ss2d_scan_carriers"],
             max_abs_err=bwd_err, ms=sum(r["ms_summaries"] + r["ms_combine"] for r in bwd_rows),
             ms_summaries=sum(r["ms_summaries"] for r in bwd_rows), ms_combine=sum(r["ms_combine"] for r in bwd_rows),
             plain_ms=sum(r["plain_ms"] for r in bwd_rows), plain_of="the whole plain backward",
             bound_ms=sum(r["bound_b3a_ms"] for r in bwd_rows),
             bound_by=max(bwd_rows, key=lambda r: r["bound_b3a_ms"])["bound_b3a_by"],
             bound_of="these launches alone, the segment summaries they write included", library_ms=None,
             launches_sp_blocks={k: sp_launches[k] for k in ("ss2d_scan_carriers", "ss2d_scan_combine",
                                                              "ss2d_scan_bwd_walk")},
             sp_blocks_max_abs_err=sp_err["bwd"], sp_blocks_max_abs_err_plain=sp_err["bwd_plain"], sp_blocks_combines="the kernel ss2d_scan_fwd's sp_blocks rows",
             launches_parallel=parallel_summary["launches_train"]["ss2d_scan_carriers"],
             per_level=bwd_rows,
             bf16=bf16_of(bf16["scan_bwd"], "ss2d_scan_carriers",
                          "B3a + combine + B3b together, the three 640 px levels, B=4, bf16 sequence I/O")),
        dict(name="ss2d_scan_bwd_walk (B3b segment walk)", route="cuda",
             source="tamtr_torch/csrc/ss2d_scan_bwd.cu", replaces="tamtr_tpu/kernels/selective_scan.py:684",
             launches=train_launches["ss2d_scan_bwd_walk"], launches_fit=fit_launches["ss2d_scan_bwd_walk"],
             launches_autobatch=autobatch_launches["ss2d_scan_bwd_walk"],
             launches_parallel=parallel_summary["launches_train"]["ss2d_scan_bwd_walk"],
             max_abs_err=bwd_err,
             ms=sum(r["ms_walk"] for r in bwd_rows), plain_ms=sum(r["plain_ms"] for r in bwd_rows),
             plain_of="the whole plain backward", bound_ms=sum(r["bound_b3b_ms"] for r in bwd_rows),
             bound_by=max(bwd_rows, key=lambda r: r["bound_b3b_ms"])["bound_b3b_by"],
             bound_of="this launch alone, the segment summaries it reads included", library_ms=None,
             bound_b3a_plus_b3b_ms=sum(r["bound_ms"] for r in bwd_rows),
             bound_b3a_plus_b3b_by=max(bwd_rows, key=lambda r: r["bound_ms"])["bound_by"],
             ms_b3a_plus_b3b=sum(r["ms"] for r in bwd_rows),
             bf16=bf16_of(bf16["scan_bwd"], "ss2d_scan_bwd_walk",
                          "B3a + combine + B3b together, the three 640 px levels, B=4, bf16 sequence I/O")),
        dict(name="bilinear_gather_bwd (pair_buckets + rows pass)", route="cuda",
             source="tamtr_torch/csrc/bilinear_gather_bwd.cu", replaces="tamtr_tpu/kernels/deform_scatter.py:283",
             launches=train_launches["bilinear_gather_bwd"], launches_buckets=train_launches["pair_buckets"],
             launches_fit=fit_launches["bilinear_gather_bwd"], launches_fit_buckets=fit_launches["pair_buckets"],
             launches_autobatch=autobatch_launches["bilinear_gather_bwd"],
             launches_parallel=parallel_summary["launches_train"]["bilinear_gather_bwd"],
             **gather_bwd,
             bf16=dict(launches=bf16["launches"]["bilinear_gather_bwd"],
                       launches_buckets=bf16["launches"]["pair_buckets"], **bf16["gather_bwd"],
                       of="value and dout bf16, (4, 33600, 8, 64), Q = 700")),
        dict(name="auction_assignment", route="cuda", source="tamtr_torch/csrc/auction.cu",
             replaces="tamtr_tpu/kernels/auction.py:33", launches=train_launches["auction_assignment"],
             launches_fit=fit_launches["auction_assignment"],
             launches_autobatch=autobatch_launches["auction_assignment"],
             launches_parallel=parallel_summary["launches_train"]["auction_assignment"], **auction,
             launches_auction_match=slice3("auction_match", "tamtr_torch.kernels.auction.auction_match"),
             any_size=auction_any),
        dict(name="selective_scan_fwd", route="cuda", source="tamtr_torch/csrc/selective_scan_fwd.cu",
             replaces="tamtr_tpu/kernels/selective_scan.py:72",
             **slice3("selective_scan_fwd", "tamtr_torch.nn.ssm.selective_scan"),
             **{f"launches_{p}": ops_launches[f"selective_scan_fwd_{p}"] for p in ("summaries", "combine", "output")},
             max_abs_err=scan1d_err,
             **{k: sum(r[k] for r in levels1d) for k in ("ms", "ms_summaries", "ms_combine", "ms_output", "plain_ms",
                                                          "bound_ms", "bound_summaries_ms", "bound_combine_ms",
                                                          "bound_output_ms")},
             bound_by=max(levels1d, key=lambda r: r["bound_ms"])["bound_by"], library_ms=None,
             sums_of="the three 640 px levels, G = 4", per_level=scan1d_rows,
             launches_sp_blocks={k: sp_launches[k] for k in ("selective_scan_fwd_summaries",
                                                              "selective_scan_fwd_combine", "selective_scan_fwd_output")},
             sp_blocks_max_abs_err=sp_err["fwd_1d"], sp_blocks_max_abs_err_plain=sp_err["fwd_1d_plain"],
             sp_blocks=sp_rows1d,
             bf16=dict(per_level=bf16["offpath"]["selective_scan_fwd"],
                       ms=sum(r["ms"] for r in bf16["offpath"]["selective_scan_fwd"]),
                       ms_fp32=sum(r["ms_fp32"] for r in bf16["offpath"]["selective_scan_fwd"]),
                       of="the three 640 px levels, G = 4, bf16 u, delta, B, C and y")),
        dict(name="scatter_acc (scatter_acc_buckets + rows pass)", route="cuda",
             source="tamtr_torch/csrc/deform_scatter.cu", replaces="tamtr_tpu/kernels/deform_scatter.py:86",
             **slice3("scatter_acc", "tamtr_torch.kernels.deform_scatter.weighted_gather (backward)"),
             launches_buckets=ops_launches["scatter_acc_buckets"], **scatter,
             bf16=dict(**bf16["offpath"]["scatter_acc"], of="bf16 dout and dvalue, the decoder's uniform pairs")),
        dict(name="scatter_acc_pairs (scatter_acc_pairs_buckets + rows pass)", route="cuda",
             source="tamtr_torch/csrc/deform_scatter.cu", replaces="tamtr_tpu/kernels/deform_scatter.py:359",
             **slice3("scatter_acc_pairs", "tamtr_torch.kernels.deform_scatter.scatter_acc_pairs"),
             launches_buckets=ops_launches["scatter_acc_pairs_buckets"], **scatter_pairs,
             bf16=dict(**bf16["offpath"]["scatter_acc_pairs"], of="bf16 dout and output, the decoder's uniform pairs")),
    ]
    # the main-path launches of the Detect, Segment and Pose families (none), of the four DETR loss variants' steps, of
    # rtdetr.yaml and of the variant heads
    for entry, key in zip(kernels, ("ss2d_scan_fwd", "bilinear_gather_fwd", "ss2d_scan_carriers", "ss2d_scan_bwd_walk",
                                    "bilinear_gather_bwd", "auction_assignment", "selective_scan_fwd", "scatter_acc",
                                    "scatter_acc_pairs")):
        entry.update(launches_yolo=yolo_launches[key], launches_seg_pose=seg_pose_launches[key],
                     launches_classify=classify_launches[key], launches_sam=sam_launches[key],
                     launches_loss_variants=variants_launches[key],
                     launches_rtdetr=rtdetr_launches[key], launches_heads=heads_launches[key],
                     launches_reference_ckpt=reference_launches[key])
    kernels[1].update(c32_q300={**gather_c32, "shape": "value (1, 33600, 8, 32), Q = 300 (rtdetr eval)"},
                      c32_train_b4_q900={**gather_c32_train, "shape": "value (4, 33600, 8, 32), Q = 900 (rtdetr "
                                                                       "training, uniform pairs)"})
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], gather_c32["max_abs_err"],
                                    gather_c32_train["max_abs_err"])
    kernels[4].update(c32_b4_q900={**gather_bwd_c32, "shape": "value (4, 33600, 8, 32), Q = 900 (rtdetr training)"},
                      launches_rtdetr_buckets=rtdetr_launches["pair_buckets"],
                      launches_heads_buckets=heads_launches["pair_buckets"])
    kernels[4]["max_abs_err"] = max(kernels[4]["max_abs_err"], gather_bwd_c32["max_abs_err"])
    kernels[5].update(cost_28_300_300={**auction_rtdetr, "shape": "(28, 300, 300): 7 matched layers x 4 images, "
                                                                   "the global-memory value path"})
    print(json.dumps({"fit": fit_summary}))
    print(json.dumps({"yolo": yolo_summary, "loss_variants": variants_summary}))
    print(json.dumps({"seg_pose": seg_pose_summary}))
    print(json.dumps({"classify": classify_summary, "sam": sam_summary}))
    print(json.dumps({"rtdetr": rtdetr_summary, "heads": heads_summary}))
    print(json.dumps({"bf16": {k: bf16[k] for k in ("serve", "train", "fit", "launches")}}))
    print(json.dumps({"sp_blocks": {"max_abs_err": sp_err, "launches": {k: v for k, v in sp_launches.items() if v}},
                      "parallel": parallel_summary}))
    print(json.dumps({"fuse": fuse_summary, "autobatch": autobatch_summary}))
    print(json.dumps({"predict_files": predict_summary, "serve_http": http_summary, "track": track_summary,
                      "video": video_summary,
                      "jpeg_host_decode_ms_per_megapixel": jpeg_ms_per_mp,
                      "jpeg_host_encode_ms_per_megapixel": jpeg_encode_ms_per_mp,
                      "webp_tiff_host_decode_ms_per_megapixel": {k: v for k, v in formats_ms_per_mp.items()
                                                                 if k != "encode"},
                      "tiff_webp_host_encode": formats_ms_per_mp["encode"]}))
    print(json.dumps({"export": export_summary}))
    print(json.dumps({"clip_text": clip_summary, "reference_ckpt": reference_summary}))
    print(json.dumps({"phase_s": PHASE_S, "device_ms_by": DEVICE_MS_BY}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
