"""Host time of JPEG decoders built from `csrc/jpeg_decode.cpp` sources
(the port's `tamtr_torch/csrc/jpeg_decode.cpp` by default) on the JPEG
fixtures, in ms per megapixel, for comparing versions of the decoder:

    python tools/bench_jpeg_decode_torch.py parent=/path/to/parent/tamtr_torch/csrc/jpeg_decode.cpp \\
        change=tamtr_torch/csrc/jpeg_decode.cpp

Each source is compiled with the port's host flags (`kernels/_build.py`)
into `build/bench_jpeg_decode/` and loaded side by side in this one
process through its C entry point `jpeg_decode`. Every round decodes each
fixture once with every version, the versions' order rotating from round
to round, so drift of the host clock falls on all of them alike. Each
output is checked equal to the first version's. A fixture that some
version refuses (a progressive file before the decoder took them) is
timed only by the versions that take it. Prints one JSON line: the median
and the least ms per megapixel per version and fixture.
"""

from __future__ import annotations

import argparse
import ctypes
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from tamtr_torch.data.image_io import _jpeg_header  # noqa: E402
from tamtr_torch.kernels._build import BUILD_DIR, HOST_FLAGS, host_cxx_path  # noqa: E402


def build(label: str, src: Path) -> ctypes.CDLL:
    out = BUILD_DIR / "bench_jpeg_decode" / f"lib{label}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([host_cxx_path(), *HOST_FLAGS, "-o", str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    return lib


def decode(lib: ctypes.CDLL, data: bytes, h: int, w: int):
    out = np.empty((h, w, 3), np.uint8)
    msg = ctypes.create_string_buffer(256)
    t0 = time.perf_counter()
    rc = lib.jpeg_decode(data, len(data), out.ctypes.data, h, w, msg, len(msg))
    return (time.perf_counter() - t0) * 1e3, (out if rc == 0 else None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("versions", nargs="*", default=[f"port={REPO / 'tamtr_torch/csrc/jpeg_decode.cpp'}"],
                    help="label=path/to/jpeg_decode.cpp, one per version")
    ap.add_argument("--fixtures", default=str(REPO / "tests" / "torch_data" / "jpeg"))
    ap.add_argument("--rounds", type=int, default=50)
    args = ap.parse_args()
    libs = {}
    for v in args.versions:
        label, src = v.split("=", 1)
        libs[label] = build(label, Path(src))
    labels = list(libs)
    fixtures = []
    for f in sorted(Path(args.fixtures).glob("*.jpg")):
        data = f.read_bytes()
        info = _jpeg_header(io.BytesIO(data), f.name)
        h, w = info["h"], info["w"]
        ref, takers = None, []
        for label in labels:
            _, img = decode(libs[label], data, h, w)
            if img is None:
                continue
            if ref is None:
                ref = img
            elif not np.array_equal(img, ref):
                raise AssertionError(f"{f.name}: {label} decodes differently from {takers[0]}")
            takers.append(label)
        fixtures.append((f.name, data, h, w, takers))
    times = {label: {name: [] for name, *_, takers in fixtures if label in takers} for label in labels}
    for r in range(args.rounds):
        order = labels[r % len(labels):] + labels[:r % len(labels)]
        for name, data, h, w, takers in fixtures:
            for label in order:
                if label in takers:
                    ms, _ = decode(libs[label], data, h, w)
                    times[label][name].append(ms / (h * w / 1e6))
    print(json.dumps({"rounds": args.rounds, "versions": dict(zip(labels, args.versions)), "decode": {
        label: {name: {"median_ms_per_mp": statistics.median(t), "min_ms_per_mp": min(t)} for name, t in per.items()}
        for label, per in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
