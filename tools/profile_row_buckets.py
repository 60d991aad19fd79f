"""Where the buckets launch of `tamtr_torch/csrc/row_buckets.cuh` spends its
time, per phase, on one GPU.

Run from the repo root on a machine with an NVIDIA card:
    python3 tools/profile_row_buckets.py [--root DIR] [--cluster K ...] [--iters 20]

Copies DIR's `tamtr_torch/csrc/row_buckets.cuh` (default: this checkout's)
into `build/profile_row_buckets/` with a `%globaltimer` stamp by thread 0 of
every block at each phase's end (stage, count, scan and publish, the
cluster barrier and the exchange, place and write out, for each radix
pass; then the offsets' counts, their scan, the offsets and the segments),
and a way to force the cluster size; builds it with nvcc and runs the
buckets launch of B4 (pairs, last-row shift), B7 (rows) and B8 (pairs, skip
rule) on the inputs of `tools/bench_scatter_rows.py` (value (4, 33600, 8,
64), Q = 700, uniform points). Prints, per kernel and cluster size (0: the
launch's own choice), the cluster size used, how many such clusters the card
holds at once (`cudaOccupancyMaxActiveClusters`), the launch's mean ms over
`--iters` launches by CUDA events (without the stamps), the spread of the
blocks' start times (a second wave shows here), and each phase's mean
microseconds over the blocks; B8's order and offsets are checked against
`scatter_acc_pairs_buckets_ref`. The card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "build" / "profile_row_buckets"
PHASES = {13: "p0 stage", 1: "p0 count", 2: "p0 scan+publish", 3: "p0 barrier+exchange", 4: "p0 place+out",
          14: "p1 stage", 5: "p1 count", 6: "p1 scan+publish", 7: "p1 barrier+exchange", 8: "p1 place+out",
          9: "p1 fence+barrier", 10: "offset counts", 11: "offset scan", 12: "offsets+segments"}
# the instrumented copy: (text in the header, the text that replaces it)
EDITS = [
    ("namespace {\n\nnamespace cg = cooperative_groups;",
     "namespace {\n\nnamespace cg = cooperative_groups;\n__device__ long long* g_stamps = nullptr;\n"
     "__device__ __forceinline__ long long gtimer() {\n  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
     "#define STAMP(k) do { if (g_stamps && threadIdx.x == 0) g_stamps[blockIdx.x * 16 + (k)] = gtimer(); } while (0)\n"
     "int g_force_k = 0, g_last_k = 0, g_last_clusters = 0;\n"),
    ("  int* hist = reinterpret_cast<int*>(hist4);\n  cg::cluster_group",
     "  int* hist = reinterpret_cast<int*>(hist4);\n  STAMP(0);\n  cg::cluster_group"),
    ("    for (int i = tid; i < kHist; i += kBucketThreads) hist[i] = 0;\n    __syncthreads();\n",
     "    for (int i = tid; i < kHist; i += kBucketThreads) hist[i] = 0;\n    __syncthreads();\n    STAMP(13 + p);\n"),
    ("    __syncthreads();\n    block_exclusive_scan(hist, kHist, s_warp);",
     "    __syncthreads();\n    STAMP(1 + 4 * p);\n    block_exclusive_scan(hist, kHist, s_warp);"),
    ("    cluster.sync();  // every block's starts are published",
     "    STAMP(2 + 4 * p);\n    cluster.sync();  // every block's starts are published"),
    ("      s_adj[tid] = all_before - s_pub[tid] + earlier;\n    }\n    __syncthreads();",
     "      s_adj[tid] = all_before - s_pub[tid] + earlier;\n    }\n    __syncthreads();\n    STAMP(3 + 4 * p);"),
    ("    __threadfence();\n    cluster.sync();",
     "    __syncthreads();\n    STAMP(4 + 4 * p);\n    __threadfence();\n    cluster.sync();"),
    ("  // the offsets: bucket j starts at lb(j)", "  STAMP(9);\n  // the offsets: bucket j starts at lb(j)"),
    ("    block_exclusive_scan(s_cnt, bins4, s_warp);",
     "    STAMP(10);\n    block_exclusive_scan(s_cnt, bins4, s_warp);\n    STAMP(11);"),
    ("      list_row(j, next - (R::pairs ? prev : cur));\n    }\n  }\n}",
     "      list_row(j, next - (R::pairs ? prev : cur));\n    }\n  }\n  __syncthreads();\n  STAMP(12);\n}"),
    ("  for (int K = min(kMaxCluster, max(1, sms / p.G));; --K) {",
     "  for (int K = g_force_k > 0 ? g_force_k : min(kMaxCluster, max(1, sms / p.G));; --K) {"),
    ("    if (K == 1 || (placed && clusters >= p.G)) break;",
     "    if (K == 1 || g_force_k > 0 || (placed && clusters >= p.G)) {\n"
     "      g_last_k = K;\n      g_last_clusters = clusters;\n      break;\n    }"),
    ("  if (plan.device != device ||", "  if (true || plan.device != device ||"),
]
ENTRY = """#include "row_buckets_stamped.cuh"

using B8Rule = Rule<true, true, false>;
using B7Rule = Rule<false, true, false>;
using B4Rule = Rule<true, false, true>;

// kind 0: B8, 1: B7, 2: B4; on G = B nh groups of n updates and `rows` output rows
extern "C" int stamped_buckets(int kind, const int* idx, const float* wa, const float* wb, int ws, int* offsets,
                               int* order, float* upd_w, int* items, int* done, int* n_items, int* bufs, int* keys,
                               int B, int n, int nh, int rows, int force_k, long long* stamps, int* info,
                               void* stream) {
  g_force_k = force_k;
  cudaMemcpyToSymbol(g_stamps, &stamps, sizeof(stamps));
  const int NB = kind == 0 ? rows + 1 : rows;
  const BucketArgs a{idx, wa, wb, ws, offsets, order, upd_w, reinterpret_cast<int4*>(items), done, n_items,
                     reinterpret_cast<int2*>(bufs), keys, n, nh, rows, NB, 0, 0, 0, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = kind == 0   ? launch_buckets<B8Rule>(a, B * nh, s)
                          : kind == 1 ? launch_buckets<B7Rule>(a, B * nh, s)
                                      : launch_buckets<B4Rule>(a, B * nh, s);
  info[0] = g_last_k;
  info[1] = g_last_clusters;
  return (int)err;
}
"""


def build(root: Path):
    src = (root / "tamtr_torch" / "csrc" / "row_buckets.cuh").read_text()
    for old, new in EDITS:
        if old not in src:
            raise RuntimeError(f"profile_row_buckets: the header has changed; no anchor {old[:50]!r}")
        src = src.replace(old, new, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "row_buckets_stamped.cuh").write_text(src)
    (OUT / "stamped.cu").write_text(ENTRY)
    from tamtr_torch.kernels import _build

    subprocess.run([_build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(OUT / "libstamped.so"), str(OUT / "stamped.cu")], check=True)
    fn = ctypes.CDLL(str(OUT / "libstamped.so")).stamped_buckets
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--cluster", type=int, nargs="*", default=[0])
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_row_buckets: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import bench_scatter_rows
    from tamtr_torch.kernels import deform_scatter as ds

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    fn = build(a.root.resolve())
    dev = torch.device("cuda")
    value, idx2, w_pairs, dout = bench_scatter_rows.gather_inputs(dev, False)
    (rows7, w7, _, L), (i8, wa8, wb8, _, L2) = bench_scatter_rows.scatter_inputs(value, idx2, w_pairs, dout)
    kernels = {"B8": (0, i8, wa8, wb8, 1, i8.shape[0], i8.shape[1], 1, L2, True),
               "B7": (1, rows7, w7, w7, 1, rows7.shape[0], rows7.shape[1], rows7.shape[2], L, False),
               "B4": (2, idx2, w_pairs, w_pairs[..., 1:], 2, idx2.shape[0], idx2.shape[1], idx2.shape[2],
                      value.shape[1], True)}
    stream = torch.cuda.current_stream().cuda_stream
    for name, (kind, idx, wa, wb, ws, B, n, nh, rows, pairs) in kernels.items():
        G = B * nh
        for force in a.cluster:
            b = ds._Buckets(G, n, rows + (kind == 0), pairs, dev)
            info = (ctypes.c_int * 2)()

            def launch(stamps=None):
                rc = fn(kind, idx.data_ptr(), wa.data_ptr(), wb.data_ptr(), ws, *b.ptrs, B, n, nh, rows, force, stamps,
                        info, stream)
                if rc:
                    raise RuntimeError(f"stamped_buckets: CUDA error {rc}")

            for _ in range(3):
                launch()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(a.iters):
                launch()
            end.record()
            end.synchronize()
            stamps = torch.zeros(G * 8 * 16, dtype=torch.int64, device=dev)
            launch(stamps.data_ptr())
            torch.cuda.synchronize()
            K = info[0]
            t = stamps.view(-1, 16)[: G * K].double()
            phases, prev = {}, t[:, 0]
            for k, label in PHASES.items():
                if t[:, k].max() > 0:
                    phases[label] = round(float((t[:, k] - prev).mean()) / 1e3, 2)
                    prev = t[:, k]
            row = dict(kernel=name, cluster=K, clusters_at_once=info[1], ms=start.elapsed_time(end) / a.iters,
                       start_spread_us=float(t[:, 0].max() - t[:, 0].min()) / 1e3, phases_us=phases)
            if kind == 0:
                ref = ds.scatter_acc_pairs_buckets_ref(idx, wa, wb, rows)
                row["equals_plain_version"] = bool(torch.equal(b.part(0), ref[0]) and torch.equal(b.part(1), ref[1]))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
